"""Hand-written Hopper kernels and their plain PyTorch versions.

The package also holds the ops plane, imported explicitly rather than
re-exported here: :mod:`.events` (the structured event log),
:mod:`.history` (the metric history sampler), :mod:`.alerts` (burn-rate
SLO rules), :mod:`.incident` (incident bundles and timelines) and the
``python -m analytics_zoo_tpu_torch.ops`` incident CLI.
"""
from .embedding_kernels import (  # noqa: F401
    gather_pool,
    gather_pool_int8,
    gather_rows,
    gather_rows_clip,
    int8_error_bound,
    quantize_table,
)
