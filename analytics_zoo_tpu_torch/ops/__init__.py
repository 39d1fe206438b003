"""Hand-written Hopper kernels and their plain PyTorch versions."""
from .embedding_kernels import (  # noqa: F401
    gather_pool,
    gather_pool_int8,
    gather_rows,
    gather_rows_clip,
    int8_error_bound,
    quantize_table,
)
