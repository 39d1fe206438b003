"""Carry weights across from the JAX package.

The JAX model's parameters are a nested dict ``{layer: {param: array}}``
(``Model.build`` in ``analytics_zoo_tpu/keras/engine.py``), with lists
where a model keeps a sequence of blocks (``TransformerLM``'s ``blocks``).
The port keeps the same layer and parameter names and the same layouts (a
Dense ``kernel`` is ``[in, out]`` in both), and a list item's index is its
name (``nn.ModuleList``'s), so the map is by name alone.

A model's state crosses beside its params the same way. The JAX package's
``Model.build`` returns ``(params, state)``, the state a tree of the same
shape holding what the optimizer never sees: BatchNorm's ``moving_mean``
and ``moving_var``. In the port those are buffers of the same names, so
``from_jax_params(state)`` gives their state-dict keys
(``stem_bn.moving_mean``), and ``{**from_jax_params(params),
**from_jax_params(state)}`` loads strictly into the port's model (a
convolution kernel keeps the JAX package's HWIO layout; the layer permutes
it in its forward). ``Estimator.set_model_state`` takes the state tree
alone. The int8-dataflow backbone's trees nest one level deeper, and
cross the same way: ``int8_backbone.<conv>.kernel`` (``.gamma``,
``.beta``) from its params, ``int8_backbone.in_amax``,
``int8_backbone.<conv>.mid_amax`` (``.out_amax``, ``.running_mean``,
``.running_var``) and ``int8_backbone.<block>_add.out_amax`` from its
state, the buffers of ``Int8DataflowBackbone``.

A tree from the JAX package's ``quantize_params`` crosses too: an int8
leaf ``{"q", "scale"[, "act_scale"]}`` flattens to ``<layer>.<param>.q``,
``.scale`` and ``.act_scale``, the buffers of the port's
``inference.quantize.QuantizedWeight``, so it loads strictly into a port
model quantized the same way; bf16 leaves become bf16 tensors.

A vocab-sharded table crosses to one rank as that rank's block: pass
``shard=(rank, ranks)`` and the state-dict keys of the sharded tables
(``sharded``), and each of them, the JAX package's padded global table or
an unpadded replicated one, becomes :func:`shard_rows` of it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch


def shard_rows(table: torch.Tensor, rank: int, ranks: int) -> torch.Tensor:
    """Rank ``rank``'s block of a table split by rows over ``ranks``:
    ``ceil(rows / ranks)`` rows from ``rank`` times that, zero rows past the
    end. An unpadded table and its zero-padded form give the same block."""
    per = -(-table.shape[0] // ranks)
    block = table[rank * per:(rank + 1) * per]
    if block.shape[0] < per:
        block = torch.cat([block, block.new_zeros(
            (per - block.shape[0],) + tuple(table.shape[1:]))])
    return block.contiguous()


def from_jax_params(params: Mapping[str, Any],
                    shard: Optional[Tuple[int, int]] = None,
                    sharded: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """``{layer: {param: ndarray}}`` -> a ``state_dict`` keyed
    ``"<layer>.<param>"`` (deeper nesting joins with dots too, and item
    ``i`` of a list or tuple is ``"<name>.<i>"``). Leaves may be numpy
    arrays or anything ``np.asarray`` takes; values are copied. With
    ``shard=(rank, ranks)`` every key in ``sharded`` keeps only ``rank``'s
    block (:func:`shard_rows`)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(f"{prefix}.{key}" if prefix else str(key), child)
            return
        if isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(f"{prefix}.{i}" if prefix else str(i), child)
            return
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":  # numpy has no bf16 torch takes
            out[prefix] = torch.from_numpy(
                arr.astype(np.float32)).to(torch.bfloat16)
        else:
            out[prefix] = torch.from_numpy(arr)

    walk("", params)
    if shard is not None:
        for key in sharded:
            out[key] = shard_rows(out[key], *shard)
    return out
