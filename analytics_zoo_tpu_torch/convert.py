"""Carry weights across from the JAX package.

The JAX model's parameters are a nested dict ``{layer: {param: array}}``
(``Model.build`` in ``analytics_zoo_tpu/keras/engine.py``), with lists
where a model keeps a sequence of blocks (``TransformerLM``'s ``blocks``).
The port keeps the same layer and parameter names and the same layouts (a
Dense ``kernel`` is ``[in, out]`` in both), and a list item's index is its
name (``nn.ModuleList``'s), so the map is by name alone.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{layer: {param: ndarray}}`` -> a ``state_dict`` keyed
    ``"<layer>.<param>"`` (deeper nesting joins with dots too, and item
    ``i`` of a list or tuple is ``"<name>.<i>"``). Leaves may be numpy
    arrays or anything ``np.asarray`` takes; values are copied."""
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
        out[prefix] = torch.from_numpy(np.array(node, copy=True))

    walk("", params)
    return out
