"""Carry weights across from the JAX package.

The JAX model's parameters are a nested dict ``{layer: {param: array}}``
(``Model.build`` in ``analytics_zoo_tpu/keras/engine.py``). The port keeps
the same layer and parameter names and the same layouts (a Dense ``kernel``
is ``[in, out]`` in both), so the map is by name alone.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{layer: {param: ndarray}}`` -> a ``state_dict`` keyed
    ``"<layer>.<param>"`` (deeper nesting joins with dots too). Leaves may
    be numpy arrays or anything ``np.asarray`` takes; values are copied."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(f"{prefix}.{key}" if prefix else str(key), child)
            return
        out[prefix] = torch.from_numpy(np.array(node, copy=True))

    walk("", params)
    return out
