"""The symmetric int8 quantizer and its delayed scaling (counterpart of the
public helpers of ``analytics_zoo_tpu/ops/int8_dataflow.py``:
``quant_int8``, ``dequant_int8``, ``next_amax`` and ``scale_of_amax``).

They are all that the embedding code needs (``quantize_table``,
``gather_pool_int8``). The rest of that module, the int8 ResNet dataflow
and its training, waits for the convolution layers of a later slice.

The arithmetic is the JAX package's, op for op: ``f / scale`` is an f32
division (not a multiply by the reciprocal, which rounds differently at
ties), ``torch.round`` rounds half to even as ``jnp.round`` does, and the
running amax decays by the f32 product ``0.99 * running``.
"""
from __future__ import annotations

import torch

#: fast-rise / slow-decay running amax
AMAX_DECAY = 0.99


def quant_int8(f: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with a delayed scale (scalar, or per channel along the
    last axis): ``clip(round(f / scale), -127, 127)``."""
    return torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)


def dequant_int8(q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``float(q) * scale`` in f32, cast to ``dtype`` (bf16 by default, as
    in the JAX package: every caller of the embedding path passes f32)."""
    return (q.to(torch.float32) * scale).to(dtype)


def next_amax(running: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """The running amax after seeing ``seen``: rises at once, decays by
    :data:`AMAX_DECAY` a step."""
    return torch.maximum(AMAX_DECAY * running, seen)


def scale_of_amax(running_amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-6) / 127``."""
    return torch.clamp(running_amax, min=1e-6) / 127.0
