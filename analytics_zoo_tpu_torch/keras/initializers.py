"""Weight initializers (counterpart of ``analytics_zoo_tpu/keras/
initializers.py``): same names and scales, drawn from an explicit
``torch.Generator`` on the CPU. The streams differ from ``jax.random``'s;
tests that compare the packages copy weights across instead."""
from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

Initializer = Callable[..., torch.Tensor]


def _fans(shape: Sequence[int]) -> tuple:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _uniform(gen, shape, dtype, limit):
    return torch.empty(tuple(shape), dtype=dtype).uniform_(
        -limit, limit, generator=gen)


def glorot_uniform(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _uniform(gen, shape, dtype, float(np.sqrt(6.0 / (fan_in + fan_out))))


def uniform(gen: torch.Generator, shape, dtype=torch.float32, scale=0.05):
    return _uniform(gen, shape, dtype, scale)


def normal(gen: torch.Generator, shape, dtype=torch.float32, stddev=0.05):
    return stddev * torch.randn(tuple(shape), generator=gen, dtype=dtype)


def zeros(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype)


_REGISTRY = {
    "glorot_uniform": glorot_uniform,
    "uniform": uniform,
    "normal": normal,
    "zero": zeros,
    "zeros": zeros,
}


def get(init: Union[str, Initializer]) -> Initializer:
    if callable(init):
        return init
    if init not in _REGISTRY:
        raise ValueError(f"unknown initializer '{init}'; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[init]
