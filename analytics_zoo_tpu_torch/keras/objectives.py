"""Loss objectives (counterpart of ``analytics_zoo_tpu/keras/objectives.py``).

Every loss is ``fn(y_true, y_pred) -> scalar`` (mean over the batch) on
probabilities, the reference's Keras-1 contract, clipped to
``[_EPS, 1 - _EPS]`` before the log as in the JAX package. Ported so far:
the losses the zoo's models compile with by default.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

_EPS = 1e-7


def _clip(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, _EPS, 1.0 - _EPS)


def mean_squared_error(y_true, y_pred):
    return torch.mean(torch.square(y_pred - y_true))


def sparse_categorical_crossentropy(y_true, y_pred):
    idx = y_true.to(torch.int64)
    logp = torch.log(_clip(y_pred))
    return -torch.mean(torch.gather(logp, -1, idx[..., None]))


_REGISTRY = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
}


def get(loss: Union[str, Callable]) -> Callable:
    if callable(loss):
        return loss
    if loss not in _REGISTRY:
        raise ValueError(f"unknown loss '{loss}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[loss]
