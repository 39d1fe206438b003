"""Validation metrics (counterpart of ``analytics_zoo_tpu/keras/metrics.py``).

Streaming design, as in the JAX package: ``init_state(device)`` makes zero
tensors on the evaluation device, ``update(state, y_true, y_pred, mask)``
folds one (possibly padded) batch in there, and :func:`compute_all`
finalizes a whole pass with one copy to the host. ``mask`` marks the real
rows of a padded tail batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Union

import numpy as np
import torch


def compute_all(metrics: Sequence["Metric"], states) -> Dict[str, float]:
    """Finalize an evaluation pass: every state comes to the host in one
    batch of copies, then each ``compute`` runs on numpy."""
    host = [{k: v.cpu().numpy() for k, v in s.items()} for s in states]
    return {m.name: m.compute(s) for m, s in zip(metrics, host)}


def _masked_mean_update(state, per_example, mask):
    per_example = per_example.reshape(mask.shape[0], -1).mean(dim=-1)
    return {"sum": state["sum"] + torch.sum(per_example * mask),
            "count": state["count"] + torch.sum(mask)}


class Metric:
    name = "metric"

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        return {"sum": torch.zeros((), device=device),
                "count": torch.zeros((), device=device)}

    def update(self, state, y_true, y_pred, mask):
        raise NotImplementedError

    def compute(self, state) -> float:
        return float(np.asarray(state["sum"])
                     / np.maximum(np.asarray(state["count"]), 1))


class Accuracy(Metric):
    """Binary (threshold 0.5) or categorical accuracy, chosen by the
    prediction's rank as in the JAX package."""

    name = "accuracy"

    def update(self, state, y_true, y_pred, mask):
        if y_pred.dim() > 1 and y_pred.shape[-1] > 1:
            pred = torch.argmax(y_pred, dim=-1)
            true = (torch.argmax(y_true, dim=-1)
                    if y_true.dim() == y_pred.dim()
                    else y_true.to(torch.int64))
            correct = (pred == true).float()
        else:
            p = y_pred.reshape(y_pred.shape[0], -1)[:, 0]
            t = y_true.reshape(y_true.shape[0], -1)[:, 0]
            correct = ((p > 0.5) == (t > 0.5)).float()
        return _masked_mean_update(state, correct, mask)


class Loss(Metric):
    """Streams the compiled loss as a metric: each batch's loss weighted by
    its count of real rows."""

    name = "loss"

    def __init__(self, loss_fn: Callable):
        self.loss_fn = loss_fn

    def update(self, state, y_true, y_pred, mask):
        value = self.loss_fn(y_true, y_pred)
        n = torch.sum(mask)
        return {"sum": state["sum"] + value * n, "count": state["count"] + n}


_REGISTRY: Dict[str, Callable[[], Metric]] = {"accuracy": Accuracy}


def get(metric: Union[str, Metric]) -> Metric:
    if isinstance(metric, Metric):
        return metric
    if metric not in _REGISTRY:
        raise ValueError(f"unknown metric '{metric}'; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[metric]()
