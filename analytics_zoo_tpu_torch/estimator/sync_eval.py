"""Synchronous evaluate and predict loops (counterpart of
``analytics_zoo_tpu/estimator/sync_eval.py``).

These are the per-batch forms the pipelined paths in ``estimator.py``
replaced: each batch is copied to the device on the calling thread with
nothing drawn ahead, and a captured loss or a batch of predictions comes
back to the host before the next batch is touched. ``Estimator.evaluate``
and ``predict`` take them under ``eval.async = False``, for two jobs:

1. **parity reference**: the pipelined paths reproduce these results bit
   for bit; the numerics contract is defined here: f32 per-batch losses,
   f64 host accumulation, each batch weighted by its records;
2. **A/B measurement** of what the pipelining buys, on one ``FeatureSet``.

Not exported: every entry takes the Estimator first. New behaviour goes in
``estimator.py``; this module changes only with the numerics contract.
The JAX package's per-example (``direct_eval_per_example_fn``) and
multi-process captured-loss forms have no counterpart: the port has
neither path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..feature.device_feed import _to_tensor
from ..feature.featureset import FeatureSet, tree_map
from ..keras import metrics as metrics_mod


def _to_device(est, tree):
    """A host batch on the Estimator's device, copied now."""
    return tree_map(lambda t: t.to(est.device)
                    if isinstance(t, torch.Tensor) else t,
                    tree_map(_to_tensor, tree))


def evaluate_sync(est, val_set: FeatureSet, batch: int) -> Dict[str, float]:
    """The metric path: a padded tail masked, metric states carried on the
    device (this path never synced per batch), one finalize on the host.
    ``batch`` is the global evaluation batch."""
    mesh = est._mesh_or_none()
    positions = np.arange(batch)
    if mesh is not None:
        from ..parallel.mesh import shard_batch
        positions = shard_batch(mesh, positions)
    states = [m.init_state(est.device) for m in est.metrics]
    est.model.eval()
    with torch.inference_mode():
        for x, y, valid in val_set.eval_iterator(batch, pad_remainder=True,
                                                 mesh=mesh):
            mask = (positions < valid).astype(np.float32)
            bx, by, bm = _to_device(est, (x, y, mask))
            y_pred = est._forward(bx).float()
            states = [m.update(s, by, y_pred, bm)
                      for m, s in zip(est.metrics, states)]
        if mesh is not None:
            for state in states:
                for v in state.values():
                    mesh.all_reduce_(v)
    return metrics_mod.compute_all(est.metrics, states)


def evaluate_direct_single_sync(est, val_set: FeatureSet,
                                local_batch: int) -> Dict[str, float]:
    """The captured loss averaged over the records: full batches and the
    unpadded tail, a blocking ``float()`` per batch, each loss times its
    batch's records summed in f64 on the host."""
    est.model.eval()
    total, weight = 0.0, 0
    with torch.inference_mode():
        for x, y, valid in val_set.eval_iterator(local_batch):
            bx, by = _to_device(est, (x, y))
            loss = float(est.direct_loss_fn(est.model, est._cast_inputs(bx),
                                            by).float())
            total += loss * valid
            weight += valid
    if weight == 0:
        raise ValueError(f"validation set is empty ({val_set.size} records)")
    return {"loss": total / weight}


def predict_sync(est, x: FeatureSet, batch_size: int) -> np.ndarray:
    """A blocking copy of each batch's predictions to the host."""
    mesh = est._mesh_or_none()
    est.model.eval()
    outs = []
    with torch.inference_mode():
        if mesh is None:
            batches = x.eval_iterator(max(1, min(batch_size, x.size)))
        else:
            batches = x.eval_iterator(est._eval_batch(batch_size, x.size),
                                      pad_remainder=True, mesh=mesh)
        for bx, _, valid in batches:
            out = est._forward(_to_device(est, bx)).float()
            if mesh is not None:
                out = mesh.all_gather(out)[:valid]
            outs.append(out.cpu().numpy())
    if not outs:
        return np.zeros((0,), np.float32)
    return np.concatenate(outs)
