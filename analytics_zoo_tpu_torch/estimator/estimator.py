"""The training loop (counterpart of ``analytics_zoo_tpu/estimator/
estimator.py`` ``Estimator``), on one device.

``train`` runs the JAX package's loop: it draws one batch before training
(which uses up one shuffle permutation, as the JAX loop's initialisation
sample does), then per epoch feeds batches to the device one ahead
(:class:`~analytics_zoo_tpu_torch.feature.device_feed.DeviceFeed`), steps
the model, the loss, autograd and the optimizer, and copies the losses to
the host once per epoch. Triggers decide when to validate, checkpoint and
stop. A checkpoint is one ``torch.save`` file holding the parameters, the
optimizer state, the epoch, the global step and the data pipeline's state,
so a resumed run replays the batches an uninterrupted run would see.

``train`` steps in training mode (``nn.Module.train()``), ``evaluate`` and
``predict`` run in eval mode. Dropout draws from one ``torch.Generator`` on
the Estimator's device, seeded from ``seed`` and handed to every layer
(``set_dropout_generator``); its state is part of a checkpoint, so a run
resumed with dropout on replays the uninterrupted run's masks. Moving the
Estimator to another device, or loading a checkpoint saved on another
device type, starts the generator from ``seed`` (a CPU generator's state
does not carry to a CUDA one).

A captured model (``GraphModel.from_loss``, the JAX package's
``direct_loss_fn``) hands over its whole loss instead: ``direct_loss_fn(
model, x, y)`` returns the scalar loss from the batch (``y`` is None for
an ``x``-only set), ``forward_fn(model, x)`` gives ``predict`` its
outputs, and ``evaluate`` without metrics is the record-weighted mean of
that loss over full batches and the unpadded tail. Such a model may be any
``nn.Module``: one without ``built`` counts as built.

The device is the card unless the caller passes ``device="cpu"``; without a
card the constructor raises ``NoCudaDeviceError``.
"""
from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..common import file_io
from ..common.context import DeviceLike, resolve_device
from ..common.triggers import (EveryEpoch, MaxEpoch, Trigger,
                               TrainingState)
from ..convert import from_jax_params
from ..feature.device_feed import DeviceFeed, masked_eval_batches
from ..feature.featureset import FeatureSet, tree_map
from ..keras import metrics as metrics_mod
from ..keras import objectives
from ..keras import optimizers as optimizers_mod

#: the file a checkpoint directory holds
CHECKPOINT_FILE = "estimator.pt"


def _to_device(tree, device):
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)


def params_tree(named) -> Dict[str, Any]:
    """``{layer: {param: ndarray}}`` from ``named_parameters()``: each
    dotted name nests, as the JAX package's params tree does."""
    out: Dict[str, Any] = {}
    for name, p in named:
        *path, key = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[key] = p.detach().cpu().numpy()
    return out


def _input_shape(features):
    """The model's input shape from a batch of features: ``None`` for the
    batch axis, a list for a tuple or list of arrays."""
    if isinstance(features, (tuple, list)):
        return [_input_shape(f) for f in features]
    return (None,) + tuple(np.shape(features)[1:])


class Estimator:
    def __init__(self, model, loss_fn: Optional[Callable],
                 optimizer: Any = None, metrics: Optional[Sequence] = None,
                 device: DeviceLike = None, seed: int = 42,
                 direct_loss_fn: Optional[Callable] = None,
                 forward_fn: Optional[Callable] = None):
        """``model`` is a keras ``Model`` (built or not: an unbuilt model is
        built from ``seed`` on ``device`` at first use), or with
        ``direct_loss_fn`` any ``nn.Module``."""
        self.device = resolve_device(device)
        self.model = model
        self.loss_fn = objectives.get(loss_fn) if loss_fn is not None \
            else None
        self.direct_loss_fn = direct_loss_fn
        self.forward_fn = forward_fn
        self.optimizer = (optimizers_mod.get(optimizer)
                          if optimizer is not None else None)
        self.metrics = [metrics_mod.get(m) for m in (metrics or [])]
        self.seed = seed
        self.opt_state: Optional[Dict[str, Any]] = None
        self.dropout_generator: Optional[torch.Generator] = None
        self.global_step = 0
        self.epoch = 1
        self._ckpt_dir: Optional[str] = None
        self._ckpt_trigger: Optional[Trigger] = None
        self._restore_data = None
        self._active_train_set: Optional[FeatureSet] = None

    def to(self, device: DeviceLike) -> "Estimator":
        """Move the model and the optimizer state to ``device``."""
        self.device = resolve_device(device)
        if getattr(self.model, "built", True):
            self.model.to(self.device)
        if self.opt_state is not None:
            self.opt_state = _to_device(self.opt_state, self.device)
        return self

    def set_checkpoint(self, path: str,
                       trigger: Optional[Trigger] = None) -> None:
        """Write ``<path>/snapshot-<step>`` whenever ``trigger`` (default:
        every epoch) fires during ``train``."""
        self._ckpt_dir = path
        self._ckpt_trigger = trigger or EveryEpoch()

    # -- initialization -------------------------------------------------------

    def _params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    def _ensure_initialized(self, features=None) -> None:
        """Build the model (for the shape of ``features``, a numpy tree with
        the record axis first, where it needs one), put it on the device,
        give it the dropout generator and create the optimizer state."""
        if not getattr(self.model, "built", True):
            shape = None if features is None else _input_shape(features)
            self.model.build(torch.Generator().manual_seed(self.seed),
                             shape, device=self.device)
        elif any(p.device != self.device for p in self.model.parameters()):
            self.model.to(self.device)
        gen = self.dropout_generator
        if gen is None or gen.device != self.device:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.dropout_generator = gen
        if hasattr(self.model, "set_dropout_generator"):
            self.model.set_dropout_generator(gen)
        if self.opt_state is None and self.optimizer is not None:
            self.opt_state = self.optimizer.init(self._params())

    # -- one step -------------------------------------------------------------

    def _train_step(self, x, y) -> torch.Tensor:
        """Forward, loss, gradients and the optimizer update; returns the
        loss on the device (nothing here waits for the device)."""
        params = self._params()
        if self.direct_loss_fn is not None:
            loss = self.direct_loss_fn(self.model, x, y).float()
        else:
            loss = self.loss_fn(y, self.model(x).float())
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        self.optimizer.step(params, grads, self.opt_state)
        return loss.detach()

    # -- train ----------------------------------------------------------------

    def train(self, train_set: FeatureSet, batch_size: int,
              epochs: Optional[int] = None,
              end_trigger: Optional[Trigger] = None,
              validation_set: Optional[FeatureSet] = None,
              validation_trigger: Optional[Trigger] = None,
              checkpoint_trigger: Optional[Trigger] = None,
              steps_per_dispatch: int = 1) -> Dict[str, Any]:
        """Train until ``end_trigger`` (default ``MaxEpoch(epochs or 1)``,
        counted from epoch 1 across calls and resumes). Returns
        ``{"loss_history": [loss per step], "iterations": global step}``."""
        if steps_per_dispatch != 1:
            raise NotImplementedError(
                "steps_per_dispatch > 1 is not ported yet")
        if (self.loss_fn is None and self.direct_loss_fn is None) \
                or self.optimizer is None:
            raise RuntimeError("train needs a loss_fn and an optimizer")
        end_trigger = end_trigger or MaxEpoch(epochs if epochs is not None
                                              else 1)
        validation_trigger = validation_trigger or EveryEpoch()
        checkpoint_trigger = (checkpoint_trigger or self._ckpt_trigger
                              or EveryEpoch())
        batches_per_epoch = train_set.num_batches(batch_size)
        if batches_per_epoch < 1:
            raise ValueError(f"{train_set.size} records make no batch of "
                             f"{batch_size}")
        # the JAX loop draws a sample batch to initialise, which uses up one
        # shuffle permutation: do the same, so both see the same batches
        next(train_set.train_iterator(batch_size))
        self._ensure_initialized(train_set.features)

        state = TrainingState(epoch=self.epoch, iteration=self.global_step)
        history: List[float] = []
        pending: List[torch.Tensor] = []  # device losses, copied per epoch
        need_loss = any(t.requires_loss for t in (
            end_trigger, validation_trigger, checkpoint_trigger))
        # the data pipeline is part of a checkpoint (see _snapshot)
        self._active_train_set = train_set
        self._batches_per_epoch = batches_per_epoch
        self._local_batch = batch_size

        while not end_trigger(state):
            skip = 0
            if self._restore_data is not None:
                rng_json, skip, saved_batch = self._restore_data
                self._restore_data = None
                train_set.set_data_state(rng_json)
                if skip and saved_batch != batch_size:
                    raise ValueError(
                        f"resuming a mid-epoch snapshot taken with batch "
                        f"{saved_batch} using batch {batch_size} would "
                        f"replay the wrong records")
                skip = min(skip, batches_per_epoch)
            self._epoch_data_state = train_set.data_state()
            feed = DeviceFeed(train_set.train_iterator(batch_size,
                                                       skip_batches=skip),
                              self.device)
            epoch_iter = self._epoch_offset = skip
            self.model.train()
            try:
                for x, y in feed:
                    loss = self._train_step(x, y)
                    self.global_step += 1
                    epoch_iter += 1
                    self._epoch_offset = epoch_iter
                    state.iteration = self.global_step
                    pending.append(loss)
                    if need_loss:
                        state.loss = float(loss)
                    state.epoch_finished = epoch_iter >= batches_per_epoch
                    if state.epoch_finished:
                        history.extend(torch.stack(pending).cpu().tolist())
                        pending.clear()
                        state.epoch += 1
                        self.epoch = state.epoch
                    if validation_set is not None \
                            and validation_trigger(state):
                        results = self.evaluate(validation_set, batch_size)
                        state.score = next(iter(results.values()), None)
                        self.model.train()
                    if self._ckpt_dir and checkpoint_trigger(state):
                        self.save_checkpoint(file_io.join(
                            self._ckpt_dir, f"snapshot-{self.global_step}"))
                    if state.epoch_finished or end_trigger(state):
                        break
            finally:
                feed.close()
            state.epoch_finished = False
        if pending:
            history.extend(torch.stack(pending).cpu().tolist())
        return {"loss_history": history, "iterations": self.global_step}

    # -- evaluate / predict ---------------------------------------------------

    def evaluate(self, val_set: FeatureSet, batch_size: int
                 ) -> Dict[str, float]:
        """Metrics over ``val_set`` (the compiled loss when none were
        given), accumulated on the device and copied to the host once. The
        tail batch is padded and masked, as in the JAX package."""
        if self.direct_loss_fn is not None and not self.metrics:
            return self._evaluate_direct(val_set, batch_size)
        if not self.metrics:
            self.metrics = [metrics_mod.Loss(self.loss_fn)]
        if val_set.size == 0:
            raise ValueError("validation set is empty (0 records)")
        local_batch = min(batch_size, val_set.size)
        self._ensure_initialized(val_set.features)
        states = [m.init_state(self.device) for m in self.metrics]
        self.model.eval()
        batches = masked_eval_batches(
            val_set.eval_iterator(local_batch, pad_remainder=True),
            local_batch)
        with torch.inference_mode():
            for (bx, by, mask), _ in DeviceFeed(batches, self.device):
                y_pred = self._forward(bx).float()
                states = [m.update(s, by, y_pred, mask)
                          for m, s in zip(self.metrics, states)]
        return metrics_mod.compute_all(self.metrics, states)

    def _evaluate_direct(self, val_set: FeatureSet, batch_size: int
                         ) -> Dict[str, float]:
        """``{"loss": ...}``: the captured loss averaged over the records,
        full batches and the tail unpadded, each batch weighted by its
        size (the JAX package's single-process ``_evaluate_direct``)."""
        if val_set.size == 0:
            raise ValueError("validation set is empty (0 records)")
        local_batch = min(batch_size, val_set.size)
        self._ensure_initialized(val_set.features)
        self.model.eval()
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        with torch.inference_mode():
            for bx, by, valid in DeviceFeed(
                    val_set.eval_iterator(local_batch), self.device):
                total += self.direct_loss_fn(self.model, bx, by).double() \
                    * valid
        return {"loss": float(total) / val_set.size}

    def _forward(self, x):
        return (self.forward_fn(self.model, x) if self.forward_fn is not None
                else self.model(x))

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        """Forward ``x`` (arrays, a list of arrays or a ``FeatureSet``) in
        batches of ``batch_size``; returns float32 numpy."""
        if not isinstance(x, FeatureSet):
            x = FeatureSet.from_ndarrays(x, None, shuffle=False)
        self._ensure_initialized(x.features)
        self.model.eval()
        outs = []
        with torch.inference_mode():
            for bx, _, _ in DeviceFeed(
                    x.eval_iterator(max(1, min(batch_size, x.size))),
                    self.device):
                outs.append(self._forward(bx).float())
        if not outs:
            return np.zeros((0,), np.float32)
        return torch.cat(outs).cpu().numpy()

    # -- params / checkpoint --------------------------------------------------

    def get_params(self) -> Dict[str, Any]:
        """``{layer: {param: ndarray}}``, the JAX package's params tree
        (nested deeper where the layer nests, as BERT's blocks do)."""
        self._ensure_initialized()
        return params_tree(self._params().items())

    def set_params(self, params) -> None:
        """Load a ``{layer: {param: array}}`` tree (the JAX package's, or
        :meth:`get_params`') or a flat ``{"layer.param": array}`` dict; it
        must name every parameter of the model."""
        self._ensure_initialized()
        if any(isinstance(v, Mapping) for v in params.values()):
            flat = from_jax_params(params)
        else:
            flat = {k: torch.as_tensor(np.asarray(v)) for k, v in
                    params.items()}
        named = self._params()
        if set(flat) != set(named):
            raise ValueError(
                f"params do not match the model: missing "
                f"{sorted(set(named) - set(flat))}, unexpected "
                f"{sorted(set(flat) - set(named))}")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(flat[k].to(p.dtype))

    def _snapshot(self) -> Dict[str, Any]:
        self._ensure_initialized()
        meta: Dict[str, Any] = {"global_step": self.global_step,
                                "epoch": self.epoch,
                                "dropout_rng":
                                    self.dropout_generator.get_state(),
                                "dropout_device": self.device.type}
        ts = self._active_train_set
        if ts is not None:
            # an epoch-end snapshot records the post-epoch shuffle state; a
            # mid-epoch one the epoch-start state and the batches consumed,
            # so a resume replays the same permutation from the same place
            if self._epoch_offset >= self._batches_per_epoch:
                rng_json, offset = ts.data_state(), 0
            else:
                rng_json, offset = self._epoch_data_state, self._epoch_offset
            meta.update(data_rng=rng_json, data_offset=offset,
                        data_batch=self._local_batch)
        return {
            "params": {k: v.detach().cpu()
                       for k, v in self.model.state_dict().items()},
            "opt_state": _to_device(self.opt_state, "cpu"),
            "meta": meta,
        }

    def save_checkpoint(self, path: str) -> None:
        """Write a checkpoint directory holding one ``torch.save`` file,
        through a temporary file renamed into place."""
        file_io.makedirs(path, exist_ok=True)
        dst = file_io.join(path, CHECKPOINT_FILE)
        tmp = dst + f".tmp{os.getpid()}"
        torch.save(self._snapshot(), tmp)
        file_io.replace(tmp, dst)

    def load_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` directory: parameters,
        optimizer state, epoch, global step, the dropout generator's state
        (saved on this device type; else it restarts from ``seed``), and
        the data state the next ``train`` resumes from. The model must
        be built (a ``Sequential`` needs its input shape)."""
        tree = torch.load(file_io.join(path, CHECKPOINT_FILE),
                          map_location="cpu", weights_only=True)
        missing = {"params", "opt_state", "meta"} - set(tree)
        if missing:
            raise ValueError(f"checkpoint at {path} is not an estimator "
                             f"snapshot (missing {sorted(missing)})")
        self._ensure_initialized()
        self.model.load_state_dict(tree["params"], strict=True)
        self.opt_state = _to_device(tree["opt_state"], self.device)
        meta = tree["meta"]
        self.global_step = int(meta["global_step"])
        self.epoch = int(meta["epoch"])
        # a generator's state only fits one of its own device type (a CPU
        # state is not a CUDA one): from another device, start from ``seed``
        if meta.get("dropout_device") == self.device.type:
            self.dropout_generator.set_state(meta["dropout_rng"])
        else:
            self.dropout_generator.manual_seed(self.seed)
        if "data_rng" in meta:
            self._restore_data = (meta["data_rng"], int(meta["data_offset"]),
                                  int(meta["data_batch"]))
