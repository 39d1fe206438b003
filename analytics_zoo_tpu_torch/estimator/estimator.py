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

``compute_dtype`` (e.g. ``torch.bfloat16``) is the JAX package's mixed
precision: the float inputs of ``train``, ``evaluate`` and ``predict`` are
cast to it on the device (integer inputs stay as they are), each layer
casts its f32 parameters to its input's dtype, and the loss, the metrics
and the predictions take the model's output cast to f32. Parameters and
optimizer state stay f32.

A model's buffers are its state (the JAX package's ``model_state``): the
BatchNorm statistics, which move in training mode and which the optimizer
never sees. ``get_model_state``/``set_model_state`` read and write them
as a ``{layer: {name: array}}`` tree, and a checkpoint holds them with the
parameters (``state_dict``).

On a mesh (``mesh=``, or the default mesh ``parallel.mesh.init_mesh``
installs) every rank runs its own Estimator over the same ``FeatureSet``,
and training is data parallel: each rank steps on its share of every
global batch (``batch_size`` is the global batch and must divide by the
rank count), scales its loss by ``1 / ranks`` and sums the dense gradients
over the ranks in one flat all-reduce, which also carries the loss, so
every rank's loss history is the global batch's mean loss, as the JAX
package's. Vocab-sharded tables (``sharded_tables()`` of a layer) are not
all-reduced: their gradient is already this rank's block, and where the
optimizer has a row-subset form (``sparse_rows``, with
``embed.sparse_updates`` on) they update only the rows the step touched
(``parallel.embedding.apply_row_update``), with row-wise state under
``opt_state["embed"]`` beside the optimizer's own under ``"dense"``.
``evaluate``, ``predict``, ``get_params`` and ``save_checkpoint`` are
collective: every rank calls them. ``get_params`` reads a sharded table
whole (padded), as the JAX package's global arrays read; a checkpoint is
one file per rank, and it resumes only on as many ranks.
"""
from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..common import file_io
from ..common.config import global_config
from ..common.context import DeviceLike, resolve_device
from ..common.triggers import (EveryEpoch, MaxEpoch, Trigger,
                               TrainingState)
from ..convert import from_jax_params, shard_rows
from ..feature.device_feed import DeviceFeed, masked_eval_batches
from ..feature.featureset import FeatureSet, tree_map
from ..keras import metrics as metrics_mod
from ..keras import objectives
from ..keras import optimizers as optimizers_mod
from ..parallel import embedding as _embed
from ..parallel.mesh import Mesh, default_mesh, set_default_mesh

#: the file a checkpoint directory holds (one rank)
CHECKPOINT_FILE = "estimator.pt"


def checkpoint_file(mesh: Optional[Mesh]) -> str:
    """The file this rank's checkpoint is: :data:`CHECKPOINT_FILE` for one
    rank, ``estimator-rank<r>-of-<n>.pt`` on a mesh of ``n``."""
    if mesh is None or mesh.size == 1:
        return CHECKPOINT_FILE
    return f"estimator-rank{mesh.rank}-of-{mesh.size}.pt"


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
                 forward_fn: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """``model`` is a keras ``Model`` (built or not: an unbuilt model is
        built from ``seed`` on ``device`` at first use), or with
        ``direct_loss_fn`` any ``nn.Module``. ``mesh`` (default: the default
        mesh, if any) makes this Estimator one rank of a data-parallel run,
        on ``mesh.device`` unless ``device`` names another.
        ``compute_dtype`` casts the float inputs (mixed precision)."""
        self.mesh = mesh if mesh is not None else default_mesh()
        if self.mesh is not None and device is None:
            device = self.mesh.device
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
        if compute_dtype is not None and not compute_dtype.is_floating_point:
            raise ValueError(f"compute_dtype {compute_dtype} is not a float "
                             f"dtype")
        self.compute_dtype = compute_dtype
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

    @property
    def _ranks(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def _sharded_table_specs(self) -> Dict[str, Any]:
        """``{state-dict key: ShardSpec}`` of every vocab-sharded table in
        the model."""
        out: Dict[str, Any] = {}
        for name, module in self.model.named_modules():
            tables = getattr(module, "sharded_tables", None)
            if tables is None:
                continue
            for key, spec in tables().items():
                out[f"{name}.{key}" if name else key] = spec
        return out

    def _embed_plan(self) -> Dict[str, Any]:
        """The sharded tables the row-subset update owns: all of them when
        the optimizer has one (``sparse_rows``) and ``embed.sparse_updates``
        is on, else none (the optimizer updates them as it updates any
        parameter)."""
        if (self.optimizer is None
                or getattr(self.optimizer, "sparse_rows", None) is None
                or self.direct_loss_fn is not None
                or not global_config().get("embed.sparse_updates")):
            return {}
        return self._sharded_table_specs()

    def _init_opt_state(self, params) -> Dict[str, Any]:
        """The optimizer's state; with a plan, ``{"dense": the optimizer's
        state over the other parameters, "embed": {key: row state}}``."""
        plan = {k: v for k, v in self._embed_plan().items() if k in params}
        if not plan:
            return self.optimizer.init(params)
        kind, _hyper = self.optimizer.sparse_rows
        return {"dense": self.optimizer.init(
                    {k: v for k, v in params.items() if k not in plan}),
                "embed": {k: _embed.init_row_state(kind, params[k])
                          for k in sorted(plan)}}

    def _pop_stashed_rows(self) -> Dict[str, torch.Tensor]:
        """``{state-dict key: recv}`` the sharded lookups kept since the
        last call."""
        out = {}
        for name, module in self.model.named_modules():
            pop = getattr(module, "pop_stashed_rows", None)
            if pop is not None:
                for key, recv in pop().items():
                    out[f"{name}.{key}" if name else key] = recv
        return out

    def _check_mesh_loss(self) -> None:
        if self._ranks > 1 and self.direct_loss_fn is not None:
            raise NotImplementedError(
                "a captured (direct) loss on a mesh of more than one rank "
                "is not ported")

    def _check_mesh_statistics(self) -> None:
        """Batch statistics (BatchNorm in training) over more than one rank
        are not ported: they would be each rank's, not the global
        batch's."""
        if self._ranks > 1 and any(getattr(m, "batch_statistics", False)
                                   for m in self.model.modules()):
            from ..keras.layers.norm import SYNC_BN_TODO
            raise NotImplementedError(SYNC_BN_TODO.format(ranks=self._ranks))

    def _cast_inputs(self, x):
        """Mixed precision: float tensors of ``x`` -> ``compute_dtype``;
        integer ones stay as they are."""
        if self.compute_dtype is None:
            return x
        dtype = self.compute_dtype
        return tree_map(lambda t: t.to(dtype) if isinstance(t, torch.Tensor)
                        and t.is_floating_point() else t, x)

    def _ensure_initialized(self, features=None) -> None:
        """Build the model (for the shape of ``features``, a numpy tree with
        the record axis first, where it needs one), put it on the device,
        give it the dropout generator and create the optimizer state."""
        if not getattr(self.model, "built", True):
            shape = None if features is None else _input_shape(features)
            outer = default_mesh()
            set_default_mesh(self.mesh)  # the layers shard against it
            try:
                self.model.build(torch.Generator().manual_seed(self.seed),
                                 shape, device=self.device)
            finally:
                set_default_mesh(outer)
        elif any(p.device != self.device for p in self.model.parameters()):
            self.model.to(self.device)
        gen = self.dropout_generator
        if gen is None or gen.device != self.device:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.dropout_generator = gen
        if hasattr(self.model, "set_dropout_generator"):
            self.model.set_dropout_generator(gen)
        if self.opt_state is None and self.optimizer is not None:
            self.opt_state = self._init_opt_state(self._params())

    # -- one step -------------------------------------------------------------

    def _train_step(self, x, y) -> torch.Tensor:
        """Forward, loss, gradients and the optimizer update; returns the
        loss on the device (nothing here waits for the device, except the
        collectives on a mesh)."""
        params = self._params()
        x = self._cast_inputs(x)
        if self.direct_loss_fn is not None:
            loss = self.direct_loss_fn(self.model, x, y).float()
        else:
            loss = self.loss_fn(y, self.model(x).float())
        ranks = self._ranks
        if ranks > 1:
            loss = loss / ranks  # the ranks' sum is the global batch's mean
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        loss = loss.detach()
        if ranks > 1:
            loss = self._all_reduce_grads(grads, loss)
        plan = self._embed_plan()
        rows = self._pop_stashed_rows()
        if not plan:
            self.optimizer.step(params, grads, self.opt_state)
            return loss
        dense = [k for k in params if k not in plan]
        self.optimizer.step({k: params[k] for k in dense},
                            {k: grads[k] for k in dense},
                            self.opt_state["dense"])
        kind, hyper = self.optimizer.sparse_rows
        embed_state = self.opt_state["embed"]
        for key in sorted(plan):
            recv = rows.get(key)
            if recv is not None:
                embed_state[key] = _embed.apply_row_update(
                    kind, hyper, plan[key], params[key], grads[key], recv,
                    embed_state[key])
            else:
                embed_state[key] = _embed.apply_dense_update(
                    kind, hyper, params[key], grads[key], embed_state[key])
        return loss

    def _all_reduce_grads(self, grads: Dict[str, torch.Tensor],
                          loss: torch.Tensor) -> torch.Tensor:
        """Sum every gradient but the sharded tables' (already this rank's
        whole block) and the loss over the ranks, in one flat all-reduce;
        ``grads`` are replaced by the sums, the summed loss returned."""
        sharded = self._sharded_table_specs()
        keys = [k for k in grads if k not in sharded]
        flat = torch.cat([grads[k].reshape(-1) for k in keys]
                         + [loss.reshape(1)])
        self.mesh.all_reduce_(flat)
        offset = 0
        for k in keys:
            n = grads[k].numel()
            grads[k] = flat[offset:offset + n].view_as(grads[k])
            offset += n
        return flat[offset]

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
        self._check_mesh_loss()
        self._check_mesh_statistics()
        if batch_size % self._ranks:
            raise ValueError(f"the global batch {batch_size} does not divide "
                             f"over {self._ranks} ranks")
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
            feed = DeviceFeed(train_set.train_iterator(
                batch_size, skip_batches=skip, mesh=self._mesh_or_none()),
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

    def _mesh_or_none(self) -> Optional[Mesh]:
        """The mesh when it has more than one rank (one rank needs no
        sharding of batches)."""
        return self.mesh if self._ranks > 1 else None

    def _eval_batch(self, batch_size: int, size: int) -> int:
        """The global evaluation batch: ``batch_size`` capped at ``size``,
        rounded up to a multiple of the rank count."""
        b = max(1, min(batch_size, size))
        return -(-b // self._ranks) * self._ranks

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
        batch = self._eval_batch(batch_size, val_set.size)
        mesh = self._mesh_or_none()
        self._ensure_initialized(val_set.features)
        states = [m.init_state(self.device) for m in self.metrics]
        self.model.eval()
        batches = masked_eval_batches(
            val_set.eval_iterator(batch, pad_remainder=True, mesh=mesh),
            batch, mesh=mesh)
        with torch.inference_mode():
            for (bx, by, mask), _ in DeviceFeed(batches, self.device):
                y_pred = self._forward(bx).float()
                states = [m.update(s, by, y_pred, mask)
                          for m, s in zip(self.metrics, states)]
            if mesh is not None:
                for state in states:
                    for v in state.values():
                        mesh.all_reduce_(v)
        return metrics_mod.compute_all(self.metrics, states)

    def _evaluate_direct(self, val_set: FeatureSet, batch_size: int
                         ) -> Dict[str, float]:
        """``{"loss": ...}``: the captured loss averaged over the records,
        full batches and the tail unpadded, each batch weighted by its
        size (the JAX package's single-process ``_evaluate_direct``)."""
        if val_set.size == 0:
            raise ValueError("validation set is empty (0 records)")
        self._check_mesh_loss()
        local_batch = min(batch_size, val_set.size)
        self._ensure_initialized(val_set.features)
        self.model.eval()
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        with torch.inference_mode():
            for bx, by, valid in DeviceFeed(
                    val_set.eval_iterator(local_batch), self.device):
                total += self.direct_loss_fn(
                    self.model, self._cast_inputs(bx), by).double() * valid
        return {"loss": float(total) / val_set.size}

    def _forward(self, x):
        x = self._cast_inputs(x)
        return (self.forward_fn(self.model, x) if self.forward_fn is not None
                else self.model(x))

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        """Forward ``x`` (arrays, a list of arrays or a ``FeatureSet``) in
        batches of ``batch_size``; returns float32 numpy."""
        if not isinstance(x, FeatureSet):
            x = FeatureSet.from_ndarrays(x, None, shuffle=False)
        self._ensure_initialized(x.features)
        self.model.eval()
        mesh = self._mesh_or_none()
        outs = []
        with torch.inference_mode():
            if mesh is None:
                batches = x.eval_iterator(max(1, min(batch_size, x.size)))
            else:  # every rank its rows of padded batches, then gathered
                batches = x.eval_iterator(self._eval_batch(batch_size,
                                                           x.size),
                                          pad_remainder=True, mesh=mesh)
            for bx, _, valid in DeviceFeed(batches, self.device):
                out = self._forward(bx).float()
                if mesh is not None:
                    out = mesh.all_gather(out)[:valid]
                outs.append(out)
        if not outs:
            return np.zeros((0,), np.float32)
        return torch.cat(outs).cpu().numpy()

    # -- params / checkpoint --------------------------------------------------

    def get_params(self) -> Dict[str, Any]:
        """``{layer: {param: ndarray}}``, the JAX package's params tree
        (nested deeper where the layer nests, as BERT's blocks do). A
        vocab-sharded table reads whole, padded, from every rank's block:
        every rank must call this."""
        self._ensure_initialized()
        named = self._params()
        for key in self._sharded_table_specs():
            named[key] = self.mesh.all_gather(named[key].detach())
        return params_tree(named.items())

    def set_params(self, params) -> None:
        """Load a ``{layer: {param: array}}`` tree (the JAX package's, or
        :meth:`get_params`') or a flat ``{"layer.param": array}`` dict; it
        must name every parameter of the model. A vocab-sharded table may
        come whole, padded or not: this rank keeps its block."""
        self._ensure_initialized()
        sharded = self._sharded_table_specs()
        shard = (self.mesh.rank, self.mesh.size) if sharded else None
        if any(isinstance(v, Mapping) for v in params.values()):
            flat = from_jax_params(params, shard=shard, sharded=sharded)
        else:
            flat = {k: torch.as_tensor(np.asarray(v)) for k, v in
                    params.items()}
            for key in sharded:
                flat[key] = shard_rows(flat[key], *shard)
        named = self._params()
        if set(flat) != set(named):
            raise ValueError(
                f"params do not match the model: missing "
                f"{sorted(set(named) - set(flat))}, unexpected "
                f"{sorted(set(flat) - set(named))}")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(flat[k].to(p.dtype))

    def _state_names(self) -> List[str]:
        """The state-dict keys of the model's buffers (its state)."""
        params = set(self._params())
        return [k for k in self.model.state_dict() if k not in params]

    def get_model_state(self) -> Dict[str, Any]:
        """The model's state, ``{layer: {name: ndarray}}`` (the BatchNorm
        statistics; the JAX package's ``model_state``)."""
        self._ensure_initialized()
        sd = self.model.state_dict()
        return params_tree((k, sd[k]) for k in self._state_names())

    def set_model_state(self, state) -> None:
        """Load a ``{layer: {name: array}}`` state tree (the JAX package's
        ``model_state``, or :meth:`get_model_state`') or a flat
        ``{"layer.name": array}`` dict; it must name every buffer of the
        model."""
        self._ensure_initialized()
        if any(isinstance(v, Mapping) for v in state.values()):
            flat = from_jax_params(state)
        else:
            flat = {k: torch.as_tensor(np.asarray(v)) for k, v in
                    state.items()}
        names = self._state_names()
        if set(flat) != set(names):
            raise ValueError(
                f"state does not match the model: missing "
                f"{sorted(set(names) - set(flat))}, unexpected "
                f"{sorted(set(flat) - set(names))}")
        sd = self.model.state_dict()
        with torch.no_grad():
            for k in names:
                sd[k].copy_(flat[k].to(sd[k].dtype))

    def _snapshot(self) -> Dict[str, Any]:
        self._ensure_initialized()
        meta: Dict[str, Any] = {"global_step": self.global_step,
                                "epoch": self.epoch, "ranks": self._ranks,
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
        """Write a checkpoint directory holding one ``torch.save`` file per
        rank (:func:`checkpoint_file`: parameters, sharded tables' blocks
        and row state included), each through a temporary file renamed into
        place. On a mesh every rank calls this, and it returns once every
        rank's file is written."""
        file_io.makedirs(path, exist_ok=True)
        dst = file_io.join(path, checkpoint_file(self.mesh))
        tmp = dst + f".tmp{os.getpid()}"
        torch.save(self._snapshot(), tmp)
        file_io.replace(tmp, dst)
        if self._ranks > 1:
            self.mesh.barrier()

    def load_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` directory: parameters,
        optimizer state, epoch, global step, the dropout generator's state
        (saved on this device type; else it restarts from ``seed``), and
        the data state the next ``train`` resumes from. The model must
        be built (a ``Sequential`` needs its input shape). A checkpoint
        resumes only on as many ranks as saved it."""
        src = file_io.join(path, checkpoint_file(self.mesh))
        if not file_io.exists(src):
            raise ValueError(
                f"checkpoint at {path} has no {checkpoint_file(self.mesh)}: "
                f"it was not saved by {self._ranks} rank(s)")
        tree = torch.load(src, map_location="cpu", weights_only=True)
        missing = {"params", "opt_state", "meta"} - set(tree)
        if missing:
            raise ValueError(f"checkpoint at {path} is not an estimator "
                             f"snapshot (missing {sorted(missing)})")
        saved_ranks = int(tree["meta"].get("ranks", 1))
        if saved_ranks != self._ranks:
            raise ValueError(f"checkpoint at {path} was saved by "
                             f"{saved_ranks} rank(s), not {self._ranks}")
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
