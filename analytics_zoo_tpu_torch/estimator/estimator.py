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

``steps_per_dispatch=K`` steps K batches from one stacked group, copied
to the device at once: the losses stay on the device until the group
ends, triggers are checked once a group (``TrainingState.dispatch_width``
is K, so interval triggers quantize to the group boundary) and groups never
span an epoch boundary. ``set_gradient_clipping`` clips every trainable
gradient after the mesh's all-reduce and before the optimizer (``("l2",
c)`` by the global norm, ``("const", (lo, hi))`` elementwise), and layers
a Keras model has frozen (``Model.freeze``) get no gradient and no
optimizer update.

Snapshots (``set_checkpoint``) are written by a background thread after a
synchronous copy to the host, one write in flight, into a staging
directory that is published by rename with a checksum manifest
(``zoo_manifest.json``) inside; the newest ``checkpoint.keep`` are kept.
A failed step restores the newest snapshot that verifies, falling back
past torn ones, within the ``failure.retry_times`` budget; a SIGTERM stops
the run at the next step or group boundary, writes a final snapshot and a
``PREEMPTED.json`` marker and raises :class:`PreemptedError`.
``train_online`` is ``train`` with an unbounded end and snapshots paced by
wall time.

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

import contextlib
import json
import logging
import os
import shutil
import signal
import threading
import time
import zlib
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import faults, file_io
from ..common import metrics as zoo_metrics
from ..common import profiler as _profiler
from ..common.config import global_config
from ..common.context import DeviceLike, resolve_device
from ..common.triggers import (EveryEpoch, MaxEpoch, MaxIteration, Never,
                               TimeInterval, Trigger, TrainingState)
from ..common.utils import time_it
from ..convert import from_jax_params, shard_rows
from ..feature.device_feed import DeviceFeed, masked_eval_batches
from ..feature.featureset import FeatureSet, _leaves, tree_map
from ..keras import metrics as metrics_mod
from ..keras import objectives
from ..keras import optimizers as optimizers_mod
from ..parallel import embedding as _embed
from ..parallel.mesh import Mesh, default_mesh, set_default_mesh

logger = logging.getLogger("analytics_zoo_tpu_torch")

#: the file a checkpoint directory holds (one rank)
CHECKPOINT_FILE = "estimator.pt"

#: resumable-preemption marker, written next to the snapshots
PREEMPT_MARKER = "PREEMPTED.json"

#: per-snapshot checksum manifest (inside each snapshot directory)
_MANIFEST_NAME = "zoo_manifest.json"


class CheckpointCorruptError(ValueError):
    """A snapshot failed checksum-manifest verification (torn write,
    bit-rot). Elastic restores skip it and fall back to the next older
    valid one."""


class PreemptedError(RuntimeError):
    """Training stopped on a preemption notice (SIGTERM or the
    ``train.preempt`` fault site). Where a checkpoint directory is set, a
    final snapshot and a resumable marker were written first;
    ``snapshot`` is its path (or None)."""

    def __init__(self, message: str, snapshot: Optional[str] = None):
        super().__init__(message)
        self.snapshot = snapshot


_M_STEP = zoo_metrics.histogram(
    "train.step_seconds",
    "Train-step dispatch latency (device sync included only when the "
    "loop syncs the loss).")
_M_EXAMPLES = zoo_metrics.counter(
    "train.examples_total", "Examples consumed by the train loop.")
_M_CKPT_WRITE = zoo_metrics.histogram(
    "ckpt.write_seconds", "Snapshot serialize+publish latency.")
_M_CKPT_VERIFY = zoo_metrics.histogram(
    "ckpt.verify_seconds", "Checksum-manifest verification latency.")
_M_CKPT_RESTORE = zoo_metrics.histogram(
    "ckpt.restore_seconds", "Snapshot restore latency (verify included).")
_M_CKPT_FALLBACK = zoo_metrics.counter(
    "ckpt.fallback_total",
    "Restores that skipped a torn/corrupt newest snapshot and fell back "
    "to an older one.")

#: step-phase attribution of the train loop (host_input / dispatch /
#: execute / fetch / compile a dispatch), active only under profile.enabled
_P_TRAIN = _profiler.StepProfiler("train")


def _profiled_feed(feed, prof):
    """Open each step's window just before its blocking ``next()``, so a
    wait on host input lands in this step's phases."""
    it = iter(feed)
    while True:
        prof.step_start()
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        prof.add("host_input", time.perf_counter() - t0, start=t0)
        yield item


def _dir_checksums(local_dir: str) -> Dict[str, List[int]]:
    """``{relpath: [size, crc32]}`` of every file under ``local_dir`` but
    the manifest. crc32 on purpose: the threat is torn writes and bit-rot,
    not an adversary, and the check must stay cheap next to the read it
    guards."""
    entries: Dict[str, List[int]] = {}
    for root, _dirs, files in os.walk(local_dir):
        for name in sorted(files):
            if name == _MANIFEST_NAME:
                continue
            p = os.path.join(root, name)
            rel = os.path.relpath(p, local_dir).replace(os.sep, "/")
            crc, size = 0, 0
            with open(p, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    crc = zlib.crc32(chunk, crc)
                    size += len(chunk)
            entries[rel] = [size, crc]
    return entries


def _write_manifest(local_dir: str) -> None:
    manifest = {"version": 1, "files": _dir_checksums(local_dir)}
    with open(os.path.join(local_dir, _MANIFEST_NAME), "w") as f:
        json.dump(manifest, f)


def _verify_manifest(local_dir: str, origin: str) -> bool:
    """Check ``local_dir`` against its manifest. False for a snapshot
    without one (nothing to verify); raises :class:`CheckpointCorruptError`
    on a size or checksum mismatch, a missing or an unexpected file."""
    mpath = os.path.join(local_dir, _MANIFEST_NAME)
    if not os.path.exists(mpath):
        return False
    t0 = time.perf_counter()
    with open(mpath) as f:
        manifest = json.load(f)
    want = {k: tuple(v) for k, v in manifest.get("files", {}).items()}
    have = {k: tuple(v) for k, v in _dir_checksums(local_dir).items()}
    _M_CKPT_VERIFY.observe(time.perf_counter() - t0)
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        corrupt = sorted(k for k in set(want) & set(have)
                         if want[k] != have[k])
        raise CheckpointCorruptError(
            f"checkpoint at {origin} failed checksum verification: torn "
            f"or corrupt snapshot (missing={missing[:4]}, "
            f"corrupt={corrupt[:4]}, unexpected={extra[:4]})")
    return True


class _AsyncSnapshotWriter:
    """One background snapshot write in flight, behind an explicit fence.

    The copy to the host happens on the loop's thread when the trigger
    fires; ``torch.save``, the manifest and the publish happen here.
    :meth:`wait` is the fence: before the next submit, before any restore
    and at the end of ``train``; a failed write surfaces there."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err

    def submit(self, fn) -> None:
        self.wait()  # at most one write in flight

        def run():
            try:
                fn()
            except BaseException as e:  # surfaced at the next fence
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="zoo-ckpt-writer")
        self._thread.start()


def _flat_losses(pending: List[torch.Tensor]) -> List[float]:
    """Per-step floats from the device losses of single steps (scalars)
    and groups (``[g]``), in order, with one copy to the host."""
    if not pending:
        return []
    return torch.cat([t.reshape(-1) for t in pending]).cpu().tolist()


def _stack(batches: List[Any]) -> Any:
    """``[g, ...]`` arrays from ``g`` host batch trees of one structure."""
    first = batches[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([b[i] for b in batches])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in batches]) for k in first}
    if first is None:
        return None
    return np.stack(batches)


def _group_host_batches(it, first_epoch_remaining: int, per_epoch: int,
                        k: int):
    """Stack up to ``k`` host batches into one ``[g, B, ...]`` group. A
    group never spans an epoch boundary (the epoch's last group is
    smaller), so epoch accounting and each epoch's shuffle stay exact."""
    remaining = int(first_epoch_remaining)
    while True:
        if remaining <= 0:
            remaining = per_epoch
        g = min(k, remaining)
        batches = []
        for _ in range(g):
            try:
                batches.append(next(it))
            except StopIteration:
                break
        if not batches:
            return
        yield _stack(batches)
        if len(batches) < g:
            return
        remaining -= g


def _host_copy(tree):
    """A copy of every tensor of ``tree`` on the host (a copy on the CPU
    too: the training goes on updating the live tensors in place)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)


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
        self._ckpt_writer = _AsyncSnapshotWriter()
        self._clip: Optional[Tuple[str, Any]] = None
        self._preempt_requested = False
        self._restore_data = None
        self._active_train_set: Optional[FeatureSet] = None
        #: the profiler books the first dispatch as compile, and counts a
        #: step's flops once
        self._prof_fresh_dispatch = True
        self._prof_cost_done = False

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

    def set_gradient_clipping(self, clip: Optional[Tuple[str, Any]]) -> None:
        """``("l2", c)``: scale the trainable gradients so that their global
        L2 norm is at most ``c`` (``optax.clip_by_global_norm``);
        ``("const", (lo, hi))``: clamp each element to ``[lo, hi]`` (to
        ``[-hi, hi]`` when ``|lo| == |hi|``, as ``optax.clip(hi)``); None:
        no clipping."""
        if clip is not None and clip[0] not in ("l2", "const"):
            raise ValueError(f"unknown gradient clipping {clip[0]!r}; use "
                             f"'l2' or 'const'")
        self._clip = clip

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

    def _frozen(self) -> frozenset:
        """The top-level layer names a Keras model has frozen."""
        return frozenset(getattr(self.model, "frozen_layers", ()) or ())

    def _train_step(self, x, y) -> torch.Tensor:
        """Forward, loss, gradients, clipping and the optimizer update;
        returns the loss on the device (nothing here waits for the device,
        except the collectives on a mesh). A frozen layer's parameters are
        left out of the gradients and of the update."""
        params = self._params()
        frozen = self._frozen()
        if frozen:
            params = {k: p for k, p in params.items()
                      if k.split(".", 1)[0] not in frozen}
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
        sharded_sq = None
        if ranks > 1:
            sharded = self._sharded_table_specs()
            if self._clip is not None and self._clip[0] == "l2":
                # a sharded table's gradient is this rank's block: its
                # squares join the global norm through the all-reduce
                blocks = [grads[k] for k in grads if k in sharded]
                sharded_sq = (torch.stack(torch._foreach_norm(blocks))
                              .square().sum() if blocks
                              else loss.new_zeros(()))
            loss, sharded_sq = self._all_reduce_grads(grads, loss,
                                                      sharded_sq)
        if self._clip is not None:
            self._clip_grads(grads, sharded_sq)
        plan = self._embed_plan()
        rows = self._pop_stashed_rows()
        if not plan:
            self._optimizer_step(params, grads, self.opt_state)
            return loss
        dense = [k for k in params if k not in plan]
        self._optimizer_step({k: params[k] for k in dense},
                             {k: grads[k] for k in dense},
                             self.opt_state["dense"])
        kind, hyper = self.optimizer.sparse_rows
        embed_state = self.opt_state["embed"]
        for key in sorted(plan):
            if key not in params:  # frozen
                continue
            recv = rows.get(key)
            if recv is not None:
                embed_state[key] = _embed.apply_row_update(
                    kind, hyper, plan[key], params[key], grads[key], recv,
                    embed_state[key])
            else:
                embed_state[key] = _embed.apply_dense_update(
                    kind, hyper, params[key], grads[key], embed_state[key])
        return loss

    def _optimizer_step(self, params, grads, opt_state) -> None:
        """``optimizer.step`` over ``params``, a subset of the parameters
        the state was made for when layers are frozen: the step sees the
        state of those parameters only (its tensors, updated in place, are
        the state's own), and the rest stays as it is."""
        names = set(params)
        sub = {k: ({n: t for n, t in v.items() if n in names}
                   if isinstance(v, dict) else v)
               for k, v in opt_state.items()}
        self.optimizer.step(params, grads, sub)
        for k, v in sub.items():
            if not isinstance(v, dict):  # counters
                opt_state[k] = v

    def _clip_grads(self, grads: Dict[str, torch.Tensor],
                    sharded_sq: Optional[torch.Tensor] = None) -> None:
        """Clip ``grads`` in place, in optax's arithmetic. ``sharded_sq``
        (on a mesh) is the sharded tables' squared norm summed over the
        ranks; it stands for those blocks in the global norm."""
        kind, value = self._clip
        gs = list(grads.values())
        if not gs:
            return
        if kind == "const":
            lo, hi = value
            if abs(lo) == abs(hi):
                lo = -hi  # optax.clip(hi) is symmetric
            torch._foreach_clamp_min_(gs, lo)
            torch._foreach_clamp_max_(gs, hi)
            return
        if sharded_sq is not None:
            sharded = self._sharded_table_specs()
            dense = [g for k, g in grads.items() if k not in sharded]
            sq = (torch.stack(torch._foreach_norm(dense)).square().sum()
                  if dense else sharded_sq.new_zeros(()))
            norm = torch.sqrt(sq + sharded_sq)
        else:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(gs)))
        # optax.clip_by_global_norm: t if norm < c else (t / norm) * c,
        # without a host sync
        keep = norm < value
        torch._foreach_div_(gs, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(gs, torch.where(keep, 1.0, float(value)))

    def _all_reduce_grads(self, grads: Dict[str, torch.Tensor],
                          loss: torch.Tensor,
                          extra: Optional[torch.Tensor] = None):
        """Sum every gradient but the sharded tables' (already this rank's
        whole block), the loss and ``extra`` (a scalar, or None) over the
        ranks, in one flat all-reduce; ``grads`` are replaced by the sums,
        ``(loss, extra)`` returned summed."""
        sharded = self._sharded_table_specs()
        keys = [k for k in grads if k not in sharded]
        tail = [loss.reshape(1)]
        if extra is not None:
            tail.append(extra.reshape(1).to(loss.dtype))
        flat = torch.cat([grads[k].reshape(-1) for k in keys] + tail)
        self.mesh.all_reduce_(flat)
        offset = 0
        for k in keys:
            n = grads[k].numel()
            grads[k] = flat[offset:offset + n].view_as(grads[k])
            offset += n
        return flat[offset], (flat[offset + 1] if extra is not None
                              else None)

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
        ``{"loss_history": [loss per step], "iterations": global step}``.

        A SIGTERM during this call stops the run at the next step (or
        group) boundary, writes a final snapshot and a ``PREEMPTED.json``
        marker where a checkpoint directory is set, and raises
        :class:`PreemptedError`; the handler is installed on the main
        thread only and the previous one is back when this returns. A
        leftover marker is removed here: resuming is ``load_checkpoint``
        of the snapshot, then ``train``. See :meth:`_train_impl` for the
        loop."""
        if (self.loss_fn is None and self.direct_loss_fn is None) \
                or self.optimizer is None:
            raise RuntimeError("train needs a loss_fn and an optimizer")
        self._preempt_requested = False
        restore_handler = self._install_preemption_handler()
        try:
            if self._ckpt_dir:
                marker = file_io.join(self._ckpt_dir, PREEMPT_MARKER)
                if file_io.exists(marker):
                    file_io.remove(marker)
            return self._train_impl(
                train_set, batch_size, epochs=epochs,
                end_trigger=end_trigger, validation_set=validation_set,
                validation_trigger=validation_trigger,
                checkpoint_trigger=checkpoint_trigger,
                steps_per_dispatch=steps_per_dispatch)
        finally:
            restore_handler()

    def train_online(self, train_set: FeatureSet, batch_size: int,
                     max_steps: Optional[int] = None,
                     end_trigger: Optional[Trigger] = None,
                     snapshot_interval_s: Optional[float] = None,
                     validation_set: Optional[FeatureSet] = None,
                     validation_trigger: Optional[Trigger] = None,
                     steps_per_dispatch: int = 1) -> Dict[str, Any]:
        """Continual training: unbounded by default (until preempted, or
        ``max_steps`` / ``end_trigger``), with snapshots paced by wall time
        (``snapshot_interval_s``, default config
        ``online.snapshot_interval_s``) when a checkpoint directory is set.
        Everything else is :meth:`train`."""
        if snapshot_interval_s is None:
            snapshot_interval_s = float(
                global_config().get("online.snapshot_interval_s"))
        if end_trigger is None:
            end_trigger = (MaxIteration(int(max_steps))
                           if max_steps is not None else Never())
        checkpoint_trigger = (TimeInterval(snapshot_interval_s)
                              if self._ckpt_dir else None)
        return self.train(
            train_set, batch_size, end_trigger=end_trigger,
            validation_set=validation_set,
            validation_trigger=validation_trigger,
            checkpoint_trigger=checkpoint_trigger,
            steps_per_dispatch=steps_per_dispatch)

    def _install_preemption_handler(self):
        """SIGTERM sets the preempt flag for the length of a ``train``
        call; returns the undo. Signals land on the main thread only: a
        ``train`` driven from another thread keeps the process's
        handler."""
        if threading.current_thread() is not threading.main_thread():
            return lambda: None
        try:
            prev = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:  # no signal support in this interpreter
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _on_sigterm(self, signum, frame) -> None:
        logger.warning("SIGTERM: preemption requested; a final snapshot "
                       "and a resumable marker follow at the next step "
                       "boundary")
        self._preempt_requested = True

    @staticmethod
    def preemption_marker(ckpt_dir: str) -> Optional[Dict[str, Any]]:
        """A checkpoint directory's preemption marker (None when the last
        run was not preempted)."""
        path = file_io.join(ckpt_dir, PREEMPT_MARKER)
        if not file_io.exists(path):
            return None
        with file_io.fopen(path) as f:
            return json.load(f)

    def _finalize_preemption(self, history: List[float],
                             pending: List[torch.Tensor]) -> None:
        """The preempt flag is set and the loop has stopped: drain the
        losses, fence the writer, write a final snapshot and the marker,
        and raise :class:`PreemptedError`."""
        try:
            history.extend(_flat_losses(pending))
        except Exception:
            logger.exception("a step failure surfaced while draining the "
                             "losses at preemption; the final snapshot "
                             "holds the last parameters")
        pending.clear()
        snap = None
        if self._ckpt_dir:
            try:
                self._ckpt_writer.wait()
            except RuntimeError:
                logger.exception("the background checkpoint write had "
                                 "failed; the preemption snapshot below "
                                 "replaces it")
            name = f"snapshot-{self.global_step}"
            snap = file_io.join(self._ckpt_dir, name)
            self._write_snapshot(snap, self._snapshot())
            with file_io.fopen(file_io.join(self._ckpt_dir, PREEMPT_MARKER),
                               "w") as f:
                json.dump({"global_step": self.global_step,
                           "epoch": self.epoch, "snapshot": name,
                           "resumable": True}, f)
        raise PreemptedError(
            f"training preempted (SIGTERM) at step {self.global_step}"
            + (f"; resume from {snap}" if snap
               else "; no checkpoint dir configured: progress lost"),
            snapshot=snap)

    def _dispatch(self, x, y, group: int) -> Tuple[torch.Tensor, int]:
        """Step one batch, or each batch of a ``[g, B, ...]`` group in
        order; returns the losses on the device (a scalar, or ``[g]``) and
        the steps taken."""
        if group == 1:
            return self._train_step(x, y), 1
        g = next(t for t in _leaves(x) if isinstance(t, torch.Tensor)
                 ).shape[0]
        losses = [self._train_step(tree_map(lambda t: t[i], x),
                                   tree_map(lambda t: t[i], y))
                  for i in range(g)]
        return torch.stack(losses), g

    def _train_impl(self, train_set: FeatureSet, batch_size: int,
                    epochs: Optional[int] = None,
                    end_trigger: Optional[Trigger] = None,
                    validation_set: Optional[FeatureSet] = None,
                    validation_trigger: Optional[Trigger] = None,
                    checkpoint_trigger: Optional[Trigger] = None,
                    steps_per_dispatch: int = 1) -> Dict[str, Any]:
        """The loop. ``steps_per_dispatch > 1`` steps K batches a dispatch
        from one stacked group: trigger checks and loss syncs come every K
        steps, interval triggers fire when a boundary was crossed inside
        the group, and ``MaxIteration`` may overshoot by up to K - 1
        steps. A failed step restores the newest valid snapshot and trains
        on, at most ``failure.retry_times`` times within
        ``failure.retry_interval_s``; past that the error reaches the
        caller, after the newest valid snapshot is restored."""
        self._check_mesh_loss()
        self._check_mesh_statistics()
        if batch_size % self._ranks:
            raise ValueError(f"the global batch {batch_size} does not divide "
                             f"over {self._ranks} ranks")
        cfg = global_config()
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
        retry_budget = int(cfg.get("failure.retry_times"))
        retry_window = float(cfg.get("failure.retry_interval_s"))
        retries_left = retry_budget
        last_failure = float("-inf")
        history: List[float] = []
        pending: List[torch.Tensor] = []  # device losses, drained per epoch
        need_loss = any(getattr(t, "requires_loss", True) for t in (
            end_trigger, validation_trigger, checkpoint_trigger))
        group = max(1, int(steps_per_dispatch))
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
            host_it = train_set.train_iterator(
                batch_size, skip_batches=skip, mesh=self._mesh_or_none())
            if group > 1:
                host_it = _group_host_batches(
                    host_it, batches_per_epoch - skip, batches_per_epoch,
                    group)
            feed = DeviceFeed(host_it, self.device)
            epoch_iter = self._epoch_offset = skip
            self.model.train()
            prof = _profiler.enabled()
            source = _profiled_feed(feed, _P_TRAIN) if prof else feed
            try:
                for x, y in source:
                    # a firing injection models a failure at a step's
                    # dispatch, which the retry below handles as a real one
                    faults.inject("train.step")
                    step_start = time.perf_counter()
                    counter = None
                    if prof and not self._prof_cost_done:
                        from torch.utils.flop_counter import FlopCounterMode
                        counter = FlopCounterMode(display=False)
                    with time_it("train_step"), (
                            counter or contextlib.nullcontext()):
                        losses, g = self._dispatch(x, y, group)
                    loss = losses[-1] if g > 1 else losses
                    if prof:
                        now = time.perf_counter()
                        _P_TRAIN.add("compile" if self._prof_fresh_dispatch
                                     else "dispatch", now - step_start,
                                     start=step_start)
                        self._prof_fresh_dispatch = False
                        if counter is not None:
                            # the cost model: a dispatch's flops as
                            # FlopCounterMode counts them (the aten ops it
                            # knows: a hand-written kernel's are not
                            # counted), once; PyTorch counts no bytes
                            self._prof_cost_done = True
                            _P_TRAIN.set_cost(counter.get_total_flops())
                        # a deliberate fence: the device's work becomes its
                        # own phase instead of hiding in the loss copy
                        t_x = time.perf_counter()
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                        _P_TRAIN.add("execute", time.perf_counter() - t_x,
                                     start=t_x)
                    self.global_step += g
                    epoch_iter += g
                    self._epoch_offset = epoch_iter
                    state.iteration = self.global_step
                    state.dispatch_width = g
                    pending.append(losses)
                    if need_loss:
                        with _P_TRAIN.phase("fetch"):
                            state.loss = float(loss)
                    _M_STEP.observe(time.perf_counter() - step_start)
                    _M_EXAMPLES.inc(batch_size * g)
                    if prof:
                        _P_TRAIN.step_end()
                    state.epoch_finished = epoch_iter >= batches_per_epoch
                    if state.epoch_finished:
                        # the epoch's one copy of its losses: a failure of
                        # an earlier step on the card surfaces here, inside
                        # the retry's reach
                        history.extend(_flat_losses(pending))
                        pending.clear()
                        state.epoch += 1
                        self.epoch = state.epoch
                    if validation_set is not None \
                            and validation_trigger(state):
                        results = self.evaluate(validation_set, batch_size)
                        state.score = next(iter(results.values()), None)
                        self.model.train()
                    if self._ckpt_dir and checkpoint_trigger(state):
                        self._save_snapshot()
                    if faults.inject("train.preempt"):
                        self._preempt_requested = True
                    if (self._preempt_requested or state.epoch_finished
                            or end_trigger(state)):
                        break
            except Exception:
                # elasticity: retry from the newest valid snapshot
                now = time.monotonic()
                if now - last_failure > retry_window:
                    retries_left = retry_budget  # sparse failures reset it
                last_failure = now
                retries_left -= 1
                pending.clear()  # the failed dispatch's losses
                try:
                    # a failed background write must not use up the retry
                    # or hide the step failure (publishing is atomic: the
                    # newest whole snapshot still loads)
                    self._ckpt_writer.wait()
                except RuntimeError:
                    logger.exception("the background checkpoint write had "
                                     "failed; retrying from the newest "
                                     "intact snapshot")
                if retries_left < 0 or not self._snapshot_candidates():
                    # budget used up (or nothing to restore): restore the
                    # newest valid snapshot first, so the caller gets a
                    # known-good state, then raise
                    if self._restore_latest_valid() is not None:
                        logger.error(
                            "retry budget exhausted after %d attempts; "
                            "parameters restored to the newest valid "
                            "snapshot (step %d)", retry_budget + 1,
                            self.global_step)
                    raise
                logger.exception("training step failed; resuming from "
                                 "checkpoint (%d retries left)",
                                 retries_left)
                if self._restore_latest_valid() is None:
                    logger.error("no snapshot survived verification; "
                                 "raising the step failure")
                    raise
                state.epoch = self.epoch
                state.iteration = self.global_step
                continue
            finally:
                feed.close()
            if self._preempt_requested:
                self._finalize_preemption(history, pending)
            state.epoch_finished = False
        if pending:
            try:
                history.extend(_flat_losses(pending))
            except Exception:
                if self._ckpt_dir and self._snapshot_candidates():
                    logger.exception("a trailing step failed; restoring the "
                                     "newest valid snapshot before raising")
                    self._restore_latest_valid()
                raise
            finally:
                pending.clear()
        # train must not return with a write in flight (and a failed
        # background write reaches the caller)
        self._ckpt_writer.wait()
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
        tail batch is padded and masked, as in the JAX package.
        ``eval.async = False`` takes the synchronous per-batch loop
        (``sync_eval``), which this equals bit for bit."""
        if self.direct_loss_fn is not None and not self.metrics:
            return self._evaluate_direct(val_set, batch_size)
        if not self.metrics:
            self.metrics = [metrics_mod.Loss(self.loss_fn)]
        if val_set.size == 0:
            raise ValueError("validation set is empty (0 records)")
        batch = self._eval_batch(batch_size, val_set.size)
        mesh = self._mesh_or_none()
        self._ensure_initialized(val_set.features)
        if not global_config().get("eval.async"):
            from . import sync_eval
            return sync_eval.evaluate_sync(self, val_set, batch)
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
        if not global_config().get("eval.async"):
            from . import sync_eval
            return sync_eval.evaluate_direct_single_sync(self, val_set,
                                                         local_batch)
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
        if not global_config().get("eval.async"):
            from . import sync_eval
            return sync_eval.predict_sync(self, x, batch_size)
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
        """The checkpoint's tree, copied to the host (synchronously: the
        only part of an asynchronous snapshot the loop waits for)."""
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
        return {"params": _host_copy(self.model.state_dict()),
                "opt_state": _host_copy(self.opt_state), "meta": meta}

    def _save_snapshot(self) -> None:
        """A triggered snapshot: the copy to the host now, the write and
        the pruning on the writer thread (after the previous write is
        fenced). On a mesh the write is a collective and stays on this
        thread."""
        path = file_io.join(self._ckpt_dir, f"snapshot-{self.global_step}")
        tree = self._snapshot()

        def write_then_prune():
            self._write_snapshot(path, tree)
            self._prune_snapshots()

        if self._ranks > 1:
            self._ckpt_writer.wait()
            write_then_prune()
        else:
            self._ckpt_writer.submit(write_then_prune)

    def _snapshot_candidates(self) -> List[Tuple[int, str]]:
        """``(step, path)`` of every published snapshot, by step. Only
        ``snapshot-<int>`` names count (not a ``.writing`` staging
        directory, nor a foreign entry)."""
        if not self._ckpt_dir or not file_io.isdir(self._ckpt_dir):
            return []
        out: List[Tuple[int, str]] = []
        for d in file_io.listdir(self._ckpt_dir):
            if not d.startswith("snapshot-") or d.endswith(".writing"):
                continue
            try:
                step = int(d[len("snapshot-"):])
            except ValueError:
                continue
            out.append((step, file_io.join(self._ckpt_dir, d)))
        out.sort()
        return out

    def _latest_snapshot(self) -> Optional[str]:
        cands = self._snapshot_candidates()
        return cands[-1][1] if cands else None

    def _restore_latest_valid(self) -> Optional[str]:
        """Restore the newest snapshot that verifies and loads, falling
        back past torn or corrupt newer ones. Returns its path, or None
        when none does."""
        for _step, path in reversed(self._snapshot_candidates()):
            try:
                self.load_checkpoint(path)
                return path
            except Exception:
                _M_CKPT_FALLBACK.inc()
                logger.exception("snapshot %s failed to restore; falling "
                                 "back to the next older one", path)
        return None

    def _prune_snapshots(self) -> None:
        """Keep the newest ``checkpoint.keep`` snapshots (the fallbacks a
        torn newest one needs) and delete the rest; rank 0 prunes on a
        mesh."""
        keep = int(global_config().get("checkpoint.keep") or 0)
        if keep <= 0 or (self._ranks > 1 and self.mesh.rank != 0):
            return
        for _step, path in self._snapshot_candidates()[:-keep]:
            try:
                file_io.rmtree(path)
            except Exception:
                logger.exception("failed to prune old snapshot %s", path)

    def save_checkpoint(self, path: str) -> None:
        """Write a checkpoint directory holding one ``torch.save`` file per
        rank (:func:`checkpoint_file`: parameters, sharded tables' blocks
        and row state included) and a checksum manifest of them. One rank
        writes a staging directory and publishes it by rename; on a mesh
        every rank calls this, writes its file in place, and rank 0 writes
        the manifest once every file is there."""
        self._ckpt_writer.wait()  # behind any write in flight
        self._write_snapshot(path, self._snapshot())

    def _write_snapshot(self, path: str, tree) -> None:
        with time_it("ckpt.write"):
            # a firing injection models the writer dying before the
            # publish: the previous snapshot stays the newest whole one
            faults.inject("ckpt.write")
            t0 = time.perf_counter()
            final = os.path.abspath(file_io.local_path(path))
            name = checkpoint_file(self.mesh)
            if self._ranks > 1:
                os.makedirs(final, exist_ok=True)
                dst = os.path.join(final, name)
                tmp = dst + f".tmp{os.getpid()}"
                torch.save(tree, tmp)
                os.replace(tmp, dst)
                self.mesh.barrier()
                if self.mesh.rank == 0:
                    _write_manifest(final)
                self.mesh.barrier()
            else:
                staging = final + ".writing"
                if os.path.exists(staging):  # a killed writer's leftover
                    shutil.rmtree(staging)
                os.makedirs(staging)
                torch.save(tree, os.path.join(staging, name))
                _write_manifest(staging)  # sealed into the same publish
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(staging, final)
            _M_CKPT_WRITE.observe(time.perf_counter() - t0)
        # tear the snapshot after its publish: the manifest must catch it
        # at restore, which falls back one older
        if faults.inject("ckpt.corrupt"):
            faults.tear_snapshot(path)

    def load_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` directory: parameters,
        optimizer state, epoch, global step, the dropout generator's state
        (saved on this device type; else it restarts from ``seed``), and
        the data state the next ``train`` resumes from. Under
        ``checkpoint.verify`` the directory is first held to its manifest
        (:class:`CheckpointCorruptError` on a mismatch; one without a
        manifest loads unverified). The model must be built (a
        ``Sequential`` needs its input shape). A checkpoint resumes only
        on as many ranks as saved it."""
        self._ckpt_writer.wait()  # a write in flight may be this snapshot
        t0 = time.perf_counter()
        local = os.path.abspath(file_io.local_path(path))
        if global_config().get("checkpoint.verify"):
            _verify_manifest(local, path)
        src = os.path.join(local, checkpoint_file(self.mesh))
        if not os.path.exists(src):
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
        _M_CKPT_RESTORE.observe(time.perf_counter() - t0)
