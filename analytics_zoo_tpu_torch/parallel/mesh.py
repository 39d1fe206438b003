"""Ranks and their collectives (counterpart of ``analytics_zoo_tpu/parallel/
mesh.py``), over ``torch.distributed``.

The JAX package declares a device mesh and lets XLA insert the
collectives. Here every rank is a process that runs the same program on its
share of each batch, and a :class:`Mesh` names what that process needs: its
rank, the number of ranks, the axis name the JAX package would give them
(``DATA_AXIS``), the process group and its backend, and this rank's device.
The collectives the port runs (the embedding exchange's all-to-all, the
dense gradients' all-reduce, the all-gather that reads a sharded table)
are methods of the mesh, so they all go through one process group.

:func:`init_mesh` wraps a default process group already initialised, or
initialises one from the usual ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT`` variables. A rank's device is ``cuda:(local_rank %
device_count)`` unless the caller names one, so several ranks may share
one card (with the gloo backend: NCCL refuses two ranks on one card). The
CPU must be asked for (``device="cpu"``), as everywhere in the port.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..common.context import DeviceLike, resolve_device
from ..feature.featureset import tree_map

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place among the ranks: ``rank`` of ``size`` on the
    axis ``axis``, its process ``group`` (None: the default group) with
    ``backend``, and the ``device`` its tensors live on."""
    rank: int
    size: int
    axis: str
    group: Any
    backend: str
    device: torch.device

    @property
    def axis_names(self):
        return (self.axis,)

    # -- collectives (every rank calls each, in the same order) ---------------

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block ``s`` of ``x`` ``[size, ...]`` goes to rank ``s``; block
        ``s`` of the result came from rank ``s`` (``lax.all_to_all`` with
        ``split_axis=0, concat_axis=0, tiled=True``)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns ``x``."""
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the first axis, in rank
        order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


_DEFAULT_MESH: Optional[Mesh] = None


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """Install the mesh that layers shard against when they build without
    one (:func:`init_mesh` and the Estimator set it)."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def default_mesh() -> Optional[Mesh]:
    return _DEFAULT_MESH


def _rank_device(device: DeviceLike, local_rank: int) -> torch.device:
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")  # raises NoCudaDeviceError without a card
    return resolve_device(f"cuda:{local_rank % torch.cuda.device_count()}")


def init_mesh(backend: Optional[str] = None,
              device: DeviceLike = None) -> Mesh:
    """This process's :class:`Mesh`, which also becomes the default mesh.

    With no default process group yet, one is initialised from ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; ``backend``
    defaults to ``nccl`` when every rank has a card of its own and to
    ``gloo`` otherwise (several ranks on one card, or the CPU). The device
    defaults to ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK``
    defaults to the rank)."""
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
        backend = str(dist.get_backend())
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"init_mesh needs an initialised process group or the "
                f"variables {missing}")
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
        if backend is None:
            own_card = (dev.type == "cuda"
                        and size <= torch.cuda.device_count())
            backend = "nccl" if own_card else "gloo"
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=size)
    mesh = Mesh(rank=rank, size=size, axis=DATA_AXIS, group=None,
                backend=backend, device=dev)
    set_default_mesh(mesh)
    return mesh


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows of a global batch (a numpy array or tensor, or a
    tuple/list/dict tree of them; None passes through): the ``rank``-th of
    ``size`` equal blocks of the first axis. The global batch must divide
    by the rank count."""

    def take(x):
        if x is None:
            return None
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{mesh.size} ranks")
        per = n // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return tree_map(take, batch)


def embedding_axis(mesh: Mesh) -> str:
    """The axis vocab-sharded tables partition over: ``DATA_AXIS`` when the
    mesh has it, else its first axis (the batch rides the same axis, so
    each rank requests rows for its own share of the batch)."""
    return DATA_AXIS if DATA_AXIS in mesh.axis_names else mesh.axis_names[0]

