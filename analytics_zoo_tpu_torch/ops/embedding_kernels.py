"""Embedding row gathers (counterpart of ``analytics_zoo_tpu/ops/
embedding_kernels.py``: ``gather_rows`` and ``gather_rows_clip``).

On a CUDA tensor every gather launches the hand-written kernel in
``csrc/gather_rows.cu`` (it replaces the TPU's ``_gather_kernel``), or
raises; there is no fallback. On a CPU tensor the wrapper runs
:func:`gather_plain`, the plain PyTorch version with the same contract,
which the tests hold against the JAX package and which ``chip_smoke.py``
holds the kernel against on the card.

The contract is the TPU kernel's, not ``jnp.take``'s: ``clip`` clamps ids to
``[0, rows-1]``; fill mode writes zero rows for any id outside ``[0, rows)``,
negative ids included. The TPU package's 128-lane rule (``_lane_ok``) is
dropped: every table width reaches the kernel.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from .kernel_build import load_library

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_count_lock = threading.Lock()
#: kernel launches per wrapper, counted where the kernel is launched and
#: nowhere else (``chip_smoke.py`` reads it to prove the path ran the kernel)
launch_counts: Dict[str, int] = {"gather_rows": 0}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def gather_plain(table: torch.Tensor, ids: torch.Tensor,
                 clip: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same inputs, same contract."""
    rows = table.shape[0]
    safe = ids.clamp(0, rows - 1).long()
    out = table[safe]
    if not clip:
        ok = (ids >= 0) & (ids < rows)
        out = torch.where(ok[:, None], out, torch.zeros_like(out))
    return out


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D [rows, dim], got "
                         f"{tuple(table.shape)}")
    if table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"empty table {tuple(table.shape)}")
    if ids.dim() != 1:
        raise ValueError(f"ids must be flat [n], got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table dtype {table.dtype} not in {_DTYPES}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")


def gather(table: torch.Tensor, ids: torch.Tensor,
           clip: bool) -> torch.Tensor:
    """The kernel's wrapper: ``out[i] = table[ids[i]]`` for a contiguous
    2-D table and flat int32 ids. CPU tensors take :func:`gather_plain`;
    CUDA tensors launch the kernel on the current stream."""
    _check(table, ids)
    if table.device.type == "cpu":
        return gather_plain(table, ids, clip)
    if table.device.type != "cuda":
        raise ValueError(f"no gather for device {table.device}")
    n, dim = ids.shape[0], table.shape[1]
    out = torch.empty((n, dim), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.azt_gather_rows(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
            table.shape[0], dim, table.element_size(), int(bool(clip)),
            stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        launch_counts["gather_rows"] += 1
    return out


class _GatherClip(torch.autograd.Function):
    """Clip gather whose backward is a plain ``index_add_`` into a zero
    table, as JAX's ``_gather_clip_tpu_bwd`` is an XLA scatter-add."""

    @staticmethod
    def forward(ctx, table, flat_ids):
        ctx.save_for_backward(flat_ids)
        ctx.rows = table.shape[0]
        return gather(table, flat_ids, clip=True)

    @staticmethod
    def backward(ctx, g):
        (flat_ids,) = ctx.saved_tensors
        safe = flat_ids.clamp(0, ctx.rows - 1).long()
        ct = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype,
                         device=g.device)
        return ct.index_add_(0, safe, g.contiguous()), None


def gather_rows(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """Fill-mode row gather (out-of-range -> zero row). Not differentiated,
    as in the JAX package."""
    return gather(table, flat_ids.to(torch.int32).contiguous(), clip=False)


def gather_rows_clip(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Clip-mode row gather over any ``ids`` shape; differentiable in
    ``table``. Returns ``ids.shape + (dim,)``."""
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    rows = _GatherClip.apply(table.contiguous(), flat)
    return rows.reshape(tuple(ids.shape) + (table.shape[1],))
