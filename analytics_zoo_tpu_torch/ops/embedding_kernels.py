"""Embedding row gathers, bag pooling and the sharded backward's row
scatter-add (counterpart of ``analytics_zoo_tpu/ops/embedding_kernels.py``:
``gather_rows``, ``gather_rows_clip``, ``gather_pool``, ``segment_grads``,
``scatter_rows``, and the int8 tables' ``quantize_table``,
``gather_pool_int8`` and ``int8_error_bound``).

On a CUDA tensor every gather and scatter launches a hand-written kernel,
or raises; there is no fallback. ``csrc/gather_rows.cu`` replaces the TPU's
``_gather_kernel``, ``csrc/gather_pool.cu`` its ``_gather_pool_kernel``,
``csrc/gather_int8.cu`` its ``_gather_int8_kernel`` and
``csrc/scatter_rows.cu`` its ``_scatter_add_kernel``. On a CPU tensor a
wrapper runs the kernel's plain PyTorch version (:func:`gather_plain`,
:func:`gather_pool_plain`, :func:`gather_int8_plain`,
:func:`scatter_rows_plain`) with the same contract, which the tests hold
against the JAX package and which ``chip_smoke.py`` holds each kernel
against on the card. :func:`segment_grads` is plain PyTorch on every
device, as it is plain XLA in the JAX package.

The contracts are the TPU kernels', not ``jnp.take``'s: ``clip`` clamps ids
to ``[0, rows-1]``; fill mode writes zero rows for any id outside
``[0, rows)``, negative ids included; a masked pool leaves such ids out of
the sum and of the mean/sqrtn count. The TPU package's 128-lane rule
(``_lane_ok``) is dropped: every table width reaches the kernels, and the TPU's VMEM gate on the scatter (``SCATTER_VMEM_BYTES``)
too: every sharded backward on the card launches the scatter kernel
(ROADMAP Queue C7).
"""
from __future__ import annotations

from typing import Optional

import torch

from .int8_dataflow import dequant_int8, next_amax, quant_int8, scale_of_amax
from .kernel_build import LaunchCounts, load_library, on_card

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: the pool kernel's dtype and combiner codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_COMBINERS = {"sum": 0, "mean": 1, "sqrtn": 2}

launch_counts = LaunchCounts("gather_rows", "gather_pool", "gather_int8",
                             "scatter_rows")
reset_launch_counts = launch_counts.reset


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


def _check(table: torch.Tensor, ids: torch.Tensor, ids_dim: int = 1,
           dtypes=_DTYPES) -> None:
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D [rows, dim], got "
                         f"{tuple(table.shape)}")
    if table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"empty table {tuple(table.shape)}")
    if ids.dim() != ids_dim:
        want = "flat [n]" if ids_dim == 1 else "[n, bag]"
        raise ValueError(f"ids must be {want}, got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.dtype not in dtypes:
        raise TypeError(f"table dtype {table.dtype} not in {dtypes}")
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
    if not on_card(table, "gather"):
        return gather_plain(table, ids, clip)
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
    launch_counts.launched("gather_rows", rc)
    return out


def gather_pool_plain(table: torch.Tensor, ids: torch.Tensor, combiner: str,
                      clip: bool) -> torch.Tensor:
    """Plain PyTorch version of the pool kernel, the same arithmetic in the
    same order: ``ids`` ``[n, bag]``; f32 sums in bag order; out-of-range
    ids masked out of sum and count, or clamped with ``clip``."""
    rows = table.shape[0]
    n, bag = ids.shape
    got = table[ids.clamp(0, rows - 1).long()].float()  # [n, bag, dim]
    ok = None if clip else (ids >= 0) & (ids < rows)
    acc = torch.zeros((n, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    count = torch.full((n, 1), 0.0 if ok is not None else float(bag),
                       device=table.device)
    for k in range(bag):
        row = got[:, k]
        if ok is not None:
            row = torch.where(ok[:, k, None], row, torch.zeros_like(row))
            count = count + ok[:, k, None].float()
        acc = acc + row
    denom = count.clamp(min=1.0)
    if combiner == "mean":
        acc = acc / denom
    elif combiner == "sqrtn":
        acc = acc / torch.sqrt(denom)
    return acc.to(table.dtype)


def pool(table: torch.Tensor, ids: torch.Tensor, combiner: str,
         clip: bool) -> torch.Tensor:
    """The pool kernel's wrapper: ``out[i] = combine_k table[ids[i, k]]``
    for a contiguous 2-D table and int32 ids ``[n, bag]``. CPU tensors take
    :func:`gather_pool_plain`; CUDA tensors launch the kernel on the
    current stream."""
    _check(table, ids, ids_dim=2)
    if combiner not in _COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}; have "
                         f"{sorted(_COMBINERS)}")
    if not on_card(table, "gather_pool"):
        return gather_pool_plain(table, ids, combiner, clip)
    (n, bag), dim = ids.shape, table.shape[1]
    out = torch.empty((n, dim), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.azt_gather_pool(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, bag,
            table.shape[0], dim, _DTYPE_CODES[table.dtype],
            _COMBINERS[combiner], int(bool(clip)), stream)
    launch_counts.launched("gather_pool", rc)
    return out


class _GatherPool(torch.autograd.Function):
    """Gather (``combiner=None``) or pooled gather whose backward is a plain
    ``index_add_`` into a zero table, as JAX's ``_gather_pool_tpu_bwd`` is
    an XLA scatter-add. Unlike JAX's TPU backward, masked ids are those
    outside ``[0, rows)``, as in the forward kernel, and every id is clamped
    before the add: ``index_add_`` on the card faults on an out-of-range
    index where JAX's ``.at[].add`` drops it."""

    @staticmethod
    def forward(ctx, table, idx, combiner, mask_negative):
        ids = idx.to(torch.int32).contiguous()
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        ctx.combiner, ctx.mask_negative = combiner, mask_negative
        dim = table.shape[1]
        if combiner is None:
            rows = gather(table, ids.reshape(-1), clip=not mask_negative)
            return rows.reshape(tuple(ids.shape) + (dim,))
        pooled = pool(table, ids.reshape(-1, ids.shape[-1]), combiner,
                      clip=not mask_negative)
        return pooled.reshape(tuple(ids.shape[:-1]) + (dim,))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows, dim = ctx.rows, g.shape[-1]
        valid = None
        if ctx.mask_negative:
            valid = ((ids >= 0) & (ids < rows)).to(g.dtype)[..., None]
        if ctx.combiner is None:
            gk = g if valid is None else g * valid
        else:
            if ctx.combiner in ("mean", "sqrtn"):
                count = (torch.full_like(g[..., :1], float(ids.shape[-1]))
                         if valid is None else valid.sum(-2))
                count = count.clamp(min=1.0)
                g = g / (count if ctx.combiner == "mean"
                         else torch.sqrt(count))
            gk = g[..., None, :].expand(tuple(ids.shape) + (dim,))
            if valid is not None:
                gk = gk * valid
        safe = ids.reshape(-1).clamp(0, rows - 1).long()
        ct = torch.zeros((rows, dim), dtype=ctx.dtype, device=g.device)
        ct.index_add_(0, safe, gk.reshape(-1, dim).to(ctx.dtype))
        return ct, None, None, None


def gather_pool(table: torch.Tensor, idx: torch.Tensor,
                combiner: Optional[str] = None,
                mask_negative: bool = True) -> torch.Tensor:
    """Gather + padding mask + bag pooling over the trailing axis of
    ``idx``, with the TPU kernel's contract; differentiable in ``table``.

    ``combiner`` ``sum``, ``mean`` or ``sqrtn`` pools ``idx.shape[:-1] +
    (dim,)`` through the pool kernel; ``None`` gathers ``idx.shape +
    (dim,)`` through the row-gather kernel (fill mode when masked, clip mode
    otherwise, as ``_gather_pool_tpu`` routes it). ``mask_negative`` masks
    ids outside ``[0, rows)`` (zero rows, left out of the mean/sqrtn count);
    without it every id is clamped into the table first."""
    if combiner is not None and combiner not in _COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if combiner is not None and idx.dim() < 2:
        raise ValueError("a pooled gather_pool needs idx.ndim >= 2")
    return _GatherPool.apply(table.contiguous(), idx, combiner,
                             bool(mask_negative))


def gather_rows(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """Fill-mode row gather (out-of-range -> zero row). Not differentiated,
    as in the JAX package."""
    return gather(table, flat_ids.to(torch.int32).contiguous(), clip=False)


def gather_rows_clip(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Clip-mode row gather over any ``ids`` shape; differentiable in
    ``table``. Returns ``ids.shape + (dim,)``."""
    return gather_pool(table, ids, None, mask_negative=False)


# -- the sharded backward: segment sums and the row scatter-add ---------------


def segment_grads(g: torch.Tensor, inv: torch.Tensor, d: torch.Tensor,
                  slot: torch.Tensor, shards: int) -> torch.Tensor:
    """Sum the output cotangent ``g`` ``[n, dim]`` per unique id (``inv``
    maps each id to its unique) and place each unique's sum in its
    (destination, slot) cell of the request-shaped exchange buffer ``[shards,
    n, dim]``: an ``index_add_`` and an index write, on every device."""
    n = inv.shape[0]
    g_u = torch.zeros((n, g.shape[-1]), dtype=g.dtype, device=g.device)
    g_u.index_add_(0, inv.long(), g)
    out = torch.zeros((shards, n, g.shape[-1]), dtype=g.dtype,
                      device=g.device)
    out[d.long(), slot.long()] = g_u
    return out


def scatter_rows_plain(g: torch.Tensor, rows: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the scatter kernel: zeros ``[num_rows,
    dim]``, then ``index_add_`` of the rows of ``g`` whose ``rows`` lie in
    ``[0, num_rows)``; the others drop."""
    ok = (rows >= 0) & (rows < num_rows)
    out = torch.zeros((num_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    kept = rows[ok].long()
    if kept.numel():  # an empty index_add_ fails to launch on the card
        out.index_add_(0, kept, g[ok])
    return out


#: the scatter kernel's fill counters, one a (device, stream): two int64
#: that each launch finds and leaves at zero
_fill_counters: dict = {}


def fill_counter(device: torch.device) -> torch.Tensor:
    """The scatter kernel's fill counter for ``device``'s current stream,
    made (zeroed) at the stream's first launch."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    counter = _fill_counters.get(key)
    if counter is None:
        counter = torch.zeros(2, dtype=torch.int64, device=device)
        _fill_counters[key] = counter
    return counter


def scatter_rows(g_flat: torch.Tensor, rows: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """The scatter kernel's wrapper: the row-subset cotangent ``[num_rows,
    dim]`` f32 of a table shard, ``out[rows[j]] += g_flat[j]`` over a zeroed
    block for ``rows[j]`` in ``[0, num_rows)``, the rest dropped, for
    contiguous f32 ``g_flat`` ``[n, dim]`` and flat int32 ``rows``. CPU
    tensors take :func:`scatter_rows_plain`; CUDA tensors launch the kernel
    on the current stream, one launch for the fill and the adds
    (duplicate rows add with atomics, in no fixed order)."""
    if g_flat.dim() != 2 or rows.dim() != 1 \
            or rows.shape[0] != g_flat.shape[0]:
        raise ValueError(f"g must be [n, dim] and rows [n], got "
                         f"{tuple(g_flat.shape)} and {tuple(rows.shape)}")
    if g_flat.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g_flat.dtype}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if num_rows < 1 or g_flat.shape[1] < 1:
        raise ValueError(f"empty block [{num_rows}, {g_flat.shape[1]}]")
    if not (g_flat.is_contiguous() and rows.is_contiguous()):
        raise ValueError("g and rows must be contiguous")
    if g_flat.device != rows.device:
        raise ValueError(f"g on {g_flat.device}, rows on {rows.device}")
    if not on_card(g_flat, "scatter_rows"):
        return scatter_rows_plain(g_flat, rows, num_rows)
    n, dim = g_flat.shape
    if n == 0:
        return torch.zeros((num_rows, dim), dtype=torch.float32,
                           device=g_flat.device)
    out = torch.empty((num_rows, dim), dtype=torch.float32,
                      device=g_flat.device)
    lib = load_library()
    with torch.cuda.device(g_flat.device):
        stream = torch.cuda.current_stream(g_flat.device).cuda_stream
        rc = lib.azt_scatter_rows(g_flat.data_ptr(), rows.data_ptr(),
                                  out.data_ptr(), n, num_rows, dim,
                                  fill_counter(g_flat.device).data_ptr(),
                                  stream)
    launch_counts.launched("scatter_rows", rc)
    return out


# -- int8 tables ---------------------------------------------------------------


def gather_int8_plain(qtable: torch.Tensor, scale: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel: ``float(qtable[id]) *
    scale`` in f32 for ids in ``[0, rows)``, a zero row for any other id."""
    rows = qtable.shape[0]
    out = qtable[ids.clamp(0, rows - 1).long()].to(torch.float32) * scale
    ok = (ids >= 0) & (ids < rows)
    return torch.where(ok[:, None], out, torch.zeros_like(out))


def gather_int8(qtable: torch.Tensor, scale: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's wrapper: ``out[i] = float(qtable[ids[i]]) *
    scale``, f32 ``[n, dim]``, zero rows for ids outside ``[0, rows)``, for
    a contiguous 2-D int8 table, a 0-d f32 ``scale`` on the table's device
    and flat int32 ids. CPU tensors take :func:`gather_int8_plain`; CUDA
    tensors launch the kernel on the current stream, which reads the scale
    on the card (no host sync)."""
    _check(qtable, ids, dtypes=(torch.int8,))
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise TypeError(f"scale must be one f32 value, got {scale.dtype} "
                        f"{tuple(scale.shape)}")
    if scale.device != qtable.device:
        raise ValueError(f"scale on {scale.device}, table on "
                         f"{qtable.device}")
    if not on_card(qtable, "gather_int8"):
        return gather_int8_plain(qtable, scale.reshape(()), ids)
    n, dim = ids.shape[0], qtable.shape[1]
    out = torch.empty((n, dim), dtype=torch.float32, device=qtable.device)
    if n == 0:
        return out
    scale = scale.contiguous()
    lib = load_library()
    with torch.cuda.device(qtable.device):
        stream = torch.cuda.current_stream(qtable.device).cuda_stream
        rc = lib.azt_gather_int8(qtable.data_ptr(), scale.data_ptr(),
                                 ids.data_ptr(), out.data_ptr(), n,
                                 qtable.shape[0], dim, stream)
    launch_counts.launched("gather_int8", rc)
    return out


def gather_pool_int8(qtable: torch.Tensor, scale: torch.Tensor,
                     idx: torch.Tensor, combiner: Optional[str] = None,
                     mask_negative: bool = True) -> torch.Tensor:
    """:func:`gather_pool` over a :func:`quantize_table` table, routed as
    the JAX package routes it on the TPU; f32 out, forward only.

    ``combiner=None`` returns the int8 kernel's rows (:func:`gather_int8`)
    reshaped to ``idx.shape + (dim,)``, one launch on the card and no op
    after it, masked or not. The JAX package multiplies the TPU kernel's
    rows by ``idx >= 0`` when ``mask_negative``; that multiply is an
    identity on them, bit for bit: the kernel, and its plain version here,
    already write a zero row for every id outside ``[0, rows)``, negative
    ids included, and every other row is multiplied by 1.0. A pooled
    combiner (``sum``, ``mean``, ``sqrtn``) runs the plain dequantize, mask
    and pool ops on every device, as JAX does on the TPU too: rows of ids
    outside ``[0, rows)`` are zero, as the kernel's; with ``mask_negative``
    the mean/sqrtn count is the number of ids ``>= 0``, otherwise the bag
    size. Error against the f32 table: :func:`int8_error_bound`."""
    if combiner is not None and combiner not in _COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    ids = idx.to(torch.int32).contiguous()
    dim = qtable.shape[1]
    if combiner is None:
        rows = gather_int8(qtable, scale, ids.reshape(-1))
        return rows.reshape(tuple(ids.shape) + (dim,))
    if ids.dim() < 2:
        raise ValueError("a pooled gather_pool_int8 needs idx.ndim >= 2")
    nrows = qtable.shape[0]
    ok = (ids >= 0) & (ids < nrows)
    emb = dequant_int8(qtable[ids.clamp(0, nrows - 1).long()], scale,
                       torch.float32)
    emb = torch.where(ok[..., None], emb, torch.zeros_like(emb))
    valid = None
    if mask_negative:
        valid = (ids >= 0).to(torch.float32)[..., None]
        emb = emb * valid
    total = emb.sum(dim=-2)
    if combiner == "sum":
        return total
    if valid is not None:
        count = valid.sum(dim=-2).clamp(min=1.0)
    else:
        count = torch.full(tuple(total.shape[:-1]) + (1,),
                           float(ids.shape[-1]), device=total.device)
    if combiner == "mean":
        return total / count
    return total / torch.sqrt(count)  # sqrtn


def quantize_table(table: torch.Tensor,
                   running_amax: Optional[torch.Tensor] = None):
    """Symmetric int8 quantization of an embedding table with the delayed-
    scaling recipe of :mod:`.int8_dataflow`: ``scale = amax / 127``, the
    amax carried across calls as a fast-rise/slow-decay running value when
    ``running_amax`` is given. Returns ``(qtable int8, scale, amax)``, the
    last two 0-d f32 tensors on the table's device."""
    f = table.to(torch.float32)  # as JAX promotes a bf16 table / f32 scale
    seen = f.abs().max()
    amax = seen if running_amax is None else next_amax(
        torch.as_tensor(running_amax, dtype=torch.float32,
                        device=table.device), seen)
    scale = scale_of_amax(amax)
    return quant_int8(f, scale), scale, amax


def int8_error_bound(scale, bag_size: int = 1):
    """Worst-case absolute error of an int8 lookup against the f32 table:
    half a quantization step per element, times the bag size for a
    sum-pooled bag (mean and sqrtn divide it back down)."""
    return 0.5 * scale * bag_size
