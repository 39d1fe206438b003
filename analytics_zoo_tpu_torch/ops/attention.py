"""Attention (counterpart of ``analytics_zoo_tpu/ops/attention.py``):
``dot_product_attention``, the fused short-sequence attention that BERT
runs in every layer, the flash attention that the transformer LM trains
with at every length, ``blockwise_attention`` and the decode cache's
``masked_context``.

Layout at the public functions is the JAX package's: ``q``, ``k``, ``v``
``[batch, heads, seq, head_dim]``, and ``key_bias`` ``[batch, kv_len]`` in
natural-log units (the 0 / -1e9 padding bias BERT builds from its mask).

:func:`fused_short_attention` is exact softmax attention for
``q_len == kv_len <= FUSED_SHORT_MAX_SEQ``. Its forward launches the
hand-written CUDA kernel B7 (replacing the TPU's
``_fused_short_fwd_kernel``) and its backward B8 (replacing
``_fused_short_bwd_kernel``) on a CUDA tensor, or raises; there is no
fallback. The dtype picks the route, and both run on the tensor cores
(``mma.sync``): bf16 in ``csrc/fused_short_attn_bf16.cu``, f32 as 3xTF32
(each f32 operand split into two TF32 parts, three TF32 products for one
f32-grade product) in ``csrc/fused_short_attn.cu``; ``route_counts``
counts each launch by route. On a CPU tensor each runs its plain PyTorch
version (:func:`fused_short_attention_plain`, :func:`fused_short_bwd_plain`),
the same arithmetic, which the tests hold against the JAX package and which
``chip_smoke.py`` holds each kernel against on the card.

The arithmetic, in both versions: scores ``q·k`` in f32, times
``scale·log2(e)`` in f32 (folded into the f32 score, not into ``q``: the
TPU kernel rounds the pre-scaled ``q`` to its dtype), plus
``key_bias·log2(e)`` in f32 (the TPU kernel rounds it to bf16), a causal
mask of ``-1e30`` above the diagonal, softmax in ``exp2`` with IEEE
division, then dropout, then ``p·v`` with sums in f32. ``pd`` is rounded
to the inputs' dtype before ``pd·v`` and ``pdᵀ·dO``, and ``ds`` before
``ds·k`` and ``dsᵀ·q``, where the TPU kernel rounds them (no-ops in f32).
Both backwards read each row's softmax max and sum (``stats``) from their
forward. The bf16 backward takes ``D = rowsum(dp·p)`` in f32; the f32
backward takes it as ``rowsum(dO·o)`` from the forward's output, equal in
exact arithmetic.

Dropout keeps an entry where its 32 random bits are at or above
``min(int(rate·2^32), 2^32-1)`` and scales it by ``1/(1-rate)``, the TPU
kernel's rule. The bits are not the TPU PRNG's: they are murmur3's 32-bit
hash of the words ``(bh, row, col)`` keyed by the call's seed
(:func:`dropout_bits`), so the mask depends on nothing but the seed and the
entry, and B7, B8 and the plain versions draw the same mask whatever their
tiling. The seed is drawn once per call from the model's dropout generator
and stays on the device.

:func:`flash_attention` (and :func:`flash_attention_lse`) stream over the
keys for any lengths, ``q_len`` and ``kv_len`` apart, with the causal mask
aligned top-left (row >= col in absolute indices). On a CUDA tensor the
forward launches B4 (replacing ``_flash_fwd_kernel``) and always saves the
row logsumexp in natural-log units; the backward launches the one-pass B6
(replacing ``_flash_bwd_fused_kernel``) where :func:`fused_bwd_applicable`
holds, else B5a then B5b (replacing ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``). The dtype and the kernel pick its route
(:func:`flash_route`, counted in ``flash_route_counts``): every kernel
runs on the tensor cores (``mma.sync``), bf16 in
``csrc/flash_attn_bf16.cu`` and f32 as 3xTF32 in
``csrc/flash_attn_tf32.cu``. On a CPU tensor each runs its plain
version (:func:`flash_fwd_plain`, :func:`flash_bwd_dq_plain`,
:func:`flash_bwd_dkv_plain`, :func:`flash_bwd_fused_plain`), the same
function in full-row softmax over chunks of query rows. The arithmetic is
B7's: f32 scores in ``exp2`` units, masked scores ``-1e30``, the
denominator floored at ``1e-30``; every flash kernel rounds ``p`` to the
inputs' dtype before ``p·v`` and ``pᵀ·dO``, and ``ds`` before ``ds·k`` and
``dsᵀ·q``, where the TPU kernel rounds them (no-ops in f32), so the two
backward designs' plain versions give the same gradients bit for bit. A
``[b, 1, 1, kv]`` key bias runs inside B4; its backward is autograd
through :func:`blockwise_attention`, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .kernel_build import LaunchCounts, load_library, on_card

#: the longest sequence the fused kernels take (the TPU's VMEM budget for
#: the [s, s] block; here the shared memory of the backward's dq pass)
FUSED_SHORT_MAX_SEQ = 512
#: the widest head the CUDA kernels take (16 f32 accumulators per thread);
#: the plain versions take any
FUSED_SHORT_MAX_HEAD_DIM = 128
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_DTYPES = (torch.float32, torch.bfloat16)

#: one B8 launch is the two passes of one backward
launch_counts = LaunchCounts("fused_short_fwd", "fused_short_bwd")
#: B7 and B8 launches by route: bf16 and f32 (as 3xTF32), both on the
#: tensor cores
route_counts = LaunchCounts("bf16_tc", "f32_tc")
#: B4, B5a, B5b and B6
flash_launch_counts = LaunchCounts("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "flash_bwd_fused")
#: B4, B5a, B5b and B6 launches by route: bf16 and f32 (as 3xTF32), both
#: on the tensor cores
flash_route_counts = LaunchCounts("bf16_tc", "f32_tc")


def reset_launch_counts() -> None:
    """Set every attention kernel's count to 0."""
    launch_counts.reset()
    route_counts.reset()
    flash_launch_counts.reset()
    flash_route_counts.reset()


def fused_short_route(dtype: torch.dtype) -> str:
    """The fused kernels' route for inputs of ``dtype``: ``"bf16_tc"`` (the
    tensor cores in bf16) or ``"f32_tc"`` (the tensor cores as 3xTF32)."""
    return "bf16_tc" if dtype == torch.bfloat16 else "f32_tc"


def flash_route(dtype: torch.dtype, kernel: str) -> str:
    """The route of the flash ``kernel`` (a ``flash_launch_counts`` name:
    ``"flash_fwd"`` B4, ``"flash_bwd_dq"`` B5a, ``"flash_bwd_dkv"`` B5b,
    ``"flash_bwd_fused"`` B6) for inputs of ``dtype``: ``"bf16_tc"`` (the
    tensor cores, ``csrc/flash_attn_bf16.cu``) or ``"f32_tc"`` (the tensor
    cores as 3xTF32, ``csrc/flash_attn_tf32.cu``)."""
    if kernel not in flash_launch_counts:
        raise ValueError(f"no flash kernel {kernel!r}")
    return "bf16_tc" if dtype == torch.bfloat16 else "f32_tc"


# -- dropout bits ------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in ``[0, 2^32)``: ``c`` in 16-bit
    halves, so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _mix(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One murmur3_32 block: ``k`` mixed into the running hash ``h``."""
    k = _mul32(_rotl(_mul32(k, 0xCC9E2D51), 15), 0x1B873593)
    return (_rotl(h ^ k, 13) * 5 + 0xE6546B64) & _M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _entry_bits(seed, rows: torch.Tensor, cols: torch.Tensor,
                bh: int) -> torch.Tensor:
    """murmur3_32 of ``(bh index, row, col)`` keyed by ``seed`` for the
    absolute ``rows`` and ``cols`` given: ``[bh, len(rows), len(cols)]``
    int64 in ``[0, 2^32)``."""
    dev = seed.device if isinstance(seed, torch.Tensor) else rows.device
    h = torch.as_tensor(seed, device=dev).reshape(1, 1, 1).long() & _M32
    h = _mix(h, torch.arange(bh, device=dev, dtype=torch.int64)[:, None,
                                                                   None])
    h = _mix(h, rows.to(dev, torch.int64)[None, :, None])
    h = _mix(h, cols.to(dev, torch.int64)[None, None, :])
    return _fmix(h ^ 12)  # 12: the three words' length in bytes


def dropout_bits(seed, bh: int, s: int) -> torch.Tensor:
    """The kernels' random bits, ``[bh, s, s]`` int64 in ``[0, 2^32)``:
    murmur3_32 of the three words ``(bh, row, col)`` with ``seed`` as its
    seed. ``seed`` is an int or a one-element integer tensor (its device is
    the result's)."""
    dev = seed.device if isinstance(seed, torch.Tensor) else None
    idx = torch.arange(s, device=dev, dtype=torch.int64)
    return _entry_bits(seed, idx, idx, bh)


def keep_threshold(rate: float) -> int:
    """Bits at or above this are kept: ``min(int(rate·2^32), 2^32-1)``."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep_mask(seed, bh: int, s: int, rate: float) -> torch.Tensor:
    """The plain rendering of the kernels' dropout mask, ``[bh, s, s]``
    bool: True where an attention probability is kept."""
    return dropout_bits(seed, bh, s) >= keep_threshold(rate)


# -- plain versions ----------------------------------------------------------


def _probs(q, k, key_bias, scale: float, causal: bool,
           with_stats: bool = False):
    """Pre-dropout probabilities ``[b, h, s, s]`` f32, the kernels'
    arithmetic; differentiable. With ``with_stats``, also each row's max
    (exp2 units) and sum, ``[2, b, h, s]``."""
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (scale * _LOG2E)
    if key_bias is not None:
        s2 = s2 + (key_bias.float() * _LOG2E)[:, None, None, :]
    if causal:
        n = s2.shape[-1]
        above = torch.ones(n, n, dtype=torch.bool,
                           device=s2.device).triu(1)
        s2 = s2.masked_fill(above, _NEG_INF)
    m = s2.amax(-1, keepdim=True).detach()
    e = torch.exp2(s2 - m)
    l = e.sum(-1, keepdim=True)
    if with_stats:
        return e / l, torch.stack([m[..., 0], l[..., 0].detach()])
    return e / l


def _keep(seed, q: torch.Tensor, rate: float) -> Optional[torch.Tensor]:
    if rate <= 0.0:
        return None
    b, h, s, _ = q.shape
    return dropout_keep_mask(seed, b * h, s, rate).reshape(b, h, s, s)


class _RoundTo(torch.autograd.Function):
    """f32 ``x`` rounded to ``dtype`` and back; its gradient passes through
    unrounded, as the kernels keep the gradient at that point in f32."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to f32, where the TPU kernel
    casts an operand to the inputs' dtype (a no-op in f32)."""
    return x if dtype == torch.float32 else _RoundTo.apply(x, dtype)


def fused_short_attention_plain(q, k, v, key_bias=None,
                                scale: Optional[float] = None,
                                rate: float = 0.0, seed=None,
                                causal: bool = False,
                                with_stats: bool = False):
    """Plain PyTorch version of B7: same inputs, same arithmetic, same
    dropout mask; differentiable, so autograd through it is the reference
    for B8. With ``with_stats``, returns ``(o, stats)``: each row's
    softmax max (exp2 units) and sum, ``[2, b, h, s]`` f32, as the kernels
    save them."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, stats = _probs(q, k, key_bias, scale, causal, with_stats=True)
    keep = _keep(seed, q, rate)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    o = torch.matmul(_rounded(p, v.dtype), v.float()).to(v.dtype)
    return (o, stats) if with_stats else o


def fused_short_bwd_plain(q, k, v, do, key_bias, scale: float, rate: float,
                          seed, causal: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B8, its arithmetic written out: recompute
    ``p`` and the mask; ``dv = pdᵀ·dO``; ``dp`` through the mask;
    ``ds = p·(dp − rowsum(dp·p))``; ``dq = scale·ds·k``;
    ``dk = scale·dsᵀ·q``."""
    p = _probs(q, k, key_bias, scale, causal)
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    keep = _keep(seed, q, rate)
    pd = p
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = torch.matmul(_rounded(pd, v.dtype).transpose(-1, -2), dof)
    ds = _rounded(p * (dp - (dp * p).sum(-1, keepdim=True)), q.dtype)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dot_product_attention(q, k, v, bias=None, causal: bool = False,
                          scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Reference attention, ``softmax(q kᵀ·scale + bias) v`` with scores in
    f32 and optional dropout of the probabilities drawn from ``generator``
    (the JAX package's ``dot_product_attention``; what ``use_flash=False``
    takes). ``bias`` broadcasts against ``[b, h, q_len, kv_len]``."""
    q_len, kv_len = q.shape[-2], k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        above = torch.ones(q_len, kv_len, dtype=torch.bool,
                           device=q.device).triu(1)
        scores = scores.masked_fill(above, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = 1.0 - dropout_rate
        mask = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < keep
        probs = torch.where(mask, probs / keep, 0.0)
    return torch.matmul(probs.to(v.dtype), v)


# -- the kernels' wrappers ---------------------------------------------------


def _check_head_dim(q, most: int) -> None:
    """Raise on an empty head, and on a CUDA tensor's head wider than
    ``most``, the widest the CUDA kernels take; the plain versions, which
    CPU tensors take, compute any width, as the JAX package does."""
    d = q.shape[-1]
    if d < 1 or (q.device.type == "cuda" and d > most):
        raise ValueError(f"head_dim {d} outside [1, {most}] (the CUDA "
                         f"kernels' widths)")


def _check(tensors, key_bias, seed, rate: float) -> None:
    """Raise on what the kernels do not take."""
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"q must be [b, h, s, d], got {tuple(q.shape)}")
    b, _, s, _ = q.shape
    for t in tensors:
        if t.shape != q.shape:
            raise ValueError(f"shapes differ: {tuple(t.shape)} vs "
                             f"{tuple(q.shape)} (the fused kernel needs "
                             f"q_len == kv_len)")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v (and dO) must share dtype and device")
        if not t.is_contiguous():
            raise ValueError("the fused attention kernels take contiguous "
                             "[b, h, s, d] tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not in {list(_DTYPES)}")
    if not 1 <= s <= FUSED_SHORT_MAX_SEQ:
        raise ValueError(f"seq {s} outside [1, {FUSED_SHORT_MAX_SEQ}]")
    _check_head_dim(q, FUSED_SHORT_MAX_HEAD_DIM)
    if key_bias is not None and (
            key_bias.shape != (b, s) or key_bias.dtype != torch.float32
            or key_bias.device != q.device or not key_bias.is_contiguous()):
        raise ValueError(f"key_bias must be contiguous f32 [{b}, {s}] on "
                         f"{q.device}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate > 0.0 and (seed is None or seed.dtype != torch.int32
                       or seed.numel() != 1 or seed.device != q.device):
        raise ValueError("dropout needs a one-element int32 seed on the "
                         "inputs' device")


def _check_saved(q, stats, o) -> None:
    """Raise unless ``stats`` (and, on the f32 route, ``o``) are what B7
    returned for ``q``."""
    want = (2,) + tuple(q.shape[:-1])
    if stats is None:
        raise ValueError("the backward needs the row stats its forward "
                         "returned (fused_short_fwd)")
    if (tuple(stats.shape) != want or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous f32 {want} on "
                         f"{q.device}")
    if q.dtype == torch.float32 and (
            o is None or o.shape != q.shape or o.dtype != q.dtype
            or o.device != q.device or not o.is_contiguous()):
        raise ValueError("the f32 backward needs the forward's output o, "
                         "contiguous and like q")


def _launch_args(q, key_bias, seed, scale: float, rate: float):
    b, h, s, d = q.shape
    drop = rate > 0.0
    return dict(
        bias=key_bias.data_ptr() if key_bias is not None else None,
        seed=seed.data_ptr() if drop else None,
        dims=(b * h, h, s, d),
        thresh=keep_threshold(rate) if drop else 0,
        inv=1.0 / (1.0 - rate) if drop else 1.0,
        scale_log2e=scale * _LOG2E)


def fused_short_fwd(q, k, v, key_bias, seed, scale: float, rate: float,
                    causal: bool):
    """B7's wrapper: ``[b, h, s, d]`` contiguous f32/bf16 in; ``(o,
    stats)`` out, ``o`` like ``q`` and ``stats`` the rows' softmax max and
    sum ``[2, b, h, s]`` f32 that the backward reads. CPU tensors take
    :func:`fused_short_attention_plain`; CUDA tensors launch the kernel of
    the dtype's route on the current stream."""
    _check((q, k, v), key_bias, seed, rate)
    route = fused_short_route(q.dtype)
    if not on_card(q, "fused_short_fwd"):
        return fused_short_attention_plain(q, k, v, key_bias, scale, rate,
                                           seed, causal, with_stats=True)
    o = torch.empty_like(q)
    stats = torch.empty((2,) + q.shape[:-1], dtype=torch.float32,
                        device=q.device)
    a = _launch_args(q, key_bias, seed, scale, rate)
    lib = load_library()
    fn = (lib.azt_fused_short_fwd_bf16 if route == "bf16_tc"
          else lib.azt_fused_short_fwd_f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), a["bias"],
                a["seed"], o.data_ptr(), stats.data_ptr(), *a["dims"],
                a["scale_log2e"], a["thresh"], a["inv"], int(bool(causal)),
                stream)
    launch_counts.launched("fused_short_fwd", rc)
    route_counts.launched(route, rc)
    return o, stats


def fused_short_bwd(q, k, v, do, key_bias, seed, scale: float, rate: float,
                    causal: bool, stats=None, o=None):
    """B8's wrapper: ``(dq, dk, dv)`` for contiguous ``[b, h, s, d]``
    inputs and ``do``. Both routes read the row ``stats`` that
    :func:`fused_short_fwd` returned; the f32 route also reads its output
    ``o``, for ``D = rowsum(dO·o)``. CPU tensors take
    :func:`fused_short_bwd_plain`; CUDA tensors launch the kernel (a dq
    pass, then a dk/dv pass, each recomputing ``p``: no atomics) on the
    current stream."""
    _check((q, k, v, do), key_bias, seed, rate)
    route = fused_short_route(q.dtype)
    _check_saved(q, stats, o)
    if not on_card(q, "fused_short_bwd"):
        return fused_short_bwd_plain(q, k, v, do, key_bias, scale, rate,
                                     seed, causal)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    b, h, s, _ = q.shape
    a = _launch_args(q, key_bias, seed, scale, rate)
    lib = load_library()
    # per query row: rowsum(dp·p), from the dq pass to the dk/dv pass
    delta = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "bf16_tc":
            rc = lib.azt_fused_short_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                a["bias"], a["seed"], stats.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *a["dims"],
                a["scale_log2e"], scale, a["thresh"], a["inv"],
                int(bool(causal)), stream)
        else:
            rc = lib.azt_fused_short_bwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), a["bias"], a["seed"], stats.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *a["dims"], a["scale_log2e"], scale,
                a["thresh"], a["inv"], int(bool(causal)), stream)
    launch_counts.launched("fused_short_bwd", rc)
    route_counts.launched(route, rc)
    return dq, dk, dv


class _FusedShort(torch.autograd.Function):
    """Forward B7, backward B8; the bias is a padding mask and gets no
    gradient (the JAX package's contract). The forward saves the rows'
    softmax statistics and its output for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, scale, rate, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kb = None if key_bias is None else key_bias.float().contiguous()
        o, stats = fused_short_fwd(q, k, v, kb, seed, scale, rate, causal)
        ctx.save_for_backward(q, k, v, kb, seed, stats, o)
        ctx.args = (scale, rate, causal)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, kb, seed, stats, o = ctx.saved_tensors
        scale, rate, causal = ctx.args
        dq, dk, dv = fused_short_bwd(q, k, v, g.contiguous(), kb, seed,
                                     scale, rate, causal, stats, o)
        return dq, dk, dv, None, None, None, None, None


def fused_short_attention(q, k, v, key_bias=None,
                          scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          causal: bool = False) -> torch.Tensor:
    """Exact fused attention for ``q_len == kv_len <= 512``: B7 forward and
    B8 backward on the card, their plain versions on the CPU. ``key_bias``:
    optional ``[b, kv_len]`` additive per-key bias. Dropout runs when
    ``dropout_rate > 0`` and a ``generator`` (on the inputs' device) is
    given: one seed is drawn from it per call, on the device, and the
    backward reuses it."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    rate, seed = 0.0, None
    if dropout_rate > 0.0 and generator is not None:
        rate = float(dropout_rate)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=q.device, dtype=torch.int32)
    return _FusedShort.apply(q, k, v, key_bias, seed, scale, rate, causal)


def fused_short_applicable(q_len: int, kv_len: int, causal: bool) -> bool:
    """Whether the fused kernels take these lengths. The JAX package also
    asks for a TPU; here the CPU takes the same branch through the plain
    versions, so the CPU and the card draw the same dropout mask."""
    del causal  # the kernels mask above the diagonal themselves
    return q_len == kv_len and kv_len <= FUSED_SHORT_MAX_SEQ


# -- flash attention (B4, B5a, B5b, B6) ---------------------------------------

#: the JAX package's default tile sizes; here they cut the plain
#: :func:`blockwise_attention` (the kernels cut fixed 64-row tiles)
DEFAULT_Q_BLOCK = 512
DEFAULT_KV_BLOCK = 1024
#: the widest head the CUDA flash kernels take; the plain versions take any
FLASH_MAX_HEAD_DIM = 128
_LN2 = 1.0 / _LOG2E
#: the JAX package's budget for its one-pass backward: K/V in their dtype
#: and dk/dv f32 accumulators per batch·head, ``kv_len·d·(2·itemsize + 8)``
#: bytes; above it the two-pass design runs. Kept so that a shape takes the
#: same design on both packages.
_FUSED_BWD_MAX_RESIDENT_BYTES = 6_600_000
#: query rows per chunk in the plain versions (bounds their ``[rows, kv]``
#: temporaries)
_PLAIN_Q_CHUNK = 512


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(n, cap), 0, -1):
        if n % c == 0:
            return c
    return 1


def fused_bwd_applicable(kv_len: int, d: int, itemsize: int = 2) -> bool:
    """Whether the backward takes the one-pass kernel B6 (else B5a + B5b):
    the JAX package's resident-bytes test (``_fused_bwd_applicable``).
    Its lane-tiling term (``bq % 128 == 0 or bq == q_len``) and
    ``_lse_tile_ok`` are dropped: they are rules of the TPU's (8, 128)
    tiles, off which the TPU takes an XLA backward; the CUDA kernels cut
    fixed tiles and mask ragged ones."""
    return kv_len * d * (2 * itemsize + 8) <= _FUSED_BWD_MAX_RESIDENT_BYTES


def _scores2(q, k, key_bias, scale: float, causal: bool, row0: int):
    """Scores in exp2 units, f32 ``[b, h, rows, kv]``, for query rows
    starting at ``row0``: ``q·kᵀ·scale·log2(e) + key_bias·log2(e)``, and
    ``-1e30`` where ``causal`` and col > row."""
    t = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (scale * _LOG2E)
    if key_bias is not None:
        t = t + (key_bias.float() * _LOG2E)[:, None, None, :]
    if causal:
        rows = torch.arange(row0, row0 + t.shape[-2], device=t.device)
        cols = torch.arange(t.shape[-1], device=t.device)
        t = t.masked_fill(cols[None, :] > rows[:, None], _NEG_INF)
    return t


def _q_chunks(q_len: int):
    for r0 in range(0, q_len, _PLAIN_Q_CHUNK):
        yield r0, min(r0 + _PLAIN_Q_CHUNK, q_len)


def flash_fwd_plain(q, k, v, key_bias=None, scale: Optional[float] = None,
                    causal: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B4: ``(o, lse)``, ``o`` in q's dtype and
    the row logsumexp ``[b, h, q_len]`` f32 in natural-log units. Full-row
    softmax in exp2 units (max, ``p = exp2(t - max)``, ``o = p·v /
    max(Σp, 1e-30)`` with ``p`` rounded to v's dtype in ``p·v``, ``lse =
    max·ln2 + ln(max(Σp, 1e-30))``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    outs, lses = [], []
    vf = v.float()
    for r0, r1 in _q_chunks(q.shape[-2]):
        t = _scores2(q[:, :, r0:r1], k, key_bias, scale, causal, r0)
        m = t.amax(-1, keepdim=True)
        p = torch.exp2(t - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        outs.append(torch.matmul(_rounded(p, v.dtype), vf) / l)
        lses.append((m * _LN2 + torch.log(l))[..., 0])
    return torch.cat(outs, -2).to(q.dtype), torch.cat(lses, -1)


def _bwd_chunk(q, k, v, do, lse, delta, glse, scale, causal, r0, r1):
    """``p`` and ``ds = p·(dO·vᵀ − D + glse)`` for query rows [r0, r1)."""
    t = _scores2(q[:, :, r0:r1], k, None, scale, causal, r0)
    p = torch.exp2(t - (lse[:, :, r0:r1] * _LOG2E)[..., None])
    dp = torch.matmul(do[:, :, r0:r1].float(), v.float().transpose(-1, -2))
    rest = dp - delta[:, :, r0:r1, None]
    if glse is not None:
        rest = rest + glse[:, :, r0:r1, None]
    return p, p * rest


def flash_bwd_dq_plain(q, k, v, do, lse, delta, glse, scale: float,
                       causal: bool) -> torch.Tensor:
    """Plain PyTorch version of B5a: ``dq = scale·Σ_j ds·k_j`` with ``p``
    recomputed from ``lse`` and ``ds`` rounded to the inputs' dtype before
    the product; ``delta = Σ dO·O`` per row, ``glse`` the lse cotangent
    (None for 0), both ``[b, h, q_len]`` f32. Equal to
    :func:`flash_bwd_fused_plain`'s dq bit for bit."""
    dq = []
    for r0, r1 in _q_chunks(q.shape[-2]):
        ds = _bwd_chunk(q, k, v, do, lse, delta, glse, scale, causal, r0,
                        r1)[1]
        dq.append(torch.matmul(_rounded(ds, q.dtype), k.float()) * scale)
    return torch.cat(dq, -2).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, glse, scale: float,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B5b: ``dk = scale·Σ_i dsᵀ·q_i``,
    ``dv = Σ_i pᵀ·dO_i``, ``p`` and ``ds`` rounded to the inputs' dtype
    before the products. Equal to :func:`flash_bwd_fused_plain`'s dk and
    dv bit for bit."""
    return _bwd_one_pass(q, k, v, do, lse, delta, glse, scale, causal,
                         q.dtype)[1:]


def flash_bwd_fused_plain(q, k, v, do, lse, delta, glse, scale: float,
                          causal: bool):
    """Plain PyTorch version of B6: ``(dq, dk, dv)`` from one pass over
    the query rows, each ``p`` and ``ds`` computed once and rounded to the
    inputs' dtype before the products."""
    return _bwd_one_pass(q, k, v, do, lse, delta, glse, scale, causal,
                         q.dtype)


def _bwd_one_pass(q, k, v, do, lse, delta, glse, scale: float,
                  causal: bool, dtype: torch.dtype):
    """``(dq, dk, dv)`` over chunks of query rows, ``p`` and ``ds``
    rounded to ``dtype`` before the products."""
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dq = []
    for r0, r1 in _q_chunks(q.shape[-2]):
        p, ds = _bwd_chunk(q, k, v, do, lse, delta, glse, scale, causal,
                           r0, r1)
        p, ds = _rounded(p, dtype), _rounded(ds, dtype)
        dq.append(torch.matmul(ds, k.float()) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), q[:, :, r0:r1].float())
        dv += torch.matmul(p.transpose(-1, -2), do[:, :, r0:r1].float())
    return (torch.cat(dq, -2).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def _flash_check(q, k, v, do=None, key_bias=None, rows=()) -> None:
    """Raise on what the flash kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [b, h, s, d]")
    b, h, q_len, d = q.shape
    kv_len = k.shape[-2]
    if k.shape != (b, h, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{b}, {h}, kv_len, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO must be {tuple(q.shape)}")
    for t in (k, v) + (() if do is None else (do,)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v (and dO) must share dtype and device")
    for t in (q, k, v) + (() if do is None else (do,)):
        if not t.is_contiguous():
            raise ValueError("the flash kernels take contiguous "
                             "[b, h, s, d] tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not in {list(_DTYPES)}")
    if q_len < 1 or kv_len < 1:
        raise ValueError("empty sequence")
    _check_head_dim(q, FLASH_MAX_HEAD_DIM)
    if key_bias is not None and (
            key_bias.shape != (b, kv_len) or key_bias.dtype != torch.float32
            or key_bias.device != q.device or not key_bias.is_contiguous()):
        raise ValueError(f"key_bias must be contiguous f32 [{b}, {kv_len}]"
                         f" on {q.device}")
    for t in rows:
        if t is not None and (
                t.shape != (b, h, q_len) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"lse, delta and glse must be contiguous f32 "
                             f"[{b}, {h}, {q_len}] on {q.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dims(q, k):
    b, h, q_len, d = q.shape
    return b * h, q_len, k.shape[-2], d


def flash_fwd(q, k, v, key_bias, scale: float, causal: bool):
    """B4's wrapper: ``(o, lse)`` for contiguous ``[b, h, s, d]`` inputs
    and an optional ``[b, kv_len]`` f32 key bias. CPU tensors take
    :func:`flash_fwd_plain`; CUDA tensors launch the kernel of its route
    (:func:`flash_route`) on the current stream."""
    _flash_check(q, k, v, key_bias=key_bias)
    if not on_card(q, "flash_fwd"):
        return flash_fwd_plain(q, k, v, key_bias, scale, causal)
    route = flash_route(q.dtype, "flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_bias),
            o.data_ptr(), lse.data_ptr())
    bh, q_len, kv_len, d = _dims(q, k)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "bf16_tc":
            rc = lib.azt_flash_fwd_bf16(
                *ptrs, bh, q_len, kv_len, d, q.shape[1], scale * _LOG2E,
                int(bool(causal)), stream)
        else:
            rc = lib.azt_flash_fwd(
                *ptrs, bh, q_len, kv_len, d, q.shape[1], scale * _LOG2E,
                int(bool(causal)), stream)
    flash_launch_counts.launched("flash_fwd", rc)
    flash_route_counts.launched(route, rc)
    return o, lse


def _bwd_ptrs(q, k, v, do, lse, delta, glse):
    """Check a backward's inputs; their pointers, glse's None for 0."""
    _flash_check(q, k, v, do, rows=(lse, delta, glse))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(glse))


def flash_bwd_dq(q, k, v, do, lse, delta, glse, scale: float,
                 causal: bool) -> torch.Tensor:
    """B5a's wrapper: ``dq``. CPU tensors take :func:`flash_bwd_dq_plain`;
    CUDA tensors launch the kernel of its route (:func:`flash_route`; a
    block per query tile walking the keys, no atomics)."""
    ptrs = _bwd_ptrs(q, k, v, do, lse, delta, glse)
    if not on_card(q, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, glse, scale,
                                  causal)
    route = flash_route(q.dtype, "flash_bwd_dq")
    dq = torch.empty_like(q)
    bh, q_len, kv_len, d = _dims(q, k)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "bf16_tc":
            rc = lib.azt_flash_bwd_dq_bf16(
                *ptrs, dq.data_ptr(), bh, q_len, kv_len, d, scale * _LOG2E,
                scale, int(bool(causal)), stream)
        else:
            rc = lib.azt_flash_bwd_dq(
                *ptrs, dq.data_ptr(), bh, q_len, kv_len, d, scale * _LOG2E,
                scale, int(bool(causal)), stream)
    flash_launch_counts.launched("flash_bwd_dq", rc)
    flash_route_counts.launched(route, rc)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, glse, scale: float,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5b's wrapper: ``(dk, dv)``. CPU tensors take
    :func:`flash_bwd_dkv_plain`; CUDA tensors launch the kernel of its
    route (:func:`flash_route`; a block per key tile walking the queries,
    no atomics)."""
    ptrs = _bwd_ptrs(q, k, v, do, lse, delta, glse)
    if not on_card(q, "flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, glse, scale,
                                   causal)
    route = flash_route(q.dtype, "flash_bwd_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    outs = (dk.data_ptr(), dv.data_ptr())
    bh, q_len, kv_len, d = _dims(q, k)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "bf16_tc":
            rc = lib.azt_flash_bwd_dkv_bf16(
                *ptrs, *outs, bh, q_len, kv_len, d, scale * _LOG2E, scale,
                int(bool(causal)), stream)
        else:
            rc = lib.azt_flash_bwd_dkv(
                *ptrs, *outs, bh, q_len, kv_len, d, scale * _LOG2E, scale,
                int(bool(causal)), stream)
    flash_launch_counts.launched("flash_bwd_dkv", rc)
    flash_route_counts.launched(route, rc)
    return dk, dv


def flash_bwd_fused(q, k, v, do, lse, delta, glse, scale: float,
                    causal: bool):
    """B6's wrapper: ``(dq, dk, dv)`` from one launch. CPU tensors take
    :func:`flash_bwd_fused_plain`; CUDA tensors launch the kernel of its
    route (:func:`flash_route`; a block per 64 keys walking the queries,
    dk and dv in registers, dq added into an f32 buffer with atomics, so
    dq sums in no fixed order)."""
    ptrs = _bwd_ptrs(q, k, v, do, lse, delta, glse)
    if not on_card(q, "flash_bwd_fused"):
        return flash_bwd_fused_plain(q, k, v, do, lse, delta, glse, scale,
                                     causal)
    route = flash_route(q.dtype, "flash_bwd_fused")
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    bh, q_len, kv_len, d = _dims(q, k)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "bf16_tc":
            rc = lib.azt_flash_bwd_fused_bf16(
                *ptrs, *outs, bh, q_len, kv_len, d, scale * _LOG2E, scale,
                int(bool(causal)), stream)
        else:
            rc = lib.azt_flash_bwd_fused(
                *ptrs, *outs, bh, q_len, kv_len, d, scale * _LOG2E, scale,
                int(bool(causal)), stream)
    flash_launch_counts.launched("flash_bwd_fused", rc)
    flash_route_counts.launched(route, rc)
    return dq.to(q.dtype), dk, dv


def flash_bwd(q, k, v, o, lse, do, glse, scale: float, causal: bool):
    """The flash backward: the preamble ``delta = Σ dO·O`` per row (one
    plain reduction, as in the JAX package), then B6 where
    :func:`fused_bwd_applicable` holds, else B5a and B5b."""
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, glse, scale, causal)
    if fused_bwd_applicable(k.shape[-2], q.shape[-1], q.element_size()):
        return flash_bwd_fused(*args)
    return (flash_bwd_dq(*args),) + flash_bwd_dkv(*args)


class _Flash(torch.autograd.Function):
    """Unbiased flash attention: forward B4 (saving the lse), backward B6
    or B5a + B5b; both outputs, ``o`` and ``lse``, are differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, None, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, go, glse):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal = ctx.args
        go = torch.zeros_like(o) if go is None else go.contiguous()
        if glse is not None:
            glse = glse.float().contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, go, glse, scale, causal)
        return dq, dk, dv, None, None


class _FlashKeyBias(torch.autograd.Function):
    """Flash attention with a ``[b, kv_len]`` padding bias: forward B4 with
    its bias operand; backward autograd through the plain
    :func:`blockwise_attention` recompute (the JAX package's
    ``_flash_keybias_bwd``, whose backward is XLA), and a zero gradient for
    the bias, which is a mask and not trained."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, scale, causal, q_block, kv_block):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kb = key_bias.float().contiguous()
        ctx.save_for_backward(q, k, v, kb)
        ctx.args = (scale, causal, q_block, kv_block)
        return flash_fwd(q, k, v, kb, scale, causal)[0]

    @staticmethod
    def backward(ctx, g):
        q, k, v, kb = ctx.saved_tensors
        scale, causal, q_block, kv_block = ctx.args
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = blockwise_attention(*leaves, kb[:, None, None, :], causal,
                                      scale, q_block, kv_block)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return (dq, dk, dv, torch.zeros_like(kb), None, None, None, None)


def flash_attention(q, k, v, bias=None, causal: bool = False,
                    scale: Optional[float] = None,
                    q_block: int = DEFAULT_Q_BLOCK,
                    kv_block: int = DEFAULT_KV_BLOCK) -> torch.Tensor:
    """Streaming-softmax attention for any lengths (the JAX package's
    ``flash_attention``). A per-key padding bias in the ``[b, 1, 1, kv]``
    form runs inside B4; any other bias shape takes
    :func:`blockwise_attention`. The JAX package also sends a key bias to
    the blockwise path when no kv block divisible by 128 exists
    (``_keybias_block``), a TPU tiling rule the CUDA kernel does not
    have."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if bias is not None:
        b, kv_len = q.shape[0], k.shape[-2]
        if bias.dim() == 4 and tuple(bias.shape) == (b, 1, 1, kv_len):
            return _FlashKeyBias.apply(q, k, v, bias[:, 0, 0, :], scale,
                                       causal, q_block, kv_block)
        return blockwise_attention(q, k, v, bias, causal, scale, q_block,
                                   kv_block)
    return _Flash.apply(q, k, v, scale, causal)[0]


def flash_attention_lse(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        q_block: int = DEFAULT_Q_BLOCK,
                        kv_block: int = DEFAULT_KV_BLOCK):
    """Flash attention that also returns the row logsumexp ``[b, h,
    q_len]`` (natural log), jointly differentiable in both outputs: the
    lse cotangent enters every backward kernel's ``ds``. ``q_block`` and
    ``kv_block`` are the JAX signature's TPU tile sizes: the CUDA kernels
    cut fixed tiles."""
    del q_block, kv_block
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, scale, causal)


def blockwise_attention(q, k, v, bias=None, causal: bool = False,
                        scale: Optional[float] = None,
                        q_block: int = DEFAULT_Q_BLOCK,
                        kv_block: int = DEFAULT_KV_BLOCK,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        return_lse: bool = False):
    """Streaming-softmax attention over kv blocks in plain PyTorch (the JAX
    package's ``blockwise_attention``, which is XLA there too), blocks cut
    by the largest divisor of each length within ``q_block``/``kv_block``;
    differentiable by autograd. ``bias`` broadcasts against ``[b, h, q_len,
    kv_len]``. Dropout (``dropout_rate > 0`` and a ``generator``) is applied
    per kv block to the weights after the denominator took them undropped,
    which is standard post-softmax dropout; its bits are the fused kernels'
    murmur3 of (bh, row, col) keyed by one seed drawn from ``generator``,
    not JAX's ``fold_in`` draws. ``return_lse`` also returns the row
    logsumexp ``[b, h, q_len]``."""
    b, h, q_len, d = q.shape
    kv_len = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bq = _largest_divisor_leq(q_len, q_block)
    bk = _largest_divisor_leq(kv_len, kv_block)
    if bias is not None:
        bias = bias.float().expand(b, h, q_len, kv_len)
    seed = None
    if dropout_rate > 0.0 and generator is not None:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=q.device, dtype=torch.int32)
        thresh, inv = keep_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate)
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for r0 in range(0, q_len, bq):
        qc = q[:, :, r0:r0 + bq].float()
        acc = torch.zeros(b, h, bq, d, dtype=torch.float32, device=q.device)
        m = torch.full((b, h, bq, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        rows = torch.arange(r0, r0 + bq, device=q.device)
        for c0 in range(0, kv_len, bk):
            s = torch.matmul(qc, kf[:, :, c0:c0 + bk].transpose(-1, -2)) \
                * scale
            if bias is not None:
                s = s + bias[:, :, r0:r0 + bq, c0:c0 + bk]
            cols = torch.arange(c0, c0 + bk, device=q.device)
            if causal:
                s = s.masked_fill(cols[None, :] > rows[:, None], _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            if seed is not None:
                keep = _entry_bits(seed, rows, cols, b * h).reshape(
                    b, h, bq, bk) >= thresh
                p = torch.where(keep, p * inv, 0.0)
            # p in v's dtype, the products summed in f32 (as the JAX
            # package's einsum with an f32 result)
            acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                            vf[:, :, c0:c0 + bk])
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append((acc / l).to(v.dtype))
        lses.append((m + torch.log(l))[..., 0])
    out = torch.cat(outs, -2)
    return (out, torch.cat(lses, -1)) if return_lse else out


def masked_context(q, k_buf, v_buf, visible, scale: float) -> torch.Tensor:
    """The decode cache's attention (the JAX package's ``masked_context``):
    ``softmax(q·kᵀ·scale`` masked to ``visible``) ``·v`` with f32 scores
    and sums; invisible positions score exactly ``-1e30``, so their weight
    underflows to exactly 0. ``q`` ``[B, H, T, D]``, buffers ``[B, H, K,
    D]``, ``visible`` broadcasting against ``[B, H, T, K]``."""
    s = torch.matmul(q.float(), k_buf.float().transpose(-1, -2)) * scale
    s = torch.where(visible, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.matmul(p.to(v_buf.dtype).float(), v_buf.float())
    return ctx.to(q.dtype)
