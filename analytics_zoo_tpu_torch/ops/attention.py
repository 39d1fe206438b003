"""Attention (counterpart of ``analytics_zoo_tpu/ops/attention.py``):
``dot_product_attention`` and the fused short-sequence attention that BERT
runs in every layer.

Layout at the public functions is the JAX package's: ``q``, ``k``, ``v``
``[batch, heads, seq, head_dim]``, and ``key_bias`` ``[batch, kv_len]`` in
natural-log units (the 0 / -1e9 padding bias BERT builds from its mask).

:func:`fused_short_attention` is exact softmax attention for
``q_len == kv_len <= FUSED_SHORT_MAX_SEQ``. Its forward launches the
hand-written CUDA kernel B7 (``csrc/fused_short_attn.cu``, replacing the
TPU's ``_fused_short_fwd_kernel``) and its backward B8 (replacing
``_fused_short_bwd_kernel``) on a CUDA tensor, or raises; there is no
fallback. On a CPU tensor each runs its plain PyTorch version
(:func:`fused_short_attention_plain`, :func:`fused_short_bwd_plain`), the
same arithmetic, which the tests hold against the JAX package and which
``chip_smoke.py`` holds each kernel against on the card.

The arithmetic, in both versions: scores ``q·k`` in f32, times
``scale·log2(e)`` in f32 (folded into the f32 score, not into ``q``: the
TPU kernel rounds the pre-scaled ``q`` to its dtype), plus
``key_bias·log2(e)`` in f32 (the TPU kernel rounds it to bf16), a causal
mask of ``-1e30`` above the diagonal, softmax in ``exp2`` with IEEE
division, then dropout, then ``p·v`` with ``p`` kept in f32.

Dropout keeps an entry where its 32 random bits are at or above
``min(int(rate·2^32), 2^32-1)`` and scales it by ``1/(1-rate)``, the TPU
kernel's rule. The bits are not the TPU PRNG's: they are murmur3's 32-bit
hash of the words ``(bh, row, col)`` keyed by the call's seed
(:func:`dropout_bits`), so the mask depends on nothing but the seed and the
entry, and B7, B8 and the plain versions draw the same mask whatever their
tiling. The seed is drawn once per call from the model's dropout generator
and stays on the device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .kernel_build import LaunchCounts, load_library, on_card

#: the longest sequence the fused kernels take (the TPU's VMEM budget for
#: the [s, s] block; here the shared memory of the backward's dq pass)
FUSED_SHORT_MAX_SEQ = 512
#: the widest head the kernels take (16 f32 accumulators per thread)
FUSED_SHORT_MAX_HEAD_DIM = 128
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: one B8 launch is the two passes of one backward
launch_counts = LaunchCounts("fused_short_fwd", "fused_short_bwd")
reset_launch_counts = launch_counts.reset


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


def dropout_bits(seed, bh: int, s: int) -> torch.Tensor:
    """The kernels' random bits, ``[bh, s, s]`` int64 in ``[0, 2^32)``:
    murmur3_32 of the three words ``(bh, row, col)`` with ``seed`` as its
    seed. ``seed`` is an int or a one-element integer tensor (its device is
    the result's)."""
    dev = seed.device if isinstance(seed, torch.Tensor) else None
    h = torch.as_tensor(seed, device=dev).reshape(1, 1, 1).long() & _M32
    idx = lambda n: torch.arange(n, device=h.device, dtype=torch.int64)
    h = _mix(h, idx(bh)[:, None, None])
    h = _mix(h, idx(s)[None, :, None])
    h = _mix(h, idx(s)[None, None, :])
    return _fmix(h ^ 12)  # 12: the three words' length in bytes


def keep_threshold(rate: float) -> int:
    """Bits at or above this are kept: ``min(int(rate·2^32), 2^32-1)``."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep_mask(seed, bh: int, s: int, rate: float) -> torch.Tensor:
    """The plain rendering of the kernels' dropout mask, ``[bh, s, s]``
    bool: True where an attention probability is kept."""
    return dropout_bits(seed, bh, s) >= keep_threshold(rate)


# -- plain versions ----------------------------------------------------------


def _probs(q, k, key_bias, scale: float, causal: bool) -> torch.Tensor:
    """Pre-dropout probabilities ``[b, h, s, s]`` f32, the kernels'
    arithmetic; differentiable."""
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (scale * _LOG2E)
    if key_bias is not None:
        s2 = s2 + (key_bias.float() * _LOG2E)[:, None, None, :]
    if causal:
        n = s2.shape[-1]
        above = torch.ones(n, n, dtype=torch.bool,
                           device=s2.device).triu(1)
        s2 = s2.masked_fill(above, _NEG_INF)
    e = torch.exp2(s2 - s2.amax(-1, keepdim=True).detach())
    return e / e.sum(-1, keepdim=True)


def _keep(seed, q: torch.Tensor, rate: float) -> Optional[torch.Tensor]:
    if rate <= 0.0:
        return None
    b, h, s, _ = q.shape
    return dropout_keep_mask(seed, b * h, s, rate).reshape(b, h, s, s)


def fused_short_attention_plain(q, k, v, key_bias=None,
                                scale: Optional[float] = None,
                                rate: float = 0.0, seed=None,
                                causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of B7: same inputs, same arithmetic, same
    dropout mask; differentiable, so autograd through it is the reference
    for B8."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, key_bias, scale, causal)
    keep = _keep(seed, q, rate)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    return torch.matmul(p, v.float()).to(v.dtype)


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
    dv = torch.matmul(pd.transpose(-1, -2), dof)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
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


def _check(tensors, key_bias, seed, rate: float) -> None:
    """Raise on what the kernels do not take."""
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"q must be [b, h, s, d], got {tuple(q.shape)}")
    b, _, s, d = q.shape
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
    if not 1 <= d <= FUSED_SHORT_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside "
                         f"[1, {FUSED_SHORT_MAX_HEAD_DIM}]")
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


def _launch_args(q, key_bias, seed, scale: float, rate: float):
    b, h, s, d = q.shape
    drop = rate > 0.0
    return dict(
        bias=key_bias.data_ptr() if key_bias is not None else None,
        seed=seed.data_ptr() if drop else None,
        dims=(b * h, h, s, d, _DTYPES[q.dtype]),
        thresh=keep_threshold(rate) if drop else 0,
        inv=1.0 / (1.0 - rate) if drop else 1.0,
        scale_log2e=scale * _LOG2E)


def fused_short_fwd(q, k, v, key_bias, seed, scale: float, rate: float,
                    causal: bool) -> torch.Tensor:
    """B7's wrapper: ``[b, h, s, d]`` contiguous f32/bf16 in, the same out.
    CPU tensors take :func:`fused_short_attention_plain`; CUDA tensors
    launch the kernel on the current stream."""
    _check((q, k, v), key_bias, seed, rate)
    if not on_card(q, "fused_short_fwd"):
        return fused_short_attention_plain(q, k, v, key_bias, scale, rate,
                                           seed, causal)
    o = torch.empty_like(q)
    a = _launch_args(q, key_bias, seed, scale, rate)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.azt_fused_short_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), a["bias"], a["seed"],
            o.data_ptr(), *a["dims"], a["scale_log2e"], a["thresh"],
            a["inv"], int(bool(causal)), stream)
    launch_counts.launched("fused_short_fwd", rc)
    return o


def fused_short_bwd(q, k, v, do, key_bias, seed, scale: float, rate: float,
                    causal: bool):
    """B8's wrapper: ``(dq, dk, dv)`` for contiguous ``[b, h, s, d]``
    inputs and ``do``. CPU tensors take :func:`fused_short_bwd_plain`; CUDA
    tensors launch the kernel (a dq pass, then a dk/dv pass, both
    recomputing ``p``: no atomics) on the current stream."""
    _check((q, k, v, do), key_bias, seed, rate)
    if not on_card(q, "fused_short_bwd"):
        return fused_short_bwd_plain(q, k, v, do, key_bias, scale, rate,
                                     seed, causal)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    b, h, s, _ = q.shape
    # per query row: the softmax max, its denominator, rowsum(dp·p)
    stats = torch.empty((3, b * h, s), dtype=torch.float32, device=q.device)
    a = _launch_args(q, key_bias, seed, scale, rate)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.azt_fused_short_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            a["bias"], a["seed"], dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), *a["dims"], a["scale_log2e"],
            scale, a["thresh"], a["inv"], int(bool(causal)), stream)
    launch_counts.launched("fused_short_bwd", rc)
    return dq, dk, dv


class _FusedShort(torch.autograd.Function):
    """Forward B7, backward B8; the bias is a padding mask and gets no
    gradient (the JAX package's contract)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, scale, rate, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kb = None if key_bias is None else key_bias.float().contiguous()
        ctx.save_for_backward(q, k, v, kb, seed)
        ctx.args = (scale, rate, causal)
        return fused_short_fwd(q, k, v, kb, seed, scale, rate, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kb, seed = ctx.saved_tensors
        scale, rate, causal = ctx.args
        dq, dk, dv = fused_short_bwd(q, k, v, g.contiguous(), kb, seed,
                                     scale, rate, causal)
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
