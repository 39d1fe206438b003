"""The 3xTF32 arithmetic of B7/B8's f32 route and of the flash kernels'
(B4, B5a, B5b, B6), emulated on the CPU.

``csrc/fused_short_attn.cu`` runs every product of the fused short
attention's f32 route, and ``csrc/flash_attn_tf32.cu`` every product of the
flash forward (B4), the two-pass backward (B5a's dq, B5b's dk and dv) and
the one-pass backward (B6) in f32, on the tensor cores as
``mma.sync.m16n8k8`` TF32:
each f32 operand is split into ``big = tf32(x)`` and ``small = tf32(x -
big)`` (``cvt.rna.tf32.f32``: the mantissa rounded to 10 bits, ties away
from zero), and ``a·b`` is taken as ``small·big + big·small + big·big``
into f32 accumulators. An accumulator element becomes the next product's A
fragment with its reduction index permuted inside each 8-step (``k t`` is
column ``2t``, ``k t + 4`` column ``2t + 1``), and that product's B rows
are read in the same order.

Here the split, the three products and the permuted order are emulated in
torch, and B7's and B8's function run through them at the grid's worst
shapes (s 512, d 64 and 128; padding bias, causal, dropout 0.1) are held
within 2e-5 of the output's scale against the plain versions, the route's
tolerance; one TF32 product alone misses it, so the split cannot be dropped
quietly. B4 (its output and lse), B5b (dk and dv, with an lse cotangent),
B5a (dq) and B6 (dq, dk and dv; its dq summed over each 64-key block, then
added across the blocks in f32, as its atomics add) are held the same way
against ``flash_fwd_plain``, ``flash_bwd_dkv_plain``, ``flash_bwd_dq_plain``
and ``flash_bwd_fused_plain`` at 1024 keys and at 513 queries over 1000
keys, causal or not, d 64 and 128; a reduction whose length is no multiple
of 8 is padded with zeros, as the kernels' tiles are. The tensor cores'
own accumulation inside an ``mma`` is not emulated: each 8-step's
products are summed exactly and added to the f32 accumulator with one
rounding. ``chip_smoke.py`` and
``tests/test_torch_port_kernels.py`` hold the kernels themselves on the
card. The plain versions against JAX are
``test_torch_port_attention.py::test_fused_short_forward_and_backward_match_jax``.
"""
import math

import pytest
import torch

from analytics_zoo_tpu_torch.ops import attention as at

#: the f32 route against its plain versions, relative to the output's scale
ATOL = 2e-5
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` with its 13 low mantissa bits cleared: half a
    TF32 unit added to the magnitude, then truncated."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x - big)


def _perm(n: int) -> torch.Tensor:
    """The kernel's reduction order for an accumulator fed back as an A
    fragment: in each 8-step, k = 0..7 reads columns 0, 2, 4, 6, 1, 3, 5,
    7."""
    step = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    return (torch.arange(0, n, 8)[:, None] + step).reshape(-1)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3,
        permuted: bool = False) -> torch.Tensor:
    """``a @ b`` (f32, ``[..., m, k] @ [..., k, n]``, k padded to a
    multiple of 8) as the kernel's ``mma.sync.m16n8k8`` runs it: per 8-step
    of the reduction,
    small·big, big·small and big·big (``terms`` 3), or big·big alone
    (``terms`` 1), each summed exactly and added to the f32 accumulator.
    With ``permuted``, the reduction index in c_to_a's order."""
    pad = -a.shape[-1] % 8  # zero rows and columns, as a ragged tile's
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    if permuted:
        idx = _perm(a.shape[-1])
        a, b = a[..., idx], b[..., idx, :]
    a_big, a_small = _split(a)
    b_big, b_small = _split(b)
    pairs = ([(a_small, b_big), (a_big, b_small), (a_big, b_big)]
             if terms == 3 else [(a_big, b_big)])
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            acc = (acc.double() + x[..., k0:k0 + 8].double()
                   @ y[..., k0:k0 + 8, :].double()).float()
    return acc


def _scores(x, bias, causal, scale, transposed=False):
    """f32 scores in exp2 units from the products ``x``: ``bias`` the keys'
    bias, broadcast along the key axis (the last one, or the one before it
    with ``transposed``)."""
    t = x * (scale * _LOG2E)
    if bias is not None:
        t = t + (bias * _LOG2E).float()
    if causal:
        n = t.shape[-1]
        above = torch.ones(n, n, dtype=torch.bool).triu(1)
        t = t.masked_fill(above.T if transposed else above, -1e30)
    return t


def _emulated(q, k, v, do, kb, scale, rate, seed, causal, terms):
    """B7 and B8's f32 route with every product emulated by :func:`_mm`:
    the forward's online softmax as one max and sum, its row statistics,
    D = rowsum(dO·o), the dq pass's S and dP, the dk/dv pass's Sᵀ and
    dPᵀ."""
    bias = None if kb is None else kb[:, None, None, :]
    keep = at._keep(seed, q, rate)
    inv = 1.0 / (1.0 - rate)

    def drop(x):
        return x if keep is None else torch.where(keep, x * inv, 0.0)

    # B7
    t = _scores(_mm(q, k.transpose(-1, -2), terms), bias, causal, scale)
    m = t.amax(-1, keepdim=True)
    e = torch.exp2(t - m)
    l = e.sum(-1, keepdim=True)
    o = _mm(drop(e / l), v, terms, permuted=True)
    # B8, dq pass
    p = torch.exp2(t - m) * (1.0 / l)
    dd = (do * o).sum(-1, keepdim=True)
    ds = p * (drop(_mm(do, v.transpose(-1, -2), terms)) - dd)
    dq = _mm(ds, k, terms, permuted=True) * scale
    # B8, dk/dv pass: keys x queries
    bias_t = None if kb is None else kb[:, None, :, None]
    tt = _scores(_mm(k, q.transpose(-1, -2), terms), bias_t, causal, scale,
                 transposed=True)
    pt = torch.exp2(tt - m.transpose(-1, -2)) * (1.0 / l.transpose(-1, -2))
    keep_t = None if keep is None else keep.transpose(-1, -2)

    def drop_t(x):
        return x if keep_t is None else torch.where(keep_t, x * inv, 0.0)

    dst = pt * (drop_t(_mm(v, do.transpose(-1, -2), terms))
                - dd.transpose(-1, -2))
    dv = _mm(drop_t(pt), do, terms, permuted=True)
    dk = _mm(dst, q, terms, permuted=True) * scale
    return o, (dq, dk, dv)


def _inputs(d: int, s: int = 512):
    """The grid's worst case: b 2, h 2, s 512, a padding bias with the last
    batch item's keys all masked, causal, dropout 0.1."""
    gen = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(2, 2, s, d, generator=gen) for _ in range(4))
    mask = torch.ones(2, s)
    mask[0, int(torch.randint(1, s + 1, (1,), generator=gen)):] = 0
    mask[1] = 0
    kb = (1.0 - mask) * -1e9
    seed = torch.tensor([d + 5], dtype=torch.int32)
    return q, k, v, do, kb, 1.0 / math.sqrt(d), 0.1, seed, True


def _rel_err(got, want) -> float:
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / scale


@pytest.fixture(scope="module", params=[64, 128], ids=["d64", "d128"])
def case(request):
    q, k, v, do, kb, scale, rate, seed, causal = _inputs(request.param)
    want = at.fused_short_attention_plain(q, k, v, kb, scale, rate, seed,
                                          causal)
    want_grads = at.fused_short_bwd_plain(q, k, v, do, kb, scale, rate,
                                          seed, causal)
    return (q, k, v, do, kb, scale, rate, seed, causal), want, want_grads


def test_3xtf32_holds_the_f32_tolerance(case):
    args, want, want_grads = case
    o, grads = _emulated(*args, terms=3)
    assert _rel_err(o, want) <= ATOL
    for name, g, w in zip("qkv", grads, want_grads):
        assert _rel_err(g, w) <= ATOL, f"d{name}"


def test_one_tf32_product_misses_the_f32_tolerance(case):
    args, want, want_grads = case
    o, grads = _emulated(*args, terms=1)
    assert _rel_err(o, want) > ATOL
    assert max(_rel_err(g, w) for g, w in zip(grads, want_grads)) > ATOL


def test_the_split_is_exact_to_two_tf32_parts():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3)) * 1e3
    big, small = _split(x)
    # each part keeps 11 significant bits; the first rounding is exact to
    # recover in f32, the second leaves at most 2^-22 of x
    assert torch.equal(_tf32(big), big) and torch.equal(_tf32(small), small)
    assert bool(((x - big).abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((x - big - small).abs() <= x.abs() * 2.0 ** -22).all())
    # ties round away from zero: 1 + 2^-11 lies halfway between two TF32s
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_an_accumulator_feeds_the_next_product_in_the_permuted_order():
    """The m16n8k8 TF32 fragments by lane: the C fragment of P (16 x 8)
    read as the A fragment {c0, c2, c1, c3} and X's rows read at 2t and
    2t + 1 (load_b) multiply to P·X exactly as the mma defines its
    operands."""
    gen = torch.Generator().manual_seed(0)
    p = torch.randn(16, 8, generator=gen, dtype=torch.float64)
    x = torch.randn(8, 8, generator=gen, dtype=torch.float64)
    a = torch.zeros(16, 8, dtype=torch.float64)
    b = torch.zeros(8, 8, dtype=torch.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c = [p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t],
             p[g + 8, 2 * t + 1]]
        # A fragment (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = (
            c[0], c[2], c[1], c[3])
        # B fragment (k t, n g), (k t + 4, n g)
        b[t, g], b[t + 4, g] = x[2 * t, g], x[2 * t + 1, g]
    torch.testing.assert_close(a @ b, p @ x, rtol=1e-12, atol=1e-12)
    assert torch.equal(a, p[:, _perm(8)]) and torch.equal(b, x[_perm(8)])


# -- B4, B5a, B5b and B6 (csrc/flash_attn_tf32.cu) ------------------------

#: B6's keys a block: its dq is summed over a block's keys, then added
_B6_KEYS = 64


def _flash_emulated(q, k, v, do, lse, delta, glse, scale, causal, terms):
    """B4's ``(o, lse)``, B5b's ``(dk, dv)`` (B6's too: the same kernel)
    and the dq of B5a and of B6 with every product emulated by
    :func:`_mm`: the forward's online softmax as one max and sum; the
    dk/dv pass's Sᵀ = K·Qᵀ, pᵀ from the given ``lse`` and dPᵀ = V·dOᵀ,
    then ``pᵀ·dO`` and ``dsᵀ·Q`` in the permuted order; B5a's S = Q·Kᵀ
    and dP = dO·Vᵀ, then ``ds·K`` in the permuted order; B6's ``ds·K``
    with ds read transposed from the dk/dv pass's dsᵀ, in the permuted
    order over each block of 64 keys, the blocks' shares times scale
    added in f32."""
    sq, skv = q.shape[-2], k.shape[-2]
    above = torch.arange(skv)[None, :] > torch.arange(sq)[:, None]
    # B4
    t = _mm(q, k.transpose(-1, -2), terms) * (scale * _LOG2E)
    if causal:
        t = t.masked_fill(above, -1e30)
    m = t.amax(-1, keepdim=True)
    e = torch.exp2(t - m)
    l = e.sum(-1, keepdim=True).clamp_min(1e-30)
    o = _mm(e, v, terms, permuted=True) / l
    lse_o = (m * _LN2 + torch.log(l))[..., 0]
    # B5b: keys x queries
    tt = _mm(k, q.transpose(-1, -2), terms) * (scale * _LOG2E)
    if causal:
        tt = tt.masked_fill(above.T, -1e30)
    pt = torch.exp2(tt - (lse * _LOG2E)[..., None, :])
    rest = _mm(v, do.transpose(-1, -2), terms) - delta[..., None, :]
    if glse is not None:
        rest = rest + glse[..., None, :]
    dst = pt * rest
    dv = _mm(pt, do, terms, permuted=True)
    dk = _mm(dst, q, terms, permuted=True) * scale
    # B5a: queries x keys
    t = _mm(q, k.transpose(-1, -2), terms) * (scale * _LOG2E)
    if causal:
        t = t.masked_fill(above, -1e30)
    p = torch.exp2(t - (lse * _LOG2E)[..., None])
    rest = _mm(do, v.transpose(-1, -2), terms) - delta[..., None]
    if glse is not None:
        rest = rest + glse[..., None]
    dq = _mm(p * rest, k, terms, permuted=True) * scale
    # B6: each key block's share of dq from ds^T, added in f32
    ds = dst.transpose(-1, -2)
    dq_b6 = torch.zeros_like(dq)
    for k0 in range(0, skv, _B6_KEYS):
        k1 = min(k0 + _B6_KEYS, skv)
        dq_b6 = dq_b6 + _mm(ds[..., k0:k1], k[..., k0:k1, :], terms,
                            permuted=True) * scale
    return (o, lse_o), (dk, dv), (dq, dq_b6)


_FLASH_CASES = [(d, sq, skv, causal) for d in (64, 128)
                for sq, skv in ((1024, 1024), (513, 1000))
                for causal in (False, True)]


@pytest.fixture(scope="module", params=_FLASH_CASES,
                ids=[f"d{d}-{sq}x{skv}-{'causal' if c else 'full'}"
                     for d, sq, skv, c in _FLASH_CASES])
def flash_case(request):
    """Inputs at the case's shape (b 1, h 2), an lse cotangent, and the
    plain versions' ``(o, lse)``, ``(dk, dv)`` and ``(dq, dk, dv)``, the
    backward from the plain forward's lse and D = rowsum(dO·o)."""
    d, sq, skv, causal = request.param
    gen = torch.Generator().manual_seed(d + sq + skv + causal)
    q, do = (torch.randn(1, 2, sq, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(1, 2, skv, d, generator=gen) for _ in range(2))
    glse = torch.randn(1, 2, sq, generator=gen)
    scale = 1.0 / math.sqrt(d)
    o, lse = at.flash_fwd_plain(q, k, v, None, scale, causal)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, glse, scale, causal)
    return (args, (o, lse), at.flash_bwd_dkv_plain(*args),
            at.flash_bwd_fused_plain(*args))


def test_flash_3xtf32_holds_the_f32_tolerance(flash_case):
    """B4, B5b, B5a's dq (against ``flash_bwd_dq_plain``) and B6's dq, dk
    and dv (against ``flash_bwd_fused_plain``)."""
    args, want_fwd, want_dkv, want_bwd = flash_case
    fwd, dkv, (dq, dq_b6) = _flash_emulated(*args, terms=3)
    for name, got, want in zip(("o", "lse", "dk", "dv"), fwd + dkv,
                               want_fwd + want_dkv):
        assert _rel_err(got, want) <= ATOL, name
    assert _rel_err(dq, at.flash_bwd_dq_plain(*args)) <= ATOL, "B5a dq"
    for name, got, want in zip(("dq", "dk", "dv"), (dq_b6,) + dkv,
                               want_bwd):
        assert _rel_err(got, want) <= ATOL, f"B6 {name}"


def test_flash_one_tf32_product_misses_the_f32_tolerance(flash_case):
    args, want_fwd, want_dkv, want_bwd = flash_case
    fwd, dkv, (dq, dq_b6) = _flash_emulated(*args, terms=1)
    assert max(_rel_err(g, w) for g, w in zip(fwd, want_fwd)) > ATOL
    assert max(_rel_err(g, w) for g, w in zip(dkv, want_dkv)) > ATOL
    assert _rel_err(dq, at.flash_bwd_dq_plain(*args)) > ATOL, "B5a dq"
    assert _rel_err(dq_b6, want_bwd[0]) > ATOL, "B6 dq"
