"""The torch port's attention ops against the JAX package on CPU.

On a CPU tensor the fused short attention runs its plain versions: the
forward with the kernels' arithmetic (exp2 softmax, f32 scores, the bias in
f32) and the backward with B8's written out. Both are held against JAX's
``dot_product_attention`` and ``jax.grad`` of it, f32, atol 1e-5 (the same
function with sums in another order). The dropout mask is the kernels'
murmur3 hash, held here against the same hash in numpy's wrapping uint32
arithmetic, so the torch rendering that ``chip_smoke.py`` compares the
CUDA kernels with is the hash the kernels compute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention)
from analytics_zoo_tpu_torch.ops import attention as at
from torch_port_threads import torch_threads_per_worker  # noqa: F401

ATOL = 1e-5


def _qkv(seed, b=2, h=3, s=17, d=16):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype(np.float32) for _ in range(4)]


def _padding_bias(b, s, seed=0):
    """0 / -1e9 from a numpy mask; every row keeps its first key."""
    rs = np.random.RandomState(seed)
    mask = np.ones((b, s), np.float32)
    for i, n in enumerate(rs.randint(1, s + 1, b)):
        mask[i, n:] = 0
    return (1.0 - mask) * -1e9


def _jax_reference(q, k, v, g, bias, causal, dtype=jnp.float32):
    jb = None if bias is None else jnp.asarray(bias)[:, None, None, :]
    q, k, v, g = (jnp.asarray(a, dtype) for a in (q, k, v, g))

    def loss(q, k, v):
        out = jax_dot_product_attention(q, k, v, bias=jb, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32))

    out = jax_dot_product_attention(q, k, v, bias=jb, causal=causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return (np.asarray(out, np.float32),
            [np.asarray(x, np.float32) for x in grads])


def _port(q, k, v, g, bias, causal, dtype=torch.float32, **kw):
    tq, tk, tv = (torch.tensor(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    kb = None if bias is None else torch.tensor(bias)
    out = at.fused_short_attention(tq, tk, tv, key_bias=kb, causal=causal,
                                   **kw)
    out.backward(torch.tensor(g).to(dtype))
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in (tq, tk, tv)])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "pad"])
@pytest.mark.parametrize("s", [1, 17, 64])
def test_fused_short_forward_and_backward_match_jax(s, with_bias, causal):
    q, k, v, g = _qkv(s, s=s)
    bias = _padding_bias(2, s, seed=s) if with_bias else None
    want, want_grads = _jax_reference(q, k, v, g, bias, causal)
    got, got_grads = _port(q, k, v, g, bias, causal)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")


#: bf16 against a reference: outputs round to 8 bits, so the tolerance is
#: relative to the output's scale (as on the card)
BF16_TOL = 2e-2


def _close_to_scale(got, want, tol, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "pad"])
@pytest.mark.parametrize("s", [1, 17, 64])
def test_bf16_fused_short_forward_and_backward_match_jax_in_bf16(
        s, with_bias, causal):
    """The bf16 route's plain versions (p and ds rounded to bf16 where the
    TPU kernel rounds them) against JAX's attention and its gradient run
    in bf16 on the same bf16 inputs."""
    q, k, v, g = _qkv(s, s=s)
    bias = _padding_bias(2, s, seed=s) if with_bias else None
    want, want_grads = _jax_reference(q, k, v, g, bias, causal,
                                      jnp.bfloat16)
    got, got_grads = _port(q, k, v, g, bias, causal, torch.bfloat16)
    _close_to_scale(got, want, BF16_TOL, "o")
    for name, a, b in zip("qkv", got_grads, want_grads):
        _close_to_scale(a, b, BF16_TOL, f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_plain_forward_matches_the_f32_plain_forward(causal, rate):
    q, k, v, _ = (torch.tensor(a) for a in _qkv(9, s=40))
    bias = torch.tensor(_padding_bias(2, 40, seed=9))
    seed = torch.tensor([5], dtype=torch.int32)
    want = at.fused_short_attention_plain(q, k, v, bias, 0.25, rate, seed,
                                          causal)
    # on bf16-rounded inputs, so only the route's own rounding differs
    r = [t.bfloat16() for t in (q, k, v)]
    got = at.fused_short_attention_plain(*r, bias, 0.25, rate, seed, causal)
    ref = at.fused_short_attention_plain(*(t.float() for t in r), bias, 0.25,
                                         rate, seed, causal)
    assert got.dtype == torch.bfloat16
    _close_to_scale(got.float().numpy(), ref.numpy(), BF16_TOL, "o")
    # and the rounding of the inputs stays inside the same tolerance
    _close_to_scale(got.float().numpy(), want.numpy(), BF16_TOL, "o vs f32")


@pytest.mark.parametrize("causal", [False, True])
def test_the_forward_saves_each_rows_max_and_sum(causal):
    """The statistics the bf16 backward reads: each row's max score (exp2
    units) and sum, from which exp2(t - max) / sum is the forward's p."""
    q, k, v, _ = (torch.tensor(a) for a in _qkv(11, s=33))
    bias = torch.tensor(_padding_bias(2, 33, seed=11))
    bias[-1] = -1e9  # a batch item whose keys are all masked
    o, stats = at.fused_short_attention_plain(q, k, v, bias, 0.25, 0.0, None,
                                              causal, with_stats=True)
    assert stats.shape == (2, 2, 3, 33) and stats.dtype == torch.float32
    t = torch.matmul(q, k.transpose(-1, -2)) * (0.25 * at._LOG2E) \
        + (bias * at._LOG2E)[:, None, None, :]
    if causal:
        t = t.masked_fill(torch.ones(33, 33, dtype=torch.bool).triu(1),
                          -1e30)
    p = torch.exp2(t - stats[0][..., None]) / stats[1][..., None]
    np.testing.assert_allclose(p.numpy(), at._probs(q, k, bias, 0.25,
                                                    causal).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.matmul(p, v).numpy(), o.numpy(),
                               rtol=0, atol=ATOL)
    # the all-masked batch item is uniform over the keys a row sees: every
    # score rounds to the bias (f32's spacing there is 128), so each sum
    # counts them exactly
    seen = (torch.arange(1.0, 34.0) if causal
            else torch.full((33,), 33.0)).expand(3, 33)
    assert torch.equal(stats[1, 1], seen)


def test_the_dtype_picks_the_route():
    assert at.fused_short_route(torch.bfloat16, 64) == "bf16_tc"
    assert at.fused_short_route(torch.float32, 64) == "f32_tc"
    q, k, v, g = (torch.tensor(a).bfloat16() for a in _qkv(12))
    o, stats = at.fused_short_fwd(q, k, v, None, None, 0.25, 0.0, False)
    assert stats.shape == (2, 2, 3, 17)
    # the bf16 backward reads what its forward saved
    with pytest.raises(ValueError):
        at.fused_short_bwd(q, k, v, g, None, None, 0.25, 0.0, False)
    with pytest.raises(ValueError):
        at.fused_short_bwd(q, k, v, g, None, None, 0.25, 0.0, False,
                           stats[:, :1].contiguous())
    dq, dk, dv = at.fused_short_bwd(q, k, v, g, None, None, 0.25, 0.0, False,
                                    stats)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    # f32 saves the statistics too, and its backward also reads the output
    # (D = rowsum(dO·o))
    f = [t.float() for t in (q, k, v)]
    o, stats = at.fused_short_fwd(*f, None, None, 0.25, 0.0, False)
    assert stats.shape == (2, 2, 3, 17)
    with pytest.raises(ValueError):
        at.fused_short_bwd(*f, g.float(), None, None, 0.25, 0.0, False)
    with pytest.raises(ValueError):
        at.fused_short_bwd(*f, g.float(), None, None, 0.25, 0.0, False,
                           stats)
    with pytest.raises(ValueError):
        at.fused_short_bwd(*f, g.float(), None, None, 0.25, 0.0, False,
                           stats, o[:, :1].contiguous())
    dq, dk, dv = at.fused_short_bwd(*f, g.float(), None, None, 0.25, 0.0,
                                    False, stats, o)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32


def test_the_bf16_rounding_passes_its_gradient_through_in_f32():
    """The plain forward rounds pd to bf16 before pd·v, as the kernels do;
    autograd through it must not round the incoming gradient (the kernels
    keep dp in f32), or the B8 reference gains a rounding of its own."""
    x = torch.tensor([0.1, 1.0 / 3.0, 2.0], requires_grad=True)
    w = torch.tensor([1.0 / 3.0, 0.1, 1.0 + 2.0 ** -12])
    y = at._rounded(x, torch.bfloat16)
    assert torch.equal(y, x.detach().bfloat16().float())
    (y * w).sum().backward()
    assert torch.equal(x.grad, w)
    assert at._rounded(x, torch.float32) is x


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_plain_backward_matches_autograd_through_the_plain_forward(
        causal, rate):
    """The two B8 references the card is held to agree in bf16: B8's
    arithmetic written out, and autograd through the plain forward (which
    differs only in not rounding ds to bf16)."""
    q, k, v, g = (torch.tensor(a).bfloat16() for a in _qkv(13, s=40))
    bias = torch.tensor(_padding_bias(2, 40, seed=13))
    seed = torch.tensor([77], dtype=torch.int32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    at.fused_short_attention_plain(*leaves, bias, 0.25, rate, seed,
                                   causal).backward(g)
    got = at.fused_short_bwd_plain(q, k, v, g, bias, 0.25, rate, seed,
                                   causal)
    for name, a, t in zip("qkv", got, leaves):
        assert a.dtype == torch.bfloat16
        _close_to_scale(a.float().numpy(), t.grad.float().numpy(), BF16_TOL,
                        f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_dot_product_attention_matches_jax(causal):
    q, k, v, g = _qkv(3)
    bias = _padding_bias(2, 17, seed=3)
    want, _ = _jax_reference(q, k, v, g, bias, causal)
    got = at.dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        bias=torch.tensor(bias)[:, None, None, :], causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _numpy_bits(seed, bh, s):
    """murmur3_32 of (bh, row, col) keyed by ``seed``, in numpy uint32
    (which wraps mod 2^32 as the CUDA kernels' arithmetic does)."""
    u = np.uint32

    def rotl(x, r):
        return (x << u(r)) | (x >> u(32 - r))

    def mix(h, k):
        k = rotl(k * u(0xCC9E2D51), 15) * u(0x1B873593)
        return rotl(h ^ k, 13) * u(5) + u(0xE6546B64)

    def fmix(h):
        h = (h ^ (h >> u(16))) * u(0x85EBCA6B)
        h = (h ^ (h >> u(13))) * u(0xC2B2AE35)
        return h ^ (h >> u(16))

    with np.errstate(over="ignore"):
        idx = lambda n: np.arange(n, dtype=np.uint32)
        h = np.full((bh, s, s), seed, np.uint32)
        h = mix(h, np.broadcast_to(idx(bh)[:, None, None], h.shape))
        h = mix(h, np.broadcast_to(idx(s)[None, :, None], h.shape))
        h = mix(h, np.broadcast_to(idx(s)[None, None, :], h.shape))
        return fmix(h ^ u(12))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 2])
def test_dropout_bits_are_murmur3_of_the_entry(seed):
    want = _numpy_bits(seed, 5, 33).astype(np.int64)
    got = at.dropout_bits(torch.tensor([seed], dtype=torch.int32), 5, 33)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the entry's bits do not depend on how many rows or heads are drawn
    np.testing.assert_array_equal(at.dropout_bits(seed, 2, 33).numpy(),
                                  want[:2])


def test_keep_threshold_is_the_tpu_kernels():
    assert at.keep_threshold(0.1) == int(0.1 * 2 ** 32)
    assert at.keep_threshold(0.0) == 0
    assert at.keep_threshold(1.0 - 2 ** -40) == 2 ** 32 - 1


def test_kept_share_is_within_four_sigma():
    bh, s, rate = 96, 64, 0.1
    mask = at.dropout_keep_mask(torch.tensor([77], dtype=torch.int32), bh, s,
                                rate)
    n = mask.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(float(mask.float().mean()) - (1 - rate)) < 4 * sigma


def _masked_reference(q, k, v, bias, seed, rate, causal):
    """Attention through the materialised mask, differentiated by
    autograd: the reference for the forward's and backward's masks."""
    b, h, s, d = q.shape
    p = at._probs(q, k, bias, 1.0 / np.sqrt(d), causal)
    keep = at.dropout_keep_mask(seed, b * h, s, rate).reshape(b, h, s, s)
    return torch.matmul(torch.where(keep, p / (1 - rate), 0.0), v)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_forward_and_backward_draw_the_same_mask(causal):
    q, k, v, g = _qkv(5, s=33)
    bias = torch.tensor(_padding_bias(2, 33, seed=5))
    gen = torch.Generator().manual_seed(3)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         dtype=torch.int32)
    got, got_grads = _port(q, k, v, g, _padding_bias(2, 33, seed=5), causal,
                           dropout_rate=0.1,
                           generator=torch.Generator().manual_seed(3))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    want = _masked_reference(tq, tk, tv, bias, seed, 0.1, causal)
    (want * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(got, want.detach().numpy(), rtol=0, atol=ATOL)
    for a, t in zip(got_grads, (tq, tk, tv)):
        np.testing.assert_allclose(a, t.grad.numpy(), rtol=0, atol=ATOL)
    # and the plain backward with B8's arithmetic equals autograd through
    # the plain forward
    dq, dk, dv = at.fused_short_bwd_plain(
        *(torch.tensor(a) for a in (q, k, v, g)), bias, 1 / 4.0, 0.1, seed,
        causal)
    for a, b in zip((dq, dk, dv), got_grads):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)


def test_the_same_seed_gives_the_same_output_and_another_seed_another():
    q, k, v, _ = (torch.tensor(a) for a in _qkv(6))

    def run(seed):
        return at.fused_short_attention(
            q, k, v, dropout_rate=0.1,
            generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    # dropout off: no generator is read
    assert torch.equal(at.fused_short_attention(q, k, v, dropout_rate=0.1),
                       at.fused_short_attention(q, k, v))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    at.reset_launch_counts()
    q, k, v, g = _qkv(7)
    _port(q, k, v, g, None, False)
    _port(q, k, v, g, None, False, torch.bfloat16)
    assert at.launch_counts == {"fused_short_fwd": 0, "fused_short_bwd": 0}
    assert at.route_counts == {"bf16_tc": 0, "f32_tc": 0, "wide": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError):
        at.fused_short_fwd(q, q, q[:, :, :4].contiguous(), None, None, 0.25,
                           0.0, False)
    with pytest.raises(TypeError):
        at.fused_short_fwd(q.half(), q.half(), q.half(), None, None, 0.25,
                           0.0, False)
    with pytest.raises(ValueError):  # non-contiguous
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        at.fused_short_fwd(qt, qt, qt, None, None, 0.25, 0.0, False)
    with pytest.raises(ValueError):  # seq > 512
        w = torch.zeros(1, 1, 513, 8)
        at.fused_short_fwd(w, w, w, None, None, 0.25, 0.0, False)
    with pytest.raises(ValueError):  # bias not [b, s] f32
        at.fused_short_fwd(q, q, q, torch.zeros(1, 8).double(), None, 0.25,
                           0.0, False)
    with pytest.raises(ValueError):  # dropout without a seed
        at.fused_short_fwd(q, q, q, None, None, 0.25, 0.1, False)
    with pytest.raises(ValueError):
        at.fused_short_bwd(q, q, q, q, None, None, 0.25, 1.0, False)


def test_fused_short_applicable_is_the_jax_rule_without_the_device():
    assert at.fused_short_applicable(128, 128, False)
    assert at.fused_short_applicable(512, 512, True)
    assert not at.fused_short_applicable(513, 513, False)
    assert not at.fused_short_applicable(16, 32, False)
