"""The torch port's flash attention against the JAX package on CPU.

On a CPU tensor the port's flash attention runs the plain versions of its
kernels: B4's forward (full-row softmax in exp2 units, the lse saved) and
the backward of B6 or of B5a + B5b, written out. The JAX package off a TPU
runs ``blockwise_attention`` and autodiff through it (its own tests' path).
The two compute the same function with sums in other orders: f32, atol
2e-5, inputs from numpy seeds. ``blockwise_attention`` and
``masked_context`` are plain in both packages and held at 1e-5.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as jat
from analytics_zoo_tpu_torch.ops import attention as at

ATOL = 2e-5
#: (q_len, kv_len): ragged tiles, lengths apart, the LM's S - 1 shapes
LENGTHS = [(1, 1), (17, 17), (89, 89), (130, 130), (17, 70), (70, 17),
           (1, 33), (600, 600)]


def _inputs(seed, sq, skv, d=16, b=2, h=2):
    rs = np.random.RandomState(seed)
    q, g = (rs.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, h, skv, d).astype(np.float32) for _ in range(2))
    glse = rs.randn(b, h, sq).astype(np.float32)
    mask = (rs.rand(b, skv) < 0.25).astype(np.float32)
    mask[:, 0] = 0  # every row keeps a key
    return q, k, v, g, glse, mask * -1e9


def _jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return out, [np.asarray(x) for x in vjp(cot)]


def _port_grads(fn, args, cots):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)),
        torch.zeros(())).backward()
    return [o.detach().numpy() for o in outs], [t.grad.numpy()
                                                for t in leaves]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,skv", LENGTHS,
                         ids=[f"{a}x{b}" for a, b in LENGTHS])
def test_flash_attention_and_its_gradients_match_jax(sq, skv, causal):
    q, k, v, g, _, _ = _inputs(sq * 7 + skv, sq, skv)
    want, want_grads = _jax_vjp(
        lambda q, k, v: jat.flash_attention(q, k, v, causal=causal),
        (q, k, v), jnp.asarray(g))
    got, got_grads = _port_grads(
        lambda q, k, v: at.flash_attention(q, k, v, causal=causal),
        (q, k, v), (g,))
    np.testing.assert_allclose(got[0], np.asarray(want), rtol=0, atol=ATOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,skv", [(17, 17), (130, 130), (70, 17),
                                    (17, 70)])
def test_flash_attention_lse_is_jointly_differentiable_like_jax(sq, skv,
                                                                causal):
    """The lse cotangent ``glse`` enters ``ds`` in every backward."""
    q, k, v, g, glse, _ = _inputs(sq + 3 * skv, sq, skv)
    (want_o, want_lse), want_grads = _jax_vjp(
        lambda q, k, v: jat.flash_attention_lse(q, k, v, causal=causal),
        (q, k, v), (jnp.asarray(g), jnp.asarray(glse)))
    (got_o, got_lse), got_grads = _port_grads(
        lambda q, k, v: at.flash_attention_lse(q, k, v, causal=causal),
        (q, k, v), (g, glse))
    np.testing.assert_allclose(got_o, np.asarray(want_o), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_lse, np.asarray(want_lse), rtol=0,
                               atol=ATOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,skv", [(17, 17), (89, 89), (600, 600),
                                    (70, 17)])
def test_flash_attention_with_a_key_bias_matches_jax(sq, skv, causal):
    """A ``[b, 1, 1, kv]`` padding bias: B4's forward with its bias
    operand, the backward through the blockwise recompute, the bias's
    gradient zero."""
    q, k, v, g, _, bias = _inputs(sq + skv + 1, sq, skv)
    jb = jnp.asarray(bias)[:, None, None, :]
    want, want_grads = _jax_vjp(
        lambda q, k, v: jat.flash_attention(q, k, v, bias=jb, causal=causal),
        (q, k, v), jnp.asarray(g))
    tb = torch.tensor(bias)[:, None, None, :].requires_grad_()
    got, got_grads = _port_grads(
        lambda q, k, v: at.flash_attention(q, k, v, bias=tb, causal=causal),
        (q, k, v), (g,))
    np.testing.assert_allclose(got[0], np.asarray(want), rtol=0, atol=ATOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")
    assert tb.grad is not None and not tb.grad.any()


def test_a_bias_of_another_shape_takes_blockwise_attention():
    q, k, v, g, _, _ = _inputs(5, 17, 17)
    bias = np.random.RandomState(5).randn(17, 17).astype(np.float32)
    want = jat.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               bias=jnp.asarray(bias), causal=True)
    got = at.flash_attention(*(torch.tensor(a) for a in (q, k, v)),
                             bias=torch.tensor(bias), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_both_backward_designs_compute_the_same_gradients(causal):
    """B6's plain version (one pass) and B5a + B5b's (two) agree, with and
    without an lse cotangent, and match JAX's vjp of ``flash_attention_
    lse``."""
    q, k, v, g, glse, _ = _inputs(11, 130, 70)
    tq, tk, tv, tg, tgl = (torch.tensor(a) for a in (q, k, v, g, glse))
    o, lse = at.flash_fwd_plain(tq, tk, tv, None, 0.25, causal)
    delta = (tg * o).sum(-1)
    for gl, jgl in ((None, np.zeros_like(glse)), (tgl, glse)):
        args = (tq, tk, tv, tg, lse, delta, gl, 0.25, causal)
        fused = at.flash_bwd_fused_plain(*args)
        two = (at.flash_bwd_dq_plain(*args),) + at.flash_bwd_dkv_plain(*args)
        _, want = _jax_vjp(
            lambda q, k, v: jat.flash_attention_lse(q, k, v, causal=causal),
            (q, k, v), (jnp.asarray(g), jnp.asarray(jgl)))
        for name, a, b, w in zip("qkv", fused, two, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"d{name}")
            np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=ATOL,
                                       err_msg=f"d{name}")


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    q, k, v, g, _, bias = _inputs(2, 40, 40)
    at.reset_launch_counts()
    _port_grads(lambda q, k, v: at.flash_attention(q, k, v, causal=True),
                (q, k, v), (g,))
    tb = torch.tensor(bias)[:, None, None, :]
    _port_grads(lambda q, k, v: at.flash_attention(q, k, v, bias=tb),
                (q, k, v), (g,))
    assert at.flash_launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                      "flash_bwd_dkv": 0,
                                      "flash_bwd_fused": 0}


def test_the_backward_design_is_the_jax_resident_bytes_rule():
    """The port's ``fused_bwd_applicable`` picks the JAX package's design
    wherever the JAX rule's TPU lane term holds (q tiles of a multiple of
    128 rows, or one tile): the same resident-bytes test, the same
    constant."""
    assert at._FUSED_BWD_MAX_RESIDENT_BYTES == \
        jat._FUSED_BWD_MAX_RESIDENT_BYTES
    checked = 0
    for q_len, kv_len, d, itemsize in itertools.product(
            (128, 512, 2048, 4096, 8192), (511, 2047, 2048, 4095, 4096, 8192,
                                           16384), (64, 128), (2, 4)):
        want = jat._fused_bwd_applicable(q_len, kv_len, d,
                                         jat.DEFAULT_Q_BLOCK, itemsize)
        assert at.fused_bwd_applicable(kv_len, d, itemsize) == want, \
            (q_len, kv_len, d, itemsize)
        checked += 1
    assert checked == 140
    # the LM's shapes: 2047 keys in f32 take B6, 4095 take B5a + B5b;
    # 4096 bf16 keys (the long-sequence benchmark) take B6
    assert at.fused_bwd_applicable(2047, 128, itemsize=4)
    assert not at.fused_bwd_applicable(4095, 128, itemsize=4)
    assert at.fused_bwd_applicable(4096, 128, itemsize=2)
    # off the lane rule the port still follows the bytes alone
    assert at.fused_bwd_applicable(2047, 128, 4)
    assert not jat._fused_bwd_applicable(2047, 2047, 128, 512, 4)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("blocks", [(512, 1024), (7, 9)])
def test_blockwise_attention_matches_jax(causal, blocks):
    q, k, v, g, _, bias = _inputs(13, 63, 45)
    jb = jnp.asarray(bias)[:, None, None, :]
    want, want_lse = jat.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), bias=jb, causal=causal,
        q_block=blocks[0], kv_block=blocks[1], return_lse=True)
    got, lse = at.blockwise_attention(
        *(torch.tensor(a) for a in (q, k, v)),
        bias=torch.tensor(bias)[:, None, None, :], causal=causal,
        q_block=blocks[0], kv_block=blocks[1], return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=1e-5)


def test_blockwise_dropout_uses_the_kernels_murmur3_bits():
    """Per-block dropout keeps an entry where murmur3 of (bh, row, col)
    keyed by the call's seed clears the threshold: equal to post-softmax
    dropout through that mask, whatever the blocks."""
    q, k, v, _, _, _ = (torch.tensor(a) for a in _inputs(17, 40, 40))
    rate = 0.2
    outs = [at.blockwise_attention(
        q, k, v, causal=True, q_block=qb, kv_block=kb, dropout_rate=rate,
        generator=torch.Generator().manual_seed(4)) for qb, kb in
        ((512, 1024), (8, 5))]
    seed = torch.randint(0, 2 ** 31 - 1, (1,),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    keep = at.dropout_keep_mask(seed, 4, 40, rate).reshape(2, 2, 40, 40)
    p = at.dot_product_attention(q, k, torch.eye(40).expand(2, 2, 40, 40),
                                 causal=True)
    want = torch.matmul(torch.where(keep, p / (1 - rate), 0.0), v)
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


def test_masked_context_matches_jax():
    rs = np.random.RandomState(3)
    q = rs.randn(2, 3, 4, 8).astype(np.float32)
    kb, vb = (rs.randn(2, 3, 20, 8).astype(np.float32) for _ in range(2))
    visible = (np.arange(20)[None, :] <= 9 + np.arange(4)[:, None])
    want = jat.masked_context(jnp.asarray(q), jnp.asarray(kb),
                              jnp.asarray(vb), jnp.asarray(visible), 0.35)
    got = at.masked_context(torch.tensor(q), torch.tensor(kb),
                            torch.tensor(vb), torch.tensor(visible), 0.35)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_flash_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(TypeError):
        at.flash_fwd(q.half(), q.half(), q.half(), None, 0.1, False)
    with pytest.raises(ValueError):  # non-contiguous
        qt = q.transpose(2, 3)
        at.flash_fwd(qt, qt, qt, None, 0.1, False)
    with pytest.raises(ValueError):  # k and v of other shapes
        at.flash_fwd(q, q, q[:, :, :4].contiguous(), None, 0.1, False)
    with pytest.raises(ValueError):  # bias not [b, kv] f32
        at.flash_fwd(q, q, q, torch.zeros(1, 8).double(), 0.1, False)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):  # lse of another shape
        at.flash_bwd_fused(q, q, q, q, lse[:, :, :4], lse, None, 0.1, False)
