"""The torch port's flash attention in bf16 against the JAX package on CPU.

In bf16, every flash kernel (B4, B5a, B5b, B6) rounds ``p`` to bf16
before ``p·v`` and ``pᵀ·dO``, and ``ds`` before ``ds·k`` and ``dsᵀ·q``,
where the TPU kernel rounds them; on a CPU tensor the port runs their
plain versions, which round at the same places. The JAX package off a TPU
runs ``blockwise_attention`` in bf16 and autodiff through it. Both take
the same bf16 inputs from numpy seeds; the outputs and gradients round to
8 bits, so they are held within 2e-2 of their scale (``BF16_TOL``, as
``test_torch_port_attention.py``). In f32 the rounding is the identity:
the plain versions are unchanged, and ``test_torch_port_flash.py`` holds
them against JAX at 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as jat
from analytics_zoo_tpu_torch.ops import attention as at

#: bf16 outputs round to 8 bits: relative to the output's scale
BF16_TOL = 2e-2
#: (q_len, kv_len): one element, ragged 64-row tiles, lengths apart
LENGTHS = [(1, 1), (17, 17), (130, 130), (17, 70), (70, 17), (600, 600)]


def _inputs(seed, sq, skv, d=16, b=2, h=2):
    """f32 numpy arrays already rounded to bf16, so both packages start
    from the same values."""
    rs = np.random.RandomState(seed)
    q, g = (rs.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, h, skv, d).astype(np.float32) for _ in range(2))
    mask = (rs.rand(b, skv) < 0.25).astype(np.float32)
    mask[:, 0] = 0  # every row keeps a key
    arrays = [torch.tensor(a).bfloat16().float().numpy() for a in (q, k, v,
                                                                   g)]
    return arrays + [mask * -1e9]


def _close_to_scale(got, want, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= BF16_TOL * scale, f"{what}: {err} > {BF16_TOL} x {scale}"


def _jax_bf16(q, k, v, g, bias, causal):
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)[:, None, None, :]
    out, vjp = jax.vjp(
        lambda q, k, v: jat.flash_attention(q, k, v, bias=jb,
                                            causal=causal), *args)
    grads = vjp(jnp.asarray(g, jnp.bfloat16))
    return (np.asarray(out, np.float32),
            [np.asarray(x, np.float32) for x in grads])


def _port_bf16(q, k, v, g, bias, causal):
    leaves = [torch.tensor(a).bfloat16().requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else torch.tensor(bias)[:, None, None, :]
    out = at.flash_attention(*leaves, bias=tb, causal=causal)
    out.backward(torch.tensor(g).bfloat16())
    assert out.dtype == torch.bfloat16
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in leaves])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,skv", LENGTHS,
                         ids=[f"{a}x{b}" for a, b in LENGTHS])
def test_bf16_flash_attention_and_its_gradients_match_jax_in_bf16(
        sq, skv, causal):
    """The bf16 route's plain B4 and B6 (p and ds rounded to bf16) against
    JAX's ``flash_attention`` and its vjp run in bf16 on the same inputs."""
    q, k, v, g, _ = _inputs(sq * 5 + skv, sq, skv)
    want, want_grads = _jax_bf16(q, k, v, g, None, causal)
    got, got_grads = _port_bf16(q, k, v, g, None, causal)
    _close_to_scale(got, want, "o")
    for name, a, b in zip("qkv", got_grads, want_grads):
        _close_to_scale(a, b, f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,skv", [(17, 17), (130, 130), (70, 17),
                                    (17, 70)])
def test_bf16_flash_attention_with_a_key_bias_matches_jax_in_bf16(
        sq, skv, causal):
    """A ``[b, 1, 1, kv]`` padding bias in bf16: B4's plain forward with
    its bias operand (p rounded to bf16), the backward through the
    blockwise recompute."""
    q, k, v, g, bias = _inputs(sq + skv + 3, sq, skv)
    want, want_grads = _jax_bf16(q, k, v, g, bias, causal)
    got, got_grads = _port_bf16(q, k, v, g, bias, causal)
    _close_to_scale(got, want, "o")
    for name, a, b in zip("qkv", got_grads, want_grads):
        _close_to_scale(a, b, f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,skv", LENGTHS,
                         ids=[f"{a}x{b}" for a, b in LENGTHS])
def test_bf16_two_pass_plain_gradients_match_jax_in_bf16(sq, skv, causal):
    """The two-pass backward's plain versions in bf16 (B5a's dq, B5b's dk
    and dv, p and ds rounded to bf16), from the lse of B4's plain forward
    and D = rowsum(dO·o) over its bf16 output, against the vjp of JAX's
    ``flash_attention`` run in bf16 on the same inputs."""
    q, k, v, g, _ = _inputs(sq * 7 + skv, sq, skv)
    _, want_grads = _jax_bf16(q, k, v, g, None, causal)
    tq, tk, tv, tg = (torch.tensor(a).bfloat16() for a in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    o, lse = at.flash_fwd_plain(tq, tk, tv, None, scale, causal)
    delta = (tg.float() * o.float()).sum(-1)
    args = (tq, tk, tv, tg, lse, delta, None, scale, causal)
    got = (at.flash_bwd_dq_plain(*args),) + at.flash_bwd_dkv_plain(*args)
    for name, a, b in zip("qkv", got, want_grads):
        assert a.dtype == torch.bfloat16
        _close_to_scale(a.float().numpy(), b, f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_plain_versions_round_p_and_ds_and_f32_ones_round_nothing(
        causal):
    """Every backward plain version rounds ``p`` and ``ds`` to the inputs'
    dtype before each product, as the TPU kernels and the CUDA kernels do:
    the two-pass design's plain dq, dk and dv (B5a, B5b) equal the
    one-pass design's (B6) bit for bit in f32 and in bf16. In bf16 they
    differ from the same arithmetic with p and ds kept in f32 by that
    rounding alone; in f32 the rounding is the identity."""
    q, k, v, g, _ = (torch.tensor(a) for a in _inputs(21, 90, 70))
    glse = torch.from_numpy(
        np.random.RandomState(3).randn(2, 2, 90).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv, tg = (t.to(dtype) for t in (q, k, v, g))
        o, lse = at.flash_fwd_plain(tq, tk, tv, None, 0.25, causal)
        delta = (tg.float() * o.float()).sum(-1)
        for gl in (None, glse):
            args = (tq, tk, tv, tg, lse, delta, gl, 0.25, causal)
            fused = at.flash_bwd_fused_plain(*args)
            two = (at.flash_bwd_dq_plain(*args),) + \
                at.flash_bwd_dkv_plain(*args)
            kept = at._bwd_one_pass(*args, torch.float32)
            assert all(t.dtype == dtype for t in fused + two + kept)
            for a, b, c in zip(fused, two, kept):
                assert torch.equal(a, b)
                if dtype == torch.float32:
                    assert torch.equal(b, c)
                else:
                    assert not torch.equal(b, c)
                    _close_to_scale(b.float().numpy(), c.float().numpy(),
                                    "rounding")
    # the forward: p·v with p rounded to bf16, the sums and lse in f32
    r = [t.bfloat16() for t in (q, k, v)]
    o, lse = at.flash_fwd_plain(*r, None, 0.25, causal)
    o32, lse32 = at.flash_fwd_plain(*(t.float() for t in r), None, 0.25,
                                    causal)
    assert o.dtype == torch.bfloat16 and torch.equal(lse, lse32)
    assert not torch.equal(o.float(), o32.bfloat16().float())
    _close_to_scale(o.float().numpy(), o32.numpy(), "o")


def test_flash_route_by_dtype():
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
               "flash_bwd_fused")
    assert [at.flash_route(torch.bfloat16, k) for k in kernels] == \
        ["bf16_tc"] * 4
    # f32: every kernel on the tensor cores as 3xTF32
    assert [at.flash_route(torch.float32, k) for k in kernels] == \
        ["f32_tc"] * 4
    with pytest.raises(ValueError):
        at.flash_route(torch.float32, "flash_bwd")
    q, k, v, g, _ = (torch.tensor(a).bfloat16() for a in _inputs(2, 40, 40))
    at.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    at.flash_attention(*leaves, causal=True).backward(g)
    # CPU tensors take the plain versions: no launch on any route
    assert at.flash_route_counts == {"bf16_tc": 0, "f32_tc": 0}
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_flash_backward_matches_autograd_through_the_plain_forward(
        causal):
    """Two references agree in bf16: B6's arithmetic written out, and
    autograd through B4's plain forward, whose rounding of p passes its
    gradient through in f32 (as the kernels keep dp in f32); they differ
    only in B6's rounding of ds and in D, which B6 takes from the bf16
    output."""
    q, k, v, g, _ = (torch.tensor(a).bfloat16() for a in _inputs(8, 70, 90))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = at.flash_fwd_plain(*leaves, None, 0.25, causal)
    o.backward(g)
    o, lse = at.flash_fwd_plain(q, k, v, None, 0.25, causal)
    delta = (g.float() * o.float()).sum(-1)
    got = at.flash_bwd_fused_plain(q, k, v, g, lse, delta, None, 0.25,
                                   causal)
    for name, a, t in zip("qkv", got, leaves):
        assert a.dtype == torch.bfloat16
        _close_to_scale(a.float().numpy(), t.grad.float().numpy(),
                        f"d{name}")
