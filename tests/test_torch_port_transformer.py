"""The port's MultiHeadAttention past 512 keys and its TransformerLayer
against the JAX package on CPU.

Past 512 keys both packages take flash attention (a padding mask riding
in as a key bias), the port through its kernels' plain versions, JAX off a
TPU through ``blockwise_attention``; at or below 512 the JAX package off a
TPU takes ``dot_product_attention`` and the port the fused short kernel's
plain version. The same f32 function with sums in other orders: outputs
atol 2e-5; gradients within 2e-5 of each tensor's scale, its largest
magnitude or 1 (a parameter's gradient sums every position's cotangent,
so it grows to hundreds, and an element that cancels down to a small
value keeps the rounding of its terms). Weights cross over by name
(``convert.from_jax_params``); inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras.layers import (
    MultiHeadAttention as JaxMultiHeadAttention)
from analytics_zoo_tpu.keras.layers import (
    TransformerLayer as JaxTransformerLayer)
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.keras.layers import (MultiHeadAttention,
                                                  TransformerLayer)
from analytics_zoo_tpu_torch.ops import attention as at
from torch_port_threads import torch_threads_per_worker  # noqa: F401

ATOL = 2e-5
TL_CFG = dict(vocab=50, hidden_size=16, n_block=2, n_head=2,
              intermediate_size=32, seq_len=640, hidden_p_drop=0.0,
              attn_p_drop=0.0)


def _jax_params(layer, shape):
    params, _ = layer.build(jax.random.PRNGKey(0), shape)
    return jax.tree_util.tree_map(np.asarray, params)


def _flat_grads(named):
    return {k: p.grad.numpy() for k, p in named}


def _assert_grad_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= ATOL * scale, f"{name}: {err} > {ATOL} x {scale}"


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_past_512_keys_matches_jax(with_mask, causal):
    rs = np.random.RandomState(int(with_mask) + 2 * int(causal))
    x = rs.randn(2, 520, 16).astype(np.float32)
    g = rs.randn(2, 520, 16).astype(np.float32)
    mask = np.ones((2, 520), np.float32)
    mask[1, 300:] = 0
    jm = JaxMultiHeadAttention(2, causal=causal)
    params = _jax_params(jm, (None, 520, 16))

    def fwd(p, x):
        ins = [x, x, jnp.asarray(mask)] if with_mask else x
        return jm.call(p, {}, ins)[0]

    want, vjp = jax.vjp(fwd, jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(x))
    want_gp, want_gx = vjp(jnp.asarray(g))
    pm = MultiHeadAttention(2, causal=causal)
    pm.build(torch.Generator(), (None, 520, 16), torch.device("cpu"))
    pm.load_state_dict(from_jax_params(params), strict=True)
    tx = torch.tensor(x, requires_grad=True)
    ins = [tx, tx, torch.tensor(mask)] if with_mask else tx
    at.reset_launch_counts()
    got = pm(ins)
    (got * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    _assert_grad_close(tx.grad.numpy(), np.asarray(want_gx), "x")
    want_flat = from_jax_params(jax.tree_util.tree_map(np.asarray, want_gp))
    for k, a in _flat_grads(pm.named_parameters()).items():
        _assert_grad_close(a, want_flat[k].numpy(), k)


def _layer_pair(seq):
    jl = JaxTransformerLayer(**TL_CFG)
    params = _jax_params(jl, [(None, seq), (None, seq)])
    pl = TransformerLayer(**TL_CFG, name="tl")
    pl.build(torch.Generator(), [(None, seq), (None, seq)],
             torch.device("cpu"))
    pl.load_state_dict(from_jax_params(params), strict=True)
    return jl, params, pl


@pytest.mark.parametrize("seq", [40, 600], ids=["fused_short", "flash"])
def test_transformer_layer_forward_and_gradients_match_jax(seq):
    jl, params, pl = _layer_pair(seq)
    rs = np.random.RandomState(seq)
    tokens = rs.randint(0, TL_CFG["vocab"], (2, seq)).astype(np.int32)
    positions = np.broadcast_to(np.arange(seq, dtype=np.int32),
                                (2, seq)).copy()
    cots = [rs.randn(2, seq, 16).astype(np.float32) for _ in range(2)] + [
        rs.randn(2, 16).astype(np.float32)]

    def loss(p):
        outs, _ = jl.call(p, {}, [jnp.asarray(tokens),
                                  jnp.asarray(positions)])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    outs = pl([torch.tensor(tokens), torch.tensor(positions)])
    assert len(outs) == TL_CFG["n_block"] + 1
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    for i, (a, b) in enumerate(zip(outs, want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=f"output {i}")
    want_flat = from_jax_params(jax.tree_util.tree_map(np.asarray, want_g))
    got = _flat_grads(pl.named_parameters())
    assert set(got) == set(want_flat)
    for k, a in got.items():
        _assert_grad_close(a, want_flat[k].numpy(), k)


def test_transformer_layer_defaults_its_positions_to_arange():
    _, _, pl = _layer_pair(30)
    tokens = torch.tensor(np.random.RandomState(1).randint(0, 50, (2, 30)))
    positions = torch.arange(30).expand(2, 30)
    with torch.no_grad():
        for a, b in zip(pl(tokens), pl([tokens, positions])):
            assert torch.equal(a, b)


#: heads of 256, past the CUDA kernels' 128: the plain versions take them
WIDE_TL_CFG = dict(TL_CFG, hidden_size=512, n_block=1, intermediate_size=64)
WIDE_LM_CFG = dict(vocab_size=50, hidden=512, n_block=1, n_head=2,
                   intermediate=64, max_len=640)


def _wide_layer_run(seq, rs):
    """TransformerLayer's outputs and parameter gradients, JAX's and the
    port's, under the same weights, tokens and cotangents."""
    jl = JaxTransformerLayer(**WIDE_TL_CFG)
    params = _jax_params(jl, [(None, seq), (None, seq)])
    pl = TransformerLayer(**WIDE_TL_CFG, name="tl")
    pl.build(torch.Generator(), [(None, seq), (None, seq)],
             torch.device("cpu"))
    pl.load_state_dict(from_jax_params(params), strict=True)
    tokens = rs.randint(0, WIDE_TL_CFG["vocab"], (2, seq)).astype(np.int32)
    positions = np.broadcast_to(np.arange(seq, dtype=np.int32),
                                (2, seq)).copy()
    hid = WIDE_TL_CFG["hidden_size"]
    cots = [rs.randn(2, seq, hid).astype(np.float32)
            for _ in range(WIDE_TL_CFG["n_block"])] + [
        rs.randn(2, hid).astype(np.float32)]

    def loss(p):
        outs, _ = jl.call(p, {}, [jnp.asarray(tokens),
                                  jnp.asarray(positions)])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    outs = pl([torch.tensor(tokens), torch.tensor(positions)])
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    return (outs, want), (_flat_grads(pl.named_parameters()), want_g)


def _wide_lm_run(seq, rs):
    """TransformerLM's logits and parameter gradients of a causal forward
    over ``seq`` tokens, JAX's and the port's, from the same weights, and
    both models' greedy continuation of a ``seq``-token prompt (its
    prefill through the fused short kernel's plain version at a bucket of
    512 or less, through flash above)."""
    from analytics_zoo_tpu.capture import TransformerLM as JaxLM
    from analytics_zoo_tpu_torch.capture import TransformerLM

    jlm = JaxLM(seed=0, **WIDE_LM_CFG)
    params = jlm._init_params(jax.random.PRNGKey(0), None)
    jlm._graph.estimator.set_params(params)
    plm = TransformerLM(**WIDE_LM_CFG)
    plm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    tokens = rs.randint(0, WIDE_LM_CFG["vocab_size"], (2, seq))
    cot = rs.randn(2, seq, WIDE_LM_CFG["vocab_size"]).astype(np.float32)

    def loss(p):
        out = jlm._forward(p, jnp.asarray(tokens))
        return jnp.sum(out * cot), out

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(params)
    got = plm._forward(torch.tensor(tokens))
    (got * torch.tensor(cot)).sum().backward()
    grads = (_flat_grads(plm.named_parameters()), want_g)
    prompt = tokens[:, :seq]
    want_gen = jlm.generate(prompt, max_new_tokens=4)
    got_gen = plm.generate(prompt, max_new_tokens=4, device="cpu")
    np.testing.assert_array_equal(got_gen, want_gen)
    return ([got], [want]), grads


@pytest.mark.parametrize("seq", [40, 600], ids=["fused_short", "flash"])
@pytest.mark.parametrize("model", ["layer", "lm"])
def test_heads_of_256_run_on_the_cpu_and_match_jax(model, seq):
    """Head dim 256, past the 128 the CUDA kernels take: on the CPU the
    port computes it through the plain versions, as the JAX package does,
    within the file's tolerances (outputs atol 2e-5, gradients 2e-5 of
    each tensor's scale); the LM's greedy tokens are equal."""
    rs = np.random.RandomState(seq + len(model))
    at.reset_launch_counts()
    run = _wide_layer_run if model == "layer" else _wide_lm_run
    (outs, want), (got_g, want_g) = run(seq, rs)
    for i, (a, b) in enumerate(zip(outs, want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=f"output {i}")
    want_flat = from_jax_params(jax.tree_util.tree_map(np.asarray, want_g))
    assert set(got_g) == set(want_flat)
    for k, a in got_g.items():
        _assert_grad_close(a, want_flat[k].numpy(), k)
    assert sum(at.launch_counts.values()) == 0
    assert sum(at.flash_launch_counts.values()) == 0
