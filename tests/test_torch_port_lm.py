"""The torch port's TransformerLM against the JAX package's on CPU.

The JAX model's parameters are copied into the port by name
(``convert.from_jax_params`` walks the ``blocks`` list), so both start
from the same weights; token data comes from numpy seeds. On the CPU the
port's flash attention runs its kernels' plain versions and JAX its
blockwise reference (its own tests' path): the same function with sums in
other orders. Float results are held at 1e-5 (losses relative), tokens
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.capture import TransformerLM as JaxLM
from analytics_zoo_tpu_torch.capture import (GraphModel, TransformerLM,
                                             prefill_bucket)
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.ops import attention as at

ATOL = 1e-5
CFG = dict(vocab_size=128, hidden=32, n_block=2, n_head=2, max_len=64)


def _pair(seed=0, **cfg):
    cfg = dict(CFG, **cfg)
    jlm = JaxLM(seed=seed, **cfg)
    params = jlm._init_params(jax.random.PRNGKey(seed), None)
    jlm._graph.estimator.set_params(params)
    plm = TransformerLM(seed=seed, **cfg)
    plm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jlm, plm


def _tree_max_diff(a, b):
    fa = from_jax_params(jax.tree_util.tree_map(np.asarray, a))
    fb = from_jax_params(b)
    assert set(fa) == set(fb)
    return max(float((fa[k] - fb[k]).abs().max()) for k in fa)


def test_jax_params_map_onto_the_state_dict_one_for_one():
    jlm = JaxLM(seed=1, **CFG)
    params = jlm._init_params(jax.random.PRNGKey(1), None)
    flat = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    plm = TransformerLM(**CFG)
    state = plm.state_dict()
    assert set(flat) == set(state)
    assert len(flat) == 2 + 12 * CFG["n_block"] + 2
    for key, value in flat.items():
        assert tuple(value.shape) == tuple(state[key].shape), key
    assert "blocks.1.fc2.kernel" in flat
    # and back: the port's params tree is the JAX tree with list indices as
    # keys, which from_jax_params maps to the same names
    assert set(from_jax_params(plm.params)) == set(state)


def test_logits_match_jax():
    jlm, plm = _pair()
    tokens = np.random.RandomState(0).randint(0, 128, (4, 20))
    want = np.asarray(jlm.logits(tokens))
    got = plm.logits(tokens, device="cpu")
    assert got.shape == (4, 20, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_three_adam_steps_match_jax():
    jlm, plm = _pair(seed=2)
    # batches of 8: the JAX side runs on the tests' 8-device CPU mesh
    data = np.random.RandomState(2).randint(0, 128, (28, 17))
    want = jlm.fit(data, batch_size=8, epochs=1)
    got = plm.fit(data, batch_size=8, epochs=1, device="cpu")
    assert got["iterations"] == want["iterations"] == 3
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-5, atol=0)
    assert _tree_max_diff(jlm.params, plm.params) <= ATOL
    # the captured loss's evaluate is the record-weighted mean loss
    want_eval = jlm._graph.evaluate(data, batch_size=8)
    got_eval = plm._graph.evaluate(data, batch_size=8)
    np.testing.assert_allclose(got_eval["loss"], want_eval["loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("length", [9, 40])
def test_prefill_kv_matches_jax(length):
    jlm, plm = _pair(seed=3)
    tokens = np.random.RandomState(length).randint(0, 128, (2, length))
    tb = prefill_bucket(length, CFG["max_len"])
    padded = np.zeros((2, tb), np.int32)
    padded[:, :length] = tokens
    want = jlm.prefill_kv(jlm.params, jnp.asarray(padded))
    with torch.no_grad():
        got = plm.prefill_kv(torch.tensor(padded))
    assert len(got) == len(want) == CFG["n_block"]
    for (gk, gv), (wk, wv) in zip(got, want):
        assert tuple(gk.shape) == (2, 2, tb, 16)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0,
                                   atol=ATOL)


def test_greedy_generate_is_token_identical_after_the_same_training():
    """Cyclic-counting data, as the JAX package's own LM test: after the
    same 80 Adam steps both models count on from the prompt."""
    jlm, plm = _pair(seed=4)
    v, s = CFG["vocab_size"], 16
    rs = np.random.RandomState(0)
    data = (rs.randint(0, v, 256)[:, None] + np.arange(s)[None]) % v
    want_fit = jlm.fit(data, batch_size=32, epochs=10)
    got_fit = plm.fit(data, batch_size=32, epochs=10, device="cpu")
    np.testing.assert_allclose(got_fit["loss_history"][:8],
                               want_fit["loss_history"][:8], rtol=1e-5)
    prompt = data[:3, :5]
    want = jlm.generate(prompt, max_new_tokens=8)
    got, logits = plm.generate(prompt, max_new_tokens=8,
                               return_logits=True)
    np.testing.assert_array_equal(got, want)
    expect = np.stack([(p[-1] + 1 + np.arange(8)) % v for p in prompt])
    np.testing.assert_array_equal(got, expect)
    # each step's logits are the full causal forward's at its position
    full = plm.logits(np.concatenate([prompt, got[:, :-1]], 1))
    np.testing.assert_allclose(logits, full[:, 4:], rtol=0, atol=ATOL)


def test_a_long_prompt_prefills_through_flash_and_matches_jax():
    """max_len 1100 and a 600-token prompt: the prefill pads to max_len,
    past the fused short kernel's 512, so it takes flash attention."""
    jlm, plm = _pair(seed=5, max_len=1100)
    prompt = np.random.RandomState(5).randint(0, 128, (2, 600))
    want = jlm.generate(prompt, max_new_tokens=4)
    calls = []
    real = at.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[-2])
        return real(*a, **kw)

    import analytics_zoo_tpu_torch.capture.lm as lm_mod
    lm_mod.flash_attention = spy
    try:
        got, logits = plm.generate(prompt, max_new_tokens=4, device="cpu",
                                   return_logits=True)
    finally:
        lm_mod.flash_attention = real
    assert calls == [1100] * CFG["n_block"]
    np.testing.assert_array_equal(got, want)
    full = np.asarray(jlm.logits(np.concatenate([prompt, got[:, :-1]], 1)))
    np.testing.assert_allclose(logits, full[:, 599:], rtol=0, atol=ATOL)


def test_generate_guards_and_what_waits_for_later_slices():
    _, plm = _pair(seed=6, max_len=8)
    with pytest.raises(ValueError, match="exceeds max_len"):
        plm.generate(np.zeros((1, 6), np.int32), max_new_tokens=4,
                     device="cpu")
    for kw in (dict(beam_size=2), dict(temperature=0.7), dict(top_k=3)):
        with pytest.raises(NotImplementedError, match="GenerativeServing"):
            plm.generate(np.zeros((1, 3), np.int32), 2, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="slice, 6"):
        TransformerLM(vocab_size=5, hidden=8, n_head=2, tensor_parallel=True)


def test_graph_model_from_loss_trains_any_module():
    """``from_loss`` over a plain module: fit with ``y`` absent sees the
    same batches, and ends at the same weights, as with labels; the
    captured loss's evaluate falls; predict needs a forward_fn."""
    x = np.random.RandomState(0).randn(20, 3).astype(np.float32)

    def run(labels):
        lin = torch.nn.Linear(3, 1)
        with torch.no_grad():
            lin.weight.copy_(torch.tensor([[0.5, -1.0, 2.0]]))
            lin.bias.fill_(0.25)
        seen = []

        def loss(m, xb, yb):
            assert (yb is None) == (labels is None)
            seen.append(xb.clone())
            return (m(xb) ** 2).mean()

        gm = GraphModel.from_loss(loss, lambda gen, sx: lin, optimizer="sgd")
        before = gm.evaluate(x, labels, batch_size=8, device="cpu")["loss"]
        seen.clear()
        hist = gm.fit(x, labels, batch_size=5, epochs=2)
        trained = list(seen)
        after = gm.evaluate(x, labels, batch_size=8)["loss"]
        return gm, trained, hist, before, after

    gm, seen, hist, before, after = run(None)
    _, seen_y, hist_y, _, _ = run(np.zeros(20, np.float32))
    assert hist["iterations"] == 8 and len(seen) == 8
    assert all(torch.equal(a, b) for a, b in zip(seen, seen_y))
    assert hist["loss_history"] == hist_y["loss_history"]
    assert after < before
    with pytest.raises(NotImplementedError, match="forward_fn"):
        gm.predict(x)
    assert set(gm.get_weights()) == {"weight", "bias"}
