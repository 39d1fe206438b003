"""BERT in the torch port against the JAX package on CPU.

Small BERT (2 blocks, hidden 32, 2 heads, intermediate 64, vocab 100),
inputs from numpy seeds with padded rows, f32. The JAX model's weights are
carried across by name (``convert.from_jax_params``). Tolerances: forward
states and pooled output atol 1e-5 (two packages, the same f32 function,
sums in another order); training losses rtol 1e-5 and parameters and
predictions atol 1e-5 after 2 epochs (Adam normalises each step, so the
gap stays at rounding size). In bf16 the states agree within 3e-2, two
bf16 steps at their magnitude (layer-normed values up to about 4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.capture import text as jax_text
from analytics_zoo_tpu.keras.layers import BERT as JaxBERT
from analytics_zoo_tpu.keras.layers import (
    MultiHeadAttention as JaxMultiHeadAttention)
from analytics_zoo_tpu_torch.capture import (BERTClassifier, BERTNER,
                                             bert_input_pack)
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras.layers import (BERT, Dense, Dropout,
                                                  MultiHeadAttention)
from analytics_zoo_tpu_torch.ops import attention as at
from torch_port_threads import torch_threads_per_worker  # noqa: F401

CFG = dict(vocab=100, hidden_size=32, n_block=2, n_head=2,
           intermediate_size=64, max_position_len=64)
NO_DROP = dict(CFG, hidden_p_drop=0.0, attn_p_drop=0.0)
SEQ, N, BATCH = 24, 48, 8
ATOL = 1e-5


def _tokens(seed=0, n=N, s=SEQ):
    """Token ids in [1, 100), each row padded with 0 after a random
    length, so every attention call sees a padding bias."""
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, CFG["vocab"], (n, s))
    for i, length in enumerate(rs.randint(4, s + 1, n)):
        tok[i, length:] = 0
    return tok


def _jax_params(layer_or_model, shape):
    params, _ = layer_or_model.build(jax.random.PRNGKey(0), shape)
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_bert_and_port(compute_dtype=None, use_flash=True):
    jb = JaxBERT(**CFG, compute_dtype=None if compute_dtype is None
                 else jnp.bfloat16)
    params = _jax_params(jb, [(None, SEQ)] * 4)
    pb = BERT(**CFG, compute_dtype=compute_dtype, use_flash=use_flash,
              name="bert")
    pb.build(torch.Generator(), [(None, SEQ)] * 4, torch.device("cpu"))
    pb.load_state_dict(from_jax_params(params), strict=True)
    return jb, params, pb.eval()


@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["fused_short", "dot_product"])
def test_bert_forward_matches_jax(use_flash):
    jb, params, pb = _jax_bert_and_port(use_flash=use_flash)
    x = bert_input_pack(_tokens(n=4))
    want, _ = jb.call(params, {}, [jnp.asarray(a) for a in x])
    with torch.no_grad():
        got = pb([torch.from_numpy(a) for a in x])
    assert len(got) == len(want) == CFG["n_block"] + 1
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=f"output {i}")


def test_bert_forward_in_bfloat16_matches_jax():
    jb, params, pb = _jax_bert_and_port(compute_dtype="bfloat16")
    x = bert_input_pack(_tokens(n=4))
    want, _ = jb.call(params, {}, [jnp.asarray(a) for a in x])
    with torch.no_grad():
        got = pb([torch.from_numpy(a) for a in x])
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=3e-2)


def test_cross_attention_with_a_mask_matches_jax():
    """``q_len != kv_len`` takes ``dot_product_attention``, as in JAX."""
    rs = np.random.RandomState(1)
    xq = rs.randn(2, 5, 16).astype(np.float32)
    xkv = rs.randn(2, 9, 16).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[1, 4:] = 0
    jm = JaxMultiHeadAttention(4)
    params = _jax_params(jm, [(None, 5, 16), (None, 9, 16)])
    want, _ = jm.call(params, {}, [jnp.asarray(xq), jnp.asarray(xkv),
                                   jnp.asarray(mask)])
    pm = MultiHeadAttention(4)
    pm.build(torch.Generator(), [(None, 5, 16), (None, 9, 16)],
             torch.device("cpu"))
    pm.load_state_dict(from_jax_params(params), strict=True)
    got = pm([torch.tensor(xq), torch.tensor(xkv), torch.tensor(mask)])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_kv_len_past_512_takes_flash_and_equals_the_plain_path():
    mha = MultiHeadAttention(1, 8)
    mha.build(torch.Generator().manual_seed(0), (None, 513, 8),
              torch.device("cpu"))
    x = torch.randn(1, 513, 8, generator=torch.Generator().manual_seed(1))
    got = mha(x)
    assert got.shape == (1, 513, 8)
    mha.use_flash = False
    np.testing.assert_allclose(got.detach().numpy(),
                               mha(x).detach().numpy(), rtol=0, atol=ATOL)


def _classifier_pair(make_jax, make_port):
    jc, pc = make_jax(), make_port()
    params = _jax_params(jc.model, [(None, SEQ)] * 4)
    jc.model.get_estimator().set_params(params)
    pc.build(SEQ, device="cpu")
    pc.model.load_state_dict(from_jax_params(params), strict=True)
    return jc, pc


def _assert_params_close(jax_est, port_est):
    want = from_jax_params(jax_est.get_params())
    got = from_jax_params(port_est.get_params())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=ATOL, err_msg=k)


def test_bert_classifier_fit_evaluate_predict_match_jax():
    jc, pc = _classifier_pair(
        lambda: jax_text.BERTClassifier(3, bert_config=NO_DROP, dropout=0.0),
        lambda: BERTClassifier(3, bert_config=NO_DROP, dropout=0.0))
    tok = _tokens()
    y = np.random.RandomState(9).randint(0, 3, N).astype(np.float32)
    want = jc.fit(tok, y, batch_size=BATCH, epochs=2)
    got = pc.fit(tok, y, batch_size=BATCH, epochs=2, device="cpu")
    assert got["iterations"] == want["iterations"] == 2 * N // BATCH
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-5, atol=0)
    _assert_params_close(jc.model.get_estimator(),
                         pc.model.get_estimator())
    tv, yv = _tokens(seed=1, n=20), np.arange(20) % 3
    want_eval = jc.evaluate(tv, yv, batch_size=8)
    got_eval = pc.evaluate(tv, yv, batch_size=8)
    assert got_eval.keys() == want_eval.keys() == {"accuracy"}
    np.testing.assert_allclose(got_eval["accuracy"], want_eval["accuracy"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pc.predict(tv, batch_size=16),
                               np.asarray(jc.predict(tv, batch_size=16)),
                               rtol=0, atol=ATOL)


def test_bert_ner_per_token_loss_and_fit_match_jax():
    jn, pn = _classifier_pair(
        lambda: jax_text.BERTNER(4, bert_config=NO_DROP, dropout=0.0),
        lambda: BERTNER(4, bert_config=NO_DROP, dropout=0.0))
    tok = _tokens(seed=2)
    tags = np.random.RandomState(3).randint(0, 4, tok.shape)
    want = jn.fit(tok, tags, batch_size=BATCH, epochs=1)
    got = pn.fit(tok, tags, batch_size=BATCH, epochs=1, device="cpu")
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-5, atol=0)
    _assert_params_close(jn.model.get_estimator(),
                         pn.model.get_estimator())
    out = pn.predict(tok[:5])
    assert out.shape == (5, SEQ, 4)
    np.testing.assert_allclose(out, np.asarray(jn.predict(tok[:5])),
                               rtol=0, atol=ATOL)


def test_a_dropout_on_fit_resumed_from_epoch_one_is_exact(tmp_path):
    tok = _tokens(seed=4)
    y = (tok == 7).any(axis=1).astype(np.float32)
    init = BERTClassifier(2, bert_config=CFG).build(
        SEQ, torch.Generator().manual_seed(5), device="cpu")
    weights = init.model.state_dict()

    def fresh():
        clf = BERTClassifier(2, bert_config=CFG).build(SEQ, device="cpu")
        clf.model.load_state_dict(weights)
        return clf

    whole = fresh()
    hist = whole.fit(tok, y, batch_size=BATCH, epochs=2, device="cpu")
    first = fresh()
    first.fit(tok, y, batch_size=BATCH, epochs=1, device="cpu")
    first.model.get_estimator().save_checkpoint(str(tmp_path / "e1"))
    resumed = fresh()
    est = resumed.model.get_estimator("cpu")
    est.load_checkpoint(str(tmp_path / "e1"))
    rest = resumed.fit(tok, y, batch_size=BATCH, epochs=2)
    assert rest["iterations"] == hist["iterations"] == 2 * N // BATCH
    assert rest["loss_history"] == hist["loss_history"][N // BATCH:]
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    # dropout really ran: the same run without it takes other steps
    off = BERTClassifier(2, bert_config=NO_DROP, dropout=0.0).build(
        SEQ, device="cpu")
    off.model.load_state_dict(weights)
    assert off.fit(tok, y, batch_size=BATCH, epochs=1, device="cpu")[
        "loss_history"] != hist["loss_history"][:N // BATCH]


def test_a_checkpoint_from_another_device_type_restarts_dropout(tmp_path):
    """A card's generator state (16 bytes) does not fit a CPU generator: a
    checkpoint saved on the card resumes on the CPU with the generator
    started from the Estimator's seed, everything else restored."""
    from analytics_zoo_tpu_torch.estimator.estimator import (
        CHECKPOINT_FILE, _write_manifest)
    tok = _tokens(seed=4)
    y = (tok == 7).any(axis=1).astype(np.float32)
    clf = BERTClassifier(2, bert_config=CFG).build(SEQ, device="cpu")
    clf.fit(tok, y, batch_size=BATCH, epochs=1, device="cpu")
    est = clf.model.get_estimator()
    path = tmp_path / "e1"
    est.save_checkpoint(str(path))
    tree = torch.load(path / CHECKPOINT_FILE, weights_only=True)
    assert tree["meta"]["dropout_device"] == "cpu"
    tree["meta"].update(dropout_rng=torch.zeros(16, dtype=torch.uint8),
                        dropout_device="cuda")
    torch.save(tree, path / CHECKPOINT_FILE)
    _write_manifest(str(path))  # the edited file is the snapshot's now

    resumed = BERTClassifier(2, bert_config=CFG).build(SEQ, device="cpu")
    rest = resumed.model.get_estimator("cpu")
    rest.load_checkpoint(str(path))
    assert rest.global_step == est.global_step and rest.epoch == est.epoch
    for k, v in clf.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert torch.equal(rest.dropout_generator.get_state(),
                       torch.Generator().manual_seed(rest.seed).get_state())
    assert resumed.fit(tok, y, batch_size=BATCH, epochs=2)["iterations"] \
        == 2 * N // BATCH


def test_dropout_draws_from_the_models_generator_only_in_training():
    clf = BERTClassifier(2, bert_config=CFG).build(SEQ, device="cpu")
    model = clf.model
    x = [torch.from_numpy(a) for a in bert_input_pack(_tokens(n=4))]
    model.eval()
    with torch.no_grad():
        ref = model(x)
        assert torch.equal(model(x), ref)  # eval: no dropout, no generator
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(x)
    outs = []
    for _ in range(2):
        model.set_dropout_generator(torch.Generator().manual_seed(11))
        with torch.no_grad():
            outs.append(model(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], ref)
    # the Estimator seeds the generator from its seed
    est = Estimator(model, "sparse_categorical_crossentropy", "adam",
                    device="cpu", seed=3)
    est._ensure_initialized()
    assert est.dropout_generator.initial_seed() == 3
    assert all(m.dropout_generator is est.dropout_generator
               for m in model.modules() if hasattr(m, "dropout_generator"))


def test_dropout_layer_is_the_identity_outside_training():
    drop = Dropout(0.5)
    x = torch.ones(4, 6)
    drop.eval()
    assert drop(x) is x
    drop.train()
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    inp = Input((6,))
    model = Model(inp, Dense(3)(drop(inp))).build(device="cpu")
    gen = torch.Generator().manual_seed(0)
    model.set_dropout_generator(gen)
    assert drop.dropout_generator is gen
    assert set(torch.unique(drop(x)).tolist()) == {0.0, 2.0}


def test_attention_dropout_goes_through_the_fused_branch():
    """In training, each block's attention draws one seed from the model's
    generator and the fused kernels' plain versions apply its mask."""
    clf = BERTClassifier(2, bert_config=dict(CFG, hidden_p_drop=0.0),
                         dropout=0.0).build(SEQ, device="cpu")
    calls = []
    real = at.fused_short_attention

    def spy(*args, **kwargs):
        calls.append(kwargs["dropout_rate"])
        return real(*args, **kwargs)

    x = [torch.from_numpy(a) for a in bert_input_pack(_tokens(n=2))]
    at.fused_short_attention = spy
    try:
        clf.model.train()
        clf.model.set_dropout_generator(torch.Generator().manual_seed(0))
        clf.model(x)
        clf.model.eval()
        clf.model(x)
    finally:
        at.fused_short_attention = real
    assert calls == [0.1] * CFG["n_block"] + [0.0] * CFG["n_block"]


def test_from_jax_params_carries_the_whole_bert_tree():
    jc = jax_text.BERTClassifier(2, bert_config=CFG)
    params = _jax_params(jc.model, [(None, SEQ)] * 4)
    pc = BERTClassifier(2, bert_config=CFG).build(SEQ, device="cpu")
    flat = from_jax_params(params)
    assert set(flat) == set(pc.model.state_dict())
    assert "bert_1.block_1.attn.o.kernel" in flat
    assert "classifier.kernel" in flat
    for k, v in pc.model.state_dict().items():
        assert flat[k].shape == v.shape, k
