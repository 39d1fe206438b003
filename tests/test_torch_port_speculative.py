"""The torch port's speculative decoding against the JAX package on the CPU:
the accept rules, ``paged_verify_attention``, ``TransformerLM.verify_step``
and ``generate_speculative``, and ``GenerativeServing(spec_k)``.

The LMs carry the same weights on both sides (``from_jax_params``), drawn
from a seed (vocab 128, hidden 64, 2 blocks of 4 heads, max_len 64; the
draft one block, max_len 72); the serving cases use the JAX package's own
tiny trained LMs (``tests/test_paged_serving.py``: vocab 16, hidden 16, 2
blocks of 2 heads). Accept rules and token streams are held exactly, the
greedy ones also to the port's own serial ``generate``; attention contexts
within 1e-6, pool contents bit for bit; logits within 1e-5 of their
scale. The sampled accept takes JAX's own uniforms and Gumbel draws, so it
is held exactly too.
"""
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.capture import TransformerLM as JaxLM
from analytics_zoo_tpu.ops import decode as jd
from analytics_zoo_tpu.serving import GenerativeServing as JaxServing
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu_torch.capture import TransformerLM
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.ops import decode as pd
from analytics_zoo_tpu_torch.serving import (GenerativeServing, InputQueue,
                                             OutputQueue, ServingConfig)
from torch_port_threads import torch_threads_per_worker  # noqa: F401

CFG = dict(vocab_size=128, hidden=64, n_block=2, n_head=4, max_len=64)
DRAFT = dict(CFG, n_block=1, max_len=72)
_PAIRS = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_of(jlm, cfg):
    plm = TransformerLM(**cfg)
    plm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jlm.params)), strict=True)
    plm._device("cpu")
    return plm


def _pair(seed, cfg):
    """A JAX LM with seeded random weights and the port's copy of it."""
    key = (seed, tuple(sorted(cfg.items())))
    if key not in _PAIRS:
        jlm = JaxLM(seed=seed, **cfg)
        jlm._graph.estimator.set_params(
            jlm._init_params(jax.random.PRNGKey(seed), None))
        _PAIRS[key] = (jlm, _port_of(jlm, cfg))
    return _PAIRS[key]


def _trained(max_len, seed):
    """``tests/test_paged_serving.py``'s tiny LM, trained one epoch in the
    JAX package, and the port's copy."""
    key = ("trained", max_len, seed)
    if key not in _PAIRS:
        cfg = dict(vocab_size=16, hidden=16, n_block=2, n_head=2,
                   max_len=max_len)
        jlm = JaxLM(seed=seed, **cfg)
        jlm.fit(np.random.RandomState(seed).randint(0, 16, (32, 12)),
                batch_size=8, epochs=1)
        _PAIRS[key] = (jlm, _port_of(jlm, cfg))
    return _PAIRS[key]


def _prompts(seed, b, s):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], (b, s))


def jax_draws(seed, b, k, vocab, rounds):
    """JAX's ``speculative_generate`` draws of ``PRNGKey(seed)``, in
    ``spec_draws``'s contract: round r's key splits into k+1 subkeys, the
    drafts' categoricals take the Gumbel noise of the first k, the last
    splits into the accept's uniforms and the residual's Gumbel noise."""
    keys = jax.random.split(jax.random.PRNGKey(seed), rounds)

    def draw(r):
        sub = jax.random.split(keys[r], k + 1)
        g = np.stack([np.asarray(jax.random.gumbel(sub[i], (b, vocab)))
                      for i in range(k)])
        ku, kx = jax.random.split(sub[k])
        return (_t(g), _t(np.asarray(jax.random.uniform(ku, (b, k)))),
                _t(np.asarray(jax.random.gumbel(kx, (b, vocab)))))
    return draw


# -- the accept rules ----------------------------------------------------------


def _greedy_case(name, rs):
    s, k, v = 5, 4, 11
    logits = rs.standard_normal((s, k + 1, v)).astype(np.float32)
    g = logits.argmax(-1)
    if name == "all":
        drafts = g[:, :-1]
    elif name == "none":
        drafts = (g[:, :-1] + 1) % v
    elif name == "prefix":  # row i agrees on its first i drafts
        drafts = (g[:, :-1] + 1) % v
        for i in range(s):
            drafts[i, :min(i, k)] = g[i, :min(i, k)]
    else:
        drafts = np.where(rs.rand(s, k) < 0.7, g[:, :-1],
                          rs.randint(0, v, (s, k)))
    return drafts.astype(np.int64), logits


@pytest.mark.parametrize("name", ["all", "none", "prefix", "random"])
def test_spec_accept_greedy_matches_jax(name):
    drafts, logits = _greedy_case(name, np.random.RandomState(1))
    jg, jn = jd.spec_accept_greedy(jnp.asarray(drafts, jnp.int32),
                                   jnp.asarray(logits))
    pg, pn = pd.spec_accept_greedy(_t(drafts), _t(logits))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    if name == "all":
        assert (pn.numpy() == 5).all()  # k + 1: the bonus token
    if name == "none":
        assert (pn.numpy() == 1).all()
    if name == "prefix":
        np.testing.assert_array_equal(pn.numpy(), [1, 2, 3, 4, 5])


@pytest.mark.parametrize("seed,equal", [(0, False), (1, False), (2, False),
                                        (3, True)],
                         ids=["s0", "s1", "s2", "residual_zero"])
def test_spec_accept_sampled_on_jax_draws_matches_jax(seed, equal):
    """Fed JAX's uniforms and Gumbel draws, the port's accept/resample
    rule gives JAX's tokens and counts exactly. ``residual_zero``: draft
    and target agree (p == q), so a draft is rejected only where top-k
    filtered it out, and there the residual sums to zero and the draw
    falls back to p."""
    rs = np.random.RandomState(10 + seed)
    s, k, v = 6, 3, 9
    tl = (rs.standard_normal((s, k + 1, v)) * 2).astype(np.float32)
    dl = (tl[:, :k] if equal
          else (rs.standard_normal((s, k, v)) * 2).astype(np.float32))
    drafts = rs.randint(0, v, (s, k))
    filt_j = jd.make_logit_filter(0.9, 6, None)
    filt_p = pd.make_logit_filter(0.9, 6, None)
    key = jax.random.PRNGKey(seed)
    je, jn = jd._spec_accept_sampled(
        jnp.asarray(drafts, jnp.int32), jnp.asarray(dl), jnp.asarray(tl),
        key, filt_j)
    key_u, key_x = jax.random.split(key)
    u = np.asarray(jax.random.uniform(key_u, (s, k)))
    g = np.asarray(jax.random.gumbel(key_x, (s, v)))
    pe, pn = pd._spec_accept_sampled(_t(drafts), _t(dl), _t(tl), _t(u),
                                     _t(g), filt_p)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    if equal:  # some row is rejected early: the zero-residual branch
        assert (pn.numpy() <= k).any()


def test_spec_draws_follow_their_seed_in_order():
    a, b = pd.spec_draws(5, 2, 3, 7), pd.spec_draws(5, 2, 3, 7)
    ra, rb = a(0), b(0)
    assert [x.shape for x in ra] == [(3, 2, 7), (2, 3), (2, 7)]
    assert all(torch.equal(x, y) for x, y in zip(ra, rb))
    assert not torch.equal(a(1)[0], ra[0])
    assert all(bool(torch.isfinite(x).all()) for x in ra)
    with pytest.raises(ValueError, match="in order"):
        b(2)


# -- the verify pass --------------------------------------------------------------

S, H, D, P, PL, W = 3, 2, 8, 14, 4, 6  # slots, heads, head_dim, pages,
#   page_len, table width (W·PL = 24 columns)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_verify_attention_matches_jax(int8):
    """Three rounds of T = 4 rows a slot: slot 0 crosses page boundaries,
    slot 1 runs past its two pages onto the null page, slot 2 is free (its
    writes fall on the null page). Pages 1.. are held bit for bit."""
    rs = np.random.RandomState(4)
    jc = jd.init_paged_pool(P, H, PL, D, int8=int8)
    pc = pd.init_paged_pool(P, H, PL, D, int8=int8)
    table = np.zeros((S, W), np.int32)
    table[0, :5] = [5, 2, 9, 11, 3]
    table[1, :2] = [7, 1]
    lengths = np.array([3, 5, 0], np.int32)
    for rnd in range(3):
        q, k, v = (rs.standard_normal((S, H, 4, D)).astype(np.float32)
                   for _ in range(3))
        jctx, jc = jd.paged_verify_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
            jnp.asarray(table), jnp.asarray(lengths))
        pctx, out = pd.paged_verify_attention(_t(q), _t(k), _t(v), pc,
                                              _t(table), _t(lengths))
        assert out is pc
        # slot 1's rows past its pages read the null page, as JAX's do:
        # compare the rows whose positions lie within the slot's pages
        within = [np.arange(4) + lengths[0] < 5 * PL,
                  np.arange(4) + lengths[1] < 2 * PL]
        for slot in range(2):
            scale = max(1.0, float(np.abs(np.asarray(jctx)[slot]).max()))
            np.testing.assert_allclose(
                pctx.numpy()[slot][:, within[slot]] / scale,
                np.asarray(jctx)[slot][:, within[slot]] / scale,
                rtol=0, atol=1e-6, err_msg=f"slot {slot} round {rnd}")
        for key in pc:
            want, got = np.asarray(jc[key]), pc[key].numpy()
            if key in ("k", "v", "scale_k", "scale_v"):
                want, got = want[1:], got[1:]
            np.testing.assert_array_equal(got, want, err_msg=key)
        lengths = lengths + np.array([2, 1, 0], np.int32)


def _verify_setup(plm, jlm, b=2, s=11, page_len=8):
    """Both LMs' paged caches after the same bucketed prefill of
    ``prompt[:, :-1]``, with private pages a row."""
    prompt = _prompts(3, b, s)
    width = -(-(CFG["max_len"] + 4) // page_len)
    table = np.zeros((b, width), np.int32)
    for r in range(b):
        table[r, :width - 1] = 1 + r * (width - 1) + np.arange(width - 1)
    jc = jlm.init_paged_caches(b * width + 1, page_len)
    pc = plm.init_paged_caches(b * width + 1, page_len)
    padded = np.zeros((b, 16), np.int64)
    padded[:, :s - 1] = prompt[:, :-1]
    jkv = jlm.prefill_kv(jlm.params, jnp.asarray(padded, jnp.int32))
    with torch.inference_mode():
        pkv = plm.prefill_kv(_t(padded))
        for r in range(b):
            jc = [jd.paged_insert(c, jnp.asarray(table[r]), k[r], v[r])
                  for c, (k, v) in zip(jc, jkv)]
            for c, (k, v) in zip(pc, pkv):
                pd.paged_insert(c, _t(table[r]), k[r], v[r])
    return prompt, table, jc, pc


def test_verify_step_matches_jax():
    """Two rounds through both LMs' pools: the full ``[S, T, V]`` logits
    within 1e-5 of their scale, and the pools' K/V within 1e-6."""
    jlm, plm = _pair(0, CFG)
    prompt, table, jc, pc = _verify_setup(plm, jlm)
    lengths = np.full(2, prompt.shape[1] - 1, np.int32)
    rs = np.random.RandomState(6)
    with torch.inference_mode():
        for _ in range(2):
            block = np.concatenate([prompt[:, -1:], rs.randint(
                0, 128, (2, 4))], axis=1)
            jl, jc = jlm.verify_step(jlm.params, jnp.asarray(block,
                                                             jnp.int32),
                                     jnp.asarray(lengths), jnp.asarray(table),
                                     jc)
            pl, pc = plm.verify_step(_t(block), _t(lengths), _t(table), pc)
            jl = np.asarray(jl)
            scale = max(1.0, float(np.abs(jl).max()))
            np.testing.assert_allclose(pl.numpy() / scale, jl / scale,
                                       rtol=0, atol=1e-5)
            for jb, pb in zip(jc, pc):
                np.testing.assert_allclose(pb["k"].numpy()[1:],
                                           np.asarray(jb["k"])[1:], rtol=0,
                                           atol=1e-6)
            lengths = lengths + np.array([5, 2], np.int32)


def test_verify_logits_match_a_full_forward():
    """Each verify row's logits are those of a causal forward over the
    prompt and the block (the T-batched products round differently from
    serial steps: within 1e-5 of their scale)."""
    _, plm = _pair(0, CFG)
    jlm = _pair(0, CFG)[0]
    prompt, table, _, pc = _verify_setup(plm, jlm)
    block = np.concatenate([prompt[:, -1:], _prompts(8, 2, 4)], axis=1)
    lengths = np.full(2, prompt.shape[1] - 1, np.int32)
    with torch.inference_mode():
        pl, _ = plm.verify_step(_t(block), _t(lengths), _t(table), pc)
        full = plm._forward(_t(np.concatenate([prompt[:, :-1], block], 1)))
    want = full[:, prompt.shape[1] - 1:].numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(pl.numpy() / scale, want / scale, rtol=0,
                               atol=1e-5)


def test_verify_step_clamps_positions_past_the_table():
    """Drafts past ``max_len`` read the position table's last row (JAX's
    clamp), not past it."""
    _, plm = _pair(0, CFG)
    pc = plm.init_paged_caches(20, 8)
    table = torch.arange(1, 10, dtype=torch.int32)[None]
    block = torch.tensor([[1, 2, 3, 4, 5]])
    with torch.inference_mode():
        logits, _ = plm.verify_step(block, torch.tensor([62], dtype=torch.int32),
                                    table, pc)
    assert logits.shape == (1, 5, 128) and bool(torch.isfinite(logits).all())


# -- generate_speculative -------------------------------------------------------


@pytest.mark.parametrize("draft,eos,budget", [
    ("real", False, 20), ("self", False, 20), ("real", True, 20),
    ("real", False, 7)], ids=["real_draft", "self_draft", "eos", "budget"])
def test_generate_speculative_greedy_matches_jax_and_generate(draft, eos,
                                                              budget):
    jlm, plm = _pair(0, CFG)
    jdr, pdr = (_pair(1, DRAFT) if draft == "real"
                else _pair(0, dict(CFG, max_len=CFG["max_len"] + 8)))
    prompt = _prompts(2, 3, 9)
    serial = plm.generate(prompt, budget, device="cpu")
    eos_id = int(serial[0, 4]) if eos else None
    if eos:
        serial = plm.generate(prompt, budget, eos_id=eos_id, device="cpu")
    want = jlm.generate_speculative(prompt, jdr, budget, spec_k=4,
                                    eos_id=eos_id, page_len=8)
    stats = {}
    got = plm.generate_speculative(prompt, pdr, budget, spec_k=4,
                                   eos_id=eos_id, page_len=8, device="cpu",
                                   stats=stats)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, serial)
    assert 0 <= stats["accepted"] <= stats["proposed"]
    if draft == "self":  # the target drafting for itself agrees always
        assert stats["accepted"] == stats["proposed"]


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_speculative_sampled_on_jax_draws_matches_jax(seed):
    jlm, plm = _pair(0, CFG)
    jdr, pdr = _pair(1, DRAFT)
    prompt = _prompts(4, 3, 9)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)
    want = jlm.generate_speculative(prompt, jdr, 16, spec_k=3, page_len=8,
                                    seed=seed, **kw)
    got = plm.generate_speculative(prompt, pdr, 16, spec_k=3, page_len=8,
                                   device="cpu",
                                   draws=jax_draws(seed, 3, 3, 128, 16),
                                   **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    again = plm.generate_speculative(prompt, pdr, 16, spec_k=3, page_len=8,
                                     device="cpu", seed=seed, **kw)
    assert np.array_equal(again, plm.generate_speculative(
        prompt, pdr, 16, spec_k=3, page_len=8, device="cpu", seed=seed,
        **kw))


# -- GenerativeServing(spec_k) ----------------------------------------------------


def _src(tmp_path):
    return f"dir://{tmp_path}/{uuid.uuid4().hex[:8]}"


def _drive(srv, steps=200):
    idle = 0
    for _ in range(steps):
        idle = idle + 1 if srv.serve_step() == 0 else 0
        if idle >= 3:
            return


def _serve(cls, cfg_cls, lm, draft, tmp_path, prompts, **kw):
    src = _src(tmp_path)
    cfg = cfg_cls(data_src=src, **dict(dict(slots=2, kv_pages=16,
                                            kv_page_len=8), **kw))
    srv = (cls(cfg, lm, draft_lm=draft, device="cpu")
           if cls is GenerativeServing else cls(cfg, lm, draft_lm=draft))
    inq, outq = InputQueue(src), OutputQueue(src)
    for i, p in enumerate(prompts):
        inq.enqueue_prompt(f"v{i}", p)
    _drive(srv)
    return [outq.query(f"v{i}") for i in range(len(prompts))], srv


@pytest.mark.parametrize("eos", [None, 1])
def test_spec_streams_match_jax_and_serial_greedy(tmp_path, eos):
    """``tests/test_paged_serving.py``'s speculative cases on the port:
    three streams (one joining mid-run) through two slots, a real draft."""
    jlm, plm = _trained(32, 0)
    jdr, pdr = _trained(64, 1)
    rs = np.random.RandomState(7 if eos is None else 8)
    prompts = [rs.randint(0, 16, (n,)).tolist() for n in (4, 1, 6)]
    budget = 8 if eos is None else 10
    kw = dict(spec_k=3, max_new_tokens=budget, eos_id=eos)
    want, _ = _serve(JaxServing, JaxConfig, jlm, jdr, tmp_path, prompts,
                     **kw)
    got, srv = _serve(GenerativeServing, ServingConfig, plm, pdr, tmp_path,
                      prompts, **kw)
    assert [r["value"] for r in got] == [r["value"] for r in want]
    for p, r in zip(prompts, got):
        row = plm.generate(np.asarray([p]), budget, eos_id=eos,
                           device="cpu")[0].tolist()
        assert r["value"] == (row[:row.index(eos) + 1]
                              if eos is not None and eos in row else row)
    snap = srv.health_snapshot()
    assert 0.0 <= snap["spec_accept_ratio"] <= 1.0
    assert snap["in_flight"] == 0 and snap["kv_pages_free"] == 15
    assert srv.spec_totals["accepted"] <= srv.spec_totals["proposed"]


def test_spec_streams_at_the_end_of_max_len(tmp_path):
    """Streams whose budget ends at ``max_len``: the last rounds' drafts
    run past it, on the table's slack columns and the position table's
    clamp, and the tokens still equal serial greedy's."""
    _, plm = _pair(0, CFG)
    _, pdr = _pair(1, DRAFT)
    prompts = _prompts(9, 2, 40).tolist()
    got, _ = _serve(GenerativeServing, ServingConfig, plm, pdr, tmp_path,
                    prompts, spec_k=4, max_new_tokens=24, kv_pages=32)
    for p, r in zip(prompts, got):
        assert r["value"] == plm.generate(np.asarray([p]), 24,
                                          device="cpu")[0].tolist()


def test_spec_stream_handed_off_finishes_as_serial_greedy(tmp_path):
    """A speculative stream handed off mid-decode to a plain paged server
    (and the reverse) ends with serial greedy's tokens and one terminal."""
    _, plm = _pair(0, CFG)
    _, pdr = _pair(1, DRAFT)
    prompts = _prompts(12, 2, 9).tolist()
    want = [plm.generate(np.asarray([p]), 20, device="cpu")[0].tolist()
            for p in prompts]
    for first_spec in (True, False):
        a_src, b_src = _src(tmp_path), _src(tmp_path)
        cfg = dict(slots=2, kv_pages=24, kv_page_len=8, max_new_tokens=20)
        a = GenerativeServing(ServingConfig(
            data_src=a_src, spec_k=4 if first_spec else 0, **cfg), plm,
            draft_lm=pdr, device="cpu")
        b = GenerativeServing(ServingConfig(
            data_src=b_src, spec_k=0 if first_spec else 4, **cfg), plm,
            draft_lm=pdr, device="cpu")
        for i, p in enumerate(prompts):
            InputQueue(a_src).enqueue_prompt(f"h{i}", p)
        a.serve_step()
        a.serve_step()
        assert a.handoff(b.queue) == 2
        assert not any(r.get("done") or "error" in r  # no terminal at a
                       for r in OutputQueue(a_src).dequeue().values())
        _drive(b)
        outq = OutputQueue(b_src)
        assert [outq.query(f"h{i}")["value"] for i in range(2)] == want
        assert a.health_snapshot()["in_flight"] == 0
