"""The torch port's generative slice against the JAX package on the CPU:
``TransformerLM``'s slot and paged decode steps, its suffix prefill and
its beam and sampled ``generate``, and ``GenerativeServing`` against the
JAX package's ``GenerativeServing`` on a ``dir://`` spool, then the
server's SLO rules.

Both LMs carry the same weights (``from_jax_params``), drawn from a seed
(vocab 128, hidden 64, 2 blocks of 4 heads, max_len 64). Logits are held
at 1e-5 and cache contents at 1e-6; token streams exactly. The SLO cases
step the server by hand (``serve_step``) and move its clock by patching
``wall_clock`` in the server's module, so none of them races the wall
clock.
"""
import uuid

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.capture import TransformerLM as JaxLM
from analytics_zoo_tpu.serving import GenerativeServing as JaxServing
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu_torch.capture import TransformerLM, prefill_bucket
from analytics_zoo_tpu_torch.common.config import global_config
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.serving import (GenerativeServing, InputQueue,
                                             OutputQueue, ServingConfig)
from analytics_zoo_tpu_torch.serving import server as port_server
from torch_port_threads import torch_threads_per_worker  # noqa: F401

CFG = dict(vocab_size=128, hidden=64, n_block=2, n_head=4, max_len=64)
_PAIRS = {}


def _pair(seed=0):
    """The JAX LM and the port's, with the same weights (one pair a seed
    for the whole file: nothing here changes the weights)."""
    if seed not in _PAIRS:
        jlm = JaxLM(seed=seed, **CFG)
        params = jlm._init_params(jax.random.PRNGKey(seed), None)
        jlm._graph.estimator.set_params(params)
        plm = TransformerLM(seed=seed, **CFG)
        plm.load_state_dict(from_jax_params(
            jax.tree_util.tree_map(np.asarray, params)), strict=True)
        plm._device("cpu")
        _PAIRS[seed] = (jlm, plm)
    return _PAIRS[seed]


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, CFG["vocab_size"], (n,)).tolist() for n in lengths]


def _src(tmp_path):
    return f"dir://{tmp_path}/{uuid.uuid4().hex[:8]}"


def _drive(srv, steps=300):
    """Step by hand until the server is idle three steps running."""
    idle = 0
    for _ in range(steps):
        idle = idle + 1 if srv.serve_step() == 0 else 0
        if idle >= 3:
            return


def _serve(cls, cfg_cls, lm, tmp_path, prompts, prefix=None, seeds=None,
           **kw):
    """Serve ``prompts`` through ``cls`` on a fresh spool; the streams'
    terminal results, in order, and the server."""
    src = _src(tmp_path)
    cfg = cfg_cls(data_src=src, **kw)
    srv = (cls(cfg, lm, device="cpu") if cls is GenerativeServing
           else cls(cfg, lm))
    if prefix is not None:
        srv.register_prefix(prefix)
    inq, outq = InputQueue(src), OutputQueue(src)
    for i, p in enumerate(prompts):
        inq.enqueue_prompt(f"r{i}", p,
                           seed=None if seeds is None else seeds[i])
    _drive(srv)
    return [outq.query(f"r{i}") for i in range(len(prompts))], srv


def _tokens(results):
    assert all(r is not None and r.get("done") is True for r in results), \
        results
    return [r["value"] for r in results]


# -- the LM's decode steps --------------------------------------------------------


def _np(t):
    return t.detach().numpy()


def test_slot_step_matches_jax():
    jlm, plm = _pair()
    rs = np.random.RandomState(1)
    jc, pc = jlm.init_slot_caches(3), plm.init_slot_caches(3)
    lengths = np.array([0, 4, 9], np.int32)
    with torch.inference_mode():
        for _ in range(3):
            tokens = rs.randint(0, 128, (3,)).astype(np.int32)
            jl, jc = jlm.slot_step(jlm.params, tokens, lengths, jc)
            pl, pc = plm.slot_step(torch.as_tensor(tokens),
                                   torch.as_tensor(lengths), pc)
            np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=0,
                                       atol=1e-5)
            for jb, pb in zip(jc, pc):
                for key in ("k", "v"):
                    np.testing.assert_allclose(_np(pb[key]),
                                               np.asarray(jb[key]), rtol=0,
                                               atol=1e-6)
            lengths = lengths + 1


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_slot_step_matches_jax(int8):
    jlm, plm = _pair()
    rs = np.random.RandomState(2)
    jc = jlm.init_paged_caches(10, 8, int8=int8)
    pc = plm.init_paged_caches(10, 8, int8=int8)
    table = np.zeros((2, 8), np.int32)
    table[0, :2], table[1, :3] = [4, 2], [1, 7, 3]
    lengths = np.array([5, 17], np.int32)
    with torch.inference_mode():
        for _ in range(3):
            tokens = rs.randint(0, 128, (2,)).astype(np.int32)
            jl, jc = jlm.paged_slot_step(jlm.params, tokens, lengths, table,
                                         jc)
            pl, pc = plm.paged_slot_step(
                torch.as_tensor(tokens), torch.as_tensor(lengths),
                torch.as_tensor(table), pc)
            np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=0,
                                       atol=1e-5)
            for jb, pb in zip(jc, pc):
                if int8:  # the codes may differ at a rounding tie only
                    for key in ("k", "v"):
                        diff = np.abs(_np(pb[key]).astype(np.int32)
                                      - np.asarray(jb[key]).astype(np.int32))
                        assert diff.max() <= 1
                    np.testing.assert_allclose(_np(pb["amax_k"]),
                                               np.asarray(jb["amax_k"]),
                                               rtol=1e-6)
                else:
                    np.testing.assert_allclose(_np(pb["k"])[1:],
                                               np.asarray(jb["k"])[1:],
                                               rtol=0, atol=1e-6)
            lengths = lengths + 1


def test_prefill_kv_suffix_matches_jax():
    jlm, plm = _pair()
    rs = np.random.RandomState(3)
    prefix = rs.randint(0, 128, (1, 16)).astype(np.int32)
    suffix = rs.randint(0, 128, (1, 16)).astype(np.int32)
    jpref = jlm.prefill_kv(jlm.params, prefix)
    with torch.inference_mode():
        ppref = plm.prefill_kv(torch.as_tensor(prefix).long())
        for (jk, _), (pk, _) in zip(jpref, ppref):
            np.testing.assert_allclose(_np(pk), np.asarray(jk), rtol=0,
                                       atol=1e-5)
        want = jlm.prefill_kv_suffix(jlm.params, suffix, jpref, 16)
        got = plm.prefill_kv_suffix(torch.as_tensor(suffix).long(), ppref,
                                    16)
    for (jk, jv), (pk, pv) in zip(want, got):
        np.testing.assert_allclose(_np(pk), np.asarray(jk), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("beam,eos", [(2, None), (4, 7)])
def test_generate_with_beams_matches_jax(beam, eos):
    jlm, plm = _pair()
    prompt = np.asarray(_prompts(4, [9, 9]))
    want = jlm.generate(prompt, 10, eos_id=eos, beam_size=beam)
    got = plm.generate(prompt, 10, eos_id=eos, beam_size=beam)
    np.testing.assert_array_equal(got, want)


def test_sampled_generate_follows_its_seed():
    _, plm = _pair()
    prompt = np.asarray(_prompts(5, [6]))
    kw = dict(temperature=0.8, top_k=20, top_p=0.9)
    a = plm.generate(prompt, 12, seed=3, **kw)
    assert np.array_equal(a, plm.generate(prompt, 12, seed=3, **kw))
    assert not np.array_equal(a, plm.generate(prompt, 12, seed=4, **kw))
    with pytest.raises(ValueError, match="not both"):
        plm.generate(prompt, 4, beam_size=2, temperature=0.8)


# -- GenerativeServing against the JAX package's --------------------------------


def test_greedy_streams_with_midstream_joins_match_jax(tmp_path):
    """Seven requests through three slots: later ones join slots as
    earlier streams finish, at buckets 16, 32 and 64."""
    jlm, plm = _pair()
    prompts = _prompts(6, [4, 1, 20, 3, 33, 9, 2])
    kw = dict(slots=3, max_new_tokens=8)
    want = _tokens(_serve(JaxServing, JaxConfig, jlm, tmp_path, prompts,
                          **kw)[0])
    got, srv = _serve(GenerativeServing, ServingConfig, plm, tmp_path,
                      prompts, **kw)
    assert _tokens(got) == want
    assert want == [plm.generate(np.asarray([p]), 8)[0].tolist()
                    for p in prompts]
    snap = srv.health_snapshot()
    assert snap["slots_occupied"] == 0 and snap["in_flight"] == 0
    assert snap["tokens_total"] == 7 * 8 and snap["ttft_ms"]["window"] == 7


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_streams_match_jax_and_the_contiguous_engine(tmp_path, int8):
    jlm, plm = _pair()
    prompts = _prompts(7, [5, 1, 12, 30, 7])
    kw = dict(slots=2, max_new_tokens=8, kv_pages=24, kv_page_len=8,
              kv_int8=int8)
    want = _tokens(_serve(JaxServing, JaxConfig, jlm, tmp_path, prompts,
                          **kw)[0])
    got, srv = _serve(GenerativeServing, ServingConfig, plm, tmp_path,
                      prompts, **kw)
    assert _tokens(got) == want
    if not int8:
        contiguous = _serve(GenerativeServing, ServingConfig, plm, tmp_path,
                            prompts, slots=2, max_new_tokens=8)[0]
        assert _tokens(contiguous) == want
    assert srv.health_snapshot()["kv_pages_free"] == 23


@pytest.mark.parametrize("plen", [16, 13], ids=["whole_pages", "cow_tail"])
def test_shared_prefix_streams_match_jax_and_the_unshared_run(tmp_path,
                                                              plen):
    jlm, plm = _pair()
    prefix = _prompts(8, [plen])[0]
    prompts = [prefix + tail for tail in _prompts(9, [1, 4, 9])]
    kw = dict(slots=2, max_new_tokens=6, kv_pages=24, kv_page_len=8)
    want = _tokens(_serve(JaxServing, JaxConfig, jlm, tmp_path, prompts,
                          prefix=prefix, **kw)[0])
    calls = []
    orig = plm.prefill_kv_suffix
    plm.prefill_kv_suffix = lambda *a: (calls.append(1), orig(*a))[1]
    try:
        got, srv = _serve(GenerativeServing, ServingConfig, plm, tmp_path,
                          prompts, prefix=prefix, **kw)
    finally:
        del plm.prefill_kv_suffix
    assert _tokens(got) == want
    assert len(calls) == 2  # the 4- and 9-token tails; the 1-token joins
    unshared = _serve(GenerativeServing, ServingConfig, plm, tmp_path,
                      prompts, **kw)[0]
    assert _tokens(unshared) == want
    # the registry keeps the prefix's pages after every stream retired
    assert srv.health_snapshot()["kv_pages_free"] == 23 - (-(-plen // 8))


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_sampled_streams_equal_serial_generate_with_their_seeds(tmp_path,
                                                                paged):
    _, plm = _pair()
    prompts = _prompts(10, [5, 2, 1, 17])
    seeds = [11, 22, 33, 44]
    kw = dict(temperature=0.8, top_k=50, top_p=0.9)
    want = [plm.generate(np.asarray([p]), 8, seed=s, **kw)[0].tolist()
            for p, s in zip(prompts, seeds)]
    extra = dict(kv_pages=24, kv_page_len=8) if paged else {}
    got = _serve(GenerativeServing, ServingConfig, plm, tmp_path, prompts,
                 seeds=seeds, slots=2, max_new_tokens=8, **kw, **extra)[0]
    assert _tokens(got) == want


def test_eos_ends_a_stream_as_serial_generate_pads_it(tmp_path):
    jlm, plm = _pair()
    prompts = _prompts(11, [4, 3, 6])
    serial = [plm.generate(np.asarray([p]), 10)[0].tolist() for p in prompts]
    eos = serial[0][3]  # a token the first stream emits
    kw = dict(slots=2, max_new_tokens=10, eos_id=eos)
    want = _tokens(_serve(JaxServing, JaxConfig, jlm, tmp_path, prompts,
                          **kw)[0])
    got = _tokens(_serve(GenerativeServing, ServingConfig, plm, tmp_path,
                         prompts, **kw)[0])
    assert got == want and got[0] == serial[0][:serial[0].index(eos) + 1]


def test_a_short_page_pool_sheds_the_join_and_recovers(tmp_path,
                                                      monkeypatch):
    _, plm = _pair()
    src = _src(tmp_path)
    # a full pool is pressure 1.0 at every shed pass, and the brownout
    # ladder would cap "again"'s budget by how many passes the wall clock
    # allowed: hold the ladder out of reach (tests/test_torch_port_platform
    # .py holds it to JAX's)
    monkeypatch.setitem(global_config()._overrides, "serving.brownout_high",
                        float("inf"))
    srv = GenerativeServing(ServingConfig(
        data_src=src, slots=2, max_new_tokens=10, kv_pages=5,
        kv_page_len=8), plm, device="cpu")
    inq, outq = InputQueue(src), OutputQueue(src)
    # the pool's 4 pages: "big" prefills a bucket of 32 (4 pages), "next"
    # would write 20 positions (3 pages)
    inq.enqueue_prompt("big", list(range(20)))
    inq.enqueue_prompt("next", list(range(10)))
    srv.serve_step()
    res = outq.query("next")
    assert res["error"] == port_server.PAGE_SHED_ERROR and res["retriable"]
    assert srv.counters["shed"] == 1
    _drive(srv)
    assert outq.query("big")["done"] is True
    inq.enqueue_prompt("again", list(range(10)))
    _drive(srv)
    assert outq.query("again")["value"] == plm.generate(
        np.asarray([list(range(10))]), 10)[0].tolist()
    assert srv.health_snapshot()["kv_pages_free"] == 4


# -- the SLO rules ------------------------------------------------------------------


def _server(tmp_path, **kw):
    _, plm = _pair()
    src = _src(tmp_path)
    kw.setdefault("slots", 2)
    srv = GenerativeServing(ServingConfig(data_src=src, **kw), plm,
                            device="cpu")
    return srv, InputQueue(src), OutputQueue(src), plm


def _later(monkeypatch, seconds):
    """Move the server's clock ``seconds`` ahead of the wall clock."""
    now = port_server.wall_clock()
    monkeypatch.setattr(port_server, "wall_clock", lambda: now + seconds)


def test_a_deadline_mid_stream_gives_one_terminal(tmp_path, monkeypatch):
    srv, inq, outq, _ = _server(tmp_path, max_new_tokens=40)
    inq.enqueue_prompt("doomed", [3, 5, 2], deadline_ms=60_000)
    for _ in range(3):
        srv.serve_step()
    partial = outq.query("doomed")
    assert partial["done"] is False and len(partial["stream"]) == 3
    _later(monkeypatch, 61)
    srv.serve_step()
    res = outq.query("doomed")
    assert res["error"] == port_server.DEADLINE_ERROR
    assert res["retriable"] is False
    assert srv.counters["expired"] == 1
    _drive(srv)  # no later step brings the stream back
    assert outq.query("doomed") == res
    snap = srv.health_snapshot()
    assert snap["in_flight"] == 0 and snap["slots_occupied"] == 0


def test_a_request_expired_at_claim_takes_no_slot(tmp_path, monkeypatch):
    srv, inq, outq, _ = _server(tmp_path, max_new_tokens=4)
    inq.enqueue_prompt("stale", [2, 4], deadline_ms=1000)
    _later(monkeypatch, 2)
    assert srv.serve_step() == 0
    assert outq.query("stale")["error"] == port_server.DEADLINE_ERROR
    assert srv.health_snapshot()["slots_occupied"] == 0


def test_an_over_budget_request_errors_at_once(tmp_path):
    srv, inq, outq, _ = _server(tmp_path, max_new_tokens=4)
    inq.enqueue_prompt("huge", [1] * 40, max_new_tokens=30)
    inq.enqueue_prompt("empty", [])
    srv.serve_step()
    assert "out of range" in outq.query("huge")["error"]
    assert outq.query("empty")["error"] == "empty prompt"
    assert srv.counters["errors"] == 2


def test_drain_finishes_the_streams_in_flight_and_admits_no_more(tmp_path):
    srv, inq, outq, _ = _server(tmp_path, max_new_tokens=6)
    for i in range(3):
        inq.enqueue_prompt(f"d{i}", [2, 3, 4])
    while outq.query("d0") is None or not outq.query("d0").get("done"):
        srv.serve_step()
    srv.serve_step()  # d2 takes the slot d0 left
    srv.drain()
    inq.enqueue_prompt("late", [5, 6])
    _drive(srv)
    for i in range(3):
        res = outq.query(f"d{i}")
        assert res["done"] is True and len(res["value"]) == 6
    assert outq.query("late") is None
    assert srv.health_snapshot()["state"] == "drained"


def test_the_client_stream_yields_each_token_once(tmp_path):
    srv, inq, outq, plm = _server(tmp_path, slots=1, max_new_tokens=6)
    want = plm.generate(np.asarray([[4, 2, 7]]), 6)[0].tolist()
    inq.enqueue_prompt("s0", [4, 2, 7])
    srv.start()
    try:
        got = list(outq.stream("s0", timeout_s=60))
    finally:
        srv.drain(timeout_s=60)
    assert got == want


def test_a_failed_step_errors_its_streams_and_serving_goes_on(
        tmp_path, monkeypatch):
    srv, inq, outq, plm = _server(tmp_path, max_new_tokens=4)
    inq.enqueue_prompt("hit", [2, 3])
    orig = srv._dispatch_step

    def fail_once(*a):
        monkeypatch.setattr(srv, "_dispatch_step", orig)
        raise RuntimeError("step failed")
    monkeypatch.setattr(srv, "_dispatch_step", fail_once)
    srv.serve_step()
    assert "step failed" in outq.query("hit")["error"]
    with pytest.raises(RuntimeError, match="step failed"):
        list(outq.stream("hit", timeout_s=5))
    assert srv.counters["errors"] == 1
    inq.enqueue_prompt("after", [2, 3])
    _drive(srv)
    assert outq.query("after")["value"] == plm.generate(
        np.asarray([[2, 3]]), 4)[0].tolist()


def test_stop_answers_active_streams_with_shutdown_errors(tmp_path):
    srv, inq, outq, _ = _server(tmp_path, slots=1, max_new_tokens=20)
    inq.enqueue_prompt("cut", [2, 5])
    srv.serve_step()
    srv.stop()
    assert "shut down" in outq.query("cut")["error"]
    assert srv.health_snapshot()["state"] == "stopped"


@pytest.mark.parametrize("kw,exc,match", [
    (dict(kv_shard=2, kv_pages=16), NotImplementedError, "item 7"),
    (dict(spec_k=4), ValueError, "kv_pages"),
    (dict(spec_k=4, kv_pages=16, temperature=0.8), ValueError,
     "greedy-only"),
    (dict(spec_k=4, kv_pages=16, short_draft=True), ValueError,
     "draft max_len"),
    (dict(spec_k=4, kv_pages=16, prefix=True), RuntimeError, "speculative"),
    (dict(generate_speculative=True), ValueError, "spec_k")])
def test_deferred_options_raise_naming_their_item(tmp_path, kw, exc, match):
    """What the port does not serve raises, naming why: a pool sharded over
    devices (ROADMAP Queue A item 7), and speculative decoding outside the
    JAX package's bounds (paged engine, greedy, a draft long enough, no
    shared prefixes, ``spec_k`` >= 1)."""
    _, plm = _pair()
    kw = dict(kw)
    cfg = ServingConfig(data_src=_src(tmp_path))
    with pytest.raises(exc, match=match):
        if kw.pop("generate_speculative", False):
            plm.generate_speculative(np.asarray([[1, 2]]), plm, 4, spec_k=0,
                                     device="cpu")
        short, prefix = kw.pop("short_draft", False), kw.pop("prefix", False)
        for key, value in kw.items():
            setattr(cfg, key, value)
        draft = TransformerLM(**dict(CFG, max_len=CFG["max_len"] + (
            0 if short else 4)))
        srv = GenerativeServing(cfg, plm, draft_lm=draft, device="cpu")
        if prefix:
            srv.register_prefix([1, 2, 3])


def test_yaml_parses_the_generative_fields(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(
        "data:\n  src: dir:///x\nparams:\n  slots: 32\n  max_new_tokens: 16\n"
        "  temperature: 0.8\n  top_k: 50\n  top_p: 0.9\n  eos_id: 2\n"
        "  kv_pages: 64\n  kv_page_len: 8\n  kv_int8: true\n  spec_k: 0\n"
        "  kv_shard: 1\n  stream_interval: 4\n")
    cfg = ServingConfig.from_yaml(str(path))
    assert (cfg.slots, cfg.max_new_tokens, cfg.temperature, cfg.top_k,
            cfg.top_p, cfg.eos_id, cfg.kv_pages, cfg.kv_page_len,
            cfg.kv_int8, cfg.spec_k, cfg.kv_shard, cfg.stream_interval) == (
        32, 16, 0.8, 50, 0.9, 2, 64, 8, True, 0, 1, 4)
    assert prefill_bucket(100, 2048) == 128
