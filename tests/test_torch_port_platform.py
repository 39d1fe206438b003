"""The torch port's serving platform substrate against the JAX package on
the CPU: the metrics registry, fault injection, the event log, the phase
profiler and the brownout ladder, then what both servers build on them
(health snapshots and files, the fault sites, ``reload_model``,
``handoff``).

Each test runs the JAX function or server and the port's on the same
seeded inputs. Registry snapshots and Prometheus text, fault firings,
brownout levels, events and counters are held exactly; served values
within 1e-5, token streams exactly. Fault schedules are armed in each
package's own ``faults`` module and reset after every test; neither
package's config is left changed.
"""
import json
import os
import uuid

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.capture import TransformerLM as JaxLM
from analytics_zoo_tpu.common import config as jcfg
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import metrics as jmetrics
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.ops import events as jevents
from analytics_zoo_tpu.serving import ClusterServing as JaxClusterServing
from analytics_zoo_tpu.serving import GenerativeServing as JaxGenerative
from analytics_zoo_tpu.serving import ModelReloadError as JaxReloadError
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu.serving import server as jserver
from analytics_zoo_tpu_torch.capture import TransformerLM
from analytics_zoo_tpu_torch.common import config as pcfg
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.common import metrics as pmetrics
from analytics_zoo_tpu_torch.common import profiler as pprofiler
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.inference.inference_model import \
    InferenceModel as PortInferenceModel
from analytics_zoo_tpu_torch.models import NeuralCF as PortNeuralCF
from analytics_zoo_tpu_torch.ops import events as pevents
from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                             GenerativeServing, InputQueue,
                                             ModelReloadError, OutputQueue,
                                             ServingConfig)
from analytics_zoo_tpu_torch.serving import server as pserver
from torch_port_threads import torch_threads_per_worker  # noqa: F401

NCF = dict(user_count=63, item_count=47, num_classes=2, user_embed=8,
           item_embed=8, hidden_layers=[16, 8], mf_embed=4)
LM = dict(vocab_size=128, hidden=64, n_block=2, n_head=4, max_len=64)


@pytest.fixture(autouse=True)
def _quiet_faults():
    yield
    jfaults.reset()
    pfaults.reset()


def _src(tmp_path):
    return f"dir://{tmp_path}/{uuid.uuid4().hex[:8]}"


# -- the metrics registry ---------------------------------------------------------


def _observe(reg):
    c = reg.counter("serving.shed_total", "Requests shed.", labels=("server",))
    g = reg.gauge("serving.queue_depth", "Pending requests.")
    h = reg.histogram("serving.request_latency_seconds", "Latency.",
                      labels=("server",))
    for i, v in enumerate([3e-5, 0.002, 0.002, 0.4, 7.0, 250.0, 0.0]):
        h.labels(server=f"srv{i % 2}").observe(v)
    c.labels(server="srv0").inc()
    c.labels(server="srv1").inc(2.5)
    g.set(17)
    g.inc(-2)
    return c, g, h


def test_registry_snapshot_and_exposition_equal_jax():
    jr, pr = jmetrics.Registry(enabled=True), pmetrics.Registry(enabled=True)
    try:
        _, _, jh = _observe(jr)
        _, _, ph = _observe(pr)
        assert pr.snapshot() == jr.snapshot()
        assert pr.expose_text() == jr.expose_text()
        for q in (0.0, 0.5, 0.99, 1.0):
            assert (ph.labels(server="srv0").percentile(q)
                    == jh.labels(server="srv0").percentile(q))
        pr.zero()
        jr.zero()
        assert pr.snapshot() == jr.snapshot()
        pr.set_enabled(False)
        ph.labels(server="srv0").observe(1.0)
        assert ph.labels(server="srv0").count() == 0
        with pytest.raises(ValueError, match="labels"):
            ph.labels(host="x")
        with pytest.raises(ValueError, match="already registered"):
            pr.gauge("serving.shed_total")
    finally:
        jr.close()
        pr.close()


def test_servers_register_jax_families_names_help_and_labels():
    """Every family the port's servers, faults and profiler register is
    the JAX package's: the serving and fault families with its help text
    too. Only ``build.info`` labels the torch version in place of JAX's."""
    pf = pmetrics.default_registry()._families
    jf = jmetrics.default_registry()._families
    jax_serving = {fam.name for fam in jserver._M_COUNTERS.values()} | {
        getattr(jserver, a).name for a in dir(jserver)
        if a.startswith("_M_") and a != "_M_COUNTERS"}
    assert {n for n in pf if n.startswith("serving.")} == jax_serving
    for name, fam in pf.items():
        assert name in jf, name
        if name == "build.info":
            continue
        assert (fam.kind, fam.labelnames) == (jf[name].kind,
                                              jf[name].labelnames), name
        if name.startswith(("serving.", "fault.")):
            assert fam.help == jf[name].help, name


# -- fault injection ----------------------------------------------------------------


def _firings(mod, site, calls):
    fired = []
    for i in range(1, calls + 1):
        try:
            if mod.inject(site):
                fired.append(i)
        except mod.FaultInjected as e:
            assert e.site == site and e.call == i
            fired.append(i)
    return fired


@pytest.mark.parametrize("site,kw", [
    ("serving.predict", dict(at=3)),
    ("serving.claim", dict(p=0.3, seed=7, budget=4)),
    ("serving.page_alloc", dict(p=0.5, seed=2, budget=3))],
    ids=["at", "p_raise", "p_flag"])
def test_fault_schedules_fire_at_the_same_calls(site, kw):
    jfaults.arm(site, **kw)
    pfaults.arm(site, **kw)
    want = _firings(jfaults, site, 40)
    assert _firings(pfaults, site, 40) == want and want
    assert pfaults.fire_count(site) == jfaults.fire_count(site)
    assert pfaults.armed(site) and not pfaults.armed("serving.reload")


def test_fault_plan_config_and_registry_equal_jax():
    assert pfaults.describe() == jfaults.describe()
    plan = "serving.decode:2,serving.writeback:0.4@2"
    for cfg in (jcfg.global_config(), pcfg.global_config()):
        cfg.set("faults.plan", plan)
        cfg.set("faults.seed", 5)
    try:
        for site in ("serving.decode", "serving.writeback"):
            assert (_firings(pfaults, site, 30)
                    == _firings(jfaults, site, 30))
        with pytest.raises(ValueError, match="unknown fault site"):
            pfaults.inject("no.such_site")
    finally:
        for cfg in (jcfg.global_config(), pcfg.global_config()):
            cfg.unset("faults.plan")
            cfg.unset("faults.seed")


def test_config_keys_carry_jax_defaults():
    keys = ["faults.plan", "faults.seed", "metrics.enabled",
            "profile.enabled", "profile.capture_dir", "profile.capture_steps",
            "profile.capture_on_breach", "profile.capture_seconds",
            "profile.peak_flops", "ops.enabled", "ops.dir",
            "ops.ring_events", "serving.brownout_high",
            "serving.brownout_low", "serving.brownout_hold_ticks",
            "serving.brownout_token_frac"]
    for key in keys:
        assert (pcfg.global_config().get(key)
                == jcfg.global_config().get(key)), key


# -- the event log and the brownout ladder ------------------------------------------


def _strip(evs):
    return [{k: v for k, v in ev.items() if k not in ("wall", "mono", "pid")}
            for ev in evs]


def test_event_logs_record_the_same_events(tmp_path):
    jl = jevents.EventLog(root=str(tmp_path / "j"), enabled=True)
    pl = pevents.EventLog(root=str(tmp_path / "p"), enabled=True)
    try:
        for log in (jl, pl):
            log.emit("serving.shed", label="srv0", count=3, allowed=8)
            log.emit("serving.brownout_rung", label="srv0", level_from=0,
                     level_to=1, pressure=0.9)
            log.emit("serving.lifecycle", label="srv0", state="drained")
            with pytest.raises(ValueError, match="never registered"):
                log.emit("serving.no_such_event")
            with pytest.raises(ValueError, match="reserved"):
                log.emit("serving.shed", pid=1)
        assert _strip(pl.read()) == _strip(jl.read())
        assert _strip(pl.tail(2)) == _strip(jl.tail(2))
        assert pl.read(types=["serving.lifecycle"])[0]["state"] == "drained"
    finally:
        jl.close()
        pl.close()
    jtypes = jevents.registered_types()
    for name, help_text in pevents.registered_types().items():
        assert jtypes[name] == help_text, name
    assert {"serving.brownout_rung", "serving.shed", "serving.reload",
            "serving.lifecycle"} <= set(pevents.registered_types())


def test_brownout_ladder_equals_jax():
    pressures = [0.1, 0.8, 0.9, 0.5, 0.2, 0.2, 0.2, 0.95, 0.95, 0.95, 0.96,
                 0.3, 0.1, 0.1, 0.6, 0.1, 0.1, 0.1, 0.2, 0.2, 0.2, 0.0]
    jb, pb = jserver._Brownout("x"), pserver._Brownout("x")
    for pressure in pressures:
        got = (pb.tick(pressure), pb.token_cap(64), pb.token_cap(3),
               pb.batch_window_ms(20), pb.stream_stride(8),
               pb.stream_stride(0))
        want = (jb.tick(pressure), jb.token_cap(64), jb.token_cap(3),
                jb.batch_window_ms(20), jb.stream_stride(8),
                jb.stream_stride(0))
        assert got == want, pressure


# -- the phase profiler -----------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_step_profiler_phases_sum_to_the_wall():
    clock = _FakeClock()
    sp = pprofiler.StepProfiler("fake_loop", clock=clock)
    pprofiler.set_enabled(True)
    try:
        sp.step_start()
        with sp.phase("host_input"):
            clock.t += 0.25
        clock.t += 0.5  # unattributed: booked as "other"
        sp.add("dispatch", 0.125)
        clock.t += 0.125
        sp.step_end()
    finally:
        pprofiler.set_enabled(False)
    snap = pmetrics.metrics_snapshot()
    phases = snap["profile.phase_seconds"]["series"]
    sums = {k.split("phase=")[1]: v["sum"] for k, v in phases.items()
            if k.startswith("loop=fake_loop,")}
    assert sums == {"host_input": 0.25, "dispatch": 0.125, "other": 0.5}
    wall = snap["profile.step_wall_seconds"]["series"]["loop=fake_loop"]
    assert wall["sum"] == pytest.approx(sum(sums.values()), abs=1e-9)
    sp.step_start()  # disabled: nothing recorded
    sp.step_end()
    assert pmetrics.metrics_snapshot()["profile.step_wall_seconds"][
        "series"]["loop=fake_loop"]["count"] == 1


def test_arm_capture_writes_a_torch_profiler_trace(tmp_path):
    pprofiler._reset_capture_for_tests()
    pprofiler.set_enabled(True)
    try:
        assert pprofiler.arm_capture(steps=2, out_dir=str(tmp_path))
        assert pprofiler.capture_active()
        for _ in range(2):
            torch.ones(8).sum()
            pprofiler.step_boundary()
        assert not pprofiler.capture_active()
    finally:
        pprofiler.set_enabled(False)
        pprofiler._reset_capture_for_tests()
    path = pprofiler.last_trace()
    assert path.startswith(str(tmp_path)) and os.path.getsize(path) > 0
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    assert pprofiler.device_peak_flops() is None  # no card here
    assert pprofiler.sample_memory()["host_rss_bytes"] > 0


# -- ClusterServing ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ncf():
    """JAX NCFs with their params and port NCFs with the same weights: the
    served model and the one a reload swaps in."""
    out = []
    for seed in (3, 4):
        jm = JaxNeuralCF(**NCF)._ensure_built()
        params, state = jm.build(jax.random.PRNGKey(seed))
        port = PortNeuralCF(**NCF).build(device="cpu")
        port.model.load_state_dict(
            from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
        out.append((jm, params, state, port))
    return out


def _servers(ncf, tmp_path, **kw):
    jm, params, state, port = ncf[0]
    jsrc, psrc = _src(tmp_path), _src(tmp_path)
    common = dict(image_shape=(2,), batch_size=4, batch_wait_ms=5,
                  decode_threads=1, **kw)
    jsrv = JaxClusterServing(
        JaxConfig(data_src=jsrc, **common),
        model=JaxInferenceModel().load_keras(jm, params, state))
    psrv = ClusterServing(
        ServingConfig(data_src=psrc, **common),
        model=PortInferenceModel(device="cpu").load_keras(port.model))
    return (jsrv, jsrc), (psrv, psrc)


def _records(n, seed=0):
    rs = np.random.RandomState(seed)
    return np.stack([rs.randint(0, 64, n), rs.randint(0, 48, n)],
                    1).astype(np.float32)


def _serve_records(srv, src, x, extra=()):
    inq = InputQueue(src)
    for i, row in enumerate(x):
        inq.enqueue_tensor(f"r{i}", row)
    for uri, rec in extra:
        srv.queue.enqueue(uri, rec)
    idle = 0  # a failed claim's backoff can outlast one batch window
    while idle < 3:
        idle = idle + 1 if srv.serve_once() == 0 else 0
    return OutputQueue(src).dequeue()


def _same_results(jres, pres):
    assert sorted(jres) == sorted(pres)
    for uri, want in jres.items():
        got = pres[uri]
        if "value" in want:
            np.testing.assert_allclose(got["value"], want["value"], rtol=0,
                                       atol=1e-5, err_msg=uri)
        else:
            assert got == want, uri


@pytest.mark.parametrize("site,at", [
    ("serving.predict", 2), ("serving.decode", 3), ("serving.writeback", 1),
    ("serving.claim", 1)])
def test_cluster_fault_sites_answer_as_jax(ncf, tmp_path, site, at):
    """An armed site's batch or record gets JAX's error result, every
    other record the direct forward's value, and the counters agree."""
    (jsrv, jsrc), (psrv, psrc) = _servers(ncf, tmp_path)
    x = _records(14, seed=at)
    jfaults.arm(site, at=at)
    pfaults.arm(site, at=at)
    jres = _serve_records(jsrv, jsrc, x)
    pres = _serve_records(psrv, psrc, x)
    _same_results(jres, pres)
    errors = [u for u, r in pres.items() if "error" in r]
    assert (len(errors) > 0) == (site != "serving.claim")
    assert psrv.health_snapshot()["counters"] == \
        jsrv.health_snapshot()["counters"]


def test_cluster_health_snapshot_and_files_match_jax(ncf, tmp_path):
    """Over the same records (one expired, one undecodable) both servers
    give the same snapshot keys and counters; ``health.json`` and
    ``metrics.prom`` parse back to the port's own counters."""
    health = str(tmp_path / "h" / "health.json")
    os.makedirs(os.path.dirname(health))
    (jsrv, jsrc), (psrv, psrc) = _servers(ncf, tmp_path)
    psrv.config.health_path = health
    x = _records(9)
    extra = [("late", {"tensor": [1, 2], "deadline_ms": 1,
                       "enqueue_t": 1.0}),
             ("junk", {"something": 1})]
    _same_results(_serve_records(jsrv, jsrc, x, extra),
                  _serve_records(psrv, psrc, x, extra))
    js, ps = jsrv.health_snapshot(), psrv.health_snapshot()
    assert sorted(ps) == sorted(js)
    for key in ("counters", "records_served", "in_flight", "queue_pending",
                "brownout_level", "model_version", "prewarmed", "state",
                "alerts", "incident"):
        assert ps[key] == js[key], key
    assert ps["latency_ms"]["window"] == js["latency_ms"]["window"] == 11
    psrv.drain()
    with open(health) as f:
        on_disk = json.load(f)
    assert on_disk["state"] == "drained"
    assert on_disk["counters"] == ps["counters"] == {
        "shed": 0, "expired": 1, "errors": 1, "claim_faults": 0,
        "reloads": 0, "reload_failures": 0}
    with open(os.path.join(os.path.dirname(health), "metrics.prom")) as f:
        prom = f.read()
    label = psrv.metrics_label
    assert f'zoo_serving_records_total{{server="{label}"}} 9' in prom
    assert f'zoo_serving_expired_total{{server="{label}"}} 1' in prom
    assert psrv.counters == {"shed": 0, "expired": 1, "errors": 1,
                             "claim_faults": 0}


def test_reload_model_rolls_back_and_stamps_versions_as_jax(ncf, tmp_path):
    (jsrv, jsrc), (psrv, psrc) = _servers(ncf, tmp_path)
    jm2, params2, state2, port2 = ncf[1]
    x = _records(6, seed=5)
    for mod in (jfaults, pfaults):
        mod.arm("serving.reload", at=1)
    with pytest.raises(JaxReloadError):
        jsrv.reload_model(model=JaxInferenceModel().load_keras(
            jm2, params2, state2))
    old = psrv.model
    with pytest.raises(ModelReloadError, match="previous model"):
        psrv.reload_model(model=PortInferenceModel(device="cpu").load_keras(
            port2.model))
    assert psrv.model is old and psrv.model_version == "inline-0"
    before = _serve_records(psrv, psrc, x)
    jsrv.reload_model(model=JaxInferenceModel().load_keras(
        jm2, params2, state2))
    psrv.reload_model(model=PortInferenceModel(device="cpu").load_keras(
        port2.model))
    assert psrv.model_version == jsrv.model_version == "inline-1"
    path = str(tmp_path / "ncf-v2")
    port2.save_model(path)
    psrv.reload_model(path)
    assert psrv.model_version == "ncf-v2"
    psrv.reload_model(model=psrv.model, version="v7")
    assert psrv.model_version == "v7"
    after = _serve_records(psrv, psrc, _records(6, seed=6))
    direct = PortInferenceModel(device="cpu").load_keras(port2.model)
    np.testing.assert_allclose(
        np.array([after[f"r{i}"]["value"] for i in range(6)]),
        np.asarray(direct.predict(_records(6, seed=6))), rtol=0, atol=1e-6)
    assert not np.allclose(before["r0"]["value"], after["r0"]["value"])
    counters = psrv.health_snapshot()["counters"]
    assert (counters["reloads"], counters["reload_failures"]) == (3, 1)
    assert (jsrv.health_snapshot()["counters"]["reload_failures"]
            == counters["reload_failures"])


def test_a_burst_drives_brownout_and_events_as_jax(ncf, tmp_path):
    """A backlog past ``max_pending`` sheds and steps the brownout ladder
    down: both servers log the same events and reach the same rung."""
    logs = {}
    for name, mod in (("j", jevents), ("p", pevents)):
        logs[name] = mod.reset_default(root=str(tmp_path / name),
                                       enabled=True)
    try:
        (jsrv, jsrc), (psrv, psrc) = _servers(ncf, tmp_path, max_pending=4)
        x = _records(20, seed=9)
        for srv, src in ((jsrv, jsrc), (psrv, psrc)):
            inq = InputQueue(src)
            for i, row in enumerate(x):
                inq.enqueue_tensor(f"b{i}", row)
            srv._claim()  # one shed pass and its brownout tick
        assert psrv._brownout.level == jsrv._brownout.level == 1
        assert psrv.counters["shed"] == jsrv.counters["shed"] == 16
        types = ["serving.shed", "serving.brownout_rung"]
        jev = _strip(logs["j"].read(types=types))
        pev = _strip(logs["p"].read(types=types))
        for ev in jev + pev:
            ev.pop("label")
        assert pev == jev and len(pev) == 2
    finally:
        jevents.reset_default()
        pevents.reset_default()


# -- GenerativeServing -----------------------------------------------------------------

_LMS = {}


def _lm_pair():
    if not _LMS:
        jlm = JaxLM(seed=0, **LM)
        params = jlm._init_params(jax.random.PRNGKey(0), None)
        jlm._graph.estimator.set_params(params)
        plm = TransformerLM(**LM)
        plm.load_state_dict(from_jax_params(
            jax.tree_util.tree_map(np.asarray, params)), strict=True)
        plm._device("cpu")
        _LMS.update(j=jlm, p=plm)
    return _LMS["j"], _LMS["p"]


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, LM["vocab_size"], (n,)).tolist() for n in lengths]


def _gen_serve(cls, cfg_cls, lm, src, prompts, seeds=None, steps=300, **kw):
    srv = (cls(cfg_cls(data_src=src, **kw), lm, device="cpu")
           if cls is GenerativeServing else cls(cfg_cls(data_src=src, **kw),
                                                lm))
    inq = InputQueue(src)
    for i, p in enumerate(prompts):
        inq.enqueue_prompt(f"g{i}", p,
                           seed=None if seeds is None else seeds[i])
    idle = 0
    for _ in range(steps):
        idle = idle + 1 if srv.serve_step() == 0 else 0
        if idle >= 3:
            break
    return srv, OutputQueue(src).dequeue()


@pytest.mark.parametrize("site,kw", [
    ("serving.decode_step", dict(at=2)),
    ("serving.page_alloc", dict(at=2))], ids=["decode_step", "page_alloc"])
def test_generative_fault_sites_answer_as_jax(tmp_path, site, kw):
    """``serving.decode_step`` errors each stream active in that step once
    and later streams complete; ``serving.page_alloc`` sheds its join with
    the page shed error. Results and counters equal JAX's."""
    jlm, plm = _lm_pair()
    prompts = _prompts(3, [5, 9, 3, 12])
    cfg = dict(slots=2, max_new_tokens=6, kv_pages=24, kv_page_len=8)
    jfaults.arm(site, **kw)
    pfaults.arm(site, **kw)
    jsrv, jres = _gen_serve(JaxGenerative, JaxConfig, jlm, _src(tmp_path),
                            prompts, **cfg)
    psrv, pres = _gen_serve(GenerativeServing, ServingConfig, plm,
                            _src(tmp_path), prompts, **cfg)
    assert pres == jres
    errors = [r for r in pres.values() if "error" in r]
    assert len(errors) == (2 if site == "serving.decode_step" else 1)
    if site == "serving.page_alloc":
        assert errors[0]["error"] == pserver.PAGE_SHED_ERROR
        assert errors[0]["retriable"] is True
    assert psrv.health_snapshot()["counters"] == \
        jsrv.health_snapshot()["counters"]


def test_generative_health_snapshot_and_file_match_jax(tmp_path):
    jlm, plm = _lm_pair()
    prompts = _prompts(4, [4, 1, 20, 7])
    health = str(tmp_path / "gh" / "health.json")
    os.makedirs(os.path.dirname(health))
    cfg = dict(slots=3, max_new_tokens=5, kv_pages=20, kv_page_len=8)
    jsrv, jres = _gen_serve(JaxGenerative, JaxConfig, jlm, _src(tmp_path),
                            prompts, **cfg)
    psrv, pres = _gen_serve(GenerativeServing, ServingConfig, plm,
                            _src(tmp_path), prompts, health_path=health,
                            **cfg)
    assert pres == jres
    js, ps = jsrv.health_snapshot(), psrv.health_snapshot()
    assert sorted(ps) == sorted(js)
    for key in ("counters", "tokens_total", "slots", "slots_occupied",
                "kv_pages_free", "kv_shards", "brownout_level",
                "spec_accept_ratio", "in_flight", "model_version", "state"):
        assert ps[key] == js[key], key
    assert ps["ttft_ms"]["window"] == js["ttft_ms"]["window"] == 4
    psrv.stop()
    with open(health) as f:
        assert json.load(f)["state"] == "stopped"
    assert os.path.exists(os.path.join(os.path.dirname(health),
                                       "metrics.prom"))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_handed_off_streams_equal_a_run_not_handed_off(tmp_path, sampled):
    """Streams handed off after a few steps finish on a second server with
    the tokens of a run that was not handed off (sampled ones with the
    draws of their seeds' next positions), each with one terminal, on the
    second server; greedy ones also equal JAX's handed-off streams."""
    jlm, plm = _lm_pair()
    prompts = _prompts(5, [6, 11, 3])
    knobs = dict(temperature=0.9, top_k=30) if sampled else {}
    seeds = [11, 12, 13] if sampled else None
    cfg = dict(slots=3, max_new_tokens=12, kv_pages=24, kv_page_len=8,
               **knobs)
    _, plain = _gen_serve(GenerativeServing, ServingConfig, plm,
                          _src(tmp_path), prompts, seeds=seeds, **cfg)
    results = {}
    for name, cls, cfg_cls, lm in (
            ("p", GenerativeServing, ServingConfig, plm),
            ("j", JaxGenerative, JaxConfig, jlm)):
        if name == "j" and sampled:
            continue
        a_src, b_src = _src(tmp_path), _src(tmp_path)
        a, _ = _gen_serve(cls, cfg_cls, lm, a_src, prompts, seeds=seeds,
                          steps=3, **cfg)
        b, _ = _gen_serve(cls, cfg_cls, lm, b_src, [], **cfg)
        assert a.handoff(b.queue) == 3
        idle = 0
        while idle < 3:
            idle = idle + 1 if b.serve_step() == 0 else 0
        results[name] = OutputQueue(b_src).dequeue()
        assert a.health_snapshot()["in_flight"] == 0
    got = {u: r["value"] for u, r in results["p"].items()}
    assert got == {u: r["value"] for u, r in plain.items()}
    if not sampled:
        assert got == {u: r["value"] for u, r in results["j"].items()}
