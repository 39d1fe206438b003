"""The torch port's ops plane and trace flows against the JAX package on
the CPU: the metric history, burn-rate and threshold rules, the alert
engine, incident ordering, bundles and timelines, the incident CLI, the
process-default plane behind ``health.json``'s ``alerts`` and
``incident``, and the servers' request flow chains.

Each test feeds the JAX object and the port's the same samples, events or
records, at explicit wall-clock ``now`` values (no sleeping): history
queries, rule verdicts with their details, engine transitions, event
order and the rendered timeline strings are held exactly; for flow
chains, the set of stages each record's chain passes. Metric and event
names are ones the JAX package registers, each in a private registry or
log of the test's own.
"""
import json
import os
import uuid

import numpy as np
import pytest

from analytics_zoo_tpu.common import config as jcfg
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import metrics as jmetrics
from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.ops import alerts as jalerts
from analytics_zoo_tpu.ops import events as jevents
from analytics_zoo_tpu.ops import incident as jincident
from analytics_zoo_tpu.ops.__main__ import main as jcli
from analytics_zoo_tpu.ops.history import MetricHistory as JaxHistory
from analytics_zoo_tpu.serving import ClusterServing as JaxClusterServing
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.utils import trace as jtrace
from analytics_zoo_tpu_torch.common import config as pcfg
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.common import metrics as pmetrics
from analytics_zoo_tpu_torch.common.utils import time_it
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.ops import alerts as palerts
from analytics_zoo_tpu_torch.ops import events as pevents
from analytics_zoo_tpu_torch.ops import incident as pincident
from analytics_zoo_tpu_torch.ops.__main__ import main as pcli
from analytics_zoo_tpu_torch.ops.history import MetricHistory
from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                             GenerativeServing, ServingConfig)
from analytics_zoo_tpu_torch.serving import client as pclient
from analytics_zoo_tpu_torch.utils import trace as ptrace
from torch_port_threads import torch_threads_per_worker  # noqa: F401

T0 = 1_000_000.0
SIDES = {"jax": (jmetrics, JaxHistory, jalerts, jincident, jevents),
         "port": (pmetrics, MetricHistory, palerts, pincident, pevents)}
BAD, TOT = "serving.error_total", "serving.records_total"


@pytest.fixture(autouse=True)
def _leave_no_plane():
    """Whatever a test seals or starts, the next test (in either
    package) finds no incident and no default engine."""
    yield
    for alerts, incident in ((jalerts, jincident), (palerts, pincident)):
        alerts.shutdown_default()
        incident._last = None
    jfaults.reset()
    pfaults.reset()


@pytest.fixture()
def regs():
    out = {side: SIDES[side][0].Registry(capacity=4096) for side in SIDES}
    yield out
    for r in out.values():
        r.close()


def _each(regs, fn):
    """``fn(side, registry, history_class, alerts, incident, events)`` on
    both packages; the two results."""
    return {side: fn(side, regs[side], *SIDES[side][1:]) for side in SIDES}


# -- metric history ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_history_queries_equal_jax(regs, seed):
    """Counters with a reset between samples, a labeled counter, a gauge
    and a histogram: latest, windowed delta (reset-tolerant, seeded by a
    pre-window baseline), rate, window, dump, labels and kinds agree."""
    rs = np.random.RandomState(seed)
    steps = [(int(rs.randint(0, 5)), float(rs.uniform(0, 3)),
              float(rs.uniform(0.001, 0.5)), bool(rs.rand() < 0.1))
             for _ in range(30)]

    def run(side, reg, hist_cls, *_):
        c = reg.counter(TOT)
        lab = reg.counter("serving.shed_total", labels=("server",))
        g = reg.gauge("serving.queue_depth")
        h = reg.histogram("serving.request_latency_seconds")
        hist = hist_cls(reg, depth=16)
        for i, (n, depth, lat, reset) in enumerate(steps):
            if reset:
                reg.zero()
            c.inc(n)
            lab.labels(server=f"s{i % 2}").inc(n % 2)
            g.set(depth)
            h.observe(lat)
            hist.sample_once(now=T0 + i)
        now = T0 + len(steps) - 1
        return [hist.latest(TOT), hist.latest("serving.queue_depth"),
                hist.delta(TOT, seconds=10, now=now),
                hist.delta(TOT, now=now), hist.rate(TOT, 5.0, now=now),
                hist.delta("serving.request_latency_seconds", seconds=8,
                           now=now, key="count"),
                hist.window("serving.shed_total", "server=s1", 6, now),
                hist.labels_for("serving.shed_total"),
                hist.kind("serving.request_latency_seconds"),
                hist.delta(TOT, seconds=3, now=T0 + 100),
                hist.dump(seconds=4.0, now=now)]

    got = _each(regs, run)
    assert got["port"] == got["jax"]


# -- rules and the engine -----------------------------------------------------------


def _series(kind):
    """Per-second (bad, total) increments: fast burn then recovery, a
    moderate burn, a burn exactly on its factor, silence."""
    return {"fast": [(5, 10)] * 20 + [(0, 10)] * 26,
            "slow": [(1, 10)] * 30,
            "boundary": [(1, 2)] * 20 + [(3, 2)],
            "silence": [(0, 0)] * 10 + [(1, 1)] * 2}[kind]


@pytest.mark.parametrize("kind", ["fast", "slow", "boundary", "silence"])
def test_burn_rate_rules_fire_as_jax(regs, kind):
    """The same sample series gives the same verdicts and details every
    second, under the two-window pairs of the rule."""
    windows = {"fast": ((30.0, 5.0, 14.4),),
               "slow": ((30.0, 5.0, 14.4), (60.0, 10.0, 6.0)),
               "boundary": ((30.0, 5.0, 2.0),),
               "silence": ((30.0, 5.0, 1.0),)}[kind]
    objective = 0.75 if kind == "boundary" else 0.99

    def run(side, reg, hist_cls, alerts, *_):
        bad, tot = reg.counter(BAD), reg.counter(TOT)
        hist = hist_cls(reg, depth=256)
        rule = alerts.BurnRateRule("burn", bad=BAD, total=TOT,
                                   objective=objective, windows=windows,
                                   min_total=5.0)
        out = []
        for s, (b, t) in enumerate(_series(kind)):
            bad.inc(b)
            tot.inc(t)
            hist.sample_once(now=T0 + s)
            out.append(rule.evaluate(hist, T0 + s))
        return out

    got = _each(regs, run)
    assert got["port"] == got["jax"]
    fired = [f for f, _ in got["port"]]
    assert any(fired) == (kind != "silence")


def test_threshold_rule_and_engine_transitions_equal_jax(regs, tmp_path):
    """A sustained threshold (``for_s``) through the engine with
    hysteresis: the same fire and clear transitions, the same ``ops.alert``
    events, and ``on_fire`` calls at the same ``now``; the stock rule set
    is JAX's."""
    depths = [5.0] * 25 + [1.0] + [5.0] * 3 + [0.0] * 4

    def run(side, reg, hist_cls, alerts, incident, events):
        log = events.EventLog(root=str(tmp_path / side), enabled=True)
        g = reg.gauge("serving.queue_depth")
        hist = hist_cls(reg, depth=64)
        fired = []
        eng = alerts.AlertEngine(
            hist, [alerts.ThresholdRule("depth_high", "serving.queue_depth",
                                        above=2.0, for_s=10.0,
                                        clear_holds=2)],
            log=log, interval_s=999.0,
            on_fire=lambda name, info, t: fired.append((name, t)))
        trans = []
        for s, d in enumerate(depths):
            g.set(d)
            hist.sample_once(now=T0 + s)
            trans += eng.evaluate(now=T0 + s)
        evs = [(e["alert"], e["state"], e["info"])
               for e in log.read(types=["ops.alert"])]
        log.close()
        rules = [(type(r).__name__, r.name, vars(r))
                 for r in alerts.default_rules()]
        return trans, fired, evs, eng.active_alerts(), rules

    got = _each(regs, run)
    assert got["port"] == got["jax"]
    # the calm sample breaks "sustained" until it leaves the window
    assert [t["state"] for t in got["port"][0]] == ["fire", "clear"]


# -- incidents ------------------------------------------------------------------------


def _events(seed, n=12):
    """Seeded events of two pids whose wall clocks interleave, with mono
    order within a pid and one wall step backward."""
    rs = np.random.RandomState(seed)
    evs, mono = [], {101: 0.0, 202: 0.0}
    types = ["serving.brownout_rung", "fleet.breaker", "fleet.scale",
             "serving.shed"]
    for i in range(n):
        pid = int(rs.choice([101, 202]))
        mono[pid] += float(rs.uniform(0.01, 1))
        ev = {"type": types[rs.randint(4)], "wall": 100.0 + rs.uniform(0, 5),
              "mono": mono[pid], "seq": i + 1, "pid": pid,
              "label": f"inst{rs.randint(3)}", "count": int(rs.randint(9))}
        if rs.rand() < 0.3:
            ev["detail"] = {"b": 1, "a": [1, 2]}
        evs.append(ev)
    return evs


@pytest.mark.parametrize("seed", [0, 1])
def test_order_events_and_render_timeline_equal_jax(seed):
    evs = _events(seed)
    alert = {"name": "goodput_burn", "info": {"burn_long": 21.0}}
    got = {side: (SIDES[side][3].order_events(reversed(evs)),
                  SIDES[side][3].render_timeline(
                      SIDES[side][3].order_events(evs), reason="manual",
                      alert=alert),
                  SIDES[side][3].render_timeline([]))
           for side in SIDES}
    assert got["port"] == got["jax"]
    order = got["port"][0]
    for pid in (101, 202):
        monos = [e["mono"] for e in order if e["pid"] == pid]
        assert monos == sorted(monos)


def test_cli_timeline_seal_show_equal_jax(tmp_path, capsys):
    """Both CLIs over one spool of part files: the same timeline; each
    seals a bundle of the same events (the spool unchanged) and shows the
    same timeline from it."""
    spool = tmp_path / "spool"
    spool.mkdir()
    evs = _events(3)
    for pid in (101, 202):
        with open(spool / f"{pid}.jsonl", "w") as f:
            for ev in evs:
                if ev["pid"] == pid:
                    f.write(json.dumps(ev) + "\n")
        with open(spool / f"{pid}.jsonl", "a") as f:
            f.write('{"torn')
    before = sorted(os.listdir(spool))
    out = {}
    for side, cli in (("jax", jcli), ("port", pcli)):
        assert cli(["timeline", "--events", str(spool)]) == 0
        timeline = capsys.readouterr().out
        assert cli(["seal", "--events", str(spool), "--out",
                    str(tmp_path / f"inc-{side}"), "--reason", "probe",
                    "--window-s", str(10 ** 10)]) == 0
        bdir = capsys.readouterr().out.strip()
        assert cli(["show", bdir]) == 0
        shown = capsys.readouterr().out
        assert cli(["show", bdir, "--json"]) == 0
        bundle = json.loads(capsys.readouterr().out)
        out[side] = (timeline, shown, bundle["events"], bundle["reason"])
    assert out["port"] == out["jax"]
    assert sorted(os.listdir(spool)) == before
    assert out["port"][0].count("\n") == len(evs) + 1


# -- the process-default plane behind health.json ------------------------------------


def _mean_model(side):
    fwd = (lambda p, x: x.reshape(x.shape[0], -1).mean(1, keepdims=True)) \
        if side == "jax" else \
        (lambda p, x: x.reshape(x.shape[0], -1).mean(1, keepdim=True))
    return (JaxInferenceModel().load_jax(fwd, {}) if side == "jax"
            else InferenceModel(device="cpu").load_forward(fwd, {}))


def test_predict_fault_burst_fires_alert_into_health_as_jax(tmp_path):
    """``ops.enabled``: ``start`` brings up the default plane; a
    ``serving.predict`` fault on every batch of a burst burns the goodput
    budget, sampled and evaluated at explicit ``now``. ``goodput_burn``
    fires in both packages, its incident is sealed, and both show in
    ``health_snapshot()`` and ``health.json``."""
    got = {}
    for side, cfg, faults, cls, conf, client in (
            ("jax", jcfg, jfaults, JaxClusterServing, JaxConfig, jclient),
            ("port", pcfg, pfaults, ClusterServing, ServingConfig,
             pclient)):
        alerts, incident, events = SIDES[side][2:]
        spool = str(tmp_path / f"ops-{side}")
        conf_g = cfg.global_config()
        for key, val in (("ops.enabled", True), ("ops.dir", spool),
                         ("ops.sample_interval_s", 3600.0),
                         ("ops.eval_interval_s", 3600.0)):
            conf_g.set(key, val)
        events.reset_default(root=spool, enabled=True)
        try:
            src = f"dir://{tmp_path}/{side}-{uuid.uuid4().hex[:6]}"
            health = str(tmp_path / f"{side}-health.json")
            srv = cls(conf(data_src=src, image_shape=(2,), batch_size=4,
                           batch_wait_ms=2, health_path=health),
                      model=_mean_model(side))
            srv.start()
            eng = alerts.ensure_default()
            assert eng is not None and alerts.ensure_default() is eng
            eng.history.sample_once(now=T0)
            srv.stop()
            faults.arm("serving.predict", p=1.0, budget=3)
            inq = client.InputQueue(src)
            for i in range(12):
                inq.enqueue_tensor(f"r{i}", [1.0, 2.0])
            idle = 0
            while idle < 3:
                idle = idle + 1 if srv.serve_once() == 0 else 0
            eng.history.sample_once(now=T0 + 1)
            trans = eng.evaluate(now=T0 + 1)
            snap = srv.health_snapshot()
            srv._write_health()
            with open(health) as f:
                on_disk = json.load(f)
            got[side] = ([(t["name"], t["state"]) for t in trans],
                         snap["alerts"], snap["incident"]["reason"],
                         on_disk["alerts"], on_disk["incident"]["reason"],
                         snap["counters"]["errors"],
                         [e["type"] for e in events.default_log().read(
                             types=["ops.alert", "ops.incident"])])
        finally:
            alerts.shutdown_default()
            events.reset_default(enabled=False)
            for key in ("ops.enabled", "ops.dir", "ops.sample_interval_s",
                        "ops.eval_interval_s"):
                conf_g.unset(key)
            faults.reset()
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ([("goodput_burn", "fire")], ["goodput_burn"],
                               "alert:goodput_burn")


# -- trace flows ---------------------------------------------------------------------


def _chains(path, flow_cat):
    """Stages a flow id's anchors passed, and the flow phases seen."""
    with open(path) as f:
        evs = json.load(f)
    chains = {}
    for e in evs:
        tid = (e.get("args") or {}).get("trace_id")
        if e.get("ph") == "X" and tid is not None:
            chains.setdefault(tid, set()).add(e["name"])
    phases = sorted({e["ph"] for e in evs if e.get("cat") == flow_cat})
    return chains, phases


def test_cluster_serving_flow_chains_equal_jax(tmp_path):
    """A traced serving pass: every record's chain passes enqueue, claim,
    decode, dispatch and result in both packages, with start, step and
    finish flow phases; spans of ``time_it`` land in the trace."""
    got = {}
    for side, trace, cls, conf, client in (
            ("jax", jtrace, JaxClusterServing, JaxConfig, jclient),
            ("port", ptrace, ClusterServing, ServingConfig, pclient)):
        src = f"dir://{tmp_path}/{side}"
        srv = cls(conf(data_src=src, image_shape=(3,), batch_size=4,
                       batch_wait_ms=2), model=_mean_model(side))
        path = str(tmp_path / f"{side}.json")
        with trace.trace(path):
            inq = client.InputQueue(src)
            for i in range(6):
                inq.enqueue_tensor(f"r{i}", [1.0, 2.0, float(i)])
            done = 0
            while done < 6:
                done += srv.serve_once()
        chains, phases = _chains(path, trace.FLOW_CAT)
        got[side] = (sorted(sorted(c) for c in chains.values()), phases)
        names = {e["name"] for e in json.load(open(path))}
        assert "serving.decode_batch" in names, side
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 6 and got["port"][1] == ["f", "s", "t"]


def test_generative_flow_chains_and_nested_sessions(tmp_path):
    """A served stream's chain passes enqueue, claim and result; an outer
    session keeps every span an inner one records; rows carry thread
    labels; without a session nothing is recorded."""
    from analytics_zoo_tpu_torch.capture import TransformerLM
    lm = TransformerLM(vocab_size=32, hidden=16, n_block=1, n_head=2,
                       max_len=16, seed=0)
    src = f"dir://{tmp_path}/gen"
    srv = GenerativeServing(ServingConfig(data_src=src, slots=2,
                                          max_new_tokens=3), lm,
                            device="cpu")
    outer, inner = str(tmp_path / "outer.json"), str(tmp_path / "inner.json")
    assert not ptrace.tracing()
    with ptrace.trace(outer):
        ptrace.set_thread_label("test-driver")
        inq = pclient.InputQueue(src)
        for i in range(3):
            inq.enqueue_prompt(f"g{i}", [1, 2, 3 + i])
        with ptrace.trace(inner):
            with time_it("serving.claim_batch"):
                pass
            assert ptrace.tracing()
        idle = 0
        while idle < 3:
            idle = idle + 1 if srv.serve_step() == 0 else 0
    assert not ptrace.tracing()
    chains, phases = _chains(outer, ptrace.FLOW_CAT)
    assert sorted(sorted(c) for c in chains.values()) == [
        ["serving.claim", "serving.enqueue", "serving.result"]] * 3
    assert phases == ["f", "s", "t"]
    with open(outer) as f:
        outer_evs = json.load(f)
    with open(inner) as f:
        inner_names = [e["name"] for e in json.load(f) if e.get("ph") == "X"]
    assert inner_names == ["serving.claim_batch"]
    assert "serving.claim_batch" in {e["name"] for e in outer_evs}
    assert any(e.get("args", {}).get("name") == "test-driver"
               for e in outer_evs if e.get("name") == "thread_name")
    assert all(e["pid"] == os.getpid() for e in outer_evs)
