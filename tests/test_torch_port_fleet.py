"""The torch port's fleet tier against the JAX package on the CPU: the
queue contract the fleet needs (``FileQueue`` with a detached results
root, batched publish, trim, discard and claim-lease reaping on a remote
spool, ``RedisQueue`` over a fake client), the router's scoring,
placements and circuit breakers, continuation on failover, the retrying
client and ``FleetSupervisor``.

Each parity test runs the JAX object and the port's on the same inputs.
Scores, placements, breaker states, retry-budget tokens, queue file lanes
and results are held exactly, and so are failover's token streams (both
packages' servers, then serial ``generate``: the LMs carry the same
weights through ``from_jax_params``). Clocks are explicit: the routers'
``wall_clock`` is patched to a fixed epoch, and an instance dies by its
health file's stamp, not by sleeping.
"""
import collections
import json
import os
import time
import uuid

import jax
import numpy as np
import pytest

# the JAX supervisor registers the fleet.scale family and event that the
# port's does: registries stay comparable in whatever process runs this
import analytics_zoo_tpu.cluster.supervisor  # noqa: F401
from analytics_zoo_tpu.capture import TransformerLM as JaxLM
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import file_io as jfile_io
from analytics_zoo_tpu.serving import GenerativeServing as JaxGenerative
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving import fleet as jfleet
from analytics_zoo_tpu.serving import queues as jqueues
from analytics_zoo_tpu_torch.capture import TransformerLM
from analytics_zoo_tpu_torch.cluster import FleetSupervisor
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.common import file_io as pfile_io
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.serving import GenerativeServing, ServingConfig
from analytics_zoo_tpu_torch.serving import client as pclient
from analytics_zoo_tpu_torch.serving import fleet as pfleet
from analytics_zoo_tpu_torch.serving import queues as pqueues
from analytics_zoo_tpu_torch.serving.server import SHED_ERROR
from tests.test_redis_serving import FakeRedis
from torch_port_threads import torch_threads_per_worker  # noqa: F401

T = 2_000_000.0  # the routers' fixed wall clock
LM = dict(vocab_size=128, hidden=64, n_block=2, n_head=4, max_len=64)
PKGS = {"jax": (jqueues, jfleet, jclient), "port": (pqueues, pfleet, pclient)}


@pytest.fixture(autouse=True)
def _quiet_faults():
    yield
    jfaults.reset()
    pfaults.reset()


@pytest.fixture()
def clock(monkeypatch):
    """Both routers read ``T`` as now."""
    for mod in (jfleet, pfleet):
        monkeypatch.setattr(mod, "wall_clock", lambda: T)


def _health(path, age=0.0, **kw):
    snap = {"state": "running", "time": T - age, "queue_pending": 0,
            "in_flight": 0}
    snap.update(kw)
    with open(path, "w") as f:
        json.dump(snap, f)


def _spool_uris(q):
    return sorted(u for u, _ in q.claim_batch(1 << 10))


# -- scoring, placement and scale signals --------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_instances_equals_jax(seed):
    rs = np.random.RandomState(seed)
    n = 9
    args = (rs.rand(n) > 0.2, rs.randint(0, 20, n).astype(float),
            rs.randint(0, 4, n).astype(float),
            rs.randint(0, 3, n).astype(float),
            np.where(rs.rand(n) > 0.3, rs.randint(0, 40, n), -1.0),
            rs.uniform(0.01, 0.5, n), rs.uniform(0.005, 0.05, n))
    for need_tokens, need_pages in ((0, 0), (8, 0), (24, 6), (1, 40)):
        want = jfleet._score_instances(*args, np.float64(need_tokens),
                                       np.float64(need_pages))
        got = pfleet._score_instances(*args, np.float64(need_tokens),
                                      np.float64(need_pages))
        np.testing.assert_array_equal(got, want)


def _fleet(pkg, tmp_path, healths, **kw):
    queues, fleet, _ = PKGS[pkg]
    root = str(tmp_path / pkg)
    front = queues.FileQueue(root)
    insts = [fleet.FleetInstance(name, fleet.instance_queue(root, name),
                                 hp, slots=slots)
             for name, hp, slots in healths]
    kw.setdefault("stale_after_s", 5.0)
    kw.setdefault("health_refresh_s", 0.0)
    return front, insts, fleet.FleetRouter(front, insts, **kw)


def _requests(seed, n):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        rec = {"enqueue_t": T - float(rs.uniform(0, 2))}
        if rs.rand() < 0.5:
            rec["prompt"] = rs.randint(0, 100, rs.randint(2, 30)).tolist()
            rec["max_new_tokens"] = int(rs.randint(4, 64))
        else:
            rec["tensor"] = [1.0]
        if rs.rand() < 0.4:
            rec["deadline_ms"] = int(rs.choice([50, 500, 1500, 5000]))
        out.append((f"q{i}", rec))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_router_places_as_jax_for_the_same_health_files(tmp_path, clock,
                                                        seed):
    """Seeded gauges in five health files (one stale, one draining),
    seeded one-shot and generative requests with deadlines: every request
    lands on the same instance, or gets the same shed or deadline error,
    in both packages, and the scale signal agrees."""
    rs = np.random.RandomState(seed)
    healths = []
    for i in range(5):
        hp = str(tmp_path / f"h{i}.json")
        kw = dict(queue_pending=int(rs.randint(0, 30)),
                  in_flight=int(rs.randint(0, 4)),
                  service_time_s_ewma=float(rs.uniform(0.005, 0.2)),
                  slots=4, slots_occupied=int(rs.randint(0, 5)),
                  kv_pages_free=int(rs.randint(0, 50)),
                  tokens_per_sec_ewma=float(rs.uniform(20, 400)))
        if i == 3:
            kw["state"] = "draining"
        _health(hp, age=60.0 if i == 4 else 0.5, **kw)
        healths.append((f"i{i}", hp, 4))
    reqs = _requests(seed, 40)
    got = {}
    for pkg in PKGS:
        front, insts, router = _fleet(pkg, tmp_path, healths, page_len=16)
        for uri, rec in reqs:
            front.enqueue(uri, dict(rec))
        placed = router.route_once(max_items=16)
        placed += router.route_once(max_items=64)
        got[pkg] = {"placed": placed,
                    "spools": {i.name: _spool_uris(i.queue) for i in insts},
                    "answers": {u: r["error"]
                                for u, r in front.all_results().items()},
                    "desired": router.desired_instances(),
                    "stats": router.stats}
    assert got["port"] == got["jax"]
    assert got["port"]["answers"] and got["port"]["spools"]["i0"] + \
        got["port"]["spools"]["i1"] + got["port"]["spools"]["i2"]


def test_router_route_fault_stop_and_dead_instances_as_jax(tmp_path, clock):
    """The ``fleet.route`` fault parks a request for the next pass; an
    instance with no or a stale health file takes nothing; ``stop`` hands
    the backlog back to the front."""
    ha, hb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _health(ha, service_time_s_ewma=0.01)
    trace = {}
    for pkg, faults in (("jax", jfaults), ("port", pfaults)):
        _health(hb, age=60.0)
        front, insts, router = _fleet(pkg, tmp_path, [
            ("a", ha, 1), ("b", hb, 1), ("c", str(tmp_path / "none"), 1)])
        faults.arm("fleet.route", at=1)
        for i in range(3):
            front.enqueue(f"r{i}", {"tensor": [1], "enqueue_t": T})
        steps = [router.route_once(), dict(router.stats)]
        steps += [router.route_once(), dict(router.stats),
                  [i.queue.pending_count() for i in insts],
                  faults.fire_count("fleet.route")]
        _health(hb, age=0.0)
        os.remove(ha)  # a gone, b back: nothing placeable until refresh
        front.enqueue("r9", {"tensor": [1], "enqueue_t": T})
        steps += [router.route_once(), [i.queue.pending_count()
                                        for i in insts]]
        faults.arm("fleet.breaker", p=1.0, budget=2)  # a and b trip
        _health(ha)
        front.enqueue("r10", {"tensor": [1], "enqueue_t": T})
        steps += [router.route_once(), dict(router.stats),
                  router.breaker_states()]
        router.stop()
        steps.append(front.pending_count())
        trace[pkg] = steps
    assert trace["port"] == trace["jax"]
    assert trace["port"][-1] == 1


def _breaker_ops(seed):
    rs = np.random.RandomState(seed)
    ops, now = [], 100.0
    for i in range(80):
        now += float(rs.choice([0.0, 0.3, 1.1, 2.5]))
        k = rs.randint(5)
        if k == 0:
            ops.append(("record_result", f"u{rs.randint(6)}",
                        bool(rs.rand() < 0.6), now))
        elif k == 1:
            ops.append(("record_latency", float(rs.uniform(0, 1)),
                        float(rs.choice([0.0, 0.1])), now))
        elif k == 2:
            ops.append(("placeable", now))
        elif k == 3:
            ops.append(("note_placed", f"u{rs.randint(6)}"))
        elif rs.rand() < 0.2:
            ops.append(("trip", now))
    return ops


@pytest.mark.parametrize("seed", [5, 6])
def test_breaker_states_equal_jax_for_the_same_results(seed):
    """The same sequence of settled terminals, latency refreshes, probes
    and trips at explicit ``now`` moves both breakers through the same
    states and placeable answers."""
    brs = [mod._Breaker(2, 4.0, 2.0, name="x") for mod in (jfleet, pfleet)]
    trace = [[], []]
    for op, *args in _breaker_ops(seed):
        for br, out in zip(brs, trace):
            ret = getattr(br, op)(*args)
            out.append((ret, br.state))
    assert trace[1] == trace[0]
    assert {s for _, s in trace[1]} == {0, 1, 2}


def test_breaker_trips_on_error_streak_and_probe_closes_as_jax(
        tmp_path, monkeypatch):
    """Through the router, at explicit clocks: three error terminals open
    the breaker, the cooldown admits one probe, its clean terminal closes
    it and the parked request is placed."""
    hp = str(tmp_path / "a.json")
    _health(hp)
    now = {"t": T}
    for mod in (jfleet, pfleet):
        monkeypatch.setattr(mod, "wall_clock", lambda: now["t"])
    trace = {}
    for pkg in PKGS:
        now["t"] = T
        front, (inst,), router = _fleet(pkg, tmp_path, [("a", hp, 1)])
        steps = []
        for i in range(3):
            front.enqueue(f"r{i}", {"tensor": [1], "enqueue_t": T})
        steps.append(router.route_once())
        for uri, _ in inst.queue.claim_batch(10):
            inst.queue.put_result(uri, {"error": "predict failed"})
        steps += [router.route_once(), router.breaker_states()]
        front.enqueue("r3", {"tensor": [1], "enqueue_t": T})
        steps += [router.route_once(), dict(router.stats)]
        now["t"] = T + 1.5  # past fleet.breaker_cooldown_s
        _health(hp, age=-1.5)
        front.enqueue("r4", {"tensor": [1], "enqueue_t": T})
        steps += [router.route_once(), router.breaker_states(),
                  dict(router.stats)]
        for uri, _ in inst.queue.claim_batch(10):
            inst.queue.put_result(uri, {"value": [1]})
        steps += [router.route_once(), router.route_once(),
                  router.breaker_states(), dict(router.stats)]
        trace[pkg] = steps
    assert trace["port"] == trace["jax"]
    assert trace["port"][2] == {"a": 1} and trace["port"][-2] == {"a": 0}


# -- continuation on failover ------------------------------------------------------

_LMS = {}


def _lms():
    """The JAX LM and the port's with the same weights."""
    if not _LMS:
        jlm = JaxLM(seed=0, **LM)
        params = jlm._init_params(jax.random.PRNGKey(0), None)
        jlm._graph.estimator.set_params(params)
        plm = TransformerLM(seed=0, **LM)
        plm.load_state_dict(from_jax_params(
            jax.tree_util.tree_map(np.asarray, params)), strict=True)
        plm._device("cpu")
        _LMS.update(jax=jlm, port=plm)
    return _LMS["jax"], _LMS["port"]


class _Terminals:
    """Counts the terminals posted through a queue."""

    def __init__(self, queue):
        self.counts = collections.Counter()
        put = queue.put_result

        def counted(uri, value):
            if "error" in value or "value" in value:
                self.counts[uri] += 1
            put(uri, value)
        queue.put_result = counted


def _pair_of_servers(pkg, tmp_path, lm, **cfg_kw):
    queues, fleet, client = PKGS[pkg]
    root = str(tmp_path / f"{pkg}-{uuid.uuid4().hex[:6]}")
    front = queues.FileQueue(root)
    servers, insts, counts = [], [], []
    for name in ("a", "b"):
        q = fleet.instance_queue(root, name)
        hp = os.path.join(root, f"{name}.health.json")
        kw = dict(data_src=root, slots=2, max_new_tokens=10,
                  stream_interval=2, health_path=hp, health_interval_s=0.0,
                  **cfg_kw)
        srv = (GenerativeServing(ServingConfig(**kw), lm, queue=q,
                                 device="cpu") if pkg == "port"
               else JaxGenerative(JaxConfig(**kw), lm, queue=q))
        counts.append(_Terminals(q))
        servers.append(srv)
        insts.append(fleet.FleetInstance(name, q, hp, slots=2))
    router = fleet.FleetRouter(front, insts, stale_after_s=5.0,
                               health_refresh_s=0.0)
    return root, front, servers, router, counts, client


def _freeze(path):
    """The instance stops: its health file keeps an old stamp."""
    with open(path) as f:
        snap = json.load(f)
    snap["time"] -= 60.0
    with open(path, "w") as f:
        json.dump(snap, f)


def _drive(srv, steps=200):
    idle = 0
    for _ in range(steps):
        idle = idle + 1 if srv.serve_step() == 0 else 0
        if idle >= 3:
            return


def _failover(pkg, tmp_path, lm, prompts, seeds=None, **cfg_kw):
    """Route the streams to A (two resident, the rest in its spool), step
    A until a stream has a partial, freeze A, let the router reclaim its
    spool and fail its streams over to B, finish them there."""
    root, front, (a, b), router, counts, client = _pair_of_servers(
        pkg, tmp_path, lm, **cfg_kw)
    a.serve_step()  # A writes fresh health; B has none yet: all go to A
    inq = client.InputQueue(f"dir://{root}")
    for i, p in enumerate(prompts):
        inq.enqueue_prompt(f"s{i}", p,
                           seed=None if seeds is None else seeds[i])
    router.route_once()
    for _ in range(50):
        a.serve_step()
        res = front.get_result("s0")
        if res is not None and len(res.get("stream") or []) >= 4:
            break
    _freeze(a.config.health_path)
    b.serve_step()
    router.route_once()
    _drive(b)
    out = {f"s{i}": front.get_result(f"s{i}") for i in range(len(prompts))}
    assert all(r is not None and r.get("done") is True for r in out.values())
    terminals = counts[0].counts + counts[1].counts
    return {u: r["value"] for u, r in out.items()}, terminals


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_failover_continues_streams_token_identically(tmp_path, sampled):
    """Three streams on A, two mid-decode and one still in A's spool; A
    freezes and B adopts all three, each with exactly one terminal.
    Greedy: the port's tokens equal JAX's, and both equal serial
    ``generate``'s (tokens exactly). Sampled: the port's equal its serial
    ``generate(seed=...)`` (JAX draws other noise)."""
    jlm, plm = _lms()
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 128, (n,)).tolist() for n in (5, 9, 4)]
    kw = dict(temperature=0.9, top_k=8) if sampled else {}
    seeds = [11, 12, 13] if sampled else None
    pkgs = ("port",) if sampled else ("jax", "port")
    got = {pkg: _failover(pkg, tmp_path, plm if pkg == "port" else jlm,
                          prompts, seeds=seeds, **kw) for pkg in pkgs}
    tokens, terminals = got["port"]
    assert dict(terminals) == {"s0": 1, "s1": 1, "s2": 1}
    if not sampled:
        assert tokens == got["jax"][0]
    for i, p in enumerate(prompts):
        want = plm.generate(np.asarray([p]), 10, device="cpu",
                            seed=None if seeds is None else seeds[i],
                            **kw)[0].tolist()
        assert tokens[f"s{i}"] == want, f"s{i}"


def test_handed_off_streams_get_one_terminal_unlike_jax(tmp_path):
    """A drains by ``handoff`` to the front (as the supervisor's scale-in
    does) and writes ``drained``. The port's router places the
    handed-off copy only; JAX's also fails the stream over from its
    partial, so the survivor decodes it twice and posts two terminals
    (Queue C). Both end at serial ``generate``'s tokens."""
    jlm, plm = _lms()
    prompt = np.random.RandomState(9).randint(0, 128, (6,)).tolist()
    got = {}
    for pkg, lm in (("jax", jlm), ("port", plm)):
        queues = PKGS[pkg][0]
        root, front, (a, b), router, counts, client = _pair_of_servers(
            pkg, tmp_path, lm)
        a.serve_step()
        b.serve_step()
        client.InputQueue(f"dir://{root}").enqueue_prompt("d0", prompt)
        router.route_once()
        for _ in range(4):
            a.serve_step()
        assert a.handoff(queues.FileQueue(root)) == 1
        for _ in range(3):
            router.route_once()
        _drive(b)
        got[pkg] = (front.get_result("d0")["value"],
                    counts[0].counts["d0"] + counts[1].counts["d0"])
    want = plm.generate(np.asarray([prompt]), 10, device="cpu")[0].tolist()
    assert got["port"] == (want, 1)
    assert got["jax"] == (want, 2)


# -- queues -----------------------------------------------------------------------------


LOAD = (("s0", "sheddable"), ("d1", "default"), ("c2", "critical"),
        ("s3", "sheddable"), ("d4", "default"), ("c5", "critical"),
        ("x6", "page-me"))


def _queue_story(queues, root, other_results):
    """Lanes, batched publish, shed, trim, detached results, discard."""
    q = queues.FileQueue(root, results_root=other_results)
    front = queues.FileQueue(other_results)
    q.enqueue_many([(u, {"tensor": [1], "criticality": lane})
                    for u, lane in LOAD])
    names = sorted(os.listdir(os.path.join(root, "requests")))
    story = [[n.split("-")[0] for n in names], q.pending_count()]
    members = sorted(os.listdir(os.path.join(root, "requests", names[0])))
    story.append(sorted(m.split(".")[-2] for m in members))
    story.append(sorted(q.shed(5)))
    story.append(q.trim(3))
    for u, lane in LOAD[:2]:
        q.enqueue(u, {"tensor": [2], "criticality": lane})
    story.append([u for u, _ in q.claim_batch(10)])
    q.put_result("c2", {"value": [3]})
    story += [front.get_result("c2"), sorted(front.all_results()),
              q.discard_result("c2"), q.discard_result("c2"),
              front.get_result("c2"), q.pending_count()]
    return story


def test_file_queue_lanes_batches_and_results_equal_jax(tmp_path):
    story = {pkg: _queue_story(PKGS[pkg][0], str(tmp_path / f"{pkg}q"),
                               str(tmp_path / f"{pkg}front"))
             for pkg in PKGS}
    assert story["port"] == story["jax"]
    assert story["port"][0] == ["batch"] and story["port"][3] == \
        ["s0", "s3"]


@pytest.fixture()
def memfs():
    """One in-memory filesystem registered as ``fakefs://`` in both
    packages."""
    from fsspec.implementations.memory import MemoryFileSystem

    class _FS(MemoryFileSystem):
        cachable = False
        store = {}
        pseudo_dirs = [""]

    fs = _FS()
    for mod in (jfile_io, pfile_io):
        mod.register_filesystem("fakefs", fs)
    yield fs
    for mod in (jfile_io, pfile_io):
        mod.unregister_filesystem("fakefs")


def test_remote_spool_shared_with_jax_and_reaps_stale_claims(memfs):
    """A JAX client's records on a registered ``fakefs://`` spool are
    claimed by the port's queue through claim markers; a marker left by a
    consumer that died is reaped once older than the lease, by JAX's rule
    and the port's alike; ``make_queue`` takes the scheme."""
    root = f"fakefs://spool-{uuid.uuid4().hex[:6]}"
    jq = jqueues.FileQueue(root)
    pq = pqueues.make_queue(root)
    assert isinstance(pq, pqueues.FileQueue)
    for u, lane in LOAD[:4]:
        jq.enqueue(u, {"tensor": [1], "criticality": lane})
    assert pq.pending_count() == 4
    assert [u for u, _ in pq.claim_batch(2)] == ["c2", "d1"]
    # a consumer claimed s0 100 s ago and died before reading it: inside
    # the default lease of 300 s, so nobody takes s0 yet
    pfile_io.create_exclusive(f"{root}/claimed/" + sorted(
        n for n in pfile_io.listdir(f"{root}/requests")
        if n.endswith(".s.json"))[0] + ".claim",
        repr(time.time() - 100).encode())
    assert [u for u, _ in pq.claim_batch(5)] == ["s3"]
    reaped = {}
    for pkg, cls in (("jax", jqueues.FileQueue), ("port", pqueues.FileQueue)):
        q = cls(root, claim_lease_s=60.0)
        reaped[pkg] = [u for u, _ in q.claim_batch(5)]
        if pkg == "jax":  # put the record back for the port's turn
            q.enqueue("s0", {"tensor": [1], "criticality": "sheddable"})
            pfile_io.create_exclusive(f"{root}/claimed/" + pfile_io.listdir(
                f"{root}/requests")[0] + ".claim",
                repr(time.time() - 100).encode())
    assert reaped == {"jax": ["s0"], "port": ["s0"]}
    pq.put_result("s0", {"value": [1]})
    assert jq.get_result("s0") == {"uri": "s0", "value": [1]}
    assert pq.discard_result("s0") and jq.get_result("s0") is None


class _Redis(FakeRedis):
    """``FakeRedis`` with the pipeline and DEL that batched publish and
    result discard use."""

    def pipeline(self):
        calls = []

        class _Pipe:
            def xadd(_, *a):
                calls.append(a)

            def execute(_):
                return [self.xadd(*a) for a in calls]
        return _Pipe()

    def delete(self, key):
        return 1 if self.hashes.pop(key, None) is not None else 0


@pytest.fixture()
def fake_redis(monkeypatch):
    import sys
    import types
    _Redis.instances.clear()
    mod = types.ModuleType("redis")
    mod.StrictRedis = _Redis
    monkeypatch.setitem(sys.modules, "redis", mod)
    return _Redis


def _redis_story(queues, host):
    q = queues.RedisQueue(client=_Redis(host, 1, 0), claim_lease_s=0.0)
    q.enqueue_many([(u, {"tensor": [1], "criticality": lane})
                    for u, lane in LOAD])
    story = [q.pending_count(), sorted(q.shed(5)), q.trim(3),
             q.pending_count()]
    claimed = q.claim_batch(2)
    story.append([u for u, _ in claimed])
    # a second consumer reclaims what the first left unanswered
    other = queues.RedisQueue(client=_Redis(host, 1, 0), claim_lease_s=0.0)
    story.append(sorted(u for u, _ in other.claim_batch(10)))
    other.put_result(claimed[0][0], {"value": [5]})
    story += [q.get_result(claimed[0][0]), q.discard_result(claimed[0][0]),
              q.get_result(claimed[0][0]), q.get_result("s0"),
              sorted(q.consumer_pending().values())]
    return story


def test_redis_queue_contract_equals_jax(fake_redis):
    story = {pkg: _redis_story(PKGS[pkg][0], f"h-{pkg}") for pkg in PKGS}
    assert story["port"] == story["jax"]
    assert story["port"][1] == ["s0", "s3"]
    q = pqueues.make_queue("redishost:6379")
    assert isinstance(q, pqueues.RedisQueue)


# -- the client ---------------------------------------------------------------------------


def test_retry_budget_tokens_and_jitter_equal_jax():
    rs = np.random.RandomState(8)
    budgets = [mod.RetryBudget(ratio=0.25, burst=3.0)
               for mod in (jclient, pclient)]
    trace = [[], []]
    for _ in range(200):
        op = "deposit" if rs.rand() < 0.6 else "try_spend"
        for b, out in zip(budgets, trace):
            out.append((getattr(b, op)(), b.tokens))
    assert trace[1] == trace[0]
    import random
    clients = [mod.ResilientClient(f"dir:///tmp/unused-{uuid.uuid4().hex}",
                                   backoff_s=0.05, rng=random.Random(3))
               for mod in (jclient, pclient)]
    assert [clients[1]._jitter(a) for a in range(6)] == \
        [clients[0]._jitter(a) for a in range(6)]
    for c in clients:
        for i in range(40):
            c._note_latency(0.001 * (i % 17))
    assert clients[1]._p99_delay() == clients[0]._p99_delay()


@pytest.mark.parametrize("case", ["retry", "final", "budget", "hedge"])
def test_resilient_client_paths_equal_jax(tmp_path, case):
    """Retries of retriable terminals under fresh uris, no retry of a
    final error, the budget's cap on amplification, and a hedged query
    whose losing copy is reaped: the same attempts and answers."""
    got = {}
    for pkg in PKGS:
        c = PKGS[pkg][2].ResilientClient(str(tmp_path / f"{case}{pkg}"),
                                         backoff_s=0.0, budget_ratio=0.1,
                                         attempts=3)
        q = c.outputs.queue
        sent = []

        def enqueue(uri):
            sent.append(uri)
            if case == "retry":
                q.put_result(uri, {"error": SHED_ERROR, "retriable": True}
                             if len(sent) == 1 else {"value": [7]})
            elif case == "final":
                q.put_result(uri, {"error": "deadline exceeded",
                                   "retriable": False})
            elif case == "budget":
                q.put_result(uri, {"error": SHED_ERROR, "retriable": True})
            elif uri.endswith("~h"):
                q.put_result(uri, {"value": [42]})
        if case == "hedge":
            res = [c.query_any("h0", enqueue, timeout_s=5.0,
                               hedge_delay_s=0.01)]
            q.put_result("h0", {"value": [41]})  # the loser lands late
            res += [c.reap_pending(), q.get_result("h0")]
        else:
            res = [c.call(f"u{i}", enqueue, timeout_s=5.0)
                   for i in range(12 if case == "budget" else 1)]
        got[pkg] = (res, sent, c.requests_sent, c.attempts_sent,
                    c.budget.tokens)
    assert got["port"] == got["jax"]


# -- the supervisor ----------------------------------------------------------------------------


def fleet_predict_factory(root, name):
    """A one-shot ``ClusterServing`` on the CPU whose model is the row
    mean, on its instance spool."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing

    model = InferenceModel(device="cpu").load_forward(
        lambda p, x: x.reshape(x.shape[0], -1).mean(1, keepdim=True), {})
    cfg = ServingConfig(data_src=f"dir://{root}/inst/{name}", batch_size=4,
                        batch_wait_ms=2, image_shape=(3,),
                        health_path=os.path.join(root,
                                                 f"{name}.health.json"),
                        health_interval_s=0.0)
    return ClusterServing(cfg, model=model,
                          queue=pfleet.instance_queue(root, name))


@pytest.mark.pod(budget_s=3.0)
def test_fleet_supervisor_scales_out_and_in_with_one_terminal(tmp_path):
    """Forked CPU instances: the supervisor brings the fleet up to two,
    the router spreads a burst over them, the newest drains on scale-in
    and exits, and the audit journals hold exactly one terminal a
    request."""
    root = str(tmp_path / "fleet")
    front = pqueues.FileQueue(root)
    router = pfleet.FleetRouter(front, [], stale_after_s=5.0,
                                health_refresh_s=0.0)
    sup = FleetSupervisor(router, root, f"{__name__}:fleet_predict_factory",
                          min_instances=2, max_instances=2,
                          scale_interval_s=0.0, ready_timeout_s=20,
                          start_method="fork")
    try:
        st = sup.status()
        assert st["alerts"] == [] and st["instances"] == []
        events = [sup.step(), sup.step()]
        assert events == ["out:inst0", "out:inst1"] and sup.alive_count() == 2
        inq = pclient.InputQueue(f"dir://{root}")
        for i in range(24):
            inq.enqueue_tensor(f"r{i}", [float(i), 1.0, 2.0])
        n_results = 0
        for _ in range(2000):
            router.route_once()
            n_results = len(front.all_results())
            if n_results == 24:
                break
        assert n_results == 24
        sup.min_instances = sup.max_instances = 1
        assert sup.step() == "in:inst1"
        for _ in range(500):
            router.route_once()
            sup.step()
            if not sup._draining:
                break
        assert sup.status()["instances"] == ["inst0"]
        assert [i.name for i in router.instances] == ["inst0"]
    finally:
        sup.shutdown(timeout_s=10)
    terminals = collections.Counter()
    for name in os.listdir(os.path.join(root, "audit")):
        with open(os.path.join(root, "audit", name)) as f:
            terminals.update(line.strip() for line in f if line.strip())
    assert terminals == collections.Counter(f"r{i}" for i in range(24))
    res = front.all_results()
    assert all(abs(res[f"r{i}"]["value"][0] - (i + 3.0) / 3.0) < 1e-6
               for i in range(24))
    assert sorted(n for n in os.listdir(root) if n.startswith("exit_")) == \
        ["exit_inst0.json", "exit_inst1.json"]


def test_make_queue_takes_every_source(fake_redis, tmp_path):
    """``make_queue`` serves ``dir://``, ``file://``, paths and
    ``host:port`` (registered schemes: the remote spool test)."""
    assert type(pqueues.make_queue(f"dir://{tmp_path}/a")) is \
        pqueues.FileQueue
    assert type(pqueues.make_queue(f"file://{tmp_path}/b")) is \
        pqueues.FileQueue
    assert type(pqueues.make_queue(str(tmp_path / "c"))) is pqueues.FileQueue
    assert type(pqueues.make_queue("localhost:6380")) is pqueues.RedisQueue
