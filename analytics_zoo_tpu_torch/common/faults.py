"""Deterministic, config-driven fault injection (counterpart of
``analytics_zoo_tpu/common/faults.py``: the same sites, schedules and
telemetry, reporting into the port's own metrics registry and event log).

Named injection sites are threaded through every component that claims
fault tolerance, and tests arm them with deterministic schedules to prove
that recovery recovers:

- **Deterministic.** ``at=N`` rules fire on exactly the N-th call of a
  site in a process; probabilistic rules (``p=0.2``) draw from a per-site
  ``random.Random`` seeded from ``faults.seed`` xor a stable site hash, so
  the same seed gives the same firing pattern.
- **Budgeted.** Every rule carries a budget (default 1) after which the
  site goes quiet. Budgets and fire counts live in
  ``multiprocessing.Value`` shared memory, so a site armed before a
  ``fork`` is shared with the children.
- **Registry-complete.** ``inject()`` refuses unknown site names; the
  REGISTRY below is the JAX package's whole table, so a site armed here
  means what it means there.
- **Free when idle.** With no rules armed, ``inject()`` is a dict lookup
  and a couple of ``is None`` checks.

Two site kinds: ``raise`` sites raise :class:`FaultInjected` (an
``OSError``, so transient-IO retry layers treat it as retryable); ``flag``
sites return ``True`` and the call site performs the fault itself.

Config: ``faults.plan`` is a comma-separated schedule string, e.g.
``"serving.predict:3,serving.reload:1,serving.claim:0.1@4"``: ``site:N``
fires on the N-th call, ``site:0.1`` with probability 0.1 per call, ``@B``
sets the budget. ``faults.seed`` seeds the probabilistic draws. Tests use
:func:`arm` and :func:`reset`.
"""
from __future__ import annotations

import multiprocessing
import random
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, Optional

from . import metrics as _metrics

__all__ = ["FaultInjected", "Site", "REGISTRY", "inject", "arm", "reset",
           "fire_count", "armed", "describe", "tear_snapshot"]


class FaultInjected(OSError):
    """Raised by a firing ``raise``-kind injection site. Subclasses
    ``OSError`` on purpose: layers that retry transient IO must treat an
    injected fault exactly like a real flaky backend."""

    def __init__(self, site: str, call: int):
        super().__init__(f"injected fault at site {site!r} (call #{call})")
        self.site = site
        self.call = call


@dataclass(frozen=True)
class Site:
    description: str
    kind: str = "raise"  # "raise" | "flag"


#: Every injection site of the JAX package, whole: a ``faults.inject("x")``
#: call without a row here fails at the call site (unknown site). The port
#: fires the serving sites; the others wait for the modules that hold
#: them.
REGISTRY: Dict[str, Site] = {
    "train.step": Site(
        "estimator train loop, once per dispatched step — models a chip/"
        "tunnel failure surfacing as a step exception (elastic retry)"),
    "train.preempt": Site(
        "estimator train loop — simulates SIGTERM preemption notice "
        "(fence writer, final snapshot, resumable marker)", kind="flag"),
    "ckpt.write": Site(
        "snapshot writer, before serialize+publish — models a write "
        "failure/crash before the atomic publish"),
    "ckpt.corrupt": Site(
        "snapshot writer, after publish — tears the just-published "
        "snapshot (checksum-manifest fallback must skip it)", kind="flag"),
    "io.remote": Site(
        "every remote file_io operation, before dispatch — models a "
        "flaky object store (retry-with-backoff absorbs it)"),
    "worker.task": Site(
        "transform worker child, before applying the chain to a task — "
        "models a transient per-task failure (task retry budget)"),
    "worker.kill": Site(
        "transform worker child — SIGKILLs itself mid-batch (pool "
        "self-healing respawns and resubmits)", kind="flag"),
    "xshard.task": Site(
        "xshard ETL worker child, before running a task body — models a "
        "transient per-task failure (task retry budget)"),
    "xshard.kill": Site(
        "xshard ETL worker child — SIGKILLs itself mid-task (pool "
        "self-healing respawns and resubmits)", kind="flag"),
    "feed.produce": Site(
        "device-feed producer thread, once per host batch — models a "
        "data-plane crash mid-epoch (surfaces in the consumer)"),
    "serving.decode": Site(
        "serving record decode, once per record — an undecodable/faulty "
        "record must become an error result, not kill the loop"),
    "serving.writeback": Site(
        "serving result writeback, once per batch — a failed writeback "
        "must error its batch and keep the server draining"),
    "serving.claim": Site(
        "serving claim stage, once per claim attempt — a flaky queue "
        "backend must be retried and absorbed, never kill the serve loop"),
    "serving.predict": Site(
        "serving batch dispatch, once per batch — a failed predict must "
        "post error results for ITS batch and keep the server serving"),
    "serving.reload": Site(
        "hot model reload, once per reload attempt — a failed reload "
        "must roll back to the serving model with zero dropped requests"),
    "serving.decode_step": Site(
        "generative scheduler, once per fused decode step — a failed step "
        "must error every active stream (their one terminal result) and "
        "keep the scheduler serving new requests"),
    "serving.page_alloc": Site(
        "paged KV allocator, at stream join — simulates pool exhaustion; "
        "the request must be SHED with a terminal page-shed error while "
        "every resident stream keeps decoding (no crash, no stall)",
        kind="flag"),
    "fleet.route": Site(
        "fleet router placement, once per routed request — a failed "
        "placement pass must park the request in the router backlog and "
        "retry it next pass (never lost, never double-enqueued)"),
    "fleet.breaker": Site(
        "fleet router health refresh, once per instance — a firing "
        "force-opens that instance's circuit breaker (arm with budget=N "
        "to trip the first N instances refreshed); the router must stop "
        "placing on it, half-open probe it after the cooldown, and close "
        "the breaker on a clean probe", kind="flag"),
    "cluster.heartbeat": Site(
        "worker lease heartbeat thread, once per beat — a firing makes "
        "the worker STOP heartbeating (a hung host: process alive, lease "
        "frozen); the supervisor's monotonic lease-age detector must "
        "declare it dead and restart the pod generation", kind="flag"),
    "cluster.worker_restart": Site(
        "elastic supervisor, before respawning a pod generation — models "
        "a respawn that itself fails (scheduler refusal, image pull); "
        "the supervisor must back off and retry within its budget"),
    "fleet.scale_actuate": Site(
        "fleet supervisor actuation step, once per spawn/drain decision "
        "— a failed actuation must leave the fleet consistent and be "
        "retried on the next cadence tick, never half-spawn"),
    "online.promote": Site(
        "trainer→server promotion, once per instance before its reload "
        "(canary is the 1st) — a rollout that dies at any instance must "
        "roll every already-promoted instance back to the prior "
        "model_version with zero dropped requests"),
}


#: per-site chaos telemetry (fork-safe shared-memory slots: a site fired
#: inside a worker child shows up in the parent's exposition)
_M_ARMED = _metrics.counter(
    "fault.armed_total", "Fault-injection rules armed, by site.",
    labels=("site",))
_M_FIRED = _metrics.counter(
    "fault.fired_total", "Fault-injection firings, by site.",
    labels=("site",))


def _emit_fired_event(site: str) -> None:
    """Mirror a fault firing into the ops-plane event log, so injections
    interleave with the transitions they caused. Imported lazily: the event
    log reads the config, which may still be loading."""
    try:
        from ..ops import events as ops_events
        ops_events.event_type(
            "fault.fired",
            "A fault-injection site fired (site).").emit(site=site)
    except Exception:
        pass  # chaos telemetry must never break the injected path


class _Rule:
    """One armed schedule for one site. Budget and fire counters live in
    shared memory so fork-inherited copies (worker children) coordinate
    with the parent."""

    def __init__(self, site: str, at: Optional[int], p: Optional[float],
                 budget: int, seed: int):
        if (at is None) == (p is None):
            raise ValueError(
                f"faults.arm({site!r}): exactly one of at=/p= is required")
        if at is not None and at < 1:
            raise ValueError(f"faults.arm({site!r}): at= is 1-based")
        if p is not None and not 0.0 < p <= 1.0:
            raise ValueError(f"faults.arm({site!r}): p must be in (0, 1]")
        self.site = site
        self.at = at
        self.p = p
        # per-site deterministic stream independent of arm() order
        self.rng = random.Random(seed ^ zlib.crc32(site.encode()))
        self.budget = multiprocessing.Value("i", int(budget))
        self.fired = multiprocessing.Value("i", 0)
        self.calls = 0  # per-process (fork children count independently)

    def should_fire(self) -> bool:
        self.calls += 1
        if self.at is not None:
            if self.calls != self.at:
                return False
        elif self.rng.random() >= self.p:
            return False
        with self.budget.get_lock():
            if self.budget.value <= 0:
                return False
            self.budget.value -= 1
        with self.fired.get_lock():
            self.fired.value += 1
        _M_FIRED.labels(site=self.site).inc()
        _emit_fired_event(self.site)
        return True


_lock = threading.Lock()
_rules: Dict[str, _Rule] = {}
_plan_cache: Optional[str] = None  # last faults.plan string applied


def _parse_spec(site: str, spec: str, seed: int) -> _Rule:
    budget = 1
    if "@" in spec:
        spec, b = spec.split("@", 1)
        budget = int(b)
    if "." in spec or "e" in spec.lower():
        return _Rule(site, at=None, p=float(spec), budget=budget, seed=seed)
    return _Rule(site, at=int(spec), p=None, budget=budget, seed=seed)


def _sync_plan() -> None:
    """Apply the ``faults.plan`` config string if it changed. Programmatic
    ``arm()`` calls layer on top (and ``reset()`` clears both)."""
    global _plan_cache
    try:
        from .config import global_config
        cfg = global_config()
        plan = str(cfg.get("faults.plan") or "")
        seed = int(cfg.get("faults.seed") or 0)
    except Exception:
        return  # config layer unavailable (early import): nothing to apply
    if plan == _plan_cache:
        return
    with _lock:
        if plan == _plan_cache:
            return
        for entry in filter(None, (e.strip() for e in plan.split(","))):
            site, _, spec = entry.partition(":")
            if site not in REGISTRY:
                raise ValueError(
                    f"faults.plan names unknown site {site!r}; registered "
                    f"sites: {sorted(REGISTRY)}")
            if not spec:
                raise ValueError(f"faults.plan entry {entry!r} needs a "
                                 f"'site:spec' form")
            if site not in _rules:
                _rules[site] = _parse_spec(site, spec, seed)
                _M_ARMED.labels(site=site).inc()
                _M_FIRED.labels(site=site)  # pre-fork slot for children
        _plan_cache = plan


def arm(site: str, at: Optional[int] = None, p: Optional[float] = None,
        budget: int = 1, seed: int = 0) -> None:
    """Programmatically arm ``site``: fire on call ``at`` (1-based) or with
    per-call probability ``p``, at most ``budget`` times (shared across
    forked children)."""
    if site not in REGISTRY:
        raise ValueError(f"unknown fault site {site!r}; registered sites: "
                         f"{sorted(REGISTRY)}")
    with _lock:
        _rules[site] = _Rule(site, at=at, p=p, budget=budget, seed=seed)
    _M_ARMED.labels(site=site).inc()
    # allocate the fired-counter slot NOW, before any fork: a child firing
    # this site writes to a slot the parent's exposition already knows
    _M_FIRED.labels(site=site)


def reset() -> None:
    """Disarm every site and forget the applied plan (test teardown)."""
    global _plan_cache
    with _lock:
        _rules.clear()
        _plan_cache = None


def inject(site: str) -> bool:
    """The injection point. Returns ``False`` when the site does not fire.
    When it fires: ``raise``-kind sites raise :class:`FaultInjected`;
    ``flag``-kind sites return ``True`` and the caller performs the fault
    action itself."""
    reg = REGISTRY.get(site)
    if reg is None:
        raise ValueError(f"unknown fault site {site!r}; register it in "
                         f"analytics_zoo_tpu_torch/common/faults.py")
    _sync_plan()
    rule = _rules.get(site)
    if rule is None or not rule.should_fire():
        return False
    if reg.kind == "flag":
        return True
    raise FaultInjected(site, rule.calls)


def fire_count(site: str) -> int:
    """How many times ``site`` fired (shared across forked children)."""
    rule = _rules.get(site)
    return int(rule.fired.value) if rule is not None else 0


def armed(site: str) -> bool:
    return site in _rules


def describe() -> Dict[str, str]:
    """Site registry as ``{name: 'kind: description'}`` (docs/CLI)."""
    return {name: f"{s.kind}: {s.description}"
            for name, s in sorted(REGISTRY.items())}


def tear_snapshot(path: str) -> None:
    """Chaos helper for the ``ckpt.corrupt`` flag site: corrupt the
    published snapshot at ``path`` by bit-flipping the largest data file
    (metadata/manifest files are left alone so the tear is only caught by
    checksum verification, not by a trivial parse error)."""
    from . import file_io  # lazy: file_io imports this module

    def walk(p):
        for name in file_io.listdir(p):
            child = file_io.join(p, name)
            if file_io.isdir(child):
                yield from walk(child)
            else:
                yield child
    candidates = []
    for f in walk(path):
        base = f.rsplit("/", 1)[-1]
        if base.endswith((".json", ".txt")) or base.startswith("manifest"):
            continue
        with file_io.fopen(f, "rb") as fh:
            candidates.append((len(fh.read()), f))
    if not candidates:
        raise RuntimeError(f"no data file to tear in snapshot {path!r}")
    _, victim = max(candidates)
    with file_io.fopen(victim, "rb") as fh:
        data = bytearray(fh.read())
    mid = len(data) // 2
    data[mid] ^= 0xFF
    with file_io.fopen(victim, "wb") as fh:
        fh.write(bytes(data))
