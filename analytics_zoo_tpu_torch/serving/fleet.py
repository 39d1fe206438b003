"""Fleet tier (counterpart of ``analytics_zoo_tpu/serving/fleet.py``): a
router and admission layer over N serving instances, driven by their
health files.

- **Per-instance queues.** Each server gets its own request spool
  (:func:`instance_queue`: a FileQueue under ``<root>/inst/<name>`` whose
  results land in the FRONT spool, so clients poll one place whichever
  instance answers). Clients enqueue to the front; the router is its only
  consumer.
- **Placement by estimated completion time.** The router reads each
  instance's ``health.json`` (queue depth, in flight, EWMA service time,
  p99, ``slots_occupied``, ``kv_pages_free``) and places each request on
  the instance that would finish it first: least loaded for one-shot
  predicts, slot- and page-aware for generative joins. The scoring
  (:func:`_score_instances`) is vectorised numpy over the instance axis.
- **Shed before enqueue.** When no instance can meet a request's
  deadline the router answers ``FLEET_SHED_ERROR`` at once.
- **Continuation on failover.** A health file older than
  ``fleet.stale_after_s`` (or a terminal state) marks an instance dead: its
  unstarted spool is reclaimed, and every stream assigned to it is
  re-enqueued with the token ``prefix`` (and sampling ``seed``) of its last
  partial. The adopting server prefills ``prompt + prefix`` through the
  bucketed prefill serial ``generate`` runs and goes on token for token
  (``GenerativeServing._join``).
- **Scale signals.** ``fleet.instances_alive`` and
  ``fleet.desired_instances`` give an autoscaler (``cluster.supervisor.
  FleetSupervisor``) the observed and wanted fleet size.
- **Circuit breakers.** An error streak, or an EWMA service time past
  ``fleet.breaker_latency_ratio`` times the fleet median, trips an
  instance's :class:`_Breaker` open; after ``fleet.breaker_cooldown_s`` it
  admits one probe, whose clean terminal closes it. The ``fleet.breaker``
  fault trips one on demand. With no instance placeable the router parks
  work and counts ``fleet.no_capacity_total``; it never raises.

The router never holds the only copy of a request: a claimed request
lives in the backlog, an instance spool or the failover map until its one
terminal lands (the ``fleet.route`` fault parks a placement in the
backlog). The router is host code: it holds no tensor.
"""
from __future__ import annotations

import json
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..common import faults, file_io
from ..common import metrics as _metrics
from ..common.config import global_config
from ..common.utils import wall_clock
from ..ops import events as ops_events
from .queues import FileQueue, QueueBackend
from .server import DEADLINE_ERROR

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

#: terminal error text for router-level admission shed (clients match it)
FLEET_SHED_ERROR = "shed: no instance can meet the deadline"

#: states a router may place NEW work on (idle = constructed, stepped
#: manually or not yet started — still claims from its spool)
_ROUTABLE_STATES = ("running", "idle")
#: terminal states: the instance will never claim again — reclaim its
#: spool and fail its streams over immediately, don't wait for staleness
_DEAD_STATES = ("crashed", "stopped", "drained")

_M_ROUTED = _metrics.counter(
    "fleet.routed_total", "Requests placed on an instance by the router.",
    labels=("instance",))
_M_SHED = _metrics.counter(
    "fleet.shed_total",
    "Requests shed by the router before enqueue (no instance could meet "
    "the deadline).")
_M_EXPIRED = _metrics.counter(
    "fleet.expired_total",
    "Requests already past their deadline at routing time.")
_M_FAILOVERS = _metrics.counter(
    "fleet.failovers_total",
    "Streams re-enqueued with their token prefix after their instance "
    "died or drained.")
_M_ALIVE = _metrics.gauge(
    "fleet.instances_alive",
    "Instances with a fresh health file in a routable state.")
_M_DESIRED = _metrics.gauge(
    "fleet.desired_instances",
    "Scale signal: instances needed for observed demand x headroom.")
_M_BACKLOG = _metrics.gauge(
    "fleet.backlog_depth",
    "Requests parked in the router awaiting a routable instance.")
_M_ROUTE_PASS = _metrics.histogram(
    "fleet.route_pass_seconds", "Wall seconds per route_once() pass.")
_M_NO_CAPACITY = _metrics.counter(
    "fleet.no_capacity_total",
    "Requests parked in the backlog because no instance was placeable "
    "(all breakers open / health files missing).")
_M_BREAKER = _metrics.gauge(
    "fleet.breaker_state",
    "Per-instance circuit breaker state: 0=closed, 1=open, 2=half-open.",
    labels=("instance",))

#: breaker states (gauge values)
BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN = 0, 1, 2

_BREAKER_STATE_NAMES = {BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                        BREAKER_HALF_OPEN: "half_open"}

_E_BREAKER = ops_events.event_type(
    "fleet.breaker",
    "Per-instance circuit breaker transition (state_from/state, "
    "reason=errors|latency|probe_ok|probe_fail|forced|cooldown).")


class _Breaker:
    """Per-instance circuit breaker (closed -> open -> half-open ->
    closed). Trip inputs are *settled* terminals (recorded by the
    router's ``_settle`` pass) and the latency ratio check in
    ``_refresh``; while OPEN the instance receives no placements at all,
    and HALF-OPEN admits exactly one probe request."""

    def __init__(self, failures: int, latency_ratio: float,
                 cooldown_s: float, name: str = ""):
        self.failures = int(failures)
        self.latency_ratio = float(latency_ratio)
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self.state = BREAKER_CLOSED
        self._error_streak = 0
        self._slow_streak = 0
        self._opened_at = 0.0
        self._probe_uri: Optional[str] = None

    def _transition(self, state: int, reason: str) -> None:
        """Move the state machine, emitting one ``fleet.breaker`` event
        per actual change (re-tripping an already-open breaker is not a
        transition)."""
        if state == self.state:
            return
        prev = self.state
        self.state = state
        _E_BREAKER.emit(label=self.name,
                        state=_BREAKER_STATE_NAMES[state],
                        state_from=_BREAKER_STATE_NAMES[prev],
                        reason=reason)

    def record_result(self, uri: str, is_error: bool, now: float) -> None:
        """Feed one settled terminal. In HALF-OPEN only the probe's
        terminal moves the state machine; a clean probe closes the
        breaker, a failed probe re-opens it for another cooldown."""
        if self.state == BREAKER_HALF_OPEN:
            if uri != self._probe_uri:
                return
            self._probe_uri = None
            if is_error:
                self.trip(now, reason="probe_fail")
            else:
                self._error_streak = self._slow_streak = 0
                self._transition(BREAKER_CLOSED, "probe_ok")
            return
        if is_error:
            self._error_streak += 1
            if self._error_streak >= self.failures:
                self.trip(now, reason="errors")
        else:
            self._error_streak = 0

    def record_latency(self, service_s: float, fleet_median_s: float,
                       now: float) -> None:
        """Feed one health refresh: an EWMA persistently above
        ``latency_ratio`` x the fleet median trips the breaker even when
        the instance is still answering (slow is the new down)."""
        if self.state != BREAKER_CLOSED:
            return
        if (fleet_median_s > 0.0
                and service_s > self.latency_ratio * fleet_median_s):
            self._slow_streak += 1
            if self._slow_streak >= self.failures:
                self.trip(now, reason="latency")
        else:
            self._slow_streak = 0

    def trip(self, now: float, reason: str = "forced") -> None:
        """Force-open the breaker (also the entry point for the
        ``fleet.breaker`` flag fault)."""
        self._opened_at = now
        self._error_streak = self._slow_streak = 0
        self._probe_uri = None
        self._transition(BREAKER_OPEN, reason)

    def placeable(self, now: float) -> bool:
        """May the router place a request here? OPEN breakers move to
        HALF-OPEN once the cooldown elapses; HALF-OPEN admits only while
        no probe is outstanding."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_OPEN:
            if now - self._opened_at >= self.cooldown_s:
                self._probe_uri = None
                self._transition(BREAKER_HALF_OPEN, "cooldown")
                return True
            return False
        return self._probe_uri is None  # half-open: one probe at a time

    def note_placed(self, uri: str) -> None:
        """A placement landed on this instance; in HALF-OPEN it becomes
        the probe whose terminal decides the breaker's fate."""
        if self.state == BREAKER_HALF_OPEN and self._probe_uri is None:
            self._probe_uri = uri


def read_health(path: str, now: Optional[float] = None) -> Optional[Dict]:
    """Read an instance's ``health.json`` and stamp its **age**: the
    snapshot's gauges froze at ``snap['time']``, so consumers must not
    trust them without knowing how stale they are. Returns the snapshot
    with ``health_age_s`` added, or ``None`` when the file is missing or
    unreadable (an instance that never came up)."""
    try:
        with file_io.fopen(path) as f:
            snap = json.loads(f.read())
    except (OSError, ValueError, FileNotFoundError):
        return None
    if not isinstance(snap, dict) or "time" not in snap:
        return None
    t = now if now is not None else wall_clock()
    snap["health_age_s"] = max(0.0, t - float(snap["time"]))
    return snap


def instance_queue(root: str, name: str) -> FileQueue:
    """A per-instance request spool under the fleet front spool: requests
    at ``<root>/inst/<name>``, results shared with the front's
    ``results/`` so placement stays invisible to clients."""
    return FileQueue(file_io.join(root, "inst", name), results_root=root)


@dataclass
class FleetInstance:
    """One routable serving instance: its private queue, the health file
    its server writes, and its slot count (decode slots for generative
    servers, concurrent batch capacity for one-shot predict servers)."""
    name: str
    queue: QueueBackend
    health_path: str
    slots: int = 1
    #: latest health snapshot (with health_age_s), None before first read
    health: Optional[Dict[str, Any]] = field(default=None, repr=False)


def _score_instances(alive, depth, in_flight, slots_free, pages_free,
                     service_s, token_s, need_tokens, need_pages):
    """Estimated completion seconds per instance for ONE request,
    vectorised over the instance axis (no Python loop over instances).
    ``np.inf`` marks an instance the request must not be placed on.

    One-shot predicts (``need_tokens == 0``) queue behind the backlog at
    the instance's EWMA service time. Generative joins wait for a free
    slot (when none is free, a resident stream must run out first — the
    backlog-scaled slot wait), then stream the remaining budget at the
    instance's per-token EWMA; an instance whose free KV pages cannot hold
    the stream yet pays a retirement-wait penalty per missing page."""
    backlog = depth + in_flight
    one_shot = (backlog + 1.0) * service_s
    slot_wait = np.where(slots_free > 0.5, 0.0,
                         (backlog + 1.0) * need_tokens * token_s)
    gen = slot_wait + need_tokens * token_s
    est = np.where(need_tokens > 0.5, gen, one_shot)
    page_short = np.maximum(need_pages - np.maximum(pages_free, 0.0), 0.0)
    est = est + np.where((pages_free > -0.5) & (need_pages > 0.5),
                         page_short * token_s * 4.0, 0.0)
    return np.where(alive, est, np.inf)


class FleetRouter:
    """Route requests from a FRONT queue onto per-instance queues by
    estimated completion time; reclaim and fail over the work of dead
    instances; emit scale signals. Drive with :meth:`route_once` (tests)
    or :meth:`start`/:meth:`stop` (a background thread)."""

    def __init__(self, front: QueueBackend,
                 instances: List[FleetInstance], *,
                 stale_after_s: Optional[float] = None,
                 health_refresh_s: Optional[float] = None,
                 scale_headroom: Optional[float] = None,
                 default_deadline_ms: Optional[float] = None,
                 default_max_new_tokens: int = 32,
                 default_service_s: float = 0.05,
                 default_token_s: float = 0.02,
                 page_len: int = 0,
                 settle_batch: int = 128):
        cfg = global_config()
        self.front = front
        self.instances = list(instances)
        self.stale_after_s = (float(stale_after_s) if stale_after_s
                              is not None
                              else float(cfg.get("fleet.stale_after_s")))
        self.health_refresh_s = (
            float(health_refresh_s) if health_refresh_s is not None
            else float(cfg.get("fleet.health_refresh_s")))
        self.scale_headroom = (
            float(scale_headroom) if scale_headroom is not None
            else float(cfg.get("fleet.scale_headroom")))
        self.default_deadline_ms = default_deadline_ms
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.default_service_s = float(default_service_s)
        self.default_token_s = float(default_token_s)
        self.page_len = int(page_len)
        self.settle_batch = int(settle_batch)
        self._breaker_failures = int(cfg.get("fleet.breaker_failures"))
        self._breaker_latency_ratio = float(
            cfg.get("fleet.breaker_latency_ratio"))
        self._breaker_cooldown_s = float(
            cfg.get("fleet.breaker_cooldown_s"))
        #: name -> circuit breaker, created lazily on first refresh
        self._breakers: Dict[str, _Breaker] = {}
        #: uri -> {"instance": name, "rec": original request} for every
        #: request placed and not yet seen terminal — the failover map
        self._assigned: Dict[str, Dict[str, Any]] = {}
        #: requests the router holds but could not place yet (fault, all
        #: instances dead, ...) — retried every pass, never dropped
        self._backlog: List[Tuple[str, Dict[str, Any]]] = []
        self._g: Optional[Dict[str, np.ndarray]] = None
        self._last_refresh = -1e18
        self._desired = 0
        self._settle_cursor = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- telemetry ---------------------------------------------------------

    def _breaker(self, name: str) -> _Breaker:
        br = self._breakers.get(name)
        if br is None:
            br = self._breakers[name] = _Breaker(
                self._breaker_failures, self._breaker_latency_ratio,
                self._breaker_cooldown_s, name=name)
        return br

    def _refresh(self, now: float) -> None:
        """Re-read every instance's health file and rebuild the placement
        gauge arrays. ``dead`` instances additionally get their spool
        reclaimed and their assigned streams failed over."""
        n = len(self.instances)
        alive = np.zeros(n, bool)
        dead = np.zeros(n, bool)
        depth = np.zeros(n)
        in_flight = np.zeros(n)
        slots_free = np.zeros(n)
        pages_free = np.full(n, -1.0)
        service_s = np.full(n, self.default_service_s)
        token_s = np.full(n, self.default_token_s)
        for i, inst in enumerate(self.instances):
            snap = read_health(inst.health_path, now=now)
            inst.health = snap
            if snap is None or snap["health_age_s"] > self.stale_after_s \
                    or snap.get("state") in _DEAD_STATES:
                dead[i] = True
                continue
            if snap.get("state") not in _ROUTABLE_STATES:
                continue  # draining: not dead, not routable
            alive[i] = True
            depth[i] = snap.get("queue_pending") or 0
            in_flight[i] = snap.get("in_flight") or 0
            occupied = snap.get("slots_occupied")
            if occupied is not None:
                slots_free[i] = max(0, (snap.get("slots") or inst.slots)
                                    - occupied)
            else:
                slots_free[i] = max(0, inst.slots - in_flight[i])
            kv = snap.get("kv_pages_free")
            if kv is not None:
                # sharded pools: capacity is bounded by the emptiest page
                # shard (the round-robin allocator stalls on a full shard
                # even when the pool-wide free count looks ample), so the
                # effective free count is min_shard x shards
                min_shard = snap.get("kv_pages_free_min_shard")
                shards = snap.get("kv_shards") or 1
                if min_shard is not None and shards > 1:
                    kv = min_shard * shards
                pages_free[i] = kv
            ewma = snap.get("service_time_s_ewma")
            p99 = (snap.get("latency_ms") or {}).get("p99")
            if ewma:
                service_s[i] = ewma
            elif p99:
                service_s[i] = p99 / 1e3
            tps = snap.get("tokens_per_sec_ewma")
            if tps:
                token_s[i] = 1.0 / tps
        # circuit breakers: latency-ratio trip against the fleet median,
        # the fleet.breaker flag fault, then mask placement. A breaker
        # opening on a *live* instance must NOT fail its streams over —
        # it is still answering, just not receiving new work.
        med = (float(np.median(service_s[alive]))
               if bool(alive.any()) else 0.0)
        for i, inst in enumerate(self.instances):
            br = self._breaker(inst.name)
            # chaos site (flag kind): force-open this instance's breaker
            # (arm with budget=N to trip the first N instances refreshed)
            if faults.inject("fleet.breaker"):
                br.trip(now)
            if alive[i]:
                br.record_latency(float(service_s[i]), med, now)
                alive[i] = br.placeable(now)
            _M_BREAKER.labels(instance=inst.name).set(br.state)
        self._g = {"alive": alive, "dead": dead, "depth": depth,
                   "in_flight": in_flight, "slots_free": slots_free,
                   "pages_free": pages_free, "service_s": service_s,
                   "token_s": token_s}
        _M_ALIVE.set(int(alive.sum()))
        for i in np.flatnonzero(dead):
            inst = self.instances[i]
            self._reclaim_dead(inst, handed_off=(
                inst.health is not None
                and inst.health.get("state") == "drained"))

    # -- failover ----------------------------------------------------------

    def _reclaim_dead(self, inst: FleetInstance,
                      handed_off: bool = False) -> None:
        """Sweep a dead instance: pull its UNSTARTED spool entries back
        into the router backlog, and fail over every stream assigned to
        it — from its accumulated prefix when a partial result exists,
        from scratch otherwise. A terminal that already landed settles
        the request instead (the instance died after answering).

        ``handed_off``: the instance ended ``drained``, so every request
        it claimed has its terminal or was re-enqueued on the front by
        ``handoff`` (before the state was written), and that copy is
        placed like any front request. Its assignments are dropped, not
        failed over: a second copy would post a second terminal."""
        try:
            stolen = inst.queue.claim_batch(1 << 16)
        except Exception:
            logger.exception("reclaiming %s's spool failed", inst.name)
            stolen = []
        for uri, rec in stolen:
            self._assigned.pop(uri, None)
            self._backlog.append((uri, rec))
        orphans = [u for u, a in self._assigned.items()
                   if a["instance"] == inst.name]
        for uri in orphans:
            entry = self._assigned.pop(uri)
            if handed_off:
                continue
            try:
                res = self.front.get_result(uri)
            except Exception:
                res = None
            if res is not None and ("error" in res or "value" in res):
                continue  # answered before dying: settled
            rec = dict(entry["rec"])
            if res is not None and res.get("stream"):
                # mid-stream death: carry the decoded prefix (and the
                # sampling seed the partial exported) so the adopter
                # continues token-identically instead of restarting
                rec["prefix"] = [int(x) for x in res["stream"]]
                if res.get("seed") is not None:
                    rec["seed"] = int(res["seed"])
                _M_FAILOVERS.inc()
                logger.warning(
                    "failing over %s from %s with a %d-token prefix",
                    uri, inst.name, len(rec["prefix"]))
            self._backlog.append((uri, rec))

    def _settle(self) -> None:
        """Drop assigned entries whose terminal result has landed — a
        bounded round-robin slice per pass so a large in-flight set never
        stalls routing."""
        uris = list(self._assigned)
        if not uris:
            return
        now = wall_clock()
        start = self._settle_cursor % len(uris)
        for uri in (uris[start:start + self.settle_batch]
                    or uris[:self.settle_batch]):
            try:
                res = self.front.get_result(uri)
            except Exception:
                continue
            if res is not None and ("error" in res or "value" in res):
                entry = self._assigned.pop(uri, None)
                if entry is not None:
                    # every settled terminal feeds the instance's
                    # breaker: error streaks trip it, and a half-open
                    # probe's terminal decides whether it closes
                    self._breaker(entry["instance"]).record_result(
                        uri, "error" in res, now)
        self._settle_cursor = start + self.settle_batch

    # -- placement ---------------------------------------------------------

    def _place(self, uri: str, rec: Dict[str, Any], now: float) -> bool:
        """Route one request. True = handled (placed, shed, or expired);
        False = park it in the backlog for the next pass."""
        try:
            # chaos site: a flaky placement (queue hiccup, torn health
            # read) must PARK the request, never lose or double-place it
            faults.inject("fleet.route")
        except faults.FaultInjected:
            return False
        deadline_ms = rec.get("deadline_ms") or self.default_deadline_ms
        enq = float(rec.get("enqueue_t") or now)
        remain = (enq + float(deadline_ms) / 1e3 - now
                  if deadline_ms else None)
        if remain is not None and remain <= 0:
            self.front.put_result(
                uri, {"error": DEADLINE_ERROR, "retriable": False})
            _M_EXPIRED.inc()
            return True
        g = self._g
        if g is None or not bool(g["alive"].any()):
            # zero placeable instances (all breakers open, every health
            # file missing/stale, or an empty fleet): park, never raise.
            # The backlog is retried every pass, so the first half-open
            # probe success re-places this work.
            _M_NO_CAPACITY.inc()
            return False
        prompt = rec.get("prompt")
        if prompt:
            budget = int(rec.get("max_new_tokens")
                         or self.default_max_new_tokens)
            need_tokens = max(1, budget - len(rec.get("prefix") or []))
            need_pages = (math.ceil((len(prompt) + budget) / self.page_len)
                          if self.page_len > 0 else 0)
        else:
            need_tokens = 0
            need_pages = 0
        est = _score_instances(
            g["alive"], g["depth"], g["in_flight"], g["slots_free"],
            g["pages_free"], g["service_s"], g["token_s"],
            np.float64(need_tokens), np.float64(need_pages))
        while True:
            best = int(np.argmin(est))
            if not np.isfinite(est[best]):
                # every candidate got masked mid-pass (half-open probes
                # already outstanding): same no-capacity park as above
                _M_NO_CAPACITY.inc()
                return False
            inst = self.instances[best]
            if self._breaker(inst.name).placeable(now):
                break
            # a half-open instance admits exactly ONE probe per cooldown;
            # once this pass placed it, later requests must look elsewhere
            est[best] = np.inf
            g["alive"][best] = False
        if remain is not None and float(est[best]) > remain:
            # admission control: answer NOW instead of queueing work no
            # instance can finish in time — shed is retriable (capacity
            # may free up), unlike a blown deadline
            self.front.put_result(
                uri, {"error": FLEET_SHED_ERROR, "retriable": True})
            _M_SHED.inc()
            return True
        try:
            inst.queue.enqueue(uri, rec)
        except Exception:
            logger.exception("enqueue to %s failed", inst.name)
            return False
        self._assigned[uri] = {"instance": inst.name, "rec": rec}
        self._breaker(inst.name).note_placed(uri)
        # optimistic gauge bump: later placements in this same pass see
        # the queued work without waiting for the next health refresh
        g["depth"][best] += 1.0
        if need_tokens:
            g["slots_free"][best] = max(0.0, g["slots_free"][best] - 1.0)
        _M_ROUTED.labels(instance=inst.name).inc()
        return True

    def route_once(self, max_items: int = 64) -> int:
        """One router pass: refresh telemetry (cadenced), fail over dead
        instances, settle finished work, then place the backlog plus a
        fresh batch from the front queue. Returns requests placed."""
        t0 = time.perf_counter()
        now = wall_clock()
        if now - self._last_refresh >= self.health_refresh_s:
            self._last_refresh = now
            self._refresh(now)
        self._settle()
        work, self._backlog = self._backlog, []
        try:
            work.extend(self.front.claim_batch(max_items))
        except Exception:
            logger.exception("front claim failed (transient)")
        placed = 0
        for uri, rec in work:
            if self._place(uri, rec, now):
                placed += 1
            else:
                self._backlog.append((uri, rec))
        self._scale_signals()
        _M_ROUTE_PASS.observe(time.perf_counter() - t0)
        return placed

    def _scale_signals(self) -> None:
        """Demand-derived autoscale gauges: an operator (or test) watches
        ``fleet.desired_instances`` against ``fleet.instances_alive`` to
        decide scale-out/in; headroom keeps failover capacity spare."""
        _M_BACKLOG.set(len(self._backlog))
        g = self._g
        demand = len(self._backlog) + len(self._assigned)
        if g is not None:
            demand += int(g["depth"].sum() + g["in_flight"].sum())
        per = max(1.0, float(np.mean([i.slots for i in self.instances]))
                  if self.instances else 1.0)
        self._desired = (int(math.ceil(self.scale_headroom * demand / per))
                         if demand else 0)
        _M_DESIRED.set(self._desired)

    def desired_instances(self) -> int:
        """Latest demand-derived target fleet size (the value behind the
        ``fleet.desired_instances`` gauge) — what an actuator
        (:class:`~analytics_zoo_tpu_torch.cluster.supervisor.FleetSupervisor`)
        reconciles the live fleet against."""
        return self._desired

    def register_instance(self, inst: FleetInstance) -> None:
        """Add a freshly spawned instance to the routable set and force a
        health re-read on the next pass (the actuator's scale-out hook)."""
        self.instances.append(inst)
        self._last_refresh = -1e18

    def remove_instance(self, name: str) -> None:
        """Forget a drained/dead instance after its spool was reclaimed.
        The actuator calls this once the server subprocess has exited; any
        work still assigned to the name fails over on the next refresh."""
        self.instances = [i for i in self.instances if i.name != name]
        self._breakers.pop(name, None)
        self._g = None
        self._last_refresh = -1e18

    # -- lifecycle ---------------------------------------------------------

    def run(self, poll_interval_s: float = 0.01) -> None:
        logger.info("fleet router started (%d instances)",
                    len(self.instances))
        while not self._stop.is_set():
            if self.route_once() == 0:
                time.sleep(poll_interval_s)

    def start(self) -> "FleetRouter":
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop routing. Backlogged requests are returned to the FRONT
        queue so a successor router (or a direct consumer) finds them —
        the router never takes work to its grave."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for uri, rec in self._backlog:
            try:
                self.front.enqueue(uri, rec)
            except Exception:
                logger.exception("returning %s to the front failed", uri)
        self._backlog = []

    def breaker_states(self) -> Dict[str, int]:
        """Per-instance breaker state (the values behind the
        ``fleet.breaker_state`` gauge): 0=closed, 1=open, 2=half-open."""
        return {name: br.state for name, br in self._breakers.items()}

    @property
    def stats(self) -> Dict[str, int]:
        return {"assigned": len(self._assigned),
                "backlog": len(self._backlog)}
