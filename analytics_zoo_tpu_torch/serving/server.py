"""One-shot serving engine (counterpart of ``ClusterServing`` in
``analytics_zoo_tpu/serving/server.py``): claim a micro-batch from the
queue -> drop expired records -> decode on host threads -> drop records
that expired meanwhile -> dispatch to the card -> write results back.

A record is a ``tensor`` (float32 always) or an ``image``: a base64 jpg,
decoded by ``cv2.imdecode`` (BGR), resized to ``image_shape`` when its size
differs, and kept uint8 or made float32 by ``input_dtype``. On the uint8
wire the batch reaches the card as uint8, a quarter of float32's bytes,
and the model normalizes it there.

The invariant is the JAX package's: **every claimed request receives
exactly one terminal result**, a value or an explicit error, whatever
fails. Deadlines are checked at claim, after decode and before dispatch;
overload sheds with explicit errors and drives the brownout ladder;
:meth:`ClusterServing.drain` finishes in-flight work before it stops;
:meth:`ClusterServing.reload_model` swaps the model off the serve path with
a canary and rolls back on any failure.

Both servers report into the platform substrate: the metrics registry
(``common/metrics.py``, the JAX package's family names, labels and help
text, one ``server`` label an instance), the ops-plane event log
(``ops/events.py``), the fault-injection sites (``common/faults.py``) and
the phase profiler (``common/profiler.py``). ``health_snapshot()`` is a
per-instance view of the registry; with ``config.health_path`` the servers
write it as ``health.json`` on a cadence, and the registry's Prometheus
text as ``metrics.prom`` beside it.

:class:`GenerativeServing` serves ``TransformerLM`` streams by
continuous batching under the same invariant, over slot caches or a paged
KV pool, with speculative rounds when given a draft model.

Both stamp each request's flow chain (``utils/trace.py``: claim, decode,
dispatch, result) while a trace session is active, start the process's
ops plane (``ops.alerts.ensure_default``, a no-op unless ``ops.enabled``)
and report its active alerts and last sealed incident in ``health.json``.
TensorBoard summaries are a later slice (ROADMAP Queue A item 5c).
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import faults, file_io
from ..common import metrics as _metrics
from ..common import profiler as _profiler
from ..common.config import global_config
from ..common.context import DeviceLike
from ..common.utils import time_it, wall_clock
from ..inference.inference_model import InferenceModel
from ..ops import alerts as ops_alerts
from ..ops import decode as _decode
from ..ops import events as ops_events
from ..ops import incident as ops_incident
from ..utils import trace as _trace
from .config import ServingConfig
from .queues import QueueBackend, decode_image, make_queue

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

#: canonical terminal error texts (clients match on these)
SHED_ERROR = "shed: queue overloaded"
PAGE_SHED_ERROR = "shed: kv page pool exhausted"
DEADLINE_ERROR = "deadline exceeded"
SHUTDOWN_ERROR = "serving shut down before this request completed"

#: SLO telemetry in the registry, the JAX package's families. Every family
#: is labeled by server instance, so two servers in one process keep
#: separate series; ``health_snapshot()`` is a per-instance view of these.
_M_COUNTERS = {
    "shed": _metrics.counter(
        "serving.shed_total", "Requests shed by admission control.",
        labels=("server",)),
    "expired": _metrics.counter(
        "serving.expired_total", "Requests answered with deadline errors.",
        labels=("server",)),
    "errors": _metrics.counter(
        "serving.error_total",
        "Requests answered with non-deadline error results.",
        labels=("server",)),
    "claim_faults": _metrics.counter(
        "serving.claim_fault_total", "Transient claim-stage failures.",
        labels=("server",)),
    "reloads": _metrics.counter(
        "serving.reload_total", "Successful hot model reloads.",
        labels=("server",)),
    "reload_failures": _metrics.counter(
        "serving.reload_failure_total",
        "Model reloads that failed and rolled back.", labels=("server",)),
}
#: the keys of the servers' ``counters`` view (the reload counts are in
#: ``health_snapshot()["counters"]``)
_SLO_KEYS = ("shed", "expired", "errors", "claim_faults")
_M_RECORDS = _metrics.counter(
    "serving.records_total", "Records answered with prediction values.",
    labels=("server",))
_M_LATENCY = _metrics.histogram(
    "serving.request_latency_seconds",
    "Enqueue-to-terminal-result latency (client-stamped enqueue_t).",
    labels=("server",))
_M_QUEUE_DEPTH = _metrics.gauge(
    "serving.queue_depth", "Pending requests in the claim queue.",
    labels=("server",))
_M_IN_FLIGHT = _metrics.gauge(
    "serving.in_flight", "Claimed requests without a terminal result yet.",
    labels=("server",))
_M_CLAIM_AGE = _metrics.gauge(
    "serving.claim_age_seconds", "Seconds since the last successful claim.",
    labels=("server",))
#: generative (continuous-batching) serving telemetry
_M_TTFT = _metrics.histogram(
    "serving.ttft_seconds",
    "Enqueue-to-first-token latency of generative streams.",
    labels=("server",))
_M_TOKENS = _metrics.counter(
    "serving.tokens_total",
    "Tokens decoded across all generative streams.", labels=("server",))
_M_SLOTS = _metrics.gauge(
    "serving.slots_occupied",
    "Decode slots currently holding an active stream.", labels=("server",))
#: paged KV engine + speculative decoding telemetry
_M_PAGES_FREE = _metrics.gauge(
    "serving.kv_pages_free",
    "Allocatable pages remaining in the paged KV pool (0 = joins shed).",
    labels=("server",))
_M_PAGE_EVICT = _metrics.counter(
    "serving.kv_page_evictions_total",
    "KV pages returned to the pool by stream retirement.",
    labels=("server",))
_M_SPEC_ACCEPT = _metrics.gauge(
    "serving.spec_accept_ratio",
    "Mean fraction of draft tokens accepted in the last verify round.",
    labels=("server",))
_M_BROWNOUT = _metrics.gauge(
    "serving.brownout_level",
    "Current brownout degradation rung: 0=normal, 1=coarse streaming/wide "
    "batch window, 2=half token budget, 3=quarter token budget "
    "(docs/serving.md 'Overload survival').", labels=("server",))

_instance_ids = itertools.count()

#: ops-plane event types, one event a state transition
_E_BROWNOUT = ops_events.event_type(
    "serving.brownout_rung",
    "Brownout ladder rung change (level_from/level_to, pressure).")
_E_SHED = ops_events.event_type(
    "serving.shed",
    "Admission control shed the oldest requests (count, allowed depth).")
_E_RELOAD = ops_events.event_type(
    "serving.reload",
    "Hot model reload landed (ok=true, version) or rolled back "
    "(ok=false).")
_E_LIFECYCLE = ops_events.event_type(
    "serving.lifecycle",
    "Server reached a terminal lifecycle state "
    "(state=drained|stopped|crashed).")


class _Brownout:
    """Hysteretic brownout ladder, ticked on the shed cadence with the
    server's pressure: queue fill against the shed-allowed depth, and KV
    page scarcity for a paged generative server. ``tick(pressure)`` steps
    DOWN one rung whenever pressure exceeds ``serving.brownout_high`` and
    back UP one rung only after ``serving.brownout_hold_ticks`` ticks in a
    row below ``serving.brownout_low``: degrade fast, recover cautiously.

    The rungs trade answer quality for answer existence:

    - **L1** coarsens stream partials (4x ``stream_interval``) and widens
      the one-shot micro-batch window (2x ``batch_wait_ms``);
    - **L2** also caps new streams' ``max_new_tokens`` at 2 x
      ``serving.brownout_token_frac`` of the budget and widens the window
      to 4x;
    - **L3** tightens the cap to ``serving.brownout_token_frac``.

    Speculative depth and the int8 pool are fixed when a server is built:
    an operator applies them by config and a rolling restart, not live."""

    MAX_LEVEL = 3
    #: batch-window multiplier a rung (one-shot micro-batching)
    _WINDOW = (1, 2, 4, 4)
    #: stream-partial stride multiplier a rung (generative)
    _STRIDE = (1, 4, 4, 4)

    def __init__(self, label: str = ""):
        cfg = global_config()
        self.high = float(cfg.get("serving.brownout_high"))
        self.low = float(cfg.get("serving.brownout_low"))
        self.hold_ticks = int(cfg.get("serving.brownout_hold_ticks"))
        self.token_frac = float(cfg.get("serving.brownout_token_frac"))
        self.label = label
        self.level = 0
        self._calm = 0

    def tick(self, pressure: float) -> int:
        prev = self.level
        if pressure > self.high:
            self._calm = 0
            if self.level < self.MAX_LEVEL:
                self.level += 1
        elif pressure < self.low:
            self._calm += 1
            if self._calm >= self.hold_ticks and self.level > 0:
                self.level -= 1
                self._calm = 0
        else:
            self._calm = 0
        if self.level != prev:
            _E_BROWNOUT.emit(label=self.label, level_from=prev,
                             level_to=self.level,
                             pressure=round(float(pressure), 4))
        return self.level

    def token_cap(self, budget: int) -> int:
        """Effective per-stream token budget at the current rung."""
        if self.level < 2:
            return budget
        frac = self.token_frac * (2.0 if self.level == 2 else 1.0)
        return max(1, min(budget, int(round(budget * frac))))

    def batch_window_ms(self, base_ms: float) -> float:
        return base_ms * self._WINDOW[self.level]

    def stream_stride(self, base: int) -> int:
        return base * self._STRIDE[self.level] if base > 0 else base


def _model_version_of(path: Optional[str]) -> str:
    """Version label for a servable path: its basename (snapshot export
    dirs are named by version), or ``inline-0`` for a model handed over as
    a live object."""
    base = os.path.basename(str(path or "").rstrip("/"))
    return base or "inline-0"


class ModelReloadError(RuntimeError):
    """``reload_model`` failed; the PREVIOUS model is still serving."""


def top_n(probs: np.ndarray, n: int) -> List[Dict[str, float]]:
    """Per-record topN (class, prob) filter."""
    idx = np.argsort(-probs)[:n]
    return [{"class": int(i), "prob": float(probs[i])} for i in idx]


class _ServerTelemetry:
    """What both servers share: the registry children of one instance,
    the exactly-one-terminal accounting, and the ``health.json`` and
    ``metrics.prom`` writer."""

    def _init_telemetry(self) -> None:
        self.metrics_label = f"srv{next(_instance_ids)}"
        label = self.metrics_label
        self._m = {key: fam.labels(server=label)
                   for key, fam in _M_COUNTERS.items()}
        self._m_records = _M_RECORDS.labels(server=label)
        self._m_latency = _M_LATENCY.labels(server=label)
        self._m_depth = _M_QUEUE_DEPTH.labels(server=label)
        self._m_in_flight = _M_IN_FLIGHT.labels(server=label)
        self._m_claim_age = _M_CLAIM_AGE.labels(server=label)
        self._m_brownout = _M_BROWNOUT.labels(server=label)
        self._brownout = _Brownout(label)
        self._lock = threading.Lock()
        self._in_flight = 0  # claimed, no terminal result yet
        # uri -> (client enqueue_t, trace_id)
        self._meta: Dict[str, Tuple[float, Optional[int]]] = {}
        self._last_claim_m: Optional[float] = None  # monotonic
        self._last_health_m = -1e18
        self._last_shed_m = -1e18
        self._claim_fail_streak = 0
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loop_running = False
        self._background_error: Optional[BaseException] = None
        self.terminal_state: Optional[str] = None

    @property
    def counters(self) -> Dict[str, int]:
        """The SLO counters of this instance, from the registry."""
        return {key: int(self._m[key].value()) for key in _SLO_KEYS}

    def _count(self, key: str, n: int = 1) -> None:
        self._m[key].inc(n)
        if key in ("shed", "expired"):
            # the first SLO breach can arm a capture window
            # (profile.capture_on_breach); a no-op otherwise
            _profiler.on_slo_breach(key)

    def _expiry(self, rec: Dict[str, Any]) -> Optional[float]:
        """Absolute wall-clock expiry, or None. Wall clock on purpose: the
        client stamps ``enqueue_t`` in another process."""
        deadline_ms = rec.get("deadline_ms") or self.config.default_deadline_ms
        if not deadline_ms:
            return None
        t0 = rec.get("enqueue_t")
        base = float(t0) if t0 is not None else wall_clock()
        return base + float(deadline_ms) / 1000.0

    def _note_claimed(self, got) -> None:
        """In-flight accounting for freshly claimed requests, and their
        ``serving.claim`` flow points."""
        self._last_claim_m = time.monotonic()
        now = wall_clock()
        with self._lock:
            self._in_flight += len(got)
            in_flight = self._in_flight
            for uri, rec in got:
                self._meta[uri] = (float(rec.get("enqueue_t") or now),
                                   rec.get("trace_id"))
        self._m_in_flight.set(in_flight)
        if _trace.tracing():
            for uri, rec in got:
                _trace.flow_point(rec.get("trace_id"), "serving.claim", "t")

    def _flow_uris(self, uris: List[str], stage: str) -> None:
        """One flow point a uri (a no-op unless a trace session is
        active)."""
        if not _trace.tracing():
            return
        with self._lock:
            ids = [self._meta.get(u, (0.0, None))[1] for u in uris]
        for flow_id in ids:
            _trace.flow_point(flow_id, stage, "t")

    def _post_terminal(self, uri: str, value: Dict[str, Any]) -> None:
        """The one place a claimed request gets its terminal result (a
        generative stream's partials do not come here). Error results
        carry ``retriable``: only shed errors are."""
        if "error" in value and "retriable" not in value:
            value = dict(value)
            value["retriable"] = value["error"] in (SHED_ERROR,
                                                    PAGE_SHED_ERROR)
        try:
            self.queue.put_result(uri, value)
        except OSError:
            logger.exception("posting result for %s failed", uri)
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
            in_flight = self._in_flight
            meta = self._meta.pop(uri, None)
        self._m_in_flight.set(in_flight)
        if meta is not None:
            t0, flow_id = meta
            self._m_latency.observe(max(wall_clock() - t0, 0.0))
            # the flow chain's terminus
            _trace.flow_point(flow_id, "serving.result", "f")

    def _lifecycle_state(self) -> str:
        err = self._background_error
        if self.terminal_state is not None:
            return self.terminal_state
        if err is not None:
            return "crashed"
        if self._draining.is_set():
            return "draining"
        if self._loop_running or (self._thread is not None
                                  and self._thread.is_alive()):
            return "running"
        return "idle"

    def _health_common(self) -> Dict[str, Any]:
        """The snapshot keys both servers share; refreshes the
        point-in-time gauges on the same cadence."""
        with self._lock:
            in_flight = self._in_flight
        try:
            pending = self.queue.pending_count()
        except (OSError, NotImplementedError):
            pending = None
        if pending is not None:
            self._m_depth.set(pending)
        self._m_in_flight.set(in_flight)
        claim_age = (round(time.monotonic() - self._last_claim_m, 3)
                     if self._last_claim_m is not None else None)
        if claim_age is not None:
            self._m_claim_age.set(claim_age)
        return {"state": self._lifecycle_state(), "time": wall_clock(),
                "queue_pending": pending, "in_flight": in_flight,
                "last_claim_age_s": claim_age}

    @staticmethod
    def _pct_ms(fam, p: float) -> Optional[float]:
        v = fam.percentile(p)
        return None if v is None else round(v * 1e3, 3)

    def _emit_terminal(self, state: str) -> None:
        self.terminal_state = state
        _E_LIFECYCLE.emit(label=self.metrics_label, state=state)

    def _write_health(self) -> None:
        """Write ``health.json`` (atomically: readers never see a torn
        file) and the registry's Prometheus text as ``metrics.prom`` beside
        it. The health cadence is the profiler's slow tick too: it samples
        device memory and closes an elapsed capture window."""
        path = self.config.health_path
        if not path:
            return
        try:
            _profiler.sample_memory()
            _profiler.maybe_stop_capture()
        except Exception:
            logger.debug("profiler health tick failed", exc_info=True)
        for target, text in (
                (path, lambda: json.dumps(self.health_snapshot())),
                (os.path.join(os.path.dirname(path), "metrics.prom"),
                 _metrics.expose_text)):
            # a name of this writer's own: instances sharing a directory
            # write the same metrics.prom
            tmp = f"{target}.{os.getpid()}-{threading.get_ident()}.tmp"
            try:
                with file_io.fopen(tmp, "w") as f:
                    f.write(text())
                file_io.replace(tmp, target)
            except OSError:
                logger.warning("health write to %s failed", target)

    def _maybe_write_health(self) -> None:
        if not self.config.health_path:
            return
        now = time.monotonic()
        if now - self._last_health_m >= self.config.health_interval_s:
            self._last_health_m = now
            self._write_health()

    def check_health(self) -> None:
        """Raise the background loop's failure, if any."""
        err = self._background_error
        if err is not None:
            raise RuntimeError(
                f"{type(self).__name__} loop died in the background") from err


class ClusterServing(_ServerTelemetry):
    #: min seconds between shed passes (a shed lists the whole backlog)
    SHED_INTERVAL_S = 0.05

    def __init__(self, config: ServingConfig,
                 model: Optional[InferenceModel] = None,
                 queue: Optional[QueueBackend] = None,
                 device: DeviceLike = None):
        """``model``: an already loaded :class:`InferenceModel`; else the
        config's model loads onto ``device`` (the card when omitted; raises
        without one unless ``device="cpu"``). The model is prewarmed at the
        configured batch size before this returns, so the kernel library is
        built and loaded before any request is claimed."""
        self.config = config
        self.queue = queue if queue is not None \
            else make_queue(config.data_src)
        self.model = model if model is not None \
            else self._load_model(device=device)
        # a model loaded later (reload_model by path) lands where this is
        self._device = self.model.device
        # which snapshot is live: stamped here and on every successful
        # reload_model
        self.model_version = _model_version_of(
            config.model_path if (model is None or config.model_path)
            else None)
        self._inline_versions = itertools.count(1)
        self.prewarmed = self._prewarm_model(self.model)
        self._pool = None
        self.records_served = 0
        self.batches_dispatched = 0
        self.device_seconds = 0.0  # blocked-on-fetch time across batches
        self._ewma_record_s = 0.0  # smoothed device seconds per record
        self._reload_lock = threading.Lock()
        self._init_telemetry()

    def _load_model(self, cfg: Optional[ServingConfig] = None,
                    device: DeviceLike = None) -> InferenceModel:
        cfg = cfg if cfg is not None else self.config
        if cfg.model_type != "zoo":
            raise NotImplementedError(
                f"model_type {cfg.model_type!r} is not ported yet; the "
                f"torch port serves 'zoo' models")
        im = InferenceModel(concurrent_num=cfg.concurrent_num,
                            device=device)
        im.load_zoo(cfg.model_path)
        if cfg.quantize:  # before the prewarm: no request pays for it
            im.quantize(cfg.quantize)
        return im

    def _example_batch(self) -> np.ndarray:
        """A zeros batch shaped like :meth:`_prepare`'s output: image
        records decode to ``image_shape`` arrays (uint8 or float32 by
        ``input_dtype``), tensor records are always float32."""
        cfg = self.config
        dtype = np.uint8 if cfg.input_dtype == "uint8" else np.float32
        return np.zeros((cfg.batch_size,) + tuple(cfg.image_shape), dtype)

    def _prewarm_model(self, model: InferenceModel) -> bool:
        """Run the configured ``batch_size`` bucket once, so the first
        claimed batch finds its kernels built and loaded."""
        model.prewarm(self._example_batch(),
                      buckets=(self.config.batch_size,))
        return True

    # -- record prep ----------------------------------------------------------

    def _prepare(self, record: Dict[str, Any]) -> np.ndarray:
        # fault site: a faulty decode becomes this record's error result
        faults.inject("serving.decode")
        cfg = self.config
        if "image" in record:  # base64-encoded image bytes
            img = decode_image(record["image"])
            h, w = cfg.image_shape[0], cfg.image_shape[1]
            if img.shape[:2] != (h, w):
                import cv2
                img = cv2.resize(img, (w, h))
            # the uint8 wire is for images only: pixels are uint8 already
            dtype = np.uint8 if cfg.input_dtype == "uint8" else np.float32
            return np.asarray(img, dtype)
        if "tensor" in record:  # raw numeric payload: always float32, as a
            # uint8 cast would wrap the client's floats
            return np.asarray(record["tensor"], np.float32)
        raise ValueError(f"record has neither image nor tensor: "
                         f"{sorted(record)}")

    def _decode_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.config.decode_threads,
                thread_name_prefix="zoo-serving-decode")
        return self._pool

    def _shutdown_pool(self) -> None:
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- SLO bookkeeping ------------------------------------------------------

    def latency_ms(self, p: float) -> Optional[float]:
        """Percentile ``p`` (0..1) of enqueue-to-terminal latency, in ms,
        from the registry's histogram (within ``metrics.BUCKET_REL_ERROR``
        of the exact value); None before any terminal."""
        return self._pct_ms(self._m_latency, p)

    def _error_batch(self, uris: List[str], message: str,
                     counter: str = "errors") -> None:
        for uri in uris:
            self._post_terminal(uri, {"error": message})
        if uris:
            self._count(counter, len(uris))

    # -- pipeline stages ------------------------------------------------------

    def _shed(self) -> None:
        """Erroring admission control: ``max_pending`` caps the depth;
        ``shed_wait_ms`` caps the estimated wait of the queue tail. The
        brownout ladder ticks on the same cadence, with the queue's fill
        against the allowed depth as its pressure."""
        now = time.monotonic()
        if now - self._last_shed_m < self.SHED_INTERVAL_S:
            return
        self._last_shed_m = now
        cfg = self.config
        allowed = cfg.max_pending
        if cfg.shed_wait_ms:
            with self._lock:
                per_record_s = self._ewma_record_s
            if per_record_s > 0:
                allowed = min(allowed, max(
                    cfg.batch_size,
                    int(cfg.shed_wait_ms / 1000.0 / per_record_s)))
        try:
            dropped = self.queue.shed(allowed, reason=SHED_ERROR)
        except OSError as e:
            logger.warning("shed pass failed (transient): %r", e)
            return
        try:
            pending = self.queue.pending_count()
        except (OSError, NotImplementedError):
            pending = None
        fill = (pending / float(max(allowed, 1))
                if pending is not None else 0.0)
        self._m_brownout.set(self._brownout.tick(fill))
        if dropped:
            self._count("shed", len(dropped))
            _E_SHED.emit(label=self.metrics_label, count=len(dropped),
                         allowed=allowed)
            logger.warning("overload: shed %d oldest requests with error "
                           "results (allowed depth %d)", len(dropped),
                           allowed)

    def _claim(self) -> List[Tuple[str, Dict[str, Any]]]:
        """Shed, then fill one micro-batch within the batch window on the
        monotonic clock (``batch_wait_ms``, widened by brownout). Transient
        claim failures (a flaky backend, the ``serving.claim`` fault) are
        retried with jittered backoff; ``claim_retries`` in a row surface
        the backend as dead."""
        cfg = self.config
        self._shed()
        wait_ms = self._brownout.batch_window_ms(cfg.batch_wait_ms)
        deadline = time.monotonic() + wait_ms / 1000.0
        batch: List[Tuple[str, Dict[str, Any]]] = []
        while len(batch) < cfg.batch_size and time.monotonic() < deadline:
            try:
                faults.inject("serving.claim")
                with time_it("serving.claim_batch"):
                    got = self.queue.claim_batch(cfg.batch_size - len(batch))
                self._claim_fail_streak = 0
            except OSError as e:
                self._count("claim_faults")
                self._claim_fail_streak += 1
                if self._claim_fail_streak > cfg.claim_retries:
                    raise
                logger.warning("transient claim failure (%d/%d): %r",
                               self._claim_fail_streak, cfg.claim_retries, e)
                time.sleep(np.random.uniform(
                    0.0, 0.002 * (2 ** min(self._claim_fail_streak, 6))))
                continue
            if got:
                batch.extend(got)
            elif not batch:
                break  # nothing pending at all
            else:
                time.sleep(0.001)
        if batch:
            self._note_claimed(batch)
        return batch

    def _filter_expired(self, batch: List[Tuple[str, Dict[str, Any]]]
                        ) -> List[Tuple[str, Dict[str, Any]]]:
        """Deadline check at claim: expired records answer at once."""
        if not batch:
            return batch
        now = wall_clock()
        live, expired = [], []
        for uri, rec in batch:
            exp = self._expiry(rec)
            (expired if exp is not None and now >= exp
             else live).append((uri, rec))
        if expired:
            self._error_batch([u for u, _ in expired], DEADLINE_ERROR,
                              counter="expired")
        return live

    def _decode(self, batch: List):
        """Decode on the thread pool; undecodable records and records that
        expired during decode get their error results here."""
        uris, arrays, expiries = [], [], []
        errors, expired = [], []
        tracing = _trace.tracing()
        t_dec = time.perf_counter()
        with time_it("serving.decode_batch"):
            futures = [(uri, rec,
                        self._decode_pool().submit(self._prepare, rec))
                       for uri, rec in batch]
            for uri, rec, fut in futures:
                try:
                    arr = fut.result()
                except Exception as e:  # undecodable record -> its error
                    errors.append((uri, str(e)))
                    continue
                if tracing:
                    _trace.flow_point(rec.get("trace_id"),
                                      "serving.decode", "t")
                exp = self._expiry(rec)
                if exp is not None and wall_clock() >= exp:
                    expired.append(uri)
                    continue
                uris.append(uri)
                arrays.append(arr)
                expiries.append(exp)
        _profiler.record_phase("serving", "host_input",
                               time.perf_counter() - t_dec, start=t_dec)
        for uri, msg in errors:
            self._post_terminal(uri, {"error": msg})
        if errors:
            self._count("errors", len(errors))
        self._error_batch(expired, DEADLINE_ERROR, counter="expired")
        return uris, arrays, expiries

    def _stack(self, uris: List[str], arrays: List[np.ndarray],
               expiries: List[Optional[float]]):
        """Stack decoded records into one batch. A record whose shape is
        not the configured ``image_shape`` gets an error result, so one bad
        record cannot fail its whole batch."""
        want = tuple(self.config.image_shape)
        keep = [i for i, a in enumerate(arrays) if a.shape == want]
        if len(keep) < len(arrays):
            self._error_batch(
                [u for u, a in zip(uris, arrays) if a.shape != want],
                f"record shape differs from the configured {want}")
        if not keep:
            return [], None, []
        return ([uris[i] for i in keep], np.stack([arrays[i] for i in keep]),
                [expiries[i] for i in keep])

    def _expire_before_dispatch(self, uris: List[str], x: np.ndarray,
                                expiries: List[Optional[float]]):
        """Last deadline check, right before dispatch."""
        now = wall_clock()
        keep = [i for i, e in enumerate(expiries) if e is None or now < e]
        if len(keep) == len(uris):
            return uris, x
        kept = set(keep)
        self._error_batch([u for i, u in enumerate(uris) if i not in kept],
                          DEADLINE_ERROR, counter="expired")
        if not keep:
            return [], x[:0]
        return [uris[i] for i in keep], x[keep]

    def _dispatch(self, x: np.ndarray):
        """Async dispatch of one decoded batch; returns the fetch thunk.
        The one place of the ``serving.predict`` fault site: callers post
        error results for the batch and serve on."""
        faults.inject("serving.predict")
        t_d = time.perf_counter()
        with time_it("serving.dispatch_batch"):
            handle = self.model.predict_async(x)
        _profiler.record_phase("serving", "dispatch",
                               time.perf_counter() - t_d, start=t_d)
        with self._lock:
            self.batches_dispatched += 1
        return handle

    def _fetch(self, fetch) -> Tuple[np.ndarray, float]:
        """Wait for a dispatched batch's result; returns it and the seconds
        blocked (the ``fetch`` phase)."""
        t0 = time.perf_counter()
        probs = np.asarray(fetch())
        elapsed = time.perf_counter() - t0
        _profiler.record_phase("serving", "fetch", elapsed, start=t0)
        return probs, elapsed

    def _writeback(self, uris: List[str], probs: np.ndarray,
                   device_elapsed: float) -> None:
        # fault site: a failed writeback errors its batch, serving goes on
        faults.inject("serving.writeback")
        cfg = self.config
        with time_it("serving.writeback_batch"):
            for uri, p in zip(uris, probs):
                p = np.asarray(p).reshape(-1)
                if cfg.filter_top_n:
                    self._post_terminal(
                        uri, {"topN": top_n(p, cfg.filter_top_n)})
                else:
                    self._post_terminal(uri, {"value": p.tolist()})
        self._m_records.inc(len(uris))
        self.records_served += len(uris)
        self.device_seconds += device_elapsed
        if uris:
            per = device_elapsed / len(uris)
            with self._lock:
                self._ewma_record_s = (
                    per if self._ewma_record_s == 0.0
                    else 0.8 * self._ewma_record_s + 0.2 * per)

    def _force_sentinel(self, q) -> None:
        """Land a ``None`` sentinel on a possibly full queue; displaced
        in-flight items (already claimed) get shutdown errors."""
        import queue as pyqueue
        while True:
            try:
                q.put(None, timeout=0.2)
                return
            except pyqueue.Full:
                try:
                    item = q.get_nowait()
                except pyqueue.Empty:
                    continue
                if item is None:
                    continue
                self._error_batch(list(item[0]), SHUTDOWN_ERROR)

    # -- deep health ------------------------------------------------------------

    def health_snapshot(self) -> Dict[str, Any]:
        """Lifecycle state, queue depth, last-claim age, in-flight count,
        p50/p99 terminal latency (ms, null on an empty window), brownout
        rung, model version and the SLO and reload counters: the JAX
        package's keys, a per-instance view of the metrics registry."""
        snap = self._health_common()
        with self._lock:
            ewma = self._ewma_record_s
        snap.update({
            "records_served": self.records_served,
            "device_seconds": round(self.device_seconds, 4),
            "service_time_s_ewma": (round(ewma, 6) if ewma > 0 else None),
            "brownout_level": self._brownout.level,
            "latency_ms": {"p50": self._pct_ms(self._m_latency, 0.50),
                           "p99": self._pct_ms(self._m_latency, 0.99),
                           "window": self._m_latency.count()},
            "counters": {k: int(c.value()) for k, c in self._m.items()},
            "prewarmed": self.prewarmed,
            "model_version": self.model_version,
            "alerts": sorted(ops_alerts.active_alerts()),
            "incident": ops_incident.last_incident(),
            "error": (repr(self._background_error)
                      if self._background_error is not None else None),
        })
        return snap

    # -- hot model reload -------------------------------------------------------

    def reload_model(self, model_path: Optional[str] = None, *,
                     model: Optional[InferenceModel] = None,
                     model_type: Optional[str] = None,
                     version: Optional[str] = None) -> InferenceModel:
        """Hot-swap the serving model with a canary and rollback. The
        candidate loads and prewarms off the serve path (the old model
        serves the whole time), canary-predicts one zeros batch, and only
        then swaps in: one attribute store, so no request is dropped or
        misrouted (a dispatched batch holds the model that took it). ANY
        failure (load, prewarm, canary, the ``serving.reload`` fault)
        leaves the old model and its version serving and raises
        :class:`ModelReloadError`. A candidate loaded from a path lands on
        the serving model's device."""
        with self._reload_lock:
            old = self.model
            cfg = self.config
            try:
                faults.inject("serving.reload")
                if model is None:
                    if model_path is None:
                        raise ValueError(
                            "reload_model needs model_path= or model=")
                    import dataclasses
                    model = self._load_model(dataclasses.replace(
                        cfg, model_path=model_path,
                        model_type=model_type or cfg.model_type),
                        device=self._device)
                self._prewarm_model(model)
                canary = model.predict(self._example_batch())
                leaves = (list(canary) if isinstance(canary, (list, tuple))
                          else [canary])
                if not leaves:
                    raise ValueError("canary predict returned no outputs")
                for leaf in leaves:
                    a = np.asarray(leaf)
                    if a.shape[0] != cfg.batch_size:
                        raise ValueError(
                            f"canary predict returned leading dim "
                            f"{a.shape[0]} for a batch of {cfg.batch_size}")
                    if np.issubdtype(a.dtype, np.floating) \
                            and not np.isfinite(a).all():
                        raise ValueError(
                            "canary predict produced non-finite values")
                self.model = model  # the swap: the next dispatch uses it
                if model_path is not None:
                    cfg.model_path = model_path
                    if model_type:
                        cfg.model_type = model_type
                # stamp only on success: a failed reload leaves the old
                # model and its version label live
                if version is not None:
                    self.model_version = version
                elif model_path is not None:
                    self.model_version = _model_version_of(model_path)
                else:
                    self.model_version = \
                        f"inline-{next(self._inline_versions)}"
                self._count("reloads")
                _E_RELOAD.emit(label=self.metrics_label, ok=True,
                               version=self.model_version)
                logger.info("model reloaded%s",
                            f" from {model_path}" if model_path else "")
                return model
            except Exception as e:
                self.model = old  # rollback (a no-op unless a partial swap)
                self._count("reload_failures")
                _E_RELOAD.emit(label=self.metrics_label, ok=False,
                               version=self.model_version)
                logger.exception(
                    "model reload failed; previous model still serving")
                raise ModelReloadError(
                    f"model reload failed ({e!r}); previous model still "
                    f"serving") from e

    # -- the serve loop -------------------------------------------------------

    def serve_once(self) -> int:
        """One synchronous micro-batch (claim -> decode -> predict ->
        writeback); returns the number of records claimed, each of which
        has its terminal result when this returns."""
        batch = self._claim()
        self._maybe_write_health()
        if not batch:
            return 0
        claimed = len(batch)
        uris, x, expiries = self._stack(
            *self._decode(self._filter_expired(batch)))
        if uris:
            uris, x = self._expire_before_dispatch(uris, x, expiries)
        if uris:
            try:
                self._flow_uris(uris, "serving.dispatch")
                probs, elapsed = self._fetch(self._dispatch(x))
                self._writeback(uris, probs, elapsed)
            except Exception as e:
                logger.exception("predict/writeback failed for %d records",
                                 len(uris))
                self._error_batch(uris, repr(e))
        return claimed

    def run(self, poll_interval_s: float = 0.005) -> None:
        """Pipelined serve loop: a claim+decode thread feeds dispatch on
        this thread, and a writeback thread waits for the card's results,
        so batch N+1 decodes while batch N runs and batch N-1 is written
        back. Only this thread calls into torch to launch work."""
        import queue as pyqueue

        logger.info("serving started (src=%s batch=%d)",
                    self.config.data_src, self.config.batch_size)
        ops_alerts.ensure_default()  # a no-op unless ops.enabled
        self.terminal_state = None
        self._loop_running = True
        self._last_shed_m = -1e18
        decoded_q: "pyqueue.Queue" = pyqueue.Queue(maxsize=2)
        fetch_q: "pyqueue.Queue" = pyqueue.Queue(maxsize=2)
        errors: List[BaseException] = []
        dead = threading.Event()  # any stage died: unblock everyone

        def _put(q: "pyqueue.Queue", item) -> bool:
            """Bounded put that gives up when a peer stage has died."""
            start = time.monotonic()
            while not dead.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except pyqueue.Full:
                    if time.monotonic() - start > 30:
                        logger.warning(
                            "pipeline stage blocked handing off a batch "
                            "for %.0fs", time.monotonic() - start)
                        start = time.monotonic()
            return False

        def decoder() -> None:
            try:
                while not self._stop.is_set() and not dead.is_set():
                    if self._draining.is_set():
                        return  # drain: stop claiming; sentinel flushes
                    self._maybe_write_health()
                    batch = self._filter_expired(self._claim())
                    if not batch:
                        time.sleep(poll_interval_s)
                        continue
                    uris, x, expiries = self._stack(*self._decode(batch))
                    if uris and not _put(decoded_q, (uris, x, expiries)):
                        self._error_batch(uris, SHUTDOWN_ERROR)
                        return
            except BaseException as e:  # surfaced by run() below
                errors.append(e)
                dead.set()
            finally:
                self._force_sentinel(decoded_q)

        def writeback() -> None:
            while True:
                item = fetch_q.get()
                if item is None:
                    return
                uris, fetch = item
                try:
                    # waits for the card's result only
                    probs, elapsed = self._fetch(fetch)
                    self._writeback(uris, probs, elapsed)
                except Exception as e:
                    # one failed batch must not wedge the server
                    logger.exception("writeback failed for %d records",
                                     len(uris))
                    self._error_batch(list(uris), repr(e))

        threads = [threading.Thread(target=decoder, daemon=True,
                                    name="zoo-serving-claim"),
                   threading.Thread(target=writeback, daemon=True,
                                    name="zoo-serving-writeback")]
        for t in threads:
            t.start()
        try:
            while True:
                item = decoded_q.get()
                if item is None:
                    break
                uris, x, expiries = item
                uris, x = self._expire_before_dispatch(uris, x, expiries)
                if not uris:
                    continue
                try:
                    self._flow_uris(uris, "serving.dispatch")
                    fetch = self._dispatch(x)
                except Exception as e:
                    logger.exception("dispatch failed for %d records",
                                     len(uris))
                    self._error_batch(uris, repr(e))
                    continue
                if not _put(fetch_q, (uris, fetch)):
                    self._error_batch(uris, SHUTDOWN_ERROR)
                    break
        finally:
            drained = (self._draining.is_set() and not dead.is_set()
                       and not errors)
            self._stop.set()
            dead.set()
            self._force_sentinel(fetch_q)
            for t in threads:
                t.join(timeout=10)
            self._shutdown_pool()
            self._loop_running = False
            self._emit_terminal("crashed" if errors
                                else "drained" if drained else "stopped")
            self._write_health()
        if errors:
            raise errors[0]

    def start(self) -> "ClusterServing":
        """Run the loop in a background thread; a crash there is re-raised
        by :meth:`stop`, :meth:`drain` and :meth:`check_health`."""
        ops_alerts.ensure_default()  # a no-op unless ops.enabled
        self._stop.clear()
        self._draining.clear()
        self.terminal_state = None
        self._background_error = None

        def _run() -> None:
            try:
                self.run()
            except BaseException as e:
                logger.exception("serving loop died")
                self._background_error = e

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="zoo-serving-loop")
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> None:
        """Graceful shutdown: stop claiming, finish every in-flight batch,
        flush all results, write the terminal ``health.json``. Called on a
        foreground :meth:`run` (e.g. from a SIGTERM handler) it only flags
        the loop, which unwinds itself."""
        self._draining.set()
        if self._loop_running and self._thread is None:
            return
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            if t.is_alive():
                raise RuntimeError(
                    f"drain did not complete within {timeout_s}s "
                    f"({self._in_flight} requests still in flight)")
            self._thread = None
        self._shutdown_pool()
        if self.terminal_state is None:
            self._emit_terminal("drained")
        self._write_health()
        self.check_health()

    def stop(self) -> None:
        """Hard stop; displaced in-flight work gets shutdown errors."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                self._thread = None
                raise RuntimeError(
                    "serving loop did not shut down within 10s (queue "
                    "backend wedged?); thread leaked")
            self._thread = None
        self._shutdown_pool()
        if self.terminal_state is None:
            self._emit_terminal("stopped")
        self._write_health()
        self.check_health()


class GenerativeServing(_ServerTelemetry):
    """Token-level continuous batching for ``TransformerLM`` generation
    (the JAX package's ``GenerativeServing``).

    ``config.slots`` streams stay resident in one slot-batched KV cache
    (``ops/decode.py``) and one decode step advances all of them a token;
    requests join free slots through the bucketed prefill
    (``TransformerLM.prefill_kv``: B1, then B7 at a bucket of 512 or less,
    B4 above) and finished or expired streams are evicted every step. Slot
    ids, lengths, occupancy and page tables are tensors on the card, so
    the step's shapes never change.

    Every claimed request gets exactly one terminal result (``{"value":
    tokens, "done": true}`` or an error): deadlines are checked at claim
    and every step (an expired stream is evicted mid-flight with the
    deadline error), overload sheds by the estimated wait at the current
    smoothed seconds a token, a failed step (or the ``serving.decode_step``
    fault) errors every active stream and the server goes on, and
    :meth:`drain` stops admitting but finishes the streams in flight.
    Partials (``{"stream": [...], "done": false}``) overwrite the same
    result record and are progress, not terminals; ``OutputQueue.stream``
    turns them into a generator. :meth:`handoff` re-enqueues the streams in
    flight on another server's queue with the tokens decoded so far, and
    that server finishes them as they would have gone on.

    Served streams are the serial ``TransformerLM.generate`` runs: both
    take the same bucketed prefill, the same ``masked_context`` arithmetic
    on the same f32 caches, and, when sampling, the same logit filter and
    Gumbel draws (``gumbel_noise(seed, ...)``, each request's own seed).

    The paged engine (``config.kv_pages``) replaces the rectangles with
    one page pool a block and a page table a slot: a join allocates the
    pages its prompt and budget need (shedding with ``PAGE_SHED_ERROR``
    when the pool is short, or the ``serving.page_alloc`` fault fires),
    retirement returns them by refcount, :meth:`register_prefix` shares a
    prompt prefix's pages with copy-on-write tails, and ``config.kv_int8``
    keeps the pool in int8 with delayed scaling.

    Speculative rounds (``config.spec_k`` with a ``draft_lm``, on the paged
    engine, greedy only, as the JAX package's): each step runs ``spec_k``
    draft steps off the draft's slot caches, one ``verify_step`` of the
    target through the pool, and the greedy accept rule, so a stream gains
    1 to ``spec_k + 1`` tokens a step, token-identical to serial greedy
    ``generate``. The brownout ladder caps new streams' budgets and
    coarsens partials under pressure.

    A pool sharded over devices (``kv_shard``; ROADMAP Queue A item 7) is
    refused with ``NotImplementedError``.
    """

    SHED_INTERVAL_S = 0.05

    def __init__(self, config: ServingConfig, lm,
                 queue: Optional[QueueBackend] = None, draft_lm=None,
                 device: DeviceLike = None):
        """``lm``: a ``TransformerLM``; its parameters (and ``draft_lm``'s)
        move to ``device`` (the card when omitted; raises without one
        unless ``device="cpu"``)."""
        if int(config.kv_shard or 1) > 1:
            raise NotImplementedError(
                "a KV pool sharded over devices (kv_shard > 1) is not "
                "ported yet: ROADMAP Queue A item 7")
        if config.slots < 1:
            raise ValueError(f"slots must be >= 1, got {config.slots}")
        self.config = config
        self.lm = lm
        self.model_version = _model_version_of(config.model_path)
        self.queue = (queue if queue is not None
                      else make_queue(config.data_src))
        self.slots = s = int(config.slots)
        self.device = dev = lm._device(device)
        lm.eval()
        self._sampling = (config.temperature is not None
                          or config.top_k is not None
                          or config.top_p is not None)
        self._filter = None
        if self._sampling:
            self._filter = _decode.make_logit_filter(
                config.temperature if config.temperature is not None
                else 1.0, config.top_k, config.top_p)
        self._paged = config.kv_pages is not None
        self._spec = draft_lm is not None and config.spec_k > 0
        if self._spec and not self._paged:
            raise ValueError("speculative decoding rides the paged KV "
                             "engine: set kv_pages alongside spec_k")
        if self._spec and self._sampling:
            raise ValueError("speculative decoding in the scheduler is "
                             "greedy-only; unset temperature/top_k/top_p")
        self._spec_k = int(config.spec_k) if self._spec else 0
        if self._paged:
            pl, num_pages = int(config.kv_page_len), int(config.kv_pages)
            if pl < 1 or (pl & (pl - 1)) or pl > 16:
                raise ValueError(f"kv_page_len must be a power of two "
                                 f"<= 16 (divides every prefill bucket), "
                                 f"got {pl}")
            if lm.max_len % pl:
                raise ValueError(f"kv_page_len {pl} must divide the LM's "
                                 f"max_len {lm.max_len}")
            if num_pages < 2:
                raise ValueError(f"kv_pages must be >= 2 (page 0 is the "
                                 f"null page), got {num_pages}")
            self.page_len, self.num_pages = pl, num_pages
            # slack columns for the transient spec_k overshoot past
            # max_len (past a stream's allocation, the null page takes it)
            self._table_w = -(-(lm.max_len + self._spec_k) // pl)
            self._caches = lm.init_paged_caches(num_pages, pl,
                                                int8=config.kv_int8,
                                                device=dev)
            self._table = torch.zeros((s, self._table_w), dtype=torch.int32,
                                      device=dev)
            # host allocator: a free-page stack, refcounts, each slot's
            # pages (a shared prefix's pages appear in many)
            self._free_pages = self._initial_free_pages(num_pages)
            self._page_refs = np.zeros(num_pages, np.int64)
            self._slot_pages: List[List[int]] = [[] for _ in range(s)]
            self._prefixes: List[Dict[str, Any]] = []
        else:
            self._caches = lm.init_slot_caches(s, device=dev)
        self._state = _decode.init_slot_state(s, device=dev)
        if self._spec:
            if draft_lm.max_len < lm.max_len + self._spec_k:
                raise ValueError(
                    f"draft max_len={draft_lm.max_len} must cover "
                    f"max_len={lm.max_len} + spec_k={self._spec_k} "
                    f"transient draft positions")
            self.draft_lm = draft_lm
            draft_lm._device(dev)
            draft_lm.eval()
            self._dcaches = draft_lm.init_slot_caches(s, device=dev)
        #: draft tokens offered to active streams, and accepted
        self.spec_totals = {"proposed": 0, "accepted": 0}
        # -- host bookkeeping (the scheduler thread's own) ------------------
        self._uri: List[Optional[str]] = [None] * s
        self._tokens: List[Optional[List[int]]] = [None] * s
        self._budget = [0] * s
        self._expires: List[Optional[float]] = [None] * s
        self._enqueue_t = [0.0] * s
        self._first_t: List[Optional[float]] = [None] * s
        self._streamed = [0] * s
        self._noise: List[Optional[Any]] = [None] * s
        self._next_tokens = np.zeros(s, np.int64)
        self._active_host = np.zeros(s, bool)
        # what a handoff re-enqueues: the original prompt, seed and
        # deadline ride along with the tokens decoded so far
        self._prompt: List[Optional[List[int]]] = [None] * s
        self._seed: List[Optional[int]] = [None] * s
        self._deadline_ms: List[Optional[float]] = [None] * s
        # -- SLO bookkeeping (ClusterServing's families and more) -----------
        self._init_telemetry()
        label = self.metrics_label
        self._m_ttft = _M_TTFT.labels(server=label)
        self._m_tokens = _M_TOKENS.labels(server=label)
        self._m_slots = _M_SLOTS.labels(server=label)
        self._m_pages_free = _M_PAGES_FREE.labels(server=label)
        self._m_page_evict = _M_PAGE_EVICT.labels(server=label)
        self._m_spec_accept = _M_SPEC_ACCEPT.labels(server=label)
        if self._paged:
            self._m_pages_free.set(len(self._free_pages))
        self.records_served = 0
        self.steps = 0
        self._ewma_token_s = 0.0  # smoothed wall seconds a decoded token
        self._handoff_evt = threading.Event()

    # -- the device programs ---------------------------------------------------

    def _select(self, logits, noise):
        if self._filter is None:
            return torch.argmax(logits, dim=-1)
        return _decode.sampled_select(self._filter(logits.float()), noise)

    def _advance(self):
        """Lengths advance once, after every block attended with the
        pre-increment value (write, then attend, as serial decode)."""
        self._state["length"] += self._state["active"].to(
            self._state["length"].dtype)

    def _step(self, tokens, noise):
        logits, self._caches = self.lm.slot_step(
            tokens, self._state["length"], self._caches)
        nxt = self._select(logits, noise)
        self._advance()
        return nxt

    def _step_paged(self, tokens, noise):
        logits, self._caches = self.lm.paged_slot_step(
            tokens, self._state["length"], self._table, self._caches)
        nxt = self._select(logits, noise)
        self._advance()
        return nxt

    def _step_spec(self, tokens):
        """One speculative round: ``spec_k`` chained draft steps, one
        batched verify through the pool, the greedy accept. Lengths advance
        by each active slot's accepted count. Returns ``[S, spec_k + 2]``:
        the emitted tokens, then the count valid in each row."""
        lengths = self._state["length"]
        active = self._state["active"].to(lengths.dtype)
        tok, ln, drafts = tokens, lengths, []
        for _ in range(self._spec_k):
            dlogits, self._dcaches = self.draft_lm.slot_step(
                tok, ln, self._dcaches)
            tok = torch.argmax(dlogits, dim=-1).to(tokens.dtype)
            drafts.append(tok)
            ln = ln + active
        drafts_t = torch.stack(drafts, dim=1)
        block = torch.cat([tokens[:, None], drafts_t], dim=1)
        tlogits, self._caches = self.lm.verify_step(block, lengths,
                                                    self._table, self._caches)
        emitted, n = _decode.spec_accept_greedy(drafts_t, tlogits)
        n = n.to(lengths.dtype) * active
        self._state["length"] += n
        return torch.cat([emitted, n[:, None].to(emitted.dtype)], dim=1)

    def _device_tokens(self, padded: np.ndarray):
        return torch.as_tensor(padded, dtype=torch.long, device=self.device)

    def _prefill(self, padded, slot: int, length: int) -> None:
        kvs = self.lm.prefill_kv(self._device_tokens(padded))
        for c, (k, v) in zip(self._caches, kvs):
            _decode.slot_insert(c, slot, k[0], v[0])
        _decode.slot_join(self._state, slot, length)

    def _prefill_paged(self, padded, row, slot: int, length: int,
                       dpadded=None) -> None:
        """Prefill into the pages of ``row``; under speculative decoding
        ``dpadded`` (the prompt at the draft's bucket) fills the draft's
        slot cache too."""
        kvs = self.lm.prefill_kv(self._device_tokens(padded))
        row_d = self._device_tokens(row)
        for c, (k, v) in zip(self._caches, kvs):
            _decode.paged_insert(c, row_d, k[0], v[0])
        if dpadded is not None:
            dkvs = self.draft_lm.prefill_kv(self._device_tokens(dpadded))
            for c, (k, v) in zip(self._dcaches, dkvs):
                _decode.slot_insert(c, slot, k[0], v[0])
        _decode.slot_join(self._state, slot, length)
        _decode.page_table_set(self._table, slot, row_d)

    def _prefill_suffix(self, padded, row, prow, slot: int, length: int,
                        plen: int) -> None:
        """Gather the shared prefix's K/V (refcounted pages, prefilled
        once) and run only the divergent suffix forward."""
        prow_d, row_d = self._device_tokens(prow), self._device_tokens(row)
        pref = [_decode.paged_gather(c, prow_d[None])
                for c in self._caches]
        pref = [(k[:, :, :plen], v[:, :, :plen]) for k, v in pref]
        kvs = self.lm.prefill_kv_suffix(self._device_tokens(padded), pref,
                                        plen)
        for c, (k, v) in zip(self._caches, kvs):
            _decode.paged_insert(c, row_d, k[0], v[0], start=plen)
        _decode.slot_join(self._state, slot, length)
        _decode.page_table_set(self._table, slot, row_d)

    def _prefill_prefix(self, padded, row) -> None:
        kvs = self.lm.prefill_kv(self._device_tokens(padded))
        row_d = self._device_tokens(row)
        for c, (k, v) in zip(self._caches, kvs):
            _decode.paged_insert(c, row_d, k[0], v[0])

    def _copy_pages(self, src: int, dst: int) -> None:
        for c in self._caches:
            _decode.page_copy(c, src, dst)

    # -- terminal accounting (exactly one terminal a request) -----------------

    def _retire(self, slot: int, value: Dict[str, Any],
                counter: Optional[str] = None) -> None:
        """Post a slot's terminal and free its host bookkeeping (the device
        evict is the caller's one :meth:`_evict_slots`)."""
        self._post_terminal(self._uri[slot], value)
        if counter is not None:
            self._count(counter)
        elif "value" in value:
            self._m_records.inc()
            self.records_served += 1
        if self._paged:
            self._release_pages(slot)
        self._clear_slot(slot)

    def _abandon(self, slot: int) -> None:
        """Free a slot without posting a terminal: the server that adopts
        its re-enqueued continuation posts the stream's one terminal. Only
        :meth:`handoff` does this; every other exit goes through
        :meth:`_retire`."""
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
            in_flight = self._in_flight
            self._meta.pop(self._uri[slot], None)
        self._m_in_flight.set(in_flight)
        if self._paged:
            self._release_pages(slot)
        self._clear_slot(slot)

    def _clear_slot(self, slot: int) -> None:
        self._uri[slot] = None
        self._tokens[slot] = None
        self._noise[slot] = None
        self._expires[slot] = None
        self._first_t[slot] = None
        self._streamed[slot] = 0
        self._prompt[slot] = None
        self._seed[slot] = None
        self._deadline_ms[slot] = None
        self._active_host[slot] = False

    @staticmethod
    def _initial_free_pages(num_pages: int) -> List[int]:
        """Allocatable pages ``1..num_pages-1`` as a pop()-able stack."""
        return list(range(num_pages - 1, 0, -1))

    def _release_pages(self, slot: int) -> None:
        """Drop the slot's hold on each of its pages; a page no one holds
        goes back on the free stack (a registered prefix holds its own)."""
        pages, self._slot_pages[slot] = self._slot_pages[slot], []
        freed = 0
        for p in pages:
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                self._free_pages.append(p)
                freed += 1
        if freed:
            self._m_page_evict.inc(freed)
        self._m_pages_free.set(len(self._free_pages))

    # -- the device path ---------------------------------------------------------

    def _dispatch_step(self, tokens: np.ndarray, noise):
        """One decode step (or speculative round) over every slot, enqueued
        on the card; returns its tokens, still on the device. The
        ``serving.decode_step`` fault site: a failure errors every active
        stream and the scheduler serves on."""
        faults.inject("serving.decode_step")
        t0 = time.perf_counter()
        with time_it("serving.generative.dispatch"), torch.inference_mode():
            tok = torch.as_tensor(tokens, device=self.device)
            if self._spec:
                out = self._step_spec(tok)
            elif self._paged:
                out = self._step_paged(tok, noise)
            else:
                out = self._step(tok, noise)
        _profiler.record_phase("serving", "dispatch",
                               time.perf_counter() - t0, start=t0)
        return out

    def _insert_request_device(self, padded, slot: int, length: int) -> None:
        with torch.inference_mode():
            self._prefill(padded, slot, length)

    def _evict_slots(self, mask: np.ndarray) -> None:
        with torch.inference_mode():
            m = torch.as_tensor(mask, device=self.device)
            _decode.slot_evict(self._state, m)
            if self._paged:
                _decode.page_table_clear(self._table, m)

    def _fetch_tokens(self, nxt) -> np.ndarray:
        """The step's one host sync."""
        t0 = time.perf_counter()
        with time_it("serving.generative.fetch"):
            out = nxt.cpu().numpy()
        _profiler.record_phase("serving", "fetch",
                               time.perf_counter() - t0, start=t0)
        return out

    def _step_noise(self):
        """Each active slot's Gumbel row for this step, ``[S, vocab]`` on
        the card (zeros for a free slot); None when greedy."""
        if not self._sampling:
            return None
        rows = torch.zeros((self.slots, self.lm.vocab_size))
        for i in range(self.slots):
            if self._active_host[i]:
                rows[i] = self._noise[i][len(self._tokens[i])]
        return rows.to(self.device, non_blocking=True)

    # -- admission ---------------------------------------------------------------

    def _shed(self) -> None:
        """Admission control at token granularity: slots free up at
        ``slots / (budget · smoothed seconds a token)`` streams a second;
        shed the backlog to what starts within ``shed_wait_ms`` (the
        brownout cap shortens the budget, so a browned-out server admits
        deeper queues). The brownout ladder ticks here, on the larger of
        the queue's fill and the page pool's scarcity."""
        now = time.monotonic()
        if now - self._last_shed_m < self.SHED_INTERVAL_S:
            return
        self._last_shed_m = now
        cfg = self.config
        allowed = cfg.max_pending
        eff_budget = self._brownout.token_cap(cfg.max_new_tokens)
        if cfg.shed_wait_ms and self._ewma_token_s > 0:
            stream_s = eff_budget * self._ewma_token_s
            allowed = min(allowed, max(
                self.slots,
                int(cfg.shed_wait_ms / 1000.0 / stream_s * self.slots)))
        try:
            dropped = self.queue.shed(allowed, reason=SHED_ERROR)
        except OSError as e:
            logger.warning("shed pass failed (transient): %r", e)
            return
        try:
            pending = self.queue.pending_count()
        except (OSError, NotImplementedError):
            pending = None
        fill = (pending / float(max(allowed, 1))
                if pending is not None else 0.0)
        scarcity = 0.0
        if self._paged:
            scarcity = 1.0 - (len(self._free_pages)
                              / float(max(self.num_pages - 1, 1)))
        self._m_brownout.set(self._brownout.tick(max(fill, scarcity)))
        if dropped:
            self._count("shed", len(dropped))
            _E_SHED.emit(label=self.metrics_label, count=len(dropped),
                         allowed=allowed)
            logger.warning("overload: shed %d oldest streams with error "
                           "results (allowed depth %d)", len(dropped),
                           allowed)

    def _match_prefix(self, prompt) -> Optional[Dict[str, Any]]:
        """The longest registered prefix that ``prompt`` strictly extends
        (the last prompt token is never prefilled)."""
        best = None
        for pfx in self._prefixes:
            n = pfx["len"]
            if (len(prompt) > n and list(prompt[:n]) == pfx["tokens"]
                    and (best is None or n > best["len"])):
                best = pfx
        return best

    def register_prefix(self, tokens) -> int:
        """Prefill a shared prompt prefix once into refcounted pool pages.
        A later join whose prompt extends it references those pages (whole
        pages in place; a partly filled tail page as a private copy, since
        the stream appends into it) and prefills only its own suffix. The
        registry keeps a hold on the pages for good. Call it before
        :meth:`start` or between steps. Returns the prefix's index."""
        from ..capture.lm import prefill_bucket
        if not self._paged:
            raise RuntimeError("shared prefixes require the paged KV "
                               "engine (set kv_pages)")
        if self._spec:
            raise RuntimeError("shared prefixes are not wired into the "
                               "speculative scheduler (the draft cache is "
                               "contiguous)")
        toks = [int(x) for x in tokens]
        n = len(toks)
        if n < 1 or n >= self.lm.max_len:
            raise ValueError(f"prefix length {n} out of range for "
                             f"max_len={self.lm.max_len}")
        npages = -(-n // self.page_len)
        if len(self._free_pages) < npages:
            raise RuntimeError(
                f"kv page pool exhausted: prefix needs {npages} pages, "
                f"{len(self._free_pages)} free")
        pages = [self._free_pages.pop() for _ in range(npages)]
        for p in pages:
            self._page_refs[p] = 1  # the registry's hold
        row = np.zeros(self._table_w, np.int64)
        row[:npages] = pages
        padded = np.zeros((1, prefill_bucket(n, self.lm.max_len)), np.int64)
        padded[0, :n] = toks
        with torch.inference_mode():
            self._prefill_prefix(padded, row)
        self._prefixes.append({"tokens": toks, "len": n, "pages": pages})
        self._m_pages_free.set(len(self._free_pages))
        return len(self._prefixes) - 1

    def _join_paged(self, slot: int, uri: str, prompt, t: int,
                    budget: int) -> bool:
        """Allocate pages for a valid request and prefill it into
        ``slot``. A pool too short for it (or the ``serving.page_alloc``
        fault) sheds the request: its one terminal is the page shed error,
        and resident streams go on."""
        from ..capture.lm import prefill_bucket
        pl = self.page_len
        pfx = self._match_prefix(prompt) if not self._spec else None
        plen = pfx["len"] if pfx else 0
        full = plen // pl        # whole shared pages
        rem = plen % pl          # prefix tokens on the shared tail page
        fed = t - 1              # positions prefilled before decoding
        tb = (prefill_bucket(fed - plen, self.lm.max_len)
              if fed > plen else 0)
        # the highest position the stream writes within its pages: the
        # bucket's padding past the suffix, the decode budget and the
        # transient spec_k overshoot
        high = max(plen + tb, t + budget + self._spec_k)
        # padding past the table's width is never visible: the null page
        # takes it
        fresh_needed = min(-(-high // pl), self._table_w) - full
        if (faults.inject("serving.page_alloc")
                or len(self._free_pages) < fresh_needed):
            self._post_terminal(uri, {"error": PAGE_SHED_ERROR})
            self._count("shed")
            logger.warning("kv page pool exhausted: shed %s (need %d "
                           "pages, %d free)", uri, fresh_needed,
                           len(self._free_pages))
            return False
        fresh = [self._free_pages.pop() for _ in range(fresh_needed)]
        shared = [int(p) for p in pfx["pages"][:full]] if pfx else []
        row = np.zeros(self._table_w, np.int64)
        row[:full] = shared
        row[full:full + fresh_needed] = fresh
        for p in shared:
            self._page_refs[p] += 1
        for p in fresh:
            self._page_refs[p] = 1
        self._slot_pages[slot] = shared + fresh
        self._m_pages_free.set(len(self._free_pages))
        with torch.inference_mode():
            if pfx and rem:
                # copy-on-write: the stream appends into logical page
                # ``full``, which holds the prefix's tail tokens
                self._copy_pages(pfx["pages"][full], fresh[0])
            if fed > plen:
                padded = np.zeros((1, tb), np.int64)
                padded[0, :fed - plen] = prompt[plen:fed]
                if pfx:
                    self._prefill_suffix(padded, row,
                                         np.asarray(pfx["pages"], np.int64),
                                         slot, fed, plen)
                else:
                    dpadded = None
                    if self._spec:
                        dpadded = np.zeros(
                            (1, prefill_bucket(fed, self.draft_lm.max_len)),
                            np.int64)
                        dpadded[0, :fed] = prompt[:fed]
                    self._prefill_paged(padded, row, slot, fed, dpadded)
            else:  # nothing to prefill: join and install the table row
                _decode.slot_join(self._state, slot, fed)
                _decode.page_table_set(self._table, slot,
                                       self._device_tokens(row))
        return True

    def _join(self, slot: int, uri: str, rec: Dict[str, Any],
              now: float) -> bool:
        """Check a claimed request and prefill it into ``slot``. False (the
        slot stays free) when the request ends at once: an empty prompt,
        over the budget, expired, or (paged) no pages. The budget is capped
        by the brownout rung. A request carrying a ``prefix`` (tokens
        decoded elsewhere: a handed-off stream) prefills ``prompt +
        prefix`` and decodes on from ``len(prefix)``; a sampled one takes
        row ``len(prefix)`` of its seed's draws next, so it goes on as it
        would have."""
        from ..capture.lm import prefill_bucket
        cfg = self.config
        prompt = rec.get("prompt")
        if not prompt:
            self._post_terminal(uri, {"error": "empty prompt"})
            self._count("errors")
            return False
        budget = self._brownout.token_cap(
            int(rec.get("max_new_tokens") or cfg.max_new_tokens))
        prompt = [int(x) for x in prompt]
        prefix = [int(x) for x in (rec.get("prefix") or [])]
        t = len(prompt)
        if budget < 1 or t + budget > self.lm.max_len:
            self._post_terminal(uri, {
                "error": f"prompt ({t}) + max_new_tokens ({budget}) "
                         f"out of range for max_len={self.lm.max_len}"})
            self._count("errors")
            return False
        exp = self._expiry(rec)
        if exp is not None and now >= exp:
            self._post_terminal(uri, {"error": DEADLINE_ERROR})
            self._count("expired")
            return False
        if prefix and len(prefix) >= budget:
            # decoded in full elsewhere, never answered: settle it
            self._post_terminal(uri, {"value": prefix[:budget],
                                      "done": True})
            self._m_records.inc()
            self.records_served += 1
            return False
        full = prompt + prefix
        t_full = len(full)
        t0 = time.perf_counter()
        with time_it("serving.generative.join"):
            if self._paged:
                joined = self._join_paged(slot, uri, full, t_full,
                                          budget - len(prefix))
            elif t_full > 1:
                # full[:-1] right-padded to its bucket: the prefill serial
                # generate() runs
                tb = prefill_bucket(t_full - 1, self.lm.max_len)
                padded = np.zeros((1, tb), np.int64)
                padded[0, :t_full - 1] = full[:-1]
                self._insert_request_device(padded, slot, t_full - 1)
                joined = True
            else:
                with torch.inference_mode():
                    _decode.slot_join(self._state, slot, 0)
                joined = True
        _profiler.record_phase("serving", "host_input",
                               time.perf_counter() - t0, start=t0)
        if not joined:
            return False
        self._uri[slot] = uri
        self._tokens[slot] = list(prefix)
        self._budget[slot] = budget
        self._expires[slot] = exp
        self._enqueue_t[slot] = float(rec.get("enqueue_t") or now)
        # an adopted stream's TTFT was observed where it started
        self._first_t[slot] = now if prefix else None
        self._streamed[slot] = len(prefix)
        self._next_tokens[slot] = int(full[-1])
        self._prompt[slot] = prompt
        self._deadline_ms[slot] = rec.get("deadline_ms")
        if self._sampling:
            seed = rec.get("seed")
            if seed is None:  # fresh entropy: repeated requests differ
                seed = int(np.random.SeedSequence().entropy % (2 ** 31))
            # the request's whole schedule: step i draws row i, as serial
            # sample_generate's gumbel_noise(seed, [budget, 1, vocab])
            self._seed[slot] = int(seed)
            self._noise[slot] = _decode.gumbel_noise(
                seed, (budget, self.lm.vocab_size))
        self._active_host[slot] = True
        return True

    def _admit(self) -> None:
        free = [i for i in range(self.slots) if not self._active_host[i]]
        if not free:
            return
        self._shed()
        try:
            got = self.queue.claim_batch(len(free))
            self._claim_fail_streak = 0
        except OSError as e:
            self._count("claim_faults")
            self._claim_fail_streak += 1
            if self._claim_fail_streak > self.config.claim_retries:
                raise  # a dead backend, not a flaky one
            logger.warning("transient claim failure (%d/%d): %r",
                           self._claim_fail_streak,
                           self.config.claim_retries, e)
            return
        if not got:
            return
        self._note_claimed(got)
        now = wall_clock()
        for uri, rec in got:
            slot = free.pop(0)
            if not self._join(slot, uri, rec, now):
                free.insert(0, slot)

    # -- the step loop -----------------------------------------------------------

    def _expire_slots(self) -> None:
        """The per-token deadline check: an expired stream is evicted
        mid-flight with the deadline error as its one terminal."""
        now = wall_clock()
        mask = np.zeros(self.slots, bool)
        for i in range(self.slots):
            if (self._active_host[i] and self._expires[i] is not None
                    and now >= self._expires[i]):
                mask[i] = True
                self._retire(i, {"error": DEADLINE_ERROR}, counter="expired")
        if mask.any():
            self._evict_slots(mask)

    def _fail_active(self, message: str) -> None:
        mask = self._active_host.copy()
        for i in np.flatnonzero(mask):
            self._retire(int(i), {"error": message}, counter="errors")
        if mask.any():
            self._evict_slots(mask)

    def _post_tokens(self, emitted: np.ndarray, n_acc: np.ndarray) -> None:
        """Fold a step's tokens into every active stream: ``emitted[i,
        :n_acc[i]]`` (one token a step; up to ``spec_k + 1`` a speculative
        round, cut at the budget and at eos on the host, where the stream
        is retired in the same pass, so the device's over-advanced length
        never feeds another step). TTFT at the first token, a partial every
        ``stream_interval`` tokens (stretched by brownout), the terminal
        and eviction at eos or at the budget."""
        now = wall_clock()
        cfg = self.config
        stride = self._brownout.stream_stride(cfg.stream_interval)
        finished = np.zeros(self.slots, bool)
        n_tok = 0
        for i in range(self.slots):
            if not self._active_host[i]:
                continue
            take = min(int(n_acc[i]), self._budget[i] - len(self._tokens[i]))
            toks = [int(x) for x in emitted[i, :take]]
            if cfg.eos_id is not None and cfg.eos_id in toks:
                toks = toks[:toks.index(cfg.eos_id) + 1]
            if not toks:
                continue
            self._tokens[i].extend(toks)
            self._next_tokens[i] = toks[-1]
            n_tok += len(toks)
            if self._first_t[i] is None:
                self._first_t[i] = now
                self._m_ttft.observe(max(now - self._enqueue_t[i], 0.0))
            if (len(self._tokens[i]) >= self._budget[i]
                    or (cfg.eos_id is not None and toks[-1] == cfg.eos_id)):
                finished[i] = True
                self._retire(i, {"value": list(self._tokens[i]),
                                 "done": True})
            elif (stride > 0
                  and len(self._tokens[i]) - self._streamed[i] >= stride):
                try:
                    self.queue.put_result(self._uri[i], self._partial(i))
                    self._streamed[i] = len(self._tokens[i])
                except OSError:
                    logger.exception("partial result for %s failed",
                                     self._uri[i])
        if n_tok:
            self._m_tokens.inc(n_tok)
        if finished.any():
            self._evict_slots(finished)

    def _partial(self, slot: int) -> Dict[str, Any]:
        """A progress record: the tokens so far and, when sampling, the
        seed (what a resumed request passes to go on identically)."""
        out: Dict[str, Any] = {"stream": list(self._tokens[slot]),
                               "done": False}
        if self._seed[slot] is not None:
            out["seed"] = self._seed[slot]
        return out

    def serve_step(self) -> int:
        """One scheduler step: evict expired streams, admit requests into
        free slots (shed, then prefill), run one decode step (or
        speculative round) over every occupied slot, stream and terminate.
        Returns the number of streams stepped; :meth:`run` loops it."""
        self._maybe_write_health()
        self._expire_slots()
        if not self._draining.is_set():
            self._admit()
        n_active = int(np.sum(self._active_host))
        self._m_slots.set(n_active)
        if n_active == 0:
            return 0
        t_step = time.perf_counter()
        try:
            out = self._fetch_tokens(self._dispatch_step(
                self._next_tokens, self._step_noise()))
        except Exception as e:
            logger.exception("decode step failed for %d streams", n_active)
            self._fail_active(repr(e))
            return 0
        self.steps += 1
        if self._spec:
            emitted, n_acc = out[:, :-1], out[:, -1]
            live = n_acc[self._active_host]
            accepted = int(np.maximum(live - 1, 0).sum())
            self.spec_totals["proposed"] += self._spec_k * n_active
            self.spec_totals["accepted"] += accepted
            self._m_spec_accept.set(accepted / (self._spec_k * n_active))
            n_emitted = int(live.sum())
        else:
            emitted, n_acc = out[:, None], np.ones(self.slots, np.int64)
            n_emitted = n_active
        per = (time.perf_counter() - t_step) / max(n_emitted, 1)
        self._ewma_token_s = (per if self._ewma_token_s == 0.0
                              else 0.8 * self._ewma_token_s + 0.2 * per)
        self._post_tokens(emitted, n_acc)
        return n_active

    # -- lifecycle (as ClusterServing) -------------------------------------------

    def run(self, poll_interval_s: float = 0.005) -> None:
        logger.info("generative serving started (src=%s slots=%d)",
                    self.config.data_src, self.slots)
        ops_alerts.ensure_default()  # a no-op unless ops.enabled
        self.terminal_state = None
        self._loop_running = True
        self._last_shed_m = -1e18
        try:
            while (not self._stop.is_set()
                   and not self._handoff_evt.is_set()):
                stepped = self.serve_step()
                if self._draining.is_set() and stepped == 0:
                    return  # drained: every stream in flight finished
                if stepped == 0:
                    time.sleep(poll_interval_s)
        finally:
            self._loop_running = False
            if self._stop.is_set():
                self._fail_active(SHUTDOWN_ERROR)
            self._maybe_write_health()

    def start(self) -> "GenerativeServing":
        """Run the loop in a background thread; a crash there is re-raised
        by :meth:`stop`, :meth:`drain` and :meth:`check_health`."""
        ops_alerts.ensure_default()  # a no-op unless ops.enabled
        self._stop.clear()
        self._draining.clear()
        self._handoff_evt.clear()
        self.terminal_state = None
        self._background_error = None

        def _run() -> None:
            try:
                self.run()
            except BaseException as e:
                logger.exception("generative serving loop died")
                self._background_error = e

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="zoo-generative-loop")
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> None:
        """Stop admitting and finish every stream in flight (each runs to
        its budget, eos or deadline), then write the terminal health."""
        self._draining.set()
        if self._loop_running and self._thread is None:
            return  # a foreground run(): the loop ends itself
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            if t.is_alive():
                raise RuntimeError(
                    f"drain did not complete within {timeout_s}s "
                    f"({int(np.sum(self._active_host))} streams active)")
            self._thread = None
        if self.terminal_state is None:
            self._emit_terminal("drained")
        self._write_health()
        self.check_health()

    def handoff(self, to_queue: QueueBackend, timeout_s: float = 30.0
                ) -> int:
        """Drain without finishing here: pause the loop and re-enqueue
        every stream in flight on ``to_queue`` with its ``prompt``, the
        tokens decoded so far as its ``prefix``, its full budget, its
        ``enqueue_t``, deadline and sampling ``seed``, so another server
        adopts it mid-stream and goes on as it would have. No terminal is
        posted here; the adopting server posts the stream's one terminal.
        A stream whose re-enqueue fails gets a shutdown error instead.
        Returns the number of streams handed off."""
        self._draining.set()
        self._handoff_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            if t.is_alive():
                raise RuntimeError(
                    f"handoff: serve loop did not pause within {timeout_s}s")
            self._thread = None
        elif self._loop_running:
            # a foreground run(): wait for the loop to notice the event
            deadline = time.monotonic() + timeout_s
            while self._loop_running:
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"handoff: serve loop did not pause within "
                        f"{timeout_s}s")
                time.sleep(0.002)
        moved = 0
        mask = np.zeros(self.slots, bool)
        for i in range(self.slots):
            if not self._active_host[i]:
                continue
            uri = self._uri[i]
            rec: Dict[str, Any] = {
                "prompt": list(self._prompt[i]),
                "prefix": list(self._tokens[i]),
                "max_new_tokens": self._budget[i],
                "enqueue_t": self._enqueue_t[i],
            }
            if self._deadline_ms[i] is not None:
                rec["deadline_ms"] = self._deadline_ms[i]
            if self._seed[i] is not None:
                rec["seed"] = self._seed[i]
            mask[i] = True
            try:
                to_queue.enqueue(uri, rec)
            except Exception:
                logger.exception("handoff enqueue for %s failed", uri)
                self._retire(i, {"error": SHUTDOWN_ERROR}, counter="errors")
                continue
            self._abandon(i)
            moved += 1
        if mask.any():
            self._evict_slots(mask)
        if self.terminal_state is None:
            self._emit_terminal("drained")
        self._write_health()
        self.check_health()
        return moved

    def stop(self) -> None:
        """Hard stop: active streams get explicit shutdown errors."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                self._thread = None
                raise RuntimeError(
                    "generative serving loop did not shut down within 10s "
                    "(queue backend wedged?); thread leaked")
            self._thread = None
        else:
            self._fail_active(SHUTDOWN_ERROR)
        if self.terminal_state is None:
            self._emit_terminal("stopped")
        self._write_health()
        self.check_health()

    def health_snapshot(self) -> Dict[str, Any]:
        """Lifecycle state, queue depth, slots occupied, tokens decoded,
        page pool, speculative acceptance, brownout rung, TTFT and latency
        percentiles (ms) and the counters: the JAX package's keys, a
        per-instance view of the metrics registry."""
        snap = self._health_common()
        snap.update({
            "slots": self.slots,
            "slots_occupied": int(np.sum(self._active_host)),
            "tokens_total": int(self._m_tokens.value()),
            "tokens_per_sec_ewma": (round(1.0 / self._ewma_token_s, 1)
                                    if self._ewma_token_s > 0 else None),
            "kv_pages_free": (len(self._free_pages) if self._paged
                              else None),
            "kv_shards": 1 if self._paged else None,
            "kv_pages_free_min_shard": None,
            "spec_accept_ratio": (
                round(float(self._m_spec_accept.value()), 4)
                if self._spec else None),
            "brownout_level": self._brownout.level,
            "ttft_ms": {"p50": self._pct_ms(self._m_ttft, 0.50),
                        "p99": self._pct_ms(self._m_ttft, 0.99),
                        "window": self._m_ttft.count()},
            "latency_ms": {"p50": self._pct_ms(self._m_latency, 0.50),
                           "p99": self._pct_ms(self._m_latency, 0.99),
                           "window": self._m_latency.count()},
            "counters": {k: int(c.value()) for k, c in self._m.items()},
            "model_version": self.model_version,
            "alerts": sorted(ops_alerts.active_alerts()),
            "incident": ops_incident.last_incident(),
            "error": (repr(self._background_error)
                      if self._background_error is not None else None),
        })
        return snap


def main() -> None:
    """CLI entry: read a YAML config, write a pidfile, serve on the card.
    SIGTERM drains; SIGINT stops hard."""
    import signal
    import sys
    import tempfile

    cfg = ServingConfig.from_yaml(sys.argv[1] if len(sys.argv) > 1
                                  else "config.yaml")
    # construct before writing the pidfile: a failed start leaves none
    serving = ClusterServing(cfg)
    signal.signal(signal.SIGTERM, lambda *_: serving.drain())
    signal.signal(signal.SIGINT, lambda *_: serving.stop())
    pidfile = os.environ.get(
        "ZOO_SERVING_PIDFILE",
        os.path.join(tempfile.gettempdir(), "zoo_serving.pid"))
    try:
        with open(pidfile, "w") as f:
            f.write(str(os.getpid()))
        serving.run()
    finally:
        try:
            with open(pidfile) as f:
                if f.read().strip() == str(os.getpid()):
                    os.remove(pidfile)
        except OSError:
            pass


if __name__ == "__main__":
    main()
