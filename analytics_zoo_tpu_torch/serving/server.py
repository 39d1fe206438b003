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
overload sheds with explicit errors; :meth:`ClusterServing.drain` finishes
in-flight work before it stops.

Later slices bring brownout, the ops-plane events, fault-injection sites,
trace flow points, TensorBoard summaries, ``reload_model``, the
``health.json`` writer and ``GenerativeServing``.
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..common.context import DeviceLike
from ..common.utils import time_it, wall_clock
from ..inference.inference_model import InferenceModel
from .config import ServingConfig
from .queues import QueueBackend, decode_image, make_queue

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

#: canonical terminal error texts (clients match on these)
SHED_ERROR = "shed: queue overloaded"
DEADLINE_ERROR = "deadline exceeded"
SHUTDOWN_ERROR = "serving shut down before this request completed"


def top_n(probs: np.ndarray, n: int) -> List[Dict[str, float]]:
    """Per-record topN (class, prob) filter."""
    idx = np.argsort(-probs)[:n]
    return [{"class": int(i), "prob": float(probs[i])} for i in idx]


class ClusterServing:
    #: min seconds between shed passes (a shed lists the whole backlog)
    SHED_INTERVAL_S = 0.05
    #: terminal latencies kept for :meth:`latency_ms`
    LATENCY_WINDOW = 8192

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
            else self._load_model(device)
        self.model.prewarm(self._example_batch(),
                           buckets=(config.batch_size,))
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool = None
        self._background_error: Optional[BaseException] = None
        self.records_served = 0
        self.batches_dispatched = 0
        self.device_seconds = 0.0  # blocked-on-fetch time across batches
        self._lock = threading.Lock()
        self._counters = {"shed": 0, "expired": 0, "errors": 0,
                          "claim_faults": 0}
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=self.LATENCY_WINDOW)
        self._in_flight = 0  # claimed, no terminal result yet
        self._enqueue_t: Dict[str, float] = {}  # uri -> client enqueue_t
        self._ewma_record_s = 0.0  # smoothed device seconds per record
        self._last_shed_m = -1e18
        self._claim_fail_streak = 0
        self._loop_running = False
        self.terminal_state: Optional[str] = None

    def _load_model(self, device: DeviceLike) -> InferenceModel:
        cfg = self.config
        if cfg.model_type != "zoo":
            raise NotImplementedError(
                f"model_type {cfg.model_type!r} is not ported yet; the "
                f"torch port serves 'zoo' models")
        im = InferenceModel(concurrent_num=cfg.concurrent_num, device=device)
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

    # -- record prep ----------------------------------------------------------

    def _prepare(self, record: Dict[str, Any]) -> np.ndarray:
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

    @property
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] += n

    def latency_ms(self, p: float) -> Optional[float]:
        """Percentile ``p`` (0..1) of enqueue-to-terminal latency over the
        recent window, in ms; None before any terminal."""
        with self._lock:
            lat = sorted(self._latencies)
        if not lat:
            return None
        return lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3

    def _expiry(self, rec: Dict[str, Any]) -> Optional[float]:
        """Absolute wall-clock expiry, or None. Wall clock on purpose: the
        client stamps ``enqueue_t`` in another process."""
        deadline_ms = rec.get("deadline_ms") or self.config.default_deadline_ms
        if not deadline_ms:
            return None
        t0 = rec.get("enqueue_t")
        base = float(t0) if t0 is not None else wall_clock()
        return base + float(deadline_ms) / 1000.0

    def _post_terminal(self, uri: str, value: Dict[str, Any]) -> None:
        """The one place a claimed request gets its terminal result. Error
        results carry ``retriable``: only shed errors are."""
        if "error" in value and "retriable" not in value:
            value = dict(value)
            value["retriable"] = value["error"] == SHED_ERROR
        try:
            self.queue.put_result(uri, value)
        except OSError:
            logger.exception("posting result for %s failed", uri)
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
            t0 = self._enqueue_t.pop(uri, None)
            if t0 is not None:
                self._latencies.append(max(wall_clock() - t0, 0.0))

    def _error_batch(self, uris: List[str], message: str,
                     counter: str = "errors") -> None:
        for uri in uris:
            self._post_terminal(uri, {"error": message})
        if uris:
            self._count(counter, len(uris))

    # -- pipeline stages ------------------------------------------------------

    def _shed(self) -> None:
        """Erroring admission control: ``max_pending`` caps the depth;
        ``shed_wait_ms`` caps the estimated wait of the queue tail."""
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
        if dropped:
            self._count("shed", len(dropped))
            logger.warning("overload: shed %d oldest requests with error "
                           "results (allowed depth %d)", len(dropped),
                           allowed)

    def _claim(self) -> List[Tuple[str, Dict[str, Any]]]:
        """Shed, then fill one micro-batch within ``batch_wait_ms`` on the
        monotonic clock. Transient claim failures are retried with jittered
        backoff; ``claim_retries`` in a row surface the backend as dead."""
        cfg = self.config
        self._shed()
        deadline = time.monotonic() + cfg.batch_wait_ms / 1000.0
        batch: List[Tuple[str, Dict[str, Any]]] = []
        while len(batch) < cfg.batch_size and time.monotonic() < deadline:
            try:
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
            now = wall_clock()
            with self._lock:
                self._in_flight += len(batch)
                for uri, rec in batch:
                    self._enqueue_t[uri] = float(rec.get("enqueue_t") or now)
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
                exp = self._expiry(rec)
                if exp is not None and wall_clock() >= exp:
                    expired.append(uri)
                    continue
                uris.append(uri)
                arrays.append(arr)
                expiries.append(exp)
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
        """Async dispatch of one decoded batch; returns the fetch thunk."""
        with time_it("serving.dispatch_batch"):
            handle = self.model.predict_async(x)
        with self._lock:
            self.batches_dispatched += 1
        return handle

    def _writeback(self, uris: List[str], probs: np.ndarray,
                   device_elapsed: float) -> None:
        cfg = self.config
        with time_it("serving.writeback_batch"):
            for uri, p in zip(uris, probs):
                p = np.asarray(p).reshape(-1)
                if cfg.filter_top_n:
                    self._post_terminal(
                        uri, {"topN": top_n(p, cfg.filter_top_n)})
                else:
                    self._post_terminal(uri, {"value": p.tolist()})
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

    # -- the serve loop -------------------------------------------------------

    def serve_once(self) -> int:
        """One synchronous micro-batch (claim -> decode -> predict ->
        writeback); returns the number of records claimed, each of which
        has its terminal result when this returns."""
        batch = self._claim()
        if not batch:
            return 0
        claimed = len(batch)
        uris, x, expiries = self._stack(
            *self._decode(self._filter_expired(batch)))
        if uris:
            uris, x = self._expire_before_dispatch(uris, x, expiries)
        if uris:
            start = time.perf_counter()
            try:
                fetch = self._dispatch(x)
                probs = np.asarray(fetch())
                self._writeback(uris, probs, time.perf_counter() - start)
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
                    t0 = time.perf_counter()
                    probs = fetch()  # waits for the card's result only
                    self._writeback(uris, np.asarray(probs),
                                    time.perf_counter() - t0)
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
            self.terminal_state = ("crashed" if errors
                                   else "drained" if drained else "stopped")
        if errors:
            raise errors[0]

    def start(self) -> "ClusterServing":
        """Run the loop in a background thread; a crash there is re-raised
        by :meth:`stop`, :meth:`drain` and :meth:`check_health`."""
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

    def check_health(self) -> None:
        """Raise the background loop's failure, if any."""
        err = self._background_error
        if err is not None:
            raise RuntimeError("serving loop died in the background") from err

    def drain(self, timeout_s: float = 30.0) -> None:
        """Graceful shutdown: stop claiming, finish every in-flight batch,
        flush all results. Called on a foreground :meth:`run` (e.g. from a
        SIGTERM handler) it only flags the loop, which unwinds itself."""
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
            self.terminal_state = "drained"
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
            self.terminal_state = "stopped"
        self.check_health()


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
