"""Serving client (counterpart of ``analytics_zoo_tpu/serving/client.py``):
``InputQueue.enqueue_image``/``enqueue_tensor``/``enqueue_prompt``,
``OutputQueue.query``/``dequeue``/``stream``, and ``ResilientClient``.

Every enqueue stamps ``enqueue_t`` (client wall clock, the only clock two
processes share) and a ``trace_id`` that starts the request's flow chain
(``utils/trace.py``), as the JAX client does, so records from either
client are alike; ``deadline_ms`` and ``criticality`` are optional.
:class:`ResilientClient` retries only ``retriable`` terminal errors, within
a token-bucket :class:`RetryBudget`, after full-jitter backoff, and hedges
a slow request with a second copy after a p99-derived delay.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..common.config import global_config
from ..common.utils import wall_clock
from ..utils import trace as _trace
from .queues import FileQueue, QueueBackend, encode_image, make_queue


def _transient(e: BaseException) -> bool:
    """Result-store errors worth retrying a poll through: generic OSErrors,
    timeouts and redis connection errors; shaped path errors stay
    fatal."""
    if isinstance(e, (FileNotFoundError, FileExistsError, IsADirectoryError,
                      NotADirectoryError, PermissionError)):
        return False
    if isinstance(e, (OSError, TimeoutError)):
        return True
    return type(e).__module__.split(".")[0] == "redis"


class _API:
    def __init__(self, src: str = "dir:///tmp/zoo_serving"):
        self.queue: QueueBackend = make_queue(src)

    def _get_result_guarded(self, uri: str, state: Dict[str, int]
                            ) -> Optional[Dict[str, Any]]:
        """``get_result`` absorbing up to ``failure.io_retries`` consecutive
        transient errors with exponential backoff; ``state`` carries the
        failure streak across polls."""
        cfg = global_config()
        retries = int(cfg.get("failure.io_retries") or 0)
        backoff = float(cfg.get("failure.io_backoff_s") or 0.0)
        try:
            res = self.queue.get_result(uri)
        except Exception as e:
            failures = state.get("failures", 0)
            if not _transient(e) or failures >= retries:
                raise
            state["failures"] = failures + 1
            time.sleep(backoff * (2 ** failures))
            return None
        state["failures"] = 0
        return res


class InputQueue(_API):
    @staticmethod
    def _stamp(payload: Dict[str, Any], deadline_ms: Optional[int],
               criticality: Optional[str] = None) -> Dict[str, Any]:
        payload["enqueue_t"] = wall_clock()
        flow_id = _trace.new_trace_id()
        payload["trace_id"] = flow_id
        _trace.flow_point(flow_id, "serving.enqueue", "s")
        if deadline_ms is not None:
            payload["deadline_ms"] = int(deadline_ms)
        if criticality is not None:
            payload["criticality"] = str(criticality)
        return payload

    def enqueue_image(self, uri: str, img,
                      deadline_ms: Optional[int] = None,
                      criticality: Optional[str] = None) -> None:
        """Enqueue one image: an HWC ndarray (sent as a base64 jpg), encoded
        bytes (sent as they are) or a path (read with ``cv2.imread``)."""
        if isinstance(img, str):
            import cv2
            data = cv2.imread(img)
            if data is None:
                raise ValueError(f"unreadable image path {img}")
            img = data
        self.queue.enqueue(uri, self._stamp({"image": encode_image(img)},
                                            deadline_ms, criticality))

    def enqueue_tensor(self, uri: str, tensor,
                       deadline_ms: Optional[int] = None,
                       criticality: Optional[str] = None) -> None:
        """Enqueue one numeric record; ``deadline_ms`` is an answer-by
        budget from now, ``criticality`` picks the admission lane."""
        self.queue.enqueue(
            uri, self._stamp({"tensor": np.asarray(tensor).tolist()},
                             deadline_ms, criticality))

    def enqueue_prompt(self, uri: str, tokens,
                       deadline_ms: Optional[int] = None,
                       max_new_tokens: Optional[int] = None,
                       seed: Optional[int] = None, prefix=None,
                       criticality: Optional[str] = None) -> None:
        """A generative request: ``tokens`` is the int prompt.
        ``max_new_tokens`` caps this stream (else the server's budget);
        ``seed`` makes sampled decoding reproducible; with ``deadline_ms``
        the server checks the deadline every token and evicts an expired
        stream with a deadline error as its one terminal. ``prefix``
        resumes a stream that already decoded some tokens elsewhere: the
        server prefills ``prompt + prefix`` and goes on from there (a
        sampled stream must then pass its original ``seed``)."""
        payload: Dict[str, Any] = {
            "prompt": [int(t) for t in np.asarray(tokens).reshape(-1)]}
        if max_new_tokens is not None:
            payload["max_new_tokens"] = int(max_new_tokens)
        if seed is not None:
            payload["seed"] = int(seed)
        if prefix is not None:
            payload["prefix"] = [int(t) for t in
                                 np.asarray(prefix).reshape(-1)]
        self.queue.enqueue(uri, self._stamp(payload, deadline_ms,
                                            criticality))


class OutputQueue(_API):
    def query(self, uri: str, timeout_s: float = 0.0
              ) -> Optional[Dict[str, Any]]:
        """Result for one uri, polling up to ``timeout_s`` on the monotonic
        clock with exponential backoff."""
        deadline = time.monotonic() + timeout_s
        sleep_s = 0.005
        state: Dict[str, int] = {}
        while True:
            res = self._get_result_guarded(uri, state)
            remaining = deadline - time.monotonic()
            if res is not None or remaining <= 0:
                return res
            time.sleep(min(sleep_s, remaining))
            sleep_s = min(sleep_s * 2, 0.25)

    def dequeue(self) -> Dict[str, Dict[str, Any]]:
        """All available results keyed by uri."""
        if isinstance(self.queue, FileQueue):
            return self.queue.all_results()
        raise NotImplementedError("dequeue-all needs the file queue")

    def stream(self, uri: str, timeout_s: float = 30.0):
        """Yield a generative stream's tokens as the server posts them,
        each new token once, in order. The server overwrites ``uri``'s
        result with growing partials (``{"stream": [...], "done":
        false}``) and then its terminal (``{"value": [...], "done":
        true}`` or ``{"error": ...}``). Raises ``RuntimeError`` on an error
        terminal and ``TimeoutError`` after ``timeout_s`` without progress
        (progress restarts the clock)."""
        seen = 0
        deadline = time.monotonic() + timeout_s
        sleep_s = 0.005
        state: Dict[str, int] = {}
        while True:
            res = self._get_result_guarded(uri, state)
            if res is not None:
                if "error" in res:
                    raise RuntimeError(f"stream {uri!r}: {res['error']}")
                done = bool(res.get("done", True))
                tokens = res.get("value" if done else "stream") or []
                if len(tokens) > seen:
                    for t in tokens[seen:]:
                        yield t
                    seen = len(tokens)
                    deadline = time.monotonic() + timeout_s
                    sleep_s = 0.005
                if done:
                    return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"stream {uri!r}: no progress in "
                                   f"{timeout_s}s ({seen} tokens received)")
            time.sleep(min(sleep_s, remaining))
            sleep_s = min(sleep_s * 2, 0.25)


def _is_terminal(res: Optional[Dict[str, Any]]) -> bool:
    """A request's one terminal: an error, a value, or a generative
    stream's ``done`` record; a stream's partial (``done: false``) is
    progress."""
    return res is not None and ("error" in res or res.get("done", True))


class RetryBudget:
    """Token-bucket retry budget: every first-attempt request deposits
    ``ratio`` tokens (capped at ``burst``); every retry or hedge withdraws
    one whole token. Retry amplification therefore cannot exceed
    ``ratio`` of offered load by construction — against a fleet that sheds
    100% of traffic, a budgeted client converges to ``1 + ratio`` attempts
    per request instead of a retry storm."""

    def __init__(self, ratio: float = 0.1, burst: float = 10.0):
        self.ratio = float(ratio)
        self.burst = max(1.0, float(burst))
        self._tokens = min(1.0, self.burst)  # one early retry allowed
        self._lock = threading.Lock()

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        return self._tokens


class ResilientClient:
    """Retry-budgeted, hedging client wrapper over one queue ``src``.

    ``call()`` enqueues a request, polls its terminal, and — only when the
    terminal error carries ``retriable: true`` (shed / fleet-shed; never
    deadline, validation or shutdown errors), the attempt cap allows it,
    AND the shared :class:`RetryBudget` grants a token — re-enqueues under
    a fresh attempt uri after a full-jitter exponential backoff
    (``uniform(0, base * 2^attempt)``: the jitter decorrelates a thundering
    herd of shed clients). ``query_any()`` hedges tail latency instead: a
    second copy races the first after a p99-derived delay, the first
    terminal wins and the loser is reaped via ``discard_result`` — never
    surfaced. Every attempt uses its own uri, so the server-side
    exactly-one-terminal invariant is untouched.

    Amplification accounting for SLO audits: ``attempts_sent /
    requests_sent`` is the measured retry amplification, bounded by
    ``1 + client.retry_budget_ratio`` by construction.

    A generative stream's partials (``{"stream": [...], "done": false}``)
    are progress: both paths wait for the stream's terminal, and a hedge
    loser is reaped once its terminal has landed (JAX's client returns
    the first partial as the answer and reaps a loser mid-stream, which
    its later partials re-create)."""

    def __init__(self, src: str,
                 budget_ratio: Optional[float] = None,
                 attempts: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 hedge_delay_ms: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        cfg = global_config()
        if budget_ratio is None:
            budget_ratio = float(cfg.get("client.retry_budget_ratio"))
        self.inputs = InputQueue(src)
        self.outputs = OutputQueue(src)
        self.budget = RetryBudget(budget_ratio)
        self.attempts = int(attempts if attempts is not None
                            else cfg.get("client.retry_attempts"))
        self.backoff_s = float(backoff_s if backoff_s is not None
                               else cfg.get("client.retry_backoff_s"))
        self.hedge_delay_s = float(
            hedge_delay_ms if hedge_delay_ms is not None
            else cfg.get("client.hedge_delay_ms")) / 1000.0
        self._rng = rng if rng is not None else random.Random()
        self._lat: List[float] = []  # recent terminal latencies (monotonic)
        self._pending_reaps: List[str] = []
        self._lock = threading.Lock()
        self.requests_sent = 0   # logical requests (first attempts)
        self.attempts_sent = 0   # every enqueue: first + retries + hedges

    # -- bookkeeping ----------------------------------------------------------

    def _note_latency(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(seconds)
            if len(self._lat) > 512:
                del self._lat[:256]

    def _p99_delay(self) -> float:
        """Hedge trigger: observed p99 latency once enough history exists,
        else the configured ``client.hedge_delay_ms`` floor."""
        with self._lock:
            lat = sorted(self._lat)
        if len(lat) >= 20:
            return lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        return self.hedge_delay_s

    def _jitter(self, attempt: int) -> float:
        # full jitter: anywhere in [0, base * 2^attempt) — retries from a
        # synchronized shed wave land spread out, not in lockstep
        return self._rng.uniform(0.0, self.backoff_s * (2 ** attempt))

    def reap_pending(self) -> int:
        """Discard any landed results of past hedge losers (lazy reaping:
        a loser still in flight when its race ended is reaped on a later
        call). Returns how many were removed this pass."""
        with self._lock:
            pending, self._pending_reaps = self._pending_reaps, []
        reaped = 0
        for uri in pending:
            try:
                landed = _is_terminal(self.outputs.queue.get_result(uri))
            except Exception:
                landed = False
            if landed and self.outputs.queue.discard_result(uri):
                reaped += 1
            else:
                with self._lock:
                    self._pending_reaps.append(uri)
        return reaped

    def _await_terminal(self, uri: str, timeout_s: float
                        ) -> Optional[Dict[str, Any]]:
        """Poll ``uri`` until its terminal lands (see :func:`_is_terminal`)
        or ``timeout_s`` passes; None then."""
        deadline = time.monotonic() + timeout_s
        while True:
            res = self.outputs.query(
                uri, timeout_s=max(0.0, deadline - time.monotonic()))
            if res is None or _is_terminal(res):
                return res
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.005)

    # -- request paths --------------------------------------------------------

    def call(self, uri: str, enqueue: Callable[[str], None],
             timeout_s: float = 30.0) -> Optional[Dict[str, Any]]:
        """One logical request with budgeted retries. ``enqueue`` is called
        with the attempt uri (``uri``, then ``uri~r1``, ...) and must
        enqueue exactly one copy of the request under that uri."""
        self.reap_pending()
        deadline = time.monotonic() + timeout_s
        self.requests_sent += 1
        self.budget.deposit()
        attempt = 0
        attempt_uri = uri
        while True:
            t0 = time.monotonic()
            self.attempts_sent += 1
            enqueue(attempt_uri)
            res = self._await_terminal(
                attempt_uri, max(0.0, deadline - time.monotonic()))
            if res is None:
                return None  # timed out: nothing terminal to retry on
            if "error" not in res:
                self._note_latency(time.monotonic() - t0)
                return res
            remaining = deadline - time.monotonic()
            if (not res.get("retriable") or attempt >= self.attempts
                    or remaining <= 0 or not self.budget.try_spend()):
                return res
            time.sleep(min(self._jitter(attempt), max(0.0, remaining)))
            attempt += 1
            attempt_uri = f"{uri}~r{attempt}"

    def query_any(self, uri: str, enqueue: Callable[[str], None],
                  timeout_s: float = 30.0,
                  hedge_delay_s: Optional[float] = None
                  ) -> Optional[Dict[str, Any]]:
        """Hedged request: enqueue ``uri``, wait a p99-derived delay, and
        if no terminal landed, race a second copy (``uri~h``) — subject to
        the same retry budget. The first terminal to land wins; the
        loser's result is reaped, never surfaced."""
        self.reap_pending()
        deadline = time.monotonic() + timeout_s
        self.requests_sent += 1
        self.budget.deposit()
        self.attempts_sent += 1
        t0 = time.monotonic()
        enqueue(uri)
        delay = hedge_delay_s if hedge_delay_s is not None \
            else self._p99_delay()
        res = self._await_terminal(
            uri, min(delay, max(0.0, deadline - time.monotonic())))
        if res is not None:
            self._note_latency(time.monotonic() - t0)
            return res
        hedge_uri = f"{uri}~h"
        hedged = self.budget.try_spend()
        if hedged:
            self.attempts_sent += 1
            enqueue(hedge_uri)
        sleep_s = 0.005
        state: Dict[str, int] = {}
        hstate: Dict[str, int] = {}
        while True:
            res = self.outputs._get_result_guarded(uri, state)
            if _is_terminal(res):
                winner, loser = uri, hedge_uri if hedged else None
                break
            if hedged:
                res = self.outputs._get_result_guarded(hedge_uri, hstate)
                if _is_terminal(res):
                    winner, loser = hedge_uri, uri
                    break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            time.sleep(min(sleep_s, remaining))
            sleep_s = min(sleep_s * 2, 0.25)
        if loser is not None:
            with self._lock:
                self._pending_reaps.append(loser)
            self.reap_pending()
        self._note_latency(time.monotonic() - t0)
        return res
