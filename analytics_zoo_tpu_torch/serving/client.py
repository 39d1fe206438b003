"""Serving client (counterpart of ``analytics_zoo_tpu/serving/client.py``):
``InputQueue.enqueue_image``/``enqueue_tensor``/``enqueue_prompt`` and
``OutputQueue.query``/``dequeue``/``stream``.

Every enqueue stamps ``enqueue_t`` (client wall clock, the only clock two
processes share) and a ``trace_id``, as the JAX client does, so records
from either client are alike; ``deadline_ms`` and ``criticality`` are
optional. The retry-budgeted ``ResilientClient`` is a later slice.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np

from ..common.config import global_config
from ..common.utils import wall_clock
from .queues import FileQueue, QueueBackend, encode_image, make_queue


def _transient(e: BaseException) -> bool:
    """Result-store errors worth retrying a poll through: generic OSErrors
    and timeouts; shaped path errors stay fatal."""
    if isinstance(e, (FileNotFoundError, FileExistsError, IsADirectoryError,
                      NotADirectoryError, PermissionError)):
        return False
    return isinstance(e, (OSError, TimeoutError))


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
        except (OSError, TimeoutError) as e:
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
        payload["trace_id"] = int.from_bytes(os.urandom(4), "big") \
            & 0x7FFFFFFF
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
