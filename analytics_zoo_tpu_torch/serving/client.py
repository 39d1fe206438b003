"""Serving client (counterpart of ``analytics_zoo_tpu/serving/client.py``):
``InputQueue.enqueue_tensor`` and ``OutputQueue.query``/``dequeue``.

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
from .queues import FileQueue, QueueBackend, make_queue


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

    def enqueue_tensor(self, uri: str, tensor,
                       deadline_ms: Optional[int] = None,
                       criticality: Optional[str] = None) -> None:
        """Enqueue one numeric record; ``deadline_ms`` is an answer-by
        budget from now, ``criticality`` picks the admission lane."""
        self.queue.enqueue(
            uri, self._stamp({"tensor": np.asarray(tensor).tolist()},
                             deadline_ms, criticality))


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
