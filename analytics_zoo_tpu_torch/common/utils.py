"""Small runtime utilities (counterpart of ``analytics_zoo_tpu/common/
utils.py``): the ``time_it`` wall-time span registry, its span hooks (a
live ``utils.trace.trace`` session is one) and ``wall_clock``."""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple

logger = logging.getLogger("analytics_zoo_tpu_torch")


class _TimerRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._totals[name] += seconds
            self._counts[name] += 1

    def stats(self) -> Dict[str, Tuple[float, int]]:
        with self._lock:
            return {k: (self._totals[k], self._counts[k]) for k in self._totals}

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()


timers = _TimerRegistry()


@contextlib.contextmanager
def time_it(name: str) -> Iterator[None]:
    """Add the wall time of the ``with`` body to ``timers`` under
    ``name`` and offer the span to every hook in ``span_hooks``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        timers.add(name, elapsed)
        # a snapshot: a hook added or removed on another thread meanwhile
        # must not break this span's exit
        for hook in tuple(span_hooks):
            hook(name, start, elapsed)


def wall_clock() -> float:
    """Epoch seconds for stamps that cross process boundaries (request
    ``enqueue_t``, spool file names, client deadlines). Every purely local
    interval uses ``time.monotonic()`` instead."""
    return time.time()


#: span observers, called as ``fn(name, start_perf_counter, seconds)``
#: by ``time_it`` (the profiler offers its phases to them too)
span_hooks: list = []
