"""Metric history (counterpart of ``analytics_zoo_tpu/ops/history.py``):
fixed-size per-series rings over the metrics registry.

The registry (``common/metrics.py``) holds "now": gauges their current
value, counters their running total. Burn-rate alerts and incident
bundles need windows, so :class:`MetricHistory` samples the registry on a
cadence into bounded per-series rings:

- **Fixed-size.** Each ``(metric, label)`` series keeps the newest
  ``ops.history_depth`` samples.
- **Delta-aware for counters.** :meth:`delta` sums the positive increments
  in a window, so a counter reset adds the post-reset value (PromQL's
  ``increase()``).
- **Histogram-aware.** Histogram samples carry the snapshot summary
  (``count``/``sum``/``p50``/``p90``/``p99``); window queries pick a key.
- **Near-zero cost when off.** Nothing samples until :meth:`start`, which
  ``ops.alerts.ensure_default`` calls only with ``ops.enabled``.

Timestamps are ``wall_clock()``: history is a cross-process artifact.
Tests call :meth:`sample_once` with an explicit ``now``.
"""
from __future__ import annotations

import collections
import logging
import threading
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..common import metrics as _metrics
from ..common.config import global_config
from ..common.utils import wall_clock

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["MetricHistory"]

Sample = Tuple[float, Any]  # (wall, value-or-histogram-summary)


class MetricHistory:
    """Sampler + ring store over one metrics registry (the process
    default unless a fresh test registry is passed)."""

    def __init__(self, registry: Optional[_metrics.Registry] = None,
                 depth: Optional[int] = None,
                 interval_s: Optional[float] = None):
        cfg = global_config()
        self._reg = registry if registry is not None \
            else _metrics.default_registry()
        self.depth = int(depth if depth is not None
                         else cfg.get("ops.history_depth"))
        self.interval_s = float(interval_s if interval_s is not None
                                else cfg.get("ops.sample_interval_s"))
        self._series: Dict[Tuple[str, str], Deque[Sample]] = {}
        self._kinds: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling -------------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> float:
        """Take one registry snapshot into the rings. ``now`` is
        injectable for fake-clock tests; production sampling stamps
        :func:`wall_clock`."""
        t = wall_clock() if now is None else float(now)
        snap = self._reg.snapshot()
        with self._lock:
            for name, entry in snap.items():
                kind = entry.get("type", "untyped")
                self._kinds[name] = kind
                if "series" in entry:
                    items = entry["series"].items()
                elif kind == "histogram":
                    items = [("", entry.get("summary"))]
                else:
                    items = [("", entry.get("value"))]
                for label, val in items:
                    if val is None:
                        continue
                    dq = self._series.get((name, label))
                    if dq is None:
                        dq = self._series[(name, label)] = \
                            collections.deque(maxlen=self.depth)
                    dq.append((t, val))
        return t

    def start(self) -> "MetricHistory":
        """Start the daemon sampler thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _run() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception:
                    logger.debug("metric history sample failed",
                                 exc_info=True)

        self._thread = threading.Thread(
            target=_run, name="zoo-ops-history", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    # -- queries --------------------------------------------------------------

    @staticmethod
    def _num(val: Any, key: Optional[str]) -> Optional[float]:
        if isinstance(val, dict):
            val = val.get(key or "count")
        if val is None:
            return None
        try:
            return float(val)
        except (TypeError, ValueError):
            return None

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(name)

    def labels_for(self, name: str) -> List[str]:
        with self._lock:
            return sorted(l for (n, l) in self._series if n == name)

    def latest(self, name: str, label: str = "") -> Optional[Sample]:
        with self._lock:
            dq = self._series.get((name, label))
            return dq[-1] if dq else None

    def window(self, name: str, label: str = "",
               seconds: Optional[float] = None,
               now: Optional[float] = None) -> List[Sample]:
        """Samples of one series inside the trailing window (all retained
        samples when ``seconds`` is None)."""
        with self._lock:
            dq = list(self._series.get((name, label), ()))
        if not dq:
            return []
        if now is None:
            now = dq[-1][0]
        if seconds is None:
            return [(t, v) for t, v in dq if t <= now]
        lo = now - float(seconds)
        return [(t, v) for t, v in dq if lo <= t <= now]

    def delta(self, name: str, label: str = "",
              seconds: Optional[float] = None,
              now: Optional[float] = None,
              key: Optional[str] = None) -> Optional[float]:
        """Counter increase over the trailing window: the sum of positive
        consecutive increments, reset-tolerant (a decrease counts the
        post-reset value from zero). The last sample *before* the window
        seeds the baseline so the first in-window increment is not lost.
        Returns ``None`` when the series has no sample in the window."""
        with self._lock:
            dq = list(self._series.get((name, label), ()))
        if not dq:
            return None
        if now is None:
            now = dq[-1][0]
        lo = (now - float(seconds)) if seconds is not None else None
        prev: Optional[float] = None
        total = 0.0
        seen = False
        for t, val in dq:
            if t > now:
                break
            x = self._num(val, key)
            if x is None:
                continue
            if lo is not None and t < lo:
                prev = x  # pre-window baseline
                continue
            seen = True
            if prev is not None:
                d = x - prev
                if d > 0:
                    total += d
                elif d < 0:
                    total += x  # counter reset between samples
            prev = x
        return total if seen else None

    def rate(self, name: str, label: str = "", seconds: float = 60.0,
             now: Optional[float] = None,
             key: Optional[str] = None) -> Optional[float]:
        """Windowed per-second rate of a counter (``delta / seconds``)."""
        d = self.delta(name, label, seconds, now, key)
        if d is None or seconds <= 0:
            return None
        return d / float(seconds)

    def dump(self, seconds: Optional[float] = None,
             now: Optional[float] = None
             ) -> Dict[str, Dict[str, List[List[Any]]]]:
        """JSON-ready ``{metric: {label: [[wall, value], ...]}}`` of the
        trailing window — the "related metric history" an incident
        bundle seals."""
        with self._lock:
            keys = list(self._series)
        out: Dict[str, Dict[str, List[List[Any]]]] = {}
        for name, label in keys:
            win = self.window(name, label, seconds, now)
            if win:
                out.setdefault(name, {})[label] = \
                    [[t, v] for t, v in win]
        return out
