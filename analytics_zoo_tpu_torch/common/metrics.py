"""Process-global, thread- and fork-safe metrics registry (counterpart of
``analytics_zoo_tpu/common/metrics.py``, the same code in a registry of the
port's own).

- :class:`Counter`, :class:`Gauge` and :class:`Histogram` with label
  support, registered once per process under ``subsystem.noun_unit`` names
  (the JAX package's names, so one dashboard reads both packages);
- every value lives in a ``multiprocessing.shared_memory`` slab of float64
  slots created before any fork, so a counter incremented inside a forked
  child is visible to the parent's exposition;
- all histograms share one fixed log-spaced bucket layout
  (:data:`BUCKET_BOUNDS`), so p50/p99 come from the same code everywhere;
- two exposition paths: :func:`expose_text` (Prometheus text format,
  written to ``metrics.prom`` next to ``health.json`` by the serving health
  writer) and :func:`metrics_snapshot` (a structured dict; the servers'
  ``health_snapshot()`` is a view of it).

Cost model: with the registry disabled (``metrics.enabled`` config flag or
:func:`set_enabled`), every record call is an attribute load and a boolean
check. Enabled, each record takes one cross-process lock round-trip.

Fork caveats: slot allocations and label combos created in a forked child
write to the shared slab, but the parent's name-to-slot map only knows
combos that existed before the fork, so pre-create (``.labels(...)``) any
combo a child will touch. CUDA does not survive a fork: children that use
the card are started with ``spawn`` and have registries of their own.
"""
from __future__ import annotations

import atexit
import logging
import math
import os
import threading
import warnings
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = [
    "BUCKET_BOUNDS", "Counter", "Gauge", "Histogram", "Registry",
    "default_registry", "counter", "gauge", "histogram", "expose_text",
    "metrics_snapshot", "set_enabled", "enabled", "zero_all",
]

#: shared histogram bucket layout: log-spaced upper bounds, 10 per decade
#: over 1e-5..1e2 (10µs..100s when observing seconds) + one overflow bucket.
#: Every histogram uses THIS layout, so percentile math is identical
#: everywhere and cross-metric comparisons are apples to apples.
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (-5 + i / 10.0) for i in range(1, 71))
_N_BUCKETS = len(BUCKET_BOUNDS) + 1  # + overflow
_HIST_SLOTS = _N_BUCKETS + 2         # buckets + sum + count

#: relative half-width of one bucket (geometric): the worst-case error of
#: a histogram percentile vs an exact one — tests assert against this
BUCKET_REL_ERROR = 10.0 ** 0.05 - 1.0


def _fmt(v: float) -> str:
    """Prometheus number formatting (compact, round-trippable)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Slab:
    """Fixed-capacity float64 value store in shared memory.

    Created before any fork so parent and children address the same
    physical pages. Slot 0 holds the allocation cursor (lock-guarded, so
    a post-fork child allocating a label combo draws slots disjoint from
    the parent's). Falls back to a process-local buffer when POSIX shared
    memory is unavailable — everything still works, minus fork visibility.
    """

    def __init__(self, capacity: int):
        import numpy as np
        self.capacity = capacity
        self._shm = None
        try:
            from multiprocessing import shared_memory
            self._shm = shared_memory.SharedMemory(
                create=True, size=capacity * 8)
            self.arr = np.ndarray((capacity,), dtype=np.float64,
                                  buffer=self._shm.buf)
        except Exception:
            warnings.warn(
                "analytics_zoo_tpu_torch.common.metrics: shared "
                "memory "
                "unavailable; metrics are process-local (no fork "
                "visibility)", RuntimeWarning)
            self.arr = np.zeros((capacity,), dtype=np.float64)
        self.arr[:] = 0.0
        self.arr[0] = 1.0  # next free slot (slot 0 is the cursor itself)

    def alloc(self, n: int) -> int:
        """Reserve ``n`` slots; caller holds the registry lock."""
        base = int(self.arr[0])
        if base + n > self.capacity:
            raise MemoryError(
                f"metrics slab exhausted ({self.capacity} slots); raise "
                f"Registry(capacity=...)")
        self.arr[0] = float(base + n)
        return base

    def close(self) -> None:
        self.arr = None
        if self._shm is not None:
            try:
                self._shm.close()
            except Exception:
                pass
            try:
                self._shm.unlink()
            except Exception:
                pass
            self._shm = None


class _Metric:
    """Base for one exposition family: a name, a help string, optional
    label names, and one slot block per label combo (or one block total
    when unlabeled)."""

    kind = "untyped"
    slots_per_series = 1

    def __init__(self, registry: "Registry", name: str, help: str,
                 labelnames: Tuple[str, ...]):
        self._reg = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._series: Dict[Tuple[str, ...], int] = {}
        if not labelnames:
            self._base = registry._alloc(self.slots_per_series)
            self._series[()] = self._base
        else:
            self._base = -1

    def labels(self, **kw: Any) -> "_Metric":
        """Bound child for one label combo (allocated on first use)."""
        if tuple(sorted(kw)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(kw))}")
        key = tuple(str(kw[k]) for k in self.labelnames)
        base = self._series.get(key)
        if base is None:
            with self._reg._plock:
                base = self._series.get(key)
                if base is None:
                    base = self._reg._alloc(self.slots_per_series)
                    self._series[key] = base
        child = object.__new__(type(self))
        child._reg = self._reg
        child.name = self.name
        child.help = self.help
        child.labelnames = ()
        child._series = {(): base}
        child._base = base
        return child

    def _require_base(self) -> int:
        if self._base < 0:
            raise ValueError(
                f"metric {self.name!r} is labeled by {self.labelnames}; "
                f"call .labels(...) first")
        return self._base

    def _values(self, base: int) -> List[float]:
        arr = self._reg._slab.arr
        return [float(x) for x in
                arr[base:base + self.slots_per_series]]


class Counter(_Metric):
    """Monotonically increasing value (float increments allowed, e.g.
    accumulated stall seconds)."""

    kind = "counter"

    def inc(self, v: float = 1.0) -> None:
        reg = self._reg
        if not reg._enabled:
            return
        base = self._require_base()
        if reg._acquire():
            try:
                reg._slab.arr[base] += v
            finally:
                reg._plock.release()

    def value(self) -> float:
        return float(self._reg._slab.arr[self._require_base()])


class Gauge(_Metric):
    """Point-in-time value (queue depth, in-flight count, claim age)."""

    kind = "gauge"

    def set(self, v: float) -> None:
        reg = self._reg
        if not reg._enabled:
            return
        # a plain 8-byte store is atomic enough for a gauge (last writer
        # wins is the semantics anyway) — no lock round-trip
        reg._slab.arr[self._require_base()] = float(v)

    def inc(self, v: float = 1.0) -> None:
        reg = self._reg
        if not reg._enabled:
            return
        base = self._require_base()
        if reg._acquire():
            try:
                reg._slab.arr[base] += v
            finally:
                reg._plock.release()

    def value(self) -> float:
        return float(self._reg._slab.arr[self._require_base()])


class Histogram(_Metric):
    """Fixed log-spaced-bucket histogram (layout :data:`BUCKET_BOUNDS`).

    Slot block layout: ``[bucket_0 .. bucket_69, overflow, sum, count]``
    (non-cumulative per-bucket counts; exposition cumulates)."""

    kind = "histogram"
    slots_per_series = _HIST_SLOTS

    def observe(self, v: float) -> None:
        reg = self._reg
        if not reg._enabled:
            return
        base = self._require_base()
        idx = bisect_left(BUCKET_BOUNDS, v) if v > 0 else 0
        arr = reg._slab.arr
        if reg._acquire():
            try:
                arr[base + idx] += 1.0
                arr[base + _N_BUCKETS] += v
                arr[base + _N_BUCKETS + 1] += 1.0
            finally:
                reg._plock.release()

    def count(self) -> int:
        return int(self._reg._slab.arr[self._require_base()
                                       + _N_BUCKETS + 1])

    def sum(self) -> float:
        return float(self._reg._slab.arr[self._require_base() + _N_BUCKETS])

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (``q`` in [0, 1]) from the bucket counts:
        the geometric midpoint of the bucket holding the target rank.
        Worst-case relative error is :data:`BUCKET_REL_ERROR`. Returns
        ``None`` on an empty histogram — callers surface ``null``, never
        a fake ``0.0``."""
        base = self._require_base()
        vals = self._values(base)
        buckets, total = vals[:_N_BUCKETS], vals[_N_BUCKETS + 1]
        if total <= 0:
            return None
        target = max(1.0, math.ceil(q * total))
        cum = 0.0
        for i, c in enumerate(buckets):
            cum += c
            if cum >= target:
                if i == 0:
                    return BUCKET_BOUNDS[0] * 10 ** -0.05
                if i >= len(BUCKET_BOUNDS):
                    return BUCKET_BOUNDS[-1] * 10 ** 0.05
                return math.sqrt(BUCKET_BOUNDS[i - 1] * BUCKET_BOUNDS[i])
        return BUCKET_BOUNDS[-1] * 10 ** 0.05  # pragma: no cover


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """One slab + one family table. Use :func:`default_registry` for the
    process-global instance; fresh instances are for tests (close() them —
    each owns a shared-memory segment)."""

    _live: "Dict[int, Registry]" = {}

    def __init__(self, capacity: int = 1 << 16,
                 enabled: Optional[bool] = None):
        self._slab = _Slab(capacity)
        self._families: Dict[str, _Metric] = {}
        self._flock = threading.Lock()  # family-table registration
        self._plock = self._make_plock()  # cross-process value lock
        self._lock_warned = False
        if enabled is None:
            try:
                from .config import global_config
                enabled = bool(global_config().get("metrics.enabled", True))
            except Exception:
                enabled = True
        self._enabled = bool(enabled)
        Registry._live[id(self)] = self

    @staticmethod
    def _make_plock():
        import multiprocessing as mp
        try:
            if "fork" in mp.get_all_start_methods():
                return mp.get_context("fork").Lock()
        except Exception:
            pass
        return threading.Lock()

    def _acquire(self) -> bool:
        """Take the value lock; a lock stranded by a SIGKILLed child must
        degrade to a skipped update, never deadlock the data plane."""
        try:
            got = self._plock.acquire(timeout=0.5)
        except TypeError:  # a lock type without timeout support
            got = self._plock.acquire()
        if not got and not self._lock_warned:
            self._lock_warned = True
            logger.warning(
                "metrics value lock unavailable for 0.5s (stranded by a "
                "killed process?); dropping updates rather than blocking")
        return got

    def _alloc(self, n: int) -> int:
        return self._slab.alloc(n)

    # -- registration ---------------------------------------------------------

    def _register(self, kind: str, name: str, help: str,
                  labels: Iterable[str]) -> _Metric:
        labelnames = tuple(labels)
        with self._flock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                        f"{fam.labelnames}; cannot re-register as {kind}"
                        f"{labelnames}")
                return fam
            with self._plock:
                fam = _KINDS[kind](self, name, help, labelnames)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._register("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._register("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = ()) -> Histogram:
        return self._register("histogram", name, help, labels)

    # -- toggles --------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, v: bool) -> None:
        self._enabled = bool(v)

    def zero(self) -> None:
        """Zero every allocated value slot (bench A/B resets; allocations
        and label combos survive so bound children stay valid)."""
        if self._acquire():
            try:
                cursor = self._slab.arr[0]
                self._slab.arr[1:int(cursor)] = 0.0
            finally:
                self._plock.release()

    # -- exposition -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Structured dict of every family: the machine-readable twin of
        :meth:`expose_text`. ``health_snapshot()`` is a view of this."""
        out: Dict[str, Any] = {}
        with self._flock:
            families = sorted(self._families.items())
        for name, fam in families:
            entry: Dict[str, Any] = {"type": fam.kind}
            series: Dict[str, Any] = {}
            for key, base in sorted(fam._series.items()):
                label = ",".join(f"{k}={v}" for k, v
                                 in zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    vals = fam._values(base)
                    total = vals[_N_BUCKETS + 1]
                    h = Histogram.__new__(Histogram)
                    h._reg, h._base = self, base
                    h.name, h.labelnames, h._series = name, (), {(): base}
                    series[label] = {
                        "count": int(total),
                        "sum": round(vals[_N_BUCKETS], 6),
                        "p50": h.percentile(0.50),
                        "p90": h.percentile(0.90),
                        "p99": h.percentile(0.99),
                    }
                else:
                    v = float(self._slab.arr[base])
                    series[label] = int(v) if v == int(v) else v
            if fam.labelnames:
                entry["series"] = series
            else:
                entry["value" if fam.kind != "histogram"
                      else "summary"] = series.get("")
            out[name] = entry
        return out

    def expose_text(self) -> str:
        """Prometheus text exposition format, one family per block.
        ``subsystem.noun_unit`` names become ``zoo_subsystem_noun_unit``."""
        lines: List[str] = []
        with self._flock:
            families = sorted(self._families.items())
        for name, fam in families:
            pname = "zoo_" + name.replace(".", "_").replace("-", "_")
            if fam.help:
                esc = fam.help.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {pname} {esc}")
            lines.append(f"# TYPE {pname} {fam.kind}")
            for key, base in sorted(fam._series.items()):
                pairs = [f'{k}="{v}"' for k, v in zip(fam.labelnames, key)]
                lbl = "{" + ",".join(pairs) + "}" if pairs else ""
                if fam.kind == "histogram":
                    vals = fam._values(base)
                    cum = 0.0
                    for i, bound in enumerate(BUCKET_BOUNDS):
                        cum += vals[i]
                        lp = pairs + [f'le="{_fmt(bound)}"']
                        lines.append(
                            f"{pname}_bucket{{{','.join(lp)}}} {_fmt(cum)}")
                    cum += vals[len(BUCKET_BOUNDS)]
                    lp = pairs + ['le="+Inf"']
                    lines.append(
                        f"{pname}_bucket{{{','.join(lp)}}} {_fmt(cum)}")
                    lines.append(f"{pname}_sum{lbl} "
                                 f"{_fmt(vals[_N_BUCKETS])}")
                    lines.append(f"{pname}_count{lbl} "
                                 f"{_fmt(vals[_N_BUCKETS + 1])}")
                else:
                    lines.append(
                        f"{pname}{lbl} "
                        f"{_fmt(float(self._slab.arr[base]))}")
        return "\n".join(lines) + ("\n" if lines else "")

    def close(self) -> None:
        Registry._live.pop(id(self), None)
        self._slab.close()


@atexit.register
def _close_live_registries() -> None:
    # interpreter exit must not leak /dev/shm segments
    for reg in list(Registry._live.values()):
        try:
            reg.close()
        except Exception:
            pass


# -- process-global default registry ------------------------------------------

_default: Optional[Registry] = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Registry()
    return _default


def counter(name: str, help: str = "", labels: Iterable[str] = ()) -> Counter:
    return default_registry().counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
    return default_registry().gauge(name, help, labels)


def histogram(name: str, help: str = "",
              labels: Iterable[str] = ()) -> Histogram:
    return default_registry().histogram(name, help, labels)


def metrics_snapshot() -> Dict[str, Any]:
    return default_registry().snapshot()


def expose_text() -> str:
    return default_registry().expose_text()


def set_enabled(v: bool) -> None:
    default_registry().set_enabled(v)


def enabled() -> bool:
    return default_registry().enabled


def zero_all() -> None:
    default_registry().zero()


def write_prom(path: str) -> None:
    """Write :func:`expose_text` to ``path`` atomically (tmp + rename) —
    the file the serving health loop drops next to ``health.json`` for a
    node-exporter textfile collector or a sidecar scraper to pick up."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(expose_text())
    os.replace(tmp, path)
