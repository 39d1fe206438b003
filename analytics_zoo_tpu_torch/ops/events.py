"""Structured event log (counterpart of ``analytics_zoo_tpu/ops/events.py``):
typed, fork-safe, crash-tolerant state history.

The servers' state machines (brownout rungs, sheds, reloads, lifecycle,
fault fires) surface as gauges that say where the system is; this log says
how it got there, one typed event a transition:

- **Typed and registered once.** An event type is declared at module
  scope via :func:`event_type`, with the JAX package's names. Emitting an
  unregistered type raises: a typo'd event name must not silently vanish.
- **Fork-safe and crash-tolerant.** Every process appends JSONL lines to
  its own ``<root>/<pid>.jsonl`` part file, flushed per event: a killed
  child loses at most a torn final line, which readers skip.
  :meth:`EventLog.read` merges all part files.
- **Bounded in memory.** Each process keeps the newest events in a ring
  (:meth:`EventLog.tail`) for in-process queries with no file IO.
- **Two clocks per event.** A ``wall`` stamp (``common.utils.wall_clock``,
  the only clock two processes share) and a ``mono`` stamp
  (``perf_counter``) for exact order within one pid.
- **Near-zero cost when off.** With ``ops.enabled`` false (the default) an
  emit is an attribute load and a boolean check; no spool directory is
  created.

Usage::

    from analytics_zoo_tpu_torch.ops import events

    events.set_enabled(True)          # or ops.enabled / ZOO_TPU_OPS_ENABLED
    for ev in events.read_events():   # merged across pids, wall-ordered
        print(ev["type"], ev["wall"], ev["pid"])

The history sampler, alert engine and incident correlator that read this
log in the JAX package (``ops/{history,alerts,incident}.py``) are not
ported yet.
"""
from __future__ import annotations

import atexit
import collections
import glob
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Deque, Dict, Iterable, List, Optional

from ..common import utils as _utils
from ..common.config import global_config

__all__ = [
    "EventLog", "EventType", "RESERVED_FIELDS", "default_log",
    "event_type", "registered_types", "read_events", "reset_default",
    "set_enabled", "enabled",
]

#: field names the log stamps onto every event — ``emit(**fields)``
#: payloads may not collide with them
RESERVED_FIELDS = ("type", "wall", "mono", "seq", "pid", "label",
                   "trace_id")


class EventType:
    """One registered event type; :meth:`emit` appends to the process
    default log. Registration is process-global (a type is a *name*, not
    a sink) — tests route emission into private :class:`EventLog`
    instances via ``EventLog.emit(name, ...)``."""

    __slots__ = ("name", "help")

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help

    def emit(self, label: str = "", trace_id: Optional[int] = None,
             **fields: Any) -> Optional[Dict[str, Any]]:
        """Append one event to the default log (no-op returning ``None``
        while the ops plane is disabled)."""
        return default_log().emit(self.name, label=label,
                                  trace_id=trace_id, **fields)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"EventType({self.name!r})"


_types: Dict[str, EventType] = {}
_types_lock = threading.Lock()


def event_type(name: str, help: str = "") -> EventType:
    """Register (idempotently) and return an event type. One module owns
    each name."""
    if not isinstance(name, str) or "." not in name:
        raise ValueError(
            f"event type {name!r} must be a dotted 'subsystem.noun' "
            f"string")
    with _types_lock:
        et = _types.get(name)
        if et is None:
            et = _types[name] = EventType(name, help)
        return et


def registered_types() -> Dict[str, str]:
    """``{name: help}`` of every registered event type."""
    with _types_lock:
        return {n: t.help for n, t in sorted(_types.items())}


class EventLog:
    """One event sink: a bounded in-memory ring plus per-pid JSONL part
    files under ``root``. The default instance (:func:`default_log`) is
    what :meth:`EventType.emit` writes to; tests construct private ones
    over explicit directories."""

    def __init__(self, root: Optional[str] = None,
                 ring: Optional[int] = None,
                 enabled: Optional[bool] = None):
        cfg = global_config()
        if enabled is None:
            enabled = bool(cfg.get("ops.enabled"))
        if ring is None:
            ring = int(cfg.get("ops.ring_events"))
        self._enabled = bool(enabled)
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(int(ring), 1))
        self._configured_root = (str(root) if root
                                 else str(cfg.get("ops.dir") or ""))
        self._root: Optional[str] = None
        self._owns_root = False
        self._owner_pid = os.getpid()
        self._lock = threading.Lock()
        self._fh = None
        self._fh_pid = -1
        self._seq = 0
        if self._enabled:
            # resolve the spool BEFORE any fork so children share it
            self._ensure_root()

    # -- sink resolution ------------------------------------------------------

    def _ensure_root(self) -> str:
        if self._root is None:
            if self._configured_root:
                os.makedirs(self._configured_root, exist_ok=True)
                self._root = self._configured_root
            else:
                self._root = tempfile.mkdtemp(prefix="zoo_ops_events_")
                self._owns_root = True
        return self._root

    @property
    def root(self) -> str:
        """The spool directory (created on first need)."""
        return self._ensure_root()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, v: bool) -> None:
        self._enabled = bool(v)
        if self._enabled:
            self._ensure_root()

    # -- append path ----------------------------------------------------------

    def emit(self, type_name: str, label: str = "",
             trace_id: Optional[int] = None,
             **fields: Any) -> Optional[Dict[str, Any]]:
        """Append one typed event. Raises on an unregistered type or a
        reserved-field collision (both are programming errors that would
        otherwise corrupt every downstream timeline); returns the event
        dict, or ``None`` when this log is disabled."""
        if not self._enabled:
            return None
        with _types_lock:
            known = type_name in _types
        if not known:
            raise ValueError(
                f"event type {type_name!r} was never registered via "
                f"events.event_type(...) — a typo'd type would vanish "
                f"from every timeline")
        for k in fields:
            if k in RESERVED_FIELDS:
                raise ValueError(
                    f"event field {k!r} collides with a reserved stamp "
                    f"({', '.join(RESERVED_FIELDS)})")
        ev: Dict[str, Any] = {
            "type": type_name,
            "wall": _utils.wall_clock(),
            "mono": time.perf_counter(),
            "pid": os.getpid(),
            "label": str(label or ""),
        }
        if trace_id is not None:
            ev["trace_id"] = int(trace_id)
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            self._append_line(ev)
        return ev

    def _append_line(self, ev: Dict[str, Any]) -> None:
        """Crash-tolerant append to this pid's part file. The handle is
        re-resolved after any fork (the pid changed under us); a torn
        final line from a killed process is skipped by :meth:`read`."""
        pid = ev["pid"]
        if self._fh is None or self._fh_pid != pid:
            try:
                self._fh = open(
                    os.path.join(self._ensure_root(), f"{pid}.jsonl"),
                    "a")
                self._fh_pid = pid
            except OSError:
                self._fh = None
                return
        try:
            self._fh.write(json.dumps(ev, default=str) + "\n")
            self._fh.flush()
        except (OSError, ValueError, TypeError):
            pass

    # -- read path ------------------------------------------------------------

    def tail(self, n: int = 50) -> List[Dict[str, Any]]:
        """The newest ``n`` events emitted BY THIS PROCESS (ring only, no
        file IO)."""
        with self._lock:
            return list(self._ring)[-int(n):]

    def read(self, since_wall: Optional[float] = None,
             types: Optional[Iterable[str]] = None,
             label: Optional[str] = None) -> List[Dict[str, Any]]:
        """Merge every pid's part file into one wall-ordered list (stable
        tie-break by pid then per-pid seq). Torn final lines of killed
        processes are skipped."""
        wanted = set(types) if types is not None else None
        out: List[Dict[str, Any]] = []
        for part in sorted(glob.glob(
                os.path.join(self._ensure_root(), "*.jsonl"))):
            try:
                with open(part) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue  # torn final line of a killed pid
                        if not isinstance(ev, dict) or "type" not in ev:
                            continue
                        if since_wall is not None \
                                and ev.get("wall", 0.0) < since_wall:
                            continue
                        if wanted is not None \
                                and ev["type"] not in wanted:
                            continue
                        if label is not None \
                                and ev.get("label") != label:
                            continue
                        out.append(ev)
            except OSError:
                pass
        out.sort(key=lambda e: (e.get("wall", 0.0), e.get("pid", 0),
                                e.get("seq", 0)))
        return out

    def clear(self) -> None:
        """Drop the ring and every part file (bench/test resets)."""
        with self._lock:
            self._ring.clear()
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            if self._root is not None:
                for part in glob.glob(os.path.join(self._root,
                                                   "*.jsonl")):
                    try:
                        os.remove(part)
                    except OSError:
                        pass

    def close(self) -> None:
        """Close the part-file handle; the CREATING process also removes
        an owned temp spool (children must never delete the shared dir
        out from under the parent)."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            if (self._owns_root and self._root is not None
                    and os.getpid() == self._owner_pid):
                shutil.rmtree(self._root, ignore_errors=True)
                self._root = None


# -- process-global default log -----------------------------------------------

_default: Optional[EventLog] = None
_default_lock = threading.Lock()


def default_log() -> EventLog:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = EventLog()
    return _default


def reset_default(root: Optional[str] = None, ring: Optional[int] = None,
                  enabled: Optional[bool] = None) -> EventLog:
    """Swap in a fresh default log (tests, A/B runs); the previous one is
    closed. Returns the new log."""
    global _default
    with _default_lock:
        old = _default
        _default = EventLog(root=root, ring=ring, enabled=enabled)
        if old is not None:
            old.close()
    return _default


def set_enabled(v: bool) -> None:
    default_log().set_enabled(v)


def enabled() -> bool:
    return default_log().enabled


def read_events(**kw: Any) -> List[Dict[str, Any]]:
    return default_log().read(**kw)


@atexit.register
def _close_default() -> None:
    # interpreter exit must not leak temp spools
    if _default is not None:
        try:
            _default.close()
        except Exception:
            pass
