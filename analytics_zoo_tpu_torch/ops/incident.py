"""Incident correlator (counterpart of ``analytics_zoo_tpu/ops/
incident.py``): seal event windows into causally ordered bundles.

When an alert fires (or an operator asks), the correlator freezes the
trailing event window of the structured log, the related metric history
and any ``health.json`` snapshots it was pointed at into one **incident
bundle** directory (``bundle.json`` and a rendered ``timeline.txt``).

Events carry two clocks: within one pid the monotonic stamps give exact
order; across pids only the wall stamps compare. :func:`order_events`
sorts each pid's events by ``(mono, seq)`` and merges the pids by always
taking the group whose head event has the smallest wall stamp, so no two
events of one process are ever reordered.

Sealing is itself an ``ops.incident`` event.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence

from ..common.config import global_config
from ..common.utils import wall_clock
from . import events
from .history import MetricHistory

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = [
    "IncidentCorrelator", "last_incident", "load_bundle",
    "order_events", "render_timeline",
]

_E_INCIDENT = events.event_type(
    "ops.incident",
    "An incident bundle was sealed (reason=alert:<name>|manual), "
    "carrying the bundle path and event count.")

_last: Optional[Dict[str, Any]] = None
_last_lock = threading.Lock()


def last_incident() -> Optional[Dict[str, Any]]:
    """Summary of the most recently sealed incident in this process
    (``None`` when there is none) — what servers stamp into
    ``health.json`` so ``read_health()`` consumers see it."""
    with _last_lock:
        return dict(_last) if _last is not None else None


def order_events(evs: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Causal order: exact ``(mono, seq)`` order within each pid,
    wall-clock-bracketed merge across pids (always advance the group
    whose head event carries the smallest wall stamp)."""
    groups: Dict[int, List[Dict[str, Any]]] = {}
    for ev in evs:
        groups.setdefault(int(ev.get("pid", 0)), []).append(ev)
    for g in groups.values():
        g.sort(key=lambda e: (e.get("mono", 0.0), e.get("seq", 0)))
    heads = {pid: 0 for pid in groups}
    out: List[Dict[str, Any]] = []
    while heads:
        pid = min(heads,
                  key=lambda p: (groups[p][heads[p]].get("wall", 0.0), p))
        out.append(groups[pid][heads[pid]])
        heads[pid] += 1
        if heads[pid] >= len(groups[pid]):
            del heads[pid]
    return out


def _fields_str(ev: Dict[str, Any]) -> str:
    parts = []
    for k in sorted(ev):
        if k in events.RESERVED_FIELDS:
            continue
        v = ev[k]
        if isinstance(v, dict):
            v = json.dumps(v, sort_keys=True, default=str)
        parts.append(f"{k}={v}")
    return " ".join(parts)


def render_timeline(evs: Sequence[Dict[str, Any]],
                    reason: Optional[str] = None,
                    alert: Optional[Dict[str, Any]] = None) -> str:
    """Human-readable timeline of already-causally-ordered events:
    one ``+offset  [pid/label]  type  fields`` line per event, offsets
    relative to the first event's wall stamp."""
    lines: List[str] = []
    if reason:
        lines.append(f"incident: {reason}")
    if alert:
        lines.append(
            f"triggering alert: {alert.get('name')} "
            f"{json.dumps(alert.get('info', {}), sort_keys=True, default=str)}")
    if not evs:
        lines.append("(no events in window)")
        return "\n".join(lines) + "\n"
    t0 = float(evs[0].get("wall", 0.0))
    lines.append(f"t0 = {t0:.3f} (wall)")
    for ev in evs:
        dt = float(ev.get("wall", t0)) - t0
        who = f"{ev.get('pid', '?')}/{ev.get('label') or '-'}"
        extra = _fields_str(ev)
        line = f"+{dt:8.3f}s  [{who}]  {ev.get('type', '?')}"
        if extra:
            line += f"  {extra}"
        lines.append(line)
    return "\n".join(lines) + "\n"


def load_bundle(path: str) -> Dict[str, Any]:
    """Load a sealed bundle back (``path`` is the bundle directory or
    its ``bundle.json``)."""
    if os.path.isdir(path):
        path = os.path.join(path, "bundle.json")
    with open(path) as f:
        return json.load(f)


class IncidentCorrelator:
    """Seals incident bundles from an event log + metric history.

    ``health_paths`` may list ``health.json`` files (or directories of
    them) whose current contents should be frozen into each bundle.
    """

    def __init__(self, log: Optional[events.EventLog] = None,
                 history: Optional[MetricHistory] = None,
                 out_dir: Optional[str] = None,
                 window_s: Optional[float] = None,
                 health_paths: Sequence[str] = ()):
        cfg = global_config()
        self._log = log
        self.history = history
        self.window_s = float(window_s if window_s is not None
                              else cfg.get("ops.incident_window_s"))
        self._out_dir = (str(out_dir) if out_dir
                         else str(cfg.get("ops.incident_dir") or ""))
        self.health_paths = list(health_paths)
        self._seal_lock = threading.Lock()

    @property
    def log(self) -> events.EventLog:
        return self._log if self._log is not None else events.default_log()

    def _resolve_out_dir(self) -> str:
        if self._out_dir:
            return self._out_dir
        return os.path.join(self.log.root, "incidents")

    def _health_snapshots(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        paths: List[str] = []
        for p in self.health_paths:
            if os.path.isdir(p):
                for fn in sorted(os.listdir(p)):
                    if fn.endswith(".json"):
                        paths.append(os.path.join(p, fn))
            else:
                paths.append(p)
        for p in paths:
            try:
                with open(p) as f:
                    out[p] = json.load(f)
            except (OSError, ValueError):
                out[p] = None  # frozen as unreadable — that IS evidence
        return out

    def seal(self, reason: str = "manual",
             alert: Optional[Dict[str, Any]] = None,
             now: Optional[float] = None) -> str:
        """Seal one bundle: trailing event window (causally ordered),
        metric history dump, health snapshots, rendered timeline.
        Returns the bundle directory path."""
        global _last
        t = wall_clock() if now is None else float(now)
        with self._seal_lock:
            raw = self.log.read(since_wall=t - self.window_s)
            ordered = order_events(raw)
            hist = (self.history.dump(self.window_s, t)
                    if self.history is not None else {})
            health = self._health_snapshots()
            slug = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)[:48]
            out_root = self._resolve_out_dir()
            bdir = os.path.join(out_root,
                                f"incident-{int(t * 1000)}-{slug}")
            os.makedirs(bdir, exist_ok=True)
            bundle = {
                "version": 1,
                "sealed_wall": t,
                "reason": reason,
                "alert": alert,
                "window_s": self.window_s,
                "events": ordered,
                "history": hist,
                "health": health,
            }
            timeline = render_timeline(ordered, reason=reason, alert=alert)
            try:
                with open(os.path.join(bdir, "bundle.json"), "w") as f:
                    json.dump(bundle, f, default=str)
                with open(os.path.join(bdir, "timeline.txt"), "w") as f:
                    f.write(timeline)
            except OSError:
                logger.warning("incident bundle write failed at %s",
                               bdir, exc_info=True)
            summary = {"path": bdir, "reason": reason, "wall": t,
                       "events": len(ordered)}
            with _last_lock:
                _last = summary
            try:
                self.log.emit("ops.incident", reason=reason, path=bdir,
                              events=len(ordered))
            except Exception:
                logger.debug("ops.incident event emit failed",
                             exc_info=True)
            logger.info("sealed incident bundle %s (%d events, %s)",
                        bdir, len(ordered), reason)
            return bdir
