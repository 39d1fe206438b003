"""SLO alerting (counterpart of ``analytics_zoo_tpu/ops/alerts.py``):
multi-window multi-burn-rate rules over metric history.

An SLO with objective ``o`` grants an error budget ``1 - o``; a window's
**burn rate** is ``(bad / total) / (1 - o)``. A :class:`BurnRateRule`
fires only when the burn rate passes a factor in BOTH a long window (one
bad request out of ten must not page) and a short one (the alert clears
soon after the bleeding stops). Several ``(long_s, short_s, factor)``
pairs give the fast-burn and slow-burn split. :class:`ThresholdRule`
covers a sustained level (p99 latency) with a ``for_s`` qualifier.
Comparisons are strict, and an active alert clears only after
``clear_holds`` calm evaluations.

A firing or clearing alert is an ``ops.alert`` event, so it interleaves
with its causes on the incident timeline; the engine's ``on_fire`` hook
seals an incident bundle. Everything evaluates at an explicit ``now``, so
tests drive the clock without sleeping.
"""
from __future__ import annotations

import logging
import threading
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

from ..common.config import global_config
from ..common.utils import wall_clock
from . import events
from .history import MetricHistory

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = [
    "AlertEngine", "BurnRateRule", "Rule", "ThresholdRule",
    "active_alerts", "default_rules", "ensure_default",
    "shutdown_default",
]

_E_ALERT = events.event_type(
    "ops.alert",
    "Alert state transition (state=fire|clear) from the SLO rule engine, "
    "carrying the rule name and the evaluation detail that crossed the "
    "line.")

#: default multi-window pairs: (long_s, short_s, factor). The canonical
#: SRE-workbook shape scaled to this platform's second-scale SLO windows:
#: a fast burn pages on a minute of evidence, a slow burn on five.
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (60.0, 5.0, 14.4),   # fast burn
    (300.0, 30.0, 6.0),  # slow burn
)


class Rule:
    """One named alert rule. Subclasses implement :meth:`evaluate`
    against a :class:`~.history.MetricHistory` and
    an explicit wall-clock ``now``."""

    def __init__(self, name: str, clear_holds: int = 2):
        self.name = str(name)
        self.clear_holds = max(1, int(clear_holds))

    def evaluate(self, history: MetricHistory, now: float
                 ) -> Tuple[bool, Dict[str, Any]]:
        raise NotImplementedError


def _as_names(x) -> Tuple[str, ...]:
    return (x,) if isinstance(x, str) else tuple(x)


class BurnRateRule(Rule):
    """Multi-window multi-burn-rate SLO rule over counter deltas.

    ``bad`` and ``total`` are metric names (or tuples summed together);
    with ``label=None`` deltas aggregate across every label of each
    series (fleet-wide SLO), a specific label pins one instance. For
    histogram-backed series pass ``key="count"``.
    """

    def __init__(self, name: str, bad, total, objective: float = 0.999,
                 windows: Sequence[Tuple[float, float, float]]
                 = DEFAULT_WINDOWS,
                 label: Optional[str] = None,
                 key: Optional[str] = None,
                 min_total: float = 1.0,
                 clear_holds: int = 2):
        super().__init__(name, clear_holds)
        self.bad = _as_names(bad)
        self.total = _as_names(total)
        self.objective = float(objective)
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        self.windows = tuple((float(l), float(s), float(f))
                             for l, s, f in windows)
        self.label = label
        self.key = key
        self.min_total = float(min_total)

    def _delta(self, history: MetricHistory, names: Tuple[str, ...],
               seconds: float, now: float) -> Optional[float]:
        total = 0.0
        seen = False
        for n in names:
            labels = ([self.label] if self.label is not None
                      else (history.labels_for(n) or [""]))
            for lab in labels:
                d = history.delta(n, lab, seconds, now, key=self.key)
                if d is not None:
                    total += max(0.0, d)
                    seen = True
        return total if seen else None

    def burn_rate(self, history: MetricHistory, seconds: float,
                  now: float) -> Optional[float]:
        """The window's burn rate, or ``None`` when the window has no
        traffic to judge (no samples, or fewer than ``min_total``
        events — silence is not an SLO violation)."""
        bad = self._delta(history, self.bad, seconds, now)
        tot = self._delta(history, self.total, seconds, now)
        if tot is None or tot < self.min_total:
            return None
        budget = max(1e-9, 1.0 - self.objective)
        return ((bad or 0.0) / tot) / budget

    def evaluate(self, history: MetricHistory, now: float
                 ) -> Tuple[bool, Dict[str, Any]]:
        for long_s, short_s, factor in self.windows:
            burn_l = self.burn_rate(history, long_s, now)
            burn_s = self.burn_rate(history, short_s, now)
            if burn_l is None or burn_s is None:
                continue
            # strict >: a burn sitting exactly on the factor holds steady
            if burn_l > factor and burn_s > factor:
                return True, {
                    "rule": "burn_rate",
                    "objective": self.objective,
                    "window_s": [long_s, short_s],
                    "factor": factor,
                    "burn_long": round(burn_l, 3),
                    "burn_short": round(burn_s, 3),
                }
        return False, {}


class ThresholdRule(Rule):
    """Sustained threshold over one metric series (``above`` / ``below``
    strict comparisons). With ``for_s > 0`` every sample in the trailing
    window must breach AND the series must have history reaching back at
    least ``for_s`` — a single spiky sample cannot page. ``label=None``
    checks every label and fires on the worst offender."""

    def __init__(self, name: str, metric: str, key: Optional[str] = None,
                 label: Optional[str] = None,
                 above: Optional[float] = None,
                 below: Optional[float] = None,
                 for_s: float = 0.0, clear_holds: int = 2):
        super().__init__(name, clear_holds)
        if above is None and below is None:
            raise ValueError("ThresholdRule needs above= and/or below=")
        self.metric = metric
        self.key = key
        self.label = label
        self.above = above
        self.below = below
        self.for_s = float(for_s)

    def _breach(self, x: float) -> bool:
        if self.above is not None and not (x > self.above):
            return False
        if self.below is not None and not (x < self.below):
            return False
        return True

    def evaluate(self, history: MetricHistory, now: float
                 ) -> Tuple[bool, Dict[str, Any]]:
        labels = ([self.label] if self.label is not None
                  else (history.labels_for(self.metric) or [""]))
        for lab in labels:
            full = history.window(self.metric, lab, None, now)
            if not full:
                continue
            if self.for_s > 0:
                if full[0][0] > now - self.for_s:
                    continue  # not enough history to call it sustained
                win = [v for t, v in full if t >= now - self.for_s]
            else:
                win = [full[-1][1]]
            vals = [history._num(v, self.key) for v in win]
            vals = [v for v in vals if v is not None]
            if not vals:
                continue
            if all(self._breach(v) for v in vals):
                return True, {
                    "rule": "threshold", "metric": self.metric,
                    "label": lab, "key": self.key,
                    "value": round(vals[-1], 6),
                    "above": self.above, "below": self.below,
                    "for_s": self.for_s,
                }
        return False, {}


class AlertEngine:
    """Evaluates a rule set against a :class:`MetricHistory` on a
    cadence (or on demand with an injected clock) and tracks active
    alerts with clear-side hysteresis. Transitions are emitted as
    ``ops.alert`` events; ``on_fire(name, info, now)`` hooks incident
    sealing."""

    def __init__(self, history: MetricHistory,
                 rules: Iterable[Rule] = (),
                 log: Optional[events.EventLog] = None,
                 on_fire: Optional[Callable[[str, Dict[str, Any], float],
                                            Any]] = None,
                 interval_s: Optional[float] = None):
        cfg = global_config()
        self.history = history
        self.rules: List[Rule] = list(rules)
        self.interval_s = float(interval_s if interval_s is not None
                                else cfg.get("ops.eval_interval_s"))
        self.on_fire = on_fire
        self._log = log
        self._active: Dict[str, Dict[str, Any]] = {}
        self._calm: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- evaluation -----------------------------------------------------------

    def _emit(self, name: str, state: str,
              info: Dict[str, Any]) -> None:
        try:
            if self._log is not None:
                self._log.emit("ops.alert", alert=name, state=state,
                               info=info)
            else:
                _E_ALERT.emit(alert=name, state=state, info=info)
        except Exception:
            logger.debug("alert event emit failed", exc_info=True)

    def evaluate(self, now: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the state transitions it caused
        (empty on a quiet pass). ``now`` is injectable for fake-clock
        tests."""
        t = wall_clock() if now is None else float(now)
        transitions: List[Dict[str, Any]] = []
        for rule in self.rules:
            try:
                firing, info = rule.evaluate(self.history, t)
            except Exception:
                logger.debug("rule %s evaluation failed", rule.name,
                             exc_info=True)
                continue
            name = rule.name
            with self._lock:
                active = name in self._active
                if firing:
                    self._calm[name] = 0
                    if active:
                        self._active[name]["info"] = info
                        continue
                    self._active[name] = {"since": t, "info": info}
                elif active:
                    calm = self._calm.get(name, 0) + 1
                    self._calm[name] = calm
                    if calm < rule.clear_holds:
                        continue
                    del self._active[name]
                    self._calm[name] = 0
                else:
                    continue
            state = "fire" if firing else "clear"
            self._emit(name, state, info)
            transitions.append({"name": name, "state": state,
                                "info": info, "wall": t})
            if firing and self.on_fire is not None:
                try:
                    self.on_fire(name, info, t)
                except Exception:
                    logger.warning("on_fire hook for alert %s failed",
                                   name, exc_info=True)
        return transitions

    def active_alerts(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {n: dict(v) for n, v in self._active.items()}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "AlertEngine":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _run() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.evaluate()
                except Exception:
                    logger.debug("alert evaluation pass failed",
                                 exc_info=True)

        self._thread = threading.Thread(
            target=_run, name="zoo-ops-alerts", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None


def default_rules() -> List[Rule]:
    """The stock serving SLO rule set: goodput burn (sheds + errors
    against answered traffic), deadline-miss burn, and sustained p99
    latency. Fleet-wide (label-aggregated); tune or replace per
    deployment by handing :class:`AlertEngine` your own list."""
    return [
        BurnRateRule(
            "goodput_burn",
            bad=("serving.shed_total", "serving.error_total"),
            total=("serving.records_total", "serving.shed_total",
                   "serving.error_total", "serving.expired_total"),
            objective=0.99),
        BurnRateRule(
            "deadline_miss_burn",
            bad=("serving.expired_total",),
            total=("serving.records_total", "serving.expired_total"),
            objective=0.999),
        ThresholdRule(
            "p99_latency_high", "serving.request_latency_seconds",
            key="p99", above=1.0, for_s=15.0),
    ]


# -- process-default engine ----------------------------------------------------

_default_engine: Optional[AlertEngine] = None
_default_history: Optional[MetricHistory] = None
_default_lock = threading.Lock()


def active_alerts() -> Dict[str, Dict[str, Any]]:
    """Active alerts of the process-default engine ({} when the ops
    plane is off) — the dict servers stamp into ``health.json``."""
    eng = _default_engine
    return eng.active_alerts() if eng is not None else {}


def ensure_default(registry=None) -> Optional[AlertEngine]:
    """Start the process-default ops plane — history sampler + alert
    engine over :func:`default_rules`, with incident sealing wired to
    alert fires — iff ``ops.enabled`` is set. Idempotent; returns the
    engine, or ``None`` while the ops plane is disabled (the one boolean
    check a disabled plane costs at server startup)."""
    global _default_engine, _default_history
    if _default_engine is not None:
        return _default_engine
    cfg = global_config()
    if not bool(cfg.get("ops.enabled")):
        return None
    with _default_lock:
        if _default_engine is not None:
            return _default_engine
        from . import incident as _incident
        hist = MetricHistory(registry).start()
        corr = _incident.IncidentCorrelator(history=hist)
        eng = AlertEngine(
            hist, default_rules(),
            on_fire=lambda name, info, t: corr.seal(
                reason=f"alert:{name}",
                alert={"name": name, "info": info, "wall": t}, now=t))
        eng.start()
        _default_history = hist
        _default_engine = eng
        return eng


def shutdown_default() -> None:
    """Stop and discard the process-default engine (tests/bench)."""
    global _default_engine, _default_history
    with _default_lock:
        if _default_engine is not None:
            _default_engine.stop()
            _default_engine = None
        if _default_history is not None:
            _default_history.stop()
            _default_history = None
