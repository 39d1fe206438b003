"""Step-phase attribution profiler (counterpart of
``analytics_zoo_tpu/common/profiler.py``): where a step's wall time goes.

Each profiled loop (the serving dispatch pipeline, the generative
scheduler's step) is decomposed into phases:

- ``host_input``: the loop blocked on host-side data (claim and decode,
  a generative join's prefill),
- ``dispatch``: enqueueing work onto the card (asynchronous),
- ``execute``: device compute behind an explicit synchronization,
- ``fetch``: blocked pulling results back to the host,
- ``compile``: kernel builds and first-call set-up,
- ``other``: the unattributed remainder of the step wall, booked so phase
  sums always account for the whole wall.

Everything exports through the metrics registry: phase and wall histograms
and the MFU, roofline, device-memory and host-RSS gauges land in
``metrics.expose_text()`` / ``metrics.prom`` / ``metrics_snapshot()``.

Disabled (the default: the ``profile.enabled`` config flag), every record
call is an attribute load plus a boolean check.

On-demand deep captures: :func:`arm_capture` opens a ``torch.profiler``
trace window (by step count or wall seconds), armed by hand, by config
(``profile.capture_steps`` + ``profile.capture_dir``) or on the first
serving SLO breach (``profile.capture_on_breach``); closing it writes a
Chrome trace (``trace_<pid>_<n>.json``) into the capture directory. A
profiler that fails to start degrades to a warning once, never an
exception on the hot path.

The device's peaks are the card's data-sheet figures, found by its name
(:data:`PEAK_BF16_FLOPS`, :data:`PEAK_HBM_GBPS`). The JAX package's
``cost_flops``/``cost_bytes`` read an XLA compiled object and have no
counterpart: :meth:`StepProfiler.set_cost` takes the numbers directly.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from . import metrics as _metrics
from . import utils as _utils
from .config import global_config

logger = logging.getLogger("analytics_zoo_tpu_torch")

#: the closed phase vocabulary (the ``phase`` label of
#: ``profile.phase_seconds`` only ever takes these values)
PHASES = ("host_input", "dispatch", "execute", "fetch", "compile", "other")

_M_PHASE = _metrics.histogram(
    "profile.phase_seconds",
    "Wall time attributed to one phase of one profiled loop "
    "(host_input / dispatch / execute / fetch / compile / other).",
    labels=("loop", "phase"))
_M_WALL = _metrics.histogram(
    "profile.step_wall_seconds",
    "Whole-step wall time of a profiled loop; the per-loop phase sums "
    "account for this exactly (the remainder is booked as phase=other).",
    labels=("loop",))
_M_MFU = _metrics.gauge(
    "profile.mfu_ratio",
    "Model-FLOP utilization of the last profiled step: achieved matmul "
    "FLOP/s divided by the card's bf16 peak (needs a known device kind "
    "or the profile.peak_flops override).", labels=("loop",))
_M_ROOF = _metrics.gauge(
    "profile.hbm_roofline_ratio",
    "Achieved device-memory GB/s of the last profiled step divided by the "
    "card's peak memory bandwidth.", labels=("loop",))
_M_ROOF_UTIL = _metrics.gauge(
    "profile.roofline_utilization_ratio",
    "Roofline utilization of the last profiled step: the LARGER of MFU "
    "and the memory-bandwidth fraction.", labels=("loop",))
_M_HBM_USED = _metrics.gauge(
    "profile.hbm_used_bytes",
    "Device memory allocated by tensors (torch.cuda.memory_allocated, "
    "sampled on the health cadence; absent without a card).")
_M_HBM_LIMIT = _metrics.gauge(
    "profile.hbm_limit_bytes",
    "Device memory of the card (its total_memory, sampled with "
    "profile.hbm_used_bytes).")
_M_RSS = _metrics.gauge(
    "profile.host_rss_bytes",
    "Host resident-set size of this process, sampled on the health "
    "cadence.")
_M_CAPTURES = _metrics.counter(
    "profile.captures_total",
    "torch.profiler capture windows opened, by trigger "
    "(manual / config / breach).", labels=("trigger",))
_M_BUILD = _metrics.gauge(
    "build.info",
    "Environment identity (value is always 1; the labels carry the "
    "info): torch version, backend platform, device kind, git sha.",
    labels=("torch_version", "backend", "device_kind", "git_sha"))

# -- enablement ---------------------------------------------------------------


def _resolve_enabled() -> bool:
    try:
        return bool(global_config().get("profile.enabled"))
    except Exception:  # pragma: no cover - config bootstrap
        return False


_enabled: bool = _resolve_enabled()


def enabled() -> bool:
    """Cheap hot-path check; record calls are no-ops when False."""
    return _enabled


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


# -- phase recording ----------------------------------------------------------

#: bound label children, cached — ``.labels()`` allocates a wrapper per
#: call, and record_phase sits on per-step paths
_children: Dict[Tuple[str, ...], Any] = {}


def _phase_child(loop: str, phase: str):
    child = _children.get(("p", loop, phase))
    if child is None:
        child = _M_PHASE.labels(loop=loop, phase=phase)
        _children[("p", loop, phase)] = child
    return child


def _loop_child(metric, tag: str, loop: str):
    child = _children.get((tag, loop))
    if child is None:
        child = metric.labels(loop=loop)
        _children[(tag, loop)] = child
    return child


def record_phase(loop: str, phase: str, seconds: float,
                 start: Optional[float] = None) -> None:
    """Attribute ``seconds`` of ``loop``'s time to ``phase``. With a
    ``start`` perf_counter stamp the span is also offered to
    ``common.utils.span_hooks`` as ``profile.<loop>.<phase>``. A no-op
    while the profiler is disabled."""
    if not _enabled:
        return
    _phase_child(loop, phase).observe(seconds)
    if start is not None and _utils.span_hooks:
        name = "profile.%s.%s" % (loop, phase)
        for hook in tuple(_utils.span_hooks):
            hook(name, start, seconds)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _PhaseSpan:
    __slots__ = ("_sp", "_name", "_t0")

    def __init__(self, sp: "StepProfiler", name: str):
        self._sp = sp
        self._name = name

    def __enter__(self):
        self._t0 = self._sp._clock()
        return self

    def __exit__(self, *exc):
        self._sp.add(self._name, self._sp._clock() - self._t0,
                     start=self._t0)
        return False


class StepProfiler:
    """Per-step phase accounting for one loop (``train``, ``eval``, ...).

    Phases added between :meth:`step_start` and :meth:`step_end` land in
    ``profile.phase_seconds``; the step wall lands in
    ``profile.step_wall_seconds``; any unattributed remainder is booked
    as phase ``other`` so ``sum(phases) == wall`` holds exactly (on a fake
    clock too). With a cost model (:meth:`set_cost`) each step also
    refreshes the per-loop MFU and HBM roofline gauges. Every method is a
    no-op while disabled.

    ``clock`` is injectable for tests; production uses
    ``time.perf_counter``.
    """

    def __init__(self, loop: str,
                 clock: Callable[[], float] = time.perf_counter):
        self.loop = loop
        self._clock = clock
        self._t0: Optional[float] = None
        self._acc: Dict[str, float] = {}
        self._flops: Optional[float] = None
        self._bytes: Optional[float] = None
        self._peak: Any = None        # lazily resolved; False = unknown
        self._hbm: Any = None

    def set_cost(self, flops_per_step: Optional[float] = None,
                 bytes_per_step: Optional[float] = None) -> None:
        """Install the cost model (FLOPs and device bytes a step) used for
        the MFU and roofline gauges. The JAX package reads them from an XLA
        compiled object; here the caller counts them."""
        if flops_per_step is not None:
            self._flops = float(flops_per_step)
        if bytes_per_step is not None:
            self._bytes = float(bytes_per_step)

    def step_start(self) -> None:
        if not _enabled:
            return
        self._acc.clear()
        self._t0 = self._clock()

    def add(self, phase: str, seconds: float,
            start: Optional[float] = None) -> None:
        """Accumulate one timed window into this step's ``phase``."""
        if not _enabled:
            return
        self._acc[phase] = self._acc.get(phase, 0.0) + seconds
        if start is not None and _utils.span_hooks:
            name = "profile.%s.%s" % (self.loop, phase)
            for hook in tuple(_utils.span_hooks):
                hook(name, start, seconds)

    def phase(self, name: str):
        """``with sp.phase("fetch"): ...`` — times the block into ``name``."""
        if not _enabled:
            return _NULL_SPAN
        return _PhaseSpan(self, name)

    def step_end(self) -> None:
        """Commit this step: phase histograms + wall histogram + ``other``
        remainder + MFU/roofline gauges, then the capture-window tick."""
        if not _enabled or self._t0 is None:
            return
        wall = self._clock() - self._t0
        self._t0 = None
        attributed = 0.0
        for phase, secs in self._acc.items():
            _phase_child(self.loop, phase).observe(secs)
            attributed += secs
        if wall - attributed > 0:
            _phase_child(self.loop, "other").observe(wall - attributed)
        _loop_child(_M_WALL, "w", self.loop).observe(wall)
        if wall > 0:
            mfu = roof = None
            if self._flops is not None:
                peak = self._resolve_peak()
                if peak:
                    mfu = self._flops / wall / peak
                    _loop_child(_M_MFU, "m", self.loop).set(mfu)
            if self._bytes is not None:
                hbm = self._resolve_hbm()
                if hbm:
                    roof = self._bytes / wall / (hbm * 1e9)
                    _loop_child(_M_ROOF, "r", self.loop).set(roof)
            if mfu is not None or roof is not None:
                # the binding ceiling: a step is "fast" when it saturates
                # EITHER the matmul peak or the memory bandwidth
                _loop_child(_M_ROOF_UTIL, "u", self.loop).set(
                    max(mfu or 0.0, roof or 0.0))
        step_boundary()

    def _resolve_peak(self) -> Optional[float]:
        if self._peak is None:
            self._peak = device_peak_flops() or False
        return self._peak or None

    def _resolve_hbm(self) -> Optional[float]:
        if self._hbm is None:
            self._hbm = device_hbm_gbps() or False
        return self._hbm or None


# -- device peaks -------------------------------------------------------------

#: bf16 dense peak matmul FLOP/s by device kind (``torch.cuda.
#: get_device_name``): the H100 SXM's data sheet
PEAK_BF16_FLOPS = {
    "H100": 989e12,
}

#: peak device-memory bandwidth by device kind, GB/s (H100 SXM, HBM3)
PEAK_HBM_GBPS = {
    "H100": 3350.0,
}


def _device_kind() -> Optional[str]:
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(0)
    except Exception:
        return None


def device_peak_flops() -> Optional[float]:
    """Peak bf16 matmul FLOP/s of card 0, or the ``profile.peak_flops``
    config override (>0), or None when the kind is unknown (no card)."""
    try:
        override = float(global_config().get("profile.peak_flops"))
    except Exception:
        override = 0.0
    if override > 0:
        return override
    kind = _device_kind()
    if kind is None:
        return None
    for key, peak in PEAK_BF16_FLOPS.items():
        if key.lower() in kind.lower():
            return peak
    return None


def device_hbm_gbps() -> Optional[float]:
    """Peak device-memory bandwidth (GB/s) of card 0, or None when
    unknown."""
    kind = _device_kind()
    if kind is None:
        return None
    for key, gbps in PEAK_HBM_GBPS.items():
        if key.lower() in kind.lower():
            return gbps
    return None


# -- memory + build-info gauges (health cadence) ------------------------------


def _host_rss_bytes() -> Optional[float]:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        try:
            import resource
            return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                         * 1024)
        except Exception:
            return None


def sample_memory() -> Dict[str, Optional[float]]:
    """Refresh the device-memory and host-RSS gauges; called on the serving
    health cadence. Never raises: each source degrades to None where it is
    unavailable (no card). ``hbm_peak_bytes`` is
    ``torch.cuda.max_memory_allocated``, returned but kept in no gauge."""
    out: Dict[str, Optional[float]] = {
        "hbm_used_bytes": None, "hbm_peak_bytes": None,
        "hbm_limit_bytes": None, "host_rss_bytes": None}
    try:
        import torch
        if torch.cuda.is_available():
            used = float(torch.cuda.memory_allocated(0))
            limit = float(torch.cuda.get_device_properties(0).total_memory)
            out["hbm_used_bytes"] = used
            out["hbm_peak_bytes"] = float(torch.cuda.max_memory_allocated(0))
            out["hbm_limit_bytes"] = limit
            _M_HBM_USED.set(used)
            _M_HBM_LIMIT.set(limit)
    except Exception:
        pass
    rss = _host_rss_bytes()
    if rss is not None:
        out["host_rss_bytes"] = rss
        _M_RSS.set(rss)
    ensure_build_info()
    return out


def _git_sha() -> str:
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    git = os.path.join(root, ".git")
    try:
        with open(os.path.join(git, "HEAD")) as f:
            head = f.read().strip()
        if head.startswith("ref:"):
            ref = head.split(None, 1)[1]
            try:
                with open(os.path.join(git, *ref.split("/"))) as f:
                    head = f.read().strip()
            except OSError:  # ref packed away by gc
                with open(os.path.join(git, "packed-refs")) as f:
                    for line in f:
                        parts = line.strip().split()
                        if len(parts) == 2 and parts[1] == ref:
                            head = parts[0]
                            break
        return head[:12] or "unknown"
    except Exception:
        return "unknown"


_build_info: Optional[Dict[str, str]] = None


def ensure_build_info() -> Dict[str, str]:
    """Stamp the ``build.info`` info-style gauge (value 1; the labels carry
    the torch version, backend, device kind and git sha). Idempotent;
    without a card the device labels read ``cpu`` and ``unknown``."""
    global _build_info
    if _build_info is not None:
        return _build_info
    info = {"torch_version": "unknown", "backend": "unknown",
            "device_kind": "unknown", "git_sha": _git_sha()}
    try:
        import torch
        info["torch_version"] = torch.__version__
        info["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
        kind = _device_kind()
        if kind is not None:
            info["device_kind"] = kind
    except Exception:
        pass
    _M_BUILD.labels(**info).set(1)
    _build_info = info
    return info


# -- torch.profiler capture windows -------------------------------------------


class _CaptureState:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.active = False
        self.steps_left = 0
        self.stop_at: Optional[float] = None
        self.broken = False          # the profiler failed: stop trying
        self.config_checked = False  # config arming consumed once
        self.breach_fired = False    # one breach capture per process
        self.prof = None             # the open torch.profiler.profile
        self.out_dir = ""
        self.windows = 0
        self.last_trace: Optional[str] = None


_cap = _CaptureState()


def _profiler_start(out_dir: str) -> None:
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _cap.prof, _cap.out_dir = prof, out_dir


def _profiler_stop() -> None:
    prof, _cap.prof = _cap.prof, None
    if prof is None:
        return
    prof.__exit__(None, None, None)
    _cap.windows += 1
    path = os.path.join(_cap.out_dir,
                        f"trace_{os.getpid()}_{_cap.windows}.json")
    prof.export_chrome_trace(path)
    _cap.last_trace = path


def last_trace() -> Optional[str]:
    """The Chrome trace file the last closed capture window wrote."""
    return _cap.last_trace


def arm_capture(steps: int = 0, seconds: float = 0.0,
                out_dir: Optional[str] = None,
                trigger: str = "manual") -> bool:
    """Open a ``torch.profiler`` trace window now, bounded by ``steps``
    profiled steps (closed by :func:`step_boundary`) and/or ``seconds`` of
    wall time (closed by the next boundary or health tick past the
    deadline). ``out_dir`` defaults to ``profile.capture_dir``. Returns
    True if a window opened; a profiler that fails to start warns once and
    permanently degrades to False."""
    if _cap.broken:
        return False
    if out_dir is None:
        try:
            out_dir = str(global_config().get("profile.capture_dir") or "")
        except Exception:
            out_dir = ""
    if not out_dir or (steps <= 0 and seconds <= 0):
        return False
    with _cap.lock:
        if _cap.active:
            return False
        try:
            _profiler_start(out_dir)
        except Exception:
            _cap.broken = True
            logger.warning(
                "profiler: torch.profiler capture unavailable; further "
                "capture requests are no-ops", exc_info=True)
            return False
        _cap.active = True
        _cap.steps_left = int(steps)
        _cap.stop_at = (time.perf_counter() + float(seconds)
                        if seconds > 0 else None)
    _M_CAPTURES.labels(trigger=trigger).inc()
    logger.info("profiler: capture window opened (trigger=%s "
                         "steps=%d seconds=%.1f dir=%s)",
                         trigger, steps, seconds, out_dir)
    return True


def _stop_locked() -> None:
    try:
        _profiler_stop()
    except Exception:
        _cap.broken = True
        logger.warning("profiler: closing the capture failed",
                                exc_info=True)
    _cap.active = False
    _cap.steps_left = 0
    _cap.stop_at = None


def step_boundary() -> None:
    """One profiled step elapsed: consume config arming on the first
    boundary, count down a step-bounded window, close an elapsed
    time-bounded one. Cheap when no window is armed."""
    if not _enabled:
        return
    if not _cap.config_checked:
        _cap.config_checked = True
        try:
            steps = int(global_config().get("profile.capture_steps"))
        except Exception:
            steps = 0
        if steps > 0:
            arm_capture(steps=steps, trigger="config")
            return
    if not _cap.active:
        return
    with _cap.lock:
        if not _cap.active:
            return
        if _cap.steps_left > 0:
            _cap.steps_left -= 1
            if _cap.steps_left == 0:
                _stop_locked()
                return
        if _cap.stop_at is not None and time.perf_counter() >= _cap.stop_at:
            _stop_locked()


def maybe_stop_capture() -> None:
    """Health-cadence tick: close a time-bounded window whose deadline
    passed (serving sees no step boundaries on a quiet queue)."""
    if not _cap.active:
        return
    with _cap.lock:
        if (_cap.active and _cap.stop_at is not None
                and time.perf_counter() >= _cap.stop_at):
            _stop_locked()


def capture_active() -> bool:
    return _cap.active


def on_slo_breach(kind: str) -> None:
    """Serving calls this when requests shed or miss deadlines. With
    ``profile.capture_on_breach`` set, the FIRST breach in the process
    opens one time-bounded capture (``profile.capture_seconds``) so the
    trace shows the overload as it happens."""
    if _cap.breach_fired or _cap.broken:
        return
    try:
        cfg = global_config()
        if not cfg.get("profile.capture_on_breach"):
            return
        seconds = float(cfg.get("profile.capture_seconds"))
    except Exception:
        return
    _cap.breach_fired = True
    logger.warning("profiler: SLO breach (%s), arming a capture "
                            "window", kind)
    arm_capture(seconds=seconds, trigger="breach")


def _reset_capture_for_tests() -> None:
    with _cap.lock:
        if _cap.active:
            _stop_locked()
    _cap.broken = False
    _cap.config_checked = False
    _cap.breach_fired = False
