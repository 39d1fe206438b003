"""Chrome-trace span recorder and request-lifecycle flow tracing
(counterpart of ``analytics_zoo_tpu/utils/trace.py``).

While a :func:`trace` session is active, every ``time_it`` span (the
serving stages, the generative joins) is recorded and written as a Chrome
``chrome://tracing`` / Perfetto JSON array, one row a process and thread.

- **Sessions nest.** Every active session records every span.
- **Forked workers show up, pid-correct.** A span recorded in a forked
  child is spooled to a per-pid JSONL part file that the parent merges at
  dump time (``time.perf_counter`` is CLOCK_MONOTONIC on Linux, shared
  across processes, so the stamps line up).
- **Flow events.** :func:`flow_point` stamps Chrome flow-phase events
  (``s``/``t``/``f``), so one request's lifecycle (enqueue, claim, decode,
  dispatch, result) draws as one arrowed chain across threads and
  processes. The servers call it with the ``trace_id`` the client stamps
  at enqueue.

Thread rows carry each thread's name; :func:`set_thread_label` renames
the current thread. Recording costs one list append a span; with no
session active the hook is a no-op.

Usage::

    from analytics_zoo_tpu_torch.utils.trace import trace
    with trace("/tmp/serving_trace.json"):
        server.serve_once()
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..common import utils as _utils

#: flow-chain category — one constant so emitters and Perfetto bind on the
#: same (cat, name, id) triple
FLOW_CAT = "request"


def set_thread_label(label: str) -> None:
    """Name the CURRENT thread's trace row by role (producer / server /
    worker / ...). Threads created with an explicit ``name=`` are already
    labeled; this is for code running on threads it did not create."""
    threading.current_thread().name = label


class _TraceSession:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._names: Dict[Tuple[int, int], str] = {}  # (pid, tid) -> label
        self.t0 = time.perf_counter()
        self.pid = os.getpid()
        # spool for forked children: each foreign pid appends JSONL lines
        # (crash-tolerant — a SIGKILLed worker loses at most a partial
        # final line, which the merge skips)
        self.spool = tempfile.mkdtemp(prefix="zoo_trace_spool_")
        self._part = None        # child-side open part file
        self._part_pid = -1

    # -- recording ------------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        pid = os.getpid()
        ev["pid"] = pid
        tid = ev["tid"]
        if pid == self.pid:
            with self._lock:
                if (pid, tid) not in self._names:
                    self._names[(pid, tid)] = threading.current_thread().name
                self._events.append(ev)
            return
        # forked child: spool to the per-pid part file. The file handle is
        # re-resolved after any further fork (pid changed under us).
        if self._part is None or self._part_pid != pid:
            try:
                self._part = open(
                    os.path.join(self.spool, f"{pid}.jsonl"), "a")
                self._part_pid = pid
                self._part.write(json.dumps(
                    {"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": _process_label()}}) + "\n")
            except OSError:
                return  # spool dir gone (session ended in parent)
        try:
            key = (pid, tid)
            if key not in self._names:
                self._names[key] = threading.current_thread().name
                self._part.write(json.dumps(
                    {"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid,
                     "args": {"name": self._names[key]}}) + "\n")
            self._part.write(json.dumps(ev) + "\n")
            self._part.flush()
        except (OSError, ValueError):
            pass

    def add(self, name: str, start: float, elapsed: float) -> None:
        self._emit({
            "name": name,
            "ph": "X",  # complete event
            "ts": (start - self.t0) * 1e6,  # microseconds
            "dur": elapsed * 1e6,
            "tid": threading.get_ident(),
            "cat": "analytics_zoo_tpu",
        })

    def add_flow(self, flow_id: int, stage: str, phase: str,
                 t: float) -> None:
        """One flow-chain point: a 2µs anchor slice named ``stage`` plus
        the flow event Perfetto binds to it (same ts, same track)."""
        ts = (t - self.t0) * 1e6
        tid = threading.get_ident()
        self._emit({"name": stage, "ph": "X", "ts": ts, "dur": 2.0,
                    "tid": tid, "cat": "analytics_zoo_tpu",
                    "args": {"trace_id": flow_id}})
        ev = {"name": FLOW_CAT, "cat": FLOW_CAT, "ph": phase,
              "id": flow_id, "ts": ts + 1.0, "tid": tid}
        if phase == "f":
            ev["bp"] = "e"  # bind the terminus to the enclosing slice
        self._emit(ev)

    # -- output ---------------------------------------------------------------

    def _merge_parts(self) -> List[dict]:
        merged: List[dict] = []
        for part in sorted(glob.glob(os.path.join(self.spool, "*.jsonl"))):
            try:
                with open(part) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            merged.append(json.loads(line))
                        except ValueError:
                            pass  # torn final line of a killed worker
            except OSError:
                pass
        return merged

    def dump(self, path: str) -> int:
        with self._lock:
            events = list(self._events)
            names = dict(self._names)
        events.extend(self._merge_parts())
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "args": {"name": _process_label()}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                  "args": {"name": label}}
                 for (pid, tid), label in sorted(names.items())
                 if pid == self.pid]
        with open(path, "w") as f:
            json.dump(meta + events, f)
        shutil.rmtree(self.spool, ignore_errors=True)
        return len([e for e in events if e.get("ph") != "M"])


def _process_label() -> str:
    import multiprocessing
    name = multiprocessing.current_process().name
    return "main" if name == "MainProcess" else name


#: stack of active sessions — EVERY active session records every span, so
#: nested trace() calls merge instead of the inner silently dropping the
#: outer's spans
_sessions: List[_TraceSession] = []


def tracing() -> bool:
    """Cheap hot-path check: is any trace session active?"""
    return bool(_sessions)


def _record(name: str, start: float, elapsed: float) -> None:
    for session in tuple(_sessions):
        session.add(name, start, elapsed)


_utils.span_hooks.append(_record)  # no-op while no session is active


def flow_point(flow_id: Optional[int], stage: str, phase: str) -> None:
    """Stamp one point of a request-lifecycle flow chain in every active
    session. ``phase``: ``"s"`` starts the chain (enqueue), ``"t"`` marks
    an intermediate step (claim / decode / dispatch), ``"f"`` ends it
    (result post). A ``None``/missing ``flow_id`` (request from a client
    that predates trace ids) is skipped silently."""
    if flow_id is None or not _sessions:
        return
    t = time.perf_counter()
    for session in tuple(_sessions):
        session.add_flow(int(flow_id), stage, phase, t)


def new_trace_id() -> int:
    """A fresh flow-chain id (31-bit, collision-unlikely): stamped onto
    serving requests at enqueue so every pipeline stage can tag its spans."""
    return int.from_bytes(os.urandom(4), "big") & 0x7FFFFFFF


@contextlib.contextmanager
def trace(path: str) -> Iterator[_TraceSession]:
    """Record every ``time_it`` span and :func:`flow_point` until exit,
    then write Chrome-trace JSON to ``path``. Sessions NEST by merging:
    spans recorded during an inner session land in both traces."""
    session = _TraceSession()
    _sessions.append(session)
    try:
        yield session
    finally:
        try:
            _sessions.remove(session)
        except ValueError:  # pragma: no cover - double-exit safety
            pass
        count = session.dump(path)
        _utils.logger.info("trace: wrote %d spans to %s", count, path)
