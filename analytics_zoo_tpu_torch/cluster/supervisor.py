"""The serving half of the pod supervisor (counterpart of ``FleetSupervisor``
in ``analytics_zoo_tpu/cluster/supervisor.py``): a demand-driven actuator
for the fleet tier.

:class:`FleetSupervisor` closes the loop on the router's
``fleet.desired_instances`` signal by spawning and draining real server
subprocesses (``multiprocessing``'s spawn context: each child imports torch
and opens its own CUDA context). Scale-out registers the new instance's
spool with the router; scale-in raises a ``DRAIN_<name>`` flag, and the
server hands its unfinished streams back to the front spool
(``GenerativeServing.handoff``) or drains, then publishes a terminal
``drained`` health state, so the router re-places every request: none is
dropped and each gets exactly one terminal. The ``fleet.scale_actuate``
fault fails an actuation tick, which is retried on the next one.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

from ..common import faults
from ..common import metrics as _metrics
from ..common.config import global_config
from ..ops import alerts as ops_alerts
from ..ops import events as ops_events
from ..ops import incident as ops_incident

logger = logging.getLogger("analytics_zoo_tpu_torch.cluster")

_M_SCALE_EVENTS = _metrics.counter(
    "fleet.scale_events_total",
    "Fleet supervisor actuations: server subprocesses spawned (out) or "
    "drained (in) to track fleet.desired_instances.",
    labels=("direction",))
_E_SCALE = ops_events.event_type(
    "fleet.scale",
    "Fleet supervisor actuation (direction=out|in, label=instance).")


def _peak_device_bytes() -> Optional[int]:
    """The process's peak CUDA allocation, or None where it opened no
    CUDA context."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.max_memory_allocated())


def _serve_instance(root: str, name: str, factory_spec: str) -> None:
    """Fleet-instance subprocess body. ``factory_spec`` is a
    ``module:function`` resolving to ``factory(root, name) -> server``: a
    ``ClusterServing`` or ``GenerativeServing`` bound to
    ``instance_queue(root, name)`` with its health file at
    ``<root>/<name>.health.json``.

    Control files under ``root``: ``READY_<name>`` is raised here once
    serving; ``DRAIN_<name>`` triggers scale-in (a generative server hands
    its unfinished streams back to the FRONT spool, a one-shot server
    drains); ``DONE`` is fleet-wide shutdown. Every terminal this instance
    posts is journaled to ``<root>/audit/<name>.log`` at ``put_result``,
    the exactly-one-terminal evidence; at exit ``<root>/exit_<name>.json``
    records the pid and its peak device bytes."""
    from .bootstrap import resolve_target
    factory = resolve_target(factory_spec)
    srv = factory(root, name)

    audit_dir = os.path.join(root, "audit")
    os.makedirs(audit_dir, exist_ok=True)
    audit_path = os.path.join(audit_dir, f"{name}.log")
    queue = srv.queue
    orig_put = queue.put_result

    def audited_put(uri, payload):
        orig_put(uri, payload)
        if isinstance(payload, dict) and ("error" in payload
                                          or "value" in payload):
            with open(audit_path, "a") as f:
                f.write(f"{uri}\n")
    queue.put_result = audited_put

    step = getattr(srv, "serve_once", None) or srv.serve_step
    drain_flag = os.path.join(root, f"DRAIN_{name}")
    done_flag = os.path.join(root, "DONE")
    with open(os.path.join(root, f"READY_{name}"), "w") as f:
        f.write(str(os.getpid()))
    try:
        while True:
            if os.path.exists(drain_flag) or os.path.exists(done_flag):
                handoff = getattr(srv, "handoff", None)
                if handoff is not None and not os.path.exists(done_flag):
                    # scale-in of a generative server: unfinished streams
                    # go back to the front spool with their token prefix
                    from ..serving.queues import FileQueue
                    handoff(FileQueue(root))
                else:
                    srv.drain()
                return
            if not step():
                time.sleep(0.005)
    finally:
        with open(os.path.join(root, f"exit_{name}.json"), "w") as f:
            json.dump({"pid": os.getpid(),
                       "peak_device_bytes": _peak_device_bytes()}, f)


class FleetSupervisor:
    """Actuator for the fleet scale signal: reconciles the live set of
    server subprocesses against ``FleetRouter.desired_instances()``
    (clamped to ``[min_instances, max_instances]``), at most one spawn or
    drain a ``fleet.scale_interval_s`` tick. Drive :meth:`step` from the
    loop that calls ``router.route_once()``.

    ``start_method`` is ``multiprocessing``'s: ``spawn`` (the default) for
    instances on the card, whose CUDA context a forked child cannot use;
    ``fork`` starts CPU instances without importing torch again."""

    def __init__(self, router, root: str, server_factory: str, *,
                 min_instances: int = 1, max_instances: int = 4,
                 slots: int = 1, scale_interval_s: Optional[float] = None,
                 ready_timeout_s: float = 60.0,
                 start_method: str = "spawn"):
        self.router = router
        self.root = root
        self.server_factory = server_factory
        self.min_instances = int(min_instances)
        self.max_instances = int(max_instances)
        self.slots = int(slots)
        self.scale_interval_s = (
            float(scale_interval_s) if scale_interval_s is not None
            else float(global_config().get("fleet.scale_interval_s")))
        self.ready_timeout_s = float(ready_timeout_s)
        self.start_method = str(start_method)
        self._procs: Dict[str, Any] = {}
        self._draining: Dict[str, Any] = {}
        self._counter = 0
        self._last_actuate = -1e18  # monotonic

    # -- observers --------------------------------------------------------

    def instance_names(self) -> List[str]:
        return sorted(self._procs)

    def alive_count(self) -> int:
        return sum(1 for p in self._procs.values() if p.is_alive())

    def status(self) -> Dict[str, Any]:
        """Fleet shape plus the ops plane's active alerts and last
        incident, the stamp the servers put in ``health.json``."""
        return {
            "instances": self.instance_names(),
            "alive": self.alive_count(),
            "draining": sorted(self._draining),
            "alerts": sorted(ops_alerts.active_alerts()),
            "incident": ops_incident.last_incident(),
        }

    # -- actuation --------------------------------------------------------

    def step(self) -> Optional[str]:
        """One reconcile tick. Returns ``"out:<name>"`` / ``"in:<name>"``
        when an actuation happened, else None."""
        self._reap()
        now = time.monotonic()
        if now - self._last_actuate < self.scale_interval_s:
            return None
        desired = max(self.min_instances,
                      min(self.max_instances,
                          self.router.desired_instances()))
        live = len(self._procs)
        if desired == live:
            return None
        self._last_actuate = now
        try:
            faults.inject("fleet.scale_actuate")
        except faults.FaultInjected:
            logger.warning("fleet scale actuation aborted by the "
                           "fleet.scale_actuate fault; retrying next tick")
            return None
        if desired > live:
            name = self._spawn_instance()
            if name is None:
                return None
            _M_SCALE_EVENTS.labels(direction="out").inc()
            _E_SCALE.emit(label=name, direction="out")
            logger.info("fleet scale-out: %s (%d -> %d)", name, live,
                        live + 1)
            return f"out:{name}"
        name = sorted(self._procs)[-1]  # the newest instance drains first
        proc = self._procs.pop(name)
        self._draining[name] = proc
        with open(os.path.join(self.root, f"DRAIN_{name}"), "w") as f:
            f.write("1")
        _M_SCALE_EVENTS.labels(direction="in").inc()
        _E_SCALE.emit(label=name, direction="in")
        logger.info("fleet scale-in: draining %s (%d -> %d)", name, live,
                    live - 1)
        return f"in:{name}"

    def _spawn_instance(self) -> Optional[str]:
        import multiprocessing as mp

        from ..serving.fleet import FleetInstance, instance_queue
        name = f"inst{self._counter}"
        self._counter += 1
        ctx = mp.get_context(self.start_method)
        proc = ctx.Process(target=_serve_instance,
                           args=(self.root, name, self.server_factory),
                           daemon=True)
        proc.start()
        ready = os.path.join(self.root, f"READY_{name}")
        deadline = time.monotonic() + self.ready_timeout_s
        while not os.path.exists(ready):
            if not proc.is_alive() or time.monotonic() > deadline:
                logger.error("instance %s died before READY", name)
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=10)
                return None
            time.sleep(0.02)
        self._procs[name] = proc
        self.router.register_instance(FleetInstance(
            name, instance_queue(self.root, name),
            os.path.join(self.root, f"{name}.health.json"),
            slots=self.slots))
        return name

    def _reap(self) -> None:
        """Collect exited subprocesses. A draining instance exiting ends
        its scale-in (the router forgets it). A live instance exiting
        without a drain flag was killed: its record goes, so the scale
        signal can respawn capacity, and the router's staleness path
        reclaims its spool and fails its streams over."""
        for name, proc in list(self._draining.items()):
            if not proc.is_alive():
                proc.join(timeout=1)
                del self._draining[name]
                self.router.remove_instance(name)
        for name, proc in list(self._procs.items()):
            if not proc.is_alive():
                proc.join(timeout=1)
                del self._procs[name]
                logger.warning("fleet instance %s exited unexpectedly "
                               "(rc=%s)", name, proc.exitcode)

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Fleet-wide stop: raise DONE (every instance drains its work
        and exits), then reap; stragglers are terminated."""
        with open(os.path.join(self.root, "DONE"), "w") as f:
            f.write("1")
        deadline = time.monotonic() + timeout_s
        procs = dict(self._procs)
        procs.update(self._draining)
        for name, proc in procs.items():
            proc.join(timeout=max(0.1, deadline - time.monotonic()))
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
            self.router.remove_instance(name)
        self._procs.clear()
        self._draining.clear()
