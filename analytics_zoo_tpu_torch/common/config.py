"""Layered configuration registry (counterpart of ``analytics_zoo_tpu/
common/config.py``), holding the keys the port's path reads.

Precedence, lowest to highest: registered defaults < environment variables
``ZOO_TPU_<UPPER_NAME>`` < programmatic ``set``. The
names and the environment prefix are the JAX package's, so one deployment's
settings apply to both packages.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_ENV_PREFIX = "ZOO_TPU_"


@dataclass
class _Flag:
    name: str
    default: Any
    parser: Callable[[str], Any]
    help: str = ""


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "on")


class Config:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._flags: Dict[str, _Flag] = {}
        self._overrides: Dict[str, Any] = {}

    def register(self, name: str, default: Any, help: str = "",
                 parser: Optional[Callable[[str], Any]] = None) -> None:
        with self._lock:
            if parser is None:
                if isinstance(default, bool):
                    parser = _parse_bool
                elif isinstance(default, int):
                    parser = int
                elif isinstance(default, float):
                    parser = float
                else:
                    parser = str
            self._flags[name] = _Flag(name, default, parser, help)

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            self._overrides[name] = value

    def unset(self, name: str) -> None:
        with self._lock:
            self._overrides.pop(name, None)

    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            flag = self._flags.get(name)
            if name in self._overrides:
                return self._overrides[name]
            env_key = (_ENV_PREFIX
                       + name.upper().replace(".", "_").replace("-", "_"))
            if env_key in os.environ:
                raw = os.environ[env_key]
                return flag.parser(raw) if flag else raw
            if flag is not None:
                return flag.default
            return default


_global_config = Config()


def global_config() -> Config:
    return _global_config


_global_config.register("failure.retry_times", 5,
                        "Max training retries from checkpoint within a retry "
                        "window (reference: bigdl.failure.retryTimes).")
_global_config.register("failure.retry_interval_s", 120.0,
                        "Window seconds for retry budget reset "
                        "(reference: bigdl.failure.retryTimeInterval).")
_global_config.register("failure.io_retries", 3,
                        "Retries for transient result-store read failures "
                        "in the serving client (exponential backoff).")
_global_config.register("failure.io_backoff_s", 0.05,
                        "Base backoff seconds for those retries (doubles "
                        "per attempt).")
_global_config.register("checkpoint.keep", 5,
                        "Snapshots retained per checkpoint dir (older ones "
                        "pruned after each successful write; >= 2 keeps a "
                        "fallback candidate for torn-newest recovery; "
                        "0 = unlimited).")
_global_config.register("checkpoint.verify", True,
                        "Verify the per-snapshot checksum manifest on "
                        "restore; a mismatch raises CheckpointCorruptError "
                        "and elastic restores fall back to the next-older "
                        "valid snapshot.")
_global_config.register("eval.async", True,
                        "Pipeline evaluate()/predict() through the "
                        "DeviceFeed with on-device accumulation (one host "
                        "sync per pass). False falls back to the "
                        "synchronous per-batch loops (parity reference / "
                        "A-B benchmarking).")
_global_config.register("online.snapshot_interval_s", 30.0,
                        "Default wall-time snapshot cadence for "
                        "Estimator.train_online (unbounded streams "
                        "checkpoint by time, not epoch boundaries).")
_global_config.register("data.validate_ids", "count",
                        "Embedding-id validation policy ('count' | 'raise' "
                        "| 'clamp'). 'clamp' clips silently; 'count' clips "
                        "and adds the offenders to a device counter read "
                        "only when asked for; 'raise' raises on "
                        "out-of-range ids (syncs the host each lookup).")
_global_config.register("kernels.fused_embedding", True,
                        "Accepted so the JAX package's settings load; the "
                        "port ignores it. Every embedding lookup takes the "
                        "gather wrapper (ops/embedding_kernels.py): the "
                        "CUDA kernel for a table on the card, its plain "
                        "version for a table on the CPU.")
_global_config.register("embed.sparse_updates", True,
                        "Vocab-sharded tables take the row-subset optimizer "
                        "update (parallel/embedding.py apply_row_update) "
                        "when the optimizer has one (sparse_rows); false "
                        "updates them with the dense optimizer.")
_global_config.register("faults.plan", "",
                        "Fault-injection schedule: 'site:N' fires on the "
                        "N-th call, 'site:0.1' with probability 0.1, "
                        "'@B' suffix sets the budget (default 1); "
                        "comma-separated. '' = injection disabled.")
_global_config.register("faults.seed", 0,
                        "Seed for probabilistic fault-injection draws "
                        "(per-site streams are derived deterministically).")
_global_config.register("metrics.enabled", True,
                        "Record into the process-global metrics registry "
                        "(common/metrics.py). False turns every counter/"
                        "gauge/histogram record into a sub-microsecond "
                        "no-op; serving health counters go dark too.")
_global_config.register("profile.enabled", False,
                        "Step-phase attribution profiler (common/profiler."
                        "py): decompose serving steps into host_input/"
                        "dispatch/execute/fetch/compile phases with MFU and "
                        "roofline gauges. Off = sub-microsecond no-ops.")
_global_config.register("profile.capture_dir", "",
                        "Output directory for torch.profiler capture "
                        "windows ('' disables all captures, armed or not).")
_global_config.register("profile.capture_steps", 0,
                        "Arm one torch.profiler capture for this many "
                        "profiled steps at the first step boundary (0 = not "
                        "armed).")
_global_config.register("profile.capture_on_breach", False,
                        "Arm a time-bounded torch.profiler capture on the "
                        "first serving SLO breach (shed or expired) of the "
                        "process.")
_global_config.register("profile.capture_seconds", 2.0,
                        "Wall-seconds bound for breach-triggered capture "
                        "windows.")
_global_config.register("profile.peak_flops", 0.0,
                        "Override the device's peak bf16 FLOP/s for the MFU "
                        "gauge (0 = auto-detect from the card's name; "
                        "detection knows the H100).")
_global_config.register("ops.enabled", False,
                        "Master switch for the ops plane (the event log, "
                        "the metric history sampler and the SLO alert "
                        "engine). Off by default: a disabled plane costs "
                        "one boolean check per would-be event.")
_global_config.register("ops.dir", "",
                        "Shared event-spool directory for the structured "
                        "event log; empty = a private temp spool per "
                        "creating process.")
_global_config.register("ops.ring_events", 2048,
                        "Capacity of the per-process in-memory event ring "
                        "(EventLog.tail); the JSONL spool on disk is the "
                        "unbounded record.")
_global_config.register("serving.brownout_high", 0.75,
                        "Pressure (max of queue-fill and KV-page-scarcity "
                        "ratios) above which the brownout controller steps "
                        "DOWN one degradation rung on the next shed pass.")
_global_config.register("serving.brownout_low", 0.35,
                        "Pressure below which the brownout controller "
                        "steps back UP one rung after "
                        "serving.brownout_hold_ticks consecutive calm "
                        "ticks.")
_global_config.register("serving.brownout_hold_ticks", 3,
                        "Consecutive calm ticks required before the "
                        "brownout controller recovers one rung "
                        "(hysteresis).")
_global_config.register("serving.brownout_token_frac", 0.25,
                        "Fraction of the configured max_new_tokens that "
                        "the deepest brownout rung caps generative "
                        "budgets to (rung 3; rung 2 caps at twice this).")
_global_config.register("ops.sample_interval_s", 0.25,
                        "Cadence of the metric history sampler thread "
                        "snapshotting the registry into per-series rings.")
_global_config.register("ops.history_depth", 512,
                        "Samples retained per (metric, label) series in "
                        "the history rings (memory is series x depth).")
_global_config.register("ops.eval_interval_s", 0.5,
                        "Cadence of the SLO alert engine's evaluation "
                        "pass over the metric history.")
_global_config.register("ops.incident_dir", "",
                        "Directory incident bundles are sealed into; "
                        "empty = an 'incidents/' subdirectory of the "
                        "event spool.")
_global_config.register("ops.incident_window_s", 60.0,
                        "Trailing window of events and metric history "
                        "frozen into each incident bundle.")
_global_config.register("fleet.stale_after_s", 5.0,
                        "Health-file age beyond which the fleet router "
                        "treats an instance as dead: its spool is "
                        "reclaimed and its in-flight streams fail over "
                        "from their last streamed prefix.")
_global_config.register("fleet.health_refresh_s", 0.25,
                        "Router cadence for re-reading per-instance "
                        "health files (placement gauges refresh at most "
                        "this often).")
_global_config.register("fleet.scale_headroom", 1.25,
                        "Multiplier on observed demand when computing the "
                        "fleet.desired_instances scale signal (>1 keeps "
                        "spare capacity for failover).")
_global_config.register("fleet.scale_interval_s", 0.25,
                        "Fleet supervisor actuation cadence: how often "
                        "the desired-instance signal is compared against "
                        "the live fleet and a spawn/drain is issued.")
_global_config.register("fleet.breaker_failures", 3,
                        "Consecutive settled error terminals from one "
                        "instance that trip its circuit breaker open.")
_global_config.register("fleet.breaker_latency_ratio", 4.0,
                        "An instance whose EWMA service time exceeds this "
                        "multiple of the fleet median for "
                        "fleet.breaker_failures consecutive health "
                        "refreshes trips its breaker.")
_global_config.register("fleet.breaker_cooldown_s", 1.0,
                        "Seconds an open breaker holds before moving to "
                        "half-open and admitting one probe placement.")
_global_config.register("client.retry_budget_ratio", 0.1,
                        "Retry-budget token-bucket earn rate: each first "
                        "attempt deposits this many tokens, each "
                        "retry/hedge spends one, so retry amplification "
                        "stays at most 1 + ratio.")
_global_config.register("client.retry_attempts", 2,
                        "Max budgeted retries per logical request in "
                        "ResilientClient.call (only on terminal errors "
                        "with retriable: true).")
_global_config.register("client.retry_backoff_s", 0.05,
                        "Full-jitter retry backoff base: attempt N sleeps "
                        "uniform(0, base * 2^N) seconds before "
                        "re-enqueueing.")
_global_config.register("client.hedge_delay_ms", 200.0,
                        "Hedge trigger floor for ResilientClient."
                        "query_any: a second copy races the first after "
                        "this long (or the client's observed p99 once "
                        "enough history exists) without a terminal.")
