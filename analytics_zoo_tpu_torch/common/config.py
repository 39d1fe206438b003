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


_global_config.register("failure.io_retries", 3,
                        "Retries for transient result-store read failures "
                        "in the serving client (exponential backoff).")
_global_config.register("failure.io_backoff_s", 0.05,
                        "Base backoff seconds for those retries (doubles "
                        "per attempt).")
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
