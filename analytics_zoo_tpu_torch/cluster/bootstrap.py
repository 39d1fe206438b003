"""What a spawned worker runs before user code (counterpart of
``analytics_zoo_tpu/cluster/bootstrap.py``): here only the resolution of a
``module:function`` target, which ``FleetSupervisor``'s instances call."""
from __future__ import annotations

import importlib


def resolve_target(spec: str):
    """``package.module:function`` -> the callable."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"target '{spec}' must be 'module:function'")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name)
    if not callable(fn):
        raise TypeError(f"target {spec} is not callable")
    return fn
