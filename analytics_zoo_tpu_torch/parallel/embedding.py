"""Embedding-id validation (counterpart of ``analytics_zoo_tpu/parallel/
embedding.py``: ``validate_ids`` only; the vocab-sharded engine is a later
slice). JAX's ``fused_kernels`` has no counterpart: the port has one gather
path, so ``kernels.fused_embedding`` selects nothing."""
from __future__ import annotations

import threading
from typing import Dict

import torch

from ..common.config import global_config

_oob_lock = threading.Lock()
#: device -> int64 scalar counting out-of-range ids seen in ``count`` mode
_oob_counters: Dict[torch.device, torch.Tensor] = {}


def _oob_counter(device: torch.device) -> torch.Tensor:
    c = _oob_counters.get(device)
    if c is None:
        # made outside inference mode, so training steps can add to it too
        with torch.inference_mode(False), torch.no_grad():
            c = torch.zeros((), dtype=torch.int64, device=device)
        _oob_counters[device] = c
    return c


def oob_ids_total() -> int:
    """Out-of-range ids counted so far, summed over devices. Reads the
    device counters, so it waits for the device: call it off the hot path."""
    with _oob_lock:
        counters = list(_oob_counters.values())
    return int(sum(int(c.item()) for c in counters))


def reset_oob_ids() -> None:
    with _oob_lock:
        _oob_counters.clear()


def validate_ids(idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """Apply the ``data.validate_ids`` policy to an integer id tensor.

    * ``clamp``: clip to ``[0, vocab-1]`` silently.
    * ``count`` (default): clip, and add the offenders to a counter on the
      ids' device. Nothing waits for the device; :func:`oob_ids_total`
      reads the counter when asked.
    * ``raise``: raise ValueError on any offender. This reads the count on
      the host, so it waits for the device on every lookup.
    """
    mode = str(global_config().get("data.validate_ids"))
    if mode not in ("clamp", "count", "raise"):
        raise ValueError(f"data.validate_ids={mode!r}: expected "
                         f"'clamp', 'count' or 'raise'")
    clamped = idx.clamp(0, vocab - 1)
    bad = (idx < 0) | (idx >= vocab)
    if mode == "clamp":
        return clamped
    n_bad = bad.sum()
    if mode == "raise":
        count = int(n_bad)
        if count:
            raise ValueError(
                f"{count} embedding id(s) out of range [0, {vocab}) "
                f"(data.validate_ids=raise)")
        return clamped
    with _oob_lock:
        _oob_counter(idx.device).add_(n_bad)
    return clamped

