"""Training triggers (counterpart of ``analytics_zoo_tpu/common/
triggers.py``): predicates over the loop's :class:`TrainingState` that
decide when to validate, checkpoint or stop."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class TrainingState:
    """Loop state visible to triggers."""

    epoch: int = 1                 # 1-based current epoch
    iteration: int = 0             # global step counter
    loss: Optional[float] = None   # last train loss, when a trigger reads it
    score: Optional[float] = None  # last validation score
    epoch_finished: bool = False   # set by the loop at an epoch boundary
    #: steps the loop advanced since the previous trigger check (K under
    #: ``steps_per_dispatch=K``); interval triggers fire on boundary
    #: crossings within that window rather than exact multiples, so
    #: non-aligned intervals quantize to the group boundary instead of
    #: being skipped
    dispatch_width: int = 1


class Trigger:
    #: True when the trigger reads the per-step loss: the loop copies the
    #: loss to the host each step only when some trigger needs it
    requires_loss: bool = True

    def __call__(self, state: TrainingState) -> bool:
        raise NotImplementedError


class EveryEpoch(Trigger):
    """Fires once per full epoch."""

    requires_loss = False

    def __call__(self, state: TrainingState) -> bool:
        return state.epoch_finished


class SeveralIteration(Trigger):
    """Fires every ``interval`` iterations.

    Under multi-step dispatch the counter advances ``dispatch_width`` steps
    between checks; this fires whenever an interval boundary was crossed
    inside that window (interval 100, width 8 fires at iteration 104),
    which is exact ``iteration % interval == 0`` at width 1.
    """

    requires_loss = False

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval

    def __call__(self, state: TrainingState) -> bool:
        if state.iteration <= 0:
            return False
        prev = max(0, state.iteration - max(1, state.dispatch_width))
        return state.iteration // self.interval > prev // self.interval


class MaxEpoch(Trigger):
    requires_loss = False

    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, state: TrainingState) -> bool:
        return state.epoch > self.max_epoch


class MaxIteration(Trigger):
    requires_loss = False

    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, state: TrainingState) -> bool:
        return state.iteration >= self.max_iteration


class TimeInterval(Trigger):
    """Fires when ``interval_s`` of wall time has passed since the last
    fire (monotonic clock). ``train_online`` paces its snapshots with it:
    an unbounded stream has no epoch boundary worth waiting for. The timer
    arms at the first check, so the first fire comes one full interval
    into training."""

    requires_loss = False

    def __init__(self, interval_s: float):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self._last: Optional[float] = None

    def __call__(self, state: TrainingState) -> bool:
        now = time.monotonic()
        if self._last is None:
            self._last = now
            return False
        if now - self._last >= self.interval_s:
            self._last = now
            return True
        return False


class Never(Trigger):
    """Never fires: the end trigger of unbounded online training, which
    runs until it is preempted (SIGTERM) or killed."""

    requires_loss = False

    def __call__(self, state: TrainingState) -> bool:
        return False
