"""Training triggers (counterpart of ``analytics_zoo_tpu/common/
triggers.py``): predicates over the loop's :class:`TrainingState` that
decide when to validate, checkpoint or stop."""
from __future__ import annotations

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
    """Fires every ``interval`` iterations."""

    requires_loss = False

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval

    def __call__(self, state: TrainingState) -> bool:
        return state.iteration > 0 and state.iteration % self.interval == 0


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
