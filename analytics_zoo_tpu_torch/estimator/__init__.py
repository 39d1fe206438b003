"""The training loop: ``Estimator``."""
from .estimator import CheckpointCorruptError, Estimator, PreemptedError

__all__ = ["CheckpointCorruptError", "Estimator", "PreemptedError"]
