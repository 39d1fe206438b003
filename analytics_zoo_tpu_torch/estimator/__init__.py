"""The training loop: ``Estimator``."""
from .estimator import Estimator

__all__ = ["Estimator"]
