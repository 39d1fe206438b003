"""Recommendation models."""
from .ncf import NeuralCF

__all__ = ["NeuralCF"]
