"""Layers of the port's Keras-style API."""
from .core import Dense, Flatten, Lambda, Merge, merge
from .embedding import Embedding

__all__ = ["Dense", "Embedding", "Flatten", "Lambda", "Merge", "merge"]
