"""Layers of the port's Keras-style API."""
from .core import Activation, Dense, Flatten, Lambda, Merge, merge
from .embedding import Embedding, SparseEmbedding

__all__ = ["Activation", "Dense", "Embedding", "Flatten", "Lambda", "Merge",
           "SparseEmbedding", "merge"]
