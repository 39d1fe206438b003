"""Layers of the port's Keras-style API."""
from .attention import BERT, MultiHeadAttention
from .core import Activation, Dense, Dropout, Flatten, Lambda, Merge, merge
from .embedding import Embedding, SparseEmbedding

__all__ = ["Activation", "BERT", "Dense", "Dropout", "Embedding", "Flatten",
           "Lambda", "Merge", "MultiHeadAttention", "SparseEmbedding",
           "merge"]
