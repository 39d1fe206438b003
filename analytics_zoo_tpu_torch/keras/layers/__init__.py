"""Layers of the port's Keras-style API."""
from .attention import BERT, MultiHeadAttention, TransformerLayer
from .conv import (AveragePooling2D, Conv1D, Conv2D, Convolution1D,
                   Convolution2D, GlobalAveragePooling1D,
                   GlobalAveragePooling2D, GlobalMaxPooling1D,
                   GlobalMaxPooling2D, MaxPooling1D, MaxPooling2D,
                   ZeroPadding2D)
from .core import Activation, Dense, Dropout, Flatten, Lambda, Merge, merge
from .embedding import Embedding, SparseEmbedding
from .norm import BatchNormalization, LayerNormalization

__all__ = ["Activation", "AveragePooling2D", "BERT", "BatchNormalization",
           "Conv1D", "Conv2D", "Convolution1D", "Convolution2D", "Dense",
           "Dropout", "Embedding", "Flatten", "GlobalAveragePooling1D",
           "GlobalAveragePooling2D", "GlobalMaxPooling1D",
           "GlobalMaxPooling2D", "Lambda", "LayerNormalization",
           "MaxPooling1D", "MaxPooling2D", "Merge", "MultiHeadAttention",
           "SparseEmbedding", "TransformerLayer", "ZeroPadding2D", "merge"]
