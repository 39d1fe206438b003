"""Keras-style API: ``Input``, the functional ``Model``, ``Sequential`` and
their layers."""
from .engine import Input, InputLayer, Layer, Model, Sequential, SymbolicTensor

__all__ = ["Input", "InputLayer", "Layer", "Model", "Sequential",
           "SymbolicTensor"]
