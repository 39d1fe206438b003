"""Keras-style API: ``Input``, the functional ``Model`` and its layers."""
from .engine import Input, InputLayer, Layer, Model, SymbolicTensor

__all__ = ["Input", "InputLayer", "Layer", "Model", "SymbolicTensor"]
