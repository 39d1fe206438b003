"""Core layers (counterpart of ``analytics_zoo_tpu/keras/layers/core.py``):
``Dense``, ``Flatten``, ``Lambda`` and ``Merge``/``merge`` (concat, mul)."""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from .. import initializers
from ..engine import Layer

# -- activations -------------------------------------------------------------

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": torch.nn.functional.softplus,
    "linear": lambda x: x,
    None: lambda x: x,
}


def get_activation(act: Union[str, Callable, None]) -> Callable:
    if callable(act):
        return act
    if act not in _ACTIVATIONS:
        raise ValueError(f"unknown activation '{act}'")
    return _ACTIVATIONS[act]


class Dense(Layer):
    """Fully connected layer: ``activation(x @ kernel + bias)`` with
    ``kernel`` ``[in, out]``, the JAX package's layout."""

    def __init__(self, output_dim: int, activation=None,
                 init="glorot_uniform", bias: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.output_dim = output_dim
        self.activation = get_activation(activation)
        self.init = initializers.get(init)
        self.use_bias = bias

    def build(self, generator, input_shape, device):
        in_dim = input_shape[-1]
        self.kernel = nn.Parameter(
            self.init(generator, (in_dim, self.output_dim)).to(device))
        if self.use_bias:
            self.bias = nn.Parameter(
                torch.zeros(self.output_dim, device=device))
        self.built = True

    def forward(self, inputs):
        y = inputs @ self.kernel.to(inputs.dtype)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Flatten(Layer):
    def forward(self, inputs):
        return inputs.reshape(inputs.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))


class Lambda(Layer):
    """An arbitrary tensor function as a layer."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        super().__init__(name)
        self.fn = fn

    def forward(self, inputs):
        return self.fn(inputs)

    def compute_output_shape(self, input_shape):
        # shape inference on meta tensors: no memory, no compute
        def dummy(shape):
            return torch.zeros(tuple(1 if d is None else d for d in shape),
                               device="meta")
        if isinstance(input_shape, list):
            out = self.fn([dummy(s) for s in input_shape])
        else:
            out = self.fn(dummy(input_shape))
        return (None,) + tuple(out.shape[1:])


class Merge(Layer):
    """Merge a list of inputs: ``concat`` along ``concat_axis`` or
    elementwise ``mul``."""

    MODES = ("mul", "concat")

    def __init__(self, mode: str = "concat", concat_axis: int = -1,
                 name: Optional[str] = None):
        super().__init__(name)
        if mode not in self.MODES:
            raise ValueError(f"merge mode '{mode}' is not ported; have "
                             f"{self.MODES}")
        self.mode = mode
        self.concat_axis = concat_axis

    def forward(self, inputs):
        xs = list(inputs)
        if self.mode == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out

    def compute_output_shape(self, input_shape):
        shapes = input_shape
        if self.mode == "concat":
            ax = self.concat_axis
            out = list(shapes[0])
            dims = [s[ax] for s in shapes]
            out[ax] = None if any(d is None for d in dims) else sum(dims)
            return tuple(out)
        return shapes[0]


def merge(inputs, mode="concat", concat_axis=-1, name=None):
    return Merge(mode, concat_axis, name)(inputs)
