"""Core layers (counterpart of ``analytics_zoo_tpu/keras/layers/core.py``):
``Activation``, ``Dense``, ``Dropout``, ``Flatten``, ``Lambda`` and
``Merge``/``merge`` (sum, mul, max, min, ave, concat, dot, cosine; ``sum``
by default, as in the JAX package)."""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from .. import initializers
from ..engine import Layer
from ...inference.quantize import QuantizedWeight, qdense_apply

# -- activations -------------------------------------------------------------

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": torch.nn.functional.softplus,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "linear": lambda x: x,
    None: lambda x: x,
}


def get_activation(act: Union[str, Callable, None]) -> Callable:
    if callable(act):
        return act
    if act not in _ACTIVATIONS:
        raise ValueError(f"unknown activation '{act}'")
    return _ACTIVATIONS[act]


class Activation(Layer):
    def __init__(self, activation, name: Optional[str] = None):
        super().__init__(name)
        self.fn = get_activation(activation)

    def forward(self, inputs):
        return self.fn(inputs)


class Dense(Layer):
    """Fully connected layer: ``activation(x @ kernel + bias)`` with
    ``kernel`` ``[in, out]``, the JAX package's layout. The product runs in
    the input's dtype; an int8 kernel (``inference.quantize``) takes
    ``qdense_apply``."""

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
        if isinstance(self.kernel, QuantizedWeight):
            y = qdense_apply(inputs, self.kernel)
        else:
            y = inputs @ self.kernel.to(inputs.dtype)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each entry with probability ``rate`` and scale the rest by
    ``1/(1-rate)``, the mask drawn from ``generator`` (the model's dropout
    generator, on ``x``'s device), never from torch's global RNG."""
    if generator is None:
        raise ValueError("dropout in training mode needs the model's dropout "
                         "generator (the Estimator sets it; or call "
                         "set_dropout_generator)")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Dropout(Layer):
    """The identity outside training; in training, :func:`dropout` at rate
    ``p``."""

    def __init__(self, p: float, name: Optional[str] = None):
        super().__init__(name)
        self.rate = p

    def forward(self, inputs):
        if not self.training or self.rate <= 0.0:
            return inputs
        return dropout(inputs, self.rate, self.dropout_generator)


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
    """Merge a list of inputs: sum/mul/max/min/ave elementwise, concat along
    ``concat_axis``, or the row-wise dot product or cosine of two inputs."""

    MODES = ("sum", "mul", "max", "ave", "min", "concat", "dot", "cosine")

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 name: Optional[str] = None):
        super().__init__(name)
        if mode not in self.MODES:
            raise ValueError(f"unknown merge mode '{mode}'")
        self.mode = mode
        self.concat_axis = concat_axis

    def forward(self, inputs):
        xs = list(inputs)
        if self.mode == "sum":
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        if self.mode == "mul":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
            return out
        if self.mode == "max":
            return torch.stack(xs).amax(dim=0)
        if self.mode == "min":
            return torch.stack(xs).amin(dim=0)
        if self.mode == "ave":
            return torch.stack(xs).mean(dim=0)
        if self.mode == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        a, b = xs[0], xs[1]
        if self.mode == "cosine":
            a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
            b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
        return torch.sum(a * b, dim=-1, keepdim=True)

    def compute_output_shape(self, input_shape):
        shapes = input_shape
        if self.mode in ("dot", "cosine"):
            return (shapes[0][0], 1)
        if self.mode == "concat":
            ax = self.concat_axis
            out = list(shapes[0])
            dims = [s[ax] for s in shapes]
            out[ax] = None if any(d is None for d in dims) else sum(dims)
            return tuple(out)
        return shapes[0]


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    return Merge(mode, concat_axis, name)(inputs)
