"""Convolution and pooling layers (counterpart of ``analytics_zoo_tpu/keras/
layers/conv.py``).

Activations stay NHWC between layers, as in the JAX package, and kernels
keep its layout and names: a 2-D kernel is ``[kh, kw, cin / groups, cout]``
(HWIO), a 1-D one ``[k, cin, cout]``, so ``convert.from_jax_params`` maps
them by name alone. The forward hands cuDNN the NCHW view of the NHWC
activations (``permute``, no copy): a contiguous NHWC tensor is an NCHW
tensor in ``torch.channels_last`` memory, the convolution returns that
layout too, and its NHWC view is contiguous again. The kernel is permuted
to OIHW and cast to the activations' dtype in one copy a forward.

Padding is XLA's. ``"same"`` pads ``max((ceil(n / s) - 1) * s + k - n, 0)``
in all (``k`` the dilated kernel), half of it (rounded down) before and the
rest after: at a stride of 2 on an even size that is one more after than
before (ResNet's stem conv pads 224 by (2, 3), its 3x3/2 convs and stem
pool pad (0, 1)), which ``torch.nn.functional.conv2d`` cannot say, so the
excess is padded explicitly. An int or a pair pads both sides alike (the
JAX package's torch geometry). Max pooling pads with -inf; average pooling
pads with zeros and divides by the whole window, padding included.

``Convolution2D`` has the JAX package's two int8 routes: a kernel that
``inference.quantize`` made a ``QuantizedWeight`` runs through
``qconv_apply`` (weight-only: dequantized in the inputs' dtype; calibrated:
int8 by int8 in int32), and ``int8_training=True`` runs
``ops.int8_training.int8_train_conv`` (an int8 forward with dynamic scales,
straight-through bf16 gradients).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import initializers
from ..engine import Layer
from .core import get_activation
from ...inference.quantize import QuantizedWeight, qconv_apply

Padding = Union[str, Tuple[Tuple[int, int], ...]]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def _padding_of(border_mode) -> Padding:
    """``border_mode`` -> ``"SAME"``, ``"VALID"`` or ``((ph, ph), (pw,
    pw))`` for an int or an ``(ph, pw)`` pair (symmetric explicit pads)."""
    if border_mode == "same":
        return "SAME"
    if border_mode == "valid":
        return "VALID"
    ph, pw = _pair(border_mode)
    return ((int(ph), int(ph)), (int(pw), int(pw)))


def _conv_out(size, k, stride, padding, axis=0):
    if size is None:
        return None
    if padding == "SAME":
        return -(-size // stride)
    if padding == "VALID":
        return (size - k) // stride + 1
    lo, hi = padding[axis]
    return (size + lo + hi - k) // stride + 1


def _pads(sizes: Sequence[int], window: Sequence[int],
          strides: Sequence[int], padding: Padding,
          dilation: Sequence[int] = None) -> Tuple[Tuple[int, int], ...]:
    """``(lo, hi)`` pads an axis of each spatial size, as XLA pads them."""
    dilation = dilation or (1,) * len(sizes)
    if padding == "VALID":
        return tuple((0, 0) for _ in sizes)
    if padding != "SAME":
        return tuple(tuple(p) for p in padding)
    out = []
    for n, k, s, d in zip(sizes, window, strides, dilation):
        eff = (k - 1) * d + 1
        total = max((-(-n // s) - 1) * s + eff - n, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _split_pads(pads, value: float, x: torch.Tensor):
    """``x`` (channels first) padded with ``value`` by the excess of each
    axis's larger pad over its smaller one, on that side (SAME pads at
    least as much after as before; an explicit pair may pad more before),
    and the symmetric pads left for the operation. ``F.pad`` takes the
    last axis first."""
    sym = tuple(min(lo, hi) for lo, hi in pads)
    extra = [n for (lo, hi), m in zip(reversed(pads), reversed(sym))
             for n in (lo - m, hi - m)]
    if any(extra):
        x = F.pad(x, extra, value=value)
    return x, sym


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
                padding: Padding, dilation: Sequence[int] = (1, 1),
                groups: int = 1) -> torch.Tensor:
    """The float convolution of NHWC ``x`` with the HWIO kernel ``w`` (cast
    to ``x``'s dtype) and XLA's padding, on cuDNN through the NCHW view of
    channels_last memory: NHWC out, contiguous."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory
    pads = _pads(xc.shape[2:], w.shape[:2], strides, padding, dilation)
    xc, sym = _split_pads(pads, 0.0, xc)
    wt = w.permute(3, 2, 0, 1).to(x.dtype, memory_format=torch.channels_last)
    return F.conv2d(xc, wt, None, tuple(strides), sym, tuple(dilation),
                    groups).permute(0, 2, 3, 1)


class Convolution2D(Layer):
    """2-D convolution over NHWC inputs, kernel ``[kh, kw, cin / groups,
    cout]``, with strides (``subsample``), dilation, ``groups`` (a
    depthwise conv when it equals the channels), bias and activation. The
    product runs in the inputs' dtype; ``int8_training`` runs it int8 by
    int8 with straight-through gradients (opt-in: quantization noise
    changes the training numerics)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), border_mode="valid",
                 init="glorot_uniform", bias: bool = True,
                 dilation=(1, 1), groups: int = 1,
                 int8_training: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.filters = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.strides = _pair(subsample)
        self.padding = _padding_of(border_mode)
        self.activation = get_activation(activation)
        self.init = initializers.get(init)
        self.use_bias = bias
        self.dilation = _pair(dilation)
        self.groups = groups
        self.int8_training = int8_training

    def build(self, generator, input_shape, device):
        cin = input_shape[-1]
        kh, kw = self.kernel_size
        self.kernel = nn.Parameter(self.init(
            generator, (kh, kw, cin // self.groups, self.filters)).to(device))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(self.filters, device=device))
        self.built = True

    def forward(self, inputs):
        kernel = self.kernel
        if isinstance(kernel, QuantizedWeight):
            y = qconv_apply(inputs, kernel, self.strides, self.padding,
                            self.dilation, self.groups)
        elif self.int8_training:
            from ...ops.int8_training import int8_train_conv
            y = int8_train_conv(inputs, kernel, self.strides, self.padding,
                                self.dilation, self.groups)
        else:
            y = conv2d_nhwc(inputs, kernel, self.strides, self.padding,
                            self.dilation, self.groups)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        n, h, w, _ = input_shape
        kh, kw = self.kernel_size
        sh, sw = self.strides
        return (n, _conv_out(h, kh, sh, self.padding, 0),
                _conv_out(w, kw, sw, self.padding, 1), self.filters)


Conv2D = Convolution2D


class Convolution1D(Layer):
    """1-D convolution over ``[n, length, channels]``, kernel ``[k, cin,
    cout]``."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, border_mode="valid",
                 init="glorot_uniform", bias: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.filters = nb_filter
        self.kernel_size = filter_length
        self.stride = subsample_length
        self.padding = "SAME" if border_mode == "same" else "VALID"
        self.activation = get_activation(activation)
        self.init = initializers.get(init)
        self.use_bias = bias

    def build(self, generator, input_shape, device):
        cin = input_shape[-1]
        self.kernel = nn.Parameter(self.init(
            generator, (self.kernel_size, cin, self.filters)).to(device))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(self.filters, device=device))
        self.built = True

    def forward(self, inputs):
        x = inputs.permute(0, 2, 1)
        pads = _pads(x.shape[2:], (self.kernel_size,), (self.stride,),
                     self.padding)
        x, sym = _split_pads(pads, 0.0, x)
        w = self.kernel.permute(2, 1, 0).to(inputs.dtype)
        y = F.conv1d(x, w, None, self.stride, sym).permute(0, 2, 1)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        n, l, _ = input_shape
        return (n, _conv_out(l, self.kernel_size, self.stride, self.padding),
                self.filters)


Conv1D = Convolution1D


def _pool(x: torch.Tensor, window, strides, padding: Padding, kind: str):
    """Max (``kind`` "max") or average pooling of channels-first ``x``
    over its last one or two axes with XLA's padding: -inf pads for max,
    zero pads counted in the average's divisor."""
    pads = _pads(x.shape[2:], window, strides, padding)
    if kind == "max":
        x, lo = _split_pads(pads, float("-inf"), x)
        fn = F.max_pool2d if len(window) == 2 else F.max_pool1d
        return fn(x, window, strides, lo)
    x, lo = _split_pads(pads, 0.0, x)
    return F.avg_pool2d(x, window, strides, lo, count_include_pad=True,
                        divisor_override=window[0] * window[1])


class _Pool2D(Layer):
    #: "max" or "avg"
    kind = ""

    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 name: Optional[str] = None):
        super().__init__(name)
        self.pool_size = _pair(pool_size)
        self.strides = (_pair(strides) if strides is not None
                        else self.pool_size)
        self.padding = _padding_of(border_mode)

    def compute_output_shape(self, input_shape):
        n, h, w, c = input_shape
        ph, pw = self.pool_size
        sh, sw = self.strides
        return (n, _conv_out(h, ph, sh, self.padding, 0),
                _conv_out(w, pw, sw, self.padding, 1), c)

    def forward(self, inputs):
        y = _pool(inputs.permute(0, 3, 1, 2), self.pool_size, self.strides,
                  self.padding, self.kind)
        return y.permute(0, 2, 3, 1)


class MaxPooling2D(_Pool2D):
    kind = "max"


class AveragePooling2D(_Pool2D):
    kind = "avg"


class MaxPooling1D(Layer):
    def __init__(self, pool_length=2, stride=None, border_mode="valid",
                 name: Optional[str] = None):
        super().__init__(name)
        self.pool = pool_length
        self.stride = stride or pool_length
        self.padding = "SAME" if border_mode == "same" else "VALID"

    def forward(self, inputs):
        y = _pool(inputs.permute(0, 2, 1), (self.pool,), (self.stride,),
                  self.padding, "max")
        return y.permute(0, 2, 1)

    def compute_output_shape(self, input_shape):
        n, l, c = input_shape
        return (n, _conv_out(l, self.pool, self.stride, self.padding), c)


class GlobalMaxPooling2D(Layer):
    def forward(self, inputs):
        return inputs.amax(dim=(1, 2))

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[3])


class GlobalAveragePooling2D(Layer):
    def forward(self, inputs):
        return inputs.mean(dim=(1, 2))

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[3])


class GlobalMaxPooling1D(Layer):
    def forward(self, inputs):
        return inputs.amax(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[2])


class GlobalAveragePooling1D(Layer):
    def forward(self, inputs):
        return inputs.mean(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[2])


class ZeroPadding2D(Layer):
    def __init__(self, padding=(1, 1), name: Optional[str] = None):
        super().__init__(name)
        self.pad = _pair(padding)

    def forward(self, inputs):
        ph, pw = self.pad
        return F.pad(inputs, (0, 0, pw, pw, ph, ph))

    def compute_output_shape(self, input_shape):
        n, h, w, c = input_shape
        ph, pw = self.pad
        return (n, None if h is None else h + 2 * ph,
                None if w is None else w + 2 * pw, c)
