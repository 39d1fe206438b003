"""The int8 training convolution (counterpart of ``analytics_zoo_tpu/ops/
int8_training.py``): a convolution whose forward runs int8 by int8 with
int32 sums, with a dynamic per-tensor activation scale and per-output-
channel weight scales, and whose backward is the straight-through
estimator: the input and weight gradients in bf16 against the dequantized
input, the int8 input (half a bf16 save's bytes) its saved residual.

The forward's int8 convolution is ``ops.int8_dataflow.int8_conv2d``
(``torch._int_mm`` over patches, exact in int32, the same code on both
devices); the backward is one ``aten.convolution_backward`` in bf16
(cuDNN's dgrad and wgrad on the card). The max-based dynamic scale never
clips, so the estimator is exact up to the rounding of the quantizer.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .int8_dataflow import (_quantize_weight_pc, conv_transposes,
                            dequant_int8, int8_conv2d, per_127, quant_int8)


def _quantize_dynamic(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: scale ``max|x| / 127`` (no clipping)."""
    xf = x.to(torch.float32)
    s = per_127(torch.clamp(xf.abs().max(), min=1e-12))
    return quant_int8(xf, s), s


class _Int8TrainConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, strides, padding, dilation, groups):
        xq, sx = _quantize_dynamic(x)
        wq, sw = _quantize_weight_pc(kernel)
        acc = int8_conv2d(xq, wq, strides, padding, dilation, groups)
        ctx.save_for_backward(xq, sx, kernel)
        ctx.conv = (strides, padding, dilation, groups)
        ctx.x_dtype = x.dtype
        return (acc.to(torch.float32) * (sx * sw)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, sx, kernel = ctx.saved_tensors
        strides, padding, dilation, groups = ctx.conv
        dx, dk = conv_transposes(dequant_int8(xq, sx),
                                 kernel.to(torch.bfloat16),
                                 g.to(torch.bfloat16), strides, padding,
                                 dilation, groups)
        return (dx.to(ctx.x_dtype), dk.to(kernel.dtype), None, None, None,
                None)


def int8_train_conv(x: torch.Tensor, kernel: torch.Tensor,
                    strides: Sequence[int], padding,
                    dilation: Sequence[int] = (1, 1),
                    groups: int = 1) -> torch.Tensor:
    """Forward: int8 by int8 convolution of NHWC ``x`` and HWIO ``kernel``
    summed in int32, rescaled to ``x``'s dtype. Backward (straight-through):
    bf16 input and weight gradients against the dequantized input, cast to
    ``x``'s and ``kernel``'s dtypes; the saved activation is int8."""
    return _Int8TrainConv.apply(x, kernel, tuple(strides), padding,
                                tuple(dilation), groups)
