"""Normalization layers (counterpart of ``analytics_zoo_tpu/keras/layers/
norm.py``).

``BatchNormalization`` keeps the JAX package's arithmetic. In training the
statistics are the batch's, in f32 whatever the activations' dtype: the
mean and the mean of squares, and the biased variance ``E[x^2] - E[x]^2``
clamped at 0. The running statistics move as ``m * old + (1 - m) * batch``
with ``m = momentum`` (0.99). They are buffers, ``moving_mean`` and
``moving_var``, so they sit in the ``state_dict`` (and in a checkpoint)
beside ``gamma`` and ``beta`` and the optimizer never sees them: the JAX
package's model state. In eval mode the running statistics normalize. The
output is ``x * a + b`` in f32, with ``a = gamma * rsqrt(var + eps)`` and
``b = beta - a * mean``, cast back to the input's dtype.

``exact_statistics=True`` makes the layer give the same bits on the CPU
and on the card: the mean and the mean of squares are summed in f64 (where
each f32 square is exact) and rounded once to f32, the inverse standard
deviation is a correctly rounded ``1 / sqrt`` (CUDA's ``rsqrt`` is not),
and ``x * a + b`` is two roundings, never a fused multiply-add. It costs an
f64 copy of the input. ``resnet(int8_training=True)`` sets it: there the
next convolution requantizes each output with a scale from its maximum, so
one unit in the last place that moves a code across a rounding tie moves
the codes of the layers after it, and such flips multiply layer by layer.

``torch.nn.functional.batch_norm`` is not used: its running update takes
the unbiased variance with the other momentum convention.

Training mode is ``nn.Module.training``. Batch statistics over more than
one rank (the JAX package's global batch under a mesh) are not ported:
training under a mesh of more than one rank raises.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..engine import Layer

#: what raises for batch statistics over ranks
SYNC_BN_TODO = ("BatchNormalization in training on a mesh of {ranks} ranks "
                "needs the global batch's statistics, which are not ported "
                "yet: ROADMAP Queue A item 7 (multi-card)")


def _inv_std(var: torch.Tensor, eps: float, exact: bool) -> torch.Tensor:
    if exact:
        return torch.sqrt(var + eps).reciprocal()
    return torch.rsqrt(var + eps)


def _affine(xf: torch.Tensor, a: torch.Tensor, b: torch.Tensor, shape,
            exact: bool) -> torch.Tensor:
    if exact:
        return xf * a.view(shape) + b.view(shape)
    return torch.addcmul(b.view(shape), xf, a.view(shape))


class _TrainBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over ``dims`` of ``x`` (channels on the
    other axis): saves ``x`` in its own dtype instead of f32 copies, and
    takes the gradient of ``(x - mean) * inv * gamma + beta`` in f32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, dims, shape, exact: bool):
        xf = x.to(torch.float32)
        if exact:
            xd = xf.to(torch.float64)
            mean64 = xd.mean(dims)
            var = torch.clamp(xd.square().mean(dims) - mean64.square(),
                              min=0.0).to(torch.float32)
            mean = mean64.to(torch.float32)
        else:
            mean = xf.mean(dims)
            var = torch.clamp(xf.square().mean(dims) - mean.square(),
                              min=0.0)
        inv = _inv_std(var, eps, exact)
        a = gamma * inv
        b = beta - gamma * inv * mean
        y = _affine(xf, a, b, shape, exact)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        ctx.dims, ctx.shape = dims, shape
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        n = x.numel() // mean.numel()
        g = dy.to(torch.float32)
        xhat = (x.to(torch.float32) - mean.view(shape)) * inv.view(shape)
        dbeta = g.sum(dims)
        dgamma = (g * xhat).sum(dims)
        dx = (g - (dbeta / n).view(shape)
              - xhat * (dgamma / n).view(shape)) * (gamma * inv).view(shape)
        return dx.to(x.dtype), dgamma, dbeta, None, None, None, None


class BatchNormalization(Layer):
    """Batch normalization over every axis but ``axis`` (the channels, last
    by default), with ``gamma``/``beta`` parameters and ``moving_mean``/
    ``moving_var`` running statistics (buffers); ``exact_statistics`` gives
    the same bits on every device (see the module's docstring)."""

    #: the running statistics are per rank; see :data:`SYNC_BN_TODO`
    batch_statistics = True

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 axis: int = -1, exact_statistics: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.epsilon = epsilon
        self.momentum = momentum
        self.axis = axis
        self.exact_statistics = exact_statistics

    def build(self, generator, input_shape, device):
        dim = input_shape[self.axis]
        self.gamma = nn.Parameter(torch.ones(dim, device=device))
        self.beta = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("moving_mean", torch.zeros(dim, device=device))
        self.register_buffer("moving_var", torch.ones(dim, device=device))
        self.built = True

    def forward(self, inputs):
        axis = self.axis % inputs.dim()
        dims = tuple(i for i in range(inputs.dim()) if i != axis)
        shape = [1] * inputs.dim()
        shape[axis] = -1
        exact = self.exact_statistics
        if not self.training:
            inv = _inv_std(self.moving_var.to(torch.float32), self.epsilon,
                           exact)
            a = self.gamma * inv
            b = self.beta - self.gamma * inv * self.moving_mean
            return _affine(inputs.to(torch.float32), a, b, shape,
                           exact).to(inputs.dtype)
        from ...parallel.mesh import default_mesh
        mesh = default_mesh()
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(SYNC_BN_TODO.format(ranks=mesh.size))
        y, mean, var = _TrainBatchNorm.apply(
            inputs, self.gamma, self.beta, self.epsilon, dims, shape, exact)
        m = self.momentum
        with torch.no_grad():
            self.moving_mean.copy_(m * self.moving_mean + (1 - m) * mean)
            self.moving_var.copy_(m * self.moving_var + (1 - m) * var)
        return y


class LayerNormalization(Layer):
    """Normalization over the last axis: f32 mean and biased variance
    ``E[x^2] - E[x]^2`` clamped at 0, then ``x * a + b`` in f32, cast back
    to the input's dtype."""

    def __init__(self, epsilon: float = 1e-5, name: Optional[str] = None):
        super().__init__(name)
        self.epsilon = epsilon

    def build(self, generator, input_shape, device):
        dim = input_shape[-1]
        self.gamma = nn.Parameter(torch.ones(dim, device=device))
        self.beta = nn.Parameter(torch.zeros(dim, device=device))
        self.built = True

    def forward(self, inputs):
        xf = inputs.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        mean_sq = xf.square().mean(-1, keepdim=True)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        inv = torch.rsqrt(var + self.epsilon)
        a = self.gamma * inv
        b = self.beta - self.gamma * inv * mean
        return (xf * a + b).to(inputs.dtype)
