"""Post-training quantization (counterpart of ``analytics_zoo_tpu/inference/
quantize.py``), on the port's modules rather than on a parameter pytree.

- bf16: every float parameter is cast to bf16 in place.
- int8, weight-only: every float parameter of two or more dimensions, in
  any module, becomes a :class:`QuantizedWeight`, an int8 buffer ``q`` with
  its f32 0-d ``scale`` (symmetric, per tensor), on the parameter's device;
  the f32 original is freed. A ``Dense`` kernel dequantizes on the fly; an
  ``Embedding`` table stays int8 on the card and its rows dequantize in the
  int8 gather kernel (``ops.embedding_kernels.gather_pool_int8``). Every
  other module that holds one (Wide&Deep's wide table, ``SparseEmbedding``,
  the attention layers, BERT, the LM, any ``nn.Module``) reads it as ``q *
  scale`` in f32 each time its code reads the attribute, as the JAX package
  dequantizes the whole tree before each forward.
- int8, calibrated: :func:`observe_activation_scales` records each
  ``Dense`` and ``Convolution2D`` layer's input range over calibration
  batches; only those layers' kernels are quantized, each carrying its f32
  ``act_scale``, and the layer then snaps its input to the int8 grid and
  multiplies (or convolves) int8 by int8 with int32 accumulation
  (:func:`qdense_apply`, :func:`qconv_apply`).

A :class:`QuantizedWeight` is a submodule named as the parameter it
replaces, so the state dict reads ``<layer>.kernel.q``,
``<layer>.kernel.scale`` and ``<layer>.kernel.act_scale``: the JAX
package's ``{"q", "scale", "act_scale"}`` leaves as
``convert.from_jax_params`` flattens them. The arithmetic is the JAX
package's: scales are f32 (``max(max|t|, 1e-8) / 127``), values quantize by
an f32 division rounded half to even, and an activation scale is rounded to
f32 from the double it is computed in.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class QuantizedWeight(nn.Module):
    """An int8 weight: buffers ``q`` (int8, the weight's shape), ``scale``
    (f32, 0-d) and, for a calibrated ``Dense`` kernel, ``act_scale`` (f32,
    0-d). Forward only: int8 tensors take no gradient."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 act_scale: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("act_scale", act_scale)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``float(q) * scale``, cast to ``dtype``."""
        return (self.q.to(torch.float32) * self.scale).to(dtype)


def _is_qleaf(x) -> bool:
    return isinstance(x, QuantizedWeight)


def _qleaf(t: torch.Tensor,
           act_scale: Optional[float] = None) -> QuantizedWeight:
    from ..ops.int8_dataflow import per_127, quant_int8
    t = t.detach()
    scale = per_127(torch.clamp(t.abs().max(), min=1e-8))
    q = quant_int8(t, scale)
    act = None if act_scale is None else torch.tensor(
        act_scale, dtype=torch.float32, device=t.device)
    return QuantizedWeight(q, scale.to(torch.float32), act)


def _replace(module: nn.Module, name: str, qw: QuantizedWeight) -> None:
    """Put ``qw`` where parameter ``name`` was; the parameter is dropped."""
    del module._parameters[name]
    setattr(module, name, qw)


def _float_params(model: nn.Module, min_dim: int = 0):
    """``(module, name, parameter)`` for every float parameter of at least
    ``min_dim`` dimensions, each module once."""
    return [(m, name, p) for m in model.modules()
            for name, p in m._parameters.items()
            if p is not None and p.is_floating_point() and p.dim() >= min_dim]


def _consumes_int8(module: nn.Module, name: str) -> bool:
    """Whether ``module`` runs with its parameter ``name`` int8."""
    from ..keras.layers.conv import Convolution2D
    from ..keras.layers.core import Dense
    from ..keras.layers.embedding import Embedding
    return ((isinstance(module, (Dense, Convolution2D)) and name == "kernel")
            or (type(module) is Embedding and name == "embeddings"))


def _dequantizing_getattr(self, name: str):
    value = nn.Module.__getattr__(self, name)
    if isinstance(value, QuantizedWeight):
        return value.dequantize()
    return value


#: module class -> its subclass that dequantizes on read
_DEQUANTIZING: Dict[type, type] = {}


def _dequantize_on_read(module: nn.Module) -> None:
    """Make ``module`` read each :class:`QuantizedWeight` attribute as its f32
    ``q * scale``: its class becomes a subclass (same name, ``isinstance``
    unchanged) whose ``__getattr__`` dequantizes, wherever the read is (the
    LM's blocks read their children's kernels, and its training and
    generation call no ``forward``, so forward hooks would miss them). The
    state dict still holds ``q`` and ``scale``; the module itself no longer
    pickles (``torch.save(model)``): save its ``state_dict``, as
    ``save_model`` does, the way ``torch.nn.utils.parametrize`` asks of the
    modules it swaps the class of."""
    cls = type(module)
    if cls in _DEQUANTIZING.values():
        return
    sub = _DEQUANTIZING.get(cls)
    if sub is None:
        sub = type(cls.__name__, (cls,),
                   {"__getattr__": _dequantizing_getattr,
                    "__module__": cls.__module__,
                    "__qualname__": cls.__qualname__})
        _DEQUANTIZING[cls] = sub
    module.__class__ = sub


def quantize_params(model: nn.Module, dtype: str = "bf16",
                    act_scales: Optional[Dict[str, float]] = None
                    ) -> nn.Module:
    """Quantize ``model``'s parameters in place; returns ``model``.

    ``bf16`` casts every float parameter. ``int8`` replaces every float
    parameter of two or more dimensions by a :class:`QuantizedWeight`
    (biases and scalars stay f32): ``Dense`` and ``Convolution2D`` kernels
    and ``Embedding`` tables run int8, and every other module holding one
    reads it dequantized (:func:`_dequantize_on_read`). With
    ``act_scales`` (``{layer name: activation scale}`` from
    :func:`observe_activation_scales`) only the kernels of those ``Dense``
    and ``Convolution2D`` layers are quantized, each carrying its
    ``act_scale``; every other parameter stays f32."""
    if dtype in ("bf16", "bfloat16"):
        for m, name, p in _float_params(model):
            m._parameters[name] = nn.Parameter(
                p.detach().to(torch.bfloat16), requires_grad=p.requires_grad)
        return model
    if dtype != "int8":
        raise ValueError(f"unsupported quantization dtype {dtype}")
    if act_scales is None:
        for m, name, p in _float_params(model, min_dim=2):
            _replace(m, name, _qleaf(p))
            if not _consumes_int8(m, name):
                _dequantize_on_read(m)
        return model
    for m in _quantizable_layers(model):
        p = m._parameters.get("kernel")
        if (p is not None and m.name in act_scales and p.is_floating_point()
                and p.dim() >= 2):
            _replace(m, "kernel", _qleaf(p, act_scales[m.name]))
    return model


def dequantize_params(model: nn.Module,
                      dtype: torch.dtype = torch.float32) -> nn.Module:
    """Inverse of :func:`quantize_params`, in place: every
    :class:`QuantizedWeight` becomes a parameter ``float(q) * scale`` and
    every float parameter is cast to ``dtype``; returns ``model``."""
    for m in list(model.modules()):
        for name, child in list(m._modules.items()):
            if _is_qleaf(child):
                setattr(m, name, nn.Parameter(child.dequantize(dtype)))
        if type(m) in _DEQUANTIZING.values():
            m.__class__ = type(m).__bases__[0]
    for m, name, p in _float_params(model):
        if p.dtype != dtype:
            m._parameters[name] = nn.Parameter(
                p.detach().to(dtype), requires_grad=p.requires_grad)
    return model


# -- calibration: activation observers ----------------------------------------


def _quantizable_layers(model: nn.Module) -> List[nn.Module]:
    """The ``Dense`` and ``Convolution2D`` layers reachable through
    ``model``'s ``Sequential`` and functional ``Model`` containers (the
    layers with a static-int8 path)."""
    from ..keras.engine import Model, Sequential
    from ..keras.layers.conv import Convolution2D
    from ..keras.layers.core import Dense
    out: List[nn.Module] = []

    def walk(m):
        if isinstance(m, Sequential):
            for layer in m.layers:
                walk(layer)
        elif isinstance(m, Model):
            seen = set()
            for node in m._nodes:
                if id(node.layer) not in seen:
                    seen.add(id(node.layer))
                    walk(node.layer)
        elif isinstance(m, (Dense, Convolution2D)):
            out.append(m)

    walk(model)
    return out


def observe_activation_scales(model: nn.Module, batches: Iterable,
                              percentile: float = 99.9) -> Dict[str, float]:
    """Run calibration ``batches`` through ``model`` in inference mode,
    recording each ``Dense`` and ``Convolution2D`` layer's input magnitude
    (``percentile`` of
    ``|x|`` by ``np.percentile``, or the max at 100); returns ``{layer
    name: max(range, 1e-8) / 127}`` for :func:`quantize_params`. A batch is
    an array, or a tuple whose first item is the input. The observers are
    forward pre-hooks, always removed."""
    layers = _quantizable_layers(model)
    stats: Dict[str, float] = {}
    device = next(iter(model.parameters())).device
    handles = []

    def observer(name):
        def hook(_module, args):
            a = np.abs(args[0].detach().to(torch.float32).cpu().numpy())
            v = (float(a.max()) if percentile >= 100
                 else float(np.percentile(a, percentile)))
            stats[name] = max(stats.get(name, 0.0), v)
        return hook

    was_training = model.training
    try:
        for layer in layers:
            handles.append(layer.register_forward_pre_hook(
                observer(layer.name)))
        model.eval()
        with torch.inference_mode():
            for batch in batches:
                x = batch[0] if isinstance(batch, tuple) else batch
                x = np.asarray(x)
                if x.dtype == np.float64:  # as the JAX package's x64-off
                    x = x.astype(np.float32)
                model(torch.from_numpy(np.ascontiguousarray(x)).to(device))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return {name: max(v, 1e-8) / 127.0 for name, v in stats.items()}


# -- static-int8 execution (called by Dense and Convolution2D) ----------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for int8 ``a`` ``[..., K]`` and ``b`` ``[K, N]``, summed
    exactly in int32 by ``torch._int_mm``. On the card that call wants more
    than 16 rows and K and N multiples of 8, so the operands are padded
    with zeros to those sizes (a multiple of 8 rows too; exact) and the
    result cut back; and cuBLASLt's int8 product takes ``b`` column-major
    only (it refuses both operands row-major), so ``b`` is laid out so."""
    lead, k = tuple(a.shape[:-1]), a.shape[-1]
    n = b.shape[1]
    a2 = a.reshape(-1, k)
    m = a2.shape[0]
    mp, kp, np_ = _round_up(max(m, 17), 8), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a2 = F.pad(a2, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    y = torch._int_mm(a2.contiguous(), b.t().contiguous().t())
    return y[:m, :n].reshape(lead + (n,))


def qdense_apply(inputs: torch.Tensor,
                 qkernel: QuantizedWeight) -> torch.Tensor:
    """``inputs @ kernel`` against an int8 kernel. With a calibrated
    ``act_scale`` the inputs snap to the int8 grid, the product runs int8 by
    int8 in int32, and the result scales by the f32 ``act_scale * scale``;
    without, the kernel dequantizes on the fly in the inputs' dtype."""
    s_w, s_a = qkernel.scale, qkernel.act_scale
    if s_a is None:
        return inputs @ (qkernel.q.to(inputs.dtype) * s_w.to(inputs.dtype))
    from ..ops.int8_dataflow import quant_int8
    y = int8_matmul(quant_int8(inputs.to(torch.float32), s_a), qkernel.q)
    return y.to(torch.float32) * (s_a * s_w)


def qconv_apply(inputs: torch.Tensor, qkernel: QuantizedWeight, strides,
                padding, dilation, groups: int) -> torch.Tensor:
    """The convolution of NHWC ``inputs`` with an int8 HWIO kernel. With a
    calibrated ``act_scale`` the inputs snap to the int8 grid (an f32
    division rounded half to even), the convolution runs int8 by int8 in
    int32 (``ops.int8_dataflow.int8_conv2d``: on the card ``torch._int_mm``
    over patches, never a float convolution) and the result scales by the
    f32 ``act_scale * scale``; without, the kernel dequantizes in the
    inputs' dtype and the float convolution runs."""
    from ..keras.layers.conv import conv2d_nhwc
    from ..ops.int8_dataflow import int8_conv2d, quant_int8
    s_w, s_a = qkernel.scale, qkernel.act_scale
    if s_a is None:
        dt = inputs.dtype
        return conv2d_nhwc(inputs, qkernel.q.to(dt) * s_w.to(dt), strides,
                           padding, dilation, groups)
    y = int8_conv2d(quant_int8(inputs.to(torch.float32), s_a), qkernel.q,
                    strides, padding, dilation, groups)
    return y.to(torch.float32) * (s_a * s_w)
