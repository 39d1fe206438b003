"""The int8-dataflow ResNet backbone and its building blocks (counterpart of
``analytics_zoo_tpu/ops/int8_dataflow.py``): int8 tensors between layers.

- Every activation between layers is an ``int8`` tensor with a delayed
  scale (last step's running amax, the FP8 "delayed scaling" recipe): no
  max pass over the tensor before it is quantized.
- A convolution takes int8 activations and per-output-channel int8 weights
  and sums in int32 (:func:`int8_conv2d`), exactly. Its f32 result gives
  the batch-norm statistics and the amax and is quantized to int8 at once;
  batch norm and the ReLU read that int8 pre-activation and write the int8
  output.
- A residual add dequantizes both sides, adds, applies the ReLU and
  requantizes.

Int8 tensors take no gradient, so the whole backbone is one
``torch.autograd.Function`` whose backward walks a tape of the forward's
int8 tensors in reverse: the straight-through estimator through every
quantizer, batch norm's backward in closed form, and the convolutions'
input and weight gradients in bf16 against the dequantized input
(``aten.convolution_backward``, cuDNN on the card) without evaluating the
forward again. Gradients are bf16; the f32 masters are the optimizer's.

The convolution on the card: PyTorch's CUDA convolution takes no int8, so
:func:`int8_conv2d` cuts the patches from the NHWC tensor with
``Tensor.unfold`` views (``F.unfold`` refuses int8), copies them once into
a ``[rows, kh * kw * cin]`` matrix and multiplies it by the HWIO kernel
through ``inference.quantize.int8_matmul`` (``torch._int_mm``, cuBLASLt's
int8 GEMM, int32 sums): one product per group. A 1x1 convolution at stride
1 is a reshape with no copy. The CPU runs the same code, so the card's
int32 sums equal the CPU's bit for bit. Max pooling of int8 codes goes
through an f32 copy of the codes (exact: every int8 value is an f32).

The quantizer's arithmetic is the JAX package's, op for op: ``f / scale``
and ``amax / 127`` are f32 divisions (not multiplies by the reciprocal,
which round differently; :func:`per_127`), ``torch.round`` rounds half to
even as ``jnp.round`` does, and the running amax decays by the f32 product
``0.99 * running``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

#: fast-rise / slow-decay running amax
AMAX_DECAY = 0.99
_EPS = 1e-5
#: the profiler range of :func:`int8_conv2d`'s padding and patch copies
PATCH_RANGE = "int8_conv2d.patches"


def quant_int8(f: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with a delayed scale (scalar, or per channel along the
    last axis): ``clip(round(f / scale), -127, 127)``."""
    return torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)


def dequant_int8(q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``float(q) * scale`` in f32, cast to ``dtype`` (bf16 by default, as
    in the JAX package)."""
    return (q.to(torch.float32) * scale).to(dtype)


def next_amax(running: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """The running amax after seeing ``seen``: rises at once, decays by
    :data:`AMAX_DECAY` a step."""
    return torch.maximum(AMAX_DECAY * running, seen)


def per_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127``, an f32 division correctly rounded on both devices, as
    the JAX package's: with a Python number for a divisor, PyTorch's CUDA
    kernel multiplies by its reciprocal instead, which rounds differently
    (an int8 scale one unit in the last place off the CPU's)."""
    return t / torch.full_like(t, 127.0)


def scale_of_amax(running_amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-6) / 127``."""
    return per_127(torch.clamp(running_amax, min=1e-6))


def _rsqrt(t: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(t)``, correctly rounded on both devices (CUDA's ``rsqrt``
    is not), so that the card's batch norm scales are the CPU's."""
    return 1.0 / torch.sqrt(t)


def _amax(f: torch.Tensor, per_channel: bool) -> torch.Tensor:
    a = f.to(torch.float32).abs()
    return a.amax(dim=(0, 1, 2)) if per_channel else a.max()


def _quantize_weight_pc(w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO kernel -> per-O-channel symmetric int8 and its f32 scales,
    computed each step from the float master."""
    wf = w.to(torch.float32)
    s = per_127(torch.clamp(wf.abs().amax(dim=(0, 1, 2)), min=1e-12))
    return quant_int8(wf, s), s


# -- the int8 convolution -----------------------------------------------------


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor,
                strides: Sequence[int] = (1, 1), padding="VALID",
                dilation: Sequence[int] = (1, 1),
                groups: int = 1) -> torch.Tensor:
    """The convolution of int8 NHWC activations ``xq`` ``[n, h, w, cin]``
    with an int8 HWIO kernel ``wq`` ``[kh, kw, cin / groups, cout]``, summed
    exactly in int32: ``[n, oh, ow, cout]``. ``padding`` is ``"SAME"``,
    ``"VALID"`` or ``((lo, hi), (lo, hi))``, as XLA pads (SAME pads one
    more after than before where the total is odd), with zeros. The same
    code runs on both devices; a CUDA tensor never takes a float
    convolution. The padding and the patch copies run inside the profiler
    range :data:`PATCH_RANGE`, so a trace tells their time apart."""
    from ..inference.quantize import int8_matmul
    from ..keras.layers.conv import _pads
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 operands, got {xq.dtype} "
                        f"and {wq.dtype}")
    n, h, w, cin = xq.shape
    kh, kw, cg, cout = wq.shape
    if cg * groups != cin or cout % groups:
        raise ValueError(f"kernel {tuple(wq.shape)} does not fit {cin} "
                         f"input channels in {groups} groups")
    (hlo, hhi), (wlo, whi) = _pads((h, w), (kh, kw), strides, padding,
                                   dilation)
    sh, sw = strides
    dh, dw = dilation
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    oh = (h + hlo + hhi - ekh) // sh + 1
    ow = (w + wlo + whi - ekw) // sw + 1
    with torch.profiler.record_function(PATCH_RANGE):
        if hlo or hhi or wlo or whi:
            xq = F.pad(xq, (0, 0, wlo, whi, hlo, hhi))
        if (kh, kw, sh, sw) == (1, 1, 1, 1):
            patches = xq.reshape(n, oh, ow, 1, 1, cin)
        else:
            # [n, oh, ow, cin, ekh, ekw] views, then the kernel's taps
            patches = xq.unfold(1, ekh, sh).unfold(2, ekw, sw)[
                ..., ::dh, ::dw].permute(0, 1, 2, 4, 5, 3)
        cols = [patches[..., g * cg:(g + 1) * cg].reshape(n * oh * ow,
                                                          kh * kw * cg)
                for g in range(groups)]
    cog = cout // groups
    outs = [int8_matmul(a, wq[..., g * cog:(g + 1) * cog].reshape(
        kh * kw * cg, cog)) for g, a in enumerate(cols)]
    y = outs[0] if groups == 1 else torch.cat(outs, dim=-1)
    return y.reshape(n, oh, ow, cout)


def conv_transposes(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    strides: Sequence[int], padding,
                    dilation: Sequence[int] = (1, 1), groups: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The input and weight gradients of ``y = conv(x, w)`` (NHWC ``x``,
    HWIO ``w``, XLA's padding) for ``y``'s cotangent ``g``, in the
    operands' dtype, without evaluating ``y``: one
    ``aten.convolution_backward`` (cuDNN's dgrad and wgrad on the card) on
    the NCHW views of the channels-last tensors, the pads' asymmetric
    excess (SAME's one more after) added to ``x`` and cut from its
    gradient."""
    from ..keras.layers.conv import _pads, _split_pads
    xc = x.permute(0, 3, 1, 2)
    kh, kw = w.shape[:2]
    pads = _pads(xc.shape[2:], (kh, kw), strides, padding, dilation)
    xp, sym = _split_pads(pads, 0.0, xc)
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), xp, wt, None, list(strides), list(sym),
        list(dilation), False, [0, 0], groups, [True, True, False])
    (h0, _), (w0, _) = [(lo - m, hi) for (lo, hi), m in zip(pads, sym)]
    dx = dx[:, :, h0:h0 + xc.shape[2], w0:w0 + xc.shape[3]]
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)


def _max_pool(x: torch.Tensor, window, strides, padding) -> torch.Tensor:
    """Float max pooling of NHWC ``x`` with XLA's padding (-inf pads)."""
    from ..keras.layers.conv import _pool
    return _pool(x.permute(0, 3, 1, 2), window, strides, padding,
                 "max").permute(0, 2, 3, 1)


# -- per-op forward and backward (the tape's entries) -------------------------
# A forward returns its outputs and its residuals; a backward takes the
# residuals and the bf16 cotangent of the op's dequantized output (the
# straight-through estimator through the output's quantizer) and returns the
# cotangent of its dequantized input and the parameters' gradients.


def _conv_bn_fwd(xq, sx, w, gamma, beta, s_mid_run, relu: bool, strides,
                 padding):
    """conv (int8) -> the batch statistics and the int8 pre-activation ->
    batch norm and the ReLU. Returns ``(y, aux, residuals)``, ``y`` the f32
    output before its quantizer."""
    wq, sw = _quantize_weight_pc(w)
    acc = int8_conv2d(xq, wq, strides, padding)
    f = acc.to(torch.float32) * (sx * sw)  # the conv's output, per channel
    mean = f.mean(dim=(0, 1, 2))
    var = torch.clamp((f * f).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
    amax_mid = _amax(f, per_channel=True)
    s_mid = scale_of_amax(s_mid_run)  # delayed: last step's running amax
    q_mid = quant_int8(f, s_mid)
    inv = _rsqrt(var + _EPS)
    fh = q_mid.to(torch.float32) * s_mid
    z = (fh - mean) * inv * gamma + beta
    y = torch.clamp(z, min=0.0) if relu else z
    amax_out = y.abs().max()
    residuals = (xq, sx, w, gamma, q_mid, s_mid, mean, inv)
    return y, (amax_mid, amax_out, mean, var), residuals


def _conv_bn_bwd(residuals, relu: bool, strides, padding, yq, dy):
    """Batch norm's backward in closed form, then the convolution's input
    and weight gradients in bf16. ``dy`` is the bf16 cotangent of the
    dequantized output; the ReLU's mask is the saved int8 output ``yq``."""
    xq, sx, w, gamma, q_mid, s_mid, mean, inv = residuals
    dz = dy.to(torch.float32)
    if relu:
        dz = dz * (yq > 0)
    fh = q_mid.to(torch.float32) * s_mid
    xhat = (fh - mean) * inv
    dgamma = (dz * xhat).sum(dim=(0, 1, 2))
    dbeta = dz.sum(dim=(0, 1, 2))
    dxhat = dz * gamma
    df = inv * (dxhat - dxhat.mean(dim=(0, 1, 2))
                - xhat * (dxhat * xhat).mean(dim=(0, 1, 2)))
    x_deq = dequant_int8(xq, sx)
    dx, dw = conv_transposes(x_deq, w.to(torch.bfloat16),
                             df.to(torch.bfloat16), strides, padding)
    return (dx, dw.to(w.dtype), dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype))


def _add_relu_fwd(aq, sa, bq, sb):
    y = torch.clamp(aq.to(torch.float32) * sa + bq.to(torch.float32) * sb,
                    min=0.0)
    return y, y.abs().max()


def _maxpool_q(q: torch.Tensor, window, strides, padding) -> torch.Tensor:
    """Max pooling of int8 codes: max commutes with the positive-scale
    dequantize, so pooling the codes equals pooling the values. Through an
    f32 copy of the codes (exact)."""
    return _max_pool(q.to(torch.float32), window, strides,
                     padding).to(torch.int8)


def _maxpool_bwd(q, s, window, strides, padding, dy) -> torch.Tensor:
    """The float max pool's gradient on the dequantized input (each window's
    first largest value takes its gradient), as bf16."""
    with torch.enable_grad():
        x = dequant_int8(q, s, torch.float32).requires_grad_()
        y = _max_pool(x, window, strides, padding)
        (dx,) = torch.autograd.grad(y, x, dy.to(torch.float32))
    return dx.to(torch.bfloat16)


# -- the backbone -------------------------------------------------------------


class _ConvSpec:
    def __init__(self, name, k, cin, cout, stride, relu):
        self.name, self.k = name, k
        self.cin, self.cout = cin, cout
        self.stride, self.relu = stride, relu
        self.strides = (stride, stride)
        self.padding = "SAME"


def _resnet_plan(depth: int, in_channels: int = 3):
    """The static plan the tape walker follows: ``("conv", spec)``,
    ``("pool",)`` and ``("block", convs, shortcut or None)`` entries.
    Returns ``(plan, out_channels)``."""
    from ..models.image.imageclassification import RESNET_BLOCKS
    if depth not in RESNET_BLOCKS:
        raise ValueError(f"unsupported depth {depth}")
    blocks = RESNET_BLOCKS[depth]
    bottleneck = depth >= 50
    plan: List[Tuple] = [("conv", _ConvSpec("stem", 7, in_channels, 64, 2,
                                            True)),
                         ("pool",)]
    c_in = 64
    filters = 64
    for stage, nblocks in enumerate(blocks):
        for i in range(nblocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            nm = f"s{stage + 1}b{i + 1}"
            if bottleneck:
                convs = [_ConvSpec(f"{nm}_a", 1, c_in, filters, 1, True),
                         _ConvSpec(f"{nm}_b", 3, filters, filters, stride,
                                   True),
                         _ConvSpec(f"{nm}_c", 1, filters, filters * 4, 1,
                                   False)]
                c_out = filters * 4
            else:
                convs = [_ConvSpec(f"{nm}_a", 3, c_in, filters, stride,
                                   True),
                         _ConvSpec(f"{nm}_b", 3, filters, filters, 1,
                                   False)]
                c_out = filters
            short = (None if stride == 1 and c_in == c_out else
                     _ConvSpec(f"{nm}_sc", 1, c_in, c_out, stride, False))
            plan.append(("block", convs, short))
            c_in = c_out
        filters *= 2
    return plan, c_in


def _iter_convs(plan):
    for entry in plan:
        if entry[0] == "conv":
            yield entry[1]
        elif entry[0] == "block":
            yield from entry[1]
            if entry[2] is not None:
                yield entry[2]


def _block_name(convs) -> str:
    return convs[0].name.rsplit("_", 1)[0]


class _TrainFn(torch.autograd.Function):
    """The training forward of the whole backbone; its backward walks the
    int8 tape in reverse. ``updates`` (a dict) receives the state the step
    moves to; ``leaves`` are each conv's kernel, gamma and beta in plan
    order."""

    @staticmethod
    def forward(ctx, flow, state, updates, x, *leaves):
        params = flow._unflatten(leaves)
        tape: List[Tuple] = []
        feats, upd = flow._forward(params, state, x, True, tape)
        updates.update(upd)
        ctx.flow, ctx.tape, ctx.params = flow, tape, params
        return feats

    @staticmethod
    def backward(ctx, g):
        dx, dparams = ctx.flow._backward(ctx.tape, ctx.params, g)
        ctx.tape = None
        flat = []
        for spec in _iter_convs(ctx.flow.plan):
            d = dparams[spec.name]
            flat += [d["kernel"], d["gamma"], d["beta"]]
        return (None, None, None, dx, *flat)


class Int8ResNetDataflow:
    """Functional int8-dataflow ResNet backbone.

    :meth:`init` gives ``(params, state)`` dicts of tensors; :meth:`apply`
    ``(params, state, x, training)`` gives ``(features, new_state)``,
    features bf16 ``[n, h', w', c']``. Scales live in ``state`` as running
    amaxes (delayed scaling), beside the batch norms' running statistics
    for eval."""

    def __init__(self, depth: int = 50,
                 input_shape: Tuple[int, int, int] = (224, 224, 3)):
        self.depth = depth
        self.input_shape = tuple(input_shape)
        self.plan, self.out_channels = _resnet_plan(depth, input_shape[-1])

    # -- params and state ----------------------------------------------------

    def init(self, generator: torch.Generator, device=None):
        """Seeded He-normal kernels, unit gammas, zero betas; running amaxes
        at 4 (the input) and 8, statistics at 0 and 1."""
        params: Dict[str, Any] = {}
        state: Dict[str, Any] = {"in_amax": torch.tensor(4.0, device=device)}
        for spec in _iter_convs(self.plan):
            fan_in = spec.k * spec.k * spec.cin
            shape = (spec.k, spec.k, spec.cin, spec.cout)
            params[spec.name] = {
                "kernel": (torch.randn(shape, generator=generator)
                           * math.sqrt(2.0 / fan_in)).to(device),
                "gamma": torch.ones(spec.cout, device=device),
                "beta": torch.zeros(spec.cout, device=device),
            }
            state[spec.name] = {
                "mid_amax": torch.full((spec.cout,), 8.0, device=device),
                "out_amax": torch.tensor(8.0, device=device),
                "running_mean": torch.zeros(spec.cout, device=device),
                "running_var": torch.ones(spec.cout, device=device),
            }
        for entry in self.plan:
            if entry[0] == "block":
                state[f"{_block_name(entry[1])}_add"] = {
                    "out_amax": torch.tensor(8.0, device=device)}
        return params, state

    def _unflatten(self, leaves) -> Dict[str, Any]:
        it = iter(leaves)
        return {spec.name: {"kernel": next(it), "gamma": next(it),
                            "beta": next(it)}
                for spec in _iter_convs(self.plan)}

    # -- the forward, shared by training and eval ----------------------------

    def _run_conv(self, params, state_in, updates, spec, xq, sx, tape,
                  training: bool):
        """``state_in`` is the state before the step (delayed scaling: this
        step quantizes with the last step's running amaxes)."""
        p = params[spec.name]
        st = state_in[spec.name]
        if training:
            y, aux, res = _conv_bn_fwd(
                xq, sx, p["kernel"], p["gamma"], p["beta"], st["mid_amax"],
                spec.relu, spec.strides, spec.padding)
            amax_mid, amax_out, mean, var = aux
            s_out = scale_of_amax(st["out_amax"])
            yq = quant_int8(y, s_out)
            if tape is not None:
                tape.append((res, yq, s_out))
            updates[spec.name] = {
                "mid_amax": next_amax(st["mid_amax"], amax_mid),
                "out_amax": next_amax(st["out_amax"], amax_out),
                "running_mean": 0.9 * st["running_mean"] + 0.1 * mean,
                "running_var": 0.9 * st["running_var"] + 0.1 * var,
            }
            return yq, s_out
        # eval: the running statistics, the same int8 flow
        wq, sw = _quantize_weight_pc(p["kernel"])
        acc = int8_conv2d(xq, wq, spec.strides, spec.padding)
        f = acc.to(torch.float32) * (sx * sw)
        inv = _rsqrt(st["running_var"] + _EPS)
        z = (f - st["running_mean"]) * inv * p["gamma"] + p["beta"]
        y = torch.clamp(z, min=0.0) if spec.relu else z
        s_out = scale_of_amax(st["out_amax"])
        return quant_int8(y, s_out), s_out

    def _forward(self, params, state, x, training: bool,
                 tape: Optional[list]):
        """The int8 walk: ``(features, state updates)``."""
        updates: Dict[str, Any] = {}
        s_in = scale_of_amax(state["in_amax"])
        if training:
            updates["in_amax"] = next_amax(state["in_amax"], x.abs().max())
        xq = quant_int8(x.to(torch.float32), s_in)
        if tape is not None:
            tape.append((x.dtype,))
        sx = s_in
        for entry in self.plan:
            if entry[0] == "conv":
                xq, sx = self._run_conv(params, state, updates, entry[1],
                                        xq, sx, tape, training)
            elif entry[0] == "pool":
                if tape is not None:
                    tape.append((xq, sx))
                xq = _maxpool_q(xq, (3, 3), (2, 2), "SAME")
            else:  # a residual block
                _, convs, short = entry
                nm = _block_name(convs)
                yq, sy = xq, sx
                for spec in convs:
                    yq, sy = self._run_conv(params, state, updates, spec,
                                            yq, sy, tape, training)
                if short is not None:
                    scq, scs = self._run_conv(params, state, updates, short,
                                              xq, sx, tape, training)
                else:
                    scq, scs = xq, sx
                add_st = state[f"{nm}_add"]
                y, amax = _add_relu_fwd(yq, sy, scq, scs)
                s_out = scale_of_amax(add_st["out_amax"])
                out_q = quant_int8(y, s_out)
                if training:
                    updates[f"{nm}_add"] = {
                        "out_amax": next_amax(add_st["out_amax"], amax)}
                if tape is not None:
                    tape.append((out_q,))
                xq, sx = out_q, s_out
        return dequant_int8(xq, sx), updates

    # -- the backward over the tape ------------------------------------------

    def _backward(self, tape, params, g):
        """``(dx, {conv: {"kernel", "gamma", "beta"}})`` from the features'
        cotangent ``g``."""
        dparams: Dict[str, Any] = {}
        pos = [len(tape) - 1]

        def take():
            e = tape[pos[0]]
            pos[0] -= 1
            return e

        def conv_back(spec, dy):
            res, yq, _s_out = take()
            dx, dw, dgam, dbet = _conv_bn_bwd(
                res, spec.relu, spec.strides, spec.padding, yq, dy)
            dparams[spec.name] = {"kernel": dw, "gamma": dgam, "beta": dbet}
            return dx

        dy = g.to(torch.bfloat16)
        for entry in reversed(self.plan):
            if entry[0] == "conv":
                dy = conv_back(entry[1], dy)
            elif entry[0] == "pool":
                q, s = take()
                dy = _maxpool_bwd(q, s, (3, 3), (2, 2), "SAME", dy)
            else:
                _, convs, short = entry
                (out_q,) = take()
                d_branch = (dy.to(torch.float32) * (out_q > 0)).to(
                    torch.bfloat16)
                d_sc = (conv_back(short, d_branch) if short is not None
                        else d_branch)
                d_main = d_branch
                for spec in reversed(convs):
                    d_main = conv_back(spec, d_main)
                dy = (d_main.to(torch.float32)
                      + d_sc.to(torch.float32)).to(torch.bfloat16)
        (x_dtype,) = take()
        assert pos[0] == -1
        return dy.to(x_dtype), dparams  # STE through the input's quantizer

    # -- the float mirror (tests) ---------------------------------------------

    def apply_float(self, params, x: torch.Tensor) -> torch.Tensor:
        """The same architecture and batch-statistics arithmetic in f32
        with no quantizer, differentiable by autograd: what the straight-
        through gradients are held against."""
        from ..keras.layers.conv import conv2d_nhwc
        def conv_bn(spec, h):
            p = params[spec.name]
            f = conv2d_nhwc(h, p["kernel"], spec.strides, spec.padding)
            mean = f.mean(dim=(0, 1, 2))
            var = torch.clamp((f * f).mean(dim=(0, 1, 2)) - mean * mean,
                              min=0.0)
            z = (f - mean) * _rsqrt(var + _EPS) * p["gamma"] + p["beta"]
            return torch.clamp(z, min=0.0) if spec.relu else z

        h = x.to(torch.float32)
        for entry in self.plan:
            if entry[0] == "conv":
                h = conv_bn(entry[1], h)
            elif entry[0] == "pool":
                h = _max_pool(h, (3, 3), (2, 2), "SAME")
            else:
                _, convs, short = entry
                y = h
                for spec in convs:
                    y = conv_bn(spec, y)
                sc = conv_bn(short, h) if short is not None else h
                h = torch.clamp(y + sc, min=0.0)
        return h

    # -- public apply ---------------------------------------------------------

    def apply(self, params, state, x: torch.Tensor, training: bool):
        """``(features, new_state)``: in training the int8 forward whose
        backward is the tape's, and the moved state; in eval the running
        statistics and the state unchanged."""
        if not training:
            feats, _ = self._forward(params, state, x, False, None)
            return feats, state
        updates: Dict[str, Any] = {}
        leaves = [params[spec.name][k] for spec in _iter_convs(self.plan)
                  for k in ("kernel", "gamma", "beta")]
        feats = _TrainFn.apply(self, state, updates, x, *leaves)
        return feats, {**state, **updates}
