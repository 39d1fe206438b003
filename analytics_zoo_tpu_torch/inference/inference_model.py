"""InferenceModel (counterpart of ``analytics_zoo_tpu/inference/
inference_model.py``): a loaded model behind ``concurrent_num`` dispatch
slots, with the JAX package's shape buckets and its chunk -> pad-with-last-
row -> trim contract.

The device is the card unless the caller passes ``device="cpu"``. A predict
moves its batch to the device, runs the forward under
``torch.inference_mode()`` and starts the copy back into pinned host memory
on the same stream; :meth:`predict_async` returns before that copy lands,
so the serving loop decodes the next batch while the card works.

:meth:`quantize` is the JAX package's: bf16, weight-only int8, or int8
calibrated on sample batches (``inference/quantize.py``).

:meth:`load_forward` is the JAX package's ``load_jax``: a raw
``forward_fn(params, x)`` with its params, here a torch callable and a dict
of tensors.

A model of several inputs (Wide&Deep's four) takes a list of arrays, as
in the JAX package, or one flat ``[n, sum of widths]`` array when every
input is ``[n, width]``: the flat array is split into the inputs in order.
``ClusterServing`` sends such a model its records that way, as one
float32 tensor each. A float carries an integer exactly only below 2 to
the power of its mantissa's bits plus one (2^24 for float32), so the
columns of an id input (``Input(..., ids=True)``) must hold whole numbers
below that: they become int64, and any other value raises ``ValueError``
rather than look up another row.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.context import DeviceLike, resolve_device
from .quantize import (QuantizedWeight, _qleaf, observe_activation_scales,
                       quantize_params)

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _flat_inputs(module) -> Optional[List[Tuple[int, bool]]]:
    """``(width, holds ids)`` of each input of a keras ``Model`` of several
    inputs that are all ``[batch, width]``, else None."""
    from ..keras.engine import Model
    if not isinstance(module, Model) or len(module.inputs) < 2:
        return None
    if any(len(s.shape) != 2 for s in module.inputs):
        return None
    return [(int(s.shape[1]), s.node.layer.ids) for s in module.inputs]


def _split_flat(flat: np.ndarray, inputs: List[Tuple[int, bool]]
                ) -> List[np.ndarray]:
    """Split a flat ``[n, sum of widths]`` array into the inputs; an id
    input's columns become int64, and must be whole numbers that the flat
    array's dtype holds exactly."""
    widths = [w for w, _ in inputs]
    parts = np.split(flat, np.cumsum(widths)[:-1], axis=1)
    out = []
    for (_, ids), a in zip(inputs, parts):
        if ids and np.issubdtype(a.dtype, np.floating):
            exact = 2.0 ** (np.finfo(a.dtype).nmant + 1)
            if a.size and not (np.all(np.abs(a) < exact)
                               and np.all(a == np.round(a))):
                raise ValueError(
                    f"an id column of the flat {a.dtype} input holds a "
                    f"value that is not a whole number below {exact:.0f}, "
                    f"which {a.dtype} carries exactly; pass the inputs as "
                    f"a list with integer ids")
            a = a.astype(np.int64)
        out.append(a)
    return out


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


class _Forward(torch.nn.Module):
    """``forward_fn(params, x)`` over a dict of tensors held on the device.
    After a weight-only int8 :meth:`InferenceModel.quantize` an entry is a
    :class:`QuantizedWeight`, handed to ``forward_fn`` as its f32
    ``q * scale``, as the JAX package's forward dequantizes the tree."""

    def __init__(self, forward_fn: Callable, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.forward_fn = forward_fn
        self.params = params

    def forward(self, x):
        return self.forward_fn(
            {k: v.dequantize() if isinstance(v, QuantizedWeight) else v
             for k, v in self.params.items()}, x)

    def quantize(self, dtype: str) -> None:
        """The JAX package's ``quantize_params`` over the dict: bf16 casts
        every float tensor; int8 keeps every float tensor of two or more
        dimensions as int8 with an f32 scale."""
        if dtype in ("bf16", "bfloat16"):
            self.params = {k: v.to(torch.bfloat16) if v.is_floating_point()
                           else v for k, v in self.params.items()}
        elif dtype == "int8":
            self.params = {k: _qleaf(v) if v.is_floating_point()
                           and v.dim() >= 2 else v
                           for k, v in self.params.items()}
        else:
            raise ValueError(f"unsupported quantization dtype {dtype}")


class InferenceModel:
    def __init__(self, concurrent_num: int = 1, device: DeviceLike = None):
        if concurrent_num < 1:
            raise ValueError("concurrent_num must be >= 1")
        self.device = resolve_device(device)
        self.concurrent_num = concurrent_num
        self._slots = threading.Semaphore(concurrent_num)
        self._module: Optional[torch.nn.Module] = None
        #: bf16 models hand back f32 outputs, as the JAX package's
        self._output_f32 = False
        #: {Dense layer name: activation scale} after calibrated int8
        self._act_scales: Optional[Dict[str, float]] = None
        #: a multi-input model's (width, holds ids) per input: a flat
        #: array splits by them
        self._flat_inputs: Optional[List[Tuple[int, bool]]] = None

    # -- loaders --------------------------------------------------------------

    def load_zoo(self, path: str) -> "InferenceModel":
        """Load a saved ``ZooModel`` directory onto this model's device."""
        from ..models.common import ZooModel
        self._set_module(ZooModel.load_model(path, device=self.device).model)
        return self

    def load_keras(self, model, state_dict=None) -> "InferenceModel":
        """Wrap an in-memory built keras ``Model``; ``state_dict`` (e.g.
        from ``convert.from_jax_params``) replaces its weights first."""
        if not model.built:
            raise RuntimeError("build the model (or pass it loaded) first")
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self._set_module(model.to(self.device).eval())
        return self

    def load_forward(self, forward_fn: Callable,
                     params: Dict[str, torch.Tensor]) -> "InferenceModel":
        """A raw ``forward_fn(params, x)`` and its ``params``, a dict of
        tensors moved once to this model's device (the JAX package's
        ``load_jax``). ``predict`` calls ``forward_fn`` under
        ``torch.inference_mode()`` with the device's params and the padded
        batch; buckets, ``prewarm`` and ``concurrent_num`` are
        :meth:`load_keras`'s. A bf16 output comes back f32 (the same
        values).

        BERT served from token rows, as ``bench.py`` serves it: the
        records are ``[seq]`` float32 rows, which carry an id exactly below
        2^24 (vocab 30522 is far below), and the four-array input is built
        on the device::

            clf = BERTClassifier(2, bert_config=cfg)
            clf.build(seq, device=dev)
            im = InferenceModel(device=dev).load_forward(
                bert_serving_forward(clf.model),
                from_jax_params(jax_params))

        (``capture.bert_serving_forward``: ``torch.func.functional_call``
        of the model with ``params``.)

        :meth:`quantize` follows the JAX package's opaque forward: ``bf16``
        casts the float params and the output comes back f32; ``int8``
        keeps the params of two or more dimensions int8 and hands
        ``forward_fn`` their f32 ``q * scale``; ``int8`` with
        ``calibration_data`` raises ``ValueError``."""
        params = {k: torch.as_tensor(v).to(self.device)
                  for k, v in params.items()}
        self._set_module(_Forward(forward_fn, params))
        return self

    def _set_module(self, module: torch.nn.Module) -> None:
        self._module = module
        self._output_f32 = False
        self._act_scales = None
        self._flat_inputs = _flat_inputs(module)

    # -- quantization ---------------------------------------------------------

    def quantize(self, dtype: str = "bf16", calibration_data=None,
                 percentile: float = 99.9) -> "InferenceModel":
        """Quantize the loaded model in place; returns ``self``. ``bf16``
        casts the float weights (outputs come back f32); ``int8`` without
        ``calibration_data`` is weight-only: every weight of two or more
        dimensions, in any layer, is kept int8 with an f32 scale (``Dense``
        dequantizes it on the fly, ``Embedding`` gathers it through the int8
        kernel, and every other layer reads it dequantized to f32).
        ``int8`` with ``calibration_data`` (an iterable of input batches)
        observes each ``Dense`` layer's input range over the batches, then
        quantizes only those kernels, which then run int8 by int8."""
        from ..keras.engine import Model, Sequential
        if self._module is None:
            raise RuntimeError("load a model first")
        if dtype == "int8" and calibration_data is not None:
            if not isinstance(self._module, (Model, Sequential)):
                raise ValueError(
                    "calibrated int8 needs a keras-graph model "
                    "(load_keras/load_zoo); weight-only int8 works for "
                    "opaque forwards — call quantize('int8') without "
                    "calibration_data")
            act_scales = observe_activation_scales(
                self._module, calibration_data, percentile=percentile)
            quantize_params(self._module, "int8", act_scales=act_scales)
            self._act_scales = act_scales
            return self
        if isinstance(self._module, _Forward):
            self._module.quantize(dtype)
        else:
            quantize_params(self._module, dtype)
        self._output_f32 = dtype != "int8"
        return self

    # -- warm-up --------------------------------------------------------------

    def prewarm(self, example,
                buckets: Optional[Sequence[int]] = None) -> "InferenceModel":
        """Run each expected bucket once before traffic arrives, so no
        request pays the kernel library's build or load, or the card's
        first-use initialisation. ``example`` (one batch) fixes the dtype
        and feature shape; ``buckets`` are request sizes (default: the
        example's own), each resolved as :meth:`predict` resolves it."""
        if self._module is None:
            raise RuntimeError("load a model first")
        if self.device.type == "cuda":
            from ..ops.kernel_build import load_library
            load_library()
        x = np.asarray(example)
        sizes = [x.shape[0]] if buckets is None else [int(b) for b in buckets]
        row = x[:1] if x.shape[0] else np.zeros((1,) + x.shape[1:], x.dtype)
        for b in sorted({_bucket(s) for s in sizes}):
            self.predict(np.repeat(row, b, axis=0))
        return self

    # -- predict --------------------------------------------------------------

    def _launch(self, xs: List[np.ndarray], n: int
                ) -> Callable[[], np.ndarray]:
        """Run one padded bucket; returns the fetch thunk."""
        ts = [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
              for x in xs]
        with self._slots, torch.inference_mode():
            y = self._module(ts[0] if len(ts) == 1 else ts)
            if self._output_f32 or y.dtype == torch.bfloat16:
                y = y.to(torch.float32)
            if self.device.type == "cuda":
                host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                host.copy_(y, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            else:
                host, done = y, None

        def fetch() -> np.ndarray:
            if done is not None:
                done.synchronize()
            return host.numpy()[:n]

        return fetch

    def predict(self, x, batch_size: Optional[int] = None, *,
                _fetch: bool = True):
        """Borrow a slot, pad to the shape bucket with the last row, run,
        trim. ``batch_size`` splits larger inputs into chunks, each
        bucketed. One input array, or a list of them for a model of several
        inputs (or one flat array, see the module's docstring); one output
        array."""
        if self._module is None:
            raise RuntimeError("no model loaded")
        xs = [np.asarray(a) for a in x] if isinstance(x, (list, tuple)) \
            else [np.asarray(x)]
        flat = self._flat_inputs
        if len(xs) == 1 and flat and xs[0].ndim == 2 \
                and xs[0].shape[1] == sum(w for w, _ in flat):
            xs = _split_flat(xs[0], flat)
        # f64 -> f32, as the JAX package's x64-off jit
        xs = [a.astype(np.float32) if a.dtype == np.float64 else a
              for a in xs]
        n = xs[0].shape[0]
        if batch_size is not None and n > batch_size:
            thunks = [self.predict([a[i:i + batch_size] for a in xs],
                                   batch_size, _fetch=False)
                      for i in range(0, n, batch_size)]

            def gather() -> np.ndarray:
                return np.concatenate([t() for t in thunks])

            return gather() if _fetch else gather
        bucket = _bucket(n)
        if bucket != n:
            xs = [np.concatenate([a, np.repeat(
                a[-1:] if n else np.zeros((1,) + a.shape[1:], a.dtype),
                bucket - n, axis=0)]) for a in xs]
        fetch = self._launch(xs, n)
        return fetch() if _fetch else fetch

    def predict_async(self, x, batch_size: Optional[int] = None):
        """Dispatch without waiting for the device; returns a thunk that
        produces :meth:`predict`'s result."""
        return self.predict(x, batch_size, _fetch=False)
