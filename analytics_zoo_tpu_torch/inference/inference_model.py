"""InferenceModel (counterpart of ``analytics_zoo_tpu/inference/
inference_model.py``): a loaded model behind ``concurrent_num`` dispatch
slots, with the JAX package's shape buckets and its chunk -> pad-with-last-
row -> trim contract.

The device is the card unless the caller passes ``device="cpu"``. A predict
moves its batch to the device, runs the forward under
``torch.inference_mode()`` and starts the copy back into pinned host memory
on the same stream; :meth:`predict_async` returns before that copy lands,
so the serving loop decodes the next batch while the card works.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..common.context import DeviceLike, resolve_device

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


class InferenceModel:
    def __init__(self, concurrent_num: int = 1, device: DeviceLike = None):
        if concurrent_num < 1:
            raise ValueError("concurrent_num must be >= 1")
        self.device = resolve_device(device)
        self.concurrent_num = concurrent_num
        self._slots = threading.Semaphore(concurrent_num)
        self._module: Optional[torch.nn.Module] = None

    # -- loaders --------------------------------------------------------------

    def load_zoo(self, path: str) -> "InferenceModel":
        """Load a saved ``ZooModel`` directory onto this model's device."""
        from ..models.common import ZooModel
        self._module = ZooModel.load_model(path, device=self.device).model
        return self

    def load_keras(self, model, state_dict=None) -> "InferenceModel":
        """Wrap an in-memory built keras ``Model``; ``state_dict`` (e.g.
        from ``convert.from_jax_params``) replaces its weights first."""
        if not model.built:
            raise RuntimeError("build the model (or pass it loaded) first")
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self._module = model.to(self.device).eval()
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

    def _launch(self, x: np.ndarray, n: int) -> Callable[[], np.ndarray]:
        """Run one padded bucket; returns the fetch thunk."""
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with self._slots, torch.inference_mode():
            y = self._module(t)
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
        bucketed. One input array, one output array."""
        if self._module is None:
            raise RuntimeError("no model loaded")
        x = np.asarray(x)
        if x.dtype == np.float64:  # as the JAX package's x64-off jit
            x = x.astype(np.float32)
        n = x.shape[0]
        if batch_size is not None and n > batch_size:
            thunks = [self.predict(x[i:i + batch_size], batch_size,
                                   _fetch=False)
                      for i in range(0, n, batch_size)]

            def gather() -> np.ndarray:
                return np.concatenate([t() for t in thunks])

            return gather() if _fetch else gather
        bucket = _bucket(n)
        if bucket != n:
            pad = x[-1:] if n else np.zeros((1,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, np.repeat(pad, bucket - n, axis=0)])
        fetch = self._launch(x, n)
        return fetch() if _fetch else fetch

    def predict_async(self, x, batch_size: Optional[int] = None):
        """Dispatch without waiting for the device; returns a thunk that
        produces :meth:`predict`'s result."""
        return self.predict(x, batch_size, _fetch=False)
