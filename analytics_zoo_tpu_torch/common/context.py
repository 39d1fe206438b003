"""Device context: the port's stand-in for ``init_tpu_context``.

The card is the default. :func:`resolve_device` gives ``cuda`` when no
device is named; a caller that wants the CPU says ``device="cpu"``, as the
tests do. With no card and no explicit ``cpu`` it raises, so no entry point
ever runs on the CPU without being asked to.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


class NoCudaDeviceError(RuntimeError):
    """No CUDA card is visible and the caller did not ask for the CPU."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; ``cuda[:i]`` needs a
    card. Any other device type raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
