"""Host-to-card batch feed (counterpart of ``analytics_zoo_tpu/feature/
device_feed.py`` ``DeviceFeed`` and ``masked_eval_batches``).

The JAX package runs a producer thread that keeps batches in flight ahead
of the step. Here the feed stays one batch ahead on the calling thread:
when a step takes batch ``i``, batch ``i + 1`` has already been drawn from
the host iterator, copied into pinned host memory and sent to the card with
a ``non_blocking`` copy on a side CUDA stream, so the copy runs while step
``i`` computes. The step's stream waits on the copy's event before it reads
the batch. Drawing one batch ahead also draws the next epoch's permutation
at an epoch's last step, as the JAX producer does, so both packages consume
the shuffle stream alike.

On the CPU (``device="cpu"``, which must be asked for) batches become
tensors that share the numpy arrays' memory.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
import torch

from .featureset import tree_map


def masked_eval_batches(it: Iterator[Any], batch_size: int,
                        mesh=None) -> Iterator[Any]:
    """``(x, y, valid)`` from ``eval_iterator`` -> ``((x, y, mask), valid)``
    with a float mask over the real rows of a padded tail batch. With
    ``mesh``, ``batch_size`` is the global batch and the mask this rank's
    rows of it."""
    positions = np.arange(batch_size)
    if mesh is not None:
        from ..parallel.mesh import shard_batch
        positions = shard_batch(mesh, positions)
    masks = {}
    for x, y, valid in it:
        mask = masks.get(valid)
        if mask is None:
            mask = masks[valid] = (positions < valid).astype(np.float32)
        yield (x, y, mask), valid


def _to_tensor(leaf):
    if isinstance(leaf, np.ndarray):
        if leaf.dtype == np.float64:  # as the JAX package's x64-off arrays
            leaf = leaf.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf


class DeviceFeed:
    """Iterate device tensors from a host iterator of numpy trees, one
    batch ahead. Leaves that are not arrays (valid counts) pass through."""

    def __init__(self, host_iterator: Iterator[Any], device: torch.device):
        self.device = device
        self._it = iter(host_iterator)
        self._cuda = device.type == "cuda"
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device) if self._cuda else None)
        self._next = None
        self._held = None
        self._started = False

    def _stage(self) -> None:
        """Draw the next host batch and start its copy to the device."""
        try:
            item = next(self._it)
        except StopIteration:
            self._next = None
            return
        host = tree_map(_to_tensor, item)
        if not self._cuda:
            self._next = (host, None, None)
            return
        pinned = tree_map(lambda t: t.pin_memory()
                          if isinstance(t, torch.Tensor) else t, host)
        with torch.cuda.stream(self._stream):
            dev = tree_map(lambda t: t.to(self.device, non_blocking=True)
                           if isinstance(t, torch.Tensor) else t, pinned)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self._next = (dev, ready, pinned)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._started:
            self._started = True
            self._stage()
        if self._next is None:
            raise StopIteration
        batch, ready, pinned = self._next
        # the pinned source stays referenced until its copy is waited on
        self._held = pinned
        self._stage()
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            # the side stream allocated the batch; tell the allocator the
            # step's stream uses it too
            tree_map(lambda t: t.record_stream(stream)
                     if isinstance(t, torch.Tensor) else t, batch)
        return batch

    def close(self) -> None:
        self._next = None
        self._held = None
        self._it = iter(())
