"""In-memory dataset (counterpart of ``analytics_zoo_tpu/feature/
featureset.py`` ``FeatureSet``, the DRAM tier on one host).

Features and labels are numpy arrays, or tuples/dicts of them, whose leading
axis is the record axis. The shuffle stream is the JAX package's exactly:
``np.random.default_rng(seed)``, one ``permutation`` per epoch, drawn when
the epoch's first batch is, so both packages see the same batches in the
same order.

On a mesh every rank holds the same ``FeatureSet`` (same arrays, same
seed), so every rank draws the same global batches; each gathers only its
own rows of each (``parallel.mesh.shard_batch`` on the batch's record
indices), and an evaluation tail is padded to the same length on every
rank.

The memory tier is ``MemoryType.DRAM``; the JAX package's ``DISK`` tier
(arrays spilled to ``np.memmap``) is not ported yet and raises.
"""
from __future__ import annotations

import json
from enum import Enum
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np

ArrayTree = Union[np.ndarray, Tuple[np.ndarray, ...], Dict[str, np.ndarray]]


class MemoryType(Enum):
    DRAM = "dram"
    DISK = "disk"


def column_matrix(df, cols) -> np.ndarray:
    """DataFrame columns -> one float32 array: array-valued cells stack
    (``[n, *cell shape]``), scalar columns give one dimension each
    (``[n, 1]`` for one scalar column); several columns concatenate along
    axis 1. Used by NNFrames."""
    if isinstance(cols, str):
        cols = [cols]
    parts = []
    for c in cols:
        col = df[c].to_numpy()
        if len(col) and isinstance(col[0], (list, tuple, np.ndarray)):
            parts.append(np.stack([np.asarray(v, np.float32) for v in col]))
        else:
            parts.append(col.astype(np.float32)[:, None])
    out = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    return np.ascontiguousarray(out, dtype=np.float32)


def _normalize(tree):
    """Lists of arrays (the Keras multi-input convention) become tuples."""
    return tuple(tree) if isinstance(tree, list) else tree


def tree_map(fn, tree):
    """``fn`` over the leaves of a tuple/list/dict tree."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


class FeatureSet:
    """``(features, labels)`` array trees held in host memory. ``labels``
    may be None (inference)."""

    def __init__(self, features: ArrayTree,
                 labels: Optional[ArrayTree] = None, shuffle: bool = True,
                 seed: int = 0, memory_type: MemoryType = MemoryType.DRAM):
        if MemoryType(memory_type) is not MemoryType.DRAM:
            raise NotImplementedError(
                f"FeatureSet memory_type {memory_type} is not ported yet "
                f"(DRAM only): ROADMAP Queue A item 5")
        features = _normalize(features)
        labels = _normalize(labels)
        n = _leaves(features)[0].shape[0]
        for leaf in _leaves(features) + (
                _leaves(labels) if labels is not None else []):
            if leaf.shape[0] != n:
                raise ValueError(
                    "all arrays must share the leading record axis")
        self.features = features
        self.labels = labels
        self.size = n
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_ndarrays(cls, features: ArrayTree,
                      labels: Optional[ArrayTree] = None,
                      **kwargs) -> "FeatureSet":
        features = tree_map(np.asarray, _normalize(features))
        if labels is not None:
            labels = tree_map(np.asarray, _normalize(labels))
        return cls(features, labels, **kwargs)

    def num_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        if drop_remainder:
            return self.size // batch_size
        return (self.size + batch_size - 1) // batch_size

    def _gather(self, idx: np.ndarray) -> Tuple[Any, Any]:
        take = lambda a: np.take(a, idx, axis=0)
        x = tree_map(take, self.features)
        y = tree_map(take, self.labels) if self.labels is not None else None
        return x, y

    def train_iterator(self, batch_size: int, skip_batches: int = 0,
                       mesh=None) -> Iterator[Tuple[Any, Any]]:
        """Endless; reshuffles every epoch; drops the remainder so every
        step sees a full batch. ``skip_batches`` fast-forwards within the
        first epoch only (a resumed mid-epoch checkpoint). With ``mesh``
        each global batch of ``batch_size`` yields this rank's rows."""
        while True:
            order = (self._rng.permutation(self.size) if self.shuffle
                     else np.arange(self.size))
            first = skip_batches * batch_size
            skip_batches = 0
            for start in range(first, self.size - batch_size + 1,
                               batch_size):
                idx = order[start:start + batch_size]
                yield self._gather(idx if mesh is None
                                   else _shard_batch(mesh, idx))

    def data_state(self) -> str:
        """The shuffle RNG's state as JSON (PCG64 holds 128-bit ints, which
        JSON carries exactly)."""
        return json.dumps(self._rng.bit_generator.state)

    def set_data_state(self, state_json: str) -> None:
        rng = np.random.default_rng()
        rng.bit_generator.state = json.loads(state_json)
        self._rng = rng

    def eval_iterator(self, batch_size: int, pad_remainder: bool = False,
                      mesh=None) -> Iterator[Tuple[Any, Any, int]]:
        """Bounded, in record order; yields ``(x, y, valid_count)``. With
        ``pad_remainder`` the tail batch repeats its last record up to full
        size and ``valid_count`` marks the real ones. With ``mesh`` (which
        needs ``pad_remainder``) each padded global batch yields this
        rank's rows and the global ``valid_count``."""
        if mesh is not None and not pad_remainder:
            raise ValueError("a mesh evaluates padded batches: every rank's "
                             "batch must have the same length")
        for start in range(0, self.size, batch_size):
            idx = np.arange(start, min(start + batch_size, self.size))
            valid = len(idx)
            if valid < batch_size and pad_remainder:
                idx = np.concatenate(
                    [idx, np.full(batch_size - valid, idx[-1])])
            if mesh is not None:
                idx = _shard_batch(mesh, idx)
            x, y = self._gather(idx)
            yield x, y, valid


def _shard_batch(mesh, idx: np.ndarray) -> np.ndarray:
    from ..parallel.mesh import shard_batch
    return shard_batch(mesh, idx)
