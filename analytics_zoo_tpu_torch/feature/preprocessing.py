"""Composable preprocessing pipeline (the port's own copy of
``analytics_zoo_tpu/feature/preprocessing.py``, which is numpy only).

The reference's ``Preprocessing[A, B]`` transformers chain with ``->``
(``zoo/.../feature/common/*.scala``) and adapt raw records into model inputs
(``ArrayToTensor``, ``SeqToTensor``, ``TensorToSample``...). Here a
``Preprocessing`` is a pure record transform, chained with ``>>``;
``stack_records`` stacks transformed records into numpy minibatches (the
``MTSampleToMiniBatch`` role) for the feed to move to the card.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np


class Preprocessing:
    """A record-level transform; chain with ``>>`` (reference: ``->``)."""

    def apply(self, record: Any) -> Any:
        raise NotImplementedError

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing(self, other)

    def __call__(self, records: Iterable[Any]) -> Iterator[Any]:
        return (self.apply(r) for r in records)


class BatchPreprocessing(Preprocessing):
    """A transform that operates on the WHOLE stacked array tree at once
    (``batched=True``): ``apply_batch`` is one vectorized numpy call in
    place of a per-record Python loop. The
    per-record ``apply`` still works (records get a temporary batch axis),
    so batched and record transforms chain freely."""

    batched = True

    def apply_batch(self, batch: Any) -> Any:
        raise NotImplementedError

    def apply(self, record: Any) -> Any:
        add = lambda a: np.asarray(a)[None]
        drop = lambda a: np.asarray(a)[0]
        batched = (tuple(add(r) for r in record) if isinstance(record, tuple)
                   else {k: add(v) for k, v in record.items()}
                   if isinstance(record, dict) else add(record))
        out = self.apply_batch(batched)
        return (tuple(drop(o) for o in out) if isinstance(out, tuple)
                else {k: drop(v) for k, v in out.items()}
                if isinstance(out, dict) else drop(out))


class BatchLambda(BatchPreprocessing):
    """Vectorized transform from a plain function over the stacked tree."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply_batch(self, batch: Any) -> Any:
        return self.fn(batch)


class ChainedPreprocessing(Preprocessing):
    def __init__(self, *stages: Preprocessing):
        flat = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                flat.extend(s.stages)
            else:
                flat.append(s)
        self.stages = tuple(flat)
        # a chain of all-batched stages is itself batched (stays vectorized)
        self.batched = all(getattr(s, "batched", False) for s in flat)

    def apply(self, record: Any) -> Any:
        for s in self.stages:
            record = s.apply(record)
        return record

    def apply_batch(self, batch: Any) -> Any:
        for s in self.stages:
            batch = s.apply_batch(batch)
        return batch


class Lambda(Preprocessing):
    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply(self, record: Any) -> Any:
        return self.fn(record)


class ArrayToTensor(Preprocessing):
    """Coerce (nested) python/numpy data to float32 ndarrays
    (reference ``ArrayToTensor``/``SeqToTensor``)."""

    def __init__(self, dtype=np.float32):
        self.dtype = dtype

    def apply(self, record: Any) -> Any:
        if isinstance(record, tuple):
            return tuple(np.asarray(r, dtype=self.dtype) for r in record)
        return np.asarray(record, dtype=self.dtype)


class FeatureLabelPreprocessing(Preprocessing):
    """Apply separate transforms to the feature and label of a (x, y) record
    (reference ``FeatureLabelPreprocessing``)."""

    def __init__(self, feature: Preprocessing, label: Preprocessing):
        self.feature = feature
        self.label = label

    def apply(self, record: Any) -> Any:
        x, y = record
        return self.feature.apply(x), self.label.apply(y)


def stack_records(records: Sequence[Any], out: Any = None) -> Any:
    """Stack a list of records (arrays, or tuples/dicts of arrays) into one
    batched record — the ``SampleToMiniBatch`` role.

    With ``out`` (a same-structured tree of ``[len(records), ...]``
    buffers) rows are written in place and ``out`` is returned: callers
    filling a preallocated output tree chunk by chunk avoid ever holding a
    full per-record Python list next to its stacked copy."""
    first = records[0]
    if out is None:
        if isinstance(first, tuple):
            return tuple(np.stack([r[i] for r in records])
                         for i in range(len(first)))
        if isinstance(first, dict):
            return {k: np.stack([r[k] for r in records]) for k in first}
        return np.stack(records)
    if isinstance(first, tuple):
        for j in range(len(first)):
            buf = out[j]
            for i, r in enumerate(records):
                buf[i] = r[j]
    elif isinstance(first, dict):
        for k in first:
            buf = out[k]
            for i, r in enumerate(records):
                buf[i] = r[k]
    else:
        for i, r in enumerate(records):
            out[i] = r
    return out
