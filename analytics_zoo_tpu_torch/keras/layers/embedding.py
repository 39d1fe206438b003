"""Embedding layers (counterpart of ``analytics_zoo_tpu/keras/layers/
embedding.py``: ``Embedding`` and ``SparseEmbedding``), for a replicated
table with no cold tier.

Every lookup validates its ids (``data.validate_ids``), then gathers rows
through ``ops.embedding_kernels.gather_rows_clip``: the hand-written CUDA
kernel for a table on the card, its plain PyTorch version only for a table
on the CPU. ``SparseEmbedding`` pools bags of ids through
``ops.embedding_kernels.gather_pool``, the gather+pool kernel. Neither
``kernels.fused_embedding`` nor ``fused`` can move a lookup on the card off
the kernels. Vocab sharding (``shard``) and the
host-memory cold tier (``cold_rows``) are later slices and raise here.

An ``Embedding`` table that ``inference.quantize`` left int8 stays int8
and is looked up through ``ops.embedding_kernels.gather_pool_int8``: the
int8 gather kernel on the card, which dequantizes each row as it copies it.
The JAX package instead dequantizes the whole table before the forward;
the values are the same (ROADMAP Queue C5). An int8 table is forward only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import initializers
from ..engine import Layer
from ...inference.quantize import QuantizedWeight
from ...ops import embedding_kernels as _ek
from ...parallel import embedding as _embed


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 weights: Optional[np.ndarray] = None,
                 trainable: bool = True, name: Optional[str] = None,
                 shard=None, cold_rows: int = 0,
                 fused: Optional[bool] = None):
        super().__init__(name)
        if shard:
            raise NotImplementedError(
                "vocab-sharded embeddings (shard=...) are not ported yet")
        if cold_rows:
            raise NotImplementedError(
                "the host cold tier (cold_rows=...) is not ported yet")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.init = initializers.get(init)
        self.weights = weights
        self.trainable = trainable
        #: kept so the JAX package's constructor surface and saved configs
        #: still load; the port has one gather path and ignores it
        self.fused = fused

    def build(self, generator, input_shape, device):
        if self.weights is not None:
            table = torch.as_tensor(np.asarray(self.weights, np.float32))
            if tuple(table.shape) != (self.input_dim, self.output_dim):
                raise ValueError(
                    f"pretrained weights {tuple(table.shape)} != "
                    f"({self.input_dim}, {self.output_dim})")
        else:
            table = self.init(generator, (self.input_dim, self.output_dim))
        table = table.to(device)
        if self.trainable:
            self.embeddings = nn.Parameter(table)
        else:
            self.register_buffer("embeddings", table)
        self.built = True

    def forward(self, inputs):
        # float ids truncate toward zero, as the JAX layer's astype(int32)
        idx = _embed.validate_ids(inputs.to(torch.int32), self.input_dim)
        table = self.embeddings
        if isinstance(table, QuantizedWeight):
            if self.training:
                raise RuntimeError(
                    f"{self.name}: an int8 table is forward only; it has no "
                    f"gradient (quantize a model for inference, after "
                    f"training)")
            return _ek.gather_pool_int8(table.q, table.scale, idx, None)
        return _ek.gather_rows_clip(table, idx)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class SparseEmbedding(Embedding):
    """Embedding over integer bags ``[..., bag]`` pooled by ``combiner``
    (``sum``, ``mean``, ``sqrtn``; ``None`` keeps the bag axis). Negative
    ids are padding: zero rows, left out of the mean/sqrtn count."""

    def __init__(self, input_dim: int, output_dim: int, combiner: str = "sum",
                 init="uniform", weights=None, trainable: bool = True,
                 name: Optional[str] = None, shard=None,
                 fused: Optional[bool] = None):
        super().__init__(input_dim, output_dim, init=init, weights=weights,
                         trainable=trainable, name=name, shard=shard,
                         fused=fused)
        if combiner not in ("sum", "mean", "sqrtn", None):
            raise ValueError(f"unknown combiner {combiner}")
        self.combiner = combiner

    def forward(self, inputs):
        idx = _embed.validate_ids(inputs.to(torch.int32), self.input_dim,
                                  allow_negative=True)
        return _ek.gather_pool(self.embeddings, idx, self.combiner)

    def compute_output_shape(self, input_shape):
        if self.combiner is None:
            return tuple(input_shape) + (self.output_dim,)
        return tuple(input_shape[:-1]) + (self.output_dim,)
