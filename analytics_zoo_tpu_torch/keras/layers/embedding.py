"""Embedding layer (counterpart of ``analytics_zoo_tpu/keras/layers/
embedding.py`` ``Embedding``), for a replicated table with no cold tier.

Every lookup validates its ids (``data.validate_ids``), then gathers rows
through ``ops.embedding_kernels.gather_rows_clip``: the hand-written CUDA
kernel for a table on the card, its plain PyTorch version only for a table
on the CPU. Neither ``kernels.fused_embedding`` nor ``fused`` can move a
lookup on the card off the kernel. Vocab sharding (``shard``) and the
host-memory cold tier (``cold_rows``) are later slices and raise here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import initializers
from ..engine import Layer
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
        return _ek.gather_rows_clip(self.embeddings, idx)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)
