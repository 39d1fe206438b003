"""Embedding layers (counterpart of ``analytics_zoo_tpu/keras/layers/
embedding.py``: ``Embedding`` and ``SparseEmbedding``), replicated or
vocab-sharded, with no cold tier.

Every lookup validates its ids (``data.validate_ids``), then gathers rows
through ``ops.embedding_kernels.gather_rows_clip``: the hand-written CUDA
kernel for a table on the card, its plain PyTorch version only for a table
on the CPU. ``SparseEmbedding`` pools bags of ids through
``ops.embedding_kernels.gather_pool``, the gather+pool kernel. Neither
``kernels.fused_embedding`` nor ``fused`` can move a lookup on the card off
the kernels.

``shard=True`` (or the name of a mesh axis) splits the vocab over the ranks
of the default mesh (``parallel.mesh.init_mesh``, or the Estimator's
``mesh``) when the layer builds: the table is drawn whole from the
generator, as a replicated one is, padded with zero rows to the shard
count, and this rank keeps its block (``parallel.embedding.ShardSpec``).
Lookups then go through ``parallel.embedding.sharded_lookup``, and the
layer keeps the lookup's ``recv`` for the Estimator's row-subset update
(:meth:`Embedding.pop_stashed_rows`). With one rank or no mesh the table
stays replicated. The host-memory cold tier (``cold_rows``) is not ported
and raises.

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
from ...convert import shard_rows
from ...inference.quantize import QuantizedWeight
from ...ops import embedding_kernels as _ek
from ...parallel import embedding as _embed


class ShardedTable:
    """The vocab-sharding half of a layer that holds one table: the
    parameter ``TABLE`` of shape ``[self._vocab, self._dim]`` (Embedding's
    ``embeddings``, Wide&Deep's wide ``table``). ``shard`` is False/None
    (replicated), True (the default mesh's embedding axis) or an axis
    name."""

    TABLE = "embeddings"

    def _init_sharding(self, shard) -> None:
        self.shard = shard
        self._shard_spec = None
        self._stashed: dict = {}

    def _make_spec(self):
        if not self.shard:
            return None
        axis = self.shard if isinstance(self.shard, str) else None
        return _embed.make_shard_spec(self._vocab, self._dim, axis=axis)

    def sharded_tables(self):
        """``{param name: ShardSpec}`` of the vocab-sharded table, for the
        Estimator's plan (empty when replicated or frozen)."""
        if not getattr(self, "trainable", True):
            return {}
        spec = self._shard_spec if self.built else self._make_spec()
        return {self.TABLE: spec} if spec is not None else {}

    def pop_stashed_rows(self) -> dict:
        """``{param name: recv}`` of the sharded lookups since the last
        call, emptied."""
        out, self._stashed = self._stashed, {}
        return out

    def _shard_table(self, table: torch.Tensor) -> torch.Tensor:
        """At build: this rank's padded block of the whole ``table`` when
        the layer shards, else ``table``."""
        self._shard_spec = spec = self._make_spec()
        if spec is None:
            return table
        _embed.note_table_bytes(self.name, spec.table_bytes)
        return shard_rows(table, spec.mesh.rank, spec.shards)

    def _takes_sharded(self, idx: torch.Tensor) -> bool:
        spec = self._shard_spec
        # every rank holds an equal share of the batch: the whole batch has
        # ``shards`` times this rank's ids
        return spec is not None and _embed.can_run(
            spec, idx.numel() * spec.shards)

    def _sharded(self, table: torch.Tensor, flat: torch.Tensor):
        """Rows of ``flat`` through the sharded engine, keeping ``recv``
        while training."""
        rows, recv = _embed.sharded_lookup(table, flat, self._shard_spec)
        if self.training:
            self._stashed[self.TABLE] = recv
        return rows


class Embedding(ShardedTable, Layer):
    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 weights: Optional[np.ndarray] = None,
                 trainable: bool = True, name: Optional[str] = None,
                 shard=None, cold_rows: int = 0,
                 fused: Optional[bool] = None):
        super().__init__(name)
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
        self._init_sharding(shard)

    @property
    def _vocab(self) -> int:
        return self.input_dim

    @property
    def _dim(self) -> int:
        return self.output_dim

    def build(self, generator, input_shape, device):
        if self.weights is not None:
            table = torch.as_tensor(np.asarray(self.weights, np.float32))
            if tuple(table.shape) != (self.input_dim, self.output_dim):
                raise ValueError(
                    f"pretrained weights {tuple(table.shape)} != "
                    f"({self.input_dim}, {self.output_dim})")
        else:
            table = self.init(generator, (self.input_dim, self.output_dim))
        table = self._shard_table(table).to(device)
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
        if self._takes_sharded(idx):
            rows = self._sharded(table, idx.reshape(-1))
            return rows.reshape(tuple(idx.shape) + (self.output_dim,))
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
        if not self._takes_sharded(idx):
            return _ek.gather_pool(self.embeddings, idx, self.combiner)
        spec = self._shard_spec
        # padding ids route to the SENTINEL (zero rows, no gradient); the
        # mask keeps the combiner's arithmetic the JAX package's
        flat = idx.reshape(-1)
        rows = self._sharded(self.embeddings, torch.where(
            flat < 0, torch.full_like(flat, spec.padded), flat))
        valid = (idx >= 0).to(rows.dtype)[..., None]
        emb = rows.reshape(tuple(idx.shape) + (self.output_dim,)) * valid
        if self.combiner is None:
            return emb
        total = emb.sum(dim=-2)
        if self.combiner == "sum":
            return total
        n = valid.sum(dim=-2).clamp(min=1.0)
        if self.combiner == "mean":
            return total / n
        return total / torch.sqrt(n)  # sqrtn

    def compute_output_shape(self, input_shape):
        if self.combiner is None:
            return tuple(input_shape) + (self.output_dim,)
        return tuple(input_shape[:-1]) + (self.output_dim,)
