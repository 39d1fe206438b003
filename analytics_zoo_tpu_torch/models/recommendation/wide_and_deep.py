"""Wide & Deep recommender (counterpart of ``analytics_zoo_tpu/models/
recommendation/wide_and_deep.py``): the same column spec, feature helpers,
constructor surface and layer names, so weights carry across by name.

The wide part keeps its features as bucket ids and is an embedding-sum over
a ``[total_wide_dim, num_classes]`` table (``one_hot(x) @ W == W[x].sum``),
pooled by ``gather_pool`` and so by the gather+pool kernel on the card.
Indicator columns are one-hot on the device, embedding columns get one
table each (the row-gather kernel), continuous columns pass through.

``shard_embeddings`` (True or a mesh axis name) vocab-shards the wide table
and every embedding table over the ranks of the default mesh
(``parallel/embedding.py``): the hashed-cross vocabulary stops being
replicated on every rank, and its gradient stops being a dense all-reduce.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..common import Recommender, register_zoo_model
from ...keras import Input, Model
from ...keras.engine import Layer
from ...keras.layers.embedding import ShardedTable
from ...keras.layers import (Activation, Dense, Embedding, Flatten, Lambda,
                             merge)
from ...ops import embedding_kernels as _ek
from ...parallel import embedding as _embed


@dataclass
class ColumnFeatureInfo:
    """Column spec: every dim is a per-column cardinality; wide-cross
    columns are bucket ids from :func:`cross_columns`."""
    wide_base_cols: Sequence[str] = field(default_factory=list)
    wide_base_dims: Sequence[int] = field(default_factory=list)
    wide_cross_cols: Sequence[str] = field(default_factory=list)
    wide_cross_dims: Sequence[int] = field(default_factory=list)
    indicator_cols: Sequence[str] = field(default_factory=list)
    indicator_dims: Sequence[int] = field(default_factory=list)
    embed_cols: Sequence[str] = field(default_factory=list)
    embed_in_dims: Sequence[int] = field(default_factory=list)
    embed_out_dims: Sequence[int] = field(default_factory=list)
    continuous_cols: Sequence[str] = field(default_factory=list)
    label: str = "label"

    @property
    def wide_dims(self) -> List[int]:
        return list(self.wide_base_dims) + list(self.wide_cross_dims)

    @property
    def wide_cols(self) -> List[str]:
        return list(self.wide_base_cols) + list(self.wide_cross_cols)


def _crc32_codes(col) -> np.ndarray:
    """``crc32(str(v))`` per value, hashing each distinct value once."""
    try:
        import pandas as pd
        # NaN stays among the uniques and hashes as crc32("nan")
        inv, uniq = pd.factorize(np.asarray(col), use_na_sentinel=False)
        uniq = np.asarray(uniq)
    except ImportError:
        uniq, inv = np.unique(np.asarray(col), return_inverse=True)
    table = np.fromiter((zlib.crc32(str(v).encode()) for v in uniq),
                        dtype=np.int64, count=len(uniq))
    return table[inv]


def cross_columns(df, cols: Sequence[str], bucket_size: int) -> np.ndarray:
    """Hash-cross of categorical columns into ``bucket_size`` buckets with
    crc32, stable across processes (train and serve land in one bucket)."""
    acc = np.zeros(len(df), dtype=np.int64)
    for c in cols:
        acc = acc * 1000003 + _crc32_codes(df[c])
    return np.abs(acc) % bucket_size


def features_from_dataframe(df, column_info: ColumnFeatureInfo
                            ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """pandas DataFrame -> the 4 model input arrays and the labels.
    Categorical columns must already be integer ids (0-based per column);
    they travel as int32."""
    n = len(df)
    ci = column_info

    def ids(cols, dims, offsets):
        if not cols:
            return np.zeros((n, 0), np.int32)
        return np.stack([
            np.clip(df[c].to_numpy().astype(np.int64), 0, d - 1) + off
            for c, d, off in zip(cols, dims, offsets)],
            axis=1).astype(np.int32)

    wide = ids(ci.wide_cols, ci.wide_dims,
               np.cumsum([0] + list(ci.wide_dims))[:-1])
    ind = ids(ci.indicator_cols, ci.indicator_dims,
              [0] * len(ci.indicator_cols))
    emb = ids(ci.embed_cols, ci.embed_in_dims, [0] * len(ci.embed_cols))
    cont = (np.stack([df[c].to_numpy().astype(np.float32)
                      for c in ci.continuous_cols], axis=1)
            if ci.continuous_cols else np.zeros((n, 0), np.float32))
    labels = (df[ci.label].to_numpy().astype(np.float32)
              if ci.label in df.columns else None)
    return [wide, ind, emb, cont], labels


class _WideLinear(ShardedTable, Layer):
    """Embedding-sum sparse linear layer over offset bucket ids
    ``[batch, n_wide]``: ``table[ids].sum(1) + bias``.

    With ``shard`` the ``[total_dim, num_classes]`` table is drawn whole,
    padded with zero rows and split over the default mesh's ranks; this
    rank keeps its block and looks rows up through the sharded engine."""

    TABLE = "table"

    def __init__(self, total_dim: int, num_classes: int, name=None,
                 shard=None, fused=None):
        super().__init__(name)
        self.total_dim = total_dim
        self.num_classes = num_classes
        #: kept for the JAX package's surface; the port has one path
        self.fused = fused
        self._init_sharding(shard)

    @property
    def _vocab(self) -> int:
        return self.total_dim

    @property
    def _dim(self) -> int:
        return self.num_classes

    def build(self, generator, input_shape, device):
        table = torch.empty((self.total_dim, self.num_classes)).uniform_(
            -0.05, 0.05, generator=generator)
        self.table = nn.Parameter(self._shard_table(table).to(device))
        self.bias = nn.Parameter(torch.zeros(self.num_classes, device=device))
        self.built = True

    def forward(self, inputs):
        idx = _embed.validate_ids(inputs.to(torch.int32), self.total_dim)
        if not self._takes_sharded(idx):
            return _ek.gather_pool(self.table, idx, "sum",
                                   mask_negative=False) + self.bias
        rows = self._sharded(self.table, idx.reshape(-1))
        return rows.reshape(tuple(idx.shape) + (self.num_classes,)).sum(1) \
            + self.bias

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.num_classes)


class _OneHotConcat(Layer):
    """Indicator ids -> concatenated one-hot block, on the device. An id
    outside ``[0, d)`` gives a zero block, as ``jax.nn.one_hot`` does."""

    def __init__(self, dims: Sequence[int], name=None):
        super().__init__(name)
        self.dims = list(dims)

    def forward(self, inputs):
        idx = inputs.to(torch.int64)
        parts = [(idx[:, i:i + 1] == torch.arange(d, device=idx.device))
                 .float() for i, d in enumerate(self.dims)]
        return torch.cat(parts, dim=-1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], sum(self.dims))


@register_zoo_model
class WideAndDeep(Recommender):
    """Inputs (``[batch, n]`` arrays, see ``features_from_dataframe``):
    [wide offset ids, indicator ids, embed ids, continuous]."""

    def __init__(self, model_type: str = "wide_n_deep", num_classes: int = 2,
                 column_info: Optional[ColumnFeatureInfo] = None,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 shard_embeddings=None, fused_embeddings=None,
                 **column_kwargs):
        super().__init__()
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(f"unknown model_type {model_type}")
        if column_info is None:
            column_info = ColumnFeatureInfo(**column_kwargs)
        elif isinstance(column_info, dict):
            column_info = ColumnFeatureInfo(**column_info)
        self.model_type = model_type
        self.num_classes = num_classes
        self.column_info = column_info
        self.hidden_layers = list(hidden_layers)
        #: None/False = replicated tables; True/axis name = vocab-shard the
        #: wide table and the embedding tables over the default mesh
        self.shard_embeddings = shard_embeddings
        #: kept so zoo_model.json matches the JAX package's; ignored
        self.fused_embeddings = fused_embeddings

    def get_config(self) -> Dict[str, Any]:
        ci = self.column_info
        return {
            "model_type": self.model_type, "num_classes": self.num_classes,
            "hidden_layers": self.hidden_layers,
            "shard_embeddings": self.shard_embeddings,
            "fused_embeddings": self.fused_embeddings,
            "column_info": {
                "wide_base_cols": list(ci.wide_base_cols),
                "wide_base_dims": list(ci.wide_base_dims),
                "wide_cross_cols": list(ci.wide_cross_cols),
                "wide_cross_dims": list(ci.wide_cross_dims),
                "indicator_cols": list(ci.indicator_cols),
                "indicator_dims": list(ci.indicator_dims),
                "embed_cols": list(ci.embed_cols),
                "embed_in_dims": list(ci.embed_in_dims),
                "embed_out_dims": list(ci.embed_out_dims),
                "continuous_cols": list(ci.continuous_cols),
                "label": ci.label,
            },
        }

    def build_model(self) -> Model:
        ci = self.column_info
        in_wide = Input((len(ci.wide_cols),), name="wide_input", ids=True)
        in_ind = Input((len(ci.indicator_cols),), name="indicator_input",
                       ids=True)
        in_emb = Input((len(ci.embed_cols),), name="embed_input", ids=True)
        in_cont = Input((len(ci.continuous_cols),), name="continuous_input")
        inputs = [in_wide, in_ind, in_emb, in_cont]

        wide_out = None
        if ci.wide_cols:
            wide_out = _WideLinear(sum(ci.wide_dims), self.num_classes,
                                   name="wide_linear",
                                   shard=self.shard_embeddings,
                                   fused=self.fused_embeddings)(in_wide)

        deep_out = None
        deep_parts = []
        if ci.indicator_cols:
            deep_parts.append(_OneHotConcat(
                ci.indicator_dims, name="indicator_onehot")(in_ind))
        for i, (c, din, dout) in enumerate(zip(
                ci.embed_cols, ci.embed_in_dims, ci.embed_out_dims)):
            col = Lambda(lambda x, i=i: x[:, i:i + 1],
                         name=f"embed_col_{i}")(in_emb)
            e = Embedding(din, dout, init="normal", name=f"embed_table_{c}",
                          shard=self.shard_embeddings,
                          fused=self.fused_embeddings)(col)
            deep_parts.append(Flatten(name=f"embed_flat_{c}")(e))
        if ci.continuous_cols:
            deep_parts.append(in_cont)
        if deep_parts:
            h = (merge(deep_parts, mode="concat") if len(deep_parts) > 1
                 else deep_parts[0])
            for i, units in enumerate(self.hidden_layers):
                h = Dense(units, activation="relu",
                          name=f"deep_dense_{i}")(h)
            deep_out = Dense(self.num_classes, name="deep_linear")(h)

        if self.model_type == "wide":
            if wide_out is None:
                raise ValueError("model_type 'wide' needs wide columns")
            out = Activation("softmax", name="prediction")(wide_out)
        elif self.model_type == "deep":
            if deep_out is None:
                raise ValueError("model_type 'deep' needs deep columns")
            out = Activation("softmax", name="prediction")(deep_out)
        else:
            if wide_out is None or deep_out is None:
                raise ValueError(
                    "wide_n_deep needs both wide and deep columns")
            out = Activation("softmax", name="prediction")(
                merge([wide_out, deep_out], mode="sum"))
        return Model(inputs, out, name="wide_and_deep")

    def default_compile(self):
        self.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                     metrics=["accuracy"])
