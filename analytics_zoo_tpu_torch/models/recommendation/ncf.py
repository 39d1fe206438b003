"""Neural Collaborative Filtering (counterpart of ``analytics_zoo_tpu/
models/recommendation/ncf.py``): GMF + MLP twin towers over user and item
embeddings with a softmax head; the same constructor surface and the same
layer names, so weights carry across by name."""
from __future__ import annotations

from typing import Sequence

from ..common import Recommender, register_zoo_model
from ...keras import Input, Model
from ...keras.layers import Dense, Embedding, Flatten, Lambda, merge


@register_zoo_model
class NeuralCF(Recommender):
    def __init__(self, user_count: int, item_count: int, num_classes: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 shard_embeddings=None, fused_embeddings=None):
        super().__init__()
        self.user_count = user_count
        self.item_count = item_count
        self.num_classes = num_classes
        self.user_embed = user_embed
        self.item_embed = item_embed
        self.hidden_layers = list(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = mf_embed
        #: vocab sharding is a later slice; the Embedding layer raises on it
        self.shard_embeddings = shard_embeddings
        #: kept so zoo_model.json matches the JAX package's; the port's
        #: Embedding ignores it (one gather path, the kernel on the card)
        self.fused_embeddings = fused_embeddings

    def get_config(self):
        return {
            "user_count": self.user_count, "item_count": self.item_count,
            "num_classes": self.num_classes, "user_embed": self.user_embed,
            "item_embed": self.item_embed,
            "hidden_layers": self.hidden_layers,
            "include_mf": self.include_mf, "mf_embed": self.mf_embed,
            "shard_embeddings": self.shard_embeddings,
            "fused_embeddings": self.fused_embeddings,
        }

    def build_model(self) -> Model:
        pairs = Input((2,), name="user_item_pairs")
        user = Lambda(lambda x: x[:, 0:1], name="user_select")(pairs)
        item = Lambda(lambda x: x[:, 1:2], name="item_select")(pairs)

        shard = self.shard_embeddings
        fused = self.fused_embeddings
        mlp_user = Flatten(name="mlp_user_flat")(
            Embedding(self.user_count + 1, self.user_embed, init="normal",
                      name="mlp_user_table", shard=shard,
                      fused=fused)(user))
        mlp_item = Flatten(name="mlp_item_flat")(
            Embedding(self.item_count + 1, self.item_embed, init="normal",
                      name="mlp_item_table", shard=shard,
                      fused=fused)(item))
        h = merge([mlp_user, mlp_item], mode="concat")
        for i, units in enumerate(self.hidden_layers):
            h = Dense(units, activation="relu", name=f"mlp_dense_{i}")(h)

        if self.include_mf:
            if self.mf_embed <= 0:
                raise ValueError("mf_embed must be positive when include_mf")
            mf_user = Flatten(name="mf_user_flat")(
                Embedding(self.user_count + 1, self.mf_embed, init="normal",
                          name="mf_user_table", shard=shard,
                          fused=fused)(user))
            mf_item = Flatten(name="mf_item_flat")(
                Embedding(self.item_count + 1, self.mf_embed, init="normal",
                          name="mf_item_table", shard=shard,
                          fused=fused)(item))
            gmf = merge([mf_user, mf_item], mode="mul")
            h = merge([h, gmf], mode="concat")
        out = Dense(self.num_classes, activation="softmax",
                    name="prediction")(h)
        return Model(pairs, out, name="neural_cf")
