"""Model-zoo base classes (counterpart of ``analytics_zoo_tpu/models/
common.py``): ``ZooModel``, ``Recommender`` and the class registry.

A saved model is a directory holding ``zoo_model.json`` (the JAX package's
format, byte for byte) and ``weights/model.pt``, a ``torch.save`` of the
``state_dict`` where the JAX package keeps an orbax checkpoint.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import file_io
from ..common.context import DeviceLike

_MODEL_REGISTRY: Dict[str, type] = {}


def register_zoo_model(cls):
    _MODEL_REGISTRY[cls.__name__] = cls
    return cls


class ZooModel:
    """Base for built-in models. Subclasses implement ``build_model()``
    returning a keras ``Model`` and ``get_config()``."""

    def __init__(self):
        self.model = None

    def _ensure_built(self):
        if self.model is None:
            self.model = self.build_model()
        return self.model

    def build_model(self):
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        raise NotImplementedError

    def build(self, generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> "ZooModel":
        """Create the parameters from ``generator`` (seed 0 when omitted)
        on ``device`` (the card when omitted)."""
        self._ensure_built().build(generator, device=device)
        return self

    # -- training facade (the JAX package's) ---------------------------------

    def compile(self, optimizer, loss, metrics=None):
        self._ensure_built().compile(optimizer, loss, metrics)

    def default_compile(self):
        self.compile(optimizer="adam", loss="mse")

    def fit(self, *args, **kwargs):
        return self._ensure_built().fit(*args, **kwargs)

    def evaluate(self, *args, **kwargs):
        return self._ensure_built().evaluate(*args, **kwargs)

    def predict(self, x, batch_size: int = 1024, device: DeviceLike = None
                ) -> np.ndarray:
        """Forward ``x`` in chunks of ``batch_size``; returns a numpy array.
        The device is chosen as ``Model.predict`` chooses it."""
        return self._ensure_built().predict(x, batch_size=batch_size,
                                            device=device)

    # -- persistence ----------------------------------------------------------

    def save_model(self, path: str) -> None:
        file_io.makedirs(path, exist_ok=True)
        config = {"class": type(self).__name__, "config": self.get_config()}
        with file_io.fopen(file_io.join(path, "zoo_model.json"), "w") as f:
            f.write(json.dumps(config, indent=2))
        self._ensure_built().save_model(file_io.join(path, "weights"))

    @staticmethod
    def load_model(path: str, device: DeviceLike = None) -> "ZooModel":
        """Registry lookup -> build on ``device`` (the card when omitted;
        raises without one unless ``device="cpu"``) -> load the weights."""
        with file_io.fopen(file_io.join(path, "zoo_model.json")) as f:
            spec = json.loads(f.read())
        cls = _MODEL_REGISTRY.get(spec["class"])
        if cls is None:
            raise ValueError(f"unknown zoo model class {spec['class']}; "
                             f"registered: {sorted(_MODEL_REGISTRY)}")
        inst = cls(**spec["config"])
        inst.build(device=device)
        inst.model.load_weights(file_io.join(path, "weights"))
        inst.model.eval()
        return inst


class Recommender(ZooModel):
    """Adds ranking helpers over (user, item) pair predictions."""

    def _pair_probs(self, user_ids, item_ids, batch_size: int = 1024
                    ) -> np.ndarray:
        pairs = np.stack([user_ids, item_ids], axis=1).astype(np.float32)
        return self.predict(pairs, batch_size=batch_size)

    def predict_user_item_pair(self, user_ids, item_ids,
                               batch_size: int = 1024
                               ) -> List[Tuple[int, int, int, float]]:
        """(user, item, predicted_class, probability) per pair; classes are
        1-based like the reference."""
        probs = self._pair_probs(np.asarray(user_ids), np.asarray(item_ids),
                                 batch_size)
        cls = np.argmax(probs, axis=-1)
        return [(int(u), int(i), int(c) + 1, float(p[c]))
                for u, i, c, p in zip(user_ids, item_ids, cls, probs)]

    def recommend_for_user(self, user_ids, item_ids, max_items: int = 5,
                           batch_size: int = 1024):
        """Top-N items per user, ranked by (class desc, probability desc)."""
        preds = self.predict_user_item_pair(user_ids, item_ids, batch_size)
        by_user: Dict[int, List] = {}
        for u, i, c, p in preds:
            by_user.setdefault(u, []).append((i, c, p))
        out = {}
        for u, items in by_user.items():
            items.sort(key=lambda t: (-t[1], -t[2]))
            out[u] = items[:max_items]
        return out

    def recommend_for_item(self, user_ids, item_ids, max_users: int = 5,
                           batch_size: int = 1024):
        preds = self.predict_user_item_pair(user_ids, item_ids, batch_size)
        by_item: Dict[int, List] = {}
        for u, i, c, p in preds:
            by_item.setdefault(i, []).append((u, c, p))
        out = {}
        for i, users in by_item.items():
            users.sort(key=lambda t: (-t[1], -t[2]))
            out[i] = users[:max_users]
        return out
