"""Model-zoo base classes (counterpart of ``analytics_zoo_tpu/models/
common.py``): ``ZooModel``, ``Recommender`` and the class registry.

A saved model is a directory holding ``zoo_model.json`` (the JAX package's
format, byte for byte) and ``weights/model.pt``, a ``torch.save`` of the
``state_dict`` where the JAX package keeps an orbax checkpoint. A
pretrained bundle (``save_pretrained``) holds ``zoo_bundle.json`` (the JAX
package's: format tag, class, config, label map and preprocessing spec)
beside the same ``weights/``.
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
    def _instantiate_and_load(cls_name: str, config: Dict[str, Any],
                              weights_path: str,
                              device: DeviceLike) -> "ZooModel":
        """Registry lookup -> build on ``device`` -> load the weights."""
        cls = _MODEL_REGISTRY.get(cls_name)
        if cls is None:
            raise ValueError(f"unknown zoo model class {cls_name}; "
                             f"registered: {sorted(_MODEL_REGISTRY)}")
        inst = cls(**config)
        inst.build(device=device)
        inst.model.load_weights(weights_path)
        inst.model.eval()
        return inst

    @staticmethod
    def load_model(path: str, device: DeviceLike = None) -> "ZooModel":
        """Registry lookup -> build on ``device`` (the card when omitted;
        raises without one unless ``device="cpu"``) -> load the weights."""
        with file_io.fopen(file_io.join(path, "zoo_model.json")) as f:
            spec = json.loads(f.read())
        return ZooModel._instantiate_and_load(
            spec["class"], spec["config"], file_io.join(path, "weights"),
            device)

    # -- pretrained bundles ---------------------------------------------------
    #
    # The reference zoo ships loadable pretrained artifacts carrying the
    # model weights and their label map + per-model preprocessing config
    # (ImageClassifier.scala:37 label maps; ObjectDetectionConfig.scala:1
    # per-variant preproc). A bundle is one directory:
    #   zoo_bundle.json   format tag, class, config, labels, preproc spec
    #   weights/          the weights (save_model's layout)

    BUNDLE_FORMAT = "zoo-tpu-bundle/1"

    def preprocessing_spec(self) -> Optional[List[Dict[str, Any]]]:
        """Serializable inference preprocessing (``feature/image/spec.py``);
        None when the model has no canonical input chain."""
        return None

    def save_pretrained(self, path: str) -> None:
        """Write one pretrained artifact: weights, config, label map and
        preprocessing spec."""
        file_io.makedirs(path, exist_ok=True)
        bundle = {
            "format": self.BUNDLE_FORMAT,
            "class": type(self).__name__,
            "config": self.get_config(),
            "labels": getattr(self, "labels", None),
            "preprocessing": self.preprocessing_spec(),
        }
        with file_io.fopen(file_io.join(path, "zoo_bundle.json"), "w") as f:
            f.write(json.dumps(bundle, indent=2))
        self._ensure_built().save_model(file_io.join(path, "weights"))

    @staticmethod
    def load_pretrained(path: str, device: DeviceLike = None) -> "ZooModel":
        """Load a bundle written by :meth:`save_pretrained` onto ``device``
        (as :meth:`load_model`); the model predicts with its labels and
        gives the bundled chain through :meth:`bundled_preprocessing`. A
        directory without a bundle's format tag raises ``ValueError``
        (``load_model`` reads a bare checkpoint)."""
        bundle_path = file_io.join(path, "zoo_bundle.json")
        bundle = {}
        if file_io.exists(bundle_path):
            with file_io.fopen(bundle_path) as f:
                bundle = json.loads(f.read())
        fmt = bundle.get("format")
        if fmt != ZooModel.BUNDLE_FORMAT:
            raise ValueError(f"{path!r} is not a zoo-tpu pretrained bundle "
                             f"(format {fmt!r}); for bare checkpoints use "
                             f"ZooModel.load_model")
        inst = ZooModel._instantiate_and_load(
            bundle["class"], bundle["config"], file_io.join(path, "weights"),
            device)
        if bundle.get("labels") is not None:
            inst.labels = bundle["labels"]
        inst._bundle_preprocessing = bundle.get("preprocessing")
        return inst

    def bundled_preprocessing(self):
        """The preprocessing chain this model was bundled with (else the
        model's own canonical spec's)."""
        from ..feature.image.spec import build_preprocessing
        spec = getattr(self, "_bundle_preprocessing", None)
        if spec is None:
            spec = self.preprocessing_spec()
        return build_preprocessing(spec)


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
