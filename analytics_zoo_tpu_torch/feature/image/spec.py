"""Declarative preprocessing specs (counterpart of ``analytics_zoo_tpu/
feature/image/spec.py``): the serializable half of the image transform
chains.

The reference ships per-model preprocessing inside its pretrained artifacts
(``ImageClassificationConfig.scala``, ``ObjectDetectionConfig.scala``: each
variant names its resize/normalize chain). A bundle (``ZooModel.
save_pretrained``) stores the same information as a JSON list of ``{"op":
name, ...kwargs}`` steps, the JAX package's; :func:`build_preprocessing`
turns a spec back into a runnable ``Preprocessing`` chain. Only
deterministic inference-time ops belong in a spec: training augmentations
(random crops, flips) are code, not artifact metadata.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

from .transforms import (AspectScale, CenterCrop, ChannelNormalize,
                         ChannelOrder, Grayscale, ImageSetToSample,
                         MatToFloats, Resize)

SPEC_OPS: Dict[str, type] = {
    "resize": Resize,
    "aspect_scale": AspectScale,
    "center_crop": CenterCrop,
    "channel_normalize": ChannelNormalize,
    "channel_order": ChannelOrder,
    "mat_to_floats": MatToFloats,
    "grayscale": Grayscale,
    "to_sample": ImageSetToSample,
}


def build_preprocessing(spec: Sequence[Dict[str, Any]]):
    """``[{"op": "resize", "height": 224, "width": 224}, ...]`` → chained
    ``Preprocessing``. Returns None for an empty/None spec."""
    if not spec:
        return None
    chain = None
    for step in spec:
        step = dict(step)
        op = step.pop("op")
        if op not in SPEC_OPS:
            raise ValueError(f"unknown preprocessing op {op!r} in bundle "
                             f"spec; supported: {sorted(SPEC_OPS)}")
        t = SPEC_OPS[op](**step)
        chain = t if chain is None else (chain >> t)
    return chain


def classification_spec(height: int, width: int, mean: Sequence[float],
                        std: Sequence[float]) -> List[Dict[str, Any]]:
    """The standard classifier chain (resize → normalize → sample)."""
    return [{"op": "resize", "height": height, "width": width},
            {"op": "channel_normalize", "mean": list(mean),
             "std": list(std)},
            {"op": "to_sample"}]
