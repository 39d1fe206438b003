"""ImageSet (counterpart of ``analytics_zoo_tpu/feature/image/
image_set.py``; reference ``feature/image/ImageSet.scala:140``):
``LocalImageSet``/``DistributedImageSet`` collections, the ``read``
factory, ``transform`` chaining and the lowering to a ``FeatureSet``.

An ImageSet holds host images (a list of HWC arrays, possibly ragged before
a resize). ``to_featureset`` stacks them into the port's ``FeatureSet``,
which feeds the card. On a mesh every rank holds the same FeatureSet and
gathers its own rows of each batch, so a ``DistributedImageSet`` lowers as
a ``LocalImageSet`` does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..featureset import FeatureSet
from ..preprocessing import Preprocessing
from ...common import file_io

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class ImageSet:
    def __init__(self, images: List[np.ndarray],
                 labels: Optional[np.ndarray] = None,
                 paths: Optional[List[str]] = None):
        self.images = list(images)
        self.labels = None if labels is None else np.asarray(labels)
        self.paths = paths

    # -- factories (reference ImageSet.read) ----------------------------------

    @staticmethod
    def read(path: str, with_label: bool = False,
             one_based_label: bool = True) -> "LocalImageSet":
        """Read the images of the directory ``path`` (``.jpg``, ``.jpeg``,
        ``.png``, ``.bmp``, in name order, decoded BGR by ``cv2.imdecode``;
        undecodable files are skipped). With ``with_label``, ``path`` holds
        one subdirectory a class, and a class's label is its place in the
        alphabetical order (from 1 with ``one_based_label``)."""
        import cv2

        def _load(fpath):
            with file_io.fopen(fpath, "rb") as f:
                buf = np.frombuffer(f.read(), np.uint8)
            return cv2.imdecode(buf, cv2.IMREAD_COLOR)

        images, labels, paths = [], [], []
        if with_label:
            classes = sorted(d for d in file_io.listdir(path)
                             if file_io.isdir(file_io.join(path, d)))
            base = 1 if one_based_label else 0
            for ci, cls in enumerate(classes):
                cdir = file_io.join(path, cls)
                for name in sorted(file_io.listdir(cdir)):
                    if not name.lower().endswith(_IMG_EXTS):
                        continue
                    f = file_io.join(cdir, name)
                    img = _load(f)
                    if img is None:
                        continue
                    images.append(img)
                    labels.append(ci + base)
                    paths.append(f)
            return LocalImageSet(images, np.asarray(labels, np.float32), paths)
        for name in sorted(file_io.listdir(path)):
            if not name.lower().endswith(_IMG_EXTS):
                continue
            f = file_io.join(path, name)
            img = _load(f)
            if img is not None:
                images.append(img)
                paths.append(f)
        return LocalImageSet(images, None, paths)

    @staticmethod
    def from_arrays(images: Sequence[np.ndarray],
                    labels: Optional[np.ndarray] = None) -> "LocalImageSet":
        return LocalImageSet(list(images), labels)

    # -- transform chaining ---------------------------------------------------

    def transform(self, preprocessing: Preprocessing) -> "ImageSet":
        out = [preprocessing.apply(img) for img in self.images]
        return type(self)(out, self.labels, self.paths)

    def __len__(self) -> int:
        return len(self.images)

    # -- lowering to the feed -------------------------------------------------

    def to_featureset(self, **kwargs) -> FeatureSet:
        """The images stacked as float32 ``[n, h, w, c]`` with the labels;
        ``kwargs`` go to ``FeatureSet.from_ndarrays`` (``shuffle``,
        ``seed``)."""
        shapes = {np.asarray(i).shape for i in self.images}
        if len(shapes) > 1:
            raise ValueError(
                f"images have mixed shapes {shapes}; apply Resize/Crop "
                "transforms before to_featureset (a batch needs one shape)")
        feats = np.stack([np.asarray(i, np.float32) for i in self.images])
        return FeatureSet.from_ndarrays(feats, self.labels, **kwargs)


class LocalImageSet(ImageSet):
    """Single-host image collection (reference ``LocalImageSet:98``)."""


class DistributedImageSet(ImageSet):
    """Sharded image collection (reference ``DistributedImageSet:119``):
    each rank of a mesh trains on its own rows of every batch of the
    ``FeatureSet`` it lowers into (``transform`` keeps the type)."""
