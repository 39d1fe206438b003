"""Image preprocessing ops (counterpart of ``analytics_zoo_tpu/feature/
image/transforms.py``; reference ``zoo/.../feature/image/*.scala``, the
OpenCV-backed transforms of SURVEY §2.2 "ImageSet").

The transforms run on the host CPU over numpy HWC uint8/float arrays (cv2
where it wins, numpy otherwise); the card only sees the stacked batches.
Each op is a ``Preprocessing``, chained with ``>>`` as the reference chains
with ``->``. The random ops draw from their own ``random.Random(seed)``,
as the JAX package's do, so a seeded op makes the same draws there and
here."""
from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

from ..preprocessing import Preprocessing

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is in the image, but stay robust
    cv2 = None


class ImageTransform(Preprocessing):
    """Base: apply(img HWC ndarray) -> HWC ndarray."""

    def apply(self, img):
        raise NotImplementedError


class Resize(ImageTransform):
    def __init__(self, height: int, width: int, interpolation: str = "linear"):
        self.height = height
        self.width = width
        self.interpolation = interpolation

    def apply(self, img):
        if cv2 is not None:
            interp = (cv2.INTER_NEAREST if self.interpolation == "nearest"
                      else cv2.INTER_LINEAR)
            return cv2.resize(np.asarray(img), (self.width, self.height),
                              interpolation=interp)
        # numpy nearest fallback
        img = np.asarray(img)
        ys = (np.arange(self.height) * img.shape[0] / self.height).astype(int)
        xs = (np.arange(self.width) * img.shape[1] / self.width).astype(int)
        return img[ys][:, xs]


class AspectScale(ImageTransform):
    """Scale the short side to ``min_size``, capping the long side
    (reference ``AspectScale.scala``)."""

    def __init__(self, min_size: int, max_size: int = 1000):
        self.min_size = min_size
        self.max_size = max_size

    def apply(self, img):
        h, w = img.shape[:2]
        scale = self.min_size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return Resize(int(round(h * scale)), int(round(w * scale))).apply(img)


class CenterCrop(ImageTransform):
    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def apply(self, img):
        h, w = img.shape[:2]
        y0 = max(0, (h - self.height) // 2)
        x0 = max(0, (w - self.width) // 2)
        return img[y0:y0 + self.height, x0:x0 + self.width]


class RandomCrop(ImageTransform):
    def __init__(self, height: int, width: int, seed: Optional[int] = None):
        self.height = height
        self.width = width
        self._rng = random.Random(seed)

    def apply(self, img):
        h, w = img.shape[:2]
        y0 = self._rng.randint(0, max(0, h - self.height))
        x0 = self._rng.randint(0, max(0, w - self.width))
        return img[y0:y0 + self.height, x0:x0 + self.width]


class FixedCrop(ImageTransform):
    """Crop by absolute or normalized box (reference ``Crop.scala``)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def apply(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        return img[int(y1):int(y2), int(x1):int(x2)]


class HFlip(ImageTransform):
    def apply(self, img):
        return np.ascontiguousarray(img[:, ::-1])


class Brightness(ImageTransform):
    """Add a random delta in [delta_low, delta_high] (reference
    ``Brightness.scala``)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self._rng = random.Random(seed)

    def apply(self, img):
        delta = self._rng.uniform(self.low, self.high)
        return np.asarray(img, np.float32) + delta


class Contrast(ImageTransform):
    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self._rng = random.Random(seed)

    def apply(self, img):
        return np.asarray(img, np.float32) * self._rng.uniform(self.low,
                                                               self.high)


class Saturation(ImageTransform):
    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self._rng = random.Random(seed)

    def apply(self, img):
        f = self._rng.uniform(self.low, self.high)
        img = np.asarray(img, np.float32)
        gray = img.mean(axis=-1, keepdims=True)
        return gray + (img - gray) * f


class Hue(ImageTransform):
    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self._rng = random.Random(seed)

    def apply(self, img):
        delta = self._rng.uniform(self.low, self.high)
        img = np.asarray(img, np.float32)
        if cv2 is None:
            return img
        hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                           cv2.COLOR_BGR2HSV).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] + delta) % 180
        return cv2.cvtColor(hsv.astype(np.uint8),
                            cv2.COLOR_HSV2BGR).astype(np.float32)


class ColorJitter(ImageTransform):
    """Random brightness/contrast/saturation in random order (reference
    ``ColorJitter.scala``)."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)
        self.ops = [Brightness(seed=seed), Contrast(seed=seed),
                    Saturation(seed=seed)]

    def apply(self, img):
        ops = list(self.ops)
        self._rng.shuffle(ops)
        for op in ops:
            img = op.apply(img)
        return img


class Expand(ImageTransform):
    """Place the image on a larger mean-filled canvas (reference
    ``Expand.scala``)."""

    def __init__(self, means: Sequence[float] = (123, 117, 104),
                 max_ratio: float = 4.0, seed: Optional[int] = None):
        self.means = means
        self.max_ratio = max_ratio
        self._rng = random.Random(seed)

    def apply(self, img):
        h, w, c = img.shape
        ratio = self._rng.uniform(1.0, self.max_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.empty((nh, nw, c), np.float32)
        canvas[:] = np.asarray(self.means, np.float32)[:c]
        y0 = self._rng.randint(0, nh - h)
        x0 = self._rng.randint(0, nw - w)
        canvas[y0:y0 + h, x0:x0 + w] = img
        return canvas


class ChannelNormalize(ImageTransform):
    def __init__(self, mean: Sequence[float],
                 std: Sequence[float] = (1, 1, 1)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def apply(self, img):
        return (np.asarray(img, np.float32) - self.mean) / self.std


class ChannelOrder(ImageTransform):
    """BGR↔RGB swap (reference ``ChannelOrder.scala``)."""

    def apply(self, img):
        return np.ascontiguousarray(np.asarray(img)[..., ::-1])


class MatToFloats(ImageTransform):
    """uint8 HWC → float32 (reference ``MatToFloats.scala``)."""

    def apply(self, img):
        return np.asarray(img, np.float32)


class PixelBytesToMat(ImageTransform):
    """Decode encoded image bytes (jpg/png) → HWC array (reference
    ``PixelBytesToMat.scala``/``BytesToMat``)."""

    def apply(self, data):
        buf = np.frombuffer(bytes(data), np.uint8)
        if cv2 is None:
            raise RuntimeError("cv2 unavailable: cannot decode image bytes")
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("undecodable image bytes")
        return img


class RandomPreprocessing(ImageTransform):
    """Apply the wrapped transform with probability p (reference
    ``RandomPreprocessing``)."""

    def __init__(self, transform: ImageTransform, prob: float = 0.5,
                 seed: Optional[int] = None):
        self.transform = transform
        self.prob = prob
        self._rng = random.Random(seed)

    def apply(self, img):
        if self._rng.random() < self.prob:
            return self.transform.apply(img)
        return img


RandomTransformer = RandomPreprocessing  # reference alias


class ImageSetToSample(ImageTransform):
    """Finalize: float32 HWC contiguous (the model-feed record; reference
    ``ImageSetToSample.scala``). Conv layers are NHWC, so no transpose."""

    def apply(self, img):
        return np.ascontiguousarray(np.asarray(img, np.float32))


class VFlip(ImageTransform):
    """Vertical flip (reference ``ImageMirror``'s vertical mode)."""

    def apply(self, img):
        return np.ascontiguousarray(np.asarray(img)[::-1])


Mirror = HFlip  # reference alias (``ImageMirror.scala``)


class Filler(ImageTransform):
    """Fill a normalized-coordinate sub-rectangle with a constant (reference
    ``ImageFiller.scala`` — occlusion augmentation)."""

    def __init__(self, start_x: float, start_y: float, end_x: float,
                 end_y: float, value: float = 255.0):
        if not (0 <= start_x <= end_x <= 1 and 0 <= start_y <= end_y <= 1):
            raise ValueError("filler coords must satisfy "
                             "0 <= start <= end <= 1")
        self.box = (start_x, start_y, end_x, end_y)
        self.value = value

    def apply(self, img):
        img = np.array(img, np.float32, copy=True)
        h, w = img.shape[:2]
        x0, y0, x1, y1 = self.box
        img[int(y0 * h):int(y1 * h), int(x0 * w):int(x1 * w)] = self.value
        return img


class ChannelScaledNormalizer(ImageTransform):
    """Per-channel mean subtract + single global scale (reference
    ``ImageChannelScaledNormalizer.scala``)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 scale: float = 1.0):
        self.mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self.scale = scale

    def apply(self, img):
        return (np.asarray(img, np.float32) - self.mean) * self.scale


class PixelNormalizer(ImageTransform):
    """Subtract a full per-pixel mean image (reference
    ``ImagePixelNormalizer.scala`` — e.g. the ImageNet mean image)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply(self, img):
        img = np.asarray(img, np.float32)
        if img.shape != self.means.shape:
            raise ValueError(f"mean image shape {self.means.shape} != image "
                             f"shape {img.shape}")
        return img - self.means


class RandomResize(ImageTransform):
    """Resize to a size drawn uniformly from [min, max] (reference
    ``ImageRandomResize.scala``)."""

    def __init__(self, min_size: int, max_size: int,
                 seed: Optional[int] = None):
        self.min_size, self.max_size = min_size, max_size
        self._rng = random.Random(seed)

    def apply(self, img):
        size = self._rng.randint(self.min_size, self.max_size)
        return Resize(size, size).apply(img)


class RandomAspectScale(ImageTransform):
    """Scale the short side to a randomly chosen length, capped by
    ``max_size`` on the long side (reference ``RandomAspectScale``)."""

    def __init__(self, scales: Sequence[int], max_size: int = 1000,
                 seed: Optional[int] = None):
        self.scales = list(scales)
        self.max_size = max_size
        self._rng = random.Random(seed)

    def apply(self, img):
        img = np.asarray(img)
        h, w = img.shape[:2]
        target = self._rng.choice(self.scales)
        scale = target / min(h, w)
        if round(scale * float(np.max((h, w)))) > self.max_size:
            scale = self.max_size / float(np.max((h, w)))
        return Resize(int(round(h * scale)),
                      int(round(w * scale))).apply(img)


class Grayscale(ImageTransform):
    """RGB → single-channel luma, kept 3-channel for shape stability."""

    def apply(self, img):
        img = np.asarray(img, np.float32)
        luma = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
        return np.repeat(luma[..., None], img.shape[-1], axis=-1)
