"""Image records on the host: decoding, transforms, preprocessing specs
and ``ImageSet`` (counterpart of ``analytics_zoo_tpu/feature/image/``;
object detection's ``detection.py`` is not ported yet)."""
from .image_set import (  # noqa: F401
    DistributedImageSet, ImageSet, LocalImageSet)
from .transforms import (  # noqa: F401
    AspectScale, Brightness, CenterCrop, ChannelNormalize, ChannelOrder,
    ChannelScaledNormalizer, ColorJitter, Contrast, Expand, Filler,
    FixedCrop, Grayscale, HFlip, Hue, ImageSetToSample, MatToFloats, Mirror,
    PixelBytesToMat, PixelNormalizer, RandomAspectScale, RandomCrop,
    RandomPreprocessing, RandomResize, RandomTransformer, Resize, Saturation,
    VFlip)
