"""Image models: the classifier zoo."""
from .imageclassification import (IMAGENET_MEAN, IMAGENET_STD, RESNET_BLOCKS,
                                  ImageClassifier, densenet, inception_v1,
                                  mobilenet, resnet, squeezenet, vgg)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "ImageClassifier",
           "RESNET_BLOCKS", "densenet", "inception_v1", "mobilenet",
           "resnet", "squeezenet", "vgg"]
