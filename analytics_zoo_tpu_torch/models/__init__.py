"""Model zoo: ``ZooModel`` persistence and the built-in models."""
from .common import Recommender, ZooModel, register_zoo_model
from .image import ImageClassifier
from .recommendation import NeuralCF, WideAndDeep

__all__ = ["ImageClassifier", "NeuralCF", "Recommender", "WideAndDeep",
           "ZooModel", "register_zoo_model"]
