"""Model zoo: ``ZooModel`` persistence and the built-in models."""
from .common import Recommender, ZooModel, register_zoo_model
from .recommendation import NeuralCF

__all__ = ["NeuralCF", "Recommender", "ZooModel", "register_zoo_model"]
