"""Host datasets and the host-to-card batch feed."""
from .featureset import FeatureSet

__all__ = ["FeatureSet"]
