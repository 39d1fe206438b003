"""Host datasets and the host-to-card batch feed."""
from .featureset import FeatureSet, MemoryType, column_matrix

__all__ = ["FeatureSet", "MemoryType", "column_matrix"]
