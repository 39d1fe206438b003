"""Recommendation models."""
from .ncf import NeuralCF
from .wide_and_deep import (ColumnFeatureInfo, WideAndDeep, cross_columns,
                            features_from_dataframe)

__all__ = ["ColumnFeatureInfo", "NeuralCF", "WideAndDeep", "cross_columns",
           "features_from_dataframe"]
