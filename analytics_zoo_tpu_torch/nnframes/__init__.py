"""NNFrames: estimators over pandas DataFrames."""
from .nn_estimator import (NNClassifier, NNClassifierModel, NNEstimator,
                           NNImageReader, NNModel)

__all__ = ["NNClassifier", "NNClassifierModel", "NNEstimator",
           "NNImageReader", "NNModel"]
