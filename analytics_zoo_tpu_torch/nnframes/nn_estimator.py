"""NNFrames (counterpart of ``analytics_zoo_tpu/nnframes/nn_estimator.py``):
Spark-ML style estimators over pandas DataFrames.

``fit`` stacks the feature columns into one float32 array
(``feature.column_matrix``: array-valued cells such as images stack whole)
and the label column beside it, trains the model through the
:class:`~analytics_zoo_tpu_torch.estimator.Estimator` and returns an
:class:`NNModel`, whose ``transform`` appends a prediction column. The
setters are the JAX package's.

The device is the card unless the constructor is given ``device="cpu"``;
without a card the constructor raises ``NoCudaDeviceError``.
``NNImageReader.read_images`` reads an image folder into a DataFrame.
``set_tensorboard`` waits for ``utils/tensorboard.py`` (ROADMAP Queue A
item 5) and raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..common.context import DeviceLike, resolve_device
from ..estimator.estimator import Estimator
from ..feature.featureset import FeatureSet, MemoryType, column_matrix
from ..keras import objectives, optimizers as opt_mod


class NNEstimator:
    def __init__(self, model, criterion="mse",
                 features_col: Union[str, Sequence[str]] = "features",
                 label_col: str = "label", device: DeviceLike = None):
        self.model = model
        self.criterion = criterion
        self.features_col = features_col
        self.label_col = label_col
        self.device = resolve_device(device)
        self.batch_size = 32
        self.max_epoch = 1
        self.optimizer = "adam"
        self.learning_rate: Optional[float] = None
        self.cache_level = MemoryType.DRAM
        self.validation: Optional[tuple] = None
        self._ckpt: Optional[tuple] = None

    # -- Spark-ML param surface -----------------------------------------------

    def set_batch_size(self, n: int) -> "NNEstimator":
        self.batch_size = n
        return self

    def set_max_epoch(self, n: int) -> "NNEstimator":
        self.max_epoch = n
        return self

    def set_optim_method(self, optimizer) -> "NNEstimator":
        self.optimizer = optimizer
        return self

    def set_learning_rate(self, lr: float) -> "NNEstimator":
        self.learning_rate = lr
        return self

    def set_data_cache_level(self, level) -> "NNEstimator":
        self.cache_level = MemoryType[level.upper()] \
            if isinstance(level, str) else level
        return self

    def set_validation(self, df, trigger=None) -> "NNEstimator":
        self.validation = (df, trigger)
        return self

    def set_tensorboard(self, log_dir: str, app_name: str) -> "NNEstimator":
        raise NotImplementedError(
            "set_tensorboard needs utils/tensorboard.py, which is not "
            "ported yet: ROADMAP Queue A item 5")

    def set_checkpoint(self, path: str, trigger=None) -> "NNEstimator":
        self._ckpt = (path, trigger)
        return self

    # -- fit ------------------------------------------------------------------

    def _label_array(self, df) -> np.ndarray:
        y = df[self.label_col].to_numpy()
        if len(y) and isinstance(y[0], (list, tuple, np.ndarray)):
            return np.stack([np.asarray(v, np.float32) for v in y])
        return y.astype(np.float32)

    def _make_estimator(self) -> Estimator:
        opt = self.optimizer
        if isinstance(opt, str):
            opt = opt_mod.get(opt, learning_rate=self.learning_rate)
        return Estimator(self.model, objectives.get(self.criterion), opt,
                         device=self.device)

    def fit(self, df) -> "NNModel":
        x = column_matrix(df, self.features_col)
        y = self._label_array(df)
        fs = FeatureSet.from_ndarrays(x, y, memory_type=self.cache_level)
        est = self._make_estimator()
        if self._ckpt:
            est.set_checkpoint(*self._ckpt)
        val_fs = None
        val_trigger = None
        if self.validation is not None:
            vdf, val_trigger = self.validation
            val_fs = FeatureSet.from_ndarrays(
                column_matrix(vdf, self.features_col),
                self._label_array(vdf))
        est.train(fs, batch_size=self.batch_size, epochs=self.max_epoch,
                  validation_set=val_fs, validation_trigger=val_trigger)
        return self._make_model(est)

    def _make_model(self, est: Estimator) -> "NNModel":
        return NNModel(self.model, est, self.features_col)


class NNModel:
    """A fitted transformer: ``transform`` appends ``prediction``."""

    def __init__(self, model, estimator: Estimator,
                 features_col: Union[str, Sequence[str]] = "features",
                 prediction_col: str = "prediction"):
        self.model = model
        self.estimator = estimator
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.batch_size = 32

    def set_batch_size(self, n: int) -> "NNModel":
        self.batch_size = n
        return self

    def set_prediction_col(self, c: str) -> "NNModel":
        self.prediction_col = c
        return self

    def _predict_array(self, df) -> np.ndarray:
        x = column_matrix(df, self.features_col)
        return np.asarray(self.estimator.predict(x,
                                                 batch_size=self.batch_size))

    def transform(self, df):
        preds = self._predict_array(df)
        out = df.copy()
        out[self.prediction_col] = (list(preds) if preds.ndim > 1
                                    else preds.tolist())
        return out

    def save(self, path: str) -> None:
        self.estimator.save_checkpoint(path)

    def load_weights(self, path: str) -> None:
        self.estimator.load_checkpoint(path)


class NNClassifier(NNEstimator):
    """Classification: integer labels, the argmax of the predicted
    probabilities."""

    def __init__(self, model, criterion="sparse_categorical_crossentropy",
                 features_col="features", label_col="label",
                 device: DeviceLike = None):
        super().__init__(model, criterion, features_col, label_col, device)

    def _make_model(self, est: Estimator) -> "NNClassifierModel":
        return NNClassifierModel(self.model, est, self.features_col)


class NNClassifierModel(NNModel):
    def transform(self, df):
        probs = self._predict_array(df)
        out = df.copy()
        out[self.prediction_col] = np.argmax(probs, axis=-1).astype(float)
        return out


class NNImageReader:
    """Read an image folder into a DataFrame of decoded image arrays
    (reference ``NNImageReader.scala``: the image schema DataFrame)."""

    @staticmethod
    def read_images(path: str, resize_h: Optional[int] = None,
                    resize_w: Optional[int] = None, with_label: bool = False):
        """``image`` (float32 HWC, BGR), ``origin`` (the file's path) and,
        with ``with_label``, ``label`` (``ImageSet.read``'s one-based
        alphabetical class labels) columns; each image resized to
        ``resize_h`` x ``resize_w`` when both are given."""
        import pandas as pd
        from ..feature.image import ImageSet, Resize
        iset = ImageSet.read(path, with_label=with_label)
        if resize_h and resize_w:
            iset = iset.transform(Resize(resize_h, resize_w))
        data = {"image": [np.asarray(i, np.float32) for i in iset.images],
                "origin": iset.paths}
        if with_label:
            data["label"] = iset.labels
        return pd.DataFrame(data)
