"""GraphModel: train a computation the user captured whole (counterpart of
``analytics_zoo_tpu/capture/graph_model.py``; ported so far:
``from_loss``).

``GraphModel.from_loss(loss_fn, init_params_fn)`` is the JAX package's
``TFOptimizer.from_loss`` analogue: the user hands over the loss, and
gradients, the optimizer and the loop run in the shared Estimator. In the
JAX package the parameters are a pytree that ``init_params_fn(rng,
sample_x)`` returns; here they are the ``nn.Module`` that
``init_params_fn(generator, sample_x)`` returns, made at first use, and
``loss_fn(module, x, y)`` / ``forward_fn(module, x)`` take that module.
The Estimator is made on the first ``fit``, ``evaluate`` or ``predict``,
on the device it names (the card when omitted); later calls reuse it.
``from_forward``, ``from_flax`` and ``from_haiku`` are not ported.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..common.context import DeviceLike
from ..estimator.estimator import Estimator
from ..feature.featureset import FeatureSet
from ..keras import optimizers as opt_mod


class GraphModel:
    """fit / evaluate / predict over a captured loss."""

    def __init__(self, loss_fn: Callable, init_params_fn: Callable,
                 optimizer="adam", metrics: Optional[Sequence] = None,
                 forward_fn: Optional[Callable] = None):
        self._loss_fn = loss_fn
        self._init_params_fn = init_params_fn
        self._optimizer = opt_mod.get(optimizer)
        self._metrics = metrics
        self._forward_fn = forward_fn
        self.estimator: Optional[Estimator] = None

    @classmethod
    def from_loss(cls, loss_fn: Callable, init_params_fn: Callable,
                  optimizer="adam", metrics: Optional[Sequence] = None,
                  forward_fn: Optional[Callable] = None) -> "GraphModel":
        """``loss_fn(params, x, y) -> scalar`` and
        ``init_params_fn(generator, sample_x) -> params``, an ``nn.Module``
        (on the CPU; the Estimator moves it). Supply ``forward_fn(params, x)
        -> y_pred`` to enable ``predict`` and metric evaluation: the loss
        alone does not define predictions."""
        return cls(loss_fn, init_params_fn, optimizer, metrics, forward_fn)

    def _no_forward(self, params, x):
        raise NotImplementedError(
            "GraphModel.from_loss captured only the loss; pass "
            "forward_fn=... to enable predict()/metric evaluate()")

    def get_estimator(self, device: DeviceLike = None,
                      sample_x=None) -> Estimator:
        """The Estimator, made at first use on ``device`` with the
        parameters ``init_params_fn`` returns for ``sample_x`` (from a
        generator seeded as the Estimator's default); a later ``device``
        moves it there."""
        if self.estimator is None:
            est = Estimator(None, None, self._optimizer, self._metrics,
                            device=device, direct_loss_fn=self._loss_fn,
                            forward_fn=self._forward_fn or self._no_forward)
            est.model = self._init_params_fn(
                torch.Generator().manual_seed(est.seed), sample_x)
            self.estimator = est
        elif device is not None:
            self.estimator.to(device)
        return self.estimator

    @staticmethod
    def _featureset(x, y, featureset) -> FeatureSet:
        if featureset is not None:
            return featureset
        return x if isinstance(x, FeatureSet) else \
            FeatureSet.from_ndarrays(x, y)

    def fit(self, x, y=None, batch_size: int = 32, epochs: int = 1,
            validation_data=None, featureset: Optional[FeatureSet] = None,
            device: DeviceLike = None, **kwargs):
        """Train on ``x`` (and ``y``, or None) through the Estimator;
        returns ``{"loss_history", "iterations"}``."""
        fs = self._featureset(x, y, featureset)
        est = self.get_estimator(device, fs.features)
        if validation_data is not None and not isinstance(validation_data,
                                                          FeatureSet):
            validation_data = FeatureSet.from_ndarrays(*validation_data)
        return est.train(fs, batch_size=batch_size, epochs=epochs,
                         validation_set=validation_data, **kwargs)

    def evaluate(self, x, y=None, batch_size: int = 32,
                 featureset: Optional[FeatureSet] = None,
                 device: DeviceLike = None):
        fs = self._featureset(x, y, featureset)
        return self.get_estimator(device, fs.features).evaluate(
            fs, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32, device: DeviceLike = None):
        return self.get_estimator(device, x).predict(x,
                                                     batch_size=batch_size)

    def get_weights(self):
        """The parameters as the JAX package's host tree of numpy arrays
        (nested dicts; a ``ModuleList`` item under its index)."""
        return self.get_estimator().get_params()

    def set_weights(self, params) -> None:
        self.get_estimator().set_params(params)
