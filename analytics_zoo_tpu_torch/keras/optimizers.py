"""Optimizers (counterpart of ``analytics_zoo_tpu/keras/optimizers.py``).

The JAX package wraps ``optax`` transformations. Here an :class:`Optimizer`
keeps the same shape, ``init(params) -> state`` and ``step(params, grads,
state)``, over dicts of tensors named as in the ``state_dict``, and updates
the parameters in place with PyTorch's multi-tensor (``_foreach``) ops, a
few launches per step whatever the number of tensors. The arithmetic is
optax's, in optax's order: :func:`Adam` is ``optax.adam`` (``eps`` added
after the bias-corrected square root), :func:`SGD` is ``optax.sgd`` with
optional momentum, Nesterov and weight decay (``add_decayed_weights``),
:func:`Adagrad` is ``optax.adagrad`` (accumulator from 0.1, ``eps`` 1e-7).

``sparse_rows`` is the JAX package's: ``(kind, hyperparameters)`` where the
optimizer's arithmetic has a row-subset form that the Estimator may run on
vocab-sharded tables (``parallel.embedding.apply_row_update``), else None
(momentum, weight decay).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


class Optimizer:
    """Named optimizer: ``init`` builds the state, ``step`` applies one
    update in place. ``learning_rate`` is a float."""

    def __init__(self, name: str, learning_rate: float,
                 init: Callable[[Tensors], Dict[str, Any]],
                 step: Callable[[List[torch.Tensor], List[torch.Tensor],
                                 Dict[str, Any]], None]):
        self.name = name
        self.learning_rate = learning_rate
        self._init = init
        self._step = step
        #: ``(kind, hyperparameters)`` of the row-subset update, or None
        self.sparse_rows: Optional[Tuple[str, Dict[str, float]]] = None

    def init(self, params: Tensors) -> Dict[str, Any]:
        """Zero state for ``params`` (name -> tensor), on their devices."""
        with torch.no_grad():
            return self._init(params)

    def step(self, params: Tensors, grads: Tensors,
             state: Dict[str, Any]) -> None:
        """Update ``params`` and ``state`` in place from ``grads`` (same
        names as ``params``)."""
        names = list(params)
        with torch.no_grad():
            self._step([params[k] for k in names], [grads[k] for k in names],
                       state)


def _zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _slots(state: Dict[str, Any], key: str, n: int) -> List[torch.Tensor]:
    slots = list(state[key].values())
    if len(slots) != n:
        raise ValueError(f"optimizer state holds {len(slots)} '{key}' "
                         f"tensors for {n} parameters")
    return slots


def SGD(learningrate: float = 0.01, momentum: float = 0.0,
        dampening: float = 0.0, nesterov: bool = False,
        weightdecay: float = 0.0) -> Optimizer:
    """``optax.sgd`` (``dampening`` is accepted and, as in the JAX package,
    not applied)."""
    del dampening

    def init(params):
        return {"trace": _zeros(params)} if momentum else {}

    def step(ps, gs, state):
        if weightdecay > 0:
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, weightdecay))
        if momentum:
            trace = _slots(state, "trace", len(ps))
            # optax.trace: t = g + momentum * t; nesterov: g + momentum * t
            torch._foreach_mul_(trace, momentum)
            torch._foreach_add_(trace, gs)
            if nesterov:
                gs = torch._foreach_add(
                    gs, torch._foreach_mul(trace, momentum))
            else:
                gs = trace
        torch._foreach_add_(ps, torch._foreach_mul(gs, -learningrate))

    opt = Optimizer("sgd", learningrate, init, step)
    if momentum == 0.0 and not nesterov and weightdecay == 0.0:
        opt.sparse_rows = ("sgd", {"lr": float(learningrate)})
    return opt


def Adam(learningrate: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8) -> Optimizer:
    """``optax.adam``: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2
    nu``, ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)`` with the bias
    corrections ``1 - b^count`` taken in float32."""

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def step(ps, gs, state):
        mu = _slots(state, "mu", len(ps))
        nu = _slots(state, "nu", len(ps))
        torch._foreach_mul_(mu, beta1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - beta1))
        torch._foreach_mul_(nu, beta2)
        torch._foreach_add_(
            nu, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - beta2))
        state["count"] += 1
        count = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(beta1) ** count)
        bc2 = float(np.float32(1) - np.float32(beta2) ** count)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, epsilon)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -learningrate)
        torch._foreach_add_(ps, upd)

    opt = Optimizer("adam", learningrate, init, step)
    # lazy adam on sharded tables: moments move for touched rows only
    opt.sparse_rows = ("adam", {"lr": float(learningrate),
                                "b1": float(beta1), "b2": float(beta2),
                                "eps": float(epsilon)})
    return opt


def Adagrad(learningrate: float = 1e-2, weightdecay: float = 0.0
            ) -> Optimizer:
    """``optax.adagrad``: ``acc += g^2`` from 0.1, ``p += -lr * g *
    rsqrt(acc + 1e-7)`` (0 where ``acc`` is 0), after optional weight
    decay."""
    eps = 1e-7

    def init(params):
        return {"acc": {k: torch.full_like(v, 0.1)
                        for k, v in params.items()}}

    def step(ps, gs, state):
        if weightdecay > 0:
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, weightdecay))
        acc = _slots(state, "acc", len(ps))
        torch._foreach_add_(acc, torch._foreach_mul(gs, gs))
        for p, g, a in zip(ps, gs, acc):
            inv_rt = torch.where(a > 0, torch.rsqrt(a + eps),
                                 torch.zeros_like(a))
            p.add_((inv_rt * g) * (-learningrate))

    opt = Optimizer("adagrad", learningrate, init, step)
    if weightdecay == 0.0:
        opt.sparse_rows = ("adagrad", {"lr": float(learningrate), "eps": eps})
    return opt


_FACTORIES = {"sgd": SGD, "adam": Adam, "adagrad": Adagrad}


def get(optimizer: Union[str, Optimizer],
        learning_rate: Optional[float] = None) -> Optimizer:
    """Resolve an optimizer by name or instance; ``learning_rate``
    overrides the named factory's default."""
    if isinstance(optimizer, Optimizer):
        return optimizer
    key = str(optimizer).lower()
    if key not in _FACTORIES:
        raise ValueError(f"unknown optimizer '{optimizer}'; have "
                         f"{sorted(_FACTORIES)}")
    factory = _FACTORIES[key]
    return factory() if learning_rate is None else factory(learning_rate)
