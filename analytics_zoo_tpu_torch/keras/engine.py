"""Keras-style model engine (counterpart of ``analytics_zoo_tpu/keras/
engine.py``): layers, symbolic inputs, the functional ``Model`` and
``Sequential``.

In the JAX package a layer is a stateless config whose parameters live in
an external pytree. Here a :class:`Layer` is an ``nn.Module`` that owns its
parameters once built: :meth:`Layer.build` draws them from an explicit
``torch.Generator`` onto an explicit device. A :class:`Model` registers each
layer under its name, so ``state_dict()`` keys read ``"<layer>.<param>"``,
the JAX package's params tree flattened (``mlp_dense_0.kernel``).

Graph building is the JAX package's: calling a layer on a
:class:`SymbolicTensor` records a :class:`Node`; the model orders the nodes
topologically and runs them in that order.

Training is the JAX package's too: ``compile`` then ``fit``, ``evaluate``
and ``predict`` delegate to an :class:`~analytics_zoo_tpu_torch.estimator.
Estimator`, which runs on the card unless ``device="cpu"`` is passed.
Training mode is ``nn.Module.train()``; dropout draws from one explicit
``torch.Generator`` on the model's device, which the Estimator hands to
every layer through :meth:`set_dropout_generator`.
"""
from __future__ import annotations

import copy
import itertools
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..common import file_io
from ..common.context import DeviceLike, resolve_device

Shape = Tuple[Optional[int], ...]

#: file holding ``torch.save(state_dict)`` inside a weights directory
WEIGHTS_FILE = "model.pt"

_name_counters: Dict[str, "itertools.count"] = defaultdict(
    lambda: itertools.count(1))


def _auto_name(cls_name: str) -> str:
    return f"{cls_name.lower()}_{next(_name_counters[cls_name])}"


class Layer(nn.Module):
    """Base layer: ``build`` creates the parameters, ``forward`` computes.
    Called on symbolic tensors it records a graph node instead."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self._auto_named = name is None
        self.name = name or _auto_name(type(self).__name__)
        self.built_shape: Optional[Any] = None
        self.built = False
        #: set on every layer by the model (``set_dropout_generator``)
        self.dropout_generator: Optional[torch.Generator] = None

    def build(self, generator: torch.Generator, input_shape,
              device: torch.device) -> None:
        """Create parameters for ``input_shape`` on ``device``. Default:
        none."""
        self.built = True

    def compute_output_shape(self, input_shape):
        return input_shape

    def __call__(self, inputs, *args, **kwargs):
        syms = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if not any(isinstance(s, SymbolicTensor) for s in syms):
            return super().__call__(inputs, *args, **kwargs)
        if not all(isinstance(s, SymbolicTensor) for s in syms):
            raise TypeError(f"{self.name} called on a mix of symbolic and "
                            f"concrete inputs")
        in_shapes = [s.shape for s in syms]
        shape_arg = (in_shapes if isinstance(inputs, (list, tuple))
                     else in_shapes[0])
        out_shape = self.compute_output_shape(shape_arg)
        return SymbolicTensor(tuple(out_shape), Node(self, list(syms)), 0)


def _scope_names(layers: Sequence[Layer]) -> None:
    """Rename auto-named layers by position within a container, so two
    structurally identical models share parameter keys (the JAX package's
    rule, so both packages name the same layers alike)."""
    counters: Dict[str, int] = defaultdict(int)
    seen = set()
    kept: Dict[str, int] = {}
    for l in layers:
        if not l._auto_named and kept.setdefault(l.name, id(l)) != id(l):
            raise ValueError(
                f"duplicate layer name '{l.name}' from two different layers "
                f"in one container; rename one (names key the state dict)")
    taken = set(kept)
    for layer in layers:
        if id(layer) in seen:
            continue
        seen.add(id(layer))
        cls = type(layer).__name__.lower()
        counters[cls] += 1
        if layer._auto_named:
            while f"{cls}_{counters[cls]}" in taken:
                counters[cls] += 1
            layer.name = f"{cls}_{counters[cls]}"
            layer._auto_named = False
            taken.add(layer.name)


class Node:
    """One application of a layer to symbolic inputs."""

    def __init__(self, layer: Layer, inputs: List["SymbolicTensor"]):
        self.layer = layer
        self.inputs = inputs


class SymbolicTensor:
    """Placeholder tensor in the functional graph."""

    def __init__(self, shape: Shape, node: Optional[Node], index: int = 0):
        self.shape = shape
        self.node = node
        self.index = index

    def __repr__(self):
        return f"<SymbolicTensor {self.shape}>"


class InputLayer(Layer):
    def __init__(self, shape: Shape, name: Optional[str] = None,
                 ids: bool = False):
        super().__init__(name)
        self.shape = (None,) + tuple(shape)
        #: whether the input holds integer ids (which a float array carries
        #: exactly only up to its mantissa)
        self.ids = ids

    def forward(self, inputs):
        return inputs

    def compute_output_shape(self, input_shape):
        return self.shape


def Input(shape: Shape, name: Optional[str] = None,
          ids: bool = False) -> SymbolicTensor:
    """A model input of ``shape`` (batch axis left out); ``ids`` marks one
    that holds integer ids."""
    layer = InputLayer(shape, name, ids)
    return SymbolicTensor(layer.shape, Node(layer, []), 0)


class _TrainableMixin:
    """The compile / fit / evaluate / predict surface and persistence that
    ``Model`` and ``Sequential`` share (the JAX package's
    ``_TrainableMixin``)."""

    @property
    def device(self) -> torch.device:
        for p in itertools.chain(self.parameters(), self.buffers()):
            return p.device
        return torch.device("cpu")

    def set_dropout_generator(self,
                              generator: Optional[torch.Generator]) -> None:
        """Hand ``generator`` to every layer, nested ones included: their
        dropout draws from it and from nothing else."""
        for m in self.modules():
            if isinstance(m, Layer):
                m.dropout_generator = generator

    # -- transfer learning (the JAX package's freeze API) ---------------------

    @property
    def frozen_layers(self) -> frozenset:
        return getattr(self, "_frozen_layers", frozenset())

    def _param_layer_names(self) -> List[str]:
        """Names of the top-level layers that own parameters, in build
        order. An unbuilt ``Model`` reads them from a copy built on the
        CPU (its own weights stay unbuilt); an unbuilt ``Sequential``
        needs its input shape first."""
        model = self
        if not self.built:
            if not isinstance(self, Model):
                raise RuntimeError("model must be built before freeze()")
            model = copy.deepcopy(self).build(device="cpu")
        names: List[str] = []
        for key, _ in model.named_parameters():
            top = key.split(".", 1)[0]
            if top not in names:
                names.append(top)
        return names

    def _all_layer_names(self) -> set:
        """Top-level layer names only: a parameter's state-dict key starts
        with one, so a nested layer's name could never match and freezing
        it would silently do nothing."""
        if isinstance(self, Model):
            return {n.layer.name for n in self._nodes}
        return {layer.name for layer in getattr(self, "layers", [])}

    def freeze(self, names: Optional[Sequence[str]] = None) -> "Layer":
        """Freeze the given layers (every layer with parameters if
        ``names`` is None): their parameters get no gradient and no
        optimizer update. An unknown name raises ``ValueError``."""
        if names is None:
            names = self._param_layer_names()
        elif isinstance(names, str):
            names = [names]
        known = self._all_layer_names()
        try:
            known |= set(self._param_layer_names())
        except RuntimeError:
            pass  # unbuilt Sequential: layer names only
        unknown = set(names) - known
        if unknown:
            # a typo here would silently leave a backbone trainable
            raise ValueError(f"freeze: unknown layer name(s) "
                             f"{sorted(unknown)}; known layers: "
                             f"{sorted(known)}")
        self._frozen_layers = frozenset(self.frozen_layers | set(names))
        return self

    def unfreeze(self, names: Optional[Sequence[str]] = None) -> "Layer":
        """Unfreeze the given layers (all if None)."""
        if names is None:
            self._frozen_layers = frozenset()
        else:
            if isinstance(names, str):
                names = [names]
            self._frozen_layers = frozenset(self.frozen_layers - set(names))
        return self

    def trainable_param_names(self) -> List[str]:
        return [n for n in self._param_layer_names()
                if n not in self.frozen_layers]

    # -- training (delegates to the Estimator, as in the JAX package) ---------

    def compile(self, optimizer, loss, metrics: Optional[List] = None):
        from . import objectives
        from . import optimizers as opt_mod
        self.loss_fn = objectives.get(loss)
        self.optimizer = opt_mod.get(optimizer)
        self.metric_specs = list(metrics or [])
        self._estimator = None

    def get_estimator(self, device: DeviceLike = None):
        """The compiled model's Estimator, made on ``device`` (the card when
        omitted) at first use; a later ``device`` moves it there."""
        from ..estimator import Estimator
        if not hasattr(self, "loss_fn"):
            raise RuntimeError(
                "call compile(optimizer, loss) before fit/evaluate")
        if self._estimator is None:
            self._estimator = Estimator(self, self.loss_fn, self.optimizer,
                                        self.metric_specs, device=device)
        elif device is not None:
            self._estimator.to(device)
        return self._estimator

    def set_checkpoint(self, path: str, trigger=None) -> None:
        self._ckpt = (path, trigger)

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float) -> None:
        self._clip = ("l2", clip_norm)

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float) -> None:
        self._clip = ("const", (min_value, max_value))

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, featureset=None, device: DeviceLike = None,
            **kwargs):
        """Train on ``x``/``y`` arrays (or a ``FeatureSet``) through the
        Estimator, with the checkpoint and gradient clipping set on this
        model; other keywords (``steps_per_dispatch``, triggers) go to
        ``Estimator.train``. Returns ``{"loss_history", "iterations"}``."""
        from ..feature import FeatureSet
        nb_epoch = kwargs.pop("epochs", nb_epoch)
        est = self.get_estimator(device)
        if hasattr(self, "_ckpt"):
            est.set_checkpoint(*self._ckpt)
        if hasattr(self, "_clip"):
            est.set_gradient_clipping(self._clip)
        if featureset is None:
            featureset = (x if isinstance(x, FeatureSet)
                          else FeatureSet.from_ndarrays(x, y))
        if validation_data is not None and not isinstance(validation_data,
                                                          FeatureSet):
            validation_data = FeatureSet.from_ndarrays(*validation_data)
        return est.train(featureset, batch_size=batch_size, epochs=nb_epoch,
                         validation_set=validation_data, **kwargs)

    def evaluate(self, x, y=None, batch_size: int = 32, featureset=None,
                 device: DeviceLike = None) -> Dict[str, float]:
        from ..feature import FeatureSet
        est = self.get_estimator(device)
        if featureset is None:
            featureset = (x if isinstance(x, FeatureSet)
                          else FeatureSet.from_ndarrays(x, y))
        return est.evaluate(featureset, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32, device: DeviceLike = None):
        """Forward ``x`` in batches. A compiled model predicts through its
        Estimator; an uncompiled one on ``device``, else on the device its
        built parameters live on, else on the card."""
        from ..estimator import Estimator
        if hasattr(self, "loss_fn"):
            est = self.get_estimator(device)
        else:
            if device is None and self.built:
                device = self.device
            est = Estimator(self, None, None, device=device)
        return est.predict(x, batch_size=batch_size)

    # -- persistence ----------------------------------------------------------

    def save_model(self, path: str) -> None:
        """Write ``torch.save(state_dict)`` (CPU tensors) to
        ``<path>/model.pt``. A model never built is built first with the
        default seed, as the JAX package saves a fresh model's init."""
        if not self.built:
            self.build(device="cpu")
        file_io.makedirs(path, exist_ok=True)
        state = {k: v.detach().cpu() for k, v in self.state_dict().items()}
        dst = file_io.join(path, WEIGHTS_FILE)
        tmp = dst + f".tmp{os.getpid()}"
        torch.save(state, tmp)
        file_io.replace(tmp, dst)

    def load_weights(self, path: str) -> None:
        """Load a :meth:`save_model` directory into this (built) model, onto
        the device its parameters live on."""
        if not self.built:
            raise RuntimeError("build the model before load_weights")
        state = torch.load(file_io.join(path, WEIGHTS_FILE),
                           map_location=self.device, weights_only=True)
        self.load_state_dict(state, strict=True)


class Model(_TrainableMixin, Layer):
    """Functional graph model: layers run in topological order, each node
    fed the outputs of the nodes it was called on."""

    def __init__(self, inputs, outputs, name: Optional[str] = None):
        super().__init__(name)
        self.inputs: List[SymbolicTensor] = (
            list(inputs) if isinstance(inputs, (list, tuple)) else [inputs])
        self.outputs: List[SymbolicTensor] = (
            list(outputs) if isinstance(outputs, (list, tuple))
            else [outputs])
        self._single_output = not isinstance(outputs, (list, tuple))
        self._nodes = self._topo_sort()
        _scope_names([n.layer for n in self._nodes])
        for node in self._nodes:
            layer = node.layer
            if not isinstance(layer, InputLayer) \
                    and layer.name not in self._modules:
                self.add_module(layer.name, layer)

    def _topo_sort(self) -> List[Node]:
        order: List[Node] = []
        seen = set()

        def visit(node: Node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for sym in node.inputs:
                if sym.node is not None:
                    visit(sym.node)
            order.append(node)

        for out in self.outputs:
            visit(out.node)
        return order

    def build(self, generator: Optional[torch.Generator] = None,
              input_shape=None, device: DeviceLike = None) -> "Model":
        """Create every layer's parameters, in topological order, from
        ``generator`` (seed 0 when omitted) on ``device`` (the card when
        omitted; ``"cpu"`` must be asked for)."""
        dev = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for node in self._nodes:
            layer = node.layer
            if layer.built or isinstance(layer, InputLayer):
                continue
            in_shapes = [s.shape for s in node.inputs]
            shape_arg = in_shapes[0] if len(in_shapes) == 1 else in_shapes
            layer.build(gen, shape_arg, dev)
            layer.built_shape = shape_arg
        self.built_shape = input_shape
        self.built = True
        return self

    def _node_by_layer_name(self, name: str) -> Node:
        for node in self._nodes:
            if node.layer.name == name:
                return node
        raise KeyError(f"no layer named '{name}'; have "
                       f"{[n.layer.name for n in self._nodes]}")

    def freeze_up_to(self, names) -> "Model":
        """Freeze every layer from the inputs up to and including the named
        layers (reference ``freezeUpTo``)."""
        names = [names] if isinstance(names, str) else list(names)
        seen: set = set()

        def visit(node: Node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for sym in node.inputs:
                if sym.node is not None:
                    visit(sym.node)

        for name in names:
            visit(self._node_by_layer_name(name))
        param_names = set(self._param_layer_names())
        return self.freeze([n.layer.name for n in self._nodes
                            if id(n) in seen and n.layer.name in param_names])

    def forward(self, inputs):
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if len(xs) != len(self.inputs):
            raise ValueError(f"model expects {len(self.inputs)} inputs, "
                             f"got {len(xs)}")
        values: Dict[int, Any] = {}
        for sym, x in zip(self.inputs, xs):
            values[id(sym.node)] = (x,)
        for node in self._nodes:
            if id(node) in values:
                continue
            args = [values[id(s.node)][s.index] for s in node.inputs]
            out = node.layer(args[0] if len(args) == 1 else args)
            values[id(node)] = (tuple(out) if isinstance(out, (list, tuple))
                                else (out,))
        outs = [values[id(o.node)][o.index] for o in self.outputs]
        return outs[0] if self._single_output else outs


class Sequential(_TrainableMixin, Layer):
    """A linear stack of layers (the JAX package's ``Sequential``). The
    first layer takes the model's input as it comes, a list of arrays
    included (BERT's four-array pack)."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.layers: List[Layer] = []
        for layer in (layers or []):
            self.add(layer)

    def add(self, layer: Layer) -> "Sequential":
        self.layers.append(layer)
        _scope_names(self.layers)
        for l in self.layers:
            if l.name not in self._modules:
                self.add_module(l.name, l)
        return self

    def build(self, generator: Optional[torch.Generator] = None,
              input_shape=None, device: DeviceLike = None) -> "Sequential":
        """Create every layer's parameters in order, each for the shape the
        layers before it give, from ``generator`` (seed 0 when omitted) on
        ``device`` (the card when omitted). ``input_shape`` is the input's
        shape with ``None`` for the batch, or a list of them."""
        if input_shape is None:
            raise ValueError("a Sequential builds from its input shape: "
                             "pass input_shape, or fit/predict first")
        dev = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        shape = input_shape
        for layer in self.layers:
            if not layer.built:
                layer.build(gen, shape, dev)
                layer.built_shape = shape
            shape = layer.compute_output_shape(shape)
        self.built_shape = input_shape
        self.built = True
        return self

    def forward(self, inputs):
        x = inputs
        for layer in self.layers:
            x = layer(x)
        return x

    def compute_output_shape(self, input_shape):
        shape = input_shape
        for layer in self.layers:
            shape = layer.compute_output_shape(shape)
        return shape
