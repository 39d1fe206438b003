"""Keras-style model engine (counterpart of ``analytics_zoo_tpu/keras/
engine.py``): layers, symbolic inputs and the functional ``Model``.

In the JAX package a layer is a stateless config whose parameters live in
an external pytree. Here a :class:`Layer` is an ``nn.Module`` that owns its
parameters once built: :meth:`Layer.build` draws them from an explicit
``torch.Generator`` onto an explicit device. A :class:`Model` registers each
layer under its name, so ``state_dict()`` keys read ``"<layer>.<param>"``,
the JAX package's params tree flattened (``mlp_dense_0.kernel``).

Graph building is the JAX package's: calling a layer on a
:class:`SymbolicTensor` records a :class:`Node`; the model orders the nodes
topologically and runs them in that order.
"""
from __future__ import annotations

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
    def __init__(self, shape: Shape, name: Optional[str] = None):
        super().__init__(name)
        self.shape = (None,) + tuple(shape)

    def forward(self, inputs):
        return inputs

    def compute_output_shape(self, input_shape):
        return self.shape


def Input(shape: Shape, name: Optional[str] = None) -> SymbolicTensor:
    layer = InputLayer(shape, name)
    return SymbolicTensor(layer.shape, Node(layer, []), 0)


class Model(Layer):
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

    @property
    def device(self) -> torch.device:
        for p in itertools.chain(self.parameters(), self.buffers()):
            return p.device
        return torch.device("cpu")

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
