"""Image classification zoo (counterpart of ``analytics_zoo_tpu/models/image/
imageclassification.py``): the ResNet, MobileNet-v1, Inception-v1, VGG,
SqueezeNet and DenseNet builders in the port's Keras-style layers, and the
``ImageClassifier`` zoo model over any of them.

Layer names, parameter names and kernel layouts are the JAX package's, so
the state dict of a model here is the JAX package's params tree and its
model state (the BatchNorm statistics) flattened: ``from_jax_params`` of
both, merged, loads strictly. Activations are NHWC; the convolutions run
on cuDNN (``keras/layers/conv.py``).

``ImageClassifier`` carries its preprocessing chain (``preprocessing_spec``,
saved in a pretrained bundle) and labels ``predict_image_set``'s top-k
through its label map.

``resnet(dataflow="int8")`` swaps the backbone for
:class:`Int8DataflowBackbone` (int8 tensors between layers,
``ops/int8_dataflow.py``); ``resnet(int8_training=True)`` keeps the layers
and runs every convolution int8 (``Convolution2D(int8_training=True)``).

Not ported yet, and raising ``NotImplementedError``:
``load_pretrained_torch``, which needs ``net/torch_import.py`` (ROADMAP
Queue A item 6).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..common import ZooModel, register_zoo_model
from ...keras import Input, Layer, Model
from ...keras.layers import (
    Activation, AveragePooling2D, BatchNormalization, Convolution2D, Dense,
    Dropout, Flatten, GlobalAveragePooling2D, MaxPooling2D, merge)

#: the stage table of each ResNet depth (blocks a stage)
RESNET_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

#: ImageNet statistics in pixel units
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32) * 255.0
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32) * 255.0


class _ImagenetNormalize(Layer):
    """``(float32(x) - mean) / std`` over the channels: the JAX package's
    preprocess ``Lambda``. The statistics are buffers made on the model's
    device at build and kept out of the state dict, so a forward copies
    nothing from the host."""

    def build(self, generator, input_shape, device):
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN,
                                                  device=device),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD,
                                                 device=device),
                             persistent=False)
        self.built = True

    def forward(self, inputs):
        return (inputs.to(torch.float32) - self.mean) / self.std


def _input_preprocess(x, mode: Optional[str]):
    """Optional normalization on the device: ``"imagenet_uint8"`` takes raw
    pixels (uint8, or any dtype) and gives f32, so a model fed uint8 runs
    in f32 even under an Estimator's bf16 ``compute_dtype``, which casts
    float inputs only (as in the JAX package)."""
    if mode is None:
        return x
    if mode == "imagenet_uint8":
        return _ImagenetNormalize(name="preprocess")(x)
    raise ValueError(f"unknown preprocess mode {mode!r}")


def _conv_bn(x, filters, k, stride=1, activation="relu", name="",
             border_mode="same", int8=False):
    x = Convolution2D(filters, k, k, subsample=(stride, stride),
                      border_mode=border_mode, bias=False,
                      int8_training=int8, name=f"{name}_conv")(x)
    x = BatchNormalization(exact_statistics=int8, name=f"{name}_bn")(x)
    if activation:
        x = Activation(activation, name=f"{name}_act")(x)
    return x


def _basic_block(x, filters, stride, name, pad3="same", int8=False):
    shortcut = x
    y = _conv_bn(x, filters, 3, stride, "relu", f"{name}_a", pad3, int8)
    y = _conv_bn(y, filters, 3, 1, None, f"{name}_b", pad3, int8)
    if stride != 1 or x.shape[-1] != filters:
        shortcut = _conv_bn(x, filters, 1, stride, None, f"{name}_sc",
                            int8=int8)
    return Activation("relu", name=f"{name}_out")(
        merge([y, shortcut], mode="sum"))


def _bottleneck_block(x, filters, stride, name, pad3="same", int8=False):
    shortcut = x
    y = _conv_bn(x, filters, 1, 1, "relu", f"{name}_a", int8=int8)
    y = _conv_bn(y, filters, 3, stride, "relu", f"{name}_b", pad3, int8)
    y = _conv_bn(y, filters * 4, 1, 1, None, f"{name}_c", int8=int8)
    if stride != 1 or x.shape[-1] != filters * 4:
        shortcut = _conv_bn(x, filters * 4, 1, stride, None, f"{name}_sc",
                            int8=int8)
    return Activation("relu", name=f"{name}_out")(
        merge([y, shortcut], mode="sum"))


class _Int8ConvState(nn.Module):
    """One conv of the int8 backbone: ``kernel`` (HWIO), ``gamma`` and
    ``beta`` parameters; ``mid_amax``, ``out_amax``, ``running_mean`` and
    ``running_var`` buffers."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 state: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(v))
        for k, v in state.items():
            self.register_buffer(k, v)


class _AmaxState(nn.Module):
    """A residual add's ``out_amax`` buffer."""

    def __init__(self, out_amax: torch.Tensor):
        super().__init__()
        self.register_buffer("out_amax", out_amax)


class Int8DataflowBackbone(Layer):
    """The whole ResNet backbone with int8 tensors between layers (delayed
    scaling, one autograd function over the backbone; see
    ``ops/int8_dataflow.py``). One layer, because its int8 edges carry
    (int8, scale) pairs the layer graph does not thread.

    Its parameters and state are the JAX package's nested trees as
    submodules: ``<conv>.kernel``, ``.gamma``, ``.beta`` (parameters),
    ``in_amax``, ``<conv>.mid_amax``, ``.out_amax``, ``.running_mean``,
    ``.running_var`` and ``<block>_add.out_amax`` (buffers, the model
    state). A training forward moves the state, as ``BatchNormalization``
    moves its statistics."""

    #: the statistics are the batch's, per rank (see ``norm.SYNC_BN_TODO``)
    batch_statistics = True

    def __init__(self, depth: int, input_shape: Tuple[int, int, int],
                 name: Optional[str] = None):
        super().__init__(name)
        from ...ops.int8_dataflow import Int8ResNetDataflow
        self._flow = Int8ResNetDataflow(depth, input_shape)

    def build(self, generator, input_shape, device):
        params, state = self._flow.init(generator, device)
        self.register_buffer("in_amax", state.pop("in_amax"))
        for name, st in state.items():
            self.add_module(name, _AmaxState(st["out_amax"])
                            if name.endswith("_add")
                            else _Int8ConvState(params[name], st))
        self.built = True

    def _trees(self):
        params, state = {}, {"in_amax": self.in_amax}
        for name, m in self.named_children():
            state[name] = dict(m.named_buffers())
            if isinstance(m, _Int8ConvState):
                params[name] = dict(m.named_parameters())
        return params, state

    def forward(self, inputs):
        params, state = self._trees()
        from ...parallel.mesh import default_mesh
        mesh = default_mesh()
        if self.training and mesh is not None and mesh.size > 1:
            from ...keras.layers.norm import SYNC_BN_TODO
            raise NotImplementedError(SYNC_BN_TODO.format(ranks=mesh.size))
        feats, new_state = self._flow.apply(params, state, inputs,
                                            self.training)
        if self.training:
            with torch.no_grad():
                self.in_amax.copy_(new_state["in_amax"])
                for name, m in self.named_children():
                    for k, buf in m.named_buffers():
                        buf.copy_(new_state[name][k])
        return feats

    def compute_output_shape(self, input_shape):
        h, w = input_shape[1], input_shape[2]
        return (input_shape[0], -(-h // 32), -(-w // 32),
                self._flow.out_channels)


def resnet(depth: int = 50, num_classes: int = 1000,
           input_shape: Tuple[int, int, int] = (224, 224, 3),
           include_top: bool = True,
           preprocess: Optional[str] = None,
           padding_mode: str = "same",
           int8_training: bool = False,
           dataflow: Optional[str] = None) -> Model:
    """ResNet-v1 (18/34/50/101/152): basic blocks below 50, bottlenecks
    from 50. ``padding_mode="torch"`` pads the stride-2 convs and the stem
    pool symmetrically (torchvision's geometry) where SAME pads one more
    after than before. ``int8_training`` runs every convolution int8 by
    int8 with straight-through gradients; ``dataflow="int8"`` swaps the
    backbone for :class:`Int8DataflowBackbone` (its own SAME-padded int8
    convolutions throughout, so it takes neither of the other two)."""
    if depth not in RESNET_BLOCKS:
        raise ValueError(f"unsupported depth {depth}; have "
                         f"{sorted(RESNET_BLOCKS)}")
    if dataflow == "int8":
        if padding_mode != "same" or int8_training:
            raise ValueError(
                "dataflow='int8' uses its own backbone (SAME padding, int8 "
                "convs throughout); it composes with neither "
                "padding_mode='torch' nor the per-layer int8_training flag")
        inp = Input(input_shape, name="image")
        x = _input_preprocess(inp, preprocess)
        x = Int8DataflowBackbone(depth, input_shape,
                                 name="int8_backbone")(x)
        if not include_top:
            return Model(inp, x, name=f"resnet{depth}_int8_features")
        x = GlobalAveragePooling2D(name="avg_pool")(x)
        out = Dense(num_classes, activation="softmax", name="logits")(x)
        return Model(inp, out, name=f"resnet{depth}_int8")
    if dataflow is not None:
        raise ValueError(f"unknown dataflow mode {dataflow!r}")
    torch_geo = padding_mode == "torch"
    blocks = RESNET_BLOCKS[depth]
    block_fn = _basic_block if depth < 50 else _bottleneck_block
    pad3 = 1 if torch_geo else "same"
    inp = Input(input_shape, name="image")
    x = _input_preprocess(inp, preprocess)
    x = _conv_bn(x, 64, 7, 2, "relu", "stem", 3 if torch_geo else "same",
                 int8=int8_training)
    x = MaxPooling2D((3, 3), strides=(2, 2),
                     border_mode=1 if torch_geo else "same",
                     name="stem_pool")(x)
    filters = 64
    for stage, n in enumerate(blocks):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            x = block_fn(x, filters, stride,
                         f"stage{stage + 1}_block{i + 1}", pad3,
                         int8=int8_training)
        filters *= 2
    if not include_top:
        return Model(inp, x, name=f"resnet{depth}_features")
    x = GlobalAveragePooling2D(name="avg_pool")(x)
    out = Dense(num_classes, activation="softmax", name="logits")(x)
    return Model(inp, out, name=f"resnet{depth}")


def mobilenet(num_classes: int = 1000,
              input_shape: Tuple[int, int, int] = (224, 224, 3),
              alpha: float = 1.0, include_top: bool = True) -> Model:
    """MobileNet-v1: depthwise-separable convs (a depthwise conv is a
    grouped conv with one group a channel)."""
    def dw_sep(x, filters, stride, name):
        cin = x.shape[-1]
        x = Convolution2D(cin, 3, 3, subsample=(stride, stride),
                          border_mode="same", bias=False, groups=cin,
                          name=f"{name}_dw")(x)
        x = BatchNormalization(name=f"{name}_dw_bn")(x)
        x = Activation("relu", name=f"{name}_dw_act")(x)
        return _conv_bn(x, filters, 1, 1, "relu", f"{name}_pw")

    def c(f):
        return max(8, int(f * alpha))

    inp = Input(input_shape, name="image")
    x = _conv_bn(inp, c(32), 3, 2, "relu", "stem")
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    for i, (f, s) in enumerate(cfg):
        x = dw_sep(x, c(f), s, f"block{i + 1}")
    if not include_top:
        return Model(inp, x, name="mobilenet_features")
    x = GlobalAveragePooling2D(name="avg_pool")(x)
    out = Dense(num_classes, activation="softmax", name="logits")(x)
    return Model(inp, out, name="mobilenet")


def inception_v1(num_classes: int = 1000,
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 include_top: bool = True) -> Model:
    """GoogLeNet / Inception-v1: conv + relu, no BatchNorm; each module
    concatenates four branches."""
    def conv(x, filters, k, stride=1, name=""):
        x = Convolution2D(filters, k, k, subsample=(stride, stride),
                          border_mode="same", name=f"{name}_conv")(x)
        return Activation("relu", name=f"{name}_act")(x)

    def module(x, f1, f3r, f3, f5r, f5, fp, name):
        b1 = conv(x, f1, 1, 1, f"{name}_b1")
        b3 = conv(conv(x, f3r, 1, 1, f"{name}_b3r"), f3, 3, 1, f"{name}_b3")
        b5 = conv(conv(x, f5r, 1, 1, f"{name}_b5r"), f5, 5, 1, f"{name}_b5")
        bp = MaxPooling2D((3, 3), strides=(1, 1), border_mode="same",
                          name=f"{name}_pool")(x)
        bp = conv(bp, fp, 1, 1, f"{name}_bp")
        return merge([b1, b3, b5, bp], mode="concat", name=f"{name}_out")

    inp = Input(input_shape, name="image")
    x = conv(inp, 64, 7, 2, "stem1")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="stem1_pool")(x)
    x = conv(x, 64, 1, 1, "stem2a")
    x = conv(x, 192, 3, 1, "stem2b")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="stem2_pool")(x)
    x = module(x, 64, 96, 128, 16, 32, 32, "inc3a")
    x = module(x, 128, 128, 192, 32, 96, 64, "inc3b")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="inc3_pool")(x)
    x = module(x, 192, 96, 208, 16, 48, 64, "inc4a")
    x = module(x, 160, 112, 224, 24, 64, 64, "inc4b")
    x = module(x, 128, 128, 256, 24, 64, 64, "inc4c")
    x = module(x, 112, 144, 288, 32, 64, 64, "inc4d")
    x = module(x, 256, 160, 320, 32, 128, 128, "inc4e")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="inc4_pool")(x)
    x = module(x, 256, 160, 320, 32, 128, 128, "inc5a")
    x = module(x, 384, 192, 384, 48, 128, 128, "inc5b")
    if not include_top:
        return Model(inp, x, name="inception_v1_features")
    x = GlobalAveragePooling2D(name="avg_pool")(x)
    x = Dropout(0.4, name="drop")(x)
    out = Dense(num_classes, activation="softmax", name="logits")(x)
    return Model(inp, out, name="inception_v1")


def vgg(depth: int = 16, num_classes: int = 1000,
        input_shape: Tuple[int, int, int] = (224, 224, 3),
        include_top: bool = True, fc_dim: int = 4096) -> Model:
    """VGG-16/19; ``fc_dim`` sizes the two fully connected layers."""
    cfg = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
    if depth not in cfg:
        raise ValueError(f"unsupported VGG depth {depth}; have {sorted(cfg)}")
    inp = Input(input_shape, name="image")
    x, filters = inp, 64
    for stage, n in enumerate(cfg[depth]):
        for i in range(n):
            x = Convolution2D(min(filters, 512), 3, 3, border_mode="same",
                              activation="relu",
                              name=f"block{stage + 1}_conv{i + 1}")(x)
        x = MaxPooling2D((2, 2), name=f"block{stage + 1}_pool")(x)
        filters *= 2
    if not include_top:
        return Model(inp, x, name=f"vgg{depth}_features")
    x = Flatten(name="flatten")(x)
    x = Dense(fc_dim, activation="relu", name="fc1")(x)
    x = Dropout(0.5, name="fc1_drop")(x)
    x = Dense(fc_dim, activation="relu", name="fc2")(x)
    x = Dropout(0.5, name="fc2_drop")(x)
    out = Dense(num_classes, activation="softmax", name="logits")(x)
    return Model(inp, out, name=f"vgg{depth}")


def squeezenet(num_classes: int = 1000,
               input_shape: Tuple[int, int, int] = (224, 224, 3),
               include_top: bool = True) -> Model:
    """SqueezeNet v1.1: fire modules, a 1x1 squeeze then 1x1 and 3x3
    expands concatenated."""
    def fire(x, squeeze, expand, name):
        s = Convolution2D(squeeze, 1, 1, activation="relu",
                          name=f"{name}_sq")(x)
        e1 = Convolution2D(expand, 1, 1, activation="relu",
                           name=f"{name}_e1")(s)
        e3 = Convolution2D(expand, 3, 3, border_mode="same",
                           activation="relu", name=f"{name}_e3")(s)
        return merge([e1, e3], mode="concat", name=f"{name}_out")

    inp = Input(input_shape, name="image")
    x = Convolution2D(64, 3, 3, subsample=(2, 2), activation="relu",
                      name="stem")(inp)
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool1")(x)
    x = fire(x, 16, 64, "fire2")
    x = fire(x, 16, 64, "fire3")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool3")(x)
    x = fire(x, 32, 128, "fire4")
    x = fire(x, 32, 128, "fire5")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool5")(x)
    x = fire(x, 48, 192, "fire6")
    x = fire(x, 48, 192, "fire7")
    x = fire(x, 64, 256, "fire8")
    x = fire(x, 64, 256, "fire9")
    if not include_top:
        return Model(inp, x, name="squeezenet_features")
    x = Dropout(0.5, name="drop")(x)
    x = Convolution2D(num_classes, 1, 1, activation="relu", name="conv10")(x)
    x = GlobalAveragePooling2D(name="avg_pool")(x)
    out = Activation("softmax", name="probs")(x)
    return Model(inp, out, name="squeezenet")


def densenet(depth: int = 121, num_classes: int = 1000,
             input_shape: Tuple[int, int, int] = (224, 224, 3),
             include_top: bool = True, growth_rate: int = 32) -> Model:
    """DenseNet-121/169: BN, relu, conv (pre-activation); each dense
    layer's output is concatenated onto the feature map."""
    cfg = {121: (6, 12, 24, 16), 169: (6, 12, 32, 32)}
    if depth not in cfg:
        raise ValueError(f"unsupported DenseNet depth {depth}; "
                         f"have {sorted(cfg)}")

    def bn_relu_conv(x, filters, k, name):
        x = BatchNormalization(name=f"{name}_bn")(x)
        x = Activation("relu", name=f"{name}_act")(x)
        return Convolution2D(filters, k, k, border_mode="same", bias=False,
                             name=f"{name}_conv")(x)

    inp = Input(input_shape, name="image")
    x = _conv_bn(inp, 64, 7, 2, "relu", "stem")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="stem_pool")(x)
    channels = 64
    for stage, n in enumerate(cfg[depth]):
        for i in range(n):
            name = f"dense{stage + 1}_{i + 1}"
            y = bn_relu_conv(x, 4 * growth_rate, 1, f"{name}_a")
            y = bn_relu_conv(y, growth_rate, 3, f"{name}_b")
            x = merge([x, y], mode="concat", name=f"{name}_cat")
            channels += growth_rate
        if stage < len(cfg[depth]) - 1:  # a transition halves both
            channels //= 2
            x = bn_relu_conv(x, channels, 1, f"trans{stage + 1}")
            x = AveragePooling2D((2, 2), name=f"trans{stage + 1}_pool")(x)
    x = BatchNormalization(name="final_bn")(x)
    x = Activation("relu", name="final_act")(x)
    if not include_top:
        return Model(inp, x, name=f"densenet{depth}_features")
    x = GlobalAveragePooling2D(name="avg_pool")(x)
    out = Dense(num_classes, activation="softmax", name="logits")(x)
    return Model(inp, out, name=f"densenet{depth}")


_BACKBONES: Dict[str, Callable] = {
    "resnet18": lambda n, s: resnet(18, n, s),
    "resnet34": lambda n, s: resnet(34, n, s),
    "resnet50": lambda n, s: resnet(50, n, s),
    "resnet101": lambda n, s: resnet(101, n, s),
    "resnet152": lambda n, s: resnet(152, n, s),
    "mobilenet": lambda n, s: mobilenet(n, s),
    "inception-v1": lambda n, s: inception_v1(n, s),
    "vgg-16": lambda n, s: vgg(16, n, s),
    "vgg-19": lambda n, s: vgg(19, n, s),
    "squeezenet": lambda n, s: squeezenet(n, s),
    "densenet-121": lambda n, s: densenet(121, n, s),
}


@register_zoo_model
class ImageClassifier(ZooModel):
    """A classifier over any of ``_BACKBONES``, with its label map."""

    def __init__(self, model_name: str = "resnet50", num_classes: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 labels: Optional[List[str]] = None,
                 padding_mode: str = "same"):
        super().__init__()
        if model_name not in _BACKBONES:
            raise ValueError(f"unknown model_name {model_name}; have "
                             f"{sorted(_BACKBONES)}")
        self.model_name = model_name
        self.num_classes = num_classes
        self.input_shape = tuple(input_shape)
        self.labels = labels
        self.padding_mode = padding_mode

    @staticmethod
    def load_label_map(path: str) -> List[str]:
        """A class-index -> name map: a JSON list, a JSON dict keyed by
        index (from 0 or from 1), or plain text with one label a line."""
        import json

        from ...common import file_io
        with file_io.fopen(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except ValueError:
            return [line.strip() for line in text.splitlines() if line.strip()]
        if isinstance(data, dict):
            base = 0 if "0" in data else 1 if "1" in data else None
            if base is None or not all(
                    str(i + base) in data for i in range(len(data))):
                raise ValueError(
                    f"label map dict at {path} is not contiguously indexed "
                    f"from 0 or 1 (got keys like {sorted(data)[:3]}...)")
            return [data[str(i + base)] for i in range(len(data))]
        return list(data)

    def with_label_map(self, path: str) -> "ImageClassifier":
        self.labels = self.load_label_map(path)
        return self

    def load_pretrained_torch(self, module_or_path,
                              padding_mode: str = "torch"):
        raise NotImplementedError(
            "load_pretrained_torch needs net/torch_import.py, which is not "
            "ported yet: ROADMAP Queue A item 6")

    def get_config(self) -> Dict[str, Any]:
        return {"model_name": self.model_name,
                "num_classes": self.num_classes,
                "input_shape": list(self.input_shape),
                "labels": self.labels,
                "padding_mode": self.padding_mode}

    def build_model(self) -> Model:
        if self.model_name.startswith("resnet"):
            return resnet(int(self.model_name[len("resnet"):]),
                          self.num_classes, self.input_shape,
                          padding_mode=self.padding_mode)
        return _BACKBONES[self.model_name](self.num_classes, self.input_shape)

    def default_compile(self):
        self.compile(optimizer="adam",
                     loss="sparse_categorical_crossentropy",
                     metrics=["accuracy"])

    def preprocessing_spec(self):
        """Serializable input chain, persisted in pretrained bundles."""
        from ...feature.image.spec import classification_spec
        h, w, _ = self.input_shape
        return classification_spec(h, w, IMAGENET_MEAN.tolist(),
                                   IMAGENET_STD.tolist())

    def preprocessing(self):
        """The model's input chain (reference per-model configs); a
        bundle-loaded classifier uses the chain it shipped with."""
        return self.bundled_preprocessing()

    def predict_image_set(self, image_set, top_k: int = 5,
                          batch_size: int = 32):
        """Top-k ``(label, probability)`` pairs per image (reference
        ``ImageClassifier.predictImageSet`` with the label map; the class
        index where there is no map), the images run through
        :meth:`preprocessing` first, on the device the model was built on
        (the card when it is not built yet)."""
        fs = image_set.transform(self.preprocessing()).to_featureset(
            shuffle=False)
        model = self._ensure_built()
        probs = np.asarray(model.predict(
            fs, batch_size=batch_size,
            device=model.device if model.built else None))
        top = np.argsort(-probs, axis=1)[:, :top_k]
        out = []
        for row, p in zip(top, probs):
            labeled = [((self.labels[i] if self.labels else int(i)),
                        float(p[i])) for i in row]
            out.append(labeled)
        return out
