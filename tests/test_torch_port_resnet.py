"""The port's image classifier zoo, its Estimator with ``compute_dtype`` and
NNFrames against the JAX package on the CPU.

Both packages get the same data (numpy, from a seed, as ``bench.py``'s
``bench_resnet50`` makes it: images uniform in [0, 1), integer labels) and
the same weights and running statistics: the JAX model's params and state,
carried across by name with ``convert.from_jax_params``. Forwards agree
within 1e-5 of the output's scale and running statistics within 1e-6 (f32
sums in other orders), except ResNet-50's training-mode forward at 32 x 32:
its last stage normalizes over 4 values a channel (1 x 1 pixels, batch 4),
whose small spread magnifies rounding, so that JAX's own output moves by
5e-5 to 7e-5 when its input moves by 1e-7 (relative, measured on the
CPU). It is held within 1e-3, its statistics within 1e-4.

Training at ``SGD(0.1, momentum=0.9)`` from random weights is chaotic
(measured on the CPU, ResNet-18 at 32 x 32, batch 16): changing JAX's own
initial weights by 1e-7 (relative) moves its third loss by 2e-3 and its
parameters by 7e-2 after three steps. So a free run is held at its losses
(the first two rtol 1e-4, the third 1e-2), and each step is held from the
same state: the port's Estimator steps once from JAX's parameters,
running statistics and momentum trace before step k and must land on
JAX's after it. In f32: the loss within rtol 1e-5, each parameter's update
within 1e-4 in relative L2 (a gradient sums many products that nearly
cancel, so an entry's error is relative to the sum's terms, not to it),
the parameters within 1e-4 and the statistics within 1e-5. In bf16 the
gradients of this model are mostly rounding: JAX's bf16 update is 14-36%
(relative L2) away from the f32 update from the same state, and the port's
13-41%, each in its own direction, so the two bf16 steps are not held to
each other. Each is held to the f32 step from the same state (the port's,
which the f32 case holds to JAX's): the port's bf16 loss, update and
statistics may be at most ``BF16_ERROR_RATIO`` (4) times as far from it as
JAX's are. XLA keeps f32 between fused operations where it may (its
excess-precision default) and the port rounds every layer's output to
bf16, so the port's bf16 error is the larger one at times: up to 2.6 times
JAX's here (the statistics of the third step).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.feature import FeatureSet as JaxFeatureSet
from analytics_zoo_tpu.feature.featureset import (
    column_matrix as jax_column_matrix)
from analytics_zoo_tpu.keras import Input as JaxInput
from analytics_zoo_tpu.keras import Model as JaxModel
from analytics_zoo_tpu.keras import layers as jax_layers
from analytics_zoo_tpu.keras import objectives as jax_objectives
from analytics_zoo_tpu.keras import optimizers as jax_optimizers
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu.nnframes import NNClassifier as JaxNNClassifier
from analytics_zoo_tpu_torch.common.context import NoCudaDeviceError
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.feature import (FeatureSet, MemoryType,
                                             column_matrix)
from analytics_zoo_tpu_torch.keras import Input, Model, optimizers
from analytics_zoo_tpu_torch.keras import layers
from analytics_zoo_tpu_torch.models import ZooModel
from analytics_zoo_tpu_torch.models.image import imageclassification as pic
from analytics_zoo_tpu_torch.nnframes import NNClassifier
from analytics_zoo_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh,
                                                   set_default_mesh)
from torch_port_threads import torch_threads_per_worker  # noqa: F401

LOSS = "sparse_categorical_crossentropy"
#: the training check: ResNet-18, 10 classes, 32 x 32, batch 16 (JAX's
#: 8-device test mesh divides it), 3 steps of SGD(0.1, momentum 0.9)
SIZE, CLASSES, BATCH, STEPS, LR = 32, 10, 16, 3, 0.1
#: the port's bf16 step may be this many times as far from the f32 step as
#: JAX's bf16 step is (see the module docstring)
BF16_ERROR_RATIO = 4.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_built(model):
    """``model``'s JAX init: (params, state) as numpy."""
    return _np(model.build(jax.random.PRNGKey(0)))


def _port_loaded(model, params, state):
    """``model`` (the port's) built on the CPU with JAX's weights and
    state."""
    model.build(device="cpu")
    model.load_state_dict({**from_jax_params(params),
                           **from_jax_params(state)}, strict=True)
    return model


def _images(n, size=SIZE, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, size, size, 3).astype(np.float32),
            rs.randint(0, CLASSES, n).astype(np.float32))


def _jax_forward(model, params, state, x, training=False):
    y, new_state = model.call(params, state, jnp.asarray(x),
                              training=training)
    return np.asarray(y), _np(new_state)


def _assert_forward(port_model, want, x, training=False, tol=1e-5):
    port_model.train(training)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _assert_state(port_model, jax_state, atol=1e-6):
    got = port_model.state_dict()
    for key, value in from_jax_params(jax_state).items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0,
                                   atol=atol, err_msg=key)


def test_resnet_params_and_state_load_strictly_and_agree_in_eval():
    """JAX's params and state, flattened by name, are the port's state dict
    key for key (HWIO kernels, BatchNorm buffers), load strictly, give the
    same eval forward, and read back through the Estimator's model state
    as JAX's state tree."""
    jm = jic.resnet(18, CLASSES, (SIZE, SIZE, 3))
    params, state = _jax_built(jm)
    pm = pic.resnet(18, CLASSES, (SIZE, SIZE, 3)).build(device="cpu")
    assert set(pm.state_dict()) == (set(from_jax_params(params))
                                    | set(from_jax_params(state)))
    # nonzero statistics so the eval forward reads them
    rs = np.random.default_rng(1)
    state = {layer: {"moving_mean": 0.1 * rs.standard_normal(
                         v["moving_mean"].shape).astype(np.float32),
                     "moving_var": (0.5 + rs.random(
                         v["moving_var"].shape)).astype(np.float32)}
             for layer, v in state.items()}
    pm.load_state_dict({**from_jax_params(params), **from_jax_params(state)},
                       strict=True)
    x, _ = _images(4)
    _assert_forward(pm, _jax_forward(jm, params, state, x)[0], x)
    est = Estimator(pm, LOSS, optimizers.SGD(LR), device="cpu")
    got = est.get_model_state()
    assert got.keys() == state.keys()
    for layer, names in state.items():
        for name, value in names.items():
            np.testing.assert_array_equal(got[layer][name], value)
    est.set_model_state(jax.tree_util.tree_map(np.zeros_like, state))
    assert all(float(b.abs().max()) == 0.0 for b in pm.buffers())
    with pytest.raises(ValueError, match="missing"):
        est.set_model_state({"stem_bn": state["stem_bn"]})


@pytest.mark.parametrize("depth,padding_mode,size,train_tol,stat_tol", [
    (18, "same", 64, 1e-5, 1e-6), (50, "same", SIZE, 1e-3, 1e-4),
    (18, "torch", 64, 1e-5, 1e-6)],
    ids=["resnet18", "resnet50_bottleneck", "resnet18_torch_padding"])
def test_resnet_forward_and_statistics_match_jax(depth, padding_mode, size,
                                                 train_tol, stat_tol):
    """Training-mode forward (batch statistics, the running update) and
    eval forward; ResNet-50's bottleneck blocks; torch geometry
    (symmetric pads on the stride-2 convs and the stem pool)."""
    shape = (size, size, 3)
    jm = jic.resnet(depth, CLASSES, shape, padding_mode=padding_mode)
    params, state = _jax_built(jm)
    pm = _port_loaded(pic.resnet(depth, CLASSES, shape,
                                 padding_mode=padding_mode), params, state)
    x, _ = _images(4, size)
    want, new_state = _jax_forward(jm, params, state, x, training=True)
    _assert_forward(pm, want, x, training=True, tol=train_tol)
    _assert_state(pm, new_state, atol=stat_tol)
    _assert_forward(pm, _jax_forward(jm, params, new_state, x)[0], x)


def test_imagenet_uint8_preprocess_on_uint8_input():
    """The preprocess normalizes raw uint8 pixels on the device into f32;
    under a bf16 ``compute_dtype`` (which casts float inputs only) the
    uint8 input stays uint8, so the convolutions run in f32, as in the
    JAX package."""
    jm = jic.resnet(18, CLASSES, (SIZE, SIZE, 3), preprocess="imagenet_uint8")
    params, state = _jax_built(jm)
    pm = _port_loaded(pic.resnet(18, CLASSES, (SIZE, SIZE, 3),
                                 preprocess="imagenet_uint8"), params, state)
    raw = np.random.RandomState(2).randint(0, 255, (4, SIZE, SIZE, 3),
                                           dtype=np.uint8)
    want, _ = _jax_forward(jm, params, state, raw)
    _assert_forward(pm, want, raw)
    seen = []
    pm.stem_conv.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].dtype))
    est = Estimator(pm, LOSS, optimizers.SGD(LR), device="cpu",
                    compute_dtype=torch.bfloat16)
    got = est.predict(raw, batch_size=4)
    assert seen == [torch.float32] and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _trace_of(opt_state):
    """The momentum trace inside optax's SGD state."""
    found = []

    def walk(s):
        if hasattr(s, "trace"):
            found.append(s.trace)
        elif isinstance(s, (tuple, list)):
            for c in s:
                walk(c)
    walk(opt_state)
    return found[0]


def _jax_snapshot(est, stepped: bool) -> dict:
    return {"state": {**from_jax_params(_np(est.params)),
                      **from_jax_params(_np(est.model_state))},
            "trace": (from_jax_params(_np(_trace_of(est.opt_state)))
                      if stepped else {})}


def _port_snapshot(est) -> dict:
    trace = (est.opt_state or {}).get("trace", {})
    return {"state": {k: v.detach().clone()
                      for k, v in est.model.state_dict().items()},
            "trace": {k: v.detach().clone() for k, v in trace.items()}}


def _batch(cls, x, y, k):
    return cls.from_ndarrays(x[k * BATCH:(k + 1) * BATCH],
                             y[k * BATCH:(k + 1) * BATCH], shuffle=False)


def _jax_run(jm, params, state, x, y, dtype):
    """JAX's Estimator stepped once a call: (losses, snapshots before each
    step and after the last)."""
    est = JaxEstimator(jm, jax_objectives.get(LOSS),
                       jax_optimizers.SGD(LR, momentum=0.9),
                       compute_dtype=dtype)
    est.set_params(params)
    est.set_model_state(state)
    losses, snaps = [], []
    for k in range(STEPS):
        snaps.append(_jax_snapshot(est, k > 0))
        losses += est.train(_batch(JaxFeatureSet, x, y, k),
                            batch_size=BATCH, epochs=k + 1)["loss_history"]
    snaps.append(_jax_snapshot(est, True))
    return losses, snaps


def _port_estimator(snap, dtype):
    model = pic.resnet(18, CLASSES, (SIZE, SIZE, 3)).build(device="cpu")
    model.load_state_dict(snap["state"], strict=True)
    est = Estimator(model, LOSS, optimizers.SGD(LR, momentum=0.9),
                    device="cpu", compute_dtype=dtype)
    est._ensure_initialized()
    with torch.no_grad():
        for name, value in snap["trace"].items():
            est.opt_state["trace"][name].copy_(value)
    return est


def _step(est, x, y, k):
    return est.train(_batch(FeatureSet, x, y, k), batch_size=BATCH,
                     epochs=est.epoch)["loss_history"][0]


def _update_rel(got, want, prev, keys):
    """The relative L2 distance of ``got``'s update from ``want``'s (both
    from ``prev``) over the parameters ``keys`` together."""
    diff = sum(float((got[n] - want[n]).double().square().sum())
               for n in keys)
    upd = sum(float((want[n] - prev[n]).double().square().sum())
              for n in keys)
    return (diff / max(upd, 1e-300)) ** 0.5


@pytest.fixture(scope="module")
def resnet18_jax():
    """JAX's ResNet-18, its init (numpy, read only) and the images both
    dtypes' steps take."""
    jm = jic.resnet(18, CLASSES, (SIZE, SIZE, 3))
    return (jm, *_jax_built(jm), *_images(BATCH * STEPS))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_estimator_steps_match_jax(bf16, resnet18_jax):
    """Three ``Estimator.train`` steps of ResNet-18 with SGD(0.1, momentum
    0.9), free and each from JAX's state (see the module docstring)."""
    jm, params, state, x, y = resnet18_jax
    jdtype, tdtype = ((jnp.bfloat16, torch.bfloat16) if bf16
                      else (None, None))
    jax_losses, snaps = _jax_run(jm, params, state, x, y, jdtype)
    free = _port_estimator(snaps[0], tdtype)
    free_losses = [_step(free, x, y, k) for k in range(STEPS)]
    names = [n for n, _ in free.model.named_parameters()]
    if not bf16:
        np.testing.assert_allclose(free_losses[:2], jax_losses[:2],
                                   rtol=1e-4, atol=0)
        np.testing.assert_allclose(free_losses[2], jax_losses[2], rtol=1e-2,
                                   atol=0)
    for k in range(STEPS):
        prev, want = snaps[k]["state"], snaps[k + 1]["state"]
        est = _port_estimator(snaps[k], tdtype)
        loss = _step(est, x, y, k)
        got = _port_snapshot(est)["state"]
        stats = [n for n in want if n not in names]
        stat_err = max(float((got[n] - want[n]).abs().max()) for n in stats)
        if not bf16:
            np.testing.assert_allclose(loss, jax_losses[k], rtol=1e-5)
            worst = max(_update_rel(got, want, prev, [n]) for n in names)
            assert worst <= 1e-4, (k, worst)
            param_err = max(float((got[n] - want[n]).abs().max())
                            for n in names)
            assert param_err <= 1e-4 and stat_err <= 1e-5, (
                k, param_err, stat_err)
            continue
        # JAX's own bf16 error: its distance from the f32 step
        ref = _port_estimator(snaps[k], None)
        ref_loss = _step(ref, x, y, k)
        exact = _port_snapshot(ref)["state"]
        errs = {"update": (_update_rel(got, exact, prev, names),
                           _update_rel(want, exact, prev, names)),
                "loss": (abs(loss - ref_loss), abs(jax_losses[k] - ref_loss)),
                "stats": tuple(max(float((exact[n] - b[n]).abs().max())
                                   for n in stats) for b in (got, want))}
        for what, (port_err, jax_err) in errs.items():
            assert port_err <= BF16_ERROR_RATIO * jax_err, (k, what,
                                                            port_err, jax_err)


def test_checkpoint_resume_equals_the_straight_run(tmp_path):
    """Parameters, running statistics, momentum trace and losses: a run
    stopped after two steps, checkpointed and resumed in a fresh Estimator
    ends where the straight run does (the CPU is deterministic)."""
    x, y = _images(BATCH * 4)
    init = pic.resnet(18, CLASSES, (SIZE, SIZE, 3)).build(
        torch.Generator().manual_seed(5), device="cpu").state_dict()

    def make():
        return _port_estimator({"state": init, "trace": {}}, None)

    straight = make()
    straight_losses = [_step(straight, x, y, k) for k in range(4)]
    first = make()
    _step(first, x, y, 0)
    _step(first, x, y, 1)
    first.save_checkpoint(str(tmp_path / "ckpt"))
    resumed = make()
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    assert resumed.global_step == 2
    losses = [_step(resumed, x, y, k) for k in (2, 3)]
    assert losses == straight_losses[2:]
    want, got = _port_snapshot(straight), _port_snapshot(resumed)
    for part in ("state", "trace"):
        assert want[part].keys() == got[part].keys()
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), k
    assert any("moving_var" in k for k in got["state"])


@pytest.mark.parametrize("name", sorted(pic._BACKBONES))
def test_every_backbone_forward_matches_jax(name):
    """Every model name ``ImageClassifier`` takes builds in the port with
    JAX's parameter names and gives JAX's eval forward."""
    assert sorted(pic._BACKBONES) == sorted(jic._BACKBONES)
    jm = jic._BACKBONES[name](CLASSES, (SIZE, SIZE, 3))
    params, state = _jax_built(jm)
    pm = _port_loaded(pic._BACKBONES[name](CLASSES, (SIZE, SIZE, 3)),
                      params, state)
    x, _ = _images(2)
    _assert_forward(pm, _jax_forward(jm, params, state, x)[0], x)


def test_image_classifier_config_round_trips_through_save_and_load(tmp_path):
    """``get_config`` is the JAX package's, ``zoo_model.json`` its format,
    and ``load_model`` rebuilds the same network (the padding geometry
    included) with the same weights and statistics."""
    kw = dict(model_name="resnet18", num_classes=3,
              input_shape=(SIZE, SIZE, 3), labels=["cat", "dog", "fox"],
              padding_mode="torch")
    port_ic = pic.ImageClassifier(**kw)
    assert port_ic.get_config() == jic.ImageClassifier(**kw).get_config()
    port_ic.build(torch.Generator().manual_seed(1), device="cpu")
    with torch.no_grad():
        for buf in port_ic.model.buffers():
            buf.add_(0.25)
    port_ic.save_model(str(tmp_path / "ic"))
    with open(tmp_path / "ic" / "zoo_model.json") as f:
        assert json.load(f) == {"class": "ImageClassifier",
                                "config": port_ic.get_config()}
    loaded = ZooModel.load_model(str(tmp_path / "ic"), device="cpu")
    assert isinstance(loaded, pic.ImageClassifier)
    assert loaded.get_config() == port_ic.get_config()
    want = port_ic.model.state_dict()
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    x, _ = _images(2)
    port_ic.model.eval()
    with torch.no_grad():
        assert torch.equal(loaded.model(torch.from_numpy(x)),
                           port_ic.model(torch.from_numpy(x)))
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"1": "a", "2": "b"}))
    assert loaded.with_label_map(str(labels)).labels == ["a", "b"]


def _small_convnet(mod, pkg_input, pkg_model):
    """A conv, BatchNorm, relu, global pool and softmax classifier."""
    inp = pkg_input((12, 12, 3), name="image")
    x = mod.Convolution2D(6, 3, 3, subsample=(2, 2), border_mode="same",
                          name="conv")(inp)
    x = mod.BatchNormalization(name="bn")(x)
    x = mod.Activation("relu", name="act")(x)
    x = mod.GlobalAveragePooling2D(name="pool")(x)
    return pkg_model(inp, mod.Dense(2, activation="softmax",
                                    name="logits")(x))


def _recording(clf, params=None, state=None):
    """Make ``clf``'s Estimator record its train result (and, for JAX's,
    start from ``params``/``state``)."""
    made, record = clf._make_estimator, {}

    def make():
        est = made()
        if params is not None:
            est.set_params(params)
            est.set_model_state(state)
        train = est.train

        def recorded(*a, **k):
            record["history"] = train(*a, **k)
            return record["history"]
        est.train = recorded
        return est
    clf._make_estimator = make
    return record


def test_nnclassifier_fit_and_transform_match_jax():
    """``NNClassifier`` on a DataFrame of uint8 images (one array a cell)
    and 0/1 labels: the same losses (adam, 2 epochs of 4 batches) and the
    same ``prediction`` column, 0.0 or 1.0."""
    rs = np.random.RandomState(3)
    images = rs.randint(0, 255, (32, 12, 12, 3), dtype=np.uint8)
    df = pd.DataFrame({"image": list(images),
                       "label": rs.randint(0, 2, 32).astype(np.float64)})
    jm = _small_convnet(jax_layers, JaxInput, JaxModel)
    params, state = _jax_built(jm)
    pm = _port_loaded(_small_convnet(layers, Input, Model), params, state)
    jclf = JaxNNClassifier(jm, features_col="image").set_batch_size(8)
    clf = NNClassifier(pm, features_col="image",
                       device="cpu").set_batch_size(8)
    jrec = _recording(jclf.set_max_epoch(2), params, state)
    rec = _recording(clf.set_max_epoch(2))
    want = jclf.fit(df).set_batch_size(8).transform(df)
    got = clf.fit(df).set_batch_size(8).transform(df)
    np.testing.assert_allclose(rec["history"]["loss_history"],
                               jrec["history"]["loss_history"], rtol=1e-5)
    assert set(got["prediction"]) <= {0.0, 1.0}
    np.testing.assert_array_equal(got["prediction"].to_numpy(),
                                  want["prediction"].to_numpy())
    assert list(got.columns) == ["image", "label", "prediction"]


def test_column_matrix_matches_jax():
    rs = np.random.RandomState(4)
    df = pd.DataFrame({"image": list(rs.randint(0, 255, (5, 4, 4, 3),
                                                dtype=np.uint8)),
                       "a": rs.rand(5), "b": rs.randint(0, 9, 5)})
    for cols in ("image", ["a", "b"], "a"):
        got, want = column_matrix(df, cols), jax_column_matrix(df, cols)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_batchnorm_training_raises_on_a_two_rank_mesh():
    """Batch statistics over ranks are not ported: an Estimator on a mesh
    of two ranks refuses to train a model with BatchNormalization, and the
    layer refuses to train under a default mesh of two ranks."""
    mesh = Mesh(rank=0, size=2, axis=DATA_AXIS, group=None, backend="gloo",
                device=torch.device("cpu"))
    model = _small_convnet(layers, Input, Model).build(device="cpu")
    est = Estimator(model, LOSS, optimizers.SGD(LR), device="cpu",
                    mesh=mesh)
    x = np.zeros((4, 12, 12, 3), np.float32)
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        est.train(FeatureSet.from_ndarrays(x, np.zeros(4, np.float32)),
                  batch_size=4)
    set_default_mesh(mesh)
    try:
        model.train()
        with pytest.raises(NotImplementedError, match="Queue A item 7"):
            model(torch.from_numpy(x))
        model.eval()
        model(torch.from_numpy(x))
    finally:
        set_default_mesh(None)


def test_batchnorm_exact_statistics_are_float64_sums_rounded_once():
    """``BatchNormalization(exact_statistics=True)`` in training: the batch
    mean and variance are the f64 ones rounded once to f32, bit for bit,
    and the output is within 1e-6 of its scale of the f64 normalization
    (3.9e-7 measured; the default route, f32 sums, 1.3e-5), on activations
    whose means are many standard deviations (the case where
    ``E[x^2] - E[x]^2`` cancels)."""
    from analytics_zoo_tpu_torch.keras.layers.norm import _TrainBatchNorm
    rs = np.random.RandomState(0)
    c = 64
    x = (rs.randn(16, 16, 16, c) * 0.3 + rs.rand(c) * 4).astype(np.float32)
    gamma = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    beta = (0.1 * rs.randn(c)).astype(np.float32)
    xd = x.astype(np.float64)
    mean, var = xd.mean((0, 1, 2)), xd.var((0, 1, 2))
    want = (xd - mean) / np.sqrt(var + 1e-3) * gamma + beta
    y, m, v = _TrainBatchNorm.apply(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        1e-3, (0, 1, 2), [1, 1, 1, c], True)
    assert np.array_equal(m.numpy(), mean.astype(np.float32))
    assert np.array_equal(v.numpy(), var.astype(np.float32))
    assert np.abs(y.double().numpy() - want).max() <= \
        1e-6 * np.abs(want).max()
    layer = layers.BatchNormalization(exact_statistics=True)
    layer.build(None, x.shape, torch.device("cpu"))
    with torch.no_grad():
        layer.gamma.copy_(torch.from_numpy(gamma))
        layer.beta.copy_(torch.from_numpy(beta))
    assert torch.equal(layer(torch.from_numpy(x)).detach(), y)


def test_compute_dtype_casts_float_inputs_only():
    """bf16 ``compute_dtype``: float inputs reach the model in bf16, integer
    ones as they are; losses and predictions are f32."""
    seen = []

    def record(t):
        seen.append(t.dtype)
        return t.to(torch.float32)

    a, b = Input((3,), name="a"), Input((3,), name="b")
    x = layers.Merge("concat")([layers.Lambda(record, name="ra")(a),
                                layers.Lambda(record, name="rb")(b)])
    model = Model([a, b], layers.Dense(2, activation="softmax",
                                       name="out")(x)).build(device="cpu")
    seen.clear()
    est = Estimator(model, LOSS, optimizers.SGD(LR), device="cpu",
                    compute_dtype=torch.bfloat16)
    xs = [np.ones((4, 3), np.float32), np.ones((4, 3), np.int64)]
    hist = est.train(FeatureSet.from_ndarrays(xs, np.zeros(4, np.float32)),
                     batch_size=4)
    assert seen == [torch.bfloat16, torch.int64]
    assert np.isfinite(hist["loss_history"]).all()
    assert est.predict(xs, batch_size=4).dtype == np.float32
    with pytest.raises(ValueError, match="float"):
        Estimator(model, LOSS, optimizers.SGD(LR), device="cpu",
                  compute_dtype=torch.int32)


def test_parts_not_ported_raise_naming_their_roadmap_item():
    ic = pic.ImageClassifier("resnet18", 2, (SIZE, SIZE, 3))
    pm = _small_convnet(layers, Input, Model)
    cases = [
        (lambda: NNClassifier(pm, device="cpu").set_tensorboard("d", "a"),
         "item 5"),
        (lambda: FeatureSet(np.zeros((2, 1)), memory_type=MemoryType.DISK),
         "item 5"),
        (lambda: ic.load_pretrained_torch("x.pt"), "item 6"),
    ]
    for fn, item in cases:
        with pytest.raises(NotImplementedError, match=f"Queue A {item}"):
            fn()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = pic.resnet(18, 2, (SIZE, SIZE, 3))
    for fn in (lambda: model.build(),
               lambda: pic.ImageClassifier("resnet18", 2).build(),
               lambda: NNClassifier(model),
               lambda: Estimator(model, LOSS, optimizers.SGD(LR),
                                 compute_dtype=torch.bfloat16)):
        with pytest.raises(NoCudaDeviceError):
            fn()
    assert NNClassifier(model, device="cpu").device.type == "cpu"
