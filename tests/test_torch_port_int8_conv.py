"""The port's int8 convolution, its quantized ``Convolution2D`` routes and
its int8 training convolution against the JAX package's on the CPU.

Both packages get the same int8 operands, weights and cotangents (numpy,
from a seed). What is exact must agree bit for bit:

- ``int8_conv2d``'s int32 sums equal ``lax.conv_general_dilated(...,
  preferred_element_type=int32)`` (and a float64 convolution of the same
  integers) at 1x1, 3x3, 5x3 and 7x7 kernels, strides 1 and 2, SAME, VALID
  and explicit pads, dilation 2, groups 2 and cin 3 (K = 147, no multiple
  of 8);
- calibrated ``qconv_apply``: the same f32 division rounded half to even
  snaps the inputs, so the int32 sums and their one f32 product with
  ``act_scale * scale`` are JAX's;
- ``int8_train_conv``'s forward: the same dynamic scales, codes and sums.

The float parts are held within stated tolerances, measured first on the
CPU:

- weight-only ``qconv_apply`` (a float convolution of the same dequantized
  kernel, summed in another order) within 1e-5 of the output's scale;
- the straight-through gradients, bf16 convolutions against the
  dequantized input in both packages, within one bf16 step (2^-8) of their
  scale; they were measured equal bit for bit, in f32 and in bf16;
- a ResNet-18 at 32 x 32 served through ``InferenceModel`` (f32,
  weight-only int8, bf16 and calibrated int8) within 1e-6 of JAX's
  probabilities, measured at most 4.5e-8. The calibrated run observes
  every conv's and the Dense's input: its activation scales agree with
  JAX's within 1e-6 relative (4.2e-7 measured, f32 percentiles over
  activations summed in another order), which moves a few int8 codes, so
  its predictions from its own scales are within 2e-3 of JAX's (8.6e-4
  measured); with JAX's scales loaded they are within 1e-6 (7.5e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.inference import quantize as jquant
from analytics_zoo_tpu.keras.layers import conv as jconv
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu.ops import int8_training as jtrain
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.inference import quantize as pquant
from analytics_zoo_tpu_torch.inference.quantize import QuantizedWeight
from analytics_zoo_tpu_torch.keras.layers import conv as pconv
from analytics_zoo_tpu_torch.models.image import imageclassification as pic
from analytics_zoo_tpu_torch.ops import int8_dataflow as pflow
from analytics_zoo_tpu_torch.ops import int8_training as ptrain
from torch_port_threads import torch_threads_per_worker  # noqa: F401

DIMS = ("NHWC", "HWIO", "NHWC")
#: weight-only int8 and the f32 forward: the same products summed in
#: another order
FLOAT_ATOL = 1e-5
#: the straight-through gradients: bf16 convolutions in both packages
GRAD_BF16_STEP = 2.0 ** -8
#: a ResNet-18 served quantized, against JAX's predictions (probabilities)
SERVED_ATOL = 1e-6
#: ... and calibrated on its own activation scales
OWN_SCALES_ATOL = 2e-3

#: (input [n, h, w, cin], kernel [kh, kw], cout, strides, padding,
#: dilation, groups)
CASES = [
    ((2, 8, 8, 16), (1, 1), 8, (1, 1), "SAME", (1, 1), 1),
    ((2, 8, 8, 16), (1, 1), 8, (2, 2), "SAME", (1, 1), 1),
    ((2, 9, 7, 8), (3, 3), 16, (1, 1), "SAME", (1, 1), 1),
    ((2, 8, 8, 8), (3, 3), 16, (2, 2), "SAME", (1, 1), 1),
    ((2, 9, 9, 8), (3, 3), 16, (2, 2), "SAME", (1, 1), 1),
    ((2, 9, 9, 8), (3, 3), 8, (1, 1), "VALID", (1, 1), 1),
    ((2, 8, 8, 8), (3, 3), 8, (2, 2), ((1, 1), (1, 1)), (1, 1), 1),
    ((2, 8, 9, 4), (5, 3), 8, (1, 2), ((2, 0), (1, 3)), (1, 1), 1),
    ((2, 16, 16, 3), (7, 7), 8, (2, 2), "SAME", (1, 1), 1),
    ((2, 10, 10, 8), (3, 3), 8, (1, 1), "SAME", (2, 2), 1),
    ((2, 8, 8, 8), (3, 3), 16, (1, 1), "SAME", (1, 1), 2),
]
CASE_IDS = [f"{c[1][0]}x{c[1][1]}-s{c[3][0]}{c[3][1]}-"
            f"{c[4] if isinstance(c[4], str) else 'explicit'}"
            f"-d{c[5][0]}-g{c[6]}-cin{c[0][3]}" for c in CASES]


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(
        -127, 128, shape).astype(np.int8)


def _jax_int8_conv(xq, wq, strides, padding, dilation, groups):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), window_strides=strides,
        padding=padding, rhs_dilation=dilation, feature_group_count=groups,
        dimension_numbers=DIMS, preferred_element_type=jnp.int32))


@pytest.mark.parametrize("shape,kernel,cout,strides,padding,dilation,groups",
                         CASES, ids=CASE_IDS)
def test_int8_conv2d_equals_jax_bit_for_bit(shape, kernel, cout, strides,
                                            padding, dilation, groups):
    xq = _codes(shape, 1)
    wq = _codes(kernel + (shape[3] // groups, cout), 2)
    want = _jax_int8_conv(xq, wq, strides, padding, dilation, groups)
    got = pflow.int8_conv2d(torch.from_numpy(xq), torch.from_numpy(wq),
                            strides, padding, dilation, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the exact sums: a float64 convolution of the same integers
    exact = lax.conv_general_dilated(
        jnp.asarray(xq, jnp.float32), jnp.asarray(wq, jnp.float32),
        window_strides=strides, padding=padding, rhs_dilation=dilation,
        feature_group_count=groups, dimension_numbers=DIMS,
        precision=lax.Precision.HIGHEST)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exact))


def test_int8_conv2d_takes_int8_operands_and_fitting_groups_only():
    xq = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    wq = torch.zeros(3, 3, 8, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        pflow.int8_conv2d(xq.float(), wq)
    with pytest.raises(TypeError):
        pflow.int8_conv2d(xq, wq.float())
    with pytest.raises(ValueError):
        pflow.int8_conv2d(xq, wq, groups=2)


def test_a_one_by_one_conv_at_stride_one_multiplies_the_input_in_place(
        monkeypatch):
    """A 1x1 stride-1 conv hands ``int8_matmul`` the activations' own
    storage, reshaped, with no patch copy."""
    seen = []
    real = pquant.int8_matmul

    def spy(a, b):
        seen.append(a)
        return real(a, b)

    monkeypatch.setattr(pquant, "int8_matmul", spy)
    xq = torch.from_numpy(_codes((2, 8, 8, 16), 3))
    pflow.int8_conv2d(xq, torch.from_numpy(_codes((1, 1, 16, 8), 4)))
    assert len(seen) == 1 and seen[0].data_ptr() == xq.data_ptr()


def _qkernels(kshape, act_scale, seed=5):
    """The same int8 kernel for both packages: JAX's ``{"q", "scale"[,
    "act_scale"]}`` leaf and the port's ``QuantizedWeight``."""
    w = np.random.default_rng(seed).standard_normal(kshape).astype(
        np.float32) * 0.2
    leaf = jax.tree_util.tree_map(np.array, jquant.quantize_params(
        {"l": {"kernel": w}}, "int8",
        act_scales=None if act_scale is None else {"l": act_scale}))["l"][
        "kernel"]
    port = QuantizedWeight(torch.from_numpy(leaf["q"]),
                           torch.from_numpy(np.asarray(leaf["scale"])),
                           None if act_scale is None else torch.from_numpy(
                               np.asarray(leaf["act_scale"])))
    return leaf, port


@pytest.mark.parametrize("mode", ["weight_only", "calibrated"])
@pytest.mark.parametrize("case", [2, 7, 10], ids=[CASE_IDS[i]
                                                  for i in (2, 7, 10)])
def test_qconv_apply_matches_jax(mode, case):
    shape, kernel, cout, strides, padding, dilation, groups = CASES[case]
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    act = 0.021 if mode == "calibrated" else None
    leaf, qw = _qkernels(kernel + (shape[3] // groups, cout), act)
    want = np.asarray(jquant.qconv_apply(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, leaf), strides,
        padding, dilation, groups))
    got = pquant.qconv_apply(torch.from_numpy(x), qw, strides, padding,
                             dilation, groups)
    assert got.dtype == torch.float32
    if mode == "calibrated":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FLOAT_ATOL * np.abs(want).max())


def test_convolution2d_with_a_quantized_kernel_runs_qconv_apply():
    """The layer's ``QuantizedWeight`` route, weight-only and calibrated,
    is ``qconv_apply``, then the bias and the activation, as in the JAX
    layer."""
    x = np.random.default_rng(7).standard_normal((2, 9, 9, 4)).astype(
        np.float32)
    for calibrated in (False, True):
        jl = jconv.Convolution2D(8, 3, 3, subsample=(2, 2),
                                 border_mode="same", activation="relu")
        pl = pconv.Convolution2D(8, 3, 3, subsample=(2, 2),
                                 border_mode="same", activation="relu")
        params, _ = jl.build(jax.random.PRNGKey(0), (None, 9, 9, 4))
        params = {"kernel": np.asarray(params["kernel"]),
                  "bias": np.full((8,), 0.05, np.float32)}
        qp = jax.tree_util.tree_map(np.asarray, jquant.quantize_params(
            {pl.name: params}, "int8",
            act_scales={pl.name: 0.03} if calibrated else None))[pl.name]
        pl.build(torch.Generator().manual_seed(0), (None, 9, 9, 4),
                 torch.device("cpu"))
        del pl._parameters["kernel"]
        pl.kernel = QuantizedWeight(
            torch.zeros(3, 3, 4, 8, dtype=torch.int8), torch.tensor(1.0),
            torch.tensor(1.0) if calibrated else None)
        pl.load_state_dict(from_jax_params(qp), strict=True)
        want, _ = jl.call(jax.tree_util.tree_map(jnp.asarray, qp), {},
                          jnp.asarray(x))
        with torch.no_grad():
            got = pl(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=FLOAT_ATOL * np.abs(want).max(),
                                   err_msg=f"calibrated={calibrated}")


def _train_pair(shape, cout, k, dtype, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(k, k, shape[-1], cout) * 0.1).astype(np.float32)
    g = rs.randn(*(shape[:1] + (shape[1], shape[2], cout))).astype(
        np.float32)
    return x, w, g


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("strides,padding", [((1, 1), "SAME"),
                                             ((2, 2), "SAME"),
                                             ((1, 1), "VALID")],
                         ids=["s1-same", "s2-same", "s1-valid"])
def test_int8_train_conv_forward_and_ste_gradients_match_jax(dtype, strides,
                                                             padding):
    x, w, _ = _train_pair((2, 8, 8, 16), 32, 3, dtype, 1)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jx = jnp.asarray(x).astype(jdt)
    y, vjp = jax.vjp(lambda a, b: jtrain.int8_train_conv(
        a, b, strides, padding, (1, 1), 1), jx, jnp.asarray(w))
    g = np.random.RandomState(2).randn(*y.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g).astype(jdt))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt)
    tx.requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = ptrain.int8_train_conv(tx, tw, strides, padding)
    ty.backward(torch.from_numpy(g).to(tdt))
    assert ty.dtype == tdt
    np.testing.assert_array_equal(ty.float().detach().numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=GRAD_BF16_STEP * np.abs(want).max())


def test_int8_train_conv_gradient_dtypes_follow_the_inputs():
    """As ``tests/test_int8_training.py`` asks of JAX: a bf16 input takes a
    bf16 gradient, an f32 kernel an f32 one."""
    x, w, _ = _train_pair((2, 8, 8, 16), 32, 3, "bf16", 2)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ptrain.int8_train_conv(tx, tw, (1, 1), "SAME").float().sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    assert torch.isfinite(tx.grad.float()).all()
    x32 = torch.from_numpy(x).requires_grad_()
    ptrain.int8_train_conv(x32, tw, (1, 1), "SAME").sum().backward()
    assert x32.grad.dtype == torch.float32


def test_convolution2d_int8_training_matches_the_jax_layer():
    jl = jconv.Convolution2D(8, 3, 3, subsample=(2, 2), border_mode="same",
                             int8_training=True)
    pl = pconv.Convolution2D(8, 3, 3, subsample=(2, 2), border_mode="same",
                             int8_training=True)
    params, _ = jl.build(jax.random.PRNGKey(1), (None, 9, 9, 4))
    params = jax.tree_util.tree_map(np.asarray, params)
    pl.build(torch.Generator().manual_seed(0), (None, 9, 9, 4),
             torch.device("cpu"))
    pl.load_state_dict(from_jax_params(params), strict=True)
    x = np.random.default_rng(8).standard_normal((2, 9, 9, 4)).astype(
        np.float32)
    want, _ = jl.call(jax.tree_util.tree_map(jnp.asarray, params), {},
                      jnp.asarray(x))
    got = pl(torch.from_numpy(x))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


# -- a ResNet-18 served quantized ---------------------------------------------


@pytest.fixture(scope="module")
def resnet18():
    """JAX's ResNet-18 (10 classes, 32 x 32) with random running
    statistics, and seeded images."""
    jm = jic.resnet(18, 10, (32, 32, 3))
    params, state = jax.tree_util.tree_map(
        np.asarray, jm.build(jax.random.PRNGKey(0)))
    rs = np.random.default_rng(1)
    state = {layer: {"moving_mean": 0.1 * rs.standard_normal(
                         v["moving_mean"].shape).astype(np.float32),
                     "moving_var": (0.5 + rs.random(
                         v["moving_var"].shape)).astype(np.float32)}
             for layer, v in state.items()}
    x = np.random.default_rng(2).random((16, 32, 32, 3)).astype(np.float32)
    return jm, params, state, x


def _served(resnet18, mode, port: bool):
    jm, params, state, x = resnet18
    if port:
        model = pic.resnet(18, 10, (32, 32, 3)).build(device="cpu")
        model.load_state_dict({**from_jax_params(params),
                               **from_jax_params(state)}, strict=True)
        im = InferenceModel(device="cpu").load_keras(model)
    else:
        im = JaxInferenceModel().load_keras(jm, params=params,
                                            model_state=state)
    if mode == "int8_calibrated":
        return im.quantize("int8", calibration_data=[x[:8]])
    return im if mode == "f32" else im.quantize(mode)


@pytest.mark.parametrize("mode", ["f32", "int8", "bf16", "int8_calibrated"])
def test_quantized_resnet18_predictions_match_jax(resnet18, mode):
    x = resnet18[3]
    jim = _served(resnet18, mode, port=False)
    port = _served(resnet18, mode, port=True)
    want = np.asarray(jim.predict(x))
    if mode == "int8_calibrated":
        # every conv and the Dense observed, scales within 1e-6 relative;
        # then JAX's quantized tree, scales included, loads strictly
        assert set(port._act_scales) == set(jim._act_scales)
        assert len(port._act_scales) == 21
        for name, want_s in jim._act_scales.items():
            assert abs(port._act_scales[name] - want_s) <= 1e-6 * want_s, name
        np.testing.assert_allclose(port.predict(x), want, rtol=0,
                                   atol=OWN_SCALES_ATOL)
        port._module.load_state_dict({
            **from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                     jim._params)),
            **from_jax_params(resnet18[2])}, strict=True)
    got = port.predict(x)
    assert got.dtype == np.float32 and got.shape == want.shape == (16, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=SERVED_ATOL)
