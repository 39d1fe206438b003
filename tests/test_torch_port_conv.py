"""The port's convolution, pooling and normalization layers against the JAX
package's on the CPU.

Both packages get the same inputs (numpy, from a seed), the same weights
(the JAX layer's, carried across by name with ``convert.from_jax_params``)
and the same output cotangent. The outputs, the input gradients and the
parameter gradients (``jax.vjp`` against autograd) must agree within 1e-5
of their scale (their largest magnitude, or 1 where that is smaller) in
f32: both sum the same products in other orders, and a kernel's gradient
sums a few hundred of them to magnitudes near 20. BatchNormalization's
running statistics must agree within 1e-6. In bf16 the outputs round to 8
bits once in both: they may differ by one bf16 step of their value (2^-8
relative, tested at 2^-7). The input gradient in bf16 is held within one
bf16 step of its scale (2^-7 of its largest magnitude): JAX rounds the two
paths into the input (through the scale-and-shift and through the
statistics), each of that scale, to bf16 before adding them, where the
port adds them in f32 and rounds once. The f32 statistics and parameter
gradients agree within 1e-4 of their scale (their sums read rounded bf16
activations in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras.layers import conv as jconv
from analytics_zoo_tpu.keras.layers import norm as jnorm
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.inference.quantize import QuantizedWeight
from analytics_zoo_tpu_torch.keras import layers as port
from analytics_zoo_tpu_torch.keras.layers import conv as pconv
from torch_port_threads import torch_threads_per_worker  # noqa: F401

ATOL = 1e-5


def _pair(jax_layer, port_layer, shape):
    """Build both layers for ``shape`` (batch axis included) with the JAX
    layer's weights; returns (jax params, jax state)."""
    in_shape = (None,) + tuple(shape[1:])
    params, state = jax_layer.build(jax.random.PRNGKey(3), in_shape)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    port_layer.build(torch.Generator().manual_seed(0), in_shape,
                     torch.device("cpu"))
    if params or state:
        port_layer.load_state_dict(
            {**from_jax_params(params), **from_jax_params(state)},
            strict=True)
    assert (tuple(jax_layer.compute_output_shape(in_shape))
            == tuple(port_layer.compute_output_shape(in_shape)))
    return params, state


def _run_both(jax_layer, port_layer, x, training=False, dtype=None):
    """Forward both on ``x`` and pull the same seeded cotangent back:
    returns ((jax out, jax state, jax dx, jax dparams), (port out, port dx,
    port dparams)) as numpy, f32."""
    params, state = _pair(jax_layer, port_layer, x.shape)
    jx = jnp.asarray(x)
    if dtype is not None:
        jx = jx.astype(dtype)

    def f(p, xin):
        return jax_layer.call(p, state, xin, training=training)

    (y, new_state), vjp = jax.vjp(f, params, jx)
    cot = np.random.default_rng(9).standard_normal(y.shape).astype(
        np.float32)
    dp, dx = vjp((jnp.asarray(cot).astype(y.dtype),
                  jax.tree_util.tree_map(jnp.zeros_like, new_state)))
    tx = torch.from_numpy(x)
    if dtype is not None:
        tx = tx.to(torch.bfloat16)
    tx.requires_grad_(True)
    port_layer.train(training)
    ty = port_layer(tx)
    assert ty.dtype == tx.dtype
    ty.backward(torch.from_numpy(cot).to(ty.dtype))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    jax_out = (f32(y), jax.tree_util.tree_map(f32, new_state), f32(dx),
               {k: f32(v) for k, v in from_jax_params(
                   jax.tree_util.tree_map(f32, dp)).items()})
    port_out = (ty.detach().float().numpy(), tx.grad.float().numpy(),
                {k: p.grad.float().numpy()
                 for k, p in port_layer.named_parameters()})
    return jax_out, port_out


def _assert_layer_matches(jax_layer, port_layer, x, atol=ATOL, **kw):
    (y, _, dx, dp), (ty, tdx, tdp) = _run_both(jax_layer, port_layer, x,
                                               **kw)
    assert ty.shape == y.shape and set(dp) == set(tdp)
    for got, want, what in [(ty, y, "output"), (tdx, dx, "input grad")] + [
            (tdp[k], g, k) for k, g in dp.items()]:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=atol * max(1.0, np.abs(want).max()),
            err_msg=what)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


#: (input [n, h, w, c], filters, kernel, stride, border_mode, extras): SAME
#: on even and odd sizes at strides 1 and 2 (stride 2 on an even size pads
#: one more after: ResNet's stem (2, 3) and its 3x3/2 convs (0, 1)), VALID,
#: explicit symmetric pads, dilation, a depthwise conv, and bias with an
#: activation
CONV2D_CASES = [
    ((2, 16, 16, 3), 4, 7, 2, "same", {}),
    ((2, 8, 8, 5), 6, 3, 2, "same", {}),
    ((2, 9, 9, 5), 6, 3, 2, "same", {}),
    ((2, 9, 8, 4), 6, 3, 1, "same", {}),
    ((2, 8, 8, 4), 6, 1, 2, "same", {"bias": False}),
    ((2, 9, 9, 4), 6, 3, 2, "valid", {}),
    ((2, 8, 8, 4), 6, 3, 2, 1, {}),
    ((2, 10, 10, 4), 6, 3, 1, "same", {"dilation": 2}),
    ((2, 8, 8, 6), 6, 3, 2, "same", {"groups": 6, "bias": False}),
    ((2, 7, 7, 4), 5, 3, 1, "valid", {"activation": "relu"}),
]


@pytest.mark.parametrize("shape,filters,k,stride,border,extra", CONV2D_CASES,
                         ids=[f"{c[0][1]}x{c[0][2]}-k{c[2]}s{c[3]}-{c[4]}-"
                              f"{'-'.join(c[5]) or 'plain'}"
                              for c in CONV2D_CASES])
def test_conv2d_matches_jax_with_gradients(shape, filters, k, stride, border,
                                           extra):
    def layer(mod):
        return mod.Convolution2D(filters, k, k, subsample=(stride, stride),
                                 border_mode=border, **extra)
    _assert_layer_matches(layer(jconv), layer(pconv), _x(shape))


@pytest.mark.parametrize("border,stride", [("same", 2), ("valid", 1),
                                           ("same", 1)])
def test_conv1d_matches_jax_with_gradients(border, stride):
    def layer(mod):
        return mod.Convolution1D(5, 3, activation="tanh",
                                 subsample_length=stride, border_mode=border)
    _assert_layer_matches(layer(jconv), layer(pconv), _x((2, 11, 4)))


#: (pool class, input, window, strides, border_mode): SAME on even and odd
#: sizes (ResNet's stem pool pads 112 by (0, 1): the last window falls off
#: the end), VALID, and explicit pads (torch geometry)
POOL_CASES = [
    ("MaxPooling2D", (2, 12, 12, 3), 3, 2, "same"),
    ("MaxPooling2D", (2, 11, 11, 3), 3, 2, "same"),
    ("MaxPooling2D", (2, 9, 10, 3), 2, 2, "valid"),
    ("MaxPooling2D", (2, 12, 12, 3), 3, 2, 1),
    ("AveragePooling2D", (2, 12, 12, 3), 3, 2, "same"),
    ("AveragePooling2D", (2, 9, 9, 3), 2, 2, "valid"),
    ("AveragePooling2D", (2, 7, 7, 3), 3, 1, "same"),
    ("AveragePooling2D", (2, 12, 12, 3), 3, 2, 1),
]


@pytest.mark.parametrize("cls,shape,window,stride,border", POOL_CASES,
                         ids=[f"{c[0]}-{c[1][1]}-w{c[2]}s{c[3]}-{c[4]}"
                              for c in POOL_CASES])
def test_pool2d_matches_jax_with_gradients(cls, shape, window, stride,
                                           border):
    """Max pooling pads with -inf; average pooling with zeros, dividing by
    the whole window."""
    def layer(mod):
        return getattr(mod, cls)((window, window), strides=(stride, stride),
                                 border_mode=border)
    _assert_layer_matches(layer(jconv), layer(pconv), _x(shape))


@pytest.mark.parametrize("cls,shape,args", [
    ("GlobalMaxPooling2D", (2, 5, 6, 3), ()),
    ("GlobalAveragePooling2D", (2, 5, 6, 3), ()),
    ("GlobalMaxPooling1D", (2, 7, 3), ()),
    ("GlobalAveragePooling1D", (2, 7, 3), ()),
    ("ZeroPadding2D", (2, 4, 5, 3), ((1, 2),)),
    ("MaxPooling1D", (2, 11, 3), (3, 2, "same")),
])
def test_global_pools_padding_and_pool1d_match_jax(cls, shape, args):
    _assert_layer_matches(getattr(jconv, cls)(*args),
                          getattr(pconv, cls)(*args), _x(shape))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_batchnorm_training_update_and_eval_match_jax(bf16):
    """Training: the batch's biased variance (E[x^2] - E[x]^2, clamped),
    the running update ``0.99 * old + 0.01 * batch`` (not torch's unbiased
    one), output and gradients; then eval from the running statistics."""
    x = 2.0 * _x((6, 5, 4, 8)) + 0.5
    dtype = jnp.bfloat16 if bf16 else None
    jl, pl = jnorm.BatchNormalization(name="bn"), port.BatchNormalization(
        name="bn")
    # non-trivial gamma, beta and running statistics
    params, state = _pair(jl, pl, x.shape)
    rs = np.random.default_rng(4)
    for k in ("gamma", "beta"):
        params[k] = (params[k] + rs.standard_normal(8)).astype(np.float32)
    state = {"moving_mean": rs.standard_normal(8).astype(np.float32),
             "moving_var": (rs.random(8) + 0.5).astype(np.float32)}
    jl.build = lambda *a: (params, state)
    for training in (True, False):
        (y, new_state, dx, dp), (ty, tdx, tdp) = _run_both(
            jl, pl, x, training=training, dtype=dtype)
        scale = np.abs(y).max()
        if bf16:
            np.testing.assert_allclose(ty, y, rtol=2 ** -7, atol=1e-6)
            np.testing.assert_allclose(tdx, dx, rtol=0,
                                       atol=2 ** -7 * np.abs(dx).max())
            gtol = 1e-4
        else:
            np.testing.assert_allclose(ty, y, rtol=0, atol=ATOL * scale)
            np.testing.assert_allclose(tdx, dx, rtol=0, atol=ATOL)
            gtol = ATOL
        for k in ("gamma", "beta"):
            np.testing.assert_allclose(tdp[k], dp[k], rtol=0,
                                       atol=gtol * max(1.0, np.abs(
                                           dp[k]).max()), err_msg=k)
        got_state = {k: getattr(pl, k).numpy()
                     for k in ("moving_mean", "moving_var")}
        for k, v in new_state.items():
            np.testing.assert_allclose(got_state[k], v, rtol=0,
                                       atol=1e-6 if not bf16 else 1e-5,
                                       err_msg=k)
        if not training:
            np.testing.assert_array_equal(got_state["moving_var"],
                                          state["moving_var"])


def test_layernorm_matches_jax():
    x = 3.0 * _x((4, 5, 16)) - 1.0
    _assert_layer_matches(jnorm.LayerNormalization(),
                          port.LayerNormalization(), x)


def test_conv_output_is_contiguous_nhwc_with_no_layout_copy():
    """cuDNN (and the CPU) gets the NCHW view of NHWC activations, which is
    channels_last memory; the output comes back in that layout, so its
    NHWC view is contiguous and the next layer copies nothing."""
    layer = pconv.Convolution2D(8, 3, 3, subsample=(2, 2), border_mode="same")
    layer.build(torch.Generator().manual_seed(0), (None, 16, 16, 4),
                torch.device("cpu"))
    x = torch.randn(2, 16, 16, 4)
    assert x.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)
    y = layer(x)
    assert y.shape == (2, 8, 8, 8) and y.is_contiguous()
    z = pconv.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(y)
    assert z.is_contiguous()


def test_int8_convolution_paths_raise_naming_their_roadmap_item():
    """Queue A item 3 is ported: neither int8 route raises any more. A
    layer with ``int8_training`` runs ``int8_train_conv``, and one whose
    kernel is a ``QuantizedWeight`` runs ``qconv_apply`` (their parity with
    JAX: ``tests/test_torch_port_int8_conv.py``)."""
    from analytics_zoo_tpu_torch.inference.quantize import qconv_apply
    from analytics_zoo_tpu_torch.ops.int8_training import int8_train_conv
    x = torch.randn(1, 8, 8, 2, generator=torch.Generator().manual_seed(0))
    trained = pconv.Convolution2D(4, 3, 3, int8_training=True, bias=False)
    trained.build(torch.Generator().manual_seed(0), (None, 8, 8, 2),
                  torch.device("cpu"))
    assert torch.equal(trained(x), int8_train_conv(
        x, trained.kernel, (1, 1), "VALID"))
    layer = pconv.Convolution2D(4, 3, 3, bias=False)
    layer.build(torch.Generator().manual_seed(0), (None, 8, 8, 2),
                torch.device("cpu"))
    kernel = layer.kernel.detach()
    del layer._parameters["kernel"]
    layer.kernel = QuantizedWeight(kernel.to(torch.int8),
                                   torch.tensor(1.0))
    assert torch.equal(layer(x), qconv_apply(x, layer.kernel, (1, 1),
                                             "VALID", (1, 1), 1))
