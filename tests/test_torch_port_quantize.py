"""Quantized inference in the torch port against the JAX package, on CPU.

Inputs are made with numpy from a seed; weights cross with
``convert.from_jax_params``. Quantizing is exact arithmetic (f32 scales, an
f32 division rounded half to even), so int8 weights, scales and bf16 casts
must equal JAX's bit for bit. Predictions agree within 1e-5 for weight-only
and calibrated int8 (f32 sums in another order), within 2e-2 for bf16
(8-bit mantissas, rounded at different places by the two frameworks).

Out-of-range ids (ROADMAP Queue C5): JAX's int8 lookup off the TPU reads
through ``jnp.take`` (a row of -128 for an id past the end, a wrapped row
for a negative id); the port follows the TPU kernel (a zero row), written
out here in numpy.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.inference import quantize as jax_quantize
from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.models import WideAndDeep as JaxWideAndDeep
from analytics_zoo_tpu.ops import embedding_kernels as jax_ek
from analytics_zoo_tpu.ops import int8_dataflow as jax_i8
from analytics_zoo_tpu_torch import ops as port_ops
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.inference import quantize as port_quantize
from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.models import NeuralCF, WideAndDeep
from analytics_zoo_tpu_torch.ops import embedding_kernels as ek
from analytics_zoo_tpu_torch.ops import int8_dataflow as port_i8
from analytics_zoo_tpu_torch.serving import (ClusterServing, FileQueue,
                                             InputQueue, OutputQueue,
                                             ServingConfig)
from torch_port_threads import torch_threads_per_worker  # noqa: F401

CFG = dict(user_count=63, item_count=47, num_classes=2, user_embed=8,
           item_embed=8, hidden_layers=[16, 8], mf_embed=4)
MODES = ["bf16", "int8", "int8_calibrated"]
#: port against JAX: predictions
ATOL = {"bf16": 2e-2, "int8": 1e-5, "int8_calibrated": 1e-5}


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, CFG["user_count"] + 1, n),
                     rng.integers(0, CFG["item_count"] + 1, n)],
                    axis=1).astype(np.float32)


def _calibration(seed=7):
    x = _pairs(96, seed)
    return [x[i:i + 32] for i in range(0, 96, 32)]


@pytest.fixture(scope="module")
def jax_ncf():
    jm = JaxNeuralCF(**CFG)._ensure_built()
    params, state = jm.build(jax.random.PRNGKey(1))
    return jm, jax.tree_util.tree_map(np.asarray, params), state


def _port_model(params):
    port = NeuralCF(**CFG).build(device="cpu")
    port.model.load_state_dict(from_jax_params(params), strict=True)
    return port.model.eval()


def _jax_inference(jax_ncf, mode):
    jm, params, state = jax_ncf
    im = JaxInferenceModel().load_keras(jm, params=params, model_state=state)
    if mode == "int8_calibrated":
        return im.quantize("int8", calibration_data=_calibration())
    return im.quantize(mode)


def _port_inference(jax_ncf, mode):
    im = InferenceModel(device="cpu").load_keras(_port_model(jax_ncf[1]))
    if mode == "int8_calibrated":
        return im.quantize("int8", calibration_data=_calibration())
    return im.quantize(mode)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


# -- quantize_params -----------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_matches_jax_exactly(jax_ncf, mode):
    jm, params, state = jax_ncf
    act_scales = None
    if mode == "int8_calibrated":
        # JAX's own scales, handed to both packages
        act_scales = jax_quantize.observe_activation_scales(
            jm, params, state, _calibration())
        assert set(act_scales) == {"mlp_dense_0", "mlp_dense_1",
                                   "prediction"}
    dtype = "bf16" if mode == "bf16" else "int8"
    want = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_quantize.quantize_params(params, dtype,
                                                 act_scales=act_scales)))
    model = port_quantize.quantize_params(_port_model(params), dtype,
                                          act_scales=act_scales)
    got = model.state_dict()
    _assert_state_equal(got, want)
    if mode == "int8":
        assert got["mlp_user_table.embeddings.q"].dtype == torch.int8
        assert got["mlp_dense_0.bias"].dtype == torch.float32
        assert got["mlp_dense_0.kernel.scale"].shape == ()
    if mode == "int8_calibrated":
        assert got["mlp_user_table.embeddings"].dtype == torch.float32
        assert got["prediction.kernel.act_scale"].dtype == torch.float32


def test_quantize_params_rejects_an_unknown_dtype(jax_ncf):
    with pytest.raises(ValueError, match="unsupported quantization dtype"):
        port_quantize.quantize_params(_port_model(jax_ncf[1]), "int4")


def test_dequantize_params_is_the_jax_inverse(jax_ncf):
    params = jax_ncf[1]
    q = jax_quantize.quantize_params(params, "int8")
    want = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_quantize.dequantize_params(q)))
    model = port_quantize.quantize_params(_port_model(params), "int8")
    assert port_quantize._is_qleaf(model.mlp_dense_0.kernel)
    got = port_quantize.dequantize_params(model).state_dict()
    _assert_state_equal(got, want)
    assert isinstance(model.mlp_dense_0.kernel, torch.nn.Parameter)


# -- the int8 table helpers ------------------------------------------------------


@pytest.mark.parametrize("running", [None, 2.0, 0.25])
def test_quantize_table_matches_jax_exactly(running):
    table = (np.random.default_rng(3).standard_normal((37, 6)) * 0.4
             ).astype(np.float32)
    jr = None if running is None else jnp.float32(running)
    pr = None if running is None else torch.tensor(running)
    jq, js, ja = jax_ek.quantize_table(jnp.asarray(table), running_amax=jr)
    pq, ps, pa = port_ops.quantize_table(torch.from_numpy(table),
                                         running_amax=pr)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert np.array_equal(pq.numpy(), np.asarray(jq))
    assert ps.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    assert pa.numpy().tobytes() == np.asarray(ja, np.float32).tobytes()


@pytest.mark.parametrize("running,seen", [(2.0, 0.5), (0.3, 0.9),
                                          (1e-9, 0.0), (0.7, 0.7)])
def test_delayed_scaling_helpers_match_jax_exactly(running, seen):
    jr, js = jnp.float32(running), jnp.float32(seen)
    pr, ps = torch.tensor(running), torch.tensor(seen)
    amax = port_i8.next_amax(pr, ps)
    assert amax.numpy().tobytes() == np.asarray(
        jax_i8.next_amax(jr, js)).tobytes()
    assert port_i8.scale_of_amax(amax).numpy().tobytes() == np.asarray(
        jax_i8.scale_of_amax(jax_i8.next_amax(jr, js))).tobytes()
    f = np.linspace(-2, 2, 41, dtype=np.float32)  # ties included
    scale = port_i8.scale_of_amax(torch.tensor(2.0))
    q = port_i8.quant_int8(torch.from_numpy(f), scale)
    assert np.array_equal(q.numpy(), np.asarray(jax_i8.quant_int8(
        jnp.asarray(f), jax_i8.scale_of_amax(jnp.float32(2.0)))))
    assert np.array_equal(
        port_i8.dequant_int8(q, scale, torch.float32).numpy(),
        np.asarray(jax_i8.dequant_int8(jnp.asarray(q.numpy()),
                                       jax_i8.scale_of_amax(
                                           jnp.float32(2.0)), jnp.float32)))


ROWS, DIM, N, BAG = 29, 6, 13, 5


def _int8_inputs(seed, lo=0, hi=ROWS):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((ROWS, DIM)) * 0.5).astype(np.float32)
    idx = rng.integers(lo, hi, (N, BAG)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("mask_negative", [True, False])
@pytest.mark.parametrize("combiner", [None, "sum", "mean", "sqrtn"])
def test_gather_pool_int8_matches_jax(combiner, mask_negative):
    table, idx = _int8_inputs(5)
    jq, js, _ = jax_ek.quantize_table(jnp.asarray(table))
    pq, ps, _ = ek.quantize_table(torch.from_numpy(table))
    want = np.asarray(jax_ek.gather_pool_int8(jq, js, jnp.asarray(idx),
                                              combiner, mask_negative))
    got = port_ops.gather_pool_int8(pq, ps, torch.from_numpy(idx), combiner,
                                    mask_negative).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if combiner is None:
        assert np.array_equal(got, want)  # a gather and one f32 multiply
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # JAX's own TestInt8Variant check: within the documented bound of the
    # f32 table's lookup
    f32 = ek.gather_pool(torch.from_numpy(table), torch.from_numpy(idx),
                         combiner, mask_negative).numpy()
    bag = 1 if combiner is None else BAG
    bound = float(ek.int8_error_bound(ps, bag_size=bag))
    assert np.abs(got - f32).max() <= bound


def test_gather_pool_int8_masks_negative_ids_as_padding():
    table, idx = _int8_inputs(6, lo=-3)
    pq, ps, _ = ek.quantize_table(torch.from_numpy(table))
    jq, js, _ = jax_ek.quantize_table(jnp.asarray(table))
    for combiner in (None, "sum", "mean", "sqrtn"):
        got = ek.gather_pool_int8(pq, ps, torch.from_numpy(idx),
                                  combiner).numpy()
        want = np.asarray(jax_ek.gather_pool_int8(jq, js, jnp.asarray(idx),
                                                  combiner))
        if combiner is None:
            # the kernel's zero rows are JAX's rows times (idx >= 0), bit
            # for bit (array_equal: JAX's -0.0 equals the kernel's 0.0)
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mask_negative", [True, False])
def test_unpooled_gather_pool_int8_adds_no_op_after_the_int8_kernel(
        monkeypatch, mask_negative):
    table, idx = _int8_inputs(6, lo=-3)
    pq, ps, _ = ek.quantize_table(torch.from_numpy(table))
    returned = []
    real = ek.gather_int8

    def spy(qtable, scale, ids):
        returned.append(real(qtable, scale, ids))
        return returned[-1]

    monkeypatch.setattr(ek, "gather_int8", spy)
    got = ek.gather_pool_int8(pq, ps, torch.from_numpy(idx), None,
                              mask_negative)
    assert len(returned) == 1 and got.shape == idx.shape + (DIM,)
    # a view of the kernel's rows: nothing ran after the kernel
    assert got._base is returned[0]
    assert got.data_ptr() == returned[0].data_ptr()


def _int8_contract(q, scale, ids):
    """The TPU kernel's contract in numpy: ``float(q[id]) * scale`` in f32
    for ids in [0, rows), a zero row for any other id."""
    rows = q.shape[0]
    out = q[np.clip(ids, 0, rows - 1)].astype(np.float32) * np.float32(scale)
    return np.where(((ids >= 0) & (ids < rows))[:, None], out,
                    np.float32(0.0))


def test_jax_take_departs_from_the_int8_kernel_contract():
    table, _ = _int8_inputs(8)
    jq, js, _ = jax_ek.quantize_table(jnp.asarray(table))
    ids = jnp.asarray([-1, ROWS, 2], jnp.int32)
    got = np.asarray(jax_ek.gather_pool_int8(jq, js, ids, None,
                                             mask_negative=False))
    q = np.asarray(jq)
    # -1 wraps to the last row; an id past the end reads -128 (the int8
    # fill of jnp.take), where the TPU kernel writes zero rows
    np.testing.assert_array_equal(got[0], q[-1].astype(np.float32) * js)
    np.testing.assert_array_equal(got[1], np.float32(-128) * np.asarray(js))
    masked = np.asarray(jax_ek.gather_pool_int8(jq, js, ids, None))
    assert (masked[0] == 0).all()
    np.testing.assert_array_equal(masked[1],
                                  np.float32(-128) * np.asarray(js))
    assert not np.array_equal(got, _int8_contract(q, js, np.asarray(ids)))


@pytest.mark.parametrize("mask_negative", [True, False])
@pytest.mark.parametrize("dim", [1, 3, 4, 64])
def test_int8_out_of_range_ids_follow_the_tpu_kernel_contract(mask_negative,
                                                             dim):
    rng = np.random.default_rng(dim)
    q = rng.integers(-127, 128, (17, dim)).astype(np.int8)
    scale = np.float32(0.0123)
    ids = rng.integers(-4, 21, 40).astype(np.int32)
    ids[:3] = [-1, 17, 16]
    want = _int8_contract(q, scale, ids)
    tq, ts = torch.from_numpy(q), torch.tensor(scale)
    tids = torch.from_numpy(ids)
    assert np.array_equal(ek.gather_int8(tq, ts, tids).numpy(), want)
    got = ek.gather_pool_int8(tq, ts, tids, None, mask_negative).numpy()
    assert np.array_equal(got, want)
    # the pooled route reads the same zero rows
    bags = torch.from_numpy(ids.reshape(8, 5))
    pooled = ek.gather_pool_int8(tq, ts, bags, "sum", mask_negative).numpy()
    np.testing.assert_allclose(pooled, want.reshape(8, 5, dim).sum(1),
                               rtol=0, atol=1e-6)


# -- InferenceModel.quantize ---------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_quantized_ncf_predictions_match_jax(jax_ncf, mode):
    x = _pairs(45, seed=2)
    x[0] = [-2, CFG["item_count"] + 40]  # clamped by validate_ids in both
    want = np.asarray(_jax_inference(jax_ncf, mode).predict(x))
    got = _port_inference(jax_ncf, mode).predict(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[mode])


def test_calibrated_int8_with_jax_scales_matches_jax(jax_ncf):
    jim = _jax_inference(jax_ncf, "int8_calibrated")
    port = _port_inference(jax_ncf, "int8_calibrated")
    # the port's own observed scales: f32 activations summed in another
    # order, so within 1e-6 relative
    assert set(port._act_scales) == set(jim._act_scales)
    for name, want in jim._act_scales.items():
        assert abs(port._act_scales[name] - want) <= 1e-6 * want
    # JAX's quantized tree, scales included, loads strictly into the port
    port._module.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, jim._params)), strict=True)
    x = _pairs(70, seed=4)
    np.testing.assert_allclose(port.predict(x), np.asarray(jim.predict(x)),
                               rtol=0, atol=1e-5)


def test_weight_only_int8_embedding_route_equals_the_dequantized_forward(
        jax_ncf):
    quantized = port_quantize.quantize_params(_port_model(jax_ncf[1]),
                                              "int8")
    tree = port_quantize.dequantize_params(copy.deepcopy(quantized))
    x = torch.from_numpy(_pairs(64, seed=9))
    ek.reset_launch_counts()
    with torch.inference_mode():
        got = quantized(x)
        want = tree(x)
    # the int8 rows dequantize in the gather (B9's plain version here); the
    # JAX package's route dequantizes the whole tree first: same values
    assert torch.equal(got, want)
    assert ek.launch_counts == {"gather_rows": 0, "gather_pool": 0,
                                "gather_int8": 0,
                                "scatter_rows": 0}


def test_weight_only_int8_gathers_every_table_through_the_int8_wrapper(
        jax_ncf, monkeypatch):
    calls = []
    real = ek.gather_int8

    def spy(qtable, scale, ids):
        calls.append((tuple(qtable.shape), qtable.dtype))
        return real(qtable, scale, ids)

    def no_float_gather(*args, **kwargs):
        raise AssertionError("an int8 table went through the f32 gather")

    monkeypatch.setattr(ek, "gather_int8", spy)
    monkeypatch.setattr(ek, "gather", no_float_gather)
    im = _port_inference(jax_ncf, "int8")
    im.predict(_pairs(5, seed=1))
    assert calls == [((64, 8), torch.int8), ((48, 8), torch.int8),
                     ((64, 4), torch.int8), ((48, 4), torch.int8)]


def test_bf16_gathers_bf16_rows_and_answers_f32(jax_ncf, monkeypatch):
    dtypes = []
    real = ek.gather

    def spy(table, ids, clip):
        dtypes.append(table.dtype)
        return real(table, ids, clip)

    monkeypatch.setattr(ek, "gather", spy)
    im = _port_inference(jax_ncf, "bf16")
    assert im._module.mlp_dense_0.kernel.dtype == torch.bfloat16
    y = im.predict(_pairs(3, seed=1))
    assert y.dtype == np.float32
    assert dtypes == [torch.bfloat16] * 4


def test_an_int8_table_is_forward_only(jax_ncf):
    model = port_quantize.quantize_params(_port_model(jax_ncf[1]), "int8")
    table = model.mlp_user_table.embeddings
    with pytest.raises(RuntimeError):
        table.q.requires_grad_(True)
    model.train()
    with pytest.raises(RuntimeError, match="forward only"):
        model(torch.from_numpy(_pairs(4, seed=0)))


def test_quantize_needs_a_loaded_model():
    with pytest.raises(RuntimeError, match="load a model first"):
        InferenceModel(device="cpu").quantize("int8")


class _Opaque(Layer):
    """A built layer with a weight but no layer graph."""

    def __init__(self):
        super().__init__("opaque")
        self.w = torch.nn.Parameter(torch.ones(2, 3))
        self.built = True

    def forward(self, x):
        return x.to(self.w.dtype) @ self.w


def test_calibration_of_an_opaque_module_raises_jax_value_error():
    im = InferenceModel(device="cpu").load_keras(_Opaque())
    with pytest.raises(ValueError, match="keras-graph model"):
        im.quantize("int8", calibration_data=[np.ones((4, 2), np.float32)])
    # weight-only int8 quantizes any module, as the JAX package's does: its
    # forward reads the weight dequantized
    im.quantize("int8")
    w = im._module._modules["w"]
    assert port_quantize._is_qleaf(w) and w.q.dtype == torch.int8
    assert type(im._module).__name__ == "_Opaque"
    np.testing.assert_allclose(im.predict(np.ones((2, 2), np.float32)),
                               np.full((2, 3), 2.0), rtol=0, atol=1e-6)
    im = InferenceModel(device="cpu").load_keras(_Opaque()).quantize("bf16")
    assert im.predict(np.ones((2, 2), np.float32)).dtype == np.float32


WND_COLS = dict(wide_base_cols=["a"], wide_base_dims=[7],
                wide_cross_cols=["c"], wide_cross_dims=[30],
                indicator_cols=["i"], indicator_dims=[3],
                embed_cols=["e1"], embed_in_dims=[7], embed_out_dims=[4],
                continuous_cols=["x"])


def _wnd_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [np.stack([rng.integers(0, 7, n), 7 + rng.integers(0, 30, n)],
                     1).astype(np.int32),
            rng.integers(0, 3, (n, 1)).astype(np.int32),
            rng.integers(0, 7, (n, 1)).astype(np.int32),
            rng.random((n, 1)).astype(np.float32)]


@pytest.fixture(scope="module")
def jax_wnd():
    jm = JaxWideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                        **WND_COLS)._ensure_built()
    params, state = jm.build(jax.random.PRNGKey(3))
    return jm, jax.tree_util.tree_map(np.asarray, params), state


def _port_wnd(params):
    zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                      **WND_COLS).build(device="cpu")
    zoo.model.load_state_dict(from_jax_params(params), strict=True)
    return zoo


def test_weight_only_int8_raises_for_wide_and_deep_and_changes_nothing(
        jax_wnd):
    """Weight-only int8 Wide&Deep (the wide table, the embedding table and
    every Dense kernel int8) predicts as the JAX package's
    ``InferenceModel.quantize("int8")`` within 1e-5."""
    jm, params, state = jax_wnd
    x = _wnd_inputs(37, seed=2)
    want = np.asarray(JaxInferenceModel().load_keras(
        jm, params=params, model_state=state).quantize("int8").predict(x))
    zoo = _port_wnd(params)
    im = InferenceModel(device="cpu").load_keras(zoo.model).quantize("int8")
    qtree = jax_quantize.quantize_params(params, "int8")
    assert sorted(zoo.model.state_dict()) == sorted(from_jax_params(qtree))
    assert zoo.model.wide_linear._modules["table"].q.dtype == torch.int8
    got = im.predict(x)
    assert got.shape == (37, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # JAX's quantized tree loads into the quantized port model, and one
    # flat float32 row per record predicts the same
    zoo.model.load_state_dict(from_jax_params(qtree), strict=True)
    flat = np.concatenate([a.astype(np.float32) for a in x], axis=1)
    np.testing.assert_allclose(im.predict(flat), want, rtol=0, atol=1e-5)


def test_flat_rows_with_ids_past_float32_raise_or_stay_exact():
    """A cross column past 2^24 buckets: a flat float32 row cannot carry
    its ids, so predict raises instead of looking up a neighbouring row; a
    flat float64 row carries them exactly and predicts as the list of
    integer inputs; a fractional id raises too."""
    cols = dict(WND_COLS, wide_cross_dims=[(1 << 24) + 9])
    zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                      **cols).build(device="cpu")
    im = InferenceModel(device="cpu").load_keras(zoo.model).quantize("int8")
    x = _wnd_inputs(5, seed=6)
    x[0][:, 1] = 7 + (1 << 24) + np.arange(5) % 9  # past float32's 2^24
    want = im.predict(x)
    flat64 = np.concatenate([a.astype(np.float64) for a in x], axis=1)
    np.testing.assert_array_equal(im.predict(flat64), want)
    with pytest.raises(ValueError, match="whole number below 16777216"):
        im.predict(flat64.astype(np.float32))
    small = np.concatenate([a.astype(np.float32) for a in _wnd_inputs(
        5, seed=6)], axis=1)
    im.predict(small)
    small[0, 0] += 0.5
    with pytest.raises(ValueError, match="whole number"):
        im.predict(small)


def test_weight_only_int8_bert_matches_jax():
    from analytics_zoo_tpu.keras.layers import BERT as JaxBERT
    from analytics_zoo_tpu_torch.capture import bert_input_pack
    from analytics_zoo_tpu_torch.keras.layers import BERT
    cfg = dict(vocab=100, hidden_size=32, n_block=2, n_head=2,
               intermediate_size=64, max_position_len=64)
    jb = JaxBERT(**cfg)
    params, _ = jb.build(jax.random.PRNGKey(0), [(None, 24)] * 4)
    params = jax.tree_util.tree_map(np.asarray, params)
    rs = np.random.RandomState(0)
    tok = rs.randint(1, 100, (4, 24))
    for i, length in enumerate(rs.randint(4, 25, 4)):
        tok[i, length:] = 0
    x = bert_input_pack(tok)
    deq = jax_quantize.dequantize_params(
        jax_quantize.quantize_params(params, "int8"))
    want, _ = jb.call(deq, {}, [jnp.asarray(a) for a in x])
    pb = BERT(**cfg, name="bert")
    pb.build(torch.Generator(), [(None, 24)] * 4, torch.device("cpu"))
    pb.load_state_dict(from_jax_params(params), strict=True)
    port_quantize.quantize_params(pb.eval(), "int8")
    pb.load_state_dict(from_jax_params(
        jax_quantize.quantize_params(params, "int8")), strict=True)
    with torch.no_grad():
        got = pb([torch.from_numpy(a) for a in x])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_weight_only_int8_lm_logits_match_jax():
    from analytics_zoo_tpu.capture import TransformerLM as JaxLM
    from analytics_zoo_tpu_torch.capture import TransformerLM
    cfg = dict(vocab_size=128, hidden=32, n_block=2, n_head=2, max_len=64)
    jlm = JaxLM(seed=0, **cfg)
    params = jlm._init_params(jax.random.PRNGKey(0), None)
    qtree = jax_quantize.quantize_params(params, "int8")
    jlm._graph.estimator.set_params(jax_quantize.dequantize_params(qtree))
    tokens = np.random.RandomState(0).randint(0, 128, (4, 20))
    want = np.asarray(jlm.logits(tokens))
    plm = TransformerLM(seed=0, **cfg)
    plm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    port_quantize.quantize_params(plm, "int8")
    assert sorted(plm.state_dict()) == sorted(from_jax_params(
        jax.tree_util.tree_map(np.asarray, qtree)))
    got = plm.logits(tokens, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [1, 16, 17, 256])
@pytest.mark.parametrize("k,n", [(64, 2), (13, 8), (128, 32)])
def test_int8_matmul_pads_exactly(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = port_quantize.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


# -- serving -------------------------------------------------------------------


def test_serving_config_reads_quantize_from_yaml(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("model:\n  path: /m\nparams:\n  quantize: int8\n")
    assert ServingConfig.from_yaml(str(path)).quantize == "int8"
    path.write_text("model:\n  path: /m\n")
    assert ServingConfig.from_yaml(str(path)).quantize is None


def test_cluster_serving_with_quantize_int8_answers_as_a_direct_predict(
        jax_ncf, tmp_path):
    model_dir = str(tmp_path / "ncf")
    port = NeuralCF(**CFG).build(device="cpu")
    port.model.load_state_dict(from_jax_params(jax_ncf[1]), strict=True)
    port.save_model(model_dir)
    src = f"dir://{tmp_path}/spool"
    cfg = ServingConfig(model_path=model_dir, data_src=src, image_shape=(2,),
                        batch_size=8, quantize="int8")
    server = ClusterServing(cfg, queue=FileQueue(str(tmp_path / "spool")),
                            device="cpu")
    assert port_quantize._is_qleaf(server.model._module.mlp_dense_0.kernel)
    x = _pairs(19, seed=5)
    inq = InputQueue(src)
    for i, row in enumerate(x):
        inq.enqueue_tensor(f"r{i}", row)
    while server.serve_once():
        pass
    results = OutputQueue(src).dequeue()
    assert sorted(results) == sorted(f"r{i}" for i in range(len(x)))
    served = np.array([results[f"r{i}"]["value"] for i in range(len(x))],
                      np.float32)
    direct = InferenceModel(device="cpu").load_zoo(model_dir).quantize(
        "int8").predict(x)
    np.testing.assert_allclose(served, direct, rtol=1e-6, atol=0)
    want = np.asarray(_jax_inference(jax_ncf, "int8").predict(x))
    np.testing.assert_allclose(served, want, rtol=0, atol=1e-5)


def test_cluster_serving_with_quantize_int8_serves_wide_and_deep(
        jax_wnd, tmp_path):
    """Each record is one flat float32 row of the four inputs; served
    answers equal a direct quantized predict and JAX's within 1e-5."""
    model_dir = str(tmp_path / "wnd")
    _port_wnd(jax_wnd[1]).save_model(model_dir)
    x = _wnd_inputs(21, seed=4)
    flat = np.concatenate([a.astype(np.float32) for a in x], axis=1)
    src = f"dir://{tmp_path}/spool"
    cfg = ServingConfig(model_path=model_dir, data_src=src,
                        image_shape=(flat.shape[1],), batch_size=8,
                        quantize="int8")
    server = ClusterServing(cfg, queue=FileQueue(str(tmp_path / "spool")),
                            device="cpu")
    assert port_quantize._is_qleaf(
        server.model._module.wide_linear._modules["table"])
    inq = InputQueue(src)
    for i, row in enumerate(flat):
        inq.enqueue_tensor(f"r{i}", row)
    while server.serve_once():
        pass
    results = OutputQueue(src).dequeue()
    assert sorted(results) == sorted(f"r{i}" for i in range(len(flat)))
    served = np.array([results[f"r{i}"]["value"] for i in range(len(flat))],
                      np.float32)
    direct = InferenceModel(device="cpu").load_zoo(model_dir).quantize(
        "int8").predict(x)
    np.testing.assert_allclose(served, direct, rtol=1e-6, atol=0)
    jm, params, state = jax_wnd
    want = np.asarray(JaxInferenceModel().load_keras(
        jm, params=params, model_state=state).quantize("int8").predict(x))
    np.testing.assert_allclose(served, want, rtol=0, atol=1e-5)
