"""The port's ``gather_pool`` and the layers above it against the JAX
package on CPU.

The port's CPU path is the pool kernel's plain PyTorch version; the JAX side
off the TPU is ``_gather_pool_ref``, the reference its Pallas kernel is held
to. Where the two packages' contracts part (ids at or past the end of the
table, ROADMAP Queue C2) the port follows the TPU kernel, written out here
in numpy.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras.layers import core as jax_core
from analytics_zoo_tpu.keras.layers import embedding as jax_embedding
from analytics_zoo_tpu.ops import embedding_kernels as jax_ek
from analytics_zoo_tpu_torch.keras.layers import core as port_core
from analytics_zoo_tpu_torch.keras.layers import embedding as port_embedding
from analytics_zoo_tpu_torch.ops import embedding_kernels as ek
from analytics_zoo_tpu_torch.parallel import embedding as port_embed
from torch_port_threads import torch_threads_per_worker  # noqa: F401

ROWS, DIM, N, BAG = 23, 5, 11, 4
COMBINERS = [None, "sum", "mean", "sqrtn"]


def _inputs(seed, lo=0, hi=ROWS, shape=(N, BAG)):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    idx = rng.integers(lo, hi, shape).astype(np.int32)
    cot_shape = shape + (DIM,) if len(shape) == 1 else shape[:-1] + (DIM,)
    return table, idx, rng.standard_normal(cot_shape).astype(np.float32)


def _port_fwd_grad(table, idx, combiner, mask_negative, cot):
    t = torch.from_numpy(table).requires_grad_(True)
    out = ek.gather_pool(t, torch.from_numpy(idx), combiner, mask_negative)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def _kernel_numpy(table, idx, combiner, clip):
    """The TPU kernel's contract (``_gather_pool_kernel``, and the clip its
    wrapper applies with ``mask_negative=False``) written in numpy."""
    rows = table.shape[0]
    if clip:
        idx = np.clip(idx, 0, rows - 1)
    ok = (idx >= 0) & (idx < rows)
    emb = table[np.clip(idx, 0, rows - 1)] * ok[..., None]
    if combiner is None:
        return emb
    total = emb.sum(-2)
    count = np.maximum(ok.sum(-1, keepdims=True), 1).astype(np.float32)
    if combiner == "mean":
        return total / count
    if combiner == "sqrtn":
        return total / np.sqrt(count)
    return total


@pytest.mark.parametrize("mask_negative", [True, False])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_gather_pool_matches_the_jax_reference(combiner, mask_negative):
    # in range for both packages: with the mask, negative ids are padding
    lo = -2 if mask_negative else 0
    shape = (N, BAG)
    table, idx, cot = _inputs(7, lo=lo, shape=shape)
    if combiner is None:
        cot = np.random.default_rng(8).standard_normal(
            shape + (DIM,)).astype(np.float32)

    def f(tb):
        return jax_ek._gather_pool_ref(tb, jnp.asarray(idx), combiner,
                                       mask_negative)

    want = np.asarray(f(jnp.asarray(table)))
    want_grad = np.asarray(jax.grad(
        lambda tb: jnp.sum(f(tb) * cot))(jnp.asarray(table)))
    got, got_grad = _port_fwd_grad(table, idx, combiner, mask_negative, cot)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_ids_past_the_end_follow_the_tpu_kernel_contract(combiner):
    table, idx, cot = _inputs(3, lo=-3, hi=ROWS + 4)
    idx[0] = [ROWS, ROWS + 1, -1, 2]  # one real row among three masked ids
    got, grad = _port_fwd_grad(table, idx, combiner, True, cot)
    want = _kernel_numpy(table, idx, combiner, clip=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], _kernel_numpy(
        table, idx[:1, 3:], combiner, clip=False)[0], rtol=0, atol=1e-6)
    # the backward masks the same ids and counts the same way
    ok = (idx >= 0) & (idx < ROWS)
    count = np.maximum(ok.sum(-1, keepdims=True), 1).astype(np.float32)
    g = {"sum": cot, "mean": cot / count, "sqrtn": cot / np.sqrt(count)}[
        combiner]
    want_grad = np.zeros_like(table)
    for i, k in zip(*np.nonzero(ok)):
        want_grad[idx[i, k]] += g[i]
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-6)
    # clamped without the mask: every id counts
    got_clip, _ = _port_fwd_grad(table, idx, combiner, False, cot)
    np.testing.assert_allclose(
        got_clip, _kernel_numpy(table, idx, combiner, clip=True),
        rtol=0, atol=1e-6)


def test_jax_reference_off_the_tpu_gives_nan_rows_past_the_end():
    """Queue C2: ``jnp.take`` pads ids >= rows with NaN, where the TPU
    kernel (and the port) masks them to zero and out of the count."""
    table, idx, _ = _inputs(4)
    idx[0] = [ROWS, 1, 2, 3]
    ref = np.asarray(jax_ek._gather_pool_ref(
        jnp.asarray(table), jnp.asarray(idx), "mean", True))
    assert np.isnan(ref[0]).all() and np.isfinite(ref[1:]).all()
    got = ek.gather_pool(torch.from_numpy(table), torch.from_numpy(idx),
                         "mean").numpy()
    np.testing.assert_allclose(got[0], table[[1, 2, 3]].mean(0), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pool_accumulates_in_f32_and_returns_the_table_dtype(dtype):
    table, idx, _ = _inputs(5)
    t = torch.from_numpy(table).to(dtype)
    out = ek.pool(t, torch.from_numpy(idx), "mean", clip=False)
    assert out.dtype == dtype
    want = _kernel_numpy(t.float().numpy(), idx, "mean", clip=False)
    assert torch.equal(out, torch.from_numpy(want).to(dtype))


def test_pool_wrapper_rejects_what_the_kernel_does_not_take():
    table = torch.zeros(4, 3)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        ek.pool(table, ids.reshape(-1), "sum", clip=False)
    with pytest.raises(TypeError):
        ek.pool(table, ids.long(), "sum", clip=False)
    with pytest.raises(ValueError):
        ek.pool(table, ids, "max", clip=False)
    with pytest.raises(ValueError):
        ek.gather_pool(table, ids[0], "sum")
    ek.reset_launch_counts()
    assert ek.pool(table, ids, "sum", clip=False).shape == (2, 3)
    assert ek.launch_counts == {"gather_rows": 0, "gather_pool": 0,
                                "gather_int8": 0,
                                "scatter_rows": 0}


# -- layers above it ---------------------------------------------------------


@pytest.mark.parametrize("combiner", COMBINERS)
def test_sparse_embedding_matches_jax(combiner):
    rng = np.random.default_rng(11)
    table = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    ids = rng.integers(-2, ROWS + 3, (N, BAG)).astype(np.float32)
    jl = jax_embedding.SparseEmbedding(ROWS, DIM, combiner=combiner)
    want, _ = jl.call({"embeddings": jnp.asarray(table)}, {},
                      jnp.asarray(ids))
    pl = port_embedding.SparseEmbedding(ROWS, DIM, combiner=combiner)
    pl.build(torch.Generator().manual_seed(0), (None, BAG), "cpu")
    with torch.no_grad():
        pl.embeddings.copy_(torch.from_numpy(table))
    got = pl(torch.from_numpy(ids)).detach().numpy()
    assert got.shape == tuple(pl.compute_output_shape((N, BAG)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_validate_ids_allow_negative_keeps_padding():
    ids = torch.tensor([[-1, 3, 9], [0, -5, 4]], dtype=torch.int32)
    port_embed.reset_oob_ids()
    out = port_embed.validate_ids(ids, 5, allow_negative=True)
    assert out.tolist() == [[-1, 3, 4], [0, -5, 4]]
    assert port_embed.oob_ids_total() == 1
    assert port_embed.validate_ids(ids, 5).tolist() == [[0, 3, 4],
                                                        [0, 0, 4]]
    assert port_embed.oob_ids_total() == 1 + 3


@pytest.mark.parametrize("mode", port_core.Merge.MODES)
def test_merge_matches_jax(mode):
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((6, 4)).astype(np.float32) for _ in range(2)]
    want, _ = jax_core.Merge(mode).call({}, {}, [jnp.asarray(x) for x in xs])
    got = port_core.Merge(mode)([torch.from_numpy(x) for x in xs]).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    shape = port_core.Merge(mode).compute_output_shape([(None, 4)] * 2)
    assert shape == jax_core.Merge(mode).compute_output_shape(
        [(None, 4)] * 2)


def test_merge_defaults_to_sum_as_in_jax():
    for fn in (port_core.merge, port_core.Merge.__init__):
        assert inspect.signature(fn).parameters["mode"].default == "sum"
    assert inspect.signature(jax_core.merge).parameters["mode"].default \
        == "sum"
    xs = [torch.ones(2, 3), 2 * torch.ones(2, 3)]
    assert torch.equal(port_core.Merge()(xs), 3 * torch.ones(2, 3))


@pytest.mark.parametrize("act", ["softmax", "relu", "sigmoid", None])
def test_activation_matches_jax(act):
    x = np.random.default_rng(4).standard_normal((5, 3)).astype(np.float32)
    want, _ = jax_core.Activation(act).call({}, {}, jnp.asarray(x))
    got = port_core.Activation(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
