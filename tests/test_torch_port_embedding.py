"""Parity of the torch port's embedding path with the JAX package on CPU.

The same seeded numpy inputs go through ``analytics_zoo_tpu`` and
``analytics_zoo_tpu_torch`` (``device="cpu"``, the kernel's plain version).
A gather is a copy, so it must match exactly. Where JAX's CPU path
(``jnp.take``) departs from the TPU kernel's contract, on negative ids and
on ids >= rows in clip mode, the port is held against that contract written
out in numpy instead.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common.config import global_config as jax_config
from analytics_zoo_tpu.keras.layers import Embedding as JaxEmbedding
from analytics_zoo_tpu.ops import embedding_kernels as jax_ek
from analytics_zoo_tpu.parallel import embedding as jax_embed
from analytics_zoo_tpu_torch.common.config import global_config as port_config
from analytics_zoo_tpu_torch.keras.layers import Embedding as PortEmbedding
from analytics_zoo_tpu_torch.ops import embedding_kernels as port_ek
from analytics_zoo_tpu_torch.parallel import embedding as port_embed
from torch_port_threads import torch_threads_per_worker  # noqa: F401


@contextlib.contextmanager
def _knobs(**values):
    """Set the same config keys in both packages, restoring them after."""
    try:
        for key, value in values.items():
            name = key.replace("__", ".")
            jax_config().set(name, value)
            port_config().set(name, value)
        yield
    finally:
        for key in values:
            name = key.replace("__", ".")
            jax_config().unset(name)
            port_config().unset(name)


def _table(rows, dim, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, dim)).astype(np.float32)


def _contract(table, ids, clip):
    """The TPU kernel's contract in numpy: clip clamps; fill zeroes any
    row whose id is outside [0, rows)."""
    rows = table.shape[0]
    out = table[np.clip(ids, 0, rows - 1)]
    if not clip:
        out = np.where(((ids >= 0) & (ids < rows))[:, None], out, 0.0)
    return out.astype(table.dtype)


@pytest.mark.parametrize("dim", [3, 8, 64])
@pytest.mark.parametrize("n", [1, 7, 256, 257])
def test_gather_rows_clip_in_range_matches_jax(n, dim):
    table = _table(50, dim, seed=n)
    ids = np.random.default_rng(n + dim).integers(0, 50, n).astype(np.int32)
    want = np.asarray(jax_ek.gather_rows_clip(jnp.asarray(table),
                                              jnp.asarray(ids)))
    got = port_ek.gather_rows_clip(torch.from_numpy(table),
                                   torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dim", [3, 8, 64])
@pytest.mark.parametrize("n", [1, 7, 257])
def test_gather_rows_fill_matches_jax_including_ids_past_the_end(n, dim):
    table = _table(40, dim, seed=dim)
    # ids in [0, rows + 8): the tail past the end must come back as zeros
    ids = np.random.default_rng(n).integers(0, 48, n).astype(np.int32)
    ids[0] = 45
    want = np.asarray(jax_ek.gather_rows(jnp.asarray(table),
                                         jnp.asarray(ids)))
    got = port_ek.gather_rows(torch.from_numpy(table),
                              torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, want)
    assert not got[0].any()


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dim", [3, 64])
def test_out_of_range_ids_follow_the_tpu_kernel_contract(clip, dim):
    table = _table(20, dim, seed=3)
    ids = np.array([-5, -1, 0, 19, 20, 1000, 7], np.int32)
    got = port_ek.gather(torch.from_numpy(table), torch.from_numpy(ids),
                         clip=clip).numpy()
    assert np.array_equal(got, _contract(table, ids, clip))


def test_jax_cpu_take_departs_from_the_kernel_contract():
    """Off the TPU, JAX's clip gather is ``jnp.take``: -1 wraps to the last
    row and ids >= rows give NaN rows, where the TPU kernel (and the port)
    clamp. The NCF path never shows it, since validate_ids clamps first."""
    table = _table(10, 4, seed=1)
    ids = np.array([-1, 12], np.int32)
    jax_rows = np.asarray(jax_ek.gather_rows_clip(jnp.asarray(table),
                                                  jnp.asarray(ids)))
    assert np.array_equal(jax_rows[0], table[-1])
    assert np.isnan(jax_rows[1]).all()
    port_rows = port_ek.gather_rows_clip(torch.from_numpy(table),
                                         torch.from_numpy(ids)).numpy()
    assert np.array_equal(port_rows, table[[0, 9]])


@pytest.mark.parametrize("mode", ["clamp", "count", "raise"])
def test_validate_ids_matches_jax(mode):
    vocab = 30
    bad = np.array([[-3, 0], [29, 30], [7000, 5]], np.int32)
    good = np.array([[0, 1], [29, 5]], np.int32)
    with _knobs(data__validate_ids=mode):
        if mode == "raise":
            with pytest.raises(ValueError):
                jax_embed.validate_ids(jnp.asarray(bad), vocab)
            with pytest.raises(ValueError):
                port_embed.validate_ids(torch.from_numpy(bad), vocab)
            ids = good
        else:
            ids = bad
        jax_before = jax_embed._M_OOB.value()
        port_embed.reset_oob_ids()
        want = np.asarray(jax_embed.validate_ids(jnp.asarray(ids), vocab))
        jax.effects_barrier()
        got = port_embed.validate_ids(torch.from_numpy(ids), vocab).numpy()
        assert np.array_equal(got, want)
        assert port_embed.oob_ids_total() == \
            int(jax_embed._M_OOB.value() - jax_before)
        assert port_embed.oob_ids_total() == (3 if mode == "count" else 0)


@pytest.mark.parametrize("fused", [True, False])
def test_embedding_layer_forward_and_gradient_match_jax(fused):
    """The knob moves JAX between its kernel and its plain path; the port
    has one path, which must match JAX's either way."""
    rows, dim = 25, 8
    table = _table(rows, dim, seed=11)
    rng = np.random.default_rng(12)
    # float ids as the NCF Lambda hands them over, out-of-range included;
    # 2.7 and -0.5 truncate toward zero in both packages
    x = rng.integers(0, rows, (6, 2)).astype(np.float32)
    x[0, 0], x[1, 1], x[2, 0], x[3, 1] = -3.0, 1000.0, 2.7, -0.5
    weight = rng.standard_normal((6, 2, dim)).astype(np.float32)
    with _knobs(kernels__fused_embedding=fused):
        jl = JaxEmbedding(rows, dim, name="emb")
        params = {"embeddings": jnp.asarray(table)}

        def loss(p):
            out, _ = jl.call(p, {}, jnp.asarray(x))
            return jnp.sum(out * weight), out

        (_, jax_out), jax_grad = jax.value_and_grad(loss, has_aux=True)(
            params)
        pl = PortEmbedding(rows, dim, weights=table, name="emb")
        pl.build(torch.Generator(), (None, 2), torch.device("cpu"))
        port_out = pl(torch.from_numpy(x))
        (port_out * torch.from_numpy(weight)).sum().backward()
    assert np.array_equal(port_out.detach().numpy(), np.asarray(jax_out))
    np.testing.assert_allclose(pl.embeddings.grad.numpy(),
                               np.asarray(jax_grad["embeddings"]),
                               rtol=0, atol=1e-6)


def test_gather_clip_backward_is_an_index_add_into_a_zero_table():
    table = torch.from_numpy(_table(6, 3)).requires_grad_(True)
    ids = torch.tensor([[0, 5], [5, 9], [-2, 1]], dtype=torch.int32)
    g = torch.arange(18, dtype=torch.float32).reshape(3, 2, 3)
    port_ek.gather_rows_clip(table, ids).backward(g)
    want = np.zeros((6, 3), np.float32)
    np.add.at(want, np.clip(ids.numpy().reshape(-1), 0, 5),
              g.numpy().reshape(-1, 3))
    assert np.array_equal(table.grad.numpy(), want)
