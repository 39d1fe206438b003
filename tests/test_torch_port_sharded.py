"""The torch port's vocab-sharded embedding engine against the JAX package,
on the CPU.

The pieces are held one by one against the JAX functions they port, on the
same inputs made with numpy from a seed: the static-size unique routing
exactly; the per-unique segment sums and the row scatter-add within 1e-7
(f32 sums in another order); the sgd row update exactly and the adagrad
and lazy adam ones within 1e-6 (``rsqrt`` and ``pow`` may round apart by an
ulp); ``ShardSpec`` and ``exchange_cost_bytes`` exactly.

Then four gloo ranks on the CPU (``tests/torch_port_sharded_worker.py``,
which imports no JAX) train NeuralCF and Wide&Deep with sharded tables, and
their parameters are held within 1e-5 of the JAX package's runs on its
4-device CPU mesh from the same weights and batches, and of the port's own
replicated and straight runs.

The scatter's contract is the TPU kernel's: a negative row drops. JAX off
the TPU reads a row in ``[-rows, -1]`` from the end instead (``.at[]``'s
index normalisation); the engine sends no negative rows, so the two agree
on every row it sends (ROADMAP Queue C7).
"""
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from analytics_zoo_tpu.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.feature import FeatureSet as JaxFeatureSet
from analytics_zoo_tpu.keras import objectives as jax_objectives
from analytics_zoo_tpu.keras import optimizers as jax_optimizers
from analytics_zoo_tpu.models.recommendation.ncf import NeuralCF as JaxNCF
from analytics_zoo_tpu.models.recommendation.wide_and_deep import \
    WideAndDeep as JaxWideAndDeep
from analytics_zoo_tpu.ops import embedding_kernels as jax_ek
from analytics_zoo_tpu.parallel import embedding as jax_engine
from analytics_zoo_tpu_torch.convert import from_jax_params, shard_rows
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.keras import optimizers
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.ops import embedding_kernels as ek
from analytics_zoo_tpu_torch.parallel import embedding as engine
from analytics_zoo_tpu_torch.parallel.mesh import Mesh, shard_batch
from torch_port_threads import torch_threads_per_worker  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_sharded_worker.py")


def _load_worker():
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_port_sharded_worker",
                                                  WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_worker()


def _mesh(shards: int) -> Mesh:
    """A mesh description for the per-rank bodies that run no collective."""
    return Mesh(rank=0, size=shards, axis="data", group=None,
                backend="gloo", device=torch.device("cpu"))


def _jax_mesh(shards: int) -> JaxMesh:
    return JaxMesh(np.asarray(jax.devices()[:shards]), ("data",))


def _specs(vocab, dim, shards):
    return (engine.make_shard_spec(vocab, dim, mesh=_mesh(shards)),
            jax_engine.make_shard_spec(vocab, dim, mesh=_jax_mesh(shards)))


def _ids(rng, spec, n):
    """Ids with duplicates and SENTINELs."""
    ids = rng.integers(0, spec.vocab, n)
    ids[rng.random(n) < 0.2] = spec.padded
    ids[: n // 4] = ids[n // 4: n // 2]
    return ids.astype(np.int32)


# -- shard description -----------------------------------------------------------


@pytest.mark.parametrize("vocab,dim,shards", [(41, 8, 4), (100001016, 2, 4),
                                              (12, 4, 2), (3, 1, 4)])
def test_shard_spec_and_exchange_cost_equal_jax(vocab, dim, shards):
    port, ref = _specs(vocab, dim, shards)
    for field in ("shards", "rows_per_shard", "vocab", "dim", "padded",
                  "table_bytes", "device_bytes"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.axis == ref.axis == "data"
    for n in (shards, 64, 8192 * 3):
        assert engine.exchange_cost_bytes(port, n) == \
            jax_engine.exchange_cost_bytes(ref, n)
    assert engine.can_run(port, 16) == jax_engine.can_run(ref, 16)
    assert engine.can_run(port, 6) == jax_engine.can_run(ref, 6)


def test_one_rank_or_no_mesh_shards_nothing():
    assert engine.make_shard_spec(10, 4, mesh=_mesh(1)) is None
    assert engine.make_shard_spec(10, 4, mesh=None) is None
    assert engine.make_shard_spec(10, 4, mesh=_mesh(4), axis="model") is None


# -- routing, segment sums, scatter ------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("n", [1, 16, 64])
def test_routing_equals_jax_exactly(shards, n):
    port, ref = _specs(41, 8, shards)
    ids = _ids(np.random.default_rng(n + shards), port, n)
    got = engine._routing(port, torch.from_numpy(ids))
    want = jax_engine._routing(ref, jnp.asarray(ids))
    for name, a, b in zip(("u", "inv", "d", "local_row", "slot"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("shards", [2, 4])
def test_segment_grads_equal_jax(shards):
    port, ref = _specs(41, 8, shards)
    rng = np.random.default_rng(shards)
    ids = _ids(rng, port, 64)
    g = rng.standard_normal((64, 8)).astype(np.float32)
    _, inv, d, _, slot = engine._routing(port, torch.from_numpy(ids))
    _, jinv, jd, _, jslot = jax_engine._routing(ref, jnp.asarray(ids))
    got = ek.segment_grads(torch.from_numpy(g), inv, d, slot, shards)
    want = jax_ek.segment_grads(jnp.asarray(g), jinv, jd, jslot, shards)
    assert got.shape == (shards, 64, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


def _scatter_reference(g, rows, num_rows):
    """The TPU kernel's contract in numpy: rows outside [0, num_rows) drop,
    negatives included."""
    out = np.zeros((num_rows, g.shape[1]), np.float32)
    for j, r in enumerate(rows):
        if 0 <= r < num_rows:
            out[r] += g[j]
    return out


@pytest.mark.parametrize("n,dim,num_rows", [(0, 8, 5), (1, 2, 3),
                                            (255, 2, 7), (257, 8, 300),
                                            (64, 130, 11)])
def test_scatter_rows_plain_equals_jax(n, dim, num_rows):
    rng = np.random.default_rng(n + dim)
    rows = rng.integers(0, num_rows + 3, n).astype(np.int32)  # >= R drop
    rows[: n // 3] = rows[n // 3: 2 * (n // 3)]  # duplicates
    g = rng.standard_normal((n, dim)).astype(np.float32)
    got = ek.scatter_rows(torch.from_numpy(g), torch.from_numpy(rows),
                          num_rows)
    want = jax_ek.scatter_rows(jnp.asarray(g), jnp.asarray(rows), num_rows)
    assert got.shape == (num_rows, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    assert torch.equal(ek.scatter_rows_plain(
        torch.from_numpy(g), torch.from_numpy(rows), num_rows), got)


def test_scatter_rows_drops_negative_rows_as_the_tpu_kernel_does():
    rng = np.random.default_rng(3)
    rows = np.array([-1, -7, 0, 4, 4, 5, 9, -2], np.int32)
    g = rng.standard_normal((8, 3)).astype(np.float32)
    ek.reset_launch_counts()
    got = ek.scatter_rows(torch.from_numpy(g), torch.from_numpy(rows), 5)
    np.testing.assert_allclose(got.numpy(), _scatter_reference(g, rows, 5),
                               rtol=0, atol=1e-7)
    assert ek.launch_counts["scatter_rows"] == 0  # the CPU runs the plain
    # JAX off the TPU adds row -1 into the last row and -2 into the one
    # before it: the departure the docstring records
    jax_out = np.asarray(jax_ek.scatter_rows(jnp.asarray(g),
                                             jnp.asarray(rows), 5))
    np.testing.assert_allclose(jax_out[3], g[7], rtol=0, atol=1e-7)
    assert not np.allclose(jax_out[4], got.numpy()[4])


def test_scatter_wrapper_rejects_what_the_kernel_does_not_take():
    g, rows = torch.zeros(3, 2), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        ek.scatter_rows(g.double(), rows, 4)
    with pytest.raises(TypeError):
        ek.scatter_rows(g, rows.long(), 4)
    with pytest.raises(ValueError):
        ek.scatter_rows(g, rows[:2], 4)
    with pytest.raises(ValueError):
        ek.scatter_rows(torch.zeros(2, 3).t(), rows, 4)
    with pytest.raises(ValueError):
        ek.scatter_rows(g, rows, 0)


# -- row updates -------------------------------------------------------------------


def _row_case(kind, seed):
    """A block, its cotangent, a ``recv`` with SENTINELs and rows asked
    twice, and row state, the same in numpy for both packages."""
    port, ref = _specs(41, 4, 4)
    rps = port.rows_per_shard
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rps, 4)).astype(np.float32)
    grad = rng.standard_normal((rps, 4)).astype(np.float32)
    recv = rng.integers(0, rps, (4, 6)).astype(np.int32)
    recv[:, 4:] = rps                   # nothing asked: SENTINEL
    recv[1, :2] = recv[0, :2]           # one row asked by two ranks
    recv[2, 0] = rps - 1                # the last row, written too
    state = {}
    if kind == "adagrad":
        state = {"acc": (0.1 + rng.random((rps, 4))).astype(np.float32)}
    elif kind == "adam":
        state = {"mu": rng.standard_normal((rps, 4)).astype(np.float32),
                 "nu": rng.random((rps, 4)).astype(np.float32),
                 "count": np.int32(3)}
    return port, ref, table, grad, recv, state


HYPER = {"sgd": {"lr": 0.1}, "adagrad": {"lr": 0.05, "eps": 1e-7},
         "adam": {"lr": 1e-2, "b1": 0.9, "b2": 0.999, "eps": 1e-8}}


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_updates_equal_jax_update_body(kind, seed):
    port, ref, table, grad, recv, state = _row_case(kind, seed)
    hyper = HYPER[kind]
    opt = [jnp.asarray(state[k]) for k in ("acc", "mu", "nu", "count")
           if k in state]
    want = jax_engine._update_body(kind, hyper, ref, jnp.asarray(table),
                                   jnp.asarray(grad), jnp.asarray(recv),
                                   *opt)
    t = torch.from_numpy(table.copy())
    pstate = {k: torch.as_tensor(np.array(v)) for k, v in state.items()}
    new_state = engine.apply_row_update(kind, hyper, port, t,
                                        torch.from_numpy(grad),
                                        torch.from_numpy(recv), pstate)
    got = [t] + [new_state[k] for k in ("acc", "mu", "nu", "count")
                 if k in new_state]
    assert len(got) == len(want)
    tol = 0 if kind == "sgd" else 1e-6
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol)
    untouched = np.setdiff1d(np.arange(port.rows_per_shard), recv)
    assert np.array_equal(t.numpy()[untouched], table[untouched])


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_dense_update_equals_jax(kind):
    port, ref, table, grad, _recv, state = _row_case(kind, 5)
    hyper = HYPER[kind]
    want_t, want_s = jax_engine.apply_dense_update(
        kind, hyper, jnp.asarray(table), jnp.asarray(grad),
        {k: jnp.asarray(v) for k, v in state.items()})
    t = torch.from_numpy(table.copy())
    got_s = engine.apply_dense_update(
        kind, hyper, t, torch.from_numpy(grad),
        {k: torch.as_tensor(np.array(v)) for k, v in state.items()})
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), rtol=0,
                               atol=1e-6)
    assert sorted(got_s) == sorted(want_s)
    for k in got_s:
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_row_state_init_equals_jax(kind):
    table = np.ones((5, 3), np.float32)
    got = engine.init_row_state(kind, torch.from_numpy(table))
    want = jax_engine.init_row_state(kind, jnp.asarray(table))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == getattr(torch, str(want[k].dtype))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -- optimizers ------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, {"learningrate": 0.05},
                                    {"learningrate": 0.1,
                                     "weightdecay": 0.01}])
def test_adagrad_follows_optax(kwargs):
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    grads[0]["b"][:] = 0.0
    jopt, popt = jax_optimizers.Adagrad(**kwargs), optimizers.Adagrad(**kwargs)
    jp, jstate = dict(params), jopt.init(params)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = popt.init(pp)
    for g in grads:
        updates, jstate = jopt.update(g, jstate, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        popt.step(pp, {k: torch.from_numpy(v) for k, v in g.items()},
                  pstate)
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    assert popt.sparse_rows == jopt.sparse_rows
    assert optimizers.get("adagrad").name == "adagrad"


@pytest.mark.parametrize("make", [
    lambda m: m.SGD(0.1), lambda m: m.SGD(0.1, momentum=0.9),
    lambda m: m.SGD(0.1, weightdecay=0.01), lambda m: m.Adam(1e-3),
    lambda m: m.Adam(0.05, 0.8, 0.9, 1e-6), lambda m: m.Adagrad(0.05),
    lambda m: m.Adagrad(0.05, weightdecay=0.1)])
def test_sparse_rows_equal_jax(make):
    assert make(optimizers).sparse_rows == make(jax_optimizers).sparse_rows


def test_optax_adagrad_starts_its_accumulator_at_one_tenth():
    state = optax.adagrad(0.1).init({"a": jnp.zeros(2)})
    got = optimizers.Adagrad(0.1).init({"a": torch.zeros(2)})
    np.testing.assert_array_equal(np.asarray(state[0].sum_of_squares["a"]),
                                  got["acc"]["a"].numpy())


# -- conversion, batches ---------------------------------------------------------


def test_from_jax_params_takes_this_ranks_block():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((41, 3)).astype(np.float32)
    padded = np.concatenate([table, np.zeros((3, 3), np.float32)])
    tree = {"t": {"embeddings": table, "other": np.ones(2, np.float32)}}
    for rank in range(4):
        got = from_jax_params(tree, shard=(rank, 4),
                              sharded=["t.embeddings"])
        np.testing.assert_array_equal(got["t.embeddings"].numpy(),
                                      padded[rank * 11:(rank + 1) * 11])
        np.testing.assert_array_equal(got["t.other"].numpy(), np.ones(2))
        via_padded = from_jax_params({"t": {"embeddings": padded}},
                                     shard=(rank, 4),
                                     sharded=["t.embeddings"])
        assert torch.equal(via_padded["t.embeddings"], got["t.embeddings"])
    assert from_jax_params(tree)["t.embeddings"].shape == (41, 3)
    assert torch.equal(shard_rows(torch.arange(5.0)[:, None], 1, 2),
                       torch.tensor([[3.0], [4.0], [0.0]]))


def test_shard_batch_keeps_this_ranks_rows_and_rejects_a_ragged_batch():
    x = np.arange(16).reshape(8, 2)
    parts = [shard_batch(Mesh(r, 4, "data", None, "gloo",
                              torch.device("cpu")), (x, None))
             for r in range(4)]
    assert all(p[1] is None for p in parts)
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), x)
    with pytest.raises(ValueError):
        shard_batch(_mesh(3), x)


def test_a_global_batch_that_does_not_divide_over_the_ranks_raises():
    est = Estimator(NeuralCF(5, 4, 2, user_embed=2, item_embed=2,
                             hidden_layers=[4], mf_embed=2)._ensure_built(),
                    "sparse_categorical_crossentropy", optimizers.SGD(0.1),
                    device="cpu", mesh=_mesh(4))
    x = np.ones((12, 2), np.float32)
    from analytics_zoo_tpu_torch.feature import FeatureSet
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        est.train(FeatureSet.from_ndarrays(x, np.zeros(12, np.int32)),
                  batch_size=6)


# -- four gloo ranks against JAX's 4-device mesh ---------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(out_dir):
    port = _free_port()
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(out_dir)],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(4)]


def _jax_model(kind, shard):
    if kind == "ncf":
        return JaxNCF(W.USERS, W.ITEMS, 2, user_embed=8, item_embed=8,
                      hidden_layers=(16, 8), mf_embed=8,
                      shard_embeddings=shard).build_model()
    return JaxWideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                          shard_embeddings=shard,
                          **W.WND_COLUMNS)._ensure_built()


def _jax_estimator(kind, opt, params, mesh):
    est = JaxEstimator(model=_jax_model(kind, True),
                       loss_fn=jax_objectives.get(
                           "sparse_categorical_crossentropy"),
                       optimizer=opt, mesh=mesh, seed=7)
    if params is not None:
        est.set_params(params)
    return est


def _jax_data(kind):
    x, y = W.ncf_data() if kind == "ncf" else W.wnd_data()
    return JaxFeatureSet.from_ndarrays(x, y, shuffle=False)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_diff(a, b, trim=False):
    """Largest difference over the two trees' leaves; ``trim`` cuts each of
    ``b``'s tables to ``a``'s rows (drops the padding)."""
    assert sorted(a) == sorted(b)
    worst = 0.0
    for layer in a:
        assert sorted(a[layer]) == sorted(b[layer]), layer
        for k, va in a[layer].items():
            vb = np.asarray(b[layer][k])
            if trim:
                vb = vb[:va.shape[0]]
            assert va.shape == vb.shape, (layer, k)
            worst = max(worst, float(np.abs(va - vb).max()))
    return worst


@pytest.mark.pod(budget_s=20)
def test_four_gloo_ranks_train_as_jax_on_its_four_device_mesh(ctx, tmp_path):
    mesh = _jax_mesh(4)
    # the weights: the JAX sharded models' own init (tables padded)
    weights = {}
    for kind in ("ncf", "wnd"):
        est = _jax_estimator(kind, jax_optimizers.SGD(0.1), None, mesh)
        fs = _jax_data(kind)
        est._ensure_initialized(next(fs.train_iterator(W.B))[0])
        weights[kind] = _host(est.params)
    ref_shapes = _host(JaxNCF(W.USERS, W.ITEMS, 2, user_embed=8,
                              item_embed=8, hidden_layers=(16, 8),
                              mf_embed=8).build_model().build(
        jax.random.PRNGKey(0))[0])
    weights["ncf_replicated"] = {
        layer: {k: v[:ref_shapes[layer][k].shape[0]] for k, v in sub.items()}
        for layer, sub in weights["ncf"].items()}
    torch.save(weights, tmp_path / "weights.pt")
    t0 = time.perf_counter()
    procs = _start_ranks(tmp_path)
    try:
        # the JAX runs, while the ranks train
        want = {}
        for name, kind, opt, lr, _, _ in W.RUNS[:5]:
            if name.endswith("_replicated"):
                continue
            factory = {"sgd": jax_optimizers.SGD,
                       "adagrad": jax_optimizers.Adagrad,
                       "adam": jax_optimizers.Adam}[opt]
            est = _jax_estimator(kind, factory(lr), weights[kind], mesh)
            hist = est.train(_jax_data(kind), batch_size=W.B, epochs=1)
            want[name] = (_host(est.params), hist["loss_history"])
            if name == "ncf_sgd":
                x, _ = W.ncf_data()
                want_predict = np.asarray(est.predict(x, batch_size=16))
                want_eval = est.evaluate(_jax_data(kind), W.B)
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    wall = time.perf_counter() - t0
    got = torch.load(tmp_path / "results.pt", weights_only=False)

    for name, (params, losses) in want.items():
        assert got[name]["iterations"] == 4
        assert _max_diff(params, got[name]["params"]) <= 1e-5, name
        np.testing.assert_allclose(got[name]["loss"], losses, rtol=1e-5,
                                   err_msg=name)
        assert got[name]["plan"], name  # the row-subset path ran
    assert got["ncf_sgd"]["plan"] == ["mf_item_table.embeddings",
                                      "mf_user_table.embeddings",
                                      "mlp_item_table.embeddings",
                                      "mlp_user_table.embeddings"]
    assert got["wnd_sgd"]["plan"] == ["embed_table_a_e.embeddings",
                                      "wide_linear.table"]
    # predict (a padded tail batch) and evaluate are collective on a mesh
    np.testing.assert_allclose(got["ncf_sgd_predict"], want_predict, rtol=0,
                               atol=1e-5)
    assert got["ncf_sgd_evaluate"].keys() == want_eval.keys()
    for k, v in want_eval.items():
        np.testing.assert_allclose(got["ncf_sgd_evaluate"][k], v, rtol=1e-5)
    # sharded against the port's replicated (data-parallel) run
    rep = got["ncf_sgd_replicated"]
    assert rep["plan"] == [] and rep["exchange_bytes"] == {"exchange": 0,
                                                           "grad": 0}
    assert _max_diff(rep["params"], got["ncf_sgd"]["params"],
                     trim=True) <= 1e-5
    # a resume on the same ranks ends at the straight run's parameters
    assert got["ncf_adagrad_resumed"]["iterations"] == 8
    assert _max_diff(got["ncf_adagrad_straight"]["params"],
                     got["ncf_adagrad_resumed"]["params"]) <= 1e-5
    # adagrad's row state: touched rows moved, untouched ones stayed 0.1
    acc = got["ncf_adagrad"]["opt_state"]["embed"][
        "mlp_user_table.embeddings"]["acc"].numpy()
    assert (acc > np.float32(0.1)).any() and (acc == np.float32(0.1)).any()
    assert int(got["ncf_adam"]["opt_state"]["embed"][
        "mf_user_table.embeddings"]["count"]) == 4
    # each rank's exchange bytes, summed over the 4 ranks, are the JAX
    # package's analytic cost: 4 tables x 4 steps of 16 ids each
    spec = engine.make_shard_spec(W.USERS + 1, 8, mesh=_mesh(4))
    cost = engine.exchange_cost_bytes(spec, W.B)
    assert 4 * got["ncf_sgd"]["exchange_bytes"]["exchange"] == \
        4 * 4 * cost["forward_bytes"]
    assert 4 * got["ncf_sgd"]["exchange_bytes"]["grad"] == \
        4 * 4 * cost["grad_bytes"]
    # a checkpoint of 4 ranks does not resume on one
    one = Estimator(W.model("ncf", True), "sparse_categorical_crossentropy",
                    optimizers.Adagrad(0.05), device="cpu")
    with pytest.raises(ValueError, match="not saved by 1 rank"):
        one.load_checkpoint(str(tmp_path / "ckpt"))
    assert wall < 120
