"""Training in the torch port against the JAX package's Estimator on CPU.

Both packages get the same data (made with numpy from a seed) and the same
initial weights: the JAX model's, set with ``Estimator.set_params`` there
and carried across by name with ``convert.from_jax_params`` here. Both
shuffle with ``np.random.default_rng(0)``, so they take the same batches in
the same order. Tolerances: loss history rtol 1e-5 and final parameters
atol 1e-5 (the two frameworks sum matrix products, softmax and scatter-adds
in different orders; Adam normalises each step, so the gap stays at
rounding size).
"""
import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import FeatureSet as JaxFeatureSet
from analytics_zoo_tpu.keras import optimizers as jax_optimizers
from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.models.recommendation import wide_and_deep as jax_wnd
from analytics_zoo_tpu_torch.common import context
from analytics_zoo_tpu_torch.common.triggers import (MaxIteration,
                                                     SeveralIteration)
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.feature import FeatureSet
from analytics_zoo_tpu_torch.keras import objectives, optimizers
from analytics_zoo_tpu_torch.models import NeuralCF, WideAndDeep, ZooModel
from analytics_zoo_tpu_torch.models.recommendation import wide_and_deep
from torch_port_threads import torch_threads_per_worker  # noqa: F401

#: 10 steps per epoch; every batch divides JAX's 8-device test mesh
N, BATCH = 320, 32
WND_COLUMNS = dict(
    wide_base_cols=["edu", "occ"], wide_base_dims=[4, 10],
    wide_cross_cols=["edu_occ"], wide_cross_dims=[50],
    indicator_cols=["work"], indicator_dims=[3],
    embed_cols=["edu_e", "occ_e"], embed_in_dims=[4, 10],
    embed_out_dims=[4, 4], continuous_cols=["age", "hours"])
#: __graft_entry__._make_ncf(small=True)
NCF_SMALL = dict(user_count=6040, item_count=3706, num_classes=2,
                 user_embed=8, item_embed=8, hidden_layers=[16, 8],
                 mf_embed=4)


def _wnd_data(seed=0, n=N):
    ci = jax_wnd.ColumnFeatureInfo(**WND_COLUMNS)
    rs = np.random.default_rng(seed)
    offsets = np.cumsum([0] + ci.wide_dims)[:-1]
    wide = np.stack([rs.integers(0, d, n) + off
                     for d, off in zip(ci.wide_dims, offsets)], 1)
    ind = np.stack([rs.integers(0, d, n) for d in ci.indicator_dims], 1)
    emb = np.stack([rs.integers(0, d, n) for d in ci.embed_in_dims], 1)
    cont = rs.random((n, 2)).astype(np.float32)
    y = rs.integers(0, 2, n).astype(np.float32)
    return [wide.astype(np.int32), ind.astype(np.int32),
            emb.astype(np.int32), cont], y


def _ncf_data(seed=0, n=N):
    rs = np.random.default_rng(seed)
    x = np.stack([rs.integers(1, NCF_SMALL["user_count"] + 1, n),
                  rs.integers(1, NCF_SMALL["item_count"] + 1, n)],
                 1).astype(np.float32)
    return x, rs.integers(0, 2, n).astype(np.float32)


def _wnd_pair():
    jax_zoo = jax_wnd.WideAndDeep("wide_n_deep", 2,
                                  hidden_layers=(8, 4), **WND_COLUMNS)
    port_zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                           **WND_COLUMNS)
    return jax_zoo, port_zoo


def _ncf_pair():
    return JaxNeuralCF(**NCF_SMALL), NeuralCF(**NCF_SMALL)


def _compiled_pair(make, seed=0):
    """A compiled JAX zoo model with its init params installed through
    ``set_params``, and the port's with the same weights on the CPU."""
    jax_zoo, port_zoo = make()
    jax_zoo.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    jm = jax_zoo._ensure_built()
    params, _ = jm.build(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    jm.get_estimator().set_params(params)
    port_zoo.build(device="cpu")
    port_zoo.model.load_state_dict(from_jax_params(params), strict=True)
    port_zoo.compile("adam", "sparse_categorical_crossentropy",
                     ["accuracy"])
    return jax_zoo, port_zoo


@pytest.mark.parametrize("make,data", [(_wnd_pair, _wnd_data),
                                       (_ncf_pair, _ncf_data)],
                         ids=["wide_and_deep", "ncf_small"])
def test_two_epochs_of_training_match_jax(make, data):
    jax_zoo, port_zoo = _compiled_pair(make)
    x, y = data()
    want = jax_zoo.fit(x, y, batch_size=BATCH, nb_epoch=2)
    got = port_zoo.fit(x, y, batch_size=BATCH, nb_epoch=2, device="cpu")
    assert got["iterations"] == want["iterations"] == 2 * N // BATCH
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-5, atol=0)
    jax_params = jax_zoo.model.get_estimator().get_params()
    port_params = port_zoo.model.get_estimator().get_params()
    assert port_params.keys() == jax_params.keys()
    for layer, ps in jax_params.items():
        for name, value in ps.items():
            np.testing.assert_allclose(port_params[layer][name], value,
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{layer}.{name}")
    xv, yv = data(seed=1, n=200)
    want_eval = jax_zoo.evaluate(xv, yv, batch_size=40)
    got_eval = port_zoo.evaluate(xv, yv, batch_size=40)
    assert got_eval.keys() == want_eval.keys() == {"accuracy"}
    np.testing.assert_allclose(got_eval["accuracy"], want_eval["accuracy"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_zoo.predict(xv, batch_size=64),
                               jax_zoo.predict(xv, batch_size=64),
                               rtol=0, atol=1e-5)


def test_featureset_batches_follow_the_jax_shuffle_stream():
    x, y = _wnd_data()
    port = FeatureSet.from_ndarrays(x, y).train_iterator(BATCH)
    ref = JaxFeatureSet.from_ndarrays(x, y).train_iterator(BATCH)
    for _ in range(2 * N // BATCH + 3):  # across epoch boundaries
        (px, py), (jx, jy) = next(port), next(ref)
        assert all(np.array_equal(a, b) for a, b in zip(px, jx))
        assert np.array_equal(py, jy)


def test_loss_metric_and_evaluate_without_metrics_match_jax():
    jax_zoo, port_zoo = _compiled_pair(_wnd_pair)
    x, y = _wnd_data(seed=3, n=200)
    want = jax_zoo.model.get_estimator()
    want.metrics = []
    port = port_zoo.model.get_estimator("cpu")
    port.metrics = []
    ref = want.evaluate(JaxFeatureSet.from_ndarrays(x, y), 48)
    got = port.evaluate(FeatureSet.from_ndarrays(x, y), 48)
    assert got.keys() == ref.keys() == {"loss"}
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {}), ("adam", {"learningrate": 0.05, "epsilon": 1e-3}),
    ("sgd", {"learningrate": 0.1}),
    ("sgd", {"learningrate": 0.1, "momentum": 0.9}),
    ("sgd", {"learningrate": 0.1, "momentum": 0.9, "nesterov": True,
             "weightdecay": 0.01})])
def test_optimizers_follow_optax_arithmetic(name, kwargs):
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    factory = {"adam": (jax_optimizers.Adam, optimizers.Adam),
               "sgd": (jax_optimizers.SGD, optimizers.SGD)}[name]
    jopt, popt = factory[0](**kwargs), factory[1](**kwargs)
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


def test_sparse_categorical_crossentropy_matches_jax():
    from analytics_zoo_tpu.keras import objectives as jax_objectives
    rng = np.random.default_rng(5)
    p = rng.random((16, 3)).astype(np.float32)
    p[0] = [1.0, 0.0, 0.0]  # clipped to [1e-7, 1 - 1e-7] in both
    p = p / p.sum(1, keepdims=True)
    y = rng.integers(0, 3, 16).astype(np.float32)
    y[0] = 1
    want = jax_objectives.sparse_categorical_crossentropy(y, p)
    got = objectives.get("sparse_categorical_crossentropy")(
        torch.from_numpy(y), torch.from_numpy(p))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert objectives._EPS == jax_objectives._EPS


# -- checkpoint and resume ----------------------------------------------------


def _port_wnd(params):
    zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                      **WND_COLUMNS).build(device="cpu")
    zoo.model.load_state_dict(params, strict=True)
    zoo.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    return zoo


@pytest.mark.parametrize("how", ["save_checkpoint", "epoch_trigger"])
def test_resume_from_epoch_one_equals_the_uninterrupted_run(how, tmp_path):
    x, y = _wnd_data()
    init = {k: v.clone() for k, v in WideAndDeep(
        "wide_n_deep", 2, hidden_layers=(8, 4), **WND_COLUMNS).build(
        torch.Generator().manual_seed(3), device="cpu"
    ).model.state_dict().items()}
    whole = _port_wnd(init)
    full = whole.fit(x, y, batch_size=BATCH, nb_epoch=2, device="cpu")

    first = _port_wnd(init)
    est = first.model.get_estimator("cpu")
    if how == "epoch_trigger":
        est.set_checkpoint(str(tmp_path))
        first.fit(x, y, batch_size=BATCH, nb_epoch=1)
        ckpt = str(tmp_path / f"snapshot-{N // BATCH}")
    else:
        first.fit(x, y, batch_size=BATCH, nb_epoch=1)
        ckpt = str(tmp_path / "epoch1")
        est.save_checkpoint(ckpt)

    resumed = _port_wnd({k: torch.zeros_like(v) for k, v in init.items()})
    est2 = resumed.model.get_estimator("cpu")
    est2.load_checkpoint(ckpt)
    assert (est2.global_step, est2.epoch) == (N // BATCH, 2)
    rest = resumed.fit(x, y, batch_size=BATCH, nb_epoch=2)
    assert rest["iterations"] == full["iterations"]
    assert rest["loss_history"] == full["loss_history"][N // BATCH:]
    want = whole.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    mu = est2.opt_state["mu"]
    for k, v in whole.model.get_estimator().opt_state["mu"].items():
        assert torch.equal(mu[k], v), k


def test_resume_from_a_mid_epoch_snapshot_replays_the_same_batches(
        tmp_path):
    x, y = _wnd_data()
    init = {k: v.clone() for k, v in WideAndDeep(
        "wide_n_deep", 2, hidden_layers=(8, 4), **WND_COLUMNS).build(
        torch.Generator().manual_seed(4), device="cpu"
    ).model.state_dict().items()}
    full = _port_wnd(init).fit(x, y, batch_size=BATCH, nb_epoch=2,
                               device="cpu")
    stop = N // BATCH + 5  # half way through epoch 2
    first = _port_wnd(init)
    est = first.model.get_estimator("cpu")
    est.set_checkpoint(str(tmp_path), SeveralIteration(5))
    est.train(FeatureSet.from_ndarrays(x, y), BATCH,
              end_trigger=MaxIteration(stop))
    resumed = _port_wnd(init)
    resumed.model.get_estimator("cpu").load_checkpoint(
        str(tmp_path / f"snapshot-{stop}"))
    rest = resumed.fit(x, y, batch_size=BATCH, nb_epoch=2)
    assert rest["loss_history"] == full["loss_history"][stop:]


def test_validation_during_fit_leaves_training_unchanged():
    x, y = _wnd_data()
    xv, yv = _wnd_data(seed=2, n=96)
    init = {k: v.clone() for k, v in WideAndDeep(
        "wide_n_deep", 2, hidden_layers=(8, 4), **WND_COLUMNS).build(
        torch.Generator().manual_seed(5), device="cpu"
    ).model.state_dict().items()}
    plain = _port_wnd(init).fit(x, y, batch_size=BATCH, nb_epoch=2,
                                device="cpu")
    validated = _port_wnd(init)
    seen = []
    est = validated.model.get_estimator("cpu")
    evaluate = est.evaluate
    est.evaluate = lambda *a: seen.append(evaluate(*a)) or seen[-1]
    got = validated.fit(x, y, batch_size=BATCH, nb_epoch=2,
                        validation_data=(xv, yv))
    assert got["loss_history"] == plain["loss_history"]
    assert len(seen) == 2 and all(set(r) == {"accuracy"} for r in seen)


def test_wide_and_deep_save_load_round_trip(tmp_path):
    zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                      **WND_COLUMNS).build(torch.Generator().manual_seed(1),
                                           device="cpu")
    zoo.save_model(str(tmp_path / "wnd"))
    loaded = ZooModel.load_model(str(tmp_path / "wnd"), device="cpu")
    assert isinstance(loaded, WideAndDeep)
    x, _ = _wnd_data(n=40)
    assert np.array_equal(loaded.predict(x), zoo.predict(x))
    jax_json = jax_wnd.WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                                   **WND_COLUMNS).get_config()
    assert zoo.get_config() == jax_json


def test_state_dict_names_follow_the_jax_params():
    jax_zoo, port_zoo = _wnd_pair()
    params, _ = jax_zoo._ensure_built().build(jax.random.PRNGKey(0))
    flat = {f"{layer}.{name}": tuple(np.shape(v))
            for layer, ps in params.items() for name, v in ps.items()}
    sd = port_zoo.build(device="cpu").model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == flat
    assert flat["wide_linear.table"] == (64, 2)
    assert "embed_table_occ_e.embeddings" in flat


def test_feature_helpers_match_jax():
    pd = pytest.importorskip("pandas")
    rs = np.random.default_rng(6)
    df = pd.DataFrame({
        "edu": rs.integers(0, 6, 50), "occ": rs.integers(0, 12, 50),
        "work": rs.integers(0, 3, 50), "age": rs.random(50),
        "hours": rs.random(50), "label": rs.integers(0, 2, 50),
        "tok": rs.choice(["a", "b", None], 50)})
    df["edu_occ"] = jax_wnd.cross_columns(df, ["edu", "occ"], 50)
    assert np.array_equal(
        wide_and_deep.cross_columns(df, ["edu", "tok"], 50),
        jax_wnd.cross_columns(df, ["edu", "tok"], 50))
    df["edu_e"], df["occ_e"] = df["edu"], df["occ"]
    ci = jax_wnd.ColumnFeatureInfo(**WND_COLUMNS)
    want_x, want_y = jax_wnd.features_from_dataframe(df, ci)
    got_x, got_y = wide_and_deep.features_from_dataframe(
        df, wide_and_deep.ColumnFeatureInfo(**WND_COLUMNS))
    for g, w in zip(got_x, want_x):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(got_y, want_y)


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_fit_needs_a_card_unless_the_cpu_is_asked_for(no_card):
    x, y = _wnd_data(n=64)
    zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4), **WND_COLUMNS)
    zoo.default_compile()
    with pytest.raises(context.NoCudaDeviceError):
        zoo.fit(x, y, batch_size=BATCH)
    with pytest.raises(context.NoCudaDeviceError):
        Estimator(zoo.model, "mse", "adam")
    assert zoo.fit(x, y, batch_size=BATCH, device="cpu")["iterations"] == 2
    assert zoo.model.device.type == "cpu"
