"""The Estimator's training loop in the torch port against the JAX
package's, on the CPU: ``steps_per_dispatch``, gradient clipping, freeze,
checksummed asynchronous snapshots with retention, elastic retry,
preemption, ``train_online``, the synchronous evaluate and predict forms
and the train loop's profiler phases.

Both packages get the same seeded numpy data and the same initial weights
(the JAX tree, carried across with ``convert.from_jax_params``) on a small
MLP (6 -> 16 relu -> 2 softmax, sparse categorical cross-entropy, 256 or
640 records, batch 64: JAX's CPU test mesh has 8 devices, so every batch
divides by 8). Tolerances: losses rtol 1e-5 and parameters atol 1e-5
against JAX (the frameworks sum products in different orders); the port
against itself (K steps a dispatch against one, a resumed or retried run
against the straight one, the synchronous forms against the pipelined
ones) bit for bit.
"""
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common.config import global_config as jax_config
from analytics_zoo_tpu.common.triggers import \
    SeveralIteration as JaxSeveralIteration
from analytics_zoo_tpu.common.triggers import TrainingState as JaxState
from analytics_zoo_tpu.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.feature import FeatureSet as JaxFeatureSet
from analytics_zoo_tpu.keras import Input as JaxInput
from analytics_zoo_tpu.keras import Model as JaxModel
from analytics_zoo_tpu.keras import Sequential as JaxSequential
from analytics_zoo_tpu.keras import layers as jax_layers
from analytics_zoo_tpu.keras import objectives as jax_objectives
from analytics_zoo_tpu.keras import optimizers as jax_optimizers
from analytics_zoo_tpu_torch.common import faults, metrics
from analytics_zoo_tpu_torch.common import profiler
from analytics_zoo_tpu_torch.common.config import global_config
from analytics_zoo_tpu_torch.common.triggers import (MaxIteration,
                                                     SeveralIteration,
                                                     TimeInterval,
                                                     TrainingState)
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.estimator import (CheckpointCorruptError,
                                               Estimator, PreemptedError)
from analytics_zoo_tpu_torch.estimator import estimator as est_mod
from analytics_zoo_tpu_torch.feature import FeatureSet
from analytics_zoo_tpu_torch.keras import Input, Model, Sequential
from analytics_zoo_tpu_torch.keras import optimizers
from analytics_zoo_tpu_torch.keras.layers import Dense
from torch_port_threads import torch_threads_per_worker  # noqa: F401

BATCH = 64
LOSS = "sparse_categorical_crossentropy"
RTOL, ATOL = 1e-5, 1e-5
_KEYS = ("faults.plan", "checkpoint.keep", "checkpoint.verify",
         "eval.async", "failure.retry_times", "failure.retry_interval_s",
         "profile.enabled")


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    yield
    faults.reset()
    profiler.set_enabled(False)
    for key in _KEYS:
        global_config().unset(key)


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {"d1": {"kernel": (rs.randn(6, 16) * 0.4).astype(np.float32),
                   "bias": (rs.randn(16) * 0.1).astype(np.float32)},
            "d2": {"kernel": (rs.randn(16, 2) * 0.4).astype(np.float32),
                   "bias": (rs.randn(2) * 0.1).astype(np.float32)}}


def _data(n=256, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 6).astype(np.float32),
            rs.randint(0, 2, n).astype(np.float32))


def _fs(n=256, shuffle=True, seed=0):
    x, y = _data(n, seed)
    return FeatureSet.from_ndarrays(x, y, shuffle=shuffle, seed=7)


def _jax_fs(n=256, shuffle=True, seed=0):
    x, y = _data(n, seed)
    return JaxFeatureSet.from_ndarrays(x, y, shuffle=shuffle, seed=7)


def _port_model():
    return Sequential([Dense(16, activation="relu", name="d1"),
                       Dense(2, activation="softmax", name="d2")])


def _port(opt=None, params=None, metrics_=None):
    model = _port_model().build(input_shape=(None, 6), device="cpu")
    model.load_state_dict(from_jax_params(params or _params()), strict=True)
    return Estimator(model, LOSS, opt or optimizers.Adam(0.01),
                     metrics=metrics_, device="cpu")


def _jax(opt=None, params=None, metrics_=None, model=None):
    model = model or JaxSequential([
        jax_layers.Dense(16, activation="relu", name="d1"),
        jax_layers.Dense(2, activation="softmax", name="d2")])
    est = JaxEstimator(model=model, loss_fn=jax_objectives.get(LOSS),
                       optimizer=opt or jax_optimizers.Adam(0.01),
                       metrics=metrics_)
    est.set_params(jax.tree_util.tree_map(np.asarray, params or _params()))
    return est


def _port_params(est):
    return {k: v.detach().clone() for k, v in est.model.state_dict().items()}


def _assert_params_match_jax(port_est, jax_est, atol=ATOL):
    want = jax_est.get_params()
    got = port_est.get_params()
    assert got.keys() == want.keys()
    for layer, ps in want.items():
        for name, value in ps.items():
            np.testing.assert_allclose(got[layer][name], value, rtol=0,
                                       atol=atol, err_msg=f"{layer}.{name}")


def _assert_same_params(a, b):
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


# -- steps_per_dispatch --------------------------------------------------


@pytest.fixture(scope="module")
def straight_640():
    """The port's K = 1 run over 640 unshuffled records, 3 epochs."""
    est = _port()
    hist = est.train(_fs(640, shuffle=False), BATCH, epochs=3)
    return hist, _port_params(est)


def test_k_steps_a_dispatch_equal_single_steps_and_jax(straight_640):
    """(counterpart of test_estimator.py:48) K = 4 over 10 batches an
    epoch takes groups of 4, 4, 2: bit for bit the K = 1 run, and JAX's
    K = 4 run within the tolerance."""
    hist1, params1 = straight_640
    est = _port()
    hist4 = est.train(_fs(640, shuffle=False), BATCH, epochs=3,
                      steps_per_dispatch=4)
    assert est.global_step == 30 and len(hist4["loss_history"]) == 30
    assert hist4["loss_history"] == hist1["loss_history"]
    _assert_same_params(_port_params(est), params1)
    jest = _jax()
    want = jest.train(_jax_fs(640, shuffle=False), BATCH, epochs=3,
                      steps_per_dispatch=4)
    np.testing.assert_allclose(hist4["loss_history"], want["loss_history"],
                               rtol=RTOL, atol=0)
    _assert_params_match_jax(est, jest)


def test_k_steps_on_shuffled_data_equal_single_steps():
    """The grouped feed draws the shuffle stream as the single-step one."""
    h1 = _port().train(_fs(640), BATCH, epochs=3)
    h4 = _port().train(_fs(640), BATCH, epochs=3, steps_per_dispatch=4)
    assert h1["loss_history"] == h4["loss_history"]


def test_max_iteration_quantizes_to_the_group():
    """(test_estimator.py:64) MaxIteration(3) under K = 2 ends at 4."""
    got = _port().train(_fs(), BATCH, end_trigger=MaxIteration(3),
                        steps_per_dispatch=2)
    from analytics_zoo_tpu.common.triggers import MaxIteration as JaxMax
    want = _jax().train(_jax_fs(), BATCH, end_trigger=JaxMax(3),
                        steps_per_dispatch=2)
    assert got["iterations"] == want["iterations"] == 4
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=RTOL, atol=0)


def test_periodic_snapshots_quantize_to_the_group(tmp_path):
    """(test_estimator.py:169) interval 3 under K = 2 over 8 steps:
    snapshots at 4 and 6, as JAX's."""
    est = _port()
    est.set_checkpoint(str(tmp_path / "port"), SeveralIteration(3))
    est.train(_fs(512), BATCH, epochs=1, steps_per_dispatch=2)
    jest = _jax()
    jest.set_checkpoint(str(tmp_path / "jax"), JaxSeveralIteration(3))
    jest.train(_jax_fs(512), BATCH, epochs=1, steps_per_dispatch=2)
    snaps = {side: sorted(int(d.split("-")[1])
                          for d in os.listdir(tmp_path / side))
             for side in ("port", "jax")}
    assert snaps["port"] == snaps["jax"] == [4, 6]


@pytest.mark.parametrize("interval,width", [(100, 8), (96, 8), (3, 1),
                                            (3, 4)])
def test_several_iteration_fires_on_crossings_as_jax(interval, width):
    """(test_common.py:79) the same checks fire on both sides."""
    checks = range(width, 1000, width)
    mine, theirs = SeveralIteration(interval), JaxSeveralIteration(interval)
    got = [i for i in checks
           if mine(TrainingState(iteration=i, dispatch_width=width))]
    want = [i for i in checks
            if theirs(JaxState(iteration=i, dispatch_width=width))]
    assert got == want and len(got) == len({i // interval for i in got})


# -- gradient clipping and freeze ----------------------------------------


@pytest.mark.parametrize("clip", [("l2", 0.1), ("const", (-0.01, 0.01)),
                                  ("const", (-0.02, 0.005))],
                         ids=["l2", "symmetric", "asymmetric"])
def test_gradient_clipping_matches_jax(clip):
    """(test_estimator.py:87) two epochs of Adam, clipped, against JAX's;
    the clip bites (the run differs from the unclipped one)."""
    est = _port()
    est.set_gradient_clipping(clip)
    got = est.train(_fs(), BATCH, epochs=2)
    jest = _jax()
    jest.set_gradient_clipping(clip)
    want = jest.train(_jax_fs(), BATCH, epochs=2)
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=RTOL, atol=0)
    _assert_params_match_jax(est, jest)
    free = _port()
    free.train(_fs(), BATCH, epochs=2)
    assert not torch.equal(free.model.d1.kernel, est.model.d1.kernel)


def test_keras_fit_hands_clipping_and_checkpoint_to_the_estimator(
        tmp_path):
    x, y = _data()
    model = _port_model()
    model.compile(optimizers.Adam(0.01), LOSS)
    model.set_constant_gradient_clipping(-0.01, 0.01)
    model.set_checkpoint(str(tmp_path), SeveralIteration(2))
    model.fit(x, y, batch_size=BATCH, nb_epoch=1, device="cpu",
              steps_per_dispatch=2)
    est = model.get_estimator()
    assert est._clip == ("const", (-0.01, 0.01))
    assert sorted(os.listdir(tmp_path)) == ["snapshot-2", "snapshot-4"]
    model.set_gradient_clipping_by_l2_norm(0.5)
    model.fit(x, y, batch_size=BATCH, nb_epoch=2)
    assert est._clip == ("l2", 0.5)


def test_freeze_matches_jax_and_leaves_frozen_layers_bit_for_bit():
    """A frozen layer gets no gradient and no update (its Adam moments
    stay zero); the rest trains as JAX's frozen run does."""
    est = _port()
    before = _port_params(est)
    est.model.freeze(["d1"])
    got = est.train(_fs(), BATCH, epochs=2)
    jest = _jax()
    jest.model.freeze(["d1"])
    want = jest.train(_jax_fs(), BATCH, epochs=2)
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=RTOL, atol=0)
    _assert_params_match_jax(est, jest)
    after = _port_params(est)
    for k in ("d1.kernel", "d1.bias"):
        assert torch.equal(after[k], before[k]), k
        assert not bool(est.opt_state["mu"][k].any())
    assert not torch.equal(after["d2.kernel"], before["d2.kernel"])
    # unfrozen, the layer trains again
    est.model.unfreeze()
    est.train(_fs(), BATCH, epochs=3)
    assert not torch.equal(est.model.d1.kernel, before["d1.kernel"])


def test_freeze_names_as_jax():
    """freeze / unfreeze / trainable_param_names / freeze_up_to and the
    ValueError for an unknown name, on a functional model, against JAX's
    model of the same layer names."""
    def graph(inp, dense):
        a = dense(8, name="a")(inp)
        b = dense(8, name="b")(a)
        return dense(2, name="c")(b)

    jin = JaxInput((4,))
    jm = JaxModel(jin, graph(jin, jax_layers.Dense))
    pin = Input((4,))
    pm = Model(pin, graph(pin, Dense))  # unbuilt, as jm
    assert pm.trainable_param_names() == jm.trainable_param_names() == [
        "a", "b", "c"]
    assert not pm.built
    for side in (pm, jm):
        side.freeze_up_to("b")
    assert pm.frozen_layers == jm.frozen_layers == frozenset({"a", "b"})
    assert pm.trainable_param_names() == jm.trainable_param_names()
    for side in (pm, jm):
        side.unfreeze("a")
    assert pm.frozen_layers == jm.frozen_layers == frozenset({"b"})
    for side in (pm, jm):
        side.unfreeze()
        side.freeze()
    assert pm.frozen_layers == jm.frozen_layers == frozenset(
        {"a", "b", "c"})
    for side in (pm, jm):
        with pytest.raises(ValueError, match="unknown layer name"):
            side.freeze(["a", "nope"])


# -- snapshots: manifest, retention, fallback ----------------------------


def _trained(tmp_path, epochs=2, keep=None):
    if keep is not None:
        global_config().set("checkpoint.keep", keep)
    est = _port(optimizers.SGD(0.05))
    est.set_checkpoint(str(tmp_path), SeveralIteration(1))
    est.train(_fs(), BATCH, epochs=epochs)
    return est


def test_manifest_written_and_verified(tmp_path):
    """(test_chaos.py:104) every snapshot holds a manifest of its files,
    and loads after verification."""
    write = metrics.histogram("ckpt.write_seconds")
    verify = metrics.histogram("ckpt.verify_seconds")
    writes, verifies = write.count(), verify.count()
    est = _trained(tmp_path)
    assert write.count() - writes == 8
    snap = est._latest_snapshot()
    with open(os.path.join(snap, "zoo_manifest.json")) as f:
        manifest = json.load(f)
    size = os.path.getsize(os.path.join(snap, est_mod.CHECKPOINT_FILE))
    assert manifest["version"] == 1
    assert manifest["files"][est_mod.CHECKPOINT_FILE][0] == size
    est2 = _port(optimizers.SGD(0.05))
    est2.load_checkpoint(snap)
    assert verify.count() == verifies + 1
    assert est2.global_step == est.global_step == 8
    _assert_same_params(_port_params(est2), _port_params(est))


def test_torn_snapshot_rejected_and_fallen_past(tmp_path):
    """(test_chaos.py:117) a torn newest snapshot raises on load; the
    valid-restore falls back one, counted by ckpt.fallback_total."""
    est = _trained(tmp_path)
    newest = est._latest_snapshot()
    faults.tear_snapshot(newest)
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        _port(optimizers.SGD(0.05)).load_checkpoint(newest)
    fallback = metrics.counter("ckpt.fallback_total")
    before = fallback.value()
    est3 = _port(optimizers.SGD(0.05))
    est3.set_checkpoint(str(tmp_path))
    restored = est3._restore_latest_valid()
    assert restored is not None and restored != newest
    assert est3.global_step == est.global_step - 1
    assert fallback.value() == before + 1


def test_retention_keeps_newest_k_and_verify_can_be_disabled(tmp_path):
    """(test_chaos.py:144, 150) checkpoint.keep 2 keeps the last two of
    8 writes; a poisoned manifest loads only with checkpoint.verify off."""
    est = _trained(tmp_path, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["snapshot-7", "snapshot-8"]
    snap = est._latest_snapshot()
    manifest = os.path.join(snap, "zoo_manifest.json")
    with open(manifest) as f:
        data = json.load(f)
    next(iter(data["files"].values()))[1] ^= 1
    with open(manifest, "w") as f:
        json.dump(data, f)
    global_config().set("checkpoint.verify", False)
    _port(optimizers.SGD(0.05)).load_checkpoint(snap)
    global_config().unset("checkpoint.verify")
    with pytest.raises(CheckpointCorruptError):
        _port(optimizers.SGD(0.05)).load_checkpoint(snap)


def test_a_failed_background_write_reaches_the_caller(tmp_path):
    """The ckpt.write site fails the last write on the writer thread; the
    fence at the end of train raises it, and the previous snapshot stays
    the newest whole one."""
    est = _port()
    est.set_checkpoint(str(tmp_path), SeveralIteration(2))
    faults.arm("ckpt.write", at=2)
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        est.train(_fs(), BATCH, epochs=1)
    assert sorted(os.listdir(tmp_path)) == ["snapshot-2"]


# -- elastic retry -------------------------------------------------------


def test_elastic_retry_falls_back_past_torn_newest(tmp_path):
    """(test_chaos.py:131) ckpt.corrupt tears snapshot 5, step 6 fails:
    training falls back to snapshot 4 and ends where the fault-free run
    ends, bit for bit (and at JAX's fault-free parameters)."""
    est = _port(optimizers.SGD(0.05))
    est.set_checkpoint(str(tmp_path), SeveralIteration(1))
    faults.arm("ckpt.corrupt", at=5, budget=1)
    faults.arm("train.step", at=6, budget=1)
    fallback = metrics.counter("ckpt.fallback_total")
    before = fallback.value()
    est.train(_fs(), BATCH, epochs=3)
    assert faults.fire_count("ckpt.corrupt") == 1
    assert faults.fire_count("train.step") == 1
    assert fallback.value() == before + 1
    assert est.epoch == 4 and est.global_step == 12
    clean = _port(optimizers.SGD(0.05))
    clean.train(_fs(), BATCH, epochs=3)
    _assert_same_params(_port_params(est), _port_params(clean))
    jest = _jax(jax_optimizers.SGD(0.05))
    jest.train(_jax_fs(), BATCH, epochs=3)
    _assert_params_match_jax(est, jest)


def _always_fails(est, calls):
    def step(*args):
        calls["n"] += 1
        raise RuntimeError("permanent failure")
    est._train_step = step


def test_exhausted_retries_restore_then_reach_the_caller(tmp_path):
    """(test_chaos.py:200) failure.retry_times retries, then the error
    reaches the caller with the newest valid snapshot restored."""
    x, y = _data(128)
    fs = FeatureSet.from_ndarrays(x, y)
    est = _port(optimizers.SGD(0.05))
    est.set_checkpoint(str(tmp_path), SeveralIteration(1))
    est.train(fs, BATCH, epochs=1)
    snap_params = _port_params(est)
    calls = {"n": 0}
    _always_fails(est, calls)
    budget = int(global_config().get("failure.retry_times"))
    assert budget == int(jax_config().get("failure.retry_times")) == 5
    with pytest.raises(RuntimeError, match="permanent failure"):
        est.train(fs, BATCH, epochs=2)
    assert calls["n"] == budget + 1
    assert est.global_step == 2
    _assert_same_params(_port_params(est), snap_params)
    del est._train_step
    scores = est.evaluate(fs, BATCH)
    assert np.isfinite(list(scores.values())).all()
    # the torn newest is skipped on the final restore too
    faults.tear_snapshot(est._latest_snapshot())
    _always_fails(est, calls)
    with pytest.raises(RuntimeError, match="permanent failure"):
        est.train(fs, BATCH, epochs=2)
    assert est.global_step == 1


def test_the_retry_budget_resets_after_the_interval(tmp_path):
    """With failure.retry_times 1, two failures further apart than
    failure.retry_interval_s are both retried; closer together, the
    second reaches the caller."""
    global_config().set("failure.retry_times", 1)
    for interval, survives in ((0.0, True), (3600.0, False)):
        global_config().set("failure.retry_interval_s", interval)
        est = _port(optimizers.SGD(0.05))
        est.set_checkpoint(str(tmp_path / str(interval)),
                           SeveralIteration(1))
        real, calls = est._train_step, {"n": 0}

        def flaky(*args, real=real, calls=calls):
            calls["n"] += 1
            if calls["n"] in (2, 5):
                raise RuntimeError("transient failure")
            return real(*args)

        est._train_step = flaky
        if survives:
            est.train(_fs(), BATCH, epochs=2)
            assert est.global_step == 8
        else:
            with pytest.raises(RuntimeError, match="transient failure"):
                est.train(_fs(), BATCH, epochs=2)


# -- preemption ----------------------------------------------------------


def test_preempt_site_writes_snapshot_and_marker(tmp_path):
    """(test_chaos.py:160) the train.preempt site at step 5: a final
    snapshot, JAX's marker, PreemptedError."""
    est = _port(optimizers.SGD(0.05))
    est.set_checkpoint(str(tmp_path), SeveralIteration(100))
    faults.arm("train.preempt", at=5)
    with pytest.raises(PreemptedError) as ei:
        est.train(_fs(), BATCH, epochs=3)
    assert ei.value.snapshot.endswith("snapshot-5")
    assert os.path.isdir(ei.value.snapshot)
    assert Estimator.preemption_marker(str(tmp_path)) == {
        "global_step": 5, "epoch": 2, "snapshot": "snapshot-5",
        "resumable": True}


def test_resume_after_preemption_is_bit_identical(tmp_path):
    """(test_chaos.py:172) K = 2 preempted at its third group resumes from
    the snapshot to the straight run's parameters, bit for bit, and the
    marker is consumed; the straight run is JAX's within the tolerance."""
    straight = _port(optimizers.SGD(0.05))
    straight.train(_fs(), BATCH, epochs=3)
    est_b = _port(optimizers.SGD(0.05))
    est_b.set_checkpoint(str(tmp_path), SeveralIteration(100))
    faults.arm("train.preempt", at=3)
    with pytest.raises(PreemptedError):
        est_b.train(_fs(), BATCH, epochs=3, steps_per_dispatch=2)
    faults.reset()
    est_c = _port(optimizers.SGD(0.05), params=_params(9))
    est_c.set_checkpoint(str(tmp_path))
    est_c.load_checkpoint(est_c._latest_snapshot())
    assert est_c.global_step == 6
    est_c.train(_fs(), BATCH, epochs=3, steps_per_dispatch=2)
    assert Estimator.preemption_marker(str(tmp_path)) is None
    _assert_same_params(_port_params(est_c), _port_params(straight))
    jest = _jax(jax_optimizers.SGD(0.05))
    jest.train(_jax_fs(), BATCH, epochs=3)
    _assert_params_match_jax(straight, jest)


def test_a_real_sigterm_is_a_preemption(tmp_path):
    """(test_chaos.py:190) SIGTERM to the process mid-run: PreemptedError,
    a marker naming a snapshot that exists, and the previous handler is
    back afterwards."""
    est = _port(optimizers.SGD(0.05))
    est.set_checkpoint(str(tmp_path), SeveralIteration(100))
    real, seen = est._train_step, {"n": 0}

    def step_then_sigterm(*args):
        seen["n"] += 1
        if seen["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*args)

    est._train_step = step_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(PreemptedError, match="preempted"):
        est.train(_fs(), BATCH, epochs=3)
    marker = Estimator.preemption_marker(str(tmp_path))
    assert marker["global_step"] == 2
    assert os.path.isdir(tmp_path / marker["snapshot"])
    assert signal.getsignal(signal.SIGTERM) == before


# -- train_online --------------------------------------------------------


def test_train_online_ends_at_max_steps_with_time_snapshots(tmp_path):
    """max_steps 8 ends at 8 with the straight run's losses (and JAX's
    train_online's); snapshots come by TimeInterval. Without max_steps the
    run is unbounded (Never) and ends by preemption."""
    straight = _port().train(_fs(), BATCH, end_trigger=MaxIteration(8))
    est = _port()
    est.set_checkpoint(str(tmp_path / "online"))
    got = est.train_online(_fs(), BATCH, max_steps=8,
                           snapshot_interval_s=1e-6)
    assert got["iterations"] == 8
    assert got["loss_history"] == straight["loss_history"]
    snaps = est._snapshot_candidates()
    assert len(snaps) >= 1 and snaps[-1][0] <= 8
    want = _jax().train_online(_jax_fs(), BATCH, max_steps=8)
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=RTOL, atol=0)
    assert TimeInterval(1e-6)(TrainingState()) is False  # arms first
    unbounded = _port()
    faults.arm("train.preempt", at=11)
    with pytest.raises(PreemptedError):
        unbounded.train_online(_fs(), BATCH)
    assert unbounded.global_step == 11


# -- synchronous evaluate and predict -------------------------------------


def test_sync_eval_equals_async_bit_for_bit_and_jax():
    """eval.async False against True: evaluate (a metric, and the compiled
    loss without metrics), a captured loss's evaluate and predict; bit for
    bit. The metric and loss paths and predict against JAX's within the
    tolerance."""
    x, y = _data(200, seed=3)
    val = FeatureSet.from_ndarrays(x, y, shuffle=False)
    est = _port(metrics_=["accuracy"])
    est.train(_fs(), BATCH, epochs=2)
    plain = Estimator(est.model, LOSS, optimizers.Adam(0.01), device="cpu")

    def captured(model, bx, by):
        return torch.nn.functional.cross_entropy(
            torch.log(model(bx)), by.long())

    direct = Estimator(est.model, None, optimizers.Adam(0.01),
                       direct_loss_fn=captured, device="cpu")
    runs = {}
    for mode in (True, False):
        global_config().set("eval.async", mode)
        runs[mode] = (est.evaluate(val, 48), plain.evaluate(val, 48),
                      direct.evaluate(val, 48),
                      est.predict(x, batch_size=48))
    for got, want in zip(runs[False][:3], runs[True][:3]):
        assert got == want
    assert np.array_equal(runs[True][3], runs[False][3])
    jest = _jax(metrics_=["accuracy"])
    jest.train(_jax_fs(), BATCH, epochs=2)
    jval = JaxFeatureSet.from_ndarrays(x, y, shuffle=False)
    want = jest.evaluate(jval, 48)
    want.update(_jax(params=jest.get_params()).evaluate(jval, 48))
    got = {**runs[False][0], **runs[False][1]}
    assert got.keys() == want.keys() == {"accuracy", "loss"}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5)
    np.testing.assert_allclose(runs[False][3], jest.predict(x, 48),
                               rtol=0, atol=ATOL)


# -- profiler phases and the config keys ---------------------------------


def test_train_loop_profiler_phases_and_cost():
    """Under profile.enabled the train loop books JAX's phases under loop
    "train", and the cost model holds one dispatch's flops (a group of 2:
    two steps) as FlopCounterMode counts them."""
    from torch.utils.flop_counter import FlopCounterMode
    phases = metrics.histogram("profile.phase_seconds",
                               labels=("loop", "phase"))
    names = ("host_input", "compile", "dispatch", "execute", "fetch")
    before = {p: phases.labels(loop="train", phase=p).count()
              for p in names}
    profiler.set_enabled(True)
    est = _port()
    est.train(_fs(), BATCH, epochs=1, steps_per_dispatch=2,
              end_trigger=MaxIteration(4))
    grew = {p: phases.labels(loop="train", phase=p).count() - before[p]
            for p in names}
    assert grew == {"host_input": 2, "compile": 1, "dispatch": 1,
                    "execute": 2, "fetch": 0}
    x, y = next(_fs().train_iterator(BATCH))
    twin = _port()
    twin._ensure_initialized(x)
    with FlopCounterMode(display=False) as counter:
        twin._train_step(torch.from_numpy(x), torch.from_numpy(y))
    assert est_mod._P_TRAIN._flops == 2 * counter.get_total_flops() > 0
    assert est_mod._P_TRAIN._bytes is None


def test_the_loop_config_keys_hold_jax_defaults():
    for key in ("failure.retry_times", "failure.retry_interval_s",
                "checkpoint.keep", "checkpoint.verify", "eval.async",
                "online.snapshot_interval_s"):
        assert global_config().get(key) == jax_config().get(key), key
        assert global_config()._flags[key].help == \
            jax_config()._flags[key].help, key
