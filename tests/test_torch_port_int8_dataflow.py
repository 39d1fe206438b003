"""The port's int8-dataflow ResNet (``ops/int8_dataflow.py``,
``Int8DataflowBackbone``, ``resnet(dataflow="int8")``) and the per-layer
``resnet(int8_training=True)`` against the JAX package's on the CPU.

Both packages get the same images (numpy, from a seed), weights, running
amaxes and statistics (JAX's init, carried across by name with
``convert.from_jax_params``) and the same cotangents. The int32 sums are
exact, and the first conv's codes use only delayed scales, so they agree
bit for bit. Past them the batch means and variances are f32 sums in
another order, so a code may flip by one where a value sits at a rounding
tie. In a free-running forward every such flip moves the next layer's
sums and statistics, and the flips cascade: at ResNet-18, 32 x 32, batch 8
the last stage normalizes over 8 values a channel, and the features end
up to tens of quantization steps apart. JAX's own per-layer int8 network
moves its output by 0.12 (probabilities) when its input moves by 1e-7
relative. So the whole backbone is held as each op is, from the same
inputs (measured on the CPU, each tolerance above what was measured):

- each conv of the backbone from JAX's int8 input and state: codes at most
  1 apart, at most 1e-4 of them flipped (1.2e-5 measured), the state it
  moves within 1e-5 of its scale (3.3e-6);
- the backward walking JAX's own tape: every gradient within 3e-2 of its
  scale (1.4e-2 measured: bf16 roundings of the cotangent compound over
  the walk, worst at the stem);
- the op-level forward and backward, the float mirror (1e-4 and 2e-4 of
  scale; 2.4e-5 and 4.5e-5 measured) and eval (bit for bit);
- the Estimator's first two bf16 steps from JAX's state, while the delayed
  scales are JAX's init: loss within 5e-3 relative (1.5e-3 measured), each
  parameter's update within 4e-2 relative L2 (1.5e-2), the state within
  2e-4 of its scale (5.1e-5; JAX's Estimator sums the batch statistics
  over the test's 8-device CPU mesh). From the third step the adapted
  scales make the cascade above the difference (7% in the loss), so it is
  not held;
- ``resnet(int8_training=True)``: eval bit for bit, and one f32 Estimator
  step from JAX's init (each conv requantizes with its input's maximum,
  so from the second step the cascade is the difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.feature import FeatureSet as JaxFeatureSet
from analytics_zoo_tpu.keras import objectives as jax_objectives
from analytics_zoo_tpu.keras import optimizers as jax_optimizers
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu.ops import int8_dataflow as j8
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.feature import FeatureSet
from analytics_zoo_tpu_torch.keras import optimizers
from analytics_zoo_tpu_torch.models.image import imageclassification as pic
from analytics_zoo_tpu_torch.ops import int8_dataflow as p8
from torch_port_threads import torch_threads_per_worker  # noqa: F401

LOSS = "sparse_categorical_crossentropy"
SIZE, BATCH, LR = 32, 8, 0.1
#: codes of one conv from the same int8 input: the share that may flip
FLIP_SHARE = 1e-4
#: the state a conv moves, relative to its scale
STATE_RTOL = 1e-5
#: gradients walking JAX's tape, relative to their scale
TAPE_GRAD_RTOL = 3e-2
#: the float mirror: forward and gradients, relative to their scale
FLOAT_RTOL, FLOAT_GRAD_RTOL = 1e-4, 2e-4
#: the Estimator's first two steps: loss, each update, the state
EST_LOSS_RTOL, EST_UPDATE_REL, EST_STATE_RTOL = 5e-3, 4e-2, 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    want = _f32(want)
    return float(np.abs(_f32(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def backbone():
    """JAX's ResNet-18 backbone at 32 x 32 with its init, the state after
    one JAX training step (delayed scales that fit the data), seeded
    images, and the port's backbone."""
    bbj = j8.Int8ResNetDataflow(18, (SIZE, SIZE, 3))
    params, state = _np(bbj.init(jax.random.PRNGKey(0)))
    x = np.random.RandomState(1).rand(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    _, state1 = bbj.apply(params, state, jnp.asarray(x), True)
    return bbj, p8.Int8ResNetDataflow(18, (SIZE, SIZE, 3)), params, \
        _np(state1), x


def _conv_operands(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 16, 16, 8).astype(np.float32)
    w = (rs.randn(3, 3, 8, 16) * 0.2).astype(np.float32)
    gamma = (1 + 0.1 * rs.randn(16)).astype(np.float32)
    beta = (0.1 * rs.randn(16)).astype(np.float32)
    sx = np.float32(np.abs(x).max() / 127.0)
    xq = np.asarray(j8._quant(jnp.asarray(x), sx))
    return xq, sx, w, gamma, beta, np.full((16,), 3.0, np.float32)


def test_quantize_weight_pc_matches_jax_exactly():
    w = np.random.RandomState(2).randn(3, 3, 8, 16).astype(np.float32)
    jq, js = j8._quantize_weight_pc(jnp.asarray(w))
    pq, ps = p8._quantize_weight_pc(torch.from_numpy(w))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)], ids=["s1", "s2"])
def test_conv_bn_forward_and_backward_match_jax(strides):
    """The forward from the same int8 input: codes at most one apart (none
    flipped here), statistics within 1e-6 of their scale; the backward
    from JAX's residuals: the bf16 input and weight gradients within one
    bf16 step (bit-equal here), gamma's and beta's within 1e-5."""
    xq, sx, w, gamma, beta, mid = _conv_operands()
    jy, jaux, jres = j8._conv_bn_fwd(
        jnp.asarray(xq), jnp.float32(sx), jnp.asarray(w), jnp.asarray(gamma),
        jnp.asarray(beta), jnp.asarray(mid), True, strides, "SAME")
    py, paux, pres = p8._conv_bn_fwd(
        torch.from_numpy(xq), torch.tensor(sx), torch.from_numpy(w),
        torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(mid), True, strides, "SAME")
    assert np.abs(_f32(pres[4]) - _f32(jres[4])).max() <= 1
    assert _rel(py, jy) <= 1e-6
    for got, want in zip(paux, jaux):
        assert _rel(got, want) <= 1e-6
    s_out = j8._scale_of(jnp.max(jnp.abs(jy)))
    yq = j8._quant(jy, s_out)
    g = np.random.RandomState(3).randn(*jy.shape).astype(np.float32)
    jd = j8._conv_bn_bwd(jres, True, strides, "SAME", yq,
                         jnp.asarray(g).astype(jnp.bfloat16))
    pd = p8._conv_bn_bwd(tuple(_t(list(jres))), True, strides, "SAME",
                         torch.from_numpy(np.array(yq)),
                         torch.from_numpy(g).to(torch.bfloat16))
    assert pd[0].dtype == torch.bfloat16 and pd[1].dtype == torch.float32
    for i, (got, want) in enumerate(zip(pd, jd)):
        assert _rel(got, want) <= (2.0 ** -8 if i < 2 else 1e-5), i


def test_add_relu_and_max_pooling_match_jax_exactly():
    rs = np.random.RandomState(4)
    a, b = (rs.randint(-127, 128, (2, 9, 9, 4)).astype(np.int8)
            for _ in range(2))
    jy, jm = j8._add_relu_fwd(jnp.asarray(a), jnp.float32(0.03),
                              jnp.asarray(b), jnp.float32(0.05))
    py, pm = p8._add_relu_fwd(torch.from_numpy(a), torch.tensor(0.03),
                              torch.from_numpy(b), torch.tensor(0.05))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    assert float(pm) == float(jm)
    jp = j8._maxpool_q(jnp.asarray(a), (3, 3), (2, 2), "SAME")
    pp = p8._maxpool_q(torch.from_numpy(a), (3, 3), (2, 2), "SAME")
    assert pp.dtype == torch.int8
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    dy = rs.randn(*jp.shape).astype(np.float32)
    jb = j8._maxpool_bwd(jnp.asarray(a), jnp.float32(0.1), (3, 3), (2, 2),
                         "SAME", jnp.asarray(dy).astype(jnp.bfloat16))
    pb = p8._maxpool_bwd(torch.from_numpy(a), torch.tensor(0.1), (3, 3),
                         (2, 2), "SAME",
                         torch.from_numpy(dy).to(torch.bfloat16))
    np.testing.assert_array_equal(_f32(pb), _f32(jb))


def _order(plan):
    """The tape's entries in order: each conv's spec, "pool" and "add"."""
    out = []
    for entry in plan:
        if entry[0] == "conv":
            out.append(entry[1])
        elif entry[0] == "pool":
            out.append("pool")
        else:
            out += list(entry[1]) + ([entry[2]] if entry[2] else []) + ["add"]
    return out


def test_backbone_convs_from_jax_inputs_flip_codes_by_at_most_one(backbone):
    """Each of the 20 convs of a training forward, run by the port from
    the int8 input JAX's walk gave it and from the same state: its output
    codes, and the state it moves."""
    bbj, bbp, params, state, x = backbone
    tape = []
    _, updates = bbj._forward(params, state, jnp.asarray(x), True, tape)
    tp, ts = _t(params), _t(state)
    flips = total = convs = 0
    for entry, spec in zip(tape[1:], _order(bbj.plan)):
        if spec in ("pool", "add"):
            continue
        res, yq, _ = entry
        moved = {}
        got, _ = bbp._run_conv(tp, ts, moved, spec, torch.from_numpy(
            np.array(res[0])), torch.tensor(np.array(res[1])), None, True)
        d = np.abs(_f32(got) - _f32(yq))
        assert d.max() <= 1, spec.name
        flips += int((d > 0).sum())
        total += d.size
        convs += 1
        for k, v in moved[spec.name].items():
            assert _rel(v, updates[spec.name][k]) <= STATE_RTOL, (spec.name,
                                                                  k)
    assert convs == 20 and flips <= FLIP_SHARE * total, flips / total


def test_backbone_backward_over_the_jax_tape_matches_jax(backbone):
    """The port's backward walking JAX's own tape (the same int8 tensors)
    against ``jax.vjp`` of the backbone: every parameter's gradient."""
    bbj, bbp, params, state, x = backbone
    tape = []
    bbj._forward(params, state, jnp.asarray(x), True, tape)
    (jf, jst), vjp = jax.vjp(
        lambda p: bbj.apply(p, state, jnp.asarray(x), True), params)
    g = np.random.RandomState(3).randn(*jf.shape).astype(np.float32)
    (jg,) = vjp((jnp.asarray(g).astype(jf.dtype),
                 jax.tree_util.tree_map(jnp.zeros_like, jst)))
    port_tape = [(torch.float32,)] + [
        ((tuple(_t(list(e[0]))), torch.from_numpy(np.array(e[1])),
          torch.tensor(np.array(e[2]))) if len(e) == 3 else tuple(_t(list(e))))
        for e in tape[1:]]
    dx, dparams = bbp._backward(port_tape, _t(params),
                                torch.from_numpy(g).to(torch.bfloat16))
    assert dx.dtype == torch.float32 and dx.shape == x.shape
    for name in params:
        for k in ("kernel", "gamma", "beta"):
            assert dparams[name][k].dtype == torch.float32
            assert _rel(dparams[name][k], jg[name][k]) <= TAPE_GRAD_RTOL, (
                name, k)


def test_backbone_free_run_starts_exact_then_flips_codes_by_one(backbone):
    """The port's own training forward: the stem's codes are JAX's bit for
    bit (delayed scales only); the first block's output codes differ by at
    most 2 at under 1e-2 of them (2 and 4.9e-3 measured: its two convs'
    one-code flips meet at the residual sum); the step's features and
    moved state are finite and of the same shapes."""
    bbj, bbp, params, state, x = backbone
    jt, pt = [], []
    bbj._forward(params, state, jnp.asarray(x), True, jt)
    feats, moved = bbp._forward(_t(params), _t(state), torch.from_numpy(x),
                                True, pt)
    assert feats.dtype == torch.bfloat16 and feats.shape == (BATCH, 1, 1,
                                                             512)
    for k in (4, 1):  # the stem's q_mid, then its output codes
        got = pt[1][0][k] if k == 4 else pt[1][k]
        want = jt[1][0][k] if k == 4 else jt[1][k]
        np.testing.assert_array_equal(_f32(got), _f32(want))
    first_block = [i for i, s in enumerate(_order(bbj.plan), 1)
                   if s == "add"][0]
    d = np.abs(_f32(pt[first_block][0]) - _f32(jt[first_block][0]))
    assert d.max() <= 2 and (d > 0).mean() <= 1e-2
    assert all(torch.isfinite(v).all() for st in moved.values()
               for v in (st.values() if isinstance(st, dict) else [st]))


def test_backbone_eval_matches_jax_bit_for_bit(backbone):
    bbj, bbp, params, state, x = backbone
    want, _ = bbj.apply(params, state, jnp.asarray(x), False)
    with torch.no_grad():
        got, same = bbp.apply(_t(params), _t(state), torch.from_numpy(x),
                              False)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_apply_float_matches_jax_with_gradients(backbone):
    bbj, bbp, params, _, x = backbone
    want, vjp = jax.vjp(lambda p: bbj.apply_float(p, jnp.asarray(x)),
                        params)
    tp = {k: {kk: torch.from_numpy(np.array(v)).requires_grad_()
              for kk, v in d.items()} for k, d in params.items()}
    got = bbp.apply_float(tp, torch.from_numpy(x))
    assert _rel(got, want) <= FLOAT_RTOL
    g = np.random.RandomState(4).randn(*want.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(g))
    got.backward(torch.from_numpy(g))
    for name in params:
        for k in ("kernel", "gamma", "beta"):
            assert _rel(tp[name][k].grad, jg[name][k]) <= FLOAT_GRAD_RTOL


@pytest.fixture(scope="module")
def jax_model():
    """JAX's ``resnet(18, 2, dataflow="int8")`` and its init (numpy, read
    only)."""
    jm = jic.resnet(18, 2, (SIZE, SIZE, 3), dataflow="int8")
    return (jm, *_np(jm.build(jax.random.PRNGKey(0))))


@pytest.fixture(scope="module")
def jax_int8_training_model():
    """JAX's ``resnet(18, 10, int8_training=True)`` and its init (numpy,
    read only)."""
    jm = jic.resnet(18, 10, (SIZE, SIZE, 3), int8_training=True)
    return (jm, *_np(jm.build(jax.random.PRNGKey(0))))


def _port_model(params, state, classes=2):
    model = pic.resnet(18, classes, (SIZE, SIZE, 3),
                       dataflow="int8").build(device="cpu")
    model.load_state_dict({**from_jax_params(params),
                           **from_jax_params(state)}, strict=True)
    return model


def test_the_model_holds_the_jax_trees_and_its_estimator_moves_them(
        jax_model):
    """``resnet(dataflow="int8")``'s state dict is JAX's params and state
    flattened (nested ``<conv>.kernel``, ``in_amax``, ``<block>_add.
    out_amax``...); the Estimator reads the state back as JAX's tree and
    writes it; a training forward moves it, an eval forward does not."""
    jm, params, state = jax_model
    model = pic.resnet(18, 2, (SIZE, SIZE, 3),
                       dataflow="int8").build(device="cpu")
    assert set(model.state_dict()) == (set(from_jax_params(params))
                                       | set(from_jax_params(state)))
    model = _port_model(params, state)
    est = Estimator(model, LOSS, optimizers.SGD(LR), device="cpu")
    got = est.get_model_state()
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(a, b)
    bumped = jax.tree_util.tree_map(lambda a: a * 2, state)
    est.set_model_state(bumped)
    assert float(model.int8_backbone.in_amax) == 8.0
    x = torch.rand(BATCH, SIZE, SIZE, 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.eval()
    with torch.no_grad():
        model(x)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    model.train()
    model(x)
    assert not torch.equal(before["int8_backbone.stem.running_mean"],
                           model.int8_backbone.stem.running_mean)


def test_dataflow_options_raise_as_in_jax():
    for kwargs in ({"dataflow": "int8", "padding_mode": "torch"},
                   {"dataflow": "int8", "int8_training": True}):
        with pytest.raises(ValueError):
            jic.resnet(18, 2, (SIZE, SIZE, 3), **kwargs)
        with pytest.raises(ValueError):
            pic.resnet(18, 2, (SIZE, SIZE, 3), **kwargs)
    with pytest.raises(ValueError):
        pic.resnet(18, 2, (SIZE, SIZE, 3), dataflow="fp8")
    feats = pic.resnet(50, 2, (40, 36, 3), include_top=False,
                       dataflow="int8")
    assert feats.outputs[0].shape == (None, 2, 2, 2048)


def _trace_of(opt_state):
    found = []

    def walk(s):
        if hasattr(s, "trace"):
            found.append(s.trace)
        elif isinstance(s, (tuple, list)):
            for c in s:
                walk(c)
    walk(opt_state)
    return found[0]


def test_estimator_bf16_steps_match_jax(jax_model):
    """Two ``Estimator.train`` steps of ``resnet(18, dataflow="int8")`` in
    bf16 with SGD(0.1, momentum 0.9) at batch 16, each from JAX's
    parameters, state and momentum trace before the step."""
    jm, params, state = jax_model
    batch, steps = 16, 2
    rs = np.random.RandomState(0)
    x = rs.rand(batch * steps, SIZE, SIZE, 3).astype(np.float32)
    y = rs.randint(0, 2, batch * steps).astype(np.float32)
    jest = JaxEstimator(jm, jax_objectives.get(LOSS),
                        jax_optimizers.SGD(LR, momentum=0.9),
                        compute_dtype=jnp.bfloat16)
    jest.set_params(params)
    jest.set_model_state(state)
    for k in range(steps):
        before = {"state": {**from_jax_params(_np(jest.params)),
                            **from_jax_params(_np(jest.model_state))},
                  "trace": (from_jax_params(_np(_trace_of(jest.opt_state)))
                            if k else {})}
        sl = slice(k * batch, (k + 1) * batch)
        jloss = jest.train(JaxFeatureSet.from_ndarrays(
            x[sl], y[sl], shuffle=False), batch_size=batch,
            epochs=k + 1)["loss_history"][0]
        want = {**from_jax_params(_np(jest.params)),
                **from_jax_params(_np(jest.model_state))}
        model = pic.resnet(18, 2, (SIZE, SIZE, 3),
                           dataflow="int8").build(device="cpu")
        model.load_state_dict(before["state"], strict=True)
        est = Estimator(model, LOSS, optimizers.SGD(LR, momentum=0.9),
                        device="cpu", compute_dtype=torch.bfloat16)
        est._ensure_initialized()
        with torch.no_grad():
            for name, value in before["trace"].items():
                est.opt_state["trace"][name].copy_(value)
        loss = est.train(FeatureSet.from_ndarrays(x[sl], y[sl],
                                                  shuffle=False),
                         batch_size=batch, epochs=est.epoch)[
            "loss_history"][0]
        assert abs(loss - jloss) <= EST_LOSS_RTOL * abs(jloss), (k, loss,
                                                                  jloss)
        got = model.state_dict()
        names = [n for n, _ in model.named_parameters()]
        prev = before["state"]
        for n in names:
            upd = float((want[n] - prev[n]).double().norm())
            err = float((got[n] - want[n]).double().norm())
            assert err <= EST_UPDATE_REL * upd, (k, n, err / upd)
        for n in want:
            if n not in names:
                assert _rel(got[n], want[n]) <= EST_STATE_RTOL, (k, n)


def test_int8_training_resnet_runs_every_conv_int8_and_matches_jax_in_eval(
        jax_int8_training_model):
    """``resnet(18, int8_training=True)``: every convolution layer takes
    the int8 route; in eval (running statistics, nothing to cascade) the
    output is JAX's within 1e-5 (measured 0); a training step's gradients
    are finite for every parameter."""
    jm, params, state = jax_int8_training_model
    model = pic.resnet(18, 10, (SIZE, SIZE, 3),
                       int8_training=True).build(device="cpu")
    model.load_state_dict({**from_jax_params(params),
                           **from_jax_params(state)}, strict=True)
    convs = [m for m in model.modules()
             if type(m).__name__ == "Convolution2D"]
    assert len(convs) == 20 and all(m.int8_training for m in convs)
    x = np.random.RandomState(1).rand(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    want, _ = jm.call(params, state, jnp.asarray(x), training=False)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=1e-5)
    model.train()
    model(torch.from_numpy(x).to(torch.bfloat16)).float().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_int8_training_estimator_first_step_matches_jax(
        jax_int8_training_model):
    """One ``Estimator.train`` step of ``resnet(18, int8_training=True)``
    in f32 with SGD(0.1, momentum 0.9) at batch 16, from JAX's init: loss
    within 1e-6 relative (0 measured), the update of all parameters within
    2e-2 relative L2 (9.5e-3) and each within ``EST_UPDATE_REL`` (1.3e-2,
    the stem's beta), the running statistics within ``EST_STATE_RTOL`` of
    their scale (4.6e-5). Only the first step is held: each conv
    requantizes its input with a scale from that input's maximum, so a
    code that JAX's f32 batch sums put across a rounding tie moves about
    ten codes of the next layer, and from JAX's state after the first step
    the port's second step is 0.28 apart (relative L2). JAX alone shows
    the same: its first step on a 1-device mesh is 0.57 of the update away
    from its step on the test's 8-device mesh (measured on the CPU)."""
    classes, batch = 10, 16
    jm, params, state = jax_int8_training_model
    rs = np.random.RandomState(0)
    x = rs.rand(batch, SIZE, SIZE, 3).astype(np.float32)
    y = rs.randint(0, classes, batch).astype(np.float32)
    jest = JaxEstimator(jm, jax_objectives.get(LOSS),
                        jax_optimizers.SGD(LR, momentum=0.9))
    jest.set_params(params)
    jest.set_model_state(state)
    jloss = jest.train(JaxFeatureSet.from_ndarrays(x, y, shuffle=False),
                       batch_size=batch, epochs=1)["loss_history"][0]
    want = {**from_jax_params(_np(jest.params)),
            **from_jax_params(_np(jest.model_state))}
    prev = {**from_jax_params(params), **from_jax_params(state)}
    model = pic.resnet(18, classes, (SIZE, SIZE, 3),
                       int8_training=True).build(device="cpu")
    model.load_state_dict(prev, strict=True)
    est = Estimator(model, LOSS, optimizers.SGD(LR, momentum=0.9),
                    device="cpu")
    loss = est.train(FeatureSet.from_ndarrays(x, y, shuffle=False),
                     batch_size=batch, epochs=1)["loss_history"][0]
    assert abs(loss - jloss) <= 1e-6 * abs(jloss), (loss, jloss)
    got = model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    err = sum(float((got[n] - want[n]).double().square().sum())
              for n in names)
    upd = sum(float((want[n] - prev[n]).double().square().sum())
              for n in names)
    assert err <= (2e-2) ** 2 * upd, (err / upd) ** 0.5
    for n in names:
        assert float((got[n] - want[n]).double().norm()) <= \
            EST_UPDATE_REL * float((want[n] - prev[n]).double().norm()), n
    for n in want:
        if n not in names:
            assert _rel(got[n], want[n]) <= EST_STATE_RTOL, n
