"""Serving images and forward functions through the torch port against the
JAX package, on CPU.

The image wire: base64 jpgs written by ``cv2.imencode`` and read back by
``cv2.imdecode`` (BGR), resized to ``image_shape`` when their size differs
and kept uint8 or made float32 by ``input_dtype``. Both packages give the
same strings and the same arrays, bit for bit, and each package's client
feeds the other's server.

A small ResNet (ResNet-18 at 32 x 32, ``preprocess="imagenet_uint8"``) is
served by both packages from the same weights: values within 1e-5 (the f32
forward's tolerance, ``tests/test_torch_port_resnet.py``), the same top-N
classes. A 2-block BERT classifier is served from float32 token rows
through ``load_forward`` and JAX's ``load_jax``, the four-array input built
on the device as ``bench.py`` builds it: within 1e-5 in f32 and 3e-2 in
bf16 (``tests/test_torch_port_bert.py``'s tolerances). Float32 rows carry
the ids exactly: the vocab (100 here, 30522 at BERT-base) is far below
2^24.
"""
import base64
import json
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.capture import text as jax_text
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu.serving import ClusterServing as JaxClusterServing
from analytics_zoo_tpu.serving import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import queues as jax_queues
from analytics_zoo_tpu_torch.capture import (BERTClassifier,
                                             bert_serving_forward)
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.models.image import imageclassification as pic
from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                             OutputQueue, ServingConfig)
from analytics_zoo_tpu_torch.serving import queues as port_queues
from torch_port_threads import torch_threads_per_worker  # noqa: F401

SIZE, CLASSES, BATCH = 32, 10, 8
BERT_CFG = dict(vocab=100, hidden_size=32, n_block=2, n_head=2,
                intermediate_size=64, max_position_len=64)
SEQ = 24


def _image(seed, h=SIZE, w=SIZE):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3),
                                               dtype=np.uint8)


def _as_served(imgs):
    """The batch a server decodes from these images sent as jpgs (an
    array, its jpg bytes or a lossless file all reach the spool as one)."""
    return np.stack([cv2.imdecode(cv2.imencode(".jpg", img)[1],
                                  cv2.IMREAD_COLOR) for img in imgs])


def _serve_all(server, n, rounds=200):
    served = 0
    for _ in range(rounds):
        served += server.serve_once()
        if served >= n:
            break
    return served


# -- the wire: encode, decode, _prepare ---------------------------------------


def test_encode_and_decode_image_match_jax_bit_for_bit():
    img = _image(0, 10, 12)
    enc = port_queues.encode_image(img)
    assert enc == jax_queues.encode_image(img)
    got, want = port_queues.decode_image(enc), jax_queues.decode_image(enc)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # encoded bytes pass through unencoded, in either package
    raw = cv2.imencode(".png", img)[1].tobytes()
    assert port_queues.encode_image(raw) == jax_queues.encode_image(raw) \
        == base64.b64encode(raw).decode()
    np.testing.assert_array_equal(port_queues.decode_image(
        port_queues.encode_image(raw)), img)  # png is lossless
    with pytest.raises(ValueError, match="decode failed"):
        port_queues.decode_image("aGVsbG8=")


@pytest.mark.parametrize("input_dtype", ["uint8", "float32"])
def test_prepare_and_example_batch_match_jax(input_dtype):
    """``_prepare`` of the same records, with a 10 x 12 image resized to
    8 x 8 and one already 8 x 8, equals JAX's ``ClusterServing._prepare``
    called unbound on a stub that has its config."""
    kw = dict(image_shape=(8, 8, 3), input_dtype=input_dtype, batch_size=4)
    port = types.SimpleNamespace(config=ServingConfig(**kw))
    jax_stub = types.SimpleNamespace(config=JaxServingConfig(**kw))
    for rec in ({"image": port_queues.encode_image(_image(1, 10, 12))},
                {"image": port_queues.encode_image(_image(2, 8, 8))},
                {"tensor": [[1.5, -2.0], [300.25, 7.0]]}):
        got = ClusterServing._prepare(port, rec)
        want = JaxClusterServing._prepare(jax_stub, rec)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32  # tensor records stay float32 always
    got = ClusterServing._example_batch(port)
    want = JaxClusterServing._example_batch(jax_stub)
    assert got.dtype == want.dtype == np.dtype(input_dtype)
    assert got.shape == want.shape == (4, 8, 8, 3)


def test_input_dtype_parses_from_yaml_and_bad_values_raise(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("data:\n  src: dir:///tmp/q\n  input_dtype: uint8\n"
                    "  image_shape: 8,8,3\n")
    cfg = ServingConfig.from_yaml(str(path))
    assert cfg.input_dtype == "uint8" and tuple(cfg.image_shape) == (8, 8, 3)
    path.write_text("data:\n  src: dir:///tmp/q\n")
    assert ServingConfig.from_yaml(str(path)).input_dtype == "float32"
    for bad in ("int8", "float16", "UINT8"):
        path.write_text(f"data:\n  input_dtype: {bad}\n")
        with pytest.raises(ValueError, match="input_dtype"):
            ServingConfig.from_yaml(str(path))
        with pytest.raises(ValueError, match="input_dtype"):
            JaxServingConfig.from_yaml(str(path))


# -- the small ResNet, served by both packages --------------------------------


@pytest.fixture(scope="module")
def resnets():
    """The JAX ResNet-18 (``imagenet_uint8``) with its params and state,
    one JAX InferenceModel over it (its compiled buckets shared by the
    tests), and the port's ResNet on the CPU with the same weights."""
    jm = jic.resnet(18, CLASSES, (SIZE, SIZE, 3), preprocess="imagenet_uint8")
    params, state = jax.tree_util.tree_map(
        np.asarray, jm.build(jax.random.PRNGKey(0)))
    jim = JaxInferenceModel().load_keras(jm, params, state)
    pm = pic.resnet(18, CLASSES, (SIZE, SIZE, 3),
                    preprocess="imagenet_uint8").build(device="cpu")
    pm.load_state_dict({**from_jax_params(params),
                        **from_jax_params(state)}, strict=True)
    return jim, pm.eval()


def _image_cfg(src, make, **kw):
    return make(data_src=src, image_shape=(SIZE, SIZE, 3), batch_size=BATCH,
                batch_wait_ms=5, **kw)


def _port_image_server(resnets, src, **kw):
    im = InferenceModel(device="cpu").load_keras(resnets[1])
    return ClusterServing(_image_cfg(src, ServingConfig, **kw), model=im)


def _jax_image_server(resnets, src, **kw):
    return JaxClusterServing(_image_cfg(src, JaxServingConfig, **kw),
                             model=resnets[0])


@pytest.mark.parametrize("top", [None, 3])
def test_served_resnet_matches_jax(resnets, tmp_path, top):
    """The same jpgs (7 of 32 x 32, one of 40 x 36 that both resize) on
    the uint8 wire: values within 1e-5, the same top-N classes; the short
    batch's pad rows are trimmed, one result a record."""
    images = [_image(10 + i) for i in range(7)] + [_image(9, 40, 36)]
    jsrc, psrc = f"dir://{tmp_path}/jax", f"dir://{tmp_path}/port"
    jax_server = _jax_image_server(resnets, jsrc, input_dtype="uint8",
                                   filter_top_n=top)
    port_server = _port_image_server(resnets, psrc, input_dtype="uint8",
                                     filter_top_n=top)
    jin, pin = JaxInputQueue(jsrc), InputQueue(psrc)
    for i, img in enumerate(images):
        jin.enqueue_image(f"i{i}", img)
        pin.enqueue_image(f"i{i}", img)
    assert _serve_all(jax_server, len(images)) == len(images)
    assert _serve_all(port_server, len(images)) == len(images)
    jres, pres = JaxOutputQueue(jsrc).dequeue(), OutputQueue(psrc).dequeue()
    assert sorted(pres) == sorted(jres) == sorted(f"i{i}" for i in
                                                   range(len(images)))
    for uri in jres:
        if top is None:
            np.testing.assert_allclose(pres[uri]["value"],
                                       jres[uri]["value"], rtol=0, atol=1e-5)
            assert len(pres[uri]["value"]) == CLASSES
        else:
            assert [t["class"] for t in pres[uri]["topN"]] == \
                [t["class"] for t in jres[uri]["topN"]]
            np.testing.assert_allclose(
                [t["prob"] for t in pres[uri]["topN"]],
                [t["prob"] for t in jres[uri]["topN"]], rtol=0, atol=1e-5)


def test_uint8_wire_reaches_the_model_as_uint8(resnets, tmp_path):
    """No host-side cast: the batch the port's model gets is uint8 on the
    uint8 wire (a quarter of float32's bytes) and float32 otherwise, the
    prewarm's batch included, and both give the same answers."""
    seen = []
    hook = resnets[1].register_forward_pre_hook(
        lambda m, args: seen.append(args[0][0].dtype if isinstance(
            args[0], (list, tuple)) else args[0].dtype))
    try:
        values = {}
        for wire in ("uint8", "float32"):
            src = f"dir://{tmp_path}/{wire}"
            seen.clear()
            server = _port_image_server(resnets, src, input_dtype=wire)
            inq = InputQueue(src)
            for i in range(3):
                inq.enqueue_image(f"w{i}", _image(20 + i))
            assert _serve_all(server, 3) == 3
            assert set(seen) == {getattr(torch, wire)} and len(seen) == 2
            res = OutputQueue(src).dequeue()
            values[wire] = np.array([res[f"w{i}"]["value"]
                                     for i in range(3)])
    finally:
        hook.remove()
    np.testing.assert_allclose(values["uint8"], values["float32"], rtol=0,
                               atol=1e-6)


def test_jax_image_client_feeds_port_server(resnets, tmp_path):
    """A JAX ``enqueue_image`` (an array, encoded bytes, a path) writes the
    spool, the port serves it, a JAX OutputQueue reads the results: equal
    to the port's forward of the decoded images (which
    ``test_served_resnet_matches_jax`` holds to JAX's)."""
    src = f"dir://{tmp_path}/q"
    imgs = [_image(30 + i) for i in range(3)]
    path = str(tmp_path / "img.png")
    cv2.imwrite(path, imgs[2])
    jin = JaxInputQueue(src)
    jin.enqueue_image("a", imgs[0])
    jin.enqueue_image("b", cv2.imencode(".jpg", imgs[1])[1].tobytes())
    jin.enqueue_image("c", path)
    assert _serve_all(_port_image_server(resnets, src, input_dtype="uint8"),
                      3) == 3
    out = JaxOutputQueue(src)
    got = np.array([out.query(u, timeout_s=5.0)["value"] for u in "abc"])
    with torch.no_grad():
        want = resnets[1](torch.from_numpy(_as_served(imgs))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_port_image_client_feeds_jax_server(resnets, tmp_path):
    src = f"dir://{tmp_path}/q"
    imgs = [_image(40 + i) for i in range(3)]
    path = str(tmp_path / "img.bmp")
    cv2.imwrite(path, imgs[2])
    pin = InputQueue(src)
    pin.enqueue_image("a", imgs[0], criticality="critical")
    pin.enqueue_image("b", cv2.imencode(".jpg", imgs[1])[1].tobytes(),
                      deadline_ms=60000)
    pin.enqueue_image("c", path)
    with pytest.raises(ValueError, match="unreadable"):
        pin.enqueue_image("d", str(tmp_path / "missing.jpg"))
    assert _serve_all(_jax_image_server(resnets, src, input_dtype="uint8"),
                      3) == 3
    out = OutputQueue(src)
    got = np.array([out.query(u, timeout_s=5.0)["value"] for u in "abc"])
    with torch.no_grad():
        want = resnets[1](torch.from_numpy(_as_served(imgs))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_image_records_fields_match_jax(tmp_path):
    jq, pq = tmp_path / "j", tmp_path / "p"
    img = _image(50)
    JaxInputQueue(f"dir://{jq}").enqueue_image("u", img, deadline_ms=50,
                                               criticality="sheddable")
    InputQueue(f"dir://{pq}").enqueue_image("u", img, deadline_ms=50,
                                            criticality="sheddable")
    (jname,), (pname,) = [list((d / "requests").iterdir()) for d in (jq, pq)]
    jrec, prec = json.loads(jname.read_text()), json.loads(pname.read_text())
    assert sorted(jrec) == sorted(prec)
    for key in ("uri", "image", "deadline_ms", "criticality"):
        assert jrec[key] == prec[key]


# -- BERT through load_forward ------------------------------------------------


def _tokens(n, seed=0):
    """Float32 token rows in [1, 100), each padded with 0 after a random
    length, as the serving wire carries them."""
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, BERT_CFG["vocab"], (n, SEQ))
    for i, length in enumerate(rs.randint(4, SEQ + 1, n)):
        tok[i, length:] = 0
    return tok.astype(np.float32)


def _bert_pair(bf16):
    """JAX's BERTClassifier served through ``load_jax`` with bench.py's
    forward, and the port's through ``load_forward`` with the same
    weights."""
    cfg = dict(BERT_CFG, compute_dtype=jnp.bfloat16 if bf16 else None)
    jc = jax_text.BERTClassifier(2, bert_config=cfg)
    params, state = jc.model.build(jax.random.PRNGKey(0), [(None, SEQ)] * 4)
    params = jax.tree_util.tree_map(np.asarray, params)

    def jax_forward(p, x):
        tokens = x.astype(jnp.int32)
        b, s = tokens.shape
        packed = [tokens, jnp.zeros((b, s), jnp.int32),
                  jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s)),
                  (tokens != 0).astype(jnp.float32)]
        y, _ = jc.model.call(p, state, packed, training=False)
        return y

    jim = JaxInferenceModel().load_jax(jax_forward, params)
    pc = BERTClassifier(2, bert_config=dict(
        BERT_CFG, compute_dtype="bfloat16" if bf16 else None))
    pc.build(SEQ, device="cpu")
    pim = InferenceModel(device="cpu").load_forward(
        bert_serving_forward(pc.model), from_jax_params(params))
    return jim, pim


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_served_bert_through_load_forward_matches_jax(tmp_path, bf16):
    jim, pim = _bert_pair(bf16)
    x = _tokens(11, seed=1)
    tol = 3e-2 if bf16 else 1e-5
    values = {}
    for name, im, make, server_cls, inq_cls, outq_cls in (
            ("jax", jim, JaxServingConfig, JaxClusterServing, JaxInputQueue,
             JaxOutputQueue),
            ("port", pim, ServingConfig, ClusterServing, InputQueue,
             OutputQueue)):
        src = f"dir://{tmp_path}/{name}"
        server = server_cls(make(data_src=src, image_shape=(SEQ,),
                                 batch_size=BATCH, batch_wait_ms=5),
                            model=im)
        inq = inq_cls(src)
        for i, row in enumerate(x):
            inq.enqueue_tensor(f"t{i}", row)
        assert _serve_all(server, len(x)) == len(x)
        res = outq_cls(src).dequeue()
        values[name] = np.array([res[f"t{i}"]["value"]
                                 for i in range(len(x))], np.float32)
    assert values["port"].shape == (len(x), 2)
    np.testing.assert_allclose(values["port"], values["jax"], rtol=0,
                               atol=tol)
    # the served answers are the direct forward's
    np.testing.assert_allclose(values["port"], pim.predict(x), rtol=0,
                               atol=0)


def test_load_forward_buckets_prewarm_and_slots():
    """Padding to a bucket with the last row, trimming, chunks, prewarm,
    ``concurrent_num`` slots, and the params moved once to the model's
    device; the forward runs under inference mode."""
    calls = []

    def forward(params, x):
        calls.append((x.shape[0], torch.is_inference_mode_enabled()))
        return x[:, :2] * params["w"] + params["b"]

    w, b = torch.tensor([2.0, -1.0]), torch.tensor([0.5, 0.25])
    im = InferenceModel(concurrent_num=2, device="cpu").load_forward(
        forward, {"w": w, "b": b})
    assert im.concurrent_num == 2 and im._slots._value == 2
    im.prewarm(np.zeros((5, 3), np.float32), buckets=(1, 16))
    assert calls == [(1, True), (16, True)]
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    calls.clear()
    np.testing.assert_array_equal(im.predict(x), x[:, :2] * [2, -1]
                                  + [0.5, 0.25])
    assert calls == [(8, True)]  # 5 rows padded to the bucket of 8
    calls.clear()
    got = im.predict_async(x, batch_size=2)()
    assert got.shape == (5, 2) and calls == [(2, True), (2, True), (1, True)]
    assert all(v.device.type == "cpu" for v in im._module.params.values())


def test_load_forward_quantize_follows_jax_opaque_forward():
    """bf16 casts the float params (the output comes back f32); weight-only
    int8 hands the forward each 2-D param as f32 ``q * scale`` and leaves
    1-D ones; calibrated int8 raises, as in the JAX package."""
    rs = np.random.RandomState(3)
    w = rs.randn(4, 3).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    x = rs.randn(5, 4).astype(np.float32)

    def jax_fwd(p, x):
        return x @ p["w"] + p["b"]

    def port_fwd(p, x):
        return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)

    for dtype in ("bf16", "int8"):
        want = JaxInferenceModel().load_jax(
            jax_fwd, {"w": w, "b": b}).quantize(dtype).predict(x)
        pim = InferenceModel(device="cpu").load_forward(
            port_fwd, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
        got = pim.quantize(dtype).predict(x)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="calibrated int8"):
        InferenceModel(device="cpu").load_forward(
            port_fwd, {"w": torch.from_numpy(w)}).quantize(
            "int8", calibration_data=[x])
