"""Serving NCF through the torch port against the JAX package, on CPU.

Both packages' ``ClusterServing`` answer the same payloads, each on its own
``FileQueue`` spool; the values agree within 1e-5, the topN classes are
identical, and every claimed request gets exactly one terminal result. The
spool format is shared, so a JAX client can feed a port server and the
reverse.
"""
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.inference.inference_model import _bucket as jax_bucket
from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.serving import ClusterServing as JaxClusterServing
from analytics_zoo_tpu.serving import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving.queues import FileQueue as JaxFileQueue
# Not used here. tests/test_metric_names_lint.py expects the online tier's
# metrics in the JAX package's process-wide registry but does not import
# that tier itself, so it passes only in a test process that already has.
# Importing it at collection gives every test process those metrics. Drop
# this once that test imports the module in its own setup (ROADMAP notes).
import analytics_zoo_tpu.online  # noqa: F401,E402
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.inference.inference_model import \
    InferenceModel as PortInferenceModel
from analytics_zoo_tpu_torch.inference.inference_model import \
    _bucket as port_bucket
from analytics_zoo_tpu_torch.models import NeuralCF as PortNeuralCF
from analytics_zoo_tpu_torch.serving import ClusterServing, FileQueue
from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving import ServingConfig
from analytics_zoo_tpu_torch.serving.server import DEADLINE_ERROR, SHED_ERROR

CFG = dict(user_count=63, item_count=47, num_classes=2, user_embed=8,
           item_embed=8, hidden_layers=[16, 8], mf_embed=4)


@pytest.fixture(scope="module")
def models():
    """The JAX NCF with its params, and a port NCF carrying the same
    weights on the CPU; built once per module."""
    jm = JaxNeuralCF(**CFG)._ensure_built()
    params, state = jm.build(jax.random.PRNGKey(3))
    port = PortNeuralCF(**CFG).build(device="cpu")
    port.model.load_state_dict(
        from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, state, port


class CountingQueue(FileQueue):
    """A FileQueue that counts terminal results per uri."""

    def __init__(self, root):
        super().__init__(root)
        self.posts = {}
        self._lock = threading.Lock()

    def put_result(self, uri, value):
        with self._lock:
            self.posts[uri] = self.posts.get(uri, 0) + 1
        super().put_result(uri, value)


def _payloads(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, CFG["user_count"] + 1, n),
                  rng.integers(0, CFG["item_count"] + 1, n)],
                 axis=1).astype(np.float32)
    x[1] = [-4, 500]  # out of range: clamped by validate_ids
    return x


def _port_server(models, src, queue=None, **kw):
    port = models[3]
    cfg = ServingConfig(data_src=src, image_shape=(2,),
                        batch_size=kw.pop("batch_size", 8),
                        batch_wait_ms=5, **kw)
    im = PortInferenceModel(device="cpu").load_keras(port.model)
    return ClusterServing(cfg, model=im, queue=queue)


def _jax_server(models, src, **kw):
    jm, params, state, _ = models
    cfg = JaxServingConfig(data_src=src, image_shape=(2,), batch_size=8,
                           batch_wait_ms=5, **kw)
    im = JaxInferenceModel().load_keras(jm, params, state)
    return JaxClusterServing(cfg, model=im)


def _serve_all(server, n, rounds=200):
    served = 0
    for _ in range(rounds):
        served += server.serve_once()
        if served >= n:
            break
    return served


def _jax_forward(models, x):
    jm, params, state, _ = models
    return np.asarray(jax.jit(lambda p, x: jm.call(p, state, x)[0])(
        params, x))


@pytest.mark.parametrize("top", [None, 1])
def test_port_and_jax_servers_answer_alike(models, tmp_path, top):
    x = _payloads(21, seed=4)
    jsrc, psrc = f"dir://{tmp_path}/jax", f"dir://{tmp_path}/port"
    jax_server = _jax_server(models, jsrc, filter_top_n=top)
    pq = CountingQueue(str(tmp_path / "port"))
    port_server = _port_server(models, psrc, queue=pq, filter_top_n=top)
    jin, pin = JaxInputQueue(jsrc), InputQueue(psrc)
    for i, row in enumerate(x):
        jin.enqueue_tensor(f"r{i}", row)
        pin.enqueue_tensor(f"r{i}", row)
    assert _serve_all(jax_server, len(x)) == len(x)
    assert _serve_all(port_server, len(x)) == len(x)
    jres, pres = JaxOutputQueue(jsrc).dequeue(), OutputQueue(psrc).dequeue()
    assert sorted(pres) == sorted(jres) == sorted(f"r{i}" for i in
                                                   range(len(x)))
    assert pq.posts == {f"r{i}": 1 for i in range(len(x))}
    for uri in jres:
        if top is None:
            np.testing.assert_allclose(pres[uri]["value"],
                                       jres[uri]["value"], rtol=0, atol=1e-5)
        else:
            assert [t["class"] for t in pres[uri]["topN"]] == \
                [t["class"] for t in jres[uri]["topN"]]
            np.testing.assert_allclose(
                [t["prob"] for t in pres[uri]["topN"]],
                [t["prob"] for t in jres[uri]["topN"]], rtol=0, atol=1e-5)


def test_jax_client_feeds_port_server(models, tmp_path):
    """Cross-wire: a JAX InputQueue writes the spool, the port serves it,
    a JAX OutputQueue reads the results."""
    src = f"dir://{tmp_path}"
    x = _payloads(11, seed=5)
    jin = JaxInputQueue(src)
    for i, row in enumerate(x):
        jin.enqueue_tensor(f"x{i}", row)
    assert _serve_all(_port_server(models, src), len(x)) == len(x)
    out = JaxOutputQueue(src)
    got = np.array([out.query(f"x{i}", timeout_s=5.0)["value"]
                    for i in range(len(x))])
    np.testing.assert_allclose(got, _jax_forward(models, x), rtol=0,
                               atol=1e-5)


def test_port_client_feeds_jax_server(models, tmp_path):
    src = f"dir://{tmp_path}"
    x = _payloads(9, seed=6)
    pin = InputQueue(src)
    for i, row in enumerate(x):
        pin.enqueue_tensor(f"y{i}", row, criticality="critical")
    assert _serve_all(_jax_server(models, src), len(x)) == len(x)
    out = OutputQueue(src)
    got = np.array([out.query(f"y{i}", timeout_s=5.0)["value"]
                    for i in range(len(x))])
    np.testing.assert_allclose(got, _jax_forward(models, x), rtol=0,
                               atol=1e-5)


def test_port_server_consumes_batches_published_by_jax(models, tmp_path):
    """The JAX FileQueue's enqueue_many publishes one ``batch-*`` dir per
    batch; the port's claim flattens it like the JAX server does."""
    x = _payloads(6, seed=10)
    JaxFileQueue(str(tmp_path)).enqueue_many(
        [(f"b{i}", {"tensor": row.tolist(), "enqueue_t": time.time()})
         for i, row in enumerate(x)])
    assert any(p.name.startswith("batch-")
               for p in (tmp_path / "requests").iterdir())
    assert _serve_all(_port_server(models, f"dir://{tmp_path}"),
                      len(x)) == len(x)
    out = OutputQueue(f"dir://{tmp_path}")
    got = np.array([out.query(f"b{i}")["value"] for i in range(len(x))])
    np.testing.assert_allclose(got, _jax_forward(models, x), rtol=0,
                               atol=1e-5)
    assert list((tmp_path / "requests").iterdir()) == []


def test_spool_records_and_file_names_match_jax(tmp_path):
    jq, pq = (tmp_path / "j"), (tmp_path / "p")
    JaxInputQueue(f"dir://{jq}").enqueue_tensor("u", [1.0, 2.0],
                                                deadline_ms=50,
                                                criticality="sheddable")
    InputQueue(f"dir://{pq}").enqueue_tensor("u", [1.0, 2.0],
                                             deadline_ms=50,
                                             criticality="sheddable")
    (jname,), (pname,) = [list((d / "requests").iterdir()) for d in (jq, pq)]
    assert jname.name.split("-")[1][8:] == pname.name.split("-")[1][8:] \
        == ".s.json"
    assert len(jname.name) == len(pname.name)
    jrec, prec = json.loads(jname.read_text()), json.loads(pname.read_text())
    assert sorted(jrec) == sorted(prec)
    for key in ("uri", "tensor", "deadline_ms", "criticality"):
        assert jrec[key] == prec[key]


def test_expired_and_undecodable_records_get_error_results(models, tmp_path):
    src = f"dir://{tmp_path}"
    queue = CountingQueue(str(tmp_path))
    server = _port_server(models, src, queue=queue)
    inq = InputQueue(src)
    inq.enqueue_tensor("late", [1, 2], deadline_ms=1)
    inq.enqueue_tensor("fine", [3, 4])
    queue.enqueue("junk", {"enqueue_t": time.time(), "something": 1})
    queue.enqueue("image", {"image": "aGVsbG8="})
    queue.enqueue("wrong_shape", {"tensor": [1, 2, 3]})
    time.sleep(0.01)
    assert _serve_all(server, 5) == 5
    out = OutputQueue(src)
    res = {u: out.query(u, timeout_s=5.0) for u in
           ("late", "fine", "junk", "image", "wrong_shape")}
    assert res["late"]["error"] == DEADLINE_ERROR
    assert res["late"]["retriable"] is False
    assert "value" in res["fine"]
    for uri in ("junk", "image", "wrong_shape"):
        assert "error" in res[uri] and res[uri]["retriable"] is False
    assert queue.posts == {u: 1 for u in res}
    assert server.counters == {"shed": 0, "expired": 1, "errors": 3,
                               "claim_faults": 0}


def test_depth_shedding_answers_every_dropped_request(models, tmp_path):
    src = f"dir://{tmp_path}"
    queue = CountingQueue(str(tmp_path))
    server = _port_server(models, src, queue=queue, max_pending=3,
                          batch_size=2)
    inq = InputQueue(src)
    for i in range(7):
        inq.enqueue_tensor(f"s{i}", [i, i], criticality=(
            "sheddable" if i < 4 else "default"))
    while server.serve_once():
        pass
    res = OutputQueue(src).dequeue()
    assert queue.posts == {f"s{i}": 1 for i in range(7)}
    shed = sorted(u for u, r in res.items() if r.get("error") == SHED_ERROR)
    assert shed == ["s0", "s1", "s2", "s3"]  # the sheddable lane goes first
    assert all(res[u]["retriable"] for u in shed)
    assert server.counters["shed"] == 4


def test_pipelined_run_gives_one_terminal_per_request(models, tmp_path):
    src = f"dir://{tmp_path}"
    queue = CountingQueue(str(tmp_path))
    server = _port_server(models, src, queue=queue, batch_size=8)
    x = _payloads(43, seed=7)
    inq = InputQueue(src)
    for i, row in enumerate(x):
        inq.enqueue_tensor(f"p{i}", row)
    server.start()
    out = OutputQueue(src)
    deadline = time.monotonic() + 30
    while len(out.dequeue()) < len(x) and time.monotonic() < deadline:
        time.sleep(0.02)
    server.drain(timeout_s=30)
    assert server.terminal_state == "drained"
    assert queue.posts == {f"p{i}": 1 for i in range(len(x))}
    got = np.array([out.query(f"p{i}")["value"] for i in range(len(x))])
    np.testing.assert_allclose(got, _jax_forward(models, x), rtol=0,
                               atol=1e-5)
    assert server.records_served == len(x)
    assert server.latency_ms(0.5) is not None


def test_bucket_padding_three_records_in_a_four_bucket(models):
    port = models[3]
    seen = []
    hook = port.model.register_forward_hook(
        lambda mod, args, out: seen.append(tuple(args[0].shape)))
    try:
        im = PortInferenceModel(device="cpu").load_keras(port.model)
        x = _payloads(3, seed=8)
        y = im.predict(x)
    finally:
        hook.remove()
    assert seen == [(4, 2)]
    assert y.shape == (3, 2)
    padded = np.concatenate([x, x[-1:]])
    with torch.inference_mode():
        want = port.model(torch.from_numpy(padded)).numpy()[:3]
    assert np.array_equal(y, want)


def test_chunked_predict_and_buckets_match_jax(models):
    for n in list(range(0, 20)) + [255, 256, 257, 1000, 1024, 1025, 3000]:
        assert port_bucket(n) == jax_bucket(n)
    im = PortInferenceModel(device="cpu").load_keras(models[3].model)
    x = _payloads(37, seed=9)
    np.testing.assert_allclose(im.predict(x, batch_size=16),
                               _jax_forward(models, x), rtol=0, atol=1e-5)
    thunk = im.predict_async(x[:5])
    assert thunk().shape == (5, 2)


def test_serving_config_yaml_matches_jax(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(
        "model:\n  path: /models/ncf\n  type: zoo\n"
        "data:\n  src: dir:///spool\n  image_shape: [2]\n  filter: topN(1)\n"
        "params:\n  batch_size: 256\n  batch_wait_ms: 7\n"
        "  max_pending: 99\n  concurrent_num: 2\n  decode_threads: 3\n"
        "  deadline_ms: 40\n  shed_wait_ms: 30\n  claim_retries: 5\n")
    jcfg = JaxServingConfig.from_yaml(str(path))
    pcfg = ServingConfig.from_yaml(str(path))
    for field in ServingConfig.__dataclass_fields__:
        assert getattr(pcfg, field) == getattr(jcfg, field), field
