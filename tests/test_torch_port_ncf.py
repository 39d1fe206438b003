"""NeuralCF in the torch port against the JAX package on CPU.

Weights are made by the JAX model and carried across by name with
``convert.from_jax_params``; the forward must then agree within 1e-5 (the
two frameworks sum matrix products and softmax in different orders).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu_torch.convert import from_jax_params
from analytics_zoo_tpu_torch.models import NeuralCF as PortNeuralCF
from analytics_zoo_tpu_torch.models import ZooModel as PortZooModel
from torch_port_threads import torch_threads_per_worker  # noqa: F401

SMALL = dict(user_count=63, item_count=47, num_classes=2, user_embed=8,
             item_embed=8, hidden_layers=[16, 8], mf_embed=4)
FULL = dict(user_count=6040, item_count=3706, num_classes=2, user_embed=64,
            item_embed=64, hidden_layers=[128, 64, 32], mf_embed=32)


def _pairs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, cfg["user_count"] + 1, n),
                  rng.integers(0, cfg["item_count"] + 1, n)],
                 axis=1).astype(np.float32)
    x[0] = [-2, cfg["item_count"] + 40]  # clamped by validate_ids in both
    return x


def _both(cfg, seed=0):
    """A JAX NeuralCF with its params, and the port's with the same
    weights on the CPU."""
    jm = JaxNeuralCF(**cfg)._ensure_built()
    params, state = jm.build(jax.random.PRNGKey(seed))
    port = PortNeuralCF(**cfg).build(device="cpu")
    port.model.load_state_dict(
        from_jax_params(jax.tree_util.tree_map(np.asarray, params)),
        strict=True)
    return jm, params, state, port


@pytest.mark.parametrize("cfg,n", [(SMALL, 37), (FULL, 256)],
                         ids=["small", "full_width_batch256"])
def test_ncf_forward_matches_jax(cfg, n):
    jm, params, state, port = _both(cfg)
    x = _pairs(cfg, n, seed=n)
    want = jax.jit(lambda p, x: jm.call(p, state, x)[0])(params, x)
    with torch.inference_mode():
        got = port.model(torch.from_numpy(x)).numpy()
    assert got.shape == (n, cfg["num_classes"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_state_dict_keys_and_shapes_follow_the_jax_names():
    _, params, _, port = _both(SMALL)
    sd = port.model.state_dict()
    flat = {f"{layer}.{name}": tuple(np.shape(v))
            for layer, ps in params.items() for name, v in ps.items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == flat
    assert tuple(sd["mlp_user_table.embeddings"].shape) == (64, 8)
    assert tuple(sd["mlp_dense_0.kernel"].shape) == (16, 16)


def test_save_load_round_trip(tmp_path):
    port = PortNeuralCF(**SMALL).build(torch.Generator().manual_seed(5),
                                       device="cpu")
    path = str(tmp_path / "ncf")
    port.save_model(path)
    loaded = PortZooModel.load_model(path, device="cpu")
    assert isinstance(loaded, PortNeuralCF)
    for key, value in port.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[key], value)
    x = _pairs(SMALL, 16, seed=2)
    assert np.array_equal(loaded.predict(x), port.predict(x))


def test_zoo_model_json_is_byte_identical_to_jax(tmp_path):
    jax_model = JaxNeuralCF(**SMALL)
    jax_model.default_compile()
    jax_model.save_model(str(tmp_path / "jax"))
    PortNeuralCF(**SMALL).save_model(str(tmp_path / "port"))
    with open(tmp_path / "jax" / "zoo_model.json", "rb") as f:
        jax_json = f.read()
    with open(tmp_path / "port" / "zoo_model.json", "rb") as f:
        port_json = f.read()
    assert port_json == jax_json
    assert json.loads(port_json)["class"] == "NeuralCF"
    assert os.path.exists(tmp_path / "port" / "weights" / "model.pt")


def test_recommender_helpers_rank_by_class_then_probability():
    port = PortNeuralCF(**SMALL).build(device="cpu")
    users = np.array([1, 1, 1, 2, 2])
    items = np.array([3, 4, 5, 3, 6])
    preds = port.predict_user_item_pair(users, items)
    assert [(u, i) for u, i, _, _ in preds] == list(zip(users, items))
    assert all(c in (1, 2) and 0.0 <= p <= 1.0 for _, _, c, p in preds)
    top = port.recommend_for_user(users, items, max_items=2)
    assert sorted(top) == [1, 2] and len(top[1]) == 2
    keyed = sorted(((c, p) for u, _, c, p in preds if u == 1),
                   key=lambda t: (-t[0], -t[1]))
    assert [(c, p) for _, c, p in top[1]] == keyed[:2]
