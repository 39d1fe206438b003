"""One rank of the torch port's vocab-sharded training runs that
``tests/test_torch_port_sharded.py`` holds against the JAX package.

Imports neither JAX nor the JAX package. Started four times, once per rank,
with the usual variables:

    RANK=<r> WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=<port> \
        python tests/torch_port_sharded_worker.py <dir>

Each rank joins a gloo group through ``init_mesh(device="cpu")``, loads the
initial weights from ``<dir>/weights.pt`` (the JAX models' trees, sharded
tables padded, and NeuralCF's unpadded for the replicated run) and trains on the CPU: NeuralCF sharded with SGD, Adagrad
and lazy Adam, NeuralCF replicated (pure data parallelism) with SGD,
Wide&Deep sharded with SGD, and NeuralCF sharded with Adagrad for two
epochs, straight and resumed from an epoch-1 checkpoint. Rank 0 writes
every run's parameters (read whole with ``get_params``), losses and
exchange byte counts, and the sharded SGD model's ``predict`` and
``evaluate``, to ``<dir>/results.pt``.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from analytics_zoo_tpu_torch.estimator import Estimator  # noqa: E402
from analytics_zoo_tpu_torch.feature import FeatureSet  # noqa: E402
from analytics_zoo_tpu_torch.keras import optimizers  # noqa: E402
from analytics_zoo_tpu_torch.models import NeuralCF, WideAndDeep  # noqa
from analytics_zoo_tpu_torch.parallel import embedding as engine  # noqa
from analytics_zoo_tpu_torch.parallel.mesh import init_mesh  # noqa: E402

#: the sizes of the JAX package's own parity test (tests/
#: test_embedding_parity.py): 64 records, global batch 16, 4 steps an epoch
USERS, ITEMS, B, N, RANKS = 40, 36, 16, 64, 4
WND_COLUMNS = dict(
    wide_base_cols=["a"], wide_base_dims=[8],
    wide_cross_cols=["ab"], wide_cross_dims=[64],
    indicator_cols=["w"], indicator_dims=[4],
    embed_cols=["a_e"], embed_in_dims=[12], embed_out_dims=[4],
    continuous_cols=["age"])
#: (run, model, optimizer, learning rate, sharded, epochs); a run named
#: ``*_resumed`` stops after epoch 1, checkpoints and resumes
RUNS = (("ncf_sgd", "ncf", "sgd", 0.1, True, 1),
        ("ncf_adagrad", "ncf", "adagrad", 0.05, True, 1),
        ("ncf_adam", "ncf", "adam", 1e-2, True, 1),
        ("ncf_sgd_replicated", "ncf", "sgd", 0.1, False, 1),
        ("wnd_sgd", "wnd", "sgd", 0.1, True, 1),
        ("ncf_adagrad_straight", "ncf", "adagrad", 0.05, True, 2),
        ("ncf_adagrad_resumed", "ncf", "adagrad", 0.05, True, 2))


def ncf_data(n=N):
    rs = np.random.default_rng(0)
    x = np.stack([rs.integers(1, USERS + 1, size=(n,)),
                  rs.integers(1, ITEMS + 1, size=(n,))], 1).astype(np.int32)
    y = rs.integers(0, 2, size=(n,)).astype(np.int32)
    return x, y


def wnd_data(n=N):
    rs = np.random.RandomState(0)
    wide_dims = WND_COLUMNS["wide_base_dims"] + WND_COLUMNS["wide_cross_dims"]
    offsets = np.cumsum([0] + wide_dims)[:-1]
    wide = np.stack([rs.randint(0, d, n) + off
                     for d, off in zip(wide_dims, offsets)],
                    1).astype(np.int32)
    ind = np.stack([rs.randint(0, d, n) for d in
                    WND_COLUMNS["indicator_dims"]], 1).astype(np.int32)
    emb = np.stack([rs.randint(0, d, n) for d in
                    WND_COLUMNS["embed_in_dims"]], 1).astype(np.int32)
    cont = rs.rand(n, 1).astype(np.float32)
    y = rs.randint(0, 2, n).astype(np.int32)
    return [wide, ind, emb, cont], y


def model(kind: str, shard: bool):
    if kind == "ncf":
        return NeuralCF(USERS, ITEMS, 2, user_embed=8, item_embed=8,
                        hidden_layers=(16, 8), mf_embed=8,
                        shard_embeddings=shard)._ensure_built()
    return WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4),
                       shard_embeddings=shard, **WND_COLUMNS)._ensure_built()


def optimizer(name: str, lr: float):
    return {"sgd": optimizers.SGD, "adagrad": optimizers.Adagrad,
            "adam": optimizers.Adam}[name](lr)


def estimator(run, mesh, weights):
    _, kind, opt, lr, shard, _ = run
    est = Estimator(model(kind, shard), "sparse_categorical_crossentropy",
                    optimizer(opt, lr), device="cpu", mesh=mesh, seed=7)
    est.set_params(weights[kind if shard else kind + "_replicated"])
    return est


def main() -> int:
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    mesh = init_mesh(device="cpu")
    assert mesh.backend == "gloo" and mesh.size == RANKS, mesh
    weights = torch.load(os.path.join(out_dir, "weights.pt"),
                         weights_only=False)
    data = {"ncf": ncf_data(), "wnd": wnd_data()}
    results = {}
    for run in RUNS:
        name, kind, _, _, _, epochs = run
        est = estimator(run, mesh, weights)
        x, y = data[kind]
        engine.reset_exchange_bytes()
        fs = FeatureSet.from_ndarrays(x, y, shuffle=False)
        if name.endswith("_resumed"):
            # stop after epoch 1, checkpoint, resume on fresh estimators
            est.train(fs, batch_size=B, epochs=1)
            ckpt = os.path.join(out_dir, "ckpt")
            est.save_checkpoint(ckpt)
            est = estimator(run, mesh, weights)
            est.load_checkpoint(ckpt)
        hist = est.train(fs, batch_size=B, epochs=epochs)
        exchanged = dict(engine.exchange_bytes)
        if name == "ncf_sgd":  # collective reads: a padded tail, then none
            results["ncf_sgd_predict"] = est.predict(x, batch_size=24)
            results["ncf_sgd_evaluate"] = est.evaluate(
                FeatureSet.from_ndarrays(x, y, shuffle=False), batch_size=B)
        results[name] = {"params": est.get_params(),
                         "loss": hist["loss_history"],
                         "iterations": hist["iterations"],
                         "exchange_bytes": exchanged,
                         "plan": sorted(est._embed_plan()),
                         "opt_state": est.opt_state if mesh.rank == 0
                         else None}
    if mesh.rank == 0:
        torch.save(results, os.path.join(out_dir, "results.pt"))
    mesh.barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
