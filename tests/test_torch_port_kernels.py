"""The torch port's boundaries and its CUDA kernel.

Imports neither JAX nor the JAX package, so it also runs on a machine
with an NVIDIA card and no JAX, where the ``cuda``-marked test holds the
hand-written gather kernel against its plain version:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_kernels.py
"""
import ast
import os

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch
from analytics_zoo_tpu_torch.common import context
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.models import NeuralCF, ZooModel
from analytics_zoo_tpu_torch.ops import embedding_kernels as ek
from analytics_zoo_tpu_torch.ops import kernel_build
from analytics_zoo_tpu_torch.serving import ClusterServing, ServingConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(analytics_zoo_tpu_torch.__file__)
FORBIDDEN_ROOTS = ("jax", "jaxlib", "optax", "orbax", "flax")


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return (root in FORBIDDEN_ROOTS or module == "analytics_zoo_tpu"
            or module.startswith("analytics_zoo_tpu."))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_and_chip_smoke_import_no_jax():
    sources = list(_port_sources())
    assert len(sources) > 20 and all(os.path.exists(p) for p in sources)
    bad = {os.path.relpath(p, REPO): m for p in sources
           for m in _imports(p) if _forbidden(m)}
    assert bad == {}


def test_forbidden_import_check_matches_the_exact_package_name():
    assert _forbidden("analytics_zoo_tpu")
    assert _forbidden("analytics_zoo_tpu.serving.config")
    assert _forbidden("jax.numpy")
    assert not _forbidden("analytics_zoo_tpu_torch.serving")
    assert not _forbidden("torch")


@pytest.fixture()
def no_card(monkeypatch):
    """Make the process see no CUDA device, card or not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    path = str(tmp_path / "ncf")
    NeuralCF(5, 4, 2, user_embed=2, item_embed=2, hidden_layers=[4],
             mf_embed=2).save_model(path)
    with pytest.raises(context.NoCudaDeviceError):
        InferenceModel()
    with pytest.raises(context.NoCudaDeviceError):
        ZooModel.load_model(path)
    cfg = ServingConfig(model_path=path, data_src=f"dir://{tmp_path}/q",
                        image_shape=(2,), batch_size=2)
    with pytest.raises(context.NoCudaDeviceError):
        ClusterServing(cfg)
    # asked for explicitly, the CPU works
    assert InferenceModel(device="cpu").device.type == "cpu"
    assert ZooModel.load_model(path, device="cpu").model.device.type == "cpu"
    served = ClusterServing(cfg, device="cpu")
    assert served.model.device.type == "cpu"


def test_resolve_device_defaults_to_the_card(no_card):
    with pytest.raises(context.NoCudaDeviceError):
        context.resolve_device()
    with pytest.raises(context.NoCudaDeviceError):
        context.resolve_device("cuda:0")
    assert context.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        context.resolve_device("meta")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table = torch.zeros(4, 3)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        ek.gather(table, ids.long(), clip=True)
    with pytest.raises(TypeError):
        ek.gather(table.double(), ids, clip=True)
    with pytest.raises(ValueError):
        ek.gather(table[None], ids, clip=True)
    with pytest.raises(ValueError):
        ek.gather(table, ids[None], clip=True)
    with pytest.raises(ValueError):
        ek.gather(torch.zeros(3, 4).t(), ids, clip=True)
    with pytest.raises(ValueError):
        ek.gather(torch.zeros(0, 3), ids, clip=True)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    ek.reset_launch_counts()
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = ek.gather(table, torch.tensor([3, -1, 4], dtype=torch.int32),
                    clip=False)
    assert torch.equal(out, torch.tensor([[9., 10., 11.], [0, 0, 0],
                                          [0, 0, 0]]))
    assert ek.gather(table, torch.zeros(0, dtype=torch.int32),
                     clip=True).shape == (0, 3)
    assert ek.launch_counts == {"gather_rows": 0}


@pytest.fixture()
def knob_off(monkeypatch):
    """Turn ``kernels.fused_embedding`` off the way a deployment would."""
    monkeypatch.setenv("ZOO_TPU_KERNELS_FUSED_EMBEDDING", "false")


def _small_ncf(device):
    return NeuralCF(9, 7, 2, user_embed=4, item_embed=4, hidden_layers=[8],
                    mf_embed=2, fused_embeddings=False).build(
        torch.Generator().manual_seed(0), device=device)


def test_every_lookup_takes_the_gather_wrapper_whatever_the_knob(
        knob_off, monkeypatch):
    calls = []
    real = ek.gather

    def spy(table, ids, clip):
        calls.append((tuple(table.shape), clip))
        return real(table, ids, clip)

    monkeypatch.setattr(ek, "gather", spy)
    ncf = _small_ncf("cpu")
    with torch.inference_mode():
        ncf.model(torch.tensor([[1., 2.], [9., 7.], [-1., 30.]]))
    assert calls == [((10, 4), True), ((8, 4), True), ((10, 2), True),
                     ((8, 2), True)]


def test_library_is_keyed_by_a_hash_of_the_sources():
    path = kernel_build.library_path()
    assert path == kernel_build.library_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "build", "analytics_zoo_tpu_torch")
    assert os.path.basename(path).startswith("libazt_kernels-")
    srcs, _ = kernel_build._sources()
    assert "gather_rows.cu" in [os.path.basename(s) for s in srcs]


# -- on the card --------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dim,dtype,n", [
    (6041, 64, torch.float32, 256), (3707, 64, torch.float32, 256),
    (6041, 32, torch.float32, 256), (3707, 32, torch.float32, 256),
    (50, 3, torch.float32, 257), (50, 33, torch.float32, 1),
    (50, 64, torch.bfloat16, 257), (50, 33, torch.float16, 100),
    (50, 8, torch.float32, 0)])
def test_kernel_equals_its_plain_version_on_the_card(cuda_device, rows, dim,
                                                      dtype, n):
    gen = torch.Generator().manual_seed(rows + dim + n)
    table = torch.randn(rows, dim, generator=gen).to(dtype).to(cuda_device)
    ids = torch.randint(-3, rows + 3, (n,), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    for clip in (True, False):
        before = ek.launch_counts["gather_rows"]
        got = ek.gather(table, ids, clip)
        torch.cuda.synchronize()
        assert ek.launch_counts["gather_rows"] == before + (1 if n else 0)
        want = ek.gather_plain(table, ids, clip)
        assert torch.equal(got, want)
        host = table.float().cpu().numpy()
        idn = ids.cpu().numpy()
        ref = host[np.clip(idn, 0, rows - 1)]
        if not clip:
            ref[(idn < 0) | (idn >= rows)] = 0
        assert np.array_equal(got.float().cpu().numpy(), ref)


@pytest.mark.cuda
def test_served_batches_launch_the_kernel_four_times_whatever_the_knob(
        cuda_device, knob_off, tmp_path):
    path = str(tmp_path / "ncf")
    _small_ncf(cuda_device).save_model(path)
    model = InferenceModel(device=cuda_device).load_zoo(path)
    x = np.array([[1, 2], [9, 7], [-1, 30]], np.float32)
    ek.reset_launch_counts()
    for batch in range(1, 4):
        model.predict(x)
        assert ek.launch_counts["gather_rows"] == 4 * batch
