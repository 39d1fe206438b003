"""The torch port's boundaries and its CUDA kernels.

Imports neither JAX nor the JAX package, so it also runs on a machine
with an NVIDIA card and no JAX, where the ``cuda``-marked tests hold the
hand-written kernels against their plain versions and train Wide&Deep and
a small BERT on the card:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_kernels.py
"""
import ast
import importlib.util
import os
import re

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
from torch_port_threads import torch_threads_per_worker  # noqa: F401

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
    assert {os.path.join(PKG, "capture", "text.py"),
            os.path.join(PKG, "ops", "attention.py"),
            os.path.join(PKG, "keras", "layers", "attention.py"),
            os.path.join(PKG, "ops", "int8_dataflow.py"),
            os.path.join(PKG, "inference", "quantize.py"),
            os.path.join(PKG, "parallel", "mesh.py"),
            os.path.join(PKG, "parallel", "embedding.py"),
            os.path.join(PKG, "serving", "queues.py"),
            os.path.join(PKG, "feature", "preprocessing.py"),
            os.path.join(PKG, "feature", "image", "__init__.py"),
            os.path.join(PKG, "feature", "image", "transforms.py"),
            os.path.join(PKG, "feature", "image", "spec.py"),
            os.path.join(PKG, "feature", "image", "image_set.py"),
            os.path.join(PKG, "common", "metrics.py"),
            os.path.join(PKG, "common", "faults.py"),
            os.path.join(PKG, "common", "profiler.py"),
            os.path.join(PKG, "ops", "events.py"),
            os.path.join(PKG, "ops", "history.py"),
            os.path.join(PKG, "ops", "alerts.py"),
            os.path.join(PKG, "ops", "incident.py"),
            os.path.join(PKG, "ops", "__main__.py"),
            os.path.join(PKG, "utils", "__init__.py"),
            os.path.join(PKG, "utils", "trace.py"),
            os.path.join(PKG, "cluster", "__init__.py"),
            os.path.join(PKG, "cluster", "bootstrap.py"),
            os.path.join(PKG, "cluster", "supervisor.py"),
            os.path.join(PKG, "serving", "fleet.py"),
            os.path.join(PKG, "serving", "client.py"),
            os.path.join(PKG, "common", "file_io.py"),
            os.path.join(PKG, "estimator", "sync_eval.py")} <= set(
                sources)
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
    assert ek.launch_counts == {"gather_rows": 0, "gather_pool": 0,
                                "gather_int8": 0,
                                "scatter_rows": 0}


def test_int8_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(4, 3, dtype=torch.int8)
    scale = torch.tensor(0.5)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        ek.gather_int8(q.float(), scale, ids)
    with pytest.raises(TypeError):
        ek.gather_int8(q, scale.double(), ids)
    with pytest.raises(TypeError):
        ek.gather_int8(q, torch.ones(2), ids)
    with pytest.raises(TypeError):
        ek.gather_int8(q, scale, ids.long())
    with pytest.raises(ValueError):
        ek.gather_int8(q, scale, ids[None])
    with pytest.raises(ValueError):
        ek.gather_int8(torch.zeros(3, 4, dtype=torch.int8).t(), scale, ids)
    ek.reset_launch_counts()
    out = ek.gather_int8(q + 2, scale, torch.tensor([3, -1, 4],
                                                    dtype=torch.int32))
    assert torch.equal(out, torch.tensor([[1., 1., 1.], [0, 0, 0],
                                          [0, 0, 0]]))
    assert ek.launch_counts["gather_int8"] == 0


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
    assert {"gather_rows.cu", "gather_pool.cu", "fused_short_attn.cu",
            "fused_short_attn_bf16.cu", "gather_int8.cu",
            "scatter_rows.cu", "flash_attn_bf16.cu",
            "flash_attn_tf32.cu"} <= {os.path.basename(s) for s in srcs}


def test_the_build_keeps_its_ptxas_log_beside_the_library(tmp_path,
                                                         monkeypatch):
    """A build writes the compilers' ``ptxas -v`` output beside the library
    under the same name, so a run that reuses the library still reads the
    kernels' registers and spills; no temporary file is left."""
    cmds = []

    def fake_run_all(batch):
        cmds.append(batch)
        for cmd in batch:
            with open(cmd[cmd.index("-o") + 1], "w") as f:
                f.write("object")
        return "ptxas info    : Used 255 registers"

    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernel_build, "_run_all", fake_run_all)
    out = str(tmp_path / "libazt_kernels-0123.so")
    kernel_build._build(out)
    assert all("-Xptxas" in cmd for cmd in cmds[0])
    assert sorted(os.listdir(tmp_path)) == ["libazt_kernels-0123.ptxas.txt",
                                            "libazt_kernels-0123.so"]
    with open(tmp_path / "libazt_kernels-0123.ptxas.txt") as f:
        assert f.read() == "ptxas info    : Used 255 registers"
    monkeypatch.setattr(kernel_build, "library_path", lambda: out)
    assert kernel_build.build_log() == "ptxas info    : Used 255 registers"


@pytest.mark.parametrize("source,limit", [
    ("fused_short_attn.cu", "FUSED_SHORT_MAX_HEAD_DIM"),
    ("fused_short_attn_bf16.cu", "FUSED_SHORT_MAX_HEAD_DIM"),
    ("flash_attn_tf32.cu", "FLASH_MAX_HEAD_DIM"),
    ("flash_attn_bf16.cu", "FLASH_MAX_HEAD_DIM")])
def test_each_attention_source_takes_the_head_width_its_wrapper_allows(
        source, limit):
    """The widest head a CUDA source's C entries take (its ``kMaxD``) is
    the limit its Python wrapper checks before a launch (256), so a width
    the wrapper lets through is never refused by the kernel, and one it
    refuses never reaches the kernel."""
    from analytics_zoo_tpu_torch.ops import attention as at
    with open(os.path.join(kernel_build.CSRC_DIR, source)) as f:
        found = re.findall(r"constexpr int kMaxD = (\d+);", f.read())
    assert [int(v) for v in found] == [getattr(at, limit)] == [256]


@pytest.mark.parametrize("d", [0, 1, 256, 257, 320, 1024])
def test_head_dim_check_refuses_only_empty_heads(d):
    """``_check_head_dim`` raises for a head narrower than one column and
    lets every other width through (past 256 the card takes the ``wide``
    route); the routes' names follow the width."""
    from analytics_zoo_tpu_torch.ops import attention as at
    q = torch.zeros(1, 1, 2, d)
    if d < 1:
        with pytest.raises(ValueError, match="head_dim 0"):
            at._check_head_dim(q)
        return
    at._check_head_dim(q)
    wide = d > 256
    assert (at.fused_short_route(torch.float32, d) == "wide") == wide
    assert (at.flash_route(torch.bfloat16, "flash_bwd_fused", d)
            == "wide") == wide


# -- on the card --------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py`` as a module (it is a script, not a package)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dim,dtype,n", [
    (6041, 64, torch.float32, 256), (3707, 64, torch.float32, 256),
    (6041, 32, torch.float32, 256), (3707, 32, torch.float32, 256),
    (50, 3, torch.float32, 257), (50, 33, torch.float32, 1),
    (50, 64, torch.bfloat16, 257), (50, 33, torch.float16, 100),
    (50, 8, torch.float32, 0),
    # f32 widths that pack 32, 32, 16, 8 and 4 rows a warp, at id counts
    # that are no multiple of a warp's or a block's rows, and past one
    # pass of the grid (64 f32: 2 rows a warp)
    (100, 1, torch.float32, 1025), (100, 2, torch.float32, 1000),
    (100, 8, torch.float32, 33), (100, 16, torch.float32, 4099),
    (100, 32, torch.float32, 100003), (1000, 64, torch.float32, 101377),
    # bf16 and fp16 at odd widths, and rows wider than a warp's units
    (50, 7, torch.bfloat16, 1000), (50, 5, torch.float16, 333),
    (50, 129, torch.float16, 77), (600, 768, torch.bfloat16, 1000),
    (64, 2048, torch.float32, 300)])
def test_kernel_equals_its_plain_version_on_the_card(cuda_device, rows, dim,
                                                      dtype, n):
    gen = torch.Generator().manual_seed(rows + dim + n)
    flat = torch.randn(rows * dim + 2, generator=gen).to(dtype).to(
        cuda_device)
    ids = torch.randint(-3, rows + 3, (n,), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    # the table at the storage's start and one and two elements past it:
    # 16-byte aligned, then not (every copy unit the width allows)
    for off in (0, 1, 2):
        table = flat[off:off + rows * dim].view(rows, dim)
        for clip in (True, False):
            before = ek.launch_counts["gather_rows"]
            got = ek.gather(table, ids, clip)
            torch.cuda.synchronize()
            assert ek.launch_counts["gather_rows"] == before + (
                1 if n else 0)
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


#: the pool kernel's grid: W&D's wide-table call; widths of 8-byte rows
#: (one thread a bag), 16-byte rows and 64 f32 (16 lanes a bag), rows past
#: 32 units (a warp a bag); bags of 1, 3, 8, 9, 17 and 64 across the
#: in-flight chunk; n of 0, 1, 255, 256, 257 and past the grid's cap
#: (None, ``chip_smoke.past_the_cap``); every dtype. Each runs on four
#: table offsets (every copy unit)
POOL_GRID = [
    (101016, 2, 3, 8192, torch.float32), (50, 2, 1, 257, torch.float32),
    (50, 8, 17, 100, torch.float32), (50, 33, 3, 64, torch.float32),
    (300, 64, 5, 129, torch.float32), (300, 64, 3, 64, torch.bfloat16),
    (50, 33, 17, 31, torch.float16), (50, 8, 3, 0, torch.float32),
    (300, 64, 8, 1, torch.float32), (300, 64, 9, 255, torch.float32),
    (300, 64, 64, 256, torch.float32), (50, 4, 17, 257, torch.bfloat16),
    (50, 16, 8, 256, torch.float16), (50, 3, 64, 255, torch.bfloat16),
    (50, 200, 9, 257, torch.float32), (50, 520, 3, 31, torch.bfloat16),
    (1000, 2, 3, None, torch.float32), (1000, 64, 9, None, torch.float32),
    (1000, 8, 1, None, torch.bfloat16), (1000, 4, 17, None, torch.float16)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dim,bag,n,dtype", POOL_GRID)
def test_pool_kernel_equals_its_plain_version_on_the_card(cuda_device, smoke,
                                                          rows, dim, bag, n,
                                                          dtype):
    n = smoke.past_the_cap(cuda_device) if n is None else n
    gen = torch.Generator().manual_seed(rows + dim + bag + n)
    flat = torch.randn(rows * dim + 4, generator=gen).to(dtype).to(
        cuda_device)
    ids = torch.randint(-3, rows + 3, (n, bag), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    # the table at the storage's start and 1, 2 and 4 elements past it:
    # 16-byte aligned, then not (every copy unit the width allows)
    for off in (0, 1, 2, 4):
        table = flat[off:off + rows * dim].view(rows, dim)
        for combiner in ("sum", "mean", "sqrtn"):
            for clip in (True, False):
                before = ek.launch_counts["gather_pool"]
                got = ek.pool(table, ids, combiner, clip)
                torch.cuda.synchronize()
                assert ek.launch_counts["gather_pool"] == before + (
                    1 if n else 0)
                assert got.dtype == dtype and got.shape == (n, dim)
                # the same f32 adds in the same bag order: bit for bit
                assert torch.equal(got, ek.gather_pool_plain(
                    table, ids, combiner, clip))


#: the int8 kernel's grid: widths that are and are not whole 4-byte units,
#: rows past 32 units (130 on the byte path, 1024 on 4-byte units: a warp a
#: row), and n of 0, 1, 31, 255, 256, 257 and past the grid's cap (None)
INT8_DIMS = (1, 3, 4, 5, 8, 16, 31, 32, 33, 64, 130, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", INT8_DIMS)
@pytest.mark.parametrize("n", [0, 1, 31, 255, 256, 257, None])
def test_int8_kernel_equals_its_plain_version_on_the_card(cuda_device, smoke,
                                                         dim, n):
    n = smoke.past_the_cap(cuda_device) if n is None else n
    gen = torch.Generator().manual_seed(dim * 1000 + n)
    rows = 50
    q = torch.randint(-127, 128, (rows, dim), generator=gen,
                      dtype=torch.int8)
    ids = torch.randint(-3, rows + 3, (n,), generator=gen, dtype=torch.int32)
    if n >= 2:
        ids[0], ids[1] = -1, rows
    # the table at bases 16-byte aligned and 1, 4 and 8 bytes past it: the
    # byte path at 1, 4-byte units where the width allows at 0, 4 and 8
    raw = torch.zeros(rows * dim + 8, dtype=torch.int8)
    scale = torch.tensor(0.0173, device=cuda_device)
    idn = ids.numpy()[:4096]  # the numpy reference on the first rows
    ref = q.numpy()[np.clip(idn, 0, rows - 1)].astype(np.float32) \
        * np.float32(0.0173)
    ref[(idn < 0) | (idn >= rows)] = 0
    for off in (0, 1, 4, 8):
        raw[off:off + rows * dim] = q.reshape(-1)
        table = raw.to(cuda_device)[off:off + rows * dim].view(rows, dim)
        before = ek.launch_counts["gather_int8"]
        got = ek.gather_int8(table, scale, ids.to(cuda_device))
        torch.cuda.synchronize()
        assert ek.launch_counts["gather_int8"] == before + (1 if n else 0)
        assert got.dtype == torch.float32 and got.shape == (n, dim)
        want = ek.gather_int8_plain(table, scale, ids.to(cuda_device))
        assert torch.equal(got, want)  # one exact convert, one f32 multiply
        assert np.array_equal(got[:4096].cpu().numpy(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_negative", [True, False])
def test_an_unpooled_int8_lookup_is_one_kernel_on_the_card(cuda_device,
                                                          smoke,
                                                          mask_negative):
    gen = torch.Generator().manual_seed(5)
    q, scale, _ = ek.quantize_table(torch.randn(6041, 64, generator=gen))
    q, scale = q.to(cuda_device), scale.to(cuda_device)
    ids = torch.randint(-3, 6044, (256, 1), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    calls = 20
    seen = smoke.lookup_kernels(ek, lambda: [ek.gather_pool_int8(
        q, scale, ids, None, mask_negative) for _ in range(calls)])
    # every lookup issued one launch, and every kernel the card ran was B9
    # (where the trace kept its device events)
    assert seen["launches_per_lookup"] == [1] * calls
    assert seen["issued"] == calls
    assert all(k in ([], ["gather_int8"]) for k in seen["kernels_per_lookup"])
    assert ("warning" in seen) == ([] in seen["kernels_per_lookup"])
    if seen["kernels"] is not None:
        assert seen["kernels"] == {"gather_int8": calls}


@pytest.mark.cuda
def test_served_int8_batches_launch_the_int8_kernel_four_times(cuda_device,
                                                               tmp_path):
    path = str(tmp_path / "ncf")
    _small_ncf(cuda_device).save_model(path)
    model = InferenceModel(device=cuda_device).load_zoo(path).quantize("int8")
    x = np.array([[1, 2], [9, 7], [-1, 30]], np.float32)
    ek.reset_launch_counts()
    for batch in range(1, 4):
        y = model.predict(x)
        assert ek.launch_counts["gather_int8"] == 4 * batch
        assert ek.launch_counts["gather_rows"] == 0
    cpu = InferenceModel(device="cpu").load_zoo(path).quantize("int8")
    np.testing.assert_allclose(y, cpu.predict(x), rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 24, 256, 257])
@pytest.mark.parametrize("k,n", [(128, 128), (128, 64), (64, 32), (64, 2),
                                 (10, 2)])
def test_int8_matmul_is_exact_on_the_card(cuda_device, m, k, n):
    from analytics_zoo_tpu_torch.inference.quantize import int8_matmul
    gen = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    got = int8_matmul(a.to(cuda_device), b.to(cuda_device))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), (a.long() @ b.long()).int())


#: int8_conv2d on the card: ResNet's convolutions (7x7/2 with cin 3, 3x3 at
#: strides 1 and 2, 1x1 at strides 1 and 2), explicit pads, dilation and
#: groups, as (input, kernel [kh, kw, cin / groups, cout], strides,
#: padding, dilation, groups)
INT8_CONV_CASES = [
    ((4, 32, 32, 3), (7, 7, 3, 64), (2, 2), "SAME", (1, 1), 1),
    ((4, 16, 16, 64), (3, 3, 64, 64), (1, 1), "SAME", (1, 1), 1),
    ((4, 16, 16, 64), (3, 3, 64, 128), (2, 2), "SAME", (1, 1), 1),
    ((4, 16, 16, 64), (1, 1, 64, 256), (1, 1), "SAME", (1, 1), 1),
    ((4, 16, 16, 256), (1, 1, 256, 128), (2, 2), "SAME", (1, 1), 1),
    ((2, 9, 9, 8), (5, 3, 8, 16), (1, 2), ((2, 0), (1, 3)), (1, 1), 1),
    ((2, 10, 10, 8), (3, 3, 8, 8), (1, 1), "SAME", (2, 2), 1),
    ((2, 8, 8, 16), (3, 3, 8, 16), (1, 1), "VALID", (1, 1), 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kshape,strides,padding,dilation,groups",
                         INT8_CONV_CASES)
def test_int8_conv2d_on_the_card_equals_the_cpu_bit_for_bit(
        cuda_device, shape, kshape, strides, padding, dilation, groups):
    """The int8 convolution's int32 sums on the card (``torch._int_mm``
    over the patches) equal the CPU's (the same code) bit for bit, and no
    float convolution runs."""
    from analytics_zoo_tpu_torch.ops.int8_dataflow import int8_conv2d
    gen = torch.Generator().manual_seed(sum(shape) + sum(kshape))
    xq = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, kshape, generator=gen, dtype=torch.int8)
    want = int8_conv2d(xq, wq, strides, padding, dilation, groups)
    got = int8_conv2d(xq.to(cuda_device), wq.to(cuda_device), strides,
                      padding, dilation, groups)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_batchnorm_exact_statistics_on_the_card_equal_the_cpu(cuda_device):
    """``BatchNormalization(exact_statistics=True)``: the training output
    and the running statistics it moves, and the eval output, on the card
    equal the CPU's bit for bit, in f32 and in bf16 (what lets the
    requantizing ``int8_training`` ResNet's codes on the card be the
    CPU's)."""
    from analytics_zoo_tpu_torch.keras.layers import BatchNormalization
    gen = torch.Generator().manual_seed(5)
    c = 64
    x = (torch.randn(16, 32, 32, c, generator=gen) * 0.3
         + torch.rand(c, generator=gen) * 4)
    gamma = 1 + 0.1 * torch.randn(c, generator=gen)
    beta = 0.1 * torch.randn(c, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        outs = []
        for dev in (torch.device("cpu"), cuda_device):
            layer = BatchNormalization(exact_statistics=True)
            layer.build(None, x.shape, dev)
            with torch.no_grad():
                layer.gamma.copy_(gamma)
                layer.beta.copy_(beta)
            xd = x.to(dev, dtype)
            with torch.no_grad():
                y = layer(xd)
                layer.eval()
                y_eval = layer(xd)
            outs.append([t.cpu() for t in (y, layer.moving_mean,
                                           layer.moving_var, y_eval)])
        for want, got in zip(*outs):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_int8_train_conv_forward_on_the_card_equals_the_cpu(cuda_device):
    """``int8_train_conv``'s forward (dynamic scales, int8 sums, one f32
    product) is the CPU's bit for bit on the card, in f32 and in bf16; its
    straight-through gradients are cuDNN's bf16 convolutions, within one
    bf16 step of the largest value, 2^-7 of the CPU's scale (one step
    measured on an H100)."""
    from analytics_zoo_tpu_torch.ops.int8_training import int8_train_conv
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 28, 28, 64, generator=gen)
    w = torch.randn(3, 3, 64, 64, generator=gen) * 0.05
    g = torch.randn(8, 14, 14, 64, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        outs = []
        for dev in ("cpu", cuda_device):
            xd = x.to(dev, dtype, copy=True).requires_grad_()
            wd = w.to(dev, copy=True).requires_grad_()
            y = int8_train_conv(xd, wd, (2, 2), "SAME")
            y.backward(g.to(dtype).to(dev))
            outs.append((y.detach().cpu(), xd.grad.cpu(), wd.grad.cpu()))
        assert torch.equal(outs[0][0], outs[1][0])
        for want, got in zip(outs[0][1:], outs[1][1:]):
            scale = float(want.float().abs().max())
            assert float((got.float() - want.float()).abs().max()) <= \
                2.0 ** -7 * scale


@pytest.mark.cuda
def test_calibrated_int8_on_the_card_equals_the_cpu_at_padded_buckets(
        cuda_device, tmp_path):
    path = str(tmp_path / "ncf")
    _small_ncf("cpu").save_model(path)
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, 10, 64), rng.integers(0, 8, 64)],
                 1).astype(np.float32)
    batches = [x[:32], x[32:]]
    card = InferenceModel(device=cuda_device).load_zoo(path).quantize(
        "int8", calibration_data=batches)
    cpu = InferenceModel(device="cpu").load_zoo(path).quantize(
        "int8", calibration_data=batches)
    for name, scale in cpu._act_scales.items():
        assert abs(card._act_scales[name] - scale) <= 1e-6 * scale
    # the CPU's activation scales on the card: the int8 products are exact
    card._module.load_state_dict(cpu._module.state_dict(), strict=True)
    for b in (1, 16, 17, 64):  # through _int_mm's padding
        np.testing.assert_allclose(card.predict(x[:b]), cpu.predict(x[:b]),
                                   rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_a_wide_and_deep_step_launches_pool_once_and_gather_twice(
        cuda_device):
    from analytics_zoo_tpu_torch.models import WideAndDeep
    cols = dict(wide_base_cols=["a"], wide_base_dims=[7],
                wide_cross_cols=["c"], wide_cross_dims=[30],
                indicator_cols=["i"], indicator_dims=[3],
                embed_cols=["e1", "e2"], embed_in_dims=[7, 9],
                embed_out_dims=[4, 4], continuous_cols=["x"])
    rng = np.random.default_rng(0)
    n = 64
    x = [np.stack([rng.integers(0, 7, n), 7 + rng.integers(0, 30, n)],
                  1).astype(np.int32),
         rng.integers(0, 3, (n, 1)).astype(np.int32),
         np.stack([rng.integers(0, 7, n), rng.integers(0, 9, n)],
                  1).astype(np.int32),
         rng.random((n, 1)).astype(np.float32)]
    y = rng.integers(0, 2, n).astype(np.float32)
    zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=(8, 4), **cols)
    zoo.default_compile()
    ek.reset_launch_counts()
    hist = zoo.fit(x, y, batch_size=16, nb_epoch=1)
    steps = hist["iterations"]
    assert steps == 4 and np.isfinite(hist["loss_history"]).all()
    assert ek.launch_counts == {"gather_pool": steps,
                                "gather_rows": 2 * steps, "gather_int8": 0,
                                "scatter_rows": 0}
    assert zoo.model.device.type == "cuda"


# -- the row scatter-add (B3) on the card --------------------------------------


def test_chip_smoke_counts_each_byte_once_in_the_gather_and_scatter_bounds(
        smoke):
    # B3: the block written once, each grad row and its id read once, at
    # the W&D shard and at the 1 GiB block
    assert smoke.scatter_bound_ms(25000254, 2, 24576) == pytest.approx(
        (25000254 * 2 * 4 + 24576 * (4 + 2 * 4)) / 3.35e9, rel=1e-12)
    assert smoke.scatter_bound_ms(25000254, 2, 24576) == pytest.approx(
        0.0597901, rel=1e-6)
    assert smoke.scatter_bound_ms(1 << 22, 64, 1 << 20) == pytest.approx(
        0.4019020, rel=1e-6)
    # B1: in fill mode an id outside the table reads no row; in clip mode
    # it reads the clamped row; a row asked for twice is read once
    table = torch.zeros(10, 4)
    ids = torch.tensor([-1, 3, 3, 10], dtype=torch.int32)
    row, out = 16, 4 * 16 + 4 * 4
    assert smoke.gather_bound_ms(table, ids, clip=False) == pytest.approx(
        (out + 1 * row) / 3.35e9, rel=1e-12)
    assert smoke.gather_bound_ms(table, ids, clip=True) == pytest.approx(
        (out + 3 * row) / 3.35e9, rel=1e-12)


@pytest.mark.parametrize("table, rows_per_shard, dim", [
    ("wide", 25000254, 2), ("edu_e", 4, 8), ("occ_e", 250, 8)])
def test_chip_smoke_times_the_rows_a_sharded_step_receives(smoke, table,
                                                           rows_per_shard,
                                                           dim):
    rps, got_dim, ids = smoke.shard_request_ids(0, table)
    assert (rps, got_dim) == (rows_per_shard, dim)
    # each source rank's block: its distinct local rows, then the SENTINEL
    blocks = np.split(ids, smoke.SHARD_RANKS)
    assert ids.size == smoke.SHARD_BATCH * (3 if table == "wide" else 1)
    for block in blocks:
        mine = block[block != rps]
        assert mine.size and np.all(np.diff(mine) > 0)
        assert mine.min() >= 0 and mine.max() < rps
        assert np.all(block[mine.size:] == rps)


def _scatter_case(n, dim, num_rows, kind, seed):
    """f32 grads and int32 rows with negatives, ``num_rows`` and past it;
    in range every row distinct (``"distinct"``), some repeating
    (``"repeat"``), or all among the first 4, inside the kernel's first
    fill chunk, their adds on a few lines (``"one_chunk"``)."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "distinct":
        rows = torch.randperm(num_rows + 6, generator=gen)[:n] - 3
    else:
        hi = num_rows if kind == "repeat" else min(4, num_rows)
        rows = torch.randint(-3, hi + 3, (n,), generator=gen)
        rows[rows >= hi] += num_rows - hi  # past the end: SENTINEL and on
    g = torch.randn(n, dim, generator=gen)
    return g, rows.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 2, 3, 8, 64, 130])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4096, 8192, 24576])
def test_scatter_kernel_equals_its_plain_version_on_the_card(cuda_device,
                                                             dim, n):
    # 100,003 rows: no 32 KB fill chunk divides the block (at odd widths
    # nor 16 bytes); "one_chunk": every row in the first fill chunk
    for num_rows, kind in ((5000, "distinct"), (7, "repeat"),
                           (300, "repeat"), (100003, "distinct"),
                           (100003, "repeat"), (5000, "one_chunk"),
                           (7, "one_chunk")):
        repeat = kind != "distinct"
        if not repeat and n > num_rows:
            continue
        g, rows = _scatter_case(n, dim, num_rows, kind, seed=n + dim)
        want = ek.scatter_rows_plain(g, rows, num_rows)
        ek.reset_launch_counts()
        got = ek.scatter_rows(g.to(cuda_device), rows.to(cuda_device),
                              num_rows)
        torch.cuda.synchronize()
        assert got.shape == (num_rows, dim)
        assert ek.launch_counts["scatter_rows"] == (1 if n else 0)
        if repeat:  # atomics add a repeated row in no fixed order
            scale = max(1.0, float(want.abs().max()))
            assert float((got.cpu() - want).abs().max()) <= 2e-5 * scale
        else:
            assert torch.equal(got.cpu(), want)


# -- the fused short attention kernels (B7, B8) on the card -------------------

#: kernel against plain: f32 sums in another order; bf16 outputs round to
#: 8 bits, so their tolerance is relative to the output's scale
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(dev, b, h, s, d, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(dtype).to(dev)
                   for _ in range(4))
    mask = torch.ones(b, s)
    for i in range(b):
        mask[i, int(torch.randint(1, s + 1, (1,), generator=gen)):] = 0
    if b > 1:
        mask[-1] = 0  # a row of all-masked keys
    return q, k, v, do, ((1.0 - mask) * -1e9).to(dev)


def _close(got, want, dtype):
    scale = max(1.0, float(want.detach().float().abs().max()))
    return float((got.float() - want.float()).abs().max()) <= \
        ATTN_ATOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 17, 64, 65, 128, 129, 512])
@pytest.mark.parametrize("d", [24, 32, 64, 128, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_short_kernels_equal_their_plain_versions_on_the_card(
        cuda_device, s, d, dtype):
    _hold_fused_short_kernels(cuda_device, s, d, dtype)


def _hold_fused_short_kernels(cuda_device, s, d, dtype):
    from analytics_zoo_tpu_torch.ops import attention as at
    q, k, v, do, bias = _attn_inputs(cuda_device, 2, 3, s, d, dtype, s + d)
    seed = torch.tensor([1234], dtype=torch.int32, device=cuda_device)
    for kb in (None, bias):
        for causal in (False, True):
            for rate in (0.0, 0.1):
                before = dict(at.launch_counts)
                o, stats = at.fused_short_fwd(q, k, v, kb, seed, 0.125, rate,
                                              causal)
                grads = at.fused_short_bwd(q, k, v, do, kb, seed, 0.125,
                                           rate, causal, stats, o)
                torch.cuda.synchronize()
                assert at.launch_counts == {
                    "fused_short_fwd": before["fused_short_fwd"] + 1,
                    "fused_short_bwd": before["fused_short_bwd"] + 1}
                leaves = [t.detach().clone().requires_grad_() for t in
                          (q, k, v)]
                want = at.fused_short_attention_plain(
                    *leaves, kb, 0.125, rate, seed, causal)
                want.backward(do)
                case = f"bias={kb is not None} causal={causal} rate={rate}"
                assert o.dtype == dtype and _close(o, want, dtype), case
                for name, g, t in zip("qkv", grads, leaves):
                    assert _close(g, t.grad, dtype), f"d{name} {case}"
                again = at.fused_short_bwd(q, k, v, do, kb, seed, 0.125,
                                           rate, causal, stats, o)
                assert torch.equal(o, at.fused_short_fwd(
                    q, k, v, kb, seed, 0.125, rate, causal)[0]), case
                assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [128, 320], ids=["d128", "wide_d320"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_the_kernels_dropout_mask_is_the_plain_mask_bit_for_bit(
        cuda_device, dtype, s):
    from analytics_zoo_tpu_torch.ops import attention as at
    b, h = 4, 3
    # q = k = 0 gives p = 1/s everywhere; v = I reads p·keep back out
    # (1/(128·0.9) is far from 0 in bf16 too)
    q = torch.zeros(b, h, s, s, device=cuda_device, dtype=dtype)
    eye = torch.eye(s, device=cuda_device, dtype=dtype).expand(
        b, h, s, s).contiguous()
    seed = torch.tensor([99], dtype=torch.int32, device=cuda_device)
    o, stats = at.fused_short_fwd(q, q, eye, None, seed, 1.0, 0.1, False)
    _, _, dv = at.fused_short_bwd(q, q, eye, eye, None, seed, 1.0, 0.1,
                                  False, stats, o)
    want = at.dropout_keep_mask(seed, b * h, s, 0.1).reshape(b, h, s, s)
    assert torch.equal(o != 0, want)
    assert torch.equal(dv.transpose(-1, -2) != 0, want)
    o2, _ = at.fused_short_fwd(q, q, eye, None, seed, 1.0, 0.1, False)
    assert torch.equal(o, o2)


@pytest.mark.cuda
def test_bf16_and_f32_each_take_their_tensor_core_route(cuda_device):
    """B7 and B8 count on ``"bf16_tc"`` in bf16 and on ``"f32_tc"`` (3xTF32)
    in f32, both saving the row statistics, and no flash route counts;
    the flash kernels' f32 route is ``"f32_tc"`` (3xTF32) for all four."""
    from analytics_zoo_tpu_torch.ops import attention as at
    for dtype, route in ((torch.bfloat16, "bf16_tc"),
                         (torch.float32, "f32_tc")):
        q, k, v, do, bias = _attn_inputs(cuda_device, 2, 2, 40, 64, dtype,
                                         3)
        at.reset_launch_counts()
        o, stats = at.fused_short_fwd(q, k, v, bias, None, 0.125, 0.0,
                                      False)
        at.fused_short_bwd(q, k, v, do, bias, None, 0.125, 0.0, False,
                           stats, o)
        assert at.route_counts == {"bf16_tc": 0, "f32_tc": 0, "wide": 0,
                                    route: 2}
        assert at.flash_route_counts == {"bf16_tc": 0, "f32_tc": 0,
                                         "wide": 0}
        assert stats.shape == (2, 2, 2, 40)
    assert [at.flash_route(torch.float32, k, 128) for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")] \
        == ["f32_tc"] * 4
    # the backward reads the forward's row statistics (and in f32 its output)
    with pytest.raises(ValueError):
        at.fused_short_bwd(*(t.bfloat16() for t in (q, k, v, do)), bias,
                           None, 0.125, 0.0, False)
    with pytest.raises(ValueError):
        at.fused_short_bwd(q, k, v, do, bias, None, 0.125, 0.0, False, stats)


#: the f32 route's timed shapes (chip_smoke.ATTN_F32_TIMED): the LM's
#: prefill, BERT-base at the default dtype, the longest length
_F32_TIMED = {"lm_prefill": ((4, 16, 128, 128), False, 0.0, True),
              "bert_base": ((128, 12, 128, 64), True, 0.1, False),
              "s512": ((4, 16, 512, 128), False, 0.0, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(_F32_TIMED))
def test_f32_route_equals_its_plain_versions_at_the_timed_shapes(
        cuda_device, label):
    from analytics_zoo_tpu_torch.ops import attention as at
    (b, h, s, d), bias, rate, causal = _F32_TIMED[label]
    q, k, v, do, kb = _attn_inputs(cuda_device, b, h, s, d, torch.float32,
                                   s + d)
    kb = kb if bias else None
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda_device)
    scale = d ** -0.5
    at.reset_launch_counts()
    o, stats = at.fused_short_fwd(q, k, v, kb, seed, scale, rate, causal)
    grads = at.fused_short_bwd(q, k, v, do, kb, seed, scale, rate, causal,
                               stats, o)
    assert at.route_counts == {"bf16_tc": 0, "f32_tc": 2, "wide": 0}
    want = at.fused_short_attention_plain(q, k, v, kb, scale, rate, seed,
                                          causal)
    assert _close(o, want, torch.float32)
    plain = at.fused_short_bwd_plain(q, k, v, do, kb, scale, rate, seed,
                                     causal)
    for name, g, w in zip("qkv", grads, plain):
        assert _close(g, w, torch.float32), f"d{name}"
    assert torch.equal(o, at.fused_short_fwd(q, k, v, kb, seed, scale, rate,
                                             causal)[0])
    again = at.fused_short_bwd(q, k, v, do, kb, seed, scale, rate, causal,
                               stats, o)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(17, 24), (65, 64), (129, 128)])
def test_f32_route_equals_its_plain_versions_on_a_grid_of_many_blocks(
        cuda_device, s, d):
    """b·h 1536 gives at least 8 blocks an SM, where the f32 kernels take
    four-warp blocks (``split_for`` in ``csrc/fused_short_attn.cu``); the
    grid test's small grids take eight-warp ones."""
    from analytics_zoo_tpu_torch.ops import attention as at
    q, k, v, do, bias = _attn_inputs(cuda_device, 128, 12, s, d,
                                     torch.float32, s * d)
    seed = torch.tensor([77], dtype=torch.int32, device=cuda_device)
    for kb in (None, bias):
        for causal in (False, True):
            for rate in (0.0, 0.1):
                o, stats = at.fused_short_fwd(q, k, v, kb, seed, 0.125, rate,
                                              causal)
                grads = at.fused_short_bwd(q, k, v, do, kb, seed, 0.125,
                                           rate, causal, stats, o)
                case = f"bias={kb is not None} causal={causal} rate={rate}"
                want = at.fused_short_attention_plain(q, k, v, kb, 0.125,
                                                      rate, seed, causal)
                assert _close(o, want, torch.float32), case
                plain = at.fused_short_bwd_plain(q, k, v, do, kb, 0.125,
                                                 rate, seed, causal)
                for name, g, w in zip("qkv", grads, plain):
                    assert _close(g, w, torch.float32), f"d{name} {case}"
                again = at.fused_short_bwd(q, k, v, do, kb, seed, 0.125,
                                           rate, causal, stats, o)
                assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_a_bert_step_launches_each_attention_kernel_once_per_block(
        cuda_device):
    from analytics_zoo_tpu_torch.capture import BERTClassifier
    from analytics_zoo_tpu_torch.ops import attention as at
    cfg = dict(vocab=100, hidden_size=64, n_block=2, n_head=2,
               intermediate_size=128, max_position_len=64,
               compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 100, (64, 32))
    tok[:, 20:] = 0
    y = rng.integers(0, 2, 64)
    clf = BERTClassifier(2, bert_config=cfg)
    at.reset_launch_counts()
    ek.reset_launch_counts()
    hist = clf.fit(tok, y, batch_size=16, epochs=1)
    steps = hist["iterations"]
    assert steps == 4 and np.isfinite(hist["loss_history"]).all()
    assert at.launch_counts == {"fused_short_fwd": 2 * steps,
                                "fused_short_bwd": 2 * steps}
    assert at.route_counts == {"bf16_tc": 4 * steps, "f32_tc": 0,
                               "wide": 0}
    assert ek.launch_counts["gather_rows"] == 3 * steps
    at.reset_launch_counts()
    assert clf.predict(tok, batch_size=32).shape == (64, 2)
    assert at.launch_counts == {"fused_short_fwd": 4, "fused_short_bwd": 0}


@pytest.mark.cuda
def test_a_served_bert_batch_launches_b7_per_block_and_three_b1(
        cuda_device, tmp_path):
    """BERT (2 blocks, bf16) served from float32 token rows through
    ``load_forward``: a batch at [4, 2, 128, 64] launches one B7 a block on
    the bf16 route, three row gathers and no B8, and its answers are a
    direct forward's."""
    from analytics_zoo_tpu_torch.capture import (BERTClassifier,
                                                 bert_input_pack,
                                                 bert_serving_forward)
    from analytics_zoo_tpu_torch.ops import attention as at
    from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue
    cfg = dict(vocab=100, hidden_size=128, n_block=2, n_head=2,
               intermediate_size=256, max_position_len=128,
               compute_dtype="bfloat16")
    clf = BERTClassifier(2, bert_config=cfg).build(128, device=cuda_device)
    params = {k: v.detach().clone() for k, v in
              clf.model.state_dict().items()}
    im = InferenceModel(device=cuda_device).load_forward(
        bert_serving_forward(clf.model), params)
    src = f"dir://{tmp_path}"
    server = ClusterServing(ServingConfig(data_src=src, image_shape=(128,),
                                          batch_size=4, batch_wait_ms=5),
                            model=im)
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 100, (4, 128))
    tok[1, 70:] = 0
    inq = InputQueue(src)
    for i, row in enumerate(tok.astype(np.float32)):
        inq.enqueue_tensor(f"t{i}", row)
    at.reset_launch_counts()
    ek.reset_launch_counts()
    assert server.serve_once() == 4
    assert at.launch_counts == {"fused_short_fwd": 2, "fused_short_bwd": 0}
    assert at.route_counts == {"bf16_tc": 2, "f32_tc": 0, "wide": 0}
    assert ek.launch_counts["gather_rows"] == 3
    res = OutputQueue(src).dequeue()
    served = np.array([res[f"t{i}"]["value"] for i in range(4)], np.float32)
    with torch.inference_mode():
        direct = clf.model([torch.from_numpy(a).to(cuda_device) for a in
                            bert_input_pack(tok)]).float().cpu().numpy()
    np.testing.assert_allclose(served, direct, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kv_len_past_512_takes_flash_on_the_card(cuda_device):
    # kv_len past 512 takes the flash kernels (one B4 launch forward) and
    # equals the same layer on the CPU
    from analytics_zoo_tpu_torch.keras.layers import MultiHeadAttention
    from analytics_zoo_tpu_torch.ops import attention as at
    mha = MultiHeadAttention(1, 8)
    mha.build(torch.Generator().manual_seed(0), (None, 513, 8),
              torch.device("cpu"))
    x = torch.randn(1, 513, 8, generator=torch.Generator().manual_seed(1))
    want = mha(x)
    at.reset_launch_counts()
    got = mha.to(cuda_device)(x.to(cuda_device))
    assert at.flash_launch_counts["flash_fwd"] == 1
    assert float((got.detach().cpu() - want.detach()).abs().max()) <= 1e-5


# -- the flash attention kernels (B4, B5a, B5b, B6) on the card ---------------

#: (q_len, kv_len): ragged tiles, lengths apart, the LM's S - 1
FLASH_LENGTHS = [(1, 1), (17, 17), (513, 513), (1000, 1000), (2047, 2047),
                 (2048, 2048), (4096, 4096), (513, 1000), (1000, 513),
                 (17, 4096), (2047, 1)]


def _rel_l2(got, want, norm=None) -> float:
    err = float((got.float() - want.float()).norm())
    return err / max(float(want.float().norm()) if norm is None else norm,
                     1e-30)


def _flash_close(got, want, dtype):
    """Within the tolerance of the output's scale (at least 1) and in
    relative L2, so a wrong tile of small values shows too."""
    return _close(got, want, dtype) and \
        _rel_l2(got, want) <= ATTN_ATOL[dtype]


def _grads_close(got, want, dtype, one_key_no_glse):
    """The three gradients against the reference's: each within the
    tolerance of their joint scale (the largest reference gradient, at
    least 1), and each within it in relative L2 over its own norm. Over a
    single key with no lse cotangent, dq and dk are zero in exact
    arithmetic (ds = dO·v − dO·o cancels), so they are rounding of dp and
    D alone and take the three gradients' joint norm."""
    scale = max([1.0] + [float(w.float().abs().max()) for w in want])
    joint = float(sum(w.float().norm() ** 2 for w in want)) ** 0.5
    tol = ATTN_ATOL[dtype]
    return all(float((g.float() - w.float()).abs().max()) <= tol * scale
               and _rel_l2(g, w, joint if one_key_no_glse and i < 2
                           else None) <= tol
               for i, (g, w) in enumerate(zip(got, want)))


def _flash_inputs(dev, sq, skv, d, dtype, seed, b=1, h=2):
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen).to(dtype).to(dev)
             for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, generator=gen).to(dtype).to(dev)
            for _ in range(2))
    glse = torch.randn(b, h, sq, generator=gen).to(dev)
    mask = (torch.rand(b, skv, generator=gen) < 0.2).float()
    return q, k, v, do, glse, (mask * -1e9).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", FLASH_LENGTHS,
                         ids=[f"{a}x{b}" for a, b in FLASH_LENGTHS])
@pytest.mark.parametrize("d", [24, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_equal_their_plain_versions_on_the_card(
        cuda_device, sq, skv, d, dtype):
    """B4 (with and without a key bias, causal or not), B5a + B5b and B6
    (with and without an lse cotangent) against their plain versions:
    within 2e-5 (f32) or 2e-2 (bf16) of the output's scale (the three
    gradients' joint scale for a backward) and in relative L2. Every
    kernel counts on its route (the tensor cores: bf16, and f32 as
    3xTF32). B6 adds dq with atomics in no fixed order, which costs at most
    skv / 64 partial sums' rounding, far inside the f32 tolerance; its dk
    and dv repeat bit for bit, dq need not. B5a + B5b use no atomics: dq,
    dk and dv repeat bit for bit."""
    _hold_flash_kernels(cuda_device, sq, skv, d, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(17, 17), (513, 1000), (1000, 513)],
                         ids=["17x17", "513x1000", "1000x513"])
@pytest.mark.parametrize("d", [5, 6, 30])
def test_f32_flash_kernels_at_widths_off_a_multiple_of_four(cuda_device, sq,
                                                            skv, d):
    """As above, in f32, at head widths whose rows are no 16-byte vectors:
    the kernels stage them element by element, and B6 adds dq by scalar
    atomics where it adds float4 at the widths above."""
    _hold_flash_kernels(cuda_device, sq, skv, d, torch.float32)


def _hold_flash_kernels(cuda_device, sq, skv, d, dtype):
    from analytics_zoo_tpu_torch.ops import attention as at
    q, k, v, do, glse, bias = _flash_inputs(cuda_device, sq, skv, d, dtype,
                                            sq + skv + d)
    scale = d ** -0.5
    for causal in (False, True):
        for kb in (None, bias):
            before = at.flash_launch_counts["flash_fwd"]
            routes = dict(at.flash_route_counts)
            o, lse = at.flash_fwd(q, k, v, kb, scale, causal)
            torch.cuda.synchronize()
            assert at.flash_launch_counts["flash_fwd"] == before + 1
            routes[at.flash_route(dtype, "flash_fwd", d)] += 1
            assert at.flash_route_counts == routes
            want_o, want_lse = at.flash_fwd_plain(q, k, v, kb, scale, causal)
            case = f"causal={causal} bias={kb is not None}"
            assert o.dtype == dtype and _flash_close(o, want_o, dtype), case
            assert _flash_close(lse, want_lse, torch.float32), case
        o, lse = at.flash_fwd_plain(q, k, v, None, scale, causal)
        delta = (do.float() * o.float()).sum(-1)
        for gl in (None, glse):
            args = (q, k, v, do, lse, delta, gl, scale, causal)
            want = at.flash_bwd_fused_plain(*args)
            counts = dict(at.flash_launch_counts)
            routes = dict(at.flash_route_counts)
            two_pass = (at.flash_bwd_dq(*args),) + at.flash_bwd_dkv(*args)
            fused = at.flash_bwd_fused(*args)
            again = at.flash_bwd_fused(*args)
            torch.cuda.synchronize()
            assert at.flash_launch_counts["flash_bwd_dq"] == \
                counts["flash_bwd_dq"] + 1
            assert at.flash_launch_counts["flash_bwd_dkv"] == \
                counts["flash_bwd_dkv"] + 1
            assert at.flash_launch_counts["flash_bwd_fused"] == \
                counts["flash_bwd_fused"] + 2
            for kernel, n in (("flash_bwd_dq", 1), ("flash_bwd_dkv", 1),
                              ("flash_bwd_fused", 2)):
                routes[at.flash_route(dtype, kernel, d)] += n
            assert at.flash_route_counts == routes
            case = f"causal={causal} glse={gl is not None}"
            assert all(t.dtype == dtype for t in two_pass + fused)
            one_key = skv == 1 and gl is None
            assert _grads_close(two_pass, want, dtype, one_key), f"B5 {case}"
            assert _grads_close(fused, want, dtype, one_key), f"B6 {case}"
            assert torch.equal(fused[1], again[1])
            assert torch.equal(fused[2], again[2])
            two_again = (at.flash_bwd_dq(*args),) + at.flash_bwd_dkv(*args)
            assert all(torch.equal(a, b)
                       for a, b in zip(two_pass, two_again)), case


#: lengths of the grid above, each at a batch (``_many_blocks_batch``)
#: whose grid of 64-row blocks is at least eight blocks an SM
FLASH_MANY_LENGTHS = [(513, 1000), (1000, 513), (17, 4096), (2047, 1),
                      (4096, 4096)]


def _many_blocks_batch(dev, rows, h):
    """The least batch whose ``b·h·ceil(rows / 64)`` blocks make at least
    eight an SM of this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return -(-8 * sms // (h * -(-rows // 64)))


def _flash_inputs_on_card(dev, sq, skv, d, b, h, seed):
    """Seeded q, k, v, dO, glse and a padding bias, drawn on the card (the
    batches here reach 2 GiB a tensor)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=dev)
             for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, generator=gen, device=dev)
            for _ in range(2))
    glse = torch.randn(b, h, sq, generator=gen, device=dev)
    mask = (torch.rand(b, skv, generator=gen, device=dev) < 0.2).float()
    return q, k, v, do, glse, mask * -1e9


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", FLASH_MANY_LENGTHS,
                         ids=[f"{a}x{b}" for a, b in FLASH_MANY_LENGTHS])
@pytest.mark.parametrize("d", [24, 64, 96, 128])
def test_f32_flash_tensor_core_kernels_on_grids_of_many_blocks(
        cuda_device, sq, skv, d):
    """f32 B4 (with and without a key bias), B5a, B5b and B6 (with and
    without an lse cotangent), causal or not, at 16 heads and a batch that
    gives each kernel's grid at least eight blocks an SM, against their
    plain versions: within 2e-5 of the scale and in relative L2 (over the
    three gradients' joint norm where a single key and no lse cotangent
    leave dq and dk rounding alone; B5a's dq is held beside the plain dk
    and dv for that). The grid test above runs b·h 2."""
    from analytics_zoo_tpu_torch.ops import attention as at
    h, scale, f32 = 16, d ** -0.5, torch.float32
    # B4 and B5a: 64 queries a block
    b = _many_blocks_batch(cuda_device, sq, h)
    q, k, v, do, glse, bias = _flash_inputs_on_card(cuda_device, sq, skv, d,
                                                    b, h, sq + skv + d)
    for causal in (False, True):
        for kb in (None, bias):
            before = at.flash_route_counts["f32_tc"]
            o, lse = at.flash_fwd(q, k, v, kb, scale, causal)
            assert at.flash_route_counts["f32_tc"] == before + 1
            want_o, want_lse = at.flash_fwd_plain(q, k, v, kb, scale, causal)
            case = f"b={b} causal={causal} bias={kb is not None}"
            assert _flash_close(o, want_o, f32), case
            assert _flash_close(lse, want_lse, f32), case
        o, lse = at.flash_fwd_plain(q, k, v, None, scale, causal)
        delta = (do * o).sum(-1)
        for gl in (None, glse):
            args = (q, k, v, do, lse, delta, gl, scale, causal)
            before = at.flash_route_counts["f32_tc"]
            dq = at.flash_bwd_dq(*args)
            assert at.flash_route_counts["f32_tc"] == before + 1
            want = at.flash_bwd_fused_plain(*args)
            case = f"B5a b={b} causal={causal} glse={gl is not None}"
            assert _grads_close((dq,) + want[1:], want, f32,
                                skv == 1 and gl is None), case
    del q, k, v, do, glse, o, lse, want_o, want_lse, dq, want
    # B5b and B6: 64 keys a block
    b = _many_blocks_batch(cuda_device, skv, h)
    q, k, v, do, glse, _ = _flash_inputs_on_card(cuda_device, sq, skv, d, b,
                                                 h, sq + skv + d + 1)
    for causal in (False, True):
        o, lse = at.flash_fwd_plain(q, k, v, None, scale, causal)
        delta = (do * o).sum(-1)
        for gl in (None, glse):
            args = (q, k, v, do, lse, delta, gl, scale, causal)
            before = at.flash_route_counts["f32_tc"]
            got = at.flash_bwd_dkv(*args)
            fused = at.flash_bwd_fused(*args)
            assert at.flash_route_counts["f32_tc"] == before + 2
            want = at.flash_bwd_dkv_plain(*args)
            case = f"b={b} causal={causal} glse={gl is not None}"
            one_key = skv == 1 and gl is None
            assert _grads_close(got, want, f32, one_key), f"B5b {case}"
            assert _grads_close(fused, at.flash_bwd_fused_plain(*args), f32,
                                one_key), f"B6 {case}"


@pytest.mark.cuda
def test_flash_takes_the_tensor_cores_in_bf16_and_in_f32(cuda_device):
    """A causal forward and backward through ``flash_attention`` counts
    each of its launches on its route: in bf16 every kernel on the tensor
    cores (``bf16_tc``), in f32 every kernel on the tensor cores as 3xTF32
    (``f32_tc``). One B4 and one B6 at 700 keys of d 64; one B4, one B5a
    and one B5b past the resident-bytes rule (8192 keys of d 128 in bf16,
    4096 in f32)."""
    from analytics_zoo_tpu_torch.ops import attention as at
    for dtype, routes, s, d, fused in (
            (torch.bfloat16, {"bf16_tc": 2}, 700, 64, True),
            (torch.float32, {"f32_tc": 2}, 700, 64, True),
            (torch.bfloat16, {"bf16_tc": 3}, 8192, 128, False),
            (torch.float32, {"f32_tc": 3}, 4096, 128, False)):
        q, k, v, do, _, _ = _flash_inputs(cuda_device, s, s, d, dtype, 5)
        leaves = [t.requires_grad_() for t in (q, k, v)]
        at.reset_launch_counts()
        at.flash_attention(*leaves, causal=True).backward(do)
        torch.cuda.synchronize()
        assert at.flash_route_counts == {"bf16_tc": 0, "f32_tc": 0,
                                         "wide": 0, **routes}
        assert at.flash_launch_counts == {
            "flash_fwd": 1, "flash_bwd_dq": 0 if fused else 1,
            "flash_bwd_dkv": 0 if fused else 1,
            "flash_bwd_fused": 1 if fused else 0}
        assert all(t.grad.dtype == dtype and bool(t.grad.isfinite().all())
                   for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,fused", [
    (torch.float32, 2048, True), (torch.float32, 4096, False),
    (torch.bfloat16, 4096, True), (torch.bfloat16, 8192, False)],
    ids=["f32-2048", "f32-4096", "bf16-4096", "bf16-8192"])
def test_flash_backward_takes_the_design_the_resident_bytes_pick(
        cuda_device, dtype, s, fused):
    """At d 128, the one-pass B6 takes the LM's 2048 keys in f32 and
    bench_longseq's 4096 in bf16, the two-pass B5a + B5b 4096 keys in f32
    and 8192 in bf16, as in the JAX package, each kernel on its route."""
    from analytics_zoo_tpu_torch.ops import attention as at
    q, k, v, do, _, _ = _flash_inputs(cuda_device, s, s, 128, dtype, s)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    at.reset_launch_counts()
    at.flash_attention(*leaves, causal=True).backward(do)
    torch.cuda.synchronize()
    assert at.flash_launch_counts == {
        "flash_fwd": 1, "flash_bwd_dq": 0 if fused else 1,
        "flash_bwd_dkv": 0 if fused else 1,
        "flash_bwd_fused": 1 if fused else 0}
    routes = {"bf16_tc": 0, "f32_tc": 0, "wide": 0}
    for kernel, n in at.flash_launch_counts.items():
        routes[at.flash_route(dtype, kernel, 128)] += n
    assert at.flash_route_counts == routes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_card_wrappers_take_heads_past_256_on_the_wide_route(cuda_device,
                                                             dtype):
    """At a head of 257 every attention wrapper launches the ``wide``
    route (``csrc/attn_wide.cu``) once, counted under its own name, and
    equals its plain version within 2e-5 (f32) or 2e-2 (bf16) of scale."""
    from analytics_zoo_tpu_torch.ops import attention as at
    q, k, v, do, bias = _attn_inputs(cuda_device, 1, 2, 40, 257, dtype, 7)
    scale = 257 ** -0.5
    at.reset_launch_counts()
    o, stats = at.fused_short_fwd(q, k, v, bias, None, scale, 0.0, True)
    grads = at.fused_short_bwd(q, k, v, do, bias, None, scale, 0.0, True,
                               stats, o)
    want_o = at.fused_short_attention_plain(q, k, v, bias, scale, 0.0, None,
                                            True)
    want = at.fused_short_bwd_plain(q, k, v, do, bias, scale, 0.0, None,
                                    True)
    torch.cuda.synchronize()
    assert _close(o, want_o, dtype)
    assert all(_close(g, w, dtype) for g, w in zip(grads, want))
    assert at.launch_counts == {"fused_short_fwd": 1, "fused_short_bwd": 1}
    assert at.route_counts == {"bf16_tc": 0, "f32_tc": 0, "wide": 2}
    fo, lse = at.flash_fwd(q, k, v, None, scale, True)
    want_fo, want_lse = at.flash_fwd_plain(q, k, v, None, scale, True)
    assert _close(fo, want_fo, dtype) and _close(lse, want_lse,
                                                 torch.float32)
    delta = (do.float() * want_fo.float()).sum(-1)
    args = (q, k, v, do, want_lse, delta, None, scale, True)
    want = at.flash_bwd_fused_plain(*args)
    got = ((at.flash_bwd_dq(*args),) + at.flash_bwd_dkv(*args),
           at.flash_bwd_fused(*args))
    torch.cuda.synchronize()
    for grads in got:
        assert all(_close(g, w, dtype) for g, w in zip(grads, want))
    assert at.flash_launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                      "flash_bwd_dkv": 1,
                                      "flash_bwd_fused": 1}
    assert at.flash_route_counts == {"bf16_tc": 0, "f32_tc": 0, "wide": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 128])
@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_fused_short_kernels_equal_their_plain_versions_on_the_card(
        cuda_device, s, d, dtype):
    """B7 and B8 at heads of 320 and 512 (the ``wide`` route): bias or
    not, causal or not, dropout 0 and 0.1, as the grid above."""
    _hold_fused_short_kernels(cuda_device, s, d, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(1, 1), (33, 33), (100, 300),
                                    (300, 100)],
                         ids=["1x1", "33x33", "100x300", "300x100"])
@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_flash_kernels_equal_their_plain_versions_on_the_card(
        cuda_device, sq, skv, d, dtype):
    """B4, B5a + B5b and B6 at heads of 320 and 512 (the ``wide`` route,
    where B6 launches the pair): as the flash grid above."""
    _hold_flash_kernels(cuda_device, sq, skv, d, dtype)


# -- speculative decoding and handoff on the card -------------------------------

_SPEC_LM = dict(vocab_size=128, hidden=64, n_block=2, n_head=4, max_len=64)


def _spec_lms(device):
    """The same seeded target and 1-block draft, on ``device``."""
    from analytics_zoo_tpu_torch.capture import TransformerLM
    lm = TransformerLM(**_SPEC_LM, seed=3)
    draft = TransformerLM(**dict(_SPEC_LM, n_block=1, max_len=72), seed=4)
    lm._device(device)
    draft._device(device)
    return lm, draft


@pytest.mark.cuda
@pytest.mark.parametrize("eos", [None, 9])
def test_generate_speculative_on_the_card_equals_the_cpu(cuda_device, eos):
    """Greedy ``generate_speculative`` on the card gives the CPU's tokens
    and the card's own serial ``generate``'s."""
    prompt = np.random.RandomState(5).randint(0, 128, (3, 9))
    got = {}
    for dev in ("cpu", "cuda"):
        lm, draft = _spec_lms(dev)
        got[dev] = lm.generate_speculative(prompt, draft, 20, spec_k=4,
                                           eos_id=eos, page_len=8,
                                           device=dev)
        if dev == "cuda":
            np.testing.assert_array_equal(
                got[dev], lm.generate(prompt, 20, eos_id=eos, device=dev))
    np.testing.assert_array_equal(got["cuda"], got["cpu"])


@pytest.mark.cuda
def test_speculative_serving_and_handoff_on_the_card_equal_the_cpu(
        cuda_device, tmp_path):
    """``GenerativeServing(spec_k)`` on the card, with its streams handed
    off to a second card server after two rounds, ends with the CPU's
    uninterrupted tokens."""
    from analytics_zoo_tpu_torch.serving import (GenerativeServing,
                                                 InputQueue, OutputQueue,
                                                 ServingConfig)
    prompts = np.random.RandomState(6).randint(0, 128, (3, 7)).tolist()
    results = {}
    for dev, hand in (("cpu", False), ("cuda", False), ("cuda", True)):
        lm, draft = _spec_lms(dev)
        srvs = []
        for name in ("a", "b"):
            src = f"dir://{tmp_path}/{dev}{hand}{name}"
            srvs.append((GenerativeServing(ServingConfig(
                data_src=src, slots=3, max_new_tokens=16, kv_pages=24,
                kv_page_len=8, spec_k=3), lm, draft_lm=draft, device=dev),
                src))
        (a, a_src), (b, b_src) = srvs
        for i, p in enumerate(prompts):
            InputQueue(a_src).enqueue_prompt(f"s{i}", p)
        last = a
        if hand:
            a.serve_step()
            a.serve_step()
            assert a.handoff(b.queue) == 3
            last = b
        idle = 0
        while idle < 3:
            idle = idle + 1 if last.serve_step() == 0 else 0
        out = OutputQueue(b_src if hand else a_src)
        results[(dev, hand)] = [out.query(f"s{i}")["value"]
                                for i in range(3)]
    assert results[("cuda", False)] == results[("cpu", False)]
    assert results[("cuda", True)] == results[("cpu", False)]


# -- the fleet router over card instances ------------------------------------------


@pytest.mark.cuda
def test_fleet_router_places_and_fails_over_on_the_card(cuda_device,
                                                        tmp_path):
    """Two ``GenerativeServing`` instances on the card behind a
    ``FleetRouter``: two streams are placed, the instance holding them
    freezes mid-decode (its health file keeps an old stamp), and the other
    adopts both with their prefixes; the tokens equal the CPU's serial
    ``generate`` and each stream has one terminal."""
    import json

    from analytics_zoo_tpu_torch.capture import TransformerLM
    from analytics_zoo_tpu_torch.serving import (FileQueue, FleetInstance,
                                                 FleetRouter,
                                                 GenerativeServing,
                                                 InputQueue, ServingConfig,
                                                 instance_queue)
    cfg = dict(vocab_size=128, hidden=64, n_block=2, n_head=4, max_len=64)
    prompts = np.random.RandomState(7).randint(0, 128, (2, 9)).tolist()
    cpu = TransformerLM(**cfg, seed=3)
    cpu._device("cpu")
    want = cpu.generate(np.asarray(prompts), 12, device="cpu").tolist()
    lm = TransformerLM(**cfg, seed=3)
    lm._device(cuda_device)
    root = str(tmp_path / "fleet")
    front = FileQueue(root)
    servers, insts = [], []
    for name in ("a", "b"):
        q = instance_queue(root, name)
        hp = os.path.join(root, f"{name}.health.json")
        servers.append(GenerativeServing(ServingConfig(
            data_src=root, slots=2, max_new_tokens=12, stream_interval=2,
            health_path=hp, health_interval_s=0.0), lm, queue=q))
        insts.append(FleetInstance(name, q, hp, slots=2))
    a, b = servers
    router = FleetRouter(front, insts, stale_after_s=5.0,
                         health_refresh_s=0.0)
    a.serve_step()
    for i, p in enumerate(prompts):
        InputQueue(f"dir://{root}").enqueue_prompt(f"s{i}", p)
    assert router.route_once() == 2
    for _ in range(5):
        a.serve_step()
    with open(a.config.health_path) as f:
        snap = json.load(f)
    snap["time"] -= 60.0
    with open(a.config.health_path, "w") as f:
        json.dump(snap, f)
    b.serve_step()
    router.route_once()
    idle = 0
    while idle < 3:
        idle = idle + 1 if b.serve_step() == 0 else 0
    got = [front.get_result(f"s{i}") for i in range(2)]
    assert [r["value"] for r in got] == want
    assert router.stats["assigned"] == 2  # settled on the next pass
    router.route_once()
    assert router.stats == {"assigned": 0, "backlog": 0}


@pytest.mark.cuda
def test_estimator_loop_groups_clips_and_retries_on_the_card(cuda_device,
                                                             tmp_path):
    """An MLP trained on the card through ``Estimator.train`` (SGD, whose
    updates do not amplify rounding as Adam's do): 4 steps a
    dispatch equal one a dispatch bit for bit with l2 clipping on; a run
    whose 6th dispatch fails after the newest snapshot is torn falls back
    one snapshot and ends at the straight run's parameters bit for bit;
    the clipped run is the CPU's within 1e-5."""
    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras import Sequential, optimizers
    from analytics_zoo_tpu_torch.keras.layers import Dense

    rs = np.random.RandomState(0)
    x = rs.randn(640, 6).astype(np.float32)
    y = rs.randint(0, 2, 640).astype(np.float32)
    init = Sequential([Dense(16, activation="relu", name="d1"),
                       Dense(2, activation="softmax", name="d2")]).build(
        torch.Generator().manual_seed(0), (None, 6), device="cpu"
    ).state_dict()

    def run(device, k=1, ckpt=None):
        model = Sequential([Dense(16, activation="relu", name="d1"),
                            Dense(2, activation="softmax", name="d2")])
        model.build(input_shape=(None, 6), device=device)
        model.load_state_dict(init)
        est = Estimator(model, "sparse_categorical_crossentropy",
                        optimizers.SGD(0.05), device=device)
        est.set_gradient_clipping(("l2", 0.1))
        if ckpt:
            est.set_checkpoint(ckpt, SeveralIteration(1))
        hist = est.train(FeatureSet.from_ndarrays(x, y), 64, epochs=3,
                         steps_per_dispatch=k)
        return hist["loss_history"], {n: v.cpu() for n, v in
                                      model.state_dict().items()}

    losses, params = run(cuda_device)
    losses4, params4 = run(cuda_device, k=4)
    assert losses4 == losses
    assert all(torch.equal(params4[n], v) for n, v in params.items())
    faults.reset()
    faults.arm("ckpt.corrupt", at=5)
    faults.arm("train.step", at=6)
    try:
        _, retried = run(cuda_device, ckpt=str(tmp_path / "ckpt"))
        fired = (faults.fire_count("ckpt.corrupt"),
                 faults.fire_count("train.step"))
    finally:
        faults.reset()
    assert fired == (1, 1)
    assert all(torch.equal(retried[n], v) for n, v in params.items())
    cpu_losses, cpu_params = run("cpu")
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5, atol=0)
    for n, v in cpu_params.items():
        torch.testing.assert_close(params[n], v, rtol=0, atol=1e-5)
