#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed 0] [--requests 2048] [--single 64]

Phases, each of which must pass or the script exits non-zero:

1. device: a CUDA card is required; TF32 is off for the float32 matmuls.
2. build: ``nvcc`` builds the port's kernels from ``analytics_zoo_tpu_torch/
   csrc`` (or reuses the build for the same sources).
3. kernels: every kernel of the path is held bit for bit against its plain
   PyTorch version at the serving shapes and on ragged, bf16/fp16 and
   out-of-range cases, then timed with CUDA events beside the plain version
   and the one PyTorch call that computes the same function, at the serving
   batch and at 2^20 ids: from a table that fits in L2 and from one of 1 GiB
   with every id distinct, which must stream its rows from device memory.
4. serving: NeuralCF at MovieLens-1M width with seeded random weights is
   saved, loaded by ``ClusterServing`` on the card and answers the requests
   sent through the file spool: first a burst published before the server
   starts (its drain rate is the records/s), then requests sent one at a
   time (their latency). Every request must get exactly one result,
   equal to a direct forward on the card (rtol 1e-5) and to the plain
   forward on the CPU (atol 1e-5); the gather kernel must have launched 4
   times per dispatched batch.

The last three lines of output are the card's ``nvidia-smi`` name and power
limit, the ``{"kernels": [...]}`` line, and the ``{"ok": true, ...}`` line.
"""
import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
NCF = dict(user_count=6040, item_count=3706, num_classes=2, user_embed=64,
           item_embed=64, hidden_layers=[128, 64, 32], mf_embed=32)
#: the four NCF tables [rows, dim] as the serving forward gathers them
NCF_TABLES = (("mlp_user_table", 6041, 64), ("mlp_item_table", 3707, 64),
              ("mf_user_table", 6041, 32), ("mf_item_table", 3707, 32))
SERVE_BATCH = 256
LARGE_N = 1 << 20
#: rows of the timed table that L2 cannot hold: 4 Mi x 64 f32 = 1 GiB
HBM_ROWS = 1 << 22


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events,
    after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 20):
    """Device time per call of the kernels and copies ``fn`` issues, summed
    from a ``torch.profiler`` trace; None when the trace holds no device
    events (the profiler could not reach the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / calls if us > 0 else None


def gather_bound_ms(table: torch.Tensor, ids: torch.Tensor) -> float:
    """Least time for a clip gather of these ids at the memory rate: each id
    read once, each output row written once, and each distinct table row
    the ids reach read once (a row asked for twice is read once)."""
    n, dim = ids.shape[0], table.shape[1]
    distinct = int(torch.unique(ids.clamp(0, table.shape[0] - 1)).numel())
    row = dim * table.element_size()
    return (n * row + 4 * n + distinct * row) / HBM_BYTES_PER_S * 1e3


def phase_kernels(ek, dev, gen):
    """Hold the gather kernel against its plain version, then time both
    and ``index_select``; returns (timings per shape, largest error)."""
    cases = [(rows, dim, torch.float32, SERVE_BATCH)
             for _, rows, dim in NCF_TABLES]
    cases += [(6041, 64, torch.float32, 1), (6041, 64, torch.float32, 257),
              (50, 3, torch.float32, 257), (50, 33, torch.float32, 256),
              (6041, 64, torch.bfloat16, 256), (50, 33, torch.bfloat16, 7),
              (3707, 32, torch.float16, 256), (50, 8, torch.float32, 0)]
    max_err = 0.0
    for rows, dim, dtype, n in cases:
        table = torch.randn(rows, dim, generator=gen).to(dtype).to(dev)
        # ids below 0 and at or past the end, in both modes
        ids = torch.randint(-3, rows + 3, (n,), generator=gen,
                            dtype=torch.int32)
        if n >= 2:
            ids[0], ids[1] = -1, rows
        ids = ids.to(dev)
        for clip in (True, False):
            got = ek.gather(table, ids, clip)
            want = ek.gather_plain(table, ids, clip)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"gather kernel != plain at rows={rows} dim={dim} "
                  f"{dtype} n={n} clip={clip}")
            if n:
                max_err = max(max_err, float(
                    (got.float() - want.float()).abs().max()))
    log(f"kernel == plain (torch.equal) on {len(cases)} shapes x 2 modes")

    timings = []
    dev_gen = torch.Generator(device=dev).manual_seed(gen.initial_seed())
    for label, rows, dim, n, iters in (
            [(name, rows, dim, SERVE_BATCH, 500)
             for name, rows, dim in NCF_TABLES]
            + [("mlp_user_table", 6041, 64, LARGE_N, 50),
               ("hbm_table", HBM_ROWS, 64, LARGE_N, 50)]):
        if rows == HBM_ROWS:
            # every id distinct, so every row comes from device memory
            table = torch.randn(rows, dim, generator=dev_gen, device=dev)
            ids = torch.randperm(rows, generator=dev_gen, device=dev)[:n]
            ids = ids.to(torch.int32)
        else:
            table = torch.randn(rows, dim, generator=gen).to(dev)
            ids = torch.randint(0, rows, (n,), generator=gen,
                                dtype=torch.int32).to(dev)
        fns = {"ms": lambda: ek.gather(table, ids, True),
               "plain_ms": lambda: ek.gather_plain(table, ids, True),
               "library_ms": lambda: torch.index_select(table, 0, ids)}
        t = {"table": label, "rows": rows, "dim": dim, "n": n,
             "bound_ms": gather_bound_ms(table, ids)}
        # *ms: CUDA events around back-to-back calls, what a caller issuing
        # them from Python sees; *device_ms: the profiler's kernel time
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, iters)
            t[key.replace("ms", "device_ms")] = device_ms(fn)
        timings.append(t)
        log("gather timing " + json.dumps(t))
    return timings, max_err


class CountingQueue:
    """Wraps a FileQueue and counts terminal results per uri."""

    def __init__(self, inner):
        self.inner = inner
        self.posts = {}
        self._lock = threading.Lock()

    def put_result(self, uri, value):
        with self._lock:
            self.posts[uri] = self.posts.get(uri, 0) + 1
        self.inner.put_result(uri, value)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def phase_serving(ek, seed: int, n_requests: int, n_single: int,
                  workdir: str, device: str = "cuda"):
    """Serve NCF on ``device`` (the card; ``cpu`` rehearses the phase with
    the plain versions); returns (launches, batches, stats)."""
    from analytics_zoo_tpu_torch.common.utils import timers
    from analytics_zoo_tpu_torch.models import NeuralCF, ZooModel
    from analytics_zoo_tpu_torch.parallel.embedding import (oob_ids_total,
                                                            reset_oob_ids)
    from analytics_zoo_tpu_torch.serving import (ClusterServing, FileQueue,
                                                 InputQueue, OutputQueue,
                                                 ServingConfig)

    model_dir = os.path.join(workdir, "ncf")
    spool_dir = os.path.join(workdir, "spool")
    src = "dir://" + spool_dir
    ncf = NeuralCF(**NCF).build(torch.Generator().manual_seed(seed),
                                device=device)
    ncf.save_model(model_dir)

    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, NCF["user_count"] + 1, n_requests),
                  rng.integers(1, NCF["item_count"] + 1, n_requests)],
                 axis=1).astype(np.float32)
    x[3] = [-1, 5]      # out-of-range ids: validate_ids clamps and counts
    x[10] = [7000, 9]
    x[17] = [12, 5000]
    x[29] = [6040, 3706]  # the last rows, in range

    cfg = ServingConfig(model_type="zoo", model_path=model_dir,
                        data_src=src, image_shape=(2,),
                        batch_size=SERVE_BATCH)
    queue = CountingQueue(FileQueue(spool_dir))
    t0 = time.perf_counter()
    server = ClusterServing(cfg, queue=queue, device=device)
    log(f"ClusterServing up (load + prewarm) in "
        f"{time.perf_counter() - t0:.3f} s on {server.model.device}")
    check(server.model.device.type == device, f"server is not on {device}")
    inq, outq = InputQueue(src), OutputQueue(src)

    ek.reset_launch_counts()
    reset_oob_ids()
    timers.reset()
    # (a) backlog: a burst of requests is published, then the server drains
    # it; records/s is the server's drain rate with the client idle
    t0 = time.perf_counter()
    for i, row in enumerate(x):
        inq.enqueue_tensor(f"req-{i}", row)
    enqueue_s = time.perf_counter() - t0
    t_start = time.perf_counter()
    server.start()
    try:
        deadline = time.monotonic() + 300
        while (server.records_served + sum(server.counters.values())
               < n_requests and time.monotonic() < deadline):
            server.check_health()
            time.sleep(0.002)
        drain_s = time.perf_counter() - t_start
        burst_batches = server.batches_dispatched
        spans = {k: {"s": v[0], "calls": v[1]}
                 for k, v in timers.stats().items()}
        # (b) closed loop: one request at a time, so each one's latency is
        # the serving path's own, with no queue ahead of it
        single = []
        for j in range(n_single):
            uri = f"one-{j}"
            t = time.perf_counter()
            inq.enqueue_tensor(uri, x[j])
            while (queue.get_result(uri) is None
                   and time.monotonic() < deadline):
                server.check_health()
                time.sleep(0.0005)
            single.append((time.perf_counter() - t) * 1e3)
    finally:
        server.drain(timeout_s=60)
    launches = ek.launch_counts["gather_rows"]
    batches = server.batches_dispatched
    oob = oob_ids_total()

    results = outq.dequeue()
    uris = [f"req-{i}" for i in range(n_requests)]
    singles = [f"one-{j}" for j in range(n_single)]
    check(sorted(results) == sorted(uris + singles),
          f"{len(results)} results for {n_requests + n_single} requests")
    check(queue.posts == {u: 1 for u in uris + singles},
          "a request got no terminal result or more than one")
    errors = [u for u in uris + singles if "error" in results[u]]
    check(not errors, f"{len(errors)} error results, e.g. "
          f"{results[errors[0]] if errors else None}")
    check(burst_batches >= math.ceil(n_requests / SERVE_BATCH),
          f"{burst_batches} batches for {n_requests} requests")
    per_batch = 4 if device == "cuda" else 0  # the CPU launches nothing
    check(launches == per_batch * batches,
          f"gather launched {launches} times for {batches} batches "
          f"(expected {per_batch} per batch)")
    served = np.array([results[u]["value"] for u in uris + singles],
                      np.float32)
    check(served.shape == (n_requests + n_single, NCF["num_classes"])
          and bool(np.isfinite(served).all()), "served values malformed")

    xs = np.concatenate([x, x[:n_single]])
    # each out-of-range id is counted once per table it indexes (MLP, GMF)
    n_bad = 2 * int(((xs[:, 0] < 0) | (xs[:, 0] > NCF["user_count"])).sum()
                    + ((xs[:, 1] < 0) | (xs[:, 1] > NCF["item_count"])).sum())
    check(oob == n_bad, f"validate_ids counted {oob} out-of-range ids, "
          f"expected {n_bad}")
    with torch.inference_mode():
        direct = ncf.model(torch.from_numpy(xs).to(device)).cpu().numpy()
        xb = torch.from_numpy(x[:SERVE_BATCH]).to(device)
        forward_ms = (cuda_ms(lambda: ncf.model(xb), 50)
                      if device == "cuda" else None)
    # one served batch as the card sees it: copy in, forward, copy out
    predict_device_ms = (
        device_ms(lambda: server.model.predict(x[:SERVE_BATCH]))
        if device == "cuda" else None)
    np.testing.assert_allclose(served, direct, rtol=1e-5, atol=0)
    plain = ZooModel.load_model(model_dir, device="cpu").predict(xs)
    np.testing.assert_allclose(served, plain, rtol=0, atol=1e-5)
    single.sort()
    stats = {"requests": n_requests + n_single, "burst": n_requests,
             "burst_batches": burst_batches, "batches": batches,
             "enqueue_records_per_s": n_requests / enqueue_s,
             "records_per_s": n_requests / drain_s,
             "burst_latency_p50_ms": server.latency_ms(0.50),
             "single_latency_p50_ms": single[len(single) // 2],
             "single_latency_max_ms": single[-1],
             "forward_ms_batch256": forward_ms,
             "predict_device_ms_batch256": predict_device_ms,
             "device_busy_share": (
                 burst_batches * predict_device_ms / (drain_s * 1e3)
                 if predict_device_ms is not None else None),
             "spans": spans,
             "max_abs_err_vs_card_forward": float(
                 np.abs(served - direct).max()),
             "max_abs_err_vs_cpu_plain": float(np.abs(served - plain).max()),
             "oob_ids_counted": oob}
    return launches, batches, stats


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=2048,
                        help="requests in the burst phase")
    parser.add_argument("--single", type=int, default=64,
                        help="requests sent one at a time after the burst")
    args = parser.parse_args()

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from analytics_zoo_tpu_torch.ops import embedding_kernels as ek
    from analytics_zoo_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"device {torch.cuda.get_device_name(dev)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    kernel_build.load_library()
    log(f"kernel library {os.path.relpath(kernel_build.library_path(), REPO)}"
        f" ready in {time.perf_counter() - t0:.3f} s (nvcc "
        f"{kernel_build.last_build_seconds:.3f} s)")

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    timings, max_err = phase_kernels(ek, dev, gen)

    # -- 4. serving -----------------------------------------------------------
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        launches, batches, stats = phase_serving(ek, args.seed,
                                                 args.requests, args.single,
                                                 workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("serving " + json.dumps(stats) + f" | {smi}")

    # -- 5. the kernels line, 6. the result line ------------------------------
    serve = timings[0]
    entry = {
        "name": "gather_rows", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/csrc/gather_rows.cu",
        "replaces": "analytics_zoo_tpu/ops/embedding_kernels.py:118",
        "tpu_kernel": "_gather_kernel",
        "launches": launches, "launches_per_batch": launches / batches,
        "max_abs_err": max_err,
        "shape": f"table {serve['rows']}x{serve['dim']} f32, "
                 f"n={serve['n']}",
        "ms": serve["ms"], "kernel_ms": serve["ms"],
        "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
        "bound_by": "bytes", "library_ms": serve["library_ms"],
        "device_ms": serve["device_ms"],
        "large": [{k: t[k] for k in (
            "table", "rows", "n", "dim", "ms", "plain_ms", "library_ms",
            "bound_ms", "device_ms", "plain_device_ms", "library_device_ms")}
            for t in timings if t["n"] == LARGE_N],
    }
    print(smi)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
