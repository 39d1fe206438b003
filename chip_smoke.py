#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed 0] [--requests 2048] [--single 64]

Phases, each of which must pass or the script exits non-zero:

1. device: a CUDA card is required; TF32 is off for the float32 matmuls.
2. build: ``nvcc`` builds the port's kernels from ``analytics_zoo_tpu_torch/
   csrc`` (or reuses the build for the same sources), one process per
   source; then the library is built twice more into a scratch directory,
   that way and with one ``nvcc`` over every source, and both are timed.
3. kernels: every kernel of the paths is held bit for bit against its
   plain PyTorch version at the main paths' shapes and on ragged, bag-size,
   bf16/fp16 and out-of-range cases, then timed with CUDA events and the
   profiler beside the plain version and the one PyTorch call that computes
   the same function. The row gather: at the serving batch and at 2^20 ids,
   from a table that fits in L2 and from one of 1 GiB with every id
   distinct. The gather+pool: at the Wide&Deep wide table ([101016, 2],
   8192 bags of 3) and at 2^20 bags of 8 over a 64-wide table of 2^23 rows
   (2 GiB) with every id distinct, beside ``embedding_bag`` (sum and mean).
4. serving: NeuralCF at MovieLens-1M width with seeded random weights is
   saved, loaded by ``ClusterServing`` on the card and answers the requests
   sent through the file spool: first a burst published before the server
   starts (its drain rate is the records/s), then requests sent one at a
   time (their latency). Every request must get exactly one result,
   equal to a direct forward on the card (rtol 1e-5) and to the plain
   forward on the CPU (atol 1e-5); the gather kernel must have launched 4
   times per dispatched batch.
5. training: Wide&Deep at the width ``bench.py`` benchmarks (Census-like
   columns, hidden (40, 20, 10)) with seeded random weights is compiled
   (adam, sparse categorical crossentropy, accuracy) and fit on the card,
   2 epochs of 65,536 seeded records at batch 8192 (16 steps), then
   evaluated and predicted. The pool kernel must have launched once per
   forward and the row gather twice. The same run on the CPU from the same
   weights must agree: loss history rtol 1e-5, parameters atol 1e-5,
   predictions atol 1e-5, accuracy atol 1e-4 (a few of 65,536 argmaxes may
   flip on a rounding-size difference). A run stopped after epoch 1,
   checkpointed and resumed in a fresh estimator must end at the
   uninterrupted run's parameters within atol 1e-5 and its losses within
   rtol 1e-5: the card's ``index_add_`` adds with atomics in no fixed
   order, and Adam's normalised step can grow such a rounding difference in
   a parameter whose gradient nearly cancels (7e-7 seen). Then the step is
   timed: CUDA events, the profiler's device time and its top kernels, and
   the wall time of a warm 16-step fit.

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
#: Wide&Deep at the width bench.py benchmarks (bench.py:654-661)
WND_COLUMNS = dict(
    wide_base_cols=["edu", "occ"], wide_base_dims=[16, 1000],
    wide_cross_cols=["edu_occ"], wide_cross_dims=[100000],
    indicator_cols=["work", "marital"], indicator_dims=[9, 7],
    embed_cols=["edu_e", "occ_e"], embed_in_dims=[16, 1000],
    embed_out_dims=[8, 8], continuous_cols=["age", "hours"])
WND_HIDDEN = (40, 20, 10)
#: training records and batch: 2 epochs of 8 steps
WND_RECORDS, WND_BATCH = 65536, 8192
#: the wide table's rows: sum of the wide dims
WND_WIDE_ROWS = 16 + 1000 + 100000
#: the timed large pool: 2^20 bags of 8 over 2^23 rows x 64 f32 (2 GiB),
#: so every one of the 2^23 ids is a distinct row
POOL_LARGE_N, POOL_LARGE_BAG, POOL_LARGE_ROWS = 1 << 20, 8, 1 << 23


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
    return step_profile(fn, calls)["device_ms"]


def step_profile(fn, calls: int = 20, top: int = 0) -> dict:
    """A ``torch.profiler`` trace of ``calls`` calls of ``fn``, per call:
    the device time of its kernels and copies (None when the trace holds no
    device events), their number, and with ``top`` the ``top`` longest
    kernels and the ``top`` host operators with the most self time, as
    ``[name, ms, count]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in dev)
    out = {"device_ms": us / 1e3 / calls if us > 0 else None,
           "device_launches": sum(e.count for e in dev) / calls}
    if top:
        host = [e for e in events if e.device_type == DeviceType.CPU]
        dev.sort(key=lambda e: -e.self_device_time_total)
        host.sort(key=lambda e: -e.self_cpu_time_total)
        out["top_device"] = [[e.key[:72], e.self_device_time_total / 1e3
                              / calls, e.count / calls] for e in dev[:top]]
        out["top_host"] = [[e.key[:72], e.self_cpu_time_total / 1e3 / calls,
                            e.count / calls] for e in host[:top]]
    return out


def rebuild_seconds(kernel_build) -> dict:
    """Seconds to build the kernel library again into a scratch directory:
    as ``kernel_build`` does (one ``nvcc`` per source, started together,
    then a link), and with one ``nvcc`` over every source."""
    srcs, _ = kernel_build._sources()
    out = {}
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        kernel_build._build(os.path.join(tmp, "parallel.so"))
        out["nvcc_per_source"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS,
                        "-shared", "-I", kernel_build.CSRC_DIR, "-o",
                        os.path.join(tmp, "one.so"), *srcs],
                       check=True, capture_output=True)
        out["one_nvcc"] = time.perf_counter() - t0
    return out


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


def pool_bound_ms(table: torch.Tensor, ids: torch.Tensor, clip: bool) -> float:
    """Least time for a pooled gather of these ids at the memory rate: the
    ids read once, the output written once, and each distinct table row
    that adds to a bag read once."""
    rows, dim = table.shape
    n = ids.shape[0]
    used = ids.clamp(0, rows - 1) if clip else ids[(ids >= 0) & (ids < rows)]
    distinct = int(torch.unique(used).numel())
    row = dim * table.element_size()
    return (ids.numel() * 4 + distinct * row + n * row) / HBM_BYTES_PER_S * 1e3


def wide_ids(rs: np.random.RandomState, n: int) -> np.ndarray:
    """Offset wide bucket ids as ``bench.py`` makes them."""
    dims = WND_COLUMNS["wide_base_dims"] + WND_COLUMNS["wide_cross_dims"]
    offsets = np.cumsum([0] + dims)[:-1]
    return np.stack([rs.randint(0, d, n) + off
                     for d, off in zip(dims, offsets)], 1).astype(np.int32)


def phase_pool_kernels(ek, dev, gen, seed: int):
    """Hold the gather+pool kernel against its plain version, then time it,
    the plain version and ``embedding_bag``; returns (timings, largest
    error)."""
    cases = [(rows, dim, bag, n, dtype)
             for rows, dim, bag, n, dtype in (
                 (WND_WIDE_ROWS, 2, 3, 8192, torch.float32),
                 (50, 2, 1, 257, torch.float32),
                 (50, 2, 17, 100, torch.float32),
                 (50, 8, 17, 100, torch.float32),
                 (50, 33, 3, 64, torch.float32),
                 (300, 64, 8, 129, torch.float32),
                 (300, 64, 1, 33, torch.float32),
                 (300, 64, 3, 64, torch.bfloat16),
                 (50, 2, 3, 256, torch.bfloat16),
                 (50, 33, 17, 31, torch.float16),
                 (50, 8, 3, 90, torch.float16),
                 (50, 8, 3, 0, torch.float32))]
    max_err = 0.0
    checked = 0
    for rows, dim, bag, n, dtype in cases:
        table = torch.randn(rows, dim, generator=gen).to(dtype).to(dev)
        # ids below 0 and at or past the end: masked, or clamped with clip
        ids = torch.randint(-3, rows + 3, (n, bag), generator=gen,
                            dtype=torch.int32)
        if n >= 2:
            ids[0, 0], ids[1, -1] = -1, rows
        ids = ids.to(dev)
        for combiner in ("sum", "mean", "sqrtn"):
            for clip in (True, False):
                got = ek.pool(table, ids, combiner, clip)
                want = ek.gather_pool_plain(table, ids, combiner, clip)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"pool kernel != plain at rows={rows} dim={dim} "
                      f"bag={bag} n={n} {dtype} {combiner} clip={clip}")
                checked += 1
                if n:
                    max_err = max(max_err, float(
                        (got.float() - want.float()).abs().max()))
    # the W&D forward's own call: validated (in-range) offset ids, clamped
    rs = np.random.RandomState(seed)
    table = torch.randn(WND_WIDE_ROWS, 2, generator=gen).to(dev)
    ids = torch.from_numpy(wide_ids(rs, 8192)).to(dev)
    got = ek.gather_pool(table, ids, "sum", mask_negative=False)
    check(torch.equal(got, ek.gather_pool_plain(table, ids, "sum", True)),
          "pool kernel != plain at the W&D wide-table call")
    log(f"pool kernel == plain (torch.equal) on {checked} shape x combiner "
        f"x mode cases and the W&D wide-table call")

    timings = []
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    for label, iters in (("wide_table", 500), ("hbm_table", 20)):
        if label == "hbm_table":
            table = torch.randn(POOL_LARGE_ROWS, 64, generator=dev_gen,
                                device=dev)
            ids = torch.randperm(POOL_LARGE_ROWS, generator=dev_gen,
                                 device=dev).to(torch.int32).reshape(
                POOL_LARGE_N, POOL_LARGE_BAG)
        # embedding_bag takes int64 ids; converted once, outside the timing
        ids64 = ids.long()
        fns = {
            "ms": lambda: ek.pool(table, ids, "sum", True),
            "mean_ms": lambda: ek.pool(table, ids, "mean", True),
            "plain_ms": lambda: ek.gather_pool_plain(table, ids, "sum",
                                                     True),
            "library_ms": lambda: torch.nn.functional.embedding_bag(
                ids64, table, mode="sum"),
            "library_mean_ms": lambda: torch.nn.functional.embedding_bag(
                ids64, table, mode="mean"),
        }
        t = {"table": label, "rows": table.shape[0], "dim": table.shape[1],
             "n": ids.shape[0], "bag": ids.shape[1],
             "bound_ms": pool_bound_ms(table, ids, clip=True)}
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, iters)
            t[key.replace("ms", "device_ms")] = device_ms(fn)
        ref = torch.nn.functional.embedding_bag(ids64, table, mode="sum")
        t["library_max_abs_diff"] = float(
            (ek.pool(table, ids, "sum", True) - ref).abs().max())
        timings.append(t)
        log("pool timing " + json.dumps(t))
        del fns, ids64
    return timings, max_err


def wnd_records(seed: int, n: int):
    """``n`` seeded Wide&Deep records made as ``bench.py:662-671`` makes
    them: the four model inputs and the labels."""
    rs = np.random.RandomState(seed)
    wide = wide_ids(rs, n)
    ind = np.stack([rs.randint(0, d, n) for d in
                    WND_COLUMNS["indicator_dims"]], 1).astype(np.int32)
    emb = np.stack([rs.randint(0, d, n) for d in
                    WND_COLUMNS["embed_in_dims"]], 1).astype(np.int32)
    cont = rs.rand(n, 2).astype(np.float32)
    y = rs.randint(0, 2, n).astype(np.float32)
    return [wide, ind, emb, cont], y


def phase_training(ek, seed: int, n_records: int, batch: int, workdir: str,
                   device: str = "cuda"):
    """Train Wide&Deep on ``device`` (the card; ``cpu`` rehearses the phase
    with the plain versions) and hold it against the same run on the CPU;
    returns (launches, stats)."""
    from analytics_zoo_tpu_torch.models import WideAndDeep

    x, y = wnd_records(seed, n_records)
    init = WideAndDeep("wide_n_deep", 2, hidden_layers=WND_HIDDEN,
                       **WND_COLUMNS).build(
        torch.Generator().manual_seed(seed), device="cpu").model.state_dict()

    def compiled(dev):
        zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=WND_HIDDEN,
                          **WND_COLUMNS).build(device=dev)
        zoo.model.load_state_dict(init, strict=True)
        zoo.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
        return zoo

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    steps = 2 * (n_records // batch)
    zoo = compiled(device)
    est = zoo.model.get_estimator(device)
    # the main path: compile -> fit -> evaluate -> predict, counted
    ek.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    hist = zoo.fit(x, y, batch_size=batch, nb_epoch=2)
    sync()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(ek.launch_counts)
    ek.reset_launch_counts()
    scores = zoo.evaluate(x, y, batch_size=batch)
    eval_launches = dict(ek.launch_counts)
    ek.reset_launch_counts()
    preds = zoo.predict(x, batch_size=batch)
    predict_launches = dict(ek.launch_counts)
    forwards = -(-n_records // batch)

    def per(k):
        """Launches for ``k`` forwards: one pool and two row gathers each
        on the card, none on the CPU."""
        k = k if on_card else 0
        return {"gather_rows": 2 * k, "gather_pool": k}

    check(hist["iterations"] == steps, f"{hist['iterations']} steps, "
          f"expected {steps}")
    check(fit_launches == per(steps), f"fit launched {fit_launches} over "
          f"{steps} steps, expected {per(steps)}")
    check(eval_launches == per(forwards) and
          predict_launches == per(forwards),
          f"evaluate launched {eval_launches}, predict {predict_launches}, "
          f"expected {per(forwards)} each")
    losses = np.asarray(hist["loss_history"])
    check(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
          f"loss history malformed: {losses}")
    check(preds.shape == (n_records, 2) and bool(np.isfinite(preds).all()),
          "predictions malformed")

    # the same run on the CPU, from the same weights
    cpu = compiled("cpu")
    cpu_hist = cpu.fit(x, y, batch_size=batch, nb_epoch=2, device="cpu")
    cpu_scores = cpu.evaluate(x, y, batch_size=batch)
    cpu_preds = cpu.predict(x, batch_size=batch)
    np.testing.assert_allclose(losses, cpu_hist["loss_history"], rtol=1e-5,
                               atol=0)
    params = est.get_params()
    cpu_params = cpu.model.get_estimator().get_params()
    param_err = max(float(np.abs(params[l][k] - v).max())
                    for l, ps in cpu_params.items() for k, v in ps.items())
    check(param_err <= 1e-5, f"card params differ from the CPU run's by "
          f"{param_err}")
    np.testing.assert_allclose(preds, cpu_preds, rtol=0, atol=1e-5)
    check(abs(scores["accuracy"] - cpu_scores["accuracy"]) <= 1e-4,
          f"accuracy {scores} vs the CPU's {cpu_scores}")

    # stop after epoch 1, checkpoint, resume in a fresh estimator
    first = compiled(device)
    first.fit(x, y, batch_size=batch, nb_epoch=1, device=device)
    ckpt = os.path.join(workdir, "wnd_epoch1")
    first.model.get_estimator().save_checkpoint(ckpt)
    resumed = compiled(device)
    resumed_est = resumed.model.get_estimator(device)
    resumed_est.load_checkpoint(ckpt)
    rest = resumed.fit(x, y, batch_size=batch, nb_epoch=2)
    check(rest["iterations"] == steps, "the resumed run ended at step "
          f"{rest['iterations']}, expected {steps}")
    resume_err = max(
        float(np.abs(v - params[l][k]).max())
        for l, ps in resumed_est.get_params().items() for k, v in ps.items())
    check(resume_err <= 1e-5, f"resumed params differ from the "
          f"uninterrupted run's by {resume_err}")
    np.testing.assert_allclose(rest["loss_history"], losses[steps // 2:],
                               rtol=1e-5, atol=0)

    stats = {"records": n_records, "batch": batch, "steps": steps,
             "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
             "accuracy": scores["accuracy"],
             "cpu_accuracy": cpu_scores["accuracy"],
             "max_abs_err_loss_vs_cpu": float(
                 np.abs(losses - cpu_hist["loss_history"]).max()),
             "max_abs_err_params_vs_cpu": param_err,
             "max_abs_err_predict_vs_cpu": float(
                 np.abs(preds - cpu_preds).max()),
             "max_abs_err_resumed_params": resume_err,
             "launches_fit": fit_launches, "launches_evaluate": eval_launches,
             "launches_predict": predict_launches,
             "first_fit_s": fit_s}
    if on_card:
        # a second, warm 16-step fit, end to end (feed, steps, the loss
        # copies at each epoch's end)
        warm = compiled(device)
        sync()
        t0 = time.perf_counter()
        warm.fit(x, y, batch_size=batch, nb_epoch=2, device=device)
        sync()
        wall_s = time.perf_counter() - t0
        # one step on a batch already on the card: events and the profiler
        xb = [torch.from_numpy(a[:batch]).to(device) for a in x]
        yb = torch.from_numpy(y[:batch]).to(device)
        west = warm.model.get_estimator()
        step_ms = cuda_ms(lambda: west._train_step(xb, yb), 50)
        prof = step_profile(lambda: west._train_step(xb, yb), calls=10,
                            top=12)
        step_device_ms = prof["device_ms"]
        stats.update({
            "fit_wall_s": wall_s,
            "fit_ms_per_step": wall_s * 1e3 / steps,
            "fit_samples_per_s": steps * batch / wall_s,
            "step_ms_events": step_ms,
            "step_samples_per_s_events": batch / step_ms * 1e3,
            "step_device_ms": step_device_ms,
            "device_busy_share": (step_device_ms * steps / (wall_s * 1e3)
                                  if step_device_ms is not None else None),
            "step_device_launches": prof["device_launches"],
            "step_top_kernels": prof["top_device"],
            "step_top_host_ops": prof["top_host"]})
    return fit_launches, stats


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
        f"{kernel_build.last_build_seconds:.3f} s); rebuilt, s: "
        + json.dumps(rebuild_seconds(kernel_build)))

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    timings, max_err = phase_kernels(ek, dev, gen)
    pool_timings, pool_err = phase_pool_kernels(ek, dev, gen, args.seed)

    # -- 4. serving, 5. training ---------------------------------------------
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        launches, batches, stats = phase_serving(ek, args.seed,
                                                 args.requests, args.single,
                                                 workdir)
        log("serving " + json.dumps(stats) + f" | {smi}")
        train_launches, train_stats = phase_training(
            ek, args.seed, WND_RECORDS, WND_BATCH, workdir)
        log("training " + json.dumps(train_stats) + f" | {smi}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # -- 6. the kernels line, 7. the result line ------------------------------
    serve = timings[0]
    rows_launches = {"serving": launches,
                     "training": train_launches["gather_rows"]}
    entry = {
        "name": "gather_rows", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/csrc/gather_rows.cu",
        "replaces": "analytics_zoo_tpu/ops/embedding_kernels.py:118",
        "tpu_kernel": "_gather_kernel",
        "launches": sum(rows_launches.values()),
        "launches_by_path": rows_launches,
        "launches_per_batch": launches / batches,
        "launches_per_train_step":
            train_launches["gather_rows"] / train_stats["steps"],
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
    wide = pool_timings[0]
    pool_entry = {
        "name": "gather_pool", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/csrc/gather_pool.cu",
        "replaces": "analytics_zoo_tpu/ops/embedding_kernels.py:195",
        "tpu_kernel": "_gather_pool_kernel",
        "launches": train_launches["gather_pool"],
        "launches_by_path": {"serving": 0,
                             "training": train_launches["gather_pool"]},
        "launches_per_train_step":
            train_launches["gather_pool"] / train_stats["steps"],
        "max_abs_err": pool_err,
        "shape": f"table {wide['rows']}x{wide['dim']} f32, n={wide['n']}, "
                 f"bag={wide['bag']}, sum",
        "ms": wide["ms"], "kernel_ms": wide["ms"],
        "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
        "bound_by": "bytes", "library_ms": wide["library_ms"],
        "library": "torch.nn.functional.embedding_bag(mode='sum')",
        "device_ms": wide["device_ms"],
        "large": [{k: t[k] for k in (
            "table", "rows", "n", "bag", "dim", "ms", "mean_ms", "plain_ms",
            "library_ms", "library_mean_ms", "bound_ms", "device_ms",
            "mean_device_ms", "plain_device_ms", "library_device_ms",
            "library_mean_device_ms")} for t in pool_timings[1:]],
    }
    print(smi)
    print(json.dumps({"kernels": [entry, pool_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
