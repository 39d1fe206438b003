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
6. attention kernels: the fused short attention forward (B7) and backward
   (B8) are held against their plain versions (B8 against autograd through
   the plain forward) for seq 1, 17, 128 and 512, head widths 32 and 64, f32
   and bf16, with and without a padding bias (one row all masked), causal or
   not, dropout 0 and 0.1: within 2e-5 (f32) and 2e-2 (bf16) of the output's
   scale, and bit-equal when repeated. Their dropout mask must equal
   ``dropout_keep_mask`` bit for bit over 1536 x 128 x 128 entries, its kept
   share within 4 sigma of 0.9. At the BERT-base shape (bf16, padding bias,
   dropout 0 and 0.1) both are held to the bf16 tolerance again and timed
   beside their plain versions and ``scaled_dot_product_attention`` with
   the same mask.
7. BERT: ``BERTClassifier`` at BERT-base width (``bench.py``'s) with seeded
   random weights, bf16, dropout 0.1, adam, fine-tunes 2 epochs of 1024
   padded records at batch 128, seq 128 (16 steps), then evaluates and
   predicts. Every block launches B7 once per forward and B8 once per
   step, and the embeddings three row gathers; losses must be finite. The
   step is timed as in 5. Then the same model in f32 without dropout runs
   on the card and on the CPU from the same weights: probabilities atol
   1e-5, one step's gradients within 1e-4 in relative L2 norm, two Adam
   steps' losses rtol 1e-5 and parameters (see ``phase_bert_vs_cpu``).

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
#: H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, f32 without
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: BERT-base at the width bench.py benchmarks (bench.py:880-918):
#: google-research/bert's uncased_L-12_H-768_A-12
BERT_CFG = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                max_position_len=512, intermediate_size=3072)
#: fine-tuning: 1024 records, batch 128, seq 128, 2 epochs = 16 steps, at
#: the learning rate google-research/bert fine-tunes with (at Adam's
#: default 1e-3 the loss climbed from 0.74 to 8 in these 16 steps on an
#: H100)
BERT_RECORDS, BERT_BATCH, BERT_SEQ, BERT_LR = 1024, 128, 128, 2e-5
#: the card-against-CPU check: f32, 8 records at batch 4 = 2 Adam steps
BERT_CPU_RECORDS, BERT_CPU_BATCH = 8, 4
#: B7/B8 against their plain versions: f32 sums in another order; bf16
#: outputs round to 8 bits, so both are relative to the output's scale
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: the card-against-CPU check: Adam had "the CPU's gradient" for a
#: parameter where the card's is within this of it, relative
GRAD_SAME = 1e-3


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


def phase_training(ek, seed: int, workdir: str):
    """Train Wide&Deep on the card and hold it against the same run on the
    CPU; returns (launches, stats)."""
    from analytics_zoo_tpu_torch.models import WideAndDeep

    n_records, batch = WND_RECORDS, WND_BATCH
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

    steps = 2 * (n_records // batch)
    zoo = compiled("cuda")
    est = zoo.model.get_estimator("cuda")
    # the main path: compile -> fit -> evaluate -> predict, counted
    ek.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = zoo.fit(x, y, batch_size=batch, nb_epoch=2)
    torch.cuda.synchronize()
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
        """Launches for ``k`` forwards: one pool and two row gathers
        each."""
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
    first = compiled("cuda")
    first.fit(x, y, batch_size=batch, nb_epoch=1, device="cuda")
    ckpt = os.path.join(workdir, "wnd_epoch1")
    first.model.get_estimator().save_checkpoint(ckpt)
    resumed = compiled("cuda")
    resumed_est = resumed.model.get_estimator("cuda")
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
    # a second, warm 16-step fit, end to end (feed, steps, the loss copies
    # at each epoch's end)
    warm = compiled("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm.fit(x, y, batch_size=batch, nb_epoch=2, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    # one step on a batch already on the card: events and the profiler
    xb = [torch.from_numpy(a[:batch]).cuda() for a in x]
    yb = torch.from_numpy(y[:batch]).cuda()
    west = warm.model.get_estimator()
    step_ms = cuda_ms(lambda: west._train_step(xb, yb), 50)
    prof = step_profile(lambda: west._train_step(xb, yb), calls=10, top=12)
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


def attention_bound_ms(b, h, s, d, dtype, backward: bool) -> tuple:
    """Least time for B7 (or B8) at these shapes, and what bounds it: the
    larger of the bytes each input read once and each output written once
    take at the memory rate and the products' operations at the dtype's
    peak. B7: q, k, v, the [b, s] f32 bias in, o out; 4·bh·s²·d operations
    (q·kᵀ and p·v). B8: q, k, v, dO and the bias in, dq, dk, dv out;
    10·bh·s²·d (q·kᵀ again, dO·vᵀ, pdᵀ·dO, ds·k, dsᵀ·q)."""
    size = torch.tensor([], dtype=dtype).element_size()
    tile = b * h * s * d * size
    bytes_ = (7 if backward else 4) * tile + 4 * b * s
    flops = (10 if backward else 4) * b * h * s * s * d
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _attn_case(dev, b, h, s, d, dtype, gen):
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(dtype).to(dev)
                   for _ in range(4))
    mask = torch.ones(b, s)
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    for i in range(b):
        mask[i, int(lengths[i]):] = 0
    return q, k, v, do, mask


def _rel_err(got, want) -> float:
    """Largest absolute error over the output's scale (at least 1)."""
    scale = max(1.0, float(want.detach().float().abs().max()))
    return float((got.float() - want.float()).abs().max()) / scale


def phase_attention_kernels(at, dev, seed: int):
    """Hold B7 and B8 against their plain versions (autograd through the
    plain forward for B8) over the grid, check the dropout mask bit for bit
    and its kept share, then time both at the BERT-base shape beside the
    plain versions and ``scaled_dot_product_attention``; returns
    (timings, errors)."""
    gen = torch.Generator().manual_seed(seed)
    seed_t = torch.tensor([seed + 17], dtype=torch.int32, device=dev)
    errors = {"fwd": 0.0, "bwd": 0.0}
    cases = 0
    for s in (1, 17, 128, 512):
        for d in (32, 64):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, do, mask = _attn_case(dev, 2, 3, s, d, dtype, gen)
                mask[-1] = 0  # a row of all-masked keys
                bias = ((1.0 - mask) * -1e9).to(dev)
                for kb in (None, bias):
                    for causal in (False, True):
                        for rate in (0.0, 0.1):
                            args = (kb, seed_t, 0.125, rate, causal)
                            o = at.fused_short_fwd(q, k, v, *args)
                            grads = at.fused_short_bwd(q, k, v, do, *args)
                            check(torch.equal(o, at.fused_short_fwd(
                                q, k, v, *args)), "B7 not bit-equal twice")
                            again = at.fused_short_bwd(q, k, v, do, *args)
                            check(all(torch.equal(a, b) for a, b in
                                      zip(grads, again)),
                                  "B8 not bit-equal twice")
                            leaves = [t.detach().clone().requires_grad_()
                                      for t in (q, k, v)]
                            want = at.fused_short_attention_plain(
                                *leaves, kb, 0.125, rate, seed_t, causal)
                            want.backward(do)
                            torch.cuda.synchronize()
                            case = (f"s={s} d={d} {dtype} bias="
                                    f"{kb is not None} causal={causal} "
                                    f"rate={rate}")
                            e = _rel_err(o, want)
                            check(e <= ATTN_ATOL[dtype],
                                  f"B7 != plain by {e} at {case}")
                            e_b = max(_rel_err(g, t.grad)
                                      for g, t in zip(grads, leaves))
                            check(e_b <= ATTN_ATOL[dtype],
                                  f"B8 != autograd through plain by {e_b} "
                                  f"at {case}")
                            errors["fwd"] = max(errors["fwd"], e)
                            errors["bwd"] = max(errors["bwd"], e_b)
                            cases += 1
    log(f"B7/B8 within f32 2e-5, bf16 2e-2 (relative to the output's scale) "
        f"of their plain versions on {cases} cases, bit-equal when repeated;"
        f" largest errors {json.dumps(errors)}")

    # the mask: q = k = 0 makes p = 1/s; v = dO = I reads pd back out of o
    # and dv, so the kernels' mask is o != 0 (and dvᵀ != 0)
    b, h, s = BERT_BATCH, BERT_CFG["n_head"], BERT_SEQ
    zeros = torch.zeros(b, h, s, s, device=dev)
    eye = torch.eye(s, device=dev).expand(b, h, s, s).contiguous()
    o = at.fused_short_fwd(zeros, zeros, eye, None, seed_t, 1.0, 0.1, False)
    _, _, dv = at.fused_short_bwd(zeros, zeros, eye, eye, None, seed_t, 1.0,
                                  0.1, False)
    want = at.dropout_keep_mask(seed_t, b * h, s, 0.1).reshape(b, h, s, s)
    check(torch.equal(o != 0, want), "B7's dropout mask != dropout_keep_mask")
    check(torch.equal(dv.transpose(-1, -2) != 0, want),
          "B8's dropout mask != dropout_keep_mask")
    kept = float(want.float().mean())
    sigma = math.sqrt(0.1 * 0.9 / want.numel())
    check(abs(kept - 0.9) <= 4 * sigma, f"kept share {kept} is more than "
          f"4 sigma ({sigma}) from 0.9")
    mask_stats = {"entries": want.numel(), "kept_share": kept,
                  "sigma": sigma}
    log("B7/B8 dropout masks == dropout_keep_mask bit for bit " +
        json.dumps(mask_stats))
    del zeros, eye, o, dv, want

    # timing at the BERT-base shape, bf16, padding bias
    d = BERT_CFG["hidden_size"] // h
    q, k, v, do, mask = _attn_case(dev, b, h, s, d, torch.bfloat16, gen)
    kb = ((1.0 - mask) * -1e9).to(dev)
    sdpa_mask = kb[:, None, None, :].to(torch.bfloat16)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 1.0 / math.sqrt(d)
    timings = {"shape": {"b": b, "h": h, "s": s, "d": d, "dtype": "bf16"},
               "mask": mask_stats, "errors": errors, "cases": cases}
    for rate in (0.0, 0.1):
        args = (kb, seed_t, scale, rate, False)

        def sdpa_fwd_bwd():
            sdpa(*leaves, attn_mask=sdpa_mask, dropout_p=rate).backward(do)

        fns = {
            "fwd_ms": lambda: at.fused_short_fwd(q, k, v, *args),
            "bwd_ms": lambda: at.fused_short_bwd(q, k, v, do, *args),
            "plain_fwd_ms": lambda: at.fused_short_attention_plain(
                q, k, v, kb, scale, rate, seed_t),
            "plain_bwd_ms": lambda: at.fused_short_bwd_plain(
                q, k, v, do, kb, scale, rate, seed_t, False),
            "library_fwd_ms": lambda: sdpa(q, k, v, attn_mask=sdpa_mask,
                                           dropout_p=rate),
            "library_fwd_bwd_ms": sdpa_fwd_bwd,
        }
        t = {}
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, 20)
            t[key.replace("ms", "device_ms")] = device_ms(fn, calls=5)
        want = at.fused_short_attention_plain(q, k, v, kb, scale, rate,
                                              seed_t)
        got = at.fused_short_fwd(q, k, v, *args)
        t["fwd_max_abs_err"] = float((got.float() - want.float()).abs().max())
        t["fwd_rel_err"] = _rel_err(got, want)
        got = at.fused_short_bwd(q, k, v, do, *args)
        plain = at.fused_short_bwd_plain(q, k, v, do, kb, scale, rate,
                                         seed_t, False)
        t["bwd_max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                                   for a, b in zip(got, plain))
        t["bwd_rel_err"] = max(_rel_err(a, b) for a, b in zip(got, plain))
        for key in ("fwd", "bwd"):
            check(t[f"{key}_rel_err"] <= ATTN_ATOL[torch.bfloat16],
                  f"{'B7' if key == 'fwd' else 'B8'} != plain by "
                  f"{t[f'{key}_rel_err']} at the BERT-base shape, rate {rate}")
        timings[f"rate_{rate}"] = t
        log(f"attention timing rate {rate} " + json.dumps(t))
    for bwd in (False, True):
        bound, by = attention_bound_ms(b, h, s, d, torch.bfloat16, bwd)
        timings["bwd_bound" if bwd else "fwd_bound"] = [bound, by]
    return timings


def bert_records(seed: int, n: int, seq: int):
    """``n`` seeded records: tokens in ``[1, vocab_hi)``, each row padded
    with id 0 after a random length in ``[16, seq]``, and a planted signal
    as in ``examples/textclassification/bert_classifier_example.py`` (label
    = whether token 7 appears), with half the rows given a 7."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(1, 30000, (n, seq))
    tokens[tokens == 7] = 8
    lengths = rs.randint(min(16, seq), seq + 1, n)
    plant = rs.randint(0, 2, n).astype(bool)
    where = (rs.rand(n) * lengths).astype(np.int64)
    tokens[plant, where[plant]] = 7
    for i, length in enumerate(lengths):
        tokens[i, length:] = 0
    return tokens, (tokens == 7).any(axis=1).astype(np.float32)


def phase_bert(at, ek, seed: int):
    """Fine-tune BERT-base (``BERTClassifier``, bf16, dropout 0.1, adam) on
    the card, then evaluate and predict; returns (launches, stats)."""
    from analytics_zoo_tpu_torch.capture import BERTClassifier
    from analytics_zoo_tpu_torch.keras.optimizers import Adam

    cfg = dict(BERT_CFG, compute_dtype="bfloat16", hidden_p_drop=0.1,
               attn_p_drop=0.1)
    n_records, batch, seq = BERT_RECORDS, BERT_BATCH, BERT_SEQ
    tokens, y = bert_records(seed, n_records, seq)

    def built():
        return BERTClassifier(2, bert_config=cfg,
                              optimizer=Adam(BERT_LR)).build(
            seq, torch.Generator().manual_seed(seed), device="cuda")

    clf = built()
    blocks = cfg["n_block"]
    steps = 2 * (n_records // batch)
    forwards = -(-n_records // batch)
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    for name, run in (
            ("fit", lambda: clf.fit(tokens, y, batch_size=batch, epochs=2)),
            ("evaluate", lambda: clf.evaluate(tokens, y, batch_size=batch)),
            ("predict", lambda: clf.predict(tokens, batch_size=batch))):
        at.reset_launch_counts()
        ek.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        counts[name] = {**at.launch_counts,
                        "gather_rows": ek.launch_counts["gather_rows"],
                        "s": time.perf_counter() - t0}
        if name == "fit":
            hist = out
        elif name == "evaluate":
            scores = out
        else:
            preds = out

    def per(k, backward):
        """Launches for ``k`` forwards: one B7 per block, one B8 per block
        when trained, three row gathers."""
        return {"fused_short_fwd": blocks * k,
                "fused_short_bwd": blocks * k if backward else 0,
                "gather_rows": 3 * k}

    for name, k, backward in (("fit", steps, True),
                              ("evaluate", forwards, False),
                              ("predict", forwards, False)):
        got = {key: counts[name][key] for key in per(1, True)}
        check(got == per(k, backward), f"{name} launched {got}, expected "
              f"{per(k, backward)}")
    losses = np.asarray(hist["loss_history"])
    check(hist["iterations"] == steps and losses.shape == (steps,)
          and bool(np.isfinite(losses).all()),
          f"BERT fit: {hist['iterations']} steps, losses {losses}")
    check(preds.shape == (n_records, 2) and bool(np.isfinite(preds).all()),
          "BERT predictions malformed")
    stats = {"records": n_records, "batch": batch, "seq": seq,
             "steps": steps, "loss_first": float(losses[0]),
             "loss_last": float(losses[-1]), "losses": losses.tolist(),
             "accuracy": scores["accuracy"], "launches": counts,
             "first_fit_s": counts["fit"]["s"],
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    # a warm 16-step fit, end to end
    warm = built()
    warm.predict(tokens[:batch], batch_size=batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm.fit(tokens, y, batch_size=batch, epochs=2)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    # one training step on a batch already on the card
    from analytics_zoo_tpu_torch.capture.text import bert_input_pack
    xb = [torch.from_numpy(a[:batch]).cuda() for a in bert_input_pack(tokens)]
    yb = torch.from_numpy(y[:batch]).cuda()
    west = warm.model.get_estimator()
    warm.model.train()
    step_ms = cuda_ms(lambda: west._train_step(xb, yb), 10)
    prof = step_profile(lambda: west._train_step(xb, yb), calls=5, top=12)
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
    return counts, stats


def phase_bert_vs_cpu(seed: int):
    """BERT-base in f32 with dropout off, fit for two Adam steps on the card
    and on the CPU from the same weights: the forward's probabilities, the
    gradients each step handed to Adam, and the losses and parameters;
    returns stats.

    Tolerances, for 12 layers of f32 sums taken in another order: the
    probabilities atol 1e-5; the first step's gradient tensors within 1e-4
    of the CPU's in L2 norm, relative to the larger of their own norm and
    1e-4 of the largest tensor's (the key projection's bias gets a gradient
    of zero in exact arithmetic, softmax being shift-invariant, so its
    value is rounding noise); the losses rtol 1e-5. Adam moves a parameter
    by about ``lr·sign(g)`` whatever ``|g|``, so where rounding decides a
    gradient's sign the two runs part by up to ``2·lr`` a step. Where Adam
    received the CPU's gradient within ``GRAD_SAME`` (relative) at every
    step, its two steps part by at most about ``5·lr·GRAD_SAME`` (5e-6):
    those parameters must agree within atol 1e-5, the rest within
    ``2·lr`` a step."""
    from analytics_zoo_tpu_torch.capture import BERTClassifier

    cfg = dict(BERT_CFG, hidden_p_drop=0.0, attn_p_drop=0.0)
    n, batch, seq = BERT_CPU_RECORDS, BERT_CPU_BATCH, BERT_SEQ
    tokens, y = bert_records(seed + 1, n, seq)
    init = BERTClassifier(2, bert_config=cfg, dropout=0.0).build(
        seq, torch.Generator().manual_seed(seed), device="cpu")
    weights = {k: v.clone() for k, v in init.model.state_dict().items()}
    runs = {}
    for dev in ("cuda", "cpu"):
        clf = BERTClassifier(2, bert_config=cfg, dropout=0.0).build(
            seq, device=dev)
        clf.model.load_state_dict(weights)
        probs = clf.predict(tokens, batch_size=batch, device=dev)
        opt = clf.model.get_estimator().optimizer
        seen = []  # the gradients each step hands to Adam

        def recording(params, grads, state, step=opt.step, seen=seen):
            seen.append({k: g.detach().cpu() for k, g in grads.items()})
            step(params, grads, state)

        opt.step = recording
        hist = clf.fit(tokens, y, batch_size=batch, epochs=1)
        runs[dev] = (probs, seen, hist["loss_history"],
                     {k: v.detach().cpu()
                      for k, v in clf.model.state_dict().items()})
        lr = opt.learning_rate
    (p_dev, g_dev, l_dev, w_dev), (p_cpu, g_cpu, l_cpu, w_cpu) = (
        runs["cuda"], runs["cpu"])
    probs_err = float(np.abs(p_dev - p_cpu).max())
    check(probs_err <= 1e-5, f"card probabilities differ by {probs_err}")
    steps = len(l_cpu)
    check(len(g_dev) == len(g_cpu) == steps and g_dev[0].keys() == w_cpu.keys()
          and g_cpu[0].keys() == w_cpu.keys(), "different gradients")
    first_dev, first_cpu = g_dev[0], g_cpu[0]
    floor = 1e-4 * max(float(g.norm()) for g in first_cpu.values())
    grad_rel, worst = max(
        (float((first_dev[k] - first_cpu[k]).norm())
         / max(float(first_cpu[k].norm()), floor), k) for k in first_cpu)
    check(grad_rel <= 1e-4, f"gradient {worst} differs by {grad_rel} "
          f"(relative L2)")
    np.testing.assert_allclose(l_dev, l_cpu, rtol=1e-5, atol=0)
    held_err, free_err, free = (0.0, ""), 0.0, 0
    for k in w_cpu:
        same = torch.ones_like(w_cpu[k], dtype=torch.bool)
        for gd, gc in zip(g_dev, g_cpu):
            same &= (gd[k] - gc[k]).abs() <= GRAD_SAME * gc[k].abs()
        diff = (w_dev[k] - w_cpu[k]).abs()
        if bool(same.any()):
            held_err = max(held_err, (float(diff[same].max()), k))
        if not bool(same.all()):
            free_err = max(free_err, float(diff[~same].max()))
            free += int((~same).sum())
    check(held_err[0] <= 1e-5, f"parameter {held_err[1]} differs by "
          f"{held_err[0]} where Adam had the CPU's gradients")
    check(free_err <= 2 * lr * steps, f"a parameter moved {free_err} from "
          f"the CPU's, past Adam's bound {2 * lr * steps}")
    return {"records": n, "batch": batch, "seq": seq, "adam_steps": steps,
            "lr": lr, "max_abs_err_probs": probs_err,
            "max_rel_l2_err_grad": grad_rel, "worst_grad": worst,
            "max_rel_err_loss": float(np.max(np.abs(
                np.asarray(l_dev) - l_cpu) / np.abs(l_cpu))),
            "max_abs_err_params": held_err[0], "worst_param": held_err[1],
            "params": sum(v.numel() for v in w_cpu.values()),
            "params_other_gradient": free,
            "max_abs_err_params_other_gradient": free_err}


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
                  workdir: str):
    """Serve NCF on the card; returns (launches, batches, stats)."""
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
                                device="cuda")
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
    server = ClusterServing(cfg, queue=queue, device="cuda")
    log(f"ClusterServing up (load + prewarm) in "
        f"{time.perf_counter() - t0:.3f} s on {server.model.device}")
    check(server.model.device.type == "cuda", "server is not on the card")
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
    check(launches == 4 * batches, f"gather launched {launches} times for "
          f"{batches} batches (expected 4 per batch)")
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
        direct = ncf.model(torch.from_numpy(xs).cuda()).cpu().numpy()
        xb = torch.from_numpy(x[:SERVE_BATCH]).cuda()
        forward_ms = cuda_ms(lambda: ncf.model(xb), 50)
    # one served batch as the card sees it: copy in, forward, copy out
    predict_device_ms = device_ms(
        lambda: server.model.predict(x[:SERVE_BATCH]))
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
    from analytics_zoo_tpu_torch.ops import attention as at
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
    t0 = time.perf_counter()
    attn = phase_attention_kernels(at, dev, args.seed)
    phase_s = {"attention_kernels": time.perf_counter() - t0}

    # -- 4. serving, 5. training ---------------------------------------------
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        launches, batches, stats = phase_serving(ek, args.seed,
                                                 args.requests, args.single,
                                                 workdir)
        log("serving " + json.dumps(stats) + f" | {smi}")
        train_launches, train_stats = phase_training(ek, args.seed, workdir)
        log("training " + json.dumps(train_stats) + f" | {smi}")
        # -- 6. BERT fine-tuning, 7. BERT on the card against the CPU ----
        t0 = time.perf_counter()
        bert_launches, bert_stats = phase_bert(at, ek, args.seed)
        phase_s["bert"] = time.perf_counter() - t0
        log("bert " + json.dumps(bert_stats) + f" | {smi}")
        t0 = time.perf_counter()
        bert_cpu = phase_bert_vs_cpu(args.seed)
        phase_s["bert_vs_cpu"] = time.perf_counter() - t0
        log("bert card vs cpu " + json.dumps(bert_cpu) + f" | {smi}")
        log("bert phases, s: " + json.dumps(phase_s))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # -- 8. the kernels line, 9. the result line ------------------------------
    serve = timings[0]
    rows_launches = {"serving": launches,
                     "training": train_launches["gather_rows"],
                     "bert": sum(c["gather_rows"]
                                 for c in bert_launches.values())}
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
    main_t = attn["rate_0.1"]  # the fine-tune's attention dropout
    attn_shape = (f"b {BERT_BATCH} x h {BERT_CFG['n_head']}, s {BERT_SEQ}, "
                  f"d 64, bf16, padding bias, dropout 0.1")
    attn_entries = []
    for name, key, line, tpu, bound, library in (
            ("fused_short_fwd", "fwd", 716, "_fused_short_fwd_kernel",
             attn["fwd_bound"], ("library_fwd_ms",
                                 "scaled_dot_product_attention, forward")),
            ("fused_short_bwd", "bwd", 761, "_fused_short_bwd_kernel",
             attn["bwd_bound"], ("library_fwd_bwd_ms",
                                 "scaled_dot_product_attention, forward and "
                                 "backward (it has no backward alone)"))):
        by_path = {k: c[name] for k, c in bert_launches.items()}
        attn_entries.append({
            "name": name, "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/fused_short_attn.cu",
            "replaces": f"analytics_zoo_tpu/ops/attention.py:{line}",
            "tpu_kernel": tpu, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_train_step": by_path["fit"] / bert_stats["steps"],
            "max_abs_err": main_t[f"{key}_max_abs_err"],
            "max_rel_err_grid": attn["errors"][key],
            "shape": attn_shape, "ms": main_t[f"{key}_ms"],
            "kernel_ms": main_t[f"{key}_ms"],
            "plain_ms": main_t[f"plain_{key}_ms"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": main_t[library[0]], "library": library[1],
            "device_ms": main_t[f"{key}_device_ms"],
            "no_dropout": {k: v for k, v in attn["rate_0.0"].items()
                           if k.startswith((key, "plain_" + key, "library"))},
        })
    print(smi)
    print(json.dumps({"kernels": [entry, pool_entry] + attn_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
