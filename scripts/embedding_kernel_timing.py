#!/usr/bin/env python3
"""Time the embedding kernels on one card, in turns with earlier designs
and with their library calls: the row gather (B1), the row scatter-add
(B3), the gather+pool (B2) and the int8 row gather (B9).

    python3 scripts/embedding_kernel_timing.py [--only b1 b2 b3 b9]
    python3 scripts/embedding_kernel_timing.py --was DIR
    python3 scripts/embedding_kernel_timing.py --variants [variant ...]

Builds the kernel library (``ops/kernel_build``), and with ``--was DIR``
a second library from whichever of ``gather_rows.cu``, ``scatter_rows.cu``,
``gather_pool.cu`` and ``gather_int8.cu`` ``DIR`` holds (earlier sources
with the same C entries, e.g. commit dd78eba's B2 and B9: ``git show
dd78eba:analytics_zoo_tpu_torch/csrc/gather_pool.cu >
DIR/gather_pool.cu``, since the card's copy has no ``.git``; an earlier
B3 there is taken to be dcaa81e's, which takes no fill counter), and with
``--variants`` one more for each named text edit of ``EDITS``, built from
the sources it edits (all of them when none is named). Each is built by
its own ``nvcc``, all started together, into
``build/embedding_kernel_timing/`` and loaded with ``ctypes``; a kernel is
timed in every library that holds its C entry.

B3, at ``chip_smoke.scatter_timed_cases``' shapes (the Wide&Deep shard
[25,000,254, 2] with 24,576 uniform rows, the three blocks a sharded step
scatters into on one rank with the rows it receives, and a 1 GiB block
[2^22, 64] with 2^20 uniform rows): every build's C entry, ``torch.zeros``
+ ``index_add_``, the fills alone (``cudaMemsetAsync``, ``torch.zeros``)
and the committed B3 with every row dropped (its fill and barrier without
the adds), in turns (forward then backward through the names,
``--rounds`` rounds (3), ten calls after five a turn, CUDA events and the
profiler's device time), each output held to the plain version (bit for
bit where no row repeats, else within 2e-5 of the scale).

B1, at ``chip_smoke.gather_timed_cases``' shapes (the NCF serving tables,
2^20 ids from L2 and from device memory, the LM's embedding, BERT-base's
three tables, the sharded Wide&Deep's two shards in fill mode): every
build's C entry and ``index_select`` (of the clamped ids in fill mode) in
turns, each output equal to the plain version; where the bytes fit in L2,
the same again with L2 evicted before each call
(``chip_smoke.cold_device_ms``, the time the device-memory bound holds
for).

B2, at the Wide&Deep forward's wide-table call ([101016, 2] f32, 8192
bags of 3 validated ids, sum, clamped) and at a 2 GiB table ([2^23, 64]
f32, 2^20 bags of 8 distinct ids): every build's C entry, the wrapper
(``ek.pool``: its CUDA events over back-to-back calls are the host's time
a call where the kernel is launch-bound) and ``embedding_bag``, in turns,
each output equal to the plain version (the library's within 1e-5 of it).

B9, at ``chip_smoke.INT8_TIMED`` (NCF's four int8 tables at 256 ids and at
one, 2^20 distinct ids of a 1 GiB table): every build's C entry, the
wrapper (``ek.gather_int8``) and ``index_select`` + ``* scale``, in turns,
each output equal to the plain version.

Each line printed is one JSON object with the bounds ``chip_smoke``
computes; the last names the card and its power limit. Needs one NVIDIA
card and ``nvcc``.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops import embedding_kernels as ek  # noqa: E402
from analytics_zoo_tpu_torch.ops import kernel_build  # noqa: E402

OUT = os.path.join(REPO, "build", "embedding_kernel_timing")
GATHER, SCATTER = "gather_rows.cu", "scatter_rows.cu"
POOL, INT8 = "gather_pool.cu", "gather_int8.cu"
SOURCES = (GATHER, SCATTER, POOL, INT8)
#: name -> [(source, old, new)]: each old text must occur in the source
#: the committed B3's fill loop, which ``b3_static_fill`` replaces
DYNAMIC_FILL = """\
  // each block's first chunk is its own; the counter hands out the rest,
  // if any (a block of at most gridDim.x chunks never touches it)
  const bool draws = chunks > gridDim.x;
  if (threadIdx.x == 0) ticket[0] = blockIdx.x;
  __syncthreads();
  for (int it = 0;; it ^= 1) {
    const unsigned long long c = ticket[it];
    if (c >= chunks) break;
    if (threadIdx.x == 0)
      ticket[it ^ 1] = draws ? gridDim.x + atomicAdd(counter, 1ull) : chunks;
    const long long base = (long long)c * kChunk + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kFillUnroll; ++k) {
      const long long w = base + k * kThreads;
      if (w < n4) __stcs(v + w, z);
    }
    __syncthreads();
  }"""
EDITS = {
    # B1 with 8 rows (or units) a thread in flight, not 4
    "b1_unroll8": [(GATHER, "constexpr int kUnroll = 4;",
                    "constexpr int kUnroll = 8;")],
    # B1 in 4-warp blocks, 16 an SM
    "b1_threads128": [(GATHER, "constexpr int kThreads = 64;",
                       "constexpr int kThreads = 128;"),
                      (GATHER, "constexpr int kBlocksPerSm = 32;",
                       "constexpr int kBlocksPerSm = 16;")],
    # B3's fill as a fixed grid-stride split, no counter
    "b3_static_fill": [(SCATTER, DYNAMIC_FILL, """\
  const bool draws = false;  // no counter
  {
    const long long threads = (long long)gridDim.x * kThreads;
#pragma unroll 1
    for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
         u < n4; u += threads * kFillUnroll) {
#pragma unroll
      for (int k = 0; k < kFillUnroll; ++k) {
        const long long w = u + k * threads;
        if (w < n4) __stcs(v + w, z);
      }
    }
  }""")],
    # B3's fill with plain stores, not streaming ones
    "b3_plain_stores": [(SCATTER, "if (w < n4) __stcs(v + w, z);",
                         "if (w < n4) v[w] = z;")],
    # B3 without the prefetch of each thread's first target line
    "b3_no_prefetch": [(SCATTER, """\
  if (first)  // its target line into L2 while the other blocks finish
    asm volatile("prefetch.global.L2 [%0];" ::"l"(out + r0 * dim + v0 * W));
""", "")],
    # B3's grid sized as a warp a grad row (the grid before it packed the
    # adds' lanes): up to kBlocksPerSm an SM at the 8192-row embed shards
    "b3_warp_a_row_grid": [(SCATTER, """\
  const long long vecs = dim / W;
  const long long rows_a_block =
      (kThreads / 32) * (vecs < 32 ? 32 / vecs : 1);
  const long long add_blocks = (n + rows_a_block - 1) / rows_a_block;
""", """\
  const long long add_blocks = (n * 32 + kThreads - 1) / kThreads;
""")],
    # B3 drawing from the counter (and resetting it) at every block, even
    # one of no more chunks than the grid has blocks
    "b3_always_draw": [
        (SCATTER, "ticket[it ^ 1] = draws ? gridDim.x + atomicAdd(counter, "
                  "1ull) : chunks;",
         "ticket[it ^ 1] = gridDim.x + atomicAdd(counter, 1ull);"),
        (SCATTER, "if (draws && threadIdx.x == 0) {",
         "if (threadIdx.x == 0) {")],
    # B3 at 1 block of 512 an SM: half the blocks to draw and to meet at
    # the barrier
    "b3_blocks1": [(SCATTER, "constexpr int kBlocksPerSm = 2;",
                    "constexpr int kBlocksPerSm = 1;")],
    # B3 at 4 blocks of 512 an SM (2048 threads)
    "b3_blocks4": [(SCATTER, "constexpr int kBlocksPerSm = 2;",
                    "constexpr int kBlocksPerSm = 4;")],
    # B3 in 1024-thread blocks, 2 an SM (64 KB chunks)
    "b3_threads1024": [(SCATTER, "constexpr int kThreads = 512;",
                        "constexpr int kThreads = 1024;")],
    # B2 walking its bag one id at a time (the parent's dependent trips,
    # on the new grid and units), or 8 ids in flight, not 4
    "b2_chunk1": [(POOL, "constexpr int kChunk = 4;",
                   "constexpr int kChunk = 1;")],
    "b2_chunk8": [(POOL, "constexpr int kChunk = 4;",
                   "constexpr int kChunk = 8;")],
    # B2 with units of at most 4 or 8 bytes, not 16
    "b2_unit4": [(POOL, "constexpr int kMaxUnit = 16;",
                  "constexpr int kMaxUnit = 4;")],
    "b2_unit8": [(POOL, "constexpr int kMaxUnit = 16;",
                  "constexpr int kMaxUnit = 8;")],
    # B2 in 8-warp blocks, 8 an SM
    "b2_threads256": [(POOL, "constexpr int kThreads = 64;",
                       "constexpr int kThreads = 256;"),
                      (POOL, "constexpr int kBlocksPerSm = 32;",
                       "constexpr int kBlocksPerSm = 8;")],
    # B9 with 2 or 8 rows (or units) a thread in flight once the grid is
    # capped, not 4
    "b9_rows2": [(INT8, "constexpr int kUnroll = 4;",
                  "constexpr int kUnroll = 2;")],
    "b9_rows8": [(INT8, "constexpr int kUnroll = 4;",
                  "constexpr int kUnroll = 8;")],
    # B9 in 4- or 8-warp blocks, 16 or 8 an SM
    "b9_threads128": [(INT8, "constexpr int kThreads = 64;",
                       "constexpr int kThreads = 128;"),
                      (INT8, "constexpr int kBlocksPerSm = 32;",
                       "constexpr int kBlocksPerSm = 16;")],
    "b9_threads256": [(INT8, "constexpr int kThreads = 64;",
                       "constexpr int kThreads = 256;"),
                      (INT8, "constexpr int kBlocksPerSm = 32;",
                       "constexpr int kBlocksPerSm = 8;")],
    # B9 writing with streaming stores (evict first)
    "b9_stcs": [(INT8, "*reinterpret_cast<float4*>(out) =",
                 "__stcs(reinterpret_cast<float4*>(out),"),
                (INT8, ": make_float4(0.f, 0.f, 0.f, 0.f);",
                 ": make_float4(0.f, 0.f, 0.f, 0.f));"),
                (INT8, "*out = ok ? (float)v * s : 0.f;",
                 "__stcs(out, ok ? (float)v * s : 0.f);")],
}
def variant_sources(name: str) -> list:
    """The sources that ``EDITS[name]`` edits, with its edits, written
    under ``OUT/name``; returns their paths."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    paths = []
    for src in sorted({file for file, _, _ in EDITS[name]}):
        with open(os.path.join(kernel_build.CSRC_DIR, src)) as f:
            text = f.read()
        for file, old, new in EDITS[name]:
            if file == src:
                if old not in text:
                    raise ValueError(f"variant {name}: {old!r} not in {src}")
                text = text.replace(old, new)
        paths.append(os.path.join(d, src))
        with open(paths[-1], "w") as f:
            f.write(text)
    return paths


def build(extra: dict) -> dict:
    """``{name: [source, ...]}`` built into ``OUT/<name>.so``, one ``nvcc``
    each, all started together; returns ``{name: ctypes library}``."""
    os.makedirs(OUT, exist_ok=True)
    cmds = {name: [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS,
                   "-shared", "-I", kernel_build.CSRC_DIR, "-o",
                   os.path.join(OUT, f"{name}.so"), *srcs]
            for name, srcs in extra.items()}
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if hasattr(lib, "azt_gather_rows"):
            lib.azt_gather_rows.argtypes = [p, p, p, ll, ll, ll, i, i, p]
            lib.azt_gather_rows.restype = i
        if hasattr(lib, "azt_scatter_rows"):
            # the earlier B3 (``was``) takes no fill counter
            lib.azt_scatter_rows.argtypes = [p, p, p, ll, ll, ll] + (
                [p] if name == "was" else [p, p])
            lib.azt_scatter_rows.restype = i
        if hasattr(lib, "azt_gather_pool"):
            lib.azt_gather_pool.argtypes = [p, p, p, ll, i, ll, ll, i, i, i,
                                            p]
            lib.azt_gather_pool.restype = i
        if hasattr(lib, "azt_gather_int8"):
            lib.azt_gather_int8.argtypes = [p, p, p, p, ll, ll, ll, p]
            lib.azt_gather_int8.restype = i
        libs[name] = lib
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def scatter_fn(lib, g, rows, num_rows: int, was: bool):
    dim = g.shape[1]
    counter = () if was else (ek.fill_counter(g.device).data_ptr(),)

    def call():
        out = torch.empty(num_rows, dim, device=g.device)
        rc = lib.azt_scatter_rows(g.data_ptr(), rows.data_ptr(),
                                  out.data_ptr(), g.shape[0], num_rows, dim,
                                  *counter, stream())
        chip_smoke.check(rc == 0, f"scatter launch failed: {rc}")
        return out
    return call


def gather_fn(lib, table, ids, clip: bool):
    def call():
        out = torch.empty(ids.shape[0], table.shape[1], dtype=table.dtype,
                          device=table.device)
        rc = lib.azt_gather_rows(table.data_ptr(), ids.data_ptr(),
                                 out.data_ptr(), ids.shape[0],
                                 table.shape[0], table.shape[1],
                                 table.element_size(), int(clip), stream())
        chip_smoke.check(rc == 0, f"gather launch failed: {rc}")
        return out
    return call


def pool_fn(lib, table, ids, combiner: int, clip: bool):
    def call():
        out = torch.empty(ids.shape[0], table.shape[1], dtype=table.dtype,
                          device=table.device)
        rc = lib.azt_gather_pool(table.data_ptr(), ids.data_ptr(),
                                 out.data_ptr(), ids.shape[0], ids.shape[1],
                                 table.shape[0], table.shape[1],
                                 ek._DTYPE_CODES[table.dtype], combiner,
                                 int(clip), stream())
        chip_smoke.check(rc == 0, f"pool launch failed: {rc}")
        return out
    return call


def int8_fn(lib, q, scale, ids):
    def call():
        out = torch.empty(ids.shape[0], q.shape[1], device=q.device)
        rc = lib.azt_gather_int8(q.data_ptr(), scale.data_ptr(),
                                 ids.data_ptr(), out.data_ptr(),
                                 ids.shape[0], q.shape[0], q.shape[1],
                                 stream())
        chip_smoke.check(rc == 0, f"int8 gather launch failed: {rc}")
        return out
    return call


def summary(turns: dict) -> dict:
    """Each name's range over the turns, events and device time."""
    out = {}
    for name, t in turns.items():
        dev = [x for x in t["device_ms"] if x is not None]
        out[name] = {"ms": [min(t["ms"]), max(t["ms"])] if "ms" in t
                     else None,
                     "device_ms": [min(dev), max(dev)] if dev else None}
    return out


def cold_turns(fns: dict, rounds: int) -> dict:
    """``fns`` in turns as ``chip_smoke.turns_ms`` takes them, each turn
    ``chip_smoke.cold_device_ms`` (L2 evicted before each call)."""
    names = list(fns)
    out = {n: {"device_ms": []} for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            out[n]["device_ms"].append(chip_smoke.cold_device_ms(fns[n]))
    return out


def time_scatter(libs: dict, dev, seed: int, rounds: int) -> None:
    for label, num_rows, dim, rows, _ in chip_smoke.scatter_timed_cases(
            dev, seed):
        n = rows.shape[0]
        g = torch.randn(n, dim, device=dev)
        want = ek.scatter_rows_plain(g, rows, num_rows)
        kept = rows[(rows >= 0) & (rows < num_rows)]
        repeats = torch.unique(kept).numel() < kept.numel()
        scale = max(1.0, float(want.abs().max()))
        fns = {name: scatter_fn(lib, g, rows, num_rows, name == "was")
               for name, lib in libs.items()
               if hasattr(lib, "azt_scatter_rows")}
        errs = {}
        for name, fn in fns.items():
            err = float((fn() - want).abs().max())
            chip_smoke.check(err <= 2e-5 * scale if repeats else err == 0,
                             f"{name} B3 off plain by {err} at {label}")
            errs[name] = err
        del want
        # the fill and the barrier without the adds: every row dropped
        dropped = torch.full_like(rows, -1)
        fns["kernel_no_adds"] = scatter_fn(libs["kernel"], g, dropped,
                                           num_rows, False)
        chip_smoke.check(int(torch.count_nonzero(fns["kernel_no_adds"]()))
                         == 0, f"B3 with no adds left nonzeros at {label}")
        ok = (rows >= 0) & (rows < num_rows)
        rows_m, g_m = rows[ok].long(), g[ok]
        fns["library"] = lambda: torch.zeros(
            num_rows, dim, device=dev).index_add_(0, rows_m, g_m)
        # the fills alone in the same turns: the runtime's memset (the
        # earlier B3's fill) and PyTorch's fill kernel
        fns["zeros"] = lambda: torch.zeros(num_rows, dim, device=dev)
        block = torch.empty(num_rows, dim, device=dev)
        memset = chip_smoke.cuda_memset_fn(block)
        if memset is not None:
            fns["memset"] = memset
        turns = chip_smoke.turns_ms(fns, rounds, 10)
        print(json.dumps({
            "kernel": "B3", "shape": label, "rows": num_rows, "dim": dim,
            "n": n, "in_range": int(ok.sum()),
            "bound_ms": chip_smoke.scatter_bound_ms(num_rows, dim, n),
            "fill_bound_ms": num_rows * dim * 4
            / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "max_abs_err": errs, "repeated_rows": repeats,
            "summary": summary(turns), "turns": turns}), flush=True)
        del fns, memset, block, rows, g, dropped, rows_m, g_m
        torch.cuda.empty_cache()


def time_gather(libs: dict, dev, seed: int, rounds: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for label, table, ids, clip, calls in chip_smoke.gather_timed_cases(
            dev, gen, seed):
        want = ek.gather_plain(table, ids, clip)
        fns = {name: gather_fn(lib, table, ids, clip)
               for name, lib in libs.items()
               if hasattr(lib, "azt_gather_rows")}
        for name, fn in fns.items():
            chip_smoke.check(torch.equal(fn(), want),
                             f"{name} B1 != plain at {label}")
        del want
        lib_ids = ids if clip else ids.clamp(0, table.shape[0] - 1)
        fns["library"] = lambda: torch.index_select(table, 0, lib_ids)
        turns = chip_smoke.turns_ms(fns, rounds, min(calls, 50))
        nbytes = chip_smoke.gather_bytes(table, ids, clip)
        line = {
            "kernel": "B1", "table": label, "rows": table.shape[0],
            "dim": table.shape[1],
            "dtype": str(table.dtype).replace("torch.", ""),
            "n": ids.shape[0], "clip": clip,
            "bound_ms": chip_smoke.gather_bound_ms(table, ids, clip),
            "l2_resident": nbytes <= l2,
            "summary": summary(turns), "turns": turns}
        if nbytes <= l2:  # the time the device-memory bound holds for
            cold = cold_turns(fns, rounds)
            line["cold_summary"] = summary(cold)
            line["cold_turns"] = cold
        print(json.dumps(line), flush=True)
        del fns, table, ids, lib_ids
        torch.cuda.empty_cache()


def pool_timed_cases(dev, seed: int):
    """B2's timed shapes, made one at a time: (label, table, ids, calls).
    The W&D forward's wide-table call (offset bucket ids as ``bench.py``
    makes them, all in range) and 2^20 bags of 8 distinct ids of a 2 GiB
    table."""
    gen = torch.Generator().manual_seed(seed)
    yield ("wide_table",
           torch.randn(chip_smoke.WND_WIDE_ROWS, 2, generator=gen).to(dev),
           torch.from_numpy(chip_smoke.wide_ids(
               np.random.RandomState(seed), 8192)).to(dev), 200)
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    rows = chip_smoke.POOL_LARGE_ROWS
    yield ("hbm_table",
           torch.randn(rows, 64, generator=dev_gen, device=dev),
           torch.randperm(rows, generator=dev_gen, device=dev).to(
               torch.int32).reshape(chip_smoke.POOL_LARGE_N,
                                    chip_smoke.POOL_LARGE_BAG), 10)


def time_pool(libs: dict, dev, seed: int, rounds: int) -> None:
    for label, table, ids, calls in pool_timed_cases(dev, seed):
        want = ek.gather_pool_plain(table, ids, "sum", True)
        fns = {name: pool_fn(lib, table, ids, 0, True)
               for name, lib in libs.items()
               if hasattr(lib, "azt_gather_pool")}
        fns["wrapper"] = lambda: ek.pool(table, ids, "sum", True)
        for name, fn in fns.items():
            chip_smoke.check(torch.equal(fn(), want),
                             f"{name} B2 != plain at {label}")
        ids64 = ids.long()  # embedding_bag takes int64 ids
        fns["library"] = lambda: torch.nn.functional.embedding_bag(
            ids64, table, mode="sum")
        lib_err = float((fns["library"]() - want).abs().max())
        chip_smoke.check(lib_err <= 1e-5 * max(1.0, float(
            want.abs().max())), f"embedding_bag off plain by {lib_err}")
        del want
        turns = chip_smoke.turns_ms(fns, rounds, calls)
        print(json.dumps({
            "kernel": "B2", "table": label, "rows": table.shape[0],
            "dim": table.shape[1], "n": ids.shape[0], "bag": ids.shape[1],
            "combiner": "sum", "clip": True,
            "bound_ms": chip_smoke.pool_bound_ms(table, ids, clip=True),
            "library": "embedding_bag(mode='sum')",
            "library_max_abs_diff": lib_err,
            "summary": summary(turns), "turns": turns}), flush=True)
        del fns, table, ids, ids64
        torch.cuda.empty_cache()


def time_int8(libs: dict, dev, seed: int, rounds: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    for label, rows, dim, n, calls in chip_smoke.INT8_TIMED:
        if rows == chip_smoke.INT8_HBM_ROWS:
            # every id distinct, so every row comes from device memory
            q = torch.randint(-127, 128, (rows, dim), generator=dev_gen,
                              device=dev, dtype=torch.int8)
            ids = torch.randperm(rows, generator=dev_gen, device=dev)[
                :n].to(torch.int32)
            scale = torch.tensor(0.0123, device=dev)
        else:
            q, scale, _ = ek.quantize_table(
                torch.randn(rows, dim, generator=gen).to(dev) * 0.05)
            ids = torch.randint(0, rows, (n,), generator=gen,
                                dtype=torch.int32).to(dev)
        want = ek.gather_int8_plain(q, scale, ids)
        fns = {name: int8_fn(lib, q, scale, ids)
               for name, lib in libs.items()
               if hasattr(lib, "azt_gather_int8")}
        fns["wrapper"] = lambda: ek.gather_int8(q, scale, ids)
        for name, fn in fns.items():
            chip_smoke.check(torch.equal(fn(), want),
                             f"{name} B9 != plain at {label} n={n}")
        del want
        fns["library"] = lambda: torch.index_select(q, 0, ids) * scale
        turns = chip_smoke.turns_ms(fns, rounds, min(calls, 50))
        print(json.dumps({
            "kernel": "B9", "table": label, "rows": rows, "dim": dim,
            "n": n, "bound_ms": chip_smoke.int8_bound_ms(q, ids),
            "library": "index_select, then * scale",
            "summary": summary(turns), "turns": turns}), flush=True)
        del fns, q, ids
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--was", help="directory of earlier sources "
                        f"(any of {', '.join(SOURCES)})")
    parser.add_argument("--variants", nargs="*", choices=sorted(EDITS),
                        help="text edits of the committed sources")
    parser.add_argument("--rounds", type=int, default=3,
                        help="rounds of turns (each name twice a round)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", nargs="+",
                        choices=("b1", "b2", "b3", "b9"),
                        help="the kernels to time (all when not given)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    shutil.rmtree(OUT, ignore_errors=True)
    extra = {}
    if args.was:
        extra["was"] = [os.path.join(args.was, f) for f in SOURCES
                        if os.path.exists(os.path.join(args.was, f))]
        if not extra["was"]:
            parser.error(f"--was {args.was}: none of {SOURCES} there")
    if args.variants is not None:
        for name in args.variants or sorted(EDITS):
            extra[name] = variant_sources(name)
    libs = {"kernel": kernel_build.load_library(), **build(extra)}
    torch.manual_seed(args.seed)
    only = set(args.only or ("b1", "b2", "b3", "b9"))
    for kernel, time_it in (("b9", time_int8), ("b2", time_pool),
                            ("b3", time_scatter), ("b1", time_gather)):
        if kernel in only:
            time_it(libs, dev, args.seed, args.rounds)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
