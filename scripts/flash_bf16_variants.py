#!/usr/bin/env python3
"""Time variants of the bf16 flash kernels (B4, B5a, B5b, B6) beside the
committed ones.

    python3 scripts/flash_bf16_variants.py [variant ...]

A variant is ``analytics_zoo_tpu_torch/csrc/flash_attn_bf16.cu`` and
``csrc/mma_bf16.cuh`` with the named text edits of ``EDITS`` applied.
Each variant is built by its own ``nvcc -Xptxas -v`` (all started
together) into ``build/flash_bf16_variants/``, loaded with ``ctypes``, and
B4, B6, B5a and B5b are timed by CUDA events at ``bench_longseq``'s shapes
([4, 8, 4096, 128], [8, 8, 4096, 64] and [4, 8, 8192, 128], bf16,
causal), the variants in turns over two rounds; B6's time includes zeroing
the f32 dq buffer, as its wrapper does. Each variant's outputs are held to
the plain versions (2e-2 of the scale); variants named ``no_*`` drop work
to attribute time, so their outputs are wrong: their errors are printed,
not checked. Each line printed is one JSON object: first each variant's
registers and spills from ``ptxas -v``, then the times; the last names
the card and its power limit. Needs one NVIDIA card and ``nvcc``.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops import attention as at  # noqa: E402
from analytics_zoo_tpu_torch.ops import kernel_build  # noqa: E402

OUT = os.path.join(REPO, "build", "flash_bf16_variants")
SHAPES = ((4, 8, 4096, 128), (8, 8, 4096, 64), (4, 8, 8192, 128))
TOL = 2e-2

#: name -> [(file, old, new)]: each old text must occur in the file
EDITS = {
    "committed": [],
    # the accurate exp2f in place of ex2.approx
    "exp2f": [("cu", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "y = exp2f(x);")],
    # dq added one f32 at a time in place of float2 atomics
    "scalar_dq_atomics": [("cu", "const bool pairs = d % 2 == 0;",
                           "const bool pairs = false;")],
    # tiles staged with a division by d's 16-byte chunks in the loop
    "div_loads": [("cuh", """    const int c = (threadIdx.x % 16) * 8;
    if (c < d) {
      for (int r = threadIdx.x / 16; r < kRows; r += kThreads / 16) {
        const int g = row0 + r;""", """    const int chunks = d / 8;
    {
      for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
        const int r = i / chunks, c = (i - r * chunks) * 8;
        const int g = row0 + r;""")],
    # B6 blocks of 128 keys (16 warps, one block an SM)
    "keys128": [("cu", "constexpr int kBwdKeys = 64;",
                 "constexpr int kBwdKeys = 128;")],
    # B4 blocks of 256 query rows (16 warps, one block an SM)
    "rows256": [("cu", "constexpr int kFwdRows = 128;  // B4's query rows a "
                 "block\nconstexpr int kFwdThreads = 256;",
                 "constexpr int kFwdRows = 256;  // B4's query rows a "
                 "block\nconstexpr int kFwdThreads = 512;"),
                ("cu", "__launch_bounds__(kFwdThreads, 2)",
                 "__launch_bounds__(kFwdThreads, 1)")],
    # B5a walks 64-key tiles at d > 64 too (one block an SM at d 128) in
    # one pass of 64 keys (32 floats each of S and dP a thread) ...
    "dq_keys64": [("cu", "constexpr int kDqKeysWide = 32;",
                   "constexpr int kDqKeysWide = 64;")],
    # ... or in two 32-key halves
    "dq_keys64_halves": [("cu", "constexpr int kDqKeysWide = 32;",
                          "constexpr int kDqKeysWide = 64;"),
                         ("cu", "constexpr int kDqPass = 64;",
                          "constexpr int kDqPass = 32;")],
    # B5a walks 32-key tiles at d <= 64 too
    "dq_keys32": [("cu", "constexpr int kDqKeysNarrow = 64;",
                   "constexpr int kDqKeysNarrow = 32;")],
    # B5b with one buffer of Q and dO, refilled after step (2)
    "dkv_single": [("cu", "constexpr int kDkvStages = 2;",
                    "constexpr int kDkvStages = 1;")],
    # B5b blocks of 64 keys at d > 64 too (eight warps, two blocks an SM)
    "dkv_keys64": [("cu", "constexpr int kDkvKeysWide = 128;",
                    "constexpr int kDkvKeysWide = 64;")],
    # B5b blocks of 128 keys at d <= 64 too (sixteen warps, one block an SM)
    "dkv_keys128": [("cu", "constexpr int kDkvKeysNarrow = 64;",
                     "constexpr int kDkvKeysNarrow = 128;")],
    # attribution only: B6 adds nothing to dq
    "no_dq_atomics": [("cu", "      add_dq<2 * kDg>(dq_acc",
                       "      if (sq < 0) add_dq<2 * kDg>(dq_acc")],
    # attribution only: B4 without its two products
    "no_mma": [("cu", "      mma_abt<8, kD>(sc, qs + warp * 16 * ld, kst, "
                "ld, kd);", "      if (sq < 0) mma_abt<8, kD>(sc, qs + "
                "warp * 16 * ld, kst, ld, kd);"),
               ("cu", "          mma_ax<kD>(acc, af, vst + j * 16 * ld, ld, "
                "kd);", "          if (sq < 0) mma_ax<kD>(acc, af, vst + "
                "j * 16 * ld, ld, kd);")],
}


def build(names):
    """Build each variant's library; returns {name: ctypes.CDLL}."""
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name in names:
        texts = {}
        for kind, fname in (("cu", "flash_attn_bf16.cu"),
                            ("cuh", "mma_bf16.cuh")):
            with open(os.path.join(kernel_build.CSRC_DIR, fname)) as f:
                texts[kind] = f.read()
        for kind, old, new in EDITS[name]:
            if old not in texts[kind]:
                raise SystemExit(f"variant {name}: edit not found: {old!r}")
            texts[kind] = texts[kind].replace(old, new)
        d = os.path.join(OUT, name)
        os.makedirs(d)
        for kind, fname in (("cu", "flash_attn_bf16.cu"),
                            ("cuh", "mma_bf16.cuh")):
            with open(os.path.join(d, fname), "w") as f:
                f.write(texts[kind])
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-Xptxas",
               "-v", "-shared", "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "flash_attn_bf16.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        print(json.dumps({"variant": name,
                          "ptxas": chip_smoke.ptxas_usage(log)}), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        lib.azt_flash_fwd_bf16.argtypes = [p] * 6 + [ll, i, i, i, i, f, i, p]
        lib.azt_flash_bwd_fused_bf16.argtypes = [p] * 10 + [ll, i, i, i, f,
                                                            f, i, p]
        lib.azt_flash_bwd_dq_bf16.argtypes = [p] * 8 + [ll, i, i, i, f, f, i,
                                                        p]
        lib.azt_flash_bwd_dkv_bf16.argtypes = [p] * 9 + [ll, i, i, i, f, f,
                                                         i, p]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(EDITS)
    libs = build(names)
    dev = torch.device("cuda", 0)
    failed = []
    for b, h, s, d in SHAPES:
        gen = torch.Generator().manual_seed(s + d)
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(
            dev, torch.bfloat16) for _ in range(4))
        scale = d ** -0.5
        want_o, lse = at.flash_fwd_plain(q, k, v, None, scale, True)
        delta = (do.float() * want_o.float()).sum(-1)
        want = at.flash_bwd_fused_plain(q, k, v, do, lse, delta, None, scale,
                                        True)
        o, lse_k = torch.empty_like(q), torch.empty_like(lse)
        dq = torch.zeros(q.shape, device=dev)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        dq2 = torch.empty_like(q)
        dk2, dv2 = torch.empty_like(k), torch.empty_like(v)
        rows = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), None)
        dims = (b * h, s, s, d, scale * 1.4426950408889634, scale, 1)
        stream = torch.cuda.current_stream().cuda_stream
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_ms = chip_smoke.cuda_ms(lambda: sdpa(q, k, v, is_causal=True),
                                     10)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa_fwd_bwd_ms = chip_smoke.cuda_ms(
            lambda: sdpa(*leaves, is_causal=True).backward(do), 10)
        for rnd in range(2):
            for name, lib in libs.items():
                def fwd(lib=lib):
                    rc = lib.azt_flash_fwd_bf16(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                        o.data_ptr(), lse_k.data_ptr(), b * h, s, s, d, h,
                        scale * 1.4426950408889634, 1, stream)
                    assert rc == 0, rc

                def bwd(lib=lib):
                    dq.zero_()
                    rc = lib.azt_flash_bwd_fused_bf16(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        None, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        b * h, s, s, d, scale * 1.4426950408889634, scale,
                        1, stream)
                    assert rc == 0, rc

                def bwd_dq(lib=lib):
                    rc = lib.azt_flash_bwd_dq_bf16(*rows, dq2.data_ptr(),
                                                   *dims, stream)
                    assert rc == 0, rc

                def bwd_dkv(lib=lib):
                    rc = lib.azt_flash_bwd_dkv_bf16(
                        *rows, dk2.data_ptr(), dv2.data_ptr(), *dims, stream)
                    assert rc == 0, rc

                fwd()
                bwd()
                bwd_dq()
                bwd_dkv()
                torch.cuda.synchronize()
                errs = {key: chip_smoke._rel_err(got, ref)
                        for key, got, ref in (
                            ("o", o, want_o), ("dq", dq, want[0]),
                            ("dk", dk, want[1]), ("dv", dv, want[2]),
                            ("b5a_dq", dq2, want[0]),
                            ("b5b_dk", dk2, want[1]),
                            ("b5b_dv", dv2, want[2]))}
                if not name.startswith("no_") and max(errs.values()) > TOL:
                    failed.append((name, (b, h, s, d), errs))
                print(json.dumps({
                    "shape": [b, h, s, d], "round": rnd, "variant": name,
                    "b4_ms": chip_smoke.cuda_ms(fwd, 10),
                    "b6_ms": chip_smoke.cuda_ms(bwd, 10),
                    "b5a_ms": chip_smoke.cuda_ms(bwd_dq, 10),
                    "b5b_ms": chip_smoke.cuda_ms(bwd_dkv, 10),
                    "sdpa_fwd_ms": sdpa_ms,
                    "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms, "errors": errs}),
                    flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
