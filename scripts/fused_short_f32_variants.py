#!/usr/bin/env python3
"""Time variants of B7/B8's f32 route (3xTF32) beside the committed one.

    python3 scripts/fused_short_f32_variants.py [variant ...]

A variant is ``analytics_zoo_tpu_torch/csrc/fused_short_attn.cu`` and
``csrc/mma_tf32.cuh`` with the named text edits of ``EDITS`` applied.
Each variant is built by its own ``nvcc -Xptxas -v`` (all started
together) into ``build/fused_short_f32_variants/``, loaded with
``ctypes``, and B7 and B8 are timed by CUDA events at
``chip_smoke.ATTN_F32_TIMED``'s shapes, the variants in turns over two
rounds. Each variant's outputs are held to the plain versions (2e-5 of the
scale); variants named ``no_*`` or ``one_*`` drop work to attribute time,
so their outputs are wrong: their errors are printed, not checked. Each
line printed is one JSON object: first each variant's registers and
spills from ``ptxas -v``, then the times; the last names the card and its
power limit. Needs one NVIDIA card and ``nvcc``.
"""
import ctypes
import json
import math
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

OUT = os.path.join(REPO, "build", "fused_short_f32_variants")
FILES = (("cu", "fused_short_attn.cu"), ("cuh", "mma_tf32.cuh"))
TOL = 2e-5

#: name -> [(file, old, new)]: each old text must occur in the file
EDITS = {
    "committed": [],
    # the rounding by cvt.rna.tf32.f32
    "cvt_rna": [("cuh", "  return (__float_as_uint(x) + 0x1000u) & "
                 "0xffffe000u;", "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 "
                 "%0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n  return r;")],
    # the small part's 13 low bits left to the tensor cores, which read a
    # TF32 operand's top 19 bits
    "small_unmasked": [("cuh", "tf32_rna(__fsub_rn(x, __uint_as_float("
                        "big[i])));", "__float_as_uint(__fsub_rn(x, "
                        "__uint_as_float(big[i]))) + 0x1000u;")],
    # attribution only: no split (big = x, small = 0), the three products
    # kept
    "no_split": [("cuh", """    big[i] = tf32_rna(x);
    small[i] = tf32_rna(__fsub_rn(x, __uint_as_float(big[i])));""",
                  """    big[i] = __float_as_uint(x);
    small[i] = 0u;""")],
    # four-warp blocks, each warp walking whole 32-row tiles, at every grid
    "split1": [("cu", "  if (most >= 4 && blocks < 2LL * sms) return 4;\n"
                "  return blocks < 8LL * sms ? 2 : 1;", "  return 1;")],
    # eight-warp blocks, two warps a row group, at every grid
    "split2": [("cu", "  if (most >= 4 && blocks < 2LL * sms) return 4;\n"
                "  return blocks < 8LL * sms ? 2 : 1;", "  return 2;")],
    # B7 never takes four warps a row group
    "fwd_no4": [("cu", "  if (most >= 4 && blocks < 2LL * sms) return 4;\n",
                 "")],
    # attribution only: big.big alone (1xTF32)
    "one_mma": [("cuh", "  mma_tf32(c, a.small, b.big);\n"
                 "  mma_tf32(c, a.big, b.small);\n", "")],
    # attribution only: no products (and so no fragment loads or splits)
    "no_mma": [("cuh", "  mma_tf32(c, a.small, b.big);\n"
                "  mma_tf32(c, a.big, b.small);\n"
                "  mma_tf32(c, a.big, b.big);\n", "")],
}


def build(names):
    """Build each variant's library; returns {name: ctypes.CDLL}."""
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name in names:
        texts = {}
        for kind, fname in FILES:
            with open(os.path.join(kernel_build.CSRC_DIR, fname)) as f:
                texts[kind] = f.read()
        for kind, old, new in EDITS[name]:
            if old not in texts[kind]:
                raise SystemExit(f"variant {name}: edit not found: {old!r}")
            texts[kind] = texts[kind].replace(old, new)
        d = os.path.join(OUT, name)
        os.makedirs(d)
        for kind, fname in FILES:
            with open(os.path.join(d, fname), "w") as f:
                f.write(texts[kind])
        # mma_tf32.cuh includes the committed dropout_hash.cuh, mma_bf16.cuh
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-Xptxas",
               "-v", "-shared", "-I", d, "-I", kernel_build.CSRC_DIR, "-o",
               os.path.join(d, "lib.so"), os.path.join(d, FILES[0][1])]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, ll, i, f, u = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float, ctypes.c_uint32)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        print(json.dumps({"variant": name,
                          "ptxas": chip_smoke.ptxas_usage(log)}), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        lib.azt_fused_short_fwd_f32.argtypes = [p] * 7 + [ll, i, i, i, f, u,
                                                          f, i, p]
        lib.azt_fused_short_bwd_f32.argtypes = [p] * 12 + [ll, i, i, i, f, f,
                                                           u, f, i, p]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(EDITS)
    libs = build(names)
    dev = torch.device("cuda", 0)
    failed = []
    for label, (b, h, s, d), bias, rate, causal in chip_smoke.ATTN_F32_TIMED:
        gen = torch.Generator().manual_seed(s + d)
        q, k, v, do, mask = chip_smoke._attn_case(dev, b, h, s, d,
                                                  torch.float32, gen)
        kb = ((1.0 - mask) * -1e9).to(dev) if bias else None
        seed = torch.tensor([17], dtype=torch.int32, device=dev)
        scale = 1.0 / math.sqrt(d)
        want_o = at.fused_short_attention_plain(q, k, v, kb, scale, rate,
                                                seed, causal)
        want = at.fused_short_bwd_plain(q, k, v, do, kb, scale, rate, seed,
                                        causal)
        o = torch.empty_like(q)
        stats = torch.empty((2, b, h, s), device=dev)
        delta = torch.empty((b * h, s), device=dev)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        a = at._launch_args(q, kb, seed if rate else None, scale, rate)
        stream = torch.cuda.current_stream().cuda_stream
        for rnd in range(2):
            for name, lib in libs.items():
                def fwd(lib=lib):
                    rc = lib.azt_fused_short_fwd_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), a["bias"],
                        a["seed"], o.data_ptr(), stats.data_ptr(),
                        *a["dims"], a["scale_log2e"], a["thresh"], a["inv"],
                        int(causal), stream)
                    assert rc == 0, rc

                def bwd(lib=lib):
                    rc = lib.azt_fused_short_bwd_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), do.data_ptr(), a["bias"], a["seed"],
                        stats.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), *a["dims"],
                        a["scale_log2e"], scale, a["thresh"], a["inv"],
                        int(causal), stream)
                    assert rc == 0, rc

                fwd()
                bwd()
                torch.cuda.synchronize()
                errs = {key: chip_smoke._rel_err(got, ref)
                        for key, got, ref in (
                            ("o", o, want_o), ("dq", dq, want[0]),
                            ("dk", dk, want[1]), ("dv", dv, want[2]))}
                if (not name.startswith(("no_", "one_"))
                        and max(errs.values()) > TOL):
                    failed.append((name, label, errs))
                print(json.dumps({
                    "shape": label, "round": rnd, "variant": name,
                    "b7_ms": chip_smoke.cuda_ms(fwd, 20),
                    "b8_ms": chip_smoke.cuda_ms(bwd, 20), "errors": errs}),
                    flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
