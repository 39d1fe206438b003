#!/usr/bin/env python3
"""Time the flash attention kernels' f32 route on one card.

    python3 scripts/flash_f32_timing.py
    python3 scripts/flash_f32_timing.py --variants [variant ...]

Without ``--variants``: builds the kernel library (``ops/kernel_build``),
prints the registers and spills ``nvcc -Xptxas -v`` reports for
``csrc/flash_attn_tf32.cu``'s kernels (B4 and B5b on the tensor cores as
3xTF32), then times B4, B5a, B5b and B6 in f32 at the LM's two shapes
(``chip_smoke.FLASH_TIMED``'s ``lm``, [8, 16, 2048, 128], and ``lm_long``,
[2, 16, 4096, 128], causal) by CUDA events and the profiler, beside their
plain versions and ``scaled_dot_product_attention(is_causal=True)``
(forward, and forward + backward), each held to its plain version within
2e-5 of the scale and in relative L2, with every bound at both f32 rates,
as ``chip_smoke.py`` does.

With ``--variants``: each variant is ``csrc/flash_attn_tf32.cu`` and
``csrc/mma_tf32.cuh`` with the named text edits of ``EDITS`` applied (all
of them when none is named), built by its own ``nvcc -Xptxas -v`` (all
started together) into ``build/flash_f32_variants/`` and loaded with
``ctypes``; B4 and B5b are timed by CUDA events at both shapes, the
variants in turns over two rounds, and held to the plain versions (2e-5 of
the scale; ``UNCHECKED`` variants' errors are printed, not checked). This
is how the two-level sums were chosen.

Each line printed is one JSON object; the last names the card and its
power limit. Needs one NVIDIA card and ``nvcc``.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops import attention as at  # noqa: E402
from analytics_zoo_tpu_torch.ops import kernel_build  # noqa: E402

OUT = os.path.join(REPO, "build", "flash_f32_variants")
SOURCE = "flash_attn_tf32.cu"
FILES = (("cu", SOURCE), ("cuh", "mma_tf32.cuh"))
TOL = chip_smoke.ATTN_ATOL[torch.float32]
#: the LM's two f32 shapes of chip_smoke.FLASH_TIMED
TIMED = tuple(t for t in chip_smoke.FLASH_TIMED if t[2] == torch.float32)

#: name -> [(file, old, new)]: each old text must occur in the file
EDITS = {
    "committed": [],
    # p.V, p^T.dO, ds^T.Q and dP^T = V.dO^T summed straight into their
    # sums (one level), as B7/B8 do
    "one_level": [("cuh", """  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);""",
                   "  mma3(c, a, b);")],
    # the small part left unrounded: the tensor cores read its top 19 bits
    "small_trunc": [("cuh", "small[i] = tf32_rna(__fsub_rn(x, "
                     "__uint_as_float(big[i])));", "small[i] = "
                     "__float_as_uint(__fsub_rn(x, "
                     "__uint_as_float(big[i])));")],
    # B5b's dP^T = V.dO^T (which ds = p (dP - D + glse) cancels against D)
    # summed in one level
    "dpt_one_level": [("cu", "            mma3_add(dpT[n], av, b);",
                       "            mma3(dpT[n], av, b);")],
    # B5b's S^T = K.Q^T summed in two levels too
    "st_two_level": [("cu", "            mma3(sT[n], a, b);",
                      "            mma3_add(sT[n], a, b);")],
}
#: variants timed to attribute cost or error: their errors are printed,
#: not checked
UNCHECKED = ("one_level",)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def committed() -> int:
    """The committed route through the wrappers, at both shapes."""
    kernel_build.load_library()
    src = os.path.join(kernel_build.CSRC_DIR, SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        ptxas = subprocess.run(
            [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-Xptxas",
             "-v", "-I", kernel_build.CSRC_DIR, "-c", "-o",
             os.path.join(tmp, "tf32.o"), src],
            check=True, capture_output=True, text=True)
    print(json.dumps({"ptxas": chip_smoke.ptxas_usage(
        ptxas.stdout + ptxas.stderr)}), flush=True)
    dev = torch.device("cuda", 0)
    for label, t in chip_smoke.flash_timings(at, dev, TIMED).items():
        print(json.dumps({"label": label, **t}), flush=True)
    print(smi())
    return 0


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
        # mma_tf32.cuh includes the committed mma_bf16.cuh
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-Xptxas",
               "-v", "-shared", "-I", d, "-I", kernel_build.CSRC_DIR, "-o",
               os.path.join(d, "lib.so"), os.path.join(d, SOURCE)]
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
        lib.azt_flash_fwd.argtypes = [p] * 6 + [ll, i, i, i, i, i, f, i, p]
        lib.azt_flash_bwd_dkv.argtypes = [p] * 9 + [ll, i, i, i, i, f, f, i,
                                                    p]
        libs[name] = lib
    return libs


def variants(names) -> int:
    libs = build(names)
    dev = torch.device("cuda", 0)
    failed = []
    for label, (b, h, s, d), _ in TIMED:
        gen = torch.Generator().manual_seed(s + d)
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(dev)
                       for _ in range(4))
        scale = d ** -0.5
        want_o, lse = at.flash_fwd_plain(q, k, v, None, scale, True)
        delta = (do * want_o).sum(-1)
        want = (want_o, lse) + at.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, None, scale, True)
        o, got_lse = torch.empty_like(q), torch.empty_like(lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        dims = (b * h, s, s, d, 0)
        for rnd in range(2):
            for name, lib in libs.items():
                def fwd(lib=lib):
                    rc = lib.azt_flash_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                        o.data_ptr(), got_lse.data_ptr(), *dims, h,
                        scale * at._LOG2E, 1, stream)
                    assert rc == 0, rc

                def dkv(lib=lib):
                    rc = lib.azt_flash_bwd_dkv(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        None, dk.data_ptr(), dv.data_ptr(), *dims,
                        scale * at._LOG2E, scale, 1, stream)
                    assert rc == 0, rc

                fwd()
                dkv()
                torch.cuda.synchronize()
                errs = {key: max(chip_smoke._rel_err(got, ref),
                                 chip_smoke._rel_l2(got, ref))
                        for key, got, ref in zip(
                            ("o", "lse", "dk", "dv"), (o, got_lse, dk, dv),
                            want)}
                if max(errs.values()) > TOL and name not in UNCHECKED:
                    failed.append((name, label, errs))
                print(json.dumps({
                    "shape": label, "round": rnd, "variant": name,
                    "b4_ms": chip_smoke.cuda_ms(fwd, 10, warmup=2),
                    "b5b_ms": chip_smoke.cuda_ms(dkv, 10, warmup=2),
                    "errors": errs}), flush=True)
        del q, k, v, do, o, dk, dv, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi(), "failed": failed}), flush=True)
    return 1 if failed else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_timing: needs one NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = sys.argv[1:]
    if args and args[0] == "--variants":
        return variants(args[1:] or list(EDITS))
    if args:
        raise SystemExit(f"unknown arguments {args}; see the docstring")
    return committed()


if __name__ == "__main__":
    sys.exit(main())
