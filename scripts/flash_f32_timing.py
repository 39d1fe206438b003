#!/usr/bin/env python3
"""Time the flash attention kernels' f32 route on one card.

    python3 scripts/flash_f32_timing.py
    python3 scripts/flash_f32_timing.py --variants [variant ...]
    python3 scripts/flash_f32_timing.py --was OLD.cu

Without arguments: builds the kernel library (``ops/kernel_build``),
prints the registers and spills ``nvcc -Xptxas -v`` reports for
``csrc/flash_attn_tf32.cu``'s kernels (B4, B5a, B5b and B6 on the tensor
cores as 3xTF32), then times B4, B5a, B5b and B6 in f32 at the LM's two
shapes
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
``ctypes``; B4, B5a, B5b and B6 are timed by CUDA events at both shapes,
the variants in turns over two rounds, and held to the plain versions
(2e-5 of the scale; ``UNCHECKED`` variants' errors are printed, not
checked). This is how the two-level sums were chosen.

With ``--was OLD.cu``: ``OLD.cu`` is an earlier source of f32 B5a and B6
with the C entries ``azt_flash_bwd_dq`` and ``azt_flash_bwd_fused`` that
took a dtype argument after ``d`` (the CUDA-core ``csrc/flash_attn.cu`` of
commit 544dfe4, e.g. ``git show 544dfe4:analytics_zoo_tpu_torch/csrc/
flash_attn.cu > build/was/flash_attn.cu``). It is built by its own ``nvcc
-Xptxas -v`` beside the library, and each kernel is timed in turns with
the committed one (new, old, old, new; ``WAS_ROUNDS`` rounds, ten calls
after five a turn, CUDA events and the profiler's device time): B6 at
[8, 16, 2048, 128], B5a and B5a + B5b at [2, 16, 4096, 128], causal, with
``scaled_dot_product_attention(is_causal=True)``'s forward + backward in
the same turns; every output is held to its plain version.

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

#: the head of the loop over d's 8-steps in B5b's and B6's S^T and dP^T
BWD_KC = """#pragma unroll 2
      for (int kc = 0; kc < kD; ++kc) {
        if (kc < kd) {
          FragA a, av;"""
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
    # B6's dq step unrolled in full over the keys' 8-steps, not a loop
    "b6_dq_unrolled": [("cu", "#pragma unroll 1\n"
                        "  for (int s = 0; 8 * s < nk; ++s) {",
                        "#pragma unroll\n"
                        "  for (int s = 0; s < kRows / 8; ++s) {\n"
                        "    if (8 * s >= nk) break;")],
    # B5b's and B6's S^T and dP^T over d's 8-steps unrolled in full, not
    # twice
    "bwd_kc_unrolled": [("cu", BWD_KC, BWD_KC.replace("#pragma unroll 2\n",
                                                       "#pragma unroll\n"))],
    # B6's dq shares stored, not added: the atomics' cost (dq wrong)
    "b6_store_dq": [("cu", "            atomicAdd(reinterpret_cast<float4*>(",
                     "            __stcg(reinterpret_cast<float4*>(")],
    # B6's ds.K as one TF32 product: the split's and the small terms' cost
    # (dq wrong)
    "b6_dq_one_term": [("cu", "        mma3(acc[0][j], a[0], b);\n"
                        "        mma3(acc[1][j], a[1], b);",
                        "        mma_tf32(acc[0][j], a[0].big, b.big);\n"
                        "        mma_tf32(acc[1][j], a[1].big, b.big);")],
    # B6 without its dq step: the step's cost (dq wrong)
    "b6_no_dq_step": [("cu", "      add_dq_share<kD>(dq_acc + qbase, dst, "
                       "ks, ld, nk, qf, sq, d, scale);", "")],
}
#: variants timed to attribute cost or error: their errors are printed,
#: not checked
UNCHECKED = ("one_level", "b6_store_dq", "b6_no_dq_step", "b6_dq_one_term")
#: rounds of new, old, old, new in ``--was``
WAS_ROUNDS = 3


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
        lib.azt_flash_fwd.argtypes = [p] * 6 + [ll, i, i, i, i, f, i, p]
        lib.azt_flash_bwd_dq.argtypes = [p] * 8 + [ll, i, i, i, f, f, i, p]
        lib.azt_flash_bwd_dkv.argtypes = [p] * 9 + [ll, i, i, i, f, f, i, p]
        lib.azt_flash_bwd_fused.argtypes = [p] * 10 + [ll, i, i, i, f, f, i,
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
        want = (want_o, lse) + at.flash_bwd_fused_plain(
            q, k, v, do, lse, delta, None, scale, True)
        o, got_lse = torch.empty_like(q), torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dq6, dk6, dv6 = (torch.empty_like(t) for t in (q, k, v))
        stream = torch.cuda.current_stream().cuda_stream
        dims = (b * h, s, s, d)
        bwd_in = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), None)
        for rnd in range(2):
            for name, lib in libs.items():
                def fwd(lib=lib):
                    rc = lib.azt_flash_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                        o.data_ptr(), got_lse.data_ptr(), *dims, h,
                        scale * at._LOG2E, 1, stream)
                    assert rc == 0, rc

                def dq_(lib=lib):
                    rc = lib.azt_flash_bwd_dq(
                        *bwd_in, dq.data_ptr(), *dims, scale * at._LOG2E,
                        scale, 1, stream)
                    assert rc == 0, rc

                def dkv(lib=lib):
                    rc = lib.azt_flash_bwd_dkv(
                        *bwd_in, dk.data_ptr(), dv.data_ptr(), *dims,
                        scale * at._LOG2E, scale, 1, stream)
                    assert rc == 0, rc

                def fused(lib=lib):
                    dq6.zero_()
                    rc = lib.azt_flash_bwd_fused(
                        *bwd_in, dq6.data_ptr(), dk6.data_ptr(),
                        dv6.data_ptr(), *dims, scale * at._LOG2E, scale, 1,
                        stream)
                    assert rc == 0, rc

                for fn in (fwd, dq_, dkv, fused):
                    fn()
                torch.cuda.synchronize()
                errs = {key: max(chip_smoke._rel_err(got, ref),
                                 chip_smoke._rel_l2(got, ref))
                        for key, got, ref in zip(
                            ("o", "lse", "dq", "dk", "dv"),
                            (o, got_lse, dq, dk, dv), want)}
                errs.update({key: max(chip_smoke._rel_err(got, ref),
                                      chip_smoke._rel_l2(got, ref))
                             for key, got, ref in zip(
                                 ("b6_dq", "b6_dk", "b6_dv"),
                                 (dq6, dk6, dv6), want[2:])})
                if max(errs.values()) > TOL and name not in UNCHECKED:
                    failed.append((name, label, errs))
                print(json.dumps({
                    "shape": label, "round": rnd, "variant": name,
                    **{f"{key}_ms": chip_smoke.cuda_ms(fn, 10, warmup=2)
                       for key, fn in (("b4", fwd), ("b5a", dq_),
                                       ("b5b", dkv), ("b6", fused))},
                    "errors": errs}), flush=True)
        del q, k, v, do, o, dq, dk, dv, dq6, dk6, dv6, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi(), "failed": failed}), flush=True)
    return 1 if failed else 0


def was(path: str) -> int:
    """The committed f32 B5a and B6 in turns with those of ``path``."""
    kernel_build.load_library()
    out = os.path.join(REPO, "build", "flash_f32_was")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    built = subprocess.run(
        [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-shared", "-o", os.path.join(out, "lib.so"), path],
        capture_output=True, text=True)
    if built.returncode != 0:
        raise SystemExit(f"{path} failed to build:\n{built.stderr}")
    # the earlier kernels' registers and spills, by mangled name
    usage, name = {}, None
    for line in (built.stdout + built.stderr).splitlines():
        if "entry function" in line:
            name = line.split("'")[1]
        m = chip_smoke._PTXAS_REGS.search(line)
        n = chip_smoke._PTXAS_SPILL.search(line)
        if n and name:
            usage.setdefault(name, {})["spill_bytes"] = [
                int(n.group(1)), int(n.group(2))]
        if m and name:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
    print(json.dumps({"was": path, "ptxas": usage}), flush=True)
    old = ctypes.CDLL(os.path.join(out, "lib.so"))
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    old.azt_flash_bwd_dq.argtypes = [p] * 8 + [ll, i, i, i, i, f, f, i, p]
    old.azt_flash_bwd_fused.argtypes = [p] * 10 + [ll, i, i, i, i, f, f, i,
                                                   p]
    dev = torch.device("cuda", 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    failed = []
    for label, (b, h, s, d), _ in TIMED:
        gen = torch.Generator().manual_seed(s + d)
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(dev)
                       for _ in range(4))
        scale = d ** -0.5
        o, lse = at.flash_fwd(q, k, v, None, scale, True)
        delta = (do * o).sum(-1)
        args = (q, k, v, do, lse, delta, None, scale, True)
        want = at.flash_bwd_fused_plain(*args)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), None)
        dq_old = torch.empty_like(q)
        dq6, dk6, dv6 = (torch.empty_like(t) for t in (q, k, v))
        stream = torch.cuda.current_stream().cuda_stream
        dims = (b * h, s, s, d, 0)  # dtype 0: f32

        def b5a_old():
            rc = old.azt_flash_bwd_dq(*ptrs, dq_old.data_ptr(), *dims,
                                      scale * at._LOG2E, scale, 1, stream)
            assert rc == 0, rc
            return dq_old

        def b6_old():
            dq6.zero_()
            rc = old.azt_flash_bwd_fused(
                *ptrs, dq6.data_ptr(), dk6.data_ptr(), dv6.data_ptr(), *dims,
                scale * at._LOG2E, scale, 1, stream)
            assert rc == 0, rc
            return dq6, dk6, dv6

        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd():
            sdpa(*leaves, is_causal=True).backward(do)

        # each returns (dq, dk, dv), the plain dk and dv beside B5a's dq
        if at.fused_bwd_applicable(s, d, q.element_size()):
            fns = {"b6": lambda: at.flash_bwd_fused(*args), "b6_was": b6_old}
        else:
            fns = {"b5a": lambda: (at.flash_bwd_dq(*args),) + want[1:],
                   "b5a_was": lambda: (b5a_old(),) + want[1:],
                   "b5a_b5b": lambda: (at.flash_bwd_dq(*args),)
                   + at.flash_bwd_dkv(*args),
                   "b5a_b5b_was": lambda: (b5a_old(),)
                   + at.flash_bwd_dkv(*args)}
        errs = {}
        for key, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            errs[key] = max(chip_smoke._grads_errs(got, want, False))
            if errs[key] > TOL:
                failed.append((label, key, errs[key]))
        # the kernels, their earlier versions and SDPA in turns
        fns["sdpa_fwd_bwd"] = sdpa_fwd_bwd
        turns = chip_smoke.turns_ms(fns, WAS_ROUNDS)
        print(json.dumps({"shape": label, "dims": [b, h, s, d],
                          "errors": errs, "turns": turns}), flush=True)
        del q, k, v, do, o, lse, delta, args, want, leaves, fns
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
    if len(args) == 2 and args[0] == "--was":
        return was(args[1])
    if args:
        raise SystemExit(f"unknown arguments {args}; see the docstring")
    return committed()


if __name__ == "__main__":
    sys.exit(main())
