#!/usr/bin/env python3
"""Time the f32 route of the fused short attention (B7, B8) on one card.

    python3 scripts/fused_short_f32_timing.py

Builds the kernel library (``ops/kernel_build``), prints the registers and
spills ``nvcc -Xptxas -v`` reports for ``csrc/fused_short_attn.cu``'s
kernels, then times B7 and B8's f32 route at ``chip_smoke.ATTN_F32_TIMED``
(the LM's prefill [4, 16, 128, 128] causal; BERT-base [128, 12, 128, 64]
with a padding bias and dropout 0.1; [4, 16, 512, 128] causal) by CUDA
events and the profiler, beside their plain versions and
``scaled_dot_product_attention`` in f32 with the same mask and dropout,
each held to its plain version within 2e-5 of the output's scale, as
``chip_smoke.py`` does. Each line printed is one JSON object; the last
names the card and its power limit. Needs one NVIDIA card and ``nvcc``.
"""
import json
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops import attention as at  # noqa: E402
from analytics_zoo_tpu_torch.ops import kernel_build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_short_f32_timing: needs one NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_build.load_library()
    src = os.path.join(kernel_build.CSRC_DIR, "fused_short_attn.cu")
    with tempfile.TemporaryDirectory() as tmp:
        ptxas = subprocess.run(
            [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-Xptxas",
             "-v", "-I", kernel_build.CSRC_DIR, "-c", "-o",
             os.path.join(tmp, "f32.o"), src],
            check=True, capture_output=True, text=True)
    print(json.dumps({"ptxas": chip_smoke.ptxas_usage(
        ptxas.stdout + ptxas.stderr)}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    seed_t = torch.tensor([17], dtype=torch.int32, device=dev)
    for label, t in chip_smoke.f32_attention_timings(at, dev, gen,
                                                      seed_t).items():
        print(json.dumps({"label": label, **t}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
