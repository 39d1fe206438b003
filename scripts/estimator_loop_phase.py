#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training-loop phase (25,
``phase_estimator_loop``) alone on one card.

    python3 scripts/estimator_loop_phase.py [--seed N]

Builds the kernel library (``ops/kernel_build``), then fine-tunes
BERT-base through ``Estimator.train`` as the phase does: K steps a
dispatch against one, elastic retry past a torn snapshot, a real SIGTERM
and its resume, NCF with frozen tables, ``train_online``. It prints the
card's name and power limit, the build's and the phase's seconds, and the
phase's stats as one JSON line; it exits with 1 if a check fails. Needs
one NVIDIA card and ``nvcc``; snapshots go under ``build/``.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops import attention as at  # noqa: E402
from analytics_zoo_tpu_torch.ops import embedding_kernels as ek  # noqa: E402
from analytics_zoo_tpu_torch.ops import kernel_build  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("estimator_loop_phase: needs one NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    kernel_build.load_library()
    print(f"build {time.perf_counter() - t0:.3f} s", flush=True)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="estimator_loop_", dir=build)
    try:
        t0 = time.perf_counter()
        _, stats = chip_smoke.phase_estimator_loop(at, ek, args.seed,
                                                   workdir)
        print(f"phase {time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
