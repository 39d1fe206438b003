#!/usr/bin/env python3
"""The card's run-to-run spread of ``chip_smoke.py``'s training-loop
phase (25): its BERT-base fine-tune, 16 steps through ``Estimator.train``
with ``("l2", 1.0)`` clipping, from one set of seeded weights.

    python3 scripts/estimator_loop_spread.py [--seed N] [--default-runs N]
                                             [--deterministic-runs N]
                                             [--out DIR]

Trains ``--default-runs`` times in PyTorch's default mode, then
``--deterministic-runs`` times under ``chip_smoke.deterministic_algorithms``,
each time alternating one and four steps a dispatch (K = 1, 4, 1, ...).
For every pair of runs of one mode it prints the parameters' max |Δ| and
relative L2 distance, the losses' max |Δ| and each step's |Δ loss|, and
each run's ms a step by wall clock, as one JSON line a mode; with
``--out``, each line also goes to
``DIR/estimator_loop_spread_<mode>.json``. It prints the card's name and
power limit first. Needs one NVIDIA card and ``nvcc``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops import kernel_build  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--default-runs", type=int, default=8)
    parser.add_argument("--deterministic-runs", type=int, default=5)
    parser.add_argument("--out", help="a directory for the JSON lines")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("estimator_loop_spread: needs one NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    kernel_build.load_library()
    from analytics_zoo_tpu_torch.capture import BERTClassifier
    from analytics_zoo_tpu_torch.capture.text import bert_input_pack
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras.optimizers import Adam

    cs = chip_smoke
    cfg = dict(cs.BERT_CFG, compute_dtype="bfloat16", hidden_p_drop=0.1,
               attn_p_drop=0.1)
    tokens, labels = cs.bert_records(args.seed, cs.BERT_RECORDS, cs.BERT_SEQ)
    packed = bert_input_pack(tokens)
    epochs = cs.LOOP_STEPS // (cs.BERT_RECORDS // cs.BERT_BATCH)
    model = BERTClassifier(2, bert_config=cfg,
                           optimizer=Adam(cs.BERT_LR)).build(
        cs.BERT_SEQ, torch.Generator().manual_seed(args.seed),
        device="cuda").model
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def run(k):
        model.load_state_dict(init)
        est = Estimator(model, model.loss_fn, Adam(cs.BERT_LR),
                        device="cuda")
        est.set_gradient_clipping(("l2", 1.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = est.train(FeatureSet.from_ndarrays(packed, labels),
                         cs.BERT_BATCH, epochs=epochs, steps_per_dispatch=k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(hist["loss_history"])
        return k, hist["loss_history"], {
            n: v.detach().clone() for n, v in model.state_dict().items()}, ms

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for mode, n in (("default", args.default_runs),
                    ("deterministic", args.deterministic_runs)):
        ks = [(1, 4)[i % 2] for i in range(n)]
        t0 = time.perf_counter()
        if mode == "default":
            runs = [run(k) for k in ks]
        else:
            with cs.deterministic_algorithms():
                runs = [run(k) for k in ks]
        pairs = []
        for i, a in enumerate(runs):
            for b in runs[i + 1:]:
                dl = np.abs(np.asarray(a[1]) - np.asarray(b[1]))
                pairs.append({"k": [a[0], b[0]],
                              **cs.param_distance(a[2], b[2]),
                              "loss": float(dl.max()),
                              "loss_steps": [float(x) for x in dl]})
        line = {"mode": mode, "seconds": time.perf_counter() - t0,
                "k": ks, "ms_per_step_wall": [r[3] for r in runs],
                "losses_first_run": [float(x) for x in runs[0][1]],
                "pairs": pairs}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(os.path.join(args.out,
                                   f"estimator_loop_spread_{mode}.json"),
                      "w") as f:
                json.dump(line, f)
        del runs
    return 0


if __name__ == "__main__":
    sys.exit(main())
