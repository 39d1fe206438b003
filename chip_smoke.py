#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed 0] [--requests 2048] [--single 64]

Phases, each of which must pass or the script exits non-zero:

1. device: a CUDA card is required; TF32 is off for the float32 matmuls.
2. build: ``nvcc`` builds the port's kernels from ``analytics_zoo_tpu_torch/
   csrc`` (or reuses the build for the same sources), one process per
   source; then the library is built twice more into a scratch directory,
   that way and with one ``nvcc`` over every source, and both are timed;
   the second's ``ptxas -v`` gives the registers and spills of the 12 bf16
   flash kernels, the 6 f32 flash kernels on the tensor cores and the 21
   f32 fused short kernels.
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
   the plain forward) for seq 1, 17, 64, 65, 128, 129 and 512, head widths
   32, 64 and 128, f32 (the tensor cores as 3xTF32, ``f32_tc``) and bf16
   (the tensor cores, ``bf16_tc``), the backward reading the row
   statistics its forward saved (and in f32 its output), with and without
   a padding bias (one row all masked), causal or not, dropout 0 and 0.1:
   within 2e-5 (f32) and 2e-2 (bf16) of the output's scale, and bit-equal
   when repeated; each call must count on its dtype's route. Their dropout
   mask must equal ``dropout_keep_mask`` bit for bit over 1536 x 128 x 128
   entries in f32 and in bf16, its kept share within 4 sigma of 0.9. At
   seed 0, on the card and torch build they were recorded on, the grid's
   largest errors must equal the recorded ones bit for bit: the bf16
   route's those of commit 5cfb824 (its fragment helpers have since moved
   into ``csrc/mma_bf16.cuh``), the f32 route's ``ATTN_GRID_ERRORS_F32_TC``.
   The bf16 route at the BERT-base shape (padding bias, dropout 0 and 0.1)
   and the f32 route at ``ATTN_F32_TIMED``'s shapes (the LM's prefill
   [4, 16, 128, 128] causal; BERT-base [128, 12, 128, 64], padding bias,
   dropout 0.1; [4, 16, 512, 128] causal) are held to their tolerances
   again and timed beside their plain versions and
   ``scaled_dot_product_attention`` with the same mask and dropout; the f32
   bounds at the 3xTF32 rate and at the CUDA cores' f32 rate.
7. BERT: ``BERTClassifier`` at BERT-base width (``bench.py``'s) with seeded
   random weights, bf16, dropout 0.1, adam, fine-tunes 2 epochs of 1024
   padded records at batch 128, seq 128 (16 steps), then evaluates and
   predicts. Every block launches B7 once per forward and B8 once per
   step, all on the bf16 route, and the embeddings three row gathers;
   losses must be finite. The step is timed as in 5. Then the same model
   in f32 without dropout runs on the card (B7 and B8 on the f32 route
   alone) and on the CPU from the same weights: probabilities atol
   1e-5, one step's gradients within 1e-4 in relative L2 norm, two Adam
   steps' losses rtol 1e-5 and parameters (see ``phase_bert_vs_cpu``).

8. flash kernels: the flash attention forward (B4, with and without a
   padding bias, causal or not), the two-pass backward (B5a + B5b) and the
   one-pass backward (B6, with and without an lse cotangent) are held
   against their plain versions for lengths 1, 17, 513, 1000, 2047, 2048
   and 4096 and four pairs of unequal q/kv lengths, head widths 24, 64, 96
   and 128 in f32 and in bf16: within 2e-5 (f32) and 2e-2 (bf16) of the
   output's scale (of the three gradients' joint scale for a backward)
   and, each output and each gradient, in relative L2; B5a + B5b's dq, dk
   and dv and B6's dk and dv bit-equal when repeated. The dtype and the
   kernel pick its route (both on the tensor cores: bf16 in
   ``csrc/flash_attn_bf16.cu``, f32 as 3xTF32 in
   ``csrc/flash_attn_tf32.cu``) and each call must count on it, here and
   on the LM's paths. The f32 kernels are also held at a batch of 16 heads
   whose grids are at least eight blocks an SM, as the LM's are. The
   backward must take B6 at [8, 16, 2048, 128] f32 and [1, 2, 4096, 128]
   bf16, and B5a + B5b at [2, 16, 4096, 128] f32 and [1, 2, 8192, 128]
   bf16. All four are timed at the
   LM's two shapes and at bench_longseq's [4, 8, 4096, 128], [8, 8, 4096,
   64] and [4, 8, 8192, 128] bf16 beside their plain versions and
   ``scaled_dot_product_attention(is_causal=True)``, and held to the same
   tolerances at those shapes; each bound at the rate of the kernel's
   route, and in f32 at both the 3xTF32 and the CUDA cores' rate. A
   profiler device time is printed only
   where every kernel and copy the host issued has its device event in the
   trace.
   Then the long-context step, ``bench.py``'s ``bench_longseq``:
   ``flash_attention(q, k, v, causal=True)`` in bf16 with the loss
   ``sum(o)`` in f32, 20 chained steps (each step's inputs the last
   step's plus eps times its gradients, eps a 0 on the card), at [4, 8,
   4096, 128] and [8, 8, 4096, 64], where a step must launch one B4 and
   one B6, and at [4, 8, 8192, 128], where it must launch one B4, one B5a
   and one B5b, all on the tensor cores. Each shape is gated first as
   ``_flash_numerics_gate`` does (output and gradients within 4e-2 of f32
   ``blockwise_attention``'s largest magnitude, at b 2, h 2, s 1024 for
   4096 keys and at b 1, h 2, s 8192 for 8192, so that the gate takes the
   same backward design as the steps); eps = 0 must give back the inputs
   bit for bit (finite gradients). It prints ms a step by CUDA events,
   tokens/s, the share of 989 TFLOP/s at ``9·B·H·S²·D`` FLOPs a step, and
   the same step through ``scaled_dot_product_attention(is_causal=True)``.
9. TransformerLM: the full-width model (``bench.py:2337-2338``: vocab
   32000, hidden 2048, 8 blocks, 16 heads, max_len 2048, f32, Adam) with
   seeded weights trains 8 steps at batch 8 x 2048 tokens (one B4 and one
   B6 per block and step), then a warm fit and the step are timed; it
   generates 32 tokens greedily for 4 prompts of 1000 tokens (prefill
   through B4) and of 100 (through B7's f32 route, causal), each decode
   step's logits held to a full causal forward (1e-4 of their scale). A
   long-context
   step (depth 2, sequence 4096, batch 2) must take B5a + B5b. At depth 2
   the card is held against the CPU from the same weights: a greedy
   generate after a 600-token prompt (tokens equal up to a near-tie of the
   CPU's, logits 1e-4 of their scale) and two Adam steps (losses rtol
   1e-5, parameters as in 7).

10. int8 gather kernel (B9): held bit for bit against its plain version on
   NCF's four tables quantized as ``quantize_table`` does, for n 0-257,
   widths 1, 3, 4, 5, 31, 32, 33, 64 and 130, ids out of range on both
   sides, a scale that is a device tensor, and a table whose base is not
   4-byte aligned; then timed at the served lookup ([6041, 64], n 256) and
   over a 1 GiB table ([2^24, 64], 2^20 distinct ids) beside its plain
   version and ``index_select`` then ``* scale`` (two calls).
11. quantized serving: the NCF that phase 4 saved is served through
   ``ClusterServing`` with ``quantize: int8`` and ``quantize: bf16`` (a
   burst of 512, then 16 single requests each). Every request is answered
   once, equal to a direct card forward of the same quantized model at the
   served batch shapes (rtol 1e-5) and to the CPU's quantized forward (atol
   1e-5 int8, 2e-2 bf16); a served batch launches 4 B9 and no B1 in int8,
   4 B1 on bf16 tables in bf16; int8 frees about 3/4 of the weight bytes.
   Records/s, latency, and drift and argmax agreement against the f32
   model are printed.
12. calibrated int8: ``InferenceModel.quantize("int8", calibration_data=)``
   on the same model, on the card and on the CPU from the same batches:
   activation scales within 1e-6 relative, int8 kernels equal; with the
   CPU's scales loaded on the card, predictions at buckets 1, 16 and 256
   within 1e-5 of the CPU's (buckets 1 and 16 pad for ``torch._int_mm``).
13. row scatter-add kernel (B3): held against its plain version for widths
   1, 2, 3, 8, 64 and 130, 0 to 4096 grad rows, blocks of 7, 5000 and
   25,000,254 rows, rows out of range on both sides: bit for bit where no
   row repeats, within 2e-5 of the output's scale where rows repeat (f32
   atomics add them in no fixed order). Timed at the Wide&Deep shard
   ([25,000,254, 2], n = 4 x 6144) and at a 1 GiB block ([2^22, 64], 2^20
   uniform rows) beside its plain version and ``zeros`` + ``index_add_``;
   at the shard also in turns with that library call (kernel, library,
   library, kernel; ten calls after five each, by device time and events).
14. vocab-sharded Wide&Deep: 4 gloo ranks (``torch.multiprocessing``) share
   the card, each holding a quarter of every table. At the columns of 5,
   ``SGD(0.1)``, 4 steps of the global batch 8192: parameters within 1e-5
   of the replicated model trained on the card in one process from the
   same weights, and of the same 4 ranks on the CPU; each rank launches 3
   B1 (forward lookups) and 3 B3 (backward) a step and no B2, and the
   ranks' exchange bytes are ``exchange_cost_bytes``. Then at
   ``bench_widedeep_sharded``'s width (100M-bucket cross: a 100,001,016 x 2
   f32 table, 200 MB a rank, asserted at most a quarter of the dense
   table plus one row), lazy Adam 1e-3, 16 steps: samples/s, step ms by
   CUDA events, peak memory and bytes exchanged per rank, and rank 0's
   step in the profiler (device time, top kernels and host operators);
   the replicated model at 1M buckets in one process beside it. Four ranks time-share one
   card: no multi-card scaling is measured.
15. weight-only int8 Wide&Deep (columns of 5): predicted on the card and on
   the CPU from the same saved model, within 1e-5; the wide table reads
   dequantized (one B2 a batch), the embedding tables through B9.

Each phase's seconds are printed. The last three lines of output are the
card's
``nvidia-smi`` name and power limit, the ``{"kernels": [...]}`` line,
and the ``{"ok": true, ...}`` line.
"""
import argparse
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

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
#: f32-grade products on the tensor cores as 3xTF32: three TF32 products
#: (494.7 TFLOP/s dense, H100 SXM data sheet) for each f32 one
PEAK_FLOPS_3XTF32 = 494.7e12 / 3
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
#: B7/B8's grid, every case through both routes: lengths (one tile, one
#: past it, two and past them, the longest) and head widths
ATTN_SEQS = (1, 17, 64, 65, 128, 129, 512)
ATTN_DIMS = (32, 64, 128)
#: B7/B8's largest grid errors at seed 0 from commit 5cfb824, before their
#: fragment helpers moved into csrc/mma_bf16.cuh, on this card and torch
#: build: the bf16 route's must stay bit for bit. Its f32 entries are the
#: CUDA-core kernel's, which the 3xTF32 kernel replaced: kept as a record,
#: not compared
ATTN_GRID_ERRORS_5CFB824 = (
    ("NVIDIA H100 80GB HBM3", "2.11.0+cu128"),
    {"fwd": 2.8305358204308074e-07, "bwd": 4.98379385249795e-07,
     "fwd_bf16": 0.007407407407407408, "bwd_bf16": 0.007633587786259542})
#: the f32 route's largest grid errors at seed 0 on the tensor cores
#: (3xTF32), on this card and torch build: a change that leaves the f32
#: kernels' arithmetic alone leaves them bit for bit
ATTN_GRID_ERRORS_F32_TC = (
    ("NVIDIA H100 80GB HBM3", "2.11.0+cu128"),
    {"fwd": 4.17570171394223e-06, "bwd": 7.523755994632065e-06})
#: the card-against-CPU check: Adam had "the CPU's gradient" for a
#: parameter where the card's is within this of it, relative
GRAD_SAME = 1e-3
#: the repo's full-width TransformerLM (bench.py:2337-2338): head dim 128,
#: intermediate 8192, tied embeddings, f32 (472.6 M parameters)
LM_CFG = dict(vocab_size=32000, hidden=2048, n_block=8, n_head=16,
              max_len=2048)
#: training: 8 steps of batch 8 x 2048 tokens (rows of 2049: the forward
#: runs at max_len)
LM_BATCH, LM_STEPS = 8, 8
#: long context: the same widths at depth 2 (cut for time only), max_len
#: and sequence 4096 (bench_longseq's, bench.py:2874), batch 2, 2 steps
LM_LONG = dict(LM_CFG, n_block=2, max_len=4096)
LM_LONG_BATCH, LM_LONG_STEPS = 2, 2
#: generation: batch 4, 32 new tokens, prompts of 1000 tokens (prefill
#: bucket 2048, flash) and of 100 (bucket 128, the fused short kernel)
GEN_BATCH, GEN_NEW, GEN_PROMPTS = 4, 32, (1000, 100)
#: B7's f32 route where the LM's generate runs it: the 100-token prompt's
#: prefill bucket of 128, [GEN_BATCH, heads, 128, head width], causal
ATTN_F32_SHAPE = (GEN_BATCH, LM_CFG["n_head"], 128,
                  LM_CFG["hidden"] // LM_CFG["n_head"])
#: B7/B8's f32 route timed as (label, [b, h, s, d], padding bias, dropout,
#: causal): the LM's prefill; BERT-base fine-tuned at the default dtype
#: (what each of its 12 layers runs a step); the longest length the kernels
#: take, at the LM's heads
ATTN_F32_TIMED = (
    ("lm_prefill", ATTN_F32_SHAPE, False, 0.0, True),
    ("bert_base", (BERT_BATCH, BERT_CFG["n_head"], BERT_SEQ,
                   BERT_CFG["hidden_size"] // BERT_CFG["n_head"]),
     True, 0.1, False),
    ("s512", (GEN_BATCH, LM_CFG["n_head"], 512, ATTN_F32_SHAPE[3]),
     False, 0.0, True))
#: card against CPU: full width at depth 2; two Adam steps at batch 2,
#: sequence 512; a greedy generate of 8 tokens after a 600-token prompt
LM_CPU = dict(LM_CFG, n_block=2)
LM_CPU_RECORDS, LM_CPU_BATCH, LM_CPU_SEQ = 4, 2, 512
LM_CPU_PROMPT, LM_CPU_NEW = 600, 8
#: B9's grid: widths that are and are not whole 4-byte words, and id counts
INT8_DIMS = (1, 3, 4, 5, 31, 32, 33, 64, 130)
INT8_NS = (0, 1, 2, 31, 32, 33, 255, 256, 257)
#: the timed int8 table that L2 cannot hold: 16 Mi x 64 int8 = 1 GiB
INT8_HBM_ROWS = 1 << 24
#: B3's grid: widths (the wide table's 2, the embed tables' 8), grad
#: counts (those of the sharded step: 4 ranks x 2048 rows for an embed
#: table, x 3 wide ids for the wide table), and block rows (small, the
#: occ_e shard's 250, and the full-width Wide&Deep shard's)
SCATTER_DIMS = (1, 2, 3, 8, 64, 130)
SCATTER_NS = (0, 1, 255, 256, 257, 4096, 8192, 24576)
SCATTER_ROWS = (7, 250, 5000, 25000254)
#: the full-width Wide&Deep shard: 100,001,016 wide rows over 4 ranks, and
#: one step's exchanged grads there (4 ranks x 2048 rows x 3 wide ids)
WND_SHARD_ROWS, WND_SHARD_N = 25000254, 4 * 6144
#: a shard block L2 cannot hold: 2^22 x 64 f32 = 1 GiB, 2^20 uniform rows
SCATTER_HBM = (1 << 22, 64, 1 << 20)
#: rounds of B3 and its library call in turns at the shard (each a turn
#: of each, then of each again in the other order)
SCATTER_TURNS = 3
#: vocab-sharded Wide&Deep: gloo ranks sharing the one card, the global
#: batch (bench_widedeep_sharded's), and steps held to the replicated run
SHARD_RANKS, SHARD_BATCH, SHARD_STEPS = 4, 8192, 4
#: full width: bench_widedeep_sharded's 100M-bucket cross (bench.py:
#: 752-755), lazy Adam for 16 steps, then 10 steps timed by CUDA events;
#: the replicated layout beside it at 1M buckets (bench.py:816-824)
FULL_CROSS, FULL_STEPS, FULL_TIMED = 100000000, 16, 10
#: steps in the profiler's trace of a full-width step (rank 0's)
FULL_PROFILED = 5
REPLICATED_CROSS = 1000000
#: seconds the parent waits for every rank's results
RANKS_TIMEOUT_S = 480
#: weight-only int8 Wide&Deep, card against CPU: records predicted
INT8_WND_RECORDS = 20000
#: quantized serving: a burst, then requests one at a time, per mode
QUANT_BURST, QUANT_SINGLE = 512, 16
#: the served answers against the CPU's quantized forward
QUANT_ATOL = {"int8": 1e-5, "bf16": 2e-2}
#: calibration: 4 seeded batches of 256 pairs
CALIB_BATCHES = 4
#: decode logits against a full forward (the card) and the card against
#: the CPU: f32 sums in another order through every block, relative to the
#: logits' scale (their largest magnitude, about 4 at random init)
LOGIT_TOL = 1e-4
#: flash kernels against their plain versions: the grid's (q_len, kv_len)
FLASH_LENGTHS = ((1, 1), (17, 17), (513, 513), (1000, 1000), (2047, 2047),
                 (2048, 2048), (4096, 4096), (513, 1000), (1000, 513),
                 (17, 4096), (2047, 1))
#: f32 B4, B5a, B5b and B6 at a batch of 16-head rows whose grid is at
#: least eight 64-row blocks an SM (``many_blocks_batch``), as the LM's
#: grids are: the grid above runs b·h 2
FLASH_MANY_LENGTHS = ((513, 1000), (1000, 513), (17, 4096), (2047, 1),
                      (4096, 4096))
FLASH_MANY_HEADS = 16
#: the head widths of the grid, in both dtypes: 64 and 128, one ragged
#: chunk of 8 or 16 (24) and a partial 128-wide tile (96)
FLASH_DIMS = {torch.float32: (24, 64, 96, 128),
              torch.bfloat16: (24, 64, 96, 128)}
#: bench_longseq (bench.py:2874-2925), bf16, causal, 20 chained steps, as
#: (label, shape, the numerics gate's shape): the headline [4, 8, 4096,
#: 128] and the d 64 addendum (batch doubled, the same FLOPs a step), which
#: take B6, and the headline with seq raised to 8192, which takes B5a + B5b
#: (past fused_bwd_applicable)
LONGSEQ_SHAPES = (("d128", (4, 8, 4096, 128), (2, 2, 1024, 128)),
                  ("d64", (8, 8, 4096, 64), (2, 2, 1024, 64)),
                  ("s8192", (4, 8, 8192, 128), (1, 2, 8192, 128)))
LONGSEQ_STEPS = 20
#: its numerics gate (bench.py:297-330): the output and the gradients
#: against f32 blockwise_attention, relative to its largest magnitude
LONGSEQ_GATE_TOL = 4e-2
#: the timed shapes [b, h, s, d]: the LM's step (B4, B6), its long-context
#: step (B5a, B5b in f32) and bench_longseq's headline, addendum (bf16, B4
#: and B6 on the tensor cores) and 8192 keys (bf16, B4, B5a and B5b on the
#: tensor cores)
FLASH_TIMED = (("lm", (8, 16, 2048, 128), torch.float32),
               ("lm_long", (2, 16, 4096, 128), torch.float32),
               ("bench_longseq", LONGSEQ_SHAPES[0][1], torch.bfloat16),
               ("bench_longseq_d64", LONGSEQ_SHAPES[1][1], torch.bfloat16),
               ("bench_longseq_s8192", LONGSEQ_SHAPES[2][1],
                torch.bfloat16))


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events,
    after ``warmup`` calls."""
    for _ in range(warmup):
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


def turns_ms(fns: dict, rounds: int, calls: int = 10,
             warmup: int = 5) -> dict:
    """Each of ``fns`` (``{name: fn}``) timed in turns, forward then
    backward through the names (a, b, b, a for two) ``rounds`` times: per
    turn ``warmup`` calls, then ``calls`` calls by CUDA events and
    ``calls`` under the profiler. Returns ``{name: {"ms": [...],
    "device_ms": [...]}}``, a list entry a turn (device None where the
    trace lost events)."""
    names = list(fns)
    out = {n: {"ms": [], "device_ms": []} for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            out[n]["ms"].append(cuda_ms(fns[n], calls, warmup))
            out[n]["device_ms"].append(
                step_profile(fns[n], calls, warmup=False)["device_ms"])
    return out


def device_ms(fn, calls: int = 20):
    """Device time per call of the kernels and copies ``fn`` issues, summed
    from a ``torch.profiler`` trace; None when the trace is incomplete (see
    :func:`step_profile`)."""
    return step_profile(fn, calls)["device_ms"]


#: host calls that put a kernel, copy or fill on the card, as the profiler
#: names them (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
#: ``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...)
_DEVICE_WORK_CALL = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")


def step_profile(fn, calls: int = 20, top: int = 0,
                 warmup: bool = True) -> dict:
    """A ``torch.profiler`` trace of ``calls`` calls of ``fn``, per call:
    the device time of its kernels and copies, their number, the number of
    host calls that issued them, and with ``top`` the ``top`` longest
    kernels and the ``top`` host operators with the most self time, as
    ``[name, ms, count]``. The device time is None unless every issued
    kernel, copy and fill has its device event: the profiler can drop
    device events in short windows, and a partial sum is not a time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    us = sum(e.self_device_time_total for e in dev)
    n_dev = sum(e.count for e in dev)
    issued = sum(e.count for e in host if _DEVICE_WORK_CALL.match(e.key))
    out = {"device_ms": us / 1e3 / calls if us > 0 and n_dev == issued
           else None,
           "device_launches": n_dev / calls,
           "issued_launches": issued / calls}
    if top:
        dev.sort(key=lambda e: -e.self_device_time_total)
        host.sort(key=lambda e: -e.self_cpu_time_total)
        out["top_device"] = [[e.key[:72], e.self_device_time_total / 1e3
                              / calls, e.count / calls] for e in dev[:top]]
        out["top_host"] = [[e.key[:72], e.self_cpu_time_total / 1e3 / calls,
                            e.count / calls] for e in host[:top]]
    return out


#: ptxas -v's lines for an entry function of the bf16 flash kernels (B4
#: ``flash_fwd``, B5a ``flash_bwd_dq``, B5b and B6 ``flash_bwd``), of the
#: f32 flash kernels (B4 ``flash_fwd_tf32``, B5a ``flash_bwd_dq_tf32``,
#: B5b and B6 ``flash_bwd_tf32``) or of the f32 fused short kernels (B7
#: ``fused_short_fwd``, B8's two passes ``fused_short_bwd_dq`` and
#: ``_dkv``) and its mangled template arguments
_PTXAS_ENTRY = re.compile(
    r"entry function '\S*?((?:flash_(?:fwd|bwd|bwd_dq)_(?:bf16|tf32)|"
    r"fused_short_(?:fwd|bwd_dq|bwd_dkv))_kernel)I((?:L[ib]\d+E)+)E")
_PTXAS_ARG = re.compile(r"L[ib](\d+)E")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each bf16 flash kernel (by its template
    arguments: 16-column chunks of d, and B5b's and B6's keys a block and
    whether it adds dq), each f32 flash kernel (8-column chunks of d, and
    for B5b and B6 whether it adds dq) and
    each f32 fused short kernel (8-column chunks of d, and warps a row
    group) from ``nvcc -Xptxas -v`` output."""
    usage, name = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            args = ",".join(_PTXAS_ARG.findall(m.group(2)))
            name = f"{m.group(1)}<{args}>"
            usage[name] = {}
            continue
        m = _PTXAS_SPILL.search(line)
        if m and name:
            usage[name]["spill_store_bytes"] = int(m.group(1))
            usage[name]["spill_load_bytes"] = int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
            name = None
    return usage


def rebuild_seconds(kernel_build) -> dict:
    """Seconds to build the kernel library again into a scratch directory:
    as ``kernel_build`` does (one ``nvcc`` per source, started together,
    then a link), and with one ``nvcc`` over every source (with ``-Xptxas
    -v``, whose registers and spills of the bf16 and f32 flash kernels and
    of the f32 fused short kernels are kept)."""
    srcs, _ = kernel_build._sources()
    out = {}
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        kernel_build._build(os.path.join(tmp, "parallel.so"))
        out["nvcc_per_source"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS,
                              "-Xptxas", "-v", "-shared", "-I",
                              kernel_build.CSRC_DIR, "-o",
                              os.path.join(tmp, "one.so"), *srcs],
                             check=True, capture_output=True, text=True)
        out["one_nvcc"] = time.perf_counter() - t0
    usage = ptxas_usage(one.stdout + one.stderr)
    for key, kind, want, what in (
            ("ptxas_bf16_flash", "_bf16_", 12,
             "bf16 flash kernels (B4, B5a, B5b, B6)"),
            ("ptxas_f32_flash", "_tf32_", 12,
             "f32 flash kernels (B4, B5a, B5b, B6)"),
            ("ptxas_f32_fused", "fused_short_", 21,
             "f32 fused short kernels (B7 at 3 splits, B8's two passes at "
             "2)")):
        out[key] = {k: v for k, v in usage.items() if kind in k}
        check(len(out[key]) == want, f"ptxas -v named {sorted(out[key])}, "
              f"expected the {what} at 3 widths")
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


def int8_bound_ms(qtable: torch.Tensor, ids: torch.Tensor) -> float:
    """Least time for an int8 gather of these ids at the memory rate, as
    :func:`gather_bound_ms` reckons it: each distinct in-range row read
    once (1 byte an element), each f32 output row written once, each id
    read once."""
    rows, dim = qtable.shape
    n = ids.shape[0]
    distinct = int(torch.unique(ids[(ids >= 0) & (ids < rows)]).numel())
    return (distinct * dim + n * dim * 4 + 4 * n) / HBM_BYTES_PER_S * 1e3


def phase_int8_kernels(ek, dev, seed: int):
    """Hold the int8 gather kernel (B9) against its plain version bit for
    bit, then time both and ``index_select`` + ``* scale``; returns
    (timings, largest error, cases checked)."""
    gen = torch.Generator().manual_seed(seed)
    cases = []
    for _, rows, dim in NCF_TABLES:  # NCF's tables, as quantize makes them
        q, scale, _ = ek.quantize_table(
            torch.randn(rows, dim, generator=gen) * 0.05)
        cases += [(q, scale, n) for n in INT8_NS]
    for dim in INT8_DIMS:
        q = torch.randint(-127, 128, (50, dim), generator=gen,
                          dtype=torch.int8)
        scale = torch.rand((), generator=gen) * 0.02 + 1e-3
        cases += [(q, scale, n) for n in INT8_NS]
    max_err, checked = 0.0, 0
    for q, scale, n in cases:
        rows, dim = q.shape
        ids = torch.randint(-3, rows + 3, (n,), generator=gen,
                            dtype=torch.int32)
        if n >= 2:
            ids[0], ids[1] = -1, rows
        ids, scale_dev = ids.to(dev), scale.to(dev)
        # the table as allocated, and at an odd address (the byte path)
        raw = torch.zeros(q.numel() + 1, dtype=torch.int8, device=dev)
        raw[1:] = q.reshape(-1).to(dev)
        for table in (q.to(dev), raw[1:].view(rows, dim)):
            got = ek.gather_int8(table, scale_dev, ids)
            want = ek.gather_int8_plain(table, scale_dev, ids)
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and torch.equal(got, want),
                  f"int8 kernel != plain at rows={rows} dim={dim} n={n} "
                  f"aligned={table.data_ptr() % 4 == 0}")
            checked += 1
            if n:
                max_err = max(max_err, float((got - want).abs().max()))
    log(f"int8 kernel == plain (torch.equal) on {checked} cases")

    timings = []
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    for label, rows, dim, n, iters in (
            ("mlp_user_table", 6041, 64, SERVE_BATCH, 500),
            ("hbm_table", INT8_HBM_ROWS, 64, LARGE_N, 50)):
        if rows == INT8_HBM_ROWS:
            # every id distinct, so every row comes from device memory
            q = torch.randint(-127, 128, (rows, dim), generator=dev_gen,
                              device=dev, dtype=torch.int8)
            ids = torch.randperm(rows, generator=dev_gen, device=dev)[:n]
            ids = ids.to(torch.int32)
            scale = torch.tensor(0.0123, device=dev)
        else:
            q, scale, _ = ek.quantize_table(
                torch.randn(rows, dim, generator=gen).to(dev) * 0.05)
            ids = torch.randint(0, rows, (n,), generator=gen,
                                dtype=torch.int32).to(dev)
        fns = {"ms": lambda: ek.gather_int8(q, scale, ids),
               "plain_ms": lambda: ek.gather_int8_plain(q, scale, ids),
               "library_ms": lambda: torch.index_select(q, 0, ids) * scale}
        t = {"table": label, "rows": rows, "dim": dim, "n": n,
             "bound_ms": int8_bound_ms(q, ids),
             "library_max_abs_diff": float(
                 (ek.gather_int8(q, scale, ids)
                  - torch.index_select(q, 0, ids) * scale).abs().max())}
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, iters)
            t[key.replace("ms", "device_ms")] = device_ms(fn)
        timings.append(t)
        log("int8 gather timing " + json.dumps(t))
        del fns, q, ids
    return timings, max_err, checked


def scatter_bound_ms(num_rows: int, dim: int, n: int) -> float:
    """Least time for the scatter at the memory rate: the zero fill of the
    ``[num_rows, dim]`` f32 block written once, and per grad row its row
    id read, its ``dim`` f32 read, and its output row read and written."""
    return ((num_rows * dim * 4 + n * (4 + 3 * dim * 4)) / HBM_BYTES_PER_S
            * 1e3)


def _scatter_rows_input(dev, n: int, num_rows: int, repeat: bool):
    """Rows for the B3 grid: out of range on both sides (negatives,
    ``num_rows`` and past it) and, with ``repeat``, in-range rows that
    repeat; without, every row distinct."""
    if repeat:
        pool = torch.randint(-3, num_rows + 3, (max(1, n // 4),),
                             device=dev)
        rows = pool[torch.randint(0, pool.numel(), (n,), device=dev)]
    else:
        rows = torch.randperm(num_rows + 6, device=dev)[:n] - 3
    return rows.to(torch.int32)


def _held_to_plain(ek, g, rows, num_rows: int, what: str) -> tuple:
    """Run B3 and its plain version on ``(g, rows)``: bit for bit where no
    in-range row repeats, else within ``ATTN_ATOL[f32]`` of the output's
    scale (f32 atomics sum repeats in no fixed order). Returns (largest
    error, that error over the scale where rows repeat, else None)."""
    got = ek.scatter_rows(g, rows, num_rows)
    want = ek.scatter_rows_plain(g, rows, num_rows)
    torch.cuda.synchronize()
    check(got.shape == (num_rows, g.shape[1]),
          f"scatter out {tuple(got.shape)} at {what}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    kept = rows[(rows >= 0) & (rows < num_rows)]
    if torch.unique(kept).numel() == kept.numel():
        check(torch.equal(got, want),
              f"scatter kernel != plain at {what} (no repeated rows)")
        return err, None
    scale = max(1.0, float(want.abs().max()))
    check(err <= ATTN_ATOL[torch.float32] * scale,
          f"scatter kernel off plain by {err} (scale {scale}) at {what}")
    return err, err / scale


def phase_scatter_kernel(ek, dev, seed: int):
    """Hold the row scatter-add kernel (B3) against its plain version on the
    grid, then time both and ``zeros`` + ``index_add_`` at the Wide&Deep
    shard and at a 1 GiB block, holding B3 to plain there too; returns
    (timings, largest error, largest error relative to scale with
    repeated rows, cases)."""
    torch.manual_seed(seed)
    abs_err, repeat_err, cases = 0.0, 0.0, 0
    for num_rows in SCATTER_ROWS:
        for dim in SCATTER_DIMS:
            for n in SCATTER_NS:
                for repeat in (False, True):
                    if not repeat and n > num_rows + 6:
                        continue
                    rows = _scatter_rows_input(dev, n, num_rows, repeat)
                    g = torch.randn(n, dim, device=dev)
                    err, rel = _held_to_plain(
                        ek, g, rows, num_rows,
                        f"rows={num_rows} dim={dim} n={n}")
                    abs_err = max(abs_err, err)
                    repeat_err = max(repeat_err, rel or 0.0)
                    cases += 1
                    del g, rows
        torch.cuda.empty_cache()
    log(f"scatter kernel against plain on {cases} cases: bit for bit "
        f"without repeated rows, {repeat_err:.3g} of scale with them")

    timings = []
    for label, num_rows, dim, n, iters in (
            ("wnd_shard", WND_SHARD_ROWS, 2, WND_SHARD_N, 50),
            ("hbm_block",) + SCATTER_HBM + (20,)):
        rows = torch.randint(0, num_rows, (n,), device=dev,
                             dtype=torch.int32)
        g = torch.randn(n, dim, device=dev)
        ok = (rows >= 0) & (rows < num_rows)
        rows_m, g_m = rows[ok].long(), g[ok]
        fns = {"ms": lambda: ek.scatter_rows(g, rows, num_rows),
               "plain_ms": lambda: ek.scatter_rows_plain(g, rows, num_rows),
               "library_ms": lambda: torch.zeros(
                   num_rows, dim, device=dev).index_add_(0, rows_m, g_m)}
        err, rel = _held_to_plain(ek, g, rows, num_rows, label)
        abs_err = max(abs_err, err)
        repeat_err = max(repeat_err, rel or 0.0)
        t = {"shape": label, "rows": num_rows, "dim": dim, "n": n,
             "bound_ms": scatter_bound_ms(num_rows, dim, n),
             "max_abs_err": err, "repeated_rows": rel is not None}
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, iters)
            t[key.replace("ms", "device_ms")] = device_ms(fn)
        if label == "wnd_shard":
            # B3 and its library call in turns, to tell them apart
            t["turns"] = turns_ms({"kernel": fns["ms"],
                                   "library": fns["library_ms"]},
                                  SCATTER_TURNS)
        timings.append(t)
        log("scatter timing " + json.dumps(t))
        del fns, rows, g, rows_m, g_m
        torch.cuda.empty_cache()
    return timings, abs_err, repeat_err, cases


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
        return {"gather_rows": 2 * k, "gather_pool": k, "gather_int8": 0,
                "scatter_rows": 0}

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


def wnd_columns(cross: int) -> dict:
    """``WND_COLUMNS`` with a cross column of ``cross`` buckets."""
    return dict(WND_COLUMNS, wide_cross_dims=[cross])


def wnd_records_at(seed: int, n: int, columns: dict):
    """``n`` seeded records for the Wide&Deep of ``columns``, made as
    ``bench.py:767-776`` makes them."""
    rs = np.random.RandomState(seed)
    dims = columns["wide_base_dims"] + columns["wide_cross_dims"]
    offsets = np.cumsum([0] + dims)[:-1]
    wide = np.stack([rs.randint(0, d, n) + off
                     for d, off in zip(dims, offsets)], 1).astype(np.int32)
    ind = np.stack([rs.randint(0, d, n) for d in
                    columns["indicator_dims"]], 1).astype(np.int32)
    emb = np.stack([rs.randint(0, d, n) for d in
                    columns["embed_in_dims"]], 1).astype(np.int32)
    cont = rs.rand(n, 2).astype(np.float32)
    y = rs.randint(0, 2, n).astype(np.float32)
    return [wide, ind, emb, cont], y


def _launches(ek) -> dict:
    return {k: ek.launch_counts[k] for k in
            ("gather_rows", "gather_pool", "gather_int8", "scatter_rows")}


def _rank_train(ek, engine, est, x, y, steps: int) -> dict:
    """Train ``est`` one epoch of ``steps`` global batches, counting this
    rank's launches and exchange bytes over that run only."""
    from analytics_zoo_tpu_torch.feature import FeatureSet
    fs = FeatureSet.from_ndarrays(x, y)
    ek.reset_launch_counts()
    engine.reset_exchange_bytes()
    sync = est.device.type == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = est.train(fs, batch_size=SHARD_BATCH, epochs=1)
    if sync:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(hist["iterations"] == steps, f"{hist['iterations']} steps, "
          f"expected {steps}")
    return {"launches": _launches(ek), "wall_s": wall,
            "exchange_bytes": dict(engine.exchange_bytes),
            "loss": hist["loss_history"]}


def _shard_rank(rank: int, port: int, device: str, jobs: list, seed: int,
                init_path: str, queue) -> None:
    """One of ``SHARD_RANKS`` ranks: join a gloo group, run ``jobs`` and put
    ``(rank, {job: result})`` on ``queue``."""
    sys.path.insert(0, REPO)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SHARD_RANKS),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank))
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.parallel.mesh import init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    mesh = init_mesh(backend="gloo", device=device)
    try:
        queue.put((rank, _rank_jobs(rank, mesh, device, jobs, seed,
                                    init_path)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    mesh.barrier()
    dist.destroy_process_group()


def _rank_jobs(rank: int, mesh, device: str, jobs: list, seed: int,
               init_path: str) -> dict:
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.keras import optimizers
    from analytics_zoo_tpu_torch.models import WideAndDeep
    from analytics_zoo_tpu_torch.ops import embedding_kernels as ek
    from analytics_zoo_tpu_torch.parallel import embedding as engine

    out = {}
    for job in jobs:
        if job == "correct":
            # 100k-bucket cross, SGD(0.1): held to the replicated run
            zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=WND_HIDDEN,
                              shard_embeddings=True, **WND_COLUMNS)
            est = Estimator(zoo._ensure_built(),
                            "sparse_categorical_crossentropy",
                            optimizers.SGD(0.1), mesh=mesh, seed=seed)
            est.set_params(torch.load(init_path, weights_only=True))
            x, y = wnd_records(seed, SHARD_STEPS * SHARD_BATCH)
            res = _rank_train(ek, engine, est, x, y, SHARD_STEPS)
            params = est.get_params()  # collective
            res["params"] = params if rank == 0 else None
            res["specs"] = {k: (s.rows_per_shard, s.dim, s.vocab)
                            for k, s in est._sharded_table_specs().items()}
            out[job] = res
            del est, zoo
        else:  # "full": bench_widedeep_sharded's model, lazy Adam
            dev = torch.device(device)
            torch.cuda.reset_peak_memory_stats(dev)
            cols = wnd_columns(FULL_CROSS)
            zoo = WideAndDeep("wide_n_deep", 2, hidden_layers=WND_HIDDEN,
                              shard_embeddings=True, **cols)
            est = Estimator(zoo._ensure_built(),
                            "sparse_categorical_crossentropy",
                            optimizers.Adam(1e-3), mesh=mesh, seed=seed)
            x, y = wnd_records_at(seed, FULL_STEPS * SHARD_BATCH, cols)
            t0 = time.perf_counter()
            est._ensure_initialized(x)
            init_s = time.perf_counter() - t0
            res = _rank_train(ek, engine, est, x, y, FULL_STEPS)
            spec = est._sharded_table_specs()["wide_linear.table"]
            dense = sum(cols["wide_base_dims"] + cols["wide_cross_dims"]) \
                * 2 * 4
            check(spec.device_bytes <= dense / spec.shards + spec.dim * 4,
                  f"rank table bytes {spec.device_bytes} > dense/"
                  f"{spec.shards} + one row")
            local = SHARD_BATCH // SHARD_RANKS
            xb = [torch.from_numpy(a[rank * local:(rank + 1) * local])
                  .to(dev) for a in x]
            yb = torch.from_numpy(y[rank * local:(rank + 1) * local]).to(dev)
            est.model.train()

            def step():
                return est._train_step(xb, yb)

            step_ms = cuda_ms(step, FULL_TIMED, 2)
            # rank 0's trace; the others step alike (every step is
            # collective) without the profiler
            if rank == 0:
                prof = step_profile(step, calls=FULL_PROFILED, top=8)
            else:
                for _ in range(FULL_PROFILED + 1):
                    step()
                torch.cuda.synchronize()
                prof = None
            res.update({
                "init_s": init_s, "step_ms_events": step_ms,
                "samples_per_s_events": SHARD_BATCH / step_ms * 1e3,
                "profile": prof,
                "table_rows": spec.padded, "rows_per_shard":
                    spec.rows_per_shard,
                "rank_table_bytes": spec.device_bytes,
                "dense_table_bytes": dense,
                "sharded_table_bytes": sum(engine.table_bytes.values()),
                "specs": {k: (s.rows_per_shard, s.dim, s.vocab) for k, s in
                          est._sharded_table_specs().items()},
                "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)})
            out[job] = res
            del est, zoo
    return out


def run_ranks(device: str, jobs: list, seed: int, init_path: str) -> list:
    """Spawn ``SHARD_RANKS`` gloo ranks on ``device`` (all on one card, or
    the CPU) running ``jobs``; returns each rank's results, in rank
    order."""
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, port, device, jobs, seed, init_path,
                               queue))
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        got = {}
        for _ in procs:
            rank, res = queue.get(timeout=max(1.0, deadline
                                              - time.monotonic()))
            check("error" not in res, f"rank {rank} failed:\n"
                  f"{res.get('error')}")
            got[rank] = res
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    check(all(p.exitcode == 0 for p in procs),
          f"rank exit codes {[p.exitcode for p in procs]}")
    return [got[r] for r in range(SHARD_RANKS)]


def _per_step(launches: dict, steps: int) -> dict:
    return {k: v / steps for k, v in launches.items()}


def _padding_dropped(params: dict, like: dict) -> float:
    """Largest difference between ``like`` and ``params`` with each of
    ``params``' tables cut to ``like``'s rows."""
    worst = 0.0
    for layer, sub in like.items():
        for k, v in sub.items():
            got = params[layer][k][:v.shape[0]]
            check(got.shape == v.shape, f"{layer}.{k} {got.shape} vs "
                  f"{v.shape}")
            worst = max(worst, float(np.abs(got - v).max()))
    return worst


def _change_off(params: dict, like: dict, init: dict) -> float:
    """Largest difference between ``params``' change from ``init`` and
    ``like``'s, over its allowance: 1e-3 of ``like``'s change plus 8 f32
    spacings of the largest value (each run rounds a parameter once a step,
    four steps). A table row whose gradient was lost, or half lost, is off
    by all (half) of its change, which the values' check at 1e-5 misses
    for a row hit once (SGD(0.1) moves it about 0.1 x 0.5 / 8192 = 6e-6).
    Above 1 fails."""
    worst = 0.0
    for layer, sub in like.items():
        for k, v in sub.items():
            p0 = init[layer][k]
            got = params[layer][k][:v.shape[0]]
            err = np.abs((got - p0) - (v - p0))
            top = np.maximum(np.maximum(np.abs(p0), np.abs(v)), np.abs(got))
            tol = 1e-3 * np.abs(v - p0) + 8 * np.spacing(top)
            worst = max(worst, float((err / tol).max()))
    return worst


def phase_sharded_wnd(ek, seed: int, workdir: str):
    """Train Wide&Deep with vocab-sharded tables on ``SHARD_RANKS`` gloo
    ranks that share the card: at ``WND_COLUMNS`` held to the replicated
    card run and the same ranks on the CPU, then at full width (100M-bucket
    cross) timed; the replicated model at 1M buckets beside it. Returns
    (card ranks' results, stats)."""
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.estimator.estimator import params_tree
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras import optimizers
    from analytics_zoo_tpu_torch.models import WideAndDeep
    from analytics_zoo_tpu_torch.parallel import embedding as engine
    from analytics_zoo_tpu_torch.parallel.mesh import Mesh

    init = WideAndDeep("wide_n_deep", 2, hidden_layers=WND_HIDDEN,
                       **WND_COLUMNS).build(
        torch.Generator().manual_seed(seed), device="cpu").model.state_dict()
    init_path = os.path.join(workdir, "wnd_shard_init.pt")
    torch.save(init, init_path)

    # the replicated reference: one process on the card
    x, y = wnd_records(seed, SHARD_STEPS * SHARD_BATCH)
    ref_est = Estimator(
        WideAndDeep("wide_n_deep", 2, hidden_layers=WND_HIDDEN,
                    **WND_COLUMNS).build(device="cuda").model,
        "sparse_categorical_crossentropy", optimizers.SGD(0.1),
        device="cuda", seed=seed)
    ref_est.model.load_state_dict(init, strict=True)
    ref_hist = ref_est.train(FeatureSet.from_ndarrays(x, y),
                             batch_size=SHARD_BATCH, epochs=1)
    ref = ref_est.get_params()
    del ref_est

    t0 = time.perf_counter()
    card = run_ranks("cuda:0", ["correct", "full"], seed, init_path)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_ranks("cpu", ["correct"], seed, init_path)
    cpu_s = time.perf_counter() - t0

    got = card[0]["correct"]
    err_ref = _padding_dropped(got["params"], ref)
    check(err_ref <= 1e-5, f"sharded card params off the replicated card "
          f"run's by {err_ref}")
    np.testing.assert_allclose(got["loss"], ref_hist["loss_history"],
                               rtol=1e-5, atol=0)
    err_cpu = _padding_dropped(got["params"], cpu[0]["correct"]["params"])
    check(err_cpu <= 1e-5, f"sharded card params off the CPU ranks' by "
          f"{err_cpu}")
    init_tree = params_tree(init.items())
    change_ref = _change_off(got["params"], ref, init_tree)
    change_cpu = _change_off(got["params"], cpu[0]["correct"]["params"],
                             init_tree)
    check(max(change_ref, change_cpu) <= 1.0,
          f"sharded card params' change off the replicated run's by "
          f"{change_ref} and off the CPU ranks' by {change_cpu} of its "
          f"allowance")
    want_step = {"gather_rows": 3, "gather_pool": 0, "gather_int8": 0,
                 "scatter_rows": 3}
    for r, res in enumerate(card):
        for job, steps in (("correct", SHARD_STEPS), ("full", FULL_STEPS)):
            per = _per_step(res[job]["launches"], steps)
            check(per == want_step, f"rank {r} {job} launched {per} per "
                  f"step, expected {want_step}")
    for r, res in enumerate(cpu):
        check(not any(res["correct"]["launches"].values()),
              f"CPU rank {r} launched {res['correct']['launches']}")

    def cost(specs, steps):
        """Each table's ``exchange_cost_bytes`` for ``steps`` steps."""
        stub = Mesh(rank=0, size=SHARD_RANKS, axis="data", group=None,
                    backend="gloo", device=torch.device("cpu"))
        out = {"exchange": 0.0, "grad": 0.0}
        for key, (rps, dim, vocab) in specs.items():
            spec = engine.ShardSpec(stub, "data", SHARD_RANKS, rps, vocab,
                                    dim)
            n_ids = SHARD_BATCH * (3 if key == "wide_linear.table" else 1)
            c = engine.exchange_cost_bytes(spec, n_ids)
            out["exchange"] += c["forward_bytes"] * steps
            out["grad"] += c["grad_bytes"] * steps
        return out

    for job, steps in (("correct", SHARD_STEPS), ("full", FULL_STEPS)):
        want = cost(card[0][job]["specs"], steps)
        summed = {k: sum(res[job]["exchange_bytes"][k] for res in card)
                  for k in want}
        check(summed == want, f"{job}: ranks moved {summed} bytes, "
              f"exchange_cost_bytes gives {want}")

    # beside it: the replicated model at 1M buckets, one process
    cols = wnd_columns(REPLICATED_CROSS)
    rx, ry = wnd_records_at(seed, FULL_STEPS * SHARD_BATCH, cols)
    rep = Estimator(WideAndDeep("wide_n_deep", 2, hidden_layers=WND_HIDDEN,
                                **cols)._ensure_built(),
                    "sparse_categorical_crossentropy", optimizers.Adam(1e-3),
                    device="cuda", seed=seed)
    rep_train = _rank_train(ek, engine, rep, rx, ry, FULL_STEPS)
    xb = [torch.from_numpy(a[:SHARD_BATCH]).cuda() for a in rx]
    yb = torch.from_numpy(ry[:SHARD_BATCH]).cuda()
    rep_ms = cuda_ms(lambda: rep._train_step(xb, yb), FULL_TIMED, 2)
    rep_prof = step_profile(lambda: rep._train_step(xb, yb),
                            calls=FULL_PROFILED, top=8)
    del rep

    full = [res["full"] for res in card]
    stats = {
        "ranks": SHARD_RANKS, "backend": "gloo", "device": "cuda:0 (shared)",
        "correct": {
            "steps": SHARD_STEPS, "batch": SHARD_BATCH,
            "max_abs_err_params_vs_replicated_card": err_ref,
            "max_abs_err_params_vs_cpu_ranks": err_cpu,
            "change_off_replicated_card_of_allowance": change_ref,
            "change_off_cpu_ranks_of_allowance": change_cpu,
            "loss_first": float(got["loss"][0]),
            "loss_last": float(got["loss"][-1]),
            "launches_per_step_per_rank": _per_step(got["launches"],
                                                    SHARD_STEPS),
            "exchange_bytes_per_step": {
                k: sum(r["correct"]["exchange_bytes"][k] for r in card)
                / SHARD_STEPS for k in ("exchange", "grad")}},
        "full": {
            "cross_buckets": FULL_CROSS, "steps": FULL_STEPS,
            "batch": SHARD_BATCH, "table_rows": full[0]["table_rows"],
            "rows_per_shard": full[0]["rows_per_shard"],
            "rank_table_bytes": full[0]["rank_table_bytes"],
            "dense_table_bytes": full[0]["dense_table_bytes"],
            "sharded_table_bytes": full[0]["sharded_table_bytes"],
            "init_s": [r["init_s"] for r in full],
            "fit_wall_s": [r["wall_s"] for r in full],
            "fit_samples_per_s": [FULL_STEPS * SHARD_BATCH / r["wall_s"]
                                  for r in full],
            "step_ms_events": [r["step_ms_events"] for r in full],
            "samples_per_s_events": [r["samples_per_s_events"]
                                     for r in full],
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in full],
            "exchange_bytes_per_step": {
                k: sum(r["exchange_bytes"][k] for r in full) / FULL_STEPS
                for k in ("exchange", "grad")},
            "loss_first": float(full[0]["loss"][0]),
            "loss_last": float(full[0]["loss"][-1]),
            "launches_per_step_per_rank": _per_step(full[0]["launches"],
                                                    FULL_STEPS),
            "rank0_step_profile": full[0]["profile"]},
        "replicated_1m": {
            "cross_buckets": REPLICATED_CROSS, "steps": FULL_STEPS,
            "fit_wall_s": rep_train["wall_s"],
            "fit_samples_per_s": FULL_STEPS * SHARD_BATCH
            / rep_train["wall_s"],
            "step_ms_events": rep_ms,
            "samples_per_s_events": SHARD_BATCH / rep_ms * 1e3,
            "step_profile": rep_prof,
            "launches_per_step": _per_step(rep_train["launches"],
                                           FULL_STEPS)},
        "card_ranks_s": card_s, "cpu_ranks_s": cpu_s}
    return card, stats


def phase_int8_wnd(ek, seed: int, workdir: str):
    """Weight-only int8 Wide&Deep (``WND_COLUMNS``) predicted on the card
    and on the CPU from the same saved model; returns stats."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import WideAndDeep

    path = os.path.join(workdir, "wnd_int8")
    WideAndDeep("wide_n_deep", 2, hidden_layers=WND_HIDDEN,
                **WND_COLUMNS).build(torch.Generator().manual_seed(seed),
                                     device="cpu").save_model(path)
    x, _ = wnd_records(seed + 3, INT8_WND_RECORDS)
    card = InferenceModel(device="cuda").load_zoo(path).quantize("int8")
    cpu = InferenceModel(device="cpu").load_zoo(path).quantize("int8")
    ek.reset_launch_counts()
    got = card.predict(x, batch_size=SHARD_BATCH)
    launches = _launches(ek)
    want = cpu.predict(x, batch_size=SHARD_BATCH)
    err = float(np.abs(got - want).max())
    check(got.shape == (INT8_WND_RECORDS, 2) and np.isfinite(got).all(),
          "int8 Wide&Deep predictions malformed")
    check(err <= 1e-5, f"int8 Wide&Deep card off the CPU by {err}")
    batches = -(-INT8_WND_RECORDS // SHARD_BATCH)
    want_launches = {"gather_rows": 0, "gather_pool": batches,
                     "gather_int8": 2 * batches, "scatter_rows": 0}
    check(launches == want_launches, f"int8 Wide&Deep launched {launches}, "
          f"expected {want_launches}")
    return {"records": INT8_WND_RECORDS, "max_abs_err_vs_cpu": err,
            "launches": launches}


def attention_bound_ms(b, h, s, d, dtype, backward: bool, bias=True,
                       causal=False, peak=None) -> tuple:
    """Least time for B7 (or B8) at these shapes, and what bounds it: the
    larger of the bytes each input read once and each output written once
    take at the memory rate and the products' operations at ``peak``
    (FLOP/s; the dtype's ``PEAK_FLOPS`` by default), over the (row, col)
    pairs the causal mask leaves. B7: q, k, v and the [b, s] f32 bias in, o
    out; 4·d operations a pair (q·kᵀ, p·v). B8: q, k, v, dO and the bias
    in, dq, dk, dv out; 10·d a pair (q·kᵀ again, dO·vᵀ, pdᵀ·dO, ds·k,
    dsᵀ·q). What a design passes from B7 to B8 (the row statistics, the
    output for D) is its own bytes, not the function's: not counted."""
    size = torch.tensor([], dtype=dtype).element_size()
    tile = b * h * s * d * size
    bytes_ = (7 if backward else 4) * tile + (4 * b * s if bias else 0)
    pairs = flash_pairs(s, s, causal)
    flops = (10 if backward else 4) * b * h * pairs * d
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
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


def _fused_pair(at, q, k, v, do, args):
    """B7 then B8 as ``_FusedShort`` runs them: the forward saves the rows'
    softmax statistics, which the backward reads (the f32 route also its
    output, for D)."""
    o, stats = at.fused_short_fwd(q, k, v, *args)
    return o, at.fused_short_bwd(q, k, v, do, *args, stats, o), stats


def _attn_timing(at, q, k, v, do, args, library_fwd, library_fwd_bwd):
    """CUDA-event (and profiler) times of B7, B8, their plain versions and
    the library's call, and B7's and B8's errors against the plain
    versions on the same inputs (the backward from the statistics and
    output B7 saved)."""
    kb, seed_t, scale, rate, causal = args
    o, _, stats = _fused_pair(at, q, k, v, do, args)
    fns = {
        "fwd_ms": lambda: at.fused_short_fwd(q, k, v, *args),
        "bwd_ms": lambda: at.fused_short_bwd(q, k, v, do, *args, stats, o),
        "plain_fwd_ms": lambda: at.fused_short_attention_plain(
            q, k, v, kb, scale, rate, seed_t, causal, with_stats=True),
        "plain_bwd_ms": lambda: at.fused_short_bwd_plain(
            q, k, v, do, kb, scale, rate, seed_t, causal),
        "library_fwd_ms": library_fwd,
        "library_fwd_bwd_ms": library_fwd_bwd,
    }
    t = {}
    for key, fn in fns.items():
        t[key] = cuda_ms(fn, 20)
        t[key.replace("ms", "device_ms")] = device_ms(fn, calls=5)
    want, want_stats = at.fused_short_attention_plain(
        q, k, v, kb, scale, rate, seed_t, causal, with_stats=True)
    got, grads, _ = _fused_pair(at, q, k, v, do, args)
    t["fwd_max_abs_err"] = float((got.float() - want.float()).abs().max())
    t["fwd_rel_err"] = _rel_err(got, want)
    t["stats_max_rel_err"] = float(((stats - want_stats).abs()
                                    / want_stats.abs().clamp_min(1.0)).max())
    plain = at.fused_short_bwd_plain(q, k, v, do, kb, scale, rate, seed_t,
                                     causal)
    t["bwd_max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(grads, plain))
    t["bwd_rel_err"] = max(_rel_err(a, b) for a, b in zip(grads, plain))
    for key in ("fwd", "bwd"):
        check(t[f"{key}_rel_err"] <= ATTN_ATOL[q.dtype],
              f"{'B7' if key == 'fwd' else 'B8'} != plain by "
              f"{t[f'{key}_rel_err']} at {tuple(q.shape)} {q.dtype}, "
              f"rate {rate}")
    return t


def phase_attention_kernels(at, dev, seed: int):
    """Hold B7 and B8 against their plain versions (autograd through the
    plain forward for B8) over the grid, through both routes (bf16 on the
    tensor cores, f32 on the CUDA cores), check the dropout mask bit for
    bit and its kept share in both, then time both routes: bf16 at the
    BERT-base shape, f32 at the LM's prefill through B7, beside the plain
    versions and ``scaled_dot_product_attention``; returns timings."""
    gen = torch.Generator().manual_seed(seed)
    seed_t = torch.tensor([seed + 17], dtype=torch.int32, device=dev)
    errors = {"fwd": 0.0, "bwd": 0.0, "fwd_bf16": 0.0, "bwd_bf16": 0.0}
    cases = 0
    for s in ATTN_SEQS:
        for d in ATTN_DIMS:
            for dtype in (torch.float32, torch.bfloat16):
                route = at.fused_short_route(dtype)
                q, k, v, do, mask = _attn_case(dev, 2, 3, s, d, dtype, gen)
                mask[-1] = 0  # a row of all-masked keys
                bias = ((1.0 - mask) * -1e9).to(dev)
                for kb in (None, bias):
                    for causal in (False, True):
                        for rate in (0.0, 0.1):
                            args = (kb, seed_t, 0.125, rate, causal)
                            before = dict(at.route_counts)
                            o, grads, stats = _fused_pair(at, q, k, v, do,
                                                          args)
                            check(at.route_counts[route]
                                  == before[route] + 2, f"{dtype} took "
                                  f"{dict(at.route_counts)}, not {route}")
                            again = at.fused_short_fwd(q, k, v, *args)
                            check(torch.equal(o, again[0])
                                  and torch.equal(stats, again[1]),
                                  "B7 not bit-equal twice")
                            again = at.fused_short_bwd(q, k, v, do, *args,
                                                       stats, o)
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
                            tag = "_bf16" if dtype == torch.bfloat16 else ""
                            errors["fwd" + tag] = max(errors["fwd" + tag], e)
                            errors["bwd" + tag] = max(errors["bwd" + tag],
                                                      e_b)
                            cases += 1
    log(f"B7/B8 within f32 2e-5, bf16 2e-2 (relative to the output's scale) "
        f"of their plain versions on {cases} cases, each dtype by its own "
        f"route, bit-equal when repeated; largest errors "
        f"{json.dumps(errors)}")
    for route, (where, before) in (("bf16", ATTN_GRID_ERRORS_5CFB824),
                                   ("f32", ATTN_GRID_ERRORS_F32_TC)):
        keys = ("fwd_bf16", "bwd_bf16") if route == "bf16" else ("fwd",
                                                                 "bwd")
        got = {k: errors[k] for k in keys}
        want = {k: before[k] for k in keys}
        if seed == 0 and where == (torch.cuda.get_device_name(0),
                                   torch.__version__):
            check(got == want, f"B7/B8's {route} grid errors {got} differ "
                  f"from the recorded {want}")
            log(f"B7/B8's {route} grid errors equal the recorded ones bit "
                f"for bit")
        else:
            log(f"B7/B8's {route} grid errors not compared (recorded at "
                f"seed 0 on {where})")

    # the mask: q = k = 0 makes p = 1/s; v = dO = I reads pd back out of o
    # and dv, so the kernels' mask is o != 0 (and dvᵀ != 0); 1/(s·0.9)
    # is far from 0 in bf16 too
    b, h, s = BERT_BATCH, BERT_CFG["n_head"], BERT_SEQ
    want = at.dropout_keep_mask(seed_t, b * h, s, 0.1).reshape(b, h, s, s)
    for dtype in (torch.float32, torch.bfloat16):
        zeros = torch.zeros(b, h, s, s, device=dev, dtype=dtype)
        eye = torch.eye(s, device=dev, dtype=dtype).expand(
            b, h, s, s).contiguous()
        o, (_, _, dv), _ = _fused_pair(at, zeros, zeros, eye, eye,
                                       (None, seed_t, 1.0, 0.1, False))
        check(torch.equal(o != 0, want),
              f"B7's {dtype} dropout mask != dropout_keep_mask")
        check(torch.equal(dv.transpose(-1, -2) != 0, want),
              f"B8's {dtype} dropout mask != dropout_keep_mask")
        del zeros, eye, o, dv
    kept = float(want.float().mean())
    sigma = math.sqrt(0.1 * 0.9 / want.numel())
    check(abs(kept - 0.9) <= 4 * sigma, f"kept share {kept} is more than "
          f"4 sigma ({sigma}) from 0.9")
    mask_stats = {"entries": want.numel(), "kept_share": kept,
                  "sigma": sigma, "dtypes": ["f32", "bf16"]}
    log("B7/B8 dropout masks == dropout_keep_mask bit for bit " +
        json.dumps(mask_stats))
    del want

    # the bf16 route at the BERT-base shape, padding bias
    d = BERT_CFG["hidden_size"] // h
    q, k, v, do, mask = _attn_case(dev, b, h, s, d, torch.bfloat16, gen)
    kb = ((1.0 - mask) * -1e9).to(dev)
    sdpa_mask = kb[:, None, None, :].to(torch.bfloat16)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {"shape": {"b": b, "h": h, "s": s, "d": d, "dtype": "bf16"},
               "mask": mask_stats, "errors": errors, "cases": cases}
    for rate in (0.0, 0.1):
        def sdpa_fwd_bwd():
            sdpa(*leaves, attn_mask=sdpa_mask, dropout_p=rate).backward(do)

        t = _attn_timing(
            at, q, k, v, do, (kb, seed_t, 1.0 / math.sqrt(d), rate, False),
            lambda: sdpa(q, k, v, attn_mask=sdpa_mask, dropout_p=rate),
            sdpa_fwd_bwd)
        timings[f"rate_{rate}"] = t
        log(f"attention timing bf16 rate {rate} " + json.dumps(t))
    for bwd in (False, True):
        bound, by = attention_bound_ms(b, h, s, d, torch.bfloat16, bwd)
        timings["bwd_bound" if bwd else "fwd_bound"] = [bound, by]
    del q, k, v, do, leaves
    timings["f32"] = f32_attention_timings(at, dev, gen, seed_t)
    return timings


def f32_attention_timings(at, dev, gen, seed_t) -> dict:
    """Time B7 and B8's f32 route at each shape of ``ATTN_F32_TIMED`` (CUDA
    events and the profiler's device time) beside their plain versions and
    ``scaled_dot_product_attention`` in f32 with the same mask and
    dropout, held to the plain versions within ``ATTN_ATOL``; each bound at
    the 3xTF32 rate (``bound``) and at the CUDA cores' f32 rate
    (``bound_simt``). Returns the timings by label."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for label, (b, h, s, d), bias, rate, causal in ATTN_F32_TIMED:
        q, k, v, do, mask = _attn_case(dev, b, h, s, d, torch.float32, gen)
        kb = ((1.0 - mask) * -1e9).to(dev) if bias else None
        kw = dict(attn_mask=None if kb is None else kb[:, None, None, :],
                  dropout_p=rate, is_causal=causal)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        t = _attn_timing(
            at, q, k, v, do, (kb, seed_t, 1.0 / math.sqrt(d), rate, causal),
            lambda: sdpa(q, k, v, **kw),
            lambda: sdpa(*leaves, **kw).backward(do))
        for key, bwd in (("fwd", False), ("bwd", True)):
            for tag, peak in (("", PEAK_FLOPS_3XTF32),
                              ("_simt", PEAK_FLOPS[torch.float32])):
                t[f"{key}_bound{tag}"] = list(attention_bound_ms(
                    b, h, s, d, torch.float32, bwd, bias=bias,
                    causal=causal, peak=peak))
        t["shape"] = {"b": b, "h": h, "s": s, "d": d, "dtype": "f32",
                      "bias": bias, "dropout": rate, "causal": causal}
        out[label] = t
        log(f"attention timing f32 {label} " + json.dumps(t))
        del q, k, v, do, leaves
    return out


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
                        "routes": dict(at.route_counts),
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
        want = blocks * k * (2 if backward else 1)
        check(counts[name]["routes"] == {"bf16_tc": want, "f32_tc": 0},
              f"{name} took the routes {counts[name]['routes']}, expected "
              f"{want} bf16_tc")
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


def record_grads(opt) -> list:
    """Wrap ``opt.step`` so each step's gradients are kept (on the host);
    returns the list they are appended to."""
    seen = []

    def recording(params, grads, state, step=opt.step):
        seen.append({k: g.detach().cpu() for k, g in grads.items()})
        step(params, grads, state)

    opt.step = recording
    return seen


def hold_adam_params(w_dev, w_cpu, g_dev, g_cpu, lr: float):
    """Hold the card's parameters after Adam steps to the CPU's: within
    atol 1e-5 where Adam had the CPU's gradient within ``GRAD_SAME``
    (relative) at every step, else within ``2·lr`` a step (Adam moves a
    parameter by about ``lr·sign(g)`` whatever ``|g|``, so where rounding
    decides a gradient's sign the runs part by up to that). Returns
    ``((largest held error, its parameter), elements held to 2·lr, their
    largest error)``."""
    steps = len(g_cpu)
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
    return held_err, free, free_err


def phase_bert_vs_cpu(at, seed: int):
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
        at.reset_launch_counts()
        probs = clf.predict(tokens, batch_size=batch, device=dev)
        opt = clf.model.get_estimator().optimizer
        seen = record_grads(opt)
        hist = clf.fit(tokens, y, batch_size=batch, epochs=1)
        if dev == "cuda":
            launches = {**at.launch_counts, "routes": dict(at.route_counts)}
        runs[dev] = (probs, seen, hist["loss_history"],
                     {k: v.detach().cpu()
                      for k, v in clf.model.state_dict().items()})
        lr = opt.learning_rate
    (p_dev, g_dev, l_dev, w_dev), (p_cpu, g_cpu, l_cpu, w_cpu) = (
        runs["cuda"], runs["cpu"])
    probs_err = float(np.abs(p_dev - p_cpu).max())
    check(probs_err <= 1e-5, f"card probabilities differ by {probs_err}")
    fused = launches["fused_short_fwd"] + launches["fused_short_bwd"]
    check(launches["fused_short_bwd"] > 0 and launches["routes"] == {
        "bf16_tc": 0, "f32_tc": fused}, f"the f32 card run launched "
        f"{launches}, not the f32 route alone")
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
    held_err, free, free_err = hold_adam_params(w_dev, w_cpu, g_dev, g_cpu,
                                                lr)
    return {"records": n, "batch": batch, "seq": seq, "adam_steps": steps,
            "launches": launches,
            "lr": lr, "max_abs_err_probs": probs_err,
            "max_rel_l2_err_grad": grad_rel, "worst_grad": worst,
            "max_rel_err_loss": float(np.max(np.abs(
                np.asarray(l_dev) - l_cpu) / np.abs(l_cpu))),
            "max_abs_err_params": held_err[0], "worst_param": held_err[1],
            "params": sum(v.numel() for v in w_cpu.values()),
            "params_other_gradient": free,
            "max_abs_err_params_other_gradient": free_err}


def flash_pairs(sq: int, skv: int, causal: bool) -> int:
    """(row, col) pairs a flash call computes: all of them, or those on and
    below the top-left diagonal."""
    if not causal:
        return sq * skv
    rows = np.arange(sq)
    return int(np.minimum(rows + 1, skv).sum())


def flash_bound_ms(b, h, sq, skv, d, dtype, kind: str, causal=True,
                   peak=None):
    """Least time for a flash kernel at these shapes, and what bounds it:
    the larger of the bytes each input read once and each output written
    once take at the memory rate and the operations at ``peak`` (FLOP/s;
    the dtype's ``PEAK_FLOPS`` by default), counting only the (row, col)
    pairs the causal mask leaves. ``fwd``
    (B4): q, k, v in, o and the f32 lse out, 4·d operations a pair (q·kᵀ,
    p·v). ``bwd`` (the backward function, one-pass count, whichever design
    runs): q, k, v, dO, lse, D in, dq, dk, dv out, 10·d a pair. ``dq``
    (B5a): q, k, v, dO, lse, D in, dq out, 6·d a pair (q·kᵀ, dO·vᵀ, ds·k).
    ``dkv`` (B5b): q, k, v, dO, lse, D in, dk, dv out, 8·d a pair (q·kᵀ,
    dO·vᵀ, pᵀ·dO, dsᵀ·q)."""
    size = torch.tensor([], dtype=dtype).element_size()
    qt, kt = b * h * sq * d * size, b * h * skv * d * size
    rows = 4 * b * h * sq
    bytes_, per_pair = {
        "fwd": (2 * qt + 2 * kt + rows, 4),
        "bwd": (3 * qt + 3 * kt + 2 * rows, 10),
        "dq": (3 * qt + 2 * kt + 2 * rows, 6),
        "dkv": (2 * qt + 4 * kt + 2 * rows, 8)}[kind]
    flops = per_pair * b * h * d * flash_pairs(sq, skv, causal)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _flash_case(dev, sq, skv, d, dtype, gen, b=1, h=2):
    q, do = (torch.randn(b, h, sq, d, generator=gen).to(dtype).to(dev)
             for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, generator=gen).to(dtype).to(dev)
            for _ in range(2))
    glse = torch.randn(b, h, sq, generator=gen).to(dev)
    bias = ((torch.rand(b, skv, generator=gen) < 0.2).float() * -1e9).to(dev)
    return q, k, v, do, glse, bias


def _rel_l2(got, want, norm=None) -> float:
    """``‖got − want‖ / ‖want‖`` over the whole tensor (``norm`` in place
    of ``‖want‖`` where given): small entries weigh as much as the large
    ones, so a wrong or missing tile shows though its values are small."""
    err = float((got.float() - want.float()).norm())
    return err / max(float(want.float().norm()) if norm is None else norm,
                     1e-30)


def _grads_errs(got, want, one_key_no_glse: bool):
    """Two errors of ``(dq, dk, dv)`` against the reference: the largest
    absolute error over the three gradients' joint scale (the largest
    reference gradient, at least 1), and the largest relative L2 error of
    each gradient over its own norm. Over a single key with no lse
    cotangent, dq and dk are zero in exact arithmetic (``ds = p·(dp − D)``
    with ``p = 1`` and ``D = dp``), so they are rounding of dp and D alone
    and take the joint norm."""
    scale = max([1.0] + [float(w.float().abs().max()) for w in want])
    joint = float(sum(w.float().norm() ** 2 for w in want)) ** 0.5
    abs_err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want)) / scale
    l2 = max(_rel_l2(g, w, joint if one_key_no_glse and i < 2 else None)
             for i, (g, w) in enumerate(zip(got, want)))
    return abs_err, l2


#: the route each flash kernel must count on, written out here so that the
#: route checks hold the wrappers' table (``at.flash_route``) to it: bf16
#: on the tensor cores, f32 on the tensor cores as 3xTF32
FLASH_ROUTES = {
    torch.bfloat16: {"flash_fwd": "bf16_tc", "flash_bwd_dq": "bf16_tc",
                     "flash_bwd_dkv": "bf16_tc", "flash_bwd_fused": "bf16_tc"},
    torch.float32: {"flash_fwd": "f32_tc", "flash_bwd_dq": "f32_tc",
                    "flash_bwd_dkv": "f32_tc", "flash_bwd_fused": "f32_tc"}}


def flash_routes_of(at, dtype, launches: dict) -> dict:
    """The flash route counts that these flash launches (by kernel name)
    of ``dtype`` must make, every route named, by ``FLASH_ROUTES``."""
    routes = {r: 0 for r in at.flash_route_counts}
    for kernel, n in launches.items():
        if kernel in at.flash_launch_counts:
            routes[FLASH_ROUTES[dtype][kernel]] += n
    return routes


def phase_flash_kernels(at, dev, seed: int):
    """Hold B4 (bias or not, causal or not), B5a + B5b and B6 (lse
    cotangent or not) against their plain versions over the grid, each
    call on its route, check that the backward takes B6 at the
    LM's shape and at bench_longseq's headline and B5a + B5b at the LM's
    long-context shape and at 8192 keys in bf16, then time all four at the
    timed shapes beside their plain versions and
    ``scaled_dot_product_attention``; returns (timings, errors)."""
    gen = torch.Generator().manual_seed(seed)
    errors = {f"{key}_{name}": 0.0 for name in ("f32", "bf16")
              for key in ("fwd", "bwd_two_pass", "bwd_fused", "lse")}
    worst = {}  # the case of each largest error

    def record(key, e, case):
        if e > errors[key]:
            errors[key], worst[key] = e, case

    grid = [(sq, skv, d, dtype) for sq, skv in FLASH_LENGTHS
            for dtype, dims in FLASH_DIMS.items() for d in dims]
    cases = 0
    for sq, skv, d, dtype in grid:
        q, k, v, do, glse, bias = _flash_case(dev, sq, skv, d, dtype, gen)
        scale = d ** -0.5
        tol = ATTN_ATOL[dtype]
        tag = "f32" if dtype == torch.float32 else "bf16"
        routes = dict(at.flash_route_counts)
        for causal in (False, True):
            case = f"{sq}x{skv} d={d} {dtype} causal={causal}"
            for kb in (None, bias):
                o, lse = at.flash_fwd(q, k, v, kb, scale, causal)
                want_o, want_lse = at.flash_fwd_plain(
                    q, k, v, kb, scale, causal)
                e = max(_rel_err(o, want_o), _rel_l2(o, want_o))
                e_l = max(_rel_err(lse, want_lse), _rel_l2(lse, want_lse))
                check(e <= tol and e_l <= ATTN_ATOL[torch.float32],
                      f"B4 != plain by {e} (lse {e_l}) at {case} "
                      f"bias={kb is not None}")
                where = f"{case} bias={kb is not None}"
                record(f"fwd_{tag}", e, where)
                record(f"lse_{tag}", e_l, where)
            o, lse = at.flash_fwd_plain(q, k, v, None, scale, causal)
            delta = (do.float() * o.float()).sum(-1)
            for gl in (None, glse):
                args = (q, k, v, do, lse, delta, gl, scale, causal)
                want = at.flash_bwd_fused_plain(*args)
                two = (at.flash_bwd_dq(*args),) + at.flash_bwd_dkv(*args)
                two_again = (at.flash_bwd_dq(*args),) \
                    + at.flash_bwd_dkv(*args)
                fused = at.flash_bwd_fused(*args)
                again = at.flash_bwd_fused(*args)
                torch.cuda.synchronize()
                check(torch.equal(fused[1], again[1])
                      and torch.equal(fused[2], again[2]),
                      f"B6's dk, dv not bit-equal twice at {case}")
                check(all(torch.equal(a, b) for a, b in zip(two, two_again)),
                      f"B5a's dq, B5b's dk, dv not bit-equal twice at {case}")
                for key, got in (("bwd_two_pass", two),
                                 ("bwd_fused", fused)):
                    e = max(_grads_errs(got, want, skv == 1 and gl is None))
                    check(e <= tol, f"{key} != plain by {e} at {case} "
                          f"glse={gl is not None}")
                    record(f"{key}_{tag}", e,
                           f"{case} glse={gl is not None}")
        # per causal: two B4 calls, and four each of B5a, B5b and B6
        for route, n in flash_routes_of(at, dtype, {
                "flash_fwd": 4, "flash_bwd_dq": 8, "flash_bwd_dkv": 8,
                "flash_bwd_fused": 8}).items():
            routes[route] += n
        check(dict(at.flash_route_counts) == routes,
              f"{dtype} took {dict(at.flash_route_counts)}, not {routes}")
        cases += 1
    log(f"flash kernels within f32 2e-5, bf16 2e-2 of their plain versions "
        f"(of the scale and in relative L2) on {cases} cases (each: B4 with "
        f"and without a bias, B5a + B5b and B6 with and without glse, every "
        f"call on its route, B5a + B5b's dq, dk, dv and B6's dk, dv "
        f"bit-equal twice); largest errors " + json.dumps(errors)
        + ", at " + json.dumps(worst))

    many = phase_flash_many_blocks(at, dev, seed)
    log("f32 B4, B5a, B5b and B6 at grids of at least eight blocks an SM "
        "within 2e-5 of their plain versions: " + json.dumps(many))

    # dispatch by the resident-bytes rule: in f32 the LM's 2048 keys take
    # B6 and 4096 keys B5a + B5b; in bf16 4096 keys B6, 8192 B5a + B5b
    for shape, dtype, fused in (
            ((8, 16, 2048, 128), torch.float32, True),
            ((2, 16, 4096, 128), torch.float32, False),
            ((1, 2, 4096, 128), torch.bfloat16, True),
            ((1, 2, 8192, 128), torch.bfloat16, False)):
        leaves = [torch.randn(shape, device=dev).to(dtype).requires_grad_()
                  for _ in range(3)]
        at.reset_launch_counts()
        at.flash_attention(*leaves, causal=True).backward(
            torch.randn(shape, device=dev).to(dtype))
        torch.cuda.synchronize()
        want = {"flash_fwd": 1, "flash_bwd_dq": 0 if fused else 1,
                "flash_bwd_dkv": 0 if fused else 1,
                "flash_bwd_fused": 1 if fused else 0}
        want_routes = flash_routes_of(at, dtype, want)
        check(dict(at.flash_launch_counts) == want
              and dict(at.flash_route_counts) == want_routes,
              f"backward at {shape} {dtype} launched "
              f"{dict(at.flash_launch_counts)} "
              f"({dict(at.flash_route_counts)}), expected {want} "
              f"({want_routes})")
        del leaves
    log("flash dispatch: [8, 16, 2048, 128] f32 -> B6, [2, 16, 4096, 128] "
        "f32 -> B5a + B5b, [1, 2, 4096, 128] bf16 -> B6, [1, 2, 8192, 128] "
        "bf16 -> B5a + B5b, each kernel on its route")

    return {"cases": cases, "errors": errors, "many_blocks": many,
            **flash_timings(at, dev, FLASH_TIMED)}


def many_blocks_batch(dev, rows: int, h: int) -> int:
    """The least batch whose ``b·h·ceil(rows / 64)`` blocks make at least
    eight an SM of this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return -(-8 * sms // (h * -(-rows // 64)))


def phase_flash_many_blocks(at, dev, seed: int) -> dict:
    """f32 B4 (bias or not), B5a, B5b and B6 (lse cotangent or not), causal
    or not, at ``FLASH_MANY_LENGTHS`` x ``FLASH_DIMS[f32]`` and a batch that
    gives each kernel's grid at least eight blocks an SM, against their
    plain versions within 2e-5 of the scale and in relative L2, each launch
    on ``f32_tc``; returns the cases and largest errors with where each
    occurred."""
    h, tol = FLASH_MANY_HEADS, ATTN_ATOL[torch.float32]
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    errors = {"fwd": 0.0, "lse": 0.0, "dq": 0.0, "dkv": 0.0, "fused": 0.0}
    worst, cases = {}, 0

    def record(key, e, case):
        if e > errors[key]:
            errors[key], worst[key] = e, case

    def draw(b, rows, d):
        return torch.randn(b, h, rows, d, generator=gen, device=dev)

    for sq, skv in FLASH_MANY_LENGTHS:
        for d in FLASH_DIMS[torch.float32]:
            scale = d ** -0.5
            b = many_blocks_batch(dev, sq, h)  # B4, B5a: 64 queries a block
            q, do = draw(b, sq, d), draw(b, sq, d)
            k, v = draw(b, skv, d), draw(b, skv, d)
            glse = torch.randn(b, h, sq, generator=gen, device=dev)
            bias = (torch.rand(b, skv, generator=gen, device=dev)
                    < 0.2).float() * -1e9
            for causal in (False, True):
                for kb in (None, bias):
                    case = (f"{sq}x{skv} d={d} b={b} causal={causal} "
                            f"bias={kb is not None}")
                    before = at.flash_route_counts["f32_tc"]
                    o, lse = at.flash_fwd(q, k, v, kb, scale, causal)
                    check(at.flash_route_counts["f32_tc"] == before + 1,
                          f"B4 not on f32_tc at {case}")
                    want_o, want_lse = at.flash_fwd_plain(q, k, v, kb,
                                                          scale, causal)
                    e = max(_rel_err(o, want_o), _rel_l2(o, want_o))
                    e_l = max(_rel_err(lse, want_lse),
                              _rel_l2(lse, want_lse))
                    check(e <= tol and e_l <= tol,
                          f"B4 != plain by {e} (lse {e_l}) at {case}")
                    record("fwd", e, case)
                    record("lse", e_l, case)
                o, lse = at.flash_fwd_plain(q, k, v, None, scale, causal)
                delta = (do * o).sum(-1)
                for gl in (None, glse):
                    case = (f"{sq}x{skv} d={d} b={b} causal={causal} "
                            f"glse={gl is not None}")
                    args = (q, k, v, do, lse, delta, gl, scale, causal)
                    before = at.flash_route_counts["f32_tc"]
                    dq = at.flash_bwd_dq(*args)
                    check(at.flash_route_counts["f32_tc"] == before + 1,
                          f"B5a not on f32_tc at {case}")
                    # beside the plain dk and dv: one key with no lse
                    # cotangent leaves dq rounding alone, held to the three
                    # gradients' joint norm (_grads_errs)
                    want = at.flash_bwd_fused_plain(*args)
                    e = max(_grads_errs((dq,) + want[1:], want,
                                        skv == 1 and gl is None))
                    check(e <= tol, f"B5a != plain by {e} at {case}")
                    record("dq", e, case)
            del q, k, v, do, glse, o, lse, delta, want_o, want_lse, dq, want
            b = many_blocks_batch(dev, skv, h)  # B5b, B6: 64 keys a block
            q, do = draw(b, sq, d), draw(b, sq, d)
            k, v = draw(b, skv, d), draw(b, skv, d)
            glse = torch.randn(b, h, sq, generator=gen, device=dev)
            for causal in (False, True):
                o, lse = at.flash_fwd_plain(q, k, v, None, scale, causal)
                delta = (do * o).sum(-1)
                for gl in (None, glse):
                    case = (f"{sq}x{skv} d={d} b={b} causal={causal} "
                            f"glse={gl is not None}")
                    args = (q, k, v, do, lse, delta, gl, scale, causal)
                    before = at.flash_route_counts["f32_tc"]
                    got = at.flash_bwd_dkv(*args)
                    check(at.flash_route_counts["f32_tc"] == before + 1,
                          f"B5b not on f32_tc at {case}")
                    # one key with no lse cotangent: dk is rounding alone,
                    # held to the joint norm (_grads_errs)
                    e = max(_grads_errs(got, at.flash_bwd_dkv_plain(*args),
                                        skv == 1 and gl is None))
                    check(e <= tol, f"B5b != plain by {e} at {case}")
                    record("dkv", e, case)
                    before = at.flash_route_counts["f32_tc"]
                    got = at.flash_bwd_fused(*args)
                    check(at.flash_route_counts["f32_tc"] == before + 1,
                          f"B6 not on f32_tc at {case}")
                    e = max(_grads_errs(got, at.flash_bwd_fused_plain(*args),
                                        skv == 1 and gl is None))
                    check(e <= tol, f"B6 != plain by {e} at {case}")
                    record("fused", e, case)
            del q, k, v, do, glse, o, lse, delta, got
            torch.cuda.empty_cache()
            cases += 1
    return {"cases": cases, "heads": h, "errors": errors, "worst": worst}


def flash_timings(at, dev, timed) -> dict:
    """Time B4, B5a, B5b and B6 at each ``(label, [b, h, s, d], dtype)`` of
    ``timed``, causal (CUDA events and the profiler's device time), beside
    their plain versions and ``scaled_dot_product_attention(is_causal=
    True)``, each held to its plain version within ``ATTN_ATOL`` of the
    scale and in relative L2; returns the timings by label."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for label, (b, h, s, d), dtype in timed:
        q, k, v, do = (torch.randn(b, h, s, d, device=dev).to(dtype)
                       for _ in range(4))
        scale = d ** -0.5
        o, lse = at.flash_fwd(q, k, v, None, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, None, scale, True)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd():
            sdpa(*leaves, is_causal=True).backward(do)

        fns = {
            "fwd_ms": lambda: at.flash_fwd(q, k, v, None, scale, True),
            "dq_ms": lambda: at.flash_bwd_dq(*args),
            "dkv_ms": lambda: at.flash_bwd_dkv(*args),
            "fused_ms": lambda: at.flash_bwd_fused(*args),
            "plain_fwd_ms": lambda: at.flash_fwd_plain(q, k, v, None, scale,
                                                       True),
            "plain_dq_ms": lambda: at.flash_bwd_dq_plain(*args),
            "plain_dkv_ms": lambda: at.flash_bwd_dkv_plain(*args),
            "plain_fused_ms": lambda: at.flash_bwd_fused_plain(*args),
            "library_fwd_ms": lambda: sdpa(q, k, v, is_causal=True),
            "library_fwd_bwd_ms": sdpa_fwd_bwd,
        }
        t = {"shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1],
             "causal": True,
             "backward_design": "B6" if at.fused_bwd_applicable(
                 s, d, q.element_size()) else "B5a+B5b"}
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, 3, warmup=1)
            t[key.replace("ms", "device_ms")] = device_ms(fn, calls=2)
        want_o, want_lse = at.flash_fwd_plain(q, k, v, None, scale, True)
        got_o, got_lse = at.flash_fwd(q, k, v, None, scale, True)
        t["fwd_max_abs_err"] = float((got_o.float() - want_o.float()).abs()
                                     .max())
        t["fwd_rel_err"] = _rel_err(got_o, want_o)
        t["fwd_rel_l2_err"] = _rel_l2(got_o, want_o)
        t["lse_rel_err"] = _rel_err(got_lse, want_lse)
        t["lse_rel_l2_err"] = _rel_l2(got_lse, want_lse)
        check(max(t["fwd_rel_err"], t["fwd_rel_l2_err"]) <= ATTN_ATOL[dtype]
              and max(t["lse_rel_err"], t["lse_rel_l2_err"])
              <= ATTN_ATOL[torch.float32],
              f"B4 != plain at {label}: " + json.dumps(
                  {k: t[k] for k in ("fwd_rel_err", "fwd_rel_l2_err",
                                     "lse_rel_err", "lse_rel_l2_err")}))
        del got_o, got_lse, want_o, want_lse
        want = at.flash_bwd_fused_plain(*args)
        for key, got in (("fused", at.flash_bwd_fused(*args)),
                         ("two_pass", (at.flash_bwd_dq(*args),)
                          + at.flash_bwd_dkv(*args))):
            t[f"{key}_max_abs_err"] = max(
                float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want))
            t[f"{key}_rel_err"], t[f"{key}_rel_l2_err"] = _grads_errs(
                got, want, False)
            check(max(t[f"{key}_rel_err"], t[f"{key}_rel_l2_err"])
                  <= ATTN_ATOL[dtype],
                  f"{key} != plain by {t[f'{key}_rel_err']} (relative L2 "
                  f"{t[f'{key}_rel_l2_err']}) at {label}")
        # each bound at the rate of the route that runs the kernel (the
        # whole backward's at B6's); in f32 also at both f32 rates
        t["routes"] = {}
        for kind, kernel in (("fwd", "flash_fwd"), ("bwd", "flash_bwd_fused"),
                             ("dq", "flash_bwd_dq"),
                             ("dkv", "flash_bwd_dkv")):
            route = FLASH_ROUTES[dtype][kernel]
            t["routes"][kernel] = route
            t[f"{kind}_bound"] = list(flash_bound_ms(
                b, h, s, s, d, dtype, kind,
                peak=PEAK_FLOPS_3XTF32 if route == "f32_tc" else None))
            if dtype == torch.float32:
                for tag, peak in (("_3xtf32", PEAK_FLOPS_3XTF32),
                                  ("_simt", PEAK_FLOPS[torch.float32])):
                    t[f"{kind}_bound{tag}"] = list(flash_bound_ms(
                        b, h, s, s, d, dtype, kind, peak=peak))
        timings[label] = t
        log(f"flash timing {label} " + json.dumps(t))
        del q, k, v, do, o, lse, delta, args, leaves, fns
        torch.cuda.empty_cache()
    return timings


def _longseq_gate(at, dev, shape) -> float:
    """The port's ``_flash_numerics_gate`` (bench.py:297-330): bf16 flash
    attention (B4, then B6 or B5a + B5b as the shape picks) against f32
    ``blockwise_attention`` at ``shape``, causal, inputs ``randn·0.5`` from
    ``RandomState(7)``: the output and the gradients of ``sum(o·0.01)``,
    each error over the reference's largest magnitude; returns the
    largest."""
    rs = np.random.RandomState(7)
    base = [torch.from_numpy(rs.randn(*shape) * 0.5).to(
        dev, torch.bfloat16) for _ in range(3)]
    results = []
    for attn, dtype in ((at.flash_attention, torch.bfloat16),
                        (at.blockwise_attention, torch.float32)):
        leaves = [t.to(dtype).detach().requires_grad_() for t in base]
        o = attn(*leaves, causal=True)
        (o.float() * 0.01).sum().backward()
        results.append([o.detach()] + [t.grad for t in leaves])
    worst = max(float((g.float() - w.float()).abs().max())
                / max(float(w.float().abs().max()), 1e-6)
                for g, w in zip(*results))
    check(worst <= LONGSEQ_GATE_TOL, f"long-context numerics gate at "
          f"{list(shape)}: {worst} > {LONGSEQ_GATE_TOL}")
    return worst


def _longseq_chain(attn, q, k, v, eps, steps: int):
    """``steps`` chained training steps of causal attention, the loss
    ``sum(o)`` in f32: each step's inputs are the last step's plus ``eps``
    times its gradients (``eps`` a 0 on the card, so the steps run in
    series), as ``bench.py``'s ``_longseq_once``; returns the last
    inputs."""
    for _ in range(steps):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        attn(*leaves, is_causal=True).float().sum().backward()
        q, k, v = (t.detach() + eps * t.grad for t in leaves)
    return q, k, v


def _chain_ms(attn, q, k, v, eps, steps: int):
    """Milliseconds a step of :func:`_longseq_chain` by CUDA events over
    ``steps`` steps, after two; and the last inputs."""
    _longseq_chain(attn, q, k, v, eps, 2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = _longseq_chain(attn, q, k, v, eps, steps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps, out


def phase_longseq(at, dev, seed: int):
    """``bench_longseq`` on the card: at each of its shapes the numerics
    gate, then 20 chained steps through ``flash_attention`` (one B4 and one
    B6 a step at 4096 keys, one B4, one B5a and one B5b at 8192, all on
    the tensor cores) and through
    ``scaled_dot_product_attention(is_causal=True)``; returns (launches,
    stats)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def flash(q, k, v, is_causal):
        return at.flash_attention(q, k, v, causal=is_causal)

    launches, stats = {}, {}
    for label, (b, h, s, d), gate_shape in LONGSEQ_SHAPES:
        gate = _longseq_gate(at, dev, gate_shape)
        rs = np.random.RandomState(seed + 1)  # bench.py's RandomState(1)
        q, k, v = (torch.from_numpy(rs.randn(b, h, s, d).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        eps = torch.zeros((), dtype=torch.bfloat16, device=dev)
        torch.cuda.reset_peak_memory_stats()
        at.reset_launch_counts()
        step_ms, out = _chain_ms(flash, q, k, v, eps, LONGSEQ_STEPS)
        counts = {**at.flash_launch_counts,
                  **{f"route_{r}": n for r, n in at.flash_route_counts.items()}}
        n = LONGSEQ_STEPS + 2
        fused = at.fused_bwd_applicable(s, d, q.element_size())
        want = {"flash_fwd": n, "flash_bwd_fused": n if fused else 0,
                "flash_bwd_dq": 0 if fused else n,
                "flash_bwd_dkv": 0 if fused else n,
                "route_bf16_tc": (2 if fused else 3) * n,
                "route_f32_tc": 0}
        check(counts == want, f"long-context steps at {label} launched "
              f"{counts}, expected {want}")
        # eps = 0: the inputs come back bit for bit unless a gradient was
        # not finite
        check(all(torch.equal(a, b) for a, b in zip(out, (q, k, v))),
              f"long-context gradients at {label} not finite")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        library_ms, _ = _chain_ms(sdpa, q, k, v, eps, LONGSEQ_STEPS)
        prof = step_profile(
            lambda: _longseq_chain(flash, q, k, v, eps, 1), calls=3)
        flops = 9 * b * h * s * s * d
        stats[label] = {
            "shape": [b, h, s, d], "dtype": "bf16", "causal": True,
            "steps": LONGSEQ_STEPS, "numerics_rel_err": gate,
            "numerics_gate_shape": list(gate_shape),
            "backward_design": "B6" if fused else "B5a+B5b",
            "step_ms": step_ms, "tokens_per_s": b * s / step_ms * 1e3,
            "flops_per_step": flops,
            "tflops": flops / step_ms / 1e9,
            "peak_share_989": flops / step_ms / 1e9 / 989.0,
            "library_step_ms": library_ms,
            "library_tokens_per_s": b * s / library_ms * 1e3,
            "library": "scaled_dot_product_attention(is_causal=True)",
            "step_device_ms": prof["device_ms"],
            "step_device_launches": prof["device_launches"],
            "peak_memory_gb": peak_gb,
            "launches_per_step": {key: c / n for key, c in counts.items()}}
        launches[label] = {key: c for key, c in counts.items()
                           if not key.startswith("route_")}
        log(f"long-context step {label} " + json.dumps(stats[label]))
        del q, k, v, out
        torch.cuda.empty_cache()
    return launches, stats


def lm_tokens(seed: int, n: int, s: int) -> np.ndarray:
    """``n`` rows of ``s`` token ids drawn uniformly from the vocabulary."""
    return np.random.RandomState(seed).randint(
        0, LM_CFG["vocab_size"], (n, s)).astype(np.int64)


def _lm_counts(at, ek) -> dict:
    return {**at.flash_launch_counts, **at.launch_counts,
            "gather_rows": ek.launch_counts["gather_rows"]}


def _reset_counts(at, ek) -> None:
    at.reset_launch_counts()
    ek.reset_launch_counts()


def _lm_step_stats(lm, tokens, batch: int, steps_timed: int,
                   steps_profiled: int) -> dict:
    """One training step on a batch already on the card: CUDA events,
    the profiler's device time, launches and top kernels."""
    est = lm._graph.get_estimator()
    xb = torch.from_numpy(tokens[:batch].astype(np.float32)).cuda()
    lm.train()
    step_ms = cuda_ms(lambda: est._train_step(xb, None), steps_timed,
                      warmup=1)
    prof = step_profile(lambda: est._train_step(xb, None),
                        calls=steps_profiled, top=12, warmup=False)
    return {"step_ms_events": step_ms,
            "tokens_per_s_events": batch * (tokens.shape[1] - 1) / step_ms
            * 1e3,
            "step_device_ms": prof["device_ms"],
            "step_device_launches": prof["device_launches"],
            "step_issued_launches": prof["issued_launches"],
            "step_top_kernels": prof["top_device"],
            "step_top_host_ops": prof["top_host"]}


def phase_lm_train(at, ek, seed: int):
    """Train the full-width TransformerLM on the card: 8 steps at batch 8 x
    2048 tokens, then a warm fit of 8 more and the step timed; returns
    (the model, launches, stats)."""
    from analytics_zoo_tpu_torch.capture import TransformerLM

    t0 = time.perf_counter()
    lm = TransformerLM(**LM_CFG, seed=seed)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    tokens = lm_tokens(seed, LM_BATCH * LM_STEPS, LM_CFG["max_len"] + 1)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(at, ek)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = lm.fit(tokens, batch_size=LM_BATCH, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _lm_counts(at, ek)
    blocks = LM_CFG["n_block"]
    want = {"flash_fwd": blocks * LM_STEPS, "flash_bwd_fused":
            blocks * LM_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "fused_short_fwd": 0, "fused_short_bwd": 0,
            "gather_rows": LM_STEPS}
    check(launches == want, f"LM fit launched {launches}, expected {want}")
    flash_routes = dict(at.flash_route_counts)
    check(flash_routes == flash_routes_of(at, torch.float32, launches),
          f"LM fit's flash routes {flash_routes}")
    losses = np.asarray(hist["loss_history"])
    check(hist["iterations"] == LM_STEPS and losses.shape == (LM_STEPS,)
          and bool(np.isfinite(losses).all()),
          f"LM fit: {hist['iterations']} steps, losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a warm fit: one more epoch of the same 8 steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = lm.fit(tokens, batch_size=LM_BATCH, epochs=2)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(warm["iterations"] == 2 * LM_STEPS and bool(np.isfinite(
        warm["loss_history"]).all()), "the warm LM fit failed")
    stats = {"config": LM_CFG, "params": n_params, "batch": LM_BATCH,
             "seq": LM_CFG["max_len"], "steps": LM_STEPS,
             "tokens_per_step": LM_BATCH * LM_CFG["max_len"],
             "losses": losses.tolist(),
             "warm_losses": list(warm["loss_history"]),
             "init_s": init_s, "first_fit_s": fit_s,
             "first_fit_ms_per_step": fit_s * 1e3 / LM_STEPS,
             "fit_wall_s": wall_s,
             "fit_ms_per_step": wall_s * 1e3 / LM_STEPS,
             "fit_tokens_per_s": LM_STEPS * LM_BATCH * LM_CFG["max_len"]
             / wall_s,
             "peak_memory_gb": peak_gb, "launches": launches,
             "flash_routes": flash_routes,
             "launches_per_step": {k: v / LM_STEPS
                                   for k, v in launches.items()}}
    stats.update(_lm_step_stats(lm, tokens, LM_BATCH, 2, 1))
    stats["device_busy_share"] = (
        stats["step_device_ms"] * LM_STEPS / (wall_s * 1e3)
        if stats["step_device_ms"] is not None else None)
    return lm, launches, stats


def phase_lm_long(at, ek, seed: int):
    """The long-context step: full widths at depth 2, sequence 4096, batch
    2, 2 steps; the backward must take B5a + B5b; returns (launches,
    stats)."""
    from analytics_zoo_tpu_torch.capture import TransformerLM

    lm = TransformerLM(**LM_LONG, seed=seed + 2)
    tokens = lm_tokens(seed + 2, LM_LONG_BATCH * LM_LONG_STEPS,
                       LM_LONG["max_len"] + 1)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(at, ek)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = lm.fit(tokens, batch_size=LM_LONG_BATCH, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _lm_counts(at, ek)
    n = LM_LONG["n_block"] * LM_LONG_STEPS
    want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "flash_bwd_fused": 0, "fused_short_fwd": 0, "fused_short_bwd": 0,
            "gather_rows": LM_LONG_STEPS}
    check(launches == want, f"long-context fit launched {launches}, "
          f"expected {want}")
    flash_routes = dict(at.flash_route_counts)
    check(flash_routes == flash_routes_of(at, torch.float32, launches),
          f"long-context fit's flash routes {flash_routes}")
    check(bool(np.isfinite(hist["loss_history"]).all()),
          "long-context losses not finite")
    stats = {"config": LM_LONG, "batch": LM_LONG_BATCH,
             "seq": LM_LONG["max_len"], "steps": LM_LONG_STEPS,
             "reduced": "n_block 8 -> 2, for time",
             "losses": list(hist["loss_history"]), "first_fit_s": fit_s,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches, "flash_routes": flash_routes,
             "launches_per_step": {k: v / LM_LONG_STEPS
                                   for k, v in launches.items()}}
    stats.update(_lm_step_stats(lm, tokens, LM_LONG_BATCH, 2, 1))
    del lm
    torch.cuda.empty_cache()
    return launches, stats


def _decode_vs_full(lm, prompt, gen, logits) -> float:
    """Largest error of each decode step's logits against a full causal
    forward of prompt + generated tokens at those positions, over the
    logits' scale."""
    full = lm.logits(np.concatenate([prompt, gen[:, :-1]], 1),
                     batch_size=prompt.shape[0])
    want = full[:, prompt.shape[1] - 1:]
    return float(np.abs(logits - want).max()) / max(
        1.0, float(np.abs(want).max()))


def phase_lm_generate(at, ek, lm, seed: int):
    """Greedy generation with the trained full-width LM: prompts of 1000
    tokens (prefill through B4) and of 100 (through B7, causal), 32 new
    tokens each; every decode step's logits against a full forward;
    returns (launches by prompt, stats)."""
    from analytics_zoo_tpu_torch.capture import prefill_bucket

    blocks = LM_CFG["n_block"]
    launches, stats = {}, {}
    for length in GEN_PROMPTS:
        prompt = lm_tokens(seed + length, GEN_BATCH, length)
        tb = prefill_bucket(length - 1, LM_CFG["max_len"])
        _reset_counts(at, ek)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, logits = lm.generate(prompt, GEN_NEW, return_logits=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = _lm_counts(at, ek)
        routes = dict(at.route_counts)
        flash = tb > at.FUSED_SHORT_MAX_SEQ
        want = {"flash_fwd": blocks if flash else 0,
                "fused_short_fwd": 0 if flash else blocks,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_fused": 0,
                "fused_short_bwd": 0, "gather_rows": 1 + GEN_NEW}
        check(counts == want, f"generate after {length} tokens launched "
              f"{counts}, expected {want}")
        check(routes == {"bf16_tc": 0, "f32_tc": want["fused_short_fwd"]},
              f"generate after {length} tokens took the routes {routes}, "
              f"expected f32_tc alone")
        flash_routes = dict(at.flash_route_counts)
        check(flash_routes == flash_routes_of(at, torch.float32, counts),
              f"generate after {length} tokens took the flash routes "
              f"{flash_routes}")
        check(gen.shape == (GEN_BATCH, GEN_NEW) and bool(
            ((gen >= 0) & (gen < LM_CFG["vocab_size"])).all()),
              "generated tokens malformed")
        err = _decode_vs_full(lm, prompt, gen, logits)
        check(err <= LOGIT_TOL, f"decode logits differ from the full "
              f"forward by {err} of their scale ({length}-token prompt)")
        # warm: the whole call again, and the prefill alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = lm.generate(prompt, GEN_NEW)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(again, gen), "a second generate differs")
        padded = torch.zeros((GEN_BATCH, tb), dtype=torch.long,
                             device=lm.embed.device)
        padded[:, :length - 1] = torch.from_numpy(prompt[:, :-1])
        with torch.inference_mode():
            prefill_ms = cuda_ms(lambda: lm.prefill_kv(padded), 3, warmup=1)
        launches[length] = counts
        stats[f"prompt_{length}"] = {
            "bucket": tb, "attention": "B4" if flash else "B7",
            "first_call_ms": first_s * 1e3, "total_ms": total_ms,
            "prefill_ms_events": prefill_ms,
            "ms_per_token": (total_ms - prefill_ms) / GEN_NEW,
            "launches": counts, "routes": routes,
            "flash_routes": flash_routes,
            "decode_vs_full_rel_err": err}
    return launches, stats


def phase_lm_vs_cpu(seed: int):
    """Full width at depth 2, on the card and on the CPU from the same
    weights: a greedy generate of 8 tokens after a 600-token prompt (the
    prefill through flash), then two Adam steps at batch 2, sequence 512;
    returns stats.

    Tokens must equal the CPU's up to the first step where a row parts,
    and there the CPU's top-two logit margin must lie within LOGIT_TOL of
    the logits' scale (a near-tie that rounding may decide; random weights
    give near-ties over 32,000 tokens); logits at the steps before are held
    to LOGIT_TOL. Losses rtol 1e-5, parameters as ``hold_adam_params``."""
    from analytics_zoo_tpu_torch.capture import TransformerLM

    weights = {k: v.clone() for k, v in
               TransformerLM(**LM_CPU, seed=seed + 3).state_dict().items()}
    tokens = lm_tokens(seed + 4, LM_CPU_RECORDS, LM_CPU_SEQ + 1)
    prompt = lm_tokens(seed + 5, 2, LM_CPU_PROMPT)
    runs = {}
    for dev in ("cuda", "cpu"):
        lm = TransformerLM(**LM_CPU)
        lm.load_state_dict(weights)
        t0 = time.perf_counter()
        gen, logits = lm.generate(prompt, LM_CPU_NEW, device=dev,
                                  return_logits=True)
        gen_s = time.perf_counter() - t0
        opt = lm._graph.get_estimator().optimizer
        seen = record_grads(opt)
        t0 = time.perf_counter()
        hist = lm.fit(tokens, batch_size=LM_CPU_BATCH, epochs=1)
        runs[dev] = dict(gen=gen, logits=logits, grads=seen,
                         losses=hist["loss_history"], fit_s=time.perf_counter()
                         - t0, gen_s=gen_s,
                         weights={k: v.detach().cpu()
                                  for k, v in lm.state_dict().items()},
                         lr=opt.learning_rate)
        del lm
    card, cpu = runs["cuda"], runs["cpu"]
    scale = max(1.0, float(np.abs(cpu["logits"]).max()))
    matched, margins = [], []
    for row in range(prompt.shape[0]):
        n = 0
        while n < LM_CPU_NEW and card["gen"][row, n] == cpu["gen"][row, n]:
            err = float(np.abs(card["logits"][row, n]
                               - cpu["logits"][row, n]).max()) / scale
            check(err <= LOGIT_TOL, f"row {row} step {n}: logits differ "
                  f"from the CPU's by {err} of their scale")
            n += 1
        if n < LM_CPU_NEW:
            top2 = np.sort(cpu["logits"][row, n])[-2:]
            margin = float(top2[1] - top2[0]) / scale
            check(margin <= LOGIT_TOL, f"row {row} parts from the CPU at "
                  f"step {n} with a top-two margin of {margin}")
            margins.append(margin)
        matched.append(n)
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-5,
                               atol=0)
    held_err, free, free_err = hold_adam_params(
        card["weights"], cpu["weights"], card["grads"], cpu["grads"],
        cpu["lr"])
    return {"config": LM_CPU, "reduced": "n_block 8 -> 2, for the CPU's time",
            "records": LM_CPU_RECORDS, "batch": LM_CPU_BATCH,
            "seq": LM_CPU_SEQ, "adam_steps": len(cpu["losses"]),
            "max_rel_err_loss": float(np.max(np.abs(
                np.asarray(card["losses"]) - cpu["losses"])
                / np.abs(cpu["losses"]))),
            "max_abs_err_params": held_err[0], "worst_param": held_err[1],
            "params_other_gradient": free,
            "max_abs_err_params_other_gradient": free_err,
            "prompt": LM_CPU_PROMPT, "new_tokens": LM_CPU_NEW,
            "steps_matched": matched, "parting_margins": margins,
            "max_rel_err_logits_matched": float(max(
                [np.abs(card["logits"][r, :n] - cpu["logits"][r, :n]).max()
                 / scale for r, n in enumerate(matched) if n] + [0.0])),
            "cpu_fit_s": cpu["fit_s"], "cpu_generate_s": cpu["gen_s"],
            "card_fit_s": card["fit_s"], "card_generate_s": card["gen_s"]}


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


def ncf_pairs(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` (user, item) requests, a few of them out of range (clamped and
    counted by ``validate_ids``)."""
    x = np.stack([rng.integers(1, NCF["user_count"] + 1, n),
                  rng.integers(1, NCF["item_count"] + 1, n)],
                 axis=1).astype(np.float32)
    x[3], x[10], x[17] = [-1, 5], [7000, 9], [12, 5000]
    return x


def _card_forward(module, x: np.ndarray, batch: int) -> np.ndarray:
    """A direct forward on the card, ``batch`` rows at a time, f32 out."""
    with torch.inference_mode():
        return np.concatenate([
            module(torch.from_numpy(x[i:i + batch]).cuda()).float().cpu()
            .numpy() for i in range(0, len(x), batch)])


def phase_quantized_serving(ek, seed: int, workdir: str):
    """Serve phase 4's NCF through ``ClusterServing`` with ``quantize:
    int8`` and ``quantize: bf16``; returns {mode: (launches, stats)}."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.inference.quantize import _is_qleaf
    from analytics_zoo_tpu_torch.serving import (ClusterServing, FileQueue,
                                                 InputQueue, OutputQueue,
                                                 ServingConfig)

    model_dir = os.path.join(workdir, "ncf")
    x = ncf_pairs(np.random.default_rng(seed + 1), QUANT_BURST)
    xs = np.concatenate([x, x[:QUANT_SINGLE]])
    f32 = InferenceModel(device="cuda").load_zoo(model_dir)
    ref = _card_forward(f32._module, xs, len(xs))
    del f32

    # weight memory: int8 keeps a quarter of the >= 2-D weights' bytes
    im = InferenceModel(device="cuda").load_zoo(model_dir)
    wbytes = sum(p.numel() * p.element_size()
                 for p in im._module.parameters() if p.dim() >= 2)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    im.quantize("int8")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    freed = (before - after) / wbytes
    check(abs(freed - 0.75) <= 0.01, f"int8 quantize freed {freed:.4f} of "
          f"the {wbytes} weight bytes, expected about 3/4")
    del im

    out = {}
    for mode in ("int8", "bf16"):
        spool = os.path.join(workdir, f"spool_{mode}")
        src = "dir://" + spool
        cfg = ServingConfig(model_type="zoo", model_path=model_dir,
                            data_src=src, image_shape=(2,),
                            batch_size=SERVE_BATCH, quantize=mode)
        queue = CountingQueue(FileQueue(spool))
        t0 = time.perf_counter()
        server = ClusterServing(cfg, queue=queue, device="cuda")
        up_s = time.perf_counter() - t0
        module = server.model._module
        tables = [getattr(module, name).embeddings
                  for name, _, _ in NCF_TABLES]
        if mode == "int8":
            check(all(_is_qleaf(t) and t.q.dtype == torch.int8
                      and t.q.is_cuda for t in tables)
                  and _is_qleaf(module.prediction.kernel),
                  "int8 serving did not keep the weights int8 on the card")
        else:
            check(all(t.dtype == torch.bfloat16 and t.is_cuda
                      for t in tables), "bf16 tables are not bf16")
        inq, outq = InputQueue(src), OutputQueue(src)

        ek.reset_launch_counts()
        t0 = time.perf_counter()
        for i, row in enumerate(x):
            inq.enqueue_tensor(f"req-{i}", row)
        enqueue_s = time.perf_counter() - t0
        t_start = time.perf_counter()
        server.start()
        try:
            deadline = time.monotonic() + 300
            while (server.records_served + sum(server.counters.values())
                   < QUANT_BURST and time.monotonic() < deadline):
                server.check_health()
                time.sleep(0.002)
            drain_s = time.perf_counter() - t_start
            burst_batches = server.batches_dispatched
            single = []
            for j in range(QUANT_SINGLE):
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
        launches = dict(ek.launch_counts)
        batches = server.batches_dispatched

        results = outq.dequeue()
        uris = [f"req-{i}" for i in range(QUANT_BURST)]
        singles = [f"one-{j}" for j in range(QUANT_SINGLE)]
        check(sorted(results) == sorted(uris + singles),
              f"{mode}: {len(results)} results for "
              f"{QUANT_BURST + QUANT_SINGLE} requests")
        check(queue.posts == {u: 1 for u in uris + singles},
              f"{mode}: a request got no terminal result or more than one")
        errors = [u for u in uris + singles if "error" in results[u]]
        check(not errors, f"{mode}: {len(errors)} error results, e.g. "
              f"{results[errors[0]] if errors else None}")
        # the direct forward below repeats the served shapes: 256-row
        # batches, then single rows
        check(burst_batches == QUANT_BURST // SERVE_BATCH
              and batches == burst_batches + QUANT_SINGLE,
              f"{mode}: {burst_batches} burst batches, {batches} in all")
        rows_kernel, other = (("gather_int8", "gather_rows")
                              if mode == "int8" else
                              ("gather_rows", "gather_int8"))
        check(launches[rows_kernel] == 4 * batches
              and launches[other] == 0 and launches["gather_pool"] == 0,
              f"{mode}: launched {launches} for {batches} batches (expected "
              f"4 {rows_kernel} a batch and nothing else)")
        served = np.array([results[u]["value"] for u in uris + singles],
                          np.float32)
        check(served.shape == (len(xs), NCF["num_classes"])
              and bool(np.isfinite(served).all()),
              f"{mode}: served values malformed")
        direct = np.concatenate([_card_forward(module, x, SERVE_BATCH),
                                 _card_forward(module, x[:QUANT_SINGLE], 1)])
        np.testing.assert_allclose(served, direct, rtol=1e-5, atol=0)
        cpu = InferenceModel(device="cpu").load_zoo(model_dir).quantize(mode)
        plain = cpu.predict(xs)
        np.testing.assert_allclose(served, plain, rtol=0,
                                   atol=QUANT_ATOL[mode])
        xb = torch.from_numpy(x[:SERVE_BATCH]).cuda()
        with torch.inference_mode():
            forward_ms = cuda_ms(lambda: module(xb), 50)
        predict_device_ms = device_ms(
            lambda: server.model.predict(x[:SERVE_BATCH]))
        single.sort()
        stats = {
            "mode": mode, "requests": len(xs), "burst": QUANT_BURST,
            "burst_batches": burst_batches, "batches": batches,
            "launches": launches, "load_quantize_prewarm_s": up_s,
            "enqueue_records_per_s": QUANT_BURST / enqueue_s,
            "records_per_s": QUANT_BURST / drain_s,
            "burst_latency_p50_ms": server.latency_ms(0.50),
            "single_latency_p50_ms": single[len(single) // 2],
            "single_latency_max_ms": single[-1],
            "forward_ms_batch256": forward_ms,
            "predict_device_ms_batch256": predict_device_ms,
            "max_abs_err_vs_card_forward": float(
                np.abs(served - direct).max()),
            "max_abs_err_vs_cpu_plain": float(np.abs(served - plain).max()),
            "max_prob_drift_vs_f32": float(np.abs(served - ref).max()),
            "argmax_agreement_vs_f32": float(
                (served.argmax(1) == ref.argmax(1)).mean())}
        if mode == "int8":
            stats.update({"weight_bytes_f32": wbytes,
                          "allocated_before": before,
                          "allocated_after": after,
                          "freed_share_of_weight_bytes": freed})
        log(f"{mode}: max prob drift vs f32 "
            f"{stats['max_prob_drift_vs_f32']:.6f}, argmax agreement "
            f"{stats['argmax_agreement_vs_f32']:.4f}, "
            f"{stats['records_per_s']:.1f} records/s served")
        out[mode] = (launches, stats)
        del server, module, tables, cpu
    return out


def phase_calibrated(ek, seed: int, workdir: str):
    """Calibrated int8 on the card against the CPU from the same batches;
    returns (launches of the bucketed predicts, stats)."""
    from analytics_zoo_tpu_torch.inference import InferenceModel

    model_dir = os.path.join(workdir, "ncf")
    rng = np.random.default_rng(seed + 2)
    calib = [ncf_pairs(rng, SERVE_BATCH) for _ in range(CALIB_BATCHES)]
    x = ncf_pairs(rng, SERVE_BATCH)
    ref = _card_forward(InferenceModel(device="cuda").load_zoo(
        model_dir)._module, x, SERVE_BATCH)
    card = InferenceModel(device="cuda").load_zoo(model_dir)
    cpu = InferenceModel(device="cpu").load_zoo(model_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.quantize("int8", calibration_data=calib)
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    cpu.quantize("int8", calibration_data=calib)
    names = sorted(cpu._act_scales)
    check(sorted(card._act_scales) == names and len(names) == 4,
          f"calibrated layers {sorted(card._act_scales)} vs the CPU's "
          f"{names}")
    scale_err = max(abs(card._act_scales[k] - cpu._act_scales[k])
                    / cpu._act_scales[k] for k in names)
    check(scale_err <= 1e-6, f"activation scales differ from the CPU's by "
          f"{scale_err} relative")
    for k in names:
        got, want = (getattr(card._module, k).kernel,
                     getattr(cpu._module, k).kernel)
        check(torch.equal(got.q.cpu(), want.q)
              and torch.equal(got.scale.cpu(), want.scale),
              f"{k}: the card's int8 kernel or scale differs from the CPU's")
    own = card.predict(x)
    # the CPU's scales on the card: no activation can round across a tie
    card._module.load_state_dict(cpu._module.state_dict(), strict=True)
    ek.reset_launch_counts()
    errs = {}
    for b in (1, 16, SERVE_BATCH):
        got, want = card.predict(x[:b]), cpu.predict(x[:b])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        errs[b] = float(np.abs(got - want).max())
    launches = dict(ek.launch_counts)
    check(launches == {"gather_rows": 12, "gather_pool": 0,
                       "gather_int8": 0, "scatter_rows": 0},
          f"3 calibrated predicts launched {launches}, expected 12 row "
          f"gathers (the tables stay f32)")
    xb = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: card._module(xb), 50)
    stats = {"calibration_batches": CALIB_BATCHES,
             "calibrate_s_card": calibrate_s,
             "act_scales": cpu._act_scales,
             "max_rel_err_act_scales": scale_err,
             "max_abs_err_vs_cpu_by_bucket": errs,
             "max_abs_err_own_scales_vs_cpu": float(
                 np.abs(own - cpu.predict(x)).max()),
             "forward_ms_batch256": forward_ms,
             "max_prob_drift_vs_f32": float(np.abs(own - ref).max()),
             "argmax_agreement_vs_f32": float(
                 (own.argmax(1) == ref.argmax(1)).mean())}
    log(f"calibrated int8: max prob drift vs f32 "
        f"{stats['max_prob_drift_vs_f32']:.6f}, argmax agreement "
        f"{stats['argmax_agreement_vs_f32']:.4f}")
    return launches, stats


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

    phase_s = {}

    def timed(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t0
        return out

    # -- 2. build -------------------------------------------------------------
    timed("build", kernel_build.load_library)
    log(f"kernel library {os.path.relpath(kernel_build.library_path(), REPO)}"
        f" ready in {phase_s['build']:.3f} s (nvcc "
        f"{kernel_build.last_build_seconds:.3f} s); rebuilt, s: "
        + json.dumps(timed("rebuild", rebuild_seconds, kernel_build)))

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    timings, max_err = timed("gather_kernel", phase_kernels, ek, dev, gen)
    pool_timings, pool_err = timed("pool_kernel", phase_pool_kernels, ek, dev,
                                   gen, args.seed)
    attn = timed("attention_kernels", phase_attention_kernels, at, dev,
                 args.seed)
    int8_timings, int8_err, int8_cases = timed(
        "int8_kernel", phase_int8_kernels, ek, dev, args.seed)
    scatter_timings, scatter_err, scatter_rel, scatter_cases = timed(
        "scatter_kernel", phase_scatter_kernel, ek, dev, args.seed)

    # -- 4. serving, 5. training ---------------------------------------------
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        launches, batches, stats = timed(
            "serving", phase_serving, ek, args.seed, args.requests,
            args.single, workdir)
        log("serving " + json.dumps(stats) + f" | {smi}")
        # -- 11. quantized serving, 12. calibrated int8 ------------------
        quant = timed("quantized_serving", phase_quantized_serving, ek,
                      args.seed, workdir)
        for mode, (_, q_stats) in quant.items():
            log(f"serving quantize={mode} " + json.dumps(q_stats)
                + f" | {smi}")
        calib_launches, calib_stats = timed("calibrated_int8",
                                            phase_calibrated, ek, args.seed,
                                            workdir)
        log("calibrated int8 " + json.dumps(calib_stats) + f" | {smi}")
        train_launches, train_stats = timed("training", phase_training, ek,
                                            args.seed, workdir)
        log("training " + json.dumps(train_stats) + f" | {smi}")
        # -- 13. vocab-sharded Wide&Deep, 14. int8 Wide&Deep -------------
        torch.cuda.empty_cache()
        shard_ranks, shard_stats = timed("sharded_wnd", phase_sharded_wnd,
                                         ek, args.seed, workdir)
        log("sharded wide&deep " + json.dumps(shard_stats) + f" | {smi}")
        int8_wnd = timed("int8_wnd", phase_int8_wnd, ek, args.seed, workdir)
        log("int8 wide&deep " + json.dumps(int8_wnd) + f" | {smi}")
        # -- 6. BERT fine-tuning, 7. BERT on the card against the CPU ----
        bert_launches, bert_stats = timed("bert", phase_bert, at, ek,
                                          args.seed)
        log("bert " + json.dumps(bert_stats) + f" | {smi}")
        bert_cpu = timed("bert_vs_cpu", phase_bert_vs_cpu, at, args.seed)
        log("bert card vs cpu " + json.dumps(bert_cpu) + f" | {smi}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # -- 8. flash kernels, 9. the TransformerLM ------------------------------
    flash = timed("flash_kernels", phase_flash_kernels, at, dev, args.seed)
    longseq_launches, longseq_stats = timed("longseq", phase_longseq, at,
                                            dev, args.seed)
    log("long-context steps " + json.dumps(longseq_stats) + f" | {smi}")
    lm, lm_launches, lm_stats = timed("lm_train", phase_lm_train, at, ek,
                                      args.seed)
    log("lm training " + json.dumps(lm_stats) + f" | {smi}")
    gen_launches, gen_stats = timed("lm_generate", phase_lm_generate, at, ek,
                                    lm, args.seed)
    log("lm generate " + json.dumps(gen_stats) + f" | {smi}")
    del lm
    torch.cuda.empty_cache()
    long_launches, long_stats = timed("lm_long", phase_lm_long, at, ek,
                                      args.seed)
    log("lm long context " + json.dumps(long_stats) + f" | {smi}")
    lm_cpu = timed("lm_vs_cpu", phase_lm_vs_cpu, args.seed)
    log("lm card vs cpu " + json.dumps(lm_cpu) + f" | {smi}")
    log("phases, s: " + json.dumps(phase_s))

    # -- 8. the kernels line, 9. the result line ------------------------------
    serve = timings[0]
    lm_paths = {"lm_train": lm_launches, "lm_long": long_launches,
                **{f"lm_generate_{n}": c for n, c in gen_launches.items()}}
    rows_launches = {"serving": launches,
                     "serving_bf16": quant["bf16"][0]["gather_rows"],
                     "serving_int8": quant["int8"][0]["gather_rows"],
                     "calibrated_int8": calib_launches["gather_rows"],
                     "training": train_launches["gather_rows"],
                     "sharded_wnd": sum(
                         r[job]["launches"]["gather_rows"]
                         for r in shard_ranks for job in ("correct", "full")),
                     "bert": sum(c["gather_rows"]
                                 for c in bert_launches.values()),
                     **{k: c["gather_rows"] for k, c in lm_paths.items()}}
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
    int8_serve = quant["int8"][0]
    int8_by_path = {"serving_int8": int8_serve["gather_int8"],
                    "serving_bf16": quant["bf16"][0]["gather_int8"],
                    "calibrated_int8": calib_launches["gather_int8"]}
    served8, large8 = int8_timings
    int8_entry = {
        "name": "gather_int8", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/csrc/gather_int8.cu",
        "replaces": "analytics_zoo_tpu/ops/embedding_kernels.py:158",
        "tpu_kernel": "_gather_int8_kernel",
        "launches": int8_by_path["serving_int8"],
        "launches_by_path": int8_by_path,
        "launches_per_batch": int8_by_path["serving_int8"]
        / quant["int8"][1]["batches"],
        "max_abs_err": int8_err, "grid_cases": int8_cases,
        "shape": f"table {served8['rows']}x{served8['dim']} int8, "
                 f"n={served8['n']}",
        "ms": served8["ms"], "kernel_ms": served8["ms"],
        "plain_ms": served8["plain_ms"], "bound_ms": served8["bound_ms"],
        "bound_by": "bytes", "library_ms": served8["library_ms"],
        "library": "torch.index_select, then * scale (two calls)",
        "device_ms": served8["device_ms"],
        "large": [{k: large8[k] for k in (
            "table", "rows", "n", "dim", "ms", "plain_ms", "library_ms",
            "bound_ms", "device_ms", "plain_device_ms", "library_device_ms",
            "library_max_abs_diff")}],
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
    shard_launches = {job: sum(r[job]["launches"]["scatter_rows"]
                               for r in shard_ranks)
                      for job in ("correct", "full")}
    wnd_shard, hbm_block = scatter_timings
    scatter_entry = {
        "name": "scatter_rows", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "analytics_zoo_tpu/ops/embedding_kernels.py:257",
        "tpu_kernel": "_scatter_add_kernel",
        "launches": sum(shard_launches.values()),
        "launches_by_path": {f"sharded_wnd_{k}": v
                             for k, v in shard_launches.items()},
        "launches_per_step_per_rank":
            shard_stats["full"]["launches_per_step_per_rank"]["scatter_rows"],
        "max_abs_err": scatter_err, "max_rel_err_repeated_rows": scatter_rel,
        "grid_cases": scatter_cases,
        "shape": f"block {wnd_shard['rows']}x{wnd_shard['dim']} f32, "
                 f"n={wnd_shard['n']}",
        "ms": wnd_shard["ms"], "kernel_ms": wnd_shard["ms"],
        "device_ms": wnd_shard["device_ms"],
        "plain_ms": wnd_shard["plain_ms"], "bound_ms": wnd_shard["bound_ms"],
        "bound_by": "bytes", "library_ms": wnd_shard["library_ms"],
        "library": "torch.zeros, then index_add_ of the in-range rows "
                   "(two calls)",
        "turns": wnd_shard["turns"],
        "large": [{k: hbm_block[k] for k in (
            "rows", "dim", "n", "ms", "device_ms", "plain_ms",
            "plain_device_ms", "library_ms", "library_device_ms",
            "bound_ms", "max_abs_err")}],
    }
    main_t = attn["rate_0.1"]  # the fine-tune's attention dropout
    attn_sources = {
        "bf16_tc": "analytics_zoo_tpu_torch/csrc/fused_short_attn_bf16.cu",
        "f32_tc": "analytics_zoo_tpu_torch/csrc/fused_short_attn.cu"}
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
        by_path.update({k: c[name] for k, c in lm_paths.items()})
        by_path["bert_vs_cpu"] = bert_cpu["launches"][name]
        # the BERT fine-tune is bf16, the others f32 (both checked)
        routes = {"bf16_tc": {
            "source": attn_sources["bf16_tc"],
            "shape": attn_shape, "ms": main_t[f"{key}_ms"],
            "device_ms": main_t[f"{key}_device_ms"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "plain_ms": main_t[f"plain_{key}_ms"],
            "library_ms": main_t[library[0]],
            "library_device_ms": main_t[library[0].replace(
                "_ms", "_device_ms")],
            "max_abs_err": main_t[f"{key}_max_abs_err"],
            "max_rel_err_grid": attn["errors"][f"{key}_bf16"],
            "launches_by_path": {k: v for k, v in by_path.items()
                                 if k in bert_launches}}}
        # the f32 route at each timed shape, the LM's prefill first; its
        # bound at the 3xTF32 rate, and at the CUDA cores' f32 rate beside
        def f32_at(label, key=key, library=library):
            f32 = attn["f32"][label]
            return {
                "shape": f32["shape"], "ms": f32[f"{key}_ms"],
                "device_ms": f32[f"{key}_device_ms"],
                "bound_ms": f32[f"{key}_bound"][0],
                "bound_by": f32[f"{key}_bound"][1],
                "bound_rate": "3xTF32, 494.7 / 3 TFLOP/s",
                "bound_ms_f32_cuda_cores": f32[f"{key}_bound_simt"][0],
                "plain_ms": f32[f"plain_{key}_ms"],
                "library_ms": f32[library[0]],
                "library_device_ms": f32[library[0].replace(
                    "_ms", "_device_ms")],
                "max_abs_err": f32[f"{key}_max_abs_err"]}

        routes["f32_tc"] = {
            "source": attn_sources["f32_tc"], **f32_at("lm_prefill"),
            "library": library[1] + ", f32, with the same mask and dropout",
            "max_rel_err_grid": attn["errors"][key],
            "other_shapes": {label: f32_at(label)
                             for label, *_ in ATTN_F32_TIMED[1:]},
            "launches_by_path": {k: v for k, v in by_path.items()
                                 if k not in bert_launches}}
        # the top-level numbers are the main path's: BERT's bf16 route
        attn_entries.append({
            "name": name, "route": "cuda",
            "source": attn_sources["bf16_tc"],
            "replaces": f"analytics_zoo_tpu/ops/attention.py:{line}",
            "tpu_kernel": tpu, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_train_step": by_path["fit"] / bert_stats["steps"],
            "max_abs_err": main_t[f"{key}_max_abs_err"],
            "max_rel_err_grid": {"f32": attn["errors"][key],
                                 "bf16": attn["errors"][f"{key}_bf16"]},
            "shape": attn_shape, "ms": main_t[f"{key}_ms"],
            "kernel_ms": main_t[f"{key}_ms"],
            "plain_ms": main_t[f"plain_{key}_ms"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": main_t[library[0]], "library": library[1],
            "device_ms": main_t[f"{key}_device_ms"],
            "no_dropout": {k: v for k, v in attn["rate_0.0"].items()
                           if k.startswith((key, "plain_" + key, "library"))},
            "routes": routes,
        })
    flash_sources = {
        "bf16_tc": "analytics_zoo_tpu_torch/csrc/flash_attn_bf16.cu",
        "f32_tc": "analytics_zoo_tpu_torch/csrc/flash_attn_tf32.cu"}
    flash_paths = {**lm_paths, **{f"longseq_{k}": c
                                  for k, c in longseq_launches.items()}}
    flash_entries = []
    # the top-level numbers are bf16's, on the tensor cores: B4 and B6 at
    # bench_longseq's headline, B5a and B5b at its 8192 keys; each route's
    # beside them (f32, on each kernel's f32 route: the LM's step for B4
    # and B6, its long-context step for B5a and B5b)
    for name, tpu, line, label, key, kind, err in (
            ("flash_fwd", "_flash_fwd_kernel", 203, "bench_longseq", "fwd",
             "fwd", "fwd_max_abs_err"),
            ("flash_bwd_dq", "_flash_bwd_dq_kernel", 379,
             "bench_longseq_s8192", "dq", "dq", "two_pass_max_abs_err"),
            ("flash_bwd_dkv", "_flash_bwd_dkv_kernel", 428,
             "bench_longseq_s8192", "dkv", "dkv", "two_pass_max_abs_err"),
            ("flash_bwd_fused", "_flash_bwd_fused_kernel", 483,
             "bench_longseq", "fused", "bwd", "fused_max_abs_err")):
        t = flash[label]
        by_path = {k: c[name] for k, c in flash_paths.items()}
        library = ("library_fwd_ms", "scaled_dot_product_attention("
                   "is_causal=True), forward") if key == "fwd" else (
            "library_fwd_bwd_ms", "scaled_dot_product_attention("
            "is_causal=True), forward and backward (it has no backward "
            "alone)")

        def timed_at(lab, key=key, kind=kind, library=library):
            u = flash[lab]
            # f32: the bound at the route's rate, and at both f32 rates
            rates = {f"bound_ms{tag}": u[f"{kind}_bound{tag}"][0]
                     for tag in ("_3xtf32", "_simt")
                     if f"{kind}_bound{tag}" in u}
            return {"shape": f"{u['shape']} {u['dtype']} causal",
                    "ms": u[f"{key}_ms"], "device_ms": u[f"{key}_device_ms"],
                    "plain_ms": u[f"plain_{key}_ms"],
                    "bound_ms": u[f"{kind}_bound"][0],
                    "bound_by": u[f"{kind}_bound"][1], **rates,
                    "library_ms": u[library[0]],
                    "library_device_ms": u[library[0].replace(
                        "_ms", "_device_ms")]}

        two_pass = key in ("dq", "dkv")
        entry_k = {
            "name": name, "route": "cuda",
            "source": flash_sources["bf16_tc"],
            "replaces": f"analytics_zoo_tpu/ops/attention.py:{line}",
            "tpu_kernel": tpu, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_train_step": by_path[
                "longseq_s8192" if two_pass else "longseq_d128"]
            / (LONGSEQ_STEPS + 2),
            "max_abs_err": t[err],
            "max_rel_err_grid": {
                name: flash["errors"][
                    {"fwd": "fwd", "dq": "bwd_two_pass",
                     "dkv": "bwd_two_pass", "fused": "bwd_fused"}[key]
                    + f"_{name}"] for name in ("f32", "bf16")},
            **timed_at(label), "kernel_ms": t[f"{key}_ms"],
            "backward_bound_ms": t["bwd_bound"][0],
            "library": library[1],
            "other_shapes": {
                lab: {k: flash[lab][k] for k in (
                    "shape", "dtype", "backward_design", f"{key}_ms",
                    f"{key}_device_ms", f"plain_{key}_ms", f"{kind}_bound",
                    "library_fwd_ms", "library_fwd_bwd_ms")}
                for lab, _, _ in FLASH_TIMED if lab != label},
        }
        others = (("s4096", "bench_longseq"),) if two_pass else (
            ("d64", "bench_longseq_d64"), ("s8192", "bench_longseq_s8192"))
        f32_route = FLASH_ROUTES[torch.float32][name]
        f32_label = "lm_long" if two_pass else "lm"
        entry_k["routes"] = {
            "bf16_tc": {"source": flash_sources["bf16_tc"],
                        **timed_at(label),
                        **{k: timed_at(lab) for k, lab in others},
                        "launches_by_path": {
                            k: c for k, c in by_path.items()
                            if k.startswith("longseq")}},
            # f32, on the tensor cores as 3xTF32: at the LM's long-context
            # shape for the two-pass kernels, its step's shape for the
            # others
            f32_route: {"source": flash_sources[f32_route],
                        **timed_at(f32_label),
                        "other_shapes": {
                            lab: timed_at(lab) for lab in ("lm", "lm_long")
                            if lab != f32_label},
                        "launches_by_path": {
                            k: c for k, c in by_path.items()
                            if not k.startswith("longseq")}}}
        flash_entries.append(entry_k)
    print(smi)
    print(json.dumps({"kernels": [entry, pool_entry, scatter_entry,
                                  int8_entry]
                      + attn_entries + flash_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
