#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed 0] [--requests 2048] [--single 64]

Phases, each of which must pass or the script exits non-zero:

1. device: a CUDA card is required; TF32 is off for the float32 matmuls.
2. build: ``nvcc`` builds the port's kernels from ``analytics_zoo_tpu_torch/
   csrc`` (or reuses the build for the same sources), one process per
   source, with ``ptxas -v``, which gives the registers and spills of the
   16 bf16 and 16 f32 flash kernels, the 12 bf16 fused short kernels and
   the 25 f32 ones (each at its head widths, 256 among them); where the
   build was reused, their four sources are compiled again for it.
3. kernels: every kernel of the paths is held bit for bit against its
   plain PyTorch version at the main paths' shapes and on ragged, bag-size,
   bf16/fp16 and out-of-range cases, then timed with CUDA events and the
   profiler beside the plain version and the one PyTorch call that computes
   the same function. The row gather (on tables at three base alignments,
   widths of 1 to 2048): at the serving batch; at 2^20 ids, from a table
   that fits in L2 and from one of 1 GiB with every id distinct, also in
   turns with ``index_select``; at the LM's embedding, BERT-base's three
   tables and the sharded Wide&Deep's wide and ``occ_e`` shards (fill
   mode); where a shape's bytes fit in L2, also with L2 evicted before
   each call, the time its device-memory bound holds for. The gather+pool
   (``POOL_GRID``: tables at four base alignments, so every copy unit;
   bags of 1 to 64 across its in-flight chunk; id counts past its capped
   grid; every dtype, combiner and mode): at the Wide&Deep wide table
   ([101016, 2], 8192 bags of 3) and at 2^20 bags of 8 over a 64-wide
   table of 2^23 rows (2 GiB) with every id distinct, beside
   ``embedding_bag`` (sum and mean).
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
   32, 64, 128, 192 and 256, f32 (the tensor cores as 3xTF32, ``f32_tc``)
   and bf16
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
   and 4096 and four pairs of unequal q/kv lengths, head widths 24, 64, 96,
   128, 192 and 256 in f32 and in bf16: within 2e-5 (f32) and 2e-2 (bf16)
   of the output's scale (of the three gradients' joint scale for a
   backward) and, each output and each gradient, in relative L2; B5a +
   B5b's dq, dk and dv and B6's dk and dv bit-equal when repeated. The
   dtype and the kernel pick its route (both on the tensor cores: bf16 in
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
   NCF's four tables quantized as ``quantize_table`` does and on widths 1
   to 1024 (``INT8_DIMS``), for n 0-257 and past its capped grid, ids out
   of range on both sides, a scale that is a device tensor, and table
   bases 16-byte aligned and 1, 4 and 8 bytes past it: the byte path,
   4-byte units, a warp a row and the capped grid-stride loop; then timed
   at NCF's four tables at 256 ids and at one (``INT8_TIMED``) and over a
   1 GiB table ([2^24, 64], 2^20 distinct ids) beside its plain version
   and ``index_select`` then ``* scale`` (two calls).
11. quantized serving: the NCF that phase 4 saved is served through
   ``ClusterServing`` with ``quantize: int8`` and ``quantize: bf16`` (a
   burst of 512, then 16 single requests each). Every request is answered
   once, equal to a direct card forward of the same quantized model at the
   served batch shapes (rtol 1e-5) and to the CPU's quantized forward (atol
   1e-5 int8, 2e-2 bf16); a served batch launches 4 B9 and no B1 in int8,
   4 B1 on bf16 tables in bf16; in int8 the profiler shows each of a
   batch's 4 lookups issuing one launch, a B9 (``lookup_kernels``); int8
   frees about 3/4 of the weight bytes.
   Records/s, latency, and drift and argmax agreement against the f32
   model are printed.
12. calibrated int8: ``InferenceModel.quantize("int8", calibration_data=)``
   on the same model, on the card and on the CPU from the same batches:
   activation scales within 1e-6 relative, int8 kernels equal; with the
   CPU's scales loaded on the card, predictions at buckets 1, 16 and 256
   within 1e-5 of the CPU's (buckets 1 and 16 pad for ``torch._int_mm``).
13. row scatter-add kernel (B3): held against its plain version for widths
   1, 2, 3, 8, 64 and 130, 0 to 24,576 grad rows, blocks of 7, 250, 5000,
   100,003 and 25,000,254 rows, rows out of range on both sides, spread
   over the block or all inside its first fill chunk: bit for bit where no
   row repeats, within 2e-5 of the output's scale where rows repeat (f32
   atomics add them in no fixed order). Timed at the Wide&Deep shard
   ([25,000,254, 2], n = 4 x 6144 uniform rows), at the three blocks a
   sharded step scatters into on one rank with the rows it receives (the
   wide shard, ``edu_e`` [4, 8] and ``occ_e`` [250, 8] at n = 8192) and at
   a 1 GiB block ([2^22, 64], 2^20 uniform rows) beside its plain version
   and ``zeros`` + ``index_add_``, and in turns with that library call,
   the fills alone (``cudaMemsetAsync``, ``torch.zeros``) and B3 with
   every row dropped: forward then backward through the names, ten calls
   after five each, by device time and events.
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

16. ResNet-50 trained on the card (north-star #2; no kernel of the port's
   own is on this path, and every launch count must stay 0): (a)
   ``bench_resnet50``'s configuration (``bench.py:394-437``), ``resnet(50,
   num_classes=2, input_shape=(224, 224, 3))`` with bf16 ``compute_dtype``,
   ``SGD(0.1, momentum=0.9)``, batch 256 of seeded f32 images in [0, 1):
   two steps through ``Estimator.train`` (the first timed alone), then the
   step on a batch on the card by CUDA events (16) and the profiler (3):
   images/s, busy share, device ms by kind of kernel, top kernels and host
   operators, peak memory, and each convolution's and BatchNorm's forward
   and backward timed alone at its input; losses finite, parameters and
   running statistics moved and finite. (b) the fed variant,
   ``preprocess="imagenet_uint8"`` on 2048 seeded uint8 images through
   ``FeatureSet`` and the feed, two epochs of 8 steps (the second timed at
   wall clock); its convolutions run in f32 (the uint8 input is not cast).
   (c) ``NNClassifier`` on a pandas DataFrame of 512 uint8 images, batch 64,
   one epoch: ``transform``'s predictions 0.0 or 1.0, equal to a direct
   card forward's argmax. (d) ResNet-18 (10 classes, 64 x 64, f32, batch
   16, 4 SGD-momentum steps) on the card against the CPU from the same
   weights, each step from the CPU's state (``RESNET_CPU_TOL``); with
   cuDNN's deterministic algorithms a checkpoint resume equals the straight
   card run exactly; a bf16 forward is held to the CPU's within 2e-2.

17. Cluster Serving (north-star #5, ``bench.py:1268-1392``), each model
   through ``ClusterServing`` and the file spool, a burst of distinct
   records published before the server starts (its drain rate is the
   records/s), then requests one at a time (their latency; the first ones
   of the burst again). Every request must get exactly one value, equal to
   a direct card forward of the batches as dispatched (rtol 1e-5) and to
   the CPU's forward from the same weights on the records sent twice
   (``SERVE_CPU_ATOL``). (a) ``resnet50_serving``: ``resnet(50, 10,
   (224, 224, 3), preprocess="imagenet_uint8")`` in f32, batch 64,
   ``input_dtype: uint8``, 512 seeded 224 x 224 jpgs (base64), then 64:
   every batch must reach the card as uint8, each row ``decode_image`` of
   its payload bit for bit; ``filter_top_n`` answers (top 5 of the first
   64 records) must carry the values' classes; no kernel of the port's
   own runs (every launch count 0). (b) ``bert_serving``:
   ``BERTClassifier(2)`` at BERT-base width in bf16 through
   ``InferenceModel.load_forward`` and ``bert_serving_forward`` (the
   four-array input built on the card from float32 token rows), batch 32,
   seq 128, 256 seeded padded records, then 32: a served batch must launch
   12 B7 on the bf16 route, 3 B1 and no B8. Each prints records/s, the
   latencies (p50, max and which single paid it), a batch's forward by
   CUDA events and a served predict's device time by the profiler, the
   busy share, ``serving.decode_batch`` seconds a batch, a record's bytes
   in the spool and a batch's bytes to the card.

18. heads of 256 (``phase_wide_heads``): B7/B8 at [16, 8, 512, 256] and
   B4, B5a, B5b and B6 at [4, 8, 2048, 256] causal, in bf16 and f32, timed
   beside their plain versions and ``scaled_dot_product_attention`` and
   held to the plain versions; a TransformerLM step in f32 at 8 x 2048
   with hidden 2048 in 8 heads of 256, depth 2 (each block one B4, one B5a
   and one B5b a step: 8.4 MB resident a head, past the one-pass rule);
   a bf16 flash step at [4, 8, 2048, 256] (one B4 and one B6), beside
   SDPA's.
19. the int8 ResNet. (a) ``resnet18_quantized``: ``bench_quantized``'s
   configuration (ResNet-18, 1000 classes, 224 x 224, batch 32, f32,
   seeded) through ``InferenceModel``, fp32, ``quantize("bf16")`` and
   ``quantize("int8", calibration_data=[x[:8]])``: images/s of each by
   CUDA events; the int8 forward's device ms by kind (int8 GEMMs, the
   patch copies by their profiler range, elementwise) with no float
   convolution or product; drift and argmax agreement against fp32; every
   calibrated conv's int32 sums equal to the CPU's bit for bit; the
   activation scales and the answers from the CPU's quantized weights
   against the CPU's (``QUANT_SCALE_RTOL``, ``QUANT_CARD_CPU_ATOL``). (b)
   ``resnet50_int8``: ``bench_resnet50_int8``'s configuration, not cut
   (``resnet(50, 2, (224, 224, 3), dataflow="int8")``, SGD(0.1, momentum
   0.9), bf16 compute, batch 256): 2 warm steps, then the step by CUDA
   events and the profiler (device ms by kind, the patch copies, busy
   share, peak memory) beside the bf16 step of 16 (a); ResNet-18 at 64 x
   64, batch 16, 3 steps, each from the CPU's state (``INT8_CPU_TOL``).
   (c) ``int8_training``: ``resnet(18, int8_training=True)`` the same way,
   and one ``Convolution2D(int8_training=True)`` at [256, 56, 56, 64], 64
   filters 3x3, forward and backward timed beside the bf16 conv. None of
   the three launches a kernel of the port's own.

20. generative serving (north-star: ``bench.py``'s ``bench_generate``;
   the slice's main path): ``GenerativeServing`` with the TransformerLM
   at ``LM_CFG``'s width (seeded random weights, f32), every request sent
   with ``enqueue_prompt`` through a ``dir://`` spool, the first read back
   with ``OutputQueue.stream``. (a) contiguous slots: 32 slots, 32 new
   tokens, 64 greedy prompts of 100 tokens (bucket 128: B7) and 4 of 1000
   (bucket 1024: B4) that join mid-run; every request one terminal; the
   prefills launch B7 or B4 once a block, B1 once a prefill and once a
   step, and no backward kernel runs; this run is timed. Then the same
   prompts again with each step's logits kept (a tap that copies them on
   the host, so this run is not timed): its tokens equal the timed run's,
   each stream's logits are within ``LOGIT_TOL`` of their scale of a
   serial ``generate`` of its prompt on the card, and its tokens equal,
   except where the serial run's top two logits are that close
   (printed). (b) paged: ``kv_page_len`` 16, 64
   slots, 128 streams (those of (a) and 60 more), ``kv_pages`` the pages
   64 resident streams take: the tokens of (a)'s prompts equal (a)'s. (c)
   (b) with ``kv_int8``: one terminal each, tokens well formed, launches
   as (b)'s, the count that differ from (b)'s printed. (d)
   ``register_prefix`` of 64 tokens against the same 16 prompts without
   it, as (a) against serial; the registration launches B7 once a block
   and the joins none. (e) sampled (temperature 0.8, top-k 50, top-p 0.9,
   a seed a request): as (a), timed untapped, then tapped against
   ``generate(seed=...)``, where a token may differ only where the draw's
   own scores (filtered logits plus the step's Gumbel noise) are that
   close. Each prints tokens/s, TTFT and
   latency p50/p99, steps and the KV bytes; then a decode step of 32
   resident streams alone: ms by CUDA events, device ms, busy share, top
   kernels.
21. heads past 256 (``csrc/attn_wide.cu``, C15): every attention wrapper
   at heads of 257, 320 and 512 (the forwards also 1024), f32 and bf16, is
   held to its plain version as in 6 and 8 (B7 with dropout 0 and 0.1,
   bias or not, causal or not; B4; B5a + B5b and B6 with and without an
   lse cotangent), every launch counted on the ``wide`` route; B7/B8's
   dropout mask at 320 columns bit for bit; the three kernels (forward,
   dq pass, dk/dv pass) timed at [2, 4, 512, 512] causal beside their
   plain versions and SDPA with their bounds; a TransformerLM with 4 heads
   of 512 (depth 2, max_len 512) trains 2 steps and generates after a
   100-token prompt, every attention launch on the ``wide`` route (the
   launches the kernels line reports for the three).

22. speculative decoding (ROADMAP Queue A item 4b): the TransformerLM at
   ``LM_CFG``'s width (seeded random weights, the output projections of
   blocks 3-8 scaled by ``SPEC_TAIL_SCALE``, f32, paged with 16-token
   pages) and a 2-block draft of the same width built from its embedding,
   first two blocks, ``ln_f`` and position rows (``max_len`` 2048 +
   ``SPEC_K``, the extra rows seeded), ``SPEC_K`` = 4. (a)
   ``generate_speculative`` on 8 prompts of 100 tokens, 64 new: tokens
   equal greedy ``generate``'s except at printed near-ties (the serial
   run's top two logits within ``LOGIT_TOL`` of their scale); B7 10 times
   (8 target blocks, 2 draft), B1 twice plus 5 a round. (b)
   ``GenerativeServing(spec_k=4, draft_lm=...)`` through the spool: 64
   slots, 32 new tokens, (20)'s 64 prompts of 100 tokens and 4 of 1000
   joining mid-run, one terminal each, tokens held to serial ``generate``
   as in (a); the plain paged run of the same streams beside it; then one
   round of 64 resident streams alone and its verify pass alone (ms by
   events, device ms, busy share, top kernels), the plain decode step
   beside it. (c) a draft with its own weights (acceptance near 0) at 4
   streams, held the same way. (d) sampled ``generate_speculative``
   (temperature 0.8, top-k 24) on a small LM (vocab 64) and a 1-block
   draft: the first emitted token of 8192 rows of one prompt, each row its
   own draws, within total variation ``SPEC_TV_BOUND`` of the target's
   filtered softmax. Printed: tokens/s, ms a round, acceptance, launches.
23. the serving platform: (a) ``ClusterServing`` of NCF (B1) with
   ``health_path``: an armed ``serving.predict`` fault errors its batch of
   64 and every other record equals the direct forward; ``reload_model``
   to a second NCF while a burst of 512 is in flight drops no record (each
   equals one model's forward, the split printed) and stamps ``ncf-v2``;
   the next burst is the new model's; an injected ``serving.reload`` fault
   raises ``ModelReloadError`` and v2 serves on; ``health.json`` and
   ``metrics.prom`` read back with the outcomes' counters. A burst of 512
   past ``max_pending`` 128 sheds with errors and steps the brownout
   ladder down and back (levels and events printed). (b)
   ``GenerativeServing`` at ``LM_CFG``'s width, paged: the
   ``serving.decode_step`` fault errors each of 4 active streams once and
   4 later streams complete; ``serving.page_alloc`` sheds its join with
   ``PAGE_SHED_ERROR``; 8 streams handed off after 6 steps finish on a
   second server held to serial ``generate`` as in 22; ``arm_capture
   (steps=2)`` writes a ``torch.profiler`` trace holding kernels. (c) the
   host cost of a disabled and an enabled counter, histogram and profiler
   phase, ns a call.
24. the serving fleet (ROADMAP Queue A item 5a). (a) a ``FleetRouter``
   over two in-process ``GenerativeServing`` instances of ``LM_CFG``'s LM
   (one set of weights, paged f32, 40 slots, a partial every token), each
   stepped by its own thread: 32 streams of 100-token prompts (B7) and 2 of
   1000 (B4), 32 new tokens each, published to the front spool. Once every
   stream on A has ``FLEET_STOP_AFTER`` tokens A stops; its health file
   goes stale after ``FLEET_STALE_S`` and B adopts A's streams with their
   prefixes. Every uri gets exactly one terminal (counted at each
   instance's ``put_result``), tokens equal serial ``generate``'s except
   at printed near-ties, and B1, B4 and B7 launch. Printed: tokens/s, the
   seconds from staleness to the adopter's first token, the streams
   continued. (d) then a ``ResilientClient`` against the same front: first
   attempts that no instance can finish in their deadline are shed by the
   router and retried, hedged queries race a copy; attempts stay within
   ``1 + client.retry_budget_ratio`` of requests. (b) ``FleetSupervisor``
   spawns two instances of the same LM (``fleet_lm_factory``, each process
   its own CUDA context and LM), the router spreads 16 streams over them,
   and the newer scales in through its ``DRAIN_`` flag and ``handoff``
   mid-decode: the audit journals hold one terminal a uri, the tokens are
   serial ``generate``'s, each process's peak device bytes are printed. (c)
   ``ClusterServing`` of NCF (B1) with ``ops.enabled`` under a
   ``serving.predict`` fault on 4 batches of a 512-record burst:
   ``goodput_burn`` fires into ``health.json``'s ``alerts``, its incident
   is sealed and shows as ``incident``, the events render in causal order
   (fault, alert, incident), and a ``trace()`` session holds every record's
   whole flow chain (enqueue, claim, decode, dispatch, result).

25. the Estimator's training loop (ROADMAP Queue A item 5b,
   ``phase_estimator_loop``): BERT-base fine-tuned as phase 7 does, with
   ``set_gradient_clipping(("l2", 1.0))``, from one set of seeded weights,
   under PyTorch's deterministic algorithms (``index_add_`` without
   atomics): (a) 16 steps three times (the card's own run-to-run distance,
   the largest pair's; 0 where the runs agree bit for bit), (b) 16 steps
   at ``steps_per_dispatch=4`` equal to (a) bit for bit where (a)'s runs
   agree bit for bit, else within twice that distance, with ms a step by
   CUDA events and wall clock at K = 1 and 4 (and in PyTorch's default
   mode, one more run each), (c) elastic retry: a torn
   snapshot and a failed 10th dispatch fall back one snapshot and end at
   (a)'s parameters with 2 verified snapshots left, (d) a real SIGTERM
   at 0.4 of a run: ``PreemptedError``, the marker's snapshot resumes to (a)'s
   parameters, (e) NCF at MovieLens-1M width with its tables frozen: 8
   steps leave them bit for bit, (f) ``train_online(max_steps=8)`` writes a
   ``TimeInterval`` snapshot. B1, B7 and B8 launch; printed with the peak
   memory, the snapshot's host copy, write, verify and restore seconds.

Each phase's seconds are printed. The last three lines of output are the
card's
``nvidia-smi`` name and power limit, the ``{"kernels": [...]}`` line,
and the ``{"ok": true, ...}`` line.
"""
import argparse
import contextlib
import ctypes
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

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
#: past it, two and past them, the longest) and head widths; the first
#: ATTN_PINNED widths run first, as before heads past 128 were taken, so
#: that their largest errors stay comparable with the recorded ones below
ATTN_SEQS = (1, 17, 64, 65, 128, 129, 512)
ATTN_DIMS = (32, 64, 128, 192, 256)
ATTN_PINNED = 3
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
#: B9's grid: widths that are and are not whole 4-byte units, rows past 32
#: units (130 bytes a row on the byte path, 1024 on 4-byte units: a warp a
#: row), and id counts (None: past the gathers' capped grid,
#: ``past_the_cap``), each on four table bases
INT8_DIMS = (1, 3, 4, 5, 8, 16, 31, 32, 33, 64, 130, 1024)
INT8_NS = (0, 1, 2, 31, 32, 33, 255, 256, 257, None)
#: B9's table bases: 16-byte aligned and 1, 4 and 8 bytes past it (the
#: byte path at 1; 4-byte units, where the width allows, at 0, 4 and 8)
INT8_OFFSETS = (0, 1, 4, 8)
#: the timed int8 table that L2 cannot hold: 16 Mi x 64 int8 = 1 GiB
INT8_HBM_ROWS = 1 << 24
#: B3's grid: widths (the wide table's 2, the embed tables' 8), grad
#: counts (those of the sharded step: 4 ranks x 2048 rows for an embed
#: table, x 3 wide ids for the wide table), and block rows (small, the
#: occ_e shard's 250, one that no 32 KB fill chunk divides, and the
#: full-width Wide&Deep shard's)
SCATTER_DIMS = (1, 2, 3, 8, 64, 130)
SCATTER_NS = (0, 1, 255, 256, 257, 4096, 8192, 24576)
SCATTER_ROWS = (7, 250, 5000, 100003, 25000254)
#: the full-width Wide&Deep shard: 100,001,016 wide rows over 4 ranks, and
#: one step's exchanged grads there (4 ranks x 2048 rows x 3 wide ids)
WND_SHARD_ROWS, WND_SHARD_N = 25000254, 4 * 6144
#: a shard block L2 cannot hold: 2^22 x 64 f32 = 1 GiB, 2^20 uniform rows
SCATTER_HBM = (1 << 22, 64, 1 << 20)
#: rounds of B3 and its library call in turns, and of what splits B3's
#: time (each a turn of each, then of each again in the other order)
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
#: chunk of 8 or 16 (24), a partial 128-wide tile (96), and past 128 the
#: wide instances, partly (192) and wholly (256) filled
FLASH_DIMS = {torch.float32: (24, 64, 96, 128, 192, 256),
              torch.bfloat16: (24, 64, 96, 128, 192, 256)}
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


#: bytes written between calls by :func:`cold_device_ms` to evict L2 (50 MB
#: on the H100)
L2_FLUSH_BYTES = 256 << 20


def cold_device_ms(fn, calls: int = 20):
    """Device time per call of the kernels ``fn`` issues with L2 evicted
    before each call: a write of ``L2_FLUSH_BYTES`` between calls (left out
    of the sum), so that ``fn`` reads its inputs from device memory and
    each line it writes evicts a dirty one. None when the trace is
    incomplete (see :func:`step_profile`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as alone:
        buf.fill_(1.0)
        torch.cuda.synchronize()
    flush_keys = {e.key for e in alone.key_averages()
                  if e.device_type == DeviceType.CUDA}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            buf.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    issued = sum(e.count for e in events if e.device_type == DeviceType.CPU
                 and _DEVICE_WORK_CALL.match(e.key))
    flushes = sum(e.count for e in dev if e.key in flush_keys)
    us = sum(e.self_device_time_total for e in dev
             if e.key not in flush_keys)
    if sum(e.count for e in dev) != issued or flushes != calls or us <= 0:
        return None
    return us / 1e3 / calls


#: host calls that put a kernel, copy or fill on the card, as the profiler
#: names them (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
#: ``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...)
_DEVICE_WORK_CALL = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")


def step_profile(fn, calls: int = 20, top: int = 0,
                 warmup: bool = True, split=None) -> dict:
    """A ``torch.profiler`` trace of ``calls`` calls of ``fn``, per call:
    the device time of its kernels and copies, their number, the number of
    host calls that issued them, and with ``top`` the ``top`` longest
    kernels and the ``top`` host operators with the most self time, as
    ``[name, ms, count]``; with ``split`` (kernel name -> kind) the device
    ms by kind; the names of the kernels; and the device ms of the kernels
    inside the int8 convolution's patch range (None if none ran). The
    device time is None unless every issued kernel, copy and fill has its
    device event: the profiler can drop device events in short windows,
    and a partial sum is not a time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.ops.int8_dataflow import PATCH_RANGE
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the device side of a ``record_function`` range is a span, not work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.key != PATCH_RANGE]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    us = sum(e.self_device_time_total for e in dev)
    patch_us = sum(e.device_time_total for e in host if e.key == PATCH_RANGE)
    n_dev = sum(e.count for e in dev)
    issued = sum(e.count for e in host if _DEVICE_WORK_CALL.match(e.key))
    out = {"device_ms": us / 1e3 / calls if us > 0 and n_dev == issued
           else None,
           "device_launches": n_dev / calls,
           "issued_launches": issued / calls,
           "kernel_names": sorted({e.key for e in dev}),
           "patch_device_ms": patch_us / 1e3 / calls if patch_us > 0
           else None}
    if split is not None:
        kinds: dict = {}
        for e in dev:
            kind = split(e.key)
            kinds[kind] = kinds.get(kind, 0.0) + (
                e.self_device_time_total / 1e3 / calls)
        out["split_ms"] = kinds
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
#: B5b and B6 ``flash_bwd_tf32``) or of the fused short kernels (B7
#: ``fused_short_fwd``, B8's two passes ``fused_short_bwd_dq`` and
#: ``_dkv``, ``_bf16`` after each name on the bf16 route) and its mangled
#: template arguments
_PTXAS_ENTRY = re.compile(
    r"entry function '\S*?((?:flash_(?:fwd|bwd|bwd_dq)_(?:bf16|tf32)|"
    r"fused_short_(?:fwd|bwd_dq|bwd_dkv)(?:_bf16)?)_kernel)I((?:L[ib]\d+E)+)"
    r"E")
_PTXAS_ARG = re.compile(r"L[ib](\d+)E")
#: the wide kernels' entries (``csrc/attn_wide.cu``), by dtype
_PTXAS_WIDE = re.compile(
    r"entry function '\S*?(wide_(?:fwd|dq|dkv)_kernel)I(f|13__nv_bfloat16)E")
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
        m = _PTXAS_WIDE.search(line)
        if m:
            name = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}>"
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


def ptxas_report(kernel_build) -> dict:
    """``ptxas -v`` registers and spills of the flash kernels and of the
    fused short kernels, each at its head widths, from the build's log
    kept beside the library."""
    out = {}
    usage = ptxas_usage(kernel_build.build_log())
    for key, kind, bf16, want, what in (
            ("ptxas_bf16_flash", "flash_", True, 16,
             "bf16 flash kernels (B4, B5a, B5b, B6) at 4 widths"),
            ("ptxas_f32_flash", "flash_", False, 16,
             "f32 flash kernels (B4, B5a, B5b, B6) at 4 widths"),
            ("ptxas_bf16_fused", "fused_short_", True, 12,
             "bf16 fused short kernels (B7, B8's two passes) at 4 widths"),
            ("ptxas_f32_fused", "fused_short_", False, 25,
             "f32 fused short kernels (B7 at 3 splits, B8's two passes at "
             "2, at 3 widths; at d 256 B7 at 2 and B8 at 1)"),
            ("ptxas_wide", "wide_", None, 6,
             "wide kernels (forward, dq and dk/dv passes) in f32 and "
             "bf16")):
        out[key] = {k: v for k, v in usage.items()
                    if k.startswith(kind)
                    and (bf16 is None or ("_bf16_" in k) == bf16)}
        check(len(out[key]) == want, f"ptxas -v named {sorted(out[key])}, "
              f"expected the {what}")
    return out


def gather_bytes(table: torch.Tensor, ids: torch.Tensor,
                 clip: bool = True) -> int:
    """Bytes a gather of these ids must move: each id read once, each
    output row written once, and each distinct table row the ids reach
    read once (a row asked for twice is read once; in fill mode an id
    outside the table reaches no row)."""
    n, rows, dim = ids.shape[0], table.shape[0], table.shape[1]
    reached = (ids.clamp(0, rows - 1) if clip
               else ids[(ids >= 0) & (ids < rows)])
    distinct = int(torch.unique(reached).numel())
    row = dim * table.element_size()
    return n * row + 4 * n + distinct * row


def gather_bound_ms(table: torch.Tensor, ids: torch.Tensor,
                    clip: bool = True) -> float:
    """Least time for a gather of these ids at the memory rate: its
    :func:`gather_bytes` from and to device memory. Where those bytes fit
    in L2, calls back to back find the rows and the last call's output
    lines there and may beat it: the bound holds for the time with L2
    evicted before each call (:func:`cold_device_ms`)."""
    return gather_bytes(table, ids, clip) / HBM_BYTES_PER_S * 1e3


def _table_views(rows: int, dim: int, dtype, gen, dev,
                 offsets=(0, 1, 2)) -> list:
    """The same seeded ``[rows, dim]`` table at each of ``offsets``
    elements past the start of its storage (16-byte aligned): at one and
    two it is 4- and 8-byte aligned in f32, 2 and 4 in bf16 and fp16 (four
    gives bf16 and fp16 8 bytes), so the gathers take every copy unit a
    width allows."""
    flat = torch.randn(rows * dim + max(offsets), generator=gen).to(
        dtype).to(dev)
    return [(off, flat[off:off + rows * dim].view(rows, dim))
            for off in offsets]


def past_the_cap(dev) -> int:
    """More rows (or bags) than the gathers' capped grid holds at any
    packing (32 blocks of 64 threads an SM, at most one row a thread), so
    B1, B2 and B9 walk them in their grid-stride loop."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * 32 * 64 + 77


def lookup_kernels(ek, fn) -> dict:
    """What the card ran inside each ``ek.gather_pool_int8`` call while
    ``fn`` runs, by ``torch.profiler``, a list a lookup in order: the host
    calls that put a kernel, copy or fill on the card from inside it
    (``launches_per_lookup``, their sum ``launches_in_lookups``) and the
    device work that those calls' correlation ids name
    (``kernels_per_lookup``, by kind: ``gather_int8`` for B9, else the
    kernel's name). ``kernels`` counts the whole trace's device kernels by
    kind, or is None where the trace lost device events (see
    :func:`step_profile`); a ``warning`` says when a lookup's launches
    have no linked device kernel, so that only its host launches show what
    it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    real = ek.gather_pool_int8

    def traced(*args, **kwargs):
        with record_function("int8_lookup"):
            return real(*args, **kwargs)

    def kind(name: str) -> str:
        return "gather_int8" if "gather_int8" in name else name[:72]

    fn()  # warm: the library built, the allocator's blocks cached
    torch.cuda.synchronize()
    ek.gather_pool_int8 = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        ek.gather_pool_int8 = real
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range for e in host if e.name == "int8_lookup"),
                   key=lambda s: s.start)
    issued = [e for e in host if _DEVICE_WORK_CALL.match(e.name)]
    # the range's own device-side span is no kernel
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "int8_lookup"]
    # a launch and the work it put on the card share a correlation id
    by_call = {}
    for e in device:
        by_call.setdefault(e.id, []).append(kind(e.name))

    def inside(s) -> list:
        return [r for r in issued
                if s.start <= r.time_range.start and r.time_range.end <= s.end]

    per_lookup = [len(inside(s)) for s in spans]
    kernels_per_lookup = [[k for r in inside(s) for k in by_call.get(r.id, [])]
                          for s in spans]
    kernels = {}
    for e in device:
        kernels[kind(e.name)] = kernels.get(kind(e.name), 0) + 1
    seen = {"lookups": len(spans), "launches_per_lookup": per_lookup,
            "launches_in_lookups": sum(per_lookup),
            "kernels_per_lookup": kernels_per_lookup, "issued": len(issued),
            "kernels": kernels if sum(kernels.values()) == len(issued)
            else None}
    unlinked = sum(n > len(k) for n, k in zip(per_lookup, kernels_per_lookup))
    if unlinked:
        seen["warning"] = (
            f"{unlinked} of {len(spans)} lookups made more launches than "
            f"the trace kept device work for (it kept "
            f"{sum(kernels.values())} device kernels of {len(issued)} "
            "launches): there only the lookup's host launches were counted")
    return seen


def shard_request_ids(seed: int, table: str) -> tuple:
    """The ids the sharded Wide&Deep step gathers from rank 1's shard of
    one table at ``bench_widedeep_sharded``'s width (``FULL_CROSS``
    buckets): each of the ``SHARD_RANKS`` ranks sends, for its
    ``SHARD_BATCH // SHARD_RANKS`` records, a block of one slot an id
    holding the sorted local rows of its unique ids that rank 1 owns, then
    the SENTINEL ``rows_per_shard`` (``parallel/embedding.py``
    ``_routing``, ``_lookup_body``). ``table`` is ``"wide"`` (the
    100,001,016-row wide table, 3 ids a record) or an embed column
    (``"edu_e"``, 16 rows of 8, or ``"occ_e"``, 1000 rows of 8, 1 id a
    record). The backward's row scatter-add (B3) gets the same rows, a
    gradient row a slot. Returns (rows_per_shard, dim, ids int32)."""
    cols = wnd_columns(FULL_CROSS)
    (wide, _, emb, _), _ = wnd_records_at(seed, SHARD_BATCH, cols)
    if table == "wide":  # the wide table: a row of 2 class logits an id
        ids, dim = wide, 2
        vocab = sum(cols["wide_base_dims"] + cols["wide_cross_dims"])
    else:
        col = cols["embed_cols"].index(table)
        ids, dim = emb[:, col], cols["embed_out_dims"][col]
        vocab = cols["embed_in_dims"][col]
    rps = -(-vocab // SHARD_RANKS)
    blocks = []
    for part in np.split(ids, SHARD_RANKS):
        u = np.unique(part)
        mine = u[np.minimum(u // rps, SHARD_RANKS - 1) == 1] - rps
        block = np.full(part.size, rps, np.int32)
        block[:mine.size] = mine
        blocks.append(block)
    return rps, dim, np.concatenate(blocks)


def gather_timed_cases(dev, gen, seed: int):
    """B1's timed shapes, made one at a time: (label, table, ids, clip,
    calls). The NCF serving batch's four tables; 2^20 ids from a table L2
    holds and from a 1 GiB one (every id distinct); the LM's embedding (8 x
    2048 uniform tokens); BERT-base's word, position and type tables at a
    fine-tuning batch (128 x 128 ids as ``bert_records`` and
    ``bert_input_pack`` make them); and the sharded Wide&Deep's wide and
    ``occ_e`` shards in fill mode (``shard_request_ids``)."""
    dev_gen = torch.Generator(device=dev).manual_seed(gen.initial_seed())
    for name, rows, dim in NCF_TABLES:
        yield (name, torch.randn(rows, dim, generator=gen).to(dev),
               torch.randint(0, rows, (SERVE_BATCH,), generator=gen,
                             dtype=torch.int32).to(dev), True, 500)
    yield ("mlp_user_table", torch.randn(6041, 64, generator=gen).to(dev),
           torch.randint(0, 6041, (LARGE_N,), generator=gen,
                         dtype=torch.int32).to(dev), True, 50)
    # every id distinct, so every row comes from device memory
    yield ("hbm_table", torch.randn(HBM_ROWS, 64, generator=dev_gen,
                                    device=dev),
           torch.randperm(HBM_ROWS, generator=dev_gen, device=dev)[
               :LARGE_N].to(torch.int32), True, 50)
    vocab, hidden = LM_CFG["vocab_size"], LM_CFG["hidden"]
    yield ("lm_embed", torch.randn(vocab, hidden, generator=dev_gen,
                                   device=dev),
           torch.from_numpy(lm_tokens(seed, LM_BATCH, LM_CFG["max_len"])
                            .reshape(-1)).to(torch.int32).to(dev),
           True, 50)
    tokens, _ = bert_records(seed, BERT_BATCH, BERT_SEQ)
    bert_ids = {
        "bert_word": (BERT_CFG["vocab"], tokens),
        "bert_position": (BERT_CFG["max_position_len"],
                          np.broadcast_to(np.arange(BERT_SEQ),
                                          tokens.shape)),
        "bert_type": (2, np.zeros_like(tokens))}
    for name, (rows, ids) in bert_ids.items():
        yield (name, torch.randn(rows, BERT_CFG["hidden_size"],
                                 generator=dev_gen, device=dev).to(
                                     torch.bfloat16),
               torch.from_numpy(np.ascontiguousarray(ids).reshape(-1))
               .to(torch.int32).to(dev), True, 200)
    for table in ("wide", "occ_e"):
        rows, dim, ids = shard_request_ids(seed, table)
        yield (f"wnd_{table}_shard", torch.randn(rows, dim,
                                                 generator=dev_gen,
                                                 device=dev),
               torch.from_numpy(ids).to(dev), False, 200)


#: B1's grid: (rows, dim, dtype, n), every case run on three table views
#: (``_table_views``) in both modes. The NCF serving tables; f32 widths of
#: 1, 2, 8, 16, 32 and 64 (32, 32, 16, 8, 4 and 2 rows a warp, in 4-, 8-
#: and 16-byte units), bf16 and fp16 at odd widths, rows wider than
#: a warp's units (BERT's 768 bf16, the LM's 2048 f32, 129 fp16), and id
#: counts that are no multiple of a warp's or a block's rows, past one
#: pass of the grid (101,377 at 64 f32)
GATHER_GRID = tuple(
    [(rows, dim, torch.float32, SERVE_BATCH) for _, rows, dim in NCF_TABLES]
    + [(6041, 64, torch.float32, 1), (6041, 64, torch.float32, 257),
       (50, 3, torch.float32, 257), (50, 33, torch.float32, 256),
       (6041, 64, torch.bfloat16, 256), (50, 33, torch.bfloat16, 7),
       (3707, 32, torch.float16, 256), (50, 8, torch.float32, 0),
       (100, 1, torch.float32, 1025), (100, 2, torch.float32, 1000),
       (100, 8, torch.float32, 33), (100, 16, torch.float32, 4099),
       (100, 32, torch.float32, 100003), (1000, 64, torch.float32, 101377),
       (50, 7, torch.bfloat16, 1000), (50, 5, torch.float16, 333),
       (50, 129, torch.float16, 77), (600, 768, torch.bfloat16, 1000),
       (64, 2048, torch.float32, 300)])
#: rounds of B1 and ``index_select`` in turns at 2^20 x 64
GATHER_TURNS = 3


def phase_kernels(ek, dev, gen, seed: int):
    """Hold the gather kernel against its plain version on ``GATHER_GRID``,
    then time both and ``index_select`` at ``gather_timed_cases``' shapes
    (at 2^20 ids also B1 and ``index_select`` in turns; where the bytes fit
    in L2 also both with L2 evicted before each call); returns (timings per
    shape, largest error, cases)."""
    max_err, checked = 0.0, 0
    for rows, dim, dtype, n in GATHER_GRID:
        # ids below 0 and at or past the end, in both modes
        ids = torch.randint(-3, rows + 3, (n,), generator=gen,
                            dtype=torch.int32)
        if n >= 2:
            ids[0], ids[1] = -1, rows
        ids = ids.to(dev)
        for off, table in _table_views(rows, dim, dtype, gen, dev):
            for clip in (True, False):
                got = ek.gather(table, ids, clip)
                want = ek.gather_plain(table, ids, clip)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"gather kernel != plain at rows={rows} dim={dim} "
                      f"{dtype} n={n} offset={off} clip={clip}")
                if n:
                    max_err = max(max_err, float(
                        (got.float() - want.float()).abs().max()))
                checked += 1
    log(f"kernel == plain (torch.equal) on {len(GATHER_GRID)} shapes x 3 "
        f"table offsets x 2 modes")

    timings = []
    for label, table, ids, clip, iters in gather_timed_cases(dev, gen,
                                                             seed):
        # index_select has no fill mode: in fill mode it is timed on the
        # ids clamped into the table (the same bytes, not the function)
        lib_ids = ids if clip else ids.clamp(0, table.shape[0] - 1)
        fns = {"ms": lambda: ek.gather(table, ids, clip),
               "plain_ms": lambda: ek.gather_plain(table, ids, clip),
               "library_ms": lambda: torch.index_select(table, 0, lib_ids)}
        check(torch.equal(fns["ms"](), fns["plain_ms"]()),
              f"gather kernel != plain at {label}")
        t = {"table": label, "rows": table.shape[0], "dim": table.shape[1],
             "dtype": str(table.dtype).replace("torch.", ""),
             "n": ids.shape[0], "clip": clip,
             "bound_ms": gather_bound_ms(table, ids, clip),
             "library": "index_select" if clip
             else "index_select of the ids clamped into the table"}
        # *ms: CUDA events around back-to-back calls, what a caller issuing
        # them from Python sees; *device_ms: the profiler's kernel time
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, iters)
            t[key.replace("ms", "device_ms")] = device_ms(fn)
        # where the bytes fit in L2, warm calls beat device memory's rate:
        # the kernel and the library call also with L2 evicted before each
        t["l2_resident"] = gather_bytes(table, ids, clip) <= \
            torch.cuda.get_device_properties(dev).L2_cache_size
        if t["l2_resident"]:
            t["cold_device_ms"] = cold_device_ms(fns["ms"])
            t["library_cold_device_ms"] = cold_device_ms(fns["library_ms"])
        if ids.shape[0] == LARGE_N:
            t["turns"] = turns_ms({"kernel": fns["ms"],
                                   "library": fns["library_ms"]},
                                  GATHER_TURNS)
        timings.append(t)
        log("gather timing " + json.dumps(t))
        del fns, table, ids, lib_ids
        torch.cuda.empty_cache()
    return timings, max_err, checked


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


#: B2's grid: (rows, dim, bag, n, dtype), every case on four table views
#: (``_table_views`` at ``POOL_OFFSETS``: every copy unit a width allows),
#: three combiners, masked and clamped. The W&D wide-table call; widths of
#: 8-byte rows (a thread a bag), 16-byte rows and 64 f32 (16 lanes a bag),
#: rows past 32 units (a warp a bag); bags of 1, 3, 8, 9, 17 and 64 across
#: the in-flight chunk; n past the capped grid (None, ``past_the_cap``)
POOL_GRID = (
    (WND_WIDE_ROWS, 2, 3, 8192, torch.float32),
    (50, 2, 1, 257, torch.float32), (50, 2, 17, 100, torch.float32),
    (50, 8, 17, 100, torch.float32), (50, 33, 3, 64, torch.float32),
    (300, 64, 8, 129, torch.float32), (300, 64, 1, 33, torch.float32),
    (300, 64, 9, 255, torch.float32), (300, 64, 64, 256, torch.float32),
    (300, 64, 3, 64, torch.bfloat16), (50, 2, 3, 256, torch.bfloat16),
    (50, 33, 17, 31, torch.float16), (50, 8, 3, 90, torch.float16),
    (50, 8, 3, 0, torch.float32), (50, 200, 9, 257, torch.float32),
    (50, 520, 3, 31, torch.bfloat16), (1000, 2, 3, None, torch.float32),
    (1000, 64, 9, None, torch.float32), (1000, 8, 1, None, torch.bfloat16))
POOL_OFFSETS = (0, 1, 2, 4)


def phase_pool_kernels(ek, dev, gen, seed: int):
    """Hold the gather+pool kernel against its plain version bit for bit
    on ``POOL_GRID``, then time it, the plain version and
    ``embedding_bag`` at the W&D wide-table call and at a 2 GiB table;
    returns (timings, largest error)."""
    max_err = 0.0
    checked = 0
    past = past_the_cap(dev)
    for rows, dim, bag, n, dtype in POOL_GRID:
        n = past if n is None else n
        # ids below 0 and at or past the end: masked, or clamped with clip
        ids = torch.randint(-3, rows + 3, (n, bag), generator=gen,
                            dtype=torch.int32)
        if n >= 2 and bag:
            ids[0, 0], ids[1, -1] = -1, rows
        ids = ids.to(dev)
        for off, table in _table_views(rows, dim, dtype, gen, dev,
                                       POOL_OFFSETS):
            for combiner in ("sum", "mean", "sqrtn"):
                for clip in (True, False):
                    got = ek.pool(table, ids, combiner, clip)
                    want = ek.gather_pool_plain(table, ids, combiner, clip)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"pool kernel != plain at rows={rows} dim={dim} "
                          f"bag={bag} n={n} {dtype} offset={off} "
                          f"{combiner} clip={clip}")
                    checked += 1
                    if n:
                        max_err = max(max_err, float(
                            (got.float() - want.float()).abs().max()))
        del ids
    # the W&D forward's own call: validated (in-range) offset ids, clamped
    rs = np.random.RandomState(seed)
    table = torch.randn(WND_WIDE_ROWS, 2, generator=gen).to(dev)
    ids = torch.from_numpy(wide_ids(rs, 8192)).to(dev)
    got = ek.gather_pool(table, ids, "sum", mask_negative=False)
    check(torch.equal(got, ek.gather_pool_plain(table, ids, "sum", True)),
          "pool kernel != plain at the W&D wide-table call")
    log(f"pool kernel == plain (torch.equal) on {checked} shape x offset "
        f"x combiner x mode cases and the W&D wide-table call")

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


#: B9's timed lookups: (label, rows, dim, n, calls). NCF's four tables at
#: the serving batch and at a single request, then 2^20 distinct ids of a
#: 1 GiB table
INT8_TIMED = tuple(
    [(name, rows, dim, n, 500) for n in (SERVE_BATCH, 1)
     for name, rows, dim in NCF_TABLES]
    + [("hbm_table", INT8_HBM_ROWS, 64, LARGE_N, 50)])


def phase_int8_kernels(ek, dev, seed: int):
    """Hold the int8 gather kernel (B9) against its plain version bit for
    bit on NCF's tables and ``INT8_DIMS``, each at ``INT8_NS`` ids and on
    ``INT8_OFFSETS`` table bases, then time both and ``index_select`` +
    ``* scale`` at ``INT8_TIMED``; returns (timings, largest error, cases
    checked)."""
    gen = torch.Generator().manual_seed(seed)
    tables = []
    for _, rows, dim in NCF_TABLES:  # NCF's tables, as quantize makes them
        q, scale, _ = ek.quantize_table(
            torch.randn(rows, dim, generator=gen) * 0.05)
        tables.append((q, scale))
    for dim in INT8_DIMS:
        q = torch.randint(-127, 128, (50, dim), generator=gen,
                          dtype=torch.int8)
        tables.append((q, torch.rand((), generator=gen) * 0.02 + 1e-3))
    past = past_the_cap(dev)
    max_err, checked = 0.0, 0
    for q, scale in tables:
        rows, dim = q.shape
        scale_dev = scale.to(dev)
        views = []
        for off in INT8_OFFSETS:  # the table at 16-byte aligned + off
            raw = torch.zeros(q.numel() + off, dtype=torch.int8, device=dev)
            raw[off:] = q.reshape(-1).to(dev)
            views.append((off, raw[off:].view(rows, dim)))
        for n in INT8_NS:
            n = past if n is None else n
            ids = torch.randint(-3, rows + 3, (n,), generator=gen,
                                dtype=torch.int32)
            if n >= 2:
                ids[0], ids[1] = -1, rows
            ids = ids.to(dev)
            for off, table in views:
                got = ek.gather_int8(table, scale_dev, ids)
                want = ek.gather_int8_plain(table, scale_dev, ids)
                torch.cuda.synchronize()
                check(got.dtype == torch.float32 and torch.equal(got, want),
                      f"int8 kernel != plain at rows={rows} dim={dim} n={n} "
                      f"offset={off}")
                checked += 1
                if n:
                    max_err = max(max_err, float((got - want).abs().max()))
        del views
    log(f"int8 kernel == plain (torch.equal) on {checked} cases")

    timings = []
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    for label, rows, dim, n, iters in INT8_TIMED:
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
        check(torch.equal(fns["ms"](), fns["plain_ms"]()),
              f"int8 kernel != plain at {label} n={n}")
        t = {"table": label, "rows": rows, "dim": dim, "n": n,
             "bound_ms": int8_bound_ms(q, ids),
             "library_max_abs_diff": float(
                 (fns["ms"]() - fns["library_ms"]()).abs().max())}
        # *ms: CUDA events around back-to-back calls, what a caller issuing
        # them from Python sees (the host's time a call where it is
        # launch-bound); *device_ms: the profiler's kernel time
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, iters)
            t[key.replace("ms", "device_ms")] = device_ms(fn)
        timings.append(t)
        log("int8 gather timing " + json.dumps(t))
        del fns, q, ids
    return timings, max_err, checked


def scatter_bound_ms(num_rows: int, dim: int, n: int) -> float:
    """Least time for the scatter at the memory rate: each input byte read
    once (per grad row its row id and its ``dim`` f32) and each output byte
    written once (the ``[num_rows, dim]`` f32 block)."""
    return ((num_rows * dim * 4 + n * (4 + dim * 4)) / HBM_BYTES_PER_S
            * 1e3)


def _scatter_rows_input(dev, n: int, num_rows: int, kind: str):
    """Rows for the B3 grid, out of range on both sides (negatives,
    ``num_rows`` and past it) and in range: every row distinct
    (``"distinct"``), rows that repeat (``"repeat"``), or every in-range
    row among the first 4, inside the kernel's first fill chunk, their adds
    on a few lines (``"one_chunk"``)."""
    if kind == "distinct":
        rows = torch.randperm(num_rows + 6, device=dev)[:n] - 3
    else:
        hi = num_rows if kind == "repeat" else min(4, num_rows)
        pool = torch.randint(-3, hi + 3, (max(1, n // 4),), device=dev)
        pool[pool >= hi] += num_rows - hi  # past the end: the SENTINEL on
        rows = pool[torch.randint(0, pool.numel(), (n,), device=dev)]
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


def cuda_memset_fn(out: torch.Tensor):
    """A call of the CUDA runtime's ``cudaMemsetAsync`` zeroing ``out`` on
    the current stream (the fill B3 ran before it was one launch), or None
    where no runtime library loads."""
    cuda_home = os.path.dirname(os.path.dirname(
        shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"))
    for name in ("libcudart.so.12", "libcudart.so",
                 os.path.join(cuda_home, "lib64", "libcudart.so")):
        try:
            rt = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    rt.cudaMemsetAsync.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_size_t, ctypes.c_void_p]
    rt.cudaMemsetAsync.restype = ctypes.c_int
    nbytes = out.numel() * out.element_size()

    def memset():
        rc = rt.cudaMemsetAsync(out.data_ptr(), 0, nbytes,
                                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"cudaMemsetAsync failed: {rc}")
    return memset


def scatter_timed_cases(dev, seed: int):
    """B3's timed shapes, made one at a time: (label, num_rows, dim, rows
    int32, calls). The full-width Wide&Deep shard with 24,576 uniform rows
    (every add in range); the three blocks one sharded step scatters into
    on rank 1, with the rows that rank receives (``shard_request_ids``:
    the wide shard, and the ``edu_e`` and ``occ_e`` shards at 8192 slots,
    most of them the SENTINEL); and a 1 GiB block with 2^20 uniform
    rows."""
    def uniform(num_rows, n):
        return torch.randint(0, num_rows, (n,), device=dev,
                             dtype=torch.int32)
    yield ("wnd_shard", WND_SHARD_ROWS, 2, uniform(WND_SHARD_ROWS,
                                                   WND_SHARD_N), 50)
    for table in ("wide", "edu_e", "occ_e"):
        rows, dim, ids = shard_request_ids(seed, table)
        yield (f"wnd_{table}_request", rows, dim,
               torch.from_numpy(ids).to(dev), 50 if table == "wide" else 200)
    num_rows, dim, n = SCATTER_HBM
    yield ("hbm_block", num_rows, dim, uniform(num_rows, n), 20)


def phase_scatter_kernel(ek, dev, seed: int):
    """Hold the row scatter-add kernel (B3) against its plain version on the
    grid, then time both and ``zeros`` + ``index_add_`` at
    ``scatter_timed_cases``' shapes, holding B3 to plain there too, in
    turns with the library call and what splits its time
    (``cudaMemsetAsync``, ``torch.zeros``, B3 with every row dropped);
    returns (timings, largest error, largest error relative to scale with
    repeated rows, cases)."""
    torch.manual_seed(seed)
    abs_err, repeat_err, cases = 0.0, 0.0, 0
    for num_rows in SCATTER_ROWS:
        for dim in SCATTER_DIMS:
            for n in SCATTER_NS:
                for kind in ("distinct", "repeat", "one_chunk"):
                    if kind == "distinct" and n > num_rows + 6:
                        continue
                    rows = _scatter_rows_input(dev, n, num_rows, kind)
                    g = torch.randn(n, dim, device=dev)
                    err, rel = _held_to_plain(
                        ek, g, rows, num_rows,
                        f"rows={num_rows} dim={dim} n={n} {kind}")
                    abs_err = max(abs_err, err)
                    repeat_err = max(repeat_err, rel or 0.0)
                    cases += 1
                    del g, rows
        torch.cuda.empty_cache()
    log(f"scatter kernel against plain on {cases} cases: bit for bit "
        f"without repeated rows, {repeat_err:.3g} of scale with them")

    timings = []
    for label, num_rows, dim, rows, iters in scatter_timed_cases(dev, seed):
        n = rows.shape[0]
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
             "in_range": int(ok.sum()),
             "bound_ms": scatter_bound_ms(num_rows, dim, n),
             "max_abs_err": err, "repeated_rows": rel is not None}
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, iters)
            t[key.replace("ms", "device_ms")] = device_ms(fn)
        # B3 and its library call in turns, to tell them apart, and in the
        # same turns what splits B3's time: the runtime's memset and
        # PyTorch's fill kernel alone, and B3 with every row dropped (its
        # fill and barrier without the adds)
        dropped = torch.full_like(rows, -1)
        check(int(torch.count_nonzero(ek.scatter_rows(g, dropped,
                                                      num_rows))) == 0,
              f"B3 with every row dropped left nonzeros at {label}")
        block = torch.empty(num_rows, dim, device=dev)
        turned = {"kernel": fns["ms"], "library": fns["library_ms"],
                  "zeros": lambda: torch.zeros(num_rows, dim, device=dev),
                  "kernel_no_adds": lambda: ek.scatter_rows(g, dropped,
                                                            num_rows)}
        memset = cuda_memset_fn(block)
        if memset is not None:
            turned["memset"] = memset
        t["turns"] = turns_ms(turned, SCATTER_TURNS)
        timings.append(t)
        log("scatter timing " + json.dumps(t))
        del fns, turned, memset, block, rows, g, rows_m, g_m, dropped
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
    wide_errors = dict(errors)  # heads past 128
    cases = 0
    pinned = [(s, d) for s in ATTN_SEQS for d in ATTN_DIMS[:ATTN_PINNED]]
    for s, d in pinned + [(s, d) for s in ATTN_SEQS
                          for d in ATTN_DIMS[ATTN_PINNED:]]:
        errs = errors if (s, d) in pinned else wide_errors
        for dtype in (torch.float32, torch.bfloat16):
            route = at.fused_short_route(dtype, d)
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
                        errs["fwd" + tag] = max(errs["fwd" + tag], e)
                        errs["bwd" + tag] = max(errs["bwd" + tag], e_b)
                        cases += 1
    log(f"B7/B8 within f32 2e-5, bf16 2e-2 (relative to the output's scale) "
        f"of their plain versions on {cases} cases, each dtype by its own "
        f"route, bit-equal when repeated; largest errors "
        f"{json.dumps(errors)}, at heads of {ATTN_DIMS[ATTN_PINNED:]} "
        f"{json.dumps(wide_errors)}")
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
               "mask": mask_stats, "errors": errors,
               "wide_head_errors": wide_errors, "cases": cases}
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
        check(counts[name]["routes"] == {"bf16_tc": want, "f32_tc": 0,
                                          "wide": 0},
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
        "bf16_tc": 0, "f32_tc": fused, "wide": 0},
          f"the f32 card run launched "
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


#: the training loop's phase: BERT-base as phase_bert fine-tunes it, 16
#: steps (2 epochs of 8 batches), K steps a dispatch, a snapshot every 4
#: steps of which the newest 2 are kept, a step fault at the 10th dispatch
LOOP_STEPS, LOOP_K, LOOP_SNAPSHOT_EVERY, LOOP_KEEP = 16, 4, 4, 2
LOOP_STRAIGHT_RUNS = 3
#: the SIGTERM's time as a share of a straight run's wall: the host runs a
#: few steps ahead of the card, so a little before half way lands mid-run
LOOP_SIGTERM_AT = 0.4
LOOP_FAULT_AT, LOOP_ONLINE_STEPS, LOOP_ONLINE_INTERVAL_S = 10, 8, 0.25
#: NCF at MovieLens-1M width frozen below its dense layers: 8 steps
FREEZE_BATCH, FREEZE_STEPS = 2048, 8
NCF_TABLE_LAYERS = tuple(name for name, _, _ in NCF_TABLES)


def param_distance(a: dict, b: dict) -> dict:
    """Max |a - b| and the relative L2 distance over every float tensor of
    two state dicts."""
    worst, diff, norm = 0.0, 0.0, 0.0
    for k, v in a.items():
        if not v.is_floating_point():
            continue
        d = (v.double() - b[k].double())
        worst = max(worst, float(d.abs().max()) if d.numel() else 0.0)
        diff += float(d.square().sum())
        norm += float(v.double().square().sum())
    return {"max_abs": worst, "rel_l2": (diff / max(norm, 1e-300)) ** 0.5}


def loss_distance(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """PyTorch's deterministic algorithms for the block (its default mode
    where ``on`` is False), then the settings as they were. The embedding
    backward's ``index_add_`` then adds by a sorted reduction, not with
    atomics in no fixed order, so two runs of one training agree bit for
    bit. Ops without such an algorithm only warn (``warn_only``), and
    cuBLAS's warning (no ``CUBLAS_WORKSPACE_CONFIG``; one stream computes
    here) is silenced; ``torch.empty`` is not filled, as in a default
    run."""
    from torch.utils import deterministic
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(on, warn_only=True)
    deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CuBLAS.*")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        deterministic.fill_uninitialized_memory = was[2]


def phase_estimator_loop(at, ek, seed: int, workdir: str):
    """The Estimator's training loop on the card (ROADMAP Queue A item
    5b): BERT-base fine-tuned as ``phase_bert`` does (bf16, dropout 0.1,
    Adam at ``BERT_LR``, batch 128 x 128, 1024 seeded records) through
    ``Estimator.train`` with ``set_gradient_clipping(("l2", 1.0))``, from
    one set of seeded weights, under :func:`deterministic_algorithms` (the
    kernels and the loop are the default run's; only ``index_add_`` adds
    in a fixed order, so the comparisons below can be bit for bit):

    (a) 16 steps, one a dispatch, three times: the card's run-to-run
        distance, the largest of the three pairs' (max |Δ| and relative L2
        over the parameters, max |Δ| over the losses); the first run's
        parameters are P;
    (b) the same 16 steps at K = 4 a dispatch: its losses and parameters
        equal the first run's bit for bit where (a)'s runs agree bit for
        bit, else within twice their distance; ms a step by CUDA events
        and by wall clock at K = 1 and K = 4, of these runs and of one
        more each in PyTorch's default mode;
    (c) elastic retry: a snapshot every 4 steps, ``checkpoint.keep`` 2,
        ``ckpt.corrupt`` tears the second snapshot and ``train.step``
        fails the 10th dispatch: the restore falls back one snapshot
        (``ckpt.fallback_total`` 1), the run ends at (a)'s parameters
        under (b)'s rule, two snapshot directories are left, each with a
        manifest that verifies;
    (d) a real SIGTERM from a timer thread at 0.4 of a straight run's wall
        clock: PreemptedError,
        the marker names a snapshot that exists, and a fresh Estimator
        loaded from it trains to 16 steps and ends at (a)'s parameters;
    (e) the flagship NCF (MovieLens-1M width) with its four embedding
        tables frozen, 8 steps through ``fit``: the tables stay equal to
        their initial values bit for bit, every other layer moves;
    (f) ``train_online(max_steps=8)`` with a 0.25 s ``TimeInterval``
        snapshot: at least one is written.

    Returns (launches over the whole phase, stats)."""
    with deterministic_algorithms():
        return _estimator_loop(at, ek, seed, workdir)


def _estimator_loop(at, ek, seed: int, workdir: str):
    """:func:`phase_estimator_loop`'s runs and checks."""
    from analytics_zoo_tpu_torch.capture import BERTClassifier
    from analytics_zoo_tpu_torch.capture.text import bert_input_pack
    from analytics_zoo_tpu_torch.common import faults, metrics
    from analytics_zoo_tpu_torch.common.config import global_config
    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    from analytics_zoo_tpu_torch.estimator import Estimator, PreemptedError
    from analytics_zoo_tpu_torch.estimator import estimator as est_mod
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.models import NeuralCF

    cfg = dict(BERT_CFG, compute_dtype="bfloat16", hidden_p_drop=0.1,
               attn_p_drop=0.1)
    tokens, labels = bert_records(seed, BERT_RECORDS, BERT_SEQ)
    packed = bert_input_pack(tokens)
    epochs = LOOP_STEPS // (BERT_RECORDS // BERT_BATCH)
    clf = BERTClassifier(2, bert_config=cfg, optimizer=Adam(BERT_LR)).build(
        BERT_SEQ, torch.Generator().manual_seed(seed), device="cuda")
    model = clf.model
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def estimator():
        model.load_state_dict(init)
        est = Estimator(model, model.loss_fn, Adam(BERT_LR), device="cuda")
        est.set_gradient_clipping(("l2", 1.0))
        return est

    def data():
        return FeatureSet.from_ndarrays(packed, labels)

    def params():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def train(est, k=1, **kw):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        t0 = time.perf_counter()
        start.record()
        hist = est.train(data(), BERT_BATCH, epochs=epochs,
                         steps_per_dispatch=k, **kw)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = len(hist["loss_history"])
        return hist, {"ms_per_step_events": start.elapsed_time(end) / steps,
                      "ms_per_step_wall": wall * 1e3 / steps, "wall_s": wall}

    at.reset_launch_counts()
    ek.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stats = {"records": BERT_RECORDS, "batch": BERT_BATCH, "seq": BERT_SEQ,
             "steps": LOOP_STEPS, "clip": ["l2", 1.0]}
    # (a) the straight run, three times: where the runs do not agree bit
    # for bit, a single pair's distance is one draw of the card's spread
    # (Adam amplifies any rounding), so the spread is the largest pair's
    runs = []
    for _ in range(LOOP_STRAIGHT_RUNS):
        est = estimator()
        hist, timing = train(est)
        check(est.global_step == LOOP_STEPS
              and len(hist["loss_history"]) == LOOP_STEPS
              and bool(np.isfinite(hist["loss_history"]).all()),
              f"straight run: {est.global_step} steps, "
              f"{hist['loss_history']}")
        runs.append((hist["loss_history"], params(), timing))
    losses_p, p_ref, _ = runs[0]
    pairs = [{**param_distance(a[1], b[1]), "loss": loss_distance(a[0], b[0])}
             for i, a in enumerate(runs) for b in runs[i + 1:]]
    own = {k: max(d[k] for d in pairs) for k in pairs[0]}
    stats["run_to_run"] = {"largest": own, "pairs": pairs}
    exact = own["max_abs"] == 0.0 and own["loss"] == 0.0

    def held(what, losses, got):
        dist = {**param_distance(p_ref, got),
                "loss": loss_distance(losses_p, losses)}
        if exact:
            ok = dist["max_abs"] == 0.0 and dist["loss"] == 0.0
        else:
            ok = all(dist[k] <= 2 * own[k] for k in dist)
        check(ok, f"{what}: {dist} from the straight run, whose own "
              f"run-to-run distance is {own}")
        return dist

    # (b) K steps a dispatch
    est = estimator()
    hist, timing_k4 = train(est, LOOP_K)
    stats["k4_distance"] = held(f"K = {LOOP_K}", hist["loss_history"],
                                params())
    stats["ms_per_step_deterministic"] = {"k1": runs[-1][2],
                                          f"k{LOOP_K}": timing_k4}
    # ms a step as users train, in PyTorch's default mode (the sorted
    # index_add_ makes a deterministic step slower: PERF.md)
    with deterministic_algorithms(False):
        stats["ms_per_step"] = {f"k{k}": train(estimator(), k)[1]
                                for k in (1, LOOP_K)}
    # (c) elastic retry past a torn snapshot
    write = metrics.histogram("ckpt.write_seconds")
    verify = metrics.histogram("ckpt.verify_seconds")
    restore = metrics.histogram("ckpt.restore_seconds")
    fallback = metrics.counter("ckpt.fallback_total")
    before = (write.count(), write.sum(), verify.count(), verify.sum(),
              restore.sum(), fallback.value())
    ckpt = os.path.join(workdir, "estimator_loop_retry")
    global_config().set("checkpoint.keep", LOOP_KEEP)
    faults.reset()
    faults.arm("ckpt.corrupt", at=2)
    faults.arm("train.step", at=LOOP_FAULT_AT)
    try:
        est = estimator()
        est.set_checkpoint(ckpt, SeveralIteration(LOOP_SNAPSHOT_EVERY))
        copies, marks = [], {}
        snapshot, restore_valid, step = (est._snapshot,
                                         est._restore_latest_valid,
                                         est._train_step)

        def timed_copy():
            t0 = time.perf_counter()
            out = snapshot()
            copies.append(time.perf_counter() - t0)
            return out

        def timed_restore():
            marks["fault"] = time.perf_counter()
            return restore_valid()

        def timed_step(x, y):
            loss = step(x, y)
            if "fault" in marks and "recovered" not in marks:
                torch.cuda.synchronize()
                marks["recovered"] = time.perf_counter()
            return loss

        est._snapshot, est._restore_latest_valid = timed_copy, timed_restore
        est._train_step = timed_step
        hist, _ = train(est)
        fired = (faults.fire_count("ckpt.corrupt"),
                 faults.fire_count("train.step"))
    finally:
        faults.reset()
        global_config().unset("checkpoint.keep")
    check(fired == (1, 1), f"faults fired {fired}, expected one each")
    fell_back = fallback.value() - before[5]
    check(fell_back == 1, f"ckpt.fallback_total moved by {fell_back}")
    check(est.global_step == LOOP_STEPS, f"retried run ended at step "
          f"{est.global_step}")
    left = sorted(os.listdir(ckpt))
    want_left = [f"snapshot-{LOOP_STEPS - LOOP_SNAPSHOT_EVERY}",
                 f"snapshot-{LOOP_STEPS}"]
    check(left == want_left, f"snapshots left {left}, expected {want_left}")
    for name in left:
        check(est_mod._verify_manifest(os.path.join(ckpt, name), name),
              f"{name} has no manifest")
    # the history holds the failed attempt's first epoch and then the
    # replay from the restored snapshot: the run's own losses are the
    # steps before that snapshot and the replay's
    kept = LOOP_SNAPSHOT_EVERY
    own_losses = (hist["loss_history"][:kept]
                  + hist["loss_history"][-(LOOP_STEPS - kept):])
    stats["retry"] = {
        "distance": held("elastic retry", own_losses, params()),
        "fallbacks": fell_back, "snapshots_left": left,
        "snapshot_bytes": os.path.getsize(os.path.join(
            ckpt, left[-1], est_mod.CHECKPOINT_FILE)),
        "host_copy_s": copies, "writes": write.count() - before[0],
        "write_s": write.sum() - before[1],
        "verifies": verify.count() - before[2],
        "verify_s": verify.sum() - before[3],
        "restore_s": restore.sum() - before[4],
        "fault_to_next_good_step_s": marks["recovered"] - marks["fault"]}
    shutil.rmtree(ckpt, ignore_errors=True)
    # (d) a real SIGTERM part way through
    ckpt = os.path.join(workdir, "estimator_loop_preempt")
    late = []
    outer = signal.signal(signal.SIGTERM, lambda *_: late.append(1))
    try:
        est = estimator()
        est.set_checkpoint(ckpt, SeveralIteration(10 * LOOP_STEPS))
        delay = runs[-1][2]["wall_s"] * LOOP_SIGTERM_AT
        timer = threading.Timer(delay, os.kill, (os.getpid(),
                                                 signal.SIGTERM))
        timer.start()
        try:
            train(est)
            preempted = None
        except PreemptedError as e:
            preempted = e
        timer.join(timeout=60)
    finally:
        signal.signal(signal.SIGTERM, outer)
    check(preempted is not None and not late,
          f"no preemption from a SIGTERM at {delay:.3f} s")
    marker = Estimator.preemption_marker(ckpt)
    snap = os.path.join(ckpt, marker["snapshot"])
    check(marker["resumable"] and os.path.isdir(snap)
          and snap == preempted.snapshot,
          f"marker {marker} does not name the snapshot {preempted.snapshot}")
    stopped = est.global_step
    check(0 < stopped < LOOP_STEPS, f"preempted at step {stopped}")
    resumed = estimator()
    resumed.load_checkpoint(snap)
    hist, _ = train(resumed)
    check(resumed.global_step == LOOP_STEPS, f"resumed run ended at step "
          f"{resumed.global_step}")
    stats["preempt"] = {
        "sigterm_after_s": delay, "stopped_at_step": stopped,
        "marker": marker,
        "distance": held("resumed after preemption",
                         losses_p[:stopped] + hist["loss_history"],
                         params())}
    shutil.rmtree(ckpt, ignore_errors=True)
    # (f) train_online: TimeInterval snapshots
    ckpt = os.path.join(workdir, "estimator_loop_online")
    est = estimator()
    est.set_checkpoint(ckpt)
    t0 = time.perf_counter()
    hist = est.train_online(data(), BERT_BATCH, max_steps=LOOP_ONLINE_STEPS,
                            snapshot_interval_s=LOOP_ONLINE_INTERVAL_S)
    online_s = time.perf_counter() - t0
    snaps = [step for step, _ in est._snapshot_candidates()]
    check(hist["iterations"] == LOOP_ONLINE_STEPS and len(snaps) >= 1,
          f"train_online: {hist['iterations']} steps, snapshots {snaps}")
    stats["online"] = {"steps": hist["iterations"], "snapshots": snaps,
                       "wall_s": online_s,
                       "losses_equal_straight": hist["loss_history"]
                       == losses_p[:LOOP_ONLINE_STEPS]}
    shutil.rmtree(ckpt, ignore_errors=True)
    launches = {**at.launch_counts,
                "gather_rows": ek.launch_counts["gather_rows"],
                "routes": dict(at.route_counts)}
    stats["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del clf, model, init, est, resumed
    torch.cuda.empty_cache()
    # (e) freeze: NCF's tables frozen, 8 steps through fit
    ek.reset_launch_counts()
    pairs = ncf_pairs(np.random.default_rng(seed), FREEZE_BATCH
                      * FREEZE_STEPS)
    clicks = np.random.default_rng(seed + 1).integers(
        0, 2, len(pairs)).astype(np.float32)
    ncf = NeuralCF(**NCF).build(torch.Generator().manual_seed(seed),
                                device="cuda")
    ncf.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    ncf.model.freeze(list(NCF_TABLE_LAYERS))
    before_w = {k: v.detach().clone()
                for k, v in ncf.model.state_dict().items()}
    hist = ncf.fit(pairs, clicks, batch_size=FREEZE_BATCH, nb_epoch=1,
                   device="cuda")
    after_w = ncf.model.state_dict()
    frozen = [k for k in before_w if k.split(".")[0] in NCF_TABLE_LAYERS]
    moved = [k for k in before_w if k not in frozen]
    check(len(frozen) == len(NCF_TABLE_LAYERS) and all(
        torch.equal(after_w[k], before_w[k]) for k in frozen),
          "a frozen NCF table moved")
    still = [k for k in moved if torch.equal(after_w[k], before_w[k])]
    check(hist["iterations"] == FREEZE_STEPS and not still,
          f"NCF freeze: {hist['iterations']} steps, unmoved {still}")
    launches["gather_rows"] += ek.launch_counts["gather_rows"]
    stats["freeze"] = {"model": "NCF (MovieLens-1M width)",
                       "frozen": list(NCF_TABLE_LAYERS),
                       "steps": hist["iterations"],
                       "gather_rows": ek.launch_counts["gather_rows"],
                       "trainable_moved": len(moved)}
    want = {"fused_short_fwd": 1, "fused_short_bwd": 1, "gather_rows": 1}
    check(all(launches[k] >= v for k, v in want.items())
          and launches["routes"]["bf16_tc"] > 0,
          f"the loop launched {launches}")
    stats["launches"] = launches
    return launches, stats


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
    of ``dtype`` and heads of 256 or fewer (every caller's) must make,
    every route named, by ``FLASH_ROUTES``."""
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
                "route_f32_tc": 0, "route_wide": 0}
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
        check(routes == {"bf16_tc": 0, "f32_tc": want["fused_short_fwd"],
                         "wide": 0},
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
            # a served batch's lookups: one B9 each and nothing else
            seen = lookup_kernels(
                ek, lambda: server.model.predict(x[:SERVE_BATCH]))
            tables_n = len(NCF_TABLES)
            check(seen["lookups"] == tables_n
                  and seen["launches_per_lookup"] == [1] * tables_n
                  and all(k in ([], ["gather_int8"])
                          for k in seen["kernels_per_lookup"])
                  and (seen["kernels"] is None
                       or seen["kernels"].get("gather_int8") == tables_n),
                  f"int8: a served batch's lookups ran {seen}, expected "
                  f"{tables_n} lookups of one B9 launch each")
            if "warning" in seen:
                log(f"int8 lookups: {seen['warning']}")
            stats.update({"lookup_kernels": seen,
                          "weight_bytes_f32": wbytes,
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


#: bench_resnet50 (bench.py:394-437), north-star #2: ResNet-50, 2 classes,
#: 224 x 224 x 3, batch 256, SGD(0.1, momentum 0.9), bf16 compute; 2 warm
#: steps through Estimator.train, then 16 timed on a batch on the card and
#: 3 under the profiler
RESNET_BATCH, RESNET_SIZE, RESNET_WARM = 256, 224, 2
RESNET_TIMED, RESNET_PROFILED = 16, 3
#: the fed variant: uint8 records of 8 batches, 2 epochs (the first warms)
RESNET_FED_BATCHES = 8
#: NNClassifier: 512 uint8 images in a DataFrame, batch 64, 1 epoch
RESNET_FRAME_RECORDS, RESNET_FRAME_BATCH = 512, 64
#: the card against the CPU: ResNet-18, 10 classes, 64 x 64, f32, batch 16,
#: 4 SGD(0.1, momentum 0.9) steps
RESNET_CPU = dict(depth=18, classes=10, size=64, batch=16, steps=4)
#: card against CPU, each step from the CPU's state: the loss (relative),
#: running statistics and parameters (absolute), and the step's update of
#: all parameters (relative L2). The updates differ most in the stem
#: conv's kernel, whose gradient sums 16 x 32 x 32 positions of products
#: that nearly cancel (the images' mean of 0.5 is the largest part of every
#: stem output, and BatchNorm takes it out), so the sums' order shows: on
#: an H100 80GB HBM3 at 700 W the update differed from the CPU's by 8.6e-3
#: (relative L2) and a parameter by up to 2.4e-3, and by 6.7e-3 and
#: 1.6e-3 with PyTorch's own convolutions in place of cuDNN's, while the
#: loss and the statistics agreed within 7e-7
RESNET_CPU_TOL = dict(loss=1e-4, stats=1e-4, params=5e-3, update=2e-2)
#: a bf16 forward against the CPU's bf16, of the probabilities' scale
RESNET_BF16_TOL = 2e-2


def resnet_kernel_class(name: str) -> str:
    """The kind of a device kernel of a ResNet step, by its name: PyTorch's
    own kernels (``at::native``) by what they do, copies and fills, and
    the rest, cuDNN's convolutions (and cuBLAS's one product, the
    classifier's)."""
    n = name.lower()
    if "memcpy" in n or "memset" in n:
        return "copy"
    if "at::" not in n:
        return "cudnn"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer"
    if "reduce" in n:
        return "reduction"
    if "pool" in n:
        return "pooling"
    return "elementwise"


def resnet_layer_split(model, x: torch.Tensor, calls: int = 10) -> dict:
    """CUDA-event ms a step of the model's convolutions and BatchNorms: each
    layer's forward and backward at the input it gets in a training
    forward of ``x``, on a copy of the layer, summed by kind."""
    import copy

    from analytics_zoo_tpu_torch.keras.layers import (BatchNormalization,
                                                      Convolution2D)
    seen, hooks = [], []
    for layer in model.modules():
        if isinstance(layer, (Convolution2D, BatchNormalization)):
            hooks.append(layer.register_forward_pre_hook(
                lambda m, args: seen.append((m, args[0].shape,
                                             args[0].dtype))))
    model.train()
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    out = {"convolution_ms": 0.0, "batchnorm_ms": 0.0, "convolutions": 0,
           "batchnorms": 0}
    for layer, shape, dtype in seen:
        clone = copy.deepcopy(layer, {id(layer.dropout_generator): None})
        inp = torch.randn(shape, device=x.device, dtype=dtype,
                          requires_grad=True)
        dy = torch.randn_like(clone(inp))

        def fwd_bwd(clone=clone, inp=inp, dy=dy):
            clone(inp).backward(dy)

        ms = cuda_ms(fwd_bwd, calls, warmup=2)
        kind = ("convolution" if isinstance(layer, Convolution2D)
                else "batchnorm")
        out[f"{kind}_ms"] += ms
        out[f"{kind}s"] += 1
    return out


def _resnet_snapshot(est) -> dict:
    """CPU copies of the model's parameters and buffers and of the
    momentum trace."""
    out = {k: v.detach().cpu().clone()
           for k, v in est.model.state_dict().items()}
    trace = (est.opt_state or {}).get("trace", {})
    return {"state": out, "trace": {k: v.detach().cpu().clone()
                                    for k, v in trace.items()}}


def _finite_moved(before: dict, after: dict, keys) -> tuple:
    """(all finite, every key moved) over ``keys`` of two state dicts."""
    finite = all(bool(torch.isfinite(after[k]).all()) for k in keys)
    moved = all(not torch.equal(before[k], after[k]) for k in keys)
    return finite, moved


def phase_resnet50(at, ek, seed: int, workdir: str) -> dict:
    """ResNet-50 trained on the card (north-star #2): (a) bench_resnet50's
    configuration, (b) its fed uint8 variant, (c) NNClassifier on a
    DataFrame, (d) ResNet-18 on the card against the CPU and a checkpoint
    resume; returns stats. No kernel of the port's own is on this path:
    every launch count must stay 0."""
    _reset_counts(at, ek)
    out = {"bench": resnet_bench(seed), "fed": resnet_fed(seed),
           "nnframes": resnet_nnframes(seed),
           "card_vs_cpu": resnet_vs_cpu(seed, workdir)}
    counts = {**_lm_counts(at, ek), **_launches(ek)}
    check(not any(counts.values()), f"the ResNet path launched the port's "
          f"kernels: {counts}")
    out["port_kernel_launches"] = counts
    return out


def resnet_bench(seed: int) -> dict:
    """(a): ``resnet(50, 2)`` with bf16 compute, SGD(0.1, momentum 0.9) at
    batch 256 on seeded f32 images in [0, 1) and 0/1 labels
    (``bench.py:411-413``): two steps through ``Estimator.train`` (the
    first one timed alone), then the step on the batch on the card by CUDA
    events and the profiler, and the convolutions' and BatchNorms' share
    of it."""
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras import optimizers
    from analytics_zoo_tpu_torch.models.image import resnet

    b, s = RESNET_BATCH, RESNET_SIZE
    rs = np.random.RandomState(seed)
    x = rs.rand(b, s, s, 3).astype(np.float32)
    y = rs.randint(0, 2, b).astype(np.float32)
    model = resnet(50, num_classes=2, input_shape=(s, s, 3))
    est = Estimator(model, "sparse_categorical_crossentropy",
                    optimizers.SGD(0.1, momentum=0.9), device="cuda",
                    compute_dtype=torch.bfloat16, seed=seed)
    est._ensure_initialized(x)
    before = _resnet_snapshot(est)["state"]
    fs = FeatureSet.from_ndarrays(x, y)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(RESNET_WARM):  # one batch an epoch: a call, a step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += est.train(fs, batch_size=b, epochs=est.epoch)[
            "loss_history"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    xb, yb = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    est.model.train()
    step_ms = cuda_ms(lambda: est._train_step(xb, yb), RESNET_TIMED,
                      warmup=0)
    peak = torch.cuda.max_memory_allocated()
    prof = step_profile(lambda: est._train_step(xb, yb),
                        calls=RESNET_PROFILED, top=12, warmup=False,
                        split=resnet_kernel_class)
    after = _resnet_snapshot(est)["state"]
    params = [k for k, _ in est.model.named_parameters()]
    stats = [k for k in after if k not in set(params)]
    p_ok = _finite_moved(before, after, params)
    s_ok = _finite_moved(before, after, stats)
    check(len(losses) == RESNET_WARM and bool(np.isfinite(losses).all()),
          f"ResNet-50 losses {losses}")
    check(p_ok == (True, True), f"parameters finite and moved: {p_ok}")
    check(s_ok == (True, True), f"running statistics finite and moved: "
          f"{s_ok}")
    split = resnet_layer_split(est.model, xb.to(torch.bfloat16))
    busy = (prof["device_ms"] / step_ms if prof["device_ms"] is not None
            else None)
    # the device time the trace kept: all of it, or a lower bound where it
    # lost events
    kept_ms = sum(prof["split_ms"].values())
    return {"config": "resnet(50, num_classes=2, input_shape=(224, 224, 3))"
                      ", SGD(0.1, momentum=0.9), bf16 compute (bench.py:"
                      "394-437)",
            "batch": b, "losses": losses, "first_step_s": step_s[0],
            "second_step_s": step_s[1],
            "step_ms_events": step_ms,
            "images_per_s_events": b / step_ms * 1e3,
            "peak_memory_gib": peak / 2 ** 30,
            "step_device_ms": prof["device_ms"], "device_busy_share": busy,
            "device_busy_share_at_least": kept_ms / step_ms,
            "step_device_launches": prof["device_launches"],
            "step_issued_launches": prof["issued_launches"],
            "device_ms_by_kind": prof["split_ms"],
            "layer_ms": split,
            "step_top_kernels": prof["top_device"],
            "step_top_host_ops": prof["top_host"],
            "parameters": sum(est.model.state_dict()[k].numel()
                              for k in params)}


def resnet_fed(seed: int) -> dict:
    """(b): ``preprocess="imagenet_uint8"`` on seeded uint8 records through
    ``FeatureSet`` and the ``DeviceFeed``, bf16 compute_dtype (which casts
    float inputs only: the uint8 input stays uint8 and the preprocess makes
    it f32, so the convolutions run in f32, as in the JAX package), two
    epochs of 8 steps at wall clock, the second timed."""
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras import optimizers
    from analytics_zoo_tpu_torch.keras.layers import Convolution2D
    from analytics_zoo_tpu_torch.models.image import resnet

    b, s, n = RESNET_BATCH, RESNET_SIZE, RESNET_BATCH * RESNET_FED_BATCHES
    rs = np.random.RandomState(seed + 1)
    raw = rs.randint(0, 255, (n, s, s, 3), dtype=np.uint8)
    labels = rs.randint(0, 2, n).astype(np.float32)
    model = resnet(50, num_classes=2, input_shape=(s, s, 3),
                   preprocess="imagenet_uint8")
    est = Estimator(model, "sparse_categorical_crossentropy",
                    optimizers.SGD(0.1, momentum=0.9), device="cuda",
                    compute_dtype=torch.bfloat16, seed=seed)
    conv_dtypes = set()
    hooks = [m.register_forward_pre_hook(
        lambda m, args: conv_dtypes.add(str(args[0].dtype)))
        for m in model.modules() if isinstance(m, Convolution2D)]
    fed = FeatureSet.from_ndarrays(raw, labels, shuffle=True)
    walls, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += est.train(fed, batch_size=b, epochs=est.epoch)[
            "loss_history"]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for h in hooks:
        h.remove()
    check(len(losses) == 2 * RESNET_FED_BATCHES
          and bool(np.isfinite(losses).all()), f"fed losses {losses}")
    return {"records": n, "batch": b, "input": "uint8",
            "conv_input_dtypes": sorted(conv_dtypes),
            "first_epoch_s": walls[0], "epoch_s": walls[1],
            "images_per_s_wall": n / walls[1],
            "ms_per_step_wall": walls[1] * 1e3 / RESNET_FED_BATCHES,
            "loss_first": losses[0], "loss_last": losses[-1]}


def resnet_nnframes(seed: int) -> dict:
    """(c): ``NNClassifier`` on a pandas DataFrame of 512 seeded uint8
    images (one ``image`` column) and 0/1 labels, ``resnet(50, 2,
    preprocess="imagenet_uint8")``, batch 64, one epoch; ``transform``'s
    predictions must be 0.0 or 1.0 and equal the argmax of a direct card
    forward at the same batches (a pair of probabilities within 1e-6 of a
    tie may go either way)."""
    import pandas as pd

    from analytics_zoo_tpu_torch.models.image import resnet
    from analytics_zoo_tpu_torch.nnframes import NNClassifier

    n, b, s = RESNET_FRAME_RECORDS, RESNET_FRAME_BATCH, RESNET_SIZE
    rs = np.random.RandomState(seed + 2)
    images = rs.randint(0, 255, (n, s, s, 3), dtype=np.uint8)
    df = pd.DataFrame({"image": list(images),
                       "label": rs.randint(0, 2, n).astype(np.float64)})
    model = resnet(50, num_classes=2, input_shape=(s, s, 3),
                   preprocess="imagenet_uint8")
    clf = (NNClassifier(model, features_col="image", label_col="label",
                        device="cuda")
           .set_batch_size(b).set_max_epoch(1))
    t0 = time.perf_counter()
    fitted = clf.fit(df)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fitted.set_batch_size(b).transform(df)
    transform_s = time.perf_counter() - t0
    pred = out["prediction"].to_numpy()
    check(pred.shape == (n,) and set(np.unique(pred)) <= {0.0, 1.0},
          f"prediction column holds {np.unique(pred)}")
    model.eval()
    probs = []
    with torch.no_grad():
        for i in range(0, n, b):
            probs.append(model(torch.from_numpy(images[i:i + b]).cuda())
                         .float().cpu().numpy())
    probs = np.concatenate(probs)
    direct = np.argmax(probs, axis=-1).astype(float)
    margin = np.abs(probs[:, 0] - probs[:, 1])
    differ = (pred != direct) & (margin > 1e-6)
    check(not differ.any(), f"{int(differ.sum())} predictions differ from "
          f"the direct forward's argmax")
    hist = fitted.estimator.global_step
    return {"records": n, "batch": b, "steps": hist, "fit_s": fit_s,
            "transform_s": transform_s,
            "transform_images_per_s": n / transform_s,
            "predicted_ones": int(pred.sum()),
            "near_ties": int(((pred != direct) & ~differ).sum())}


def _step_from(est, snap: dict) -> None:
    """Put ``snap`` (a CPU :func:`_resnet_snapshot`) into ``est``'s model
    and momentum trace."""
    est._ensure_initialized()
    est.model.load_state_dict(snap["state"], strict=True)
    trace = est.opt_state.get("trace") if est.opt_state else None
    if trace is not None and snap["trace"]:
        with torch.no_grad():
            for k, v in trace.items():
                v.copy_(snap["trace"][k])


def resnet_vs_cpu(seed: int, workdir: str) -> dict:
    """(d): ResNet-18 (10 classes, 64 x 64, f32, TF32 off) on the card and
    on the CPU from the same weights, 4 SGD(0.1, momentum 0.9) steps at
    batch 16, through ``Estimator.train`` (one batch a call).

    From random weights at lr 0.1 the trajectory is chaotic: on the CPU a
    relative change of 1e-7 in the weights moves the parameters by 5e-2 in
    4 steps (ResNet-18, 64 x 64, batch 16, measured on the CPU). So the
    free runs are held at their first loss only, and each step is held
    from the same state: the card steps once from the CPU's state before
    step k (parameters, running statistics, momentum trace) and must land
    on the CPU's state after it within ``RESNET_CPU_TOL``. cuDNN runs
    deterministic algorithms here, so a checkpoint resume on the card must
    end at the straight card run's state exactly. A bf16 forward on the
    card is held to the CPU's bf16 forward within ``RESNET_BF16_TOL``."""
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras import optimizers
    from analytics_zoo_tpu_torch.models.image import resnet

    cfg = RESNET_CPU
    b, s, steps = cfg["batch"], cfg["size"], cfg["steps"]
    rs = np.random.RandomState(seed + 3)
    x = rs.rand(b * steps, s, s, 3).astype(np.float32)
    y = rs.randint(0, cfg["classes"], b * steps).astype(np.float32)
    shape = (s, s, 3)
    init = resnet(cfg["depth"], cfg["classes"], shape).build(
        torch.Generator().manual_seed(seed), device="cpu").state_dict()

    def make(dev, dtype=None):
        model = resnet(cfg["depth"], cfg["classes"], shape).build(device=dev)
        model.load_state_dict(init, strict=True)
        return Estimator(model, "sparse_categorical_crossentropy",
                         optimizers.SGD(0.1, momentum=0.9), device=dev,
                         compute_dtype=dtype, seed=seed)

    def step(est, k):
        fs = FeatureSet.from_ndarrays(x[k * b:(k + 1) * b],
                                      y[k * b:(k + 1) * b], shuffle=False)
        return est.train(fs, batch_size=b, epochs=est.epoch)[
            "loss_history"][0]

    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cpu, snaps, cpu_losses = make("cpu"), [], []
        for k in range(steps):
            snaps.append(_resnet_snapshot(cpu))
            cpu_losses.append(step(cpu, k))
        snaps.append(_resnet_snapshot(cpu))
        card = make("cuda")
        card_losses = [step(card, k) for k in range(steps)]
        straight = _resnet_snapshot(card)
        check(abs(card_losses[0] - cpu_losses[0])
              <= RESNET_CPU_TOL["loss"] * abs(cpu_losses[0]),
              f"first loss {card_losses[0]} vs the CPU's {cpu_losses[0]}")
        params = [k for k, _ in card.model.named_parameters()]
        worst = {"loss": 0.0, "stats": 0.0, "params": 0.0, "update": 0.0}
        by_step = []
        for k in range(steps):
            est = make("cuda")
            _step_from(est, snaps[k])
            loss = step(est, k)
            got = _resnet_snapshot(est)
            want, prev = snaps[k + 1], snaps[k]
            errs = {"loss": abs(loss - cpu_losses[k]) / abs(cpu_losses[k])}
            errs["stats"] = max(float((got["state"][n] - want["state"][n])
                                      .abs().max())
                                for n in want["state"] if n not in params)
            errs["params"] = max(float((got["state"][n] - want["state"][n])
                                       .abs().max()) for n in params)
            diff = sum(float((got["state"][n] - want["state"][n])
                             .double().square().sum()) for n in params)
            upd = sum(float((want["state"][n] - prev["state"][n])
                            .double().square().sum()) for n in params)
            errs["update"] = math.sqrt(diff / upd)
            errs["worst_param"] = max(
                params, key=lambda n: float((got["state"][n]
                                             - want["state"][n]).abs().max()))
            by_step.append(dict(errs))
            errs.pop("worst_param")
            for key, err in errs.items():
                worst[key] = max(worst[key], err)
                check(err <= RESNET_CPU_TOL[key], f"step {k} from the CPU's "
                      f"state: {key} error {err}")
        # checkpoint after 2 steps, resume in a fresh estimator
        first = make("cuda")
        for k in range(steps // 2):
            step(first, k)
        ckpt = os.path.join(workdir, "resnet18_step2")
        first.save_checkpoint(ckpt)
        resumed = make("cuda")
        resumed.load_checkpoint(ckpt)
        for k in range(steps // 2, steps):
            step(resumed, k)
        end = _resnet_snapshot(resumed)
        resume_err = max(float((end["state"][n] - straight["state"][n])
                               .abs().max()) for n in straight["state"])
        check(resume_err == 0.0, f"the resumed card run ends {resume_err} "
              f"from the straight one")
        # bf16 forwards of the initial weights, card against CPU
        probs = {dev: make(dev, torch.bfloat16).predict(x, batch_size=b)
                 for dev in ("cuda", "cpu")}
        bf16_err = float(np.abs(probs["cuda"] - probs["cpu"]).max()) / max(
            float(np.abs(probs["cpu"]).max()), 1e-30)
        check(bf16_err <= RESNET_BF16_TOL, f"bf16 forward {bf16_err} of "
              f"the scale from the CPU's")
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    return {"config": cfg, "optimizer": "SGD(0.1, momentum=0.9)",
            "cpu_losses": cpu_losses, "card_losses": card_losses,
            "max_err_from_cpu_state": worst, "tolerance": RESNET_CPU_TOL,
            "err_from_cpu_state_by_step": by_step,
            "max_abs_err_resumed": resume_err,
            "bf16_forward_err_of_scale": bf16_err}


#: north-star #5, Cluster Serving (bench.py:1339-1392 and :1268-1336):
#: ResNet-50 (10 classes, 224 x 224 x 3, imagenet_uint8, f32) on 224 x 224
#: jpgs over the uint8 wire in batches of 64, and BERT-base (bf16) on
#: float32 token rows of 128 through a forward function in batches of 32.
#: Each serves a burst of distinct records published before the server
#: starts, then requests one at a time, the same records as the burst's
#: first ones (their answers are held to the CPU)
RESNET_SERVE = dict(batch=64, burst=512, single=64, classes=10)
BERT_SERVE = dict(batch=32, burst=256, single=32, seq=128)
#: served probabilities against the CPU's forward from the same weights:
#: ResNet-50 f32 (TF32 off; 53 convolutions whose sums run in other
#: orders), BERT-base bf16 (``ATTN_ATOL``'s bf16 tolerance, of the
#: probabilities' scale)
SERVE_CPU_ATOL = {"resnet50": 1e-4, "bert": 2e-2}


class ServedBatches:
    """What a ``ClusterServing`` dispatched, in order: each batch's array
    as the card got it, and its uris (from the writeback, which takes the
    batches in dispatch order)."""

    def __init__(self, server):
        self.xs, self.uris = [], []
        dispatch, writeback = server._dispatch, server._writeback

        def _dispatch(x):
            self.xs.append(x)
            return dispatch(x)

        def _writeback(uris, probs, elapsed):
            self.uris.append(list(uris))
            return writeback(uris, probs, elapsed)

        server._dispatch, server._writeback = _dispatch, _writeback


def serve_burst_then_singles(server, queue, send, n_burst: int,
                             singles: list, timeout_s: float = 300):
    """Start ``server`` on the burst already published (``n_burst``
    records), wait until every one has its terminal result, then send
    ``singles`` one at a time with ``send(uri)``, each awaited; drain.
    Returns the drain seconds, the burst's batches, the stage spans and
    each single's latency in ms."""
    from analytics_zoo_tpu_torch.common.utils import timers
    timers.reset()
    t_start = time.perf_counter()
    server.start()
    try:
        deadline = time.monotonic() + timeout_s
        while (server.records_served + sum(server.counters.values())
               < n_burst and time.monotonic() < deadline):
            server.check_health()
            time.sleep(0.002)
        drain_s = time.perf_counter() - t_start
        burst_batches = server.batches_dispatched
        spans = {k: {"s": v[0], "calls": v[1]}
                 for k, v in timers.stats().items()}
        single = []
        for uri in singles:
            t = time.perf_counter()
            send(uri)
            while (queue.get_result(uri) is None
                   and time.monotonic() < deadline):
                server.check_health()
                time.sleep(0.0005)
            single.append((time.perf_counter() - t) * 1e3)
    finally:
        server.drain(timeout_s=60)
    return drain_s, burst_batches, spans, single


def served_values(outq, queue, uris: list) -> np.ndarray:
    """Every uri answered exactly once, with a value; the values."""
    results = outq.dequeue()
    check(sorted(results) == sorted(uris),
          f"{len(results)} results for {len(uris)} requests")
    check(queue.posts == {u: 1 for u in uris},
          "a request got no terminal result or more than one")
    errors = [u for u in uris if "error" in results[u]]
    check(not errors, f"{len(errors)} error results, e.g. "
          f"{results[errors[0]] if errors else None}")
    return {u: np.asarray(results[u]["value"], np.float32) for u in uris}


def held_to_direct(module, batches: ServedBatches, values: dict) -> float:
    """Each dispatched batch forwarded again on the card, padded to its
    bucket with its last row as ``InferenceModel.predict`` pads it: the
    served values within rtol 1e-5. Returns the largest difference."""
    from analytics_zoo_tpu_torch.inference.inference_model import _bucket
    check(len(batches.xs) == len(batches.uris),
          f"{len(batches.xs)} batches dispatched, {len(batches.uris)} "
          f"written back")
    worst = 0.0
    for x, uris in zip(batches.xs, batches.uris):
        n = len(uris)
        padded = np.concatenate([x, np.repeat(x[-1:], _bucket(n) - n, 0)])
        with torch.inference_mode():
            direct = module(torch.from_numpy(padded).cuda()).float().cpu() \
                .numpy()[:n]
        served = np.stack([values[u] for u in uris])
        np.testing.assert_allclose(served, direct, rtol=1e-5, atol=0)
        worst = max(worst, float(np.abs(served - direct).max()))
    return worst


def serving_figures(server, module, x_batch: np.ndarray, n_burst: int,
                    drain_s: float, burst_batches: int, spans: dict,
                    single: list) -> dict:
    """The serving line's numbers: the burst's drain rate, latencies, a
    batch's forward on a batch already on the card by CUDA events and by
    the profiler, a served predict (copy in, forward, copy out) by the
    profiler with its top kernels and host operators, the busy share, and
    the host's decode seconds a batch. Where the profiler's trace lost
    device events its device ms are null and the ``_at_least`` figures are
    the time the trace kept."""
    xb = torch.from_numpy(x_batch).cuda()
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: module(xb), 20)
        forward = step_profile(lambda: module(xb), 10,
                               split=lambda name: "kept")
    predict = step_profile(lambda: server.model.predict(x_batch), 10,
                           top=8, split=lambda name: "kept")
    predict_device_ms = predict["device_ms"]
    kept_ms = predict["split_ms"].get("kept", 0.0)
    decode = spans.get("serving.decode_batch", {"s": 0.0, "calls": 0})
    worst = int(np.argmax(single))
    return {"records_per_s": n_burst / drain_s, "burst_s": drain_s,
            "burst_batches": burst_batches,
            "batches": server.batches_dispatched,
            "burst_latency_p50_ms": server.latency_ms(0.50),
            "single_latency_p50_ms": sorted(single)[len(single) // 2],
            "single_latency_max_ms": single[worst],
            "single_latency_max_at": worst,
            "single_latency_first_ms": single[0],
            "forward_ms_batch": forward_ms,
            "forward_device_ms_batch": forward["device_ms"],
            "forward_device_ms_at_least": forward["split_ms"].get("kept"),
            "predict_device_ms_batch": predict_device_ms,
            "predict_device_ms_at_least": kept_ms,
            "predict_device_launches": predict["device_launches"],
            "predict_issued_launches": predict["issued_launches"],
            "predict_top_kernels": predict["top_device"],
            "predict_top_host_ops": predict["top_host"],
            "device_busy_share": (
                burst_batches * predict_device_ms / (drain_s * 1e3)
                if predict_device_ms is not None else None),
            "device_busy_share_at_least":
                burst_batches * kept_ms / (drain_s * 1e3),
            "decode_s_per_batch": decode["s"] / max(decode["calls"], 1),
            "batch_bytes_to_card": int(x_batch.nbytes),
            "spans": spans}


def spool_record_bytes(spool_dir: str) -> float:
    """Mean size of the request files waiting in the spool."""
    req = os.path.join(spool_dir, "requests")
    sizes = [os.path.getsize(os.path.join(req, f)) for f in os.listdir(req)
             if not f.startswith(".")]
    return sum(sizes) / max(len(sizes), 1)


def phase_resnet50_serving(at, ek, seed: int, workdir: str) -> dict:
    """ResNet-50 served on the card (north-star #5, ``bench_serving``):
    ``resnet(50, 10, (224, 224, 3), preprocess="imagenet_uint8")`` with
    seeded weights in f32, ``ClusterServing`` at batch 64 with
    ``input_dtype: uint8``, 512 distinct seeded 224 x 224 jpgs (base64)
    published before the server starts, then 64 of them one at a time.
    Every request gets one value; each batch reaches the card as uint8,
    its rows ``decode_image`` of their payloads bit for bit; the values
    equal a direct card forward of the same batches (rtol 1e-5) and the
    CPU's forward from the same weights (``SERVE_CPU_ATOL``, the first 64
    records' burst and single answers); ``filter_top_n`` answers carry the
    values' classes. No kernel of the port's own is on this path: every
    launch count stays 0. Returns stats."""
    import cv2

    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models.image import resnet
    from analytics_zoo_tpu_torch.serving import (ClusterServing, FileQueue,
                                                 InputQueue, OutputQueue,
                                                 ServingConfig)
    from analytics_zoo_tpu_torch.serving.queues import (decode_image,
                                                        encode_image)

    cfg_s = RESNET_SERVE
    b, n, s = cfg_s["batch"], cfg_s["burst"], RESNET_SIZE
    _reset_counts(at, ek)
    t0 = time.perf_counter()
    model = resnet(50, num_classes=cfg_s["classes"], input_shape=(s, s, 3),
                   preprocess="imagenet_uint8").build(
        torch.Generator().manual_seed(seed), device="cuda")
    im = InferenceModel(concurrent_num=2, device="cuda").load_keras(model)
    spool_dir = os.path.join(workdir, "resnet_spool")
    src = "dir://" + spool_dir
    cfg = ServingConfig(data_src=src, batch_size=b, batch_wait_ms=5,
                        input_dtype="uint8", image_shape=(s, s, 3))
    queue = CountingQueue(FileQueue(spool_dir))
    server = ClusterServing(cfg, model=im, queue=queue)
    up_s = time.perf_counter() - t0
    batches = ServedBatches(server)
    rs = np.random.RandomState(seed + 5)
    jpgs = [cv2.imencode(".jpg", rs.randint(0, 256, (s, s, 3),
                                            dtype=np.uint8))[1].tobytes()
            for _ in range(n)]
    payloads = {f"req-{i}": encode_image(j) for i, j in enumerate(jpgs)}
    singles = [f"one-{j}" for j in range(cfg_s["single"])]
    payloads.update({u: payloads[f"req-{j}"] for j, u in enumerate(singles)})
    inq, outq = InputQueue(src), OutputQueue(src)
    t0 = time.perf_counter()
    for i, jpg in enumerate(jpgs):
        inq.enqueue_image(f"req-{i}", jpg)
    enqueue_s = time.perf_counter() - t0
    record_bytes = spool_record_bytes(spool_dir)
    drain_s, burst_batches, spans, single = serve_burst_then_singles(
        server, queue,
        lambda uri: inq.enqueue_image(uri, jpgs[int(uri[4:])]), n, singles)
    uris = list(payloads)
    values = served_values(outq, queue, uris)
    check(all(v.shape == (cfg_s["classes"],) and np.isfinite(v).all()
              for v in values.values()), "served values malformed")
    # the wire: uint8 up to the card, each row its payload's pixels
    for x, batch_uris in zip(batches.xs, batches.uris):
        check(x.dtype == np.uint8 and x.shape[1:] == (s, s, 3),
              f"a batch reached the card as {x.dtype} {x.shape}")
        for row, uri in zip(x, batch_uris):
            check(np.array_equal(row, decode_image(payloads[uri])),
                  f"{uri}: served pixels differ from decode_image")
    err_direct = held_to_direct(model, batches, values)
    firsts = [f"req-{j}" for j in range(len(singles))]
    pixels = np.stack([decode_image(payloads[u]) for u in firsts])
    figures = serving_figures(server, model, pixels[:b], n, drain_s,
                              burst_batches, spans, single)
    # the CPU from the same weights, on the first 64 records (burst and
    # single answers)
    t0 = time.perf_counter()
    cpu = resnet(50, num_classes=cfg_s["classes"], input_shape=(s, s, 3),
                 preprocess="imagenet_uint8").build(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        strict=True)
    cpu.eval()
    with torch.inference_mode():
        want = np.concatenate([cpu(torch.from_numpy(pixels[i:i + 16]))
                               .numpy() for i in range(0, len(firsts), 16)])
    cpu_s = time.perf_counter() - t0
    err_cpu = 0.0
    for group in (firsts, singles):
        got = np.stack([values[u] for u in group])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SERVE_CPU_ATOL["resnet50"])
        err_cpu = max(err_cpu, float(np.abs(got - want).max()))
    # filter_top_n: the first batch's records again, answered as top 5
    top_dir = os.path.join(workdir, "resnet_top")
    top_src = "dir://" + top_dir
    top_server = ClusterServing(ServingConfig(
        data_src=top_src, batch_size=b, batch_wait_ms=5, input_dtype="uint8",
        image_shape=(s, s, 3), filter_top_n=5), model=im,
        queue=FileQueue(top_dir))
    top_in = InputQueue(top_src)
    for u in firsts:
        top_in.enqueue_image(u, jpgs[int(u[4:])])
    served = 0
    while served < len(firsts):
        got = top_server.serve_once()
        check(got > 0, "the top-N server claimed nothing")
        served += got
    tops = OutputQueue(top_src).dequeue()
    swapped = 0
    for u in firsts:
        classes = [t["class"] for t in tops[u]["topN"]]
        v = values[u]
        rank = list(np.argsort(-v)[:5])
        # a swap only between probabilities equal within rtol 1e-5 (the
        # top-N forward's batch is not the value's)
        np.testing.assert_allclose(v[classes], v[rank], rtol=1e-5, atol=0)
        np.testing.assert_allclose([t["prob"] for t in tops[u]["topN"]],
                                   v[classes], rtol=1e-5, atol=0)
        swapped += classes != rank
    counts = {**_lm_counts(at, ek), **_launches(ek)}
    check(not any(counts.values()), f"ResNet serving launched the port's "
          f"kernels: {counts}")
    return {"config": "resnet(50, num_classes=10, input_shape=(224, 224, 3)"
                      ", preprocess='imagenet_uint8'), f32, batch 64, "
                      "input_dtype uint8 (bench.py:1339-1392)",
            "requests": len(uris), "burst": n, "single": len(singles),
            "server_up_s": up_s, "enqueue_records_per_s": n / enqueue_s,
            "record_bytes": record_bytes, **figures,
            "max_abs_err_vs_card_forward": err_direct,
            "max_abs_err_vs_cpu": err_cpu, "cpu_check_s": cpu_s,
            "cpu_atol": SERVE_CPU_ATOL["resnet50"],
            "top5_near_tie_swaps": swapped,
            "port_kernel_launches": counts}


def phase_bert_serving(at, ek, seed: int, workdir: str):
    """BERT-base served on the card (north-star #5, ``bench.py``'s
    ``_bert_serving_rate``): ``BERTClassifier(2)`` at ``BERT_CFG`` in bf16
    with seeded weights, through ``InferenceModel.load_forward`` with
    ``bert_serving_forward`` (the four-array input built on the card from
    float32 token rows), ``ClusterServing`` at batch 32: a burst of 256
    seeded padded records, then 32 of them one at a time. Every request
    gets one value, equal to a direct card forward of the same batches
    (rtol 1e-5) and to the CPU's bf16 forward from the same weights
    (``SERVE_CPU_ATOL``, the first 32 records' burst and single answers);
    a served batch launches 12 B7 on the bf16 route, 3 B1 and no B8.
    Returns (launches, stats)."""
    from analytics_zoo_tpu_torch.capture import (BERTClassifier,
                                                 bert_serving_forward)
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing, FileQueue,
                                                 InputQueue, OutputQueue,
                                                 ServingConfig)

    cfg_s = BERT_SERVE
    b, n, seq = cfg_s["batch"], cfg_s["burst"], cfg_s["seq"]
    bert_cfg = dict(BERT_CFG, compute_dtype="bfloat16")
    blocks = bert_cfg["n_block"]
    t0 = time.perf_counter()
    clf = BERTClassifier(2, bert_config=bert_cfg).build(
        seq, torch.Generator().manual_seed(seed), device="cuda")
    params = {k: v.detach().cpu() for k, v in clf.model.state_dict().items()}
    im = InferenceModel(concurrent_num=2, device="cuda").load_forward(
        bert_serving_forward(clf.model), params)
    spool_dir = os.path.join(workdir, "bert_spool")
    src = "dir://" + spool_dir
    cfg = ServingConfig(data_src=src, batch_size=b, batch_wait_ms=5,
                        input_dtype="float32", image_shape=(seq,))
    queue = CountingQueue(FileQueue(spool_dir))
    server = ClusterServing(cfg, model=im, queue=queue)
    up_s = time.perf_counter() - t0
    batches = ServedBatches(server)
    tokens, _ = bert_records(seed + 6, n, seq)
    rows = tokens.astype(np.float32)  # exact: every id is below 2^24
    singles = [f"one-{j}" for j in range(cfg_s["single"])]
    inq, outq = InputQueue(src), OutputQueue(src)
    t0 = time.perf_counter()
    for i, row in enumerate(rows):
        inq.enqueue_tensor(f"req-{i}", row)
    enqueue_s = time.perf_counter() - t0
    record_bytes = spool_record_bytes(spool_dir)
    _reset_counts(at, ek)
    drain_s, burst_batches, spans, single = serve_burst_then_singles(
        server, queue, lambda uri: inq.enqueue_tensor(uri, rows[int(
            uri[4:])]), n, singles)
    launches = {**at.launch_counts, "routes": dict(at.route_counts),
                "gather_rows": ek.launch_counts["gather_rows"]}
    k = server.batches_dispatched
    want_launches = {"fused_short_fwd": blocks * k, "fused_short_bwd": 0,
                     "routes": {"bf16_tc": blocks * k, "f32_tc": 0,
                                "wide": 0},
                     "gather_rows": 3 * k}
    check(launches == want_launches, f"{k} served batches launched "
          f"{launches}, expected {want_launches}")
    uris = [f"req-{i}" for i in range(n)] + singles
    values = served_values(outq, queue, uris)
    check(all(v.shape == (2,) and np.isfinite(v).all()
              for v in values.values()), "served values malformed")
    check(all(x.dtype == np.float32 for x in batches.xs),
          "a token batch reached the card as another dtype than float32")
    err_direct = held_to_direct(im._module, batches, values)
    figures = serving_figures(server, im._module, rows[:b], n, drain_s,
                              burst_batches, spans, single)
    t0 = time.perf_counter()
    cpu_clf = BERTClassifier(2, bert_config=bert_cfg).build(seq,
                                                            device="cpu")
    want = InferenceModel(device="cpu").load_forward(
        bert_serving_forward(cpu_clf.model), params).predict(
        rows[:len(singles)])
    cpu_s = time.perf_counter() - t0
    err_cpu = 0.0
    for group in ([f"req-{j}" for j in range(len(singles))], singles):
        got = np.stack([values[u] for u in group])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SERVE_CPU_ATOL["bert"])
        err_cpu = max(err_cpu, float(np.abs(got - want).max()))
    stats = {"config": "BERTClassifier(2), vocab 30522, hidden 768, 12 "
                       "blocks, 12 heads, intermediate 3072, bf16, batch "
                       "32, seq 128 (bench.py:1268-1336)",
             "requests": len(uris), "burst": n, "single": len(singles),
             "server_up_s": up_s, "enqueue_records_per_s": n / enqueue_s,
             "record_bytes": record_bytes, **figures,
             "launches": launches, "launches_per_batch": {
                 "fused_short_fwd": launches["fused_short_fwd"] / k,
                 "gather_rows": launches["gather_rows"] / k},
             "max_abs_err_vs_card_forward": err_direct,
             "max_abs_err_vs_cpu": err_cpu, "cpu_check_s": cpu_s,
             "cpu_atol": SERVE_CPU_ATOL["bert"]}
    return launches, stats


#: heads past 128: B7/B8 at d 256 in both dtypes, [b, h, s, d]
#: (the longest sequence the fused kernels take), no bias, no dropout,
#: timed beside their plain versions and scaled_dot_product_attention
ATTN_WIDE_TIMED = (16, 8, 512, 256)
#: B4, B5a, B5b and B6 at d 256, causal, beside the same: bf16 takes B6
#: (2048 keys of 256 are under the one-pass rule's bytes), f32 B5a + B5b
FLASH_WIDE_TIMED = (("d256_bf16", (4, 8, 2048, 256), torch.bfloat16),
                    ("d256_f32", (4, 8, 2048, 256), torch.float32))
#: a TransformerLM step with heads of 256: hidden 2048 in 8 heads (the
#: attention width of Gemma-2B's heads, without its multi-query sharing,
#: which the JAX LM lacks), depth 2 (cut for time), f32, batch 8 x 2048:
#: each block launches B4, B5a and B5b (8.4 MB resident a head, past the
#: one-pass rule's 6.6 MB)
LM_WIDE = dict(LM_CFG, n_block=2, n_head=8)
LM_WIDE_BATCH, LM_WIDE_STEPS = 8, 2
#: a bf16 flash step at d 256, causal (B4 and B6), CUDA events
FLASH_WIDE_STEP = (4, 8, 2048, 256)
#: bench_quantized's configuration (bench.py:3020-3082): ResNet-18, 1000
#: classes, 224 x 224, f32, seeded weights and images in [0, 1), batch 32;
#: calibrated int8 on the first 8 images
QUANT_RESNET = dict(depth=18, classes=1000, size=224, batch=32, calib=8)
#: forwards timed by CUDA events, then under the profiler
QUANT_TIMED, QUANT_PROFILED = 20, 3
#: images of each conv's int8 input whose int32 sums are held bit for bit,
#: card against CPU
QUANT_EXACT_IMAGES = 2
#: the card's calibrated int8 ResNet-18 against the CPU's from the same
#: quantized weights and activation scales (the probabilities): the int32
#: sums are equal, the f32 around them (the scale products, BatchNorm in
#: eval, the pooling, the softmax) is summed in other orders, and where an
#: activation lands on a rounding tie its code moves by one (3.3e-6 on an
#: H100 80GB HBM3 at 700 W)
QUANT_CARD_CPU_ATOL = 1e-5
#: the activation scales calibrated on the card against the CPU's (f32
#: activations from cuDNN's convolutions, TF32 off, against the CPU's;
#: 1.9e-6 on the H100)
QUANT_SCALE_RTOL = 1e-5
#: bench_resnet50_int8's configuration (bench.py:521-560), not cut:
#: resnet(50, 2, (224, 224, 3), dataflow="int8"), SGD(0.1, momentum 0.9),
#: bf16 compute, batch 256 of seeded images in [0, 1); 2 warm steps through
#: Estimator.train, then the step timed by CUDA events and the profiler
INT8_RESNET_BATCH, INT8_RESNET_WARM = 256, 2
INT8_RESNET_TIMED, INT8_RESNET_PROFILED = 8, 2
#: card against CPU, each step from the CPU's state: ResNet-18, 10
#: classes, 64 x 64, batch 16, bf16 compute, SGD(0.1, momentum 0.9), for
#: the int8 dataflow and for int8_training (f32 compute there)
INT8_CPU = dict(depth=18, classes=10, size=64, batch=16, steps=3)
#: the card's step against the CPU's from the same state: the loss
#: (relative), the update of all parameters (relative L2) and the state
#: (each tensor of its scale). The int32 sums are equal and the scales are
#: the CPU's (``per_127``, ``_rsqrt``). Dataflow: its batch statistics are
#: f32 sums in other orders, and a code at a rounding tie moves by one.
#: int8_training: its BatchNormalization layers take ``exact_statistics``
#: (f64 sums rounded once, a correctly rounded ``1 / sqrt``, no fused
#: multiply-add), so the forward's codes are the CPU's: without it one
#: flipped code moved about ten codes of the next layer, 40% of the last
#: stage's codes differed and the update was 0.44 apart (H100, 700 W).
#: What is left is the bf16 gradients' sums (cuDNN's order) and the head's
#: f32 sums. On an H100 80GB HBM3 at 700 W the worst of 3 steps were,
#: dataflow: loss 6.8e-4, update 9.9e-3, state 8.5e-7; int8_training:
#: loss 9.6e-8, update 8.8e-3, state 0 (no code flipped in any of the 20
#: convs). Each bound is about twice that (the state's one f32 unit)
INT8_CPU_TOL = {"dataflow": dict(loss=2e-3, update=2e-2, state=2e-6),
                "int8_training": dict(loss=2e-7, update=2e-2, state=1e-7)}
#: one int8_training conv at a ResNet-50 3x3 shape, timed alone (forward
#: and backward) beside the bf16 convolution: input [256, 56, 56, 64], 64
#: filters, SAME
INT8_CONV_TIMED = ((256, 56, 56, 64), 64, 3)
#: the H100 SXM's dense int8 tensor-core rate (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12


def int8_kernel_class(name: str) -> str:
    """The kind of a device kernel of an int8 ResNet forward or step:
    cuBLASLt's int8 GEMMs (``s8``/``i8``/``imma`` in their names), then
    ``resnet_kernel_class``'s kinds (cuDNN's float convolutions, which an
    int8 forward must not launch, and its dgrad and wgrad in a step;
    PyTorch's elementwise, reduction and pooling kernels; copies and
    fills)."""
    n = name.lower()
    if "at::" not in n and re.search(r"s8|i8|imma|int8|igemm", n):
        return "int8_gemm"
    return resnet_kernel_class(name)


#: a float convolution's or float product's kernel, by its name (cuDNN's
#: convolutions, cuBLAS's float GEMMs): an int8 forward launches none
_FLOAT_CONV_OR_GEMM = re.compile(
    r"conv|fprop|dgrad|wgrad|cudnn|sgemm|hgemm|f32f32|bf16bf16|f16f16|"
    r"gemm_f32|gemm_bf16", re.I)


def _seeded_resnet(cfg, dev, seed: int, **kw):
    from analytics_zoo_tpu_torch.models.image import resnet
    return resnet(cfg["depth"], cfg["classes"],
                  (cfg["size"], cfg["size"], 3), **kw).build(
        torch.Generator().manual_seed(seed), device=dev)


def int8_conv_bound_ms(n, oh, ow, k_taps, cout) -> float:
    """Least time of an int8 conv's products at the dense int8 rate: 2 ops
    a multiply-add."""
    return 2.0 * n * oh * ow * k_taps * cout / PEAK_INT8_OPS * 1e3


def phase_resnet18_quantized(seed: int) -> dict:
    """bench_quantized's configuration through ``InferenceModel`` on the
    card: fp32, ``quantize("bf16")`` and ``quantize("int8",
    calibration_data=[x[:8]])``. Images/s of each forward by CUDA events;
    the int8 forward's device ms by kind (its int8 GEMMs, the patch copies
    by their profiler range, the rest) and no float convolution; drift and
    argmax agreement of bf16 and int8 against f32; every calibrated conv's
    int32 sums on the card equal to the CPU's bit for bit; the activation
    scales against the CPU's, and the card's int8 answers against the
    CPU's from the same quantized weights and scales."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.inference.quantize import QuantizedWeight
    from analytics_zoo_tpu_torch.keras.layers import Convolution2D
    from analytics_zoo_tpu_torch.ops.int8_dataflow import int8_conv2d

    cfg = QUANT_RESNET
    b, s = cfg["batch"], cfg["size"]
    x = np.random.RandomState(seed).rand(b, s, s, 3).astype(np.float32)
    calib = [x[:cfg["calib"]]]
    init = _seeded_resnet(cfg, "cpu", seed).state_dict()

    def served(dev, mode):
        model = _seeded_resnet(cfg, dev, seed)
        model.load_state_dict(init, strict=True)
        im = InferenceModel(device=dev).load_keras(model)
        if mode == "int8":
            return im.quantize("int8", calibration_data=calib)
        return im if mode == "fp32" else im.quantize(mode)

    xb = torch.from_numpy(x).cuda()
    out = {"config": f"resnet({cfg['depth']}, num_classes="
                     f"{cfg['classes']}, input_shape=({s}, {s}, 3)), f32, "
                     f"seeded weights (bench.py:3020-3082)", "batch": b}
    probs = {}
    for mode in ("fp32", "bf16", "int8"):
        im = served("cuda", mode)
        module = im._module

        def fwd(module=module):
            with torch.inference_mode():
                return module(xb)

        ms = cuda_ms(fwd, QUANT_TIMED, warmup=3)
        probs[mode] = im.predict(x, batch_size=b)
        out[mode] = {"forward_ms_events": ms,
                     "images_per_s_events": b / ms * 1e3}
        if mode != "int8":
            continue
        prof = step_profile(fwd, calls=QUANT_PROFILED, top=8,
                            split=int8_kernel_class)
        kinds = prof["split_ms"]
        convs = [m for m in module.modules()
                 if isinstance(m, Convolution2D)]
        check(len(convs) == 20 and all(
            isinstance(m.kernel, QuantizedWeight)
            and m.kernel.act_scale is not None for m in convs),
            "calibrated int8 left a conv unquantized")
        library = [n for n in prof["kernel_names"] if "at::" not in n]
        floats = [n for n in library if int8_kernel_class(n) != "int8_gemm"
                  and _FLOAT_CONV_OR_GEMM.search(n)]
        check(kinds.get("int8_gemm", 0.0) > 0.0 and not floats,
              f"the int8 forward's device ms by kind {kinds}: it must run "
              f"int8 GEMMs and no float convolution or product, ran "
              f"{floats}")
        out["int8"].update({
            "device_ms": prof["device_ms"],
            "device_ms_by_kind": kinds,
            "patch_copy_device_ms": prof["patch_device_ms"],
            "top_kernels": prof["top_device"],
            "library_kernels": [n[:96] for n in library],
            "int8_gemm_bound_ms": 0.0})
        # every calibrated conv's int8 sums, card against CPU, bit for bit
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda m, args: seen.append((m, args[0]))) for m in convs]
        try:
            fwd()
        finally:
            for h in hooks:
                h.remove()
        n_img = QUANT_EXACT_IMAGES
        for m, inp in seen:
            qw = m.kernel
            xq = torch.clamp(torch.round(inp[:n_img].float() / qw.act_scale),
                             -127, 127).to(torch.int8)
            card = int8_conv2d(xq, qw.q, m.strides, m.padding, m.dilation,
                               m.groups)
            host = int8_conv2d(xq.cpu(), qw.q.cpu(), m.strides, m.padding,
                               m.dilation, m.groups)
            check(card.dtype == torch.int32 and torch.equal(card.cpu(), host),
                  f"{m.name}: the card's int32 sums differ from the CPU's")
            n_, oh, ow, cout = card.shape
            kh, kw_, cg, _ = qw.q.shape
            out["int8"]["int8_gemm_bound_ms"] += int8_conv_bound_ms(
                b, oh, ow, kh * kw_ * cg, cout)
        out["int8"]["convs_bit_equal_to_cpu"] = len(seen)
    for mode in ("bf16", "int8"):
        out[mode]["max_abs_drift_vs_fp32"] = float(
            np.abs(probs[mode] - probs["fp32"]).max())
        out[mode]["argmax_agreement_vs_fp32"] = float(
            (probs[mode].argmax(1) == probs["fp32"].argmax(1)).mean())
    # the CPU's calibration, and its quantized weights and scales on the
    # card
    cpu = served("cpu", "int8")
    card = served("cuda", "int8")
    scale_err = max(abs(card._act_scales[k] - v) / v
                    for k, v in cpu._act_scales.items())
    check(set(card._act_scales) == set(cpu._act_scales)
          and scale_err <= QUANT_SCALE_RTOL,
          f"activation scales {scale_err} (relative) from the CPU's")
    card._module.load_state_dict(cpu._module.state_dict(), strict=True)
    got, want = card.predict(x, batch_size=b), cpu.predict(x, batch_size=b)
    err = float(np.abs(got - want).max())
    check(err <= QUANT_CARD_CPU_ATOL, f"calibrated int8 on the card {err} "
          f"from the CPU's")
    out["int8"].update({"act_scale_max_rel_err_vs_cpu": scale_err,
                        "max_abs_err_vs_cpu": err,
                        "argmax_agreement_vs_cpu": float(
                            (got.argmax(1) == want.argmax(1)).mean()),
                        "cpu_atol": QUANT_CARD_CPU_ATOL})
    return out


def int8_card_vs_cpu(seed: int, kind: str) -> dict:
    """``INT8_CPU``'s ResNet-18 (``dataflow="int8"`` in bf16, or
    ``int8_training`` in f32) stepped on the CPU, then on the card from the
    CPU's state before each step: the loss, the update and the state
    against ``INT8_CPU_TOL``; the free card run's losses finite."""
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras import optimizers

    cfg, tol = INT8_CPU, INT8_CPU_TOL[kind]
    b, s, steps = cfg["batch"], cfg["size"], cfg["steps"]
    rs = np.random.RandomState(seed + 5)
    x = rs.rand(b * steps, s, s, 3).astype(np.float32)
    y = rs.randint(0, cfg["classes"], b * steps).astype(np.float32)
    kw = ({"dataflow": "int8"} if kind == "dataflow"
          else {"int8_training": True})
    dtype = torch.bfloat16 if kind == "dataflow" else None
    init = _seeded_resnet(cfg, "cpu", seed, **kw).state_dict()

    def make(dev):
        model = _seeded_resnet(cfg, dev, seed, **kw)
        model.load_state_dict(init, strict=True)
        return Estimator(model, "sparse_categorical_crossentropy",
                         optimizers.SGD(0.1, momentum=0.9), device=dev,
                         compute_dtype=dtype, seed=seed)

    def step(est, k):
        fs = FeatureSet.from_ndarrays(x[k * b:(k + 1) * b],
                                      y[k * b:(k + 1) * b], shuffle=False)
        return est.train(fs, batch_size=b, epochs=est.epoch)[
            "loss_history"][0]

    cpu, snaps, cpu_losses = make("cpu"), [], []
    for k in range(steps):
        snaps.append(_resnet_snapshot(cpu))
        cpu_losses.append(step(cpu, k))
    snaps.append(_resnet_snapshot(cpu))
    card = make("cuda")
    card_losses = [step(card, k) for k in range(steps)]
    check(bool(np.isfinite(card_losses).all()), f"{kind} card losses "
          f"{card_losses}")
    params = [k for k, _ in card.model.named_parameters()]
    by_step = []
    for k in range(steps):
        est = make("cuda")
        _step_from(est, snaps[k])
        loss = step(est, k)
        got = _resnet_snapshot(est)["state"]
        want, prev = snaps[k + 1]["state"], snaps[k]["state"]
        diff = sum(float((got[n] - want[n]).double().square().sum())
                   for n in params)
        upd = sum(float((want[n] - prev[n]).double().square().sum())
                  for n in params)
        errs = {"loss": abs(loss - cpu_losses[k]) / abs(cpu_losses[k]),
                "update": math.sqrt(diff / max(upd, 1e-300)),
                "state": max(float((got[n] - want[n]).abs().max())
                             / max(float(want[n].abs().max()), 1e-30)
                             for n in want if n not in params)}
        by_step.append(errs)
        for key, err in errs.items():
            check(err <= tol[key], f"{kind} step {k} from the CPU's state: "
                  f"{key} error {err}")
    return {"config": cfg, "kind": kind, "cpu_losses": cpu_losses,
            "card_losses": card_losses, "err_from_cpu_state_by_step": by_step,
            "tolerance": tol}


def phase_resnet50_int8(at, ek, seed: int, bf16_reference: dict) -> dict:
    """bench_resnet50_int8's configuration on the card: 2 warm steps
    through ``Estimator.train``, then the step on a batch on the card by
    CUDA events and the profiler (device ms by kind, the patch copies by
    their profiler range, busy share, peak memory); phase 16's bf16 ResNet-50
    step from this run beside it (a reference, not a claim); then ResNet-18
    card against CPU from the same state. No kernel of the port's own runs
    on this path."""
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.keras import optimizers
    from analytics_zoo_tpu_torch.models.image import resnet

    _reset_counts(at, ek)
    b, s = INT8_RESNET_BATCH, RESNET_SIZE
    rs = np.random.RandomState(seed)
    x = rs.rand(b, s, s, 3).astype(np.float32)
    y = rs.randint(0, 2, b).astype(np.float32)
    model = resnet(50, num_classes=2, input_shape=(s, s, 3), dataflow="int8")
    est = Estimator(model, "sparse_categorical_crossentropy",
                    optimizers.SGD(0.1, momentum=0.9), device="cuda",
                    compute_dtype=torch.bfloat16, seed=seed)
    est._ensure_initialized(x)
    before = _resnet_snapshot(est)["state"]
    fs = FeatureSet.from_ndarrays(x, y)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(INT8_RESNET_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += est.train(fs, batch_size=b, epochs=est.epoch)[
            "loss_history"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    xb, yb = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    est.model.train()
    step_ms = cuda_ms(lambda: est._train_step(xb, yb), INT8_RESNET_TIMED,
                      warmup=0)
    peak = torch.cuda.max_memory_allocated()
    prof = step_profile(lambda: est._train_step(xb, yb),
                        calls=INT8_RESNET_PROFILED, top=12, warmup=False,
                        split=int8_kernel_class)
    after = _resnet_snapshot(est)["state"]
    params = [k for k, _ in est.model.named_parameters()]
    stats = [k for k in after if k not in set(params)]
    check(len(losses) == INT8_RESNET_WARM
          and bool(np.isfinite(losses).all()), f"int8 ResNet-50 losses "
          f"{losses}")
    check(_finite_moved(before, after, params) == (True, True),
          "int8 ResNet-50 parameters not finite and moved")
    check(_finite_moved(before, after, stats)[0],
          "int8 ResNet-50 state not finite")
    check(prof["split_ms"].get("int8_gemm", 0.0) > 0.0,
          f"the int8 step launched no int8 GEMM: {prof['split_ms']}")
    counts = {**_lm_counts(at, ek), **_launches(ek)}
    check(not any(counts.values()), f"the int8 ResNet path launched the "
          f"port's kernels: {counts}")
    kept_ms = sum(prof["split_ms"].values())
    out = {"config": "resnet(50, num_classes=2, input_shape=(224, 224, 3), "
                     "dataflow='int8'), SGD(0.1, momentum=0.9), bf16 compute"
                     " (bench.py:521-560)",
           "batch": b, "losses": losses, "first_step_s": step_s[0],
           "second_step_s": step_s[1], "step_ms_events": step_ms,
           "images_per_s_events": b / step_ms * 1e3,
           "peak_memory_gib": peak / 2 ** 30,
           "step_device_ms": prof["device_ms"],
           "device_busy_share": (prof["device_ms"] / step_ms
                                 if prof["device_ms"] is not None else None),
           "device_busy_share_at_least": kept_ms / step_ms,
           "device_ms_by_kind": prof["split_ms"],
           "patch_copy_device_ms": prof["patch_device_ms"],
           "step_top_kernels": prof["top_device"],
           "step_top_host_ops": prof["top_host"],
           "bf16_resnet50_step_ms_events_same_run":
               bf16_reference.get("step_ms_events"),
           "bf16_resnet50_images_per_s_same_run":
               bf16_reference.get("images_per_s_events"),
           "port_kernel_launches": counts}
    del est, model, xb, yb
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = int8_card_vs_cpu(seed, "dataflow")
    return out


def phase_int8_training(seed: int) -> dict:
    """``resnet(18, int8_training=True)`` card against CPU from the same
    state, then one ``Convolution2D(int8_training=True)`` at a ResNet-50
    3x3 shape timed alone (forward and backward) beside the bf16 conv."""
    from analytics_zoo_tpu_torch.keras.layers import Convolution2D

    out = {"card_vs_cpu": int8_card_vs_cpu(seed, "int8_training")}
    shape, filters, k = INT8_CONV_TIMED
    x = torch.randn(shape, device="cuda").to(torch.bfloat16)
    timed = {}
    for name, int8 in (("int8_training", True), ("bf16", False)):
        layer = Convolution2D(filters, k, k, border_mode="same", bias=False,
                              int8_training=int8)
        layer.build(torch.Generator().manual_seed(seed), (None,)
                    + shape[1:], torch.device("cuda"))
        inp = x.clone().requires_grad_()
        dy = torch.randn_like(layer(inp))

        def fwd(layer=layer, inp=inp):
            return layer(inp)

        def fwd_bwd(layer=layer, inp=inp, dy=dy):
            layer(inp).backward(dy)

        timed[name] = {"forward_ms_events": cuda_ms(fwd, 10, warmup=2),
                       "forward_backward_ms_events": cuda_ms(fwd_bwd, 10,
                                                             warmup=2)}
    n, h, w, c = shape
    out["conv"] = {"input": list(shape), "filters": filters, "kernel": k,
                   **timed,
                   "int8_gemm_bound_ms": int8_conv_bound_ms(
                       n, h, w, k * k * c, filters)}
    return out


def phase_wide_heads(at, ek, dev, seed: int) -> dict:
    """Heads of 256 on the card: B7/B8 and B4, B5a, B5b, B6 at d 256 timed
    beside their plain versions and SDPA (each held to its plain version);
    a TransformerLM step with heads of 256 (f32, B4, B5a and B5b); a bf16
    flash step at d 256 (B4 and B6); returns (launches by path, stats)."""
    from analytics_zoo_tpu_torch.capture import TransformerLM

    gen = torch.Generator().manual_seed(seed)
    seed_t = torch.tensor([seed + 17], dtype=torch.int32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    stats = {"fused": {}}
    b, h, s, d = ATTN_WIDE_TIMED
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, _ = _attn_case(dev, b, h, s, d, dtype, gen)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd(leaves=leaves, do=do):
            sdpa(*leaves).backward(do)

        t = _attn_timing(at, q, k, v, do, (None, seed_t, d ** -0.5, 0.0,
                                           False),
                         lambda q=q, k=k, v=v: sdpa(q, k, v), sdpa_fwd_bwd)
        peak = PEAK_FLOPS_3XTF32 if dtype == torch.float32 else None
        for bwd in (False, True):
            t["bwd_bound" if bwd else "fwd_bound"] = list(
                attention_bound_ms(b, h, s, d, dtype, bwd, bias=False,
                                   peak=peak))
        t["shape"] = [b, h, s, d]
        stats["fused"][str(dtype).split(".")[-1]] = t
        log(f"attention timing d256 {dtype} " + json.dumps(t))
        del q, k, v, do, leaves
    stats["flash"] = flash_timings(at, dev, FLASH_WIDE_TIMED)
    torch.cuda.empty_cache()

    # the LM step with heads of 256
    lm = TransformerLM(**LM_WIDE, seed=seed + 4)
    tokens = lm_tokens(seed + 4, LM_WIDE_BATCH * LM_WIDE_STEPS,
                       LM_WIDE["max_len"] + 1)
    _reset_counts(at, ek)
    hist = lm.fit(tokens, batch_size=LM_WIDE_BATCH, epochs=1)
    torch.cuda.synchronize()
    lm_launches = _lm_counts(at, ek)
    n = LM_WIDE["n_block"] * LM_WIDE_STEPS
    want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "flash_bwd_fused": 0, "fused_short_fwd": 0, "fused_short_bwd": 0,
            "gather_rows": LM_WIDE_STEPS}
    check(lm_launches == want, f"the LM with heads of 256 launched "
          f"{lm_launches}, expected {want}")
    check(dict(at.flash_route_counts) == flash_routes_of(
        at, torch.float32, lm_launches), "the LM's flash routes")
    check(bool(np.isfinite(hist["loss_history"]).all()),
          "the LM with heads of 256: losses not finite")
    stats["lm"] = {"config": LM_WIDE, "batch": LM_WIDE_BATCH,
                   "head_dim": LM_WIDE["hidden"] // LM_WIDE["n_head"],
                   "reduced": "n_block 8 -> 2, for time",
                   "losses": list(hist["loss_history"]),
                   "launches": lm_launches,
                   "flash_routes": dict(at.flash_route_counts),
                   **_lm_step_stats(lm, tokens, LM_WIDE_BATCH, 2, 1)}
    del lm
    torch.cuda.empty_cache()

    # a bf16 flash step at d 256: B4, then B6
    leaves = [torch.randn(FLASH_WIDE_STEP, device=dev, generator=None).to(
        torch.bfloat16).requires_grad_() for _ in range(3)]

    def flash_step(leaves=leaves):
        at.flash_attention(*leaves, causal=True).float().sum().backward()

    def sdpa_step(leaves=leaves):
        sdpa(*leaves, is_causal=True).float().sum().backward()

    _reset_counts(at, ek)
    flash_step()
    torch.cuda.synchronize()
    step_launches = dict(at.flash_launch_counts)
    check(step_launches == {"flash_fwd": 1, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "flash_bwd_fused": 1}
          and dict(at.flash_route_counts) == flash_routes_of(
              at, torch.bfloat16, step_launches),
          f"the bf16 d 256 step launched {step_launches}")
    check(all(bool(torch.isfinite(t.grad.float()).all()) for t in leaves),
          "the bf16 d 256 step's gradients are not finite")
    stats["flash_step"] = {"shape": list(FLASH_WIDE_STEP), "dtype": "bf16",
                           "causal": True, "launches": step_launches,
                           "step_ms_events": cuda_ms(flash_step, 5, 1),
                           "sdpa_step_ms_events": cuda_ms(sdpa_step, 5, 1)}
    del leaves
    torch.cuda.empty_cache()
    return {"lm_heads256": lm_launches,
            "longseq_d256_step": {**step_launches, "fused_short_fwd": 0,
                                  "fused_short_bwd": 0,
                                  "gather_rows": 0}}, stats


#: heads past 256 (the ``wide`` route, ``csrc/attn_wide.cu``): the grid's
#: widths, 1024 for the forwards alone; B7/B8's lengths and the flash
#: kernels' (q, kv) lengths
WIDE_DIMS = (257, 320, 512)
WIDE_FWD_DIM = 1024
WIDE_FUSED_SEQS = (1, 33, 128)
WIDE_FLASH_LENGTHS = ((33, 33), (100, 300), (300, 100))
#: the shape the wide kernels are timed at, causal
WIDE_TIMED = (2, 4, 512, 512)
#: the LM path with heads of 512 that drives the wide kernels through the
#: user's entry points: training steps (flash: a forward, then the dq and
#: dk/dv passes) and a generate (the fused prefill at bucket 128)
LM_WIDE512 = dict(LM_CFG, n_block=2, n_head=4, max_len=512)
LM_WIDE512_BATCH, LM_WIDE512_STEPS = 4, 2
#: the f32 rate of the CUDA cores, at which the wide kernels compute
PEAK_F32_SIMT = 67e12


def _wide_grid(at, dev, gen, seed_t) -> dict:
    """Hold every wrapper at heads of 257, 320 and 512 (forwards also
    1024) to its plain version: B7/B8 with and without a padding bias,
    causal or not, dropout 0 and 0.1; B4 with and without a bias, causal or
    not; B5a + B5b and B6 with and without an lse cotangent. Returns the
    largest errors over the output's scale (the gradients' joint scale)
    by dtype and the number of cases."""
    errs, cases = {}, 0

    def hold(err, dtype, what):
        key = f"{what}_{str(dtype).split('.')[-1]}"
        errs[key] = max(errs.get(key, 0.0), err)
        check(err <= ATTN_ATOL[dtype], f"wide {what} != plain by {err} "
              f"({dtype})")

    for dtype in (torch.float32, torch.bfloat16):
        for d in WIDE_DIMS + (WIDE_FWD_DIM,):
            fwd_only = d == WIDE_FWD_DIM
            for s in WIDE_FUSED_SEQS[1:] if fwd_only else WIDE_FUSED_SEQS:
                q, k, v, do, mask = _attn_case(dev, 2, 2, s, d, dtype, gen)
                bias = ((1.0 - mask) * -1e9).to(dev)
                for kb in (None, bias):
                    for causal in (False, True):
                        for rate in (0.0, 0.1):
                            args = (kb, seed_t, d ** -0.5, rate, causal)
                            o, stats = at.fused_short_fwd(q, k, v, *args)
                            want = at.fused_short_attention_plain(
                                q, k, v, kb, d ** -0.5, rate, seed_t, causal)
                            hold(_rel_err(o, want), dtype, "fused_fwd")
                            cases += 1
                            if fwd_only:
                                continue
                            got = at.fused_short_bwd(q, k, v, do, *args,
                                                     stats, o)
                            plain = at.fused_short_bwd_plain(
                                q, k, v, do, kb, d ** -0.5, rate, seed_t,
                                causal)
                            hold(_grads_errs(got, plain, False)[0], dtype,
                                 "fused_bwd")
            lengths = WIDE_FLASH_LENGTHS[1:2] if fwd_only \
                else WIDE_FLASH_LENGTHS
            for sq, skv in lengths:
                q, k, v, do, glse, bias = _flash_case(dev, sq, skv, d, dtype,
                                                      gen)
                scale = d ** -0.5
                for causal in (False, True):
                    for kb in (None, bias):
                        o, lse = at.flash_fwd(q, k, v, kb, scale, causal)
                        want_o, want_lse = at.flash_fwd_plain(q, k, v, kb,
                                                              scale, causal)
                        hold(_rel_err(o, want_o), dtype, "flash_fwd")
                        hold(_rel_err(lse, want_lse), torch.float32,
                             "flash_lse")
                        cases += 1
                    if fwd_only:
                        continue
                    o, lse = at.flash_fwd_plain(q, k, v, None, scale, causal)
                    delta = (do.float() * o.float()).sum(-1)
                    for gl in (None, glse):
                        a = (q, k, v, do, lse, delta, gl, scale, causal)
                        want = at.flash_bwd_fused_plain(*a)
                        pair = (at.flash_bwd_dq(*a),) + at.flash_bwd_dkv(*a)
                        one_key = skv == 1 and gl is None
                        hold(_grads_errs(pair, want, one_key)[0], dtype,
                             "flash_bwd_pair")
                        hold(_grads_errs(at.flash_bwd_fused(*a), want,
                                         one_key)[0], dtype,
                             "flash_bwd_fused")
                        cases += 1
    torch.cuda.synchronize()
    return {"max_rel_err": errs, "cases": cases}


def _wide_dropout_mask(at, dev, seed_t) -> dict:
    """B7/B8's dropout mask at heads of 320 equals ``dropout_keep_mask``
    bit for bit: q = k = 0 gives p = 1/s everywhere, and v = I (s = d =
    320) reads p·keep back out of o, dO = I out of dv."""
    s = 320
    kept = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(4, 3, s, s, device=dev, dtype=dtype)
        eye = torch.eye(s, device=dev, dtype=dtype).expand(
            4, 3, s, s).contiguous()
        o, stats = at.fused_short_fwd(q, q, eye, None, seed_t, 1.0, 0.1,
                                      False)
        _, _, dv = at.fused_short_bwd(q, q, eye, eye, None, seed_t, 1.0,
                                      0.1, False, stats, o)
        want = at.dropout_keep_mask(seed_t, 12, s, 0.1).reshape(4, 3, s, s)
        check(torch.equal(o != 0, want), f"wide B7's dropout mask != the "
              f"plain mask ({dtype})")
        check(torch.equal(dv.transpose(-1, -2) != 0, want),
              f"wide B8's dropout mask != the plain mask ({dtype})")
        kept[str(dtype).split(".")[-1]] = float(want.float().mean())
    return {"entries": 2 * 4 * 3 * s * s, "kept_share": kept}


def _wide_timings(at, dev, gen) -> dict:
    """The three wide kernels at ``WIDE_TIMED`` causal, by their flash
    wrappers (forward with lse, dq pass, dk/dv pass), beside their plain
    versions and ``scaled_dot_product_attention(is_causal=True)``, held
    to the plain versions; bounds at the card's peak for the dtype (in
    f32 the tensor cores as 3xTF32, the rate the other f32 attention
    kernels are bounded at) and, in f32, also at the CUDA cores' f32 rate
    (the kernels' own arithmetic)."""
    b, h, s, d = WIDE_TIMED
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(dtype)
                       .to(dev) for _ in range(4))
        scale = d ** -0.5
        o, lse = at.flash_fwd(q, k, v, None, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        a = (q, k, v, do, lse, delta, None, scale, True)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd(leaves=leaves, do=do):
            sdpa(*leaves, is_causal=True).backward(do)

        fns = {
            "fwd_ms": lambda: at.flash_fwd(q, k, v, None, scale, True),
            "dq_ms": lambda: at.flash_bwd_dq(*a),
            "dkv_ms": lambda: at.flash_bwd_dkv(*a),
            "plain_fwd_ms": lambda: at.flash_fwd_plain(q, k, v, None, scale,
                                                       True),
            "plain_dq_ms": lambda: at.flash_bwd_dq_plain(*a),
            "plain_dkv_ms": lambda: at.flash_bwd_dkv_plain(*a),
            "library_fwd_ms": lambda: sdpa(q, k, v, is_causal=True),
            "library_fwd_bwd_ms": sdpa_fwd_bwd}
        t = {"shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1],
             "causal": True}
        for key, fn in fns.items():
            t[key] = cuda_ms(fn, 5, warmup=2)
            t[key.replace("_ms", "_device_ms")] = device_ms(fn, calls=3)
        want_o, want_lse = at.flash_fwd_plain(q, k, v, None, scale, True)
        t["fwd_max_abs_err"] = float((o.float() - want_o.float()).abs()
                                     .max())
        t["fwd_rel_err"] = _rel_err(o, want_o)
        want = at.flash_bwd_fused_plain(*a)
        got = (at.flash_bwd_dq(*a),) + at.flash_bwd_dkv(*a)
        t["dq_max_abs_err"] = float((got[0].float() - want[0].float())
                                    .abs().max())
        t["dkv_max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got[1:], want[1:]))
        t["bwd_rel_err"] = _grads_errs(got, want, False)[0]
        check(t["fwd_rel_err"] <= ATTN_ATOL[dtype]
              and t["bwd_rel_err"] <= ATTN_ATOL[dtype],
              f"wide kernels at {WIDE_TIMED} {dtype} != plain: {t}")
        for kind in ("fwd", "dq", "dkv"):
            t[f"{kind}_bound"] = list(flash_bound_ms(
                b, h, s, s, d, dtype, kind, True,
                peak=PEAK_FLOPS_3XTF32 if dtype == torch.float32 else None))
            t[f"{kind}_bound_simt"] = list(flash_bound_ms(
                b, h, s, s, d, dtype, kind, True, peak=PEAK_F32_SIMT))
        out[t["dtype"]] = t
        del q, k, v, do, leaves
    return out


def _wide_lm_path(at, ek, seed: int) -> tuple:
    """A TransformerLM with heads of 512 (``LM_WIDE512``) through its
    entry points: ``fit`` (each block and step a flash forward, a dq and a
    dk/dv pass) and ``generate`` after a 100-token prompt (each block's
    prefill a fused forward at bucket 128): every launch on the ``wide``
    route. Returns (launches, stats)."""
    from analytics_zoo_tpu_torch.capture import TransformerLM

    lm = TransformerLM(**LM_WIDE512, seed=seed + 31)
    tokens = lm_tokens(seed + 31, LM_WIDE512_BATCH * LM_WIDE512_STEPS,
                       LM_WIDE512["max_len"] + 1)
    prompt = lm_tokens(seed + 32, 1, 100)
    _reset_counts(at, ek)
    t0 = time.perf_counter()
    hist = lm.fit(tokens, batch_size=LM_WIDE512_BATCH, epochs=1)
    out = lm.generate(prompt, 4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _lm_counts(at, ek)
    blocks, steps = LM_WIDE512["n_block"], LM_WIDE512_STEPS
    want = {"flash_fwd": blocks * steps, "flash_bwd_dq": blocks * steps,
            "flash_bwd_dkv": blocks * steps, "flash_bwd_fused": 0,
            "fused_short_fwd": blocks, "fused_short_bwd": 0,
            "gather_rows": steps + 1 + 4}
    check(counts == want, f"the heads-of-512 LM launched {counts}, "
          f"expected {want}")
    check(dict(at.route_counts) == {"bf16_tc": 0, "f32_tc": 0,
                                    "wide": blocks}
          and dict(at.flash_route_counts) == {
              "bf16_tc": 0, "f32_tc": 0, "wide": 3 * blocks * steps},
          f"the heads-of-512 LM took {dict(at.route_counts)} and "
          f"{dict(at.flash_route_counts)}, not the wide route alone")
    check(bool(np.isfinite(hist["loss_history"]).all())
          and out.shape == (1, 4), "the heads-of-512 LM failed")
    return counts, {"config": LM_WIDE512, "batch": LM_WIDE512_BATCH,
                    "steps": steps, "losses": list(hist["loss_history"]),
                    "wall_s": wall, "launches": counts}


def phase_attn_wide(at, ek, dev, seed: int) -> dict:
    """C15's kernels, heads past 256 (``csrc/attn_wide.cu``): the grid
    against the plain versions, the dropout mask bit for bit, the timings
    at ``WIDE_TIMED``, every launch of the grid counted on the ``wide``
    route, then the heads-of-512 LM path whose launches the kernels line
    reports."""
    gen = torch.Generator().manual_seed(seed + 29)
    seed_t = torch.tensor([seed + 29], dtype=torch.int32, device=dev)
    _reset_counts(at, ek)
    stats = {"grid": _wide_grid(at, dev, gen, seed_t),
             "dropout_mask": _wide_dropout_mask(at, dev, seed_t)}
    fused = sum(at.launch_counts.values())
    flash = sum(at.flash_launch_counts.values())
    check(dict(at.route_counts) == {"bf16_tc": 0, "f32_tc": 0,
                                    "wide": fused}
          and dict(at.flash_route_counts) == {"bf16_tc": 0, "f32_tc": 0,
                                              "wide": flash},
          f"the wide grid took {dict(at.route_counts)} and "
          f"{dict(at.flash_route_counts)}")
    stats["grid"]["launches"] = {"fused": fused, "flash": flash}
    torch.cuda.empty_cache()
    stats["timed"] = _wide_timings(at, dev, gen)
    torch.cuda.empty_cache()
    launches, stats["lm_heads_512"] = _wide_lm_path(at, ek, seed)
    torch.cuda.empty_cache()
    return launches, stats


#: generative serving (GenerativeServing at LM_CFG's width, seeded random
#: weights): the contiguous run's slots, budget and prompts (100 tokens:
#: bucket 128, B7; 1000: bucket 1024, B4), the paged run's, the sampled
#: run's knobs, and the shared prefix's length
GEN_SERVE = dict(slots=32, max_new_tokens=32, stream_interval=8)
GEN_SERVE_PROMPTS = {100: 64, 1000: 4}
GEN_PAGED = dict(slots=64, kv_page_len=16, streams=128)
GEN_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, streams=32)
GEN_PREFIX = dict(prefix=64, streams=16)


class _LogitTap:
    """Keeps each served stream's logits, step by step: wraps the server's
    selector, which sees a step's logits ``[slots, vocab]`` before the
    tokens are posted, and keeps one copy of them a step; ``rows[uri]``
    lists the stream's rows in step order."""

    def __init__(self, srv):
        self.rows = {}
        select = srv._select

        def tapped(logits, noise):
            kept = logits.detach().clone()
            for i in np.flatnonzero(srv._active_host):
                self.rows.setdefault(srv._uri[i], []).append(kept[int(i)])
            return select(logits, noise)
        srv._select = tapped


def _serve_generative(lm, workdir: str, name: str, prompts: list,
                      seeds=None, prefix=None, tap=True, draft_lm=None,
                      **cfg_kw) -> tuple:
    """``GenerativeServing`` on the card over a fresh ``dir://`` spool:
    every prompt enqueued with ``enqueue_prompt`` before the loop starts,
    the loop run in its thread until each request has its terminal, read
    back with ``OutputQueue.stream`` for the first and ``query`` for the
    others. Returns (tokens by uri, the server, logits by uri, stats)."""
    from analytics_zoo_tpu_torch.common.utils import timers
    from analytics_zoo_tpu_torch.serving import (GenerativeServing,
                                                 InputQueue, OutputQueue,
                                                 ServingConfig)
    spool = os.path.join(workdir, name)
    src = f"dir://{spool}"
    srv = GenerativeServing(ServingConfig(data_src=src, **cfg_kw), lm,
                            draft_lm=draft_lm)
    if prefix is not None:
        srv.register_prefix(prefix)
    logits = _LogitTap(srv) if tap else None
    inq, outq = InputQueue(src), OutputQueue(src)
    uris = [f"{name}-{i}" for i in range(len(prompts))]
    for i, (uri, p) in enumerate(zip(uris, prompts)):
        inq.enqueue_prompt(uri, p, seed=None if seeds is None else seeds[i])
    torch.cuda.synchronize()
    timers.reset()
    t0 = time.perf_counter()
    srv.start()
    try:
        first = list(outq.stream(uris[0], timeout_s=120))
        results = {uris[0]: {"value": first, "done": True}}
        for uri in uris[1:]:
            deadline = time.monotonic() + 120
            while True:
                res = outq.query(uri, timeout_s=1.0)
                if res is not None and (res.get("done") or "error" in res):
                    break
                check(time.monotonic() < deadline, f"{uri}: no terminal")
            results[uri] = res
        wall = time.perf_counter() - t0
    finally:
        srv.drain(timeout_s=60)
    errors = {u: r["error"] for u, r in results.items() if "error" in r}
    check(not errors, f"{name}: error terminals {errors}")
    check(all(r.get("done") is True for r in results.values()),
          f"{name}: a request has no terminal")
    tokens = {u: r["value"] for u, r in results.items()}
    snap = srv.health_snapshot()
    check(snap["in_flight"] == 0 and snap["slots_occupied"] == 0
          and snap["counters"] == {"shed": 0, "expired": 0, "errors": 0,
                                   "claim_faults": 0, "reloads": 0,
                                   "reload_failures": 0},
          f"{name}: the server ended with {snap}")
    n_tok = sum(len(t) for t in tokens.values())
    # host seconds in the loop's spans: the joins (claim excluded: their
    # prefills), the steps' dispatch and their one fetch each
    spans = {k.split(".")[-1]: {"s": v[0], "count": v[1]}
             for k, v in timers.stats().items()
             if k.startswith("serving.generative.")}
    stats = {"streams": len(prompts), "tokens": n_tok, "wall_s": wall,
             "tokens_per_s": n_tok / wall, "steps": srv.steps,
             "ms_per_step_wall": wall * 1e3 / max(srv.steps, 1),
             "spans": spans,
             "ttft_ms": snap["ttft_ms"], "latency_ms": snap["latency_ms"],
             "kv_pages_free": snap["kv_pages_free"]}
    return tokens, srv, (logits.rows if logits else None), stats


def _against_serial(lm, prompts, uris, served, served_logits, budget,
                    **gen_kw) -> dict:
    """Each served stream against a serial ``lm.generate`` of its prompt
    on the card: each step's logits within ``LOGIT_TOL`` of their scale of
    the serial run's, and its tokens equal, except where the scores the
    serial run chose by are within that tolerance of each other (printed;
    the stream is compared up to there). Greedy, the scores are the
    logits; sampled, the filtered logits plus the step's Gumbel noise, the
    draw's own margin, taken back to logit units by the temperature."""
    from analytics_zoo_tpu_torch.ops.decode import (gumbel_noise,
                                                    make_logit_filter)
    temperature = gen_kw.get("temperature")
    if temperature is not None:
        filt = make_logit_filter(temperature, gen_kw.get("top_k"),
                                 gen_kw.get("top_p"))
    worst, near_ties = 0.0, []
    for i, (uri, p) in enumerate(zip(uris, prompts)):
        kw = dict(gen_kw)
        if "seeds" in kw:
            kw["seed"] = kw.pop("seeds")[i]
        want, logits = lm.generate(np.asarray([p]), budget,
                                   return_logits=True, **kw)
        want, logits = want[0].tolist(), logits[0]
        if temperature is not None:  # the serial run's draws, step by step
            noise = gumbel_noise(kw["seed"],
                                 (budget, 1, logits.shape[-1]))[:, 0]
        got = served[uri]
        for step, (a, b) in enumerate(zip(got, want)):
            row = served_logits[uri][step].float().cpu().numpy()
            scale = max(1.0, float(np.abs(logits[step]).max()))
            err = float(np.abs(row - logits[step]).max()) / scale
            worst = max(worst, err)
            check(err <= LOGIT_TOL, f"{uri} step {step}: logits differ from "
                  f"the serial run's by {err} of their scale")
            if a != b:
                scores = logits[step]
                if temperature is not None:
                    scores = (filt(torch.tensor(scores)) + noise[step]
                              ).numpy() * temperature
                top2 = np.sort(scores)[-2:]
                margin = float(top2[1] - top2[0]) / scale
                check(margin <= LOGIT_TOL, f"{uri} step {step}: token {a} "
                      f"!= serial {b}, top-two margin {margin}")
                near_ties.append({"uri": uri, "step": step, "served": a,
                                  "serial": b, "margin": margin})
                log(f"generative near-tie {near_ties[-1]}")
                break
        else:
            check(len(got) == len(want), f"{uri}: {len(got)} tokens")
    return {"logits_max_rel_err": worst, "near_ties": near_ties}


def _decode_step_stats(lm, workdir: str, name: str, prompts, slots: int,
                       **cfg_kw) -> dict:
    """One decode step of ``slots`` resident streams after 100-token
    prompts, on a server whose slots are all joined: ms by CUDA events,
    the profiler's device time, busy share and top kernels, and the KV
    caches' bytes."""
    from analytics_zoo_tpu_torch.serving import (GenerativeServing,
                                                 InputQueue, ServingConfig)
    src = f"dir://{os.path.join(workdir, name)}"
    srv = GenerativeServing(ServingConfig(
        data_src=src, slots=slots, max_new_tokens=256, **cfg_kw), lm)
    inq = InputQueue(src)
    for i in range(slots):
        inq.enqueue_prompt(f"step-{i}", prompts[i])
    check(srv.serve_step() == slots, "the step server did not fill its "
          "slots")
    tokens = srv._next_tokens.copy()

    def step():
        return srv._dispatch_step(tokens, None)

    ms = cuda_ms(step, 20, warmup=3)
    prof = step_profile(step, calls=5, top=8, warmup=False)
    host_t0 = time.perf_counter()
    for _ in range(5):
        step().cpu()
    host_ms = (time.perf_counter() - host_t0) * 1e3 / 5
    srv.stop()  # the resident streams end with shutdown errors
    kv_bytes = sum(t.numel() * t.element_size() for c in srv._caches
                   for t in c.values())
    return {"slots": slots, "step_ms_events": ms,
            "step_ms_host_with_fetch": host_ms,
            "step_device_ms": prof["device_ms"],
            "device_busy_share": (prof["device_ms"] / host_ms
                                  if prof["device_ms"] is not None
                                  else None),
            "step_device_launches": prof["device_launches"],
            "step_top_kernels": prof["top_device"],
            "step_top_host_ops": prof["top_host"],
            "kv_cache_bytes": kv_bytes}


def phase_generative(at, ek, seed: int, workdir: str) -> tuple:
    """GenerativeServing at ``LM_CFG``'s width with seeded random weights
    (see the module docstring, 20). Returns (launches by run, stats)."""
    from analytics_zoo_tpu_torch.capture import TransformerLM, prefill_bucket

    blocks, budget = LM_CFG["n_block"], GEN_SERVE["max_new_tokens"]
    lm = TransformerLM(**LM_CFG, seed=seed + 41)
    lm._device(None)
    prompts = [p.tolist() for length, n in GEN_SERVE_PROMPTS.items()
               for p in lm_tokens(seed + 41 + length, n, length)]
    # the long prompts join mid-run, among the short ones
    prompts = prompts[:40] + prompts[64:] + prompts[40:64]
    launches, stats = {}, {}

    # a warm-up of both prefill buckets, so that the runs below time the
    # server and not the first calls' set-up
    _serve_generative(lm, workdir, "warmup", prompts[:2] + prompts[40:41],
                      tap=False, **GEN_SERVE)

    # 1. contiguous slots, greedy: the serving numbers from a run without
    # the logit tap (it copies each step's logits and loops over the slots
    # on the host, inside the timed loop), then a tapped run of the same
    # prompts for the parity with serial generate
    _reset_counts(at, ek)
    tokens, srv, _, stats["contiguous"] = _serve_generative(
        lm, workdir, "contiguous", prompts, tap=False, **GEN_SERVE)
    counts = _lm_counts(at, ek)
    buckets = [prefill_bucket(len(p) - 1, LM_CFG["max_len"])
               for p in prompts]
    flash = sum(tb > at.FUSED_SHORT_MAX_SEQ for tb in buckets)
    want = {"fused_short_fwd": blocks * (len(prompts) - flash),
            "flash_fwd": blocks * flash, "fused_short_bwd": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_fused": 0,
            "gather_rows": len(prompts) + srv.steps}
    check(counts == want, f"contiguous serving launched {counts}, "
          f"expected {want}")
    check(dict(at.route_counts) == {"bf16_tc": 0, "f32_tc":
                                    want["fused_short_fwd"], "wide": 0}
          and dict(at.flash_route_counts) == flash_routes_of(
              at, torch.float32, counts),
          f"contiguous serving took {dict(at.route_counts)} and "
          f"{dict(at.flash_route_counts)}")
    launches["generative_contiguous"] = counts
    contiguous = [tokens[f"contiguous-{i}"] for i in range(len(prompts))]
    kv_contig = sum(t.numel() * t.element_size() for c in srv._caches
                    for t in c.values())
    del srv
    tapped, _, logits, stats["contiguous_tapped"] = _serve_generative(
        lm, workdir, "tapped", prompts, **GEN_SERVE)
    uris = [f"tapped-{i}" for i in range(len(prompts))]
    check([tapped[u] for u in uris] == contiguous, "the tapped run's "
          "tokens differ from the untapped run's")
    stats["contiguous"].update(
        launches=counts, prompt_lengths=dict(GEN_SERVE_PROMPTS),
        kv_bytes=kv_contig,
        **_against_serial(lm, prompts, uris, tapped, logits, budget))
    del logits
    torch.cuda.empty_cache()

    # 2. paged: the contiguous prompts, then more short ones, 128 streams
    extra = [p.tolist() for p in lm_tokens(
        seed + 43, GEN_PAGED["streams"] - len(prompts), 100)]
    paged_prompts = prompts + extra
    page_len = GEN_PAGED["kv_page_len"]
    pages = 1 + sum(-(-max(prefill_bucket(len(p) - 1, LM_CFG["max_len"]),
                           len(p) + budget) // page_len)
                    for p in sorted(paged_prompts, key=len)[-GEN_PAGED[
                        "slots"]:])
    paged_kw = dict(slots=GEN_PAGED["slots"], max_new_tokens=budget,
                    stream_interval=GEN_SERVE["stream_interval"],
                    kv_pages=pages, kv_page_len=page_len)
    _reset_counts(at, ek)
    paged, srv, _, stats["paged"] = _serve_generative(
        lm, workdir, "paged", paged_prompts, tap=False, **paged_kw)
    launches["generative_paged"] = counts = _lm_counts(at, ek)
    flash = sum(prefill_bucket(len(p) - 1, LM_CFG["max_len"])
                > at.FUSED_SHORT_MAX_SEQ for p in paged_prompts)
    want = dict(want, fused_short_fwd=blocks * (len(paged_prompts) - flash),
                flash_fwd=blocks * flash,
                gather_rows=len(paged_prompts) + srv.steps)
    check(counts == want, f"paged serving launched {counts}, expected "
          f"{want}")
    pool_bytes = sum(t.numel() * t.element_size() for c in srv._caches
                     for t in c.values())
    del srv
    got = [paged[f"paged-{i}"] for i in range(len(paged_prompts))]
    check(got[:len(prompts)] == contiguous, "the paged run's tokens differ "
          "from the contiguous run's")
    check(all(len(t) == budget for t in got), "paged streams malformed")
    stats["paged"].update(kv_pages=pages, kv_bytes=pool_bytes,
                          launches=launches["generative_paged"],
                          equal_to_contiguous=len(prompts))

    # 3. paged with an int8 pool
    _reset_counts(at, ek)
    int8, srv, _, stats["paged_int8"] = _serve_generative(
        lm, workdir, "int8", paged_prompts, tap=False, kv_int8=True,
        **paged_kw)
    launches["generative_int8"] = counts = _lm_counts(at, ek)
    want = dict(want, gather_rows=len(paged_prompts) + srv.steps)
    check(counts == want, f"int8 paged serving launched {counts}, "
          f"expected {want}")
    pool8 = sum(t.numel() * t.element_size() for c in srv._caches
                for t in c.values())
    del srv
    got8 = [int8[f"int8-{i}"] for i in range(len(paged_prompts))]
    check(all(len(t) == budget and all(0 <= x < LM_CFG["vocab_size"]
                                       for x in t) for t in got8),
          "int8 streams malformed")
    differ = sum(a != b for s8, s32 in zip(got8, got)
                 for a, b in zip(s8, s32))
    diverged = sum(s8 != s32 for s8, s32 in zip(got8, got))
    stats["paged_int8"].update(kv_bytes=pool8, tokens_differing=differ,
                               streams_differing=diverged)
    log(f"generative int8 pool: {differ} of {budget * len(got)} tokens "
        f"differ from the f32 pool's ({diverged} streams)")

    # 4. a registered shared prefix against the same prompts without it
    common = lm_tokens(seed + 44, 1, GEN_PREFIX["prefix"])[0].tolist()
    tails = lm_tokens(seed + 45, GEN_PREFIX["streams"],
                      100 - GEN_PREFIX["prefix"])
    shared_prompts = [common + t.tolist() for t in tails]
    kw = dict(paged_kw, slots=GEN_PREFIX["streams"])
    plain, _, plain_logits, _ = _serve_generative(
        lm, workdir, "noprefix", shared_prompts, **kw)
    _reset_counts(at, ek)
    shared, srv, shared_logits, stats["prefix"] = _serve_generative(
        lm, workdir, "prefix", shared_prompts, prefix=common, **kw)
    launches["generative_prefix"] = counts = _lm_counts(at, ek)
    # the registration prefills the prefix (B7 a block, bucket <= 512);
    # each join embeds its suffix (B1) and attends over the prefix's pages
    # outside any kernel, so no join launches B7 or B4
    want = dict(want, fused_short_fwd=blocks, flash_fwd=0,
                gather_rows=1 + len(shared_prompts) + srv.steps)
    check(counts == want, f"prefix serving launched {counts}, expected "
          f"{want}")
    del srv
    same, ties = 0, []
    for i in range(len(shared_prompts)):
        a, b = shared[f"prefix-{i}"], plain[f"noprefix-{i}"]
        for step, (x, y) in enumerate(zip(a, b)):
            ref = plain_logits[f"noprefix-{i}"][step].float()
            got_l = shared_logits[f"prefix-{i}"][step].float()
            scale = max(1.0, float(ref.abs().max()))
            err = float((got_l - ref).abs().max()) / scale
            check(err <= LOGIT_TOL, f"prefix stream {i} step {step}: logits "
                  f"differ by {err} of their scale")
            if x != y:
                top2 = torch.topk(ref, 2).values
                margin = float(top2[0] - top2[1]) / scale
                check(margin <= LOGIT_TOL, f"prefix stream {i} step {step}: "
                      f"{x} != {y}, margin {margin}")
                ties.append({"stream": i, "step": step, "margin": margin})
                log(f"generative prefix near-tie {ties[-1]}")
                break
        else:
            same += 1
    stats["prefix"].update(prefix_tokens=GEN_PREFIX["prefix"],
                           streams_equal=same, near_ties=ties,
                           launches=launches["generative_prefix"])
    del plain_logits, shared_logits

    # 5. sampled, per-request seeds
    n = GEN_SAMPLED["streams"]
    knobs = {k: GEN_SAMPLED[k] for k in ("temperature", "top_k", "top_p")}
    seeds = [seed * 1000 + 7 * i + 1 for i in range(n)]
    sample_prompts = prompts[:n]
    sample_kw = dict(seeds=seeds, slots=GEN_SERVE["slots"],
                     max_new_tokens=budget,
                     stream_interval=GEN_SERVE["stream_interval"], **knobs)
    _reset_counts(at, ek)
    sampled, srv, _, stats["sampled"] = _serve_generative(
        lm, workdir, "sampled", sample_prompts, tap=False, **sample_kw)
    launches["generative_sampled"] = counts = _lm_counts(at, ek)
    want = dict(want, fused_short_fwd=blocks * n, flash_fwd=0,
                gather_rows=n + srv.steps)
    check(counts == want, f"sampled serving launched {counts}, expected "
          f"{want}")
    del srv
    tapped, _, logits, stats["sampled_tapped"] = _serve_generative(
        lm, workdir, "sampled_tapped", sample_prompts, **sample_kw)
    uris = [f"sampled_tapped-{i}" for i in range(n)]
    check([tapped[u] for u in uris]
          == [sampled[f"sampled-{i}"] for i in range(n)],
          "the tapped sampled run's tokens differ from the untapped run's")
    stats["sampled"].update(knobs, launches=counts, **_against_serial(
        lm, sample_prompts, uris, tapped, logits, budget,
        seeds=list(seeds), **knobs))
    del logits
    torch.cuda.empty_cache()

    # the decode step alone: 32 contiguous slots, then 64 paged
    short = prompts[:40] + prompts[44:] + extra
    stats["decode_step"] = _decode_step_stats(
        lm, workdir, "step", short, GEN_SERVE["slots"])
    stats["decode_step_paged"] = _decode_step_stats(
        lm, workdir, "step_paged", short, GEN_PAGED["slots"],
        kv_pages=1 + GEN_PAGED["slots"] * (-(-(100 + 256) // page_len)),
        kv_page_len=page_len)
    del lm
    torch.cuda.empty_cache()
    return launches, stats


#: speculative decoding at ``LM_CFG``'s width: draft tokens a round, the
#: generate_speculative streams (8 prompts of 100, 64 new tokens), the
#: served streams (``GEN_SERVE_PROMPTS``, 32 new tokens, 64 slots) and the
#: reject-path streams of a draft with its own weights
SPEC_K = 4
SPEC_GEN = dict(streams=8, prompt=100, new=64)
SPEC_SERVE = dict(slots=64, max_new_tokens=32, kv_page_len=16,
                  stream_interval=8)
SPEC_REJECT_STREAMS = 4
#: random blocks (std 0.02) each add O(1) to the residual, so a 2-block
#: draft of the target's first blocks agrees with it no better than chance
#: (acceptance 0.001 on the H100, PERF.md): the target's later blocks have
#: their output projections scaled by this, so that the draft agrees in
#: part and rounds accept several tokens
SPEC_TAIL_SCALE = 0.05
#: the sampled accept rule's check: a small LM (vocab 64), the first
#: emitted token of SPEC_SAMPLED_ROWS rows (each its own draws) against the
#: target's filtered softmax, total variation within SPEC_TV_BOUND (about
#: four times the expected sampling error at this many rows)
SPEC_SMALL = dict(vocab_size=64, hidden=64, n_block=2, n_head=4, max_len=64)
SPEC_SAMPLED = dict(temperature=0.8, top_k=24)
SPEC_SAMPLED_ROWS = 8192
SPEC_TV_BOUND = 0.06


@contextlib.contextmanager
def brownout_off():
    """The generative and speculative runs measure full-budget streams.
    Their page pools are sized for the resident streams, so the pool's
    scarcity alone would step the brownout ladder down and cap the budgets
    of late joins; this lifts ``serving.brownout_high`` out of reach while
    they run (phase 23 drives the ladder on purpose)."""
    from analytics_zoo_tpu_torch.common.config import global_config
    cfg = global_config()
    cfg.set("serving.brownout_high", float("inf"))
    try:
        yield
    finally:
        cfg.unset("serving.brownout_high")


def spec_draft(lm, seed: int, shared: bool = True):
    """A 2-block draft of ``lm``'s width, ``max_len`` ``lm.max_len +
    SPEC_K``. Shared: ``lm``'s embedding, first two blocks, ``ln_f`` and
    position rows (the SPEC_K extra rows keep their seeded values), so it
    agrees with ``lm`` in part; else its own seeded weights."""
    from analytics_zoo_tpu_torch.capture import TransformerLM
    cfg = dict(vocab_size=lm.vocab_size, hidden=lm.hidden, n_block=2,
               n_head=lm.n_head, max_len=lm.max_len + SPEC_K)
    draft = TransformerLM(**cfg, seed=seed)
    if shared:
        with torch.no_grad():
            draft.embed.copy_(lm.embed.detach().cpu())
            draft.pos[:lm.max_len].copy_(lm.pos.detach().cpu())
            for i in range(2):
                draft.blocks[i].load_state_dict(lm.blocks[i].state_dict())
            draft.ln_f.load_state_dict(lm.ln_f.state_dict())
    draft._device(None)
    return draft


def _held_to_serial(lm, prompts, got: dict, budget: int, what: str) -> dict:
    """Each stream in ``got`` (uri -> tokens, in the order of ``prompts``)
    against greedy ``generate`` of its prompt on the card, in batches of
    16 prompts of one length: its tokens equal, except where the serial
    run's top two logits are within ``LOGIT_TOL`` of their scale (printed;
    the stream is compared up to there)."""
    uris = list(got)
    near_ties, equal = [], 0
    by_len: dict = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    for idx in by_len.values():
        for c in range(0, len(idx), 16):
            chunk = idx[c:c + 16]
            want, logits = lm.generate(
                np.asarray([prompts[i] for i in chunk]), budget,
                return_logits=True)
            for row, i in enumerate(chunk):
                a, b = got[uris[i]], want[row].tolist()
                for step, (x, y) in enumerate(zip(a, b)):
                    if x != y:
                        row_logits = logits[row, step]
                        scale = max(1.0, float(np.abs(row_logits).max()))
                        top2 = np.sort(row_logits)[-2:]
                        margin = float(top2[1] - top2[0]) / scale
                        check(margin <= LOGIT_TOL, f"{what} {uris[i]} step "
                              f"{step}: token {x} != serial {y}, top-two "
                              f"margin {margin}")
                        near_ties.append({"uri": uris[i], "step": step,
                                          "margin": margin})
                        log(f"{what} near-tie {near_ties[-1]}")
                        break
                else:
                    check(len(a) == len(b), f"{what} {uris[i]}: {len(a)} "
                          f"tokens, serial {len(b)}")
                    equal += 1
    return {"streams_equal_to_serial": equal, "near_ties": near_ties}


def _spec_round_stats(lm, draft, workdir: str, prompts) -> dict:
    """A speculative round of ``SPEC_SERVE['slots']`` resident streams
    after 100-token prompts, and its verify pass alone: ms by CUDA events,
    the profiler's device ms, busy share and launches; the plain paged
    decode step of the same streams beside it."""
    from analytics_zoo_tpu_torch.serving import (GenerativeServing,
                                                 InputQueue, ServingConfig)
    slots, pl = SPEC_SERVE["slots"], SPEC_SERVE["kv_page_len"]
    pages = 1 + slots * -(-(100 + 256 + SPEC_K) // pl)
    out = {}
    for name, k in (("spec", SPEC_K), ("plain", 0)):
        src = f"dir://{os.path.join(workdir, 'round_' + name)}"
        srv = GenerativeServing(ServingConfig(
            data_src=src, slots=slots, max_new_tokens=256, spec_k=k,
            kv_pages=pages, kv_page_len=pl), lm, draft_lm=draft)
        inq = InputQueue(src)
        for i in range(slots):
            inq.enqueue_prompt(f"round-{i}", prompts[i])
        check(srv.serve_step() == slots, "the round server did not fill "
              "its slots")
        tokens = srv._next_tokens.copy()

        def step():
            return srv._dispatch_step(tokens, None)

        ms = cuda_ms(step, 10, warmup=2)
        prof = step_profile(step, calls=3, top=6, warmup=False)
        t0 = time.perf_counter()
        for _ in range(3):
            step().cpu()
        host_ms = (time.perf_counter() - t0) * 1e3 / 3
        entry = {"ms_events": ms, "ms_host_with_fetch": host_ms,
                 "device_ms": prof["device_ms"],
                 "busy_share": (prof["device_ms"] / host_ms
                                if prof["device_ms"] is not None else None),
                 "device_launches": prof["device_launches"],
                 "top_kernels": prof["top_device"]}
        if k:
            # the verify pass alone: the target's one batched T = k+1 pass
            st = srv._state
            block = torch.as_tensor(np.repeat(tokens[:, None], k + 1, 1),
                                    device=srv.device)

            def verify():
                with torch.inference_mode():
                    return lm.verify_step(block, st["length"], srv._table,
                                          srv._caches)[0]
            vprof = step_profile(verify, calls=3, top=4)
            entry["verify"] = {"ms_events": cuda_ms(verify, 10, warmup=2),
                               "device_ms": vprof["device_ms"],
                               "device_launches": vprof["device_launches"],
                               "top_kernels": vprof["top_device"]}
        srv.stop()  # the resident streams end with shutdown errors
        del srv
        torch.cuda.empty_cache()
        out[name] = entry
    return out


def phase_speculative(at, ek, seed: int, workdir: str) -> tuple:
    """Speculative decoding at ``LM_CFG``'s width (see the module
    docstring, 22). Returns (launches by run, stats)."""
    from analytics_zoo_tpu_torch.capture import TransformerLM, prefill_bucket

    blocks = LM_CFG["n_block"]
    lm = TransformerLM(**LM_CFG, seed=seed + 51)
    with torch.no_grad():
        for blk in lm.blocks[2:]:
            blk.attn_out.kernel.mul_(SPEC_TAIL_SCALE)
            blk.fc2.kernel.mul_(SPEC_TAIL_SCALE)
    lm._device(None)
    draft = spec_draft(lm, seed + 52)
    launches, stats = {}, {}

    # (a) generate_speculative against greedy generate
    prompts = lm_tokens(seed + 53, SPEC_GEN["streams"], SPEC_GEN["prompt"])
    lm.generate_speculative(prompts[:1], draft, 4, spec_k=SPEC_K)  # warm-up
    _reset_counts(at, ek)
    spec_stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = lm.generate_speculative(prompts, draft, SPEC_GEN["new"],
                                  spec_k=SPEC_K, stats=spec_stats)
    wall = time.perf_counter() - t0
    launches["spec_generate"] = counts = _lm_counts(at, ek)
    want = {"fused_short_fwd": blocks + 2, "flash_fwd": 0,
            "fused_short_bwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_fused": 0,
            "gather_rows": 2 + (SPEC_K + 1) * spec_stats["rounds"]}
    check(counts == want, f"generate_speculative launched {counts}, "
          f"expected {want}")
    t0 = time.perf_counter()
    lm.generate(prompts, SPEC_GEN["new"])
    serial_wall = time.perf_counter() - t0
    n_tok = got.size
    stats["generate"] = {
        "streams": SPEC_GEN["streams"], "prompt": SPEC_GEN["prompt"],
        "new_tokens": SPEC_GEN["new"], "spec_k": SPEC_K,
        "rounds": spec_stats["rounds"],
        "acceptance": spec_stats["accepted"] / spec_stats["proposed"],
        "tokens_per_s": n_tok / wall,
        "ms_per_round_wall": wall * 1e3 / spec_stats["rounds"],
        "serial_generate_tokens_per_s": n_tok / serial_wall,
        "launches": counts,
        **_held_to_serial(lm, prompts.tolist(),
                          {f"gen-{i}": r.tolist() for i, r in enumerate(got)},
                          SPEC_GEN["new"], "speculative generate")}

    # (b) GenerativeServing(spec_k) through the spool, beside the plain
    # paged run of the same streams
    serve_prompts = [p.tolist() for length, n in GEN_SERVE_PROMPTS.items()
                     for p in lm_tokens(seed + 54 + length, n, length)]
    serve_prompts = serve_prompts[:40] + serve_prompts[64:] \
        + serve_prompts[40:64]
    budget, pl = SPEC_SERVE["max_new_tokens"], SPEC_SERVE["kv_page_len"]
    pages = 1 + sum(-(-max(prefill_bucket(len(p) - 1, LM_CFG["max_len"]),
                           len(p) + budget + SPEC_K) // pl)
                    for p in sorted(serve_prompts, key=len)[
                        -SPEC_SERVE["slots"]:])
    kw = dict(SPEC_SERVE, kv_pages=pages)
    _serve_generative(lm, workdir, "spec_warmup", serve_prompts[:2]
                      + serve_prompts[40:41], tap=False, spec_k=SPEC_K,
                      draft_lm=draft, **kw)
    plain, srv, _, stats["plain_paged"] = _serve_generative(
        lm, workdir, "plain", serve_prompts, tap=False, **kw)
    del srv
    _reset_counts(at, ek)
    served, srv, _, stats["serving"] = _serve_generative(
        lm, workdir, "spec", serve_prompts, tap=False, spec_k=SPEC_K,
        draft_lm=draft, **kw)
    launches["spec_serving"] = counts = _lm_counts(at, ek)
    flash = sum(prefill_bucket(len(p) - 1, LM_CFG["max_len"])
                > at.FUSED_SHORT_MAX_SEQ for p in serve_prompts)
    short = len(serve_prompts) - flash
    want = dict(want, fused_short_fwd=(blocks + 2) * short,
                flash_fwd=(blocks + 2) * flash,
                gather_rows=2 * len(serve_prompts)
                + (SPEC_K + 1) * srv.steps)
    check(counts == want, f"speculative serving launched {counts}, "
          f"expected {want}")
    totals = dict(srv.spec_totals)
    del srv
    uris = [f"spec-{i}" for i in range(len(serve_prompts))]
    same = sum(served[u] == plain[f"plain-{i}"] for i, u in enumerate(uris))
    stats["serving"].update(
        spec_k=SPEC_K, launches=counts,
        acceptance=totals["accepted"] / totals["proposed"],
        ms_per_round_wall=stats["serving"]["ms_per_step_wall"],
        streams_equal_to_plain_paged=same,
        **_held_to_serial(lm, serve_prompts, {u: served[u] for u in uris},
                          budget, "speculative serving"))
    stats["speedup_tokens_per_s_vs_plain_paged"] = (
        stats["serving"]["tokens_per_s"]
        / stats["plain_paged"]["tokens_per_s"])
    stats["round"] = _spec_round_stats(lm, draft, workdir,
                                       serve_prompts[:40]
                                       + serve_prompts[44:])

    # (c) a draft with its own weights: acceptance near 0, the reject path
    other = spec_draft(lm, seed + 55, shared=False)
    rej_prompts = serve_prompts[:SPEC_REJECT_STREAMS]
    rejected, srv, _, stats["reject"] = _serve_generative(
        lm, workdir, "reject", rej_prompts, tap=False, spec_k=SPEC_K,
        draft_lm=other, **dict(kw, slots=SPEC_REJECT_STREAMS))
    totals = dict(srv.spec_totals)
    del srv, other
    stats["reject"].update(
        acceptance=totals["accepted"] / totals["proposed"],
        **_held_to_serial(lm, rej_prompts, rejected, budget,
                          "speculative reject"))
    del lm, draft
    torch.cuda.empty_cache()

    # (d) the sampled accept rule keeps the target's distribution
    stats["sampled"] = _spec_sampled_distribution(seed)
    return launches, stats


def _spec_sampled_distribution(seed: int) -> dict:
    """Sampled ``generate_speculative`` on a small LM: the first emitted
    token of ``SPEC_SAMPLED_ROWS`` rows of one prompt (each row its own
    draws) against the target's filtered softmax at the prompt, by total
    variation; the draft's own distribution's distance beside it."""
    from analytics_zoo_tpu_torch.capture import TransformerLM
    from analytics_zoo_tpu_torch.ops.decode import make_logit_filter
    lm = TransformerLM(**SPEC_SMALL, seed=seed + 56)
    lm._device(None)
    draft = TransformerLM(**dict(SPEC_SMALL, n_block=1, max_len=SPEC_SMALL[
        "max_len"] + SPEC_K), seed=seed + 57)
    draft._device(None)
    prompt = np.random.RandomState(seed + 58).randint(
        0, SPEC_SMALL["vocab_size"], (1, 8))
    filt = make_logit_filter(SPEC_SAMPLED["temperature"],
                             SPEC_SAMPLED["top_k"], None)
    with torch.inference_mode():
        x = torch.as_tensor(prompt).cuda()
        p = torch.softmax(filt(lm._forward(x)[0, -1].float()), -1)
        q = torch.softmax(filt(draft._forward(x)[0, -1].float()), -1)
    t0 = time.perf_counter()
    out = lm.generate_speculative(np.repeat(prompt, SPEC_SAMPLED_ROWS, 0),
                                  draft, 2, spec_k=SPEC_K, seed=seed + 59,
                                  page_len=8, **SPEC_SAMPLED)
    wall = time.perf_counter() - t0
    freq = np.bincount(out[:, 0], minlength=SPEC_SMALL["vocab_size"]) \
        / SPEC_SAMPLED_ROWS
    p, q = p.cpu().numpy(), q.cpu().numpy()
    tv = 0.5 * float(np.abs(freq - p).sum())
    check(tv <= SPEC_TV_BOUND, f"sampled speculative first tokens are "
          f"{tv} from the target's distribution (bound {SPEC_TV_BOUND})")
    check(bool((freq[p == 0] == 0).all()), "a token outside the target's "
          "top-k was sampled")
    return {"rows": SPEC_SAMPLED_ROWS, **SPEC_SAMPLED,
            "tv_to_target": tv, "tv_bound": SPEC_TV_BOUND,
            "tv_draft_to_target": 0.5 * float(np.abs(q - p).sum()),
            "wall_s": wall}


#: the platform phase: NCF bursts, the generative fault and handoff runs
OPS_BURST = 512
OPS_BATCH = 64
OPS_GEN = dict(slots=8, max_new_tokens=24, kv_page_len=16)


def _ncf_send(inq, x, prefix: str) -> list:
    """Enqueue the rows of ``x`` as ``prefix-i``; returns their uris."""
    uris = [f"{prefix}-{i}" for i in range(len(x))]
    for uri, row in zip(uris, x):
        inq.enqueue_tensor(uri, row)
    return uris


def _ncf_wait(server, outq, uris, timeout_s=120) -> dict:
    """Wait for every uri's terminal result."""
    deadline = time.monotonic() + timeout_s
    results = {}
    while len(results) < len(uris):
        check(time.monotonic() < deadline, f"{len(results)} of "
              f"{len(uris)} terminals")
        server.check_health()
        for uri in uris:
            if uri not in results:
                res = outq.query(uri)
                if res is not None:
                    results[uri] = res
        time.sleep(0.005)
    return results


def _ops_cluster(ek, seed: int, workdir: str) -> tuple:
    """``ClusterServing`` of NCF with ``health_path``: a ``serving.predict``
    fault at one batch, a reload mid-burst, a failed reload, the health
    files read back, then a burst past ``max_pending`` (brownout)."""
    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import events
    from analytics_zoo_tpu_torch.serving import (ClusterServing, FileQueue,
                                                 InputQueue,
                                                 ModelReloadError,
                                                 OutputQueue, ServingConfig)
    models = []
    for i in range(2):
        ncf = NeuralCF(**NCF).build(torch.Generator().manual_seed(seed + i),
                                    device="cuda")
        path = os.path.join(workdir, f"ncf-v{i + 1}")
        ncf.save_model(path)
        models.append((ncf, path))
    health = os.path.join(workdir, "health", "health.json")
    os.makedirs(os.path.dirname(health))
    spool = os.path.join(workdir, "ops_spool")
    src = "dir://" + spool
    queue = CountingQueue(FileQueue(spool))
    server = ClusterServing(ServingConfig(
        model_path=models[0][1], data_src=src, image_shape=(2,),
        batch_size=OPS_BATCH, health_path=health, health_interval_s=0.05),
        queue=queue)
    check(server.model_version == "ncf-v1", server.model_version)
    inq, outq = InputQueue(src), OutputQueue(src)
    rng = np.random.default_rng(seed)
    x = ncf_pairs(rng, 3 * OPS_BURST)

    def forward(i, rows):
        with torch.inference_mode():
            return models[i][0].model(torch.from_numpy(rows).cuda()
                                      ).cpu().numpy()

    ek.reset_launch_counts()
    faults.arm("serving.predict", at=2)
    # 1. a burst, published before the server starts, whose second batch
    # meets the armed predict fault; 2. a reload to v2 while the second
    # burst is in flight; 3. a third burst after it; 4. a reload that
    # fails (injected), then one batch more
    a_uris = _ncf_send(inq, x[:OPS_BURST], "a")
    server.start()
    try:
        first = _ncf_wait(server, outq, a_uris)
        b_uris = _ncf_send(inq, x[OPS_BURST:2 * OPS_BURST], "b")
        t0 = time.perf_counter()
        server.reload_model(models[1][1])
        reload_s = time.perf_counter() - t0
        second = _ncf_wait(server, outq, b_uris)
        third = _ncf_wait(server, outq,
                          _ncf_send(inq, x[2 * OPS_BURST:], "c"))
        faults.arm("serving.reload", at=1)
        try:
            server.reload_model(models[0][1])
            check(False, "an injected reload fault did not raise")
        except ModelReloadError:
            pass
        check(server.model_version == "ncf-v2", "a failed reload changed "
              "the version")
        fourth = _ncf_wait(server, outq, _ncf_send(inq, x[:OPS_BATCH], "d"))
    finally:
        server.drain(timeout_s=60)
        faults.reset()
    launches = ek.launch_counts["gather_rows"]
    errors = {u: r for u, r in first.items() if "error" in r}
    check(len(errors) == OPS_BATCH and all(
        "serving.predict" in r["error"] for r in errors.values()),
          f"the armed predict fault errored {len(errors)} records")
    ok = [i for i in range(OPS_BURST) if f"a-{i}" not in errors]
    vals = np.array([first[f"a-{i}"]["value"] for i in ok])
    np.testing.assert_allclose(vals, forward(0, x[ok]), rtol=1e-5, atol=0)
    v1 = forward(0, x[OPS_BURST:2 * OPS_BURST])
    v2 = forward(1, x[OPS_BURST:2 * OPS_BURST])
    by_model = [0, 0]
    for i in range(OPS_BURST):
        res = second[f"b-{i}"]
        check("value" in res,
              f"b-{i} got {res} across the reload")
        got = np.asarray(res["value"])
        which = [np.allclose(got, v, rtol=1e-5, atol=0)
                 for v in (v1[i], v2[i])]
        check(any(which), f"b-{i} equals neither model's forward")
        by_model[which.index(True)] += 1
    for tag, res, i in (("c", third, 1), ("d", fourth, 1)):
        rows = x[2 * OPS_BURST:] if tag == "c" else x[:OPS_BATCH]
        got = np.array([res[f"{tag}-{j}"]["value"] for j in range(len(rows))])
        np.testing.assert_allclose(got, forward(i, rows), rtol=1e-5, atol=0)
    check(queue.posts == {u: 1 for u in queue.posts}
          and len(queue.posts) == 3 * OPS_BURST + OPS_BATCH,
          "a request got no terminal or more than one")
    with open(health) as f:
        snap = json.load(f)
    with open(os.path.join(os.path.dirname(health), "metrics.prom")) as f:
        prom = f.read()
    label = server.metrics_label
    n_values = 3 * OPS_BURST + OPS_BATCH - OPS_BATCH
    want = {"shed": 0, "expired": 0, "errors": OPS_BATCH, "claim_faults": 0,
            "reloads": 1, "reload_failures": 1}
    check(snap["counters"] == want and snap["state"] == "drained"
          and snap["model_version"] == "ncf-v2"
          and snap["records_served"] == n_values,
          f"health.json reads {snap}")
    for name, value in (("records_total", n_values),
                        ("error_total", OPS_BATCH), ("reload_total", 1),
                        ("reload_failure_total", 1)):
        line = f'zoo_serving_{name}{{server="{label}"}} {value}'
        check(line in prom, f"metrics.prom lacks {line!r}")
    cluster = {"records": len(queue.posts), "predict_fault_errors":
               len(errors), "reload_s": reload_s,
               "burst_b_by_model": {"v1": by_model[0], "v2": by_model[1]},
               "health_counters": snap["counters"],
               "latency_ms": snap["latency_ms"],
               "gather_rows": launches}

    # 5. a burst past max_pending: shed with errors, the brownout ladder
    log_dir = os.path.join(workdir, "events")
    ev_log = events.reset_default(root=log_dir, enabled=True)
    try:
        spool2 = os.path.join(workdir, "burst_spool")
        src2 = "dir://" + spool2
        burst = ClusterServing(ServingConfig(
            model_path=models[1][1], data_src=src2, image_shape=(2,),
            batch_size=OPS_BATCH, max_pending=2 * OPS_BATCH), queue=None)
        inq2 = InputQueue(src2)
        for i, row in enumerate(x[:8 * OPS_BATCH]):
            inq2.enqueue_tensor(f"o-{i}", row)
        levels = []
        while burst.serve_once():
            levels.append(burst._brownout.level)
            burst._last_shed_m = -1e18  # a shed pass (and tick) a batch
        for _ in range(4):  # calm ticks: the ladder steps back up
            burst._last_shed_m = -1e18
            burst.serve_once()
            levels.append(burst._brownout.level)
        evs = [{k: ev[k] for k in ev if k not in ("wall", "mono", "pid",
                                                  "seq", "label")}
               for ev in ev_log.read(types=["serving.shed",
                                            "serving.brownout_rung"])]
        results = OutputQueue(src2).dequeue()
        shed = sum(r.get("error") == "shed: queue overloaded"
                   for r in results.values())
        check(len(results) == 8 * OPS_BATCH and shed == burst.counters[
            "shed"] and shed > 0 and max(levels) >= 1,
              f"the burst: {len(results)} results, {shed} shed, levels "
              f"{levels}")
        burst.stop()
    finally:
        events.reset_default()
    cluster["brownout"] = {"levels": levels, "shed": shed, "events": evs}
    return cluster, launches


def _ops_generative(at, ek, seed: int, workdir: str) -> tuple:
    """``GenerativeServing`` at ``LM_CFG``'s width, paged: the
    ``serving.decode_step`` and ``serving.page_alloc`` faults, a handoff
    mid-decode to a second server, and a ``torch.profiler`` capture of two
    steps."""
    from analytics_zoo_tpu_torch.capture import TransformerLM
    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common import profiler
    from analytics_zoo_tpu_torch.serving import (GenerativeServing,
                                                 InputQueue, OutputQueue,
                                                 ServingConfig)
    from analytics_zoo_tpu_torch.serving.server import PAGE_SHED_ERROR
    lm = TransformerLM(**LM_CFG, seed=seed + 61)
    lm._device(None)
    budget, pl = OPS_GEN["max_new_tokens"], OPS_GEN["kv_page_len"]
    prompts = [p.tolist() for p in lm_tokens(seed + 62, 12, 100)]
    pages = 1 + OPS_GEN["slots"] * -(-(128 + budget) // pl)

    def server(name, **kw):
        src = f"dir://{os.path.join(workdir, name)}"
        return GenerativeServing(ServingConfig(
            data_src=src, kv_pages=pages, **dict(OPS_GEN, **kw)), lm), src

    def drive(srv, limit=400):
        idle = 0
        for _ in range(limit):
            idle = idle + 1 if srv.serve_step() == 0 else 0
            if idle >= 2:
                return

    out = {}
    _reset_counts(at, ek)
    # the decode_step fault: each active stream errors once, then more
    # streams join and complete
    srv, src = server("fault")
    inq, outq = InputQueue(src), OutputQueue(src)
    for i in range(4):
        inq.enqueue_prompt(f"f-{i}", prompts[i])
    faults.arm("serving.decode_step", at=3)
    try:
        for _ in range(4):
            srv.serve_step()
        for i in range(4, 8):
            inq.enqueue_prompt(f"f-{i}", prompts[i])
        drive(srv)
    finally:
        faults.reset()
    res = outq.dequeue()
    errs = sorted(u for u, r in res.items() if "error" in r)
    check(errs == [f"f-{i}" for i in range(4)]
          and all("serving.decode_step" in res[u]["error"] for u in errs)
          and all(res[f"f-{i}"].get("done") for i in range(4, 8))
          and srv.counters["errors"] == 4,
          f"decode_step fault: errors {errs}, counters {srv.counters}")
    # the page_alloc fault: the join is shed, the others go on
    for i in range(8, 10):
        inq.enqueue_prompt(f"f-{i}", prompts[i])
    faults.arm("serving.page_alloc", at=1)
    try:
        drive(srv)
    finally:
        faults.reset()
    res = outq.dequeue()
    check(res["f-8"].get("error") == PAGE_SHED_ERROR
          and res["f-9"].get("done") is True,
          f"page_alloc fault: {res['f-8']}, {res['f-9']}")
    out["faults"] = {"decode_step_errors": len(errs),
                     "page_alloc_shed": res["f-8"]["error"],
                     "counters": srv.health_snapshot()["counters"]}
    srv.stop()
    del srv

    # handoff mid-decode: 8 streams, 6 steps, then a second server adopts
    a, a_src = server("handoff_a")
    b, b_src = server("handoff_b")
    inq = InputQueue(a_src)
    for i in range(8):
        inq.enqueue_prompt(f"h-{i}", prompts[i])
    for _ in range(6):
        a.serve_step()
    t0 = time.perf_counter()
    moved = a.handoff(b.queue)
    handoff_ms = (time.perf_counter() - t0) * 1e3
    check(moved == 8, f"handoff moved {moved} streams")
    drive(b)
    res = OutputQueue(b_src).dequeue()
    check(sorted(res) == [f"h-{i}" for i in range(8)]
          and all(r.get("done") is True for r in res.values()),
          f"adopted streams: {res}")
    out["handoff"] = {"streams": moved, "handoff_ms": handoff_ms,
                      "adopted_prefix_tokens": 6,
                      **_held_to_serial(lm, prompts[:8],
                                        {f"h-{i}": res[f"h-{i}"]["value"]
                                         for i in range(8)}, budget,
                                        "handoff")}
    a.stop()
    del a

    # a torch.profiler capture of two steps of the adopting server
    cap_dir = os.path.join(workdir, "capture")
    profiler._reset_capture_for_tests()
    profiler.set_enabled(True)
    try:
        inq = InputQueue(b_src)
        for i in range(8, 12):
            inq.enqueue_prompt(f"cap-{i}", prompts[i])
        check(profiler.arm_capture(steps=2, out_dir=cap_dir),
              "arm_capture did not open a window")
        sp = profiler.StepProfiler("serving")
        for _ in range(2):
            sp.step_start()
            b.serve_step()
            sp.step_end()
        check(not profiler.capture_active(), "the capture did not close")
    finally:
        profiler.set_enabled(False)
    trace = profiler.last_trace()
    with open(trace) as f:
        trace_events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in trace_events if e.get("cat") == "kernel")
    check(kernels > 0, f"the capture {trace} holds no kernel")
    out["capture"] = {"file": os.path.relpath(trace, workdir),
                      "bytes": os.path.getsize(trace),
                      "kernel_events": kernels}
    b.stop()
    del b, lm
    torch.cuda.empty_cache()
    return out, _lm_counts(at, ek)


def _disabled_cost() -> dict:
    """ns a call of a disabled counter, histogram and profiler phase, and
    of the enabled ones, on this host (median of 5 runs of 200,000)."""
    from analytics_zoo_tpu_torch.common import metrics, profiler
    reg = metrics.Registry(capacity=256, enabled=False)
    c = reg.counter("serving.records_total", labels=())
    h = reg.histogram("serving.request_latency_seconds", labels=())
    n = 200_000

    def per_call(fn):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            runs.append((time.perf_counter() - t0) * 1e9 / n)
        return sorted(runs)[2]

    out = {"counter_inc_disabled_ns": per_call(c.inc),
           "histogram_observe_disabled_ns": per_call(lambda: h.observe(
               0.001)),
           "record_phase_disabled_ns": per_call(
               lambda: profiler.record_phase("cost", "fetch", 0.001))}
    reg.set_enabled(True)
    out["counter_inc_enabled_ns"] = per_call(c.inc)
    out["histogram_observe_enabled_ns"] = per_call(lambda: h.observe(0.001))
    reg.close()
    return out


def phase_serving_ops(at, ek, seed: int, workdir: str) -> tuple:
    """The serving platform on the card (see the module docstring, 23).
    Returns (launches by run, stats)."""
    cluster, ncf_rows = _ops_cluster(ek, seed, workdir)
    generative, gen_counts = _ops_generative(at, ek, seed, workdir)
    stats = {"cluster": cluster, "generative": generative,
             "disabled_cost": _disabled_cost()}
    return {"serving_ops_ncf": {"gather_rows": ncf_rows},
            "serving_ops_generative": gen_counts}, stats


#: phase 24's instances: paged f32, a partial every token (the failover
#: prefix and the adopter's first token are read from them)
FLEET = dict(slots=20, max_new_tokens=32, stream_interval=1, kv_page_len=16)
#: prompt length -> streams, in the order they are published (the router
#: fills one instance's free slots before it places on the next)
FLEET_PROMPTS = {1000: 2, 100: 32}
#: seconds a health file may age before the router calls its instance dead
#: (``fleet.stale_after_s``'s default: a step that joins many prompts
#: must not look like a death)
FLEET_STALE_S = 5.0
FLEET_SUP = dict(streams=16, prompt=100, slots=8, timeout_s=300)
#: tokens each stream on A has decoded when A stops
FLEET_STOP_AFTER = 8
FLEET_OPS = dict(burst=512, faulted_batches=4)
FLEET_CLIENT = dict(calls=8, hedged=8, prompt=100, new_tokens=8)


def _fleet_pages(prompts, budget: int) -> int:
    """Pages for every stream resident on one instance, twice over (an
    adopter holds its own streams and the dead instance's), plus the null
    page."""
    pl = FLEET["kv_page_len"]
    return 1 + 2 * sum(-(-(len(p) + budget) // pl) for p in prompts)


class _TerminalCount:
    """Counts the terminals a server posts through its queue."""

    def __init__(self, queue):
        self.counts = {}
        self._lock = threading.Lock()
        put = queue.put_result

        def counted(uri, value):
            if "error" in value or "value" in value:
                with self._lock:
                    self.counts[uri] = self.counts.get(uri, 0) + 1
            put(uri, value)
        queue.put_result = counted


def _assigned_to(router, name: str) -> list:
    """The uris the router has placed on instance ``name`` and not seen
    settle (read while the router's thread may be changing the map)."""
    while True:
        try:
            return sorted(u for u, e in list(router._assigned.items())
                          if e["instance"] == name)
        except RuntimeError:  # resized mid-copy: read again
            continue


def _loop_thread(fn, stop, errors, name):
    """Call ``fn`` until ``stop`` is set (a short nap when it did
    nothing); an exception lands in ``errors``."""
    def run():
        try:
            while not stop.is_set():
                if not fn():
                    time.sleep(0.002)
        except BaseException as e:  # surfaced by the phase
            errors.append(e)
            traceback.print_exc()
    t = threading.Thread(target=run, daemon=True, name=name)
    t.start()
    return t


def fleet_lm_factory(root: str, name: str):
    """``FleetSupervisor``'s instance factory: ``LM_CFG``'s TransformerLM
    from the seed in ``<root>/fleet.json``, paged ``GenerativeServing`` on
    the card on ``instance_queue(root, name)``. Without a card the LM's
    move raises ``NoCudaDeviceError``: an instance never serves from the
    CPU."""
    from analytics_zoo_tpu_torch.capture import TransformerLM
    from analytics_zoo_tpu_torch.common.config import global_config
    from analytics_zoo_tpu_torch.ops import kernel_build
    from analytics_zoo_tpu_torch.serving import (GenerativeServing,
                                                 ServingConfig,
                                                 instance_queue)
    with open(os.path.join(root, "fleet.json")) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global_config().set("serving.brownout_high", float("inf"))
    kernel_build.load_library()
    lm = TransformerLM(**LM_CFG, seed=spec["seed"])
    lm._device(None)
    return GenerativeServing(ServingConfig(
        data_src=root, kv_pages=spec["kv_pages"],
        health_path=os.path.join(root, f"{name}.health.json"),
        health_interval_s=0.05, **dict(FLEET, slots=spec["slots"])), lm,
        queue=instance_queue(root, name))


def _fleet_failover(at, ek, lm, seed: int, workdir: str) -> tuple:
    """(a) Two in-process instances behind a ``FleetRouter``; A stops
    mid-run and goes stale, B adopts its streams; then (d) a
    ``ResilientClient`` against the fleet front."""
    from analytics_zoo_tpu_torch.serving import (FileQueue, FleetInstance,
                                                 FleetRouter,
                                                 GenerativeServing,
                                                 InputQueue,
                                                 ResilientClient,
                                                 ServingConfig,
                                                 instance_queue)
    from analytics_zoo_tpu_torch.common.utils import wall_clock
    from analytics_zoo_tpu_torch.serving import fleet as fleet_mod
    budget = FLEET["max_new_tokens"]
    prompts = [p.tolist() for n, (s, k) in enumerate(FLEET_PROMPTS.items())
               for p in lm_tokens(seed + 72 + n, k, s)]
    uris = [f"fl-{i}" for i in range(len(prompts))]
    root = os.path.join(workdir, "fleet")
    front = FileQueue(root)
    pages = _fleet_pages(prompts, budget)
    servers, insts, counts = [], [], []
    for name in ("a", "b"):
        q = instance_queue(root, name)
        hp = os.path.join(root, f"{name}.health.json")
        servers.append(GenerativeServing(ServingConfig(
            data_src=root, kv_pages=pages, health_path=hp,
            health_interval_s=0.05, **FLEET), lm, queue=q))
        counts.append(_TerminalCount(q))
        insts.append(FleetInstance(name, q, hp, slots=FLEET["slots"]))
    a, b = servers
    router = FleetRouter(front, insts, stale_after_s=FLEET_STALE_S,
                         health_refresh_s=0.05)
    a.serve_step()
    b.serve_step()
    failovers0 = fleet_mod._M_FAILOVERS.value()
    stops = {k: threading.Event() for k in ("a", "b")}
    errors: list = []
    _reset_counts(at, ek)
    torch.cuda.synchronize()
    threads = {k: _loop_thread(srv.serve_step, stops[k], errors, f"fleet-{k}")
               for k, srv in (("a", a), ("b", b))}
    inq = InputQueue(f"dir://{root}")
    t0 = time.perf_counter()
    for uri, p in zip(uris, prompts):
        inq.enqueue_prompt(uri, p)
    router.start()
    deadline = time.monotonic() + 120
    while router.stats["assigned"] < len(uris):
        check(time.monotonic() < deadline, "fleet: the router placed "
              f"{router.stats} of {len(uris)}")
        time.sleep(0.01)
    first_on_a = _assigned_to(router, "a")
    # A runs until every stream first placed on it has decoded
    # FLEET_STOP_AFTER tokens (or finished), then stops: its health file
    # goes stale
    while True:
        check(not errors and time.monotonic() < deadline,
              f"fleet: A never streamed ({errors})")
        parts = [front.get_result(u) for u in first_on_a]
        if all(r is not None and (
                r.get("done") or len(r.get("stream") or [])
                >= FLEET_STOP_AFTER) for r in parts):
            break
        time.sleep(0.02)
    stops["a"].set()
    threads["a"].join(timeout=60)
    with open(a.config.health_path) as f:
        stale_at = json.load(f)["time"] + FLEET_STALE_S
    on_a = _assigned_to(router, "a")
    prefix_at_kill = {}
    for uri in on_a:
        res = front.get_result(uri) or {}
        if not res.get("done") and "error" not in res:
            prefix_at_kill[uri] = len(res.get("stream") or [])
    first_adopted = None
    results = {}
    deadline = time.monotonic() + 300
    while len(results) < len(uris):
        check(not errors and time.monotonic() < deadline,
              f"fleet: {len(results)} of {len(uris)} terminals ({errors})")
        for uri in uris:
            if uri in results:
                continue
            res = front.get_result(uri)
            if res is None:
                continue
            if (first_adopted is None and uri in prefix_at_kill
                    and len(res.get("value") or res.get("stream") or [])
                    > prefix_at_kill[uri]):
                first_adopted = wall_clock()
            if res.get("done") or "error" in res:
                results[uri] = res
        time.sleep(0.02)
    wall = time.perf_counter() - t0
    launches = _lm_counts(at, ek)
    errs = {u: r["error"] for u, r in results.items() if "error" in r}
    check(not errs, f"fleet: error terminals {errs}")
    terminals = {u: counts[0].counts.get(u, 0) + counts[1].counts.get(u, 0)
                 for u in uris}
    check(all(n == 1 for n in terminals.values()),
          f"fleet: terminals by uri {terminals}")
    got = {u: results[u]["value"] for u in uris}
    held = _held_to_serial(lm, prompts, got, budget, "fleet")
    for key in ("gather_rows", "fused_short_fwd", "flash_fwd"):
        check(launches[key] > 0, f"fleet: {key} never launched")
    n_tok = sum(len(t) for t in got.values())
    failover = {
        "streams": len(uris), "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "streams_first_placed_on_a": len(first_on_a),
        "streams_on_a_at_stop": len(on_a),
        "streams_unfinished_on_a": len(prefix_at_kill),
        "streams_continued_with_prefix":
            int(fleet_mod._M_FAILOVERS.value() - failovers0),
        "prefix_tokens_at_stop": sorted(prefix_at_kill.values()),
        "stale_to_adopted_token_s": (first_adopted - stale_at
                                     if first_adopted else None),
        "terminals_by_instance": {"a": sum(counts[0].counts.values()),
                                  "b": sum(counts[1].counts.values())},
        "launches": launches, **held}
    check(prefix_at_kill and first_adopted is not None,
          "fleet: no stream was continued on B")

    # (d) a ResilientClient against the fleet front: retries of the
    # router's retriable shed, hedges, all within the retry budget
    client = ResilientClient(f"dir://{root}", backoff_s=0.01)
    short = lm_tokens(seed + 75, FLEET_CLIENT["calls"]
                      + FLEET_CLIENT["hedged"], FLEET_CLIENT["prompt"])
    answers = []
    for i in range(FLEET_CLIENT["calls"]):
        def enqueue(uri, p=short[i].tolist()):
            # a first attempt asks for a budget no instance can decode in
            # its deadline: the router sheds it (retriable); a retry asks
            # for FLEET_CLIENT's budget, no deadline
            if "~r" in uri:
                inq.enqueue_prompt(uri, p,
                                   max_new_tokens=FLEET_CLIENT["new_tokens"])
            else:
                inq.enqueue_prompt(uri, p, deadline_ms=100, max_new_tokens=(
                    LM_CFG["max_len"] - FLEET_CLIENT["prompt"]))
        answers.append(client.call(f"rc-{i}", enqueue, timeout_s=60))
    for i in range(FLEET_CLIENT["hedged"]):
        p = short[FLEET_CLIENT["calls"] + i].tolist()
        answers.append(client.query_any(
            f"hq-{i}", lambda uri, p=p: inq.enqueue_prompt(
                uri, p, max_new_tokens=FLEET_CLIENT["new_tokens"]),
            timeout_s=60, hedge_delay_s=0.02))
    time.sleep(0.5)  # a hedge's loser may still be decoding
    reaped = client.reap_pending()
    n_req = client.requests_sent
    bound = n_req * (1 + client.budget.ratio) + 1
    values = sum(1 for r in answers if r is not None and "value" in r)
    sheds = sum(1 for r in answers if r is not None
                and r.get("error") == fleet_mod.FLEET_SHED_ERROR)
    check(all(r is not None for r in answers)
          and values + sheds == len(answers) and values > 0
          and client.attempts_sent <= bound,
          f"resilient client: {answers}, {client.attempts_sent} attempts "
          f"for {n_req} requests")
    resilient = {"requests": n_req, "attempts": client.attempts_sent,
                 "attempt_bound": bound, "values": values,
                 "final_sheds": sheds, "losers_reaped": reaped,
                 "budget_tokens_left": client.budget.tokens}
    router.stop()
    stops["b"].set()
    threads["b"].join(timeout=60)
    check(not errors, f"fleet threads: {errors}")
    del a, b, servers
    torch.cuda.empty_cache()
    return failover, resilient, launches


def _fleet_supervisor(lm, seed: int, workdir: str) -> dict:
    """(b) ``FleetSupervisor`` spawns two instances of the same LM, the
    router spreads a burst over them, one scales in through its
    ``DRAIN_`` flag and ``handoff`` mid-decode; the audit journals hold
    one terminal a uri and the tokens are serial ``generate``'s."""
    import collections

    from analytics_zoo_tpu_torch.cluster import FleetSupervisor
    from analytics_zoo_tpu_torch.serving import (FileQueue, FleetRouter,
                                                 InputQueue)
    budget = FLEET["max_new_tokens"]
    prompts = [p.tolist() for p in lm_tokens(
        seed + 74, FLEET_SUP["streams"], FLEET_SUP["prompt"])]
    uris = [f"sup-{i}" for i in range(len(prompts))]
    root = os.path.join(workdir, "fleet_sup")
    front = FileQueue(root)
    with open(os.path.join(root, "fleet.json"), "w") as f:
        json.dump({"seed": seed + 71, "slots": FLEET_SUP["slots"],
                   "kv_pages": _fleet_pages(prompts, budget)}, f)
    router = FleetRouter(front, [], stale_after_s=30.0,
                         health_refresh_s=0.05)
    sup = FleetSupervisor(router, root, "chip_smoke:fleet_lm_factory",
                          min_instances=2, max_instances=2,
                          slots=FLEET_SUP["slots"], scale_interval_s=0.0,
                          ready_timeout_s=FLEET_SUP["timeout_s"])
    t0 = time.perf_counter()
    events = []
    try:
        while sup.alive_count() < 2:
            # an instance that dies before READY is retried once
            check(sup._counter <= 3, f"fleet supervisor: instances died "
                  f"before READY ({events})")
            ev = sup.step()
            if ev:
                events.append(ev)
        spawn_s = time.perf_counter() - t0
        inq = InputQueue(f"dir://{root}")
        for uri, p in zip(uris, prompts):
            inq.enqueue_prompt(uri, p)
        # route until both instances stream, then scale in the newest
        deadline = time.monotonic() + 120
        while True:
            check(time.monotonic() < deadline, "fleet supervisor: the "
                  "instances never streamed")
            router.route_once()
            parts = [front.get_result(u) for u in uris]
            by = collections.Counter(e["instance"] for e in
                                     router._assigned.values())
            if (len(by) == 2 and sum(1 for r in parts if r is not None
                                     and r.get("stream")) >= 4):
                break
            time.sleep(0.01)
        placed = dict(by)
        sup.min_instances = sup.max_instances = 1
        t_in = time.perf_counter()
        ev = None
        while ev is None:
            ev = sup.step()
        events.append(ev)
        check(ev.startswith("in:"), f"fleet supervisor: {ev}")
        results = {}
        deadline = time.monotonic() + 240
        while len(results) < len(uris) or sup._draining:
            check(time.monotonic() < deadline,
                  f"fleet supervisor: {len(results)} of {len(uris)}")
            router.route_once()
            sup.step()
            for uri in uris:
                if uri not in results:
                    res = front.get_result(uri)
                    if res is not None and (res.get("done")
                                            or "error" in res):
                        results[uri] = res
            time.sleep(0.005)
        scale_in_s = time.perf_counter() - t_in
        status = sup.status()
    finally:
        sup.shutdown(timeout_s=120)
    terminals = collections.Counter()
    audit = os.path.join(root, "audit")
    for name in os.listdir(audit):
        with open(os.path.join(audit, name)) as f:
            terminals.update(line.strip() for line in f if line.strip())
    check(terminals == collections.Counter(uris),
          f"fleet supervisor: audit {dict(terminals)}")
    errs = {u: r["error"] for u, r in results.items() if "error" in r}
    check(not errs, f"fleet supervisor: error terminals {errs}")
    held = _held_to_serial(lm, prompts, {u: results[u]["value"]
                                         for u in uris}, budget,
                           "fleet supervisor")
    peaks = {}
    for name in sorted(os.listdir(root)):
        if name.startswith("exit_"):
            with open(os.path.join(root, name)) as f:
                peaks[name[5:-5]] = json.load(f)["peak_device_bytes"]
    check(len(peaks) == 2 and all(peaks.values()),
          f"fleet supervisor: peak memory {peaks}")
    return {"events": events, "spawn_two_s": spawn_s,
            "placed_before_scale_in": placed, "scale_in_to_done_s":
            scale_in_s, "status_after": status,
            "terminals": sum(terminals.values()),
            "peak_device_bytes": peaks, **held}


def _fleet_ops(ek, seed: int, workdir: str) -> tuple:
    """(c) ``ClusterServing`` of NCF with ``ops.enabled`` under a
    ``serving.predict`` fault burst: a burn-rate alert fires into
    ``health.json``, an incident is sealed, its timeline renders in causal
    order, and a ``trace()`` session holds each record's flow chain."""
    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common.config import global_config
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import alerts, events, incident
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 InputQueue, OutputQueue,
                                                 ServingConfig)
    from analytics_zoo_tpu_torch.utils import trace
    ncf = NeuralCF(**NCF).build(torch.Generator().manual_seed(seed + 81),
                                device="cuda")
    path = os.path.join(workdir, "ncf-ops")
    ncf.save_model(path)
    ops_dir = os.path.join(workdir, "ops_events")
    health = os.path.join(workdir, "ops_health", "health.json")
    os.makedirs(os.path.dirname(health))
    cfg = global_config()
    settings = {"ops.enabled": True, "ops.dir": ops_dir,
                "ops.sample_interval_s": 0.05, "ops.eval_interval_s": 0.05}
    for k, v in settings.items():
        cfg.set(k, v)
    events.reset_default(root=ops_dir, enabled=True)
    src = "dir://" + os.path.join(workdir, "ops_fleet_spool")
    n = FLEET_OPS["burst"]
    x = ncf_pairs(np.random.default_rng(seed + 82), n)
    trace_path = os.path.join(workdir, "fleet_ops_trace.json")
    try:
        server = ClusterServing(ServingConfig(
            model_path=path, data_src=src, image_shape=(2,),
            batch_size=OPS_BATCH, health_path=health,
            health_interval_s=0.05))
        inq, outq = InputQueue(src), OutputQueue(src)
        ek.reset_launch_counts()
        server.start()
        time.sleep(0.3)  # the sampler's baseline before the burst
        faults.arm("serving.predict", p=1.0,
                   budget=FLEET_OPS["faulted_batches"])
        t0 = time.perf_counter()
        with trace.trace(trace_path):
            res = _ncf_wait(server, outq, _ncf_send(inq, x, "ops"))
            t_done = time.perf_counter()
            time.sleep(0.2)  # a result is read before its flow end lands
        fired = faults.fire_count("serving.predict")
        faults.reset()
        fired_s = None
        deadline = time.monotonic() + 30
        while True:
            with open(health) as f:
                snap = json.load(f)
            if snap.get("alerts") and snap.get("incident"):
                fired_s = time.perf_counter() - t0
                after_last_s = time.perf_counter() - t_done
                break
            check(time.monotonic() < deadline,
                  f"no alert in health.json: {snap.get('alerts')}")
            time.sleep(0.02)
        launches = ek.launch_counts["gather_rows"]
        server.drain(timeout_s=60)
        errors = sum(1 for r in res.values() if "error" in r)
        check(fired == FLEET_OPS["faulted_batches"] and errors > 0
              and errors == server.counters["errors"]
              and all("serving.predict" in r["error"]
                      for r in res.values() if "error" in r),
              f"fleet ops: {fired} faults, {errors} error terminals, "
              f"counters {server.counters}")
        bundle = incident.load_bundle(snap["incident"]["path"])
        timeline = incident.render_timeline(
            bundle["events"], reason=bundle["reason"],
            alert=bundle["alert"])
        evs = incident.order_events(events.default_log().read())
        types = [e["type"] for e in evs]
        check("fault.fired" in types and "ops.alert" in types
              and "ops.incident" in types
              and types.index("fault.fired") < types.index("ops.alert")
              < types.index("ops.incident"),
              f"fleet ops: event order {types}")
    finally:
        faults.reset()
        alerts.shutdown_default()
        events.reset_default(enabled=False)
        for k in settings:
            cfg.unset(k)
    with open(trace_path) as f:
        trace_evs = json.load(f)
    chains = {}
    for e in trace_evs:
        tid = (e.get("args") or {}).get("trace_id")
        if e.get("ph") == "X" and tid is not None:
            chains.setdefault(tid, set()).add(e["name"])
    stages = {"serving.enqueue", "serving.claim", "serving.decode",
              "serving.dispatch", "serving.result"}
    whole = sum(1 for c in chains.values() if c == stages)
    check(whole == n and len(chains) == n,
          f"fleet ops: {whole} whole flow chains of {n}")
    log("fleet ops timeline (first lines):\n"
        + "\n".join(timeline.splitlines()[:12]))
    return {"records": n, "faulted_batches": fired,
            "predict_fault_errors": errors,
            "alerts": snap["alerts"], "incident": snap["incident"],
            "alert_in_health_s_from_burst_start": fired_s,
            "alert_in_health_s_after_last_result": after_last_s,
            "timeline_lines": len(timeline.splitlines()),
            "event_types_in_order": [t for t in types if t in (
                "fault.fired", "ops.alert", "ops.incident")][:8],
            "whole_flow_chains": whole,
            "trace_bytes": os.path.getsize(trace_path),
            "gather_rows": launches}, launches


def phase_fleet(at, ek, seed: int, workdir: str) -> tuple:
    """The serving fleet on the card (see the module docstring, 24).
    Returns (launches by run, stats)."""
    from analytics_zoo_tpu_torch.capture import TransformerLM
    torch.cuda.reset_peak_memory_stats()
    lm = TransformerLM(**LM_CFG, seed=seed + 71)
    lm._device(None)
    failover, resilient, gen_counts = _fleet_failover(at, ek, lm, seed,
                                                      workdir)
    sup = _fleet_supervisor(lm, seed, workdir)
    del lm
    torch.cuda.empty_cache()
    ops, ncf_rows = _fleet_ops(ek, seed, workdir)
    stats = {"failover": failover, "supervisor": sup, "ops": ops,
             "resilient_client": resilient,
             "parent_peak_device_bytes": torch.cuda.max_memory_allocated()}
    return {"fleet_ncf": {"gather_rows": ncf_rows},
            "fleet_generative": gen_counts}, stats


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
        f"{kernel_build.last_build_seconds:.3f} s); ptxas -v: "
        + json.dumps(timed("ptxas", ptxas_report, kernel_build)))

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    timings, max_err, gather_cases = timed("gather_kernel", phase_kernels,
                                           ek, dev, gen, args.seed)
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
        # -- 25. the Estimator's training loop --------------------------
        torch.cuda.empty_cache()
        loop_launches, loop_stats = timed(
            "estimator_loop", phase_estimator_loop, at, ek, args.seed,
            workdir)
        log("estimator loop " + json.dumps(loop_stats) + f" | {smi}")
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
    # -- 20. generative serving (the slice's main path) ----------------------
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        with brownout_off():
            gen_serving_launches, gen_serving = timed(
                "generative", phase_generative, at, ek, args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for part, part_stats in gen_serving.items():
        log(f"generative {part} " + json.dumps(part_stats) + f" | {smi}")
    # -- 22. speculative decoding, 23. the serving platform -------------------
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        with brownout_off():
            spec_launches, spec = timed("speculative", phase_speculative,
                                        at, ek, args.seed, workdir)
        for part, part_stats in spec.items():
            log(f"speculative {part} " + json.dumps(part_stats)
                + f" | {smi}")
        torch.cuda.empty_cache()
        ops_launches, ops = timed("serving_ops", phase_serving_ops, at, ek,
                                  args.seed, workdir)
        for part, part_stats in ops.items():
            log(f"serving_ops {part} " + json.dumps(part_stats)
                + f" | {smi}")
        # -- 24. the serving fleet -------------------------------------------
        torch.cuda.empty_cache()
        with brownout_off():
            fleet_launches, fleet = timed("fleet", phase_fleet, at, ek,
                                          args.seed, workdir)
        for part, part_stats in fleet.items():
            log(f"fleet {part} " + json.dumps(part_stats) + f" | {smi}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # -- 21. heads past 256 ---------------------------------------------------
    torch.cuda.empty_cache()
    wide512_launches, attn_wide = timed("attn_wide", phase_attn_wide, at,
                                        ek, dev, args.seed)
    for part, part_stats in attn_wide.items():
        log(f"heads past 256 {part} " + json.dumps(part_stats) + f" | {smi}")
    # -- 18. heads of 256 ----------------------------------------------------
    torch.cuda.empty_cache()
    wide_launches, heads256 = timed("wide_heads", phase_wide_heads, at, ek,
                                    dev, args.seed)
    log("heads of 256 " + json.dumps(heads256) + f" | {smi}")
    # -- 16. ResNet-50 trained on the card -----------------------------------
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        resnet_stats = timed("resnet50", phase_resnet50, at, ek, args.seed,
                             workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for part, part_stats in resnet_stats.items():
        log(f"resnet50 {part} " + json.dumps(part_stats) + f" | {smi}")
    # -- 17. ResNet-50 and BERT-base served (north-star #5) -------------------
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        resnet_serving = timed("resnet50_serving", phase_resnet50_serving,
                               at, ek, args.seed, workdir)
        log("resnet50_serving " + json.dumps(resnet_serving) + f" | {smi}")
        bert_serving_launches, bert_serving = timed(
            "bert_serving", phase_bert_serving, at, ek, args.seed, workdir)
        log("bert_serving " + json.dumps(bert_serving) + f" | {smi}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # -- 19. the int8 ResNet: served calibrated, trained in int8 -------------
    torch.cuda.empty_cache()
    quant18 = timed("resnet18_quantized", phase_resnet18_quantized,
                    args.seed)
    log("resnet18_quantized " + json.dumps(quant18) + f" | {smi}")
    torch.cuda.empty_cache()
    int8_50 = timed("resnet50_int8", phase_resnet50_int8, at, ek, args.seed,
                    resnet_stats["bench"])
    log("resnet50_int8 " + json.dumps(int8_50) + f" | {smi}")
    torch.cuda.empty_cache()
    int8_train = timed("int8_training", phase_int8_training, args.seed)
    log("int8_training " + json.dumps(int8_train) + f" | {smi}")
    log("phases, s: " + json.dumps(phase_s))

    # -- 8. the kernels line, 9. the result line ------------------------------
    serve = timings[0]
    lm_paths = {"lm_train": lm_launches, "lm_long": long_launches,
                **{f"lm_generate_{n}": c for n, c in gen_launches.items()},
                **wide_launches, **gen_serving_launches, **spec_launches,
                "serving_ops_generative":
                    ops_launches["serving_ops_generative"],
                "fleet_generative": fleet_launches["fleet_generative"]}
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
                     "estimator_loop": loop_launches["gather_rows"],
                     "bert_serving": bert_serving_launches["gather_rows"],
                     "serving_ops_ncf":
                         ops_launches["serving_ops_ncf"]["gather_rows"],
                     "fleet_ncf": fleet_launches["fleet_ncf"]["gather_rows"],
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
        "grid_cases": gather_cases,
        "l2_resident": serve["l2_resident"],
        "cold_device_ms": serve.get("cold_device_ms"),
        # 2^20 ids, then the LM's, BERT's and the sharded W&D's lookups;
        # where the bytes fit in L2 (l2_resident) bound_ms holds for the
        # cold time, not the warm one
        "large": [{k: t.get(k) for k in (
            "table", "rows", "n", "dim", "dtype", "clip", "ms", "plain_ms",
            "library_ms", "bound_ms", "device_ms", "plain_device_ms",
            "library_device_ms", "l2_resident", "cold_device_ms",
            "library_cold_device_ms")} for t in timings[len(NCF_TABLES):]],
    }
    int8_serve = quant["int8"][0]
    int8_by_path = {"serving_int8": int8_serve["gather_int8"],
                    "serving_bf16": quant["bf16"][0]["gather_int8"],
                    "calibrated_int8": calib_launches["gather_int8"]}
    served8 = int8_timings[0]
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
        # NCF's other tables at 256 ids, all four at one id, then 2^20 ids
        # of the 1 GiB table
        "large": [{k: t[k] for k in (
            "table", "rows", "n", "dim", "ms", "plain_ms", "library_ms",
            "bound_ms", "device_ms", "plain_device_ms", "library_device_ms",
            "library_max_abs_diff")} for t in int8_timings[1:]],
        "served_lookup_kernels": quant["int8"][1]["lookup_kernels"],
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
    by_shape = {t["shape"]: t for t in scatter_timings}
    wnd_shard = by_shape.pop("wnd_shard")
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
        # a sharded step's three blocks on rank 1, then the 1 GiB block
        "large": [{k: t[k] for k in (
            "shape", "rows", "dim", "n", "in_range", "ms", "device_ms",
            "plain_ms", "plain_device_ms", "library_ms", "library_device_ms",
            "bound_ms", "max_abs_err", "turns")} for t in by_shape.values()],
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
        by_path["bert_serving"] = bert_serving_launches[name]
        by_path.update({k: c[name] for k, c in lm_paths.items()})
        by_path["bert_vs_cpu"] = bert_cpu["launches"][name]
        by_path["estimator_loop"] = loop_launches[name]
        bf16_paths = set(bert_launches) | {"bert_serving", "estimator_loop"}
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
                                 if k in bf16_paths}}}
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
                                 if k not in bf16_paths}}
        # heads of 256, both routes, at ATTN_WIDE_TIMED
        heads_256 = {}
        for tag, u in heads256["fused"].items():
            heads_256[tag] = {
                "shape": u["shape"], "ms": u[f"{key}_ms"],
                "device_ms": u[f"{key}_device_ms"],
                "plain_ms": u[f"plain_{key}_ms"],
                "bound_ms": u[f"{key}_bound"][0],
                "bound_by": u[f"{key}_bound"][1],
                "library_ms": u[library[0]],
                "max_abs_err": u[f"{key}_max_abs_err"]}
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
            "routes": routes, "heads_256": heads_256,
        })
    flash_sources = {
        "bf16_tc": "analytics_zoo_tpu_torch/csrc/flash_attn_bf16.cu",
        "f32_tc": "analytics_zoo_tpu_torch/csrc/flash_attn_tf32.cu"}
    flash_paths = {**lm_paths, **{f"longseq_{k}": c
                                  for k, c in longseq_launches.items()}}
    flash_entries = []
    flash.update(heads256["flash"])  # the d 256 timings, by label
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
        entry_k["heads_256"] = {lab: timed_at(lab)
                                for lab, _, _ in FLASH_WIDE_TIMED}
        flash_entries.append(entry_k)
    wide_entries = []
    for name, key, line, also, launched in (
            ("attn_wide_fwd", "fwd", 203, 716,
             ("flash_fwd", "fused_short_fwd")),
            ("attn_wide_bwd_dq", "dq", 379, 761,
             ("flash_bwd_dq", "flash_bwd_fused", "fused_short_bwd")),
            ("attn_wide_bwd_dkv", "dkv", 428, 761,
             ("flash_bwd_dkv", "flash_bwd_fused", "fused_short_bwd"))):
        t = attn_wide["timed"]["float32"]
        n = sum(wide512_launches[k] for k in launched)
        lib = "library_fwd_ms" if key == "fwd" else "library_fwd_bwd_ms"
        wide_entries.append({
            "name": name, "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/attn_wide.cu",
            "replaces": f"analytics_zoo_tpu/ops/attention.py:{line}",
            "also_replaces": f"analytics_zoo_tpu/ops/attention.py:{also}",
            "heads": "past 256 columns", "launches": n,
            "launches_by_path": {"lm_heads_512": n},
            "wrappers": list(launched),
            "max_abs_err": t[f"{key}_max_abs_err"],
            "max_rel_err_grid": attn_wide["grid"]["max_rel_err"],
            "shape": f"{t['shape']} f32 causal",
            "ms": t[f"{key}_ms"], "kernel_ms": t[f"{key}_ms"],
            "device_ms": t[f"{key}_device_ms"],
            "plain_ms": t[f"plain_{key}_ms"],
            "bound_ms": t[f"{key}_bound"][0],
            "bound_by": t[f"{key}_bound"][1],
            "bound_rate": "3xTF32, 494.7 / 3 TFLOP/s",
            "bound_ms_f32_cuda_cores": t[f"{key}_bound_simt"][0],
            "library_ms": t[lib],
            "library": "scaled_dot_product_attention(is_causal=True), "
                       + ("forward" if key == "fwd" else
                          "forward and backward (it has no backward "
                          "alone)"),
            "bf16": {k: v for k, v in attn_wide["timed"]["bfloat16"].items()
                     if k.startswith((key, f"plain_{key}", "library"))}})
    print(smi)
    print(json.dumps({"kernels": [entry, pool_entry, scatter_entry,
                                  int8_entry]
                      + attn_entries + flash_entries + wide_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
