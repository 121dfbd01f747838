"""Drive the PyTorch/CUDA port (infinitensor_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing with a nonzero exit, each printing its seconds:
  1. the card: CUDA present; its name and power limit (nvidia-smi);
  2. build every kernel from kernels/csrc/ (one nvcc per source, in
     parallel), timed;
  3. each kernel against its plain PyTorch version on the card at the
     Llama-2-7B shapes of its path: decode (bs=1, ctx=1024), the prompt's
     attention (S=1024) and its matmuls at 256 rows, and the serving
     engine's paged decode (8 slots, pages of 64 rows, ragged positions
     around 1024, a shuffled block table, NaN in every row no slot owns or
     past its position); max error, median
     time, the least time the card could take (bytes over the published
     3.35 TB/s or operations over the published tensor-core peak,
     whichever is larger, and bytes over the device-to-device copy rate
     measured here), the plain version's time and one PyTorch library
     call's time; qmm_group's tensor-core form (qmm_group_mma) at the 7B
     shapes at SLOTS, 64 and SHORT rows, GPT-2's int8 w_o, w_down and
     lm_head at 64 rows and wo at SHORT rows of f16, each beside the
     CUDA-core form's time in the same call; qmm_w4a8's tensor-core form
     (qmm_w4a8_mma) at the lm_head's SLOTS and SHORT rows, and
     qmm_group_ln's (qmm_group_ln_mma) at GPT-2's w_qkv and w_up at 64
     rows (its library row also from the raw rows: F.layer_norm +
     addmm), and qmm_group_norm's (qmm_group_norm_mma, an RMSNorm
     pre-pass then qmm_group_mma's tile) at wqkv and w_gateup at SLOTS,
     64 and SHORT rows (beside the tile alone on rows normalized
     beforehand), each beside the CUDA-core form in the same call, with a
     crossover of both forms at 1-8 rows; qmm_chunk's (qmm_chunk_mma,
     that tile with each weight scaled and rounded to bf16 before the
     mma) at group 64 on wqkv, w_gateup, wo, w_down and the lm_head at
     SLOTS, 64 and SHORT rows, and qmm_norm_w4a8's (qmm_norm_w4a8_mma,
     the RMSNorm in the int8 tile's quantize pre-pass; no main path) on
     wqkv and w_gateup at the same rows under phase 10's knobs (beside its
     tile alone), each beside the CUDA-core form, forced, with a
     crossover of qmm_chunk's forms at 1-4 rows; qmm_group_norm at one row
     in its ring form (qmm_group_norm_ring, csrc/quant_matmul_ring.cu: a
     balanced persistent grid and a cp.async ring) on wqkv
     and w_gateup beside the CUDA-core form, forced (which keeps a row of
     its own), each within one bf16 ulp at max|plain|, and both, with
     qmm_group's 1-row split on wo and w_down, also read back to back:
     one launch per layer's copy of the weight, 32 of them captured in one
     CUDA graph (ms a launch, as the decode graph sees them); and the
     crossover tables of both forms, forced: qmm_group at 1-8 rows,
     qmm_w4a8 at 1-5, 8, 64 and 256 rows, qmm_group_ln at 1, 8 and
     64 rows (with its tile alone on rows normalized beforehand), which
     set MMA_MIN_ROWS, W4A8_MMA_MIN_ROWS and CHUNK_MMA_MIN_ROWS; the W4A8
     pair at one row in its ring form (csrc/quant_matmul_w4a8_ring.cu: the
     same grid and ring, the row quantized inside, an integer dp4a
     consumer): qmm_w4a8_ring on the lm_head (phase 4's) and, under phase
     10's knobs, on wo and w_down, qmm_norm_w4a8_ring on wqkv and w_gateup,
     each beside its CUDA-core form, forced (which keeps rows of its own),
     within one bf16 ulp at max|plain| of the plain version and of that
     form, both also back to back in one CUDA graph (the lm_head 8 times
     over its one copy); qmm_slab_norm at one row in its ring form
     (qmm_slab_norm_ring, csrc/quant_matmul_ring.cu: the same ring with
     one scale row a stage) on phase 8's paired wqkv and w_gateup, and
     qmm_group2d at one row in its ring form (qmm_group2d_ring, one
     launch) on wo and w_down under phase 11's table, each beside its old
     form, forced (the CUDA-core body; the two-launch split and its
     splitk_sum), which keeps a row of its own, within one bf16 ulp of
     the plain version and of that form, both also back to back over the
     32 layers' copies in one CUDA graph, and qmm_group2d_ring with an f16
     and an f32 x (one f16 ulp, 1e-5 of max|plain|); the paired
     tensor-core forms (qmm_slab_norm_mma on wqkv and w_gateup,
     qmm_slab_mma on wqkv, wo, w_gateup and w_down: qmm_group_mma's tile
     over one scale row a packed group) at SLOTS, 64 and SHORT rows of
     phase 8's paired weights, each beside the CUDA-core body, forced,
     and the unpaired tile on the same shape (the group-128 build), with
     a crossover of both paired forms at 1-8 rows; the
     dense decode attention
     (flash_decode, flash_decode_q8) in the split form its wrappers take
     at batch 1 beside the forced unsplit form, the split form's merge
     (flash_decode_merge) on partials of the 7B shape, and the crossover
     of the forms at 8-1024 (batch, kv head) blocks, 96-192 among them,
     where the rule flips; both paged kernels in the ring form their
     route takes (csrc/paged_flash_decode_ring.cu: page chunks over a
     ring of asynchronous page copies, the merge inside) at MHA 32/32 and
     GQA 32/8, beside the block form (csrc/paged_flash_decode.cu),
     forced, which keeps a row of its own, and the crossover of both
     forms at pages of 16 and 64 rows over chunks of 64 rows to the whole
     table, at ragged positions and at phase 6's uniform pos 640 (sets
     pa.ring_chunks and pa.paged_form); flash_attention at the 7B prompt and at
     entry()'s; the attention wrappers at the f16 shapes of phase 14
     (flash_attention on its prompt, also in bf16 and in f16 at head dim
     96, flash_decode and flash_decode_q8 at pos CTX split and unsplit,
     the merge, both paged kernels at the serving shape), each in its
     fast 16-bit form beside the any-type body it replaced
     (csrc/attention_any.cuh, forced through the old route), and the
     same in f32 (library calls with torch.backends.cuda.matmul.allow_tf32
     False; within 1e-5 of max|plain|): the f32 decode (an f32 q over f32
     or INT8 caches and pages) takes the fast body, beside the
     any-type body, which keeps rows of its own (the `_any` names); each
     of the
     five attention wrappers at every q dtype (bf16, f16, f32) and head
     dim 8, 16, 64, 72, 96, 128, 136, 256 against its plain version (the
     any-type grid, untimed, each reporting its form); the 1-row
     matmuls that take the K split (qmm_group, qmm_slab and
     qmm_chunk on a short grid, and qmm_group_ln at GPT-2's w_qkv and
     w_up, LayerNorm and bias inside the split) each beside the form
     before it, forced (qm._SPLITS = 1); the any-type prefill
     (csrc/flash_attention_any.cuh) in f32 at causal 1 x 32 x 256 x 128
     and 1 x 32 x 1024 x 128, held within 1e-5 of max|plain| (f32, TF32
     off), and in bf16 at 1 x 32 x 256 x 256, each beside SDPA;
  4. the 7B INT4 + INT8-KV decode path with random weights built on the
     card as bench.py builds them: one step with the kernels against the
     same step on the plain versions (CPU), then llama_decode_multi for
     128 greedy steps under a CUDA graph (tokens equal to an eager loop),
     tok/s (min of 3 fresh runs) against the copy-rate roofline, a
     torch.profiler window over one graph run (busy share, kernel ms a
     token), and each
     kernel's launch count on that path (no tensor-core form at 1 row;
     qmm_group_norm 64 a token, all of them qmm_group_norm_ring; the
     lm_head's qmm_w4a8 once, in its ring form;
     flash_decode_q8 and flash_decode_merge 32 a token; qmm_group_split
     64: wo and w_down take the K split), the same region with
     the matmuls' K split forced off, and with qmm_group_norm's CUDA-core
     form forced (qm.group_form patched for the capture), read in turns
     with the ring form's graph, its tokens equal up to a printed
     near-tie;
  5. the prompt -> generate path (greedy_generate) with the same weights
     and a seeded 1024-token prompt, for 128 tokens with the default bf16
     cache and again with an INT8 cache: prefill ms, prompt tok/s, the
     decode tok/s of the generate loop (min of 3 runs) against its
     roofline, the launches of every kernel and of the dequant route;
     a 256-token prompt, whose matmuls take the kernels (qmm_group_mma
     4 x 32 launches a prefill, qmm_w4a8_mma 1), its prefill ms beside
     the 1024-token one's; prefill of S-1
     tokens plus one bf16 decode step against the S-token prefill; a
     2-layer model of 7B width, kernels on the card against the plain
     versions on the CPU;
  6. the serving path at full width: PagedServingEngine over the same 7B
     INT4 weights, 8 slots, pages of 64 rows, buckets (128, 512, 1024),
     decode chunks of 8 under one captured CUDA graph, and a pool of 96
     usable pages (6144 tokens, against 8 x 1664 for a dense cache) so
     that admission waits for reclaim; 24 seeded requests of 64-900 prompt
     tokens and 32-128 new tokens; once with the bf16 pool and once with
     the INT8 pool. Every request ends with its token count and every page
     returns to the free list; the tokens equal the dense ServingEngine's
     on the same stream and one request's equal greedy_generate's, each
     up to a first near-tie whose logit gap is printed; a snapshot taken
     mid-stream and restored into a fresh engine ends in the same tokens;
     the paged kernel is launched 32 times per decode step, every time
     in its ring form (no flash_decode_merge launch), and
     flash_attention 32 times per prefill pass; a decode step at 8 rows
     launches qmm_group_mma 4 x 32 times where MMA_MIN_ROWS <= 8 and
     qmm_w4a8_mma once where W4A8_MMA_MIN_ROWS <= 8, and the dense
     engine's step qmm_group_norm_mma and qmm_group_mma 2 x 32 times each.
     Prints generated tok/s over the drain, decode ms per step at 8 live
     slots and the engine's stats slices; the paged step at 8 live slots
     (one captured step replayed, CUDA events) with the paged kernel's
     block form forced (pa.paged_form patched for the capture) and in its
     ring form, in turns, and 16 greedy tokens of each equal up to a
     printed near-tie; with the INT8 cache the dense
     engine's step at 8 live slots (one captured step replayed, CUDA
     events) with qmm_group_norm in its tensor-core form, forced to the
     CUDA-core form (qm.group_form patched for the capture) and in its own
     form again, in turns, and 16 greedy tokens of each equal up to a
     printed near-tie;
  7. GPT-2 345M INT8 continuous batching at full width and depth (dim
     1024, 24 layers, 16 heads of 64, vocab 50257 with the int8 lm_head
     padded to 51200 columns, max_seq 384), weights made on the card from
     seed 0: one decode step at 64 slots with the kernels against the same
     step on the plain versions (CPU), per cache type; then the serving
     bench (infinitensor_tpu_torch/tools/serving_bench.py: 64 slots,
     buckets (64, 256), chunks of 64, pipeline depth 2, lookahead, 192
     requests of 16-249 prompt tokens and 64 new tokens) with the bf16
     cache and again with the INT8 cache. Every request ends with 64
     tokens; the tokens with INFINITPU_GPT2_FUSED_LN=1 equal those with
     =0, and one request's equal a batch-1 prefill + decode loop, each up
     to a first near-tie whose logit gap is printed (limit G_TIE); every
     token of every request is the pick, or within G_FORCED of the pick,
     of gpt2_prefill forced along the same history; a decode step
     launches qmm_group_ln 48 times, qmm_group 49 (all of them
     qmm_group_mma, and all 48 qmm_group_ln_mma, where MMA_MIN_ROWS <=
     64) and flash_decode (or
     flash_decode_q8) 24. Prints generated tok/s over the drain (every
     sample), ms per step at 64 live slots, the stats slices and a
     torch.profiler window over one chunk. Then batch 1 (path "gpt2
     decode bs1"): one eager step after a 64-token prompt launches
     qmm_group_ln 48 times, all in the K split (qmm_group_ln_split 48);
     the step captured as one CUDA graph with the split, with only the
     qmm_group_ln launches unsplit and with every split off
     (qm._SPLITS = 1), each replay timed in turns, and 16 greedy steps
     of each graph equal up to a printed near-tie;
  8. Llama-2-7B INT4 decode with paired scales (one scale row per pair of
     split-half groups), INT8 KV, bs=1, ctx 1024: one step of the first
     4 layers with the kernels against the plain versions (CPU), 128
     graph-replayed steps with tokens equal to an eager loop, tok/s (min
     of 3) against the
     copy-rate roofline with the paired byte count; a token launches
     qmm_slab_norm 64 times, all of them qmm_slab_norm_ring, qmm_slab 65,
     flash_decode_q8 32 and no qmm_group, qmm_group_norm or qmm_w4a8; the
     region read in turns with qmm_slab_norm's CUDA-core form forced
     (qm.slab_form patched for the capture), its tokens equal up to a
     printed near-tie; then a seeded SHORT-token prefill of that model
     (its norm unfused: qmm_slab_mma 4 L + 1 launches, no
     qmm_slab_norm_mma) and the dense ServingEngine's captured step at
     SLOTS live slots over its weights (INT8 cache; qmm_slab_norm_mma 2 L
     and qmm_slab_mma 2 L + 1 a step), each read in turns with the
     CUDA-core body forced (qm.slab_form patched; new, forced, new), the
     prefill's last logits and 16 greedy tokens of the step equal up to a
     printed near-tie;
  9. the same decode with INT4 weights at group 64, the quantization of
     __graft_entry__.entry() at 7B width: every linear takes qmm_chunk
     (wqkv and w_gateup through rmsnorm + quant_matmul), 129 launches a
     token (wqkv, wo and w_down in the K split) and no qmm_group*,
     qmm_w4a8 or qmm_slab*; a seeded 256-token prefill of that model
     (qmm_chunk_mma 129 launches) and the dense ServingEngine's captured
     step at SLOTS live slots over its weights (INT8 cache; qmm_chunk_mma
     129 a step), each read in turns with qmm_chunk's CUDA-core form forced (qm.chunk_form
     patched; new, forced, new), the prefill's last logits and 16 greedy
     tokens of the step equal up to a printed near-tie; then the port's
     entry() (infinitensor_tpu_torch/entry.py) once, its launches
     (qmm_chunk_mma at its 2 rows) counted and its logits held against
     the plain versions on the CPU;
 10. the group-128 decode under INFINITPU_QMM_VARIANT=w4a8 with an empty
     tuning table (INFINITPU_QMM_TUNE): qmm_norm_w4a8 64 and qmm_w4a8 65
     launches a token, all in their ring forms (qmm_norm_w4a8_ring 64,
     qmm_w4a8_ring 65); the region read in turns with the CUDA-core forms
     forced (qm.w4a8_form patched for the capture), its tokens equal up to
     a printed near-tie; with the default table the env var changes
     nothing (its entries win), so one step then launches what phase 4's
     does;
 11. the group-128 decode with a copy of the port's tuning table whose wo
     and w_down entries read {"variant": "group2d", "bn": 1024, "kb": kb},
     kb chosen so that the split-K grid fills the card's SMs where the
     packed rows allow it: qmm_group2d 64, all of them qmm_group2d_ring
     (one launch each: the profiler window shows no splitk_sum),
     qmm_group_norm 64 (the ring form), qmm_w4a8 1 (the ring form); the
     region read in turns with the two-launch split forced
     (qm.group2d_form patched for the capture), its tokens equal up to a
     printed near-tie.
 12. the 7B decode of phase 4 built through the graph IR
     (models/graph_llama.py build_llama_decoder, weights bound without a
     copy, GraphExecutor): one eager step launches qmm_group_norm 64 (the
     ring form), qmm_group 64, qmm_w4a8 1 (the ring form), flash_decode_q8
     32 and rmsnorm 1, its logits held against llama_decode_step's; 128 steps of
     make_fused_greedy_decode (one CUDA graph of 128 steps) equal 128
     eager graph steps and phase 4's tokens up to a printed near-tie;
     tok/s (min of 3) beside phase 4's, the eager ms per step; then
     GraphLlamaServingAdapter under ServingEngine at 7B width, 2 layers, 8
     slots, INT8 cache, 6 seeded requests of 8-32 prompt tokens and 16 new
     tokens (the final norm is rmsnorm at 8 rows), tokens equal to the
     hand-written dense engine's up to a printed near-tie;
 13. the Longformer block of tools/rewrite_speedup.py (batch 1, 8 heads,
     S 2048, head dim 128, one-sided window 64) in the JAX package's band
     form through GraphHandler (G2BMM, scale, edge mask, Softmax, GBMM), in
     f32 and bf16, against the dense masked S x S attention in plain torch
     (relative error against f64 within 1e-4 in f32, 4e-2 in bf16; the
     same check must fail with one row of v moved), launching the ring
     forms of g2bmm and gbmm once each; the captured block's ms in 6
     pairs of single runs with the same block captured with the first
     forms; then G2BMM -> GBMM in f32 at shapes no band kernel takes (k
     512 and w 128, whose window no block's shared memory holds; bz
     65536), which the lowering's gate sends to its gather or shift-scan
     path: no band launch, within 1e-4 of max|plain|;
 14. the 7B model of phase 4 as an f16 model (the same INT4 codes, scales
     rescaled to weights of rms 1/sqrt(din) so that the residual fits f16;
     f16 embedding, norms, activations and cache): greedy_generate on a
     seeded 256-token prompt with the f16 cache and with an INT8 cache
     (flash_attention 32 a prefill, flash_decode or flash_decode_q8 and
     flash_decode_merge in the decode, no any-type form), prefill ms (host
     clock, and one CUDA graph's replay) and a decode step's ms (one CUDA
     graph); a 2-layer f16 prefill against
     the plain versions on the CPU; one decode step of 8 slots over f16
     pages and over INT8 pages (the fast paged kernels, 32 launches each,
     no any-type form) against the same step over a dense cache, its ms
     (one CUDA graph); each time beside the any-type body's, forced
     through the old route, read in turns in this call;
 15. OPT-1.3B (dim 2048, 24 layers, 32 heads of 64, FFN 8192, vocab
     50272; random weights from a seed), bf16 activations and cache, with
     bf16 weights and with INT8 weights at group 128: the first CPU_LAYERS
     layers against the CPU plain path (a 256-token prompt's last logits
     and the next step's), then at full depth the prompt (ms; 96
     qmm_group_mma with INT8 weights, no kernel in bf16), a decode step
     against the prefill's logits, and 64 greedy steps eager and from one
     captured step (24 flash_decode and 24 flash_decode_merge a step, with
     INT8 96 qmm_group, all in the K split; ms a step, tok/s against the
     copy-rate roofline of the bytes a token reads); INT8 also a batch of
     8 prompts of 17-256 tokens, one batched step at each prompt's own
     position against its batch-1 step (96 qmm_group_mma, 24
     flash_decode);
 16. BERT-base (12 layers, dim 768, 12 heads; B 2, S 128; f32):
     bert_encode against the CPU, the FP32 and dynamic-INT8 graphs
     (build_bert_graph) through GraphExecutor eager and captured, the FP32
     graph against the CPU (1e-3 of max|h|), INT8 against FP32 (mean|dh|
     / rms(h) < 5 %), and the INT8 graph exported to ONNX, re-imported
     and run, bit for bit the in-memory graph's output; ms of each;
 17. ResNet-18-v2, DenseNet-121, Inception-v2 and EfficientNet-Lite4 at
     224 x 224, batch 1, 1000 classes, f32: each exported to ONNX bytes,
     re-imported and run captured on the card, within 1e-3 of max|ref| of
     the CPU's eager run of the directly built graph and bit for bit the
     directly built graph's output on the card; ms an image, the ONNX MB,
     and the error with cuDNN's TF32 left on, for the record;
 18. the graph corpus's kernel cases (tests/torch_graph_cases.py
     case_matmul_woq, case_attention_kvcache) through ONNX: the imported
     graph launches the direct graph's kernels (each nonzero) and gives
     its outputs bit for bit;
 19. the optimizer and the tuner on the card: the Longformer block of
     tools/rewrite_speedup.py (masked S x S attention in standard ops,
     through ONNX, phase 13's shape) in f32 and bf16, searched with a
     fresh PerfEngine (each candidate's per-op cost sum printed): the
     winner holds G2BMM and GBMM, launches g2bmm_ring and gbmm_ring once
     each, meets phase 13's limits against the f64 dense attention and the
     standard-op graph (and fails them on a moved v row); both graphs
     captured, in turns; the qkv workload (12 layers, batch 8, dim 2048)
     through optimize_graph(2) and the search, held to the unoptimized
     graph; the tuner's three sweeps at the 7B and OPT-1.3B decode shapes
     and 7B's wo / w_down (each candidate's ms beside the default rule's
     choice; a second pass times nothing); memory_report of the 2-layer
     graph-built 7B beside max_memory_allocated of a captured step;
 20. NNET (nnet/*) on the card: the three conv families of
     tools/derivation_bench.py (the ResNet stem, the dilated 3x3, the
     Inception 1x1) at full width in f32, each conv + relu: NMutator
     derives mutants with its oracle's evaluations on the card (the
     candidate count and each mutant's op types printed; one must hold
     a MatMul and a MemBound, the im2col form); every mutant, captured,
     within 1e-4 of max|base| of the Conv graph's output, and past it
     with one filter of W moved; SearchEngine(mutator=NMutator()) with a
     fresh PerfEngine (each candidate's per-op cost sum printed), its
     pick held to the same limit; the base graph and each mutant
     captured in turns; every op of each mutant timed alone (the stem's
     im2col gather is the standalone MemBound); the phase's peak of
     max_memory_allocated and its seconds.
Phase 3 also holds qmm_group at OPT-1.3B's four shapes (int8, group 128
at 1, 8 and 256 rows, and one group of din at 1 and 256 rows),
flash_decode at 32 heads of 64 at batch 1 and 8, and the merge of its
split.
Phase 9 also runs greedy_generate on entry()'s model (head dim 64), whose
prefill launches flash_attention at D 64.
Phases 8-11 each check one step of their first CPU_LAYERS (4) layers
against the plain versions on the CPU,
128 graph-replayed steps equal to an eager loop, and print tok/s (min of
3) against the copy-rate roofline and a torch.profiler window over one
graph run (busy share, kernel ms a token). Phase 3 also holds the kernels of
phases 7-11 against their plain versions at those shapes (64 rows of 1024
features; B 64, 16 heads of 64, S 384, ragged pos in [16, 313]; the paired
7B matmuls at 1 row;
qmm_chunk at group 64 and qmm_norm_w4a8's CUDA-core form at 1, 2 and 8
rows, qmm_group2d at 1 row), and the graph slice's kernels: rmsnorm at 1,
8, 64, 256, 1024 and 4096 rows of 4096 in bf16 and f32 (within 1e-5 of
max|plain| in f32), g2bmm and gbmm (the ring form beside the first
form forced; 1e-5 of max|plain| in f32) at the phase 13 shape (f32,
bf16) and at Longformer-base's attention (12 heads of 64, window 256, S
4096, bf16), flash_attention at head dim 64 at entry()'s prompt (q, k, v [2, 8,
64, 64]).
The last lines are the kernels JSON (every kernel, the any-type forms
and the K split's forms among them), nvidia-smi's name and power
limit,
and {"ok": true, "device": {...}}. A report goes to chiprun_out/.
"""

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12        # H100 SXM published device-memory rate
PEAK_OPS = {"bf16": 989e12, "f16": 989e12,     # dense tensor-core peaks
            "int8": 1979e12,
            "f32": 67e12}                          # f32 outside them
SEED = 0
CTX = 1024                   # decode position (bench.py BENCH_CTX)
MAX_SEQ = 1664               # bench.py cache capacity at ctx 1024
STEPS = 128                  # tokens per CUDA-graph region (BENCH_MULTI)
PROMPT = 1024                # phase 5 prompt length (ctx of the decode)
SHORT = 256                  # the longest prompt whose matmuls take kernels
GEN = 128                    # greedy_generate tokens in phase 5
TOL = 1e-2                   # kernel vs plain: max err <= TOL * max|plain|
SLOTS = 8                    # phase 6: decode batch of the serving engines
PAGE = 64                    # rows per KV page
POOL_PAGES = 97              # page 0 is the trash page: 96 usable
BUCKETS = (128, 512, 1024)   # prefill buckets
CHUNK = 8                    # decode steps per fetch
REQUESTS = 24
TIE = 5e-2                   # near-tie: logit gap <= TIE * max|logit|
G_SLOTS = 64                 # phase 7: tools/serving_bench.py defaults
G_MAXSEQ = 384
G_CHUNK = 64
G_PIPELINE = 2
G_REPS = 2
GPT2_BF16, GPT2_INT8 = "gpt2 serving bf16", "gpt2 serving int8"
G_TIE = 2.5e-2               # phase 7's near-tie: this random model's mean
#                              top-1/top-2 gap is 3.4e-2 of max|logit|, so
#                              TIE would let a runner-up pass
G_FORCED = {GPT2_BF16: 2.5e-2, GPT2_INT8: 3e-2}   # teacher-forced limits
PAIRED = "paired decode"
G64, W4A8, SPLIT = "group64 decode", "w4a8 decode", "split-K decode"
F16_PROMPT = f"f16 prompt {SHORT}"       # phase 14
F16_PROMPT_Q8 = f"f16 prompt {SHORT} int8"
F16_PAGED = "f16 paged step"
GPT2_BS1 = "gpt2 decode bs1"             # phase 7, batch 1
DENSE_BF16 = "serving dense bf16"        # phase 6, the dense engine
DENSE_INT8 = "serving dense int8"
DENSE_STEPS = 16             # phase 6: greedy steps of each dense form
G64_PROMPT = f"group64 prompt {SHORT}"   # phase 9: the group-64 prefill
DENSE_G64 = "serving dense g64 int8"     # ... and its dense 8-slot step
PAIRED_PROMPT = f"paired prompt {SHORT}"  # phase 8: the paired prefill
DENSE_PAIRED = "serving dense paired int8"  # ... and its dense 8-slot step
CPU_LAYERS = 4               # phases 8-11: layers of the step held against
#                              the plain versions on the CPU
PAGED_POS = (CTX - 331, CTX - 64, CTX - 1, CTX, CTX + 1, CTX + 63,
             CTX + 200, CTX + 477)  # phase 3's ragged slots (693-1501)
G_BS1_PROMPT = 64            # ... its prompt tokens
G_BS1_STEPS = 16             # ... and greedy steps, split and unsplit
SRC = "infinitensor_tpu_torch/kernels/csrc/"
TPU = "infinitensor_tpu/kernels/"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@contextlib.contextmanager
def knobs(env):
    """Set the environment variables in `env` (None: unset) for the block;
    the matmul wrappers read the variant knobs at every call."""
    old = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text):
    """One line per kernel of an nvcc -Xptxas -v log: the end of its
    mangled name (the template arguments), its registers and shared
    memory, its spills."""
    out, name, spill = [], "?", ""
    for line in text.splitlines():
        if "Function properties for" in line:
            name = line.split("for ", 1)[1].strip().split("EEv")[0][-56:]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


def cuda_ms(torch, fn, reps, flush=None):
    """Median milliseconds of fn() over `reps` CUDA-event timings, with
    the L2 cache overwritten before each (cold weights, as in decode)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bf16_ulp(v):
    """One bf16 ulp at v > 0 (8 significant bits)."""
    return ulp_at(v, 8)


def ulp_at(v, bits):
    """One ulp at v > 0 of a float type of `bits` significant bits."""
    return 2.0 ** (math.floor(math.log2(v)) - bits + 1)


def graph_launch_ms(torch, fn, weights):
    """Milliseconds a launch of fn(w) for each w of weights (distinct
    copies, so that each launch finds its weight cold, as the decode graph
    does layer after layer), all captured back to back in one CUDA graph:
    the median of 20 timed replays over len(weights)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for w in weights:
            fn(w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for w in weights:
            fn(w)
    ms = cuda_ms(torch, graph.replay, 20) / len(weights)
    del graph
    return ms


def copy_rate(torch):
    """Device-to-device copy_ of 1 GB: bytes read + written per second."""
    n = 1 << 30
    a = torch.empty(n, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    ms = cuda_ms(torch, lambda: b.copy_(a), 10)
    del a, b
    return 2 * n / (ms * 1e-3)


class Counters:
    """The launch counters of the kernel modules: zeroed just before a
    path runs, read just after."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self):
        for m in self.modules:
            m.launches.clear()

    def read(self):
        out = {}
        for m in self.modules:
            out.update(m.launches)
        return out


def phase(n, t0):
    print(f"# phase {n} done in {time.perf_counter() - t0:.1f}s", flush=True)
    return time.perf_counter()


def main():
    import torch

    t_phase = time.perf_counter()
    # 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.core.dtype import DataType
    from infinitensor_tpu_torch.kernels import _build, band, norms
    from infinitensor_tpu_torch.kernels import attention as att
    from infinitensor_tpu_torch.kernels import flash_attention as fa
    from infinitensor_tpu_torch.kernels import paged_attention as pa
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    from infinitensor_tpu_torch.models import gpt2, graph_llama, llama
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    from infinitensor_tpu_torch.tools import serving_bench
    from infinitensor_tpu_torch.quant.weight_only import (
        QuantizedLinear, dequant_matmul, dequantize_weight, quantize_weight)

    smi = smi_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    print(f"# card: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    report = {"card": smi, "torch": torch.__version__}
    counters = Counters(qm, att, fa, pa, norms, band)
    # the matmul variant knobs take the defaults outside phases 10 and 11
    for k in ("INFINITPU_QMM_VARIANT", "INFINITPU_QMM_TUNE"):
        os.environ.pop(k, None)
    t_phase = phase(1, t_phase)

    # 2. build
    t0 = time.perf_counter()
    took = _build.build_all()
    build_s = time.perf_counter() - t0
    per_src = {k: round(v, 1) for k, v in took.items()}
    print(f"# kernels built in {build_s:.1f}s (per source: {per_src})",
          flush=True)
    for log in sorted(_build.build_dir().glob("*.log")):
        for line in ptxas_summary(log.read_text()):
            print(f"# {log.stem}: {line}")
    report["build_s"] = build_s
    t_phase = phase(2, t_phase)

    # 3. kernels against their plain versions at the 7B shapes
    bw_copy = copy_rate(torch)
    print(f"# device-to-device copy: {bw_copy / 1e9:.1f} GB/s", flush=True)
    report["copy_gbps"] = bw_copy / 1e9
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = llama.LlamaConfig(max_seq=MAX_SEQ)
    params = build_params(torch, cfg, gen, dev, QuantizedLinear)
    g64params = build_params(
        torch, cfg, torch.Generator(device=dev).manual_seed(SEED + 9), dev,
        QuantizedLinear, group=64)
    # phase 8's paired weights, also phase 3's (row 10c back to back)
    pparams = build_params(torch, cfg, torch.Generator(device=dev).manual_seed(
        SEED + 8), dev, QuantizedLinear, paired=True)
    envs, kbs = variant_envs(qm, _build, cfg, params)
    report["split_kb"] = kbs
    print(f"# split-K: kb {kbs} (packed rows per block; grid = column "
          "tiles of 128 x packed rows / kb)", flush=True)
    gcfg = gpt2.GPT2Config(max_seq=G_MAXSEQ)
    gparams = serving_bench.build_params(gcfg, dev, seed=SEED)
    # 1 GB: its memset overwrites the 50 MB L2 and outlasts the host's
    # enqueueing of a timed call (~0.3 ms), so the events time the card,
    # not the wrapper's Python
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    eps = cfg.norm_eps
    layer0 = params["layers"][0]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # path: the run whose launch counts a case reports (phase 4 "decode",
    # phase 5 "prompt 1024" with the bf16 cache, phase 5 "prompt 256")
    cases = []
    # qmm_group_norm at 1 row: the route's ring form (the decode's), beside
    # the CUDA-core form forced, which keeps a row of its own (no main path
    # takes it at 1 row of int4); both also back to back over the 32
    # layers' copies of the weight in one CUDA graph (graph_ms), as the
    # decode graph runs them
    for label, q in (("wqkv", layer0["wqkv"]),
                     ("w_gateup", layer0["w_gateup"])):
        x = randn(1, cfg.dim)
        nw = (torch.rand(cfg.dim, generator=gen, device=dev) + 0.5).to(
            torch.bfloat16)
        xn = qm.rmsnorm_bf16(x, nw, eps)
        w = dequantize_weight(q)
        n = q.out_features
        layers = [lay[label] for lay in params["layers"]]

        def core(q, x=x, nw=nw, n=n):
            return qm._launch_group(x, nw, q, eps, "qmm_group_norm",
                                    form="cuda_core")[:, :n]

        def ring(q, x=x, nw=nw):
            return qm.quant_matmul_norm(x, nw, q, eps)

        row = dict(
            shape=label, replaces=TPU + "quant_matmul.py:85",
            plain=lambda x=x, nw=nw, q=q, n=n: qm.qmm_group_plain(
                qm.rmsnorm_bf16(x, nw, eps), q)[:, :n],
            library=lambda xn=xn, w=w: torch.matmul(xn, w),
            bytes=nbytes(x, nw, q.qweight, q.scales) + 2 * q.out_physical,
            ops=2 * cfg.dim * q.out_physical, kind="bf16", ulp=True,
            graph_weights=layers)
        cases.append(dict(
            row, name="qmm_group_norm_ring", path="decode",
            source=SRC + "quant_matmul_ring.cu",
            kernel=lambda q=q, f=ring: f(q),
            cuda_core=lambda q=q, f=core: f(q),
            graph={"ring": ring, "cuda_core": core}))
        cases.append(dict(
            row, name="qmm_group_norm", path=NO_PATH,
            source=SRC + "quant_matmul.cu",
            kernel=lambda q=q, f=core: f(q), graph={"cuda_core": core}))
    decode_mm = (("wo", layer0["wo"], cfg.dim),
                 ("w_down", layer0["w_down"], cfg.intermediate))
    prompt_mm = (("wqkv", layer0["wqkv"], cfg.dim), decode_mm[0],
                 ("w_gateup", layer0["w_gateup"], cfg.dim), decode_mm[1])
    # SLOTS rows: the paged engine's decode step, which does not fuse the
    # norm, so all four matmuls of a layer are qmm_group
    for rows, path, shapes in ((1, "decode", decode_mm),
                               (SLOTS, "serving paged bf16", prompt_mm),
                               (SHORT, f"prompt {SHORT}", prompt_mm)):
        for label, q, din in shapes:
            x = randn(rows, din)
            w = dequantize_weight(q)
            cases.append(dict(
                name="qmm_group",
                shape=label if rows == 1 else f"{label} {rows} rows",
                path=path, replaces=TPU + "quant_matmul.py:100",
                source=SRC + "quant_matmul.cu",
                # 1 row: the K split, beside the form before it, and back
                # to back over the 32 layers' copies in one CUDA graph
                **({"forms": {"unsplit": unsplit(qm, lambda x=x, q=q:
                                                  qm.quant_matmul(x, q))},
                    "graph": {"split": lambda q, x=x: qm.quant_matmul(x, q)},
                    "graph_weights": [lay[label]
                                      for lay in params["layers"]]}
                   if rows == 1 else {}),
                kernel=lambda x=x, q=q: qm.quant_matmul(x, q),
                plain=lambda x=x, q=q: qm.qmm_group_plain(x, q)[
                    :, :q.out_features],
                library=lambda x=x, w=w: torch.matmul(x, w),
                bytes=nbytes(x, q.qweight, q.scales)
                + 2 * rows * q.out_physical,
                ops=2 * rows * din * q.out_physical, kind="bf16"))
    q = params["lm_head"]
    w = dequantize_weight(q)
    if qm.route(randn(1, cfg.dim), q)[0] != "qmm_w4a8":
        fail("the variant table does not route the lm_head to w4a8")
    # 1 row: the ring form (the route's), beside the CUDA-core form, forced,
    # which keeps a row of its own (no main path takes it at 1 row of
    # int4), both also back to back in one CUDA graph (the one lm_head, 8
    # times: its 67.6 MB exceed the 50 MB L2); SLOTS and SHORT rows: the
    # tensor-core form (the path's own call), beside the CUDA-core form
    for rows, path in ((1, "decode"), (SLOTS, "serving paged bf16"),
                       (SHORT, f"prompt {SHORT}")):
        x = randn(rows, cfg.dim)
        form = qm.w4a8_form(rows, x.dtype, False, q.bits)
        row = dict(
            shape="lm_head" if rows == 1 else f"lm_head {rows} rows",
            replaces=TPU + "quant_matmul.py:283",
            plain=lambda x=x, q=q: qm.qmm_w4a8_plain(x, q)[
                :, :q.out_features],
            library=lambda x=x, w=w: torch.matmul(x, w),
            bytes=nbytes(x, q.qweight, q.scales) + 2 * rows * q.out_physical,
            ops=2 * rows * cfg.dim * q.out_physical, kind="int8")
        core = lambda q, x=x: qm._launch_w4a8(   # noqa: E731
            x, q, form="cuda_core")[:, :q.out_features]
        cases.append(dict(
            row, name={"mma": "qmm_w4a8_mma", "ring": "qmm_w4a8_ring"}.get(
                form, "qmm_w4a8"), path=path,
            source=SRC + {"mma": "quant_matmul_w4a8_mma.cu",
                          "ring": "quant_matmul_w4a8_ring.cu"}.get(
                form, "quant_matmul.cu"),
            kernel=lambda x=x, q=q: qm.quant_matmul(x, q),
            **({"cuda_core": lambda q=q, f=core: f(q)}
               if form != "cuda_core" else {}),
            **({"ulp": True, "graph_weights": [q] * 8,
                "graph": {"ring": lambda q, x=x: qm.quant_matmul(x, q),
                          "cuda_core": core}} if form == "ring" else {})))
        if form == "ring":
            cases.append(dict(
                row, name="qmm_w4a8", path=NO_PATH,
                source=SRC + "quant_matmul.cu", ulp=True,
                kernel=lambda q=q, f=core: f(q)))
    for label, H, Hkv in (("mha 32/32", 32, 32), ("gqa 32/8", 32, 8)):
        D, S = cfg.head_dim, MAX_SEQ
        qh = randn(1, H, 1, D)
        kc = torch.randint(-127, 128, (1, Hkv, S, D), generator=gen,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-127, 128, (1, Hkv, S, D), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand(1, Hkv, S, generator=gen, device=dev) * 0.015 + 0.005
        vs = torch.rand(1, Hkv, S, generator=gen, device=dev) * 0.015 + 0.005
        pos = torch.full((1,), CTX, dtype=torch.int32, device=dev)
        live = CTX + 1
        rep = H // Hkv
        kf = (kc[:, :, :live].float() * ks[:, :, :live, None]).to(
            torch.bfloat16).repeat_interleave(rep, 1)
        vf = (vc[:, :, :live].float() * vs[:, :, :live, None]).to(
            torch.bfloat16).repeat_interleave(rep, 1)
        args = (qh, kc, vc, ks, vs, pos)
        if label.startswith("mha"):
            q8_mha = args
        cases.append(dict(
            name="flash_decode_q8", shape=f"{label} pos {CTX}",
            path="decode", replaces=TPU + "attention.py:345",
            source=SRC + "flash_decode.cu",
            kernel=lambda a=args: att.flash_decode_q8(*a),
            plain=lambda a=args: att.flash_decode_q8_plain(*a),
            forms={"unsplit": lambda a=args: att.flash_decode_q8(
                *a, _splits=1)},
            library=lambda qh=qh, kf=kf, vf=vf:
                torch.nn.functional.scaled_dot_product_attention(qh, kf, vf),
            bytes=2 * Hkv * live * (D + 4) + 2 * nbytes(qh),
            ops=4 * H * live * D, kind="bf16"))
        kb, vb = randn(1, Hkv, S, D), randn(1, Hkv, S, D)
        args = (qh, kb, vb, pos)
        kr = kb[:, :, :live].repeat_interleave(rep, 1)
        vr = vb[:, :, :live].repeat_interleave(rep, 1)
        cases.append(dict(
            name="flash_decode", shape=f"{label} pos {CTX}",
            path=f"prompt {PROMPT}", replaces=TPU + "attention.py:294",
            source=SRC + "flash_decode.cu",
            kernel=lambda a=args: att.flash_decode(*a),
            plain=lambda a=args: att.flash_decode_plain(*a),
            forms={"unsplit": lambda a=args: att.flash_decode(
                *a, _splits=1)},
            library=lambda qh=qh, kr=kr, vr=vr:
                torch.nn.functional.scaled_dot_product_attention(qh, kr, vr),
            bytes=2 * Hkv * live * D * 2 + 2 * nbytes(qh),
            ops=4 * H * live * D, kind="bf16"))
    # the split form's merge, on the partials of the INT8-cache MHA case
    # (the plain split version on the card) at the split count it takes
    H, D = cfg.n_heads, cfg.head_dim
    splits = att.launch_splits(1, H, MAX_SEQ)
    part = att.flash_decode_q8_split_plain(*q8_mha, splits).contiguous()
    cases.append(dict(
        name="flash_decode_merge", shape=f"mha 32/32 {splits} splits",
        path="decode", replaces=TPU + "attention.py:345",
        source=SRC + "flash_decode.cu",
        kernel=lambda: att.flash_decode_merge(part),
        plain=lambda: att.flash_decode_merge_plain(part), library=None,
        bytes=nbytes(part) + 2 * H * D, ops=3 * H * splits * D,
        kind="f32"))
    qa, ka, va = (randn(1, H, PROMPT, D) for _ in range(3))
    cases.append(dict(
        name="flash_attention", shape=f"causal 1x{H}x{PROMPT}x{D}",
        path=f"prompt {PROMPT}", replaces=TPU + "flash_attention.py:37",
        source=SRC + "flash_attention.cu",
        kernel=lambda: fa.flash_attention(qa, ka, va, causal=True),
        plain=lambda: fa.mha_plain(qa, ka, va, causal=True),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qa, ka, va, is_causal=True),
        bytes=4 * nbytes(qa),
        # the (i, j <= i) pairs this causal input needs, 4 D flops each
        ops=4 * H * (PROMPT * (PROMPT + 1) // 2) * D, kind="bf16"))

    cases += paged_cases(torch, pa, cfg, gen, dev, randn)
    cases += gpt2_cases(torch, qm, att, gcfg, gparams, gen, dev, randn,
                        dequantize_weight)
    cases += paired_cases(torch, qm, cfg, pparams, randn, dequantize_weight)
    cases += paired_rows_cases(torch, qm, cfg, pparams, envs, layer0, gen,
                               dev, randn, dequantize_weight)
    cases += variant_cases(torch, qm, cfg, g64params, params, envs, kbs,
                           randn, dequantize_weight)
    cases += graph_cases(torch, norms, band, fa, cfg, gen, dev, randn)
    cases += mma_cases(torch, qm, cfg, params, gparams, randn,
                       dequantize_weight)
    cases += norm_mma_cases(torch, qm, cfg, layer0, gen, dev, randn,
                            dequantize_weight)
    cases += chunk_mma_cases(torch, qm, g64params, randn, dequantize_weight)
    cases += norm_w4a8_mma_cases(torch, qm, cfg, layer0, envs, gen, dev,
                                 randn, dequantize_weight)
    cases += any_cases(torch, att, fa, pa, cfg, gen, dev, torch.float16)
    cases += prefill_rows(torch, att, fa, pa, cfg, gen, dev)
    cases += any_cases(torch, att, fa, pa, cfg, gen, dev, torch.float32)
    cases += prefill_any_rows(torch, fa, cfg, gen, dev)
    cases += opt_cases(torch, qm, att, gen, dev, randn, quantize_weight,
                       dequantize_weight)

    for c in cases:
        with knobs(c.get("env", {})):
            check_and_time(torch, c, counters, flush, bw_copy)
    report["mma_crossover"] = mma_crossover(torch, qm, layer0, randn, flush)
    report["w4a8_crossover"] = w4a8_crossover(torch, qm, params["lm_head"],
                                              randn, flush)
    report["ln_crossover"] = ln_crossover(torch, qm, gparams["layers"][0],
                                          gcfg, gen, randn, flush)
    report["norm_crossover"] = norm_crossover(torch, qm, layer0, cfg, gen,
                                              randn, flush)
    report["chunk_crossover"] = chunk_crossover(torch, qm, g64params, randn,
                                                flush)
    report["slab_crossover"] = slab_crossover(torch, qm, pparams, cfg, gen,
                                              randn, flush)
    report["decode_crossover"] = decode_crossover(torch, att, gen, dev, flush)
    report["paged_crossover"] = paged_crossover(torch, pa, gen, dev, flush)
    report["any_grid"] = any_grid(torch, att, fa, pa, gen, dev)
    report["split_crossover"] = split_crossover(
        torch, qm, layer0, g64params["layers"][0], randn, flush)
    del flush, qa, ka, va, part, q8_mha
    t_phase = phase(3, t_phase)

    # 4. the 7B decode path
    per_token = decode_path(torch, llama, counters, params, cfg, dev, report)
    step4 = dict(per_token)         # phases 5 and 6 add their kernels
    paths = {"decode": report["launches_main_path"]}
    for kname in ("qmm_group_norm", "qmm_group_norm_ring", "qmm_group",
                  "qmm_group_split", "qmm_w4a8", "qmm_w4a8_ring",
                  "flash_decode_q8", "flash_decode_merge"):
        if paths["decode"].get(kname, 0) <= 0:
            fail(f"{kname} was never launched on the main path")
    for kname in ("qmm_group_mma", "qmm_w4a8_mma", "qmm_group_ln_mma"):
        if paths["decode"].get(kname, 0) or step4.get(kname, 0):
            fail(f"the 1-row decode launched {kname}, a tensor-core form")
    # wqkv and w_gateup: the ring form, and no CUDA-core qmm_group_norm
    L = cfg.n_layers
    if step4.get("qmm_group_norm_ring", 0) != 2 * L or \
            step4.get("qmm_group_norm", 0) != 2 * L:
        fail(f"a decode step launched qmm_group_norm "
             f"{step4.get('qmm_group_norm', 0)} times, "
             f"{step4.get('qmm_group_norm_ring', 0)} of them the ring form; "
             f"expected {2 * L} and {2 * L}")
    # the lm_head: once a token, in the ring form
    if step4.get("qmm_w4a8", 0) != 1 or step4.get("qmm_w4a8_ring", 0) != 1:
        fail(f"a decode step launched qmm_w4a8 {step4.get('qmm_w4a8', 0)} "
             f"times, {step4.get('qmm_w4a8_ring', 0)} of them the ring "
             "form; expected 1 and 1")
    t_phase = phase(4, t_phase)

    # 5. the 7B prompt -> generate path
    paths.update(generate_path(torch, llama, counters, params, cfg, dev,
                               report, per_token, dequantize_weight,
                               dequant_matmul))
    for path, knames in ((f"prompt {PROMPT}", ("flash_attention",
                                               "flash_decode")),
                         (f"prompt {PROMPT} int8", ("flash_attention",
                                                    "flash_decode_q8")),
                         (f"prompt {SHORT}", ("qmm_group", "qmm_w4a8",
                                              "flash_attention",
                                              "flash_decode"))):
        for kname in knames:
            if paths[path].get(kname, 0) <= 0:
                fail(f"{kname} was never launched on the path {path}")
    t_phase = phase(5, t_phase)

    # 6. the 7B serving path, paged against dense
    paths.update(serving_path(torch, llama, counters, params, cfg, dev,
                              report, per_token))
    for path, kname in (("serving paged bf16", "paged_flash_decode"),
                        ("serving paged int8", "paged_flash_decode_q8")):
        for k in (kname, kname + "_ring", "flash_attention", "qmm_group",
                  "qmm_w4a8"):
            if paths[path].get(k, 0) <= 0:
                fail(f"{k} was never launched on the path {path}")
    for path in (DENSE_BF16, DENSE_INT8):
        for k in ("qmm_group_norm_mma", "qmm_group_mma", "flash_attention"):
            if paths[path].get(k, 0) <= 0:
                fail(f"{k} was never launched on the path {path}")
    t_phase = phase(6, t_phase)

    # 7. GPT-2 345M INT8 continuous batching
    steps = {}
    paths.update(gpt2_path(torch, gpt2, serving_bench, counters, gparams,
                           gcfg, dev, report, steps))
    for path, kname in ((GPT2_BF16, "flash_decode"),
                        (GPT2_INT8, "flash_decode_q8")):
        for k in (kname, "qmm_group_ln", "qmm_group"):
            if paths[path].get(k, 0) <= 0:
                fail(f"{k} was never launched on the path {path}")
    paths[GPT2_BS1] = steps[GPT2_BS1] = gpt2_bs1_path(
        torch, gpt2, qm, counters, gparams, gcfg, dev, report)
    del gparams
    t_phase = phase(7, t_phase)

    # 8. the 7B decode path with paired scales: wqkv and w_gateup in
    # qmm_slab_norm's ring form, read in turns with its CUDA-core form
    L = cfg.n_layers
    paths[PAIRED] = variant_path(
        torch, llama, counters, pparams, cfg, dev, report, steps, PAIRED,
        {"qmm_slab_norm": 2 * L, "qmm_slab_norm_ring": 2 * L,
         "qmm_slab": 2 * L + 1,
         "qmm_slab_split": L * split_launches(
             qm, (pparams["layers"][0]["wo"], pparams["layers"][0]["w_down"]))
         + split_launches(qm, (pparams["lm_head"],)),
         "flash_decode_q8": L, **merges(cfg, L)},
        weight_bytes(cfg, paired=True),
        ring_form=("slab_form", ("qmm_slab_norm_ring",)))
    # the paired prefill (unfused norm: qmm_slab at SHORT rows) and the
    # dense 8-slot step (qmm_slab_norm and qmm_slab at SLOTS rows) in the
    # paired tensor-core forms, each read in turns with the CUDA-core body
    # forced (qm.slab_form patched)
    t0 = time.perf_counter()
    mma = {r: qm.slab_form(r, torch.bfloat16, False) == "mma"
           for r in (SHORT, SLOTS)}
    paths[PAIRED_PROMPT] = forms_prompt_path(
        torch, llama, qm, counters, pparams, cfg, dev, report, PAIRED_PROMPT,
        "slab_form", lambda rows, dtype, norm: "cuda_core",
        {"qmm_slab": 4 * L + 1,
         "qmm_slab_mma": (4 * L + 1) * mma[SHORT]}, SEED + 80)
    paths[DENSE_PAIRED], forms = forms_dense_path(
        torch, llama, qm, counters, pparams, cfg, dev, report, DENSE_PAIRED,
        "slab_form", lambda rows, dtype, norm: "cuda_core",
        {"qmm_slab_norm": 2 * L, "qmm_slab_norm_mma": 2 * L * mma[SLOTS],
         "qmm_slab": 2 * L + 1, "qmm_slab_mma": (2 * L + 1) * mma[SLOTS]},
        "qmm_slab_norm_mma")
    report["serving"][DENSE_PAIRED] = {
        "launches_per_step": paths[DENSE_PAIRED], **forms}
    print(f"# {PAIRED_PROMPT} and {DENSE_PAIRED} (both forms, in turns) "
          f"took {time.perf_counter() - t0:.1f}s", flush=True)
    # the prefill's norm is unfused (as in the JAX package), so only the
    # step launches qmm_slab_norm_mma
    for path, knames in ((PAIRED_PROMPT, ("qmm_slab_mma",)),
                         (DENSE_PAIRED, ("qmm_slab_mma",
                                         "qmm_slab_norm_mma"))):
        for kname in knames:
            if paths[path].get(kname, 0) <= 0:
                fail(f"{kname} was never launched on the path {path}")
    del pparams
    t_phase = phase(8, t_phase)

    # 9. the 7B decode at group 64 (entry()'s quantization), then entry()
    lay64 = g64params["layers"][0]
    paths[G64] = variant_path(
        torch, llama, counters, g64params, cfg, dev, report, steps, G64,
        {"qmm_chunk": 4 * L + 1,
         "qmm_chunk_split": L * split_launches(
             qm, [lay64[k] for k in ("wqkv", "wo", "w_gateup", "w_down")])
         + split_launches(qm, (g64params["lm_head"],)),
         "flash_decode_q8": L, **merges(cfg, L)},
        weight_bytes(cfg, group=64))
    # the prefill and the dense 8-slot step (qmm_chunk at SHORT and SLOTS
    # rows), each read in turns with qmm_chunk's CUDA-core form forced
    group = g64params["lm_head"].group_size
    n = 4 * L + 1
    t0 = time.perf_counter()
    paths[G64_PROMPT] = forms_prompt_path(
        torch, llama, qm, counters, g64params, cfg, dev, report, G64_PROMPT,
        "chunk_form", lambda rows, dtype, group: "cuda_core",
        {"qmm_chunk": n, "qmm_chunk_mma": n if qm.chunk_form(
            SHORT, torch.bfloat16, group) == "mma" else 0}, SEED + 64)
    paths[DENSE_G64], forms = forms_dense_path(
        torch, llama, qm, counters, g64params, cfg, dev, report, DENSE_G64,
        "chunk_form", lambda rows, dtype, group: "cuda_core",
        {"qmm_chunk": n, "qmm_chunk_mma": n if qm.chunk_form(
            SLOTS, torch.bfloat16, group) == "mma" else 0}, "qmm_chunk_mma")
    report["serving"][DENSE_G64] = {
        "launches_per_step": paths[DENSE_G64], **forms}
    print(f"# {G64_PROMPT} and {DENSE_G64} (both forms, in turns) took "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for path in (G64_PROMPT, DENSE_G64):
        if paths[path].get("qmm_chunk_mma", 0) <= 0:
            fail(f"qmm_chunk_mma was never launched on the path {path}")
    del g64params
    entry_check(torch, counters, report)
    paths[ENTRY_PROMPT] = entry_prompt_check(torch, llama, counters, report)
    t_phase = phase(9, t_phase)

    # 10. W4A8 under the env var and an empty table; with the default
    # table the env var changes nothing
    with knobs(envs[W4A8]):
        paths[W4A8] = variant_path(
            torch, llama, counters, params, cfg, dev, report, steps, W4A8,
            {"qmm_norm_w4a8": 2 * L, "qmm_w4a8": 2 * L + 1,
             "qmm_norm_w4a8_ring": 2 * L, "qmm_w4a8_ring": 2 * L + 1,
             "flash_decode_q8": L, **merges(cfg, L)},
            weight_bytes(cfg), ring_form=("w4a8_form", (
                "qmm_w4a8_ring", "qmm_norm_w4a8_ring")))
    with knobs({"INFINITPU_QMM_VARIANT": "w4a8"}):
        counters.reset()
        llama.llama_decode_step(
            params, cfg, torch.zeros(1, dtype=torch.int32, device=dev),
            torch.full((1,), CTX, dtype=torch.int32, device=dev),
            llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev))
        torch.cuda.synchronize()
        default_table = counters.read()
    print(f"# w4a8 env var with the default table: {default_table}",
          flush=True)
    report["w4a8_env_default_table_launches"] = default_table
    if default_table != step4:
        fail(f"the env var overrode the default table: {default_table}")
    t_phase = phase(10, t_phase)

    # 11. split-K wo and w_down from a tuning-table entry: qmm_group2d in its
    # ring form (one launch, no splitk_sum), read in turns with the
    # two-launch split
    with knobs(envs[SPLIT]):
        paths[SPLIT] = variant_path(
            torch, llama, counters, params, cfg, dev, report, steps, SPLIT,
            {"qmm_group2d": 2 * L, "qmm_group2d_ring": 2 * L,
             "qmm_group_norm": 2 * L,
             "qmm_group_norm_ring": 2 * L, "qmm_w4a8": 1,
             "qmm_w4a8_ring": 1, "flash_decode_q8": L, **merges(cfg, L)},
            weight_bytes(cfg),
            ring_form=("group2d_form", ("qmm_group2d_ring",)))
    prof = report[SPLIT.replace(" ", "_")]["device_profile"]
    if prof and prof["kernel_ms_per_token"].get("qmm_group2d sum"):
        fail(f"{SPLIT}: the decode graph ran splitk_sum kernels")
    t_phase = phase(11, t_phase)

    # 12. the 7B decode built through the graph IR, and its serving adapter
    paths.update(graph_path(torch, llama, graph_llama, GraphExecutor,
                            counters, params, cfg, dev, report, steps))
    t_phase = phase(12, t_phase)

    # 13. Longformer band attention through the graph IR
    paths.update(longformer_path(torch, GraphHandler, DataType,
                                 GraphExecutor, band, counters, dev, report,
                                 steps))
    band_gate_check(torch, GraphHandler, GraphExecutor, band, counters, dev,
                    report)
    t_phase = phase(13, t_phase)

    # 14. the 7B model in f16: the fast 16-bit attention on its paths
    prompts_of = {ENTRY_PROMPT: paths[ENTRY_PROMPT],
                  G64_PROMPT: paths[G64_PROMPT],
                  PAIRED_PROMPT: paths[PAIRED_PROMPT], NO_PATH: {}}
    paths.update(f16_path(torch, llama, counters, (att, fa, pa), params,
                          cfg, dev, report, steps, prompts_of))
    paths[NO_PATH] = steps[NO_PATH] = {}
    del params
    t_phase = phase(14, t_phase)

    # 15. OPT-1.3B prompt and decode, bf16 and INT8 weights
    import numpy as np
    from infinitensor_tpu_torch import onnx as tonnx
    from infinitensor_tpu_torch.models import bert, opt, vision
    from infinitensor_tpu_torch.native import onnx_wire
    from infinitensor_tpu_torch.ops import lowering
    from infinitensor_tpu_torch.runtime.runtime import cuda_runtime
    from infinitensor_tpu_torch.serving import kvcache
    paths.update(opt_path(torch, opt, kvcache, qm, att, counters, dev,
                          report, steps, bw_copy))
    prompts_of[OPT_PROMPT] = paths[OPT_PROMPT]
    for path, knames in ((OPT_DECODE, ("qmm_group", "qmm_group_split",
                                       "flash_decode", "flash_decode_merge")),
                         (OPT_PROMPT, ("qmm_group_mma",)),
                         (OPT_BATCH, ("qmm_group_mma", "flash_decode"))):
        for kname in knames:
            if paths[path].get(kname, 0) <= 0:
                fail(f"{kname} was never launched on the path {path}")
    t_phase = phase(15, t_phase)

    # 16. BERT-base, FP32 and dynamic INT8, and its ONNX round trip
    parser = "native scan" if onnx_wire.native_available() else \
        f"pure-Python parse ({onnx_wire._LIB_ERR})"
    print(f"# ONNX initializers: {parser}", flush=True)
    report["onnx_parser"] = parser
    bert_path(torch, np, bert, tonnx, GraphExecutor, cuda_runtime, dev,
              report)
    t_phase = phase(16, t_phase)

    # 17. the vision parity set through ONNX
    vision_path(torch, np, vision, tonnx, lowering, GraphExecutor,
                cuda_runtime, dev, report)
    t_phase = phase(17, t_phase)

    # 18. the corpus's kernel cases through ONNX
    paths[ONNX_KERNELS] = onnx_kernel_path(
        torch, np, GraphHandler, tonnx, GraphExecutor, cuda_runtime,
        counters, dev, report)
    t_phase = phase(18, t_phase)

    # 19. the optimizer's search for the band form, the qkv merge, the
    # tuner's sweeps, the memory planner's report
    paths.update(search_path(torch, np, GraphHandler, tonnx, GraphExecutor,
                             cuda_runtime, counters, dev, report, steps))
    qkv_path(torch, np, GraphHandler, GraphExecutor, cuda_runtime, dev,
             report)
    tpaths, trows = tuner_path(torch, att, qm, QuantizedLinear,
                               dequantize_weight, counters, dev, report,
                               steps, bw_copy)
    paths.update(tpaths)
    cases += trows
    memory_path(torch, llama, graph_llama, GraphExecutor, QuantizedLinear,
                dev, report)
    t_phase = phase(19, t_phase)

    # 20. NNET: the three conv families derived, run and searched
    nnet_path(torch, np, GraphHandler, GraphExecutor, cuda_runtime, dev,
              report)
    t_phase = phase(20, t_phase)

    per_prompt = report["generate"][f"prompt {SHORT}"]["launches_per_prompt"]
    kernels = []
    # a row measured in phase 3 stands once for each path that runs its
    # kernel at its shape (phase 19's paths repeat earlier shapes)
    for c, path in ((c, p) for c in cases
                    for p in [c["path"]] + c.get("also_paths", [])):
        prefill = c["name"].startswith("flash_attention") or path in \
            (f"prompt {SHORT}", G64_PROMPT, PAIRED_PROMPT, OPT_PROMPT)
        step = report["serving"][path]["launches_per_step"] \
            if path.startswith("serving") else steps.get(path, per_token)
        per_prompt_c = prompts_of.get(path, per_prompt)
        kernels.append({
            "name": c["name"], "shape": c["shape"], "route": "cuda",
            "source": c["source"], "replaces": c["replaces"],
            "path": path, "launches": paths[path].get(c["name"], 0),
            "launches_per_token": None if prefill
            else step.get(c["name"], 0),
            "launches_per_prompt": per_prompt_c.get(c["name"], 0)
            if prefill else None,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "copy_bound_ms": c["copy_bound_ms"],
            "bytes": c["bytes"], "ops": c["ops"],
            "library_ms": c["library_ms"],
            **({"cuda_core_ms": c["cuda_core_ms"]}
               if "cuda_core" in c else {}),
            **({"cuda_core_err": c["cuda_core_err"]}
               if "cuda_core_err" in c else {}),
            **({"library_ln_ms": c["library_ln_ms"]}
               if "library_ln" in c else {}),
            **({"yardstick_ms": c["yardstick_ms"]}
               if c["yardstick_ms"] else {}),
            **({"forms": {f: {"ms": ms, "max_abs_err": c["form_err"][f]}
                          for f, ms in c["form_ms"].items()}}
               if c["form_ms"] else {}),
            **({"graph_ms": c["graph_ms"]} if c["graph_ms"] else {})})
    report["kernels"] = kernels
    report["launches_by_path"] = paths
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke_report.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def check_and_time(torch, c, counters, flush, bw_copy):
    """Phase 3 for one case: the wrapper launches its kernel once, the
    result is within TOL of max|plain|; then the kernel, plain and library
    times and the bound."""
    before = counters.read().get(c["name"], 0)
    got, want = c["kernel"](), c["plain"]()
    torch.cuda.synchronize()
    if counters.read().get(c["name"], 0) != before + 1:
        fail(f"{c['name']} {c['shape']}: the wrapper did not launch it")
    if got.shape != want.shape:
        fail(f"{c['name']} {c['shape']}: shape {tuple(got.shape)} vs "
             f"{tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    c["max_abs_err"], c["max_abs_ref"] = err, ref
    # "ulp": one ulp at max|plain| of bf16 (True or 8 significant bits) or
    # f16 (11), else tol of max|plain|
    tol = ulp_at(ref, 8 if c.get("ulp") is True else c["ulp"]) / ref \
        if c.get("ulp") else c.get("tol", TOL)
    if not (math.isfinite(err) and err <= tol * ref):
        fail(f"{c['name']} {c['shape']}: max err {err} > {tol} * {ref}")
    c["ms"] = cuda_ms(torch, c["kernel"], 50, flush)
    c["plain_ms"] = cuda_ms(torch, c["plain"], 5, flush)
    c["library_ms"] = cuda_ms(torch, c["library"], 50, flush) \
        if c["library"] else None
    if "cuda_core" in c:            # the route's form: the other form, now
        c["cuda_core_ms"] = cuda_ms(torch, c["cuda_core"], 50, flush)
        if c.get("ulp"):            # ... within one bf16 ulp of this one
            e = (c["cuda_core"]().float() - got.float()).abs().max().item()
            c["cuda_core_err"] = e
            if not (math.isfinite(e) and e <= bf16_ulp(ref)):
                fail(f"{c['name']} {c['shape']}: {e} from the CUDA-core "
                     f"form, more than one bf16 ulp at {ref}")
    # other kernels on the same shape, timed only (yardsticks)
    c["yardstick_ms"] = {f: cuda_ms(torch, fn, 50, flush)
                         for f, fn in c.get("yardsticks", {}).items()}
    if "library_ln" in c:           # LayerNorm + addmm from the raw rows
        c["library_ln_ms"] = cuda_ms(torch, c["library_ln"], 50, flush)
    c["form_ms"], c["form_err"] = {}, {}
    for form, fn in c.get("forms", {}).items():   # the other forms, forced
        e = (fn().float() - want.float()).abs().max().item()
        if not (math.isfinite(e) and e <= tol * ref):
            fail(f"{c['name']} {c['shape']} form {form}: max err {e} > "
                 f"{tol} * {ref}")
        c["form_err"][form] = e
        c["form_ms"][form] = cuda_ms(torch, fn, 50, flush)
    # back to back: one launch per weight copy, captured in one graph
    c["graph_ms"] = {form: graph_launch_ms(torch, fn, c["graph_weights"])
                     for form, fn in c.get("graph", {}).items()}
    c["bound_ms"] = 1e3 * max(c["bytes"] / HBM_BYTES_S,
                              c["ops"] / PEAK_OPS[c["kind"]])
    c["bound_by"] = ("bytes" if c["bytes"] / HBM_BYTES_S
                     >= c["ops"] / PEAK_OPS[c["kind"]] else "operations")
    c["copy_bound_ms"] = 1e3 * c["bytes"] / bw_copy
    print(f"# {c['name']:16s} {c['shape']:22s} err {err:.3g} "
          f"(max|ref| {ref:.3g})  kernel {c['ms']:.4f} ms  bound "
          f"{c['bound_ms']:.4f} ms {c['bound_by']} (copy-rate "
          f"{c['copy_bound_ms']:.4f})  plain {c['plain_ms']:.4f} ms  "
          f"library {c['library_ms'] or float('nan'):.4f} ms  "
          + (f"cuda-core form {c['cuda_core_ms']:.4f} ms  "
             if "cuda_core" in c else "")
          + (f"layer_norm + addmm {c['library_ln_ms']:.4f} ms  "
             if "library_ln" in c else "")
          + "".join(f"{f} {ms:.4f} ms (x{c['ms'] / ms:.2f})  "
                    for f, ms in c["yardstick_ms"].items())
          + "".join(f"{f} form {ms:.4f} ms (err {c['form_err'][f]:.3g})  "
                    for f, ms in c["form_ms"].items())
          + "".join(f"{f} back to back {ms:.4f} ms  "
                    for f, ms in c["graph_ms"].items())
          + f"{c['bytes'] / 1e6:.2f} MB", flush=True)


def paged_cases(torch, pa, cfg, gen, dev, randn):
    """Phase 3 rows of the two paged kernels at the serving shape: SLOTS
    slots, ragged positions around CTX, a shuffled block table over a pool
    with spare pages, NaN wherever no live row lies (pages for bf16, scale
    pages for int8). The route's ring form (paged_flash_decode_ring.cu)
    beside the block form (paged_flash_decode.cu, forced), which keeps a
    row of its own, at MHA 32/32 and GQA 32/8."""
    B, D, P = SLOTS, cfg.head_dim, PAGE
    MP = MAX_SEQ // P
    N = B * MP + 1
    pos = torch.tensor(PAGED_POS[:B], dtype=torch.int32, device=dev)
    table = (torch.randperm(N - 1, generator=gen, device=dev)[:B * MP] + 1
             ).reshape(B, MP).to(torch.int32)
    live_rows = int((pos + 1).sum())
    live = torch.zeros(N, P, dtype=torch.bool, device=dev)
    rows = torch.arange(MP * P, device=dev)
    for b in range(B):
        s = rows[:int(pos[b]) + 1]
        live[table[b].long()[s // P], s % P] = True
    mask = (rows[None] <= pos[:, None])[:, None, None]     # [B, 1, 1, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []

    def forms(kname, row):
        """The ring row (the route's form, the block form beside it) and
        the block form's own row (forced; no path takes it)."""
        block = dict(row["forms"])["block"]
        return [dict(row, name=kname + "_ring",
                     source=SRC + "paged_flash_decode_ring.cu"),
                dict(row, name=kname, path=NO_PATH, kernel=block, forms={},
                     source=SRC + "paged_flash_decode.cu")]

    for label, H, Hkv in (("mha 32/32", 32, 32), ("gqa 32/8", 32, 8)):
        rep = H // Hkv
        dead = ~live[:, None, :].expand(N, Hkv, P)
        qh = randn(B, H, 1, D)
        shape = f"{label} {B} slots P{P} pos~{CTX}"
        kp, vp = (torch.randint(-127, 128, (N, Hkv, P, D), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(N, Hkv, P, generator=gen, device=dev) * 0.015
                  + 0.005 for _ in range(2))
        kf, vf = ((pa.gather_pages(x, table).float()
                   * pa.gather_scale_pages(sc, table)[..., None]).to(
                       torch.bfloat16).repeat_interleave(rep, 1)
                  for x, sc in ((kp, ks), (vp, vs)))
        ks[dead] = float("nan")
        vs[dead] = float("nan")
        args = (qh, kp, vp, ks, vs, table, pos)
        small = 2 * qh.numel() * 2 + table.numel() * 4 + pos.numel() * 4
        out += forms("paged_flash_decode_q8", dict(
            shape=shape, path="serving paged int8",
            replaces=TPU + "paged_attention.py:187",
            kernel=lambda a=args: pa.paged_flash_decode_q8(*a),
            plain=lambda a=args: pa.paged_decode_q8_plain(*a),
            forms={"block": lambda a=args: pa.paged_flash_decode_q8(
                *a, _form="block")},
            library=lambda qh=qh, kf=kf, vf=vf: sdpa(qh, kf, vf,
                                                     attn_mask=mask),
            bytes=2 * Hkv * live_rows * (D + 4) + small,
            ops=4 * H * live_rows * D, kind="bf16"))
        kb, vb = randn(N, Hkv, P, D), randn(N, Hkv, P, D)
        kr, vr = (pa.gather_pages(x, table).repeat_interleave(rep, 1)
                  for x in (kb, vb))
        kb[dead] = float("nan")
        vb[dead] = float("nan")
        args = (qh, kb, vb, table, pos)
        out += forms("paged_flash_decode", dict(
            shape=shape, path="serving paged bf16",
            replaces=TPU + "paged_attention.py:146",
            kernel=lambda a=args: pa.paged_flash_decode(*a),
            plain=lambda a=args: pa.paged_decode_plain(*a),
            forms={"block": lambda a=args: pa.paged_flash_decode(
                *a, _form="block")},
            library=lambda qh=qh, kr=kr, vr=vr: sdpa(qh, kr, vr,
                                                     attn_mask=mask),
            bytes=2 * Hkv * live_rows * D * 2 + small,
            ops=4 * H * live_rows * D, kind="bf16"))
    return out


def paged_crossover(torch, pa, gen, dev, flush):
    """Both forms of the two paged kernels, forced, at SLOTS slots of
    phase 3's ragged positions (PAGED_POS, MAX_SEQ rows a table) with
    pages of 16 and PAGE rows, and of phase 6's 8-live step (every slot at
    pos 640, pages of PAGE rows), MHA 32/32 and GQA 32/8: the block form, and
    the ring form at chunks of 64 to 1024 rows, the whole table (one
    chunk) and ring_chunks's size (the route's), in one call, the route's
    form and the block form also in turns (block, ring, ring, block): the
    times behind pa.ring_chunks and pa.paged_form. Returns [{kind,
    H, Hkv, P, pos, chosen, in_turns: {form: [ms, ms]}, block_ms,
    ring_ms: {pages a chunk: ms}}]."""
    out = []
    B, D = SLOTS, 128
    for P, spots in ((16, PAGED_POS), (PAGE, PAGED_POS), (PAGE, (640,) * B)):
        pos = torch.tensor(spots[:B], dtype=torch.int32, device=dev)
        MP = MAX_SEQ // P
        N = B * MP + 1
        table = (torch.randperm(N - 1, generator=gen, device=dev)[:B * MP]
                 + 1).reshape(B, MP).to(torch.int32)
        for H, Hkv in ((32, 32), (32, 8)):
            q = torch.randn(B, H, 1, D, generator=gen, device=dev).to(
                torch.bfloat16)
            kq, vq = (torch.randint(-127, 128, (N, Hkv, P, D), generator=gen,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2))
            sc = [torch.rand(N, Hkv, P, generator=gen, device=dev) * 0.015
                  + 0.005 for _ in range(2)]
            kb, vb = (torch.randn(N, Hkv, P, D, generator=gen,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(2))
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            chosen = pa.ring_chunks(B, Hkv, MP, sms)[0]
            sizes = sorted({max(1, r // P) for r in (64, 128, 256, 512, 1024)}
                           | {MP, chosen})
            for kind, fn, a in (
                    ("int8", pa.paged_flash_decode_q8,
                     (q, kq, vq, *sc, table, pos)),
                    ("bf16", pa.paged_flash_decode, (q, kb, vb, table, pos))):
                forms = {"block": lambda: fn(*a, _form="block"),
                         "ring": lambda: fn(*a)}
                turns = {"block": [], "ring": []}
                for f in ("block", "ring", "ring", "block"):
                    turns[f].append(cuda_ms(torch, forms[f], 50, flush))
                row = {"kind": kind, "H": H, "Hkv": Hkv, "P": P,
                       "pos": f"{min(spots)}-{max(spots)}",
                       "chosen": chosen, "in_turns": turns,
                       "block_ms": min(turns["block"]),
                       "ring_ms": {C: cuda_ms(torch, lambda C=C: fn(
                           *a, _form="ring", _chunk_pages=C), 50, flush)
                           for C in sizes if -(-MP // C) <= pa.MAX_CHUNKS}}
                out.append(row)
            del q, kq, vq, sc, kb, vb
    print("# paged decode, 8 slots: block form ms and ring form ms by pages "
          f"a chunk: {json.dumps(out)}", flush=True)
    return out


def build_params(torch, cfg, gen, dev, QuantizedLinear, paired=False,
                 group=128):
    """Random INT4 weights on the card, as bench.py:24-97 builds them:
    codes uniform in [-127, 126], bf16 scales uniform in [0.001, 0.02],
    group 128 (or `group`), w_gateup padded to a multiple of 2048 columns
    (22528), a 0.02-scaled bf16 embedding, unit norms. paired: one scale
    row per pair of split-half groups (din / 256 rows), the layout of
    quantize_weight(paired=True)."""
    def qlin(din, dout, pad_to=0):
        logical = 0
        if pad_to and dout % pad_to:
            logical, dout = dout, dout + pad_to - dout % pad_to
        qw = torch.randint(-127, 127, (din // 2, dout), generator=gen,
                           device=dev, dtype=torch.int8)
        rows = din // (2 * group) if paired else din // group
        sc = (torch.rand(rows, dout, generator=gen, device=dev)
              * 0.019 + 0.001).to(torch.bfloat16)
        return QuantizedLinear(qw, sc, 4, group, logical)

    kvd = cfg.n_kv_heads * cfg.head_dim
    ones = torch.ones(cfg.dim, dtype=torch.bfloat16, device=dev)
    layers = [{
        "attn_norm": ones, "wqkv": qlin(cfg.dim, cfg.dim + 2 * kvd),
        "wo": qlin(cfg.dim, cfg.dim), "mlp_norm": ones,
        "w_gateup": qlin(cfg.dim, 2 * cfg.intermediate, pad_to=2048),
        "w_down": qlin(cfg.intermediate, cfg.dim),
    } for _ in range(cfg.n_layers)]
    embed = (torch.randn(cfg.vocab_size, cfg.dim, generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
    return {"embed": embed, "final_norm": ones,
            "lm_head": qlin(cfg.dim, cfg.vocab_size), "layers": layers}


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.to("cpu")


def fresh(cache):
    for bufs in cache.values():
        for t in bufs:
            t.zero_()


def compare_logits(torch, what, got, want, report):
    """Fail unless got [vocab] agrees with want: relative error <= 5e-2 and
    the same top-1, or a near-tie: want's logits of the two candidates lie
    within the measured error of each other."""
    lk, lp = got.float().cpu().reshape(-1), want.float().cpu().reshape(-1)
    if not torch.isfinite(lk).all():
        fail(f"{what}: non-finite logits")
    err = (lk - lp).abs().max().item()
    rel = err / lp.abs().max().item()
    top_k, top_p = int(lk.argmax()), int(lp.argmax())
    tie = float(lp[top_p] - lp[top_k]) <= 2 * err
    print(f"# {what}: rel logit err {rel:.3g}, top-1 {top_k} vs {top_p}",
          flush=True)
    report[what] = {"rel_logit_err": rel, "top1": [top_k, top_p]}
    if rel > 5e-2 or (top_k != top_p and not tie):
        fail(f"{what}: rel {rel}, top-1 {top_k} vs {top_p}")
    return rel, top_k, top_p


def decode_path(torch, llama, counters, params, cfg, dev, report):
    """Phase 4; returns each kernel's launches in one eager decode step."""
    token = torch.zeros(1, dtype=torch.int32, device=dev)
    pos = torch.full((1,), CTX, dtype=torch.int32, device=dev)
    cache = llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev)

    # one step, kernels on the card against plain versions on the CPU
    counters.reset()
    logits, _ = llama.llama_decode_step(params, cfg, token, pos, cache)
    torch.cuda.synchronize()
    per_token = counters.read()
    t0 = time.perf_counter()
    ref, _ = llama.llama_decode_step(
        to_cpu(params), cfg, token.cpu(), pos.cpu(),
        llama.init_kv_cache(cfg, 1, kv_quant=True, device="cpu"))
    plain_s = time.perf_counter() - t0
    print(f"# 7B step on the plain versions (CPU): {plain_s:.1f}s")
    rel, top_k, top_p = compare_logits(
        torch, "7B step, kernels vs plain", logits[0], ref[0], report)
    report["step_rel_logit_err"], report["step_top1"] = rel, [top_k, top_p]

    # the main path: llama_decode_multi under a CUDA graph
    fresh(cache)
    counters.reset()
    t0 = time.perf_counter()
    toks, last, next_pos, cache = llama.llama_decode_multi(
        params, cfg, token, pos, cache, STEPS)
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    report["launches_main_path"] = counters.read()
    if toks.shape != (1, STEPS) or int(next_pos) != CTX + STEPS:
        fail(f"decode_multi returned {tuple(toks.shape)}, pos {next_pos}")

    # eager loop from the same state
    fresh(cache)
    tok, p, eager = token.clone(), pos.clone(), []
    for _ in range(STEPS):
        lg, cache = llama.llama_decode_step(params, cfg, tok, p, cache)
        tok = torch.argmax(lg, -1).to(torch.int32)
        eager.append(tok)
        p = p + 1
    eager = torch.stack(eager, 1)
    same = (toks == eager)[0].int().cumprod(0).sum().item()
    print(f"# graph vs eager greedy tokens: first {same} of {STEPS} equal; "
          f"first tokens {toks[0, :8].tolist()}", flush=True)
    report["graph_eager_equal_prefix"] = same
    report["decode_tokens"] = toks[0].tolist()
    if same < 32:
        fail(f"graph and eager tokens differ at step {same}")

    # timing: one captured graph, 3 runs of 128 tokens from fresh state
    fresh(cache)
    g = llama.DecodeGraph(params, cfg, token, pos, cache, STEPS)
    samples = []
    for _ in range(3):
        fresh(cache)
        g.reset(token, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = g.run()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        if not torch.equal(out, toks):
            fail("a timed graph run gave other tokens")
    dt = min(samples)
    prof = graph_profile(torch, g, cache, token, pos)
    # (the decode attention's unsplit form is timed beside the split one
    # kernel by kernel in phase 3, not as a region here: the run's limit)
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    unsplit_mm = unsplit_region(torch, llama, qm, params, cfg, token, pos,
                                cache)
    # the main region again, after the forced forms: the same call read in
    # turns (split, unsplit matmuls, split)
    unsplit_mm["split_again_tok_s_samples"] = time_graph(torch, g, cache,
                                                         token, pos)
    core_norm = cuda_core_region(torch, llama, qm, params, cfg, token, pos,
                                 cache, g, toks, "group_form",
                                 ("qmm_group_norm_ring",), "decode")
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * CTX * (cfg.head_dim + 4)
    bytes_tok = weight_bytes(cfg) + kv_bytes
    tok_s = STEPS / dt
    res = {"unsplit_matmuls": unsplit_mm, "cuda_core_norm": core_norm,
        "tok_s": tok_s, "ms_per_token": 1e3 * dt / STEPS,
        "tok_s_samples": [STEPS / s for s in samples],
        "decode_multi_call_s": multi_s, "bytes_per_token": bytes_tok,
        "roofline_tok_s_copy": report["copy_gbps"] * 1e9 / bytes_tok,
        "roofline_tok_s_published": HBM_BYTES_S / bytes_tok,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_main_path": report["launches_main_path"],
        "launches_per_token": per_token, "device_profile": prof}
    report.update(res)
    print("# decode " + json.dumps(res), flush=True)
    return per_token


def cuda_core_region(torch, llama, qm, params, cfg, token, pos, cache, g,
                     toks, form_fn, rings, label):
    """A decode region (phases 4, 8, 10 and 11) with the old forms forced
    where the route takes a ring form (qm.<form_fn>: group_form,
    slab_form, w4a8_form or group2d_form, patched while the step is
    captured: the forms before the ring, CUDA-core or two-launch), read in
    turns with the route's graph g (one run each, 6 pairs; the median of
    the pairs' tok/s ratios); its STEPS tokens held against g's (toks) up
    to a printed near-tie. rings: the ring kernels' counters, which the
    capture must leave alone."""
    route = getattr(qm, form_fn)

    def forced(*args, **kw):
        form = route(*args, **kw)
        return "cuda_core" if form == "ring" else form

    setattr(qm, form_fn, forced)
    before = [qm.launches[k] for k in rings]
    try:
        fresh(cache)
        g1 = llama.DecodeGraph(params, cfg, token, pos, cache, STEPS)
    finally:
        setattr(qm, form_fn, route)
    if [qm.launches[k] for k in rings] != before:
        fail(f"{label}: the CUDA-core capture launched a ring form")
    # one run of each in turns, 6 pairs: the card's speed moves between
    # runs of one graph (PERF.md section 7), so each pair's ratio is read
    samples = {"ring": [], "cuda_core": []}
    for _ in range(6):
        samples["ring"] += time_graph(torch, g, cache, token, pos, runs=1)
        samples["cuda_core"] += time_graph(torch, g1, cache, token, pos,
                                           runs=1)
    ratios = sorted(a / b for a, b in zip(samples["ring"],
                                          samples["cuda_core"]))
    fresh(cache)
    g1.reset(token, pos)
    old = g1.run()[0].tolist()
    ties = same_up_to_ties(
        f"{label}: ring vs CUDA-core forms", [old],
        [toks[0].tolist()], [[]],
        decode_tie_gap(torch, llama, params, cfg, token, pos, cache))
    del g1
    out = {"tok_s": {f: max(v) for f, v in samples.items()},
           "tok_s_in_turns": samples,
           "ring_over_cuda_core_median": statistics.median(ratios),
           "near_ties": ties}
    print(f"# {label}, {' and '.join(rings)} vs CUDA-core forms: "
          f"{json.dumps(out['tok_s'])} tok/s, ring / old in each pair "
          f"{[round(r, 4) for r in ratios]} (in turns: "
          f"{json.dumps(samples)})", flush=True)
    return out


def decode_tie_gap(torch, llama, params, cfg, token, pos, cache):
    """tie_gap(prefix, a, b) of phase 4's greedy decode from (token, pos)
    over a fresh cache: eager steps along prefix, then the gap between the
    logits of tokens a and b, relative to max|logit|."""
    def tie_gap(prefix, a, b):
        fresh(cache)
        tok, p = token.clone(), pos.clone()
        for t in prefix:
            llama.llama_decode_step(params, cfg, tok, p, cache)
            tok = torch.full_like(token, t)
            p = p + 1
        logits, _ = llama.llama_decode_step(params, cfg, tok, p, cache)
        last = logits[0].float()
        return abs(float(last[a] - last[b])) / float(last.abs().max())
    return tie_gap


def time_graph(torch, g, cache, token, pos, runs=3):
    """tok/s of `runs` runs of the DecodeGraph g, each from fresh state."""
    samples = []
    for _ in range(runs):
        fresh(cache)
        g.reset(token, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.run()
        torch.cuda.synchronize()
        samples.append(STEPS / (time.perf_counter() - t0))
    return samples


def unsplit_region(torch, llama, qm, params, cfg, token, pos, cache):
    """The 128-step graph region of phase 4 with the matmuls'
    K split forced off (qm._SPLITS = 1, the form before it): tok/s
    (max of 3 runs) and a profiler window, in the same call as the split
    form's."""
    qm._SPLITS = 1
    try:
        fresh(cache)
        g1 = llama.DecodeGraph(params, cfg, token, pos, cache, STEPS)
        samples = time_graph(torch, g1, cache, token, pos)
        prof = graph_profile(torch, g1, cache, token, pos)
        del g1
    finally:
        qm._SPLITS = None
    return {"tok_s": max(samples), "tok_s_samples": samples,
            "device_profile": prof}


def graph_profile(torch, g, cache, token, pos):
    """device_profile of one run of the DecodeGraph g from fresh state,
    with its kernel ms per token."""
    fresh(cache)
    g.reset(token, pos)
    t0 = time.perf_counter()
    prof = device_profile(torch, g.run)
    if prof:
        prof["kernel_ms_per_token"] = {
            k: v / STEPS for k, v in prof.pop("kernel_ms").items()}
        prof["window_s"] = time.perf_counter() - t0   # host seconds it took
    return prof


def weight_bytes(cfg, paired=False, group=128):
    """INT4 weights + bf16 scales (one per `group` weights of a column,
    per 2 * group paired) read by one decode step."""
    kvd = cfg.n_kv_heads * cfg.head_dim
    per_layer = (cfg.dim * cfg.dim * 2 + cfg.dim * kvd * 2
                 + cfg.dim * cfg.intermediate * 3)
    total = per_layer * cfg.n_layers + cfg.dim * cfg.vocab_size
    return total * 4 / 8 + total / (group * (2 if paired else 1)) * 2


def time_prefill(torch, llama, params, cfg, prompt, cache, reps=3):
    """Min seconds of llama_prefill over `reps` runs (each rewrites the
    cache rows [0, S) with the same values); returns (s, logits)."""
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = llama.llama_prefill(params, cfg, prompt, cache)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return min(samples), logits


def generate_path(torch, llama, counters, params, cfg, dev, report,
                  per_token, dequantize_weight, dequant_matmul):
    """Phase 5. Returns each path's launch counts; adds one bf16 decode
    step's launches to per_token."""
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    paths, res = {}, {}
    for label, kv_quant in ((f"prompt {PROMPT}", False),
                            (f"prompt {PROMPT} int8", True)):
        # the main path: greedy_generate, the default bf16 cache first
        cache = (llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev)
                 if kv_quant else None)
        counters.reset()
        t0 = time.perf_counter()
        toks, cache = llama.greedy_generate(params, cfg, prompt, GEN,
                                            cache=cache)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        paths[label] = counters.read()
        if toks.shape != (1, GEN) or toks.dtype != torch.int32:
            fail(f"{label}: greedy_generate gave {tuple(toks.shape)} "
                 f"{toks.dtype}")
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{label}: token ids out of range")
        prefill_s, logits = time_prefill(torch, llama, params, cfg, prompt,
                                         cache)
        first = torch.argmax(logits[:, -1], -1).to(torch.int32)
        if not torch.equal(first, toks[:, 0]):
            fail(f"{label}: prefill argmax {first.tolist()} is not the "
                 f"first generated token {toks[:, 0].tolist()}")
        # the generate loop's decode: one captured step, 3 runs of GEN - 1
        # tokens from pos PROMPT (rows >= PROMPT are written before read)
        pos = torch.full((1,), PROMPT, dtype=torch.int32, device=dev)
        g = llama.DecodeGraph(params, cfg, first, pos, cache, GEN - 1)
        samples = []
        for _ in range(3):
            g.reset(first, pos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = g.run()
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
            if not torch.equal(out, toks[:, 1:]):
                fail(f"{label}: a timed decode run gave other tokens")
        del g
        row = 2 * cfg.n_layers * cfg.n_kv_heads * PROMPT
        kv_bytes = row * (cfg.head_dim + 4) if kv_quant \
            else row * cfg.head_dim * 2
        bytes_tok = weight_bytes(cfg) + kv_bytes
        tok_s = (GEN - 1) / min(samples)
        res[label] = {
            "greedy_generate_call_s": call_s, "prefill_ms": 1e3 * prefill_s,
            "prompt_tok_s": PROMPT / prefill_s, "decode_tok_s": tok_s,
            "decode_tok_s_samples": [(GEN - 1) / t for t in samples],
            "kv_bytes_per_token": kv_bytes, "bytes_per_token": bytes_tok,
            "roofline_tok_s_copy": report["copy_gbps"] * 1e9 / bytes_tok,
            "roofline_tok_s_published": HBM_BYTES_S / bytes_tok,
            "launches": paths[label], "first_tokens": toks[0, :8].tolist()}
        print(f"# {label}: " + json.dumps(res[label]), flush=True)
        del cache

    # a 256-token prompt: its matmuls take the kernels
    label = f"prompt {SHORT}"
    short = prompt[:, :SHORT].contiguous()
    counters.reset()
    toks, cache = llama.greedy_generate(params, cfg, short, 8)
    torch.cuda.synchronize()
    paths[label] = counters.read()
    counters.reset()
    prefill_s, _ = time_prefill(torch, llama, params, cfg, short, cache, 1)
    per_prompt = counters.read()
    want_mma = {"qmm_group_mma": 4 * cfg.n_layers
                if SHORT >= qm.MMA_MIN_ROWS else 0,
                "qmm_w4a8_mma": int(SHORT >= qm.W4A8_MMA_MIN_ROWS)}
    for kname, n in want_mma.items():
        if per_prompt.get(kname, 0) != n:
            fail(f"{label}: a prefill launched {kname} "
                 f"{per_prompt.get(kname, 0)} times, expected {n}")
    prefill_s, _ = time_prefill(torch, llama, params, cfg, short, cache)
    print(f"# prefill ms: {SHORT} tokens {1e3 * prefill_s:.2f}, {PROMPT} "
          f"tokens {res[f'prompt {PROMPT}']['prefill_ms']:.2f}", flush=True)
    res[label] = {"prefill_ms": 1e3 * prefill_s,
                  "prompt_tok_s": SHORT / prefill_s,
                  "launches": paths[label], "launches_per_prompt": per_prompt,
                  "first_tokens": toks[0].tolist()}
    print(f"# {label}: " + json.dumps(res[label]), flush=True)
    del cache

    # prefill of S-1 tokens + one bf16 decode step = the S-token prefill
    cache = llama.init_kv_cache(cfg, 1, device=dev)
    full, _ = llama.llama_prefill(params, cfg, prompt, cache)
    fresh(cache)
    llama.llama_prefill(params, cfg, prompt[:, :-1].contiguous(), cache)
    counters.reset()
    step, _ = llama.llama_decode_step(
        params, cfg, prompt[:, -1],
        torch.full((1,), PROMPT - 1, dtype=torch.int32, device=dev), cache)
    torch.cuda.synchronize()
    per_token["flash_decode"] = counters.read().get("flash_decode", 0)
    compare_logits(torch, f"7B prefill {PROMPT - 1} + bf16 step vs "
                   f"prefill {PROMPT}", step[0], full[0, -1], report)
    del cache, full

    # 2 layers at 7B width: kernels on the card against the plain versions
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = dict(params, layers=params["layers"][:2])
    got, _ = llama.llama_prefill(params2, cfg2, short,
                                 llama.init_kv_cache(cfg2, 1, device=dev))
    t0 = time.perf_counter()
    want, _ = llama.llama_prefill(
        to_cpu(params2), cfg2, short.cpu(),
        llama.init_kv_cache(cfg2, 1, device="cpu"))
    print(f"# 2-layer prefill on the plain versions (CPU): "
          f"{time.perf_counter() - t0:.1f}s")
    compare_logits(torch, f"2-layer prefill {SHORT}, kernels vs plain",
                   got[0, -1], want[0, -1], report)
    report["generate"] = res

    # the dequant route of a long prompt, per shape: dequantize_weight
    # alone, and with its cuBLAS product at PROMPT rows
    route = {}
    layer0 = params["layers"][0]
    for label, q, din in (("wqkv", layer0["wqkv"], cfg.dim),
                          ("wo", layer0["wo"], cfg.dim),
                          ("w_gateup", layer0["w_gateup"], cfg.dim),
                          ("w_down", layer0["w_down"], cfg.intermediate),
                          ("lm_head", params["lm_head"], cfg.dim)):
        x = torch.randn(PROMPT, din, generator=gen, device=dev).to(
            torch.bfloat16)
        route[label] = {
            "dequantize_ms": cuda_ms(torch, lambda q=q:
                                     dequantize_weight(q), 10),
            "dequant_matmul_ms": cuda_ms(torch, lambda x=x, q=q:
                                         dequant_matmul(x, q), 10)}
    report["dequant_route_ms"] = route
    print(f"# dequant route at {PROMPT} rows: " + json.dumps(route),
          flush=True)
    return paths


def serving_requests(np, cfg):
    """REQUESTS seeded (prompt, max_new_tokens): 64-900 prompt tokens,
    32-128 new tokens. With eos unset the engine's schedule follows from
    the lengths alone; this seed's stream makes admission wait for pages.
    No idle slot's block-table row may point at a live request's page
    (stale_row_hazards): the engine points a retired slot's row at the
    trash page (ROADMAP.md Queue 3 item 4, repaired)."""
    rng = np.random.default_rng(SEED + 4)
    return [(rng.integers(0, cfg.vocab_size, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(64, 901, REQUESTS),
                            rng.integers(32, 129, REQUESTS))]


def device_profile(torch, fn, extra_kinds=()):
    """Run fn() under torch.profiler and read the card's side of it: the
    span from the first kernel's start to the last one's end, the share of
    it in which some kernel ran, and kernel milliseconds by kind (the
    port's kernels, then extra_kinds' (name part, kind) pairs, else
    "torch ops"). None where the profiler recorded no device event (then:
    not measured)."""
    from torch.profiler import ProfilerActivity, profile
    kinds = (("qmm_w4a8_ring_kernel", "qmm_w4a8_ring"),
             ("w4a8_quantize_rows", "qmm_w4a8"),
             ("qmm_w4a8_mma_kernel", "qmm_w4a8"),
             ("w4a8_splitk_sum", "qmm_w4a8 sum"),
             ("group_ln_norm_rows", "qmm_group_ln"),
             ("qmm_group_ln_mma_kernel", "qmm_group_ln"),
             ("group_ln_splitk_sum", "qmm_group_ln sum"),
             # the RMSNorm pre-pass and the split sum are shared by the
             # unpaired and the paired tensor-core forms
             ("group_norm_rows", "mma rmsnorm pre-pass"),
             ("qmm_group_norm_mma_kernel", "qmm_group_norm_mma"),
             ("qmm_chunk_mma_kernel", "qmm_chunk_mma"),
             ("qmm_slab_norm_mma_kernel", "qmm_slab_norm_mma"),
             ("qmm_slab_mma_kernel", "qmm_slab_mma"),
             ("chunk_splitk_sum", "qmm_chunk_mma sum"),
             ("w4a8_norm_quantize_rows", "qmm_norm_w4a8_mma"),
             ("qmm_norm_w4a8_mma_kernel", "qmm_norm_w4a8_mma"),
             ("qmm_group_kernel", "qmm_group*"),
             ("qmm_w4a8_kernel", "qmm_w4a8"),
             ("qmm_group_mma_kernel", "qmm_group_mma"),
             ("mma_splitk_sum", "mma split sum"),
             ("splitk_sum", "qmm_group2d sum"),
             ("flash_decode_kernel", "decode attention"),
             ("paged_ring_kernel", "decode attention"),
             ("flash_decode_merge", "decode attention"),
             ("flash_attention_kernel", "flash_attention"),
             ("rmsnorm_rows_kernel", "rmsnorm"),
             ("g2bmm_ring_kernel", "g2bmm_ring"),
             ("gbmm_ring_kernel", "gbmm_ring"), ("g2bmm_kernel", "g2bmm"),
             ("gbmm_kernel", "gbmm")) + tuple(extra_kinds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the profiler's raw events (prof.events() builds a tree of every event
    # first: about ten times as long a window)
    spans, by_kind = [], {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start = e.start_ns() / 1e3                     # us
        end = start + e.duration_ns() / 1e3
        spans.append((start, end))
        name = e.name()
        kind = group_kernel_kind(name) or w4a8_kernel_kind(name) or \
            ring_kernel_kind(name) or next(
                (k for sub, k in kinds if sub in name), "torch ops")
        by_kind[kind] = by_kind.get(kind, 0.0) + (end - start) / 1e3
    if not spans:
        return None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]
    return {"span_ms": span / 1e3, "busy_share": busy / span,
            "idle_share": 1 - busy / span, "kernel_ms": by_kind,
            "device_events": len(spans)}


def group_kernel_kind(name):
    """Which wrapper a qmm_group_kernel<BITS, R, PRO, PAIRED, MODE, XK>
    instantiation serves, from its demangled name (XK, the x type, is an
    int: bf16, f16 or f32); None for any other kernel or a name whose
    template arguments do not parse."""
    import re
    m = re.search(r"qmm_group_kernel<\D*\d+, \D*\d+, \D*(\d+), "
                  r"(?:\(bool\))?(true|false|0|1)(?:, \D*(\d+))?"
                  r"(?:, \D*\d+)?>", name)
    if not m:
        return None
    pro, paired = int(m.group(1)), m.group(2) in ("true", "1")
    mode = int(m.group(3) or 0)
    if mode:
        return "qmm_chunk" if mode == 1 else "qmm_group2d"
    if pro == 2:
        return "qmm_group_ln"
    if paired:
        return "qmm_slab_norm" if pro else "qmm_slab"
    return "qmm_group_norm" if pro else "qmm_group"


def ring_kernel_kind(name):
    """Which wrapper a qmm_ring_kernel<SCB, A16, NORM, PAIRED, XK>
    instantiation (csrc/quant_matmul_ring.cu) serves: qmm_group_norm_ring
    with NORM, qmm_slab_norm_ring with NORM and PAIRED, qmm_group2d_ring
    without NORM; None for any other kernel."""
    import re
    b = r"(?:\(bool\))?(true|false|0|1)"
    m = re.search(rf"qmm_ring_kernel<{b}, {b}, {b}, {b},", name)
    if not m:
        return None
    norm, paired = m.group(3) in ("true", "1"), m.group(4) in ("true", "1")
    if not norm:
        return "qmm_group2d_ring"
    return "qmm_slab_norm_ring" if paired else "qmm_group_norm_ring"


def w4a8_kernel_kind(name):
    """qmm_norm_w4a8 for a qmm_w4a8_kernel<BITS, R, NORM, XK>
    instantiation with NORM set, qmm_norm_w4a8_ring for a
    qmm_w4a8_ring_kernel<SCB, A16, NORM, XK> one, else None."""
    import re
    m = re.search(r"qmm_w4a8_kernel<\D*\d+, \D*\d+, (?:\(bool\))?(true|1)"
                  r"(?:, \D*\d+)?>", name)
    if m:
        return "qmm_norm_w4a8"
    b = r"(?:\(bool\))?(?:true|false|0|1)"
    m = re.search(rf"qmm_w4a8_ring_kernel<{b}, {b}, (?:\(bool\))?(true|1),",
                  name)
    return "qmm_norm_w4a8_ring" if m else None


def stale_row_hazards(eng):
    """(uid, page index) of every live request one of whose pages is the
    first entry of an idle slot's block-table row: the idle slot's decode
    step (pos 0) writes row 0 of that page. Reads the device table."""
    table = eng.cache["block_table"].cpu().numpy()
    out = set()
    for s in range(eng.B):
        if eng.slots[s] is not None:
            continue
        for t, req in enumerate(eng.slots):
            owned = eng.allocator.owned[t]
            if req is not None and int(table[s, 0]) in owned:
                out.add((req.uid, owned.index(int(table[s, 0]))))
    return out


def same_up_to_ties(what, got, want, prompts, tie_gap, limit=TIE):
    """Fail unless each got[i] equals want[i], or first differs at a
    near-tie (the rest of that request then follows another history):
    tie_gap(prefix, a, b), the gap between the logits of tokens a and b
    after `prefix` relative to max|logit|, is at most `limit`. Returns
    [(index, token index, gap)] of the near-ties. Tokens after a split
    are not compared here: where that matters, teacher_forced is."""
    ties = []
    compared = sum(
        next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
             min(len(g), len(w)) - 1) + 1 for g, w in zip(got, want))
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if j is None:
            fail(f"{what}: request {i} has {len(g)} vs {len(w)} tokens")
        gap = tie_gap(prompts[i] + g[:j], g[j], w[j])
        ties.append((i, j, gap))
        if gap > limit:
            fail(f"{what}: request {i} differs at token {j} "
                 f"({g[j]} vs {w[j]}), logit gap {gap:.3g} of max|logit|")
    worst = max((t[2] for t in ties), default=0.0)
    print(f"# {what}: {len(got) - len(ties)} of {len(got)} equal, "
          f"{len(ties)} part at a near-tie (largest gap {worst:.3g} of "
          f"max|logit|, limit {limit}); {compared} of "
          f"{sum(len(g) for g in got)} tokens compared", flush=True)
    return ties


def teacher_forced(torch, what, got, prompts, logits_along, limit):
    """Hold EVERY token of every request to a reference that is forced
    along the same history: logits_along(tokens) -> [len(tokens), vocab]
    are the reference's logits after each prefix of prompt + got[:-1], so
    got[j] is compared with the reference's pick after prompt + got[:j],
    whatever happened before j. Fails unless each got[j] is that pick or
    lies within `limit` of it (logit gap over the row's max|logit|).
    Returns {"tokens", "not_top1", "largest_gap"}."""
    n = differ = 0
    worst = (0.0, None, None)
    for i, (g, prompt) in enumerate(zip(got, prompts)):
        rows = logits_along(prompt + g[:-1])[len(prompt) - 1:].float()
        picked = rows.gather(1, torch.tensor(g, device=rows.device)[:, None])
        gap = (rows.max(-1).values - picked[:, 0]) / rows.abs().max(-1).values
        n += len(g)
        differ += int((gap > 0).sum())
        j = int(gap.argmax())
        if worst[1] is None or float(gap[j]) > worst[0]:
            worst = (float(gap[j]), i, j)
    print(f"# {what}: {n} tokens of {len(got)} requests against the "
          f"teacher-forced reference: {differ} are not its top-1, largest "
          f"gap {worst[0]:.3g} of max|logit| (request {worst[1]}, token "
          f"{worst[2]}; limit {limit})", flush=True)
    if worst[0] > limit:
        fail(f"{what}: request {worst[1]} token {worst[2]} lies "
             f"{worst[0]:.3g} of max|logit| below the reference's pick")
    return {"tokens": n, "not_top1": differ, "largest_gap": worst[0]}


def prefill_tie_gap(torch, llama, params, cfg, dev):
    """tie_gap(prefix, a, b): the gap between the logits of tokens a and b
    after `prefix` (one prefill of the model `params`), relative to
    max|logit|."""
    ref_cache = llama.init_kv_cache(cfg, 1, device=dev)

    def tie_gap(prefix, a, b):
        toks = torch.tensor([prefix], dtype=torch.int32, device=dev)
        logits, _ = llama.llama_prefill(params, cfg, toks, ref_cache)
        last = logits[0, -1].float()
        return (abs(float(last[a] - last[b])) / float(last.abs().max()))
    return tie_gap


def serving_path(torch, llama, counters, params, cfg, dev, report,
                 per_token):
    """Phase 6. Returns the launch counts of the paged engine's drain per
    pool type; adds one paged decode step's launches to per_token."""
    import numpy as np
    from infinitensor_tpu_torch.kernels import paged_attention as pa
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    from infinitensor_tpu_torch.serving import (PagedServingEngine,
                                                ServingEngine)

    reqs = serving_requests(np, cfg)
    n_layers = cfg.n_layers
    tie_gap = prefill_tie_gap(torch, llama, params, cfg, dev)

    def drain(eng, snap_after=None):
        """Submit the stream and step to the end; returns (tokens per
        request, seconds without the snapshot's, steps, the snapshot)."""
        handles = [eng.submit(p, max_new_tokens=m, uid=i)
                   for i, (p, m) in enumerate(reqs)]
        snap, snap_s, n = None, 0.0, 0
        waited, hazards = [0], set()
        paged = hasattr(eng, "allocator")
        admit = eng._admit

        def counted_admit():
            """Count the admissions that left a request waiting for pages
            beside a free slot."""
            admit()
            waited[0] += bool(eng.pending) and None in eng.slots

        if paged:
            eng._admit = counted_admit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.pending or any(r is not None for r in eng.slots):
            eng.step()
            n += 1
            if paged:
                hazards |= stale_row_hazards(eng)
            if n == snap_after:
                t1 = time.perf_counter()
                snap = eng.snapshot()
                snap_s = time.perf_counter() - t1
            if n > 10_000:
                fail("the serving engine did not drain")
        torch.cuda.synchronize()
        took = time.perf_counter() - t0 - snap_s
        waited = waited[0]
        if paged and (not waited or hazards):
            fail(f"the stream made admission wait in {waited} steps and "
                 f"aimed stale table rows at live pages {sorted(hazards)}")
        for h, (_, m) in zip(handles, reqs):
            if not h.done or len(h.generated) != m:
                fail(f"request {h.uid}: done={h.done}, "
                     f"{len(h.generated)} of {m} tokens")
            if not all(0 <= t < cfg.vocab_size for t in h.generated):
                fail(f"request {h.uid}: token ids out of range")
        return ([list(h.generated) for h in handles], took, n, snap,
                snap_s, waited)

    prompts = [p for p, _ in reqs]
    n_new = sum(m for _, m in reqs)
    paths, res = {}, {}
    for label, kv_quant in (("serving paged bf16", False),
                            ("serving paged int8", True)):
        kname = "paged_flash_decode_q8" if kv_quant else "paged_flash_decode"
        kw = dict(max_slots=SLOTS, prefill_buckets=BUCKETS,
                  decode_chunk=CHUNK, kv_quant=kv_quant)
        paged_kw = dict(kw, n_pages=POOL_PAGES, page_size=PAGE)
        # the main path: the paged engine drains the stream
        eng = PagedServingEngine(params, cfg, **paged_kw)
        counters.reset()
        got, took, n_steps, snap, snap_s, waited = drain(eng, snap_after=6)
        paths[label] = counters.read()
        stats = dict(eng.stats)
        if eng.free_pages != POOL_PAGES - 1 or any(eng.allocator.owned):
            fail(f"{label}: {eng.free_pages} of {POOL_PAGES - 1} pages free "
                 "after the drain")
        if eng._program.graph is None:
            fail(f"{label}: the decode step was not captured")
        # warm-up + capture of the one decode graph, all in the ring form
        # (its merge inside: no flash_decode_merge); one pass per prefill
        for k in (kname, kname + "_ring"):
            if paths[label].get(k, 0) != 2 * n_layers:
                fail(f"{label}: {paths[label].get(k, 0)} launches of "
                     f"{k}, expected {2 * n_layers}")
        passes = int(stats["prefill_launches"])
        if paths[label].get("flash_attention", 0) != n_layers * passes:
            fail(f"{label}: flash_attention launched "
                 f"{paths[label].get('flash_attention', 0)} times in "
                 f"{passes} prefill passes")
        pool_tokens = (POOL_PAGES - 1) * PAGE
        if pool_tokens >= SLOTS * cfg.max_seq:
            fail("the pool is not smaller than the dense reservation")

        # decode ms per step with all slots live: the engine's own graph,
        # 12 pages per slot, positions 640-703
        table = (torch.arange(SLOTS * 12, device=dev, dtype=torch.int32)
                 .reshape(SLOTS, 12) + 1)
        eng.cache["block_table"].zero_()
        eng.cache["block_table"][:, :12] = table
        tok0 = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
        pos0 = torch.full((SLOTS,), 640, dtype=torch.int32, device=dev)
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                eng._program.run(tok0, pos0, CHUNK)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) / (8 * CHUNK))
        # the card's side of two chunks (2 * CHUNK replays of the graph)
        prof = device_profile(torch, lambda: [
            eng._program.run(tok0, pos0, CHUNK) for _ in range(2)])
        # the same step with the paged kernel's block form forced, in
        # turns with the ring form (the route's), tokens equal up to ties
        block = dense_forms(
            torch, pa, eng, cfg, dev, tie_gap, label=label,
            form_fn="paged_form", forced=lambda *a: "block",
            kname=kname + "_ring", route_mma=True,
            what=f"ring vs block {kname}", alt="block")
        # one eager step on the same cache: launches per decode step
        counters.reset()
        llama.llama_decode_step(params, cfg, tok0, pos0, eng.cache)
        torch.cuda.synchronize()
        step_launches = counters.read()
        per_token[kname] = step_launches.get(kname, 0)
        for k in (kname, kname + "_ring"):
            if step_launches.get(k, 0) != n_layers:
                fail(f"{label}: {step_launches.get(k, 0)} launches of {k} "
                     f"in one decode step, expected {n_layers}")
        if step_launches.get("flash_decode_merge", 0):
            fail(f"{label}: a decode step launched flash_decode_merge")
        # the step's four matmuls a layer at SLOTS rows: tensor-core form
        # and its lm_head the int8 tensor cores
        want_mma = {"qmm_group_mma": 4 * n_layers
                    if SLOTS >= qm.MMA_MIN_ROWS else 0,
                    "qmm_w4a8_mma": int(SLOTS >= qm.W4A8_MMA_MIN_ROWS)}
        for kname, n in want_mma.items():
            if step_launches.get(kname, 0) != n:
                fail(f"{label}: a decode step launched {kname} "
                     f"{step_launches.get(kname, 0)} times, expected {n}")
        del eng

        # a fresh engine resumes the mid-stream snapshot to the same tokens
        eng = PagedServingEngine(params, cfg, **paged_kw)
        eng.restore(snap)
        handles = {r.uid: r for r in list(eng.pending)
                   + [r for r in eng.slots if r is not None]}
        eng.run_to_completion()
        resumed = sum(1 for uid, h in handles.items()
                      if list(h.generated) == got[uid])
        if resumed != len(handles) or eng.free_pages != POOL_PAGES - 1:
            fail(f"{label}: {resumed} of {len(handles)} resumed requests "
                 "ended in the tokens of the uninterrupted run")
        del eng, snap

        # the dense engine on the same stream
        dense_label = DENSE_INT8 if kv_quant else DENSE_BF16
        dense = ServingEngine(params, cfg, **kw)
        counters.reset()
        want, dense_s, dense_steps, _, _, _ = drain(dense)
        paths[dense_label] = counters.read()
        dense_stats = dict(dense.stats)
        # one eager step at SLOTS rows: wqkv and w_gateup take
        # qmm_group_norm's tensor-core form, wo and w_down qmm_group_mma
        counters.reset()
        llama.llama_decode_step(params, cfg, tok0, pos0, dense.cache)
        torch.cuda.synchronize()
        dense_step = counters.read()
        mma = int(SLOTS >= qm.MMA_MIN_ROWS)
        for kname, n in (("qmm_group_norm", 2 * n_layers),
                         ("qmm_group_norm_mma", 2 * n_layers * mma),
                         ("qmm_group_mma", 2 * n_layers * mma)):
            if dense_step.get(kname, 0) != n:
                fail(f"{dense_label}: a decode step launched {kname} "
                     f"{dense_step.get(kname, 0)} times, expected {n}")
        res[dense_label] = {"launches": paths[dense_label],
                            "launches_per_step": dense_step,
                            **(dense_forms(torch, qm, dense, cfg, dev,
                                           tie_gap) if kv_quant else {})}
        del dense
        ties = same_up_to_ties(f"{label} vs dense engine", got, want,
                               prompts, tie_gap)
        # one request against greedy_generate at batch 1
        i = min(range(REQUESTS), key=lambda i: len(prompts[i]))
        cache = llama.init_kv_cache(cfg, 1, kv_quant=kv_quant, device=dev)
        solo, _ = llama.greedy_generate(
            params, cfg, torch.tensor([prompts[i]], dtype=torch.int32,
                                      device=dev), reqs[i][1], cache=cache)
        del cache
        solo_ties = same_up_to_ties(
            f"{label} vs greedy_generate", [got[i]], [solo[0].tolist()],
            [prompts[i]], tie_gap)
        decode_s = stats["decode_dispatch_s"] + stats["decode_fetch_s"]
        res[label] = {
            "requests": REQUESTS, "generated_tokens": n_new,
            "prompt_tokens": sum(len(p) for p in prompts),
            "drain_s": took, "generated_tok_s": n_new / took,
            "engine_steps": n_steps, "steps_admission_waited": waited,
            "decode_steps": eng_steps(stats),
            "mean_live_slots": stats["slot_steps_active"]
            / max(stats["slot_steps_total"] / SLOTS, 1),
            "decode_ms_per_step_drain": 1e3 * decode_s
            / max(eng_steps(stats), 1),
            "decode_ms_per_step_8_live": 1e3 * min(samples),
            "decode_tok_s_8_live": SLOTS / min(samples),
            "decode_device_profile_8_live": prof,
            "block_form": block,
            "stats": stats, "snapshot_s": snap_s,
            "pool_tokens": pool_tokens,
            "dense_reservation_tokens": SLOTS * cfg.max_seq,
            "launches": paths[label], "launches_per_step": step_launches,
            "dense_engine": {"drain_s": dense_s,
                             "generated_tok_s": n_new / dense_s,
                             "engine_steps": dense_steps,
                             "stats": dense_stats},
            "equal_to_dense": REQUESTS - len(ties),
            "near_ties_vs_dense": ties,
            "greedy_generate_request": i,
            "near_ties_vs_greedy_generate": solo_ties,
            "resumed_requests_equal": resumed,
            "first_tokens": got[0][:8]}
        print(f"# {label}: " + json.dumps(res[label]), flush=True)
    report["serving"] = res
    return paths


def dense_forms(torch, qm, dense, cfg, dev, tie_gap, label=DENSE_INT8,
                form_fn="group_form", forced=None, kname="qmm_group_norm_mma",
                route_mma=None, what=None, alt="cuda_core"):
    """Phases 6 and 9: the dense engine's decode step at SLOTS live slots
    (INT8 cache) with the matmuls in the forms their route takes, with
    kname's kernel forced to its CUDA-core form (qm.<form_fn> patched to
    `forced` while the step is captured; by default qmm_group_norm's, the
    tensor cores at SLOTS rows) and in its own form again: ms a step
    (CUDA events around CHUNK replays of the one captured step from pos
    640, median of 20, over CHUNK), read in turns; a profiler window over
    one chunk of each; DENSE_STEPS greedy tokens of each from seeded
    tokens at pos 0, equal up to a printed near-tie. route_mma: whether
    the route's capture launches kname (by default where SLOTS >=
    qm.MMA_MIN_ROWS); the forced one must not. Phase 6 also passes the
    paged engine with the paged kernels' module for qm (paged_form forced
    to the block form); `what` names the two forms in the print, `alt`
    the forced one in the report."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    tok0 = torch.randint(1, cfg.vocab_size, (SLOTS,), generator=gen,
                         device=dev, dtype=torch.int32)
    zero = torch.zeros_like(tok0)
    route = getattr(qm, form_fn)
    if forced is None:
        def forced(rows, dtype, norm, bits=4):
            return "cuda_core" if norm else route(rows, dtype, norm, bits)
    if route_mma is None:
        route_mma = SLOTS >= qm.MMA_MIN_ROWS
    programs = {}
    for form in ("route", alt):
        if form == alt:
            setattr(qm, form_fn, forced)
        before = qm.launches[kname]
        try:
            dense._program = None
            dense._run_program(tok0, zero, 1)        # captures the step
        finally:
            setattr(qm, form_fn, route)
        programs[form] = dense._program
        n = qm.launches[kname] - before
        if (n > 0) != (form == "route" and route_mma):
            fail(f"{label}: the {form} step's capture launched {kname} "
                 f"{n} times")
    dense._program = None
    tokens = {}
    for form, prog in programs.items():
        first, tok, pos = prog.run(tok0, zero, CHUNK)
        rest, _, _ = prog.run(tok, pos, DENSE_STEPS - CHUNK)
        tokens[form] = torch.cat([first, rest], 1).tolist()
    what = what or f"tensor-core vs CUDA-core {kname[:-4]}"
    ties = same_up_to_ties(
        f"{label}: {what}",
        tokens["route"], tokens[alt],
        [[t] for t in tok0.tolist()], tie_gap)
    pos = torch.full((SLOTS,), 640, dtype=torch.int32, device=dev)
    ms = {"route": [], alt: []}
    for form in ("route", alt, "route"):
        ms[form].append(cuda_ms(
            torch, lambda p=programs[form]: p.run(tok0, pos, CHUNK), 20)
            / CHUNK)
    prof = {form: device_profile(torch, lambda p=prog: p.run(tok0, pos,
                                                             CHUNK))
            for form, prog in programs.items()}
    out = {"step_ms": {f: min(v) for f, v in ms.items()},
           "step_ms_in_turns": ms, "device_profile_chunk": prof,
           "tokens_from_pos0": tokens["route"][0], "near_ties": ties}
    print(f"# {label} step at {SLOTS} live, {what}: " + json.dumps(out),
          flush=True)
    del programs
    return out


def eng_steps(stats):
    """Decode steps the engine ran (every slot steps in each)."""
    return int(stats["slot_steps_total"]) // SLOTS


def gpt2_cases(torch, qm, att, gcfg, gparams, gen, dev, randn,
               dequantize_weight):
    """Phase 3 rows at the GPT-2 345M serving shapes: qmm_group_ln for
    w_qkv and w_up at G_SLOTS rows and at 1 row (the batch-1 step's K
    split, beside the unsplit form), qmm_group int8 for
    w_o, w_down and the padded lm_head at G_SLOTS rows, and both dense
    decode-attention kernels at B G_SLOTS, 16 heads of 64, S G_MAXSEQ with
    ragged pos in [16, 313] and NaN (in the scales for int8) past pos."""
    layer0, eps, dim = gparams["layers"][0], gcfg.layer_norm_eps, gcfg.dim

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def vec(scale, shift):
        return (torch.randn(dim, generator=gen, device=dev) * scale
                + shift).to(torch.bfloat16)

    out = []
    for label, rows, wkey, bkey in (("w_qkv", G_SLOTS, "w_qkv", "b_qkv"),
                                    ("w_up", G_SLOTS, "w_up", "b_up"),
                                    ("w_qkv", 1, "w_qkv", "b_qkv"),
                                    ("w_up", 1, "w_up", "b_up")):
        q = layer0[wkey]
        x = randn(rows, dim)
        g, b = vec(0.1, 1.0), vec(0.1, 0.0)
        bias = (torch.randn(q.out_features, generator=gen, device=dev)
                * 0.1).to(torch.bfloat16)
        xn, w = qm.layer_norm(x, g, b, eps), dequantize_weight(q)
        mma = qm.ln_form(rows, x.dtype) == "mma"

        def kernel(x=x, g=g, b=b, q=q, bias=bias):
            return qm.quant_matmul_ln(x, g, b, q, bias=bias, eps=eps)

        out.append(dict(
            name="qmm_group_ln_mma" if mma else "qmm_group_ln",
            shape=f"{label} {rows} rows",
            path=GPT2_BF16 if mma else GPT2_BS1,
            replaces=TPU + "quant_matmul.py:300",
            source=SRC + ("quant_matmul_mma.cu" if mma
                          else "quant_matmul_fused.cu"),
            kernel=kernel,
            plain=lambda x=x, g=g, b=b, q=q, bias=bias:
                qm.qmm_group_ln_plain(x, g, b, q, bias, eps)[
                    :, :q.out_features],
            # 1 row: the K split, beside the form before it
            **({} if mma else {"forms": {"unsplit": unsplit(qm, kernel)}}),
            # addmm on rows normalized before the timing; and from the raw
            # rows, F.layer_norm then addmm
            library=lambda xn=xn, w=w, bias=bias: torch.addmm(bias, xn, w),
            library_ln=lambda x=x, g=g, b=b, w=w, bias=bias: torch.addmm(
                bias, torch.nn.functional.layer_norm(x, (dim,), g, b, eps),
                w),
            bytes=nbytes(x, g, b, q.qweight, q.scales, bias)
            + 2 * rows * q.out_physical,
            ops=2 * rows * dim * q.out_physical, kind="bf16",
            **({"cuda_core": lambda x=x, g=g, b=b, q=q, bias=bias:
                qm._launch_group_ln(x, g, b, q, bias, eps, form="cuda_core")[
                    :, :q.out_features]} if mma else {})))
    for label, q in (("w_o", layer0["w_o"]), ("w_down", layer0["w_down"]),
                     ("lm_head", gparams["lm_head_q"])):
        x = randn(G_SLOTS, q.in_features)
        w = dequantize_weight(q)
        out.append(dict(
            name="qmm_group", shape=f"gpt2 {label} int8 {G_SLOTS} rows",
            path=GPT2_BF16, replaces=TPU + "quant_matmul.py:100",
            source=SRC + "quant_matmul.cu",
            kernel=lambda x=x, q=q: qm.quant_matmul(x, q),
            plain=lambda x=x, q=q: qm.qmm_group_plain(x, q)[
                :, :q.out_features],
            library=lambda x=x, w=w: torch.matmul(x, w),
            bytes=nbytes(x, q.qweight, q.scales)
            + 2 * G_SLOTS * q.out_physical,
            ops=2 * G_SLOTS * q.in_features * q.out_physical, kind="bf16"))

    B, H, S, D = G_SLOTS, gcfg.n_heads, G_MAXSEQ, gcfg.head_dim
    pos = torch.randint(16, 314, (B,), generator=gen, device=dev).to(
        torch.int32)
    pos[0], pos[-1] = 16, 313
    live_rows = int((pos + 1).sum())
    cols = torch.arange(S, device=dev)
    mask = (cols[None] <= pos[:, None])[:, None, None]      # [B, 1, 1, S]
    dead = ~mask[:, 0].expand(B, H, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh = randn(B, H, 1, D)
    small = 2 * nbytes(qh) + nbytes(pos)
    shape = f"{B}x{H}x{S}x{D} pos {int(pos.min())}-{int(pos.max())}"
    kc, vc = (torch.randint(-127, 128, (B, H, S, D), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B, H, S, generator=gen, device=dev) * 0.015 + 0.005
              for _ in range(2))
    kf, vf = ((c.float() * sc[..., None]).to(torch.bfloat16)
              for c, sc in ((kc, ks), (vc, vs)))
    # the kernel gets NaN past pos; the plain version (which multiplies
    # every row by its probability, 0 there) the clean tensors
    clean = (qh, kc, vc, ks.clone(), vs.clone(), pos)
    ks[dead] = float("nan")
    vs[dead] = float("nan")
    args = (qh, kc, vc, ks, vs, pos)
    out.append(dict(
        name="flash_decode_q8", shape=shape, path=GPT2_INT8,
        replaces=TPU + "attention.py:345", source=SRC + "flash_decode.cu",
        kernel=lambda a=args: att.flash_decode_q8(*a),
        plain=lambda a=clean: att.flash_decode_q8_plain(*a),
        library=lambda kf=kf, vf=vf: sdpa(qh, kf, vf, attn_mask=mask),
        bytes=2 * H * live_rows * (D + 4) + small,
        ops=4 * H * live_rows * D, kind="bf16"))
    kb, vb = randn(B, H, S, D), randn(B, H, S, D)
    kr, vr = kb.clone(), vb.clone()
    kb[dead] = float("nan")
    vb[dead] = float("nan")
    args = (qh, kb, vb, pos)
    out.append(dict(
        name="flash_decode", shape=shape, path=GPT2_BF16,
        replaces=TPU + "attention.py:294", source=SRC + "flash_decode.cu",
        kernel=lambda a=args: att.flash_decode(*a),
        plain=lambda a=(qh, kr, vr, pos): att.flash_decode_plain(*a),
        library=lambda kr=kr, vr=vr: sdpa(qh, kr, vr, attn_mask=mask),
        bytes=2 * H * live_rows * D * 2 + small,
        ops=4 * H * live_rows * D, kind="bf16"))
    return out


def paired_cases(torch, qm, cfg, pparams, randn, dequantize_weight):
    """Phase 3 rows of the slab kernels at the 7B decode shapes (1 row):
    qmm_slab_norm for wqkv and w_gateup in its ring form (the route's,
    row 10c: qmm_slab_norm_ring, beside the CUDA-core form, forced, within
    one bf16 ulp of it and of the plain version, both also back to back
    over the 32 layers' copies in one CUDA graph) and in its CUDA-core form
    (a row of its own: no path takes it at one row), qmm_slab for wo,
    w_down and the lm_head; pparams is phase 8's paired build."""
    layers, eps = pparams["layers"], cfg.norm_eps
    layer0 = layers[0]

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = []
    for label, q in (("wqkv", layer0["wqkv"]),
                     ("w_gateup", layer0["w_gateup"])):
        if not q.paired:
            fail(f"{label}: the paired build is not paired")
        x = randn(1, cfg.dim)
        nw = (randn(cfg.dim).float() * 0.1 + 1.0).to(torch.bfloat16)
        xn, w = qm.rmsnorm_bf16(x, nw, eps), dequantize_weight(q)
        n = q.out_features

        def ring(q, x=x, nw=nw):
            return qm.quant_matmul_norm(x, nw, q, eps)

        def core(q, x=x, nw=nw, n=n):
            return qm._launch_slab(x, nw, q, eps, "qmm_slab_norm",
                                   form="cuda_core")[:, :n]

        row = dict(
            shape=f"paired {label}", replaces=TPU + "quant_matmul.py:208",
            plain=lambda x=x, nw=nw, q=q, n=n: qm.qmm_slab_plain(
                qm.rmsnorm_bf16(x, nw, eps), q)[:, :n],
            library=lambda xn=xn, w=w: torch.matmul(xn, w),
            bytes=nbytes(x, nw, q.qweight, q.scales) + 2 * q.out_physical,
            ops=2 * cfg.dim * q.out_physical, kind="bf16", ulp=True)
        out.append(dict(
            row, name="qmm_slab_norm_ring", path=PAIRED,
            source=SRC + "quant_matmul_ring.cu",
            kernel=lambda q=q, f=ring: f(q),
            cuda_core=lambda q=q, f=core: f(q),
            graph_weights=[lay[label] for lay in layers],
            graph={"ring": ring, "cuda_core": core}))
        out.append(dict(
            row, name="qmm_slab_norm", path=NO_PATH,
            source=SRC + "quant_matmul_fused.cu",
            kernel=lambda q=q, f=core: f(q)))
    for label, q in (("wo", layer0["wo"]), ("w_down", layer0["w_down"]),
                     ("lm_head", pparams["lm_head"])):
        x = randn(1, q.in_features)
        w = dequantize_weight(q)
        out.append(dict(
            name="qmm_slab", shape=f"paired {label}", path=PAIRED,
            replaces=TPU + "quant_matmul.py:203",
            source=SRC + "quant_matmul_fused.cu",
            **({"forms": {"unsplit": unsplit(qm, lambda x=x, q=q:
                                              qm.quant_matmul(x, q))}}
               if split_launches(qm, (q,)) else {}),
            kernel=lambda x=x, q=q: qm.quant_matmul(x, q),
            plain=lambda x=x, q=q: qm.qmm_slab_plain(x, q)[
                :, :q.out_features],
            library=lambda x=x, w=w: torch.matmul(x, w),
            bytes=nbytes(x, q.qweight, q.scales) + 2 * q.out_physical,
            ops=2 * q.in_features * q.out_physical, kind="bf16"))
    return out


def paired_rows_cases(torch, qm, cfg, pparams, envs, layer0, gen, dev, randn,
                      dequantize_weight):
    """Phase 3 rows of the paired tensor-core forms, the route's own call
    from MMA_MIN_ROWS rows: qmm_slab_norm_mma (wqkv, w_gateup) and
    qmm_slab_mma (wqkv, wo, w_gateup, w_down) over phase 8's paired 7B
    weights at SLOTS, 64 and SHORT rows of bf16, each beside the
    CUDA-core body, forced (cuda_core), and the unpaired tile on the same
    shape (yardstick: qmm_group_norm_mma / qmm_group_mma over layer0, the
    group-128 build); SLOTS rows count the launches of phase 8's dense
    8-slot step, SHORT rows of qmm_slab those of its prefill (whose norm
    is unfused). Then qmm_norm_w4a8 (the W4A8 knob, wqkv and w_gateup) at
    2 rows, under its W4A8_MMA_MIN_ROWS. Library: matmul on the
    (normalized) rows."""
    eps, lay = cfg.norm_eps, pparams["layers"][0]
    nw = (torch.rand(cfg.dim, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = []
    for rows in (SLOTS, 64, SHORT):
        for label in ("wqkv", "w_gateup"):
            q = lay[label]
            x = randn(rows, cfg.dim) * 3
            xn, w, n = qm.rmsnorm_bf16(x, nw, eps), dequantize_weight(q), \
                q.out_features
            out.append(dict(
                name="qmm_slab_norm_mma", shape=f"paired {label} {rows} rows",
                path=DENSE_PAIRED if rows == SLOTS else NO_PATH,
                replaces=TPU + "quant_matmul.py:208",
                source=SRC + "quant_matmul_mma.cu",
                kernel=lambda x=x, q=q: qm.quant_matmul_norm(x, nw, q, eps),
                cuda_core=lambda x=x, q=q, n=n: qm._launch_slab(
                    x, nw, q, eps, "qmm_slab_norm", form="cuda_core")[:, :n],
                yardsticks={"unpaired_tile": lambda x=x, u=layer0[label]:
                            qm._launch_group(x, nw, u, eps, "qmm_group_norm",
                                             form="mma")},
                plain=lambda x=x, q=q, n=n: qm.qmm_slab_plain(
                    qm.rmsnorm_bf16(x, nw, eps), q)[:, :n],
                library=lambda xn=xn, w=w: torch.matmul(xn, w),
                bytes=nbytes(x, nw, q.qweight, q.scales)
                + 2 * rows * q.out_physical,
                ops=2 * rows * cfg.dim * q.out_physical, kind="bf16"))
        for label in ("wqkv", "wo", "w_gateup", "w_down"):
            q = lay[label]
            x = randn(rows, q.in_features)
            w = dequantize_weight(q)
            out.append(dict(
                name="qmm_slab_mma", shape=f"paired {label} {rows} rows",
                path={SLOTS: DENSE_PAIRED, SHORT: PAIRED_PROMPT}.get(
                    rows, NO_PATH),
                replaces=TPU + "quant_matmul.py:203",
                source=SRC + "quant_matmul_mma.cu",
                kernel=lambda x=x, q=q: qm.quant_matmul(x, q),
                cuda_core=lambda x=x, q=q: qm._launch_slab(
                    x, None, q, 0.0, "qmm_slab", form="cuda_core")[
                        :, :q.out_features],
                yardsticks={"unpaired_tile": lambda x=x, u=layer0[label]:
                            qm._launch_group(x, None, u, 0.0, "qmm_group",
                                             form="mma")},
                plain=lambda x=x, q=q: qm.qmm_slab_plain(x, q)[
                    :, :q.out_features],
                library=lambda x=x, w=w: torch.matmul(x, w),
                bytes=nbytes(x, q.qweight, q.scales)
                + 2 * rows * q.out_physical,
                ops=2 * rows * q.in_features * q.out_physical, kind="bf16"))
    for label in ("wqkv", "w_gateup"):
        q = layer0[label]
        x = randn(2, cfg.dim) * 3
        xn, w, n = qm.rmsnorm_bf16(x, nw, eps), dequantize_weight(q), \
            q.out_features
        out.append(dict(
            name="qmm_norm_w4a8", shape=f"{label} 2 rows", path=NO_PATH,
            replaces=TPU + "quant_matmul.py:288",
            source=SRC + "quant_matmul.cu", env=envs[W4A8],
            kernel=lambda x=x, q=q: qm.quant_matmul_norm(x, nw, q, eps),
            plain=lambda x=x, q=q, n=n: qm.qmm_norm_w4a8_plain(
                x, nw, q, eps)[:, :n],
            library=lambda xn=xn, w=w: torch.matmul(xn, w),
            bytes=nbytes(x, nw, q.qweight, q.scales) + 2 * 2 * q.out_physical,
            ops=2 * 2 * cfg.dim * q.out_physical, kind="int8"))
    return out


def slab_crossover(torch, qm, pparams, cfg, gen, randn, flush):
    """Both forms of the paired matmuls, forced, at 1, 2, 3, 4 and 8 rows
    of the 7B layer (phase 8's weights): qmm_slab_norm on wqkv and
    w_gateup (also its ring form at 1 row, the route's there), qmm_slab on
    wqkv, wo, w_gateup and w_down (the CUDA-core form with its K split
    where the route takes it); ms summed over the shapes, in one call: the
    times behind slab_form's MMA_MIN_ROWS. Returns {kernel: {rows:
    {form: ms}}}."""
    lay, eps = pparams["layers"][0], cfg.norm_eps
    nw = (torch.rand(cfg.dim, generator=gen, device=flush.device) + 0.5).to(
        torch.bfloat16)
    out = {"qmm_slab_norm": {}, "qmm_slab": {}}
    for rows in (1, 2, 3, 4, 8):
        for kname, labels, norm_w in (
                ("qmm_slab_norm", ("wqkv", "w_gateup"), nw),
                ("qmm_slab", ("wqkv", "wo", "w_gateup", "w_down"), None)):
            forms = ("mma", "cuda_core") + (
                ("ring",) if rows == 1 and norm_w is not None else ())
            res = out[kname][rows] = dict.fromkeys(forms, 0.0)
            for label in labels:
                q = lay[label]
                x = randn(rows, q.in_features) * 3
                for form in forms:
                    res[form] += cuda_ms(
                        torch, lambda x=x, q=q, form=form: qm._launch_slab(
                            x, norm_w, q, eps, kname, form=form), 50, flush)
    print(f"# paired forms, ms summed over the layer's shapes: "
          f"{json.dumps(out)}; MMA_MIN_ROWS = {qm.MMA_MIN_ROWS}", flush=True)
    return out


def mma_cases(torch, qm, cfg, params, gparams, randn, dequantize_weight):
    """Phase 3 rows of qmm_group's tensor-core form (forced), each with the
    CUDA-core form's time in the same call: the 7B layer's four matmuls at
    SLOTS, 64 and SHORT rows (int4, bf16 x), GPT-2's int8 w_o, w_down and
    lm_head at G_SLOTS rows, and wo at SHORT rows of an f16 x. Rows of
    the 7B shapes count the launches of the 256-token prompt's path."""
    layer0, glayer0 = params["layers"][0], gparams["layers"][0]

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def launch(x, q, form):
        return qm._launch_group(x, None, q, 0.0, "qmm_group", form=form)[
            :, :q.out_features]

    shapes = [(label, q, rows, path, torch.bfloat16)
              for rows, path in ((SLOTS, "serving paged bf16"),
                                 (64, f"prompt {SHORT}"),
                                 (SHORT, f"prompt {SHORT}"))
              for label, q in (("wqkv", layer0["wqkv"]), ("wo", layer0["wo"]),
                               ("w_gateup", layer0["w_gateup"]),
                               ("w_down", layer0["w_down"]))]
    shapes += [(f"gpt2 {label} int8", q, G_SLOTS, GPT2_BF16, torch.bfloat16)
               for label, q in (("w_o", glayer0["w_o"]),
                                ("w_down", glayer0["w_down"]),
                                ("lm_head", gparams["lm_head_q"]))]
    shapes.append(("wo f16", layer0["wo"], SHORT, f"prompt {SHORT}",
                   torch.float16))
    out = []
    for label, q, rows, path, dtype in shapes:
        x = randn(rows, q.in_features).to(dtype)
        w = dequantize_weight(q).to(dtype)
        out.append(dict(
            name="qmm_group_mma", shape=f"{label} {rows} rows", path=path,
            replaces=TPU + "quant_matmul.py:100",
            source=SRC + "quant_matmul_mma.cu",
            kernel=lambda x=x, q=q: launch(x, q, "mma"),
            cuda_core=lambda x=x, q=q: launch(x, q, "cuda_core"),
            plain=lambda x=x, q=q: qm.qmm_group_plain(x, q)[
                :, :q.out_features],
            library=lambda x=x, w=w: torch.matmul(x, w),
            bytes=nbytes(x, q.qweight, q.scales) + 2 * rows * q.out_physical,
            ops=2 * rows * q.in_features * q.out_physical, kind="bf16"))
    return out


def norm_mma_cases(torch, qm, cfg, layer0, gen, dev, randn,
                   dequantize_weight):
    """Phase 3 rows of qmm_group_norm's tensor-core form (the route's own
    call, quant_matmul_norm) on wqkv and w_gateup at SLOTS, 64 and SHORT
    rows, each beside the CUDA-core form, forced, and the tile alone
    (qmm_group_mma on rows normalized beforehand: the form minus it is
    the pre-pass); library: matmul on the normalized rows. SLOTS rows
    count the launches of the dense engine's drain (INT8 cache)."""
    eps = cfg.norm_eps
    nw = (torch.rand(cfg.dim, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    out = []
    for rows, path in ((SLOTS, DENSE_INT8), (64, NO_PATH),
                       (SHORT, NO_PATH)):
        for label in ("wqkv", "w_gateup"):
            q = layer0[label]
            x = randn(rows, cfg.dim) * 3
            xn = qm.rmsnorm_bf16(x, nw, eps)
            w = dequantize_weight(q)
            n = q.out_features
            out.append(dict(
                name="qmm_group_norm_mma", shape=f"{label} {rows} rows",
                path=path, replaces=TPU + "quant_matmul.py:85",
                source=SRC + "quant_matmul_mma.cu",
                kernel=lambda x=x, q=q: qm.quant_matmul_norm(x, nw, q, eps),
                cuda_core=lambda x=x, q=q, n=n: qm._launch_group(
                    x, nw, q, eps, "qmm_group_norm", form="cuda_core")[:, :n],
                forms={"tile_alone": lambda xn=xn, q=q, n=n: qm._launch_group(
                    xn, None, q, 0.0, "qmm_group", form="mma")[:, :n]},
                plain=lambda x=x, q=q, n=n: qm.qmm_group_plain(
                    qm.rmsnorm_bf16(x, nw, eps), q)[:, :n],
                library=lambda xn=xn, w=w: torch.matmul(xn, w),
                bytes=sum(t.numel() * t.element_size()
                          for t in (x, nw, q.qweight, q.scales))
                + 2 * rows * q.out_physical,
                ops=2 * rows * cfg.dim * q.out_physical, kind="bf16"))
    return out


def norm_crossover(torch, qm, layer0, cfg, gen, randn, flush):
    """Both forms of qmm_group_norm, forced, at 1, 2, 4 and 8 rows of the
    7B layer's wqkv and w_gateup (ms summed over the two), in one call:
    the times behind MMA_MIN_ROWS for the fused-norm launches. Returns
    {rows: {form: ms}}."""
    nw = (torch.rand(cfg.dim, generator=gen, device=flush.device) + 0.5).to(
        torch.bfloat16)
    out = {}
    for rows in (1, 2, 4, 8):
        out[rows] = {"mma": 0.0, "cuda_core": 0.0}
        for label in ("wqkv", "w_gateup"):
            q, x = layer0[label], randn(rows, cfg.dim) * 3
            for form in ("mma", "cuda_core"):
                out[rows][form] += cuda_ms(
                    torch, lambda x=x, q=q, form=form: qm._launch_group(
                        x, nw, q, cfg.norm_eps, "qmm_group_norm", form=form),
                    50, flush)
    print(f"# qmm_group_norm forms, ms summed over wqkv, w_gateup: "
          f"{json.dumps(out)}; MMA_MIN_ROWS = {qm.MMA_MIN_ROWS}", flush=True)
    return out


G64_SHAPES = ("wqkv", "w_gateup", "wo", "w_down", "lm_head")


def g64_weight(g64, label):
    """The group-64 7B weight `label` (the lm_head, or layer 0's)."""
    return g64[label] if label == "lm_head" else g64["layers"][0][label]


def chunk_mma_cases(torch, qm, g64, randn, dequantize_weight):
    """Phase 3 rows of qmm_chunk's tensor-core form (the route's own call,
    quant_matmul, at group 64) on wqkv, w_gateup, wo, w_down and the
    lm_head at SLOTS, 64 and SHORT rows, each beside the CUDA-core form,
    forced; library: matmul on the dequantized weight. SLOTS rows count
    the launches of phase 9's dense 8-slot step, SHORT rows those of its
    prefill."""
    out = []
    for label in G64_SHAPES:
        q = g64_weight(g64, label)
        w, n = dequantize_weight(q), q.out_features
        for rows, path in ((SLOTS, DENSE_G64), (64, NO_PATH),
                           (SHORT, G64_PROMPT)):
            x = randn(rows, q.in_features)
            out.append(dict(
                name="qmm_chunk_mma", shape=f"g64 {label} {rows} rows",
                path=path, replaces=TPU + "quant_matmul.py:44",
                source=SRC + "quant_matmul_mma.cu",
                kernel=lambda x=x, q=q: qm.quant_matmul(x, q),
                cuda_core=lambda x=x, q=q, n=n: qm._launch_chunk(
                    x, q, form="cuda_core")[:, :n],
                plain=lambda x=x, q=q, n=n: qm.qmm_chunk_plain(x, q)[:, :n],
                library=lambda x=x, w=w: torch.matmul(x, w),
                bytes=sum(t.numel() * t.element_size()
                          for t in (x, q.qweight, q.scales))
                + 2 * rows * q.out_physical,
                ops=2 * rows * q.in_features * q.out_physical, kind="bf16"))
    return out


def norm_w4a8_mma_cases(torch, qm, cfg, layer0, envs, gen, dev, randn,
                        dequantize_weight):
    """Phase 3 rows of qmm_norm_w4a8's tensor-core form (the route's own
    call, quant_matmul_norm under phase 10's knobs) on wqkv and w_gateup
    at SLOTS, 64 and SHORT rows, each beside the CUDA-core form, forced,
    and the int8 tile alone (qmm_w4a8_mma on rows normalized beforehand:
    the form minus it is the pre-pass); library: matmul on the normalized
    rows. No phase's path runs it (the W4A8 knob at many rows)."""
    eps = cfg.norm_eps
    nw = (torch.rand(cfg.dim, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    out = []
    for rows in (SLOTS, 64, SHORT):
        for label in ("wqkv", "w_gateup"):
            q = layer0[label]
            x = randn(rows, cfg.dim) * 3
            xn = qm.rmsnorm_bf16(x, nw, eps)
            w, n = dequantize_weight(q), q.out_features
            out.append(dict(
                name="qmm_norm_w4a8_mma", shape=f"{label} {rows} rows",
                path=NO_PATH, replaces=TPU + "quant_matmul.py:288",
                source=SRC + "quant_matmul_w4a8_mma.cu", env=envs[W4A8],
                kernel=lambda x=x, q=q: qm.quant_matmul_norm(x, nw, q, eps),
                cuda_core=lambda x=x, q=q, n=n: qm._launch_w4a8(
                    x, q, nw, eps, form="cuda_core")[:, :n],
                forms={"tile_alone": lambda xn=xn, q=q, n=n: qm._launch_w4a8(
                    xn, q, form="mma")[:, :n]},
                plain=lambda x=x, q=q, n=n: qm.qmm_norm_w4a8_plain(
                    x, nw, q, eps)[:, :n],
                library=lambda xn=xn, w=w: torch.matmul(xn, w),
                bytes=sum(t.numel() * t.element_size()
                          for t in (x, nw, q.qweight, q.scales))
                + 2 * rows * q.out_physical,
                ops=2 * rows * cfg.dim * q.out_physical, kind="int8"))
    return out


def chunk_crossover(torch, qm, g64, randn, flush):
    """Both forms of qmm_chunk (group 64), forced, at 1, 2, 3 and 4 rows of
    the 7B wqkv, w_gateup, wo, w_down and lm_head (the CUDA-core form in
    the K split group_splits gives it), in one call: the times that set
    qm.CHUNK_MMA_MIN_ROWS (the fewest rows at which the tensor-core
    form's sum over the five is the smaller). Returns {rows: {form: {shape:
    ms, "sum": ms}}}."""
    out = {}
    for rows in (1, 2, 3, 4):
        out[rows] = {"mma": {}, "cuda_core": {}}
        for label in G64_SHAPES:
            q = g64_weight(g64, label)
            x = randn(rows, q.in_features)
            for form in ("mma", "cuda_core"):
                out[rows][form][label] = cuda_ms(
                    torch, lambda x=x, q=q, form=form: qm._launch_chunk(
                        x, q, form=form), 50, flush)
        for form in ("mma", "cuda_core"):
            out[rows][form]["sum"] = sum(out[rows][form].values())
    print(f"# qmm_chunk forms at group 64, ms: {json.dumps(out)}; "
          f"CHUNK_MMA_MIN_ROWS = {qm.CHUNK_MMA_MIN_ROWS}", flush=True)
    return out


def mma_crossover(torch, qm, layer0, randn, flush):
    """Both forms of qmm_group, forced, at 1, 2, 4 and 8 rows of the 7B
    layer's four matmuls, in one call: the times that set
    qm.MMA_MIN_ROWS (the fewest rows at which the tensor-core form's sum
    over the four is the smaller). Returns {rows: {form: ms}}."""
    out = {}
    for rows in (1, 2, 4, 8):
        out[rows] = {"mma": 0.0, "cuda_core": 0.0}
        for label in ("wqkv", "wo", "w_gateup", "w_down"):
            q = layer0[label]
            x = randn(rows, q.in_features)
            for form in ("mma", "cuda_core"):
                out[rows][form] += cuda_ms(
                    torch, lambda x=x, q=q, form=form: qm._launch_group(
                        x, None, q, 0.0, "qmm_group", form=form), 50, flush)
    print(f"# qmm_group forms, ms summed over wqkv, wo, w_gateup, w_down: "
          f"{json.dumps(out)}; MMA_MIN_ROWS = {qm.MMA_MIN_ROWS}", flush=True)
    return out


def decode_crossover(torch, att, gen, dev, flush):
    """The dense INT8-cache decode attention (D 128, pos CTX of MAX_SEQ)
    at B * Hkv = 8, 32, 64, 96, 128, 132, 192, 256 and 1024 heads (GQA
    32/8 at B 1, MHA 32/32 at B 1, 2, 3, 4, 6, 8, 32, and MHA 132/132 at
    B 1, one head an SM of the H100), forced: unsplit, and split in 2, 4, 8, 16 and
    launch_splits's count, the merge included: the times behind
    att.SPLIT_BLOCKS_PER_SM and att.SPLIT_MAX. Returns [{B, H, Hkv,
    chosen, ms: {splits: ms}}]."""
    out = []
    for B, H, Hkv in ((1, 32, 8), (1, 32, 32), (2, 32, 32), (3, 32, 32),
                      (4, 32, 32), (1, 132, 132), (6, 32, 32), (8, 32, 32),
                      (32, 32, 32)):
        S, D = MAX_SEQ, 128
        q = torch.randn(B, H, 1, D, generator=gen, device=dev).to(
            torch.bfloat16)
        kv = [torch.randint(-127, 128, (B, Hkv, S, D), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2)]
        sc = [torch.rand(B, Hkv, S, generator=gen, device=dev) * 0.015
              + 0.005 for _ in range(2)]
        pos = torch.full((B,), CTX, dtype=torch.int32, device=dev)
        chosen = att.launch_splits(B, Hkv, S)
        row = {"B": B, "H": H, "Hkv": Hkv, "chosen": chosen, "ms": {
            n: cuda_ms(torch, lambda n=n: att.flash_decode_q8(
                q, *kv, *sc, pos, _splits=n), 50, flush)
            for n in sorted({1, 2, 4, 8, 16, chosen})}}
        out.append(row)
        del q, kv, sc
    print(f"# decode attention, int8 cache, pos {CTX}: ms by splits "
          f"(1 = unsplit): {json.dumps(out)}", flush=True)
    return out


def merges(cfg, n):
    """The merge launches of n dense decode-attention calls of cfg at
    batch 1."""
    from infinitensor_tpu_torch.kernels import attention as att
    return att.merge_launches(n, 1, cfg.n_kv_heads, cfg.max_seq)


def w4a8_crossover(torch, qm, q, randn, flush):
    """Both forms of qmm_w4a8, forced, at 1-5, 8, 64 and 256 rows of the
    7B lm_head, in one call: the times that set qm.W4A8_MMA_MIN_ROWS (the
    fewest rows from which the tensor-core form is the faster). Returns
    {rows: {form: ms}}."""
    out = {}
    for rows in (1, 2, 3, 4, 5, 8, 64, 256):
        x = randn(rows, q.in_features)
        out[rows] = {form: cuda_ms(
            torch, lambda x=x, form=form: qm._launch_w4a8(x, q, form=form),
            50, flush) for form in ("mma", "cuda_core")}
    print(f"# qmm_w4a8 forms, lm_head ms: {json.dumps(out)}; "
          f"W4A8_MMA_MIN_ROWS = {qm.W4A8_MMA_MIN_ROWS}", flush=True)
    return out


def ln_crossover(torch, qm, glayer0, gcfg, gen, randn, flush):
    """Both forms of qmm_group_ln, forced, at 1, 8 and 64 rows of GPT-2's
    w_qkv and w_up (ms summed over the two), in one call, and the
    tensor-core form's tile alone (qmm_group_mma on rows normalized
    beforehand, no bias): the form minus the tile is what the LayerNorm
    pre-pass and the bias cost. Returns {rows: {form: ms}}."""
    dim, eps = gcfg.dim, gcfg.layer_norm_eps
    g = (torch.rand(dim, generator=gen, device=flush.device) + 0.5).to(
        torch.bfloat16)
    b = (torch.randn(dim, generator=gen, device=flush.device) * 0.1).to(
        torch.bfloat16)
    out = {}
    for rows in (1, 8, 64):
        out[rows] = {"mma": 0.0, "cuda_core": 0.0, "tile_alone": 0.0}
        for wkey, bkey in (("w_qkv", "b_qkv"), ("w_up", "b_up")):
            q, bias = glayer0[wkey], glayer0[bkey]
            x = randn(rows, dim)
            xn = qm.layer_norm(x, g, b, eps)
            for form in ("mma", "cuda_core"):
                out[rows][form] += cuda_ms(
                    torch, lambda x=x, q=q, bias=bias, form=form:
                    qm._launch_group_ln(x, g, b, q, bias, eps, form=form),
                    50, flush)
            out[rows]["tile_alone"] += cuda_ms(
                torch, lambda xn=xn, q=q: qm._launch_group(
                    xn, None, q, 0.0, "qmm_group", form="mma"), 50, flush)
    print(f"# qmm_group_ln forms, ms summed over w_qkv, w_up: "
          f"{json.dumps(out)}; MMA_MIN_ROWS = {qm.MMA_MIN_ROWS}", flush=True)
    return out


def compare_logits_rows(torch, what, got, want, report):
    """compare_logits for a batch [B, vocab]: the worst row's relative
    error <= 5e-2, and every row's top-1 equal or a near-tie within twice
    the measured error."""
    lk, lp = got.float().cpu(), want.float().cpu()
    if lk.shape != lp.shape or not torch.isfinite(lk).all():
        fail(f"{what}: shape {tuple(lk.shape)} vs {tuple(lp.shape)} or "
             "non-finite logits")
    err = (lk - lp).abs().max().item()
    rel = err / lp.abs().max().item()
    top_k, top_p = lk.argmax(-1), lp.argmax(-1)
    gap = lp.gather(1, top_p[:, None]) - lp.gather(1, top_k[:, None])
    differ = int((top_k != top_p).sum())
    print(f"# {what}: rel logit err {rel:.3g}, top-1 differs in {differ} of "
          f"{lk.shape[0]} rows (largest gap {gap.max().item():.3g})",
          flush=True)
    report[what] = {"rel_logit_err": rel, "top1_differ": differ,
                    "largest_gap": gap.max().item()}
    if rel > 5e-2 or bool((gap > 2 * err).any()):
        fail(f"{what}: rel {rel}, top-1 gap {gap.max().item()} vs err {err}")


def gpt2_path(torch, gpt2, sb, counters, gparams, gcfg, dev, report, steps):
    """Phase 7. Returns the launch counts of the serving bench's drain per
    cache type; steps[path] gets one decode step's launches."""
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    B = G_SLOTS
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    prompt = torch.randint(1, 50000, (B, 256), generator=gen, device=dev,
                           dtype=torch.int32)
    token = torch.randint(1, 50000, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    pos = torch.randint(16, 256, (B,), generator=gen, device=dev).to(
        torch.int32)
    cpu_params = to_cpu(gparams)
    prompts = sb.workload(B, seed=SEED)
    n_new = sb.NEW_TOKENS * len(prompts)
    ref_cache = gpt2.init_gpt2_cache(gcfg, 1, device=dev)

    def tie_gap(prefix, a, b):
        toks = torch.tensor([prefix], dtype=torch.int32, device=dev)
        logits, _ = gpt2.gpt2_prefill(gparams, gcfg, toks, ref_cache)
        last = logits[0, -1]
        return abs(float(last[a] - last[b])) / float(last.abs().max())

    def logits_along(tokens):
        toks = torch.tensor([tokens], dtype=torch.int32, device=dev)
        return gpt2.gpt2_prefill(gparams, gcfg, toks, ref_cache)[0][0]

    paths, res = {}, {}
    for label, kv_int8 in ((GPT2_BF16, False), (GPT2_INT8, True)):
        kname = "flash_decode_q8" if kv_int8 else "flash_decode"
        # one decode step at 64 slots after a 256-token prefill: kernels
        # on the card against the plain versions on the CPU
        cache = gpt2.init_gpt2_cache(gcfg, B, kv_quant=kv_int8, device=dev)
        gpt2.gpt2_prefill(gparams, gcfg, prompt, cache)
        cpu_cache = to_cpu(cache)
        counters.reset()
        logits, _ = gpt2.gpt2_decode_step(gparams, gcfg, token, pos, cache)
        torch.cuda.synchronize()
        steps[label] = counters.read()
        want_step = {"qmm_group_ln": 2 * gcfg.n_layers,
                     "qmm_group": 2 * gcfg.n_layers + 1,
                     kname: gcfg.n_layers}
        if B >= qm.MMA_MIN_ROWS:        # w_o, w_down, lm_head at B rows
            want_step["qmm_group_mma"] = 2 * gcfg.n_layers + 1
            want_step["qmm_group_ln_mma"] = 2 * gcfg.n_layers
        if steps[label] != want_step:
            fail(f"{label}: a decode step launched {steps[label]}, expected "
                 f"{want_step}")
        if logits.shape != (B, gcfg.vocab_size) or \
                logits.dtype != torch.float32:
            fail(f"{label}: logits {tuple(logits.shape)} {logits.dtype}")
        t0 = time.perf_counter()
        ref, _ = gpt2.gpt2_decode_step(cpu_params, gcfg, token.cpu(),
                                       pos.cpu(), cpu_cache)
        print(f"# GPT-2 step at {B} slots on the plain versions (CPU): "
              f"{time.perf_counter() - t0:.1f}s")
        compare_logits_rows(torch, f"{label}: 345M step at {B} slots, "
                            "kernels vs plain", logits, ref, report)
        del cache, cpu_cache, logits, ref

        # the main path: the serving bench drains its stream
        os.environ["INFINITPU_GPT2_FUSED_LN"] = "1"
        counters.reset()
        result, got, eng = sb.serve(
            gparams, gcfg, slots=B, chunk=G_CHUNK, pipeline=G_PIPELINE,
            kv_int8=kv_int8, lookahead=True, reps=G_REPS, prompts=prompts,
            device=dev)
        paths[label] = counters.read()
        if not result["all_done"] or len(got) != len(prompts):
            fail(f"{label}: not every request ended with "
                 f"{sb.NEW_TOKENS} tokens")
        if not all(0 <= t < gcfg.vocab_size for g in got for t in g):
            fail(f"{label}: token ids out of range")
        if eng._program.graph is None:
            fail(f"{label}: the decode step was not captured")

        # ms per step with all 64 slots live: the engine's own graph
        tok0 = torch.ones(B, dtype=torch.int32, device=dev)
        pos0 = torch.full((B,), 200, dtype=torch.int32, device=dev)
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._program.run(tok0, pos0, G_CHUNK)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) / G_CHUNK)
        prof = device_profile(
            torch, lambda: eng._program.run(tok0, pos0, G_CHUNK))
        del eng

        # the same stream with the LayerNorm gate off
        os.environ["INFINITPU_GPT2_FUSED_LN"] = "0"
        counters.reset()
        off_result, off, eng = sb.serve(
            gparams, gcfg, slots=B, chunk=G_CHUNK, pipeline=G_PIPELINE,
            kv_int8=kv_int8, lookahead=True, reps=1, prompts=prompts,
            device=dev)
        off_launches = counters.read()
        os.environ["INFINITPU_GPT2_FUSED_LN"] = "1"
        del eng
        if off_launches.get("qmm_group_ln", 0) or not off_result["all_done"]:
            fail(f"{label}: with the gate off qmm_group_ln was launched "
                 f"{off_launches.get('qmm_group_ln', 0)} times")
        ties = same_up_to_ties(f"{label}: fused LayerNorm on vs off", got,
                               off, prompts, tie_gap, G_TIE)
        # every token of the drain against gpt2_prefill (bf16 K/V, no
        # decode kernel) forced along the same history
        forced = teacher_forced(
            torch, f"{label}: the drain vs prefill", got, prompts,
            logits_along, G_FORCED[label])

        # one request against a batch-1 prefill + decode loop
        i = min(range(len(prompts)), key=lambda i: len(prompts[i]))
        cache = gpt2.init_gpt2_cache(gcfg, 1, kv_quant=kv_int8, device=dev)
        lg, _ = gpt2.gpt2_prefill(
            gparams, gcfg, torch.tensor([prompts[i]], dtype=torch.int32,
                                        device=dev), cache)
        tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
        p1 = torch.full((1,), len(prompts[i]), dtype=torch.int32, device=dev)
        solo = [int(tok)]
        for _ in range(sb.NEW_TOKENS - 1):
            lg, _ = gpt2.gpt2_decode_step(gparams, gcfg, tok, p1, cache)
            tok = torch.argmax(lg, -1).to(torch.int32)
            solo.append(int(tok))
            p1 = p1 + 1
        del cache
        solo_ties = same_up_to_ties(f"{label}: request {i} vs batch-1 loop",
                                    [got[i]], [solo], [prompts[i]], tie_gap,
                                    G_TIE)

        stats = result["stats"]
        res[label] = dict(
            result, generated_tokens=n_new,
            prompt_tokens=sum(len(p) for p in prompts),
            mean_live_slots=stats["slot_steps_active"]
            / max(stats["slot_steps_total"] / B, 1),
            decode_ms_per_step_64_live=1e3 * min(samples),
            decode_tok_s_64_live=B / min(samples),
            decode_device_profile_64_live=prof,
            launches=paths[label], launches_per_step=steps[label],
            fused_ln_off={"tok_s": off_result["value"],
                          "launches": off_launches,
                          "equal": len(got) - len(ties), "near_ties": ties},
            teacher_forced_vs_prefill=forced,
            batch1_request=i, near_ties_vs_batch1=solo_ties,
            first_tokens=got[0][:8])
        print(f"# {label}: " + json.dumps(res[label]), flush=True)
    report["gpt2_serving"] = res
    return paths


def gpt2_bs1_path(torch, gpt2, qm, counters, gparams, gcfg, dev, report):
    """Phase 7 at batch 1: GPT-2 345M INT8 decode steps after a seeded
    G_BS1_PROMPT-token prompt, bf16 cache. One eager step launches
    qmm_group_ln 2L times, each in its K split (qmm_group_ln_split 2L, no
    tensor-core form); then the step captured as one CUDA graph with the
    split and with it forced off (qm._SPLITS = 1), each replay timed in
    turns (split, unsplit, split, unsplit; median of 20 CUDA-event
    timings, L2 warm as in decode), and G_BS1_STEPS greedy steps of each
    graph, their tokens equal up to a printed near-tie; a third graph
    forces only the qmm_group_ln launches unsplit (w_o and w_down keep
    qmm_group's split). Returns the eager step's launches."""
    L = gcfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    prompt = torch.randint(1, 50000, (1, G_BS1_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)

    def start():
        cache = gpt2.init_gpt2_cache(gcfg, 1, device=dev)
        logits, _ = gpt2.gpt2_prefill(gparams, gcfg, prompt, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        pos = torch.full((1,), G_BS1_PROMPT, dtype=torch.int32, device=dev)
        return cache, tok, pos

    cache, tok, pos = start()
    counters.reset()
    gpt2.gpt2_decode_step(gparams, gcfg, tok, pos, cache)
    torch.cuda.synchronize()
    step = counters.read()
    if step.get("qmm_group_ln", 0) != 2 * L or \
            step.get("qmm_group_ln_split", 0) != 2 * L or \
            step.get("qmm_group_ln_mma", 0):
        fail(f"{GPT2_BS1}: a step launched {step}; expected qmm_group_ln "
             f"{2 * L}, all of them split")
    launch_ln = qm._launch_group_ln

    def ln_unsplit(*args, **kw):
        qm._SPLITS = 1
        try:
            return launch_ln(*args, **kw)
        finally:
            qm._SPLITS = None

    def captured(splits, ln_only=False):
        """(graph, tok, pos, logits) of one decode step captured with
        qm._SPLITS = splits (ln_only: for the qmm_group_ln launches only),
        from a fresh prefill."""
        if ln_only:
            qm._launch_group_ln = ln_unsplit
        else:
            qm._SPLITS = splits
        try:
            cache, tok, pos = start()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                gpt2.gpt2_decode_step(gparams, gcfg, tok, pos, cache)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                logits, _ = gpt2.gpt2_decode_step(gparams, gcfg, tok, pos,
                                                  cache)
        finally:
            qm._SPLITS = None
            qm._launch_group_ln = launch_ln
        return graph, tok, pos, logits

    # "ln_unsplit": qmm_group_ln unsplit, w_o and w_down still split;
    # "unsplit": every split forced off (qm._SPLITS = 1)
    forms = {"split": captured(None), "ln_unsplit": captured(1, True),
             "unsplit": captured(1)}
    tokens = {}
    for name, (graph, tok, pos, logits) in forms.items():
        got = []
        for _ in range(G_BS1_STEPS):
            graph.replay()
            tok.copy_(torch.argmax(logits, -1).to(torch.int32))
            pos.add_(1)
            got.append(int(tok))
        tokens[name] = got
    ms = {name: [] for name in forms}
    for _ in range(2):
        for name, (graph, *_) in forms.items():
            ms[name].append(cuda_ms(torch, graph.replay, 20))
    ref_cache = gpt2.init_gpt2_cache(gcfg, 1, device=dev)

    def tie_gap(prefix, a, b):
        toks = torch.tensor([prefix], dtype=torch.int32, device=dev)
        last = gpt2.gpt2_prefill(gparams, gcfg, toks, ref_cache)[0][0, -1]
        return abs(float(last[a] - last[b])) / float(last.abs().max())

    ties = {other: same_up_to_ties(
        f"{GPT2_BS1}: split vs {other} graph", [tokens["split"]],
        [tokens[other]], [prompt[0].tolist()], tie_gap, G_TIE)
        for other in ("ln_unsplit", "unsplit")}
    res = {"launches_per_step": step,
           "step_ms": {name: min(v) for name, v in ms.items()},
           "step_ms_in_turns": ms, "tokens": tokens["split"],
           "near_ties": ties}
    print(f"# {GPT2_BS1}: " + json.dumps(res), flush=True)
    report["gpt2_bs1"] = res
    del forms
    return step


def variant_path(torch, llama, counters, params, cfg, dev, report, steps,
                 label, want_step, weight_b, ring_form=None):
    """Phases 8-11: decode_path's checks on other weights or knobs. One
    step must launch exactly want_step; the step of its first CPU_LAYERS
    layers is held against the plain versions on the CPU (under the same
    knobs); 128 graph-replayed steps
    must equal an eager loop; tok/s is the min of 3 graph runs against the
    copy-rate roofline of weight_b + the INT8 cache's bytes per token.
    With ring_form (the form function's
    name, the ring kernels) cuda_core_region, in turns. Returns the launch
    counts of llama_decode_multi; steps[label] gets one decode step's."""
    token = torch.zeros(1, dtype=torch.int32, device=dev)
    pos = torch.full((1,), CTX, dtype=torch.int32, device=dev)
    cache = llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev)

    counters.reset()
    logits, _ = llama.llama_decode_step(params, cfg, token, pos, cache)
    torch.cuda.synchronize()
    steps[label] = counters.read()
    if steps[label] != want_step:
        fail(f"{label}: a decode step launched {steps[label]}, expected "
             f"{want_step}")
    # the first CPU_LAYERS layers' step against the plain versions on the
    # CPU (all 32 took up to a minute a phase on the CPU)
    cut = dataclasses.replace(cfg, n_layers=CPU_LAYERS)
    cut_params = dict(params, layers=params["layers"][:CPU_LAYERS])
    logits, _ = llama.llama_decode_step(
        cut_params, cut, token, pos,
        llama.init_kv_cache(cut, 1, kv_quant=True, device=dev))
    t0 = time.perf_counter()
    ref, _ = llama.llama_decode_step(
        to_cpu(cut_params), cut, token.cpu(), pos.cpu(),
        llama.init_kv_cache(cut, 1, kv_quant=True, device="cpu"))
    what = f"{label}: {CPU_LAYERS}-layer 7B step"
    print(f"# {what} on the plain versions (CPU): "
          f"{time.perf_counter() - t0:.1f}s")
    compare_logits(torch, f"{what}, kernels vs plain", logits[0], ref[0],
                   report)

    # the path: llama_decode_multi under a CUDA graph
    fresh(cache)
    counters.reset()
    toks, last, next_pos, cache = llama.llama_decode_multi(
        params, cfg, token, pos, cache, STEPS)
    torch.cuda.synchronize()
    launches = counters.read()
    for kname in want_step:
        if launches.get(kname, 0) <= 0:
            fail(f"{kname} was never launched on the path {label}")
    if toks.shape != (1, STEPS) or int(next_pos) != CTX + STEPS:
        fail(f"{label}: decode_multi returned {tuple(toks.shape)}, pos "
             f"{next_pos}")
    fresh(cache)
    tok, p, eager = token.clone(), pos.clone(), []
    for _ in range(STEPS):
        lg, cache = llama.llama_decode_step(params, cfg, tok, p, cache)
        tok = torch.argmax(lg, -1).to(torch.int32)
        eager.append(tok)
        p = p + 1
    eager = torch.stack(eager, 1)
    same = (toks == eager)[0].int().cumprod(0).sum().item()
    print(f"# {label}: graph vs eager greedy tokens: first {same} of {STEPS} "
          f"equal; first tokens {toks[0, :8].tolist()}", flush=True)
    if same < STEPS:
        fail(f"{label}: graph and eager tokens differ at step {same}")

    fresh(cache)
    g = llama.DecodeGraph(params, cfg, token, pos, cache, STEPS)
    samples = []
    for _ in range(3):
        fresh(cache)
        g.reset(token, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = g.run()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        if not torch.equal(out, toks):
            fail(f"{label}: a timed graph run gave other tokens")
    dt = min(samples)
    # the card's side of one graph run: busy share, kernel ms a token
    prof = graph_profile(torch, g, cache, token, pos)
    extra = {}
    if ring_form is not None:
        from infinitensor_tpu_torch.kernels import quant_matmul
        extra["cuda_core_forms"] = cuda_core_region(
            torch, llama, quant_matmul, params, cfg, token, pos, cache, g,
            toks, *ring_form, label)
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * CTX * (cfg.head_dim + 4)
    bytes_tok = weight_b + kv_bytes
    res = {**extra,
        "tok_s": STEPS / dt, "ms_per_token": 1e3 * dt / STEPS,
        "tok_s_samples": [STEPS / s for s in samples],
        "unpaired_group128_tok_s": report["tok_s"],
        "bytes_per_token": bytes_tok,
        "roofline_tok_s_copy": report["copy_gbps"] * 1e9 / bytes_tok,
        "roofline_tok_s_published": HBM_BYTES_S / bytes_tok,
        "graph_eager_equal_prefix": same, "launches": launches,
        "launches_per_token": steps[label], "device_profile": prof}
    report[label.replace(" ", "_")] = res
    print(f"# {label} " + json.dumps(res), flush=True)
    return launches


def entry_check(torch, counters, report):
    """The port's entry() once on the card: a decode step of the JAX
    package's entry configuration (dim 512, 4 layers, group 64, batch 2):
    qmm_chunk for every linear but w_down (group 32 dividing no multiple
    of its 688 packed rows: the dequant route), in its tensor-core form
    where chunk_form takes 2 rows, flash_decode_q8 per layer; logits
    against the same step on the plain versions on the CPU."""
    from infinitensor_tpu_torch.entry import entry
    fn, (params, cfg, token, pos, cache) = entry()
    cpu_args = (to_cpu(params), cfg, token.cpu(), pos.cpu(), to_cpu(cache))
    counters.reset()
    logits, _ = fn(params, cfg, token, pos, cache)
    torch.cuda.synchronize()
    got = counters.read()
    L, B = cfg.n_layers, token.shape[0]
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    lay = params["layers"][0]
    # B rows: qmm_chunk's tensor-core form from CHUNK_MMA_MIN_ROWS, else
    # its CUDA-core form, in the K split on these short grids
    chunk = {"qmm_chunk_mma": 3 * L + 1} \
        if qm.chunk_form(B, torch.bfloat16, lay["wo"].group_size) == "mma" \
        else {"qmm_chunk_split": L * split_launches(
            qm, (lay["wqkv"], lay["wo"], lay["w_gateup"]), B)
            + split_launches(qm, (params["lm_head"],), B)}
    want = {"qmm_chunk": 3 * L + 1, **chunk,
            "dequant_matmul": L, "flash_decode_q8": L, **merges(cfg, L)}
    print(f"# entry(): one decode step launched {got}", flush=True)
    report["entry_launches"] = got
    if got != want:
        fail(f"entry(): launched {got}, expected {want}")
    ref, _ = fn(*cpu_args)
    compare_logits_rows(torch, "entry() step, kernels vs plain", logits, ref,
                        report)


def forms_prompt_path(torch, llama, qm, counters, params, cfg, dev, report,
                      label, form_fn, forced, want, seed):
    """Phases 8 and 9 (a): a seeded SHORT-token prefill of `params` whose
    qmm_* launches must be exactly `want` (the matmuls at SHORT rows in
    the forms their route takes); its ms (min of 3 runs) read in turns
    with qm.<form_fn> patched to `forced`, the CUDA-core form: new,
    forced, new; the last-position logits of the two forms held to each
    other up to a printed near-tie. Returns the route's launches of one
    prefill."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (1, SHORT), generator=gen,
                           device=dev, dtype=torch.int32)
    cache = llama.init_kv_cache(cfg, 1, device=dev)
    route = getattr(qm, form_fn)
    counters.reset()
    llama.llama_prefill(params, cfg, prompt, cache)
    torch.cuda.synchronize()
    launches = counters.read()
    other = [k for k in launches if k.startswith("qmm_") and k not in want]
    if other or any(launches.get(k, 0) != v for k, v in want.items()):
        fail(f"{label}: a prefill launched {launches}, expected {want}")
    ms, last = {"route": [], "cuda_core": []}, {}
    for form in ("route", "cuda_core", "route"):
        if form == "cuda_core":
            setattr(qm, form_fn, forced)
        try:
            s, logits = time_prefill(torch, llama, params, cfg, prompt, cache)
        finally:
            setattr(qm, form_fn, route)
        ms[form].append(1e3 * s)
        last[form] = logits[0, -1].float()
    what = f"{label}: tensor-core vs CUDA-core forms, last logits"
    rel, top_new, top_old = compare_logits(torch, what, last["route"],
                                           last["cuda_core"], report)
    old = last["cuda_core"]
    gap = float(old[top_old] - old[top_new]) / float(old.abs().max())
    out = {"prefill_ms": {f: min(v) for f, v in ms.items()},
           "prefill_ms_in_turns": ms, "launches_per_prompt": launches,
           "rel_logit_err": rel, "top1": [top_new, top_old],
           "near_tie_gap": gap}
    print(f"# {label}: " + json.dumps(out), flush=True)
    report[label.replace(" ", "_")] = out
    return launches


def forms_dense_path(torch, llama, qm, counters, params, cfg, dev, report,
                     label, form_fn, forced, want, kname):
    """Phases 8 and 9 (b): the dense ServingEngine over `params` (SLOTS
    slots, INT8 cache): one eager step at SLOTS rows must launch `want`
    (each name's count exactly); then dense_forms with qm.<form_fn>
    patched to `forced`, the CUDA-core form, kname the tensor-core kernel
    the route's capture launches (where want has it) and the forced one
    must not. Returns (one step's launches, dense_forms' result)."""
    from infinitensor_tpu_torch.serving import ServingEngine
    dense = ServingEngine(params, cfg, max_slots=SLOTS,
                          prefill_buckets=BUCKETS, decode_chunk=CHUNK,
                          kv_quant=True)
    tok0 = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    pos0 = torch.full((SLOTS,), 640, dtype=torch.int32, device=dev)
    counters.reset()
    llama.llama_decode_step(params, cfg, tok0, pos0, dense.cache)
    torch.cuda.synchronize()
    step = counters.read()
    for k, n in want.items():
        if step.get(k, 0) != n:
            fail(f"{label}: a decode step launched {k} {step.get(k, 0)} "
                 f"times, expected {n}")
    forms = dense_forms(
        torch, qm, dense, cfg, dev,
        prefill_tie_gap(torch, llama, params, cfg, dev), label=label,
        form_fn=form_fn, forced=forced, kname=kname,
        route_mma=want.get(kname, 0) > 0)
    del dense
    return step, forms


def split_kb(q, sms=132):
    """The split of qmm_group2d for q: the largest kb (a multiple of the
    group dividing the packed rows, below them) whose grid of 128-column
    tiles x packed rows / kb blocks still covers `sms`; else the smallest."""
    kr, g = q.qweight.shape[0], q.group_size
    tiles = -(-q.out_physical // 128)
    cands = [kb for kb in range(g, kr, g) if kr % kb == 0]
    fill = [kb for kb in cands if tiles * (kr // kb) >= sms]
    return max(fill) if fill else min(cands)


def variant_envs(qm, build, cfg, params):
    """The knobs of phases 10 and 11, written under build/: an empty tuning
    table for W4A8 under INFINITPU_QMM_VARIANT, and a copy of the port's
    table whose wo and w_down entries read group2d with split_kb's kb (in
    the form tools/qmm_tune.py writes). Returns ({label: env}, kbs)."""
    layer = params["layers"][0]
    kbs = {"wo": split_kb(layer["wo"]), "w_down": split_kb(layer["w_down"])}
    with open(qm.TUNE_DEFAULT) as f:
        table = json.load(f)
    table[f"{cfg.dim}:{cfg.dim}:4"] = {"variant": "group2d", "bn": 1024,
                                       "kb": kbs["wo"]}
    table[f"{cfg.intermediate}:{cfg.dim}:4"] = {
        "variant": "group2d", "bn": 1024, "kb": kbs["w_down"]}
    out = build.BUILD_ROOT / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    (out / "qmm_tune_empty.json").write_text("{}")
    (out / "qmm_tune_split.json").write_text(json.dumps(table, indent=1))
    return {W4A8: {"INFINITPU_QMM_VARIANT": "w4a8",
                   "INFINITPU_QMM_TUNE": str(out / "qmm_tune_empty.json")},
            SPLIT: {"INFINITPU_QMM_VARIANT": None,
                    "INFINITPU_QMM_TUNE": str(out / "qmm_tune_split.json")}
            }, kbs


def variant_cases(torch, qm, cfg, g64, params, envs, kbs, randn,
                  dequantize_weight):
    """Phase 3 rows of the kernels of phases 9-11 at the 7B shapes:
    qmm_chunk (group 64) on wqkv, w_gateup, wo, w_down and the lm_head and
    qmm_norm_w4a8 (under phase 10's knobs) on wqkv and w_gateup, at 1 and
    SLOTS rows, in their CUDA-core forms (at SLOTS rows forced: the route
    takes the tensor-core forms there, chunk_mma_cases and
    norm_w4a8_mma_cases; at 1 row forced: the route takes the ring form,
    w4a8_ring_cases); qmm_group2d (under phase 11's) on wo and w_down at 1
    row."""
    eps = cfg.norm_eps

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def row(name, label, rows, path, q, kernel, plain, library, extra=(),
            env=None):
        return dict(
            name=name, shape=label if rows == 1 else f"{label} {rows} rows",
            path=path, kernel=kernel, plain=plain, library=library,
            env=env or {},
            source=SRC + ("quant_matmul.cu" if name == "qmm_norm_w4a8"
                          else "quant_matmul_chunk.cu"),
            replaces=TPU + {"qmm_chunk": "quant_matmul.py:44",
                            "qmm_norm_w4a8": "quant_matmul.py:288",
                            "qmm_group2d": "quant_matmul.py:404"}[name],
            bytes=nbytes(q.qweight, q.scales, *extra)
            + 2 * rows * (q.in_features + q.out_physical),
            ops=2 * rows * q.in_features * q.out_physical,
            kind="int8" if name == "qmm_norm_w4a8" else "bf16")

    out = []
    lay64, layer = g64["layers"][0], params["layers"][0]
    for rows in (1, SLOTS):
        for label in ("wqkv", "w_gateup", "wo", "w_down", "lm_head"):
            q = g64[label] if label == "lm_head" else lay64[label]
            x, w = randn(rows, q.in_features), dequantize_weight(q)
            c = row(
                "qmm_chunk", f"g64 {label}", rows, G64, q,
                (lambda x=x, q=q: qm.quant_matmul(x, q)) if rows == 1 else
                (lambda x=x, q=q: qm._launch_chunk(x, q, form="cuda_core")[
                    :, :q.out_features]),
                lambda x=x, q=q: qm.qmm_chunk_plain(x, q)[:, :q.out_features],
                lambda x=x, w=w: torch.matmul(x, w))
            if split_launches(qm, (q,), rows):      # beside the old form
                c["forms"] = {"unsplit": unsplit(
                    qm, lambda x=x, q=q: qm.quant_matmul(x, q))}
            out.append(c)
        for label in ("wqkv", "w_gateup"):
            q = layer[label]
            x = randn(rows, cfg.dim)
            nw = (randn(cfg.dim).float() * 0.1 + 1.0).to(torch.bfloat16)
            xn, w = qm.rmsnorm_bf16(x, nw, eps), dequantize_weight(q)
            out.append(row(
                "qmm_norm_w4a8", label, rows, W4A8 if rows > 1 else NO_PATH,
                q, lambda x=x, nw=nw, q=q: qm._launch_w4a8(
                    x, q, nw, eps, form="cuda_core")[:, :q.out_features],
                lambda x=x, nw=nw, q=q: qm.qmm_norm_w4a8_plain(
                    x, nw, q, eps)[:, :q.out_features],
                lambda xn=xn, w=w: torch.matmul(xn, w), extra=(nw,),
                env=envs[W4A8]))
    out += w4a8_ring_cases(torch, qm, cfg, params, envs, randn,
                           dequantize_weight)
    out += group2d_ring_cases(torch, qm, params, envs, kbs, randn,
                              dequantize_weight, row)
    return out


def group2d_ring_cases(torch, qm, params, envs, kbs, randn,
                       dequantize_weight, row):
    """Phase 3 rows of qmm_group2d under phase 11's table (variant_cases'
    row): at one row its ring form (the route's, row 13c: qmm_group2d_ring,
    one launch) on wo and w_down with a bf16 x beside the two-launch split
    at the table's kb, forced, within one bf16 ulp of it and of the plain
    version, both also back to back over the 32 layers' copies in one CUDA
    graph, and with an f16 and an f32 x (within one f16 ulp, 1e-5, of
    max|plain|); the two-launch split, a row of its own (no path takes it
    at one row)."""
    out, layers = [], params["layers"]
    for label in ("wo", "w_down"):
        q, kb = layers[0][label], kbs[label]
        w, n = dequantize_weight(q), q.out_features

        def split(q, x, kb=kb, n=n):
            return qm._launch_group2d(x, q, kb, form="cuda_core")[:, :n]

        for xdt in (torch.bfloat16, torch.float16, torch.float32):
            x = randn(1, q.in_features).to(xdt)
            tag = {torch.float16: " f16 x", torch.float32: " f32 x"}
            c = row("qmm_group2d", f"{label} kb {kb}{tag.get(xdt, '')}",
                    1, SPLIT, q, lambda x=x, q=q: qm.quant_matmul(x, q),
                    lambda x=x, q=q, kb=kb, n=n: qm.qmm_group2d_plain(
                        x, q, kb)[:, :n],
                    lambda x=x, w=w.to(xdt): torch.matmul(x, w),
                    env=envs[SPLIT])
            c.update(name="qmm_group2d_ring",
                     source=SRC + "quant_matmul_ring.cu",
                     bytes=c["bytes"] + (x.element_size() - 2) * (
                         q.in_features + q.out_physical),
                     kind="f32" if xdt == torch.float32 else "bf16",
                     ulp={torch.bfloat16: 8, torch.float16: 11}.get(xdt),
                     tol=1e-5)
            if xdt == torch.bfloat16:
                xb = x
                c.update(cuda_core=lambda q=q, x=x: split(q, x),
                         graph_weights=[lay[label] for lay in layers],
                         graph={"ring": lambda q, x=x: qm.quant_matmul(x, q),
                                "split": lambda q, x=x: split(q, x)})
            out.append(c)
        out.append(row(
            "qmm_group2d", f"{label} kb {kb}", 1, NO_PATH, q,
            lambda q=q, x=xb: split(q, x),
            lambda x=xb, q=q, kb=kb, n=n: qm.qmm_group2d_plain(
                x, q, kb)[:, :n],
            lambda x=xb, w=w: torch.matmul(x, w), env=envs[SPLIT]))
    return out


def w4a8_ring_cases(torch, qm, cfg, params, envs, randn, dequantize_weight):
    """Phase 3 rows of the W4A8 pair's one-row ring forms under phase 10's
    knobs (quant_matmul_w4a8_ring.cu): qmm_norm_w4a8_ring on wqkv and
    w_gateup, qmm_w4a8_ring on wo and w_down (the lm_head's row is phase
    4's), each the route's call beside its CUDA-core form, forced, within
    one bf16 ulp of it and of the plain version, also back to back over the
    32 layers' copies in one CUDA graph; and qmm_w4a8's CUDA-core form on
    wo and w_down, a row of its own (no path takes it at one row)."""
    eps, layers = cfg.norm_eps, params["layers"]

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = []
    for label in ("wqkv", "w_gateup", "wo", "w_down"):
        q = layers[0][label]
        norm = label in ("wqkv", "w_gateup")
        x, w = randn(1, q.in_features), dequantize_weight(q)
        nw = (randn(q.in_features).float() * 0.1 + 1.0).to(torch.bfloat16) \
            if norm else None
        xn = qm.rmsnorm_bf16(x, nw, eps) if norm else x
        n = q.out_features
        name = "qmm_norm_w4a8" if norm else "qmm_w4a8"
        if norm:
            def ring(q, x=x, nw=nw):
                return qm.quant_matmul_norm(x, nw, q, eps)
            plain = lambda x=x, nw=nw, q=q, n=n: qm.qmm_norm_w4a8_plain(  # noqa
                x, nw, q, eps)[:, :n]
        else:
            def ring(q, x=x):
                return qm.quant_matmul(x, q)
            plain = lambda x=x, q=q, n=n: qm.qmm_w4a8_plain(x, q)[:, :n]  # noqa

        def core(q, x=x, nw=nw, n=n):
            return qm._launch_w4a8(x, q, nw, eps, form="cuda_core")[:, :n]

        row = dict(
            shape=label, env=envs[W4A8], ulp=True, plain=plain,
            replaces=TPU + ("quant_matmul.py:288" if norm
                            else "quant_matmul.py:283"),
            library=lambda xn=xn, w=w: torch.matmul(xn, w),
            bytes=nbytes(x, q.qweight, q.scales, *((nw,) if norm else ()))
            + 2 * q.out_physical,
            ops=2 * q.in_features * q.out_physical, kind="int8")
        out.append(dict(
            row, name=name + "_ring", path=W4A8,
            source=SRC + "quant_matmul_w4a8_ring.cu",
            kernel=lambda q=q, f=ring: f(q),
            cuda_core=lambda q=q, f=core: f(q),
            graph_weights=[lay[label] for lay in layers],
            graph={"ring": ring, "cuda_core": core}))
        if not norm:        # the norm's CUDA-core row is variant_cases'
            out.append(dict(
                row, name=name, path=NO_PATH, source=SRC + "quant_matmul.cu",
                kernel=lambda q=q, f=core: f(q)))
    return out


# -- the graph slice: phase 3 rows, phase 12 (graph-built 7B decode and ----
# -- its serving adapter), phase 13 (Longformer band attention) -------------

GRAPH = "graph decode"
GRAPH_SERVE = "graph serving"
LONG_F32, LONG_BF16 = "longformer f32", "longformer bf16"
ENTRY_PROMPT = "entry prompt"
ENTRY_PROMPT_SHAPE = (2, 8, 64, 64)    # entry()'s batch, heads, prompt, D
LF = dict(batch=1, heads=8, seq=2048, head_dim=128, w=64)  # rewrite_speedup
LF_BASE = dict(batch=1, heads=12, seq=4096, head_dim=64, w=256)
LF_TOL = {LONG_F32: 1e-4, LONG_BF16: 4e-2}     # of max|f64 dense|
G_REQUESTS = 6              # phase 12's serving adapter: requests
G_PROMPT = 32               # ... of up to 32 prompt tokens (one bucket)
G_NEW = 16                  # ... and 16 new tokens


def band_inputs(torch, shape, dtype, gen, dev):
    """q, k, v [batch * heads, seq, head_dim] (normal * 0.5) and softmax
    band weights [batch * heads, seq, 2w + 1], seeded, in `dtype`."""
    bz, S, D, w = (shape["batch"] * shape["heads"], shape["seq"],
                   shape["head_dim"], shape["w"])
    q, k, v = (torch.randn(bz, S, D, generator=gen, device=dev) * 0.5
               for _ in range(3))
    wts = torch.softmax(torch.randn(bz, S, 2 * w + 1, generator=gen,
                                    device=dev), -1)
    return [t.to(dtype) for t in (q, k, v, wts)]


def band_pairs(S, w):
    """(i, j) pairs of a band of one-sided width w inside [0, S)."""
    return S * (2 * w + 1) - w * (w + 1)


def graph_cases(torch, norms, band, fa, cfg, gen, dev, randn):
    """Phase 3 rows of the graph slice's kernels: rmsnorm at 1, 8, 64,
    256, 1024 and 4096 rows of 4096 in bf16 and in f32 (within 1e-5 of
    max|plain|) (library: torch's rms_norm); g2bmm and gbmm at the
    phase 13 shape (f32 and bf16) and at Longformer-base's attention
    (allenai/longformer-base-4096: 12 heads of 64, one-sided window 256, S
    4096; bf16), within 1e-5 of max|plain| in f32, library the gather +
    einsum form: the route's form (the ring, csrc/band_ring.cu, named
    <op>_ring) beside the old form (csrc/band.cu) forced, which keeps a
    row of its own (no path takes it at these shapes); flash_attention at
    D 64 at the shape the entry-prompt path gives it (q, k, v [2, 8, 64,
    64])."""
    cases = []
    rms = getattr(torch.nn.functional, "rms_norm", None)
    w_norm = (torch.rand(cfg.dim, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    paths = {1: GRAPH, SLOTS: GRAPH_SERVE}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for rows in (1, SLOTS, 64, 256, 1024, 4096):
            x = (randn(rows, cfg.dim) * 3).to(dt)
            cases.append(dict(
                name="rmsnorm", shape=f"{rows}x{cfg.dim} {tag}",
                path=paths.get(rows, NO_PATH) if tag == "bf16" else NO_PATH,
                replaces=TPU + "norms.py:27", source=SRC + "rmsnorm.cu",
                kernel=lambda x=x: norms.rmsnorm(x, w_norm, cfg.norm_eps),
                plain=lambda x=x: norms.rmsnorm_plain(x, w_norm,
                                                      cfg.norm_eps),
                library=None if rms is None else lambda x=x: rms(
                    x, (cfg.dim,), w_norm.to(x.dtype), cfg.norm_eps),
                bytes=2 * x.element_size() * rows * cfg.dim + 2 * cfg.dim,
                ops=4 * rows * cfg.dim, kind="f32",
                tol=TOL if tag == "bf16" else 1e-5))
    for label, shape, dtype, path, also in (
            ("phase 13", LF, torch.float32, LONG_F32, [SEARCH_F32]),
            ("phase 13", LF, torch.bfloat16, LONG_BF16, [SEARCH_BF16]),
            ("longformer-base", LF_BASE, torch.bfloat16, LONG_BF16, [])):
        q, k, v, wts = band_inputs(torch, shape, dtype, gen, dev)
        bz, S, D = q.shape
        w = shape["w"]
        el = q.element_size()
        idx = (torch.arange(S, device=dev)[:, None]
               + torch.arange(-w, w + 1, device=dev)[None, :])
        valid = (idx >= 0) & (idx < S)
        idx = idx.clamp(0, S - 1)
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        tag = f"{label} {bz}x{S}x{D} w{w} {kind}"
        pairs = bz * band_pairs(S, w)
        form = band.band_form(dtype, dtype, D)
        for name, op, first, b, plain, library, line in (
                ("g2bmm", band.g2bmm_band, q, k, band.g2bmm_plain,
                 lambda q=q, k=k, idx=idx, valid=valid: torch.where(
                     valid, torch.einsum("bmk,bmnk->bmn", q, k[:, idx]), 0),
                 44),
                ("gbmm", band.gbmm_band, wts, v, band.gbmm_plain,
                 lambda wts=wts, v=v, idx=idx, valid=valid: torch.einsum(
                     "bmn,bmnk->bmk", torch.where(valid, wts, 0), v[:, idx]),
                 68)):
            row = dict(
                shape=tag, replaces=TPU + f"band.py:{line}",
                plain=lambda f=first, b=b, w=w, pl=plain: pl(f, b, w),
                library=library,
                bytes=el * (2 * bz * S * D + bz * S * (2 * w + 1)),
                ops=2 * pairs * D, kind=kind,
                tol=1e-5 if dtype == torch.float32 else TOL)
            old = lambda f=first, b=b, w=w, op=op: op(  # noqa: E731
                f, b, w, form="simt")
            if form == "ring":
                cases.append(dict(
                    row, name=name + "_ring", path=path, also_paths=also,
                    source=SRC + "band_ring.cu",
                    kernel=lambda f=first, b=b, w=w, op=op: op(f, b, w),
                    forms={"simt": old}))
            cases.append(dict(
                row, name=name, path=path if form == "simt" else NO_PATH,
                source=SRC + "band.cu", kernel=old))
    B, H, S, D = ENTRY_PROMPT_SHAPE
    qa, ka, va = (randn(B, H, S, D) for _ in range(3))
    cases.append(dict(
        name="flash_attention", shape=f"causal {B}x{H}x{S}x{D}",
        path=ENTRY_PROMPT, replaces=TPU + "flash_attention.py:37",
        source=SRC + "flash_attention.cu",
        kernel=lambda: fa.flash_attention(qa, ka, va, causal=True),
        plain=lambda: fa.mha_plain(qa, ka, va, causal=True),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qa, ka, va, is_causal=True),
        bytes=4 * 2 * qa.numel(), ops=4 * B * H * (S * (S + 1) // 2) * D,
        kind="bf16"))
    return cases


def entry_prompt_check(torch, llama, counters, report):
    """flash_attention at head dim 64 on a path: greedy_generate on
    entry()'s model (dim 512, 8 heads of 64, INT4 at group 64) from a
    seeded 64-token prompt with the bf16 cache (its matmuls qmm_chunk at
    128 and 2 rows, counted exactly); its prefill logits held against the
    plain versions on the CPU. Returns the path's launches."""
    from infinitensor_tpu_torch.entry import entry
    _, (params, cfg, _, _, _) = entry()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    B, H, S, D = ENTRY_PROMPT_SHAPE
    if (B, H, D) != (2, cfg.n_heads, cfg.dim // cfg.n_heads):
        fail(f"{ENTRY_PROMPT}: entry()'s model no longer gives "
             f"flash_attention {ENTRY_PROMPT_SHAPE}")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    counters.reset()
    toks, _ = llama.greedy_generate(params, cfg, prompt, 8)
    torch.cuda.synchronize()
    launches = counters.read()
    print(f"# {ENTRY_PROMPT}: greedy_generate launched {launches}; first "
          f"tokens {toks[0].tolist()}", flush=True)
    if launches.get("flash_attention", 0) != cfg.n_layers:
        fail(f"{ENTRY_PROMPT}: flash_attention launched "
             f"{launches.get('flash_attention', 0)} times")
    # the prefill at B * S rows, then the decode graph's warm-up and
    # capture at B rows: 3 L + 1 qmm_chunk launches each (w_down takes the
    # dequant route), in the tensor-core form where chunk_form says so
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    n, group = 3 * cfg.n_layers + 1, params["lm_head"].group_size
    want = {"qmm_chunk": 3 * n, "qmm_chunk_mma": n * sum(
        qm.chunk_form(rows, torch.bfloat16, group) == "mma"
        for rows in (B * S, B, B))}
    for kname, k in want.items():
        if launches.get(kname, 0) != k:
            fail(f"{ENTRY_PROMPT}: {kname} launched "
                 f"{launches.get(kname, 0)} times, expected {k}")
    got, _ = llama.llama_prefill(params, cfg, prompt,
                                 llama.init_kv_cache(cfg, 2, device="cuda"))
    want, _ = llama.llama_prefill(to_cpu(params), cfg, prompt.cpu(),
                                  llama.init_kv_cache(cfg, 2, device="cpu"))
    compare_logits_rows(torch, f"{ENTRY_PROMPT}: prefill, kernels vs plain",
                        got[:, -1], want[:, -1], report)
    report["entry_prompt_launches"] = launches
    return launches


def graph_requests(np, cfg):
    """G_REQUESTS seeded prompts of 8-32 tokens for phase 12's serving."""
    rng = np.random.default_rng(SEED + 12)
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(8, G_PROMPT + 1, G_REQUESTS)]


def graph_path(torch, llama, graph_llama, GraphExecutor, counters, params,
               cfg, dev, report, steps):
    """Phase 12: the 7B INT4 + INT8-KV decode built through the graph IR
    (build_llama_decoder over the phase 4 weights, bound without a copy).
    One eager step's launches and its logits against llama_decode_step;
    128 eager graph steps; 128 steps of make_fused_greedy_decode (one
    CUDA graph) equal to them and to phase 4's tokens up to a printed
    near-tie; tok/s beside phase 4's; then GraphLlamaServingAdapter under
    ServingEngine at 7B width, 2 layers, against the dense engine.
    Returns {path: launches}."""
    import numpy as np
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    from infinitensor_tpu_torch.serving import ServingEngine

    L = cfg.n_layers
    t0 = time.perf_counter()
    dec = graph_llama.build_llama_decoder(params, cfg, batch=1,
                                          max_seq=MAX_SEQ, kv_quant=True,
                                          external_weights=True)
    build_s = time.perf_counter() - t0
    eager = GraphExecutor(dec.graph, device=dev, use_cuda_graph=False)
    graph_llama.bind_llama_weights(dec, eager, params)
    if eager.bound_weights()["l0.wqkv.qweight"].data_ptr() != \
            params["layers"][0]["wqkv"].qweight.data_ptr():
        fail(f"{GRAPH}: bind_llama_weights copied the weights")
    token = torch.zeros(1, dtype=torch.int32, device=dev)
    pos = torch.full((1,), CTX, dtype=torch.int32, device=dev)
    feed = lambda tok, p: {dec.token_name: tok, dec.pos_name: p}  # noqa

    # one step: launches, and the logits against the hand-written step
    step = eager.stepper(dec.state_map())
    counters.reset()
    out = step(feed(token, pos))
    torch.cuda.synchronize()
    per_step = counters.read()
    steps[GRAPH] = per_step
    layer0 = params["layers"][0]
    want = {"qmm_group_norm": 2 * L, "qmm_group_norm_ring": 2 * L,
            "qmm_group": 2 * L, "qmm_w4a8": 1, "qmm_w4a8_ring": 1,
            "qmm_group_split": L * split_launches(
                qm, (layer0["wo"], layer0["w_down"])),
            "flash_decode_q8": L, "rmsnorm": 1, **merges(cfg, L)}
    print(f"# {GRAPH}: {len(dec.graph.operators)} ops built in "
          f"{build_s:.2f}s; one step launched {per_step}", flush=True)
    if per_step != want:
        fail(f"{GRAPH}: one step launched {per_step}, expected {want}")
    ref, _ = llama.llama_decode_step(
        params, cfg, token, pos,
        llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev))
    compare_logits(torch, f"{GRAPH}: step vs hand-written llama_decode_step",
                   out[dec.logits_name][0], ref[0], report)

    # 128 eager steps (the stepper, uncaptured), logits kept
    step = eager.stepper(dec.state_map())
    tok, eager_toks, eager_logits = token, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(STEPS):
        lg = step(feed(tok, pos + j))[dec.logits_name]
        tok = torch.argmax(lg, -1).to(torch.int32)
        eager_toks.append(tok)
        eager_logits.append(lg[0])
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    eager_toks = torch.stack(eager_toks, 1)

    # the main path: 128 steps in one captured graph
    ex = GraphExecutor(dec.graph, device=dev)
    graph_llama.bind_llama_weights(dec, ex, params)
    fn, weights, state = graph_llama.make_fused_greedy_decode(dec, ex,
                                                              multi=STEPS)
    counters.reset()
    t0 = time.perf_counter()
    toks, state = fn(weights, token, pos, state)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches = counters.read()
    for kname in want:
        if launches.get(kname, 0) <= 0:
            fail(f"{kname} was never launched on the path {GRAPH}")
    if not torch.equal(toks, eager_toks):
        same = (toks == eager_toks)[0].int().cumprod(0).sum().item()
        fail(f"{GRAPH}: captured and eager graph tokens differ at {same}")
    # against phase 4's hand-written tokens, up to a near-tie
    hand = report["decode_tokens"]
    got = toks[0].tolist()
    j = next((i for i, (a, b) in enumerate(zip(got, hand)) if a != b), None)
    tie = None
    if j is not None:
        lg = eager_logits[j].float()
        tie = float(lg[got[j]] - lg[hand[j]]) / float(lg.abs().max())
        print(f"# {GRAPH}: graph tokens part from the hand-written ones at "
              f"step {j} ({got[j]} vs {hand[j]}), a near-tie: logit gap "
              f"{tie:.3g} of max|logit| (limit {TIE})", flush=True)
        if tie > TIE:
            fail(f"{GRAPH}: token {j} differs by {tie} of max|logit|")
    samples = []
    for _ in range(3):
        for t in state.values():
            t.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, state = fn(weights, token, pos, state)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        if not torch.equal(again, toks):
            fail(f"{GRAPH}: a timed run gave other tokens")
    for t in state.values():
        t.zero_()
    prof = device_profile(torch, lambda: fn(weights, token, pos, state))
    if prof:
        prof["kernel_ms_per_token"] = {
            k: v / STEPS for k, v in prof.pop("kernel_ms").items()}
    dt = min(samples)
    res = {"ops": len(dec.graph.operators), "build_s": build_s,
           "tok_s": STEPS / dt, "ms_per_token": 1e3 * dt / STEPS,
           "tok_s_samples": [STEPS / s for s in samples],
           "hand_written_tok_s": report["tok_s"],
           "eager_ms_per_step": eager_ms, "capture_s": capture_s,
           "equal_to_hand_written_prefix": len(got) if j is None else j,
           "near_tie_gap": tie, "launches": launches,
           "launches_per_step": per_step, "device_profile": prof,
           "first_tokens": got[:8]}
    report["graph_decode"] = res
    print(f"# {GRAPH} " + json.dumps(res), flush=True)
    del fn, state, ex, step, eager

    # the serving adapter at 7B width, 2 layers, against the dense engine
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = dict(params, layers=params["layers"][:2])
    prompts = graph_requests(np, cfg)
    ref_cache = llama.init_kv_cache(cfg2, 1, kv_quant=True, device=dev)

    def tie_gap(prefix, a, b):
        toks = torch.tensor([prefix], dtype=torch.int32, device=dev)
        logits, _ = llama.llama_prefill(params2, cfg2, toks, ref_cache)
        last = logits[0, -1].float()
        return abs(float(last[a] - last[b])) / float(last.abs().max())

    def drain(eng):
        hs = [eng.submit(p, max_new_tokens=G_NEW, uid=i)
              for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_to_completion()
        torch.cuda.synchronize()
        for h in hs:
            if not h.done or len(h.generated) != G_NEW:
                fail(f"{GRAPH_SERVE}: request {h.uid} unfinished")
        return [list(h.generated) for h in hs], time.perf_counter() - t0

    ad = graph_llama.GraphLlamaServingAdapter(params2, cfg2, kv_quant=True)
    eng = ServingEngine(params2, cfg2, max_slots=SLOTS,
                        prefill_buckets=(G_PROMPT,),
                        prefill_fn=ad.prefill_fn, decode_fn=ad.decode_fn,
                        init_cache_fn=ad.init_cache_fn)
    counters.reset()
    got, took = drain(eng)
    serve_launches = counters.read()
    if eng._program.graph is None:
        fail(f"{GRAPH_SERVE}: the decode step was not captured")
    for kname in ("rmsnorm", "qmm_group_norm", "flash_decode_q8"):
        if serve_launches.get(kname, 0) <= 0:
            fail(f"{kname} was never launched on the path {GRAPH_SERVE}")
    del eng
    dense = ServingEngine(params2, cfg2, max_slots=SLOTS,
                          prefill_buckets=(G_PROMPT,), kv_quant=True)
    want_toks, dense_s = drain(dense)
    del dense
    ties = same_up_to_ties(f"{GRAPH_SERVE} vs the dense engine", got,
                           want_toks, prompts, tie_gap)
    report["graph_serving"] = {
        "requests": G_REQUESTS, "new_tokens": G_NEW, "drain_s": took,
        "dense_drain_s": dense_s, "launches": serve_launches,
        "equal_to_dense": G_REQUESTS - len(ties), "near_ties": ties}
    print(f"# {GRAPH_SERVE}: " + json.dumps(report["graph_serving"]),
          flush=True)
    return {GRAPH: launches, GRAPH_SERVE: serve_launches}


def longformer_path(torch, GraphHandler, DataType, GraphExecutor, band,
                    counters, dev, report, steps):
    """Phase 13: the Longformer block of tools/rewrite_speedup.py:164-170
    (batch 1, 8 heads, S 2048, head dim 128, w 64) in the band form the
    JAX package's band mutator makes (optimizer/mutator.py:177-260), built
    directly through GraphHandler: G2BMM -> Mul(1/sqrt(D)) -> Add(the
    edge mask: -1e9 on the band columns outside [0, S)) -> Softmax -> GBMM,
    in f32 and in bf16, against the dense masked S x S attention in plain
    torch in f64 on the same rounded inputs (and in f32, printed, with the
    share of elements that equal it bit for bit); the check must fail on
    an input with one row of v moved. One eager run launches the ring
    form of g2bmm and gbmm once each. The captured block's ms is read in
    turns with the same block captured with band.band_form patched to the
    old form (6 pairs of single runs; held to the same limit). Returns
    {path: launches}."""
    B, H, S, D, W = (LF["batch"], LF["heads"], LF["seq"], LF["head_dim"],
                     LF["w"])
    bz = B * H
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    q, k, v = (torch.randn(bz, S, D, generator=gen, device=dev) * 0.5
               for _ in range(3))
    i = torch.arange(S, device=dev)
    jj = i[:, None] + torch.arange(-W, W + 1, device=dev)[None, :]
    edge = torch.where((jj < 0) | (jj >= S), -1e9, 0.0)
    dense_mask = (i[:, None] - i[None, :]).abs() <= W

    def dense(q, k, v):
        sc = torch.einsum("bid,bjd->bij", q, k) / math.sqrt(D)
        return torch.softmax(torch.where(dense_mask, sc, -math.inf), -1) @ v

    paths, res = {}, {}
    for label, dt in ((LONG_F32, torch.float32), (LONG_BF16, torch.bfloat16)):
        act = DataType.from_torch(dt)
        h = GraphHandler(name="longformer_band")
        qi, ki, vi = (h.input((bz, S, D), dtype=act, name=n)
                      for n in ("q", "k", "v"))
        scale = h.weight_placeholder((1,), act, name="scale")
        mask = h.weight_placeholder((S, 2 * W + 1), act, name="edge_mask")
        scores = h.g2bmm(qi, ki, width=W)
        probs = h.softmax(h.add(h.mul(scores, scale), mask), axis=-1)
        h.gbmm(probs, vi)
        h.graph.infer_output_roles()
        feeds = {"q": q.to(dt), "k": k.to(dt), "v": v.to(dt)}
        weights = {"scale": torch.full((1,), 1 / math.sqrt(D), dtype=dt,
                                       device=dev),
                   "edge_mask": edge.to(dt)}
        eager = GraphExecutor(h.graph, device=dev, use_cuda_graph=False)
        for n, t in weights.items():
            eager.set_weight(n, t)
        counters.reset()
        (out,) = eager.run(feeds).values()
        torch.cuda.synchronize()
        paths[label] = counters.read()
        steps[label] = paths[label]
        want = {"g2bmm": 1, "g2bmm_ring": 1, "gbmm": 1, "gbmm_ring": 1}
        if paths[label] != want:
            fail(f"{label}: launched {paths[label]}, expected {want}")
        qf, kf, vf = (t.float() for t in feeds.values())
        ref = dense(qf, kf, vf)
        ref64 = dense(*(t.double() for t in feeds.values()))
        top = ref64.abs().max().item()
        err = (out.double() - ref64).abs().max().item() / top
        err32 = (out.float() - ref).abs().max().item() / top
        equal = (out.float() == ref).double().mean().item()
        # the same check on a perturbed input must fail: one row of v
        # moved by 8 moves the 2w + 1 output rows that attend to it by
        # ~8 / (2w + 1), against max|out| ~0.2
        v_p = feeds["v"].clone()
        v_p[0, S // 2] += 8
        (out_p,) = eager.run({**feeds, "v": v_p}).values()
        err_p = (out_p.double() - ref64).abs().max().item() / top
        at = [(0, 0, 0), (0, S // 2, 1), (bz - 1, S - 1, D - 1)]
        pairs = [[out[a].item(), ref[a].item(), ref64[a].item()] for a in at]
        print(f"# {label}: band graph vs dense masked attention: rel err "
              f"{err:.3g} against f64 (limit {LF_TOL[label]}), {err32:.3g} "
              f"against f32; {equal:.4f} of the elements equal the f32 "
              f"dense ones bit for bit; (band, f32 dense, f64 dense) at "
              f"{at}: {pairs}; with v perturbed: {err_p:.3g}", flush=True)
        if out.dtype != dt or out.shape != (bz, S, D) or \
                not math.isfinite(err) or err > LF_TOL[label]:
            fail(f"{label}: {out.dtype} {tuple(out.shape)}, rel err {err}")
        if not err_p > LF_TOL[label]:
            fail(f"{label}: a perturbed v gives rel err {err_p}, within "
                 f"the limit {LF_TOL[label]}: the check sees nothing")
        ex = GraphExecutor(h.graph, device=dev)
        for n, t in weights.items():
            ex.set_weight(n, t)
        # the same block captured with the old form of both kernels
        route = band.band_form
        band.band_form = lambda *a: "simt"
        try:
            counters.reset()
            ex_old = GraphExecutor(h.graph, device=dev)
            for n, t in weights.items():
                ex_old.set_weight(n, t)
            (out_old,) = ex_old.run(feeds).values()
            torch.cuda.synchronize()
            old_launches = counters.read()
        finally:
            band.band_form = route
        err_old = (out_old.double() - ref64).abs().max().item() / top
        if old_launches.get("g2bmm_ring", 0) or \
                old_launches.get("gbmm_ring", 0) or \
                not old_launches.get("g2bmm", 0) or \
                not old_launches.get("gbmm", 0) or \
                not math.isfinite(err_old) or err_old > LF_TOL[label]:
            fail(f"{label}: the old forms' capture launched {old_launches},"
                 f" rel err {err_old}")
        # one run of each in turns, 6 pairs: the card's speed moves between
        # runs (PERF.md section 7), so each pair's ratio is read
        turns = {"ring": [], "old": []}
        for _ in range(6):
            turns["ring"].append(ex.time_ms(feeds, iters=20))
            turns["old"].append(ex_old.time_ms(feeds, iters=20))
        ratios = sorted(a / b for a, b in zip(turns["ring"], turns["old"]))
        del ref64, out_p, v_p, out_old
        res[label] = {"rel_err_vs_dense_f64": err,
                      "rel_err_vs_dense_f32": err32,
                      "bit_equal_share_vs_dense_f32": equal,
                      "rel_err_perturbed_v": err_p, "pairs": pairs,
                      "launches": paths[label],
                      "captured_ms": statistics.median(turns["ring"]),
                      "captured_ms_old_forms": statistics.median(
                          turns["old"]),
                      "captured_ms_in_turns": turns,
                      "ring_over_old_median": statistics.median(ratios),
                      "rel_err_old_forms_vs_dense_f64": err_old,
                      "eager_ms": eager.time_ms(feeds, iters=5),
                      "dense_ms": cuda_ms(torch, lambda qf=qf, kf=kf, vf=vf:
                                          dense(qf, kf, vf), 5)}
        print(f"# {label}: " + json.dumps(res[label]), flush=True)
        del ex, ex_old, eager, ref
    report["longformer"] = res
    return paths


def band_gate_check(torch, GraphHandler, GraphExecutor, band, counters, dev,
                    report):
    """Phase 13, the band lowering's gate: G2BMM -> GBMM in f32 through
    GraphHandler and GraphExecutor (eager) at shapes no band kernel form
    takes, an f32 window too wide for the first form's shared memory (k
    512, w 128) and bz 65536 (past a launch's grid): band_kernels_usable
    refuses both, so the lowering takes its gather or shift-scan path,
    launches no band kernel and matches g2bmm_plain / gbmm_plain within
    1e-4 of max|plain|."""
    res = {}
    for bz, m, k, w in ((2, 64, 512, 128), (65536, 4, 8, 1)):
        if band.band_kernels_usable("g2bmm", torch.float32, torch.float32,
                                    bz, m, k, w, 1):
            fail(f"the band gate passes f32 bz {bz} k {k} w {w}")
        h = GraphHandler(name="band_gate")
        a_in, b_in = (h.input((bz, m, k), name=n) for n in ("a", "b"))
        h.gbmm(h.g2bmm(a_in, b_in, width=w), b_in)
        h.graph.infer_output_roles()
        gen = torch.Generator(device=dev).manual_seed(SEED + 130 + k)
        a, b = (torch.randn(bz, m, k, generator=gen, device=dev)
                for _ in range(2))
        counters.reset()
        (out,) = GraphExecutor(h.graph, device=dev,
                               use_cuda_graph=False).run(
            {"a": a, "b": b}).values()
        torch.cuda.synchronize()
        launched = counters.read()
        want = band.gbmm_plain(band.g2bmm_plain(a, b, w), b, w)
        err = (out - want).abs().max().item()
        top = want.abs().max().item()
        key = f"bz {bz} m {m} k {k} w {w}"
        res[key] = {"max_abs_err": err, "max_abs_ref": top,
                    "launches": launched}
        print(f"# band gate, f32 {key}: err {err:.3g} (max|plain| "
              f"{top:.3g}), launches {launched}", flush=True)
        if launched.get("g2bmm", 0) or launched.get("gbmm", 0) or \
                out.shape != want.shape or not err <= 1e-4 * top:
            fail(f"band gate, {key}: launched {launched}, err {err}")
    report["band_gate"] = res


# -- the any-type attention form and the K split of the matmuls: ----------
# -- phase 3 rows, the any-type grid, phase 14 (the f16 Llama) --------------

ANY_DTYPES = ("bf16", "f16", "f32")
ANY_HEAD_DIMS = (8, 16, 64, 72, 96, 128, 136, 256)
ANY_SRC = SRC + "attention_any.cuh"
PREFILL_ANY_SRC = SRC + "flash_attention_any.cuh"
F32_TOL = 1e-5               # f32 attention vs its f32 plain version
NO_PATH = "no main path"     # rows of forms no phase's path runs


def unsplit(qm, fn):
    """fn with the matmuls' K split forced off (qm._SPLITS = 1):
    the form before it, timed beside it in one call."""
    def run():
        qm._SPLITS = 1
        try:
            return fn()
        finally:
            qm._SPLITS = None
    return run


def split_launches(qm, weights, rows=1):
    """How many of the CUDA-core launches of `weights` at `rows` rows take
    the K split on this card (qm.group_splits above 1)."""
    return sum(qm.group_splits(rows, q.out_physical, q.qweight.shape[0],
                               q.group_size, qm._build.sms(0)) > 1
               for q in weights)


CODE_RMS = math.sqrt(21.5)   # rms of int4 codes uniform in [-8, 7]


def f16_params(torch, params):
    """params (bf16 embedding and norms, INT4 weights) as an f16 model:
    the same INT4 codes, each matrix's scales multiplied so that its
    weights' rms is 1 / sqrt(din) (bench.py's random scales let the bf16
    model's residual reach 9e5 by layer 32, past f16's 65504 from layer
    3), the embedding and norms in f16."""
    def rescale(q):
        rms = CODE_RMS * q.scales.float().square().mean().sqrt()
        f = 1.0 / (math.sqrt(q.in_features) * float(rms))
        return dataclasses.replace(q, scales=(q.scales.float() * f).to(
            q.scales.dtype))

    keys = ("wqkv", "wo", "w_gateup", "w_down")
    return dict(params, embed=params["embed"].half(),
                final_norm=params["final_norm"].half(),
                lm_head=rescale(params["lm_head"]),
                layers=[dict(lay, attn_norm=lay["attn_norm"].half(),
                             mlp_norm=lay["mlp_norm"].half(),
                             **{k: rescale(lay[k]) for k in keys})
                        for lay in params["layers"]])


def split_crossover(torch, qm, layer0, lay64, randn, flush):
    """The K split forced at 1 (the form before it), 2, 4, 8 and 16
    blocks a tile, beside the count group_splits
    picks: qmm_group on wo and w_down at 1 row, qmm_chunk (group 64, its
    CUDA-core form) on wo and w_down at 1 and SLOTS rows and on wo at 4.
    The times behind qm.SPLIT_MAX and group_splits' unsplit 4-row blocks.
    Returns [{weight, rows, chosen, ms: {splits: ms}}]."""
    out = []
    for label, q, rows in (("wo", layer0["wo"], 1),
                           ("w_down", layer0["w_down"], 1),
                           ("g64 wo", lay64["wo"], 1),
                           ("g64 w_down", lay64["w_down"], 1),
                           ("g64 wo", lay64["wo"], 4),
                           ("g64 wo", lay64["wo"], SLOTS),
                           ("g64 w_down", lay64["w_down"], SLOTS)):
        x = randn(rows, q.in_features)
        chosen = qm.group_splits(rows, q.out_physical, q.qweight.shape[0],
                                 q.group_size, qm._build.sms(0))
        ms = {}
        for n in (1, 2, 4, 8, 16):
            qm._SPLITS = n
            try:
                ms[n] = cuda_ms(torch, lambda x=x, q=q: qm._launch_chunk(
                    x, q, form="cuda_core") if label.startswith("g64")
                    else qm.quant_matmul(x, q), 50, flush)
            finally:
                qm._SPLITS = None
        out.append({"weight": label, "rows": rows, "chosen": chosen,
                    "ms": ms})
    print(f"# K split, ms by blocks a tile (1 = unsplit): "
          f"{json.dumps(out)}", flush=True)
    return out


@contextlib.contextmanager
def old_route(torch, att, fa, pa):
    """The attention route before the fast kernels' f16 forms and f32
    decode, for the block: the fast kernels take a bf16 q (over a bf16 or
    INT8 cache) at D 64 or 128 only, so an f16 or f32 launch takes the
    any-type body's C entries (flash_attention_any, flash_decode_any,
    flash_decode_merge_any, paged_flash_decode(_q8)_any). The old form,
    forced, timed beside the new one in the same call."""
    bf16, dims = torch.bfloat16, att.FAST_HEAD_DIMS
    saved = att.fast_form, pa.fast_form, fa.fast_prefill
    att.fast_form = pa.fast_form = lambda q, c, D: (
        q == bf16 and D in dims and c in (bf16, torch.int8))
    fa.fast_prefill = lambda dt, D: dt == bf16 and D in dims
    try:
        yield
    finally:
        att.fast_form, pa.fast_form, fa.fast_prefill = saved


def old_body(torch, att, fa, pa, fn):
    """fn under old_route: the any-type body where the new route takes
    the fast kernels."""
    def run():
        with old_route(torch, att, fa, pa):
            return fn()
    return run


def no_tf32(torch, fn):
    """fn with torch.backends.cuda.matmul.allow_tf32 False: the f32
    library call in f32, not TF32."""
    def run():
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    return run


def any_cases(torch, att, fa, pa, cfg, gen, dev, dt):
    """Phase 3 rows of the five attention wrappers at the shapes of phase
    14's model in dtype dt: flash_attention on its 256-token prompt
    (causal 1 x 32 x 256 x 128), flash_decode (dt cache) and
    flash_decode_q8 (INT8 cache) with a dt q at pos CTX in the split form
    batch 1 takes, beside the unsplit form, the merge on their partials
    in dt, and both paged kernels at the serving shape (SLOTS slots, a dt
    q over dt or INT8 pages). The fast kernels (f16, and the f32 decode),
    each beside the any-type body it replaced (old_route,
    form "any"); f16 on phase 14's paths. In f32, which no main path
    runs: the prefill's any-type body, and the any-type decode body again
    in rows of its own (the `_any` names); plain versions and library
    calls in f32 (no_tf32), held to F32_TOL."""
    H, D, S = cfg.n_heads, cfg.head_dim, MAX_SEQ
    f32 = dt == torch.float32
    kind = "f32" if f32 else "f16"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def row(base, fast, src, path, fast_name=None, **c):
        """A case: the base name (or fast_name) and source for the fast
        kernel, the `_any` name and attention_any.cuh for the any-type
        body; for a fast kernel the old body beside it; in f32 the plain
        version and the library call without TF32, and the limit
        F32_TOL."""
        forms = c.pop("forms", {})
        if fast:
            forms["any"] = old_body(torch, att, fa, pa, c["kernel"])
        if f32:
            c["library"] = c["library"] and no_tf32(torch, c["library"])
            c["plain"] = no_tf32(torch, c["plain"])
            c["tol"] = F32_TOL
        return dict(name=(fast_name or base) if fast else base + "_any",
                    any_name=base + "_any",
                    source=SRC + src if fast else
                    PREFILL_ANY_SRC if base == "flash_attention" else ANY_SRC,
                    path=NO_PATH if f32 else path, kind=kind, forms=forms,
                    **c)

    cases = []
    qa, ka, va = (rnd(1, H, SHORT, D) for _ in range(3))
    cases.append(row(
        "flash_attention", att.fast_prefill(dt, D), "flash_attention.cu",
        F16_PROMPT, shape=f"{kind} causal 1x{H}x{SHORT}x{D}",
        replaces=TPU + "flash_attention.py:37",
        kernel=lambda: fa.flash_attention(qa, ka, va, causal=True),
        plain=lambda: fa.mha_plain(qa, ka, va, causal=True),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qa, ka, va, is_causal=True),
        bytes=4 * nbytes(qa), ops=4 * H * (SHORT * (SHORT + 1) // 2) * D))
    qh = rnd(1, H, 1, D)
    pos = torch.full((1,), CTX, dtype=torch.int32, device=dev)
    live = CTX + 1
    kc, vc = rnd(1, H, S, D), rnd(1, H, S, D)
    args = (qh, kc, vc, pos)
    cases.append(row(
        "flash_decode", att.fast_form(dt, dt, D), "flash_decode.cu",
        F16_PROMPT, shape=f"{kind} mha 32/32 pos {CTX}",
        replaces=TPU + "attention.py:294",
        kernel=lambda: att.flash_decode(*args),
        plain=lambda: att.flash_decode_plain(*args),
        forms={"unsplit": lambda: att.flash_decode(*args, _splits=1)},
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kc[:, :, :live], vc[:, :, :live]),
        bytes=2 * H * live * D * kc.element_size() + 2 * nbytes(qh),
        ops=4 * H * live * D))
    kq, vq = (torch.randint(-127, 128, (1, H, S, D), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(1, H, S, generator=gen, device=dev) * 0.015 + 0.005
              for _ in range(2))
    args8 = (qh, kq, vq, ks, vs, pos)
    kf = (kq[:, :, :live].float() * ks[:, :, :live, None]).to(dt)
    vf = (vq[:, :, :live].float() * vs[:, :, :live, None]).to(dt)
    cases.append(row(
        "flash_decode_q8", att.fast_form(dt, torch.int8, D),
        "flash_decode.cu", F16_PROMPT_Q8,
        shape=f"{kind} q mha 32/32 pos {CTX}",
        replaces=TPU + "attention.py:345",
        kernel=lambda: att.flash_decode_q8(*args8),
        plain=lambda: att.flash_decode_q8_plain(*args8),
        forms={"unsplit": lambda: att.flash_decode_q8(*args8, _splits=1)},
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kf, vf),
        bytes=2 * H * live * (D + 4) + 2 * nbytes(qh),
        ops=4 * H * live * D))
    splits = att.launch_splits(1, H, S)
    part = att.flash_decode_split_plain(*args, splits).contiguous()
    cases.append(row(
        "flash_decode_merge", att.fast_form(dt, dt, D), "flash_decode.cu",
        F16_PROMPT, shape=f"{kind} mha 32/32 {splits} splits",
        replaces=TPU + "attention.py:294",
        kernel=lambda: att.flash_decode_merge(part, dt),
        plain=lambda: att.flash_decode_merge_plain(part).to(dt),
        library=None, bytes=nbytes(part) + H * D * qh.element_size(),
        ops=3 * H * splits * D))
    # the paged kernels: a dt q over dt and INT8 pages
    B, P = SLOTS, PAGE
    MP = MAX_SEQ // P
    N = B * MP + 1
    ppos = torch.tensor(PAGED_POS[:B], dtype=torch.int32, device=dev)
    table = (torch.randperm(N - 1, generator=gen, device=dev)[:B * MP] + 1) \
        .reshape(B, MP).to(torch.int32)
    Hkv = cfg.n_kv_heads
    qp = rnd(B, H, 1, D)
    kp, vp = rnd(N, Hkv, P, D), rnd(N, Hkv, P, D)
    kpq, vpq = (torch.randint(-127, 128, (N, Hkv, P, D), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(2))
    ksp, vsp = (torch.rand(N, Hkv, P, generator=gen, device=dev) * 0.015
                + 0.005 for _ in range(2))
    rows = int((ppos + 1).sum())
    # the library call: SDPA over the pages gathered (and dequantized)
    # into dt K/V with the KV heads repeated, masked past each slot's pos
    rep = H // Hkv
    mask = (torch.arange(MP * P, device=dev)[None] <= ppos[:, None])[
        :, None, None]                                      # [B, 1, 1, S]
    gathered = [tuple(pa.gather_pages(x, table).repeat_interleave(rep, 1)
                      for x in (kp, vp)),
                tuple((pa.gather_pages(x, table).float()
                       * pa.gather_scale_pages(sc, table)[..., None])
                      .to(dt).repeat_interleave(rep, 1)
                      for x, sc in ((kpq, ksp), (vpq, vsp)))]
    for (name, pargs, plain, row_b, cdt, replaces), (kg, vg) in zip((
            ("paged_flash_decode", (qp, kp, vp, table, ppos),
             pa.paged_decode_plain, 2 * D * kp.element_size(), dt,
             "paged_attention.py:146"),
            ("paged_flash_decode_q8",
             (qp, kpq, vpq, ksp, vsp, table, ppos),
             pa.paged_decode_q8_plain, 2 * (D + 4), torch.int8,
             "paged_attention.py:187")), gathered):
        kernel = pa.paged_flash_decode if "q8" not in name \
            else pa.paged_flash_decode_q8
        cases.append(row(
            name, att.fast_form(dt, cdt, D), "paged_flash_decode_ring.cu",
            F16_PAGED, fast_name=name + "_ring", shape=f"{kind} q, {B} "
            f"slots P {P} pos {PAGED_POS[0]}-{PAGED_POS[-1]}",
            replaces=TPU + replaces,
            kernel=lambda k=kernel, a=pargs: k(*a),
            plain=lambda f=plain, a=pargs: f(*a),
            forms={"block": lambda k=kernel, a=pargs: k(*a, _form="block")},
            library=lambda kg=kg, vg=vg: torch.nn.functional
            .scaled_dot_product_attention(qp, kg, vg, attn_mask=mask),
            bytes=Hkv * rows * row_b + 2 * nbytes(qp),
            ops=4 * H * rows * D))
    if f32:
        # the any-type body the f32 decode left keeps rows of its own at
        # the same shapes, forced through the old route
        cases += [dict(c, name=c["any_name"], source=ANY_SRC,
                       kernel=c["forms"]["any"],
                       forms={f: old_body(torch, att, fa, pa, fn)
                              for f, fn in c["forms"].items()
                              if f not in ("any", "block")})
                  for c in cases if "any" in c["forms"]]
    return cases


def prefill_rows(torch, att, fa, pa, cfg, gen, dev):
    """Phase 3 rows of the tensor-core prefill beside the f16 one at
    phase 14's prompt: bf16 at the same shape (phase 5's 256-token
    prompt), and f16 at head dim 96 (zero-padded to the 128 instantiation,
    no main path), beside the any-type body (old_route)."""
    H, D = cfg.n_heads, cfg.head_dim
    cases = []
    for dt, d, path in ((torch.bfloat16, D, f"prompt {SHORT}"),
                        (torch.float16, 96, NO_PATH)):
        qa, ka, va = (torch.randn(1, H, SHORT, d, generator=gen, device=dev)
                      .to(dt) for _ in range(3))
        kernel = lambda qa=qa, ka=ka, va=va: fa.flash_attention(
            qa, ka, va, causal=True)
        cases.append(dict(
            name="flash_attention", path=path,
            shape=f"{'f16 ' if d != D else ''}causal 1x{H}x{SHORT}x{d}",
            replaces=TPU + "flash_attention.py:37",
            source=SRC + "flash_attention.cu", kernel=kernel,
            plain=lambda qa=qa, ka=ka, va=va: fa.mha_plain(qa, ka, va,
                                                           causal=True),
            library=lambda qa=qa, ka=ka, va=va: torch.nn.functional
            .scaled_dot_product_attention(qa, ka, va, is_causal=True),
            forms={} if dt == torch.bfloat16 else {
                "any": old_body(torch, att, fa, pa, kernel)},
            bytes=4 * qa.numel() * qa.element_size(),
            ops=4 * H * (SHORT * (SHORT + 1) // 2) * d,
            kind="bf16" if dt == torch.bfloat16 else "f16"))
    return cases


def prefill_any_rows(torch, fa, cfg, gen, dev):
    """Phase 3 rows of the any-type prefill (flash_attention_any, no main
    path) beside SDPA: f32 causal 1 x 32 x 1024 x 128 (the 7B prompt's
    attention in f32; the plain version and SDPA in f32, TF32 off; held
    within F32_TOL of max|plain|), and bf16 causal 1 x 32 x SHORT x 256,
    the 16-bit head dims the tensor-core kernel does not take."""
    H = cfg.n_heads
    cases = []
    for dt, S, D in ((torch.float32, PROMPT, cfg.head_dim),
                     (torch.bfloat16, SHORT, 256)):
        f32 = dt == torch.float32
        qa, ka, va = (torch.randn(1, H, S, D, generator=gen, device=dev)
                      .to(dt) for _ in range(3))
        plain = lambda qa=qa, ka=ka, va=va: fa.mha_plain(qa, ka, va, True)
        library = lambda qa=qa, ka=ka, va=va: torch.nn.functional \
            .scaled_dot_product_attention(qa, ka, va, is_causal=True)
        cases.append(dict(
            name="flash_attention_any", path=NO_PATH,
            shape=f"{'f32' if f32 else 'bf16'} causal 1x{H}x{S}x{D}",
            replaces=TPU + "flash_attention.py:37", source=PREFILL_ANY_SRC,
            kernel=lambda qa=qa, ka=ka, va=va: fa.flash_attention(
                qa, ka, va, causal=True),
            plain=no_tf32(torch, plain) if f32 else plain,
            library=no_tf32(torch, library) if f32 else library,
            bytes=4 * qa.numel() * qa.element_size(),
            ops=4 * H * (S * (S + 1) // 2) * D,
            kind="f32" if f32 else "bf16",
            **({"tol": F32_TOL} if f32 else {})))
    return cases


def any_grid(torch, att, fa, pa, gen, dev):
    """Each of the five attention wrappers (and the merge, through the
    split form) once at every q dtype (bf16, f16, f32) and head dim
    (ANY_HEAD_DIMS) against its plain version: at most 1e-2 of max|plain|
    (TOL). Small shapes, untimed. Returns {wrapper: {dtype: {D: [form,
    err / max|plain|]}}}: form "any" or "fast" (the 16-bit kernels)."""
    dts = {"bf16": torch.bfloat16, "f16": torch.float16,
           "f32": torch.float32}
    out = {}

    def check(what, dt, D, got, want, form):
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        if got.dtype != want.dtype or not (math.isfinite(err)
                                           and err <= TOL * ref):
            fail(f"any-type grid {what} {dt} D {D}: {got.dtype}, max err "
                 f"{err} > {TOL} * {ref}")
        out.setdefault(what, {}).setdefault(dt, {})[D] = [form, err / ref]

    for dname, dt in dts.items():
        for D in ANY_HEAD_DIMS:
            B, H, Hkv, S = 2, 8, 2, 200
            q = torch.randn(B, H, 1, D, generator=gen, device=dev).to(dt)
            kc, vc = (torch.randn(B, Hkv, S, D, generator=gen, device=dev)
                      .to(dt) for _ in range(2))
            kq, vq = (torch.randint(-127, 128, (B, Hkv, S, D), generator=gen,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (torch.rand(B, Hkv, S, generator=gen, device=dev) * 0.015
                      + 0.005 for _ in range(2))
            pos = torch.tensor([57, S - 1], dtype=torch.int32, device=dev)

            def form(cdt, dt=dt, D=D):
                return "fast" if att.fast_form(dt, cdt, D) else "any"

            for splits in (1, 3):
                tag = "" if splits == 1 else " split"
                check("flash_decode" + tag, dname, D,
                      att.flash_decode(q, kc, vc, pos, _splits=splits),
                      att.flash_decode_plain(q, kc, vc, pos), form(dt))
                check("flash_decode_q8" + tag, dname, D,
                      att.flash_decode_q8(q, kq, vq, ks, vs, pos,
                                          _splits=splits),
                      att.flash_decode_q8_plain(q, kq, vq, ks, vs, pos),
                      form(torch.int8))
            qa, ka, va = (torch.randn(1, 4, 77, D, generator=gen,
                                      device=dev).to(dt) for _ in range(3))
            check("flash_attention", dname, D,
                  fa.flash_attention(qa, ka, va, True),
                  fa.mha_plain(qa, ka, va, True),
                  "fast" if att.fast_prefill(dt, D) else "any")
            P, MP = 16, 4
            N = B * MP + 1
            table = (torch.arange(B * MP, device=dev) + 1).reshape(
                B, MP).to(torch.int32)
            ppos = torch.tensor([5, P * MP - 1], dtype=torch.int32,
                                device=dev)
            kp, vp = (torch.randn(N, Hkv, P, D, generator=gen, device=dev)
                      .to(dt) for _ in range(2))
            kpq, vpq = (torch.randint(-127, 128, (N, Hkv, P, D),
                                      generator=gen, device=dev,
                                      dtype=torch.int8) for _ in range(2))
            ksp, vsp = (torch.rand(N, Hkv, P, generator=gen, device=dev)
                        * 0.015 + 0.005 for _ in range(2))
            check("paged_flash_decode", dname, D,
                  pa.paged_flash_decode(q, kp, vp, table, ppos),
                  pa.paged_decode_plain(q, kp, vp, table, ppos), form(dt))
            check("paged_flash_decode_q8", dname, D,
                  pa.paged_flash_decode_q8(q, kpq, vpq, ksp, vsp, table,
                                           ppos),
                  pa.paged_decode_q8_plain(q, kpq, vpq, ksp, vsp, table,
                                           ppos), form(torch.int8))
    torch.cuda.synchronize()
    worst = {w: round(max(e for d in v.values() for _, e in d.values()),
                      6) for w, v in out.items()}
    print(f"# any-type grid: {ANY_DTYPES} x D {ANY_HEAD_DIMS}, worst err / "
          f"max|plain| per wrapper: {json.dumps(worst)}", flush=True)
    return out


def in_turns(torch, kmods, read):
    """read() with the route as it is and with old_route, in turns (new,
    old, new, old): (min of the new readings, min of the old, all four)."""
    got = []
    for _ in range(2):
        got.append(read())
        with old_route(torch, *kmods):
            got.append(read())
    return min(got[0::2]), min(got[1::2]), got


def step_ms(torch, fn):
    """Milliseconds of one replay of fn captured in a CUDA graph (after a
    warm-up run on a side stream, as the serving engine captures its
    step; median of 20 CUDA-event timings)."""
    graph = capture(torch, fn)
    ms = cuda_ms(torch, graph.replay, 20)
    del graph
    return ms


def f16_path(torch, llama, counters, kmods, params, cfg, dev, report, steps,
             prompts_of):
    """Phase 14: the 7B model of phase 4 as an f16 model (f16 embedding,
    norms, activations and cache; the same INT4 codes, scales rescaled
    by f16_params). greedy_generate
    on a seeded 256-token prompt with the f16 cache and with an INT8
    cache: the prefill launches the tensor-core flash_attention 32 times,
    the decode the fast flash_decode(_q8) and its merge, and no path
    launches an any-type form; prefill ms (host clock, min of 3; and one
    CUDA graph's replay) and a decode step's ms (one CUDA graph), each
    beside the any-type body's (old_route) in turns;
    a 2-layer f16 prefill on the card against the plain versions on the
    CPU; one decode step of SLOTS slots over f16 pages and over INT8
    pages (the fast paged kernels, 32 launches each) against the same step
    over a dense cache, its ms (one CUDA graph) beside the any-type
    body's. Returns each path's launch counts."""
    cfg16 = dataclasses.replace(cfg, dtype=torch.float16)
    p16 = f16_params(torch, params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    prompt = torch.randint(0, cfg.vocab_size, (1, SHORT), generator=gen,
                           device=dev, dtype=torch.int32)
    paths, res = {}, {}

    def no_any(label, counts):
        if any(k.endswith("_any") for k in counts):
            fail(f"{label}: an any-type form was launched: {counts}")

    for label, kv_quant, want in (
            (F16_PROMPT, False, ("flash_attention", "flash_decode",
                                 "flash_decode_merge")),
            (F16_PROMPT_Q8, True, ("flash_attention", "flash_decode_q8",
                                   "flash_decode_merge"))):
        cache = llama.init_kv_cache(cfg16, 1, kv_quant=kv_quant, device=dev)
        counters.reset()
        toks, cache = llama.greedy_generate(p16, cfg16, prompt, 8,
                                            cache=cache)
        torch.cuda.synchronize()
        paths[label] = counters.read()
        for kname in want:
            if paths[label].get(kname, 0) <= 0:
                fail(f"{kname} was never launched on the path {label}")
        no_any(label, paths[label])
        if toks.shape != (1, 8) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{label}: greedy_generate gave {toks.tolist()}")
        counters.reset()
        prefill_s, logits = time_prefill(torch, llama, p16, cfg16, prompt,
                                         cache, 1)
        prompts_of[label] = counters.read()
        if prompts_of[label].get("flash_attention", 0) != cfg.n_layers:
            fail(f"{label}: a prefill launched {prompts_of[label]}")
        no_any(label, prompts_of[label])
        prefill_s, logits = time_prefill(torch, llama, p16, cfg16, prompt,
                                         cache)
        if logits.dtype != torch.float16 and logits.dtype != torch.float32:
            fail(f"{label}: logits {logits.dtype}")
        first = torch.argmax(logits[:, -1], -1).to(torch.int32)
        if not torch.equal(first, toks[:, 0]):
            fail(f"{label}: prefill argmax {first.tolist()} is not the "
                 f"first generated token {toks[:, 0].tolist()}")
        counters.reset()
        last = toks[:, -1]
        at = torch.full((1,), SHORT + 7, dtype=torch.int32, device=dev)
        llama.llama_decode_step(p16, cfg16, last, at, cache)
        torch.cuda.synchronize()
        steps[label] = counters.read()
        no_any(label, steps[label])
        pre_new, pre_old, pre_all = in_turns(
            torch, kmods, lambda: 1e3 * time_prefill(
                torch, llama, p16, cfg16, prompt, cache)[0])
        pg_new, pg_old, pg_all = in_turns(torch, kmods, lambda: step_ms(
            torch, lambda: llama.llama_prefill(p16, cfg16, prompt, cache)))
        dec_new, dec_old, dec_all = in_turns(torch, kmods, lambda: step_ms(
            torch, lambda: llama.llama_decode_step(p16, cfg16, last, at,
                                                   cache)))
        res[label] = {"prefill_ms": pre_new,
                      "prefill_ms_any_body": pre_old,
                      "prefill_ms_in_turns": pre_all,
                      "prefill_graph_ms": pg_new,
                      "prefill_graph_ms_any_body": pg_old,
                      "prefill_graph_ms_in_turns": pg_all,
                      "prompt_tok_s": 1e3 * SHORT / pre_new,
                      "decode_step_ms": dec_new,
                      "decode_step_ms_any_body": dec_old,
                      "decode_step_ms_in_turns": dec_all,
                      "launches": paths[label],
                      "launches_per_prompt": prompts_of[label],
                      "launches_per_token": steps[label],
                      "first_tokens": toks[0].tolist()}
        print(f"# {label}: " + json.dumps(res[label]), flush=True)
        del cache
    # 2 layers at 7B width in f16: kernels on the card against the plain
    # versions on the CPU
    cfg2 = dataclasses.replace(cfg16, n_layers=2)
    p2 = dict(p16, layers=p16["layers"][:2])
    got, _ = llama.llama_prefill(p2, cfg2, prompt,
                                 llama.init_kv_cache(cfg2, 1, device=dev))
    t0 = time.perf_counter()
    want, _ = llama.llama_prefill(to_cpu(p2), cfg2, prompt.cpu(),
                                  llama.init_kv_cache(cfg2, 1, device="cpu"))
    print(f"# f16 2-layer prefill on the plain versions (CPU): "
          f"{time.perf_counter() - t0:.1f}s")
    compare_logits(torch, f"f16 2-layer prefill {SHORT}, kernels vs plain",
                   got[0, -1].float(), want[0, -1].float(), report)
    # one decode step of SLOTS slots over pages, against a dense cache
    B, P = SLOTS, PAGE
    MP = MAX_SEQ // P
    pos = torch.tensor([CTX - 331, CTX - 64, CTX - 1, CTX, CTX + 1,
                        CTX + 63, CTX + 200, CTX + 477][:B],
                       dtype=torch.int32, device=dev)
    token = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                          device=dev, dtype=torch.int32)
    paths[F16_PAGED] = {}
    res[F16_PAGED] = {}
    for kv_quant, kname in ((False, "paged_flash_decode"),
                            (True, "paged_flash_decode_q8")):
        paged = llama.init_paged_kv_cache(cfg16, B * MP + 1, P, B,
                                          kv_quant=kv_quant, device=dev)
        paged["block_table"].copy_((torch.arange(B * MP, device=dev) + 1)
                                   .reshape(B, MP))
        counters.reset()
        lg_p, _ = llama.llama_decode_step(p16, cfg16, token, pos, paged)
        torch.cuda.synchronize()
        got = counters.read()
        if got.get(kname, 0) != cfg.n_layers or \
                got.get(kname + "_ring", 0) != cfg.n_layers:
            fail(f"{F16_PAGED}: a step launched {got}")
        no_any(F16_PAGED, got)
        for k, n in got.items():
            paths[F16_PAGED][k] = paths[F16_PAGED].get(k, 0) + n
        new, old, turns = in_turns(torch, kmods, lambda: step_ms(
            torch, lambda: llama.llama_decode_step(p16, cfg16, token, pos,
                                                   paged)))
        pages = "int8" if kv_quant else "f16"
        res[F16_PAGED][pages] = {"step_ms": new, "step_ms_any_body": old,
                                 "step_ms_in_turns": turns}
        print(f"# {F16_PAGED} ({pages} pages): step {new:.3f} ms, the "
              f"any-type body {old:.3f} ms (in turns {turns})", flush=True)
        del paged
        dense = llama.init_kv_cache(cfg16, B, kv_quant=kv_quant, device=dev)
        lg_d, _ = llama.llama_decode_step(p16, cfg16, token, pos, dense)
        del dense
        compare_logits_rows(torch, f"{F16_PAGED} ({pages} pages) vs dense",
                            lg_p.float(), lg_d.float(), report)
    steps[F16_PAGED] = paths[F16_PAGED]
    report["f16"] = res
    return paths


# -- phases 15-18: the other models and the ONNX frontend ---------------------

OPT_STEPS = 64               # phase 15: greedy decode steps after a prompt
OPT_GROUP = 128              # INT8 grouping (tools/serving_bench.py:49)
OPT_LENS = (256, 200, 131, 64, 240, 17, 100, 180)   # the batch of 8's prompts
OPT_DECODE = "opt int8 decode"
OPT_PROMPT = f"opt int8 prompt {SHORT}"
OPT_BATCH = "opt int8 batch 8"
OPT_MATMULS = (("w_qkv", 2048, 6144), ("w_o", 2048, 2048),
               ("w_up", 2048, 8192), ("w_down", 8192, 2048))
BERT_SHAPE = (2, 128)        # phase 16: tools/bert_parity.py:46-47
BERT_TOL = 1e-3              # phase 16: card against the CPU, of max|h|
BERT_INT8_GATE = 0.05        # mean|dh| / rms(h), tools/bert_parity.py:5-14
VISION_IMAGE = 224           # phase 17: tools/vision_parity.py
VISION_TOL = 1e-3            # ... rtol = atol = 1e-3 x max|ref| (:102-104)
ONNX_KERNELS = "onnx kernels"     # phase 18
#: cuBLAS's kernels in phase 15's profile (the tied lm_head, bf16 weights;
#: its Hopper kernels are named nvjet_*, its split-K sum cublasLt::*)
CUBLAS_KINDS = (("nvjet", "cuBLAS"), ("cublas", "cuBLAS"), ("gemm", "cuBLAS"),
                ("gemv", "cuBLAS"))


def opt_cases(torch, qm, att, gen, dev, randn, quantize_weight,
              dequantize_weight):
    """Phase 3 rows at OPT-1.3B's shapes (phase 15's path): the int8
    qmm_group on w_qkv, w_o, w_up and w_down at group 128 at 1 row (the K
    split, beside the unsplit form), 8 rows (the batch of 8) and SHORT rows
    (qmm_group_mma, the prompt), and at group None (one group of din) at 1
    and SHORT rows (no path); flash_decode at 32 heads of 64 over a 2048-row
    bf16 cache at batch 1 (the split form, beside the unsplit) and batch 8
    (ragged pos), and flash_decode_merge on the batch-1 partials."""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = []
    for label, din, dout in OPT_MATMULS:
        w = torch.randn(din, dout, generator=gen, device=dev) * 0.02
        for group, rows_paths in ((OPT_GROUP, ((1, OPT_DECODE),
                                               (SLOTS, OPT_BATCH),
                                               (SHORT, OPT_PROMPT))),
                                  (None, ((1, NO_PATH), (SHORT, NO_PATH)))):
            q = quantize_weight(w, 8, group)
            wd = dequantize_weight(q)
            for rows, path in rows_paths:
                x = randn(rows, din)
                mma = rows >= qm.MMA_MIN_ROWS
                split = split_launches(qm, (q,), rows) > 0

                def kernel(x=x, q=q):
                    return qm.quant_matmul(x, q)

                out.append(dict(
                    name="qmm_group_mma" if mma else "qmm_group",
                    shape=f"opt {label} int8 group {q.group_size} "
                          f"{rows} rows",
                    path=path, replaces=TPU + "quant_matmul.py:100",
                    source=SRC + ("quant_matmul_mma.cu" if mma
                                  else "quant_matmul.cu"),
                    kernel=kernel,
                    plain=lambda x=x, q=q: qm.qmm_group_plain(x, q)[
                        :, :q.out_features],
                    **({"forms": {"unsplit": unsplit(qm, kernel)}}
                       if split else {}),
                    library=lambda x=x, w=wd: torch.matmul(x, w),
                    bytes=nbytes(x, q.qweight, q.scales)
                    + 2 * rows * q.out_physical,
                    ops=2 * rows * din * q.out_physical, kind="bf16"))
    H, S, D = 32, 2048, 64
    for B, path in ((1, OPT_DECODE), (SLOTS, OPT_BATCH)):
        q = randn(B, H, 1, D)
        kc, vc = randn(B, H, S, D), randn(B, H, S, D)
        pos = torch.tensor([SHORT + OPT_STEPS - 1 - 37 * i for i in range(B)],
                           dtype=torch.int32, device=dev)
        live = pos + 1
        cols = torch.arange(S, device=dev)
        mask = (cols[None] <= pos[:, None])[:, None, None]
        args = (q, kc, vc, pos)
        out.append(dict(
            name="flash_decode", shape=f"opt {B}x{H}x{S}x{D} pos "
                                      f"{int(pos.min())}-{int(pos.max())}",
            path=path, replaces=TPU + "attention.py:294",
            source=SRC + "flash_decode.cu",
            kernel=lambda a=args: att.flash_decode(*a),
            plain=lambda a=args: att.flash_decode_plain(*a),
            **({"forms": {"unsplit": lambda a=args: att.flash_decode(
                *a, _splits=1)}} if att.launch_splits(B, H, S) > 1 else {}),
            library=lambda q=q, kc=kc, vc=vc, mask=mask:
                torch.nn.functional.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask),
            bytes=2 * H * int(live.sum()) * D * 2 + 2 * nbytes(q)
            + nbytes(pos),
            ops=4 * H * int(live.sum()) * D, kind="bf16"))
        if B == 1:
            splits = att.launch_splits(1, H, S)
            part = att.flash_decode_split_plain(q, kc, vc, pos,
                                                splits).contiguous()
            out.append(dict(
                name="flash_decode_merge", shape=f"opt {H} heads x {splits} "
                                                 f"splits of D {D}",
                path=path, replaces=TPU + "attention.py:294",
                source=SRC + "flash_decode.cu",
                kernel=lambda part=part: att.flash_decode_merge(part),
                plain=lambda part=part: att.flash_decode_merge_plain(part),
                library=None, bytes=nbytes(part) + 2 * H * D,
                ops=3 * H * splits * D, kind="f32"))
    return out


def capture(torch, fn):
    """fn captured in a CUDA graph after a warm-up run on a side stream
    (whose writes the caller undoes); replay() runs it again."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def opt_step_bytes(cfg, params, pos):
    """Bytes one decode step at batch 1 must read: every layer tensor once
    (int8 codes and their scales, or the bf16 weights; biases and norms),
    the tied wte once for the lm_head, and the live K and V rows [0, pos]
    of every layer."""
    def size(v):
        if hasattr(v, "qweight"):
            return size(v.qweight) + size(v.scales)
        return v.numel() * v.element_size()

    layers = sum(size(v) for lay in params["layers"] for v in lay.values())
    wte = size(params["wte"])
    kv = 2 * cfg.n_layers * cfg.n_heads * (pos + 1) * cfg.head_dim * 2
    return layers + wte + kv, layers, wte, kv


def opt_prefill_step(torch, opt, params, cfg, prompt, dev):
    """(last prefill logits row, the next decode step's logits) of params
    on dev from the prompt, greedy."""
    cache = opt.init_opt_cache(cfg, prompt.shape[0], device=dev)
    lp, cache = opt.opt_prefill(params, cfg, prompt.to(dev), cache)
    tok = lp[:, -1].argmax(-1).int()
    pos = torch.full((prompt.shape[0],), prompt.shape[1], dtype=torch.int32,
                     device=dev)
    ld, _ = opt.opt_decode_step(params, cfg, tok, pos, cache)
    return lp[:, -1].float().cpu(), ld.float().cpu()


def opt_path(torch, opt, kvcache, qm, att, counters, dev, report, steps,
             bw_copy):
    """Phase 15: OPT-1.3B (OPTConfig.opt_1b3(): dim 2048, 24 layers, 32
    heads of 64, FFN 8192, vocab 50272), random weights from a seed, bf16
    activations and cache, in bf16 and with INT8 weights at group
    OPT_GROUP. Each form: its first CPU_LAYERS layers against the CPU
    plain path (the SHORT-token prompt's last logits and the next step's);
    at full depth the prefill of SHORT tokens (ms, launches pinned), the
    decode of the prompt's last token against the prefill's logits, then
    OPT_STEPS greedy steps eager and from one captured step (tokens equal
    up to a near-tie; ms a step, tok/s against the copy-rate roofline of
    opt_step_bytes); INT8 also a batch of 8 prompts of OPT_LENS tokens,
    its first batched step against each prompt's batch-1 step. Returns
    {path: launches}."""
    cfg = opt.OPTConfig.opt_1b3()
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    dense = opt.init_opt_params(cfg, gen, device=dev)
    forms = {"bf16": dense,
             "int8": opt.quantize_opt_params(dense, 8, OPT_GROUP)}
    prompt = torch.randint(0, cfg.vocab_size, (1, SHORT), generator=gen,
                           device=dev, dtype=torch.int32)
    ccfg = dataclasses.replace(cfg, n_layers=CPU_LAYERS)
    cpu = torch.device("cpu")
    res, paths = {}, {}
    for label, params in forms.items():
        r = res[label] = {}
        t0 = time.perf_counter()
        cut = dict(params, layers=params["layers"][:CPU_LAYERS])
        got = opt_prefill_step(torch, opt, cut, ccfg, prompt, dev)
        want = opt_prefill_step(torch, opt, to_cpu(cut), ccfg, prompt, cpu)
        for i, what in enumerate(("prefill", "decode")):
            compare_logits(torch, f"opt {label} {what} {CPU_LAYERS} layers "
                           "vs cpu", got[i][0], want[i][0], report)
        r["cpu_check_s"] = time.perf_counter() - t0

        # the prompt at full depth: launches, ms (min of 3)
        cache = opt.init_opt_cache(cfg, 1, device=dev)
        counters.reset()
        logits, _ = opt.opt_prefill(params, cfg, prompt, cache)
        torch.cuda.synchronize()
        pre = counters.read()
        pre = {k: v for k, v in pre.items() if v}
        want_pre = {"qmm_group": 4 * L, "qmm_group_mma": 4 * L} \
            if label == "int8" else {}
        if pre != want_pre:
            fail(f"opt {label} prefill launched {pre}, expected {want_pre}")
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt.opt_prefill(params, cfg, prompt, cache)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t1)
        r["prefill_ms"] = 1e3 * min(samples)
        r["prefill_ms_samples"] = [1e3 * t for t in samples]
        r["prefill_launches"] = pre
        # decode at t against the prefill at t
        c2 = opt.init_opt_cache(cfg, 1, device=dev)
        opt.opt_prefill(params, cfg, prompt[:, :-1], c2)
        ld, _ = opt.opt_decode_step(
            params, cfg, prompt[:, -1], torch.full(
                (1,), SHORT - 1, dtype=torch.int32, device=dev), c2)
        compare_logits(torch, f"opt {label} decode vs prefill at {SHORT - 1}",
                       ld[0], logits[0, -1], report)
        del c2

        # OPT_STEPS greedy steps, eager
        opt.opt_prefill(params, cfg, prompt, cache)
        first = logits[:, -1].argmax(-1).int()
        tok, pos = first.clone(), torch.full((1,), SHORT, dtype=torch.int32,
                                             device=dev)
        eager_toks, eager_logits = [], []
        counters.reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(OPT_STEPS):
            lg, _ = opt.opt_decode_step(params, cfg, tok, pos, cache)
            tok = lg.argmax(-1).int()
            pos = pos + 1
            eager_toks.append(tok)
            eager_logits.append(lg[0])
        torch.cuda.synchronize()
        r["eager_ms_per_step"] = 1e3 * (time.perf_counter() - t1) / OPT_STEPS
        run = {k: v for k, v in counters.read().items() if v}
        if any(v % OPT_STEPS for v in run.values()):
            fail(f"opt {label}: {OPT_STEPS} steps launched {run}")
        step = {k: v // OPT_STEPS for k, v in run.items()}
        want_step = {"flash_decode": L,
                     **att.merge_launches(L, 1, cfg.n_heads, cfg.max_seq)}
        if label == "int8":
            lay = params["layers"][0]
            want_step.update(qmm_group=4 * L, qmm_group_split=L * split_launches(
                qm, [lay[k] for k in ("w_qkv", "w_o", "w_up", "w_down")]))
            want_step = {k: v for k, v in want_step.items() if v}
        if step != want_step:
            fail(f"opt {label}: a decode step launched {step}, expected "
                 f"{want_step}")
        r["step_launches"] = step

        # the same steps from one captured step
        opt.opt_prefill(params, cfg, prompt, cache)
        tok_s = first.clone()
        pos_s = torch.full((1,), SHORT, dtype=torch.int32, device=dev)

        def one():
            lg, _ = opt.opt_decode_step(params, cfg, tok_s, pos_s, cache)
            tok_s.copy_(lg.argmax(-1))
            pos_s.add_(1)

        graph = capture(torch, one)

        def reset():
            opt.opt_prefill(params, cfg, prompt, cache)
            tok_s.copy_(first)
            pos_s.fill_(SHORT)

        reset()
        cap_toks = []
        for _ in range(OPT_STEPS):
            graph.replay()
            cap_toks.append(tok_s.clone())
        ct = torch.cat(cap_toks).tolist()
        et = torch.cat(eager_toks).tolist()
        if ct != et:
            i = next(j for j in range(OPT_STEPS) if ct[j] != et[j])
            lg = eager_logits[i].float()
            gap = float(lg[et[i]] - lg[ct[i]]) / float(lg.abs().max())
            print(f"# opt {label}: captured and eager tokens part at step "
                  f"{i} (near-tie, gap {gap:.3g} of max|logit|)", flush=True)
            if gap > TIE:
                fail(f"opt {label}: captured tokens {ct[:i + 1]} vs eager "
                     f"{et[:i + 1]}, gap {gap}")
        times = []
        for _ in range(3):
            reset()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(OPT_STEPS):
                graph.replay()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / OPT_STEPS)
        reset()
        prof = device_profile(torch, lambda: [graph.replay()
                                              for _ in range(OPT_STEPS)],
                              CUBLAS_KINDS)
        if prof:
            prof["kernel_ms_per_token"] = {
                k: v / OPT_STEPS for k, v in prof.pop("kernel_ms").items()}
        r["device_profile"] = prof
        del graph
        nbytes, wbytes, wte, kv = opt_step_bytes(cfg, params,
                                                 SHORT + OPT_STEPS // 2)
        r.update(graph_ms_per_step=min(times), graph_ms_samples=times,
                 tok_s=1e3 / min(times), bytes_per_token=nbytes,
                 layer_bytes=wbytes, wte_bytes=wte, kv_bytes=kv,
                 roofline_tok_s=bw_copy / nbytes)
        print(f"# opt-1.3b {label}: prefill {SHORT} {r['prefill_ms']:.2f} ms "
              f"(samples {r['prefill_ms_samples']}); decode {OPT_STEPS} steps "
              f"eager {r['eager_ms_per_step']:.3f} ms a step, captured "
              f"{r['graph_ms_per_step']:.3f} ms ({r['tok_s']:.1f} tok/s, "
              f"samples {times}); {nbytes / 1e9:.4f} GB a token (layers "
              f"{wbytes / 1e9:.4f}, wte {wte / 1e9:.4f}, KV {kv / 1e9:.4f}) "
              f"-> copy-rate roofline {r['roofline_tok_s']:.1f} tok/s "
              f"({100 * r['tok_s'] / r['roofline_tok_s']:.1f} %); launches "
              f"a step {step}, a prompt {pre}; profile {prof}", flush=True)
        if label == "int8":
            paths[OPT_DECODE] = run
            steps[OPT_DECODE] = step
            paths[OPT_PROMPT] = pre
            paths[OPT_BATCH] = steps[OPT_BATCH] = opt_batch(
                torch, opt, kvcache, att, params, cfg, counters, dev, report,
                r)
        res[label]["seconds"] = time.perf_counter() - t0
    report["opt_1b3"] = res
    del dense, forms
    return paths


def opt_batch(torch, opt, kvcache, att, params, cfg, counters, dev, report,
              r):
    """Phase 15's batch of 8: each prompt of OPT_LENS tokens prefilled
    alone and written into its slot of one batch cache; one batched step
    at the prompts' own positions against each prompt's batch-1 step
    (compare_logits_rows); its launches and eager / captured ms."""
    B = len(OPT_LENS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 151)
    cache = opt.init_opt_cache(cfg, B, device=dev)
    toks, singles = [], []
    for i, n in enumerate(OPT_LENS):
        p = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                          device=dev, dtype=torch.int32)
        one = opt.init_opt_cache(cfg, 1, device=dev)
        lp, one = opt.opt_prefill(params, cfg, p, one)
        kvcache.merge_prefill_into_slot(cache, one, i)
        tok = lp[:, -1].argmax(-1).int()
        ld, _ = opt.opt_decode_step(
            params, cfg, tok, torch.full((1,), n, dtype=torch.int32,
                                         device=dev), one)
        toks.append(tok)
        singles.append(ld[0].float())
        del one
    tok = torch.cat(toks)
    pos = torch.tensor(OPT_LENS, dtype=torch.int32, device=dev)
    state = [c.clone() for c in cache["k"] + cache["v"]]
    counters.reset()
    lg, _ = opt.opt_decode_step(params, cfg, tok, pos, cache)
    torch.cuda.synchronize()
    step = {k: v for k, v in counters.read().items() if v}
    L = cfg.n_layers
    want = {"qmm_group": 4 * L, "qmm_group_mma": 4 * L, "flash_decode": L,
            **att.merge_launches(L, B, cfg.n_heads, cfg.max_seq)}
    if step != want:
        fail(f"{OPT_BATCH}: a step launched {step}, expected {want}")
    compare_logits_rows(torch, f"{OPT_BATCH} vs batch-1 steps", lg.float(),
                        torch.stack(singles), report)

    def restore():
        for c, s in zip(cache["k"] + cache["v"], state):
            c.copy_(s)

    def eager():
        restore()
        opt.opt_decode_step(params, cfg, tok, pos, cache)

    r["batch8_eager_ms"] = cuda_ms(torch, eager, 10)
    r["batch8_graph_ms"] = step_ms(torch, lambda: opt.opt_decode_step(
        params, cfg, tok, pos, cache))
    restore()
    print(f"# {OPT_BATCH} (prompts {OPT_LENS}): a step eager "
          f"{r['batch8_eager_ms']:.3f} ms (with a cache restore), captured "
          f"{r['batch8_graph_ms']:.3f} ms; launches {step}", flush=True)
    return step


def rel_err(np, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.abs(got - want).max() / np.abs(want).max())


def bert_path(torch, np, bert, onnx, GraphExecutor, cuda_runtime, dev,
              report):
    """Phase 16: BERT-base (BertConfig(): 12 layers, dim 768, 12 heads, f32)
    at BERT_SHAPE, random weights from a seed: bert_encode on the card
    against the CPU; build_bert_graph FP32 and dynamic-INT8 through
    GraphExecutor on the card, eager and captured (ms each); the FP32
    graph against the CPU's eager executor and bert_encode (BERT_TOL of
    max|h|); INT8 against FP32 (mean|dh| / rms(h) < BERT_INT8_GATE); the
    INT8 graph exported with export_onnx, re-imported with OnnxStub and run
    on the card, bit for bit the in-memory graph's output."""
    cfg = bert.BertConfig()
    B, S = BERT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    params = bert.init_bert_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    r = {}
    h_card = bert.bert_encode(params, cfg, tokens)
    h_cpu = bert.bert_encode(to_cpu(params), cfg, tokens.cpu())
    r["encode_rel_err"] = rel_err(np, h_card.cpu(), h_cpu)
    if r["encode_rel_err"] > BERT_TOL:
        fail(f"bert_encode: {r['encode_rel_err']} of max|h| from the CPU")
    r["encode_ms"] = cuda_ms(torch, lambda: bert.bert_encode(params, cfg,
                                                             tokens), 10)
    feeds = {"tokens": tokens.cpu().numpy()}
    outs = {}
    for label, dq in (("fp32", False), ("int8", True)):
        h = bert.build_bert_graph(cfg, params, B, S, dynamic_quant=dq)
        eager = GraphExecutor(h.graph, device=dev, use_cuda_graph=False)
        cap = GraphExecutor(h.graph, device=dev)
        (oe,) = eager.run(feeds, return_numpy=True).values()
        (oc,) = cap.run(feeds, return_numpy=True).values()
        r[f"{label}_eager_vs_captured"] = rel_err(np, oc, oe)
        if r[f"{label}_eager_vs_captured"] > 1e-5:
            fail(f"bert {label}: captured {r[f'{label}_eager_vs_captured']} "
                 "of max|h| from eager")
        r[f"{label}_eager_ms"] = eager.time_ms(feeds)
        r[f"{label}_graph_ms"] = cap.time_ms(feeds)
        r[f"{label}_ops"] = len(h.graph.operators)
        outs[label] = (h, oc)
    h32, o32 = outs["fp32"]
    (want,) = GraphExecutor(h32.graph, device="cpu").run(
        feeds, return_numpy=True).values()
    r["fp32_graph_rel_err"] = rel_err(np, o32, want)
    r["fp32_graph_vs_encode"] = rel_err(np, o32, h_card.cpu())
    if max(r["fp32_graph_rel_err"], r["fp32_graph_vs_encode"]) > BERT_TOL:
        fail(f"bert fp32 graph: {r['fp32_graph_rel_err']} of max|h| from "
             f"the CPU, {r['fp32_graph_vs_encode']} from bert_encode")
    h8, o8 = outs["int8"]
    dh = np.abs(o8.astype(np.float64) - o32)
    r["int8_vs_fp32"] = float(dh.mean() / np.sqrt((o32.astype(
        np.float64) ** 2).mean()))
    if not r["int8_vs_fp32"] < BERT_INT8_GATE:
        fail(f"bert int8: mean|dh| / rms(h) {r['int8_vs_fp32']}")
    t0 = time.perf_counter()
    data = onnx.export_onnx(h8.graph, "bert_base_int8").serialize()
    stub = onnx.OnnxStub(data, cuda_runtime())
    r["onnx_round_trip_s"] = time.perf_counter() - t0
    (got,) = stub.run(feeds, return_numpy=True).values()
    if not np.array_equal(got, o8):
        fail(f"bert int8 ONNX round trip: {rel_err(np, got, o8)} of max|h| "
             "from the in-memory graph")
    r["onnx_graph_ms"] = stub.handler.executor().time_ms(feeds)
    r["onnx_mb"] = len(data) / 1e6
    report["bert_base"] = r
    print(f"# bert-base B{B} S{S}: encode {r['encode_ms']:.3f} ms (rel err "
          f"{r['encode_rel_err']:.3g} vs cpu); fp32 graph eager "
          f"{r['fp32_eager_ms']:.3f} / captured {r['fp32_graph_ms']:.3f} ms "
          f"(vs cpu {r['fp32_graph_rel_err']:.3g}, vs encode "
          f"{r['fp32_graph_vs_encode']:.3g}); int8 graph eager "
          f"{r['int8_eager_ms']:.3f} / captured {r['int8_graph_ms']:.3f} ms, "
          f"mean|dh|/rms(h) {r['int8_vs_fp32']:.4f}; ONNX "
          f"{r['onnx_mb']:.1f} MB, round trip bit-exact, captured "
          f"{r['onnx_graph_ms']:.3f} ms", flush=True)


def vision_path(torch, np, vision, onnx, lowering, GraphExecutor,
                cuda_runtime, dev, report):
    """Phase 17: ResNet-18-v2, DenseNet-121, Inception-v2 and
    EfficientNet-Lite4 at VISION_IMAGE, batch 1, 1000 classes, f32, random
    weights from a seed: each built, exported to ONNX bytes, re-imported
    with OnnxStub and run on the card (captured), within VISION_TOL of
    max|ref| of the directly built graph on the CPU's eager executor and
    bit for bit the directly built graph's output on the card; ms an image
    (captured replays), the exported MB, and, for the record, the error
    of the same graph with cuDNN's TF32 left on (the lowering turns it off
    for its f32 convolutions)."""
    import contextlib
    models = {"resnet18_v2": (vision.init_resnet18_params,
                              vision.build_resnet18),
              "densenet121": (vision.init_densenet_params,
                              vision.build_densenet),
              "inception_v2": (vision.init_inception_v2_params,
                               vision.build_inception_v2),
              "efficientnet_lite4": (vision.init_efficientnet_lite4_params,
                                     vision.build_efficientnet_lite4)}
    res = {}
    for name, (init, build) in models.items():
        rng = np.random.default_rng(SEED)
        h = build(init(rng), batch=1, image=VISION_IMAGE)
        h.runtime = cuda_runtime()
        img = {"input": rng.standard_normal(
            (1, 3, VISION_IMAGE, VISION_IMAGE)).astype(np.float32)}
        t0 = time.perf_counter()
        (ref,) = GraphExecutor(h.graph, device="cpu").run(
            img, return_numpy=True).values()
        cpu_s = time.perf_counter() - t0
        (direct,) = h.run(img, return_numpy=True).values()
        t0 = time.perf_counter()
        data = onnx.export_onnx(h.graph, name).serialize()
        stub = onnx.OnnxStub(data, cuda_runtime())
        trip_s = time.perf_counter() - t0
        (got,) = stub.run(img, return_numpy=True).values()
        err = rel_err(np, got, ref)
        if not err <= VISION_TOL:
            fail(f"{name}: {err} of max|ref| from the CPU")
        if not np.array_equal(got, direct):
            fail(f"{name}: the ONNX round trip is {rel_err(np, got, direct)}"
                 " of max|out| from the directly built graph")
        saved = lowering._exact_f32_conv
        lowering._exact_f32_conv = lambda x: contextlib.nullcontext()
        try:
            (tf32,) = GraphExecutor(h.graph, device=dev, use_cuda_graph=False
                                    ).run(img, return_numpy=True).values()
        finally:
            lowering._exact_f32_conv = saved
        res[name] = dict(
            rel_err=err, tf32_rel_err=rel_err(np, tf32, ref),
            ms=stub.handler.executor().time_ms(img), onnx_mb=len(data) / 1e6,
            ops=len(h.graph.operators), cpu_s=cpu_s, round_trip_s=trip_s,
            top5=np.argsort(got[0])[-5:][::-1].tolist())
        r = res[name]
        print(f"# {name} {VISION_IMAGE}x{VISION_IMAGE}: {r['ms']:.3f} ms an "
              f"image (captured), ONNX {r['onnx_mb']:.1f} MB, {r['ops']} ops, "
              f"rel err {err:.3g} vs cpu (TF32 on: "
              f"{r['tf32_rel_err']:.3g}), round trip bit-exact", flush=True)
    report["vision"] = res


def onnx_kernel_path(torch, np, GraphHandler, onnx, GraphExecutor,
                     cuda_runtime, counters, dev, report):
    """Phase 18: the graph corpus's kernel cases (tests/torch_graph_cases.py
    case_matmul_woq, case_attention_kvcache) exported and re-imported on
    the card: one eager run of the imported graph launches what the
    directly built graph's does (qmm_group / qmm_group_norm,
    flash_decode(_q8), each nonzero) and gives its outputs bit for bit;
    the imported graph captured within 1e-5 of max|out|. Returns the
    imported graphs' launches."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_graph_cases", os.path.join(here, "tests",
                                          "torch_graph_cases.py"))
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)
    total, res = {}, {}
    for name, kernel in (("matmul_woq", "qmm_group"),
                         ("attention_kvcache", "flash_decode")):
        h = GraphHandler(cuda_runtime())
        feeds = getattr(corpus, "case_" + name)(h, np.random.default_rng(0))
        h.graph.infer_output_roles()
        stub = onnx.OnnxStub(onnx.export_onnx(h.graph, name).serialize(),
                             cuda_runtime())
        runs = {}
        for label, graph in (("direct", h.graph),
                             ("onnx", stub.handler.graph)):
            counters.reset()
            out = GraphExecutor(graph, device=dev, use_cuda_graph=False).run(
                feeds, return_numpy=True)
            torch.cuda.synchronize()
            runs[label] = (out, {k: v for k, v in counters.read().items()
                                 if v})
        (d_out, d_n), (o_out, o_n) = runs["direct"], runs["onnx"]
        if o_n != d_n or o_n.get(kernel, 0) <= 0:
            fail(f"onnx {name}: the imported graph launched {o_n}, the "
                 f"direct one {d_n}")
        if set(o_out) != set(d_out) or not all(
                np.array_equal(np.asarray(o_out[k]), np.asarray(d_out[k]))
                for k in d_out):
            fail(f"onnx {name}: the imported graph's outputs differ")
        cap = stub.run(feeds, return_numpy=True)
        err = max(rel_err(np, cap[k], d_out[k]) for k in d_out
                  if np.asarray(d_out[k]).dtype.kind == "f")
        if err > 1e-5:
            fail(f"onnx {name}: captured {err} of max|out| from eager")
        res[name] = {"launches": o_n, "captured_rel_err": err}
        for k, v in o_n.items():
            total[k] = total.get(k, 0) + v
        print(f"# onnx {name}: imported graph launches {o_n} (as the direct "
              f"graph), outputs bit-exact; captured {err:.3g}", flush=True)
    report["onnx_kernels"] = res
    return total


# -- phase 19: the optimizer's search on the card, the qkv merge, the -------
# -- tuner's sweeps and the memory planner's report --------------------------

SEARCH_F32, SEARCH_BF16 = "search longformer f32", "search longformer bf16"
TUNED, TUNED_OPT = "tuned decode", "tuned opt decode"
QKV = dict(layers=12, batch=8, dim=2048)   # tools/rewrite_speedup.py defaults
QKV_TOL = 1e-4                             # of max|out| of the unoptimized
PAIRS = 6                                  # captured timings in turns


def longformer_block(np, GraphHandler, onnx, cuda_runtime, dtype):
    """tools/rewrite_speedup.py build_longformer at LF in `dtype` ("float32"
    or "bfloat16": inputs and the 0 / -1e9 band mask): the masked S x S
    attention in standard ops, exported to ONNX bytes and imported twice
    (the graph as it stands, and the one the search rewrites)."""
    bz, S, D, W = LF["batch"] * LF["heads"], LF["seq"], LF["head_dim"], \
        LF["w"]
    i = np.arange(S)
    mask = np.where(np.abs(i[:, None] - i[None, :]) <= W, np.float32(0),
                    np.float32(-1e9))
    if dtype == "bfloat16":
        import ml_dtypes
        mask = mask.astype(ml_dtypes.bfloat16)
    h = GraphHandler(cuda_runtime(), name="longformer_block")
    q, k, v = (h.input((bz, S, D), dtype=dtype, name=n) for n in "qkv")
    m = h.weight(mask, name="band_mask")
    scores = h.matmul(q, h.transpose(k, perm=[0, 2, 1]))
    h.matmul(h.softmax(h.add(scores, m), axis=-1), v)
    h.graph.infer_output_roles()
    data = onnx.export_onnx(h.graph, "longformer").serialize()

    def imported():
        g = onnx.OnnxStub(data, cuda_runtime()).handler.graph
        g.infer_output_roles()
        return g
    return imported(), imported()


def op_values(ex, feeds):
    """[(op type, first output)] of an eager run of ex's graph, op by op
    through the lowering, on the values GraphExecutor.profile gives each
    op."""
    from infinitensor_tpu_torch.ops.lowering import lower_op
    inputs = ex._materialize_inputs(feeds)
    env = {t.guid: inputs[t.name] for t in ex._inputs}
    for name, arr in ex.bound_weights().items():
        env[ex._weights[name].guid] = arr
    env.update(ex._constants(env))
    out = []
    for op in ex.graph.operators:
        outs = lower_op(op, [env[t.guid] if t is not None else None
                             for t in op.inputs], ex.ctx)
        for t, v in zip(op.outputs, outs):
            env[t.guid] = v
        out.append((op.op_type, outs[0]))
    return out


def band_agreement(torch, ex_band, ex_dense, feeds, W):
    """Where the band graph and the standard-op graph agree, op by op: the
    dense scores, masked scores and Softmax gathered at the band's
    positions (rows i - W .. i + W that lie in [0, S)) against the band
    form's G2BMM, Add and Softmax, then the outputs; for each, the share
    of positions that are equal bit for bit and the largest difference.
    Also whether the dense Softmax is exactly 0 off the band."""
    band = [(t, v) for t, v in op_values(ex_band, feeds)
            if t in ("G2BMM", "Add", "Softmax", "GBMM")]
    dense = [(t, v) for t, v in op_values(ex_dense, feeds)
             if t in ("MatMul", "Add", "Softmax")]
    (_, b_sc), (_, b_add), (_, b_p), (_, b_out) = band
    (_, d_sc), (_, d_add), (_, d_p), (_, d_out) = dense
    S = d_sc.shape[-1]
    i = torch.arange(S, device=d_sc.device)
    idx = i[:, None] - W + torch.arange(2 * W + 1, device=d_sc.device)
    valid = ((idx >= 0) & (idx < S)).expand(b_sc.shape)
    idx = idx.clamp(0, S - 1).expand(b_sc.shape)
    out = {}
    for name, b, d in (("scores", b_sc, d_sc), ("masked", b_add, d_add),
                       ("softmax", b_p, d_p)):
        g = d.gather(-1, idx)
        same = (g == b) & valid
        out[name] = {"equal_share": same.sum().item() / valid.sum().item(),
                     "max_abs_diff": ((g.double() - b.double()).abs()
                                      * valid).max().item()}
    on = torch.zeros_like(d_p, dtype=torch.int32)
    on.scatter_add_(-1, idx, valid.int())
    out["softmax_zero_off_band"] = bool((d_p[on == 0] == 0).all().item())
    out["output"] = {"equal_share": (b_out == d_out).float().mean().item(),
                     "max_abs_diff": (b_out.double() - d_out.double()).abs()
                     .max().item()}
    return out


def search_path(torch, np, GraphHandler, onnx, GraphExecutor, cuda_runtime,
                counters, dev, report, steps):
    """Phase 19a: the Longformer block of tools/rewrite_speedup.py:164-190
    (standard ops through ONNX, batch 1, 8 heads, S 2048, D 128, w 64) in
    f32 and bf16, searched on the card with a fresh PerfEngine
    (SearchEngine, RuleBasedMutator's band rule; each candidate's per-op
    cost sum printed). The winner must hold G2BMM and GBMM; one eager run
    of it launches g2bmm_ring and gbmm_ring once each; captured, it is held
    to the standard-op graph on the same inputs and to the dense masked
    attention in f64 within phase 13's limits, and the check must fail on
    an input with one row of v moved; both graphs captured are timed in
    turns (PAIRS pairs of 20 replays). Returns {path: launches}."""
    from infinitensor_tpu_torch.optimizer.search import SearchEngine
    from infinitensor_tpu_torch.runtime.perf import PerfEngine
    bz, S, D, W = LF["batch"] * LF["heads"], LF["seq"], LF["head_dim"], \
        LF["w"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    q, k, v = (torch.randn(bz, S, D, generator=gen, device=dev) * 0.5
               for _ in range(3))
    i = torch.arange(S, device=dev)
    band_mask = (i[:, None] - i[None, :]).abs() <= W

    def dense64(q, k, v):
        q, k, v = (t.double() for t in (q, k, v))
        sc = torch.where(band_mask, q @ k.transpose(1, 2), -math.inf)
        return torch.softmax(sc, -1) @ v

    paths, res = {}, {}
    want = {"g2bmm": 1, "g2bmm_ring": 1, "gbmm": 1, "gbmm_ring": 1}
    for label, dt, tdt in ((SEARCH_F32, "float32", torch.float32),
                           (SEARCH_BF16, "bfloat16", torch.bfloat16)):
        tol = LF_TOL[LONG_F32 if tdt == torch.float32 else LONG_BF16]
        t0 = time.perf_counter()
        base, cand = longformer_block(np, GraphHandler, onnx, cuda_runtime,
                                      dt)
        engine = SearchEngine(perf=PerfEngine(), device=dev)
        win = engine.run(cand)
        search_s = time.perf_counter() - t0
        costs = [{"kind": h["kind"], "cost_ms": h["cost_ms"],
                  "ops": h["ops"]} for h in engine.history]
        for c in costs:
            print(f"# {label}: {c['kind']} {c['ops']}: per-op cost sum "
                  f"{c['cost_ms']:.4f} ms", flush=True)
        kinds = {op.op_type for op in win.operators}
        if not {"G2BMM", "GBMM"} <= kinds:
            fail(f"{label}: the search kept {sorted(kinds)}, not the band "
                 "form")
        feeds = {"q": q.to(tdt), "k": k.to(tdt), "v": v.to(tdt)}
        counters.reset()
        (out,) = GraphExecutor(win, device=dev, use_cuda_graph=False).run(
            feeds).values()
        torch.cuda.synchronize()
        paths[label] = steps[label] = counters.read()
        if paths[label] != want:
            fail(f"{label}: the winner launched {paths[label]}, expected "
                 f"{want}")
        ex_win, ex_base = (GraphExecutor(g, device=dev) for g in (win, base))
        (got,) = ex_win.run(feeds).values()
        (dense,) = ex_base.run(feeds).values()
        ref = dense64(*feeds.values())
        top = ref.abs().max().item()
        err = (got.double() - ref).abs().max().item() / top
        err_dense = (dense.double() - ref).abs().max().item() / top
        err_pair = (got.double() - dense.double()).abs().max().item() / top
        equal = torch.equal(got, dense)
        agree = band_agreement(torch, ex_win, ex_base, feeds, W)
        print(f"# {label}: op by op, band against the standard-op graph: "
              + json.dumps(agree), flush=True)
        v_p = feeds["v"].clone()
        v_p[0, S // 2] += 8
        (got_p,) = ex_win.run({**feeds, "v": v_p}).values()
        err_p = (got_p.double() - ref).abs().max().item() / top
        print(f"# {label}: searched in {search_s:.1f}s; winner "
              f"{[op.op_type for op in win.operators]}; captured rel err "
              f"{err:.3g} against f64 dense (limit {tol}), {err_pair:.3g} "
              f"against the standard-op graph (whose own is "
              f"{err_dense:.3g}; bit for bit equal: {equal}); with v "
              f"perturbed {err_p:.3g}", flush=True)
        if got.dtype != tdt or got.shape != (bz, S, D) or \
                not math.isfinite(err) or err > tol or err_pair > tol:
            fail(f"{label}: {got.dtype} {tuple(got.shape)}, rel err {err} "
                 f"against f64, {err_pair} against the standard-op graph")
        if not err_p > tol:
            fail(f"{label}: a perturbed v gives rel err {err_p}, within "
                 f"the limit {tol}: the check sees nothing")
        turns = {"band": [], "dense": []}
        for _ in range(PAIRS):
            turns["band"].append(ex_win.time_ms(feeds, iters=20))
            turns["dense"].append(ex_base.time_ms(feeds, iters=20))
        ratios = sorted(a / b for a, b in zip(turns["band"],
                                              turns["dense"]))
        res[label] = {
            "search_s": search_s, "candidates": costs,
            "winner": [op.op_type for op in win.operators],
            "launches": paths[label], "rel_err_vs_dense_f64": err,
            "rel_err_vs_standard_graph": err_pair,
            "bit_equal_to_standard_graph": equal,
            "op_by_op_agreement": agree,
            "standard_graph_rel_err_vs_dense_f64": err_dense,
            "rel_err_perturbed_v": err_p,
            "captured_ms_band": statistics.median(turns["band"]),
            "captured_ms_dense": statistics.median(turns["dense"]),
            "captured_ms_in_turns": turns,
            "band_over_dense_median": statistics.median(ratios)}
        print(f"# {label}: " + json.dumps({k: res[label][k] for k in (
            "captured_ms_band", "captured_ms_dense",
            "band_over_dense_median")}), flush=True)
        del ex_win, ex_base, ref, got, dense, got_p, v_p, engine
    report["search_longformer"] = res
    return paths


def qkv_graph(np, GraphHandler, cuda_runtime, layers, batch, dim):
    """tools/rewrite_speedup.py build_graph: per layer q, k, v = x @ W,
    relu(q + k + v) @ transpose(Wo), identity; f32, weights seeded."""
    rng = np.random.default_rng(SEED)
    h = GraphHandler(cuda_runtime(), name="rewrite_bench")
    x = h.input((batch, dim), name="x")
    for i in range(layers):
        ws = [h.weight(rng.standard_normal((dim, dim), np.float32)
                       * np.float32(dim ** -0.5), name=f"w{n}_{i}")
              for n in "qkv"]
        q, k, v = (h.matmul(x, w) for w in ws)
        s = h.relu(h.add(h.add(q, k), v))
        wo = h.weight(rng.standard_normal((dim, dim), np.float32)
                      * np.float32(dim ** -0.5), name=f"wo_{i}")
        x = h.identity(h.matmul(s, h.transpose(wo)))
    h.graph.infer_output_roles()
    return h.graph


def qkv_path(torch, np, GraphHandler, GraphExecutor, cuda_runtime, dev,
             report):
    """Phase 19b: the qkv workload of tools/rewrite_speedup.py:33-52 (QKV
    layers, batch 8, dim 2048, f32): optimize_graph(level=2), then the
    search with a fresh PerfEngine on the card (the merge variants and
    their per-op cost sums printed, the winner's MatMul count); the
    winner's captured output within QKV_TOL of max|out| of the
    unoptimized graph's, captured."""
    from infinitensor_tpu_torch.optimizer import optimize_graph
    from infinitensor_tpu_torch.optimizer.search import SearchEngine
    from infinitensor_tpu_torch.runtime.perf import PerfEngine
    t0 = time.perf_counter()
    base = qkv_graph(np, GraphHandler, cuda_runtime, **QKV)
    opt = optimize_graph(base.clone(), level=2)
    engine = SearchEngine(perf=PerfEngine(), device=dev)
    win = engine.run(opt)
    search_s = time.perf_counter() - t0
    variants = [h for h in engine.history if h["kind"] == "variant"]
    for h in variants:
        print(f"# qkv: variant {h['index']} ({h['ops'].get('MatMul', 0)} "
              f"MatMul, {h['ops'].get('Split', 0)} Split): per-op cost sum "
              f"{h['cost_ms']:.4f} ms", flush=True)
    mm = sum(op.op_type == "MatMul" for op in win.operators)
    x = torch.randn(QKV["batch"], QKV["dim"],
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 191), device=dev)
    ((_, got),) = GraphExecutor(win, device=dev).run({"x": x}).items()
    ((_, want),) = GraphExecutor(base, device=dev).run({"x": x}).items()
    top = want.abs().max().item()
    err = (got - want).abs().max().item() / top
    took = time.perf_counter() - t0
    print(f"# qkv ({QKV}): {len(base.operators)} ops -> "
          f"{len(opt.operators)} after optimize_graph(2) -> "
          f"{len(win.operators)} in the winner ({mm} MatMul) of "
          f"{len(variants)} variants; searched in {search_s:.1f}s, "
          f"{took:.1f}s in all; rel err against the unoptimized graph "
          f"{err:.3g} (limit {QKV_TOL})", flush=True)
    if not math.isfinite(err) or err > QKV_TOL or got.shape != want.shape:
        fail(f"qkv: the winner's output is {err} of max|out| from the "
             "unoptimized graph's")
    report["qkv_search"] = {
        "config": QKV, "ops": [len(base.operators), len(opt.operators),
                               len(win.operators)],
        "variants": variants, "winner_matmuls": mm, "rel_err": err,
        "search_s": search_s, "seconds": took}


def tuner_path(torch, att, qm, QuantizedLinear, dequantize_weight,
               counters, dev, report, steps, bw_copy):
    """Phase 19c: the tuner's sweeps with a fresh PerfEngine:
    tuned_flash_decode_q8 and tuned_flash_decode at the 7B decode (B 1, 32
    heads, S MAX_SEQ, D 128, pos CTX) and at OPT-1.3B's (32 heads, S 2048,
    D 64, pos 319), tuned_quant_matmul at 7B's wo and w_down (1 row bf16,
    int4 group 128). Each candidate's ms (cold, captured: the tuner's
    timer) and the pick beside the default rule's count (launch_splits,
    group_splits); every candidate must run; each tuned output within TOL
    of max|plain| of the kernel's plain version and of the default
    launch's output; a second pass over the same engine must time
    nothing. The second pass's launches are the paths TUNED and
    TUNED_OPT, and their rows are this phase's own: each kernel at the
    launch the tuner picked, and the merge where it picked a split,
    checked against its plain version and timed as phase 3 times its
    rows; every kernel the paths launched must have a row. Returns
    ({path: launches}, rows)."""
    from infinitensor_tpu_torch.runtime import tuner
    from infinitensor_tpu_torch.runtime.perf import PerfEngine
    gen = torch.Generator(device=dev).manual_seed(SEED + 192)
    timed = []
    time_call = tuner._time_call
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def counting(fn, args, *a):
        timed.append(1)
        return time_call(fn, args, *a)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(*shape, generator=gen, device=dev) * 0.015 + 0.005

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    cases = []
    for path, H, S, D, pos in ((TUNED, 32, MAX_SEQ, 128, CTX),
                               (TUNED_OPT, 32, 2048, 64, 319)):
        p = torch.full((1,), pos, dtype=torch.int32, device=dev)
        live = pos + 1
        qh = randn(1, H, 1, D)
        kc, vc, ks, vs = int8(1, H, S, D), int8(1, H, S, D), \
            scales(1, H, S), scales(1, H, S)
        kf = (kc[:, :, :live].float() * ks[:, :, :live, None]).to(
            torch.bfloat16)
        vf = (vc[:, :, :live].float() * vs[:, :, :live, None]).to(
            torch.bfloat16)
        kb, vb = randn(1, H, S, D), randn(1, H, S, D)
        shape = f"{H}x{S}x{D} pos {pos}"
        default = att.launch_splits(1, H, S)
        cases.append(dict(
            path=path, name="flash_decode_q8", shape=shape,
            tuned=tuner.tuned_flash_decode_q8, kernel=att.flash_decode_q8,
            plain=att.flash_decode_q8_plain,
            split_plain=att.flash_decode_q8_split_plain,
            args=(qh, kc, vc, ks, vs, p), default=default,
            replaces=TPU + "attention.py:345", source="flash_decode.cu",
            library=lambda qh=qh, kf=kf, vf=vf: sdpa(qh, kf, vf),
            bytes=2 * H * live * (D + 4) + 2 * nbytes(qh),
            ops=4 * H * live * D, kind="bf16", heads=H, D=D))
        cases.append(dict(
            path=path, name="flash_decode", shape=shape,
            tuned=tuner.tuned_flash_decode, kernel=att.flash_decode,
            plain=att.flash_decode_plain,
            split_plain=att.flash_decode_split_plain,
            args=(qh, kb, vb, p), default=default,
            replaces=TPU + "attention.py:294", source="flash_decode.cu",
            library=lambda qh=qh, kb=kb, vb=vb, n=live: sdpa(
                qh, kb[:, :, :n], vb[:, :, :n]),
            bytes=2 * H * live * D * 2 + 2 * nbytes(qh),
            ops=4 * H * live * D, kind="bf16", heads=H, D=D))
    for label, din in (("wo", 4096), ("w_down", 11008)):
        w = QuantizedLinear(int8(din // 2, 4096), (torch.rand(
            din // 128, 4096, generator=gen, device=dev) * 0.019 + 0.001).to(
            torch.bfloat16), 4, 128)
        x = randn(1, din)
        cases.append(dict(
            path=TUNED, name="qmm_group", shape=f"{label} 1 row",
            tuned=tuner.tuned_quant_matmul, kernel=qm.quant_matmul,
            plain=lambda x, w: qm.qmm_group_plain(x, w)[:, :w.out_features],
            args=(x, w), replaces=TPU + "quant_matmul.py:100",
            source="quant_matmul.cu",
            default=qm.group_splits(1, 4096, din // 2, 128,
                                    qm._build.sms(dev.index or 0)),
            library=lambda x=x, wd=dequantize_weight(w): torch.matmul(x, wd),
            bytes=nbytes(x, w.qweight, w.scales) + 2 * w.out_physical,
            ops=2 * din * w.out_physical, kind="bf16"))
    tuned_name = {"flash_decode_q8": "flash_decode_q8",
                  "flash_decode": "flash_decode",
                  "qmm_group": "quant_matmul"}
    pe = PerfEngine()
    res, paths = {}, {TUNED: {}, TUNED_OPT: {}}
    tuner._time_call = counting
    try:
        for c in cases:
            args = c["args"]
            got = c["tuned"](*args, perf_engine=pe)
            want, plain = c["kernel"](*args), c["plain"](*args)
            rec = tuner.record(tuned_name[c["name"]], args, pe)
            top = plain.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            err_plain = (got.float() - plain.float()).abs().max().item()
            key = f"{c['name']} {c['shape']}"
            c["pick"] = rec["config"]
            res[key] = {"default_splits": c["default"], **rec,
                        "max_abs_err_vs_default": err,
                        "max_abs_err_vs_plain": err_plain}
            print(f"# tuner {key}: " + ", ".join(
                f"{r['config']} {r['ms']:.4f} ms" for r in
                rec["candidates"]) + f" (cold, captured); picks "
                f"{rec['config']}, the default rule takes {c['default']} "
                f"splits; err {err:.3g} against the default launch, "
                f"{err_plain:.3g} against the plain version, of max "
                f"{top:.3g}", flush=True)
            if rec["skipped"] or len(rec["candidates"]) < 1 or \
                    got.shape != plain.shape or not err <= TOL * top or \
                    not err_plain <= TOL * top:
                fail(f"tuner {key}: skipped {rec['skipped']}, err {err} "
                     f"against the default launch, {err_plain} against "
                     "the plain version")
        n = len(timed)
        for c in cases:
            counters.reset()
            c["tuned"](*c["args"], perf_engine=pe)
            torch.cuda.synchronize()
            for k, v in counters.read().items():
                paths[c["path"]][k] = paths[c["path"]].get(k, 0) + v
    finally:
        tuner._time_call = time_call
    if len(timed) != n:
        fail(f"tuner: the second pass timed {len(timed) - n} candidates")
    rows = []
    for c in cases:
        splits = c["pick"].get("_splits", 1)
        rows.append(dict(
            name=c["name"], path=c["path"], replaces=c["replaces"],
            shape=f"{c['shape']}, the tuner's {splits} splits",
            source=SRC + c["source"],
            kernel=lambda c=c: c["kernel"](*c["args"], **c["pick"]),
            plain=lambda c=c: c["plain"](*c["args"]),
            library=c["library"], bytes=c["bytes"], ops=c["ops"],
            kind=c["kind"]))
        if c["name"] != "qmm_group" and splits > 1:
            H, D = c["heads"], c["D"]
            part = c["split_plain"](*c["args"], splits).contiguous()
            rows.append(dict(
                name="flash_decode_merge", path=c["path"],
                shape=f"{H} heads x {splits} splits of D {D} "
                      f"({c['name']})",
                replaces=c["replaces"], source=SRC + "flash_decode.cu",
                kernel=lambda part=part: att.flash_decode_merge(part),
                plain=lambda part=part: att.flash_decode_merge_plain(part),
                library=None, bytes=nbytes(part) + 2 * H * D,
                ops=3 * H * splits * D, kind="f32"))
    for path in (TUNED, TUNED_OPT):
        steps[path] = paths[path]
        have = {r["name"] for r in rows if r["path"] == path}
        for kname, k in paths[path].items():
            if k and kname not in have and kname != "qmm_group_split" \
                    and not kname.endswith("_any"):
                fail(f"the path {path} launched {kname}, which has no row")
        for kname in have:
            if paths[path].get(kname, 0) <= 0:
                fail(f"{kname} was never launched on the path {path}")
    print(f"# tuner: {n} candidates timed; the second pass timed none and "
          f"launched {paths}", flush=True)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    for r in rows:
        check_and_time(torch, r, counters, flush, bw_copy)
    del flush
    report["tuner"] = res
    return paths, rows


def memory_path(torch, llama, graph_llama, GraphExecutor, QuantizedLinear,
                dev, report):
    """Phase 19d: memory_report (the native planner over the graph IR) of
    the graph-built 7B decode at 2 layers, printed beside
    torch.cuda.max_memory_allocated over one captured step of it (not
    asserted: the planner plans the IR's tensors, the executor allocates
    through PyTorch's caching allocator and the graph's pool)."""
    from infinitensor_tpu_torch.runtime.profiling import memory_report
    cfg2 = dataclasses.replace(llama.LlamaConfig(max_seq=MAX_SEQ),
                               n_layers=2)
    params2 = build_params(torch, cfg2, torch.Generator(
        device=dev).manual_seed(SEED + 193), dev, QuantizedLinear)
    dec = graph_llama.build_llama_decoder(params2, cfg2, batch=1,
                                          max_seq=MAX_SEQ, kv_quant=True,
                                          external_weights=True)
    plan = {k: v for k, v in memory_report(dec.graph).items()
            if k != "offsets"}
    ex = GraphExecutor(dec.graph, device=dev)
    graph_llama.bind_llama_weights(dec, ex, params2)
    step = ex.stepper(dec.state_map())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step({dec.token_name: torch.zeros(1, dtype=torch.int32, device=dev),
          dec.pos_name: torch.full((1,), CTX, dtype=torch.int32,
                                   device=dev)})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"memory_report": plan, "max_memory_allocated": peak,
           "allocated_before": before, "peak_over_before": peak - before}
    print(f"# memory, graph-built 7B at 2 layers ({len(dec.graph.operators)}"
          f" ops): memory_report {plan}; captured step: "
          f"max_memory_allocated {peak} B ({before} B before it)",
          flush=True)
    report["memory"] = out
    del ex, step, params2, dec


# -- phase 20: NNET, the conv families of tools/derivation_bench.py ---------

#: tools/derivation_bench.py:167-177 at full width, f32
NNET_FAMILIES = {
    "stem": dict(n=8, c=3, hw=224, f=64, r=7, stride=2, dil=1, pad=3),
    "dilated": dict(n=8, c=256, hw=28, f=256, r=3, stride=1, dil=2, pad=2),
    "conv1x1": dict(n=32, c=192, hw=28, f=64, r=1, stride=1, dil=1, pad=0),
}
NNET_TOL = 1e-4                 # of max|base|: the derivator oracle's rtol


def conv_relu_graph(np, GraphHandler, runtime, fam, seed):
    """relu(conv(x, W)) of one family: x [n, c, hw, hw] an input, W
    [f, c, r, r] a weight named "W", seeded, scaled by fan_in^-1/2."""
    rng = np.random.default_rng(seed)
    h = GraphHandler(runtime, name="nnet_conv")
    x = h.input((fam["n"], fam["c"], fam["hw"], fam["hw"]), name="x")
    w = rng.standard_normal((fam["f"], fam["c"], fam["r"], fam["r"]),
                            np.float32)
    w *= np.float32((fam["c"] * fam["r"] ** 2) ** -0.5)
    p, st, d = fam["pad"], fam["stride"], fam["dil"]
    h.relu(h.conv(x, h.weight(w, name="W"), pads=(p, p), strides=(st, st),
                  dilations=(d, d)))
    h.graph.infer_output_roles()
    return h.graph


def conv_out_hw(fam):
    return (fam["hw"] + 2 * fam["pad"] - fam["dil"] * (fam["r"] - 1) - 1) \
        // fam["stride"] + 1


def nnet_path(torch, np, GraphHandler, GraphExecutor, cuda_runtime, dev,
              report):
    """Phase 20: for each of NNET_FAMILIES, relu(conv) built through
    GraphHandler on the card; NMutator(max_depth=2) on the card (its
    oracle's feeds there): the candidate count and each mutant's op
    types, one of them holding a MatMul and a MemBound; every mutant run
    captured within NNET_TOL of max|base| of the Conv graph's output,
    and past it with one filter of W moved by +1; SearchEngine with
    NMutator and a fresh PerfEngine (each candidate's per-op cost sum),
    its pick within NNET_TOL; the base and every mutant captured in turns
    (PAIRS rounds of single runs), and each mutant's ops timed alone
    (GraphExecutor.profile: captured, cold copies). Prints the phase's
    peak max_memory_allocated and its seconds."""
    from infinitensor_tpu_torch.nnet import NMutator
    from infinitensor_tpu_torch.optimizer.search import SearchEngine
    from infinitensor_tpu_torch.runtime.perf import PerfEngine
    t_start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res = {}

    def rel(got, want, top):
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"nnet: {got.dtype} {tuple(got.shape)} against "
                 f"{want.dtype} {tuple(want.shape)}")
        return (got.double() - want.double()).abs().max().item() / top

    for i, (label, fam) in enumerate(NNET_FAMILIES.items()):
        t0 = time.perf_counter()
        base = conv_relu_graph(np, GraphHandler, cuda_runtime(), fam,
                               SEED + 200 + i)
        muts = NMutator(max_depth=2, device=dev).run(base)
        torch.cuda.synchronize()
        derive_s = time.perf_counter() - t0
        kinds = [[op.op_type for op in m.operators] for m in muts]
        print(f"# nnet {label} ({fam}): {len(muts)} mutants, derived and "
              f"verified on the card in {derive_s:.2f}s: {kinds}",
              flush=True)
        if not any({"MatMul", "MemBound"} <= set(k) for k in kinds):
            fail(f"nnet {label}: no mutant holds a MatMul and a MemBound")
        x = torch.randn(fam["n"], fam["c"], fam["hw"], fam["hw"],
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 210 + i), device=dev)
        feeds = {"x": x}
        ex_base = GraphExecutor(base, device=dev)
        (want,) = ex_base.run(feeds).values()
        oh = conv_out_hw(fam)
        if tuple(want.shape) != (fam["n"], fam["f"], oh, oh) or \
                not torch.isfinite(want).all():
            fail(f"nnet {label}: the Conv graph gave {tuple(want.shape)}")
        top = want.abs().max().item()
        w = next(t for t in base.weights() if t.name == "W").numpy()
        w_moved = w.copy()
        w_moved[fam["f"] // 2] += 1.0
        exs, errs = [], []
        for m, k in zip(muts, kinds):
            ex = GraphExecutor(m, device=dev)
            (got,) = ex.run(feeds).values()
            err = rel(got, want, top)
            bad = GraphExecutor(m, device=dev)
            bad.set_weight("W", w_moved)
            (got_p,) = bad.run(feeds).values()
            err_p = rel(got_p, want, top)
            print(f"# nnet {label}: mutant {k}: captured rel err {err:.3g} "
                  f"(limit {NNET_TOL}); W moved {err_p:.3g}", flush=True)
            if not math.isfinite(err) or err > NNET_TOL:
                fail(f"nnet {label}: a mutant is {err} of max|base| from "
                     "the Conv graph")
            if not err_p > NNET_TOL:
                fail(f"nnet {label}: a moved W gives {err_p}, within the "
                     f"limit {NNET_TOL}: the check sees nothing")
            exs.append(ex)
            errs.append({"ops": k, "rel_err": err, "rel_err_w_moved": err_p})
            del bad, got, got_p
        t1 = time.perf_counter()
        engine = SearchEngine(mutator=NMutator(device=dev), perf=PerfEngine(),
                              device=dev)
        win = engine.run(base)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t1
        costs = [{"kind": h["kind"], "cost_ms": h["cost_ms"],
                  "ops": h["ops"]} for h in engine.history]
        for c in costs:
            print(f"# nnet {label}: {c['kind']} {c['ops']}: per-op cost sum "
                  f"{c['cost_ms']:.4f} ms", flush=True)
        (got,) = GraphExecutor(win, device=dev).run(feeds).values()
        err_win = rel(got, want, top)
        pick = [op.op_type for op in win.operators]
        print(f"# nnet {label}: searched in {search_s:.2f}s; pick {pick}; "
              f"captured rel err {err_win:.3g} (limit {NNET_TOL})",
              flush=True)
        if not math.isfinite(err_win) or err_win > NNET_TOL:
            fail(f"nnet {label}: the search's pick is {err_win} of "
                 "max|base| from the Conv graph")
        turns = {"base": [], **{f"mutant {j}": [] for j in range(len(exs))}}
        for _ in range(PAIRS):
            turns["base"].append(ex_base.time_ms(feeds, iters=1, warmup=1))
            for j, ex in enumerate(exs):
                turns[f"mutant {j}"].append(ex.time_ms(feeds, iters=1,
                                                       warmup=1))
        ms = {k: statistics.median(v) for k, v in turns.items()}
        best = min((k for k in ms if k != "base"), key=ms.get)
        ops = [[(op_type, round(t, 4)) for _, op_type, t in
                ex.profile(feeds)] for ex in exs]
        print(f"# nnet {label}: captured ms in turns (median of {PAIRS}) "
              f"{json.dumps(ms)}; best {best}; each mutant's ops alone "
              f"(captured, cold) {ops}", flush=True)
        flops = 2 * fam["n"] * fam["f"] * oh * oh * fam["c"] * fam["r"] ** 2
        res[label] = {
            "family": fam, "mutants": errs, "derive_s": derive_s,
            "candidates": costs, "pick": pick, "pick_rel_err": err_win,
            "search_s": search_s, "captured_ms": ms,
            "captured_ms_in_turns": turns, "best_mutant": best,
            "ops_alone_ms": ops, "flops": flops,
            "f32_ops_bound_ms": flops / PEAK_OPS["f32"] * 1e3,
            "seconds": time.perf_counter() - t0}
        del ex_base, exs, engine, want, got, x
    gather = next(t for mut in res["stem"]["ops_alone_ms"] for op, t in mut
                  if op == "MemBound")
    fam = NNET_FAMILIES["stem"]
    oh = conv_out_hw(fam)
    gather_bytes = 4 * (fam["n"] * fam["c"] * fam["hw"] ** 2 +
                        fam["n"] * oh * oh * fam["c"] * fam["r"] ** 2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    took = time.perf_counter() - t_start
    out = {"families": res, "standalone_membound_ms": gather,
           "standalone_membound_bytes": gather_bytes,
           "standalone_membound_bound_ms": gather_bytes / HBM_BYTES_S * 1e3,
           "max_memory_allocated": peak, "allocated_before": before,
           "seconds": took}
    print(f"# nnet: the stem's im2col gather (MemBound) alone, captured "
          f"cold: {gather:.4f} ms ({gather_bytes} B, bound "
          f"{out['standalone_membound_bound_ms']:.4f} ms); "
          f"max_memory_allocated over the phase {peak} B ({before} B "
          f"before it); {took:.1f}s", flush=True)
    report["nnet"] = out


if __name__ == "__main__":
    main()
