#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --parent DIR   # DIR: an older csrc/ (its
                                         # paged_attn.cu), timed in turns

With --parent, every timing of K3 and K4 at full width (bf16 and int8
pages) runs that older body and this checkout's in turns (parent,
change, change, parent) in the same call, and the two must give the same
bits; without it, each kernel is timed alone.

Phases (none catches an exception; any failure exits non-zero):
  0. the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc/ (timed, one nvcc per source in parallel);
     the conversion instructions (I2F, F2F and their forms, in all and
     inside loops) in the SASS of the served bf16-q paged-attention bodies
     on int8 and on bf16 pages, this checkout's and, with --parent, the
     parent's (cuobjdump).
  1. K1 gmm_swiglu and K2 gmm_scaled against their plain PyTorch versions:
     fp32 at small ragged shapes with invalid tiles, then bf16 at the main
     paths' full-width shapes (llama's prefill from a real expert-choice
     tile plan and its decode on the [16*bn, 4096] selected-pair layout;
     go_wide's decode at B 72, the lane plan of K5's selection with two
     64-row tiles a lane, run two a block, some lanes with both valid;
     granite's and deepseek's decode on a real token-choice dispatch plan,
     4 rows top-8 of 40 and top-6 of 64, with the plan's tiles and valid
     tiles), with median times of kernel, plain version and one library
     call (`library_ms`), achieved bytes/s and share of the bound; a
     second launch must repeat every bit.
  2. K7 gmm_swiglu_fused and K8 gmm_scaled_fused (the fused lane pairs of
     the C1 group path): fp32 at small ragged shapes with straddle tiles
     (mid-tile, at a tile's last row, an empty primary lane, invalid tail
     tiles), then bf16 at the full-width granite and deepseek prefill
     plans (4 x 128 tokens, top-8 of 40 and top-6 of 64, group-major lanes
     fused pairwise), with times and tiles;
     off the straddle tiles they must equal K1/K2 bit for bit (one bf16
     body), and a second launch must repeat every bit.
  1b. K5 go_topk_update (the GO cache's TopKUpdate) against its plain
     version, bit for bit, at the reference's four shapes (empty rows, tied
     minima, new scores at the minimum; an int and a [B] token id;
     functional and in place); the in-place form must refuse a strided
     view; times at llama's decode shape (4, 16, 4). Then K5R go_router
     (the GO decode's router: gate row, softmax, TopKUpdate and the
     selected-pair lane plan in one launch) at K5's four shapes and the
     llama smoke shape (d 256; x and gate_w in f32/bf16 pairs; an int, an
     int32 and an int64 [B] token id; minima planted at the kernel's own g
     and one ulp above) and at llama's full-width decode shape (B 4, E 16,
     k 4, d 4096, x bf16, gate_w f32): g within GO_ROUTER_G_TOL of the plain
     version's (a planted fault, x's last column dropped, must lie beyond),
     everything after g bit for bit against the plain TopKUpdate and plan on
     the kernel's own g and the cache from before the launch, in place,
     functional and repeated; kernel, plain and bound times, and the
     composition the decode ran before (GEMV, softmax, K5, the sort plan).
     Then go_cache_step past K5R's bound, at (B 65, E 16) and (B 4, E 72),
     on the card (K5 in place once, K5R never) against the CPU: selection,
     scores and ids bit-equal to the plain TopKUpdate on the card's own g,
     g and y within GO_ROUTER_G_TOL. The path `go_cache_step_strided`
     drives K5 alone through go_cache_step on a strided cache (a
     standalone prefill).
  1c. K6 gmm (the plain grouped GEMM) against its plain version: fp32 at
     the reference's sweep shapes re-tiled at 64 rows, with invalid tiles;
     then bf16 through expert_ffn_gmm (K1 then K6) at llama's full-width
     prefill plan, as the path `llama_expert_ffn_gmm`, with times. K6
     shares K2's body, so it must equal K2 with a unit row scale bit for
     bit.
  3. K3 paged_attn_decode and K4 paged_attn_chunk against their plain
     versions: fp32 at small shapes (GQA 4/2/1, window, softcap, null and
     reused pages, ragged positions and kv_len); K3's split-KV body in
     fp32 and bf16 at GQA 1/3/4 and head_dim 64/128 over several splits
     (t = 0, a window that leaves the first splits empty, NaN in every
     page position past t, a second launch bit-equal); then bf16 at the
     engine run's full-width shapes of the three MoE models (llama 32/32
     heads of 128, granite 24/8 heads of 64, deepseek 16/16 of 128) with
     kernel, plain and library times,
     K3's splits and CTAs.
     K4's bf16 body also at every head_dim and GQA 1/3/4/16 against its
     plain version; at both full-width chunks poisoned unreachable
     positions (+-1e4) must move no output bit, a second launch must
     repeat every bit, and 1, 2 and 4 warps per CTA are each checked and
     timed (the wrapper picks one).
  3b. K3 and K4 on int8 pages (the TPU kernels' int8 page operand, one f32
     scale per page and kv head) against their plain versions (gather,
     then dequantize): at small ragged shapes with q fp32 (K3's split
     body, K4's fp32 body) at PAGED_TOL_I8_F32, which must sit below a
     planted fault's error, and q bf16 (K3, K4's tensor-core body) at
     PAGED_TOL_BF16: pages whose scale grew during writes, a partly filled
     last page, the null page; NaN in every dead and null page's scales and
     +-127 at every unreadable position move no output bit; a second
     launch repeats every bit. Then both models' full-width engine shapes
     (the live pages of the bf16 rows above, quantized) with kernel, plain
     and library times (library: the gather, dequantization, then
     scaled_dot_product_attention), K3 at splits of 64 and 128 keys and
     K4 at 1, 2 and 4 warps per CTA (each against the plain version and
     its own repeat). Then K3 and K4, bf16 q on bf16 and int8 pages, at
     the dense models' PAGED_SHAPES (paged_phase_windowed, each printing
     its seconds), each derived from its cell: starcoder2-3b's GQA 24/2
     x 128 with its 4096-token window binding (its window cell's last
     decode tick, t 4670 and 190 over 320 pages, and last chunk, 512
     queries from 4096); qwen2-7b's 28/4 (a group of 7) at its engine
     trace's last decode tick (t 78, 462, 142, 334) and its 448-token
     prompt's last chunk (128 queries from 384); gemma3-27b's 32/16 at
     its window cell's last decode tick (t 1550 and 142 over 128 pages)
     and last chunk (512 queries from 1024), as a local layer (window
     1024) and as a global one: against the plain versions at
     WINDOW_PAGED_TOL, which must sit below a planted fault's error (64
     keys inside the window left out: one of K3's splits, one of K4's key
     tiles), a pool with
     +-1e4 (int8: +-127 and NaN scales) at every key outside the windows
     giving the same bits, with kernel, plain and library times and the
     bound of the pages inside the windows.
     K9 slstm_seq against its plain version: fp32 at the JAX test's three
     shapes, then xlstm-1.3b's full-width sLSTM (B 4, S 128, H 4, hd 512,
     fp32 u, bf16 r) on its cluster body (16 CTAs a head, r resident in
     shared memory) with a planted fault beside it, a second launch
     bit-equal, with times; and fp32 r at hd 512, which keeps the
     per-(head, batch row) body.
  4. the slices end to end at smoke size, fp32, the same weights on the
     CPU (plain versions) and on the card (kernels): static generate(),
     then the continuous-batching engine on a paged pool with chunked
     prefill; llama_moe_4_16 (expert choice, GO cache),
     granite-moe-3b-a800m (token choice, C1 groups: K7/K8 at prefill) and
     deepseek-moe-16b (the same with a shared expert);
     then xlstm-1.3b: model_forward (K9 once per sLSTM block) and
     generate(), and on the card the forward's last logits against a
     stepwise prefill plus one serve_step. llama's decode runs K5R once
     per layer and decode step, and K5 alone never. Each MoE model's engine also runs on an
     int8 pool (pages of 8): card streams equal the CPU's, a second card
     run repeats streams, pages, scales and GO rows bit for bit, and
     llama's streams equal each request alone on a 1-slot int8 engine.
     Each MoE model's smoke engine also runs 66 slots of 66 short
     requests (the GO decode past K5R's bound: K5 per layer and tick),
     and the trace again with prompt buckets and requests alternating
     greedy and sampled (temperature 0.8, top_p 0.9, seed = the request
     id): card streams equal the CPU's, sampled ones included. Then the
     chaos churn of tests/test_torch_chaos.py (llama smoke, paged, seeded
     tick faults, admission pressure and forced preemptions, the audit
     every tick) on the CPU and the card: the same streams, statuses,
     injected counts, preemptions, tick retries and finish steps. Then
     PREFIX_SMOKE_TRACE for each MoE model (a prompt sent three times,
     sampled consumers among them, and once more after its donor retired;
     a prompt of whole pages sent twice; a cold one), prefix sharing and
     expert-aware admission on, fp32 and int8 pages, on the CPU and the
     card: the same streams, statuses and sharing counters. Then
     `--supervise` at smoke width on the card: the serve CLI as a watched
     child, SIGKILLed at tick 6 of generation 0, restarted once,
     generation 1 recovering from its journal: exit 0, every request DONE.
     Then the dense models' smoke configs, each printing its seconds:
     starcoder2-3b (window 32), qwen2-7b (QKV biases drawn at
     QKV_BIAS_STD), granite-8b and gemma3-27b (local, local, global;
     window 16): static, and the engine on fp32 and int8 pages (with the
     66-slot and sampled engines).
  5. full width, bf16, one set of random weights per model, first
     llama_moe_4_16, then granite-moe-3b-a800m, then deepseek-moe-16b
     (about 16.7 B parameters, 33 GB; the earlier model's weights freed
     first; `deepseek_static`, `deepseek_engine` and, on int8 KV pages,
     `deepseek_engine_int8`, with profiles; no expert-aware trace; its
     shared experts' bf16 output first held against fp32, SHARED_TOL):
     a. static generate(): 4 requests x 128 prompt tokens, 16 new tokens,
        with its profile; its two repeats must give the same tokens;
     b. the continuous-batching engine on a paged pool (4 slots, pages of
        16, 97 pages, chunks of 128): 8 staggered requests, 32 new tokens
        each, with its profile of one decode tick and one chunk tick; on
        llama's bf16 pool (and starcoder2's two) the trace runs twice and
        both runs must stream the same tokens and leave the same KV pages
        and GO rows, bit for bit. Then
        `<model>_expert_aware`: a trace of short prompts (EXPERT_LENS),
        whose signatures leave experts out, FIFO and with expert-aware
        admission: another admission order, the same streams (orders,
        admit steps and the decode ticks' median printed). llama then runs
        the same trace on int8 KV pages and GO rows (`llama_engine_int8`:
        K3/K4 on the int8 operand): the same checks but the repeat, its
        pool's page bytes beside the bf16 pool's (about half), and
        its own profile. Then, on llama's first LLAMA_SLICE_LAYERS layers
        (the full width; 8 of 32 layers), `fault_domain` (bf16, then
        `fault_domain_int8` on int8 pages; the audit on every tick):
        FAULT_TRACE on FAULT_PAGES pages, where a high-priority arrival
        evicts a low-priority stream to a host snapshot and it resumes into
        other physical pages, every stream bit-equal to the trace on a pool
        that never evicts (snapshot pages, bytes and ms, restore ms);
        FAULT_CHAOS on the engine trace, streams bit-equal to the
        chaos-free trace at that depth; a NaN-poisoned slot of 4 retires
        FAILED with a prefix of its clean stream, the others equal, and a
        request admitted next maps the scrubbed pages and streams as on a
        fresh pool; (bf16) max_wall_s=0 retires TIMEOUT with a prefix, and a
        prefill cancelled after one chunk hands its pages back. Then
        `prefix_share` (bf16, then `prefix_share_int8`; the audit on every
        tick): PREFIX_TRACE without and with copy-on-write prefix sharing,
        streams bit-equal, 6 cache admissions (728 prefill tokens skipped,
        43 pages shared), K1/K2 launched 6 x 8 times fewer, no page in
        use after the drain; POISON_TRACE (Q three times), its first
        repeat poisoned on its cache admission, which must fork the shared
        page and fail that request alone; cold and cache admission ms,
        peak pages with and without sharing, peak memory, and the device
        operations of one cache admission (kernel launches and copies).
        Then `journal` (bf16, then `journal_int8` on int8 pages):
        JOURNAL_TRACE on ENGINE_POOL with preemption and prefix sharing,
        a snapshot every JOURNAL_EVERY ticks (one holds live slots, a
        parked preempted request, a chunk job and prefix entries), run
        unjournaled and journaled (streams equal; tok/s of both, each
        commit's bytes and device read, pickle + write and fsync ms), then
        stopped at tick JOURNAL_CRASH by each in-process crash class (the
        engine abandoned, its last record torn, an uncommitted snapshot
        written) and recovered into a fresh engine: streams and statuses
        equal to the uninterrupted run, the replay oracle silent, K1, K2,
        K3, K4 and K5R launched by the recovered engine (int8 bodies on
        int8 pages), the load, restore, replay and commit ms. Then a child
        `python -m repro_torch.launch.serve` at full width with
        --journal-dir and --crash-step (JOURNAL_CLI) must die by SIGKILL
        after printing its params' checksum, equal to this process's
        copy's; its journal, recovered here, must stream what the same CLI
        workload streams uninterrupted. Then `llama_engine_sampled`: the
        same trace with prompt buckets,
        requests alternating greedy and sampled (temperature 0.8, top_p
        0.9, seed = the request id) and a ninth at top_p 1e-9 that must
        stream request 0's greedy tokens; a fresh
        engine repeats every stream; prefill lengths, tok/s, the decode
        ticks' median and p95, and profiles of a sampled chunk and decode
        tick. Then `go_wide`: static generate() at batch 72 (32 prompt
        tokens, 8 new), past K5R's 64 rows: K5 once per layer and decode
        step, K5R never, a second run's tokens equal; K5 timed alone at
        (72, 16, 4).
     Then starcoder2-3b (4,161,985,536 weights; dense SwiGLU MLP, GQA
     24/2, window 4096): `starcoder2_static` and `starcoder2_engine` as
     a. and b., the engine's bf16 streams held against static
     generate()'s path for each prompt (static_agreement, teacher-forced:
     equal, or within STATIC_GAP_ULPS bf16 steps of its top logit),
     `starcoder2_engine_int8`; `starcoder2_window` (SC2_WINDOW on a
     5120-token pool, chunks of 512: every decode tick of the long
     request attends past the window; streams against static generate()'s
     path; the prefill without the window must give other last logits;
     a second run on a fresh engine repeats streams and pages);
     `starcoder2_prefix_ext` (eight requests on one shared context,
     without and with sharing, in SC2_EXT_CASES: a 1024-token context and
     a 1040-token one (off a chunk boundary) with chunks of 512, equal
     streams; the 1024-token one without chunking, streams equal or
     parted at bf16 near-ties only; 7 hits, 448 pages shared, 7168 tokens
     skipped in each; extension and cold admission ms). K3/K4 only.
     Then DENSE_MODELS (dense_model_phase, each printing its seconds):
     qwen2-7b (7,070,619,136 weights, its QKV biases drawn at
     QKV_BIAS_STD), granite-8b (8,053,362,688) and gemma3-27b
     (27,008,319,744), each after a `need` that the card holds under
     FREE_BEFORE_GB, with its init time and peak: `<model>_static` and
     `<model>_engine` as a. and b. (16 new tokens a request; the repeat
     on qwen2 and granite-8b), every bf16 stream against static
     generate()'s path; `qwen2_engine_int8` (the same trace on int8
     pages, with its repeat); `gemma3_window` (GEMMA3_WINDOW: 1536 + 128
     tokens, 16 new, on a 2048-token pool with chunks of 512: the long
     request's decodes attend 1024 keys on the 52 local layers and all
     on the 10 global ones; as starcoder2_window, and its launches on
     windowed layers, counted apart, must be 52 of every 62). K3/K4 only
     on every engine path.
     Then xlstm-1.3b (48 layers: 6 segments of 7 mLSTM + 1 sLSTM):
     c. `xlstm_forward`: model_forward on 4 x 128 tokens, three runs, K9
        launched 6 times per call, hidden states equal bit for bit;
     d. `xlstm_static`: generate() with 4 x 32 prompt tokens stepped
        through serve_step and 16 new tokens, two runs, tokens and
        logits equal bit for bit; profiles of the forward, 8 steps of
        the stepwise prefill and one decode step.
     e. `xlstm_engine`: the engine on a dense pool (RECURRENT_POOL: 4
        slots of 256 tokens), XLSTM_ENGINE's 6 requests of 16-32 tokens,
        16 new (dense_pool_engine_phase): run twice, streams and every
        leaf of the pool's state after the last arrival and after the
        drain bit-equal; each stream held against static generate()'s
        path, teacher-forced (pool_agreement): at the pool's batch the
        engine's token is
        static's argmax at every step; at batch 1 the gaps are recorded
        (xlstm's recurrence carries the other rounding of a 1-row GEMM
        forward, so its batch-1 path drifts past the 4-bf16-step rule).
     Then zamba2-1.2b (38 Mamba2 layers, the shared attention + SwiGLU
     block after every 6th: 6 applications, 2 trailing layers;
     1,102,443,840 weights), zamba2_full_phase:
     f. `zamba2_forward`: model_forward on 4 x 128 tokens (the chunked
        SSD scan), a warm-up and two runs, hidden states bit-equal;
     g. `zamba2_static`: generate() on 4 x 64 prompt tokens stepped
        through serve_step and 16 new tokens, a warm-up and three runs,
        tokens and logits bit-equal; weight count, peak GB; profiles of
        the forward and one decode step;
     h. `zamba2_engine`: as e., with ZAMBA2_ENGINE's 8 requests of 16-64
        tokens at ticks 0-8, its batch-1 path held to STATIC_GAP_ULPS
        bf16 steps as the dense engines' are. No kernel of the port runs
        on e.-h.: their launch counts must read 0. Phase 4 holds zamba2's
        smoke generate() and both recurrent smoke engines, card against
        CPU (recurrent_smoke_phase).
     Then the cross-attention families (cross_full_phase), each request
     and static row with its own random memory (std 1): whisper-base
     uncut (WHISPER_WEIGHTS; 1500 audio frames) and llama-3.2-vision-90b
     at its full width on its first VISION_LAYERS (20) of 100 layers
     (VISION_WEIGHTS; 1600 image tokens):
     i. `whisper_forward` / `vision20_forward`: model_forward on 4 x 128
        tokens over random frame or image embeddings (whisper's encoder
        over all 1500 frames), a warm-up and two runs, hidden states
        bit-equal;
     j. `whisper_static` / `vision20_static`: generate() on 4 x 128
        prompt tokens and 16 new, a warm-up and three runs, tokens and
        logits bit-equal; a decode step's weight-read bound and the cross
        layers' K/V recompute at the bf16 peak; profiles of the forward
        and one decode step;
     k. `whisper_engine` / `vision20_engine`: as e. on WHISPER_POOL /
        VISION_POOL (4 dense slots), WHISPER_ENGINE's 6 requests of
        32-128 tokens (admitted by a stepwise prefill at batch 1) /
        VISION_ENGINE's 8 of 64-256 (one-shot), a memory a request, the
        pool's memory rows filled at the tick after the last arrival and
        zero after the drain; the pool-batch path required, the batch-1
        gaps recorded. No kernel of the port runs on i.-k. Phase 4 holds
        both smoke configs card against CPU (cross_smoke_phase).
     Each path runs with the launch counts set to 0 just before it; K5R
     must run once per layer and decode step on llama's paths up to 64
     rows and never on granite's, xlstm's or `go_wide`, where K5 runs
     instead. The profiles
     give device events per layer.
  6. Training (after deepseek's full-width block; no kernel on the path,
     the MoE layer on its "xla" realization, every kernel's launch count
     0 through each run): `train_granite`, granite-moe-3b-a800m at full
     width and depth, 6 AdamW steps of 8 x 512 tokens (warmup 1) with
     remat: losses and grad norms finite, the held-out batch's loss
     falling, then 2 steps again from seed 0 with bit-equal losses and
     parameter checksum; `train_granite_restart`, its first 4 layers, a
     checkpoint every 2 steps and RestartRequired after step 3's update:
     bit-equal to an uninterrupted run, then one more step profiled;
     `train_llama8`, llama's first 8 layers, 3 steps; `xla_vs_kernels`,
     one full-width layer of each on "xla" and on the kernels: the same
     drop set or chosen tokens, outputs within XLA_KERNEL_TOL.
Then one JSON line with every kernel's numbers, the card line again, and
the final {"ok": true, ...} line.
"""
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 FLOP/s,
# fp32 outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# K5's four shapes (B, E, k), tests/test_kernels.py::test_go_topk_sweep
GO_TOPK_SHAPES = [(1, 4, 2), (4, 16, 4), (8, 64, 6), (3, 40, 8)]

# K5R go_router, kernel vs plain version: g relative to the plain g. The
# gate row sums in another order than cuBLAS's GEMV (fp32, d terms), so g
# moves by ~1e-7..1e-6 relative; dropping x's last column (the planted
# fault) moves it by ~1e-2. Everything after g is compared bit for bit on
# the kernel's own g. Small shapes run at width GO_ROUTER_D.
GO_ROUTER_G_TOL = 1e-5
GO_ROUTER_D = 256
GO_ROUTER_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
                    ("bfloat16", "float32"), ("float32", "bfloat16")]

# K6 fp32: tests/test_kernels.py:SWEEP's (N, K, F, E), re-tiled at the
# card's 64 rows, at the reference's fp32 tolerance (the order of the sums
# only). The bf16 path check takes K1's 1e-2 (one rounding of h and of y).
GMM_SWEEP = [(128, 256, 128, 2), (256, 512, 256, 4), (256, 512, 384, 8),
             (512, 1024, 512, 8), (128, 512, 128, 3), (128, 48, 96, 4),
             (64, 688, 172, 4)]
GMM_TOL_F32 = 2e-5
GMM_TOL_BF16 = 1e-2

# Paged attention, kernel vs plain version. fp32: an online softmax page by
# page against a one-shot softmax (the reference's own kernel-vs-gather
# tolerance). bf16: the plain chunk path rounds q * scale to bf16 before
# the product (as sdpa_chunked does), the kernel scales the fp32 product;
# 2e-2 covers a few bf16 ulps at |out| ~ 1.
PAGED_TOL_F32 = 2e-5
PAGED_TOL_BF16 = 2e-2

# int8 pages (K3/K4's int8 operand), kernel vs plain version with q fp32:
# the kernel multiplies each int8 dot product by its key's scale, where the
# plain version dequantizes every key first; an online softmax against a
# one-shot one, as PAGED_TOL_F32. The phase requires err <= tol < a planted
# fault's error (the scales rounded to bf16). bf16 q takes PAGED_TOL_BF16.
PAGED_TOL_I8_F32 = 2e-5

# Smoke logits, card vs CPU, both fp32. A sound run differs by ~4e-7 (sums
# in other orders); a faulty kernel moves them by ~9e-4 (K2's row scale
# rounded to bf16) to ~0.6 (tests/test_torch_model.py's faults). The xlstm
# smoke holds its logits to the same bound.
SMOKE_LOGIT_TOL = 1e-5

# xlstm smoke hidden states, card vs CPU, both fp32. The random smoke model
# amplifies rounding (its mLSTM divides by max(|q.n|, exp(-m))): the CPU's
# own fp32 forward lies 2.2e-5 from its fp64 forward, and the card's lay
# 2.9e-5 from the CPU's; K9 dropping the last column of r moves them by 1.1.
XLSTM_SMOKE_HIDDEN_TOL = 1e-4

# K9 slstm_seq, kernel vs plain version, both fp32 arithmetic (bf16 r
# widens exactly): the JAX test's shapes at its own 1e-5. At full width the
# tolerance sits between a sound run and a planted fault (the last column
# of r dropped); the phase requires err <= tol < fault error.
SLSTM_SMALL = [(1, 16, 2, 8), (2, 24, 4, 16), (3, 33, 4, 32)]
SLSTM_TOL_F32 = 1e-5
SLSTM_FULL = (4, 128, 4, 512)
SLSTM_TOL_FULL = 1e-4


def need(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def raises(exc, fn):
    """Whether fn raises `exc`: the check that a wrapper refuses an operand
    (any other exception propagates)."""
    try:
        fn()
    except exc:
        return True
    return False


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# A spin kernel of this many clock cycles (~1 ms on an H100) runs before
# each timed launch, so the card is still busy while the host enqueues
# the launch: the time between the events is the device's, not the host
# path of a short kernel's wrapper.
SPIN_CYCLES = 2_000_000


def time_ms(torch, fn, flush, reps=15):
    """Median of per-launch CUDA-event times; the L2 cache is flushed
    before each launch (the main path finds its weights cold), and the
    start event waits behind a spin kernel (SPIN_CYCLES)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# `--parent DIR`: the parent commit's csrc/ sources of the kernel files
# this checkout changed, built beside this checkout's; every timing of a
# kernel in them then runs the two bodies in turns in this call, each body
# called through its own C signature (parent_call, parent_gmm), and the
# bf16 K3/K4 of both must give the same bits.
PARENT_SOURCES = ("paged_attn",)
PARENT = {}


def timed(torch, kern, flush, parent=None):
    """{"ms": median launch time}; with the parent body's closure the two
    run in turns, parent, change, change, parent, and "ms" is the mean of
    the change's two medians, "parent_ms" of the parent's."""
    if parent is None:
        return {"ms": time_ms(torch, kern, flush)}
    t = [time_ms(torch, f, flush) for f in (parent, kern, kern, parent)]
    return {"ms": (t[1] + t[2]) / 2, "parent_ms": (t[0] + t[3]) / 2,
            "turns_ms": t}


def parent_call(torch, source, fn, *args):
    """A closure launching the parent body's C entry `fn` of `source` on
    `args` (tensors by pointer, floats as float, ints as int; the stream
    last); None without --parent."""
    import ctypes
    if source not in PARENT:
        return None
    f = getattr(PARENT[source], fn)
    conv = [(ctypes.c_void_p, a.data_ptr()) if isinstance(a, torch.Tensor)
            else (ctypes.c_float, a) if isinstance(a, float)
            else (ctypes.c_int, int(a)) for a in args]
    f.argtypes = [c for c, _ in conv] + [ctypes.c_void_p]
    f.restype = ctypes.c_int

    def run():
        rc = f(*(v for _, v in conv), torch.cuda.current_stream().cuda_stream)
        need(rc == 0, f"parent {fn}: cudaError {rc}")
    run.operands = args          # the tensors live as long as the closure
    return run


def parent_gmm(torch, G, name, x, ws, te, tv, N, K, F, out_dtype,
               scale=None, te2=None, sel=None):
    """The parent body of K1/K2/K6/K7/K8 on the wrapper's operands."""
    if "moe_gmm" not in PARENT:
        return None
    i32 = torch.int32
    te, tv = te.to(i32).contiguous(), tv.to(i32).contiguous()
    out = torch.empty((N, F), dtype=out_dtype, device=x.device)
    fused = () if te2 is None else (te2.to(i32).contiguous(),)
    rest = (tv,) + (() if sel is None else
                    (sel.reshape(N).float().contiguous(),))
    sc = () if scale is None else (scale.reshape(N).float().contiguous(),)
    ring = G._ring_args(x, N, K, F, ws[0].shape[0],
                        name.startswith("gmm_swiglu"))
    return parent_call(torch, "moe_gmm", name, x, *ws, te, *fused, *rest,
                       *sc, out, N, K, F, G.KERNEL_BLOCK_ROWS, *ring)


# Conversion instructions counted in the paged-attention kernels' SASS, by
# opcode with its modifiers (I2F.S8, I2FP.F32.S32, F2FP.BF16.F32.PACK_AB,
# ...), in all and inside loops, and the instantiations counted: the
# served head_dims' bf16-q bodies on int8 pages beside the same bodies on
# bf16 pages. I2F.RP is an integer division's reciprocal (the divisions by
# the page size), not a value's conversion.
SASS_OPS = ("I2F", "I2FP", "F2F", "F2FP")
SASS_KERNELS = re.compile(
    r"paged_(?:decode_split_kernel<__nv_bfloat16, (?:__nv_bfloat16|signed "
    r"char), (?:64|128), \d+>|chunk_tc_kernel<(?:64|128), \d, "
    r"(?:__nv_bfloat16|signed char)>)")


def sass_conversions(build, src):
    """{kernel: {opcode: count, opcode + " in loops": count}} of the
    SASS_OPS opcodes (static counts; "in loops": between a backward
    branch's target and the branch) in each of SASS_KERNELS in the library
    built from `src`, read with the toolkit's cuobjdump -sass and named by
    cu++filt (c++filt where that is missing)."""
    bindir = os.path.dirname(build._nvcc())
    sass = subprocess.run(
        [os.path.join(bindir, "cuobjdump"), "-sass",
         str(build._lib_path(Path(src)))], capture_output=True, text=True,
        check=True).stdout
    funcs, name = {}, None               # name -> [(address, opcode, args)]
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z0-9]+(?:\.[A-Z0-9_]+)*)([^;]*);", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2),
                                m.group(3)))
    filt = os.path.join(bindir, "cu++filt")
    filt = filt if os.path.exists(filt) else shutil.which("c++filt")
    names = list(funcs)
    shown = subprocess.run([filt, *names], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    need(len(shown) == len(names), f"{filt} named {len(shown)} of "
         f"{len(names)} kernels")
    out = {}
    for mangled, readable in zip(names, shown):
        m = SASS_KERNELS.search(readable.replace("(int)", ""))
        if not m:
            continue
        ins = funcs[mangled]
        loops = []
        for addr, op, args in ins:
            to = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and to and int(to.group(1), 16) < addr:
                loops.append((int(to.group(1), 16), addr))
        counts = {}
        for addr, op, _ in ins:
            if op.split(".")[0] in SASS_OPS:
                counts[op] = counts.get(op, 0) + 1
                if any(lo <= addr <= hi for lo, hi in loops):
                    counts[op + " in loops"] = \
                        counts.get(op + " in loops", 0) + 1
        out[m.group(0)] = dict(sorted(counts.items()))
    need(out, f"no paged-attention kernel in the SASS of {src}: "
         f"{shown[:3]}")
    return dict(sorted(out.items()))


def rates(entry, nbytes):
    """Achieved bytes/s (the bytes the bound counts over the kernel's time)
    and the share of the bound the kernel reaches."""
    entry["achieved_bytes_per_s"] = nbytes / (entry["ms"] * 1e-3)
    entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    return entry


def bound(rows, experts, K, F, n_out_rows, swiglu, out_elem_bytes=None):
    """Least time (ms) for the work this run's data needs: real rows and the
    weights of experts that own one, each read once; every output row
    written once (bf16 with SwiGLU, else fp32 unless `out_elem_bytes`).
    Returns (ms, "bytes" | "operations")."""
    streams = 2 if swiglu else 1
    out_bytes = n_out_rows * F * (out_elem_bytes or (2 if swiglu else 4))
    nbytes = rows * K * 2 + experts * streams * K * F * 2 + out_bytes
    flops = 2 * streams * rows * K * F
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def bound_bytes(rows, experts, K, F, n_out_rows, swiglu, out_elem_bytes=None):
    """The bytes `bound` counts."""
    return bound(rows, experts, K, F, n_out_rows, swiglu,
                 out_elem_bytes)[0] * 1e-3 * HBM_BPS


def kernel_phase_small(torch, G):
    """fp32 at small ragged shapes with invalid tiles; tolerance 1e-4
    (fp32, only the summation order differs)."""
    bn = G.KERNEL_BLOCK_ROWS
    g = torch.Generator(device="cuda").manual_seed(1)
    for N, K, F, E in [(320, 200, 136, 5), (300, 72, 44, 3)]:
        ni = -(-N // bn)
        x = torch.randn(N, K, device="cuda", generator=g)
        wg, wi = (torch.randn(E, K, F, device="cuda", generator=g) / K ** 0.5
                  for _ in range(2))
        wo = torch.randn(E, F, K, device="cuda", generator=g) / F ** 0.5
        te = torch.randint(0, E, (ni,), device="cuda", generator=g,
                           dtype=torch.int32)
        tv = torch.arange(ni, device="cuda") % 3 != 2       # some invalid
        sc = torch.rand(N, 1, device="cuda", generator=g)
        h = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)
        y = G.gmm_scaled(h, wo, te, tv, sc, bn=bn)
        hp = G.gmm_swiglu_plain(x, wg, wi, te, tv, bn)
        yp = G.gmm_scaled_plain(h, wo, te, tv, sc, bn)
        torch.cuda.synchronize()
        e1 = (h - hp).abs().max().item()
        e2 = (y - yp).abs().max().item()
        rows_invalid = (~tv).repeat_interleave(bn)[:N]
        need(torch.allclose(h, hp, rtol=1e-4, atol=1e-4), f"K1 fp32 err {e1}")
        need(torch.allclose(y, yp, rtol=1e-4, atol=1e-4), f"K2 fp32 err {e2}")
        need(bool((h[rows_invalid] == 0).all() and
                  (y[rows_invalid] == 0).all()), "invalid tiles not zero")
        print(f"[kernels fp32] N={N} K={K} F={F} E={E}: K1 max_abs_err "
              f"{e1:.3e}, K2 max_abs_err {e2:.3e} (tol 1e-4), invalid tiles "
              "zero", flush=True)


def kernel_phase_full(torch, G, OPS, R, GT, token_cfgs):
    """bf16 at the main paths' full-width shapes: llama's expert-choice
    prefill plan, its GO decode layout at B 4 and at go_wide's B 72 (two
    tiles a lane, a block a lane), and the token-choice decode plan of
    each model of `token_cfgs` ({short name: config}; granite: 4 tokens
    top-8 of 40 through one dispatch plan, 32 pairs in 2624 rows;
    deepseek: top-6 of 64, 24 pairs in about 65 row tiles; nearly every
    tile invalid), with the plan's tiles and valid tiles. Tolerances: K1
    rounds its output to bf16, so rtol=atol=1e-2 (over one bf16 ulp, 2^-7
    relative); K2 writes fp32 sums of bf16 products, rtol=atol=1e-4."""
    bn, E, K, F = G.KERNEL_BLOCK_ROWS, 16, 4096, 688
    Bq, S, k = 4, 128, 4
    cap = S * k // E                                      # 32 per sequence
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(2)

    def bank(E, K, F):
        wg, wi = (torch.randn(E, K, F, device="cuda", generator=g).div_(
            K ** 0.5).to(bf) for _ in range(2))
        wo = torch.randn(E, F, K, device="cuda", generator=g).div_(
            F ** 0.5).to(bf)
        return wg, wi, wo, torch.cat([wg, wi], dim=-1)  # last: library's

    llama_w = bank(E, K, F)
    wg, wi, wo, w_cat = llama_w
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    results = {}

    # prefill: the expert-choice layout of B sequences, one plan
    ef = torch.arange(E, device="cuda", dtype=torch.int32).repeat_interleave(
        cap).repeat(Bq)
    plan = OPS.plan_tile_dispatch(ef, E, bn)
    x = torch.randn(plan.n_pad, K, device="cuda", generator=g).to(bf)
    x = x * plan.row_valid[:, None]
    sc = torch.rand(plan.n_pad, 1, device="cuda", generator=g)
    sc = sc * plan.row_valid[:, None]
    rows = int(plan.row_valid.sum())
    experts = int(torch.unique(plan.tile_expert[plan.tile_valid]).numel())
    x_runs = x[plan.row_valid].reshape(E, Bq * cap, K)
    results["prefill"] = dict(te=plan.tile_expert, tv=plan.tile_valid, x=x,
                              row_valid=plan.row_valid,
                              sc=sc, rows=rows, experts=experts,
                              n_rows=plan.n_pad, lib_x=x_runs, lib_w=w_cat,
                              lib_wo=wo, w=llama_w, K=K, F=F,
                              shape=f"N_pad={plan.n_pad}")

    # decode: B=4 tokens, each selected by 4 experts -> lanes of Cp=bn rows
    sel = torch.zeros(Bq, E, dtype=torch.bool, device="cuda")
    for b in range(Bq):
        sel[b, torch.randperm(E, device="cuda", generator=g)[:k]] = True
    counts = sel.sum(0)
    te = torch.arange(E, dtype=torch.int32, device="cuda")
    tv = counts > 0
    xd = torch.zeros(E * bn, K, dtype=bf, device="cuda")
    scd = torch.zeros(E * bn, 1, device="cuda")
    xt = torch.randn(Bq, K, device="cuda", generator=g).to(bf)
    for e in range(E):
        idx = sel[:, e].nonzero()[:, 0]
        xd[e * bn:e * bn + idx.numel()] = xt[idx]
        scd[e * bn:e * bn + idx.numel()] = torch.rand(idx.numel(), 1,
                                                      device="cuda")
    sel_e = tv.nonzero()[:, 0]
    results["decode"] = dict(te=te, tv=tv, x=xd, sc=scd, rows=int(counts.sum()),
                             experts=int(sel_e.numel()), n_rows=E * bn,
                             lib_x=xt[None].expand(sel_e.numel(), Bq, K)
                             .contiguous(),
                             lib_w=w_cat[sel_e].contiguous(),
                             lib_wo=wo[sel_e].contiguous(), w=llama_w, K=K,
                             F=F,
                             shape=f"[{E}*{bn}, {K}], {int(counts.sum())} "
                                   f"selected pairs on {int(sel_e.numel())} "
                                   "experts")

    # the GO decode past K5R's 64 rows (go_wide): B = 72 rows, the lane
    # plan go_cache_step builds from K5's selection, Cp = 128 rows a lane,
    # so two 64-row tiles a lane and a block. Each row's cache holds the top
    # k of 32 earlier tokens' g, as after go_wide's prompt, so a lane selects
    # about k/33 of the rows and its second tile is invalid; lanes 0-1 are
    # empty in every row (a lane that more than 64 rows select), so both
    # their tiles are valid
    Bw = GO_WIDE[0]
    hist = torch.softmax(torch.randn(Bw, GO_WIDE[1], E, device="cuda",
                                     generator=g), -1)
    sp = hist.topk(k, dim=1).values.transpose(1, 2).contiguous()
    sp[:, :2] = float("-inf")
    tp = torch.zeros(Bw, E, k, dtype=torch.int32, device="cuda")
    gw = torch.softmax(torch.randn(Bw, E, device="cuda", generator=g), -1)
    selw = GT.go_topk_update_plain(sp, tp, gw, GO_WIDE[1])[2]
    wplan = GT.go_lane_plan(selw, gw, bn)
    Cp = wplan.idx_p.shape[1]
    xt = torch.randn(Bw, K, device="cuda", generator=g).to(bf)
    tvw = wplan.tile_valid.view(E, Cp // bn)
    need(Cp == 2 * bn and bool(tvw.all(1).any()) and
         bool((tvw[:, 0] & ~tvw[:, 1]).any()),
         f"wide decode plan: Cp {Cp}, tiles valid {tvw.tolist()}: want two "
         "tiles a lane, some lanes with both valid and some with one")
    sel_e = tvw[:, 0].nonzero()[:, 0]
    results["wide_decode"] = dict(
        te=wplan.tile_expert, tv=wplan.tile_valid,
        x=xt[wplan.idx_p.long()].reshape(E * Cp, K),
        sc=wplan.scale.view(E * Cp, 1), rows=int(selw.sum()),
        experts=int(sel_e.numel()), n_rows=E * Cp,
        lib_x=xt[None].expand(sel_e.numel(), Bw, K).contiguous(),
        lib_w=w_cat[sel_e].contiguous(), lib_wo=wo[sel_e].contiguous(),
        w=llama_w, K=K, F=F,
        shape=f"[{E}*{Cp}, {K}] (B {Bw}, go_lane_plan), {int(selw.sum())} "
              f"selected pairs, {int(tvw.all(1).sum())} lanes with both "
              f"tiles valid, {int(tvw[:, 0].sum())} with one or more")

    # token-choice decode: 4 rows routed top-k by a random gate, through
    # the dispatch plan token_choice_decode builds, operands gathered as
    # moe_ffn_fused gathers them; the library call multiplies each valid
    # tile's rows by its expert's weights
    for short, cfg in token_cfgs.items():
        e = cfg.moe
        Eg, Kg, Fg, kg = e.num_experts, cfg.d_model, e.d_expert, e.top_k
        tc_w = bank(Eg, Kg, Fg)
        gate = torch.randn(Kg, Eg, device="cuda", generator=g) / Kg ** 0.5
        xt = torch.randn(Bq, Kg, device="cuda", generator=g).to(bf)
        r = R.token_choice(xt, gate, kg)
        plan = OPS.plan_tile_dispatch(r.expert_idx.reshape(-1), Eg, bn)
        tok = torch.arange(Bq, device="cuda").repeat_interleave(kg)
        rp = plan.row_pair.long()
        x = torch.cat([xt, xt.new_zeros((1, Kg))])[
            torch.cat([tok, tok.new_full((1,), Bq)])[rp]]
        sc = torch.cat([r.weights.reshape(-1),
                        r.weights.new_zeros(1)])[rp][:, None]
        tv = plan.tile_valid
        valid = tv.nonzero()[:, 0]
        te = plan.tile_expert
        rows = int(plan.row_valid.sum())
        experts = int(torch.unique(te[tv]).numel())
        results[f"{short}_decode"] = dict(
            te=te, tv=tv, x=x, sc=sc, rows=rows, experts=experts,
            n_rows=plan.n_pad, lib_x=x.view(plan.n_tiles, bn, Kg)[valid],
            lib_w=tc_w[3][te[valid].long()], lib_wo=tc_w[2][te[valid].long()],
            w=tc_w, K=Kg, F=Fg, tiles=plan.n_tiles, valid_tiles=int(tv.sum()),
            shape=f"N_pad={plan.n_pad} ({plan.n_tiles} tiles, "
                  f"{int(tv.sum())} valid), {rows} pairs on {experts} "
                  f"experts, K={Kg} F={Fg}")

    out = {"gmm_swiglu": {}, "gmm_scaled": {}}
    for phase, r in results.items():
        te, tv, x, sc = r["te"], r["tv"], r["x"], r["sc"]
        wg, wi, wo, _ = r["w"]
        Kp, Fp = r["K"], r["F"]
        N = x.shape[0]
        h = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)
        hp = G.gmm_swiglu_plain(x, wg, wi, te, tv, bn)
        y = G.gmm_scaled(h, wo, te, tv, sc, bn=bn)
        yp = G.gmm_scaled_plain(h, wo, te, tv, sc, bn)
        torch.cuda.synchronize()
        e1 = (h.float() - hp.float()).abs().max().item()
        e2 = (y - yp).abs().max().item()
        need(torch.allclose(h.float(), hp.float(), rtol=1e-2, atol=1e-2),
             f"K1 bf16 {phase} err {e1}")
        need(torch.allclose(y, yp, rtol=1e-4, atol=1e-4),
             f"K2 bf16 {phase} err {e2}")
        need(torch.equal(h, G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)) and
             torch.equal(y, G.gmm_scaled(h, wo, te, tv, sc, bn=bn)),
             f"K1/K2 bf16 {phase}: a second launch gave other bits")
        h_runs = torch.zeros(r["lib_x"].shape[0], r["lib_x"].shape[1], Fp,
                             dtype=bf, device="cuda")
        for name, kern, plain, lib, err, swiglu, Kd, Fd, parent in [
            ("gmm_swiglu",
             lambda: G.gmm_swiglu(x, wg, wi, te, tv, bn=bn),
             lambda: G.gmm_swiglu_plain(x, wg, wi, te, tv, bn),
             lambda: torch.bmm(r["lib_x"], r["lib_w"]), e1, True, Kp, Fp,
             parent_gmm(torch, G, "gmm_swiglu_bf16", x, (wg, wi), te, tv, N,
                        Kp, Fp, bf)),
            ("gmm_scaled",
             lambda: G.gmm_scaled(h, wo, te, tv, sc, bn=bn),
             lambda: G.gmm_scaled_plain(h, wo, te, tv, sc, bn),
             lambda: torch.bmm(h_runs, r["lib_wo"]), e2, False, Fp, Kp,
             parent_gmm(torch, G, "gmm_scaled_bf16", h, (wo,), te, tv, N,
                        Fp, Kp, torch.float32, scale=sc)),
        ]:
            b_ms, b_by = bound(r["rows"], r["experts"], Kd, Fd, r["n_rows"],
                               swiglu)
            out[name][phase] = rates({
                "shape": r["shape"], "max_abs_err": err,
                **timed(torch, kern, flush, parent),
                "plain_ms": time_ms(torch, plain, flush),
                "library_ms": time_ms(torch, lib, flush),
                "bound_ms": b_ms, "bound_by": b_by,
                "tiles_per_block": G.gemm_ring(N, Kd, Fd, r["w"][0].shape[0],
                                               swiglu=swiglu)[
                                                   "tiles_per_block"],
                **{k: r[k] for k in ("tiles", "valid_tiles") if k in r}},
                bound_bytes(r["rows"], r["experts"], Kd, Fd, r["n_rows"],
                            swiglu))
            print(f"[kernels bf16 {phase}] {name} {r['shape']}: "
                  f"{json.dumps(out[name][phase])}", flush=True)
    for name in out:
        need(out[name]["wide_decode"]["tiles_per_block"] == 2,
             f"{name} at the wide decode plan runs "
             f"{out[name]['wide_decode']['tiles_per_block']} tiles a block, "
             "not a lane's two")
    return out, results["prefill"]


def _go_topk_inputs(torch, g, B, E, k):
    """Cached scores with empty rows (-inf, id -1), rows of tied minima,
    and new scores equal to a row's minimum; per-row token ids."""
    sp = torch.randn(B, E, k, device="cuda", generator=g)
    tp = torch.randint(0, 1000, (B, E, k), device="cuda", generator=g,
                       dtype=torch.int32)
    sn = torch.randn(B, E, device="cuda", generator=g)
    rows = torch.randperm(B * E, device="cuda", generator=g)
    n = max(1, B * E // 6)
    empty, ties, at_min = rows[:n], rows[n:2 * n], rows[2 * n:3 * n]
    s2, t2 = sp.view(-1, k), tp.view(-1, k)
    s2[empty] = float("-inf")
    t2[empty] = -1
    s2[ties] = s2[ties].round()
    sn.view(-1)[at_min] = s2[at_min].min(dim=1).values
    tid = torch.randint(1000, 2000, (B,), device="cuda", generator=g,
                        dtype=torch.int32)
    return sp, tp, sn, tid


def _diff(a, b):
    """Largest |a - b| over the elements that differ (0.0 when equal)."""
    ne = a != b
    return (a[ne].double() - b[ne].double()).abs().max().item() \
        if bool(ne.any()) else 0.0


def go_topk_phase(torch, GT):
    """K5 against its plain version at the reference's four shapes, with an
    int and a [B] token id, functional and in place: every output is a copy
    or a comparison, so all four must be equal, bit for bit. Empty rows
    must select at slot 0. The in-place form must refuse a strided view
    (a hidden copy would drop the write). Times at llama's decode shape,
    in place with the engine's [B] token ids; the plain version is the one
    the decode ran before K5 (topk_update, then the cache's two copies).
    Bound: every input read once and output written once, against one
    fp32 comparison per cached score; no single PyTorch call computes it."""
    g = torch.Generator(device="cuda").manual_seed(8)
    err = 0.0
    for B, E, k in GO_TOPK_SHAPES:
        sp, tp, sn, tid = _go_topk_inputs(torch, g, B, E, k)
        for token_id in (1001, tid):
            want = GT.go_topk_update_plain(sp, tp, sn, token_id)
            got = GT.go_topk_update(sp, tp, sn, token_id)
            s, t = sp.clone(), tp.clone()
            sel, slot = GT.go_topk_update_(s, t, sn, token_id)
            torch.cuda.synchronize()
            for a, b in list(zip(got, want)) + list(zip((s, t, sel, slot),
                                                         want)):
                need(a.dtype == b.dtype and a.shape == b.shape,
                     f"K5 {(B, E, k)}: {a.dtype} {tuple(a.shape)} vs "
                     f"{b.dtype} {tuple(b.shape)}")
                err = max(err, _diff(a, b))
        empty = torch.isneginf(sp).all(dim=2)
        need(bool(want[2][empty].all() and (want[3][empty] == 0).all()),
             f"K5 {(B, E, k)}: an empty row did not select at slot 0")
    need(err == 0.0, f"K5 differs from its plain version by {err}")
    sp, tp, sn, tid = _go_topk_inputs(torch, g, 4, 16, 4)
    wide = torch.zeros(4, 16, 8, device="cuda")
    before = GT.LAUNCHES["go_topk_update"]
    need(raises(ValueError, lambda: GT.go_topk_update_(wide[..., :4], tp, sn,
                                                       tid))
         and GT.LAUNCHES["go_topk_update"] == before,
         "K5's in-place form took a strided view")
    print(f"[go_topk] shapes {GO_TOPK_SHAPES}, int and [B] token ids, "
          "functional and in place: bit-equal to the plain version; empty "
          "rows select at slot 0; a strided view raises", flush=True)

    entry = k5_timing(torch, GT, sp, tp, sn, tid, err)
    print(f"[go_topk] {json.dumps(entry)}", flush=True)
    return entry


def k5_timing(torch, GT, sp, tp, sn, tid, err):
    """K5 in place with [B] token ids, timed: the kernel, and the plain
    version the decode ran before K5 (topk_update, then the cache's two
    copies). Bound: every input read once and output written once,
    against one fp32 comparison per cached score."""
    B, E, k = sp.shape
    s, t = sp.clone(), tp.clone()

    def plain():
        ns, nt, sel, slot = GT.go_topk_update_plain(s, t, sn, tid)
        s.copy_(ns)
        t.copy_(nt)

    nbytes = B * E * k * (4 + 4) * 2 + B * E * 4 + B * 4 + B * E * (1 + 4)
    t_b = nbytes / HBM_BPS * 1e3
    t_f = B * E * k / FP32_FLOPS * 1e3
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    entry = {"shape": f"B={B} E={E} k={k}, in place, [B] token ids",
             "max_abs_err": err,
             "ms": time_ms(torch, lambda: GT.go_topk_update_(s, t, sn, tid),
                           flush),
             "plain_ms": time_ms(torch, plain, flush),
             "bound_ms": max(t_b, t_f),
             "bound_by": "bytes" if t_b >= t_f else "operations",
             "bound_note": f"{nbytes} bytes; the time is launch latency",
             "library_ms": None,
             "library_note": "no single PyTorch call"}
    del flush
    return entry


def _router_inputs(torch, g, B, E, k, d, xdt, wdt):
    """x, gate_w (s ~ N(0, 1)), cached scores in [0, 2/E) with empty rows
    (-inf, id -1), and per-row token ids."""
    x = torch.randn(B, d, device="cuda", generator=g).to(xdt)
    w = (torch.randn(d, E, device="cuda", generator=g) / d ** 0.5).to(wdt)
    sp = torch.rand(B, E, k, device="cuda", generator=g) * (2.0 / E)
    tp = torch.randint(0, 1000, (B, E, k), device="cuda", generator=g,
                       dtype=torch.int32)
    empty = torch.randperm(B * E, device="cuda", generator=g)[
        :max(1, B * E // 8)]
    sp.view(-1, k)[empty] = float("-inf")
    tp.view(-1, k)[empty] = -1
    tid = torch.randint(1000, 2000, (B,), device="cuda", generator=g,
                        dtype=torch.int32)
    return x, w, sp, tp, tid


def _plant_ties(torch, g, sp, gk):
    """A copy of the cache whose rows, where a coin says so, hold their
    minimum in slot 0 at the kernel's g (>= selects) or one ulp above it
    (no selection); returns (cache, planted, tie)."""
    B, E, k = sp.shape
    planted = torch.rand(B, E, device="cuda", generator=g) < 0.5
    tie = planted & (torch.rand(B, E, device="cuda", generator=g) < 0.5)
    up = torch.nextafter(gk, torch.full_like(gk, float("inf")))
    row = torch.where(tie, gk, up)[..., None] + torch.linspace(
        0, 0.5, k, device="cuda")
    return torch.where(planted[..., None], row, sp).contiguous(), planted, tie


def _router_two_step(torch, GT, x, w, sp, tp, tid, bn):
    """K5R in place, functional and in place again, against the plain
    version: g's relative error (step 1), and whether everything after g
    equals the plain TopKUpdate and lane plan on the kernel's own g and the
    cache from before the launch, bit for bit, in all three (step 2)."""
    s1, t1 = sp.clone(), tp.clone()
    r1 = GT.go_router_(x, w, s1, t1, tid, bn)
    s2, t2, r2 = GT.go_router(x, w, sp, tp, tid, bn)
    s3, t3 = sp.clone(), tp.clone()
    r3 = GT.go_router_(x, w, s3, t3, tid, bn)
    _, _, rp = GT.go_router_plain(x, w, sp, tp, tid, bn)
    ws, wt, wsel, wslot = GT.go_topk_update_plain(sp, tp, r1.g, tid)
    plan = GT.go_lane_plan(wsel, r1.g, bn)
    torch.cuda.synchronize()
    want = [ws, wt, r1.g, wsel, wslot, *plan[:4]]
    same = all(
        all(a.dtype == b.dtype for a, b in zip(got, want))
        and _same(torch, got, want)
        for got in ([s, t, r.g, r.selected, r.slot, *r.plan[:4]]
                    for s, t, r in ((s1, t1, r1), (s2, t2, r2), (s3, t3, r3))))
    rel = ((r1.g - rp.g).abs() / rp.g).max().item()
    return r1, rp, rel, same


def _router_one_cta(torch, GT, x, w, s, t, tid, bn):
    """(A closure launching K5R's C entry in place with the whole gate row
    in ONE CTA, splits 1: the body's grid before the gate row was split,
    timed beside it; its g as a tensor the closure fills.) tid: int32
    [B]."""
    import ctypes
    B, E, k = s.shape
    d = x.shape[1]
    Cp = -(-B // bn) * bn
    nt = E * Cp // bn
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device="cuda")  # noqa
    outs = [e((B, E), torch.float32), e((B, E), torch.bool),
            e((B, E), torch.int32), e((E, Cp), torch.int32),
            e(E * Cp, torch.float32), e(nt, torch.bool), e(nt, torch.int32)]
    fn = getattr(GT._lib(), f"go_router_{GT._ROUTER_DTYPES[x.dtype]}_"
                            f"{GT._ROUTER_DTYPES[w.dtype]}")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(),
                tid.data_ptr(), 4, 0, s.data_ptr(), t.data_ptr(),
                *[o.data_ptr() for o in outs], None, None, B, E, k, d, d, 1,
                Cp, bn, stream)
        need(rc == 0, f"K5R on one CTA: cudaError {rc}")
    return run, outs[0]


def go_router_phase(torch, GT, GO, OPS):
    """K5R against its plain version in two steps (g within
    GO_ROUTER_G_TOL, relative; everything after g bit for bit on the
    kernel's own g), at K5's four shapes and the llama smoke shape, every
    x/gate_w dtype pair, an int and [B] token ids of int32 and int64, then
    with minima planted at the kernel's g and one ulp above; then at
    llama's full-width decode shape with a planted fault (x's last column
    dropped: its g error must lie beyond the tolerance) and times: the
    kernel in place, the plain version (gate row, softmax, topk_update,
    the cache's copies, the sort plan), and `before_ms`, the composition
    the decode ran before K5R (the GEMV, softmax, K5 in place, the sort
    plan), and `one_cta_ms`, the same body with the gate row in one CTA
    (splits 1). Bound: x, gate_w, the cache read and written, g, selected,
    slot, the plan and the token ids once each over HBM_BPS, against the
    gate row's 2 B E d fp32 FLOPs; no single PyTorch call computes it."""
    g = torch.Generator(device="cuda").manual_seed(24)
    bn = 64
    worst, calls, n = 0.0, 0, 0
    before = GT.LAUNCHES["go_router"]
    for B, E, k in GO_TOPK_SHAPES + [(4, 8, 2)]:
        for xn, wn in GO_ROUTER_DTYPES:
            xdt, wdt = getattr(torch, xn), getattr(torch, wn)
            x, w, sp, tp, tid = _router_inputs(torch, g, B, E, k,
                                               GO_ROUTER_D, xdt, wdt)
            for token_id in (1001, tid, tid.long()):
                r, _, rel, same = _router_two_step(torch, GT, x, w, sp, tp,
                                                   token_id, bn)
                need(same, f"K5R {(B, E, k)} {xn}/{wn}: an output after g "
                     "differs from the plain TopKUpdate and plan on its g")
                sp2, planted, tie = _plant_ties(torch, g, sp, r.g)
                r2, _, rel2, same2 = _router_two_step(torch, GT, x, w, sp2,
                                                      tp, token_id, bn)
                need(same2 and torch.equal(r2.g, r.g) and torch.equal(
                    r2.selected[planted], tie[planted]),
                     f"K5R {(B, E, k)} {xn}/{wn}: planted near ties did "
                     "not select on the kernel's own g")
                worst = max(worst, rel, rel2)
                calls += 6
                n += 1
    need(worst <= GO_ROUTER_G_TOL, f"K5R g differs from the plain version's "
         f"by {worst} (relative; tol {GO_ROUTER_G_TOL:g})")
    need(GT.LAUNCHES["go_router"] - before == calls,
         f"K5R counted {GT.LAUNCHES['go_router'] - before} launches for "
         f"{calls} calls")
    print(f"[go_router] shapes {GO_TOPK_SHAPES + [(4, 8, 2)]} at d "
          f"{GO_ROUTER_D}, x/gate_w {GO_ROUTER_DTYPES}, int and [B] int32/"
          f"int64 token ids ({n} cases): g max relative err {worst:.3e} "
          f"(tol {GO_ROUTER_G_TOL:g}); selected, slot, cache, idx_p, scale, "
          "tile_valid, tile_expert bit-equal on the kernel's g, in place, "
          "functional and repeated; planted ties select, one ulp above does "
          "not", flush=True)

    B, E, k, d = 4, 16, 4, 4096
    x, w, sp, tp, tid = _router_inputs(torch, g, B, E, k, d, torch.bfloat16,
                                       torch.float32)
    r, rp, rel, same = _router_two_step(torch, GT, x, w, sp, tp, tid, bn)
    sp2, planted, tie = _plant_ties(torch, g, sp, r.g)
    r2, _, rel2, same2 = _router_two_step(torch, GT, x, w, sp2, tp, tid, bn)
    xf = x.clone()
    xf[:, -1] = 0
    fault = ((GT.go_router_plain(xf, w, sp, tp, tid, bn)[2].g - rp.g).abs()
             / rp.g).max().item()
    abs_err = (r.g - rp.g).abs().max().item()
    need(same and same2 and torch.equal(r2.selected[planted], tie[planted]),
         "K5R full width: an output after g differs from the plain "
         "TopKUpdate and plan on its g, or a planted tie did not select")
    need(max(rel, rel2) <= GO_ROUTER_G_TOL < fault,
         f"K5R full width: g relative err {max(rel, rel2)}, tol "
         f"{GO_ROUTER_G_TOL}, planted fault {fault}")

    s, t = sp.clone(), tp.clone()

    def plain():
        ns, nt, _ = GT.go_router_plain(x, w, s, t, tid, bn)
        s.copy_(ns)
        t.copy_(nt)

    def before_path():
        gg = torch.softmax(x.float() @ w.float(), dim=-1)
        sel, _ = GT.go_topk_update_(s, t, gg, tid)
        GT.go_lane_plan(sel, gg, bn)

    one_cta, g1 = _router_one_cta(torch, GT, x, w, sp.clone(), tp.clone(),
                                  tid, bn)
    one_cta()
    torch.cuda.synchronize()
    rel1 = ((g1 - rp.g).abs() / rp.g).max().item()
    need(rel1 <= GO_ROUTER_G_TOL, f"K5R on one CTA: g relative err {rel1}")
    rows, splits = GT.router_splits(d, E, w.element_size())
    Cp = -(-B // bn) * bn
    nt = E * Cp // bn
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + 2 * B * E * k * (4 + 4) + B * E * (4 + 1 + 4)
              + E * Cp * (4 + 4) + nt * (1 + 4) + B * 4)
    t_b = nbytes / HBM_BPS * 1e3
    t_f = (2 * B * E * d) / FP32_FLOPS * 1e3
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    entry = {"shape": f"B={B} E={E} k={k} d={d}, x bf16, gate_w f32, in "
                      f"place, [B] int32 token ids, bn {bn}",
             "max_abs_err": abs_err, "g_rel_err": max(rel, rel2),
             "small_g_rel_err": worst, "tol": GO_ROUTER_G_TOL,
             "planted_fault_err": fault,
             "ms": time_ms(torch, lambda: GT.go_router_(x, w, s, t, tid, bn),
                           flush),
             "plain_ms": time_ms(torch, plain, flush),
             "before_ms": time_ms(torch, before_path, flush),
             "splits": splits, "split_rows": rows,
             "one_cta_ms": time_ms(torch, one_cta, flush),
             "bound_ms": max(t_b, t_f),
             "bound_by": "bytes" if t_b >= t_f else "operations",
             "bound_note": f"{nbytes} bytes, {2 * B * E * d} fp32 FLOPs",
             "library_ms": None,
             "library_note": "no single PyTorch call"}
    del flush
    entry["wide_steps"] = go_step_wide(torch, GT, GO, OPS, g)
    print(f"[go_router] {json.dumps(entry)}", flush=True)
    return entry


def go_step_wide(torch, GT, GO, OPS, g):
    """go_cache_step past K5R's bound, at (B 65, E 16) and (B 4, E 72), k 4,
    d GO_ROUTER_D, fp32, experts of 64 through K1/K2 at the card's tile
    (two tiles a lane at B 65): the card runs K5 in place once and K5R
    never. Held against the CPU's plain route: the selection, scores and
    ids bit-equal to the plain TopKUpdate on the card's own g (the card's
    gate row and softmax, the same ops as the step's, so the same bits;
    the CPU's own g differs in the last bits), g within GO_ROUTER_G_TOL
    relative of the CPU's, and y within GO_ROUTER_G_TOL of the CPU step's
    y, relative to its largest element."""
    out = []
    for B, E in ((65, 16), (4, 72)):
        k, d, de = 4, GO_ROUTER_D, 64
        x, w, sp, tp, tid = _router_inputs(torch, g, B, E, k, d,
                                           torch.float32, torch.float32)
        bank = {n: torch.randn(*shp, device="cuda", generator=g) / 8
                for n, shp in (("wg", (E, d, de)), ("wi", (E, d, de)),
                               ("wo", (E, de, d)))}
        o = torch.randn(B, E, k, d, device="cuda", generator=g)

        def step(dev):
            # the cache as the decode state holds it: contiguous views
            cache = GO.GOCache(*(a.to(dev).clone() for a in (sp, tp, o)))
            tb = {n: a.to(dev) for n, a in bank.items()}
            res = GO.go_cache_step(
                cache, x.to(dev), tid.to(dev), w.to(dev),
                bn=OPS.default_block_rows(dev),
                contrib_fn=lambda xt, sel, gg, plan: OPS.go_plan_ffn(
                    xt, plan, tb))
            return res, cache

        before = dict(GT.LAUNCHES)
        res, cache = step("cuda")
        torch.cuda.synchronize()
        k5 = GT.LAUNCHES["go_topk_update"] - before["go_topk_update"]
        k5r = GT.LAUNCHES["go_router"] - before["go_router"]
        need((k5, k5r) == (1, 0), f"go_cache_step at B {B} E {E}: K5 "
             f"{k5} launches, K5R {k5r}")
        gk = torch.softmax(x @ w, dim=-1)
        ws, wt, wsel, _ = GT.go_topk_update_plain(sp.cpu(), tp.cpu(),
                                                  gk.cpu(), tid.cpu())
        need(torch.equal(res.selected.cpu(), wsel) and
             torch.equal(cache.scores.cpu(), ws) and
             torch.equal(cache.token_ids.cpu(), wt),
             f"go_cache_step at B {B} E {E}: selection, scores or ids "
             "differ from the plain TopKUpdate on the card's g")
        cpu, _ = step("cpu")
        gc = torch.softmax(x.cpu() @ w.cpu(), dim=-1)
        g_rel = ((gk.cpu() - gc).abs() / gc).max().item()
        y_rel = ((res.y.cpu() - cpu.y).abs().max()
                 / cpu.y.abs().max()).item()
        need(g_rel <= GO_ROUTER_G_TOL and y_rel <= GO_ROUTER_G_TOL,
             f"go_cache_step at B {B} E {E}: g relative err {g_rel}, y "
             f"{y_rel} (tol {GO_ROUTER_G_TOL:g})")
        out.append({"B": B, "E": E, "k": k, "d": d, "g_rel_err": g_rel,
                    "y_rel_err": y_rel, "k5_launches": k5,
                    "k5r_launches": k5r,
                    "selected": int(res.selected.sum())})
    print(f"[go_router] past the router's bound: {json.dumps(out)}",
          flush=True)
    return out


def go_topk_path(torch, GT, GO, OPS, counts, reset_counts):
    """The path `go_cache_step_strided`: go_cache_step at llama's
    full-width decode shape (B 4, E 16, k 4, d 4096, bf16 experts of 688)
    on a standalone prefill cache (go_cache_prefill's strided top-k views
    of 8 chosen tokens an expert), the one caller of K5 alone; the counts
    set to 0 just before it and read just after: K5 once, K1 and K2 once,
    K5R never."""
    B, E, k, C, d, de = 4, 16, 4, 8, 4096, 688
    g = torch.Generator(device="cuda").manual_seed(25)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g)
                * scale).to(torch.bfloat16)

    bank = {"wg": r(E, d, de, scale=d ** -0.5),
            "wi": r(E, d, de, scale=d ** -0.5),
            "wo": r(E, de, d, scale=de ** -0.5)}
    gate = torch.randn(d, E, device="cuda", generator=g) * d ** -0.5
    cache = GO.go_cache_prefill(
        None, None, r(B, E, C, d),
        torch.randint(0, 100, (B, E, C), device="cuda", generator=g,
                      dtype=torch.int32),
        torch.rand(B, E, C, device="cuda", generator=g) * (2.0 / E), k)
    need(not cache.scores.is_contiguous(), "the prefill cache is contiguous")
    x = r(B, d)
    zero = {n: 0 for n in counts()}
    reset_counts()
    res = GO.go_cache_step(
        cache, x, 128, gate, bn=OPS.default_block_rows("cuda"),
        contrib_fn=lambda xt, sel, gg, plan: OPS.go_plan_ffn(xt, plan, bank))
    torch.cuda.synchronize()
    launches = counts()
    need(launches == {**zero, "go_topk_update": 1, "gmm_swiglu": 1,
                      "gmm_scaled": 1},
         f"go_cache_step_strided launches {launches}")
    need(res.y.shape == (B, d) and bool(torch.isfinite(res.y).all()) and
         bool((cache.token_ids == 128).any() == res.selected.any()),
         "go_cache_step on a strided cache: y not finite or the cache not "
         "updated")
    print(f"[go_topk path] go_cache_step on a strided cache: launches "
          f"{launches}, {int(res.selected.sum())} pairs selected", flush=True)
    return launches


def gmm_phase_small(torch, G):
    """K6 in fp32 at the reference's sweep shapes re-tiled at 64 rows, with
    invalid tiles (some every third tile), against its plain version at
    GMM_TOL_F32; invalid tiles write zeros; K6 shares K2's body, so its
    output must equal K2's with a unit row scale bit for bit."""
    bn = G.KERNEL_BLOCK_ROWS
    g = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    for N, K, F, E in GMM_SWEEP:
        ni = -(-N // bn)
        x = torch.randn(N, K, device="cuda", generator=g) * 0.1
        w = torch.randn(E, K, F, device="cuda", generator=g) * 0.05
        te = torch.randint(0, E, (ni,), device="cuda", generator=g,
                           dtype=torch.int32)
        tv = torch.arange(ni, device="cuda") % 3 != 1
        y = G.gmm(x, w, te, tv, bn=bn)
        yp = G.gmm_plain(x, w, te, tv, bn)
        y1 = G.gmm_scaled(x, w, te, tv, torch.ones(N, 1, device="cuda"),
                          bn=bn)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        worst = max(worst, err)
        need(torch.allclose(y, yp, rtol=GMM_TOL_F32, atol=GMM_TOL_F32),
             f"K6 fp32 {(N, K, F, E)} err {err}")
        need(torch.equal(y, y1), f"K6 fp32 {(N, K, F, E)} differs from K2 "
             "with a unit row scale")
        rows_invalid = (~tv).repeat_interleave(bn)[:N]
        need(bool((y[rows_invalid] == 0).all()), "K6: invalid tiles not zero")
    print(f"[gmm fp32] (N, K, F, E) in {GMM_SWEEP} at bn={bn}: max_abs_err "
          f"{worst:.3e} (tol {GMM_TOL_F32:g}); bit-equal to K2 at unit "
          "scale; invalid tiles zero", flush=True)
    return worst


def gmm_phase_full(torch, G, OPS, pf, counts, reset_counts):
    """The path `llama_expert_ffn_gmm`: expert_ffn_gmm (K1 then K6) in bf16
    at llama's full-width prefill plan of phase 1 (4 x 128 tokens, expert
    choice, 16 experts of 688: N_pad 3072), the counts set to 0 just
    before it and read just after. Against the plain versions at
    GMM_TOL_BF16 (K1's: one rounding of h, one of y); K6 on its own input
    likewise; K6 must equal K2 with a unit row scale, rounded once to bf16
    (and unrounded with out_dtype=float32), bit for bit. The library call
    multiplies each expert's run of rows by its weights (torch.bmm)."""
    bn = G.KERNEL_BLOCK_ROWS
    te, tv, x, rv = pf["te"], pf["tv"], pf["x"], pf["row_valid"]
    wg, wi, wo, _ = pf["w"]
    K, F = pf["K"], pf["F"]
    E = wo.shape[0]
    zero = {k: 0 for k in counts()}
    reset_counts()
    y = OPS.expert_ffn_gmm(x, wg, wi, wo, te, tv, bn=bn)
    launches = counts()
    need(launches == {**zero, "gmm_swiglu": 1, "gmm": 1},
         f"expert_ffn_gmm launches {launches}")
    h = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)
    yp = G.gmm_plain(G.gmm_swiglu_plain(x, wg, wi, te, tv, bn), wo, te, tv,
                     bn)
    yh = G.gmm_plain(h, wo, te, tv, bn)
    one = torch.ones(x.shape[0], 1, device="cuda")
    y2 = G.gmm_scaled(h, wo, te, tv, one, bn=bn)
    y32 = G.gmm(h, wo, te, tv, bn=bn, out_dtype=torch.float32)
    torch.cuda.synchronize()
    need(y.dtype == torch.bfloat16 and y.shape == (x.shape[0], K) and
         bool(torch.isfinite(y).all()), "expert_ffn_gmm: output of another "
         "type or shape, or not finite")
    e_path = (y.float() - yp.float()).abs().max().item()
    err = (y.float() - yh.float()).abs().max().item()
    need(torch.allclose(y.float(), yp.float(), rtol=GMM_TOL_BF16,
                        atol=GMM_TOL_BF16),
         f"expert_ffn_gmm bf16 vs the plain versions: err {e_path}")
    need(torch.allclose(y.float(), yh.float(), rtol=GMM_TOL_BF16,
                        atol=GMM_TOL_BF16), f"K6 bf16 err {err}")
    need(torch.equal(y, y2.to(torch.bfloat16)) and torch.equal(y32, y2),
         "K6 differs from K2 with a unit row scale")
    need(torch.equal(y, G.gmm(h, wo, te, tv, bn=bn)),
         "K6 bf16: a second launch gave other bits")
    need(bool((y[~rv] == 0).all()), "expert_ffn_gmm: padding rows not zero")
    h_runs = h[rv].reshape(E, -1, F)
    b_ms, b_by = bound(pf["rows"], pf["experts"], F, K, pf["n_rows"], False,
                       out_elem_bytes=2)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    N = x.shape[0]
    entry = {"shape": f"expert_ffn_gmm {pf['shape']}, x [{x.shape[0]}, {F}] "
                      f"-> [{x.shape[0]}, {K}] bf16",
             "max_abs_err": err, "path_max_abs_err": e_path,
             **timed(torch, lambda: G.gmm(h, wo, te, tv, bn=bn), flush,
                     parent_gmm(torch, G, "gmm_bf16", h, (wo,), te, tv, N, F,
                                K, torch.bfloat16)),
             "plain_ms": time_ms(torch,
                                 lambda: G.gmm_plain(h, wo, te, tv, bn),
                                 flush),
             "library_ms": time_ms(torch, lambda: torch.bmm(h_runs, wo),
                                   flush),
             "bound_ms": b_ms, "bound_by": b_by,
             "path_ms": time_ms(torch, lambda: OPS.expert_ffn_gmm(
                 x, wg, wi, wo, te, tv, bn=bn), flush),
             "tiles_per_block": G.gemm_ring(N, F, K, E)["tiles_per_block"]}
    rates(entry, bound_bytes(pf["rows"], pf["experts"], F, K, pf["n_rows"],
                             False, out_elem_bytes=2))
    del flush
    print(f"[gmm bf16] {json.dumps(entry)}; launches {launches}; bit-equal "
          "to K2 at unit scale", flush=True)
    return entry, launches


# Lane pairs (0,1), (2,3), (4,5) of the small fused cases, and each case's
# rows per lane: straddles mid-tile and at a tile's last row (61 + 3, 63 + 1
# of 64), an empty primary lane (0 + 70), ragged runs.
FUSE6 = (0, 0, 1, 1, 2, 2)
FUSED_SMALL = [((61, 3, 0, 70, 63, 1), 200, 136), ((5, 80, 64, 0, 17, 40), 72, 44)]


def fused_phase_small(torch, G, OPS):
    """K7 and K8 in fp32 at small ragged shapes on fused plans, against
    their plain versions (tolerance 1e-4: the order of the sums only); on
    the tiles that straddle nothing they must equal K1/K2 bit for bit, and
    invalid tiles write zeros."""
    bn = G.KERNEL_BLOCK_ROWS
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = {"gmm_swiglu_fused": 0.0, "gmm_scaled_fused": 0.0}
    for per_lane, K, F in FUSED_SMALL:
        E = len(per_lane)
        ef = torch.cat([torch.full((n,), e, dtype=torch.int32)
                        for e, n in enumerate(per_lane)])
        ef = ef[torch.randperm(len(ef), generator=torch.Generator()
                               .manual_seed(K))].cuda()
        plan = OPS.plan_tile_dispatch(ef, E, bn, fuse=FUSE6)
        te, te2, tv = plan.tile_expert, plan.tile_expert2, plan.tile_valid
        strad = te2 != te
        need(bool(strad.any()), f"fused case {per_lane}: no straddle tile")
        N = plan.n_pad
        x = torch.randn(N, K, device="cuda", generator=g) * \
            plan.row_valid[:, None]
        wg, wi = (torch.randn(E, K, F, device="cuda", generator=g) / K ** 0.5
                  for _ in range(2))
        wo = torch.randn(E, F, K, device="cuda", generator=g) / F ** 0.5
        sc = torch.rand(N, 1, device="cuda", generator=g)
        kw = dict(tile_expert2=te2, row_sel=plan.row_sel)
        h = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn, **kw)
        y = G.gmm_scaled(h, wo, te, tv, sc, bn=bn, **kw)
        hp = G.gmm_swiglu_fused_plain(x, wg, wi, te, te2, tv, plan.row_sel,
                                      bn)
        yp = G.gmm_scaled_fused_plain(h, wo, te, te2, tv, plan.row_sel, sc,
                                      bn)
        h1 = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)
        y1 = G.gmm_scaled(h, wo, te, tv, sc, bn=bn)
        torch.cuda.synchronize()
        worst["gmm_swiglu_fused"] = max(worst["gmm_swiglu_fused"],
                                        (h - hp).abs().max().item())
        worst["gmm_scaled_fused"] = max(worst["gmm_scaled_fused"],
                                        (y - yp).abs().max().item())
        need(torch.allclose(h, hp, rtol=1e-4, atol=1e-4),
             f"K7 fp32 {per_lane}")
        need(torch.allclose(y, yp, rtol=1e-4, atol=1e-4),
             f"K8 fp32 {per_lane}")
        plain_rows = (~strad).repeat_interleave(bn)
        need(torch.equal(h[plain_rows], h1[plain_rows]) and
             torch.equal(y[plain_rows], y1[plain_rows]),
             "K7/K8 differ from K1/K2 on tiles that straddle nothing")
        rows_invalid = (~tv).repeat_interleave(bn)
        need(bool((h[rows_invalid] == 0).all() and
                  (y[rows_invalid] == 0).all()), "invalid tiles not zero")
    print(f"[kernels fp32 fused] lanes per case {[c[0] for c in FUSED_SMALL]}"
          f", pairs {FUSE6}: max_abs_err {worst} (tol 1e-4); non-straddle "
          "tiles bit-equal to K1/K2; invalid tiles zero", flush=True)
    return worst


def fused_phase_full(torch, G, OPS, MOE, R, TM, cfg, short="granite"):
    """K7 and K8 in bf16 at a full-width C1 prefill plan (granite's, or
    deepseek's with `short`): 4 x 128 tokens routed top-k by a random gate
    (granite 8 of 40, deepseek 6 of 64), each pair on its expert's
    group-major lane, the deployment's lanes fused pairwise (g=2), operands
    gathered as moe_ffn_fused gathers them. Tolerances: K7 rounds its output
    to bf16, so 1e-2; K8 writes fp32 sums of bf16 products, 1e-4. The
    library call is torch.bmm over the same tiles: each valid tile's rows
    with its expert, and a straddle tile's other rows with its second
    expert, the weights gathered per tile beforehand."""
    e = cfg.moe
    bn, E, K, F, k = G.KERNEL_BLOCK_ROWS, e.num_experts, cfg.d_model, \
        e.d_expert, e.top_k
    T = 4 * 128
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(6)
    wg, wi = (torch.randn(E, K, F, device="cuda", generator=g).div_(
        K ** 0.5).to(bf) for _ in range(2))
    wo = torch.randn(E, F, K, device="cuda", generator=g).div_(F ** 0.5).to(bf)
    gate = torch.randn(K, E, device="cuda", generator=g) / K ** 0.5
    xt = torch.randn(T, K, device="cuda", generator=g).to(bf)
    r = R.token_choice(xt, gate, k)
    members = TM.expert_group_members(cfg, "cuda")
    lane_of_rank, rank_of_expert, fuse = MOE.group_lane_map(members,
                                                            e.group_size)
    ef = r.expert_idx.reshape(-1).long()
    plan = OPS.plan_tile_dispatch(rank_of_expert[ef], E, bn, fuse=fuse)
    te = lane_of_rank[plan.tile_expert.long()].int()
    te2 = lane_of_rank[plan.tile_expert2.long()].int()
    tv, sel = plan.tile_valid, plan.row_sel
    tok = torch.arange(T, device="cuda").repeat_interleave(k)
    rp = plan.row_pair.long()
    tok_z = torch.cat([tok, tok.new_full((1,), T)])
    x = torch.cat([xt, xt.new_zeros((1, K))])[tok_z[rp]]
    sc = torch.cat([r.weights.reshape(-1), r.weights.new_zeros(1)])[rp][:, None]
    kw = dict(tile_expert2=te2, row_sel=sel)
    h = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn, **kw)
    hp = G.gmm_swiglu_fused_plain(x, wg, wi, te, te2, tv, sel, bn)
    y = G.gmm_scaled(h, wo, te, tv, sc, bn=bn, **kw)
    yp = G.gmm_scaled_fused_plain(h, wo, te, te2, tv, sel, sc, bn)
    torch.cuda.synchronize()
    e1 = (h.float() - hp.float()).abs().max().item()
    e2 = (y - yp).abs().max().item()
    need(torch.allclose(h.float(), hp.float(), rtol=1e-2, atol=1e-2),
         f"K7 bf16 {short} err {e1}")
    need(torch.allclose(y, yp, rtol=1e-4, atol=1e-4),
         f"K8 bf16 {short} err {e2}")
    # one body: off the straddle tiles K7/K8 are K1/K2 bit for bit, and a
    # second launch repeats every bit
    off = (te2 == te).repeat_interleave(bn)
    h1 = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)
    y1 = G.gmm_scaled(h, wo, te, tv, sc, bn=bn)
    need(torch.equal(h[off], h1[off]) and torch.equal(y[off], y1[off]),
         "K7/K8 bf16 differ from K1/K2 on tiles that straddle nothing")
    need(torch.equal(h, G.gmm_swiglu(x, wg, wi, te, tv, bn=bn, **kw)) and
         torch.equal(y, G.gmm_scaled(h, wo, te, tv, sc, bn=bn, **kw)),
         "K7/K8 bf16: a second launch gave other bits")
    del h1, y1

    ni = plan.n_tiles
    strad = (te2 != te) & tv
    prim = tv.nonzero()[:, 0]
    second = strad.nonzero()[:, 0]
    sel_t = sel.view(ni, bn, 1)
    keep1 = torch.where(strad[:, None, None], sel_t, 1.0)
    lib_e = torch.cat([te[prim], te2[second]]).long()
    lib_x = torch.cat([(x.view(ni, bn, K) * keep1.to(bf))[prim],
                       (x.view(ni, bn, K) * (1 - sel_t).to(bf))[second]])
    lib_w = torch.cat([wg, wi], dim=-1)[lib_e]
    lib_h = torch.cat([(h.view(ni, bn, F) * keep1.to(bf))[prim],
                       (h.view(ni, bn, F) * (1 - sel_t).to(bf))[second]])
    lib_wo = wo[lib_e]
    rows = int(plan.row_valid.sum())
    experts = int(torch.unique(torch.cat([te[tv], te2[tv]])).numel())
    shape = (f"N_pad={plan.n_pad} ({ni} tiles, {int(tv.sum())} valid, "
             f"{int(strad.sum())} straddle), {rows} pairs on {experts} "
             f"experts, K={K} F={F}")
    out = {}
    N = plan.n_pad
    tiles = dict(tiles=ni, valid_tiles=int(tv.sum()),
                 straddle_tiles=int(strad.sum()))
    for name, kern, plain, lib, err, swiglu, Kd, Fd, parent in [
        ("gmm_swiglu_fused",
         lambda: G.gmm_swiglu(x, wg, wi, te, tv, bn=bn, **kw),
         lambda: G.gmm_swiglu_fused_plain(x, wg, wi, te, te2, tv, sel, bn),
         lambda: torch.bmm(lib_x, lib_w), e1, True, K, F,
         parent_gmm(torch, G, "gmm_swiglu_fused_bf16", x, (wg, wi), te, tv,
                    N, K, F, bf, te2=te2, sel=sel)),
        ("gmm_scaled_fused",
         lambda: G.gmm_scaled(h, wo, te, tv, sc, bn=bn, **kw),
         lambda: G.gmm_scaled_fused_plain(h, wo, te, te2, tv, sel, sc, bn),
         lambda: torch.bmm(lib_h, lib_wo), e2, False, F, K,
         parent_gmm(torch, G, "gmm_scaled_fused_bf16", h, (wo,), te, tv, N,
                    F, K, torch.float32, scale=sc, te2=te2, sel=sel)),
    ]:
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
        b_ms, b_by = bound(rows, experts, Kd, Fd, plan.n_pad, swiglu)
        out[name] = rates({
            "shape": shape, "max_abs_err": err,
            **timed(torch, kern, flush, parent),
            "plain_ms": time_ms(torch, plain, flush),
            "library_ms": time_ms(torch, lib, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "tiles_per_block": G.gemm_ring(N, Kd, Fd, E, swiglu=swiglu)[
                "tiles_per_block"], **tiles},
            bound_bytes(rows, experts, Kd, Fd, plan.n_pad, swiglu))
        del flush
        print(f"[kernels bf16 {short}] {name}: {json.dumps(out[name])}",
              flush=True)
    return out


def _pools(torch, g, B, P, ps, nkv, hd, dtype, live, reuse_from=None):
    """Random pages and block tables on the card: row b owns the pages
    covering its first live[b] positions, at shuffled physical ids; the
    rest of its row is the null page 0. `reuse_from` hands the rows the
    pages another table used (a freed-then-reused pool: stale contents)."""
    NP = B * P + 1
    kp = torch.randn(NP, ps, nkv, hd, device="cuda", generator=g).to(dtype)
    vp = torch.randn(NP, ps, nkv, hd, device="cuda", generator=g).to(dtype)
    ids = (reuse_from[reuse_from > 0].flip(0) if reuse_from is not None
           else torch.randperm(NP - 1, device="cuda", generator=g) + 1)
    bt = torch.zeros(B, P, dtype=torch.int32, device="cuda")
    n = 0
    for b in range(B):
        k = -(-int(live[b]) // ps)
        bt[b, :k] = ids[n:n + k]
        n += k
    return kp, vp, bt


def paged_phase_small(torch, PA):
    """K3 and K4 in fp32 at small shapes against their plain versions:
    GQA ratios 4/2/1, window and softcap, ragged positions around page
    boundaries, null pages behind short rows, a pool whose pages were
    reused, and poisoned unreachable positions (no output bit may move)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    ps, P, hq, hd = 8, 6, 4, 64
    t = torch.tensor([0, 1, 7, 8, 9, 15, 24, 47], dtype=torch.int32,
                     device="cuda")
    worst = {"paged_attn_decode": 0.0, "paged_attn_chunk": 0.0}
    for nkv in (1, 2, 4):
        for window, softcap in ((0, 0.0), (5, 0.0), (0, 4.0)):
            kp, vp, bt = _pools(torch, g, len(t), P, ps, nkv, hd,
                                torch.float32, (t + 1).tolist())
            kp2, vp2, bt2 = _pools(torch, g, len(t), P, ps, nkv, hd,
                                   torch.float32, (t + 1).tolist(),
                                   reuse_from=bt.flatten())
            q = torch.randn(len(t), hq, hd, device="cuda", generator=g)
            qc = torch.randn(len(t), 16, hq, hd, device="cuda", generator=g)
            for pools in ((kp, vp, bt), (kp2, vp2, bt2)):
                out = PA.paged_attn_decode(q, *pools, t, window=window,
                                           softcap=softcap)
                ref = PA.paged_attn_decode_plain(q, *pools, t, window=window,
                                                 softcap=softcap)
                worst["paged_attn_decode"] = max(
                    worst["paged_attn_decode"],
                    (out - ref).abs().max().item())
                for start, kv_len in ((0, 11), (16, 29), (32, 48)):
                    out = PA.paged_attn_chunk(qc, *pools, start, kv_len,
                                              window=window, softcap=softcap)
                    ref = PA.paged_attn_chunk_plain(
                        qc, *pools, start, kv_len, window=window,
                        softcap=softcap)
                    # pad queries (q_pos >= kv_len) are discarded by the
                    # caller; with a window one may see no key at all, and
                    # then each version returns its own garbage
                    n = kv_len - start
                    worst["paged_attn_chunk"] = max(
                        worst["paged_attn_chunk"],
                        (out[:, :n] - ref[:, :n]).abs().max().item())
    torch.cuda.synchronize()
    for name, err in worst.items():
        need(err <= PAGED_TOL_F32, f"{name} fp32 err {err}")
    # poison: every position no row may read holds +-1e4
    kp, vp, bt = _pools(torch, g, len(t), P, ps, 2, hd, torch.float32,
                        (t + 1).tolist())
    pos = torch.arange(P * ps, device="cuda")
    readable = torch.zeros(kp.shape[:2], dtype=torch.bool, device="cuda")
    for b in range(len(t)):
        p = pos[:int(t[b]) + 1]
        readable[bt[b, p // ps].long(), p % ps] = True
    sel = readable[:, :, None, None]
    q = torch.randn(len(t), hq, hd, device="cuda", generator=g)
    clean = PA.paged_attn_decode(q, kp * sel, vp * sel, bt, t)
    dirty = PA.paged_attn_decode(q, torch.where(sel, kp, 1e4),
                                 torch.where(sel, vp, -1e4), bt, t)
    need(torch.equal(clean, dirty), "stale page contents leaked into K3")
    print(f"[paged fp32] GQA 4/2/1 x (window, softcap) in (0,0) (5,0) "
          f"(0,4), fresh and reused pools: max_abs_err {worst} "
          f"(tol {PAGED_TOL_F32:g}); poisoned unreachable pages: outputs "
          "bit-equal", flush=True)
    return worst


def decode_split_sweep(torch, PA):
    """K3's split-KV body in fp32 and bf16 at GQA 1, 3 and 4 and head_dim
    64 and 128, 256 positions in pages of 16 (4 splits of 4 pages): t = 0,
    positions on and beside split edges, no window and a window of 40 that
    leaves the first splits of the long rows empty. NaN in every page
    position no row may read (the tail of each row's last page, the pages
    past it, the null page) moves no output bit; against the plain version
    on the clean pools at PAGED_TOL_F32 / _BF16; a second launch repeats
    every bit."""
    g = torch.Generator(device="cuda").manual_seed(12)
    ps, P, nkv = 16, 16, 2
    t = torch.tensor([0, 63, 64, 130, 255], dtype=torch.int32, device="cuda")
    pos = torch.arange(P * ps, device="cuda")
    pages, splits = PA.decode_splits(P, ps)
    worst = {}
    for dtype, tol in ((torch.float32, PAGED_TOL_F32),
                       (torch.bfloat16, PAGED_TOL_BF16)):
        for hd in (64, 128):
            for G_ in (1, 3, 4):
                kp, vp, bt = _pools(torch, g, len(t), P, ps, nkv, hd, dtype,
                                    (t + 1).tolist())
                readable = torch.zeros(kp.shape[:2], dtype=torch.bool,
                                       device="cuda")
                for b in range(len(t)):
                    p = pos[:int(t[b]) + 1]
                    readable[bt[b, p // ps].long(), p % ps] = True
                sel = readable[:, :, None, None]
                kc, vc = kp * sel, vp * sel
                kn = torch.where(sel, kp, float("nan")).to(dtype)
                vn = torch.where(sel, vp, float("nan")).to(dtype)
                q = torch.randn(len(t), nkv * G_, hd, device="cuda",
                                generator=g).to(dtype)
                for window in (0, 40):
                    out = PA.paged_attn_decode(q, kc, vc, bt, t,
                                               window=window)
                    ref = PA.paged_attn_decode_plain(q, kc, vc, bt, t,
                                                     window=window)
                    err = (out - ref).abs().max().item()
                    key = f"{str(dtype)[6:]} hd={hd} G={G_} w={window}"
                    worst[key] = err
                    need(torch.allclose(out, ref, rtol=tol, atol=tol),
                         f"K3 split-KV {key}: err {err}")
                    need(torch.equal(out, PA.paged_attn_decode(
                        q, kn, vn, bt, t, window=window)),
                        f"K3 split-KV {key}: NaN past t reached the output")
                    need(torch.equal(out, PA.paged_attn_decode(
                        q, kc, vc, bt, t, window=window)),
                        f"K3 split-KV {key}: a second launch gave other "
                        "bits")
    print(f"[paged K3 split-KV] {pages} pages x {splits} splits, t "
          f"{t.tolist()}: max_abs_err {json.dumps(worst)} (tol fp32 "
          f"{PAGED_TOL_F32:g}, bf16 {PAGED_TOL_BF16:g}); NaN past t: "
          "outputs bit-equal; repeats bit-equal", flush=True)
    return worst


def chunk_bf16_sweep(torch, PA):
    """K4's bf16 body at every head_dim the wrapper takes and GQA 1, 3, 4
    and 16 (2 kv heads, 24 queries at 37..60 against kv_len 57: 4 pad
    queries, a ragged last warp of rows), against its plain version on the
    real queries at PAGED_TOL_BF16; a second launch repeats every bit."""
    g = torch.Generator(device="cuda").manual_seed(10)
    bf, nkv, ps, P, Cs, start, kv_len = torch.bfloat16, 2, 16, 5, 24, 37, 57
    worst = 0.0
    for hd in PA.KERNEL_HEAD_DIMS:
        for G_ in (1, 3, 4, 16):
            kp, vp, bt = _pools(torch, g, 2, P, ps, nkv, hd, bf, [kv_len] * 2)
            q = torch.randn(2, Cs, nkv * G_, hd, device="cuda",
                            generator=g).to(bf)
            out = PA.paged_attn_chunk(q, kp, vp, bt, start, kv_len)
            ref = PA.paged_attn_chunk_plain(q, kp, vp, bt, start, kv_len)
            n = kv_len - start
            err = (out[:, :n] - ref[:, :n]).abs().max().item()
            worst = max(worst, err)
            need(torch.allclose(out[:, :n], ref[:, :n], rtol=PAGED_TOL_BF16,
                                atol=PAGED_TOL_BF16),
                 f"K4 bf16 hd={hd} G={G_} err {err}")
            need(bool(torch.isfinite(out).all()) and torch.equal(
                out, PA.paged_attn_chunk(q, kp, vp, bt, start, kv_len)),
                f"K4 bf16 hd={hd} G={G_}: not finite or not repeatable")
    print(f"[paged bf16] K4 at head_dim {PA.KERNEL_HEAD_DIMS} x GQA "
          f"(1, 3, 4, 16): max_abs_err {worst:.3e} (tol {PAGED_TOL_BF16:g}); "
          "repeats bit-equal", flush=True)
    return worst


def paged_phase_full(torch, PA, cfg, page_size, max_tokens):
    """K3 and K4 in bf16 at the shapes of the full-width engine run: the
    four first requests' last decode tick (t = prompt + 31) and the last
    chunk of the 448-token prompt (queries 320..447). `bound_ms` counts
    each live page (K and V of every kv head) read once plus q and the fp32
    output, against the FLOPs of the keys each query attends."""
    import torch.nn.functional as F
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(4)
    Hq, Hkv, hd, ps = cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim(), page_size
    P = max_tokens // ps
    page_bytes = PA.page_bytes(cfg, ps)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}

    t = torch.tensor([64 + 31, 448 + 31, 128 + 31, 320 + 31],
                     dtype=torch.int32, device="cuda")
    B = len(t)
    kp, vp, bt = _pools(torch, g, B, P, ps, Hkv, hd, bf, (t + 1).tolist())
    q = torch.randn(B, Hq, hd, device="cuda", generator=g).to(bf)
    S = P * ps
    mask = torch.arange(S, device="cuda")[None, :] <= t[:, None]

    def lib_decode():
        k = kp[bt.long()].reshape(B, S, Hkv, hd).transpose(1, 2)
        v = vp[bt.long()].reshape(B, S, Hkv, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask[:, None, None],
                                              enable_gqa=Hq != Hkv)

    live, _ = PA.decode_tick_pages(t.tolist(), [True] * B, ps, B, P)
    keys = sum(int(x) + 1 for x in t.tolist())
    nbytes = live * page_bytes + B * Hq * hd * (2 + 4)
    flops = 4 * Hq * hd * keys
    o_par = torch.empty(B, Hq, hd, device="cuda")
    pages, splits = PA.decode_splits(P, ps)
    ws = torch.empty(B * Hkv * splits * (Hq // Hkv) * (hd + 2),
                     device="cuda")
    cnt = torch.zeros(B * Hkv, dtype=torch.int32, device="cuda")
    entry = _paged_entry(
        torch, flush, lambda: PA.paged_attn_decode(q, kp, vp, bt, t),
        lambda: PA.paged_attn_decode_plain(q, kp, vp, bt, t), lib_decode,
        nbytes, flops, f"B={B} t={t.tolist()} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps} "
        f"P={P}, {live} live pages",
        parent_call(torch, "paged_attn", "paged_attn_decode_bf16", q, kp, vp,
                    bt, t, ws, cnt, o_par, B, Hkv, Hq // Hkv, hd, ps, P,
                    pages, splits, 0, 0.0))
    if PARENT:
        need(torch.equal(o_par, PA.paged_attn_decode(q, kp, vp, bt, t)),
             f"K3 bf16 {cfg.name}: the parent's body gave other bits")
    entry.update(pages_per_split=pages, splits=splits, ctas=Hkv * B * splits)
    # NaN at every position no row may read moves no output bit
    pos = torch.arange(S, device="cuda")
    readable = torch.zeros(kp.shape[:2], dtype=torch.bool, device="cuda")
    for b in range(B):
        p = pos[:int(t[b]) + 1]
        readable[bt[b, p // ps].long(), p % ps] = True
    sel = readable[:, :, None, None]
    need(torch.equal(
        PA.paged_attn_decode(q, kp * sel, vp * sel, bt, t),
        PA.paged_attn_decode(q, torch.where(sel, kp, float("nan")),
                             torch.where(sel, vp, float("nan")), bt, t)),
        f"K3 bf16 {cfg.name}: NaN past t reached the output")
    print(f"[paged bf16] {cfg.name} K3: {pages} pages x {splits} splits, "
          f"{Hkv * B * splits} CTAs; NaN past t: outputs bit-equal",
          flush=True)
    out["paged_attn_decode"] = entry

    start, kv_len, Cs = 320, 448, 128
    kp, vp, bt = _pools(torch, g, 1, P, ps, Hkv, hd, bf, [kv_len])
    qc = torch.randn(1, Cs, Hq, hd, device="cuda", generator=g).to(bf)
    qpos = torch.arange(start, start + Cs, device="cuda")
    kpos = torch.arange(S, device="cuda")
    cmask = (kpos[None, :] < kv_len) & (kpos[None, :] <= qpos[:, None])

    def lib_chunk():
        k = kp[bt.long()].reshape(1, S, Hkv, hd).transpose(1, 2)
        v = vp[bt.long()].reshape(1, S, Hkv, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(qc.transpose(1, 2), k, v,
                                              attn_mask=cmask[None, None],
                                              enable_gqa=Hq != Hkv)

    live = -(-kv_len // ps)
    keys = sum(min(p + 1, kv_len) for p in range(start, start + Cs))
    nbytes = live * page_bytes + Cs * Hq * hd * (2 + 4)
    flops = 4 * Hq * hd * keys
    o_par = torch.empty(1, Cs, Hq, hd, device="cuda")
    entry = _paged_entry(
        torch, flush,
        lambda: PA.paged_attn_chunk(qc, kp, vp, bt, start, kv_len),
        lambda: PA.paged_attn_chunk_plain(qc, kp, vp, bt, start, kv_len),
        lib_chunk, nbytes, flops, f"B=1 Cs={Cs} start={start} "
        f"kv_len={kv_len} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps}, {live} live pages",
        parent_call(torch, "paged_attn", "paged_attn_chunk_bf16", qc, kp, vp,
                    bt, o_par, 1, Cs, Hkv, Hq // Hkv, hd, ps, P, start, kv_len,
                    0, 0.0, PA.chunk_warps(Cs * (Hq // Hkv))))
    if PARENT:
        need(torch.equal(o_par, PA.paged_attn_chunk(qc, kp, vp, bt, start,
                                                    kv_len)),
             f"K4 bf16 {cfg.name}: the parent's body gave other bits")
    # poison: +-1e4 at every position no query may read (past kv_len in
    # the last live page, the pages past it, the null page) moves no bit
    pos = torch.arange(kv_len, device="cuda")
    readable = torch.zeros(kp.shape[:2], dtype=torch.bool, device="cuda")
    readable[bt[0, pos // ps].long(), pos % ps] = True
    sel = readable[:, :, None, None]
    clean = PA.paged_attn_chunk(qc, kp * sel, vp * sel, bt, start, kv_len)
    dirty = PA.paged_attn_chunk(qc, torch.where(sel, kp, 1e4),
                                torch.where(sel, vp, -1e4), bt, start, kv_len)
    need(torch.equal(clean, dirty), f"K4 bf16 {cfg.name}: poisoned "
         "unreachable positions moved an output bit")
    # warps per CTA (the wrapper's chunk_warps picks one), through the C
    # entry, each against the plain version
    lib, ref = PA._lib(), PA.paged_attn_chunk_plain(qc, kp, vp, bt, start,
                                                     kv_len)
    entry["warps"] = PA.chunk_warps(Cs * (Hq // Hkv))
    entry["warps_ms"] = {}
    for w in (1, 2, 4):
        o = torch.empty(1, Cs, Hq, hd, device="cuda")

        def launch(w=w, o=o):
            rc = lib.paged_attn_chunk_bf16(
                qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                o.data_ptr(), 1, Cs, Hkv, Hq // Hkv, hd, ps, P, start, kv_len,
                0, 0.0, w, torch.cuda.current_stream().cuda_stream)
            need(rc == 0, f"K4 at {w} warps per CTA: cudaError {rc}")
        launch()
        need(torch.allclose(o, ref, rtol=PAGED_TOL_BF16, atol=PAGED_TOL_BF16),
             f"K4 bf16 at {w} warps per CTA")
        entry["warps_ms"][w] = time_ms(torch, launch, flush)
    print(f"[paged bf16] {cfg.name} K4 poisoned pages: outputs bit-equal; "
          f"ms by warps per CTA {entry['warps_ms']} (chosen: "
          f"{entry['warps']})", flush=True)
    out["paged_attn_chunk"] = entry
    return out


# ------------------------------------------------------ phase 3b: int8 pages

def _int8_views(torch, Q, kp, vp, bt, live, grow_g=None):
    """An int8 pool from float pages, as the engine builds one: each page
    quantized against its own amax (Q.quantize_pages), then, with
    `grow_g`, each row's last live position rewritten through
    Q.scatter_token with values 4x larger, so its page's scale grows and
    the page rescales. Returns (clean, dirty, readable): clean zeroes every
    position no row may read and the scales of every page no row may read
    (the null page, the pages past a row's live keys); dirty holds +-127
    there and NaN in those scales. The kernels must give both the same
    bits."""
    k8, ks = Q.quantize_pages(kp)
    v8, vs = Q.quantize_pages(vp)
    B, ps = bt.shape[0], kp.shape[1]
    if grow_g is not None:
        pos = torch.tensor([int(n) - 1 for n in live], device="cuda")
        page = bt[torch.arange(B, device="cuda"), pos // ps].long()
        for c, s in ((k8, ks), (v8, vs)):
            val = 4 * torch.randn(B, *kp.shape[2:], device="cuda",
                                  generator=grow_g)
            Q.scatter_token(c, s, page, pos % ps, val)
    readable = torch.zeros(kp.shape[:2], dtype=torch.bool, device="cuda")
    for b in range(B):
        p = torch.arange(int(live[b]), device="cuda")
        readable[bt[b, p // ps].long(), p % ps] = True
    sel, used = readable[:, :, None, None], readable.any(dim=1)[:, None]
    i8 = torch.int8
    clean = dict(k_pages=torch.where(sel, k8, 0).to(i8),
                 v_pages=torch.where(sel, v8, 0).to(i8),
                 k_scales=torch.where(used, ks, 0.0),
                 v_scales=torch.where(used, vs, 0.0))
    dirty = dict(k_pages=torch.where(sel, k8, 127).to(i8),
                 v_pages=torch.where(sel, v8, -127).to(i8),
                 k_scales=torch.where(used, ks, float("nan")),
                 v_scales=torch.where(used, vs, float("nan")))
    return clean, dirty


def _i8_call(fn, q, pool, bt, *args, **kw):
    return fn(q, pool["k_pages"], pool["v_pages"], bt, *args,
              k_scales=pool["k_scales"], v_scales=pool["v_scales"], **kw)


def paged_int8_phase_small(torch, PA, Q):
    """K3 and K4 on int8 pages against their plain versions (gather, then
    dequantize) at small ragged shapes: q fp32 (K3's split body, K4's fp32
    body) and bf16 (K3, K4's tensor-core body); GQA 1/3/4, head_dim 64 and
    128, pages of 8 and 16, no window and a window of 20; rows of 1..64 live
    keys (a partly filled last page, the null page behind short rows), each
    row's last page's scale grown by a later write. fp32 q at
    PAGED_TOL_I8_F32, which must sit below a planted fault's error (the
    scales rounded to bf16); bf16 q at PAGED_TOL_BF16 as rtol and atol, as
    the bf16 pages' checks hold it (the grown pages hold values 4x the
    others). NaN in every dead and null page's scales and +-127 at every
    unreadable position move no output bit; a second launch repeats every
    bit."""
    g = torch.Generator(device="cuda").manual_seed(31)
    live = [1, 9, 16, 17, 40, 64]
    B, P, nkv = len(live), 8, 2
    t = torch.tensor([n - 1 for n in live], dtype=torch.int32, device="cuda")
    chunks = ((0, 9), (24, 40), (48, 64))
    worst, fault = {}, {}
    for ps in (8, 16):
        for hd in (64, 128):
            for G_ in (1, 3, 4):
                kp, vp, bt = _pools(torch, g, B, P, ps, nkv, hd,
                                    torch.float32, live)
                clean, dirty = _int8_views(torch, Q, kp, vp, bt, live, g)
                bf_sc = {k: (v.to(torch.bfloat16).float()
                             if k.endswith("scales") else v)
                         for k, v in clean.items()}
                for qdt in (torch.float32, torch.bfloat16):
                    tol = PAGED_TOL_I8_F32 if qdt == torch.float32 \
                        else PAGED_TOL_BF16
                    key = f"{str(qdt)[6:]} ps={ps} hd={hd} G={G_}"
                    q = torch.randn(B, nkv * G_, hd, device="cuda",
                                    generator=g).to(qdt)
                    qc = torch.randn(B, 16, nkv * G_, hd, device="cuda",
                                     generator=g).to(qdt)
                    errs, faults = [], []

                    def check(out, ref, what):
                        errs.append((out - ref).abs().max().item())
                        ok = errs[-1] <= tol if qdt == torch.float32 else \
                            torch.allclose(out, ref, rtol=tol, atol=tol)
                        need(ok, f"{what} int8 {key}: err {errs[-1]} "
                             f"(tol {tol})")
                    for window in (0, 20):
                        out = _i8_call(PA.paged_attn_decode, q, clean, bt, t,
                                       window=window)
                        ref = _i8_call(PA.paged_attn_decode_plain, q, clean,
                                       bt, t, window=window)
                        check(out, ref, f"K3 w={window}")
                        faults.append((out - _i8_call(
                            PA.paged_attn_decode_plain, q, bf_sc, bt, t,
                            window=window)).abs().max().item())
                        need(torch.equal(out, _i8_call(
                            PA.paged_attn_decode, q, dirty, bt, t,
                            window=window)),
                            f"K3 int8 {key} w={window}: a dead page's NaN "
                            "scale or an unreadable value reached the output")
                        need(torch.equal(out, _i8_call(
                            PA.paged_attn_decode, q, clean, bt, t,
                            window=window)),
                            f"K3 int8 {key}: a second launch gave other bits")
                    for start, kv_len in chunks:
                        full = [b for b in range(B) if live[b] >= kv_len]
                        n = kv_len - start
                        out = _i8_call(PA.paged_attn_chunk, qc, clean, bt,
                                       start, kv_len)
                        ref = _i8_call(PA.paged_attn_chunk_plain, qc, clean,
                                       bt, start, kv_len)
                        check(out[full, :n], ref[full, :n],
                              f"K4 {start}..{kv_len}")
                        faults.append((out[full, :n] - _i8_call(
                            PA.paged_attn_chunk_plain, qc, bf_sc, bt, start,
                            kv_len)[full, :n]).abs().max().item())
                        need(torch.equal(out[full], _i8_call(
                            PA.paged_attn_chunk, qc, dirty, bt, start,
                            kv_len)[full]),
                            f"K4 int8 {key} {start}..{kv_len}: a dead page's "
                            "NaN scale or an unreadable value reached the "
                            "output")
                        need(torch.equal(out, _i8_call(
                            PA.paged_attn_chunk, qc, clean, bt, start,
                            kv_len)),
                            f"K4 int8 {key}: a second launch gave other bits")
                    worst[key], fault[key] = max(errs), min(faults)
                    if qdt == torch.float32:
                        need(fault[key] > tol, f"K3/K4 int8 {key}: a planted "
                             f"fault's err {fault[key]} is within the "
                             f"tolerance {tol}")
    f32 = [v for k, v in worst.items() if k.startswith("float32")]
    bf = [v for k, v in worst.items() if k.startswith("bfloat16")]
    f32_fault = min(v for k, v in fault.items() if k.startswith("float32"))
    print(f"[paged int8] K3/K4 at live {live}, ps 8/16, hd 64/128, GQA "
          f"1/3/4, window 0/20, chunks {chunks}: max_abs_err by case "
          f"{json.dumps(worst)}; fp32 q "
          f"{max(f32):.3e} (tol {PAGED_TOL_I8_F32:g}; planted fault, scales "
          f"rounded to bf16: min {f32_fault:.3e}), bf16 q {max(bf):.3e} (tol "
          f"{PAGED_TOL_BF16:g}); NaN dead-page scales and +-127 unreadable "
          "values: outputs bit-equal; repeats bit-equal", flush=True)
    return {"fp32_q": max(f32), "bf16_q": max(bf), "fault_fp32_q": f32_fault}


def paged_int8_phase_full(torch, PA, Q, cfg, page_size, max_tokens):
    """K3 and K4 on int8 pages, bf16 q, at the full-width engine shapes of
    paged_phase_full: the same live pages (the same generator calls),
    quantized with Q.quantize_pages. Against the plain version at
    PAGED_TOL_BF16, NaN in every dead and null page's scales and +-127 at
    every unreadable position move no bit, a second launch repeats every
    bit; kernel, plain and library times (the library: the block-table
    gather, dequantization, then scaled_dot_product_attention). bound_ms
    counts each live page's int8 K and V and its scales once, q and the
    fp32 output. With --parent, the parent's int8 bodies run in turns with
    this checkout's at the wrapper's split and warps, and the two must give
    the same bits. Then K3 at splits of 64 and 128 keys and K4 at 1, 2 and
    4 warps per CTA, through the C entries, each against the plain version
    and its own repeat."""
    import torch.nn.functional as F
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(4)
    Hq, Hkv, hd, ps = cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim(), page_size
    G_ = Hq // Hkv
    P, S = max_tokens // ps, max_tokens
    page_bytes = PA.page_bytes(cfg.with_overrides(kv_quant="int8"), ps)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    lib, stream = PA._lib(), torch.cuda.current_stream().cuda_stream
    out = {}

    def deq(pool, bt, B):
        bt = bt.long()
        k = (pool["k_pages"][bt].float()
             * pool["k_scales"][bt][:, :, None, :, None]).to(bf)
        v = (pool["v_pages"][bt].float()
             * pool["v_scales"][bt][:, :, None, :, None]).to(bf)
        return (k.reshape(B, S, Hkv, hd).transpose(1, 2),
                v.reshape(B, S, Hkv, hd).transpose(1, 2))

    def pool_args(pool):
        return (pool["k_pages"], pool["v_pages"], pool["k_scales"],
                pool["v_scales"])

    def sweep(what, make, ref, settings):
        """{setting: ms} of the C entry's launch `make(setting)()`, each
        against the plain version and a second launch of itself."""
        ms = {}
        for x in settings:
            run = make(x)
            first = run().clone()
            need(torch.allclose(first, ref, rtol=PAGED_TOL_BF16,
                                atol=PAGED_TOL_BF16) and
                 torch.equal(first, run()),
                 f"{what} int8 {cfg.name} at {x}: off the plain version or "
                 "not repeatable")
            ms[x] = time_ms(torch, run, flush)
        return ms

    def against_parent(what, entry, o_par, got):
        """With --parent: the parent's body at the same split and warps
        must give this one's bits."""
        if not PARENT:
            return ""
        entry["parent_bits_equal"] = torch.equal(o_par, got)
        need(entry["parent_bits_equal"],
             f"{what} int8 {cfg.name}: the parent's body gave other bits")
        return "; the parent's body: bits equal"

    t = torch.tensor([64 + 31, 448 + 31, 128 + 31, 320 + 31],
                     dtype=torch.int32, device="cuda")
    B = len(t)
    kp, vp, bt = _pools(torch, g, B, P, ps, Hkv, hd, bf, (t + 1).tolist())
    q = torch.randn(B, Hq, hd, device="cuda", generator=g).to(bf)
    clean, dirty = _int8_views(torch, Q, kp, vp, bt, (t + 1).tolist())
    del kp, vp
    mask = torch.arange(S, device="cuda")[None, :] <= t[:, None]

    def lib_decode():
        k, v = deq(clean, bt, B)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask[:, None, None],
                                              enable_gqa=Hq != Hkv)

    def decode_at(split_pages):
        """The output and the operands of K3's int8 C entry at
        `split_pages` pages a split."""
        splits = -(-P // split_pages)
        o = torch.empty(B, Hq, hd, device="cuda")
        ws = torch.empty(B * Hkv * splits * G_ * (hd + 2), device="cuda")
        cnt = torch.zeros(B * Hkv, dtype=torch.int32, device="cuda")
        return o, (q, *pool_args(clean), bt, t, ws, cnt, o, B, Hkv, G_, hd,
                   ps, P, split_pages, splits, 0, 0.0)

    def decode_c(keys):
        o, args = decode_at(max(1, keys // ps))

        def run():        # holds `args`: the workspace and the counters
            rc = lib.paged_attn_decode_i8_bf16(*(
                a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args), stream)
            need(rc == 0, f"K3 int8 C entry: cudaError {rc}")
            return o
        return run

    live, _ = PA.decode_tick_pages(t.tolist(), [True] * B, ps, B, P)
    keys = sum(int(x) + 1 for x in t.tolist())
    pages, splits = PA.decode_splits(P, ps)
    o_par, par_args = decode_at(pages)
    entry = _paged_entry(
        torch, flush, lambda: _i8_call(PA.paged_attn_decode, q, clean, bt, t),
        lambda: _i8_call(PA.paged_attn_decode_plain, q, clean, bt, t),
        lib_decode, live * page_bytes + B * Hq * hd * (2 + 4),
        4 * Hq * hd * keys, f"int8 pages, B={B} t={t.tolist()} Hq={Hq} "
        f"Hkv={Hkv} hd={hd} ps={ps} P={P}, {live} live pages",
        parent_call(torch, "paged_attn", "paged_attn_decode_i8_bf16",
                    *par_args))
    got = _i8_call(PA.paged_attn_decode, q, clean, bt, t)
    need(torch.equal(got, _i8_call(PA.paged_attn_decode, q, dirty, bt, t)),
         f"K3 int8 {cfg.name}: a dead page's NaN scale reached the output")
    entry.update(pages_per_split=pages, splits=splits, ctas=Hkv * B * splits)
    said = against_parent("K3", entry, o_par, got)
    entry["split_keys_ms"] = sweep(
        "K3", decode_c, _i8_call(PA.paged_attn_decode_plain, q, clean, bt, t),
        (64, 128))
    print(f"[paged int8] {cfg.name} K3: {pages} pages x {splits} splits, "
          f"{Hkv * B * splits} CTAs; ms by keys a split "
          f"{entry['split_keys_ms']}{said}", flush=True)
    out["paged_attn_decode_int8"] = entry

    start, kv_len, Cs = 320, 448, 128
    kp, vp, bt = _pools(torch, g, 1, P, ps, Hkv, hd, bf, [kv_len])
    qc = torch.randn(1, Cs, Hq, hd, device="cuda", generator=g).to(bf)
    clean, dirty = _int8_views(torch, Q, kp, vp, bt, [kv_len])
    del kp, vp
    qpos = torch.arange(start, start + Cs, device="cuda")
    kpos = torch.arange(S, device="cuda")
    cmask = (kpos[None, :] < kv_len) & (kpos[None, :] <= qpos[:, None])

    def lib_chunk():
        k, v = deq(clean, bt, 1)
        return F.scaled_dot_product_attention(qc.transpose(1, 2), k, v,
                                              attn_mask=cmask[None, None],
                                              enable_gqa=Hq != Hkv)

    def chunk_c(w):
        o = torch.empty(1, Cs, Hq, hd, device="cuda")
        args = (qc, *pool_args(clean), bt, o)

        def run():
            rc = lib.paged_attn_chunk_i8_bf16(
                *(a.data_ptr() for a in args), 1, Cs, Hkv, G_, hd, ps, P,
                start, kv_len, 0, 0.0, w, stream)
            need(rc == 0, f"K4 int8 C entry at {w} warps: cudaError {rc}")
            return o
        return run

    live = -(-kv_len // ps)
    keys = sum(min(p + 1, kv_len) for p in range(start, start + Cs))
    warps = PA.chunk_warps(Cs * G_)
    o_par = torch.empty(1, Cs, Hq, hd, device="cuda")
    entry = _paged_entry(
        torch, flush,
        lambda: _i8_call(PA.paged_attn_chunk, qc, clean, bt, start, kv_len),
        lambda: _i8_call(PA.paged_attn_chunk_plain, qc, clean, bt, start,
                         kv_len),
        lib_chunk, live * page_bytes + Cs * Hq * hd * (2 + 4),
        4 * Hq * hd * keys, f"int8 pages, B=1 Cs={Cs} start={start} "
        f"kv_len={kv_len} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps}, {live} live "
        "pages",
        parent_call(torch, "paged_attn", "paged_attn_chunk_i8_bf16", qc,
                    *pool_args(clean), bt, o_par, 1, Cs, Hkv, G_, hd, ps, P,
                    start, kv_len, 0, 0.0, warps))
    got = _i8_call(PA.paged_attn_chunk, qc, clean, bt, start, kv_len)
    need(torch.equal(
        got, _i8_call(PA.paged_attn_chunk, qc, dirty, bt, start, kv_len)),
        f"K4 int8 {cfg.name}: a dead page's NaN scale reached the output")
    entry["warps"] = warps
    said = against_parent("K4", entry, o_par, got)
    entry["warps_ms"] = sweep(
        "K4", chunk_c, _i8_call(PA.paged_attn_chunk_plain, qc, clean, bt,
                                start, kv_len), (1, 2, 4))
    print(f"[paged int8] {cfg.name} K4: {entry['warps']} warps a CTA; ms by "
          f"warps per CTA {entry['warps_ms']}{said}", flush=True)
    out["paged_attn_chunk_int8"] = entry
    print(f"[paged int8] {cfg.name} K3/K4 at full width: NaN dead-page "
          "scales and +-127 unreadable values move no bit", flush=True)
    return out


# K3/K4 at a dense model's served shapes (bf16 q, fp32 output, up to 4608
# keys a query): a windowed output is a mean over ~4096 values, std
# ~0.026, so a kernel that skipped 64 of them moves it by a few 1e-3 and
# PAGED_TOL_BF16 would pass it. paged_phase_windowed requires err <=
# WINDOW_PAGED_TOL < a planted fault's err: the plain version without the
# keys `drop`, one of K3's 64-key splits (of the long row) and one of K4's
# 64-key tiles (of every query), inside every window that reaches them.
WINDOW_PAGED_TOL = 2.5e-3
SC2_MAX_TOKENS = 5120


def paged_phase_windowed(torch, PA, Q, cfg, shape):
    """K3 and K4, bf16 q on bf16 and int8 pages, at one of PAGED_SHAPES
    (cfg's heads and head_dim: starcoder2's GQA 24/2 x 128, 12 query heads
    a kv head, K3's GB 16 body, K4's warps whose 16 rows straddle two
    queries; qwen2's 28/4, 7 a kv head; gemma3's 32/16) with its window
    (0: global): each against its plain version (WINDOW_PAGED_TOL, below a
    planted fault's err: the plain version without the keys `drop`) and
    timed beside it and the library call (gather, dequantize, sdpa). Every
    key outside each query's window (and past each row's end) holds +-1e4
    (int8: +-127, and NaN in the scales of pages no query may read) in a
    second pool, which must give the same bits: the kernels read nothing
    outside the window. bound_ms counts the pages inside the windows, read
    once (int8: values and scales), q and the fp32 output; the FLOPs of the
    keys each query attends."""
    import torch.nn.functional as F
    from repro_torch.models import attention as ATT
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(31)
    Hq, Hkv, hd, ps = cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim(), 16
    W, S = shape["window"], shape["max_tokens"]
    P = S // ps
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kpos = torch.arange(S, device="cuda")
    out = {}

    def pools(B, seen):
        """bf16 and int8 pools (clean, dirty) whose rows see the keys
        `seen` [B, S]; page ids shuffled, the null page behind each row's
        end."""
        live = [int(seen[b].nonzero().max()) + 1 for b in range(B)]
        kp, vp, bt = _pools(torch, g, B, P, ps, Hkv, hd, torch.float32,
                            live)
        readable = torch.zeros(kp.shape[:2], dtype=torch.bool, device="cuda")
        for b in range(B):
            p = kpos[seen[b]]
            readable[bt[b, p // ps].long(), p % ps] = True
        sel, used = readable[:, :, None, None], readable.any(dim=1)[:, None]
        kc, vc = (torch.where(sel, a, 0.0) for a in (kp, vp))
        bf16 = (dict(k_pages=kc.to(bf), v_pages=vc.to(bf)),
                dict(k_pages=torch.where(sel, kp, 1e4).to(bf),
                     v_pages=torch.where(sel, vp, -1e4).to(bf)))
        (k8, ks), (v8, vs) = Q.quantize_pages(kc), Q.quantize_pages(vc)
        i8 = torch.int8
        int8 = (dict(k_pages=k8, v_pages=v8, k_scales=ks, v_scales=vs),
                dict(k_pages=torch.where(sel, k8, 127).to(i8),
                     v_pages=torch.where(sel, v8, -127).to(i8),
                     k_scales=torch.where(used, ks, float("nan")),
                     v_scales=torch.where(used, vs, float("nan"))))
        return bt, {"": bf16, "_int8": int8}, int(used.sum())

    def call(fn, q, pool, bt, *args):
        sc = {k: pool[k] for k in ("k_scales", "v_scales") if k in pool}
        return fn(q, pool["k_pages"], pool["v_pages"], bt, *args, window=W,
                  **sc)

    def gathered(pool, bt, B):
        bt = bt.long()
        k, v = pool["k_pages"][bt].float(), pool["v_pages"][bt].float()
        if "k_scales" in pool:
            k = k * pool["k_scales"][bt][:, :, None, :, None]
            v = v * pool["v_scales"][bt][:, :, None, :, None]
        return (k.to(bf).reshape(B, S, Hkv, hd).transpose(1, 2),
                v.to(bf).reshape(B, S, Hkv, hd).transpose(1, 2))

    keep = (kpos < shape["drop"][0]) | (kpos >= shape["drop"][1])

    def dropped(kind, q, pool, bt, mask, args):
        """The plain version without the keys `drop` (a planted fault)."""
        k, v = (PA._gather(pool[f"{x}_pages"], bt, pool.get(f"{x}_scales"))
                for x in "kv")
        if kind == "decode":
            return ATT._decode_sdpa(q[:, None], k, v,
                                    mask[:, 0, 0] & keep)[:, 0]
        start, kv_len = args
        q_pos = start + torch.arange(q.shape[1], device="cuda")
        return ATT.sdpa_chunked_f32(q, k, v, q_pos,
                                    torch.where(keep, kpos, 2 ** 30), W,
                                    kv_len)

    def entries(kind, q, bt, by_pages, n_pages, keys, mask, args, lib_q,
                n_out):
        for tag, (clean, dirty) in by_pages.items():
            pcfg = cfg.with_overrides(kv_quant="int8" if tag else "none")
            fn = getattr(PA, f"paged_attn_{kind}")
            plain = getattr(PA, f"paged_attn_{kind}_plain")
            B = bt.shape[0]

            def lib(clean=clean):
                k, v = gathered(clean, bt, B)
                return F.scaled_dot_product_attention(
                    lib_q, k, v, attn_mask=mask, enable_gqa=True)

            entry = _paged_entry(
                torch, flush, lambda: call(fn, q, clean, bt, *args),
                lambda: call(plain, q, clean, bt, *args), lib,
                n_pages * PA.page_bytes(pcfg, ps) + n_out * Hq * hd * (2 + 4),
                4 * Hq * hd * keys,
                f"{'int8' if tag else 'bf16'} pages, GQA {Hq}/{Hkv} x {hd}, "
                f"window {W}, {args}, {n_pages} pages inside the window(s)",
                tol=WINDOW_PAGED_TOL,
                fault=lambda clean=clean: dropped(kind, q, clean, bt, mask,
                                                  args))
            got = call(fn, q, clean, bt, *args)
            need(torch.equal(got, call(fn, q, dirty, bt, *args)),
                 f"K{3 if kind == 'decode' else 4}{tag} {cfg.name}: keys "
                 "outside the window moved an output bit")
            entry["window_pages"] = n_pages
            out[f"paged_attn_{kind}{tag}"] = entry

    t = torch.tensor(shape["t"], dtype=torch.int32, device="cuda")
    B = len(shape["t"])
    seen = kpos[None] <= t[:, None]
    if W > 0:
        seen &= kpos[None] > t[:, None] - W
    bt, by_pages, n_pages = pools(B, seen)
    q = torch.randn(B, Hq, hd, device="cuda", generator=g).to(bf)
    entries("decode", q, bt, by_pages, n_pages, int(seen.sum()),
            seen[:, None, None], (t,), q[:, :, None], B)
    start, Cs, kv_len = shape["chunk"]
    qpos = torch.arange(start, start + Cs, device="cuda")
    cmask = (kpos[None] < kv_len) & (kpos[None] <= qpos[:, None])
    if W > 0:
        cmask &= kpos[None] > qpos[:, None] - W
    bt, by_pages, n_pages = pools(1, cmask.any(dim=0)[None])
    qc = torch.randn(1, Cs, Hq, hd, device="cuda", generator=g).to(bf)
    entries("chunk", qc, bt, by_pages, n_pages, int(cmask.sum()),
            cmask[None, None], (start, kv_len), qc.transpose(1, 2), Cs)
    print(f"[paged {cfg.name}] K3/K4 bf16 and int8 at GQA {Hq}/{Hkv} x "
          f"{hd}, window {W}: within {WINDOW_PAGED_TOL} of the plain "
          f"versions, below the planted faults' errors (keys "
          f"{shape['drop']} left out: "
          f"{[round(e['planted_fault_err'], 6) for e in out.values()]}); "
          "keys outside the window move no bit", flush=True)
    return out


def _paged_entry(torch, flush, kern, plain, lib, nbytes, flops, shape,
                 parent=None, tol=None, fault=None):
    """A paged kernel against its plain version, timed beside it and the
    library call. By default within PAGED_TOL_BF16 (rtol and atol); with
    `tol` and `fault` (the plain version of a planted fault), err <= tol <
    the fault's err, checked after the entry is printed."""
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if fault is None:
        need(torch.allclose(got, ref, rtol=PAGED_TOL_BF16,
                            atol=PAGED_TOL_BF16),
             f"paged attention bf16 err {err} ({shape})")
    else:
        fault_err = (fault() - ref).abs().max().item()
    need(torch.equal(got, kern()), f"paged attention bf16: a second launch "
         f"gave other bits ({shape})")
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    entry = rates({"shape": shape, "max_abs_err": err,
                   **timed(torch, kern, flush, parent),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": time_ms(torch, lib, flush),
                   "bound_ms": max(t_b, t_f),
                   "bound_by": "bytes" if t_b >= t_f else "operations"},
                  nbytes)
    if fault is not None:
        entry.update(tol=tol, planted_fault_err=fault_err)
    print(f"[paged bf16] {json.dumps(entry)}", flush=True)
    if fault is not None:
        need(err <= tol < fault_err, f"paged attention err {err}, tol {tol}, "
             f"planted fault {fault_err} ({shape})")
    return entry


def slstm_phase(torch, SC):
    """K9 against its plain version: fp32 at the JAX test's shapes, then
    the full-width sLSTM of xlstm-1.3b (fp32 u, bf16 r, as model_forward
    passes them) on its cluster body beside a planted fault, repeated
    launches bit-equal, with times; then fp32 r at the same width, which
    does not fit a cluster and keeps the per-(head, batch row) body. The
    bound: u and r read once, h written once, over 3.35 TB/s, against
    2·B·S·4·H·hd² FLOPs over 989 TFLOP/s; neither sees the S serial steps.
    No single PyTorch call computes the recurrence, so the library column
    is null."""
    g = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    for B, S, H, hd in SLSTM_SMALL:
        u = torch.randn(B, S, 4 * H * hd, device="cuda", generator=g) * 0.5
        r = torch.randn(4, H, hd, hd, device="cuda", generator=g) / hd ** 0.5
        h, hp = SC.slstm_seq(u, r), SC.slstm_seq_plain(u, r)
        torch.cuda.synchronize()
        err = (h - hp).abs().max().item()
        need(torch.allclose(h, hp, rtol=SLSTM_TOL_F32, atol=SLSTM_TOL_F32),
             f"K9 fp32 {(B, S, H, hd)} err {err}")
        worst = max(worst, err)
    print(f"[slstm fp32] (B, S, H, hd) in {SLSTM_SMALL} (clusters of "
          f"{[SC.slstm_cluster(b, d, 4) for b, _, _, d in SLSTM_SMALL]}): "
          f"max_abs_err {worst:.3e} (tol {SLSTM_TOL_F32:g})", flush=True)

    B, S, H, hd = SLSTM_FULL
    u = torch.randn(B, S, 4 * H * hd, device="cuda", generator=g)
    r32 = torch.randn(4, H, hd, hd, device="cuda", generator=g) / hd ** 0.5
    r = r32.to(torch.bfloat16)
    CL = SC.slstm_cluster(B, hd, r.element_size())
    need(CL == SC.CLUSTER_MAX, f"K9 full width: cluster {CL}, want 16")
    r_fault = r.clone()
    r_fault[..., -1] = 0
    h, h2 = SC.slstm_seq(u, r), SC.slstm_seq(u, r)
    hf, hp = SC.slstm_seq(u, r_fault), SC.slstm_seq_plain(u, r)
    torch.cuda.synchronize()
    err = (h - hp).abs().max().item()
    fault = (hf - hp).abs().max().item()
    need(err <= SLSTM_TOL_FULL < fault, f"K9 full width: err {err}, planted "
         f"fault {fault}, tol {SLSTM_TOL_FULL}")
    need(torch.equal(h, h2), "K9 gave other bits when launched again")
    nbytes = u.numel() * 4 + r.numel() * 2 + h.numel() * 4
    flops = 2 * B * S * 4 * H * hd * hd
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    entry = {"shape": f"B={B} S={S} H={H} hd={hd}, u fp32, r bf16",
             "max_abs_err": err, "planted_fault_err": fault,
             "tol": SLSTM_TOL_FULL, "cluster": CL, "ctas": CL * H,
             "cluster_capacity": SC._CLUSTERS_FIT[("f32", "bf16", B, hd,
                                                   CL)],
             **timed(torch, lambda: SC.slstm_seq(u, r), flush),
             "plain_ms": time_ms(torch, lambda: SC.slstm_seq_plain(u, r),
                                 flush),
             "bound_ms": max(t_b, t_f),
             "bound_by": "bytes" if t_b >= t_f else "operations",
             "bound_bytes_ms": t_b, "bound_operations_ms": t_f,
             "bound_note": f"{S} serial steps, which neither bound sees",
             "library_ms": None}
    # fp32 r: 256 KB of r a CTA even at 16 CTAs, so the other body
    need(SC.slstm_cluster(B, hd, 4) is None, "K9 fp32 r at hd 512 fits a "
         "cluster")
    h32, hp32 = SC.slstm_seq(u, r32), SC.slstm_seq_plain(u, r32)
    err32 = (h32 - hp32).abs().max().item()
    need(err32 <= SLSTM_TOL_FULL, f"K9 fp32 r, per-row body: err {err32}")
    need(torch.equal(h32, SC.slstm_seq(u, r32)),
         "K9 fp32 r gave other bits when launched again")
    entry["fp32_r"] = {"body": "slstm_seq_kernel (per head, batch row)",
                       "max_abs_err": err32,
                       "ms": time_ms(torch, lambda: SC.slstm_seq(u, r32),
                                     flush)}
    del flush
    print(f"[slstm bf16 r] {json.dumps(entry)}", flush=True)
    return entry


def gmm_launches(cfg, prefills, decodes):
    """The grouped-GEMM launches of `prefills` prefill passes (one-shot or
    chunk) and `decodes` decode steps: one K1 and one K2 per layer and pass,
    except that token choice with C1 groups prefills through K7/K8; none
    for a dense MLP."""
    L = cfg.num_layers
    if cfg.moe is None:
        return {"gmm_swiglu": 0, "gmm_scaled": 0, "gmm_swiglu_fused": 0,
                "gmm_scaled_fused": 0, "gmm": 0}
    grouped = cfg.moe.routing == "token_choice" and cfg.moe.group_size > 1 \
        and cfg.moe.use_grouped_gemm
    unfused = L * (decodes + (0 if grouped else prefills))
    fused = L * prefills if grouped else 0
    return {"gmm_swiglu": unfused, "gmm_scaled": unfused,
            "gmm_swiglu_fused": fused, "gmm_scaled_fused": fused, "gmm": 0}


def go_topk_launches(cfg, decodes):
    """K5R's launches over `decodes` decode steps: one per layer and step
    where the decode runs through the GO cache (expert choice), else 0;
    K5 alone runs on no served path."""
    go = cfg.block == "attn" and cfg.moe is not None and \
        cfg.moe.routing == "expert_choice" and cfg.moe.go_cache
    return {"go_topk_update": 0,
            "go_router": cfg.num_layers * decodes if go else 0}


def _smoke_params(torch, TM, cfg_smoke):
    """A smoke config's fp32 weights on the CPU, seed 0; QKV biases (qwen2)
    drawn at QKV_BIAS_STD from seed 1, so their path is live."""
    params = TM.model_init(cfg_smoke, torch.Generator().manual_seed(0), "cpu")
    _plant_biases(torch, params, torch.Generator().manual_seed(1),
                  QKV_BIAS_STD)
    return params


def smoke_phase(torch, G, GT, cfg_smoke, TM, TS):
    """Smoke-size slice on the CPU (plain versions) and on the card
    (kernels), same fp32 weights. Greedy tokens equal; logits within
    SMOKE_LOGIT_TOL; one prefill and 8 decode steps' grouped GEMMs
    launched, and K5R once per layer and decode step with a GO cache."""
    params = _smoke_params(torch, TM, cfg_smoke)
    params_cuda = _tree_to(params, "cuda")
    prompts = torch.randint(0, cfg_smoke.vocab_size, (4, 32),
                            generator=torch.Generator().manual_seed(1))
    r_cpu = TS.generate(params, cfg_smoke, prompts, 8, device="cpu")
    G.reset_launches()
    GT.reset_launches()
    r_gpu = TS.generate(params_cuda, cfg_smoke, prompts, 8, device="cuda")
    launches = {**G.LAUNCHES, **GT.LAUNCHES}
    err = (r_gpu["logits"].cpu() - r_cpu["logits"]).abs().max().item()
    need(launches == {**gmm_launches(cfg_smoke, 1, 8),
                      **go_topk_launches(cfg_smoke, 8)},
         f"smoke cuda launches {launches}")
    need(torch.equal(r_gpu["tokens"].cpu(), r_cpu["tokens"]),
         f"{cfg_smoke.name}: greedy tokens differ between cpu and cuda")
    need(err <= SMOKE_LOGIT_TOL, f"{cfg_smoke.name}: smoke logits differ "
         f"by {err}")
    print(f"[smoke] {cfg_smoke.name}: cpu and cuda greedy tokens equal "
          f"{r_cpu['tokens'][0].tolist()}, logits max_abs_err {err:.3e} "
          f"(tol {SMOKE_LOGIT_TOL:g}), cuda launches {launches}", flush=True)
    return err


def paged_launches(cfg, decodes, chunks, kv_quant="none"):
    """K3's and K4's launches over `decodes` decode ticks and `chunks` chunk
    ticks: one per layer and tick, counted under the `_int8` names on an
    int8 pool and the plain names otherwise."""
    L, q8 = cfg.num_layers, kv_quant == "int8"
    return {"paged_attn_decode": 0 if q8 else L * decodes,
            "paged_attn_chunk": 0 if q8 else L * chunks,
            "paged_attn_decode_int8": L * decodes if q8 else 0,
            "paged_attn_chunk_int8": L * chunks if q8 else 0}


def _pool_state(state):
    """Every tensor of a drained pool's decode state (GO rows and scales
    included), the null page 0 left out of the pages and their scales:
    free rows write there, several to one position in a tick in no fixed
    order, and nothing reads it."""
    return _tensors({k: v[:, 1:] if k in ("k_pages", "v_pages", "k_scales",
                                          "v_scales") else v
                     for k, v in state.items()})


def _same(torch, a, b):
    """Two lists of tensors, equal bit for bit."""
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def engine_smoke_phase(torch, G, PA, GT, cfg_smoke, TM, TS, kv_quant="none"):
    """The smoke engine on a paged pool with chunked prefill, the same fp32
    weights and trace on the CPU (plain versions) and on the card (K1-K4,
    K7/K8): greedy streams equal; K3/K4 launched once per layer per decode
    or chunk tick, the grouped GEMMs once per layer per prefill pass and
    decode tick, K5R once per layer and decode tick with a GO cache. With
    kv_quant="int8" (pages of 8: int8 pages need a multiple of 8) the card
    runs K3/K4 on int8 pages, a second card run repeats the streams and the
    pool's pages, scales, GO rows and GO scales bit for bit (page 0 left
    out), and, for expert choice, each stream equals the request alone on a
    1-slot int8 engine on the card (token choice routes the pool's rows
    together under a capacity, so no solo oracle exists there)."""
    import numpy as np
    params = _smoke_params(torch, TM, cfg_smoke)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_smoke.vocab_size, size=n, dtype=np.int32)
               for n in (5, 20, 8, 11, 3)]
    kw = dict(num_slots=2, max_tokens=32, arrival_steps=[0, 0, 1, 4, 6],
              paged=True, page_size=4, num_pages=10, prefill_chunk=8)
    if kv_quant != "none":
        kw.update(page_size=8, num_pages=6, kv_quant=kv_quant)
    r_cpu = TS.serve_continuous(params, cfg_smoke, prompts, 7, device="cpu",
                                **kw)
    params_cuda = _tree_to(params, "cuda")
    PA.reset_launches()
    G.reset_launches()
    GT.reset_launches()
    r_gpu = TS.serve_continuous(params_cuda, cfg_smoke, prompts, 7,
                                device="cuda", **kw)
    launches = {**G.LAUNCHES, **PA.LAUNCHES, **GT.LAUNCHES}
    s = r_gpu["stats"]
    for rid, toks in r_cpu["tokens"].items():
        need(np.array_equal(r_gpu["tokens"][rid], toks),
             f"{cfg_smoke.name} {kv_quant} engine request {rid}: cuda "
             f"{r_gpu['tokens'][rid].tolist()} != cpu {toks.tolist()}")
    one_shot = sum(len(p) <= kw["prefill_chunk"] for p in prompts)
    need(launches == {**gmm_launches(cfg_smoke, s["chunk_ticks"] + one_shot,
                                     s["decode_ticks"]),
                      **go_topk_launches(cfg_smoke, s["decode_ticks"]),
                      **paged_launches(cfg_smoke, s["decode_ticks"],
                                       s["chunk_ticks"], kv_quant)},
         f"smoke engine launches {launches}, stats {s}")
    extra = ""
    if kv_quant != "none":
        again = TS.serve_continuous(params_cuda, cfg_smoke, prompts, 7,
                                    device="cuda", **kw)
        need(all(np.array_equal(again["tokens"][r], t)
                 for r, t in r_gpu["tokens"].items()) and
             _same(torch, _pool_state(r_gpu["engine"].pool.state),
                   _pool_state(again["engine"].pool.state)),
             f"{cfg_smoke.name} int8 engine: a second card run gave other "
             "streams, pages, scales or GO rows")
        extra = "; a second run repeats streams, pages, scales and GO rows"
        if cfg_smoke.moe is not None and \
                cfg_smoke.moe.routing == "expert_choice":
            solo = dict(kw, num_slots=1, arrival_steps=None)
            for rid, p in enumerate(prompts):
                one = TS.serve_continuous(params_cuda, cfg_smoke, [p], 7,
                                          device="cuda", **solo)
                need(np.array_equal(one["tokens"][0], r_gpu["tokens"][rid]),
                     f"{cfg_smoke.name} int8 engine request {rid}: pooled "
                     "stream differs from the request alone")
            extra += ", and each stream equals its request alone"
        extra += (f"; dequant_max_abs_err {s['dequant_max_abs_err']:.3e}, "
                  f"{s['kv_bytes_per_token']:g} KV bytes a token")
    print(f"[smoke engine] {cfg_smoke.name} kv_quant={kv_quant}: cpu and "
          f"cuda greedy streams equal for {len(prompts)} requests "
          f"({s['decode_ticks']} decode ticks, {s['chunk_ticks']} chunk "
          f"ticks), cuda launches {launches}{extra}", flush=True)
    if kv_quant == "none":
        engine_smoke_wide(torch, G, PA, GT, cfg_smoke, params, params_cuda,
                          TS)
        engine_smoke_sampled(torch, G, PA, GT, cfg_smoke, params,
                             params_cuda, TS, prompts, kw)


def _submit_mixed(eng, prompts, gen, arrivals=None, top_p_of=None):
    """Submit `prompts` with requests alternating greedy (even ids) and
    sampled (odd ids: temperature 0.8, top_p 0.9, seed = the request id);
    `top_p_of` overrides a request's top_p by id. Returns the ids."""
    return [eng.submit(p, gen, arrival_step=arrivals[i] if arrivals else 0,
                       temperature=0.8 * (i % 2),
                       top_p=(top_p_of or {}).get(i, 0.9), seed=i)
            for i, p in enumerate(prompts)]


def engine_smoke_wide(torch, G, PA, GT, cfg, params, params_cuda, TS):
    """A 66-slot paged engine of 66 short requests (3 to 6 prompt tokens,
    3 new tokens, all at tick 0), greedy, on the CPU and the card: the
    streams equal; the GO decode runs past K5R's bound, so K5 once per
    layer and decode tick with a GO cache, K5R never."""
    import numpy as np
    rng = np.random.default_rng(66)
    prompts = [rng.integers(0, cfg.vocab_size, size=3 + i % 4,
                            dtype=np.int32) for i in range(66)]
    kw = dict(num_slots=66, max_tokens=12, paged=True, page_size=4)
    r_cpu = TS.serve_continuous(params, cfg, prompts, 3, device="cpu", **kw)
    for mod in (G, PA, GT):
        mod.reset_launches()
    r_gpu = TS.serve_continuous(params_cuda, cfg, prompts, 3, device="cuda",
                                **kw)
    launches = {**G.LAUNCHES, **PA.LAUNCHES, **GT.LAUNCHES}
    s = r_gpu["stats"]
    need(all(np.array_equal(r_gpu["tokens"][r], t)
             for r, t in r_cpu["tokens"].items()),
         f"{cfg.name} 66-slot engine: cuda streams differ from the cpu's")
    go = go_topk_launches(cfg, s["decode_ticks"])
    expect = {**gmm_launches(cfg, len(prompts), s["decode_ticks"]),
              "go_topk_update": go["go_router"], "go_router": 0,
              **paged_launches(cfg, s["decode_ticks"], 0)}
    need(launches == expect and s["peak_active"] == 66,
         f"66-slot engine launches {launches}, expected {expect}; stats {s}")
    print(f"[smoke engine] {cfg.name} 66 slots: cpu and cuda greedy streams "
          f"equal for 66 requests ({s['decode_ticks']} decode ticks), cuda "
          f"launches {launches}", flush=True)


def engine_smoke_sampled(torch, G, PA, GT, cfg, params, params_cuda, TS,
                         prompts, kw):
    """The smoke engine trace again with prompt buckets, requests
    alternating greedy and sampled (temperature 0.8, top_p 0.9, seed = the
    request id), on the CPU and the card: both draw the same uniforms, so
    every stream, sampled ones included, must be equal; prefill_lengths
    equal; the launches those of the greedy trace's formula (sampling runs
    no kernel of the port)."""
    import numpy as np
    streams, stats = {}, {}
    for side, dev, p in (("cpu", "cpu", params),
                         ("card", "cuda", params_cuda)):
        for mod in (G, PA, GT):
            mod.reset_launches()
        eng = TS.ServingEngine(p, cfg, device=dev, prompt_buckets=True,
                               **{k: v for k, v in kw.items()
                                  if k != "arrival_steps"})
        rids = _submit_mixed(eng, prompts, 7, kw["arrival_steps"])
        fin = eng.run()
        streams[side] = [fin[r].tokens for r in rids]
        stats[side] = eng.stats()
    launches = {**G.LAUNCHES, **PA.LAUNCHES, **GT.LAUNCHES}
    s = stats["card"]
    one_shot = sum(len(q) <= kw["prefill_chunk"] for q in prompts)
    expect = {**gmm_launches(cfg, s["chunk_ticks"] + one_shot,
                             s["decode_ticks"]),
              **go_topk_launches(cfg, s["decode_ticks"]),
              **paged_launches(cfg, s["decode_ticks"], s["chunk_ticks"])}
    need(launches == expect, f"sampled smoke engine launches {launches}, "
         f"expected {expect}")
    for rid, (a, b) in enumerate(zip(streams["cpu"], streams["card"])):
        need(a == b, f"{cfg.name} bucketed sampled engine request {rid} "
             f"({'sampled' if rid % 2 else 'greedy'}): cuda {b} != cpu {a}")
    need(s["prefill_lengths"] == stats["cpu"]["prefill_lengths"],
         f"prefill_lengths cuda {s['prefill_lengths']}, cpu "
         f"{stats['cpu']['prefill_lengths']}")
    print(f"[smoke engine] {cfg.name} buckets {s['prefill_lengths']}, "
          "greedy and sampled (0.8, 0.9, seed = id) requests alternating: "
          f"cpu and cuda streams equal {streams['card']}, cuda launches "
          f"{launches}", flush=True)


def xlstm_smoke_phase(torch, SC, cfg, TM, TS):
    """xlstm SMOKE on the CPU (plain K9) and on the card (K9), same fp32
    weights: model_forward hidden states within XLSTM_SMOKE_HIDDEN_TOL,
    generate()'s logits within SMOKE_LOGIT_TOL, greedy tokens equal, K9 launched once per sLSTM block
    of the forward; on the card, the forward's last logits against a
    stepwise prefill plus one serve_step at the reference's
    decode-consistency tolerance (rtol 1e-2, atol 5e-3)."""
    params = TM.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    pc = _tree_to(params, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    tc = tokens.cuda()
    x_cpu, _ = TM.model_forward(params, tokens, cfg)
    SC.reset_launches()
    x_gpu, _ = TM.model_forward(pc, tc, cfg)
    launches = SC.LAUNCHES["slstm_seq"]
    n_seg = cfg.num_layers // cfg.slstm_every
    err_x = (x_gpu.cpu() - x_cpu).abs().max().item()
    need(launches == n_seg, f"xlstm smoke: K9 launched {launches} times, "
         f"expected {n_seg}")
    need(err_x <= XLSTM_SMOKE_HIDDEN_TOL, f"xlstm smoke hidden states "
         f"differ by {err_x}")
    r_cpu = TS.generate(params, cfg, tokens, 8, device="cpu")
    r_gpu = TS.generate(pc, cfg, tc, 8, device="cuda")
    err_l = (r_gpu["logits"].cpu() - r_cpu["logits"]).abs().max().item()
    need(torch.equal(r_gpu["tokens"].cpu(), r_cpu["tokens"]),
         "xlstm smoke: greedy tokens differ between cpu and cuda")
    need(err_l <= SMOKE_LOGIT_TOL, f"xlstm smoke logits differ by {err_l}")
    ref = TM.logits_from_hidden(pc, x_gpu[:, -1, :], cfg)
    st, _ = TM.prefill(pc, tc[:, :-1], cfg)
    lg, _ = TM.serve_step(pc, st, tc[:, -1], cfg)
    err_c = (lg - ref).abs().max().item()
    need(torch.allclose(lg, ref, rtol=1e-2, atol=5e-3),
         f"xlstm smoke: prefill + serve_step vs model_forward err {err_c}")
    print(f"[smoke xlstm] {cfg.name}: model_forward cpu vs cuda max_abs_err "
          f"{err_x:.3e} (tol {XLSTM_SMOKE_HIDDEN_TOL:g}), K9 launches "
          f"{launches}; generate() tokens equal "
          f"{r_cpu['tokens'][0].tolist()}, logits max_abs_err {err_l:.3e} "
          f"(tol {SMOKE_LOGIT_TOL:g}); cuda prefill + serve_step vs "
          f"forward max_abs_err {err_c:.3e} (rtol 1e-2, atol 5e-3)",
          flush=True)


def xlstm_full_phase(torch, counts, reset_counts, cfg, TM, TS,
                     ServingEngine):
    """Full-width xlstm-1.3b, bf16, random weights from a seeded generator
    on the card. `xlstm_forward`: model_forward on 4 x 128 tokens, a
    warm-up, then three runs (the first counted): K9 launched once per
    sLSTM block and no other kernel of the port, hidden states bit-equal.
    `xlstm_static`: generate() with the first XLSTM_STATIC_PROMPT tokens
    of those prompts stepped through serve_step and 16 new tokens, a
    warm-up, then two runs
    (the first counted): no kernel of the port launched, tokens and the
    logits that chose them bit-equal. Then the profiles (the prefill's over
    its first 8 steps), and `xlstm_engine` (dense_pool_engine_phase)."""
    t0 = time.perf_counter()
    params = TM.model_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[full] {cfg.name}: {n_params} parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    Bq, P, GEN = 4, 128, 16
    n_seg = cfg.num_layers // cfg.slstm_every
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (Bq, P), generator=g,
                           device="cuda")
    zero = {k: 0 for k in counts()}

    TM.model_forward(params, tokens, cfg)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, xs = [], []
    for i in range(3):
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        x, aux = TM.model_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        xs.append(x)
        if i == 0:
            fwd_launches = counts()
    need(fwd_launches == {**zero, "slstm_seq": n_seg},
         f"xlstm_forward launches {fwd_launches}, expected K9 x {n_seg}")
    need(xs[0].shape == (Bq, P, cfg.d_model) and
         bool(torch.isfinite(xs[0]).all()) and float(aux) == 0.0,
         "xlstm_forward: hidden states not finite or of another shape")
    fwd_equal = all(torch.equal(x, xs[0]) for x in xs)
    stats = {"forward_ms_runs": runs, "repeat_hidden_equal": fwd_equal,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": fwd_launches}
    print(f"[full xlstm_forward] {cfg.name} bf16 B={Bq} S={P}: "
          f"{json.dumps(stats)}", flush=True)
    need(fwd_equal, "xlstm_forward: three runs gave other hidden states")
    del xs, x

    # warm-up on 8 prompt tokens: every stepwise prefill step does the
    # same work whatever its position
    TS.generate(params, cfg, tokens[:, :8], 2, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    prompts = tokens[:, :XLSTM_STATIC_PROMPT]
    res = TS.generate(params, cfg, prompts, GEN, device="cuda")
    static_launches = counts()
    reps = [res, TS.generate(params, cfg, prompts, GEN, device="cuda")]
    need(static_launches == zero, f"xlstm_static launches {static_launches}"
         ": the stepwise path runs no kernel of the port")
    need(res["tokens"].shape == (Bq, GEN) and
         bool(torch.isfinite(res["logits"]).all()),
         "xlstm_static: tokens of another shape or non-finite logits")
    repeat_equal = all(torch.equal(r["tokens"], res["tokens"]) and
                       torch.equal(r["logits"], res["logits"]) for r in reps)
    stats = {"prefill_ms_runs": [r["prefill_s"] * 1e3 for r in reps],
             "prefill_ms_per_step_runs": [
                 r["prefill_s"] * 1e3 / XLSTM_STATIC_PROMPT for r in reps],
             "decode_ms_per_token_runs": [r["decode_s"] * 1e3 / GEN
                                          for r in reps],
             "tok_per_s_runs": [r["tok_per_s"] for r in reps],
             "repeat_tokens_equal": repeat_equal,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": static_launches}
    print(f"[full xlstm_static] {cfg.name} bf16 B={Bq} "
          f"prompt={XLSTM_STATIC_PROMPT} "
          f"gen={GEN}: {json.dumps(stats)}", flush=True)
    print(f"[full xlstm_static] sample tokens {res['tokens'][0].tolist()}",
          flush=True)
    need(repeat_equal, "xlstm_static: two runs gave other tokens or "
         "logits")
    state = res["state"]
    tok = torch.zeros(Bq, dtype=torch.long, device="cuda")
    del reps, res
    # the prefill's profile covers its first 8 steps: each step is one
    # serve_step of the same work, and a trace of many (~3000 device
    # events a step) takes long to read back
    profile_phase(torch, cfg, {
        "forward": lambda: TM.model_forward(params, tokens, cfg),
        "stepwise_prefill_8_steps":
            lambda: TM.prefill(params, tokens[:, :8], cfg),
        "decode_step": lambda: TM.serve_step(params, state, tok, cfg)})
    del state
    engine_launches = dense_pool_engine_phase(
        torch, TM, cfg, params, ServingEngine, counts, reset_counts, "xlstm",
        XLSTM_ENGINE, b1_rule=False)
    return {"xlstm_forward": fwd_launches, "xlstm_static": static_launches,
            "xlstm_engine": engine_launches}


# The recurrent engine cells: a dense pool (a recurrent family has no
# pages), prompt lengths and arrival ticks, RECURRENT_GEN new tokens each.
RECURRENT_POOL = dict(num_slots=4, max_tokens=256)
RECURRENT_GEN = 16
ZAMBA2_ENGINE = ((48, 16, 64, 32, 56, 24, 40, 64), (0, 0, 1, 2, 4, 5, 7, 8))
XLSTM_ENGINE = ((24, 16, 32, 20, 28, 16), (0, 0, 1, 3, 5, 6))
# xlstm_static's prompt: 32 of the forward's 128 tokens (its stepwise
# prefill costs ~74 ms a step on the card; 128 took ~9.5 s a run)
XLSTM_STATIC_PROMPT = 32
ZAMBA2_WEIGHTS = 1_102_443_840


def recurrent_smoke_phase(torch, TM, TS, get_config, counts, reset_counts):
    """zamba2's SMOKE generate() on the CPU and on the card, the same fp32
    weights: tokens equal, the logits that chose them within
    SMOKE_LOGIT_TOL; then both recurrent families' smoke engines (2 dense
    slots, 4 staggered requests, a retired row reused) card against CPU:
    streams equal. No kernel of the port is launched."""
    import numpy as np
    reset_counts()
    cfg = get_config("zamba2-1.2b", smoke=True)
    params = TM.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    r_cpu = TS.generate(params, cfg, tokens, 8, device="cpu")
    r_gpu = TS.generate(_tree_to(params, "cuda"), cfg, tokens.cuda(), 8,
                        device="cuda")
    err = (r_gpu["logits"].cpu() - r_cpu["logits"]).abs().max().item()
    need(torch.equal(r_gpu["tokens"].cpu(), r_cpu["tokens"]),
         "zamba2 smoke: greedy tokens differ between cpu and cuda")
    need(err <= SMOKE_LOGIT_TOL, f"zamba2 smoke logits differ by {err}")
    rng = np.random.default_rng(3)
    streams = {}
    for arch in ("xlstm-1.3b", "zamba2-1.2b"):
        cfg = get_config(arch, smoke=True)
        params = TM.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
        prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                   for n in (6, 9, 5, 7)]
        got = [TS.serve_continuous(p, cfg, prompts, 5, num_slots=2,
                                   max_tokens=16, arrival_steps=[0, 1, 2, 3],
                                   device=dev)["tokens"]
               for p, dev in ((params, "cpu"),
                              (_tree_to(params, "cuda"), "cuda"))]
        need(all(np.array_equal(got[0][r], got[1][r]) for r in got[0]),
             f"{arch} smoke engine: card streams differ from the CPU's")
        streams[arch] = got[1][1].tolist()
    need(all(n == 0 for n in counts().values()),
         f"recurrent smoke paths launched a kernel: {counts()}")
    print(f"[smoke recurrent] zamba2-smoke generate() tokens equal "
          f"{r_cpu['tokens'][0].tolist()}, logits max_abs_err {err:.3e} "
          f"(tol {SMOKE_LOGIT_TOL:g}); engines card == cpu, request 1's "
          f"streams {json.dumps(streams)}", flush=True)


def dense_pool_engine_phase(torch, TM, cfg, params, ServingEngine, counts,
                            reset_counts, short, cell, b1_rule=True,
                            pool=RECURRENT_POOL, memories=None):
    """`<short>_engine` at full width, bf16: the continuous-batching engine
    on a dense `pool` (the recurrent and cross-attention families), `cell`
    = (prompt lengths, arrival ticks), RECURRENT_GEN new tokens, greedy;
    with `memories` (one [1, M, d] tensor a request) each request brings
    its own cross-attention memory. A warm-up engine first (one request,
    8 tokens), then the counted, timed run, one synchronised step at a
    time; then the same trace on a fresh engine: streams and every leaf of
    the pool's state (memory rows included) at the tick after the last
    arrival and after the drain (the retired rows go on stepping with t
    pinned to 0) must repeat bit for bit. No kernel of the port runs. Each
    stream is then held against static generate()'s path, teacher-forced
    (pool_agreement: a dense state of the pool's max_tokens), at batch 1
    and at the pool's batch; `b1_rule` says whether the batch-1 path must
    meet the STATIC_GAP_ULPS rule or is only recorded."""
    import numpy as np
    lens, arrivals = cell
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in lens]

    def extras(i):
        return None if memories is None else {"memory": memories[i]}
    warm = ServingEngine(params, cfg, device="cuda", **pool)
    warm.submit(prompts[0][:8], 2, extras=extras(0))
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mid_tick = max(arrivals) + 1

    def trace():
        eng = ServingEngine(params, cfg, device="cuda", **pool)
        rids = [eng.submit(p, RECURRENT_GEN, arrival_step=a,
                           extras=extras(i))
                for i, (p, a) in enumerate(zip(prompts, arrivals))]
        return eng, rids

    eng, rids = trace()
    reset_counts()
    ticks = []                 # (ms, decoded, prompt tokens admitted)
    seen = set()
    mid = None
    t_all = time.perf_counter()
    while eng.has_work():
        d0 = eng.decode_ticks
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        now = {o.request_id: o for o in eng.pool.owner if o is not None}
        now.update(eng.finished)
        admitted = sum(q.prompt_len for r, q in now.items() if r not in seen)
        seen |= now.keys()
        ticks.append((ms, eng.decode_ticks - d0, admitted))
        if eng.step_count == mid_tick:
            mid = [t.clone() for t in _tensors(eng.pool.state)]
            filled = [bool(r.any()) for r in eng.pool.state["memory"]] \
                if memories is not None else None
    wall_s = time.perf_counter() - t_all
    need(mid is not None, f"{short}_engine: the trace ended before tick "
         f"{mid_tick}")
    launches = counts()
    need(all(n == 0 for n in launches.values()),
         f"{short}_engine launched a kernel of the port: {launches}")
    fin = eng.finished
    for rid in rids:
        r = fin[rid]
        need(r.status == "DONE" and len(r.tokens) == RECURRENT_GEN and
             all(0 <= x < cfg.vocab_size for x in r.tokens),
             f"{short}_engine request {rid}: status {r.status}, "
             f"{len(r.tokens)} tokens")
    state = _tensors(eng.pool.state)
    need(all(bool(torch.isfinite(t).all()) for t in state + mid
             if t.is_floating_point()),
         f"{short}_engine: non-finite decode state in the run")
    if memories is not None:
        need(all(filled) and bool(eng.pool.state["memory"].eq(0).all()),
             f"{short}_engine: memory rows filled at tick {mid_tick} "
             f"{filled}, or not cleared after the drain")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    again, rids2 = trace()
    mid2 = None
    while again.has_work():
        again.step()
        if again.step_count == mid_tick:
            mid2 = [t.clone() for t in _tensors(again.pool.state)]
    fin2 = again.finished
    repeat_equal = all(fin2[r2].tokens == fin[r].tokens
                       for r, r2 in zip(rids, rids2))
    state_equal = _same(torch, state, _tensors(again.pool.state)) and \
        _same(torch, mid, mid2)
    del again, mid, mid2
    pure = sorted(ms for ms, dd, na in ticks if dd and not na)
    admit = [(ms, na) for ms, dd, na in ticks if na]
    tokens = sum(len(fin[r].tokens) for r in rids)
    stats = {"requests": len(rids), "tokens": tokens, "wall_s": wall_s,
             "tok_per_s": tokens / wall_s, "ticks": len(ticks),
             "decode_ticks": eng.decode_ticks,
             "pure_decode_ticks": len(pure),
             "decode_tick_ms_median": statistics.median(pure),
             "decode_tick_ms_p95": pure[min(len(pure) - 1,
                                            int(0.95 * len(pure)))],
             "admission_ms_per_prompt_token": sum(m for m, _ in admit) /
             max(1, sum(n for _, n in admit)),
             "peak_active": eng.peak_active,
             "max_memory_allocated_gb": peak_gb,
             "state_bytes": sum(t.numel() * t.element_size() for t in state),
             "launches": launches, "repeat_streams_equal": repeat_equal,
             "repeat_state_equal": state_equal, "state_tick": mid_tick,
             "admit_steps": [fin[r].admit_step for r in rids],
             "finish_steps": [fin[r].finish_step for r in rids]}
    print(f"[full {short}_engine] {cfg.name} bf16 {pool}, prompts "
          f"{list(lens)}, arrivals {list(arrivals)}, gen {RECURRENT_GEN}"
          f"{', a memory a request' if memories is not None else ''}: "
          f"{json.dumps(stats)}", flush=True)
    print(f"[full {short}_engine] sample tokens {fin[rids[1]].tokens}",
          flush=True)
    need(repeat_equal, f"{short}_engine: the trace streamed other tokens "
         "when run again")
    need(state_equal, f"{short}_engine: the trace left another decode "
         "state when run again")
    t0 = time.perf_counter()
    agree = [pool_agreement(torch, TM, cfg, params, p, fin[r].tokens,
                            b1_rule, pool, extras(i))
             for i, (p, r) in enumerate(zip(prompts, rids))]
    print(f"[full {short}_engine] against static generate()'s path: at "
          f"batch {pool['num_slots']} "
          f"{sum(a['pool_batch_equal'] for a in agree)} of {len(agree)} "
          f"streams equal; at batch 1 {sum(a['equal'] for a in agree)} "
          f"equal ({time.perf_counter() - t0:.1f} s); {json.dumps(agree)}",
          flush=True)
    return launches


def pool_agreement(torch, TM, cfg, params, prompt, stream, b1_rule,
                   pool=RECURRENT_POOL, extras=None):
    """static generate()'s path for `prompt` (its prefill at batch 1 with
    the request's `extras`, as the engine admits it, then serve_step on a
    dense state of the pool's max_tokens), teacher-forced with an engine
    stream, twice from the one prefill: at batch 1, as static_agreement
    ("equal", "parts", "max_gap", "gaps": static's top logit less its
    logit of the engine's token at each step; a gap over STATIC_GAP_ULPS
    bf16 steps fails only with `b1_rule`), and with the row copied into
    all the pool's rows ("pool_batch_equal": the engine's token is the
    argmax, or ties it, at every step: required). A recurrent state
    carries each step's rounding forward, and a GEMM over 4 rows rounds
    otherwise than over 1, so the batch-1 path may drift from the
    engine's; the pool-batch path is the engine's own arithmetic for that
    row."""
    rows, max_len = pool["num_slots"], pool["max_tokens"]
    tokens = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    one, logits = TM.prefill(params, tokens, cfg, max_len=max_len,
                             extras=extras)
    batch = TM.init_decode_state(cfg, rows, max_len, "cuda", per_slot_t=True)
    for b in range(rows):
        TM.write_decode_slot(batch, b, one)
    lg1 = lgn = logits
    parts, gaps, tol = [], [], 0.0
    for i, tok in enumerate(stream):
        top = int(torch.argmax(lg1[0]))
        gap = float(lg1[0, top] - lg1[0, tok])
        gaps.append(gap)
        if top != tok:
            step_tol = STATIC_GAP_ULPS * _bf16_ulp(float(lg1[0, top]))
            need(gap <= step_tol or not b1_rule, f"{cfg.name}: at step {i} "
                 f"the engine's token {tok} lies {gap} below static's top "
                 f"logit (tol {step_tol}): not a bf16 near-tie")
            parts.append(i)
            tol = max(tol, step_tol)
        top_n = int(torch.argmax(lgn[0]))
        need(lgn[0, top_n] == lgn[0, tok], f"{cfg.name}: at step {i} the "
             f"engine's token {tok} is not the argmax of static's path at "
             f"the pool's batch ({top_n})")
        if i + 1 < len(stream):
            lg1, one = TM.serve_step(params, one,
                                     torch.tensor([tok], device="cuda"), cfg)
            lgn, batch = TM.serve_step(params, batch, torch.full(
                (rows,), tok, device="cuda"), cfg)
    return {"equal": not parts, "parts": parts, "max_gap": max(gaps),
            "tol": tol, "gaps": gaps, "pool_batch_equal": True}


def zamba2_full_phase(torch, counts, reset_counts, cfg, TM, TS,
                      ServingEngine):
    """Full-width zamba2-1.2b, bf16, random weights from a seeded generator
    on the card (ZAMBA2_WEIGHTS of them). `zamba2_forward`: model_forward
    on 4 x 128 tokens, a warm-up, then two runs (the first counted),
    hidden states bit-equal. `zamba2_static`: generate() on 4 x 64 prompt
    tokens stepped through serve_step, 16 new, a warm-up, then three runs
    (the first counted), tokens and logits bit-equal. `zamba2_engine`:
    dense_pool_engine_phase on ZAMBA2_ENGINE. No kernel of the port runs on
    any of them. Then the profiles of the forward and one decode step."""
    t0 = time.perf_counter()
    params = TM.model_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[full] {cfg.name}: {n_params} parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    need(n_params == ZAMBA2_WEIGHTS, f"{cfg.name}: {n_params} parameters, "
         f"not {ZAMBA2_WEIGHTS}")
    Bq, P, PS, GEN = 4, 128, 64, 16
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (Bq, P), generator=g,
                           device="cuda")
    zero = {k: 0 for k in counts()}

    TM.model_forward(params, tokens, cfg)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, xs = [], []
    for i in range(2):
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        x, aux = TM.model_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        xs.append(x)
        if i == 0:
            fwd_launches = counts()
    need(fwd_launches == zero, f"zamba2_forward launches {fwd_launches}")
    need(xs[0].shape == (Bq, P, cfg.d_model) and
         bool(torch.isfinite(xs[0]).all()) and float(aux) == 0.0,
         "zamba2_forward: hidden states not finite or of another shape")
    fwd_equal = torch.equal(xs[0], xs[1])
    stats = {"forward_ms_runs": runs, "repeat_hidden_equal": fwd_equal,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": fwd_launches}
    print(f"[full zamba2_forward] {cfg.name} bf16 B={Bq} S={P}: "
          f"{json.dumps(stats)}", flush=True)
    need(fwd_equal, "zamba2_forward: two runs gave other hidden states")
    del xs, x

    prompts = tokens[:, :PS]
    TS.generate(params, cfg, prompts[:, :8], 2, device="cuda")  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = TS.generate(params, cfg, prompts, GEN, device="cuda")
    static_launches = counts()
    reps = [res] + [TS.generate(params, cfg, prompts, GEN, device="cuda")
                    for _ in range(2)]
    need(static_launches == zero, f"zamba2_static launches "
         f"{static_launches}: the stepwise path runs no kernel of the port")
    need(res["tokens"].shape == (Bq, GEN) and
         bool(torch.isfinite(res["logits"]).all()),
         "zamba2_static: tokens of another shape or non-finite logits")
    repeat_equal = all(torch.equal(r["tokens"], res["tokens"]) and
                       torch.equal(r["logits"], res["logits"]) for r in reps)
    stats = {"weights": n_params,
             "prefill_ms_runs": [r["prefill_s"] * 1e3 for r in reps],
             "prefill_ms_per_step_runs": [r["prefill_s"] * 1e3 / PS
                                          for r in reps],
             "decode_ms_per_token_runs": [r["decode_s"] * 1e3 / GEN
                                          for r in reps],
             "tok_per_s_runs": [r["tok_per_s"] for r in reps],
             "repeat_tokens_equal": repeat_equal,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": static_launches}
    print(f"[full zamba2_static] {cfg.name} bf16 B={Bq} prompt={PS} "
          f"gen={GEN}: {json.dumps(stats)}", flush=True)
    print(f"[full zamba2_static] sample tokens {res['tokens'][0].tolist()}",
          flush=True)
    need(repeat_equal, "zamba2_static: three runs gave other tokens or "
         "logits")
    state = res["state"]
    del reps, res
    engine_launches = dense_pool_engine_phase(
        torch, TM, cfg, params, ServingEngine, counts, reset_counts, "zamba2",
        ZAMBA2_ENGINE)
    tok = torch.zeros(Bq, dtype=torch.long, device="cuda")
    profile_phase(torch, cfg, {
        "forward": lambda: TM.model_forward(params, tokens, cfg),
        "decode_step": lambda: TM.serve_step(params, state, tok, cfg)})
    return {"zamba2_forward": fwd_launches, "zamba2_static": static_launches,
            "zamba2_engine": engine_launches}


# The cross-attention cells: whisper-base uncut, llama-3.2-vision-90b at
# its full width on its first VISION_LAYERS of 100 layers (4 superblocks
# of 4 self-attention layers and a cross layer; the 100 need ~173 GB);
# each engine's dense pool and (prompt lengths, arrival ticks),
# RECURRENT_GEN new tokens a request, a random memory (std 1) each.
# whisper's admission steps the prompt at batch 1, so its prompts are
# shorter
WHISPER_WEIGHTS = 91_582_976
VISION_LAYERS = 20
VISION_WEIGHTS = 18_163_769_344
WHISPER_POOL = dict(num_slots=4, max_tokens=160)
VISION_POOL = dict(num_slots=4, max_tokens=288)
WHISPER_ENGINE = ((96, 32, 128, 64, 48, 112), (0, 0, 1, 3, 5, 6))
VISION_ENGINE = ((192, 64, 256, 128, 96, 224, 160, 80),
                 (0, 0, 1, 2, 4, 5, 7, 8))
CROSS_ARCHS = ("whisper-base", "llama-3.2-vision-90b")


def _memory_rows(cfg):
    return cfg.num_audio_frames or cfg.num_image_tokens


def cross_smoke_phase(torch, TM, TS, ServingEngine, get_config, counts,
                      reset_counts):
    """Both cross-attention families' SMOKE configs, the same fp32 weights
    on the CPU and on the card: generate() over a random memory a row
    (tokens equal, the logits that chose them within SMOKE_LOGIT_TOL),
    then the engine (2 dense slots, 4 staggered requests with their own
    memories, a retired row reused): streams equal. No kernel of the
    port is launched."""
    import numpy as np
    reset_counts()
    out = {}
    for arch in CROSS_ARCHS:
        cfg = get_config(arch, smoke=True)
        params = TM.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
        on_card = _tree_to(params, "cuda")
        g = torch.Generator().manual_seed(1)
        M, d = _memory_rows(cfg), cfg.d_model
        tokens = torch.randint(0, cfg.vocab_size, (4, 12), generator=g)
        mem = torch.randn((4, M, d), generator=g)
        r_cpu = TS.generate(params, cfg, tokens, 8, device="cpu",
                            extras={"memory": mem})
        r_gpu = TS.generate(on_card, cfg, tokens.cuda(), 8, device="cuda",
                            extras={"memory": mem.cuda()})
        err = (r_gpu["logits"].cpu() - r_cpu["logits"]).abs().max().item()
        need(torch.equal(r_gpu["tokens"].cpu(), r_cpu["tokens"]),
             f"{cfg.name}: greedy tokens differ between cpu and cuda")
        need(err <= SMOKE_LOGIT_TOL, f"{cfg.name} logits differ by {err}")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                   for n in (6, 9, 5, 7)]
        mems = [torch.randn((1, M, d), generator=g) for _ in prompts]
        got = []
        for p, dev in ((params, "cpu"), (on_card, "cuda")):
            eng = ServingEngine(p, cfg, num_slots=2, max_tokens=16,
                                device=dev)
            rids = [eng.submit(pr, 5, arrival_step=a,
                               extras={"memory": m.to(dev)})
                    for pr, m, a in zip(prompts, mems, range(4))]
            fin = eng.run()
            got.append([fin[r].tokens for r in rids])
        need(got[0] == got[1], f"{cfg.name} smoke engine: card streams "
             f"differ from the CPU's")
        out[cfg.name] = {"tokens": r_cpu["tokens"][0].tolist(),
                         "logits_max_abs_err": err, "stream_1": got[1][1]}
    need(all(n == 0 for n in counts().values()),
         f"cross-attention smoke paths launched a kernel: {counts()}")
    print(f"[smoke cross] generate() card == cpu (tol {SMOKE_LOGIT_TOL:g}) "
          f"and engines card == cpu: {json.dumps(out)}", flush=True)


def cross_full_phase(torch, counts, reset_counts, cfg, TM, TS,
                     ServingEngine, short, weights, cell, pool):
    """A cross-attention family at full width, bf16, random weights from a
    seeded generator on the card (`weights` of them). `<short>_forward`:
    model_forward on 4 x 128 tokens over random frame or image embeddings
    (std 1; whisper's encoder runs over all its frames), a warm-up and two
    runs (the first counted), hidden states bit-equal. `<short>_static`:
    generate() on 4 x 128 prompt tokens and 16 new over a random memory a
    row, a warm-up and three runs (the first counted), tokens and logits
    bit-equal; a decode step's weight-read bound and the cross layers'
    K/V recompute at the card's peak. `<short>_engine`:
    dense_pool_engine_phase on `cell` and `pool`, a random memory a
    request, its pool-batch path required, its batch-1 path recorded. No
    kernel of the port runs on any of them. Then the profiles of the
    forward and one decode step at batch 4."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = TM.model_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[full] {cfg.name}: {n_params} parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, init "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    need(n_params == weights, f"{cfg.name}: {n_params} parameters, not "
         f"{weights}")
    Bq, P, GEN = 4, 128, 16
    M, d = _memory_rows(cfg), cfg.d_model
    dt = params["embed"].dtype
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (Bq, P), generator=g,
                           device="cuda")
    mem = torch.randn((Bq, M, d), generator=g, device="cuda").to(dt)
    fwd_extras = {("audio_frames" if cfg.encoder_layers else
                   "image_embeds"): mem}
    zero = {k: 0 for k in counts()}

    TM.model_forward(params, tokens, cfg, fwd_extras)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, xs = [], []
    for i in range(2):
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        x, aux = TM.model_forward(params, tokens, cfg, fwd_extras)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        xs.append(x)
        if i == 0:
            fwd_launches = counts()
    need(fwd_launches == zero, f"{short}_forward launches {fwd_launches}")
    need(xs[0].shape == (Bq, P, d) and bool(torch.isfinite(xs[0]).all())
         and float(aux) == 0.0,
         f"{short}_forward: hidden states not finite or of another shape")
    fwd_equal = torch.equal(xs[0], xs[1])
    stats = {"weights": n_params, "forward_ms_runs": runs,
             "memory_rows": M, "repeat_hidden_equal": fwd_equal,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": fwd_launches}
    print(f"[full {short}_forward] {cfg.name} bf16 B={Bq} S={P}: "
          f"{json.dumps(stats)}", flush=True)
    need(fwd_equal, f"{short}_forward: two runs gave other hidden states")
    del xs, x

    extras = {"memory": mem}
    TS.generate(params, cfg, tokens[:, :8], 2, device="cuda",
                extras=extras)                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = TS.generate(params, cfg, tokens, GEN, device="cuda", extras=extras)
    static_launches = counts()
    reps = [res] + [TS.generate(params, cfg, tokens, GEN, device="cuda",
                                extras=extras) for _ in range(2)]
    need(static_launches == zero, f"{short}_static launches "
         f"{static_launches}: the path runs no kernel of the port")
    need(res["tokens"].shape == (Bq, GEN) and
         bool(torch.isfinite(res["logits"]).all()),
         f"{short}_static: tokens of another shape or non-finite logits")
    repeat_equal = all(torch.equal(r["tokens"], res["tokens"]) and
                       torch.equal(r["logits"], res["logits"]) for r in reps)
    # a decode step's least time: every weight read once, and each cross
    # layer's K and V projected from the memory anew (2 products of
    # B*M x d x Hkv*hd) at the bf16 peak
    n_cross = cfg.num_layers if cfg.encoder_layers else \
        cfg.num_layers // cfg.cross_attn_every
    kv_flops = n_cross * 2 * 2 * Bq * M * d * \
        cfg.num_kv_heads * cfg.resolved_head_dim()
    stats = {"weights": n_params,
             "prefill_ms_runs": [r["prefill_s"] * 1e3 for r in reps],
             "decode_ms_per_token_runs": [r["decode_s"] * 1e3 / GEN
                                          for r in reps],
             "tok_per_s_runs": [r["tok_per_s"] for r in reps],
             "weight_read_bound_ms": n_params * dt.itemsize / HBM_BPS * 1e3,
             "cross_kv_flop_ms": kv_flops / BF16_FLOPS * 1e3,
             "repeat_tokens_equal": repeat_equal,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": static_launches}
    print(f"[full {short}_static] {cfg.name} bf16 B={Bq} prompt={P} "
          f"gen={GEN}: {json.dumps(stats)}", flush=True)
    print(f"[full {short}_static] sample tokens {res['tokens'][0].tolist()}",
          flush=True)
    need(repeat_equal, f"{short}_static: three runs gave other tokens or "
         "logits")
    state = res["state"]
    del reps, res
    memories = [torch.randn((1, M, d), generator=g, device="cuda").to(dt)
                for _ in cell[0]]
    engine_launches = dense_pool_engine_phase(
        torch, TM, cfg, params, ServingEngine, counts, reset_counts, short,
        cell, b1_rule=False, pool=pool, memories=memories)
    tok = torch.zeros(Bq, dtype=torch.long, device="cuda")
    profile_phase(torch, cfg, {
        "forward": lambda: TM.model_forward(params, tokens, cfg, fwd_extras),
        "decode_step": lambda: TM.serve_step(params, state, tok, cfg)})
    return {f"{short}_forward": fwd_launches,
            f"{short}_static": static_launches,
            f"{short}_engine": engine_launches}


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _head_layers(cfg, params, n):
    """cfg and params cut to their first n layers: views of the stacked
    layer weights; the width, embedding and final norm untouched."""
    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}
    return (cfg.with_overrides(num_layers=n),
            {**params, "layers": cut(params["layers"])})


def _engine_streams(cfg, params, ServingEngine, kv_quant):
    """The engine trace's streams (engine_phase's prompts, arrivals and
    ENGINE_GEN new tokens, greedy) on a fresh pool, bf16 or int8 pages."""
    import numpy as np
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in ENGINE_LENS]
    eng = ServingEngine(params, cfg, device="cuda",
                        **dict(ENGINE_POOL, kv_quant=kv_quant))
    rids = [eng.submit(p, ENGINE_GEN, arrival_step=a)
            for p, a in zip(prompts, ENGINE_ARRIVALS)]
    fin = eng.run()
    return [fin[r].tokens for r in rids]


def full_phase(torch, G, PA, SC, GT, cfg, params, TM, TS):
    """Full width, bf16, static generate(): 4 requests x 128 prompt tokens,
    16 new tokens. One warm-up generate(), then the counted, timed run and
    two repeats of it for the spread; the repeats must give its tokens."""
    Bq, P, GEN = 4, 128, 16
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (Bq, P), generator=g,
                            device="cuda")
    TS.generate(params, cfg, prompts, 2, device="cuda")          # warm-up
    torch.cuda.reset_peak_memory_stats()
    G.reset_launches()
    PA.reset_launches()
    SC.reset_launches()
    GT.reset_launches()
    res = TS.generate(params, cfg, prompts, GEN, device="cuda")
    launches = {**G.LAUNCHES, **PA.LAUNCHES, **SC.LAUNCHES, **GT.LAUNCHES}
    # two more identical runs: the spread of the host-bound times, and the
    # combine's determinism (the same tokens, bit for bit)
    reps = [res] + [TS.generate(params, cfg, prompts, GEN, device="cuda")
                    for _ in range(2)]
    expect = {**gmm_launches(cfg, 1, GEN), **go_topk_launches(cfg, GEN)}
    need(bool(torch.isfinite(res["logits"]).all()), "non-finite logits")
    need(res["tokens"].shape == (Bq, GEN), "token shape")
    need(launches == {**expect, **paged_launches(cfg, 0, 0),
                      "slstm_seq": 0},
         f"launch counts {launches}, expected {expect} ({cfg.num_layers} "
         f"layers x (1 prefill + {GEN} decode steps); K5R x {GEN} decode "
         "steps with a GO cache) and no paged attention on the dense static "
         "path")
    repeat_equal = all(torch.equal(r["tokens"], res["tokens"]) and
                       torch.equal(r["logits"], res["logits"]) for r in reps)
    stats = {"prefill_ms": res["prefill_s"] * 1e3,
             "decode_ms_per_token": res["decode_s"] * 1e3 / GEN,
             "tok_per_s": res["tok_per_s"],
             "prefill_ms_runs": [r["prefill_s"] * 1e3 for r in reps],
             "decode_ms_per_token_runs": [r["decode_s"] * 1e3 / GEN
                                          for r in reps],
             "repeat_tokens_equal": repeat_equal,
             "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(f"[full static] {cfg.name} bf16 B={Bq} prompt={P} gen={GEN}: "
          f"{json.dumps(stats)}", flush=True)
    print(f"[full static] sample tokens {res['tokens'][0].tolist()}",
          flush=True)
    need(repeat_equal, f"{cfg.name}: three identical static runs gave "
         "different tokens or logits")
    tok = torch.zeros(Bq, dtype=torch.long, device="cuda")
    state = res["state"]
    profile_phase(torch, cfg, {
        "prefill": lambda: TM.prefill(params, prompts, cfg,
                                      max_len=prompts.shape[1] + 17),
        "decode_step": lambda: TM.serve_step(params, state, tok, cfg)})
    return launches


# bf16 rounding of the shared experts' output (plain products, bf16
# operands and outputs) against the same products in fp32, relative to
# the largest fp32 output; ~5e-3 on random bf16 weights of deepseek's
# width
SHARED_TOL = 2e-2


def shared_phase(torch, MOE, TM, cfg, params):
    """deepseek's always-on shared experts at full width, on the card:
    layer 0's shared bank on 4 random bf16 rows (a decode tick's) against
    the same weights and rows in fp32, within SHARED_TOL of the largest
    output; and the token-choice decode's MoE output, routed part plus
    shared part, is finite and repeats bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(9)
    moe = TM.layer_params(params["layers"], 0)["moe"]
    x = torch.randn(4, cfg.d_model, device="cuda", generator=g).to(
        torch.bfloat16)
    got = MOE._shared_out(moe, x)
    ref = MOE._shared_out({"shared": {k: v.float() for k, v in
                                      moe["shared"].items()}}, x.float())
    err = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    need(err <= SHARED_TOL, f"{cfg.name}: the bf16 shared output is "
         f"{err:.3e} from fp32, relative (tol {SHARED_TOL:g})")
    y = MOE.token_choice_decode(moe, x, cfg.moe)
    need(bool(torch.isfinite(y).all()) and
         torch.equal(y, MOE.token_choice_decode(moe, x, cfg.moe)),
         f"{cfg.name}: the decode's MoE output is not finite or repeats "
         "other bits")
    print(f"[shared] {cfg.name}: {cfg.moe.num_shared_experts} shared "
          f"experts, bf16 vs fp32 relative err {err:.3e} (tol "
          f"{SHARED_TOL:g}); decode MoE output finite, repeats bit for bit",
          flush=True)
    return err


# The static batch past K5R's bound: rows, prompt tokens, new tokens.
GO_WIDE = (72, 32, 8)


def go_wide_phase(torch, G, PA, SC, GT, cfg, params, TS, counts,
                  reset_counts):
    """`go_wide`: static generate() of the full-width model in bf16 at
    batch 72 (past K5R's 64 rows), 32 prompt tokens, 8 new tokens: the GO
    decode runs K5 in place once per layer and decode step and K5R never,
    K1/K2 over plans of two 64-row tiles a lane; a second run must give
    the same tokens. Then K5 alone at the decode's shape (72, E, k)."""
    B, P, GEN = GO_WIDE
    g = torch.Generator(device="cuda").manual_seed(72)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                            device="cuda")
    TS.generate(params, cfg, prompts, 2, device="cuda")          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = TS.generate(params, cfg, prompts, GEN, device="cuda")
    launches = counts()
    again = TS.generate(params, cfg, prompts, GEN, device="cuda")
    L = cfg.num_layers
    expect = {**gmm_launches(cfg, 1, GEN), "go_topk_update": L * GEN,
              "go_router": 0, **paged_launches(cfg, 0, 0), "slstm_seq": 0}
    need(launches == expect, f"go_wide launches {launches}, expected "
         f"{expect}")
    need(res["tokens"].shape == (B, GEN) and
         bool(torch.isfinite(res["logits"]).all()),
         "go_wide: token shape or non-finite logits")
    repeat_equal = torch.equal(again["tokens"], res["tokens"])
    e = cfg.moe
    sp, tp, sn, tid = _go_topk_inputs(torch, g, B, e.num_experts, e.top_k)
    err = max(_diff(a, b) for a, b in zip(
        GT.go_topk_update(sp, tp, sn, tid),
        GT.go_topk_update_plain(sp, tp, sn, tid)))
    need(err == 0.0, f"K5 at ({B}, {e.num_experts}, {e.top_k}) differs from "
         f"its plain version by {err}")
    k5 = k5_timing(torch, GT, sp, tp, sn, tid, err)
    stats = {"batch": B, "prompt": P, "gen": GEN,
             "prefill_ms": res["prefill_s"] * 1e3,
             "decode_ms_per_token": res["decode_s"] * 1e3 / GEN,
             "decode_ms_per_token_runs": [r["decode_s"] * 1e3 / GEN
                                          for r in (res, again)],
             "tok_per_s": res["tok_per_s"],
             "repeat_tokens_equal": repeat_equal,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches, "k5": k5}
    print(f"[go_wide] {cfg.name} bf16: {json.dumps(stats)}", flush=True)
    need(repeat_equal, "go_wide: a second run gave other tokens")
    # one more decode step on the run's state (position P + GEN < max_len)
    state, tok = res["state"], res["tokens"][:, -1].long()
    profile_phase(torch, cfg, {
        "go_wide_decode_step": lambda: TS.serve_step(params, state, tok,
                                                     cfg)})
    return launches, k5


# The full-width engine trace: prompt lengths, arrival ticks, new tokens.
ENGINE_LENS = [64, 448, 128, 320, 96, 384, 192, 256]
ENGINE_ARRIVALS = [0, 0, 0, 0, 8, 8, 16, 16]
ENGINE_GEN = 32
ENGINE_POOL = dict(num_slots=4, max_tokens=512, paged=True, page_size=16,
                   num_pages=97, prefill_chunk=128)


def engine_phase(torch, G, PA, SC, GT, cfg, params, ServingEngine,
                 kv_quant="none", repeat=True, gen=ENGINE_GEN):
    """Full width, bf16, through the continuous-batching engine on a paged
    pool: 8 staggered requests of ENGINE_LENS prompt tokens, `gen` new
    tokens each, greedy. A warm-up engine first (one one-shot and one
    chunked admission, 4 tokens each), then the counted, timed run, one
    synchronised step at a time, then the same trace once more on a fresh
    engine, which must stream the same tokens and leave the same pool
    state (`repeat=False` leaves the repeat out, to hold the script's
    time). kv_quant="int8" runs the pool on int8 KV pages and GO rows
    (K3/K4 on the int8 operand) and records the pool's page bytes and the
    admissions' dequant_max_abs_err; its repeat covers the scales too."""
    import numpy as np
    pool = dict(ENGINE_POOL, kv_quant=kv_quant)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in ENGINE_LENS]
    warm = ServingEngine(params, cfg, device="cuda", **pool)
    for p in prompts[:2]:
        warm.submit(p, 4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    eng = ServingEngine(params, cfg, device="cuda", **pool)
    rids = [eng.submit(p, gen, arrival_step=a)
            for p, a in zip(prompts, ENGINE_ARRIVALS)]
    G.reset_launches()
    PA.reset_launches()
    SC.reset_launches()
    GT.reset_launches()
    ticks = []                 # (ms, decoded, chunked, admitted one-shot)
    decode_ticks = chunk_ticks = peak_pages = 0
    t_all = time.perf_counter()
    while eng.has_work():
        d0, c0 = eng.decode_ticks, eng.chunk_ticks
        a0 = eng.pool.admitted_total
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        dd, dc = eng.decode_ticks - d0, eng.chunk_ticks - c0
        decode_ticks += dd
        chunk_ticks += dc
        ticks.append((ms, dd, dc, eng.pool.admitted_total - a0))
        peak_pages = max(peak_pages, eng.pool.alloc.pages_in_use)
    wall_s = time.perf_counter() - t_all
    launches = {**G.LAUNCHES, **PA.LAUNCHES, **SC.LAUNCHES, **GT.LAUNCHES}
    launches_windowed = dict(PA.LAUNCHES_WINDOWED)

    L = cfg.num_layers
    fin = eng.finished
    for rid in rids:
        r = fin[rid]
        need(r.status == "DONE" and len(r.tokens) == gen and
             all(0 <= x < cfg.vocab_size for x in r.tokens),
             f"request {rid}: status {r.status}, {len(r.tokens)} tokens")
    st = eng.pool.state
    need(all(bool(torch.isfinite(st[k]).all()) for k in (
        "k_pages", "v_pages", "k_scales", "v_scales", "go_scales") if k in st)
         and ("go" not in st or bool(torch.isfinite(st["go"].outputs).all())),
         "non-finite KV pages, scales or GO rows after the run")
    eng.pool.alloc.check()
    need(eng.pool.alloc.pages_in_use == 0, "pages leaked after the drain")
    one_shot = sum(n <= ENGINE_POOL["prefill_chunk"] for n in ENGINE_LENS)
    expect = {**gmm_launches(cfg, chunk_ticks + one_shot, decode_ticks),
              **go_topk_launches(cfg, decode_ticks),
              **paged_launches(cfg, decode_ticks, chunk_ticks, kv_quant),
              "slstm_seq": 0}
    need(launches == expect, f"engine launches {launches}, expected "
         f"{expect} ({decode_ticks} decode ticks, {chunk_ticks} chunk ticks, "
         f"{one_shot} one-shot prefills)")
    repeat_equal = repeat_state_equal = None
    if repeat:
        again = ServingEngine(params, cfg, device="cuda", **pool)
        rids2 = [again.submit(p, gen, arrival_step=a)
                 for p, a in zip(prompts, ENGINE_ARRIVALS)]
        fin2 = again.run()
        # the streams' argmaxes can hide a changed sum; the drained pools'
        # pages (every layer's K/V of every token, which the MoE outputs of
        # the layers below feed), their scales and the GO rows must repeat
        # bit for bit as well (page 0, the null page, left out: _pool_state)
        repeat_state_equal = _same(torch, _pool_state(st),
                                   _pool_state(again.pool.state))
        repeat_equal = all(fin2[r2].tokens == fin[r].tokens
                           for r, r2 in zip(rids, rids2))
        del again
    pure_decode = sorted(ms for ms, dd, dc, da in ticks
                         if dd and not dc and not da)
    chunk_ms = sorted(ms for ms, dd, dc, da in ticks if dc)
    tokens = sum(len(fin[r].tokens) for r in rids)
    stats = {"requests": len(rids), "tokens": tokens, "wall_s": wall_s,
             "tok_per_s": tokens / wall_s, "ticks": len(ticks),
             "decode_ticks": decode_ticks, "chunk_ticks": chunk_ticks,
             "pure_decode_ticks": len(pure_decode),
             "decode_tick_ms_median": statistics.median(pure_decode),
             "decode_tick_ms_p95": pure_decode[
                 min(len(pure_decode) - 1, int(0.95 * len(pure_decode)))],
             "chunk_tick_ms_median": statistics.median(chunk_ms),
             "chunk_tick_ms_mean": statistics.mean(chunk_ms),
             "peak_active": eng.peak_active, "peak_pages_in_use": peak_pages,
             "page_waits": eng.page_waits,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches,
             "launches_windowed": launches_windowed,
             "kv_quant": kv_quant,
             "pool_page_bytes": eng.pool.num_pages * L * PA.page_bytes(
                 eng.cfg, ENGINE_POOL["page_size"]),
             "kv_bytes_per_token": eng.stats()["kv_bytes_per_token"],
             "dequant_max_abs_err": eng.stats()["dequant_max_abs_err"],
             "repeat_streams_equal": repeat_equal,
             "repeat_pool_state_equal": repeat_state_equal,
             "admit_steps": [fin[r].admit_step for r in rids],
             "finish_steps": [fin[r].finish_step for r in rids]}
    print(f"[full engine] {cfg.name} bf16 {pool}, prompts "
          f"{ENGINE_LENS}, arrivals {ENGINE_ARRIVALS}, gen {gen}: "
          f"{json.dumps(stats)}", flush=True)
    print(f"[full engine] sample tokens {fin[rids[1]].tokens}", flush=True)
    need(repeat_equal is not False, f"{cfg.name}: the engine trace streamed "
         "other tokens when run again")
    need(repeat_state_equal is not False, f"{cfg.name}: the engine trace "
         "left other KV pages, scales or GO rows when run again")
    engine_profile_phase(torch, cfg, params, prompts, ServingEngine, pool)
    stats["streams"] = [fin[r].tokens for r in rids]   # fault_domain's oracle
    stats["prompts"] = prompts
    return launches, stats


def engine_profile_phase(torch, cfg, params, prompts, ServingEngine, pool,
                         sampled=False):
    """One chunk tick (3 slots decoding beside a chunk of 128) and one
    decode tick with 4 active slots, on a fresh engine of the same pool:
    three one-shot 64/128/96-token prompts and the 384-token one. With
    `sampled`, the second and fourth sample (temperature 0.8, top_p 0.9),
    so the ticks run the sampling path."""
    eng = ServingEngine(params, cfg, device="cuda", **pool)
    for n, i in enumerate((0, 2, 4, 5)):
        eng.submit(prompts[i], 16, temperature=0.8 * (n % 2) * sampled,
                   top_p=0.9, seed=n)
    eng.step()                       # 3 one-shot admissions, chunk 1 of 3
    tag = ("" if pool["kv_quant"] == "none" else f"_{pool['kv_quant']}") \
        + ("_sampled" if sampled else "")
    profile_phase(torch, cfg, {f"engine{tag}_chunk_tick": eng.step})
    eng.step()                       # chunk 3 of 3, the 4th slot installs
    need(eng.pool.num_active() == 4, "profile engine: 4 slots not active")
    profile_phase(torch, cfg,
                  {f"engine{tag}_decode_tick_4_active": eng.step})
    # not drained: nothing reads the rest of its streams (the drain's ~14
    # decode ticks cost up to ~2.5 s a call on a slow host)


def sampled_engine_phase(torch, G, PA, SC, GT, cfg, params,
                         ServingEngine):
    """`llama_engine_sampled`: the full-width engine trace (ENGINE_LENS,
    ENGINE_ARRIVALS, ENGINE_POOL) with prompt buckets, requests
    alternating greedy and sampled (temperature 0.8, top_p 0.9, seed = the
    request id), plus a ninth request, request 0's prompt at temperature
    0.8 and top_p 1e-9 arriving at tick 16, whose stream must be request
    0's greedy one. Timed one synchronised step at a time; a fresh second
    engine must give the same streams. The launches follow the greedy
    engine's formula (sampling runs no kernel of the port); prefill
    lengths, tok/s and the pure decode ticks' median and p95 are recorded,
    and a profile of a chunk tick and a decode tick with two of four rows
    sampling gives the events a layer of a sampled tick."""
    import numpy as np
    pool = dict(ENGINE_POOL, kv_quant="none", prompt_buckets=True)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in ENGINE_LENS]
    prompts.append(prompts[0])
    arrivals = ENGINE_ARRIVALS + [16]
    near_zero = {len(prompts) - 1: 1e-9}

    def trace():
        eng = ServingEngine(params, cfg, device="cuda", **pool)
        rids = _submit_mixed(eng, prompts, ENGINE_GEN, arrivals, near_zero)
        return eng, rids

    warm, _ = trace()
    warm.run()
    del warm
    torch.cuda.synchronize()
    eng, rids = trace()
    for mod in (G, PA, SC, GT):
        mod.reset_launches()
    ticks = []                      # (ms, decoded, chunked, admitted)
    t_all = time.perf_counter()
    while eng.has_work():
        d0, c0, a0 = eng.decode_ticks, eng.chunk_ticks, \
            eng.pool.admitted_total
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ticks.append(((time.perf_counter() - t0) * 1e3,
                      eng.decode_ticks - d0, eng.chunk_ticks - c0,
                      eng.pool.admitted_total - a0))
    wall_s = time.perf_counter() - t_all
    launches = {**G.LAUNCHES, **PA.LAUNCHES, **SC.LAUNCHES, **GT.LAUNCHES}
    s = eng.stats()
    fin = eng.finished
    for rid in rids:
        r = fin[rid]
        need(r.status == "DONE" and len(r.tokens) == ENGINE_GEN and
             all(0 <= x < cfg.vocab_size for x in r.tokens),
             f"sampled request {rid}: status {r.status}, {len(r.tokens)} "
             "tokens")
    one_shot = sum(len(q) <= ENGINE_POOL["prefill_chunk"] for q in prompts)
    expect = {**gmm_launches(cfg, s["chunk_ticks"] + one_shot,
                             s["decode_ticks"]),
              **go_topk_launches(cfg, s["decode_ticks"]),
              **paged_launches(cfg, s["decode_ticks"], s["chunk_ticks"]),
              "slstm_seq": 0}
    need(launches == expect, f"llama_engine_sampled launches {launches}, "
         f"expected {expect}")
    again, rids2 = trace()
    fin2 = again.run()
    streams = [fin[r].tokens for r in rids]
    repeat_equal = streams == [fin2[r].tokens for r in rids2]
    near_zero_greedy = streams[-1] == streams[0]
    sampled_differ = any(streams[i] != streams[i - 1]
                         for i in range(1, len(ENGINE_LENS), 2))
    pure = sorted(ms for ms, dd, dc, da in ticks if dd and not dc and not da)
    tokens = sum(len(t) for t in streams)
    stats = {"requests": len(rids), "tokens": tokens, "wall_s": wall_s,
             "tok_per_s": tokens / wall_s,
             "decode_ticks": s["decode_ticks"],
             "chunk_ticks": s["chunk_ticks"],
             "pure_decode_ticks": len(pure),
             "decode_tick_ms_median": statistics.median(pure),
             "decode_tick_ms_p95": pure[min(len(pure) - 1,
                                            int(0.95 * len(pure)))],
             "prefill_lengths": s["prefill_lengths"],
             "peak_active": eng.peak_active, "launches": launches,
             "repeat_streams_equal": repeat_equal,
             "top_p_1e-9_equals_greedy": near_zero_greedy,
             "sampled_streams_differ_from_greedy": sampled_differ}
    print(f"[full engine sampled] {cfg.name} bf16 {pool}, prompts "
          f"{[len(q) for q in prompts]}, arrivals {arrivals}, gen "
          f"{ENGINE_GEN}: {json.dumps(stats)}", flush=True)
    need(repeat_equal, "llama_engine_sampled: a fresh engine streamed "
         "other tokens")
    need(near_zero_greedy, "llama_engine_sampled: the top_p=1e-9 request "
         "did not stream its greedy tokens")
    need(s["prefill_lengths"] == [64, 128], f"prefill lengths "
         f"{s['prefill_lengths']}")
    engine_profile_phase(torch, cfg, params, prompts, ServingEngine, pool,
                         sampled=True)
    return launches, stats


# The fault domain's page-pressure trace at full width: (prompt tokens, new
# tokens, priority, arrival tick). Two long low-priority streams (chunked)
# reserve 56 of FAULT_PAGES - 1 usable pages; the high-priority request
# arriving at tick 8 needs 10 more, so one of them is evicted for it.
FAULT_TRACE = [(384, 64, 5, 0), (384, 64, 5, 0), (128, 32, 0, 8)]
FAULT_PAGES = 61
# the chaos of the CPU churn test, on the full-width engine trace
FAULT_CHAOS = dict(seed=3, tick_fail=0.3, pressure=0.2, preempt=0.4)
# the quarantine run: 4 one-shot prompts decoding (lengths, new tokens),
# then one more admitted onto the scrubbed pages (length, new tokens)
FAULT_QUARANTINE = ((64, 128, 96, 112), 24, (96, 16))


def _timed_pool(torch, pool, log):
    """Time each snapshot and restore of `pool` (synchronised, host clock)
    and record each snapshot's pages and bytes into `log`."""
    snapshot, restore = pool.snapshot, pool.restore

    def snap(slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = snapshot(slot)
        torch.cuda.synchronize()
        log["snapshot_ms"].append((time.perf_counter() - t0) * 1e3)
        log["snapshot_pages"].append(out["n_pages"])
        log["snapshot_bytes"].append(sum(
            t.numel() * t.element_size() for t in _tensors(out)))
        return out

    def rest(slot, req, snap_):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(slot, req, snap_)
        torch.cuda.synchronize()
        log["restore_ms"].append((time.perf_counter() - t0) * 1e3)

    pool.snapshot, pool.restore = snap, rest


def _drained(eng):
    """The engine's pool is empty and its audit (the pool's too) green."""
    eng._audit()
    return eng.pool.alloc.pages_in_use == 0 and not eng.pool.any_active()


def fault_domain_phase(torch, cfg, params, ServingEngine, Chaos, counts,
                       reset_counts, kv_quant, clean):
    """`fault_domain`: the engine's fault domain at full width, bf16 or on
    int8 pages, every run with the audit on every tick.
    1. Preemption under page pressure (FAULT_TRACE on FAULT_PAGES pages):
       at least one eviction, as many resumes, every stream equal to the
       trace on a pool large enough never to evict (same call), the pool
       drained; the launches those of the formulas with one one-shot
       prefill (a resume prefills nothing); each snapshot's pages, bytes
       and ms, and each restore's ms.
    2. Seeded chaos (FAULT_CHAOS) on the engine trace: streams equal to
       `clean`, the chaos-free run of engine_phase in this call.
    3. NaN quarantine: after 4 tokens one of 4 decoding slots is poisoned;
       it must retire FAILED with a prefix of its clean stream, the others
       equal theirs; a request admitted right after must map a scrubbed
       page and stream as on a fresh pool.
    4. (bf16) A request with max_wall_s=0 retires TIMEOUT with a prefix of
       its clean stream, and one cancelled mid-chunk-prefill (one K4 chunk
       a layer) hands its pages back.
    Returns the launches of run 1."""
    import numpy as np
    t_phase = time.perf_counter()
    L = cfg.num_layers
    pool = dict(ENGINE_POOL, kv_quant=kv_quant)
    rng = np.random.default_rng(27)
    out = {"kv_quant": kv_quant}

    # 1. preemption under page pressure
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n, *_ in FAULT_TRACE]

    def pressure(num_pages, preemption, log=None):
        eng = ServingEngine(params, cfg, device="cuda",
                            **dict(pool, num_pages=num_pages),
                            preemption=preemption)
        eng.audit_every_tick = True
        if log is not None:
            _timed_pool(torch, eng.pool, log)
        rids = [eng.submit(p, g, priority=pr, arrival_step=a)
                for p, (_, g, pr, a) in zip(prompts, FAULT_TRACE)]
        fin = eng.run()
        return eng, [fin[r] for r in rids]

    _, roomy = pressure(None, False)
    log = {k: [] for k in ("snapshot_ms", "snapshot_pages", "snapshot_bytes",
                           "restore_ms")}
    reset_counts()
    eng, fin = pressure(FAULT_PAGES, True, log)
    launches = counts()
    s = eng.stats()
    one_shot = sum(n <= ENGINE_POOL["prefill_chunk"] for n, *_ in FAULT_TRACE)
    expect = {**gmm_launches(cfg, s["chunk_ticks"] + one_shot,
                             s["decode_ticks"]),
              **go_topk_launches(cfg, s["decode_ticks"]),
              **paged_launches(cfg, s["decode_ticks"], s["chunk_ticks"],
                               kv_quant), "slstm_seq": 0}
    need(launches == expect, f"fault_domain {kv_quant} launches {launches}, "
         f"expected {expect}")
    need(s["preemptions"] >= 1 and s["resumes"] == s["preemptions"],
         f"fault_domain {kv_quant}: preemptions {s['preemptions']}, resumes "
         f"{s['resumes']}")
    need(all(r.status == "DONE" for r in fin) and
         [r.tokens for r in fin] == [r.tokens for r in roomy],
         f"fault_domain {kv_quant}: a preempted trace streamed other tokens "
         "than the same trace that never evicts")
    need(_drained(eng), "fault_domain: pages left after the pressure run")
    out["pressure"] = {
        "preemptions": s["preemptions"], "resumes": s["resumes"],
        "page_waits": s["page_waits"], "decode_ticks": s["decode_ticks"],
        "chunk_ticks": s["chunk_ticks"],
        "finish_steps": [r.finish_step for r in fin],
        "roomy_finish_steps": [r.finish_step for r in roomy], **log}

    # 2. seeded chaos on the engine trace
    rng2 = np.random.default_rng(2)
    eprompts = [rng2.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                for n in ENGINE_LENS]
    eng = ServingEngine(params, cfg, device="cuda", chaos=Chaos(**FAULT_CHAOS),
                        **pool)
    eng.audit_every_tick = True
    log2 = {k: [] for k in log}
    _timed_pool(torch, eng.pool, log2)
    rids = [eng.submit(p, ENGINE_GEN, arrival_step=a)
            for p, a in zip(eprompts, ENGINE_ARRIVALS)]
    t0 = time.perf_counter()
    fin = eng.run()
    wall = time.perf_counter() - t0
    s = eng.stats()
    need([fin[r].tokens for r in rids] == clean,
         f"fault_domain {kv_quant}: the chaos run streamed other tokens than "
         "the chaos-free run")
    need(s["statuses"] == {"DONE": len(rids)} and _drained(eng) and
         s["resumes"] == s["preemptions"],
         f"fault_domain {kv_quant} chaos: stats {s}")
    out["chaos"] = {"injected": s["chaos"], "tick_retries": s["tick_retries"],
                    "preemptions": s["preemptions"], "resumes": s["resumes"],
                    "steps": s["steps"], "wall_s": wall,
                    "snapshot_ms_median": statistics.median(
                        log2["snapshot_ms"]) if log2["snapshot_ms"] else None,
                    "restore_ms_median": statistics.median(
                        log2["restore_ms"]) if log2["restore_ms"] else None}

    # 3. NaN quarantine and the reuse of its scrubbed pages
    qlens, qgen, (nlen, ngen) = FAULT_QUARANTINE
    qprompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                for n in qlens]
    newp = rng.integers(0, cfg.vocab_size, size=nlen, dtype=np.int32)

    def quarantine_run(poison):
        eng = ServingEngine(params, cfg, device="cuda", **pool)
        eng.audit_every_tick = True
        rids = [eng.submit(p, qgen) for p in qprompts]
        if not poison:
            fin = eng.run()
            return [fin[r].tokens for r in rids], None
        while len(eng.pool.owner[0].tokens if eng.pool.owner[0] else []) < 4:
            eng.step()
        victim = eng.pool.owner[0].request_id
        scrubbed = set(eng.pool.alloc.owned(victim))
        eng.pool.poison_slot(0)
        done = eng.step()
        need([r.request_id for r in done] == [victim] and
             done[0].status == "FAILED", f"quarantine: finished {done}")
        rnew = eng.submit(newp, ngen)
        eng.step()
        slot = next(s_ for s_, o in enumerate(eng.pool.owner)
                    if o is not None and o.request_id == rnew)
        reused = scrubbed & set(eng.pool.block_table[slot].tolist())
        fin = eng.run()
        need(_drained(eng), "quarantine run: pages left")
        return [fin[r].tokens for r in rids + [rnew]], (
            victim, fin[victim], sorted(reused))

    clean_q, _ = quarantine_run(False)
    got, (victim, vreq, reused) = quarantine_run(True)
    fresh = ServingEngine(params, cfg, device="cuda", **pool)
    rf = fresh.submit(newp, ngen)
    fresh_stream = fresh.run()[rf].tokens
    need(vreq.fail_reason == "non-finite logits" and
         4 <= len(vreq.tokens) < qgen and
         vreq.tokens == clean_q[victim][:len(vreq.tokens)],
         f"quarantine: the poisoned stream {vreq.tokens} is no prefix of "
         f"{clean_q[victim]}")
    need(all(got[i] == clean_q[i] for i in range(4) if i != victim),
         "quarantine: a cohabitant of the poisoned slot streamed other tokens")
    need(reused, "quarantine: the new request mapped no scrubbed page")
    need(got[4] == fresh_stream, "quarantine: the request on scrubbed pages "
         "streamed other tokens than on a fresh pool")
    out["quarantine"] = {"failed_tokens": len(vreq.tokens),
                         "reused_scrubbed_pages": reused}

    # 4. deadlines and cancel (bf16 only)
    if kv_quant == "none":
        eng = ServingEngine(params, cfg, device="cuda", **pool)
        eng.audit_every_tick = True
        r0 = eng.submit(eprompts[0], ENGINE_GEN, max_wall_s=0.0)
        fin = eng.run()
        need(fin[r0].status == "TIMEOUT" and
             0 < len(fin[r0].tokens) < ENGINE_GEN and
             fin[r0].tokens == clean[0][:len(fin[r0].tokens)],
             f"max_wall_s=0: {fin[r0].status}, {fin[r0].tokens}")
        r1 = eng.submit(eprompts[1], ENGINE_GEN)
        reset_counts()
        eng.step()
        chunk_launches = counts()
        need(eng._chunk_job is not None and eng.pool.alloc.pages_in_use > 0,
             "cancel: no chunk prefill in flight")
        need(eng.cancel(r1) and eng.finished[r1].status == "CANCELLED" and
             eng.pool.alloc.pages_in_use == 0 and _drained(eng),
             "cancel mid-chunk-prefill: pages not handed back")
        need(chunk_launches["paged_attn_chunk"] == L,
             f"cancelled chunk launches {chunk_launches}")
        out["deadline_cancel"] = {
            "timeout_tokens": len(fin[r0].tokens),
            "timeout_reason": fin[r0].fail_reason,
            "cancelled_chunk_k4_launches": chunk_launches["paged_attn_chunk"]}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[fault_domain] {cfg.name} {json.dumps(out)}", flush=True)
    return launches


def fault_smoke_phase(torch, cfg, TM, ServingEngine, Chaos, counts,
                      reset_counts):
    """The chaos churn of tests/test_torch_chaos.py (smoke llama, fp32, the
    same weights and seeds) on the CPU (plain versions) and on the card
    (kernels): the same streams, statuses, injected counts, preemptions,
    tick retries and finish steps."""
    import numpy as np
    params = TM.model_init(cfg, torch.Generator().manual_seed(5), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=12, dtype=np.int32)
               for _ in range(6)]
    res = {}
    for side, dev, p in (("cpu", "cpu", params),
                         ("card", "cuda", _tree_to(params, "cuda"))):
        reset_counts()
        eng = ServingEngine(p, cfg, device=dev, chaos=Chaos(**FAULT_CHAOS),
                            num_slots=3, max_tokens=48, paged=True,
                            page_size=8)
        eng.audit_every_tick = True
        rids = [eng.submit(q, 16) for q in prompts]
        fin = eng.run()
        s = eng.stats()
        res[side] = {"streams": [fin[r].tokens for r in rids],
                     "finish_steps": [fin[r].finish_step for r in rids],
                     **{k: s[k] for k in ("statuses", "chaos", "preemptions",
                                          "resumes", "tick_retries")}}
    launches = counts()
    need(set(res["card"]["statuses"]) == {"DONE"},
         f"smoke chaos churn statuses {res['card']['statuses']}")
    need(res["card"] == res["cpu"], f"smoke chaos churn: card {res['card']} "
         f"!= cpu {res['cpu']}")
    need(launches["go_router"] > 0 and launches["paged_attn_decode"] > 0,
         f"smoke chaos churn launches {launches}")
    print(f"[fault_domain smoke] {cfg.name}: cpu and cuda equal under chaos "
          f"{FAULT_CHAOS}: {json.dumps(res['card'])}, cuda launches "
          f"{launches}", flush=True)


# The prefix-share trace at full width: (prompt, temperature, seed, arrival
# tick); every request asks PREFIX_GEN new tokens, top_p 0.9 where it
# samples. P (120 tokens: 7 full pages and an 8-token tail) is sent six
# times: a greedy donor, four sampled consumers (n parallel samples) and a
# greedy repeat after the donor retired; Q (128 tokens: 8 full pages, no
# tail) twice; D64 and D96 once each (cold admissions).
PREFIX_GEN = 32
PREFIX_LENS = {"P": 120, "Q": 128, "D64": 64, "D96": 96}
PREFIX_TRACE = [("P", 0.0, None, 0), ("P", 0.8, 1, 0), ("P", 0.8, 2, 2),
                ("P", 0.8, 3, 4), ("P", 0.8, 4, 8), ("P", 0.0, None, 48),
                ("D64", 0.0, None, 0), ("D96", 0.0, None, 8),
                ("Q", 0.0, None, 16), ("Q", 0.0, None, 20)]
# the poison of a shared page: Q's donor and two repeats; the first repeat
# (request 1, no tail) is poisoned on its cache admission
POISON_TRACE = [("Q", 0.0, None, 0), ("Q", 0.0, None, 2),
                ("Q", 0.0, None, 4)]
# the smoke trace (pages of 8): P 20 tokens (2 full pages and a tail), Q 16
# (2 full pages), D 12; 8 new tokens each
PREFIX_SMOKE_LENS = {"P": 20, "Q": 16, "D": 12}
PREFIX_SMOKE_TRACE = [("P", 0.0, None, 0), ("P", 0.8, 1, 0),
                      ("P", 0.8, 2, 2), ("D", 0.0, None, 0),
                      ("Q", 0.0, None, 4), ("Q", 0.0, None, 6),
                      ("P", 0.0, None, 14)]


def _prefix_prompts(cfg, lens, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
            for k, n in lens.items()}


def _submit_prefix(eng, trace, prompts, gen):
    return [eng.submit(prompts[p], gen, temperature=temp, top_p=0.9,
                       seed=seed, arrival_step=a)
            for p, temp, seed, a in trace]


def _prefix_counters(s):
    return {k: s[k] for k in ("prefix_hits", "pages_shared",
                              "prefill_tokens_skipped")}


def _timed(torch, fn, times):
    """`fn`, each call synchronised and its host ms appended to `times`."""
    def run(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def _timed_admissions(torch, eng, log):
    """Time each cold one-shot admission (`_admit`: the prefill, the install
    and, with sharing, the deposit's clones) and each cache admission
    (`_admit_from_cache`), synchronised, on the host clock."""
    eng._admit = _timed(torch, eng._admit, log["cold_ms"])
    eng._admit_from_cache = _timed(torch, eng._admit_from_cache,
                                   log["cache_ms"])


def _poison_at_cache_admission(torch, eng, rid, log):
    """Replace the engine's chaos injection point (the engine needs a
    `chaos` for it to run) with one NaN poison of request `rid`'s slot on
    the tick it was admitted from the cache, when its last written
    position lies in a SHARED page. Records the page, its fork, whether
    the fork copied K, V (and scales) and left the shared page alone, and
    the poison's ms."""
    pool = eng.pool

    def inject():
        slot = next((s for s, o in enumerate(pool.owner) if o is not None
                     and o.request_id == rid and len(o.tokens) == 1), None)
        if slot is None or log:
            return
        t = int(pool.t_host[slot]) - 1
        idx, off = divmod(t, pool.page_size)
        page = int(pool.block_table[slot, idx])
        names = [k for k in ("k_pages", "v_pages", "k_scales", "v_scales")
                 if k in pool.state]
        before = {k: pool.state[k][:, page].clone() for k in names}
        refcount = pool.alloc.refcount(page)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.poison_slot(slot)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        new = int(pool.block_table[slot, idx])
        poisoned = "k_scales" if pool.quant else "k_pages"
        got = {k: pool.state[k][:, new].clone() for k in names}
        nan = bool(torch.isnan(got[poisoned][:, off] if not pool.quant
                               else got[poisoned]).all())
        if not pool.quant:
            got[poisoned][:, off] = before[poisoned][:, off]
        same = [k for k in names if not (pool.quant and k == poisoned)]
        copied = all(torch.equal(got[k], before[k]) for k in same)
        kept = all(torch.equal(pool.state[k][:, page], before[k])
                   for k in names)
        log.update(slot=slot, position=t, page=page, refcount=refcount,
                   fork=new, copied=copied, shared_page_kept=kept,
                   poisoned_nan=nan, poison_ms=ms)

    eng._inject_state_faults = inject


def prefix_share_phase(torch, cfg, params, ServingEngine, Chaos, counts,
                       reset_counts, kv_quant, profile):
    """`prefix_share` / `prefix_share_int8`: PREFIX_TRACE on llama's engine
    pool (ENGINE_POOL; bf16 or int8 pages), the audit on every tick, run
    without sharing and with sharing (the counted run); then POISON_TRACE
    with sharing, its request 1 (Q's first repeat, no tail) poisoned with
    NaN on its cache admission, when its last written position lies in a
    shared page.
    Requires: the sharing run's streams equal the plain run's (the sampled
    consumers draw their first token from the cached logits under their
    own generators); 6 hits, 5 x 120 + 128 = 728 prefill tokens skipped,
    5 x 7 + 8 = 43 pages shared; K1 and K2 launched 6 x L times fewer
    (6 one-shot prefills fewer), everything else as the plain run; every
    request DONE and no page in use after the drain. The poisoned run must
    fork the page (K, V and scales copied, the shared page untouched),
    retire request 1 FAILED with a prefix of its stream, and stream the
    donor and the other repeat as the sharing run's Q requests (greedy,
    one prompt: one stream), no page in use after the drain. Prints the
    cold one-shot and cache admissions' ms (medians), each index entry's
    bytes, the peak pages in use with and without sharing and the peak
    device memory; with `profile`, the device operations of one cache
    admission (from the runtime calls) and the device events of one cold
    one-shot admission (deposit included). Returns the counted run's
    launches."""
    t_phase = time.perf_counter()
    L = cfg.num_layers
    pool = dict(ENGINE_POOL, kv_quant=kv_quant)
    prompts = _prefix_prompts(cfg, PREFIX_LENS, 29)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run(share, poison=None, trace=PREFIX_TRACE):
        eng = ServingEngine(params, cfg, device="cuda", prefix_share=share,
                            chaos=Chaos(seed=0) if poison else None, **pool)
        eng.audit_every_tick = True
        log = {"cold_ms": [], "cache_ms": []}
        _timed_admissions(torch, eng, log)
        rids = _submit_prefix(eng, trace, prompts, PREFIX_GEN)
        fork = {}
        if poison is not None:
            _poison_at_cache_admission(torch, eng, rids[poison], fork)
        reset_counts()
        peak = 0
        while eng.has_work():
            eng.step()
            peak = max(peak, eng.pool.alloc.pages_in_use)
        launches = counts()
        # the index's device clones, entry by entry, before the drain
        log["entry_bytes"] = [
            sum(t.numel() * t.element_size() for t in _tensors(e))
            for e in (eng.prefix_index._entries.values() if share else ())]
        fin = eng.run()                   # the drain: flushes the index
        return eng, [fin[r] for r in rids], launches, log, peak, fork

    plain, pfin, plaunch, plog, ppeak, _ = run(False)
    eng, fin, launches, log, peak, _ = run(True)
    ps, s = plain.stats(), eng.stats()
    need([r.tokens for r in fin] == [r.tokens for r in pfin],
         f"prefix_share {kv_quant}: the sharing run streamed other tokens "
         "than the plain run")
    need(_prefix_counters(s) == {"prefix_hits": 6, "pages_shared": 43,
                                 "prefill_tokens_skipped": 728},
         f"prefix_share {kv_quant}: counters {_prefix_counters(s)}")
    for e, f_ in ((plain, pfin), (eng, fin)):
        need(all(r.status == "DONE" and len(r.tokens) == PREFIX_GEN
                 for r in f_) and _drained(e),
             f"prefix_share {kv_quant}: statuses or pages after the drain")
    n = len(PREFIX_TRACE)
    for lc, st_, cold in ((plaunch, ps, n), (launches, s, n - 6)):
        expect = {**gmm_launches(cfg, cold, st_["decode_ticks"]),
                  **go_topk_launches(cfg, st_["decode_ticks"]),
                  **paged_launches(cfg, st_["decode_ticks"], 0, kv_quant),
                  "slstm_seq": 0}
        need(lc == expect, f"prefix_share {kv_quant} launches {lc}, "
             f"expected {expect}")
    need(s["decode_ticks"] == ps["decode_ticks"] and
         plaunch["gmm_swiglu"] - launches["gmm_swiglu"] == 6 * L and
         plaunch["gmm_scaled"] - launches["gmm_scaled"] == 6 * L,
         f"prefix_share {kv_quant}: K1/K2 {launches} vs plain {plaunch}")
    need(len(log["cache_ms"]) == 6 and len(log["cold_ms"]) == 4,
         f"prefix_share {kv_quant}: admissions {log}")

    # the poison of a shared page (POISON_TRACE's request 1: no tail)
    qeng, qfin, _, _, _, fork = run(True, poison=1, trace=POISON_TRACE)
    need(fork and fork["fork"] != fork["page"] and fork["refcount"] >= 3
         and fork["copied"] and fork["shared_page_kept"]
         and fork["poisoned_nan"],
         f"prefix_share {kv_quant}: the poison did not fork: {fork}")
    q_stream = fin[8].tokens                      # Q's donor, greedy
    need(fin[9].tokens == q_stream and qfin[1].status == "FAILED" and
         qfin[1].tokens == q_stream[:len(qfin[1].tokens)] and
         all(qfin[i].tokens == q_stream and qfin[i].status == "DONE"
             for i in (0, 2)) and _drained(qeng),
         f"prefix_share {kv_quant}: the poisoned run's statuses "
         f"{[q.status.value for q in qfin]}, streams or pages differ")
    out = {"kv_quant": kv_quant, **_prefix_counters(s),
           "cold_admission_ms_median": statistics.median(plog["cold_ms"]),
           "cold_admission_ms": plog["cold_ms"],
           "cold_admission_with_deposit_ms_median":
               statistics.median(log["cold_ms"]),
           "cache_admission_ms_median": statistics.median(log["cache_ms"]),
           "cache_admission_ms": log["cache_ms"],
           "entry_bytes": log["entry_bytes"],
           "peak_pages_in_use": peak, "peak_pages_in_use_plain": ppeak,
           "page_waits": s["page_waits"], "decode_ticks": s["decode_ticks"],
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_plain": plaunch,
           "admit_steps": [r.admit_step for r in fin],
           "fork": fork, "failed_tokens": len(qfin[1].tokens)}
    print(f"[prefix_share] {cfg.name} {json.dumps(out)}", flush=True)
    if profile:
        eng = ServingEngine(params, cfg, device="cuda", prefix_share=True,
                            **pool)
        eng.submit(prompts["P"], 4)
        eng.step()                        # the donor prefills and deposits
        fresh = _prefix_prompts(cfg, {"R": PREFIX_LENS["P"]}, 30)["R"]
        reqs = [eng.scheduler.remove(eng.submit(p, 4))
                for p in (prompts["P"], fresh)]
        entry = eng._full_hit(reqs[0])
        slots = eng.pool.free_slots()
        tag = "" if kv_quant == "none" else "_int8"
        profile_short(torch, cfg, f"cache_admission{tag}",
                      lambda: eng._admit_from_cache(slots[0], reqs[0],
                                                    entry, []))
        profile_phase(torch, cfg, {
            f"cold_admission_with_deposit{tag}":
                lambda: eng._admit(slots[1], reqs[1], [])})
        eng.run()
        need(_drained(eng), "prefix_share profile engine: pages left")
    print(f"[prefix_share] {cfg.name} {kv_quant}: phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# The expert-aware trace at full width: on ENGINE_POOL, 8 requests at tick
# 0, EXPERT_GEN new tokens each; requests 0-3 have EXPERT_LENS[0] prompt
# tokens, 4-7 EXPERT_LENS[1]. The gate probe reads a prompt's first 64
# tokens, which on the engine trace's prompts cover every expert of both
# models (all tie, so the scheduler admits in FIFO order there); prompts
# this short leave most experts out, and a short prompt's signature (at
# most 2 x top-k experts) is smaller than a long one's.
EXPERT_LENS = (8, 2)
EXPERT_GEN = 8


def expert_aware_phase(torch, cfg, params, ServingEngine, counts,
                       reset_counts):
    """`<model>_expert_aware`: the expert trace (EXPERT_LENS) FIFO, then
    with expert-aware admission, one synchronised step at a time. The
    aware run must admit in another order than FIFO (its first pick, onto
    an empty batch, is the prompt with the fewest experts: a short one)
    and stream the FIFO run's tokens; its launches are those of the
    formulas. Prints both runs' admission orders, admit steps, signatures
    and pure decode ticks' median ms. Returns the aware run's launches."""
    import numpy as np
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (EXPERT_LENS[0],) * 4 + (EXPERT_LENS[1],) * 4]

    def run(aware):
        eng = ServingEngine(params, cfg, device="cuda", expert_aware=aware,
                            **ENGINE_POOL)
        rids = [eng.submit(p, EXPERT_GEN) for p in prompts]
        order, admit = [], eng._admit_any

        def logged(slot, req, done):
            order.append(rids.index(req.request_id))
            admit(slot, req, done)
        eng._admit_any = logged
        reset_counts()
        pure = []
        while eng.has_work():
            d0, a0 = eng.decode_ticks, eng.pool.admitted_total
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if eng.decode_ticks > d0 and eng.pool.admitted_total == a0:
                pure.append((time.perf_counter() - t0) * 1e3)
        launches = counts()
        fin = eng.run()
        s = eng.stats()
        need(s["statuses"] == {"DONE": len(rids)} and _drained(eng),
             f"{cfg.name} expert_aware={aware}: stats {s}")
        return [fin[r] for r in rids], order, pure, launches, s

    fifo, forder, fpure, _, _ = run(False)
    fin, order, pure, launches, s = run(True)
    sizes = [int(r.expert_sig.sum()) for r in fin]
    need([r.tokens for r in fin] == [r.tokens for r in fifo],
         f"{cfg.name} expert_aware: streams differ from the FIFO run's")
    need(forder == list(range(len(prompts))) and order != forder,
         f"{cfg.name} expert_aware: admission order {order}, FIFO {forder} "
         f"(signature sizes {sizes})")
    expect = {**gmm_launches(cfg, len(prompts), s["decode_ticks"]),
              **go_topk_launches(cfg, s["decode_ticks"]),
              **paged_launches(cfg, s["decode_ticks"], 0),
              "slstm_seq": 0}
    need(launches == expect, f"{cfg.name} expert_aware launches {launches}, "
         f"expected {expect}")
    out = {"admission_order": order, "fifo_admission_order": forder,
           "admit_steps": [r.admit_step for r in fin],
           "fifo_admit_steps": [r.admit_step for r in fifo],
           "signature_sizes": sizes,
           "num_experts": cfg.moe.num_experts,
           "decode_ticks": s["decode_ticks"],
           "decode_tick_ms_median": statistics.median(pure),
           "fifo_decode_tick_ms_median": statistics.median(fpure),
           "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    print(f"[expert_aware] {cfg.name} {json.dumps(out)}", flush=True)
    return launches


def prefix_smoke_phase(torch, cfg, TM, ServingEngine, counts, reset_counts):
    """PREFIX_SMOKE_TRACE on the smoke model (fp32, pages of 8), sharing
    and expert-aware admission on, the audit every tick, fp32 and int8
    pages, on the CPU (plain versions) and on the card (kernels): the same
    streams, statuses and the three counters; the card launched K3."""
    params = TM.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _prefix_prompts(cfg, PREFIX_SMOKE_LENS, 40)
    out = {}
    for kv_quant in ("none", "int8"):
        res = {}
        for side, dev, p in (("cpu", "cpu", params),
                             ("card", "cuda", _tree_to(params, "cuda"))):
            reset_counts()
            eng = ServingEngine(p, cfg, device=dev, num_slots=3,
                                max_tokens=48, paged=True, page_size=8,
                                kv_quant=kv_quant, prefix_share=True,
                                expert_aware=True)
            eng.audit_every_tick = True
            rids = _submit_prefix(eng, PREFIX_SMOKE_TRACE, prompts, 8)
            fin = eng.run()
            s = eng.stats()
            res[side] = {"streams": [fin[r].tokens for r in rids],
                         "statuses": s["statuses"], **_prefix_counters(s),
                         "pages_in_use": s["pages_in_use"]}
        launches = counts()
        need(res["card"] == res["cpu"], f"{cfg.name} {kv_quant} prefix "
             f"smoke: card {res['card']} != cpu {res['cpu']}")
        need(res["card"]["prefix_hits"] == 4 and
             res["card"]["statuses"] == {"DONE": len(PREFIX_SMOKE_TRACE)}
             and res["card"]["pages_in_use"] == 0,
             f"{cfg.name} {kv_quant} prefix smoke: {res['card']}")
        need(launches["paged_attn_decode" + (
            "_int8" if kv_quant == "int8" else "")] > 0,
             f"prefix smoke launches {launches}")
        out[kv_quant] = {k: v for k, v in res["card"].items()
                         if k != "streams"}
    print(f"[prefix_share smoke] {cfg.name}: cpu and cuda equal "
          f"{json.dumps(out)}", flush=True)


def _kind(name):
    """Profile bucket of a device kernel's name."""
    # the paged kernels' int8-page instantiations (KV = int8_t: "signed
    # char" demangled, "a" mangled)
    i8 = " int8" if "signed char" in name or re.search(
        r"kernelI(?:13__nv_bfloat16|f)aLi|Li\d+EaEE", name) else ""
    if "paged_decode" in name:
        return "K3 paged_attn_decode" + i8
    if "paged_chunk_kernel" in name or "paged_chunk_tc_kernel" in name:
        return "K4 paged_attn_chunk" + i8
    if "go_topk_kernel" in name:
        return "K5 go_topk_update"
    if "go_router_kernel" in name:
        return "K5R go_router"
    if "gmm_kernel" in name:
        # template arguments <T, SWIGLU, FUSED, OUT, TM, STAGES>, demangled
        # or mangled; OUT 2 scales the rows (K2, K8), K6 stores the sum (OUT
        # 0 or 1)
        m = re.search(r"gmm_kernel<[^,]+, (true|false), (true|false), "
                      r"(?:\([^)]*\))?(\d)(?:, \d+)*>", name) \
            or re.search(r"Lb([01])ELb([01])ELi(\d)E", name)
        swiglu, fused = (m.group(i) in ("true", "1") for i in (1, 2))
        if not swiglu and not fused and m.group(3) != "2":
            return "K6 gmm"
        return {(True, False): "K1 gmm_swiglu", (False, False): "K2 gmm_scaled",
                (True, True): "K7 gmm_swiglu_fused",
                (False, True): "K8 gmm_scaled_fused"}[(swiglu, fused)]
    if "slstm_seq_kernel" in name or "slstm_cluster_kernel" in name:
        return "K9 slstm_seq"
    # cuBLAS's own GEMM kernels: "nvjet_*" names carry no "gemm"
    if "gemm" in name.lower() or "xmma" in name or "cutlass" in name or \
            name.startswith("nvjet"):
        return "cuBLAS gemm"
    return "other"


def profile_phase(torch, cfg, regions):
    """Where the time goes: torch.profiler over each region. Device busy
    time is the union of the card's kernel intervals; idle share = 1 -
    busy / host wall time of the region."""
    from torch.profiler import ProfilerActivity, profile
    for name, fn in regions.items():
        torch.cuda.synchronize()
        # the device's activity only: the host ops' events would cost ~1 s
        # of post-processing per 3000 kernels and slow the region itself
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
        busy, end = 0.0, float("-inf")
        for a, b in spans:                   # union of intervals, in us
            if b > end:
                busy += b - max(a, end)
                end = b
        by_kind, other = {}, Counter()
        for e in dev:
            kind = _kind(e.name)
            t = by_kind.setdefault(kind, [0, 0.0])
            t[0] += 1
            t[1] += (e.time_range.end - e.time_range.start) / 1e3
            if kind == "other":
                other[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        out = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
               "idle_share": 1 - busy / 1e3 / wall_ms if dev else None,
               "device_events": len(dev),
               "device_events_per_layer": len(dev) / cfg.num_layers,
               "by_kind_ms": {k: round(v[1], 4) for k, v in by_kind.items()},
               "by_kind_count": {k: v[0] for k, v in by_kind.items()}}
        # the five largest kernels left under "other"
        out["other_top5_ms"] = {n[:160]: round(ms, 4)
                                for n, ms in other.most_common(5)}
        print(f"[profile] {cfg.name} {name}: {json.dumps(out)}", flush=True)


def profile_short(torch, cfg, name, fn):
    """The device operations of a region of a few ms (a cache admission),
    counted from the CUDA runtime calls the host made in it: kernel
    launches and copies. torch.profiler's device trace of a region that
    short, this late in the script, keeps 0-2 of its events, with or
    without spin kernels around it (a fresh process keeps them all), so no
    device time or event list is read from it."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = Counter(e.name for e in prof.events()
                    if e.device_type != cuda and e.name.startswith("cu"))
    out = {"kernel_launches": sum(v for k, v in calls.items()
                                  if "LaunchKernel" in k),
           "copies": calls["cudaMemcpyAsync"] + calls["cudaMemsetAsync"],
           "runtime_calls": dict(calls)}
    print(f"[profile] {cfg.name} {name}: {json.dumps(out)}", flush=True)


# The journaled trace at full width, on ENGINE_POOL with preemption and
# prefix sharing: (prompt, priority, arrival tick, temperature, seed), top_p
# 0.9 where it samples, JOURNAL_GEN new tokens each. A (100 tokens: 6 full
# pages and a 4-token tail) is sent three times, twice sampled (its first
# repeat is a cache admission at tick 0); C (448 tokens) is a chunked
# prefill of 4 chunks from tick 2; H (72 tokens, priority 0) arrives at
# tick 3 on 4 busy slots and evicts B; H is sent again at tick 10. The
# snapshot at tick JOURNAL_EVERY then holds 3 live slots, B parked, C's
# chunk job and the index's entries of A, B and H. The in-process crash
# classes stop the engine at tick JOURNAL_CRASH, past C's install.
JOURNAL_GEN = 16
JOURNAL_LENS = {"A": 100, "B": 64, "C": 448, "H": 72}
JOURNAL_TRACE = [("A", 5, 0, 0.0, None), ("A", 5, 0, 0.8, 11),
                 ("B", 5, 0, 0.0, None), ("C", 5, 2, 0.0, None),
                 ("H", 0, 3, 0.0, None), ("A", 5, 6, 0.8, 12),
                 ("H", 5, 10, 0.0, None)]
JOURNAL_POOL = dict(ENGINE_POOL, preemption=True, prefix_share=True)
JOURNAL_EVERY = 4
JOURNAL_CRASH = 6
RECOVERED_EVERY = 64
# the CLI's workload for the child killed by SIGKILL (full width, pages of
# 16, 4 slots; staggered arrivals, one every other tick) and the tick it
# dies at, past its second commit
JOURNAL_CLI = {"--requests": 6, "--slots": 4, "--prompt": 64, "--gen": 16,
               "--page-size": 16, "--snapshot-every": 4}
JOURNAL_CLI_CRASH = 9


def _journal_log(torch, eng, log):
    """Time each snapshot commit of `eng` by part (synchronised, host
    clock): the device read and host conversion (`_snapshot_payload`), the
    pickle + write, the fsyncs; record its bytes and what it holds."""
    payload_fn, commit_fn = eng._snapshot_payload, eng.journal.commit_snapshot

    def payload():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = payload_fn()
        log["read_ms"].append((time.perf_counter() - t0) * 1e3)
        log["holds"].append({
            "step": p["meta"]["step"], "slots": len(p["slots"]),
            "preempted": len(p["preempted"]),
            "chunk_job": p["chunk_req"] is not None,
            "prefix_entries": len(p["prefix"]["entries"])})
        return p

    def commit(p, step):
        seq = commit_fn(p, step)
        for k, v in eng.journal.last_commit.items():
            log[k].append(v)
        return seq

    eng._snapshot_payload, eng.journal.commit_snapshot = payload, commit


def _submit_journal(eng, prompts):
    return [eng.submit(prompts[k], JOURNAL_GEN, priority=pr, arrival_step=a,
                       temperature=t, top_p=0.9, seed=sd)
            for k, pr, a, t, sd in JOURNAL_TRACE]


def _release(torch, eng):
    """Free an engine's device pool now (an abandoned engine's too)."""
    if eng.journal is not None:
        eng.journal.close()
    eng.pool.state.clear()
    eng.prefix_index = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def journal_phase(torch, cfg, params, ServingEngine, EngineJournal, counts,
                  reset_counts, kv_quant, card):
    """`journal` / `journal_int8`: JOURNAL_TRACE on JOURNAL_POOL (bf16 or
    int8 pages), journaled with a snapshot every JOURNAL_EVERY ticks.
    1. The uninterrupted run, unjournaled then journaled (the same trace,
       this call): streams equal; at least one snapshot holds a live slot,
       a parked preempted request, a chunk job and prefix entries; each
       commit's bytes and ms by part; tok/s of both runs (reported only).
    2. Each in-process crash class at tick JOURNAL_CRASH, after a commit,
       on a copy of one run's journal: the engine abandoned; its journal's
       last record torn (`tear_tail`); the next snapshot written without
       its marker (`write_uncommitted_snapshot`). `recover()` into a fresh
       engine and
       drain it: streams and statuses equal the uninterrupted run's, the
       replay oracle silent and empty, the events replayed as expected
       (one fewer when torn; the older snapshot when uncommitted), K1, K2,
       K3 (its int8 body on int8 pages), K4 and K5R launched by the
       recovered engine, pages drained. The recovered engine commits no
       snapshot past its post-recovery one (RECOVERED_EVERY; run 1
       measured their cost). The abandoned engine's pool is freed before
       the first recovery; each recovery prints the pages its restored
       slots and index nodes map together.
    Prints the load, restore, replay and commit ms of each recovery, the
    journal bytes a decode tick and the peak memory, beside `card`.
    Returns the first recovery's launches."""
    import tempfile
    t_phase = time.perf_counter()
    pool = dict(JOURNAL_POOL, kv_quant=kv_quant)
    prompts = _prefix_prompts(cfg, JOURNAL_LENS, 31)
    tag = "" if kv_quant == "none" else "_int8"
    decode = "paged_attn_decode" + tag
    root = tempfile.mkdtemp(prefix="journal")
    out = {"kv_quant": kv_quant, "card": card}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        # 1. the uninterrupted run, unjournaled then journaled
        runs = {}
        for name, jdir in (("plain", None),
                           ("journaled", os.path.join(root, "full"))):
            eng = ServingEngine(params, cfg, device="cuda", journal_dir=jdir,
                                snapshot_every=JOURNAL_EVERY, **pool)
            log = {k: [] for k in ("read_ms", "bytes", "write_ms",
                                   "fsync_ms", "holds")}
            if jdir is not None:
                _journal_log(torch, eng, log)
            rids = _submit_journal(eng, prompts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while eng.has_work():
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fin = eng.run()
            s = eng.stats()
            runs[name] = {
                "streams": [fin[r].tokens for r in rids],
                "statuses": s["statuses"], "log": log, "stats": s,
                "tok_per_s": sum(len(fin[r].tokens) for r in rids) / wall,
                "wall_s": wall}
            need(_drained(eng), f"journal {kv_quant} {name}: pages left")
            _release(torch, eng)
        ref, jr = runs["plain"], runs["journaled"]
        need(jr["streams"] == ref["streams"] and
             ref["statuses"] == {"DONE": len(JOURNAL_TRACE)} and
             jr["statuses"] == ref["statuses"],
             f"journal {kv_quant}: the journaled run streamed other tokens "
             "than the unjournaled one")
        s = ref["stats"]
        need(s["preemptions"] >= 1 and s["prefix_hits"] >= 1 and
             s["chunk_ticks"] > 0,
             f"journal {kv_quant}: the trace did not evict, hit the cache "
             f"and chunk: {s}")
        full = [h for h in jr["log"]["holds"] if h["slots"] and
                h["preempted"] and h["chunk_job"] and h["prefix_entries"]]
        need(full, f"journal {kv_quant}: no snapshot held a live slot, a "
             f"parked request, a chunk job and prefix entries: "
             f"{jr['log']['holds']}")
        js = jr["stats"]
        log = jr["log"]
        out["uninterrupted"] = {
            "full_snapshot": full[0], "holds": log["holds"],
            "snapshots": js["snapshots"], "journal_bytes": js["journal_bytes"],
            "decode_ticks": js["decode_ticks"],
            "journal_bytes_per_tick": js["journal_bytes"] / js["decode_ticks"],
            "snapshot_bytes": log["bytes"],
            "snapshot_read_ms": log["read_ms"],
            "snapshot_write_ms": log["write_ms"],
            "snapshot_fsync_ms": log["fsync_ms"],
            "journaled_tok_per_s": jr["tok_per_s"],
            "plain_tok_per_s": ref["tok_per_s"],
            "journaled_wall_s": jr["wall_s"], "plain_wall_s": ref["wall_s"],
            "preemptions": s["preemptions"], "prefix_hits": s["prefix_hits"],
            "chunk_ticks": s["chunk_ticks"]}

        # 2. the in-process crash classes: one run to tick JOURNAL_CRASH,
        # its journal copied for each class
        jdir = os.path.join(root, "torn")
        eng = ServingEngine(params, cfg, device="cuda", journal_dir=jdir,
                            snapshot_every=JOURNAL_EVERY, **pool)
        rids = _submit_journal(eng, prompts)
        while eng.step_count < JOURNAL_CRASH:
            eng.step()
        committed = eng.journal._seq
        tail = len(EngineJournal.read_tail(jdir, committed))
        need(committed >= 1 and tail > 0,
             f"journal {kv_quant}: no commit and tail before the crash "
             f"(seq {committed}, {tail} events)")
        dirs = {c: os.path.join(root, c) for c in ("abandon", "uncommitted")}
        shutil.copytree(jdir, dirs["abandon"])
        eng.journal.write_uncommitted_snapshot(eng._snapshot_payload())
        shutil.copytree(jdir, dirs["uncommitted"])
        shutil.rmtree(eng.journal._snap_dir(committed + 1))
        eng.journal.tear_tail(eng.journal._last_record_bytes)
        dirs["torn"] = jdir
        _release(torch, eng)
        del eng
        first = None
        for crash in ("abandon", "torn", "uncommitted"):
            jdir = dirs[crash]
            want = tail - (crash == "torn")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the drain commits no further snapshot: the uninterrupted run
            # measured their cost
            rec = ServingEngine.recover(jdir, params, cfg, device="cuda",
                                        snapshot_every=RECOVERED_EVERY)
            torch.cuda.synchronize()
            recover_ms = (time.perf_counter() - t0) * 1e3
            shared = sum(n > 1 for n in rec.pool.alloc.refcounts().values())
            fin = rec.run()
            launches = counts()
            info, rs = rec.recovered_info, rec.stats()
            need([fin[r].tokens for r in rids] == ref["streams"] and
                 rs["statuses"] == ref["statuses"],
                 f"journal {kv_quant} {crash}: the recovered engine streamed "
                 "other tokens than the uninterrupted run")
            need(not rec._replay_expect and info["events"] == want and
                 info["snapshot_seq"] == committed,
                 f"journal {kv_quant} {crash}: replayed {info} of a tail of "
                 f"{want} after seq {committed}; oracle left "
                 f"{rec._replay_expect}")
            need(all(launches[k] > 0 for k in (
                "gmm_swiglu", "gmm_scaled", decode, "paged_attn_chunk" + tag,
                "go_router")),
                f"journal {kv_quant} {crash}: recovered launches {launches}")
            need(_drained(rec), f"journal {kv_quant} {crash}: pages left")
            out[crash] = {**info, "recover_ms": recover_ms,
                          "shared_pages_restored": shared,
                          "replayed_events": rs["replayed_events"],
                          "recoveries": rs["recoveries"],
                          "launches": launches}
            first = first or launches
            _release(torch, rec)
            del rec
            shutil.rmtree(jdir, ignore_errors=True)
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[journal{tag}] {cfg.name} {json.dumps(out)}", flush=True)
    return first


def journal_sigkill_phase(torch, cfg, params, ServingEngine, TS, card):
    """A real SIGKILL at full width: a child `python -m
    repro_torch.launch.serve --arch <cfg> --journal-dir <tmp> --crash-step
    JOURNAL_CLI_CRASH` (JOURNAL_CLI, seed 0 weights, as `params` were drawn
    here) must die with -SIGKILL after printing its params' checksum, which
    must equal `params`' (else the comparison below is void). Its journal,
    recovered here and drained, must stream what the same CLI workload
    streams uninterrupted in this process, every request DONE."""
    import signal
    import tempfile
    import numpy as np
    jdir = tempfile.mkdtemp(prefix="journal_kill")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             cfg.name, "--paged", "--journal-dir", jdir, "--crash-step",
             str(JOURNAL_CLI_CRASH),
             *[str(a) for kv in JOURNAL_CLI.items() for a in kv]],
            env=env, capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        need(child.returncode == -signal.SIGKILL,
             f"journal SIGKILL: the child exited {child.returncode}: "
             f"{child.stdout[-2000:]} {child.stderr[-3000:]}")
        m = re.search(r"params checksum (\S+)", child.stdout)
        mine = TS.params_checksum(params)
        need(m is not None and int(m.group(1)) == mine,
             f"journal SIGKILL: the child's params checksum "
             f"{m and m.group(1)} != {mine!r}: the comparison would be void")
        args = JOURNAL_CLI
        n, size = args["--requests"], args["--prompt"]
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=size, dtype=np.int32)
                   for _ in range(n)]
        ref = TS.serve_continuous(
            params, cfg, prompts, args["--gen"], num_slots=args["--slots"],
            arrival_steps=[2 * i for i in range(n)], paged=True,
            page_size=args["--page-size"], priorities=[0] * n,
            device="cuda")
        ref["engine"].pool.state.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = ServingEngine.recover(jdir, params, cfg, device="cuda")
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t0) * 1e3
        fin = rec.run()
        s = rec.stats()
        need(s["statuses"] == {"DONE": n} and
             all(fin[r].tokens == ref["tokens"][r].tolist()
                 for r in ref["tokens"]),
             f"journal SIGKILL: recovered streams differ from the "
             f"uninterrupted run ({s['statuses']})")
        out = {"child_rc": child.returncode, "child_s": child_s,
               "checksum": mine, "recover_ms": recover_ms,
               **rec.recovered_info, "card": card}
        rec.pool.state.clear()
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    print(f"[journal sigkill] {cfg.name} {json.dumps(out)}", flush=True)


def journal_supervise_phase(arch, card):
    """`--supervise` at smoke width on the card: the CLI re-runs itself as
    a watched child, chaos SIGKILLs generation 0 at tick 6, the supervisor
    restarts it once and generation 1 recovers from the journal and drains:
    exit 0, one restart, `recovered from` printed, every request DONE."""
    import tempfile
    jdir = tempfile.mkdtemp(prefix="journal_sup")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--smoke", "--requests", "4", "--slots", "2",
             "--prompt", "12", "--gen", "12", "--paged", "--page-size", "8",
             "--journal-dir", os.path.join(jdir, "j"), "--snapshot-every",
             "4", "--crash-step", "6", "--supervise"],
            env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    need(res.returncode == 0 and
         "supervised serve exited 0 after 1 restart(s)" in res.stdout and
         "recovered from" in res.stdout and "'DONE': 4" in res.stdout,
         f"journal supervise: rc {res.returncode}: {res.stdout[-3000:]} "
         f"{res.stderr[-3000:]}")
    line = [ln for ln in res.stdout.splitlines() if "supervised" in ln][0]
    print(f"[journal supervise] {arch} smoke: {line} in {wall:.1f} s "
          f"({card})", flush=True)


# ---------------------------------------------------------- starcoder2-3b

# Engine against static generate() at full width, bf16: the engine's decode
# reads pages through K3 and its long prompts prefill through K4, static
# generate() attends through the plain dense path, so their bf16 sums
# round in other places, and a greedy stream may part from static's where
# two logits (bf16 values) lie within a few bf16 steps of each other. So
# static generate()'s path is teacher-forced with the engine's stream:
# at every step the engine's token must be static's argmax, or lie within
# STATIC_GAP_ULPS bf16 steps (of the top logit's magnitude) of its top
# logit; the steps where it is not the argmax are reported.
STATIC_GAP_ULPS = 4
# the windowed cells (window_phase): name, the prompt lengths, new tokens,
# the pool, its chunk ticks. starcoder2: the first prompt binds the
# 4096-token window from its last chunk on (320 pages of 16 a row, 9
# chunks); gemma3: the first prompt (3 chunks of 512) outgrows the local
# layers' 1024-token window from its second chunk on (128 pages a row;
# 16 new tokens, not 64, to hold the script's time)
SC2_WINDOW = ("starcoder2_window", (4608, 128), 64,
              dict(num_slots=2, max_tokens=SC2_MAX_TOKENS, paged=True,
                   page_size=16, prefill_chunk=512), 9)
GEMMA3_WINDOW = ("gemma3_window", (1536, 128), 16,
                 dict(num_slots=2, max_tokens=2048, paged=True,
                      page_size=16, prefill_chunk=512), 3)
# the prefix-extension cell: a repository context that eight requests
# share, each with its own tail, at these ticks. With chunks of 512 the
# first prefills through the chunk lane (0, 512, 1024) and deposits, and
# each other shares the context's pages up to the start of its own last
# chunk (1024: all 64 pages of a 1024-token context, 64 of a 1040-token
# one's 65) and prefills that chunk only; without chunking every prompt
# prefills one-shot and the others share the context's 64 pages. Each case
# (name, context tokens, pool) gives 7 hits, 448 pages shared and 7168
# tokens skipped.
SC2_EXT_TAILS = (64, 256, 96, 224, 128, 192, 160, 80)
SC2_EXT_ARRIVALS = (0, 1, 1, 2, 2, 3, 3, 4)
SC2_EXT_GEN = 32
SC2_EXT_POOL = dict(num_slots=4, max_tokens=1536, paged=True, page_size=16,
                    prefill_chunk=512)
SC2_EXT_CASES = (("chunk_boundary", 1024, SC2_EXT_POOL),
                 ("off_boundary", 1040, SC2_EXT_POOL),
                 ("unchunked", 1024, dict(SC2_EXT_POOL, prefill_chunk=0)))
SC2_EXT_SHARED = 1024


def _bf16_ulp(x):
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def static_agreement(torch, TM, cfg, params, prompt, stream, max_len):
    """static generate()'s path (prefill, then serve_step on a dense cache
    of the pool's capacity) for `prompt` alone, teacher-forced with an
    engine stream: {"equal": the engine's token is static's argmax at
    every step, "parts": the steps where it is not, "max_gap": the largest
    gap between static's top logit and its logit of the engine's token,
    "tol"}; a gap over STATIC_GAP_ULPS bf16 steps fails."""
    tokens = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    state, logits = TM.prefill(params, tokens, cfg, max_len=max_len)
    parts, max_gap, tol = [], 0.0, 0.0
    for i, tok in enumerate(stream):
        lg = logits[0]
        top = int(torch.argmax(lg))
        if top != tok:
            gap = float(lg[top] - lg[tok])
            step_tol = STATIC_GAP_ULPS * _bf16_ulp(float(lg[top]))
            need(gap <= step_tol, f"{cfg.name}: at step {i} the engine's "
                 f"token {tok} lies {gap} below static's top logit (tol "
                 f"{step_tol}): not a bf16 near-tie")
            parts.append(i)
            max_gap, tol = max(max_gap, gap), max(tol, step_tol)
        if i + 1 < len(stream):
            logits, state = TM.serve_step(
                params, state, torch.tensor([tok], device="cuda"), cfg)
    return {"equal": not parts, "parts": parts, "max_gap": max_gap,
            "tol": tol}


def engine_vs_static(torch, TM, cfg, params, stats):
    """The engine trace's bf16 streams (engine_phase's stats) against
    static generate()'s path for each prompt alone (static_agreement)."""
    agree = [static_agreement(torch, TM, cfg, params, p, st,
                              ENGINE_POOL["max_tokens"])
             for p, st in zip(stats["prompts"], stats["streams"])]
    print(f"[full engine] {cfg.name}: against static generate() "
          f"{sum(a['equal'] for a in agree)} of {len(agree)} streams equal; "
          f"{json.dumps(agree)}", flush=True)
    return agree


def window_phase(torch, cfg, params, ServingEngine, TM, counts,
                 reset_counts, cell):
    """`<model>_window`, cell = (name, prompt lengths, new tokens, pool,
    chunk ticks): a prompt past the window (in chunks) and a short one on
    a pool of max_tokens. starcoder2 (SC2_WINDOW, chunks of 512, the
    last from 4096): every decode tick of the first attends past its
    4096-token window (K3 with window 4096), its last chunk too (K4);
    gemma3 (GEMMA3_WINDOW): the 1536-token prompt's decodes attend
    1024 keys on the local layers and all of its keys on the global ones.
    The counted run launches K3/K4 once per layer and tick and nothing else
    of the port, the windowed layers' share (PA.LAUNCHES_WINDOWED) once
    per windowed layer and tick; each stream against static generate()'s
    path (static_agreement); the same prompt's prefill without the window
    gives other last-position logits, so the window binds; a second run on a
    fresh engine streams the same tokens and leaves the same pages. One
    decode tick of both rows is profiled. Returns the counted run's
    launches and their windowed share."""
    import numpy as np
    from repro_torch.kernels import paged_attn as PA
    name, lens, gen, pool, n_chunks = cell
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in lens]
    eng = ServingEngine(params, cfg, device="cuda", **pool)
    rids = [eng.submit(p, gen) for p in prompts]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    profiled = False
    while eng.has_work():
        if not profiled and eng.pool.num_active() == 2 and \
                eng._chunk_job is None:
            # one tick of the run under the profiler (its wall time counts)
            profile_phase(torch, cfg, {"window_decode_tick_2_active":
                                       eng.step})
            profiled = True
        else:
            eng.step()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    windowed = {k: PA.LAUNCHES_WINDOWED[k] for k in launches
                if k in PA.LAUNCHES_WINDOWED}
    s = eng.stats()
    need(profiled, "window cell: no tick with both rows decoding")
    fin = eng.finished
    streams = [fin[r].tokens for r in rids]
    need(all(fin[r].status.value == "DONE" and
             len(fin[r].tokens) == gen for r in rids),
         f"window cell: {[(fin[r].status, len(fin[r].tokens)) for r in rids]}")
    expect = {**gmm_launches(cfg, 0, 0), **go_topk_launches(cfg, 0),
              **paged_launches(cfg, s["decode_ticks"], s["chunk_ticks"]),
              "slstm_seq": 0}
    need(launches == expect and s["chunk_ticks"] == n_chunks,
         f"window cell launches {launches}, expected {expect}; stats {s}")
    # the windowed layers' share: one launch per windowed layer and tick
    n_win = sum(w > 0 for w in TM.layer_windows(cfg))
    expect_w = {k: n * n_win // cfg.num_layers for k, n in expect.items()
                if k in windowed}
    need(windowed == expect_w, f"window cell: windowed launches {windowed}, "
         f"expected {expect_w} ({n_win} of {cfg.num_layers} layers)")
    again = ServingEngine(params, cfg, device="cuda", **pool)
    rids2 = [again.submit(p, gen) for p in prompts]
    fin2 = again.run()
    repeat_equal = [fin2[r].tokens for r in rids2] == streams
    repeat_state_equal = _same(torch, _pool_state(eng.pool.state),
                               _pool_state(again.pool.state))
    need(repeat_equal and repeat_state_equal, "window cell: a second run on "
         f"a fresh engine: streams equal {repeat_equal}, pages equal "
         f"{repeat_state_equal}")
    del again
    agree = [static_agreement(torch, TM, cfg, params, p, st,
                              pool["max_tokens"])
             for p, st in zip(prompts, streams)]
    long_prompt = torch.as_tensor(prompts[0], dtype=torch.long,
                                  device="cuda")[None]
    _, lg = TM.prefill(params, long_prompt, cfg,
                       max_len=pool["max_tokens"])
    _, lg0 = TM.prefill(params, long_prompt,
                        cfg.with_overrides(sliding_window=0),
                        max_len=pool["max_tokens"])
    binds = (lg - lg0).abs().max().item()
    need(binds > 1e-2, f"window cell: the prefill without the window gives "
         f"the same last logits ({binds})")
    out = {"wall_s": wall_s, "tokens": sum(map(len, streams)),
           "tok_per_s": sum(map(len, streams)) / wall_s,
           "decode_ticks": s["decode_ticks"], "chunk_ticks": s["chunk_ticks"],
           "launches": launches, "launches_windowed": windowed,
           "static": agree, "repeat_streams_equal": repeat_equal,
           "repeat_pool_state_equal": repeat_state_equal,
           "window_off_last_logit_max_abs_diff": binds,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    print(f"[{name}] {pool}, prompts {lens}, gen {gen}: {json.dumps(out)}",
          flush=True)
    return launches, windowed


# The llama phases of slices 12-14 (the fault domain, prefix sharing and
# the journal, each on bf16 and int8 pages) run on the first
# LLAMA_SLICE_LAYERS of llama's 32 seeded full-width layers: each compares
# runs of that one model with each other (the fault domain's chaos run
# with the chaos-free trace at that depth), and at full depth they took
# ~320 s of the script's 1218 s on an H100 with a slow host. The SIGKILL
# child serves the full model.
LLAMA_SLICE_LAYERS = 8
# slice 17's dense models at full width, after starcoder2: arch, short
# name, weight count (norm scales and qwen2's biases included), whether
# the engine trace runs a second time on a fresh engine (`repeat`) and
# once more on int8 pages (`int8`), and the window cell (`window`, or
# None). Before each init every earlier model's weights, engines and
# pools are released: the card must hold under FREE_BEFORE_GB then
# (gemma3's bf16 weights are 54.0 GB). To hold the script's time the
# engine traces take DENSE_ENGINE_GEN new tokens a request (half the
# older cells' ENGINE_GEN): every bf16 stream is then held against static
# generate()'s path, which steps each prompt alone, token by token; the
# int8 pool runs on qwen2 only (G 7), gemma3's repeat is its window
# cell's.
DENSE_ENGINE_GEN = 16
DENSE_MODELS = (
    dict(arch="qwen2-7b", short="qwen2", n_params=7_070_619_136,
         repeat=True, int8=True, window=None),
    dict(arch="granite-8b", short="granite8b", n_params=8_053_362_688,
         repeat=True, int8=False, window=None),
    dict(arch="gemma3-27b", short="gemma3", n_params=27_008_319_744,
         repeat=False, int8=False, window=GEMMA3_WINDOW))
FREE_BEFORE_GB = 1.0


def _last_tick(lens, gen):
    """Each prompt's position at its last decode tick: its prefill emits
    the first of `gen` tokens and each decode tick one more, so the last
    tick's query sits at len + gen - 2."""
    return tuple(n + gen - 2 for n in lens)


def _last_chunk(n, chunk):
    """(start, queries, kv_len) of an n-token prompt's last prefill chunk
    (the prompt is right-padded to whole chunks)."""
    return ((n - 1) // chunk * chunk, chunk, n)


def _window_shape(arch, cell, window, drop):
    """A window cell's K3/K4 shape: both rows' last decode tick and the
    long prompt's last chunk, on the cell's pool."""
    name, lens, gen, pool, _ = cell
    return dict(arch=arch, t=_last_tick(lens, gen),
                chunk=_last_chunk(lens[0], pool["prefill_chunk"]),
                max_tokens=pool["max_tokens"], window=window, drop=drop,
                path=name)


# K3/K4 at the dense models' cells, on pools of pages of 16 (derived from
# the cells, so a trimmed cell keeps its kernel shape): decode rows at
# positions `t`, the chunk (start, Cs, kv_len), the pool's max_tokens, the
# window, the keys [lo, hi) the planted fault leaves out, and the cell
# (`path`) whose launches the kernel line reports (on int8 pages its
# `_int8` twin, where the script runs one). starcoder2: its window cell
# (4608 + 128 tokens, chunks of 512) on its pool of 320 pages; qwen2 (GQA
# 28/4: 7 query heads a kv head): the engine trace's first four requests
# and its 448-token prompt's last chunk of 128; gemma3 (32/16 x 128): its
# window cell (1536 + 128 tokens, chunks of 512) on 128 pages, once as a
# local layer (window 1024) and once as a global one.
PAGED_SHAPES = {
    "starcoder2": _window_shape("starcoder2-3b", SC2_WINDOW, 4096,
                                (2560, 2624)),
    "qwen2": dict(arch="qwen2-7b",
                  t=_last_tick(ENGINE_LENS[:4], DENSE_ENGINE_GEN),
                  chunk=_last_chunk(max(ENGINE_LENS),
                                    ENGINE_POOL["prefill_chunk"]),
                  max_tokens=ENGINE_POOL["max_tokens"], window=0,
                  drop=(256, 320), path="qwen2_engine"),
    "gemma3_local": _window_shape("gemma3-27b", GEMMA3_WINDOW, 1024,
                                  (1024, 1088)),
    "gemma3_global": _window_shape("gemma3-27b", GEMMA3_WINDOW, 0,
                                   (1024, 1088)),
}
# qwen2's QKV biases: model_init makes them zero, as the reference does,
# which would leave the bias path dead at full width. The script draws
# them from the seeded generator at standard deviation QKV_BIAS_STD, half
# that of the projections' outputs on the normed input (N(0, 1/d) weights).
QKV_BIAS_STD = 0.5


def _plant_biases(torch, params, g, std):
    """Overwrite the stacked QKV biases (where the params hold them) with
    N(0, std^2) draws from `g`, in place."""
    for k in ("bq", "bk", "bv"):
        b = params["layers"]["attn"].get(k)
        if b is not None:
            b.copy_(std * torch.randn(b.shape, generator=g, device=b.device))


def dense_model_phase(torch, G, PA, SC, GT, TM, TS, ServingEngine, counts,
                      reset_counts, get_config, model):
    """One of DENSE_MODELS at full width, bf16, from seeded random weights,
    after a `need` that the card holds under FREE_BEFORE_GB: the weight
    count, init time and peak memory; `<short>_static` (full_phase);
    `<short>_engine` (engine_phase with DENSE_ENGINE_GEN new tokens, its
    repeat where the entry asks for it; the bf16 streams against static
    generate()'s path, engine_vs_static); `<short>_engine_int8` where the
    entry asks for it (its pool pages about half the bf16 pool's); the
    entry's window cell (window_phase). Each engine path launches K3/K4
    (on int8 pages their `_int8` entries) and no other kernel of the port.
    Returns the paths' launches and the engine paths' windowed share
    (PA.LAUNCHES_WINDOWED) of them."""
    cfg, short = get_config(model["arch"]), model["short"]
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    print(f"[full] before {cfg.name}: {resident:.3f} GB allocated",
          flush=True)
    need(resident < FREE_BEFORE_GB, f"{resident:.3f} GB still held before "
         f"{cfg.name}'s init (limit {FREE_BEFORE_GB} GB)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = TM.model_init(cfg, g, "cuda")
    _plant_biases(torch, params, g, QKV_BIAS_STD)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[full] {cfg.name}: {n_params} parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
          + (f"; QKV biases N(0, {QKV_BIAS_STD}^2)" if cfg.qkv_bias else ""),
          flush=True)
    need(n_params == model["n_params"], f"{cfg.name}: {n_params} "
         f"parameters, expected {model['n_params']}")
    paths = {f"{short}_static": full_phase(torch, G, PA, SC, GT, cfg, params,
                                           TM, TS)}
    windowed = {}
    path = f"{short}_engine"
    paths[path], stats = engine_phase(
        torch, G, PA, SC, GT, cfg, params, ServingEngine,
        repeat=model["repeat"], gen=DENSE_ENGINE_GEN)
    windowed[path] = stats["launches_windowed"]
    engine_vs_static(torch, TM, cfg, params, stats)
    if model["int8"]:
        path = f"{short}_engine_int8"
        paths[path], i8 = engine_phase(
            torch, G, PA, SC, GT, cfg, params, ServingEngine, "int8",
            repeat=model["repeat"], gen=DENSE_ENGINE_GEN)
        windowed[path] = i8["launches_windowed"]
        ratio = i8["pool_page_bytes"] / stats["pool_page_bytes"]
        need(0.45 < ratio < 0.55, f"{cfg.name}: int8 pool pages are "
             f"{ratio:.3f} of the bf16 pool's, not about half")
    if model["window"] is not None:
        path = model["window"][0]
        paths[path], windowed[path] = window_phase(
            torch, cfg, params, ServingEngine, TM, counts, reset_counts,
            model["window"])
    for path, got in paths.items():
        if path.endswith("_static"):
            continue
        k3, k4 = (f"paged_attn_{k}{'_int8' if path.endswith('_int8') else ''}"
                  for k in ("decode", "chunk"))
        need(got[k3] > 0 and got[k4] > 0 and
             all(got[k] == 0 for k in got if k not in (k3, k4)),
             f"{path}: K3/K4 not launched, or another kernel was: {got}")
    del params, stats
    gc.collect()
    torch.cuda.empty_cache()
    return paths, windowed


def starcoder2_prefix_ext_phase(torch, cfg, params, ServingEngine, TM,
                                counts, reset_counts):
    """`starcoder2_prefix_ext`: eight requests share a repository context,
    each with its own tail (code completion over one repository), without
    and with prefix sharing, in each of SC2_EXT_CASES. The consumers map
    the context's first 64 pages and prefill only the rest (one K4 launch
    a layer each, over the shared pages); the counters are 7 hits, 7 x 64
    pages shared, 7 x 1024 tokens skipped. With chunked prefill the
    streams equal the run without sharing bit for bit. Without chunking a
    consumer's remainder is prefilled in a shape the one-shot cold prefill
    does not share, so in bf16 its streams may part: each stream that does
    must be static generate()'s path up to bf16 near-ties
    (static_agreement). The first case's run with sharing runs again on a
    fresh engine: the same streams and pages. Extension and cold
    admissions' ms side by side. Returns the launches of the first case's
    run with sharing."""
    import numpy as np
    L, n = cfg.num_layers, len(SC2_EXT_TAILS) - 1
    out, first = {}, None
    for case, prefix_len, pool in SC2_EXT_CASES:
        rng = np.random.default_rng(6)
        prefix = rng.integers(0, cfg.vocab_size, size=prefix_len,
                              dtype=np.int32)
        prompts = [np.concatenate([prefix, rng.integers(
            0, cfg.vocab_size, size=k, dtype=np.int32)])
            for k in SC2_EXT_TAILS]
        runs, pages = {}, {}
        modes = ("without", "with") + (("repeat",) if first is None else ())
        for mode in modes:
            share = mode != "without"
            eng = ServingEngine(params, cfg, device="cuda",
                                prefix_share=share, **pool)
            eng.audit_every_tick = True
            log = {"ext_ms": [], "chunk_ms": [], "one_shot_ms": []}
            eng._admit_prefix_ext = _timed(torch, eng._admit_prefix_ext,
                                           log["ext_ms"])
            eng._advance_chunk_job_once = _timed(
                torch, eng._advance_chunk_job_once, log["chunk_ms"])
            eng._admit = _timed(torch, eng._admit, log["one_shot_ms"])
            rids = [eng.submit(p, SC2_EXT_GEN, arrival_step=a)
                    for p, a in zip(prompts, SC2_EXT_ARRIVALS)]
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while eng.has_work():
                eng.step()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = counts()
            s = eng.stats()
            fin = eng.finished
            need(all(fin[r].status.value == "DONE" for r in rids),
                 f"prefix_ext {case} share={share}: {s['statuses']}")
            chunk_ms = log.pop("chunk_ms")
            runs[mode] = {
                "streams": [fin[r].tokens for r in rids], "wall_s": wall_s,
                "launches": launches, "counters": _prefix_counters(s),
                "chunk_ticks": s["chunk_ticks"],
                "decode_ticks": s["decode_ticks"], **log,
                # a cold chunked admission: its three chunks' prefill
                "cold_chunked_ms": [sum(chunk_ms[i:i + 3])
                                    for i in range(0, len(chunk_ms), 3)],
                "pages_held_before_flush": eng.pool.alloc.pages_in_use}
            eng.run()                                   # flush the index
            need(eng.pool.alloc.pages_in_use == 0,
                 f"prefix_ext {case}: pages leaked")
            pages[mode] = _pool_state(eng.pool.state)
            del eng
        base, shared = runs["without"], runs["with"]
        repeat = {}
        if "repeat" in runs:
            repeat = {"repeat_streams_equal":
                      runs.pop("repeat")["streams"] == shared["streams"],
                      "repeat_pool_state_equal":
                      _same(torch, pages["with"], pages["repeat"])}
            need(all(repeat.values()), f"prefix_ext {case}: a second run "
                 f"with sharing on a fresh engine: {repeat}")
        chunks = 3 if pool["prefill_chunk"] else 0
        need(shared["counters"] == {
            "prefix_hits": n, "pages_shared": n * SC2_EXT_SHARED // 16,
            "prefill_tokens_skipped": n * SC2_EXT_SHARED}
             and base["counters"]["prefix_hits"] == 0,
             f"prefix_ext {case} counters {shared['counters']}")
        need(shared["chunk_ticks"] == chunks and
             base["chunk_ticks"] == chunks * len(prompts) and
             shared["launches"]["paged_attn_chunk"] == L * (chunks + n) and
             base["launches"]["paged_attn_chunk"] == L * chunks * len(
                 prompts), f"prefix_ext {case} chunk ticks / K4 launches: "
             f"{shared}, {base}")
        parted = [i for i, (a, b) in enumerate(zip(shared["streams"],
                                                   base["streams"]))
                  if a != b]
        agree = {}
        if chunks:
            need(not parted, f"prefix_ext {case}: streams {parted} with "
                 "sharing differ from the run without it")
        else:
            agree = {i: static_agreement(
                torch, TM, cfg, params, prompts[i], shared["streams"][i],
                pool["max_tokens"]) for i in parted}
        out[case] = {"prefix": prefix_len, "streams_equal": len(prompts) - len(
            parted), "parted": parted, "static": agree, **repeat, **{
            k: {kk: v for kk, v in r.items() if kk != "streams"}
            for k, r in (("without_sharing", base),
                         ("with_sharing", shared))}}
        print(f"[starcoder2_prefix_ext] {case} {pool}, prefix {prefix_len}, "
              f"tails {SC2_EXT_TAILS}, gen {SC2_EXT_GEN}: "
              f"{json.dumps(out[case])}", flush=True)
        if first is None:
            first = shared["launches"]
    return first


# Slice 18: training (launch/train.py) at full width, on the MoE layer's
# "xla" realization (no CUDA kernel has a backward pass). TrainConfig's
# seq 512 and global batch 8, warmup 1 step. train_granite: 6 steps of the
# full model, then 2 steps again from the same seed (the first two steps'
# learning rates are equal at any total); the held-out batch is a corpus
# step no run reaches. train_granite_restart: the first 4 layers, a
# checkpoint every 2 steps, RestartRequired raised after step 3's
# in-place update. train_llama8: llama's first 8 layers (its 32 need ~79
# GB of weights, grads and moments: more than one card).
TRAIN_TC = dict(seq_len=512, global_batch=8, warmup_steps=1, log_every=1)
TRAIN_STEPS = 6
TRAIN_REPEAT_STEPS = 2
TRAIN_HELDOUT_STEP = 1_000_000
RESTART_LAYERS = 4
RESTART_STEPS = 5
RESTART_AT = 3
LLAMA_TRAIN_LAYERS = 8
LLAMA_TRAIN_STEPS = 3

# xla_vs_kernels: one full-width MoE layer on one bf16 sequence of 512
# tokens through "xla" and through the kernels. The drop sets and the
# chosen tokens are equal (one routing, one drop order); the outputs
# differ by where each side rounds to bf16 (xla rounds x Wg, x Wi, h and
# y Wo; the kernels keep fp32 until h and y): a few bf16 ulps of the
# output's scale, so max |y_xla - y_kernels| <= XLA_KERNEL_TOL * max |y|.
XLA_KERNEL_TOKENS = 512
XLA_KERNEL_TOL = 3e-2


def _checksum(torch, tree):
    """(the int64 sum of every leaf's bit patterns, the fp64 sum of its
    values), a layer slice at a time: equal trees give equal sums."""
    bits, vals = 0, 0.0
    for t in _leaves(tree):
        t = t.detach()
        view = {2: torch.int16, 4: torch.int32}[t.element_size()]
        for part in (t.split(1) if t.dim() > 1 else [t]):
            bits += int(part.view(view).to(torch.int64).sum())
            vals += float(part.double().sum())
    return bits, vals


def _train_cfg(steps, ckpt_dir, ckpt_every=0):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                       **TRAIN_TC)


def _train_stats(torch, out, card):
    """Per-step losses, grad norms and ms; the median step after the
    first; tokens/s; peak GB since the last reset."""
    tokens = TRAIN_TC["seq_len"] * TRAIN_TC["global_batch"]
    med = statistics.median(out["step_ms"][1:] or out["step_ms"])
    return {"steps": len(out["losses"]), "tokens_per_step": tokens,
            "losses": out["losses"], "grad_norms": out["grad_norms"],
            "step_ms": out["step_ms"], "median_step_ms": med,
            "tok_per_s": tokens / med * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": card}


def _need_finite(out, what):
    import math
    need(all(map(math.isfinite, out["losses"] + out["grad_norms"])),
         f"{what}: a loss or grad norm is not finite: {out['losses']} "
         f"{out['grad_norms']}")


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(torch, TM, TT, get_config, counts, reset_counts, card):
    """train_granite, train_granite_restart, train_llama8; every kernel's
    launch count must stay 0 through each run. Returns {path: counts}."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.runtime.fault import RestartRequired
    paths = {}
    tmp = tempfile.mkdtemp(prefix="train")

    def log(tag):
        return lambda s: print(f"[train] {tag} {s}", flush=True)

    def no_launch(path):
        got = counts()
        need(all(n == 0 for n in got.values()),
             f"{path}: a training step launched a CUDA kernel: {got}")
        paths[path] = got

    # train_granite: full width, full depth
    cfg = get_config("granite-moe-3b-a800m")
    t0 = time.perf_counter()
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)  # noqa: E731
    params = TM.model_init(cfg, gen(), "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_TC["seq_len"],
        global_batch=TRAIN_TC["global_batch"], seed=0))
    heldout = {k: torch.from_numpy(v).cuda()
               for k, v in corpus.batch(TRAIN_HELDOUT_STEP).items()}

    def heldout_loss(p):
        with torch.no_grad():
            return float(TM.loss_fn(p, heldout, cfg)[0])
    before = heldout_loss(params)
    marks = {}

    def mark(step, phase):
        if phase == "update" and step == TRAIN_REPEAT_STEPS - 1:
            marks["checksum"] = _checksum(torch, params)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = TT.run(cfg, _train_cfg(TRAIN_STEPS, tmp), resume=False,
                 device="cuda", params=params, fault=mark,
                 log=log("granite"))
    no_launch("train_granite")
    stats = _train_stats(torch, out, card)
    _need_finite(out, "train_granite")
    after = heldout_loss(params)
    need(after < before, f"train_granite: held-out loss {before} -> {after}")
    stats.update(params=n_params, heldout_before=before,
                 heldout_after=after)
    del out, params
    _free(torch)
    params = TM.model_init(cfg, gen(), "cuda")
    rep = TT.run(cfg, _train_cfg(TRAIN_REPEAT_STEPS, tmp), resume=False,
                 device="cuda", params=params, log=log("granite repeat"))
    need(rep["losses"] == stats["losses"][:TRAIN_REPEAT_STEPS] and
         _checksum(torch, params) == marks["checksum"],
         f"train_granite: the repeat gave {rep['losses']} "
         f"{_checksum(torch, params)}, first run {stats['losses']} "
         f"{marks['checksum']}")
    stats["repeat"] = {"losses": rep["losses"],
                       "checksum": list(marks["checksum"])}
    del rep, params
    _free(torch)
    stats["s"] = time.perf_counter() - t0
    print(f"[train] train_granite {json.dumps(stats)}", flush=True)

    # train_granite_restart: the first RESTART_LAYERS layers
    t0 = time.perf_counter()
    cfg_r = cfg.with_overrides(num_layers=RESTART_LAYERS)
    fired = []

    def fault(step, phase):
        if step == RESTART_AT and phase == "update" and not fired:
            fired.append(time.perf_counter())
            raise RestartRequired(f"injected after step {step}'s update")
    reset_counts()
    ck = os.path.join(tmp, "restart")
    a = TT.run(cfg_r, _train_cfg(RESTART_STEPS, ck, ckpt_every=2),
               resume=False, device="cuda", fault=fault,
               log=log("granite_restart"))
    no_launch("train_granite_restart")
    restored_s = time.perf_counter() - fired[0]
    sum_a = _checksum(torch, a["params"])
    ck_bytes = sum(f.stat().st_size for f in Path(ck).rglob("*.npy"))
    losses_a = a["losses"]
    del a
    _free(torch)
    tc_b = _train_cfg(RESTART_STEPS, tmp)
    b = TT.run(cfg_r, tc_b, resume=False, device="cuda",
               log=log("granite_uninterrupted"))
    want = b["losses"][:RESTART_AT] + b["losses"][RESTART_AT - 1:]
    need(losses_a == want and _checksum(torch, b["params"]) == sum_a,
         f"train_granite_restart: {losses_a} vs {want}")
    # where a training step's time goes: one more step of this model
    batch = {k: torch.from_numpy(v).cuda() for k, v in corpus.batch(
        RESTART_STEPS).items()}
    step = TT.make_step(cfg_r, tc_b)
    profile_phase(torch, cfg_r, {"train_step": lambda: step(
        b["params"], b["opt_state"], batch, RESTART_STEPS)})
    stats = {k: v for k, v in _train_stats(torch, b, card).items()
             if k in ("step_ms", "median_step_ms", "tok_per_s")}
    stats.update(layers=RESTART_LAYERS, losses=losses_a,
                 uninterrupted=b["losses"], checksum=list(sum_a),
                 ckpt_bytes_on_disk=ck_bytes, restart_to_end_s=restored_s,
                 s=time.perf_counter() - t0, card=card)
    print(f"[train] train_granite_restart {json.dumps(stats)}", flush=True)
    del b
    _free(torch)

    # train_llama8: llama's first LLAMA_TRAIN_LAYERS layers
    t0 = time.perf_counter()
    cfg_l = get_config("llama_moe_4_16").with_overrides(
        num_layers=LLAMA_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = TT.run(cfg_l, _train_cfg(LLAMA_TRAIN_STEPS, tmp), resume=False,
                 device="cuda", log=log("llama8"))
    no_launch("train_llama8")
    _need_finite(out, "train_llama8")
    stats = _train_stats(torch, out, card)
    stats.update(layers=LLAMA_TRAIN_LAYERS, params=sum(
        t.numel() for t in _leaves(out["params"])),
        s=time.perf_counter() - t0)
    print(f"[train] train_llama8 {json.dumps(stats)}", flush=True)
    del out
    _free(torch)
    shutil.rmtree(tmp, ignore_errors=True)
    return paths


def xla_vs_kernels_phase(torch, TM, MOE, get_config, counts, reset_counts,
                         card):
    """granite's group_forward and llama's expert_choice_forward at full
    width, one layer, one bf16 sequence: "xla" (no launch) against the
    kernels (K7/K8, K1/K2): the same drop set or chosen tokens, outputs
    within XLA_KERNEL_TOL of the output's scale; both timed."""
    import dataclasses
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for arch in ("granite-moe-3b-a800m", "llama_moe_4_16"):
        cfg = get_config(arch).with_overrides(num_layers=1)
        g = torch.Generator(device="cuda").manual_seed(1)
        moe = TM.layer_params(TM.model_init(cfg, g, "cuda")["layers"],
                              0)["moe"]
        x = torch.randn((XLA_KERNEL_TOKENS, cfg.d_model), generator=g,
                        device="cuda").to(torch.bfloat16)
        ex = dataclasses.replace(cfg.moe, backend="xla")
        if cfg.moe.routing == "token_choice":
            goe, mem = (TM.expert_groups(cfg, "cuda"),
                        TM.expert_group_members(cfg, "cuda"))
            run = lambda e: MOE.group_forward(moe, x, e, goe, mem)  # noqa
            key = "kept"
        else:
            run = lambda e: MOE.expert_choice_forward(moe, x, e)  # noqa
            key = "chosen_tokens"
        with torch.no_grad():
            reset_counts()
            yx, ax = run(ex)
            torch.cuda.synchronize()
            need(all(n == 0 for n in counts().values()),
                 f"{arch}: the xla layer launched a kernel: {counts()}")
            yk, ak = run(cfg.moe)
            torch.cuda.synchronize()
            launched = {k: n for k, n in counts().items() if n}
            need(launched, f"{arch}: the kernel layer launched nothing")
            need(torch.equal(ax[key], ak[key]),
                 f"{arch}: xla and the kernels drop or choose other pairs")
            err = float((yx.float() - yk.float()).abs().max())
            scale = float(yk.float().abs().max())
            need(err <= XLA_KERNEL_TOL * scale,
                 f"{arch}: xla vs kernels err {err} at scale {scale}")
            entry = {"tokens": XLA_KERNEL_TOKENS, key: int(
                ak[key].sum() if key == "kept" else ak[key].numel()),
                "dropped": int(ak.get("dropped", 0)),
                "max_abs_err": err, "out_scale": scale,
                "tol": XLA_KERNEL_TOL, "kernel_launches": launched,
                "xla_ms": time_ms(torch, lambda: run(ex), flush, reps=5),
                "kernels_ms": time_ms(torch, lambda: run(cfg.moe), flush,
                                      reps=5), "card": card}
        out[arch] = entry
        print(f"[xla_vs_kernels] {arch} {json.dumps(entry)}", flush=True)
        del moe, x, yx, yk, ax, ak
        _free(torch)
    return out


def _tensors(tree):
    """Every tensor of a decode state (dicts and named tuples), in order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, tuple) else ()
    return [t for v in vals for t in _tensors(v)]


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core import go_cache as GO
    from repro_torch.core import moe as MOE
    from repro_torch.core import quant as Q
    from repro_torch.core import routing as R
    from repro_torch.kernels import build
    from repro_torch.kernels import go_topk as GT
    from repro_torch.kernels import moe_gmm as G
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import slstm_cell as SC
    from repro_torch.launch import serve as TS
    from repro_torch.launch import train as TT
    from repro_torch.models import model as TM
    from repro_torch.serving import Chaos, EngineJournal, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    print(f"[card] {card}", flush=True)
    parent = sys.argv[sys.argv.index("--parent") + 1] \
        if "--parent" in sys.argv else None
    extra = [os.path.join(parent, f"{n}.cu") for n in PARENT_SOURCES] \
        if parent else []
    build_s = build.build_all(extra)
    print(f"[build] kernels built in {build_s:.1f} s", flush=True)
    for n, src in zip(PARENT_SOURCES, extra):
        PARENT[n] = build.load_path(src)
        print(f"[build] parent body {src}: timed in turns", flush=True)
    # conversion instructions in the paged-attention bodies, this
    # checkout's and the parent's
    sass = {"change": sass_conversions(build, build.CSRC / "paged_attn.cu")}
    if "paged_attn" in PARENT:
        sass["parent"] = sass_conversions(
            build, extra[PARENT_SOURCES.index("paged_attn")])
    for side, by_kernel in sass.items():
        for k, c in by_kernel.items():
            print(f"[sass] {side} {k}: {json.dumps(c)}", flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    def counts():
        return {**G.LAUNCHES, **PA.LAUNCHES, **SC.LAUNCHES, **GT.LAUNCHES}

    def reset_counts():
        for mod in (G, PA, SC, GT):
            mod.reset_launches()

    llama, granite = "llama_moe_4_16", "granite-moe-3b-a800m"
    deepseek = "deepseek-moe-16b"
    sc2 = "starcoder2-3b"
    cfgs = {m: get_config(m) for m in (llama, granite, deepseek)}
    by_path = {}
    windowed = {}          # a path's launches made with a window (> 0)
    kernel_phase_small(torch, G)
    timings, llama_prefill = kernel_phase_full(
        torch, G, OPS, R, GT,
        {"granite": cfgs[granite], "deepseek": cfgs[deepseek]})
    k5_small = go_topk_phase(torch, GT)
    timings["go_router"] = go_router_phase(torch, GT, GO, OPS)
    by_path["go_cache_step_strided"] = go_topk_path(torch, GT, GO, OPS,
                                                    counts, reset_counts)
    gmm_phase_small(torch, G)
    timings["gmm"], by_path["llama_expert_ffn_gmm"] = gmm_phase_full(
        torch, G, OPS, llama_prefill, counts, reset_counts)
    del llama_prefill
    fused_phase_small(torch, G, OPS)
    timings.update(fused_phase_full(torch, G, OPS, MOE, R, TM,
                                    cfgs[granite]))
    for name, entry in fused_phase_full(torch, G, OPS, MOE, R, TM,
                                        cfgs[deepseek], "deepseek").items():
        timings[name]["deepseek"] = entry
    paged_phase_small(torch, PA)
    decode_split_sweep(torch, PA)
    chunk_bf16_sweep(torch, PA)
    paged = {m: paged_phase_full(torch, PA, cfgs[m], ENGINE_POOL["page_size"],
                                 ENGINE_POOL["max_tokens"]) for m in cfgs}
    for name, entry in paged[llama].items():
        timings[name] = {**entry, "granite": paged[granite][name],
                         "deepseek": paged[deepseek][name]}
    int8_small = paged_int8_phase_small(torch, PA, Q)
    paged = {m: paged_int8_phase_full(torch, PA, Q, cfgs[m],
                                      ENGINE_POOL["page_size"],
                                      ENGINE_POOL["max_tokens"]) for m in cfgs}
    for name, entry in paged[llama].items():
        body = "decode_split" if "decode" in name else "chunk_tc"
        timings[name] = {**entry, "granite": paged[granite][name],
                         "deepseek": paged[deepseek][name],
                         "small_max_abs_err": int8_small,
                         "tol": {"fp32_q": PAGED_TOL_I8_F32,
                                 "bf16_q": PAGED_TOL_BF16},
                         "sass": {side: {k: c for k, c in by_kernel.items()
                                         if body in k}
                                  for side, by_kernel in sass.items()}}
    del paged
    # K3/K4 at the dense models' shapes: starcoder2's GQA 24/2 x 128 with
    # its window, qwen2's group of 7, gemma3's local and global layers
    for label, shape in PAGED_SHAPES.items():
        t0 = time.perf_counter()
        for name, entry in paged_phase_windowed(
                torch, PA, Q, get_config(shape["arch"]), shape).items():
            timings[name][label] = entry
        print(f"[paged {label}] {time.perf_counter() - t0:.1f} s",
              flush=True)
    timings["slstm_seq"] = slstm_phase(torch, SC)
    torch.cuda.empty_cache()
    for m in cfgs:
        smoke_phase(torch, G, GT, get_config(m, smoke=True), TM, TS)
        for kv_quant in ("none", "int8"):
            engine_smoke_phase(torch, G, PA, GT, get_config(m, smoke=True),
                               TM, TS, kv_quant)
    fault_smoke_phase(torch, get_config(llama, smoke=True), TM,
                      ServingEngine, Chaos, counts, reset_counts)
    for m in cfgs:
        prefix_smoke_phase(torch, get_config(m, smoke=True), TM,
                           ServingEngine, counts, reset_counts)
    journal_supervise_phase(llama, card)
    # the dense models' smoke configs: starcoder2-3b (window 32), qwen2
    # (seeded nonzero QKV biases), granite-8b, gemma3 (local, local,
    # global; window 16)
    for m in (sc2, *(d["arch"] for d in DENSE_MODELS)):
        t0 = time.perf_counter()
        smoke = get_config(m, smoke=True)
        smoke_phase(torch, G, GT, smoke, TM, TS)
        for kv_quant in ("none", "int8"):
            engine_smoke_phase(torch, G, PA, GT, smoke, TM, TS, kv_quant)
        print(f"[smoke] {smoke.name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    xlstm = "xlstm-1.3b"
    xlstm_smoke_phase(torch, SC, get_config(xlstm, smoke=True), TM, TS)
    recurrent_smoke_phase(torch, TM, TS, get_config, counts, reset_counts)
    cross_smoke_phase(torch, TM, TS, ServingEngine, get_config, counts,
                      reset_counts)

    for m, short in ((llama, "llama"), (granite, "granite"),
                     (deepseek, "deepseek")):
        cfg = cfgs[m]
        t0 = time.perf_counter()
        params = TM.model_init(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        print(f"[full] {cfg.name}: {sum(t.numel() for t in _leaves(params))} "
              f"parameters initialised in {time.perf_counter() - t0:.2f} s",
              flush=True)
        if cfg.moe.num_shared_experts:
            shared_phase(torch, MOE, TM, cfg, params)
        by_path[f"{short}_static"] = full_phase(torch, G, PA, SC, GT, cfg,
                                                params, TM, TS)
        # the engine trace's repeat: llama's bf16 pool (and starcoder2's
        # two) only, to hold the script's time
        by_path[f"{short}_engine"], bf16_stats = engine_phase(
            torch, G, PA, SC, GT, cfg, params, ServingEngine,
            repeat=m == llama)
        if m != deepseek:
            # slice 13: expert-aware admission on a trace it reorders
            by_path[f"{short}_expert_aware"] = expert_aware_phase(
                torch, cfg, params, ServingEngine, counts, reset_counts)
        if m != granite:
            # the same trace on int8 KV pages (and GO rows: slice 8)
            by_path[f"{short}_engine_int8"], i8_stats = engine_phase(
                torch, G, PA, SC, GT, cfg, params, ServingEngine, "int8",
                repeat=False)
            ratio = i8_stats["pool_page_bytes"] / bf16_stats["pool_page_bytes"]
            print(f"[full engine] {cfg.name}: int8 pool pages "
                  f"{i8_stats['pool_page_bytes']} B, bf16 "
                  f"{bf16_stats['pool_page_bytes']} B (ratio {ratio:.4f}); "
                  f"tok/s int8 {i8_stats['tok_per_s']:.2f}, bf16 "
                  f"{bf16_stats['tok_per_s']:.2f}", flush=True)
            need(0.45 < ratio < 0.55, f"int8 pool pages are {ratio:.3f} of "
                 "the bf16 pool's, not about half")
        if m == llama:
            # slices 12-14 on llama's first LLAMA_SLICE_LAYERS layers
            cfg_h, params_h = _head_layers(cfg, params, LLAMA_SLICE_LAYERS)
            # slice 12: the engine's fault domain, bf16 then int8 pages,
            # against the chaos-free trace at that depth
            for kvq in ("none", "int8"):
                tag = "" if kvq == "none" else "_int8"
                by_path[f"fault_domain{tag}"] = fault_domain_phase(
                    torch, cfg_h, params_h, ServingEngine, Chaos, counts,
                    reset_counts, kvq,
                    _engine_streams(cfg_h, params_h, ServingEngine, kvq))
            # slice 13: copy-on-write prefix sharing, bf16 then int8 pages
            # (the admissions profiled on bf16 pages only)
            for kvq in ("none", "int8"):
                tag = "" if kvq == "none" else "_int8"
                by_path[f"prefix_share{tag}"] = prefix_share_phase(
                    torch, cfg_h, params_h, ServingEngine, Chaos, counts,
                    reset_counts, kvq, profile=kvq == "none")
            # slice 14: the journal's crash classes, bf16 then int8 pages,
            # and a child process (the full model) killed by SIGKILL
            for kvq in ("none", "int8"):
                tag = "" if kvq == "none" else "_int8"
                by_path[f"journal{tag}"] = journal_phase(
                    torch, cfg_h, params_h, ServingEngine, EngineJournal,
                    counts, reset_counts, kvq, card)
            del params_h
            journal_sigkill_phase(torch, cfg, params, ServingEngine, TS, card)
            # slice 11: the engine trace with prompt buckets and sampling,
            # and the static batch past K5R's 64 rows
            by_path["llama_engine_sampled"], _ = sampled_engine_phase(
                torch, G, PA, SC, GT, cfg, params, ServingEngine)
            by_path["go_wide"], timings["go_topk_update"] = go_wide_phase(
                torch, G, PA, SC, GT, cfg, params, TS, counts, reset_counts)
            timings["go_topk_update"]["b4"] = k5_small
        # the engines of the phases above hold the weights in reference
        # cycles: collect them, or the next model's peak counts these too
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[full] {cfg.name}: {time.perf_counter() - t0:.1f} s",
              flush=True)

    # slice 18: training on the MoE layer's "xla" realization (granite at
    # full width and depth, its first 4 layers through a restart, llama's
    # first 8), then one layer of each on "xla" against the kernels
    t0 = time.perf_counter()
    by_path.update(train_phase(torch, TM, TT, get_config, counts,
                               reset_counts, card))
    xla_vs_kernels_phase(torch, TM, MOE, get_config, counts, reset_counts,
                         card)
    print(f"[full] training: {time.perf_counter() - t0:.1f} s", flush=True)

    # starcoder2-3b at full width (dense MLP, GQA 24/2, window
    # 4096): static, the engine trace on bf16 and int8 pages (bf16 streams
    # against static generate()), the windowed cell, the prefix extension
    cfg = get_config(sc2)
    t0 = time.perf_counter()
    params = TM.model_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[full] {cfg.name}: {n_params} parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    need(n_params == 4_161_985_536, f"{cfg.name}: {n_params} parameters")
    by_path["starcoder2_static"] = full_phase(torch, G, PA, SC, GT, cfg,
                                              params, TM, TS)
    by_path["starcoder2_engine"], sc2_stats = engine_phase(
        torch, G, PA, SC, GT, cfg, params, ServingEngine)
    engine_vs_static(torch, TM, cfg, params, sc2_stats)
    by_path["starcoder2_engine_int8"], sc2_i8 = engine_phase(
        torch, G, PA, SC, GT, cfg, params, ServingEngine, "int8")
    ratio = sc2_i8["pool_page_bytes"] / sc2_stats["pool_page_bytes"]
    need(0.45 < ratio < 0.55, f"{cfg.name}: int8 pool pages are {ratio:.3f} "
         "of the bf16 pool's, not about half")
    by_path["starcoder2_window"], windowed["starcoder2_window"] = \
        window_phase(torch, cfg, params, ServingEngine, TM, counts,
                     reset_counts, SC2_WINDOW)
    by_path["starcoder2_prefix_ext"] = starcoder2_prefix_ext_phase(
        torch, cfg, params, ServingEngine, TM, counts, reset_counts)
    for path, (k3, k4) in {
            "starcoder2_engine": ("paged_attn_decode", "paged_attn_chunk"),
            "starcoder2_engine_int8": ("paged_attn_decode_int8",
                                       "paged_attn_chunk_int8"),
            "starcoder2_window": ("paged_attn_decode", "paged_attn_chunk"),
            "starcoder2_prefix_ext": ("paged_attn_decode",
                                      "paged_attn_chunk")}.items():
        got = by_path[path]
        need(got[k3] > 0 and got[k4] > 0 and
             all(got[k] == 0 for k in got if k not in (k3, k4)),
             f"{path}: K3/K4 not launched, or another kernel was: {got}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[full] {cfg.name}: {time.perf_counter() - t0:.1f} s", flush=True)

    # slice 17: qwen2-7b, granite-8b, gemma3-27b
    for model in DENSE_MODELS:
        t0 = time.perf_counter()
        paths, win = dense_model_phase(
            torch, G, PA, SC, GT, TM, TS, ServingEngine, counts,
            reset_counts, get_config, model)
        by_path.update(paths)
        windowed.update(win)
        print(f"[full] {model['arch']}: {time.perf_counter() - t0:.1f} s",
              flush=True)

    by_path.update(xlstm_full_phase(torch, counts, reset_counts,
                                    get_config(xlstm), TM, TS, ServingEngine))
    gc.collect()
    torch.cuda.empty_cache()
    # slice 19: zamba2-1.2b (Mamba2 with a shared attention block)
    t0 = time.perf_counter()
    by_path.update(zamba2_full_phase(torch, counts, reset_counts,
                                     get_config("zamba2-1.2b"), TM, TS,
                                     ServingEngine))
    print(f"[full] zamba2-1.2b: {time.perf_counter() - t0:.1f} s",
          flush=True)
    # slice 20: the cross-attention families, whisper-base uncut, then
    # llama-3.2-vision-90b at full width on its first VISION_LAYERS layers
    for arch, short, weights, cell, pool, depth in (
            ("whisper-base", "whisper", WHISPER_WEIGHTS, WHISPER_ENGINE,
             WHISPER_POOL, None),
            ("llama-3.2-vision-90b", "vision20", VISION_WEIGHTS,
             VISION_ENGINE, VISION_POOL, VISION_LAYERS)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if depth:
            cfg = cfg.with_overrides(num_layers=depth)
        by_path.update(cross_full_phase(torch, counts, reset_counts, cfg, TM,
                                        TS, ServingEngine, short, weights,
                                        cell, pool))
        print(f"[full] {arch}: {time.perf_counter() - t0:.1f} s", flush=True)

    # launches: each kernel's count on the path it was ported for (K1/K2
    # llama's static generate() of slice 1, K3/K4 llama's engine of slice 2,
    # K7/K8 granite's engine of slice 3, K9 xlstm's model_forward of slice
    # 4, K6 llama's expert_ffn_gmm of slice 5, K3/K4 on int8 pages llama's
    # int8 engine of slice 8, K5R llama's engine of slice 9, which took K5's
    # place on the served paths: K5 alone runs on go_cache_step's strided
    # cache); every path's count beside it
    meta = {
        "gmm_swiglu": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:466",
                       "llama_static"),
        "gmm_scaled": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:332",
                       "llama_static"),
        "paged_attn_decode": ("paged_attn.cu",
                              "src/repro/kernels/paged_attn.py:179",
                              "llama_engine"),
        "paged_attn_chunk": ("paged_attn.cu",
                             "src/repro/kernels/paged_attn.py:325",
                             "llama_engine"),
        "paged_attn_decode_int8": ("paged_attn.cu",
                                   "src/repro/kernels/paged_attn.py:179",
                                   "llama_engine_int8"),
        "paged_attn_chunk_int8": ("paged_attn.cu",
                                  "src/repro/kernels/paged_attn.py:325",
                                  "llama_engine_int8"),
        "gmm_swiglu_fused": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:423",
                             "granite_engine"),
        "gmm_scaled_fused": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:384",
                             "granite_engine"),
        "slstm_seq": ("slstm_cell.cu", "src/repro/kernels/slstm_cell.py:62",
                      "xlstm_forward"),
        "go_topk_update": ("go_topk.cu", "src/repro/kernels/go_topk.py:43",
                           "go_wide"),
        "go_router": ("go_topk.cu", "src/repro/kernels/go_topk.py:43",
                      "llama_engine"),
        "gmm": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:274",
                "llama_expert_ffn_gmm"),
    }
    # slice 15: deepseek's paths launch K7/K8 at the C1 prefill, K1/K2 at
    # the decode and K3/K4 (their int8 entries on int8 pages) in the
    # engine (each path's phase checked its counts against the formulas)
    ds = {"deepseek_static": ("gmm_swiglu_fused", "gmm_scaled_fused",
                              "gmm_swiglu", "gmm_scaled"),
          "deepseek_engine": ("gmm_swiglu_fused", "gmm_scaled_fused",
                              "gmm_swiglu", "gmm_scaled", "paged_attn_decode",
                              "paged_attn_chunk"),
          "deepseek_engine_int8": ("gmm_swiglu_fused", "gmm_scaled_fused",
                                   "gmm_swiglu", "gmm_scaled",
                                   "paged_attn_decode_int8",
                                   "paged_attn_chunk_int8")}
    for path, names in ds.items():
        need(all(by_path[path][n] > 0 for n in names) and
             by_path[path]["go_router"] == 0,
             f"{path}: a kernel of the path was not launched: "
             f"{by_path[path]}")
    kernels = []
    for name, (src, replaces, path) in meta.items():
        need(by_path[path][name] > 0 and
             (not name.endswith("_fused") or by_path["granite_static"][name])
             and (name != "go_router" or (by_path["llama_static"][name] and
                                          by_path["llama_engine_int8"][name])),
             f"{name} was not launched on its path: {by_path}")
        main_t = timings[name].get("prefill", timings[name])
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": by_path[path][name],
            "max_abs_err": main_t["max_abs_err"], "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"], "shape": main_t["shape"],
            "launches_by_path": {p: by_path[p][name] for p in by_path}}
        entry.update({k: main_t[k] for k in (
            "planted_fault_err", "tol", "bound_bytes_ms",
            "bound_operations_ms", "bound_note", "library_note",
            "path_max_abs_err", "path_ms", "parent_ms", "turns_ms",
            "achieved_bytes_per_s", "bound_share", "tiles_per_block",
            "warps", "warps_ms", "pages_per_split", "splits", "ctas",
            "cluster", "cluster_capacity", "fp32_r",
            "small_max_abs_err", "g_rel_err", "small_g_rel_err",
            "before_ms", "splits", "split_rows", "one_cta_ms",
            "split_keys_ms", "parent_bits_equal", "sass", "b4",
            "wide_steps")
            if k in main_t})
        if "decode" in timings[name]:
            entry["shape"] = "prefill " + main_t["shape"]
            for k in ("decode", "granite_decode", "deepseek_decode",
                      "wide_decode"):
                entry[k] = timings[name][k]
        for k in ("granite", "deepseek"):
            if k in timings[name]:
                entry[k] = timings[name][k]
        for label, shape in PAGED_SHAPES.items():
            if label not in timings[name]:
                continue
            # launches on the cell of the shape (on int8 pages its _int8
            # twin): a windowed shape's the windowed layers', a global
            # one's the rest; null where the script runs no such cell
            cell = shape["path"] + ("_int8" if name.endswith("_int8")
                                    else "")
            launches = None
            if cell in by_path:
                n, w = by_path[cell][name], windowed[cell][name]
                launches = w if shape["window"] else n - w
                need(launches > 0, f"{name} at {label}: no launch on {cell}")
            entry[label] = {**timings[name][label],
                            "path": cell if launches is not None else None,
                            "launches": launches}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
