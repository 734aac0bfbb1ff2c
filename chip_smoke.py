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
     granite's decode on a real token-choice dispatch plan, 4 rows top-8
     of 40), with median times of kernel, plain version and one library
     call (`library_ms`), achieved bytes/s and share of the bound; a
     second launch must repeat every bit.
  2. K7 gmm_swiglu_fused and K8 gmm_scaled_fused (the fused lane pairs of
     the C1 group path): fp32 at small ragged shapes with straddle tiles
     (mid-tile, at a tile's last row, an empty primary lane, invalid tail
     tiles), then bf16 at the full-width granite prefill plan (4 x 128
     tokens, top-8 of 40, group-major lanes fused pairwise), with times;
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
     engine run's full-width shapes of both models (llama 32/32 heads of
     128, granite 24/8 heads of 64) with kernel, plain and library times,
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
     its own repeat).
     K9 slstm_seq against its plain version: fp32 at the JAX test's three
     shapes, then xlstm-1.3b's full-width sLSTM (B 4, S 128, H 4, hd 512,
     fp32 u, bf16 r) on its cluster body (16 CTAs a head, r resident in
     shared memory) with a planted fault beside it, a second launch
     bit-equal, with times; and fp32 r at hd 512, which keeps the
     per-(head, batch row) body.
  4. the slices end to end at smoke size, fp32, the same weights on the
     CPU (plain versions) and on the card (kernels): static generate(),
     then the continuous-batching engine on a paged pool with chunked
     prefill; llama_moe_4_16 (expert choice, GO cache) and
     granite-moe-3b-a800m (token choice, C1 groups: K7/K8 at prefill);
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
  5. full width, bf16, one set of random weights per model, first
     llama_moe_4_16, then granite-moe-3b-a800m:
     a. static generate(): 4 requests x 128 prompt tokens, 16 new tokens,
        with its profile; its two repeats must give the same tokens;
     b. the continuous-batching engine on a paged pool (4 slots, pages of
        16, 97 pages, chunks of 128): 8 staggered requests, 32 new tokens
        each, with its profile of one decode tick and one chunk tick; the
        trace runs twice and both runs must stream the same tokens and
        leave the same KV pages and GO rows, bit for bit. Then
        `<model>_expert_aware`: a trace of short prompts (EXPERT_LENS),
        whose signatures leave experts out, FIFO and with expert-aware
        admission: another admission order, the same streams (orders,
        admit steps and the decode ticks' median printed). llama then runs
        the same trace on int8 KV pages and GO rows (`llama_engine_int8`:
        K3/K4 on the int8 operand): the same checks, scales included,
        its pool's page bytes beside the bf16 pool's (about half), and
        its own profile. Then `fault_domain` (bf16, then
        `fault_domain_int8` on int8 pages; the audit on every tick):
        FAULT_TRACE on FAULT_PAGES pages, where a high-priority arrival
        evicts a low-priority stream to a host snapshot and it resumes into
        other physical pages, every stream bit-equal to the trace on a pool
        that never evicts (snapshot pages, bytes and ms, restore ms);
        FAULT_CHAOS on the engine trace, streams bit-equal to the
        chaos-free run above; a NaN-poisoned slot of 4 retires FAILED with
        a prefix of its clean stream, the others equal, and a request
        admitted next maps the scrubbed pages and streams as on a fresh
        pool; (bf16) max_wall_s=0 retires TIMEOUT with a prefix, and a
        prefill cancelled after one chunk hands its pages back. Then
        `prefix_share` (bf16, then `prefix_share_int8`; the audit on every
        tick): PREFIX_TRACE without and with copy-on-write prefix sharing,
        streams bit-equal, 6 cache admissions (728 prefill tokens skipped,
        43 pages shared), K1/K2 launched 6 x 32 times fewer, no page in
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
     Then xlstm-1.3b (48 layers: 6 segments of 7 mLSTM + 1 sLSTM):
     c. `xlstm_forward`: model_forward on 4 x 128 tokens, three runs, K9
        launched 6 times per call, hidden states equal bit for bit;
     d. `xlstm_static`: generate() with 4 x 128 prompt tokens stepped
        through serve_step and 16 new tokens, three runs, tokens and
        logits equal bit for bit; profiles of the forward, 8 steps of
        the stepwise prefill and one decode step.
     Each path runs with the launch counts set to 0 just before it; K5R
     must run once per layer and decode step on llama's paths up to 64
     rows and never on granite's, xlstm's or `go_wide`, where K5 runs
     instead. The profiles
     give device events per layer.
Then one JSON line with every kernel's numbers, the card line again, and
the final {"ok": true, ...} line.
"""
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


def kernel_phase_full(torch, G, OPS, R, GT, cfg_granite):
    """bf16 at the main paths' full-width shapes: llama's expert-choice
    prefill plan, its GO decode layout at B 4 and at go_wide's B 72 (two
    tiles a lane, a block a lane), and granite's token-choice
    decode plan (4 tokens top-8 of 40 through one dispatch plan: 32 pairs
    in 2624 rows, nearly every tile invalid). Tolerances: K1 rounds its
    output to bf16, so rtol=atol=1e-2 (over one bf16 ulp, 2^-7 relative);
    K2 writes fp32 sums of bf16 products, rtol=atol=1e-4."""
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

    # granite decode: 4 rows routed top-8 of 40 by a random gate, through
    # the dispatch plan token_choice_decode builds, operands gathered as
    # moe_ffn_fused gathers them; the library call multiplies each valid
    # tile's rows by its expert's weights
    e = cfg_granite.moe
    Eg, Kg, Fg, kg = e.num_experts, cfg_granite.d_model, e.d_expert, e.top_k
    gran_w = bank(Eg, Kg, Fg)
    gate = torch.randn(Kg, Eg, device="cuda", generator=g) / Kg ** 0.5
    xt = torch.randn(Bq, Kg, device="cuda", generator=g).to(bf)
    r = R.token_choice(xt, gate, kg)
    plan = OPS.plan_tile_dispatch(r.expert_idx.reshape(-1), Eg, bn)
    tok = torch.arange(Bq, device="cuda").repeat_interleave(kg)
    rp = plan.row_pair.long()
    x = torch.cat([xt, xt.new_zeros((1, Kg))])[
        torch.cat([tok, tok.new_full((1,), Bq)])[rp]]
    sc = torch.cat([r.weights.reshape(-1), r.weights.new_zeros(1)])[rp][:, None]
    tv = plan.tile_valid
    valid = tv.nonzero()[:, 0]
    te = plan.tile_expert
    rows = int(plan.row_valid.sum())
    experts = int(torch.unique(te[tv]).numel())
    results["granite_decode"] = dict(
        te=te, tv=tv, x=x, sc=sc, rows=rows, experts=experts,
        n_rows=plan.n_pad, lib_x=x.view(plan.n_tiles, bn, Kg)[valid],
        lib_w=gran_w[3][te[valid].long()], lib_wo=gran_w[2][te[valid].long()],
        w=gran_w, K=Kg, F=Fg,
        shape=f"N_pad={plan.n_pad} ({plan.n_tiles} tiles, {int(tv.sum())} "
              f"valid), {rows} pairs on {experts} experts, K={Kg} F={Fg}")

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
                                                   "tiles_per_block"]},
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


def fused_phase_full(torch, G, OPS, MOE, R, TM, cfg):
    """K7 and K8 in bf16 at the full-width granite prefill plan: 4 x 128
    tokens routed top-8 of 40 by a random gate, each pair on its expert's
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
         f"K7 bf16 granite err {e1}")
    need(torch.allclose(y, yp, rtol=1e-4, atol=1e-4),
         f"K8 bf16 granite err {e2}")
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
                "tiles_per_block"]},
            bound_bytes(rows, experts, Kd, Fd, plan.n_pad, swiglu))
        del flush
        print(f"[kernels bf16 granite] {name}: {json.dumps(out[name])}",
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


def _paged_entry(torch, flush, kern, plain, lib, nbytes, flops, shape,
                 parent=None):
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    need(torch.allclose(got, ref, rtol=PAGED_TOL_BF16, atol=PAGED_TOL_BF16),
         f"paged attention bf16 err {err} ({shape})")
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
    print(f"[paged bf16] {json.dumps(entry)}", flush=True)
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
    except that token choice with C1 groups prefills through K7/K8."""
    L = cfg.num_layers
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


def smoke_phase(torch, G, GT, cfg_smoke, TM, TS):
    """Smoke-size slice on the CPU (plain versions) and on the card
    (kernels), same fp32 weights. Greedy tokens equal; logits within
    SMOKE_LOGIT_TOL; one prefill and 8 decode steps' grouped GEMMs
    launched, and K5R once per layer and decode step with a GO cache."""
    params = TM.model_init(cfg_smoke, torch.Generator().manual_seed(0), "cpu")
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
    params = TM.model_init(cfg_smoke, torch.Generator().manual_seed(0), "cpu")
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
        if cfg_smoke.moe.routing == "expert_choice":
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


def xlstm_full_phase(torch, counts, reset_counts, cfg, TM, TS):
    """Full-width xlstm-1.3b, bf16, random weights from a seeded generator
    on the card. `xlstm_forward`: model_forward on 4 x 128 tokens, a
    warm-up, then three runs (the first counted): K9 launched once per
    sLSTM block and no other kernel of the port, hidden states bit-equal.
    `xlstm_static`: generate() with the same 4 x 128 prompts stepped
    through serve_step and 16 new tokens, a warm-up, then three runs
    (the first counted): no kernel of the port launched, tokens and the
    logits that chose them bit-equal. Then the profiles (the prefill's over
    its first 8 steps)."""
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
    res = TS.generate(params, cfg, tokens, GEN, device="cuda")
    static_launches = counts()
    reps = [res] + [TS.generate(params, cfg, tokens, GEN, device="cuda")
                    for _ in range(2)]
    need(static_launches == zero, f"xlstm_static launches {static_launches}"
         ": the stepwise path runs no kernel of the port")
    need(res["tokens"].shape == (Bq, GEN) and
         bool(torch.isfinite(res["logits"]).all()),
         "xlstm_static: tokens of another shape or non-finite logits")
    repeat_equal = all(torch.equal(r["tokens"], res["tokens"]) and
                       torch.equal(r["logits"], res["logits"]) for r in reps)
    stats = {"prefill_ms_runs": [r["prefill_s"] * 1e3 for r in reps],
             "prefill_ms_per_step_runs": [r["prefill_s"] * 1e3 / P
                                          for r in reps],
             "decode_ms_per_token_runs": [r["decode_s"] * 1e3 / GEN
                                          for r in reps],
             "tok_per_s_runs": [r["tok_per_s"] for r in reps],
             "repeat_tokens_equal": repeat_equal,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": static_launches}
    print(f"[full xlstm_static] {cfg.name} bf16 B={Bq} prompt={P} "
          f"gen={GEN}: {json.dumps(stats)}", flush=True)
    print(f"[full xlstm_static] sample tokens {res['tokens'][0].tolist()}",
          flush=True)
    need(repeat_equal, "xlstm_static: three runs gave other tokens or "
         "logits")
    state = res["state"]
    tok = torch.zeros(Bq, dtype=torch.long, device="cuda")
    del reps, res
    # the prefill's profile covers its first 8 of 128 steps: each step is
    # one serve_step of the same work, and a trace of all 128 (~400k device
    # events) takes minutes to read back
    profile_phase(torch, cfg, {
        "forward": lambda: TM.model_forward(params, tokens, cfg),
        "stepwise_prefill_8_of_128_steps":
            lambda: TM.prefill(params, tokens[:, :8], cfg),
        "decode_step": lambda: TM.serve_step(params, state, tok, cfg)})
    return {"xlstm_forward": fwd_launches, "xlstm_static": static_launches}


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


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
                 kv_quant="none"):
    """Full width, bf16, through the continuous-batching engine on a paged
    pool: 8 staggered requests of ENGINE_LENS prompt tokens, 32 new tokens
    each, greedy. A warm-up engine first (one one-shot and one chunked
    admission, 4 tokens each), then the counted, timed run, one
    synchronised step at a time, then the same trace once more on a fresh
    engine, which must stream the same tokens and leave the same pool
    state. kv_quant="int8" runs the pool on int8 KV pages and GO rows
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
    rids = [eng.submit(p, ENGINE_GEN, arrival_step=a)
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

    L = cfg.num_layers
    fin = eng.finished
    for rid in rids:
        r = fin[rid]
        need(r.status == "DONE" and len(r.tokens) == ENGINE_GEN and
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
    again = ServingEngine(params, cfg, device="cuda", **pool)
    rids2 = [again.submit(p, ENGINE_GEN, arrival_step=a)
             for p, a in zip(prompts, ENGINE_ARRIVALS)]
    fin2 = again.run()
    # the streams' argmaxes can hide a changed sum; the drained pools'
    # pages (every layer's K/V of every token, which the MoE outputs of the
    # layers below feed), their scales and the GO rows must repeat bit for
    # bit as well (page 0, the null page, left out: _pool_state)
    repeat_state_equal = _same(torch, _pool_state(st),
                               _pool_state(again.pool.state))
    repeat_equal = all(fin2[r2].tokens == fin[r].tokens
                       for r, r2 in zip(rids, rids2))
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
          f"{ENGINE_LENS}, arrivals {ENGINE_ARRIVALS}, gen {ENGINE_GEN}: "
          f"{json.dumps(stats)}", flush=True)
    print(f"[full engine] sample tokens {fin[rids[1]].tokens}", flush=True)
    need(repeat_equal, f"{cfg.name}: the engine trace streamed other tokens "
         "when run again")
    need(repeat_state_equal, f"{cfg.name}: the engine trace left other KV "
         "pages, scales or GO rows when run again")
    engine_profile_phase(torch, cfg, params, prompts, ServingEngine, pool)
    stats["streams"] = [fin[r].tokens for r in rids]   # fault_domain's oracle
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
    eng.run()


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


def _timed_admissions(torch, eng, log):
    """Time each cold one-shot admission (`_admit`: the prefill, the install
    and, with sharing, the deposit's clones) and each cache admission
    (`_admit_from_cache`), synchronised, on the host clock."""
    def wrap(fn, key):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*a)
            torch.cuda.synchronize()
            log[key].append((time.perf_counter() - t0) * 1e3)
        return run
    eng._admit = wrap(eng._admit, "cold_ms")
    eng._admit_from_cache = wrap(eng._admit_from_cache, "cache_ms")


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
    if "gemm" in name.lower() or "xmma" in name or "cutlass" in name:
        return "cuBLAS gemm"
    return "other"


def profile_phase(torch, cfg, regions):
    """Where the time goes: torch.profiler over each region. Device busy
    time is the union of the card's kernel intervals; idle share = 1 -
    busy / host wall time of the region."""
    from torch.profiler import ProfilerActivity, profile
    for name, fn in regions.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
        by_kind = {}
        for e in dev:
            t = by_kind.setdefault(_kind(e.name), [0, 0.0])
            t[0] += 1
            t[1] += (e.time_range.end - e.time_range.start) / 1e3
        out = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
               "idle_share": 1 - busy / 1e3 / wall_ms if dev else None,
               "device_events": len(dev),
               "device_events_per_layer": len(dev) / cfg.num_layers,
               "by_kind_ms": {k: round(v[1], 4) for k, v in by_kind.items()},
               "by_kind_count": {k: v[0] for k, v in by_kind.items()}}
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
    cfgs = {m: get_config(m) for m in (llama, granite)}
    by_path = {}
    kernel_phase_small(torch, G)
    timings, llama_prefill = kernel_phase_full(torch, G, OPS, R, GT,
                                               cfgs[granite])
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
    paged_phase_small(torch, PA)
    decode_split_sweep(torch, PA)
    chunk_bf16_sweep(torch, PA)
    paged = {m: paged_phase_full(torch, PA, cfgs[m], ENGINE_POOL["page_size"],
                                 ENGINE_POOL["max_tokens"]) for m in cfgs}
    for name, entry in paged[llama].items():
        timings[name] = {**entry, "granite": paged[granite][name]}
    int8_small = paged_int8_phase_small(torch, PA, Q)
    paged = {m: paged_int8_phase_full(torch, PA, Q, cfgs[m],
                                      ENGINE_POOL["page_size"],
                                      ENGINE_POOL["max_tokens"]) for m in cfgs}
    for name, entry in paged[llama].items():
        body = "decode_split" if "decode" in name else "chunk_tc"
        timings[name] = {**entry, "granite": paged[granite][name],
                         "small_max_abs_err": int8_small,
                         "tol": {"fp32_q": PAGED_TOL_I8_F32,
                                 "bf16_q": PAGED_TOL_BF16},
                         "sass": {side: {k: c for k, c in by_kernel.items()
                                         if body in k}
                                  for side, by_kernel in sass.items()}}
    del paged
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
    xlstm = "xlstm-1.3b"
    xlstm_smoke_phase(torch, SC, get_config(xlstm, smoke=True), TM, TS)

    for m, short in ((llama, "llama"), (granite, "granite")):
        cfg = cfgs[m]
        t0 = time.perf_counter()
        params = TM.model_init(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        print(f"[full] {cfg.name}: {sum(t.numel() for t in _leaves(params))} "
              f"parameters initialised in {time.perf_counter() - t0:.2f} s",
              flush=True)
        by_path[f"{short}_static"] = full_phase(torch, G, PA, SC, GT, cfg,
                                                params, TM, TS)
        by_path[f"{short}_engine"], bf16_stats = engine_phase(
            torch, G, PA, SC, GT, cfg, params, ServingEngine)
        # slice 13: expert-aware admission on a trace it reorders
        by_path[f"{short}_expert_aware"] = expert_aware_phase(
            torch, cfg, params, ServingEngine, counts, reset_counts)
        if m == llama:
            # the same trace on int8 KV pages and GO rows (slice 8)
            by_path["llama_engine_int8"], i8_stats = engine_phase(
                torch, G, PA, SC, GT, cfg, params, ServingEngine, "int8")
            ratio = i8_stats["pool_page_bytes"] / bf16_stats["pool_page_bytes"]
            print(f"[full engine] {cfg.name}: int8 pool pages "
                  f"{i8_stats['pool_page_bytes']} B, bf16 "
                  f"{bf16_stats['pool_page_bytes']} B (ratio {ratio:.4f}); "
                  f"tok/s int8 {i8_stats['tok_per_s']:.2f}, bf16 "
                  f"{bf16_stats['tok_per_s']:.2f}", flush=True)
            need(0.45 < ratio < 0.55, f"int8 pool pages are {ratio:.3f} of "
                 "the bf16 pool's, not about half")
            # slice 12: the engine's fault domain, bf16 then int8 pages
            for kvq, st_ in (("none", bf16_stats), ("int8", i8_stats)):
                tag = "" if kvq == "none" else "_int8"
                by_path[f"fault_domain{tag}"] = fault_domain_phase(
                    torch, cfg, params, ServingEngine, Chaos, counts,
                    reset_counts, kvq, st_["streams"])
            # slice 13: copy-on-write prefix sharing, bf16 then int8 pages
            for kvq in ("none", "int8"):
                tag = "" if kvq == "none" else "_int8"
                by_path[f"prefix_share{tag}"] = prefix_share_phase(
                    torch, cfg, params, ServingEngine, Chaos, counts,
                    reset_counts, kvq, profile=True)
            # slice 14: the journal's crash classes, bf16 then int8 pages,
            # and a child process killed by SIGKILL
            for kvq in ("none", "int8"):
                tag = "" if kvq == "none" else "_int8"
                by_path[f"journal{tag}"] = journal_phase(
                    torch, cfg, params, ServingEngine, EngineJournal, counts,
                    reset_counts, kvq, card)
            journal_sigkill_phase(torch, cfg, params, ServingEngine, TS, card)
            # slice 11: the engine trace with prompt buckets and sampling,
            # and the static batch past K5R's 64 rows
            by_path["llama_engine_sampled"], _ = sampled_engine_phase(
                torch, G, PA, SC, GT, cfg, params, ServingEngine)
            by_path["go_wide"], timings["go_topk_update"] = go_wide_phase(
                torch, G, PA, SC, GT, cfg, params, TS, counts, reset_counts)
            timings["go_topk_update"]["b4"] = k5_small
        del params
        torch.cuda.empty_cache()

    by_path.update(xlstm_full_phase(torch, counts, reset_counts,
                                    get_config(xlstm), TM, TS))

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
            entry["decode"] = timings[name]["decode"]
            entry["granite_decode"] = timings[name]["granite_decode"]
            entry["wide_decode"] = timings[name]["wide_decode"]
        if "granite" in timings[name]:
            entry["granite"] = timings[name]["granite"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
