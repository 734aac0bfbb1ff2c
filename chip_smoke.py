#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (none catches an exception; any failure exits non-zero):
  0. the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc/ (timed).
  1. K1 gmm_swiglu and K2 gmm_scaled against their plain PyTorch versions:
     fp32 at small ragged shapes with invalid tiles, then bf16 at the main
     path's full-width shapes (prefill from a real expert-choice tile plan,
     decode on the [16*bn, 4096] selected-pair layout), with median times
     of kernel, plain version and one library call (`library_ms`).
  2. the slice end to end at smoke size: the same fp32 weights through
     generate() on the CPU (plain versions) and on the card (kernels).
  3. full width: llama_moe_4_16 in bf16, 4 requests x 128 prompt tokens,
     16 new tokens, with the kernels' launch counts from that run.
Then one JSON line with every kernel's numbers, the card line again, and
the final {"ok": true, ...} line.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

# Smoke logits, card vs CPU, both fp32. A sound run differs by ~4e-7 (sums
# in other orders, float atomics); a faulty kernel moves them by ~9e-4 (K2's
# row scale rounded to bf16) to ~0.6 (tests/test_torch_model.py's faults).
SMOKE_LOGIT_TOL = 1e-5


def need(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps=15):
    """Median of per-launch CUDA-event times; the L2 cache is flushed
    before each launch (the main path finds its weights cold)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(rows, experts, K, F, n_out_rows, swiglu):
    """Least time (ms) for the work this run's data needs: real rows and the
    weights of experts that own one, each read once; every output row
    written once. Returns (ms, "bytes" | "operations")."""
    streams = 2 if swiglu else 1
    out_bytes = n_out_rows * F * (2 if swiglu else 4)
    nbytes = rows * K * 2 + experts * streams * K * F * 2 + out_bytes
    flops = 2 * streams * rows * K * F
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


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


def kernel_phase_full(torch, G, OPS):
    """bf16 at the main path's full-width shapes. Tolerances: K1 rounds its
    output to bf16, so rtol=atol=1e-2 (over one bf16 ulp, 2^-7 relative);
    K2 writes fp32 sums of bf16 products, rtol=atol=1e-4."""
    bn, E, K, F = G.KERNEL_BLOCK_ROWS, 16, 4096, 688
    Bq, S, k = 4, 128, 4
    cap = S * k // E                                      # 32 per sequence
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(2)
    wg, wi = (torch.randn(E, K, F, device="cuda", generator=g).div_(
        K ** 0.5).to(bf) for _ in range(2))
    wo = torch.randn(E, F, K, device="cuda", generator=g).div_(F ** 0.5).to(bf)
    w_cat = torch.cat([wg, wi], dim=-1)                   # library yardstick
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
                              sc=sc, rows=rows, experts=experts,
                              n_rows=plan.n_pad, lib_x=x_runs, lib_w=w_cat,
                              lib_wo=wo, shape=f"N_pad={plan.n_pad}")

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
                             lib_wo=wo[sel_e].contiguous(),
                             shape=f"[{E}*{bn}, {K}], {int(counts.sum())} "
                                   f"selected pairs on {int(sel_e.numel())} "
                                   "experts")

    out = {"gmm_swiglu": {}, "gmm_scaled": {}}
    for phase, r in results.items():
        te, tv, x, sc = r["te"], r["tv"], r["x"], r["sc"]
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
        h_runs = torch.zeros(r["lib_x"].shape[0], r["lib_x"].shape[1], F,
                             dtype=bf, device="cuda")
        for name, kern, plain, lib, err, swiglu, Kd, Fd in [
            ("gmm_swiglu",
             lambda: G.gmm_swiglu(x, wg, wi, te, tv, bn=bn),
             lambda: G.gmm_swiglu_plain(x, wg, wi, te, tv, bn),
             lambda: torch.bmm(r["lib_x"], r["lib_w"]), e1, True, K, F),
            ("gmm_scaled",
             lambda: G.gmm_scaled(h, wo, te, tv, sc, bn=bn),
             lambda: G.gmm_scaled_plain(h, wo, te, tv, sc, bn),
             lambda: torch.bmm(h_runs, r["lib_wo"]), e2, False, F, K),
        ]:
            b_ms, b_by = bound(r["rows"], r["experts"], Kd, Fd, r["n_rows"],
                               swiglu)
            out[name][phase] = {
                "shape": r["shape"], "max_abs_err": err,
                "ms": time_ms(torch, kern, flush),
                "plain_ms": time_ms(torch, plain, flush),
                "library_ms": time_ms(torch, lib, flush),
                "bound_ms": b_ms, "bound_by": b_by}
            print(f"[kernels bf16 {phase}] {name} {r['shape']}: "
                  f"{json.dumps(out[name][phase])}", flush=True)
    return out


def smoke_phase(torch, G, cfg_smoke, TM, TS):
    """Smoke-size slice on the CPU (plain versions) and on the card
    (kernels), same fp32 weights. Greedy tokens equal; logits within
    SMOKE_LOGIT_TOL."""
    params = TM.model_init(cfg_smoke, torch.Generator().manual_seed(0), "cpu")
    params_cuda = _tree_to(params, "cuda")
    prompts = torch.randint(0, cfg_smoke.vocab_size, (4, 32),
                            generator=torch.Generator().manual_seed(1))
    r_cpu = TS.generate(params, cfg_smoke, prompts, 8, device="cpu")
    G.reset_launches()
    r_gpu = TS.generate(params_cuda, cfg_smoke, prompts, 8, device="cuda")
    launches = dict(G.LAUNCHES)
    err = (r_gpu["logits"].cpu() - r_cpu["logits"]).abs().max().item()
    need(launches["gmm_swiglu"] > 0 and launches["gmm_scaled"] > 0,
         f"smoke cuda run launched no kernel: {launches}")
    need(torch.equal(r_gpu["tokens"].cpu(), r_cpu["tokens"]),
         "greedy tokens differ between cpu and cuda")
    need(err <= SMOKE_LOGIT_TOL, f"smoke logits differ by {err}")
    print(f"[smoke] {cfg_smoke.name}: cpu and cuda greedy tokens equal "
          f"{r_cpu['tokens'][0].tolist()}, logits max_abs_err {err:.3e} "
          f"(tol {SMOKE_LOGIT_TOL:g}), cuda launches {launches}", flush=True)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def full_phase(torch, G, cfg, TM, TS):
    """Full-width llama_moe_4_16, bf16: 4 requests x 128 prompt tokens, 16
    new tokens. One warm-up generate(), then the counted, timed run and two
    repeats of it for the spread."""
    Bq, P, GEN = 4, 128, 16
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = TM.model_init(cfg, g, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (Bq, P), generator=g,
                            device="cuda")
    TS.generate(params, cfg, prompts, 2, device="cuda")          # warm-up
    torch.cuda.reset_peak_memory_stats()
    G.reset_launches()
    res = TS.generate(params, cfg, prompts, GEN, device="cuda")
    launches = dict(G.LAUNCHES)
    # two more identical runs: the spread of the host-bound times
    reps = [res] + [TS.generate(params, cfg, prompts, GEN, device="cuda")
                    for _ in range(2)]
    expect = cfg.num_layers * (1 + GEN)
    need(bool(torch.isfinite(res["logits"]).all()), "non-finite logits")
    need(res["tokens"].shape == (Bq, GEN), "token shape")
    need(launches == {"gmm_swiglu": expect, "gmm_scaled": expect},
         f"launch counts {launches}, expected {expect} each "
         f"({cfg.num_layers} layers x (1 prefill + {GEN} decode steps))")
    stats = {"params": sum(t.numel() for t in _leaves(params)),
             "init_s": init_s,
             "prefill_ms": res["prefill_s"] * 1e3,
             "decode_ms_per_token": res["decode_s"] * 1e3 / GEN,
             "tok_per_s": res["tok_per_s"],
             "prefill_ms_runs": [r["prefill_s"] * 1e3 for r in reps],
             "decode_ms_per_token_runs": [r["decode_s"] * 1e3 / GEN
                                          for r in reps],
             # index_add_ sums with float atomics: report, do not require
             "repeat_tokens_equal": all(torch.equal(r["tokens"], res["tokens"])
                                        for r in reps),
             "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(f"[full] {cfg.name} bf16 B={Bq} prompt={P} gen={GEN}: "
          f"{json.dumps(stats)}", flush=True)
    print(f"[full] sample tokens {res['tokens'][0].tolist()}", flush=True)
    profile_phase(torch, cfg, params, prompts, res["state"], TM)
    return launches


def profile_phase(torch, cfg, params, prompts, state, TM):
    """Where the time goes: torch.profiler over one full-width prefill and
    one decode step. Device busy time is the union of the card's kernel
    intervals; idle share = 1 - busy / host wall time of the region."""
    from torch.profiler import ProfilerActivity, profile
    tok = torch.zeros(prompts.shape[0], dtype=torch.long, device="cuda")
    regions = {
        "prefill": lambda: TM.prefill(params, prompts, cfg,
                                      max_len=prompts.shape[1] + 17),
        "decode_step": lambda: TM.serve_step(params, state, tok, cfg),
    }
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
            swiglu = "Lb1" in e.name or "true>" in e.name   # template arg
            kind = ("K1 gmm_swiglu" if "gmm_kernel" in e.name and swiglu
                    else "K2 gmm_scaled" if "gmm_kernel" in e.name
                    else "cuBLAS gemm" if ("gemm" in e.name.lower()
                                           or "xmma" in e.name
                                           or "cutlass" in e.name)
                    else "other")
            t = by_kind.setdefault(kind, [0, 0.0])
            t[0] += 1
            t[1] += (e.time_range.end - e.time_range.start) / 1e3
        out = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
               "idle_share": 1 - busy / 1e3 / wall_ms if dev else None,
               "device_events": len(dev),
               "by_kind_ms": {k: round(v[1], 4) for k, v in by_kind.items()},
               "by_kind_count": {k: v[0] for k, v in by_kind.items()}}
        print(f"[profile] {cfg.name} {name}: {json.dumps(out)}", flush=True)


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
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_gmm as G
    from repro_torch.kernels import ops as OPS
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as TM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    print(f"[card] {card}", flush=True)
    build_s = build.build_all()
    print(f"[build] kernels built in {build_s:.1f} s", flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    kernel_phase_small(torch, G)
    timings = kernel_phase_full(torch, G, OPS)
    torch.cuda.empty_cache()
    smoke_phase(torch, G, get_config("llama_moe_4_16", smoke=True), TM, TS)
    launches = full_phase(torch, G, get_config("llama_moe_4_16"), TM, TS)

    replaces = {"gmm_swiglu": "src/repro/kernels/moe_gmm.py:466",
                "gmm_scaled": "src/repro/kernels/moe_gmm.py:332"}
    kernels = []
    for name in ("gmm_swiglu", "gmm_scaled"):
        pre = timings[name]["prefill"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": pre["max_abs_err"], "ms": pre["ms"],
            "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
            "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
            "shape": "prefill " + pre["shape"],
            "decode": timings[name]["decode"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
