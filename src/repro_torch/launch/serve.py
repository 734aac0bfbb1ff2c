"""Serving entry points with KV (+ GO) caches (the paper's generation path).

Counterpart of repro/launch/serve.py. Two modes:

  generate()          static batch: a fixed batch of requests moves
                      lock-step from prefill to completion (prefill() fills
                      the KV caches and, for expert choice, the per-layer
                      GO caches, then one serve_step() per generated token);
                      greedy, or sampled at temperature 1 (greedy=False).
  serve_continuous()  continuous batching through serving.ServingEngine:
                      requests join mid-flight into free slots of a pooled
                      KV (+ GO) cache (dense rows or a paged pool, optionally
                      with chunked prefill) and retire on EOS or length,
                      or on a deadline, a cancel or a quarantine.
                      The CLI's default mode.

`--arch` takes llama_moe_4_16 (expert choice, GO cache),
granite-moe-3b-a800m (token choice on the C1 group path) and, with
--static only, xlstm-1.3b (mLSTM/sLSTM; prefill steps serve_step over the
prompt; the engine raises NotImplementedError for a recurrent family).

Entry points run on the CUDA card unless the caller names another device;
without a card, asking for CUDA raises.

  python -m repro_torch.launch.serve --arch llama_moe_4_16 --requests 8 \
      --slots 4 --paged --page-size 16 --chunk-prefill 128
  python -m repro_torch.launch.serve --arch llama_moe_4_16 --static \
      --batch 4 --prompt 128 --gen 16
  python -m repro_torch.launch.serve --arch llama_moe_4_16 --smoke \
      --paged --page-size 4 --chunk-prefill 8 --device cpu
  python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --smoke \
      --paged --page-size 4 --chunk-prefill 8 --device cpu
  python -m repro_torch.launch.serve --arch llama_moe_4_16 --smoke \
      --paged --page-size 8 --chunk-prefill 8 --kv-quant int8 --device cpu
  python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke --static \
      --device cpu
  # sampled requests (temperature, top-p; each seeded by its id) and
  # prompts padded to power-of-two buckets:
  python -m repro_torch.launch.serve --arch llama_moe_4_16 --smoke \
      --paged --page-size 4 --temperature 0.8 --top-p 0.9 --buckets \
      --device cpu
  # the fault domain: priority preemption, wall budgets, seeded chaos
  python -m repro_torch.launch.serve --arch llama_moe_4_16 --smoke \
      --paged --page-size 4 --num-pages 30 --preemption --chaos \
      --chaos-seed 3 --max-wall-s 30 --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import model_init, prefill, serve_step
from repro_torch.serving.chaos import Chaos
from repro_torch.serving.engine import ServingEngine, _sample_tokens


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params, cfg, prompts, gen_tokens: int, *, device=None,
             max_len: int = 0, greedy: bool = True,
             generator: torch.Generator | None = None) -> dict:
    """Static-batch decoding. prompts [B, T] -> tokens [B, gen_tokens], plus
    the logits that chose each token ([gen_tokens, B, V] fp32) and wall
    times. `max_len` sizes the KV cache (0 -> T + gen_tokens + 1). Greedy
    by default; `greedy=False` samples every token, the first included, at
    temperature 1 over the whole vocabulary through the engine's
    `_sample_tokens`, from B uniforms a token drawn from `generator` (a
    CPU torch.Generator; required). At batch 1 that is the engine's
    request at temperature 1.0, top_p 1.0, whose generator was seeded the
    same. `params` must already live on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"generate() runs on {dev}")
    if not greedy and generator is None:
        raise ValueError("generate(greedy=False) draws its uniforms from "
                         "`generator`: pass a CPU torch.Generator")
    prompts = torch.as_tensor(prompts).to(dev)
    B, T = prompts.shape
    ones = torch.ones(B, dtype=torch.float32, device=dev)

    def pick(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(B, generator=generator).to(dev)
        return _sample_tokens(logits, u, ones, ones)

    _sync(dev)
    t0 = time.perf_counter()
    state, logits = prefill(params, prompts, cfg,
                            max_len=max_len or (T + gen_tokens + 1))
    tok = pick(logits)
    _sync(dev)
    t1 = time.perf_counter()
    out, chose = [], []
    for i in range(gen_tokens):
        out.append(tok)
        chose.append(logits)
        logits, state = serve_step(params, state, tok, cfg)
        if i + 1 < gen_tokens:        # pick only the tokens that are emitted
            tok = pick(logits)
    _sync(dev)
    t2 = time.perf_counter()
    return {
        "tokens": torch.stack(out, dim=1).to(torch.int32),
        "logits": torch.stack(chose),
        "prefill_s": t1 - t0,
        "decode_s": t2 - t1,
        "tok_per_s": B * gen_tokens / max(t2 - t1, 1e-9),
        "state": state,
    }


def serve_continuous(params, cfg, prompts: list, gen_tokens: int, *,
                     num_slots: int, max_tokens: int = 0,
                     arrival_steps: list | None = None, paged: bool = False,
                     page_size: int = 16, num_pages: int | None = None,
                     prefill_chunk: int = 0, priorities: list | None = None,
                     kv_quant: str | None = None, temperature: float = 0.0,
                     top_p: float = 1.0, prompt_buckets: bool = False,
                     preemption: bool = False, chaos=None,
                     deadline_s: float | None = None,
                     max_wall_s: float | None = None,
                     device=None) -> dict:
    """Run a list of prompts through the continuous-batching engine.
    `paged` swaps the dense slot rows for the block-table page pool
    (`page_size`, `num_pages`: None keeps the dense token capacity);
    `prefill_chunk` admits long prompts one chunk per tick; `priorities`
    orders admission (lower first, FIFO within a level); `kv_quant`
    "int8" stores the paged pool's KV pages and GO rows as int8 (None keeps
    cfg's mode). `temperature` > 0 samples with top-p nucleus filtering
    (each request seeded by its id); `prompt_buckets` pads one-shot
    prompts to power-of-two buckets. `preemption` lets a blocked
    higher-priority admission evict lower-priority streams (paged pools;
    they resume bit-identically); `chaos` injects seeded faults
    (serving/chaos.py); `deadline_s` / `max_wall_s` bound every request's
    wall clock (TIMEOUT past them). `max_tokens` 0 derives the pool's
    capacity from the longest prompt, rounded up to a multiple of the page
    size and the chunk. Returns the token stream of every request by id
    (a request that ends in another status than DONE keeps its partial
    stream), the wall time and the engine's stats."""
    max_tokens = max_tokens or (
        max(len(p) for p in prompts) + gen_tokens + 1)
    grain = math.lcm(page_size if paged else 1,
                     prefill_chunk if prefill_chunk else 1)
    max_tokens += -max_tokens % grain
    eng = ServingEngine(params, cfg, num_slots=num_slots,
                        max_tokens=max_tokens, paged=paged,
                        page_size=page_size, num_pages=num_pages,
                        prefill_chunk=prefill_chunk, kv_quant=kv_quant,
                        prompt_buckets=prompt_buckets,
                        preemption=preemption, chaos=chaos, device=device)
    ids = [eng.submit(p, gen_tokens,
                      arrival_step=arrival_steps[i] if arrival_steps else 0,
                      priority=priorities[i] if priorities else 0,
                      temperature=temperature, top_p=top_p,
                      deadline_s=deadline_s, max_wall_s=max_wall_s)
           for i, p in enumerate(prompts)]
    _sync(eng.device)
    t0 = time.perf_counter()
    fin = eng.run()
    _sync(eng.device)
    dt = time.perf_counter() - t0
    toks = {rid: np.asarray(fin[rid].tokens, np.int32) for rid in ids}
    return {
        "tokens": toks,
        "decode_s": dt,
        "tok_per_s": sum(len(t) for t in toks.values()) / max(dt, 1e-9),
        "stats": eng.stats(),
        "engine": eng,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--static", action="store_true",
                    help="static-batch generate() instead of the engine")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size for --static")
    ap.add_argument("--requests", type=int, default=8,
                    help="request count for the engine")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool: block-table pages instead of dense "
                         "per-slot rows")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (with --paged)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size incl. the null page (0 = the dense "
                         "pool's token capacity)")
    ap.add_argument("--chunk-prefill", type=int, default=0,
                    help="admit prompts longer than this one chunk per tick "
                         "(0 = one-shot prefill)")
    ap.add_argument("--kv-quant", default="none", choices=("none", "int8"),
                    help="store the paged pool's KV pages and GO rows as "
                         "int8 with per-page / per-row scales (needs "
                         "--paged and a page size divisible by 8)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature of the engine's requests "
                         "(0 = greedy, the default)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (with --temperature > 0)")
    ap.add_argument("--buckets", action="store_true",
                    help="pad one-shot prompts to power-of-two buckets "
                         "(prefill with the real length as valid_len)")
    ap.add_argument("--priority", type=int, default=0,
                    help="admission priority of the submitted requests "
                         "(lower = admitted first; FIFO within a level)")
    ap.add_argument("--preemption", action="store_true",
                    help="let blocked higher-priority admissions evict "
                         "lower-priority streams (paged pools; evicted "
                         "streams resume bit-identically)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request wall budget from submission "
                         "(0 = unbounded; exceeded -> status TIMEOUT)")
    ap.add_argument("--max-wall-s", type=float, default=0.0,
                    help="per-request wall budget from first admission "
                         "(0 = unbounded; exceeded -> status TIMEOUT)")
    ap.add_argument("--chaos", action="store_true",
                    help="seeded fault injection: transient tick failures, "
                         "admission pressure, forced preemptions "
                         "(serving/chaos.py)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.static and (args.temperature > 0 or args.buckets):
        ap.error("--temperature and --buckets drive the engine; the static "
                 "path decodes greedily (drop --static)")
    engine_only = (args.preemption or args.chaos or args.deadline_s
                   or args.max_wall_s)
    if args.static and engine_only:
        ap.error("--preemption, --chaos, --deadline-s and --max-wall-s "
                 "drive the engine (drop --static)")
    if args.preemption and not args.paged:
        ap.error("--preemption needs --paged (eviction snapshots are "
                 "block-table surgery)")
    if args.kv_quant != "none" and not args.paged:
        ap.error("--kv-quant int8 needs --paged (scale granularity is page "
                 "granularity)")
    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(cfg, gen, dev)
    if args.static:
        prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                                generator=gen, device=dev)
        res = generate(params, cfg, prompts, args.gen, device=dev)
        print(f"{cfg.name} on {dev}: prefill {res['prefill_s'] * 1e3:.1f} ms, "
              f"generated {tuple(res['tokens'].shape)} in "
              f"{res['decode_s']:.2f}s ({res['tok_per_s']:.1f} tok/s)")
        print("sample:", res["tokens"][0, :16].tolist())
        return res

    chaos = None
    if args.chaos:
        chaos = Chaos(seed=args.chaos_seed, tick_fail=0.05, pressure=0.05,
                      preempt=0.05)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt,
                            dtype=np.int32) for _ in range(args.requests)]
    # staggered arrivals: one new request every other engine tick
    arrivals = [2 * i for i in range(args.requests)]
    res = serve_continuous(params, cfg, prompts, args.gen,
                           num_slots=args.slots, arrival_steps=arrivals,
                           paged=args.paged, page_size=args.page_size,
                           num_pages=args.num_pages or None,
                           prefill_chunk=args.chunk_prefill,
                           priorities=[args.priority] * len(prompts),
                           kv_quant=args.kv_quant,
                           temperature=args.temperature, top_p=args.top_p,
                           prompt_buckets=args.buckets,
                           preemption=args.preemption, chaos=chaos,
                           deadline_s=args.deadline_s or None,
                           max_wall_s=args.max_wall_s or None, device=dev)
    s = res["stats"]
    print(f"{cfg.name} on {dev}: served {s['finished']} requests over "
          f"{s['steps']} ticks on {args.slots} slots in "
          f"{res['decode_s']:.2f}s ({res['tok_per_s']:.1f} tok/s)"
          + (f" [paged ps={s['page_size']} pages={s['num_pages']}]"
             if s["paged"] else "")
          + (f" [{s['kv_quant_dtype']} pages, dequant max err "
             f"{s['dequant_max_abs_err']:.3g}]" if s["kv_quant_dtype"]
             else "")
          + (f" [chunk ticks {s['chunk_ticks']}]" if s["chunk_ticks"] else "")
          + (f" [temperature {args.temperature:g}, top_p {args.top_p:g}]"
             if args.temperature > 0 else "")
          + (f" [prefill lengths {s['prefill_lengths']}]" if args.buckets
             else ""))
    print(f"statuses: {s['statuses']}  preemptions: {s['preemptions']} "
          f"(resumes {s['resumes']})  tick retries: {s['tick_retries']}"
          + (f"  chaos: {s['chaos']} ({chaos.describe()})" if chaos
             else ""))
    print("sample:", res["tokens"][min(res["tokens"])][:16].tolist())
    return res


if __name__ == "__main__":
    main()
