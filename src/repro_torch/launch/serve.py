"""Static-batch serving with KV + GO caches (the paper's generation path).

Counterpart of repro/launch/serve.py. Slice 1 ports the static batch:

  generate()   a fixed batch of requests moves lock-step from prefill to
               completion: prefill() fills the KV caches and the per-layer GO
               caches, then one serve_step() per generated token.

The continuous-batching engine is slice 2. Entry points run on the CUDA
card unless the caller names another device; without a card, asking for
CUDA raises.

  python -m repro_torch.launch.serve --arch llama_moe_4_16 --static \
      --batch 4 --prompt 128 --gen 16
  python -m repro_torch.launch.serve --arch llama_moe_4_16 --smoke --static \
      --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import model_init, prefill, serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params, cfg, prompts, gen_tokens: int, *, device=None,
             max_len: int = 0) -> dict:
    """Greedy decoding. prompts [B, T] -> tokens [B, gen_tokens], plus the
    logits that chose each token ([gen_tokens, B, V] fp32) and wall times.
    `max_len` sizes the KV cache (0 -> T + gen_tokens + 1). `params` must
    already live on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"generate() runs on {dev}")
    prompts = torch.as_tensor(prompts).to(dev)
    B, T = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    state, logits = prefill(params, prompts, cfg,
                            max_len=max_len or (T + gen_tokens + 1))
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    out, chose = [], []
    for _ in range(gen_tokens):
        out.append(tok)
        chose.append(logits)
        logits, state = serve_step(params, state, tok, cfg)
        tok = torch.argmax(logits, dim=-1)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--static", action="store_true",
                    help="static-batch generate() (the only ported mode)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.static:
        raise NotImplementedError(
            "continuous batching (ServingEngine on the paged pool) is slice 2 "
            "of the port (ROADMAP.md Queue 1 item 6); pass --static")
    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_init(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                            generator=gen, device=dev)
    res = generate(params, cfg, prompts, args.gen, device=dev)
    print(f"{cfg.name} on {dev}: prefill {res['prefill_s'] * 1e3:.1f} ms, "
          f"generated {tuple(res['tokens'].shape)} in "
          f"{res['decode_s']:.2f}s ({res['tok_per_s']:.1f} tok/s)")
    print("sample:", res["tokens"][0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
