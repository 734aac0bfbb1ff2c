"""Language-model assembly, attention family.

Counterpart of repro/models/model.py for the static-batch serving path:

  model_init(cfg, generator, device)            -> params
  init_decode_state(cfg, batch, max_len, device) -> dense decode state
  prefill(params, tokens, cfg, max_len)         -> (state, last_logits)
  serve_step(params, state, tokens_t, cfg)      -> (logits, state)
  logits_from_hidden(params, x, cfg)            -> [.., V] fp32

Parameters keep the reference's nesting and its stacked layer axis
(`layers.{attn.{wq,wk,wv,wo}, ln1, ln2, moe.{gate, experts.{wg,wi,wo}}}`),
so `bridge.params_from_numpy` carries JAX weights across unchanged. Where
JAX scans over layers and carries the KV and GO caches through the scan,
the port loops over layers in Python and writes each layer's slice of the
caches in place.
"""
from __future__ import annotations

import torch

from repro_torch.core import moe as MOE
from repro_torch.core.go_cache import GOCache, go_cache_init, go_cache_prefill
from repro_torch.models import blocks as B
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       rmsnorm)


def layer_windows(cfg) -> list[int]:
    """Per-layer sliding-window spans (0 = global attention)."""
    return [cfg.sliding_window] * cfg.num_layers


def check_served(cfg) -> None:
    """Raise on a configuration the port does not serve yet: it serves the
    attention family with expert-choice MoE and the GO cache."""
    e = cfg.moe
    if cfg.block != "attn" or e is None or e.routing != "expert_choice" \
            or not e.go_cache:
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention blocks with expert-choice "
            "MoE and the GO cache so far; dense MLPs, token choice and the "
            "other families are ROADMAP.md Queue 1 items 4, 5 and 9")
    MOE.check_backend(e)


# ----------------------------------------------------------------------- init

def _stacked(n: int, make) -> torch.Tensor:
    """Stack n tensors from make() into one, one slice at a time (keeps the
    fp32 staging of a full-width init to one layer)."""
    first = make()
    out = torch.empty((n, *first.shape), dtype=first.dtype,
                      device=first.device)
    out[0] = first
    for i in range(1, n):
        out[i] = make()
    return out


def model_init(cfg, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's distributions, from `generator`
    (which must live on `device`)."""
    check_served(cfg)
    dt = dtype_of(cfg)
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    g = generator

    def dense(d_in, d_out, dtype=dt, lead=()):
        return _stacked(L, lambda: dense_init(g, d_in, d_out, dtype, device,
                                              lead))

    p = {"embed": embed_init(g, cfg.vocab_size, d, dt, device),
         "final_norm": {"scale": torch.ones(d, device=device)}}
    layers = {
        "ln1": {"scale": torch.ones((L, d), device=device)},
        "ln2": {"scale": torch.ones((L, d), device=device)},
        "attn": {"wq": dense(d, nq * hd), "wk": dense(d, nkv * hd),
                 "wv": dense(d, nkv * hd), "wo": dense(nq * hd, d)},
    }
    E, de = cfg.moe.num_experts, cfg.moe.d_expert
    layers["moe"] = {
        "gate": dense(d, E, torch.float32),
        "experts": {"wi": dense(d, de, lead=(E,)),
                    "wg": dense(d, de, lead=(E,)),
                    "wo": dense(de, d, lead=(E,))},
    }
    p["layers"] = layers
    return p


def layer_params(tree: dict, l: int) -> dict:
    """Layer l's parameters: views into the stacked layer axis."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


# ---------------------------------------------------------------------- heads

def logits_from_hidden(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Tied embeddings: x @ embed.T, returned in fp32."""
    return (x @ params["embed"].T.to(x.dtype)).float()


# --------------------------------------------------------------- decode state

def init_decode_state(cfg, batch: int, max_len: int, device) -> dict:
    """Zero dense decode state: KV rows [L, B, max_len, Hkv, hd], the
    per-layer GO caches [L, B, E, k, (d)], and the position `t` (an int:
    the static batch moves in lock step)."""
    check_served(cfg)
    dt = dtype_of(cfg)
    L = cfg.num_layers
    shp = (L, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim())
    e = cfg.moe
    return {"t": 0,
            "k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device),
            "go": go_cache_init(batch, e.num_experts, e.top_k, cfg.d_model,
                                dt, device, lead=(L,))}


def _layer_go(state: dict, l: int) -> GOCache:
    return GOCache(*(a[l] for a in state["go"]))


# -------------------------------------------------------------------- prefill

def prefill(params: dict, tokens: torch.Tensor, cfg, max_len: int = 0):
    """Full-sequence forward that fills the decode state: KV caches and, per
    layer, the GO cache from the expert-choice routing. tokens [B, S] ->
    (state, last-position logits [B, V] fp32)."""
    Bsz, S = tokens.shape
    dev = tokens.device
    state = init_decode_state(cfg, Bsz, max_len or 2 * S, dev)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    x = params["embed"][tokens]
    for l, w in enumerate(layer_windows(cfg)):
        x, aux, k, v = B.attn_block(layer_params(params["layers"], l), x,
                                    cfg=cfg, positions=positions, window=w,
                                    return_kv=True)
        state["k"][l, :, :S] = k
        state["v"][l, :, :S] = v
        go = go_cache_prefill(None, None, aux["weighted_outputs"],
                              aux["chosen_tokens"], aux["chosen_scores"],
                              cfg.moe.top_k)
        for dst, src in zip(_layer_go(state, l), go):
            dst.copy_(src)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params, x[:, -1, :], cfg)
    state["t"] = S
    return state, logits


# ----------------------------------------------------------------- serve step

def serve_step(params: dict, state: dict, tokens_t: torch.Tensor, cfg):
    """One decode step. tokens_t [B] -> (logits [B, V] fp32, state); the
    state's caches are updated in place."""
    t = state["t"]
    x = params["embed"][tokens_t][:, None, :]                     # [B, 1, d]
    for l, w in enumerate(layer_windows(cfg)):
        x, _ = B.attn_block_decode(
            layer_params(params["layers"], l), x, state["k"][l],
            state["v"][l], t, cfg=cfg, go_cache=_layer_go(state, l),
            window=w)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params, x[:, 0, :], cfg)
    state["t"] = t + 1
    return logits, state
