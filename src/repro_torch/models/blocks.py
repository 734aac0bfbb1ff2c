"""Residual attention blocks with the MoE sublayer on the expert-choice and
GO-cache path. Counterpart of repro/models/blocks.py (`attn_block`,
`attn_block_decode`, `attn_block_chunk`) for the attention family with
expert-choice MoE (models/model.py:check_served rejects the rest).
"""
from __future__ import annotations

import torch

from repro_torch.core import moe as MOE
from repro_torch.core.go_cache import (GOCache, go_cache_merge,
                                       go_cache_prefill, go_cache_step)
from repro_torch.kernels import ops as OPS
from repro_torch.models import attention as ATT
from repro_torch.models.layers import rmsnorm


def attn_block(params: dict, x: torch.Tensor, *, cfg,
               positions: torch.Tensor, window: int = 0,
               return_kv: bool = False):
    """Full-sequence block, x [B, S, d] -> (x, aux[, k, v]). The MoE
    sublayer routes per sequence but plans the whole batch's FFN pairs as
    one grouped GEMM (expert_choice_forward_batched)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a = ATT.attn_forward(params["attn"], h, cfg=cfg, positions=positions,
                         window=window, return_kv=return_kv)
    if return_kv:
        a, k, v = a
    x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    y, aux = MOE.expert_choice_forward_batched(params["moe"], h, cfg.moe)
    x = x + y
    if return_kv:
        return x, aux, k, v
    return x, aux


def attn_block_decode(params: dict, x_t: torch.Tensor, cache_k, cache_v, t,
                      *, cfg, go_cache: GOCache, window: int = 0,
                      block_table: torch.Tensor | None = None):
    """One-token decode, x_t [B, 1, d] -> (x, aux). The KV and GO caches
    (this layer's views of the decode state; with `block_table`, the KV is
    the layer's page pool) are updated in place. Only the experts that
    select the token run, through go_selected_ffn."""
    h = rmsnorm(params["ln1"], x_t, cfg.norm_eps)
    a = ATT.attn_decode(params["attn"], h, cache_k, cache_v, t, cfg=cfg,
                        window=window, block_table=block_table)
    x = x_t + a
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)[:, 0]            # [B, d]
    moe_p = params["moe"]
    MOE.reject_shared(moe_p)
    res = go_cache_step(
        go_cache, h2, t, moe_p["gate"],
        contrib_fn=lambda xt, sel, g: OPS.go_selected_ffn(
            xt, sel, g, moe_p["experts"], cfg.moe.num_experts))
    return x + res.y[:, None, :], {"selected": res.selected}


def attn_block_chunk(params: dict, x: torch.Tensor, cache_k, cache_v,
                     start: int, *, cfg, go_cache: GOCache, window: int = 0,
                     valid_len: int | None = None,
                     block_table: torch.Tensor | None = None):
    """Chunked-prefill block: append one prompt chunk (x [B, Cs, d] at
    positions start..start+Cs-1) to the KV cache (dense, or the layer's
    page pool with `block_table`), then run the MoE over the chunk. The
    chunk's expert-choice routing (capacity from the CHUNK length, pads at
    >= valid_len masked out) builds a per-chunk GO cache that merges into
    the accumulated one, `go_cache`, in place. Returns (x, aux)."""
    vl = x.shape[1] if valid_len is None else valid_len
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a = ATT.attn_chunk(params["attn"], h, cache_k, cache_v, start, cfg=cfg,
                       window=window, kv_len=start + vl,
                       block_table=block_table)
    x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    y, aux = MOE.expert_choice_forward_batched(params["moe"], h, cfg.moe,
                                               valid_len=vl)
    chunk_go = go_cache_prefill(None, None, aux["weighted_outputs"],
                                aux["chosen_tokens"] + start,
                                aux["chosen_scores"], cfg.moe.top_k)
    for dst, src in zip(go_cache, go_cache_merge(go_cache, chunk_go)):
        dst.copy_(src)
    return x + y, aux
