"""Residual attention blocks with the MoE sublayer on the expert-choice and
GO-cache path. Counterpart of repro/models/blocks.py (`attn_block`,
`attn_block_decode`) for the attention family with expert-choice MoE
(models/model.py:check_served rejects the rest).
"""
from __future__ import annotations

import torch

from repro_torch.core import moe as MOE
from repro_torch.core.go_cache import GOCache, go_cache_step
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
                      *, cfg, go_cache: GOCache, window: int = 0):
    """One-token decode, x_t [B, 1, d] -> (x, aux). The KV and GO caches
    (this layer's views of the decode state) are updated in place. Only the
    experts that select the token run, through go_selected_ffn."""
    h = rmsnorm(params["ln1"], x_t, cfg.norm_eps)
    a = ATT.attn_decode(params["attn"], h, cache_k, cache_v, t, cfg=cfg,
                        window=window)
    x = x_t + a
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)[:, 0]            # [B, d]
    moe_p = params["moe"]
    MOE.reject_shared(moe_p)
    res = go_cache_step(
        go_cache, h2, t, moe_p["gate"],
        contrib_fn=lambda xt, sel, g: OPS.go_selected_ffn(
            xt, sel, g, moe_p["experts"], cfg.moe.num_experts))
    return x + res.y[:, None, :], {"selected": res.selected}
