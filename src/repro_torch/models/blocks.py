"""Residual blocks. Counterpart of repro/models/blocks.py (`_ffn_apply`,
`attn_block`, `attn_block_decode`, `attn_block_chunk`) for the attention
family with MoE: expert choice with the GO cache, and token choice
(dispatch, or C1 group multiplexing) without one; the xlstm family's
blocks are re-exported from models/xlstm.py, as the reference does.
models/model.py:check_served rejects the rest.
"""
from __future__ import annotations

import torch

from repro_torch.core import moe as MOE
from repro_torch.core.go_cache import (GOCache, go_cache_merge,
                                       go_cache_prefill, go_cache_step)
from repro_torch.kernels import ops as OPS
from repro_torch.models import attention as ATT
from repro_torch.models.layers import rmsnorm
from repro_torch.models.xlstm import (mlstm_block, mlstm_block_init,  # noqa: F401
                                      slstm_block, slstm_block_init)


def _ffn_apply(params: dict, x: torch.Tensor, cfg, group_of_expert=None,
               group_members=None, valid_len=None) -> tuple:
    """Post-attention MoE sublayer, x [B, S, d] -> (x + y, aux). Expert
    choice routes per sequence (pads at >= valid_len masked out) but plans
    the whole batch's pairs as one grouped GEMM. Token choice flattens
    B*S into one plan, pads included (their outputs land on pad rows only),
    as the reference's pallas backend does."""
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    B, S, d = h.shape
    if cfg.moe.routing == "expert_choice":
        y, aux = MOE.expert_choice_forward_batched(params["moe"], h, cfg.moe,
                                                   valid_len=valid_len)
    else:
        y, aux = MOE.moe_forward(params["moe"], h.reshape(B * S, d),
                                 cfg.moe, group_of_expert, group_members)
        y = y.reshape(B, S, d)
    return x + y, aux


def attn_block(params: dict, x: torch.Tensor, *, cfg,
               positions: torch.Tensor, window: int = 0,
               group_of_expert=None, group_members=None,
               return_kv: bool = False, valid_len: int | None = None):
    """Full-sequence block, x [B, S, d] -> (x, aux[, k, v]). `valid_len`
    (a bucketed prefill's real length) masks the right pads out of
    expert-choice routing (_ffn_apply)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a = ATT.attn_forward(params["attn"], h, cfg=cfg, positions=positions,
                         window=window, return_kv=return_kv)
    if return_kv:
        a, k, v = a
    x, aux = _ffn_apply(params, x + a, cfg, group_of_expert, group_members,
                        valid_len)
    if return_kv:
        return x, aux, k, v
    return x, aux


def attn_block_decode(params: dict, x_t: torch.Tensor, cache_k, cache_v, t,
                      *, cfg, go_cache: GOCache | None = None,
                      window: int = 0,
                      block_table: torch.Tensor | None = None):
    """One-token decode, x_t [B, 1, d] -> (x, aux). The KV cache (this
    layer's view of the decode state; with `block_table`, the layer's page
    pool) and the GO cache are updated in place. With a GO cache only the
    experts that select the token run (the router's lane plan through
    go_plan_ffn); without one every row routes by token choice through the
    unfused grouped GEMM."""
    h = rmsnorm(params["ln1"], x_t, cfg.norm_eps)
    a = ATT.attn_decode(params["attn"], h, cache_k, cache_v, t, cfg=cfg,
                        window=window, block_table=block_table)
    x = x_t + a
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)[:, 0]            # [B, d]
    moe_p = params["moe"]
    if go_cache is None:
        y = MOE.token_choice_decode(moe_p, h2, cfg.moe)
        return x + y[:, None, :], None
    MOE.reject_shared(moe_p)
    res = go_cache_step(
        go_cache, h2, t, moe_p["gate"], bn=MOE.block_rows(cfg.moe, h2.device),
        contrib_fn=lambda xt, sel, g, plan: OPS.go_plan_ffn(
            xt, plan, moe_p["experts"]))
    return x + res.y[:, None, :], {"selected": res.selected}


def attn_block_chunk(params: dict, x: torch.Tensor, cache_k, cache_v,
                     start: int, *, cfg, go_cache: GOCache | None = None,
                     window: int = 0, valid_len: int | None = None,
                     group_of_expert=None, group_members=None,
                     block_table: torch.Tensor | None = None):
    """Chunked-prefill block: append one prompt chunk (x [B, Cs, d] at
    positions start..start+Cs-1) to the KV cache (dense, or the layer's
    page pool with `block_table`), then run the MoE over the chunk. With a
    GO cache, the chunk's expert-choice routing (capacity from the CHUNK
    length, pads at >= valid_len masked out) builds a per-chunk GO cache
    that merges into `go_cache` in place. Token choice pools its capacity
    over the chunk's rows, pads included. Returns (x, aux)."""
    vl = x.shape[1] if valid_len is None else valid_len
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a = ATT.attn_chunk(params["attn"], h, cache_k, cache_v, start, cfg=cfg,
                       window=window, kv_len=start + vl,
                       block_table=block_table)
    x, aux = _ffn_apply(params, x + a, cfg, group_of_expert, group_members,
                        vl)
    if go_cache is not None:
        chunk_go = go_cache_prefill(None, None, aux["weighted_outputs"],
                                    aux["chosen_tokens"] + start,
                                    aux["chosen_scores"], cfg.moe.top_k)
        for dst, src in zip(go_cache, go_cache_merge(go_cache, chunk_go)):
            dst.copy_(src)
    return x, aux
