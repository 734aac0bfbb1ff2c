"""Residual blocks. Counterpart of repro/models/blocks.py (`_ffn_apply`,
`attn_block`, `attn_block_decode`, `attn_block_chunk`,
`cross_block_decode`) for the attention family: with an MoE sublayer
(expert choice with the GO cache, and token choice, dispatch or C1 group
multiplexing, without one) or with a dense MLP (`params["mlp"]`:
SwiGLU, models/layers.py `mlp`, or without `wg` the gelu MLP, whisper);
causal, bidirectional or cross attention over a memory; the xlstm family's
blocks are re-exported from models/xlstm.py, as the reference does, and
the Mamba2 blocks (`mamba2_block_init`, `mamba2_block`,
`mamba2_block_decode`) wrap models/ssm.py in a pre-norm residual.
models/model.py:check_served rejects the rest.
"""
from __future__ import annotations

import torch

from repro_torch.core import moe as MOE
from repro_torch.core.go_cache import (GOCache, go_cache_merge,
                                       go_cache_prefill, go_cache_step)
from repro_torch.kernels import ops as OPS
from repro_torch.models import attention as ATT
from repro_torch.models.layers import (dense_init, gelu_mlp, gelu_mlp_init,
                                       mlp, mlp_init, rmsnorm)
from repro_torch.models.ssm import mamba2_decode, mamba2_forward, mamba2_init
from repro_torch.models.xlstm import (mlstm_block, mlstm_block_init,  # noqa: F401
                                      slstm_block, slstm_block_init)


def attn_init(g: torch.Generator, cfg, dt, device, *,
              cross: bool = False) -> dict:
    """One attention sublayer's weights (attention.py:30's attn_init): wq,
    wk, wv, wo, and the zero QKV bias where cfg.qkv_bias asks for one,
    except on a cross-attention layer."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": dense_init(g, d, nq * hd, dt, device),
         "wk": dense_init(g, d, nkv * hd, dt, device),
         "wv": dense_init(g, d, nkv * hd, dt, device),
         "wo": dense_init(g, nq * hd, d, dt, device)}
    if cfg.qkv_bias and not cross:
        for key, width in (("bq", nq * hd), ("bk", nkv * hd),
                           ("bv", nkv * hd)):
            p[key] = torch.zeros(width, dtype=dt, device=device)
    return p


def attn_block_init(g: torch.Generator, cfg, dt, device, *,
                    cross: bool = False, gelu: bool = False) -> dict:
    """A dense attention block's weights (blocks.py:24's attn_block_init
    without MoE): ln1, attn, ln2 and the SwiGLU MLP, or with `gelu` the
    gelu MLP (whisper); `cross` takes no QKV bias."""
    d = cfg.d_model
    return {"ln1": {"scale": torch.ones(d, device=device)},
            "attn": attn_init(g, cfg, dt, device, cross=cross),
            "ln2": {"scale": torch.ones(d, device=device)},
            "mlp": (gelu_mlp_init if gelu else mlp_init)(g, d, cfg.d_ff, dt,
                                                         device)}


def _mlp(w: dict, h: torch.Tensor) -> torch.Tensor:
    """The dense MLP the params hold: SwiGLU, or gelu where there is no
    `wg` (whisper)."""
    return mlp(w, h) if "wg" in w else gelu_mlp(w, h)


def _ffn_apply(params: dict, x: torch.Tensor, cfg, group_of_expert=None,
               group_members=None, valid_len=None) -> tuple:
    """Post-attention FFN sublayer, x [B, S, d] -> (x + y, aux). The dense
    MLP gives aux None, as the reference's dense branch does.

    The grouped GEMM ("auto", "pallas") routes expert choice per sequence
    (pads at >= valid_len masked out) but plans the whole batch's pairs
    as one GEMM; token choice flattens B*S into one plan, pads included
    (their outputs land on pad rows only), as the reference's pallas
    backend does. "xla" runs each sequence on its own, as the reference
    vmaps it: routing, capacity and drops per sequence. Its expert-choice
    aux stacks the rows (what the GO cache reads); its token-choice aux
    sums `counts` and `dropped` and averages `balance_loss` over them."""
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if "mlp" in params:
        return x + _mlp(params["mlp"], h), None
    B, S, d = h.shape
    moe_p, e = params["moe"], cfg.moe
    if MOE.resolve_backend(e, (h, moe_p)) == "xla":
        outs = [MOE.expert_choice_forward(moe_p, h[b], e, valid_len)
                if e.routing == "expert_choice" else
                MOE.moe_forward(moe_p, h[b], e, group_of_expert,
                                group_members) for b in range(B)]
        y = torch.stack([o[0] for o in outs])
        auxes = [o[1] for o in outs]
        if e.routing == "expert_choice":
            return x + y, {k: torch.stack([a[k] for a in auxes])
                           for k in auxes[0]}
        return x + y, {
            "counts": torch.stack([a["counts"] for a in auxes]).sum(0),
            "balance_loss": torch.stack(
                [a["balance_loss"] for a in auxes]).mean(),
            "dropped": torch.stack([a["dropped"] for a in auxes]).sum()}
    if e.routing == "expert_choice":
        y, aux = MOE.expert_choice_forward_batched(moe_p, h, e,
                                                   valid_len=valid_len)
    else:
        y, aux = MOE.moe_forward(moe_p, h.reshape(B * S, d), e,
                                 group_of_expert, group_members)
        y = y.reshape(B, S, d)
    return x + y, aux


def attn_block(params: dict, x: torch.Tensor, *, cfg,
               positions: torch.Tensor, window: int = 0,
               causal: bool = True, group_of_expert=None,
               group_members=None, kv_source: torch.Tensor | None = None,
               use_rope: bool = True, return_kv: bool = False,
               valid_len: int | None = None):
    """Full-sequence block, x [B, S, d] -> (x, aux[, k, v]). `causal`,
    `kv_source` (cross attention over a memory) and `use_rope` go to
    attn_forward. `valid_len` (a bucketed prefill's real length) masks
    the right pads out of expert-choice routing (_ffn_apply)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a = ATT.attn_forward(params["attn"], h, cfg=cfg, positions=positions,
                         window=window, causal=causal, kv_source=kv_source,
                         use_rope=use_rope, return_kv=return_kv)
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
    go_plan_ffn; on "xla", the reference's dense fallback: all E experts
    over every row, masked); without one every row routes by token choice
    through the unfused grouped GEMM (on "xla", dispatch_forward at the
    worst-case capacity). Shared experts, where the config has them, add
    their output on both branches. A dense block runs its MLP (aux None)."""
    h = rmsnorm(params["ln1"], x_t, cfg.norm_eps)
    a = ATT.attn_decode(params["attn"], h, cache_k, cache_v, t, cfg=cfg,
                        window=window, block_table=block_table)
    x = x_t + a
    if "mlp" in params:
        return x + _mlp(params["mlp"], rmsnorm(params["ln2"], x,
                                               cfg.norm_eps)), None
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)[:, 0]            # [B, d]
    moe_p = params["moe"]
    if go_cache is None:
        y = MOE.token_choice_decode(moe_p, h2, cfg.moe)
        return x + y[:, None, :], None
    if MOE.resolve_backend(cfg.moe, (h2, moe_p)) == "xla":
        # the reference's dense fallback: every expert over every row
        res = go_cache_step(go_cache, h2, t, moe_p["gate"],
                            expert_fn=lambda xt: MOE.expert_ffn_all(moe_p, xt))
    else:
        res = go_cache_step(
            go_cache, h2, t, moe_p["gate"],
            bn=MOE.block_rows(cfg.moe, h2.device),
            contrib_fn=lambda xt, sel, g, plan: OPS.go_plan_ffn(
                xt, plan, moe_p["experts"]))
    y = MOE.add_shared(moe_p, res.y, h2)
    return x + y[:, None, :], {"selected": res.selected}


def attn_block_chunk(params: dict, x: torch.Tensor, cache_k, cache_v,
                     start: int, *, cfg, go_cache: GOCache | None = None,
                     window: int = 0, valid_len: int | None = None,
                     group_of_expert=None, group_members=None,
                     block_table: torch.Tensor | None = None):
    """Chunked-prefill block: append one prompt chunk (x [B, Cs, d] at
    positions start..start+Cs-1) to the KV cache (dense, or the layer's
    page pool with `block_table`), then run the FFN over the chunk. With a
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


def cross_block_decode(params: dict, x_t: torch.Tensor,
                       memory: torch.Tensor, *, cfg) -> torch.Tensor:
    """Cross-attention block decode, x_t [B, 1, d] -> x: attention over the
    fixed memory [B, M, d] (no cache grows), then the block's MLP."""
    h = rmsnorm(params["ln1"], x_t, cfg.norm_eps)
    x = x_t + ATT.cross_attn_decode(params["attn"], h, memory, cfg=cfg)
    return _ffn_apply(params, x, cfg)[0]


# ------------------------------------------------------------- mamba2 block

def mamba2_block_init(g: torch.Generator, cfg, device) -> dict:
    return {"ln": {"scale": torch.ones(cfg.d_model, device=device)},
            "mix": mamba2_init(g, cfg, device)}


def mamba2_block(params: dict, x: torch.Tensor, *, cfg) -> torch.Tensor:
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    return x + mamba2_forward(params["mix"], h, cfg=cfg)


def mamba2_block_decode(params: dict, x_t: torch.Tensor, state: dict, *,
                        cfg) -> tuple:
    """x_t [B, 1, d] -> (x, the new {"ssm", "conv"} state)."""
    h = rmsnorm(params["ln"], x_t, cfg.norm_eps)
    y, new_state = mamba2_decode(params["mix"], h, state, cfg=cfg)
    return x_t + y, new_state
