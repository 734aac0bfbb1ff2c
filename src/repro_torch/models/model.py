"""Language-model assembly: the attention family, with MoE or the dense
SwiGLU MLP, xlstm, the Mamba2 hybrid (zamba2) and the cross-attention
families (whisper's encoder-decoder, llama-vision's cross layers).

Counterpart of repro/models/model.py for the serving paths:

  model_init(cfg, generator, device)            -> params
  model_forward(params, tokens, cfg, extras)    -> (x_final, aux_loss)
  chunked_xent(params, x, labels, cfg)          -> (sum_loss, count)
  loss_fn(params, batch, cfg)                   -> (loss, metrics)
  init_decode_state(cfg, batch, max_len, device, extras=, per_slot_t=,
                    paged=)                     -> dense or paged state
  init_decode_slot / write_decode_slot          -> reset / fill one pool row
  prefill(params, tokens, cfg, max_len, valid_len=, extras=)
                                                -> (state, last_logits)
  prefill_chunk(params, state, tokens, cfg, start, valid_len)
                                                -> (state, chunk logits)
  serve_step(params, state, tokens_t, cfg)      -> (logits, state)
  logits_from_hidden(params, x, cfg)            -> [.., V] fp32

Parameters keep the reference's nesting and its stacked layer axes
(`layers.{attn.{wq,wk,wv,wo}, ln1, ln2, moe.{gate, experts.{wg,wi,wo},
shared.{wg,wi,wo}}}`, `shared` only with always-on shared experts,
`attn.{bq,bk,bv}` only with cfg.qkv_bias; a dense block holds
`mlp.{wi,wg,wo}` in place of `moe`;
xlstm: `mlayers` [n_seg, n_m, ...] and `slayers` [n_seg, ...]; zamba2:
`layers.{ln, mix.{in_proj, conv_w, conv_b, A_log, D, dt_bias, out_proj,
norm_scale}}` [L, ...] and ONE `shared_attn` attention block with the
dense SwiGLU MLP, applied after every `attn_every`-th Mamba2 layer;
whisper: `pos_embed` [40960, d], `encoder` [E, ...] of bidirectional
blocks with the gelu MLP (`mlp.{wi,wo}`), `dec_self` [L, ...] of
`{ln1, attn}` (no MLP), `dec_cross` [L, ...] of cross-attention blocks
with the gelu MLP, `enc_norm`; llama-vision: `layers` [n_sup, n_self, ...]
and `cross_layers` [n_sup, ...], a superblock of cross_attn_every - 1
self-attention layers and one cross layer), so
`bridge.params_from_numpy` carries JAX weights across unchanged. Where
JAX scans over layers and carries the KV and GO caches (or the recurrent
states) through the scan, the port loops over layers in Python and writes
each layer's slice of the decode state in place. The decode state holds GO
rows only for expert choice with the GO cache; token choice keeps none, as
in the reference. Recurrent families prefill by stepping serve_step, as
the reference does, and keep dense per-row state only (no pages): the
engine's pool admits and retires their rows through init_decode_slot and
write_decode_slot like any other.

The cross-attention families read a per-request memory: `model_forward`
takes `extras["audio_frames"]` (whisper; its encoder runs there, without
RoPE, bidirectional) or `extras["image_embeds"]` (llama-vision), while
the decode state holds `memory` [B, M, d], memory already encoded, from
`extras["memory"]` (zeros without one), which every decode step's cross
layers read (their K and V are projected from it at every step, as in
the reference). Their KV rows are dense only: whisper [L, B, max_len,
...], llama-vision [n_sup * n_self, ...] by the flat self-layer index.
whisper prefills by stepping serve_step, llama-vision in one pass.

Training (`loss_fn`, the attention family) differentiates through
`model_forward`: the MoE layer on its "xla" realization (`_training_cfg`
pins "auto" to it, as the reference does), attention through
`sdpa_flash`'s chunk-streamed backward. With cfg.remat every layer and
every cross-entropy chunk runs under torch.utils.checkpoint (the
reference's jax.checkpoint): the backward recomputes its forward, which
makes the same routing decisions, since every op on the path gives the
same bits on every run (the gathers' gradients through
models/layers.py `take_rows`).

A paged state with cfg.kv_quant="int8" (core/quant.py) holds int8 pages
with `k_scales`/`v_scales` [L, NP, Hkv] f32 and int8 GO outputs with
`go_scales` [L, B, E, k] f32. Each decode layer dequantizes its GO rows to
f32 before the block and requantizes them after it; a chunked prefill's
own batch-1 GO cache stays full precision and quantizes once, at
write_decode_slot.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import moe as MOE
from repro_torch.core import quant as Q
from repro_torch.core.grouping import (default_groups,
                                       group_of_expert_from_groups)
from repro_torch.core.go_cache import (GOCache, go_cache_init,
                                       go_cache_init_slot, go_cache_prefill,
                                       go_cache_write_slot)
from repro_torch.models import attention as ATT
from repro_torch.models import blocks as B
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       mlp_init, rmsnorm, take_rows)


def layer_windows(cfg) -> list[int]:
    """Per-layer sliding-window spans (0 = global attention). With
    local_global_ratio r every (r + 1)-th layer is global and the others
    attend within sliding_window (gemma3: 5 local, then 1 global); without
    it every layer takes sliding_window."""
    r = cfg.local_global_ratio
    if r > 0:
        return [0 if l % (r + 1) == r else cfg.sliding_window
                for l in range(cfg.num_layers)]
    return [cfg.sliding_window] * cfg.num_layers


def check_served(cfg) -> None:
    """Raise on a configuration the port does not serve yet: it serves the
    xlstm family, the Mamba2 hybrid (zamba2, whose shared attention block
    runs the dense SwiGLU MLP) and the attention family with a dense MLP
    (no MoE, d_ff > 0: SwiGLU, or whisper's gelu MLP; the cross-attention
    families whisper and llama-vision among them) or with an MoE sublayer,
    either expert choice with the GO cache or token choice, with or
    without always-on shared experts, on either MoE realization."""
    if cfg.block == "xlstm" or (cfg.block == "mamba2" and cfg.moe is None):
        return
    e = cfg.moe
    if cfg.block == "attn" and e is None and cfg.d_ff > 0:
        return
    if cfg.block != "attn" or e is None or e.routing not in (
            "expert_choice", "token_choice") or (
            e.routing == "expert_choice" and not e.go_cache):
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention blocks with the dense "
            "SwiGLU MLP or with MoE (expert choice with the GO cache, or "
            "token choice) so far; expert choice without the GO cache and "
            "the other families are ROADMAP.md Queue 1 items 4 and 9")
    MOE.resolve_backend(e)


@functools.lru_cache(maxsize=None)
def _moe_deployment(moe_cfg) -> tuple[np.ndarray, np.ndarray]:
    """Deployment-time C2 artifacts, once per MoE config (host numpy): the
    [E] group-id map and the [G, g] member matrix of `default_groups`."""
    groups = default_groups(moe_cfg)
    return (group_of_expert_from_groups(groups).astype(np.int32),
            np.asarray(groups, np.int32))


@functools.lru_cache(maxsize=None)
def _deployment_on(moe_cfg, device: str) -> tuple[torch.Tensor, ...]:
    """The deployment's tensors on `device`, copied there once."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _moe_deployment(moe_cfg))


def expert_groups(cfg, device) -> torch.Tensor:
    """C2 grouping -> [E] group id per expert, on `device`."""
    return _deployment_on(cfg.moe, str(torch.device(device)))[0]


def expert_group_members(cfg, device) -> torch.Tensor:
    """C2 grouping -> [G, g] expert ids per group, on `device`."""
    return _deployment_on(cfg.moe, str(torch.device(device)))[1]


def _groups(cfg, device) -> dict:
    """The group map and members a block's token-choice MoE reads (none for
    expert choice or a dense MLP)."""
    if cfg.moe is None or cfg.moe.routing == "expert_choice":
        return {}
    return {"group_of_expert": expert_groups(cfg, device),
            "group_members": expert_group_members(cfg, device)}


def _xlstm_segments(cfg) -> tuple[int, int]:
    """(num_segments, mlstm_per_segment); an sLSTM closes each segment."""
    if cfg.slstm_every <= 0:
        return 1, cfg.num_layers
    if cfg.num_layers % cfg.slstm_every:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} is not a "
                         f"multiple of slstm_every={cfg.slstm_every}")
    return cfg.num_layers // cfg.slstm_every, cfg.slstm_every - 1


def _vlm_segments(cfg) -> tuple[int, int]:
    """(superblocks, self-attention layers in each): llama-vision's
    num_layers is n_sup x cross_attn_every, each superblock's last layer a
    cross layer."""
    every = cfg.cross_attn_every
    if cfg.num_layers % every:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} is not a "
                         f"multiple of cross_attn_every={every}")
    return cfg.num_layers // every, every - 1


def _zamba_segments(cfg) -> tuple[int, int]:
    """(applications of the shared attention block, Mamba2 layers before
    each); the num_layers - n_app * seg layers past the last application
    run after it."""
    if cfg.attn_every <= 0:
        return 0, cfg.num_layers
    return cfg.num_layers // cfg.attn_every, cfg.attn_every


def _shared_attn_after(l: int, cfg) -> int | None:
    """The shared attention application that follows Mamba2 layer l (its
    index, which picks its KV rows), or None."""
    n_app, seg = _zamba_segments(cfg)
    if n_app and l % seg == seg - 1 and l // seg < n_app:
        return l // seg
    return None


# ----------------------------------------------------------------------- init

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn, a, b) -> None:
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def _stacked(n: int, make):
    """Stack n tensors (or dicts of them) from make() leaf by leaf into a
    leading axis of size n, one make() at a time (keeps the fp32 staging of
    a full-width init to one layer)."""
    first = make()
    out = _tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    for i in range(n):
        _tree_zip(lambda dst, src: dst[i].copy_(src), out,
                  first if i == 0 else make())
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
    if cfg.block == "attn" and cfg.encoder_layers > 0:
        # whisper; the position table is sized for the reference's
        # decode_32k cell
        p["pos_embed"] = (torch.randn((40960, d), generator=g, device=device,
                                      dtype=torch.float32) * 0.02).to(dt)
        p["encoder"] = _stacked(cfg.encoder_layers, lambda: B.attn_block_init(
            g, cfg, dt, device, gelu=True))
        p["dec_self"] = _stacked(L, lambda: {
            "ln1": {"scale": torch.ones(d, device=device)},
            "attn": B.attn_init(g, cfg, dt, device)})
        p["dec_cross"] = _stacked(L, lambda: B.attn_block_init(
            g, cfg, dt, device, cross=True, gelu=True))
        p["enc_norm"] = {"scale": torch.ones(d, device=device)}
        return p
    if cfg.block == "attn" and cfg.cross_attn_every > 0:
        n_sup, n_self = _vlm_segments(cfg)
        p["layers"] = _stacked(n_sup, lambda: _stacked(
            n_self, lambda: B.attn_block_init(g, cfg, dt, device)))
        p["cross_layers"] = _stacked(n_sup, lambda: B.attn_block_init(
            g, cfg, dt, device, cross=True))
        return p
    if cfg.block == "xlstm":
        n_seg, n_m = _xlstm_segments(cfg)
        p["mlayers"] = _stacked(n_seg, lambda: _stacked(
            n_m, lambda: B.mlstm_block_init(g, cfg, dt, device)))
        p["slayers"] = _stacked(
            n_seg, lambda: B.slstm_block_init(g, cfg, dt, device))
        return p
    if cfg.block == "mamba2":
        p["layers"] = _stacked(L, lambda: B.mamba2_block_init(g, cfg, device))
        if cfg.attn_every > 0:
            # one block, its weights shared by every application
            p["shared_attn"] = {
                "ln1": {"scale": torch.ones(d, device=device)},
                "ln2": {"scale": torch.ones(d, device=device)},
                "attn": {"wq": dense_init(g, d, nq * hd, dt, device),
                         "wk": dense_init(g, d, nkv * hd, dt, device),
                         "wv": dense_init(g, d, nkv * hd, dt, device),
                         "wo": dense_init(g, nq * hd, d, dt, device)},
                "mlp": mlp_init(g, d, cfg.d_ff, dt, device)}
        return p
    layers = {
        "ln1": {"scale": torch.ones((L, d), device=device)},
        "ln2": {"scale": torch.ones((L, d), device=device)},
        "attn": {"wq": dense(d, nq * hd), "wk": dense(d, nkv * hd),
                 "wv": dense(d, nkv * hd), "wo": dense(nq * hd, d)},
    }
    if cfg.qkv_bias:
        # zeros, as the reference initialises them
        for key, width in (("bq", nq * hd), ("bk", nkv * hd),
                           ("bv", nkv * hd)):
            layers["attn"][key] = torch.zeros((L, width), dtype=dt,
                                              device=device)
    if cfg.moe is None:
        layers["mlp"] = _stacked(L, lambda: mlp_init(g, d, cfg.d_ff, dt,
                                                     device))
        p["layers"] = layers
        return p
    E, de = cfg.moe.num_experts, cfg.moe.d_expert
    layers["moe"] = {
        "gate": dense(d, E, torch.float32),
        "experts": {"wi": dense(d, de, lead=(E,)),
                    "wg": dense(d, de, lead=(E,)),
                    "wo": dense(de, d, lead=(E,))},
    }
    S = cfg.moe.num_shared_experts
    if S:
        layers["moe"]["shared"] = {"wi": dense(d, de, lead=(S,)),
                                   "wg": dense(d, de, lead=(S,)),
                                   "wo": dense(de, d, lead=(S,))}
    p["layers"] = layers
    return p


def layer_params(tree: dict, l: int) -> dict:
    """Layer l's parameters: views into the stacked layer axis (the first
    one; apply twice for two stacked axes, llama-vision's and xlstm's)."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


# -------------------------------------------------------------------- forward

def model_forward(params: dict, tokens: torch.Tensor, cfg,
                  extras: dict | None = None):
    """tokens [B, S] -> (x_final [B, S, d] normalized, aux balance loss: the
    sum over layers of each token-choice MoE layer's balance loss, a zero
    fp32 scalar for expert choice, the dense MLP and the recurrent and
    cross-attention families). xlstm runs each sLSTM block's whole
    sequence in one K9 launch on a card; zamba2 runs the chunked SSD scan
    in plain PyTorch. whisper reads `extras["audio_frames"]` [B, F, d] and
    llama-vision `extras["image_embeds"]` [B, I, d], tensors on the
    tokens' device in the weights' dtype."""
    check_served(cfg)
    extras = extras or {}
    x = take_rows(params["embed"], tokens)
    if cfg.block == "xlstm":
        return _fwd_xlstm(params, x, cfg)
    if cfg.block == "attn" and cfg.encoder_layers > 0:
        return _fwd_whisper(params, x, cfg, extras["audio_frames"])
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    if cfg.block == "mamba2":
        return _fwd_zamba(params, x, positions, cfg)
    if cfg.cross_attn_every > 0:
        return _fwd_vlm(params, x, positions, cfg, extras["image_embeds"])
    return _fwd_attn(params, x, positions, cfg)


def _unbind(tree, n: int) -> list:
    """A stacked layer tree -> n per-layer trees. One unbind a leaf, so
    the backward stacks each leaf's layer gradients once (indexing layer
    by layer would add a zero-filled copy of the whole leaf per layer)."""
    if isinstance(tree, dict):
        sub = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: sub[k][i] for k in sub} for i in range(n)]
    return list(torch.unbind(tree))


def _attn_layer(lp: dict, x: torch.Tensor, positions: torch.Tensor,
                window: int, cfg, groups: dict):
    """One attention block -> (x, the layer's balance loss or zero)."""
    x, aux = B.attn_block(lp, x, cfg=cfg, positions=positions, window=window,
                          **groups)
    if aux is not None and "balance_loss" in aux:
        return x, aux["balance_loss"].sum()
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _remat(fn, cfg, *args):
    """fn(*args), under torch.utils.checkpoint where cfg.remat asks for it
    and autograd records (the reference's jax.checkpoint)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _fwd_attn(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg):
    groups = _groups(cfg, x.device)
    bal = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, w in zip(_unbind(params["layers"], cfg.num_layers),
                     layer_windows(cfg)):
        x, b = _remat(_attn_layer, cfg, lp, x, positions, w, cfg, groups)
        bal = bal + b
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), bal


def _fwd_vlm(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
             memory: torch.Tensor):
    """Each superblock's self-attention layers (causal, RoPE), then its
    cross layer over the image embeds (no RoPE, no mask)."""
    n_sup, n_self = _vlm_segments(cfg)
    for s in range(n_sup):
        stack = layer_params(params["layers"], s)
        for i in range(n_self):
            x, _ = B.attn_block(layer_params(stack, i), x, cfg=cfg,
                                positions=positions)
        x, _ = B.attn_block(layer_params(params["cross_layers"], s), x,
                            cfg=cfg, positions=positions, causal=False,
                            kv_source=memory, use_rope=False)
    return (rmsnorm(params["final_norm"], x, cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _fwd_whisper(params: dict, x: torch.Tensor, cfg, frames: torch.Tensor):
    """Encode the frames [B, F, d] (bidirectional, no RoPE, then
    enc_norm: the memory), add the learned positions, then each decoder
    layer: causal self-attention without RoPE (no MLP), then the cross
    block over the memory with its gelu MLP."""
    h = frames
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)
    for l in range(cfg.encoder_layers):
        h, _ = B.attn_block(layer_params(params["encoder"], l), h, cfg=cfg,
                            positions=pos, causal=False, use_rope=False)
    memory = rmsnorm(params["enc_norm"], h, cfg.norm_eps)
    S = x.shape[1]
    x = x + params["pos_embed"][:S]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    for l in range(cfg.num_layers):
        sp = layer_params(params["dec_self"], l)
        h = rmsnorm(sp["ln1"], x, cfg.norm_eps)
        x = x + ATT.attn_forward(sp["attn"], h, cfg=cfg, positions=pos,
                                 use_rope=False)
        x, _ = B.attn_block(layer_params(params["dec_cross"], l), x, cfg=cfg,
                            positions=pos, causal=False, kv_source=memory,
                            use_rope=False)
    return (rmsnorm(params["final_norm"], x, cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _fwd_xlstm(params: dict, x: torch.Tensor, cfg):
    n_seg, n_m = _xlstm_segments(cfg)
    for s in range(n_seg):
        mstack = layer_params(params["mlayers"], s)
        for i in range(n_m):
            x = B.mlstm_block(layer_params(mstack, i), x, cfg=cfg)
        x = B.slstm_block(layer_params(params["slayers"], s), x, cfg=cfg)
    return (rmsnorm(params["final_norm"], x, cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _fwd_zamba(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg):
    """The Mamba2 layers in order, the shared attention block (no window)
    after every attn_every-th of them, the remaining layers after the
    last application."""
    for l in range(cfg.num_layers):
        x = B.mamba2_block(layer_params(params["layers"], l), x, cfg=cfg)
        if _shared_attn_after(l, cfg) is not None:
            x, _ = B.attn_block(params["shared_attn"], x, cfg=cfg,
                                positions=positions)
    return (rmsnorm(params["final_norm"], x, cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------- heads

def logits_from_hidden(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Tied embeddings: x @ embed.T, returned in fp32."""
    return (x @ params["embed"].T.to(x.dtype)).float()


def _xent_chunk(xb: torch.Tensor, lb: torch.Tensor, w: torch.Tensor):
    """(sum of token losses, count) over one chunk; labels < 0 masked."""
    logits = (xb @ w.to(xb.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    # one label per row: the gather's gradient lands on distinct entries
    gold = torch.gather(logits, -1, lb.clamp(min=0)[..., None].long())[..., 0]
    mask = (lb >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_xent(params: dict, x: torch.Tensor, labels: torch.Tensor, cfg,
                 chunk: int = 512):
    """Cross-entropy without materializing [B, S, V]: over S in chunks
    (the largest size <= `chunk` that divides S). x [B, S, d]; labels
    [B, S] (-1 = masked). Returns (sum_loss, count), fp32 scalars."""
    S = x.shape[1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    w = params["embed"].T
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        l, c = _remat(_xent_chunk, cfg, x[:, c0:c0 + chunk],
                      labels[:, c0:c0 + chunk], w)
        loss, cnt = loss + l, cnt + c
    return loss, cnt


def _training_cfg(cfg):
    """Training runs the differentiable "xla" realization: the CUDA kernels
    have no backward pass, so backend="auto" pins to "xla". An EXPLICIT
    backend="pallas" fails fast here, with the reference's message."""
    if cfg.moe is None:
        return cfg
    b = cfg.moe.backend
    if b == "pallas":
        raise NotImplementedError(
            "pallas backend has no backward pass yet; use backend='auto' or "
            "'xla' for training (see ROADMAP: custom VJP over gmm/gmm_swiglu)."
            " For forward-only evaluation on pallas, call model_forward + "
            "chunked_xent directly — loss_fn is the training entry point")
    if b == "auto":
        return cfg.with_overrides(
            moe=dataclasses.replace(cfg.moe, backend="xla"))
    return cfg


def loss_fn(params: dict, batch: dict, cfg):
    """batch: tokens [B, S], labels [B, S] -> (loss, {"ce", "balance"}):
    the mean token cross-entropy plus balance_coef times the layers' mean
    balance loss. The attention family without cross attention only: the
    xlstm family's sLSTM runs K9, which has no backward pass, zamba2's
    training is untested, and whisper's and llama-vision's are not
    ported."""
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: training is ported for the attention family "
            "without cross attention; xlstm and zamba2 training (a "
            "differentiable sLSTM and SSD scan) and whisper and "
            "llama-vision training are the rest of ROADMAP.md Queue 1 "
            "item 10")
    cfg = _training_cfg(cfg)
    x, bal = model_forward(params, batch["tokens"], cfg)
    loss_sum, cnt = chunked_xent(params, x, batch["labels"], cfg)
    ce = loss_sum / torch.clamp(cnt, min=1.0)
    coef = cfg.moe.balance_coef if cfg.moe is not None else 0.0
    total = ce + coef * bal / max(1, cfg.num_layers)
    return total, {"ce": ce, "balance": bal}


# --------------------------------------------------------------- decode state

def paged_supported(cfg) -> bool:
    """Paged KV pools cover the plain attention family: the KV cache is the
    only sequence-shaped decode state there (recurrent families keep O(1)
    state per row, whisper and llama-vision carry per-request memories)."""
    return (cfg.block == "attn" and cfg.encoder_layers == 0
            and cfg.cross_attn_every == 0)


def init_decode_state(cfg, batch: int, max_len: int, device, *,
                      extras: dict | None = None, per_slot_t: bool = False,
                      paged: tuple[int, int] | None = None) -> dict:
    """Zero decode state: the per-layer GO caches [L, B, E, k, (d)] (expert
    choice with the GO cache only; a dense MLP keeps none) and the
    position `t`, an int (the static batch moves in lock step) or, with
    per_slot_t, an int32 tensor [B] (every pool slot at its own offset).

    The KV is dense rows [L, B, max_len, Hkv, hd], or, with
    `paged=(num_pages, page_size)`, a shared page pool `k_pages`/`v_pages`
    [L, num_pages, page_size, Hkv, hd] plus a per-slot `block_table`
    [B, max_len // page_size] int32 of physical page ids (0 = the reserved
    null page). GO caches stay slot-resident either way. A paged state with
    cfg.kv_quant="int8" stores int8 pages and GO outputs, with
    `k_scales`/`v_scales` [L, num_pages, Hkv] and `go_scales` [L, B, E, k]
    (f32, zero = empty).

    The recurrent families keep the reference's nesting and no pages.
    xlstm: `mlstm` {"mlstm": (C, n, M), "conv"} with leading axes
    [n_seg, n_m] and `slstm` c/n/m/h with a leading [n_seg]. zamba2: `ssm`
    {"ssm" [L, B, H, P, N] fp32, "conv" [L, B, K - 1, di + 2n]} and the
    shared attention block's dense KV rows `k`/`v` [n_app, B, max_len,
    Hkv, hd], one pair per application.

    The cross-attention families keep dense KV rows of their
    self-attention layers (whisper [L, ...], llama-vision
    [n_sup * n_self, ...] by the flat self-layer index) and `memory`
    [B, M, d]: `extras["memory"]` where given (memory already encoded;
    used as it is, not copied), else zeros of num_audio_frames or
    num_image_tokens rows."""
    check_served(cfg)
    extras = extras or {}
    st = {"t": (torch.zeros(batch, dtype=torch.int32, device=device)
                if per_slot_t else 0)}
    dt = dtype_of(cfg)
    if paged is not None and not paged_supported(cfg):
        raise ValueError(
            "paged decode state is attention-family only "
            f"(block={cfg.block!r}, encoder_layers={cfg.encoder_layers}, "
            f"cross_attn_every={cfg.cross_attn_every})")
    if cfg.block == "attn" and not paged_supported(cfg):
        if cfg.encoder_layers > 0:
            n_kv, M = cfg.num_layers, cfg.num_audio_frames
        else:
            n_sup, n_self = _vlm_segments(cfg)
            n_kv, M = n_sup * n_self, cfg.num_image_tokens
        shp = (n_kv, batch, max_len, cfg.num_kv_heads,
               cfg.resolved_head_dim())
        st["k"] = torch.zeros(shp, dtype=dt, device=device)
        st["v"] = torch.zeros(shp, dtype=dt, device=device)
        st["memory"] = extras["memory"] if "memory" in extras else \
            torch.zeros((batch, M, cfg.d_model), dtype=dt, device=device)
        return st
    if cfg.block != "attn":
        if cfg.block == "xlstm":
            n_seg, n_m = _xlstm_segments(cfg)
            st["mlstm"] = X.mlstm_init_state(cfg, batch, device,
                                             lead=(n_seg, n_m))
            st["slstm"] = X.slstm_init_state(cfg, batch, device,
                                             lead=(n_seg,))
            return st
        st["ssm"] = SSM.mamba2_init_state(cfg, batch, device,
                                          lead=(cfg.num_layers,))
        n_app, _ = _zamba_segments(cfg)
        if n_app:
            shp = (n_app, batch, max_len, cfg.num_kv_heads,
                   cfg.resolved_head_dim())
            st["k"] = torch.zeros(shp, dtype=dt, device=device)
            st["v"] = torch.zeros(shp, dtype=dt, device=device)
        return st
    L = cfg.num_layers
    hd = cfg.resolved_head_dim()
    e = cfg.moe
    quant = False
    if paged is not None:
        num_pages, ps = paged
        if max_len % ps:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={ps}")
        Q.validate_kv_quant(cfg.kv_quant)
        quant = cfg.kv_quant == "int8"
        st["block_table"] = torch.zeros((batch, max_len // ps),
                                        dtype=torch.int32, device=device)
        shp = (L, num_pages, ps, cfg.num_kv_heads, hd)
        page_dt = torch.int8 if quant else dt
        st["k_pages"] = torch.zeros(shp, dtype=page_dt, device=device)
        st["v_pages"] = torch.zeros(shp, dtype=page_dt, device=device)
        if quant:
            # per-page, per-kv-head amax scales; zero = empty page
            for key in ("k_scales", "v_scales"):
                st[key] = torch.zeros((L, num_pages, cfg.num_kv_heads),
                                      dtype=torch.float32, device=device)
    else:
        shp = (L, batch, max_len, cfg.num_kv_heads, hd)
        st["k"] = torch.zeros(shp, dtype=dt, device=device)
        st["v"] = torch.zeros(shp, dtype=dt, device=device)
    if e is not None and e.routing == "expert_choice" and e.go_cache:
        st["go"] = go_cache_init(batch, e.num_experts, e.top_k, cfg.d_model,
                                 torch.int8 if quant else dt, device,
                                 lead=(L,))
        if quant:
            # per-row GO scales (the outputs rows are [E, k, d] per slot)
            st["go_scales"] = torch.zeros((L, batch, e.num_experts, e.top_k),
                                          dtype=torch.float32, device=device)
    return st


# the batch axis of each recurrent state's leaves (the reference's
# init_decode_slot comment): ssm and slstm after the layer axis, mlstm after
# the segment and layer axes
_RECURRENT_AXES = (("ssm", 1), ("mlstm", 2), ("slstm", 1))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, tuple):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


def recurrent_rows(state: dict, slot: int) -> list[torch.Tensor]:
    """Views of row `slot` of every recurrent leaf (xlstm's C, n, M and
    conv, c, n, m, h; zamba2's ssm and conv), in a fixed order: two states
    of one config give their leaves in the same order."""
    return [a.select(ax, slot) for key, ax in _RECURRENT_AXES
            if key in state for a in _leaves(state[key])]


def init_decode_slot(state: dict, slot: int) -> None:
    """Reset pool row `slot` to the empty decode state IN PLACE. A paged
    pool resets only the row's block table (to the null page): its
    physical pages go back to the host allocator and are rewritten before
    any later occupant reads them. GO rows reset (scores to -inf, and an
    int8 state's row scales to 0). A recurrent row's leaves go to 0, as
    the reference sets them (xlstm's M too, which init_decode_state starts
    at -1e30): write_decode_slot overwrites them all at admission. A
    cross-attention family's memory row goes to 0."""
    state["t"][slot] = 0
    for row in recurrent_rows(state, slot):
        row.zero_()
    if "block_table" in state:
        state["block_table"][slot] = 0
    for key in ("k", "v"):
        if key in state:
            state[key][:, slot] = 0
    if "go" in state:
        go_cache_init_slot(state["go"], slot)
    if "go_scales" in state:
        state["go_scales"][:, slot] = 0
    if "memory" in state:
        state["memory"][slot] = 0


def write_decode_slot(state: dict, slot: int, src: dict,
                      page_ids: torch.Tensor | None = None) -> None:
    """Write a batch-1 decode state `src` (a one-request prefill built with
    the SAME max_len as the pool) into pool row `slot` IN PLACE.

    A paged pool also takes `page_ids` [max_len // page_size] int32, the
    row's whole block table. The dense prefill KV splits into page-size
    rows scattered to those pages; null (0) entries, the pages past the
    request's allocation, dump their rows onto the null page. A src without
    dense "k"/"v" (a paged chunked prefill, which wrote its KV straight
    into the pool's pages) splats only its position and GO rows.

    An int8 state splat-quantizes each page against its own amax (a pure
    function of the tokens, independent of the pool's history) and each
    full-precision GO row once. A recurrent state's every leaf is written:
    retired rows keep stepping, so a leaf left out would hand the row's
    previous occupant's state to the next request. A cross-attention
    family's memory row is copied in the pool's dtype."""
    state["t"][slot] = int(src["t"])
    for dst, row in zip(recurrent_rows(state, slot), recurrent_rows(src, 0)):
        dst.copy_(row)
    if "block_table" in state:
        if page_ids is None:
            raise ValueError("paged pool: pass the slot's page_ids")
        pid = page_ids.to(device=state["block_table"].device,
                          dtype=torch.int32)
        state["block_table"][slot] = pid
        L, _, ps, h, hd = state["k_pages"].shape
        P = pid.shape[0]
        for key, srck in (("k_pages", "k"), ("v_pages", "v")):
            if srck not in src:
                continue
            if src[srck].shape[2] != P * ps:
                raise ValueError(
                    f"{srck}: prefill length {src[srck].shape[2]} != pool "
                    f"max_tokens {P * ps} (prefill with the pool's max_len)")
            pages = src[srck][:, 0].reshape(L, P, ps, h, hd)
            if "k_scales" in state:
                q, sc = Q.quantize_pages(pages)
                state[key][:, pid.long()] = q
                state[key[0] + "_scales"][:, pid.long()] = sc
            else:
                state[key][:, pid.long()] = pages.to(state[key].dtype)
    for key in ("k", "v"):
        if key in state:
            state[key][:, slot] = src[key][:, 0].to(state[key].dtype)
    if "go" in state:
        src_go = src["go"]
        if "go_scales" in state:
            qout, qsc = Q.quantize_rows(src_go.outputs)
            src_go = src_go._replace(outputs=qout)
            state["go_scales"][:, slot] = qsc[:, 0]
        go_cache_write_slot(state["go"], slot, src_go)
    if "memory" in state:
        state["memory"][slot] = src["memory"][0].to(state["memory"].dtype)


def _layer_go(state: dict, l: int) -> GOCache | None:
    if "go" not in state:
        return None
    return GOCache(*(a[l] for a in state["go"]))


# -------------------------------------------------------------------- prefill

def prefill(params: dict, tokens: torch.Tensor, cfg, max_len: int = 0,
            valid_len: int | None = None, extras: dict | None = None):
    """Full-sequence forward that fills the decode state: KV caches and,
    for expert choice, each layer's GO cache from its routing; a recurrent
    family and whisper step serve_step over the prompt instead, on a
    state of max_len (zamba2's shared-attention KV rows are max_len long,
    so the engine's pool splats them; xlstm keeps none). whisper and
    llama-vision read `extras["memory"]` (init_decode_state).
    tokens [B, S] -> (state, last-position logits [B, V] fp32).

    `valid_len` (a host int) is a BUCKETED prefill: tokens are right-padded
    to a bucket length and only the first valid_len positions are real.
    Causal attention keeps real positions off the pads; expert-choice
    routing masks the pads out of its top-C, so the GO cache holds only
    real tokens (token choice routes the pads too; their outputs land on
    pad rows only). The logits come from position valid_len - 1 and the
    decode starts there: the pads' KV rows are overwritten by decode steps
    before anything attends to them. The plain attention family only, as
    in the reference."""
    Bsz, S = tokens.shape
    dev = tokens.device
    state = init_decode_state(cfg, Bsz, max_len or 2 * S, dev, extras=extras)
    if valid_len is not None and not paged_supported(cfg):
        raise ValueError(
            f"{cfg.name}: bucketed prefill (valid_len) is attention-family "
            "only; recurrent and encoder-decoder families prefill step by "
            "step, cross-attention ones have no bucketed prefill")
    if cfg.block != "attn" or cfg.encoder_layers > 0:
        # step-by-step prefill, exact for a recurrent family and whisper
        logits = None
        for i in range(S):
            logits, state = serve_step(params, state, tokens[:, i], cfg)
        return state, logits
    vl = S if valid_len is None else int(valid_len)
    if not 1 <= vl <= S:
        raise ValueError(f"valid_len={valid_len} must lie in 1..{S}")
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    x = params["embed"][tokens]
    if cfg.cross_attn_every > 0:
        x = _prefill_vlm(params, x, positions, state, cfg)
    else:
        x = _prefill_layers(params, x, positions, state, cfg, valid_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params, x[:, vl - 1, :], cfg)
    state["t"] = vl
    return state, logits


def _prefill_layers(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    state: dict, cfg, valid_len: int | None) -> torch.Tensor:
    """The plain attention family's layers: each writes its KV rows and,
    for expert choice, its GO cache from the layer's routing."""
    S = x.shape[1]
    groups = _groups(cfg, x.device)
    for l, w in enumerate(layer_windows(cfg)):
        x, aux, k, v = B.attn_block(layer_params(params["layers"], l), x,
                                    cfg=cfg, positions=positions, window=w,
                                    return_kv=True, valid_len=valid_len,
                                    **groups)
        state["k"][l, :, :S] = k
        state["v"][l, :, :S] = v
        go_l = _layer_go(state, l)
        if go_l is not None:
            go = go_cache_prefill(None, None, aux["weighted_outputs"],
                                  aux["chosen_tokens"], aux["chosen_scores"],
                                  cfg.moe.top_k)
            for dst, src in zip(go_l, go):
                dst.copy_(src)
    return x


def _prefill_vlm(params: dict, x: torch.Tensor, positions: torch.Tensor,
                 state: dict, cfg) -> torch.Tensor:
    """llama-vision's one-shot prefill: each superblock's self-attention
    layers write their KV rows at the flat self-layer index, then its
    cross layer reads the state's memory."""
    n_sup, n_self = _vlm_segments(cfg)
    S = x.shape[1]
    for s in range(n_sup):
        stack = layer_params(params["layers"], s)
        for i in range(n_self):
            x, _, k, v = B.attn_block(layer_params(stack, i), x, cfg=cfg,
                                      positions=positions, return_kv=True)
            state["k"][s * n_self + i, :, :S] = k
            state["v"][s * n_self + i, :, :S] = v
        x, _ = B.attn_block(layer_params(params["cross_layers"], s), x,
                            cfg=cfg, positions=positions, causal=False,
                            kv_source=state["memory"], use_rope=False)
    return x


# -------------------------------------------------------------- chunk prefill

def _kv(state: dict, l: int):
    """Layer l's KV views and the block table (None for dense rows); an
    int8 pool's views come as (pages, scales) tuples."""
    if "k_scales" in state:
        return ((state["k_pages"][l], state["k_scales"][l]),
                (state["v_pages"][l], state["v_scales"][l]),
                state["block_table"])
    if "block_table" in state:
        return (state["k_pages"][l], state["v_pages"][l],
                state["block_table"])
    return state["k"][l], state["v"][l], None


def prefill_chunk(params: dict, state: dict, tokens: torch.Tensor, cfg,
                  start: int, valid_len: int | None = None):
    """Append ONE prompt chunk (tokens [B, Cs] at positions
    start..start+Cs-1; `start` and `valid_len` host ints) to a decode
    state mid-prefill, IN PLACE. The last chunk is right-padded to Cs and
    rides in with valid_len = its real token count: causal attention and
    the kv_len mask keep real positions off the pads, and expert-choice
    routing masks pads out of the chunk's top-C, so the merged GO cache
    holds only real tokens (token choice routes the pads too; their
    outputs land on pad rows only). A paged state (block_table, k_pages, v_pages)
    prefills straight into the pool's pages, an int8 one through the
    rescale-on-write scatter; the state's GO cache stays full precision
    (the engine's chunk job quantizes it once, at write_decode_slot).
    Returns (state, logits [B, V] fp32 at chunk position valid_len - 1);
    state["t"] lands on start + valid_len."""
    Cs = tokens.shape[1]
    vl = Cs if valid_len is None else valid_len
    groups = _groups(cfg, tokens.device)
    x = params["embed"][tokens]
    for l, w in enumerate(layer_windows(cfg)):
        ck, cv, bt = _kv(state, l)
        x, _ = B.attn_block_chunk(
            layer_params(params["layers"], l), x, ck, cv, start, cfg=cfg,
            go_cache=_layer_go(state, l), window=w, valid_len=vl,
            block_table=bt, **groups)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params, x[:, vl - 1, :], cfg)
    state["t"] = start + vl
    return state, logits


# ----------------------------------------------------------------- serve step

def serve_step(params: dict, state: dict, tokens_t: torch.Tensor, cfg):
    """One decode step. tokens_t [B] -> (logits [B, V] fp32, state); the
    state's caches are updated in place. `state["t"]` is an int or a
    per-slot [B] tensor; a paged state walks its block table. An int8
    state's GO rows are dequantized to f32 at each layer boundary (f32, NOT
    the compute dtype: an unchanged row then requantizes to its own int8
    bits) and requantized after the block."""
    t = state["t"]
    x = params["embed"][tokens_t][:, None, :]                     # [B, 1, d]
    if cfg.block == "xlstm":
        x = _dec_xlstm(params, x, state, cfg)
    elif cfg.block == "mamba2":
        x = _dec_zamba(params, x, state, cfg)
    elif cfg.encoder_layers > 0:
        x = _dec_whisper(params, x, state, cfg)
    elif cfg.cross_attn_every > 0:
        x = _dec_vlm(params, x, state, cfg)
    else:
        for l, w in enumerate(layer_windows(cfg)):
            ck, cv, bt = _kv(state, l)
            go = _layer_go(state, l)
            gsc = state["go_scales"][l] if "go_scales" in state else None
            if gsc is not None:
                stored = go.outputs
                go = go._replace(outputs=Q.dequantize_rows(stored, gsc))
            x, _ = B.attn_block_decode(
                layer_params(params["layers"], l), x, ck, cv, t, cfg=cfg,
                go_cache=go, window=w, block_table=bt)
            if gsc is not None:
                qout, qsc = Q.quantize_rows(go.outputs)
                stored.copy_(qout)
                gsc.copy_(qsc)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params, x[:, 0, :], cfg)
    state["t"] = t + 1
    return logits, state


def _dec_vlm(params: dict, x: torch.Tensor, state: dict, cfg):
    """One token through each superblock: its self-attention layers on
    their KV rows (flat index), then its cross layer over the memory."""
    n_sup, n_self = _vlm_segments(cfg)
    t = state["t"]
    for s in range(n_sup):
        stack = layer_params(params["layers"], s)
        for i in range(n_self):
            l = s * n_self + i
            x, _ = B.attn_block_decode(layer_params(stack, i), x,
                                       state["k"][l], state["v"][l], t,
                                       cfg=cfg)
        x = B.cross_block_decode(layer_params(params["cross_layers"], s), x,
                                 state["memory"], cfg=cfg)
    return x


def _dec_whisper(params: dict, x: torch.Tensor, state: dict, cfg):
    """One token: the learned position of each row's own t, then each
    decoder layer's self-attention (no RoPE, no MLP) and cross block."""
    t = state["t"]
    Bsz = x.shape[0]
    if isinstance(t, int):
        t_vec = torch.full((Bsz,), t, dtype=torch.long, device=x.device)
    else:
        t_vec = t.long().reshape(-1).expand(Bsz)
    x = x + params["pos_embed"][t_vec][:, None, :]
    for l in range(cfg.num_layers):
        sp = layer_params(params["dec_self"], l)
        h = rmsnorm(sp["ln1"], x, cfg.norm_eps)
        x = x + ATT.attn_decode(sp["attn"], h, state["k"][l], state["v"][l],
                                t, cfg=cfg, use_rope=False)
        x = B.cross_block_decode(layer_params(params["dec_cross"], l), x,
                                 state["memory"], cfg=cfg)
    return x


def _dec_xlstm(params: dict, x: torch.Tensor, state: dict, cfg):
    """One token through every segment; each block's new recurrent state is
    written into its slice of the decode state in place."""
    n_seg, n_m = _xlstm_segments(cfg)
    ms, ss = state["mlstm"], state["slstm"]
    for s in range(n_seg):
        mstack = layer_params(params["mlayers"], s)
        for i in range(n_m):
            st = {"mlstm": tuple(a[s, i] for a in ms["mlstm"]),
                  "conv": ms["conv"][s, i]}
            x, new = B.mlstm_block(layer_params(mstack, i), x, cfg=cfg,
                                   decode_state=st)
            for dst, src in zip((*st["mlstm"], st["conv"]),
                                (*new["mlstm"], new["conv"])):
                dst.copy_(src)
        sst = {k: v[s] for k, v in ss.items()}
        x, new = B.slstm_block(layer_params(params["slayers"], s), x,
                               cfg=cfg, decode_state=sst)
        for k, dst in sst.items():
            dst.copy_(new[k])
    return x


def _dec_zamba(params: dict, x: torch.Tensor, state: dict, cfg):
    """One token through the Mamba2 layers and the shared attention block's
    applications, each with its own KV rows (no window); every layer's new
    SSM and conv state is written into its slice of the decode state in
    place."""
    ssm = state["ssm"]
    for l in range(cfg.num_layers):
        st = {k: v[l] for k, v in ssm.items()}
        x, new = B.mamba2_block_decode(layer_params(params["layers"], l), x,
                                       st, cfg=cfg)
        for k, dst in st.items():
            dst.copy_(new[k])
        s = _shared_attn_after(l, cfg)
        if s is not None:
            x, _ = B.attn_block_decode(params["shared_attn"], x,
                                       state["k"][s], state["v"][s],
                                       state["t"], cfg=cfg)
    return x
