"""Language-model assembly: the attention family with MoE, and xlstm.

Counterpart of repro/models/model.py for the serving paths:

  model_init(cfg, generator, device)            -> params
  model_forward(params, tokens, cfg)            -> (x_final, aux_loss), xlstm
  init_decode_state(cfg, batch, max_len, device, per_slot_t=, paged=)
                                                -> dense or paged state
  init_decode_slot / write_decode_slot          -> reset / fill one pool row
  prefill(params, tokens, cfg, max_len, valid_len=)
                                                -> (state, last_logits)
  prefill_chunk(params, state, tokens, cfg, start, valid_len)
                                                -> (state, chunk logits)
  serve_step(params, state, tokens_t, cfg)      -> (logits, state)
  logits_from_hidden(params, x, cfg)            -> [.., V] fp32

Parameters keep the reference's nesting and its stacked layer axes
(`layers.{attn.{wq,wk,wv,wo}, ln1, ln2, moe.{gate, experts.{wg,wi,wo}}}`;
xlstm: `mlayers` [n_seg, n_m, ...] and `slayers` [n_seg, ...]), so
`bridge.params_from_numpy` carries JAX weights across unchanged. Where
JAX scans over layers and carries the KV and GO caches (or the recurrent
states) through the scan, the port loops over layers in Python and writes
each layer's slice of the decode state in place. The decode state holds GO
rows only for expert choice with the GO cache; token choice keeps none, as
in the reference. Recurrent families prefill by stepping serve_step, as
the reference does.

A paged state with cfg.kv_quant="int8" (core/quant.py) holds int8 pages
with `k_scales`/`v_scales` [L, NP, Hkv] f32 and int8 GO outputs with
`go_scales` [L, B, E, k] f32. Each decode layer dequantizes its GO rows to
f32 before the block and requantizes them after it; a chunked prefill's
own batch-1 GO cache stays full precision and quantizes once, at
write_decode_slot.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import moe as MOE
from repro_torch.core import quant as Q
from repro_torch.core.grouping import (default_groups,
                                       group_of_expert_from_groups)
from repro_torch.core.go_cache import (GOCache, go_cache_init,
                                       go_cache_init_slot, go_cache_prefill,
                                       go_cache_write_slot)
from repro_torch.models import blocks as B
from repro_torch.models import xlstm as X
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       rmsnorm)


def layer_windows(cfg) -> list[int]:
    """Per-layer sliding-window spans (0 = global attention)."""
    return [cfg.sliding_window] * cfg.num_layers


def check_served(cfg) -> None:
    """Raise on a configuration the port does not serve yet: it serves the
    xlstm family (model_forward and static generate()) and the attention
    family with an MoE sublayer, either expert choice with the GO cache or
    token choice, and no shared experts."""
    if cfg.block == "xlstm":
        return
    e = cfg.moe
    if cfg.block != "attn" or e is None or e.routing not in (
            "expert_choice", "token_choice") or (
            e.routing == "expert_choice" and not e.go_cache):
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention blocks with MoE "
            "(expert choice with the GO cache, or token choice) so far; "
            "dense MLPs and the other families are ROADMAP.md Queue 1 "
            "items 4, 5 and 9")
    if e.num_shared_experts:
        raise NotImplementedError(
            f"{cfg.name}: shared experts are not ported yet (ROADMAP.md "
            "Queue 1 item 4)")
    MOE.check_backend(e)


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
    expert choice)."""
    if cfg.moe.routing == "expert_choice":
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
    if cfg.block == "xlstm":
        n_seg, n_m = _xlstm_segments(cfg)
        p["mlayers"] = _stacked(n_seg, lambda: _stacked(
            n_m, lambda: B.mlstm_block_init(g, cfg, dt, device)))
        p["slayers"] = _stacked(
            n_seg, lambda: B.slstm_block_init(g, cfg, dt, device))
        return p
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


# -------------------------------------------------------------------- forward

def model_forward(params: dict, tokens: torch.Tensor, cfg):
    """tokens [B, S] -> (x_final [B, S, d] normalized, aux loss: a zero fp32
    scalar, as the reference's for a family without MoE). Ported for the
    xlstm family, where each sLSTM block runs its whole sequence in one K9
    launch on a card."""
    check_served(cfg)
    if cfg.block != "xlstm":
        raise NotImplementedError(
            f"{cfg.name}: model_forward is ported for the xlstm family only; "
            "the attention family's branch is ROADMAP.md Queue 1 item 10")
    return _fwd_xlstm(params, params["embed"][tokens], cfg)


def _fwd_xlstm(params: dict, x: torch.Tensor, cfg):
    n_seg, n_m = _xlstm_segments(cfg)
    for s in range(n_seg):
        mstack = layer_params(params["mlayers"], s)
        for i in range(n_m):
            x = B.mlstm_block(layer_params(mstack, i), x, cfg=cfg)
        x = B.slstm_block(layer_params(params["slayers"], s), x, cfg=cfg)
    return (rmsnorm(params["final_norm"], x, cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------- heads

def logits_from_hidden(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Tied embeddings: x @ embed.T, returned in fp32."""
    return (x @ params["embed"].T.to(x.dtype)).float()


# --------------------------------------------------------------- decode state

def paged_supported(cfg) -> bool:
    """Paged KV pools cover the plain attention family: the KV cache is the
    only sequence-shaped decode state there (recurrent families keep O(1)
    state per row)."""
    return cfg.block == "attn"


def init_decode_state(cfg, batch: int, max_len: int, device, *,
                      per_slot_t: bool = False,
                      paged: tuple[int, int] | None = None) -> dict:
    """Zero decode state: the per-layer GO caches [L, B, E, k, (d)] (expert
    choice with the GO cache only) and the position `t`, an int (the static batch moves in lock step) or, with
    per_slot_t, an int32 tensor [B] (every pool slot at its own offset).

    The KV is dense rows [L, B, max_len, Hkv, hd], or, with
    `paged=(num_pages, page_size)`, a shared page pool `k_pages`/`v_pages`
    [L, num_pages, page_size, Hkv, hd] plus a per-slot `block_table`
    [B, max_len // page_size] int32 of physical page ids (0 = the reserved
    null page). GO caches stay slot-resident either way. A paged state with
    cfg.kv_quant="int8" stores int8 pages and GO outputs, with
    `k_scales`/`v_scales` [L, num_pages, Hkv] and `go_scales` [L, B, E, k]
    (f32, zero = empty).

    xlstm keeps the reference's nesting: `mlstm` {"mlstm": (C, n, M),
    "conv"} with leading axes [n_seg, n_m] and `slstm` c/n/m/h with a
    leading [n_seg] (no KV, no pages)."""
    check_served(cfg)
    st = {"t": (torch.zeros(batch, dtype=torch.int32, device=device)
                if per_slot_t else 0)}
    if cfg.block == "xlstm":
        if paged is not None:
            raise ValueError(f"{cfg.name}: paged decode state is "
                             "attention-family only")
        n_seg, n_m = _xlstm_segments(cfg)
        st["mlstm"] = X.mlstm_init_state(cfg, batch, device,
                                         lead=(n_seg, n_m))
        st["slstm"] = X.slstm_init_state(cfg, batch, device, lead=(n_seg,))
        return st
    dt = dtype_of(cfg)
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
    if e.routing == "expert_choice" and e.go_cache:
        st["go"] = go_cache_init(batch, e.num_experts, e.top_k, cfg.d_model,
                                 torch.int8 if quant else dt, device,
                                 lead=(L,))
        if quant:
            # per-row GO scales (the outputs rows are [E, k, d] per slot)
            st["go_scales"] = torch.zeros((L, batch, e.num_experts, e.top_k),
                                          dtype=torch.float32, device=device)
    return st


def init_decode_slot(state: dict, slot: int) -> None:
    """Reset pool row `slot` to the empty decode state IN PLACE. A paged
    pool resets only the row's block table (to the null page): its
    physical pages go back to the host allocator and are rewritten before
    any later occupant reads them. GO rows reset (scores to -inf, and an
    int8 state's row scales to 0)."""
    state["t"][slot] = 0
    if "block_table" in state:
        state["block_table"][slot] = 0
    for key in ("k", "v"):
        if key in state:
            state[key][:, slot] = 0
    if "go" in state:
        go_cache_init_slot(state["go"], slot)
    if "go_scales" in state:
        state["go_scales"][:, slot] = 0


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
    full-precision GO row once."""
    state["t"][slot] = int(src["t"])
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


def _layer_go(state: dict, l: int) -> GOCache | None:
    if "go" not in state:
        return None
    return GOCache(*(a[l] for a in state["go"]))


# -------------------------------------------------------------------- prefill

def prefill(params: dict, tokens: torch.Tensor, cfg, max_len: int = 0,
            valid_len: int | None = None):
    """Full-sequence forward that fills the decode state: KV caches and,
    for expert choice, each layer's GO cache from its routing; a recurrent
    family steps serve_step over the prompt instead (max_len unused).
    tokens [B, S] -> (state, last-position logits [B, V] fp32).

    `valid_len` (a host int) is a BUCKETED prefill: tokens are right-padded
    to a bucket length and only the first valid_len positions are real.
    Causal attention keeps real positions off the pads; expert-choice
    routing masks the pads out of its top-C, so the GO cache holds only
    real tokens (token choice routes the pads too; their outputs land on
    pad rows only). The logits come from position valid_len - 1 and the
    decode starts there: the pads' KV rows are overwritten by decode steps
    before anything attends to them. Attention family only, as in the
    reference."""
    Bsz, S = tokens.shape
    dev = tokens.device
    state = init_decode_state(cfg, Bsz, max_len or 2 * S, dev)
    if cfg.block != "attn":
        if valid_len is not None:
            raise ValueError(
                f"{cfg.name}: bucketed prefill (valid_len) is attention-"
                "family only; a recurrent family prefills step by step")
        # step-by-step prefill, exact for a recurrent family
        logits = None
        for i in range(S):
            logits, state = serve_step(params, state, tokens[:, i], cfg)
        return state, logits
    vl = S if valid_len is None else int(valid_len)
    if not 1 <= vl <= S:
        raise ValueError(f"valid_len={valid_len} must lie in 1..{S}")
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    groups = _groups(cfg, dev)
    x = params["embed"][tokens]
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
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params, x[:, vl - 1, :], cfg)
    state["t"] = vl
    return state, logits


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
