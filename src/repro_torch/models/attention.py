"""Grouped-query attention: the full-sequence pass, single-token decode and
chunked prefill against a dense KV cache or a paged KV pool.

Counterpart of repro/models/attention.py (`attn_forward` through
`sdpa_flash`, whose forward is `sdpa_chunked`'s arithmetic and whose
chunk-streamed backward is the reference's custom VJP, causal,
bidirectional or cross attention over a memory; `attn_decode`,
`cross_attn_decode` and `attn_chunk`). The
reference's dense code is plain jnp, not Pallas, so the port's is plain
torch.matmul and softmax: scores and the value product take fp32 inputs,
which is what JAX's preferred_element_type=float32 computes. The paged
branches scatter the new keys into their pages, then attend through
kernels/paged_attn.py (K3 at decode, K4 at a prefill chunk): the CUDA
kernels on a card, the reference's gather realization on the CPU. An int8
pool (cfg.kv_quant="int8") arrives as (pages, scales) tuples: the new keys
go in through core/quant.py's rescale-on-write scatters and the scales
ride along to K3/K4. Every path applies cfg.logit_softcap (0 = none) to
the scores and adds the QKV bias where the params hold one (`_qkv`).
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import paged_attn as PAGED
from repro_torch.models.layers import apply_rope, rope_angles

NEG_INF = -1e30


def _chunk(Sk: int, ck: int) -> int:
    """The KV chunk: the largest size <= ck that divides Sk."""
    ck = min(ck, Sk)
    while Sk % ck:
        ck -= 1
    return ck


def _chunk_mask(kpb, q_pos, kv_len: int, window: int,
                causal: bool = True) -> torch.Tensor:
    """[Sq, ck] bool ([1, ck] when neither causal nor windowed): keys at or
    past kv_len out; if `causal`, keys past the query out; with a window
    > 0 only keys within `window` of the query."""
    mask = kpb[None, :] < kv_len
    if causal:
        mask = mask & (kpb[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (kpb[None, :] > q_pos[:, None] - window)
    return mask


def _flash_fwd(q, k, v, q_pos, k_pos, window: int, kv_len: int,
               softcap: float, ck: int, causal: bool = True):
    """The online-softmax forward over KV chunks of ck keys: (out fp32
    [B, Sq, Hq, D] before its final cast, lse fp32 [B, Hkv, G, Sq], the
    row statistics the backward needs)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    ck = _chunk(Sk, ck)
    scale = 1.0 / (D ** 0.5)
    # [B, Hkv, G, Sq, D], pre-scaled in fp32 then rounded to q's dtype
    qg = (q.float() * scale).to(q.dtype).reshape(B, Sq, Hkv, G, D)
    qg = qg.permute(0, 2, 3, 1, 4).float()
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Sk, ck):
        kb = k[:, c0:c0 + ck].permute(0, 2, 3, 1)[:, :, None].float()
        vb = v[:, c0:c0 + ck].permute(0, 2, 1, 3)[:, :, None]  # [B,Hkv,1,ck,D]
        s = qg @ kb                                          # [B,Hkv,G,Sq,ck]
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(_chunk_mask(k_pos[c0:c0 + ck], q_pos, kv_len, window,
                                    causal), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(vb.dtype).float() @ vb.float()
        m = m_new
    l = torch.clamp(l, min=1e-20)
    out = acc / l[..., None]
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D),
            m + torch.log(l))


def sdpa_chunked_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                     kv_len: int, *, softcap: float = 0.0,
                     ck: int = 1024, causal: bool = True) -> torch.Tensor:
    """`sdpa_chunked` before its final cast: fp32 [B, Sq, Hq, D]."""
    return _flash_fwd(q, k, v, q_pos, k_pos, window, kv_len, softcap, ck,
                      causal)[0]


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                 kv_len: int, *, softcap: float = 0.0,
                 ck: int = 1024, causal: bool = True) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ck keys, in q's dtype,
    causal unless `causal=False` (bidirectional or cross attention).
    q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D]; positions int [Sq] / [Sk];
    keys at k_pos >= kv_len are masked; softcap > 0 applies
    c * tanh(s / c) to the scores."""
    return sdpa_chunked_f32(q, k, v, q_pos, k_pos, window, kv_len,
                            softcap=softcap, ck=ck,
                            causal=causal).to(q.dtype)


class _SdpaFlash(torch.autograd.Function):
    """`sdpa_chunked` with the reference's chunk-streamed backward
    (`sdpa_flash`'s custom VJP): the forward keeps only (q, k, v, out,
    lse); the backward recomputes p per KV chunk from lse and never builds
    the [Sq, Sk] score matrix, with the reference's casts."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, kv_len, softcap, ck,
                causal):
        out, lse = _flash_fwd(q, k, v, q_pos, k_pos, window, kv_len,
                              softcap, ck, causal)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.args = (window, kv_len, softcap, ck, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        window, kv_len, softcap, ck, causal = ctx.args
        B, Sq, Hq, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        G = Hq // Hkv
        ck = _chunk(Sk, ck)
        scale = 1.0 / (D ** 0.5)

        def grouped(t):                                  # -> [B,Hkv,G,Sq,D]
            return t.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)

        qg = grouped(q) * scale            # fp32, unrounded (dk's operand)
        qs = qg.to(q.dtype).float()        # the forward's rounded scores
        dog = grouped(dout)
        drow = (dog * grouped(out)).sum(-1)                 # [B,Hkv,G,Sq]
        dov = dog.to(v.dtype).float()
        dq = torch.zeros_like(qg)
        dks, dvs = [], []
        for c0 in range(0, Sk, ck):
            kb = k[:, c0:c0 + ck].permute(0, 2, 1, 3)[:, :, None]  # [B,Hkv,1,ck,D]
            vb = v[:, c0:c0 + ck].permute(0, 2, 1, 3)[:, :, None]
            sraw = qs @ kb.float().transpose(-1, -2)       # [B,Hkv,G,Sq,ck]
            if softcap > 0:
                t = torch.tanh(sraw / softcap)
                s, dsoft = softcap * t, 1.0 - t * t
            else:
                s, dsoft = sraw, None
            mask = _chunk_mask(k_pos[c0:c0 + ck], q_pos, kv_len, window,
                               causal)
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse[..., None])
            dvs.append((p.transpose(-1, -2) @ dog).sum(2))    # [B,Hkv,ck,D]
            dp = dov @ vb.float().transpose(-1, -2)
            ds = p * (dp - drow[..., None])
            if dsoft is not None:
                ds = ds * dsoft
            ds = torch.where(mask, ds, 0.0)
            dq = dq + ds.to(k.dtype).float() @ kb.float()
            dks.append((ds.transpose(-1, -2) @ qg).sum(2))
        dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
        dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3)
        dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None)


def sdpa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
               kv_len: int, *, softcap: float = 0.0,
               ck: int = 1024, causal: bool = True) -> torch.Tensor:
    """`sdpa_chunked` (the same bits forward) with the chunk-streamed flash
    backward; differentiable in q, k and v."""
    return _SdpaFlash.apply(q, k, v, q_pos, k_pos, window, kv_len, softcap,
                            ck, causal)


def _qkv(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
         kv_source: torch.Tensor | None = None, use_rope: bool = True):
    """Projections (plus the QKV bias where the params hold one, qwen2)
    and RoPE. x [B, S, d]; positions [S] or [B, S] -> q [B, S, Hq, hd],
    k/v [B, Sk, Hkv, hd]. K and V project `kv_source` [B, Sk, d] where
    one is given (cross attention: the raw memory, no RoPE), else x."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    src = x if kv_source is None else kv_source
    Sk = src.shape[1]
    q, k, v = x @ params["wq"], src @ params["wk"], src @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, nq, hd)
    k = k.reshape(B, Sk, nkv, hd)
    v = v.reshape(B, Sk, nkv, hd)
    if not use_rope or kv_source is not None:
        return q, k, v
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos[..., None, :], sin[..., None, :])
    k = apply_rope(k, cos[..., None, :], sin[..., None, :])
    return q, k, v


def attn_forward(params: dict, x: torch.Tensor, *, cfg,
                 positions: torch.Tensor, window: int = 0,
                 causal: bool = True,
                 kv_source: torch.Tensor | None = None,
                 use_rope: bool = True, return_kv: bool = False):
    """Full-sequence attention. x [B, S, d]; positions [S]. Causal
    self-attention by default; `causal=False` is bidirectional (whisper's
    encoder); `use_rope=False` leaves RoPE out (whisper). With `kv_source`
    [B, Sk, d] it is cross attention over that memory: K and V project the
    raw memory, keys sit at positions 0..Sk-1, no RoPE and no causal mask.
    With return_kv also the (post-RoPE) (k, v) for the KV cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg, kv_source, use_rope)
    Sk = k.shape[1]
    k_pos = positions if kv_source is None else torch.arange(
        Sk, dtype=torch.int32, device=x.device)
    out = sdpa_flash(q, k, v, positions, k_pos, window, Sk + 10**9,
                     softcap=cfg.logit_softcap,
                     causal=causal and kv_source is None)
    out = out.reshape(B, S, -1) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


def _decode_sdpa(q, k, v, mask, softcap: float = 0.0):
    """Single-query SDPA. q [B, 1, Hq, D]; k/v [B, S, Hkv, D]; mask [B, S].
    Returns fp32 [B, 1, Hq, D]."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()                   # [B, Hkv, G, D]
    kt = k.permute(0, 2, 3, 1).float()                     # [B, Hkv, D, S]
    s = (qg @ kt) / (D ** 0.5)                             # [B, Hkv, G, S]
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p.to(v.dtype).float() @ v.permute(0, 2, 1, 3).float()  # [B,Hkv,G,D]
    return out.reshape(B, 1, Hq, D)


def _unpack(cache_k, cache_v):
    """(k pages, v pages, k scales, v scales): an int8 pool arrives as
    (pages, scales) tuples, a full-precision one as bare tensors."""
    if isinstance(cache_k, tuple):
        return cache_k[0], cache_v[0], cache_k[1], cache_v[1]
    return cache_k, cache_v, None, None


def attn_decode(params: dict, x_t: torch.Tensor, cache_k, cache_v, t, *,
                cfg, window: int = 0, use_rope: bool = True,
                block_table: torch.Tensor | None = None):
    """Single-token decode. `t` is the position: an int (static batch) or
    [B]. The new token's K/V are written IN PLACE (JAX returns updated
    caches): into a dense cache [B, Smax, Hkv, hd] at row t, or, with
    `block_table` [B, P] int32, into the shared page pool
    [NP, ps, Hkv, hd] at page bt[b, t // ps], offset t % ps (0 = the null
    page: retired rows write there). An int8 pool comes as (pages,
    scales) tuples, written through Q.scatter_token. Attention then runs
    over the dense rows, or walks the block table through K3
    (paged_attn_decode). `use_rope=False` leaves RoPE out (whisper's
    decoder self-attention)."""
    B = x_t.shape[0]
    hd = cfg.resolved_head_dim()
    nq = cfg.num_heads
    dev = x_t.device
    if isinstance(t, int):      # a fill on the device, not a host copy
        t_vec = torch.full((B,), t, dtype=torch.int32, device=dev)
    else:
        t_vec = t.to(torch.int32).reshape(-1).expand(B)
    q, k, v = _qkv(params, x_t, t_vec[:, None], cfg, use_rope=use_rope)

    rows = torch.arange(B, device=dev)
    tl = t_vec.long()
    cache_k, cache_v, k_scales, v_scales = _unpack(cache_k, cache_v)
    if block_table is not None:
        ps = cache_k.shape[1]
        page = block_table[rows, tl // ps].long()                    # [B]
        if k_scales is not None:
            Q.scatter_token(cache_k, k_scales, page, tl % ps, k[:, 0])
            Q.scatter_token(cache_v, v_scales, page, tl % ps, v[:, 0])
        else:
            cache_k[page, tl % ps] = k[:, 0].to(cache_k.dtype)
            cache_v[page, tl % ps] = v[:, 0].to(cache_v.dtype)
        out = PAGED.paged_attn_decode(q[:, 0], cache_k, cache_v, block_table,
                                      t_vec, window=window,
                                      softcap=cfg.logit_softcap,
                                      k_scales=k_scales, v_scales=v_scales)
        return out.to(x_t.dtype).reshape(B, 1, nq * hd) @ params["wo"]
    cache_k[rows, tl] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, tl] = v[:, 0].to(cache_v.dtype)
    Smax = cache_k.shape[1]
    k_pos = torch.arange(Smax, dtype=torch.int32, device=dev)
    mask = k_pos[None, :] <= t_vec[:, None]                     # [B, Smax]
    if window > 0:
        mask = mask & (k_pos[None, :] > t_vec[:, None] - window)
    out = _decode_sdpa(q, cache_k, cache_v, mask, cfg.logit_softcap)
    return out.to(x_t.dtype).reshape(B, 1, nq * hd) @ params["wo"]


def attn_chunk(params: dict, x: torch.Tensor, cache_k, cache_v, start: int,
               *, cfg, window: int = 0, kv_len: int | None = None,
               block_table: torch.Tensor | None = None):
    """Chunked-prefill attention: append one prompt chunk (x [B, Cs, d] at
    absolute positions start..start+Cs-1; `start` a host int) to the KV
    cache IN PLACE and attend its queries over everything cached so far.
    Keys at positions >= `kv_len` are masked (the last, right-padded chunk
    rides in with kv_len = start + valid). Dense caches take the chunk at
    rows start..; with `block_table` the chunk scatters into the pages
    backing its positions (pad positions past the row's allocation land on
    the null page 0; an int8 pool's (pages, scales) tuples through
    Q.scatter_chunk) and attention walks the block table through K4
    (paged_attn_chunk)."""
    B, Cs, _ = x.shape
    hd = cfg.resolved_head_dim()
    nq = cfg.num_heads
    dev = x.device
    positions = start + torch.arange(Cs, dtype=torch.int32, device=dev)
    q, k, v = _qkv(params, x, positions, cfg)
    cache_k, cache_v, k_scales, v_scales = _unpack(cache_k, cache_v)
    if block_table is not None:
        ps = cache_k.shape[1]
        P = block_table.shape[1]
        pl = positions.long()
        pages = block_table[:, pl // ps].long()                      # [B, Cs]
        offs = (pl % ps)[None, :].expand(B, Cs)
        if k_scales is not None:
            Q.scatter_chunk(cache_k, k_scales, pages, offs, k)
            Q.scatter_chunk(cache_v, v_scales, pages, offs, v)
        else:
            cache_k[pages, offs] = k.to(cache_k.dtype)
            cache_v[pages, offs] = v.to(cache_v.dtype)
        kvl = P * ps if kv_len is None else kv_len
        out = PAGED.paged_attn_chunk(q, cache_k, cache_v, block_table, start,
                                     kvl, window=window,
                                     softcap=cfg.logit_softcap,
                                     k_scales=k_scales, v_scales=v_scales)
        return out.to(x.dtype).reshape(B, Cs, nq * hd) @ params["wo"]
    cache_k[:, start:start + Cs] = k.to(cache_k.dtype)
    cache_v[:, start:start + Cs] = v.to(cache_v.dtype)
    Smax = cache_k.shape[1]
    k_pos = torch.arange(Smax, dtype=torch.int32, device=dev)
    out = sdpa_chunked(q, cache_k, cache_v, positions, k_pos, window,
                       Smax if kv_len is None else kv_len,
                       softcap=cfg.logit_softcap)
    return out.reshape(B, Cs, nq * hd) @ params["wo"]


def cross_attn_decode(params: dict, x_t: torch.Tensor, memory: torch.Tensor,
                      *, cfg) -> torch.Tensor:
    """Single-token cross attention over a fixed memory [B, M, d] (encoded
    audio frames or image embeds): K and V are projected from the memory
    at every step, as the reference does, and every key is attended (no
    mask, no RoPE). x_t [B, 1, d] -> [B, 1, d]."""
    B = x_t.shape[0]
    hd = cfg.resolved_head_dim()
    nq = cfg.num_heads
    q, k, v = _qkv(params, x_t, None, cfg, kv_source=memory)
    mask = torch.ones((B, k.shape[1]), dtype=torch.bool, device=x_t.device)
    out = _decode_sdpa(q, k, v, mask, cfg.logit_softcap)
    return out.to(x_t.dtype).reshape(B, 1, nq * hd) @ params["wo"]
