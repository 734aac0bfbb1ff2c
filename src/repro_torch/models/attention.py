"""Grouped-query attention: the full-sequence pass, single-token decode and
chunked prefill against a dense KV cache or a paged KV pool.

Counterpart of repro/models/attention.py (`attn_forward` with the numerics
of `sdpa_chunked`/`sdpa_flash`, `attn_decode` and `attn_chunk`). The
reference's dense code is plain jnp, not Pallas, so the port's is plain
torch.matmul and softmax: scores and the value product take fp32 inputs,
which is what JAX's preferred_element_type=float32 computes. The paged
branches scatter the new keys into their pages, then attend through
kernels/paged_attn.py (K3 at decode, K4 at a prefill chunk): the CUDA
kernels on a card, the reference's gather realization on the CPU. An int8
pool (cfg.kv_quant="int8") arrives as (pages, scales) tuples: the new keys
go in through core/quant.py's rescale-on-write scatters and the scales
ride along to K3/K4.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import paged_attn as PAGED
from repro_torch.models.layers import apply_rope, rope_angles

NEG_INF = -1e30


def sdpa_chunked_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                     kv_len: int, *, softcap: float = 0.0,
                     ck: int = 1024) -> torch.Tensor:
    """`sdpa_chunked` before its final cast: fp32 [B, Sq, Hq, D]."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    ck = min(ck, Sk)
    while Sk % ck:
        ck -= 1
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
        kpb = k_pos[c0:c0 + ck]
        s = qg @ kb                                          # [B,Hkv,G,Sq,ck]
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        mask = (kpb[None, :] < kv_len) & (kpb[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (kpb[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(vb.dtype).float() @ vb.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                 kv_len: int, *, softcap: float = 0.0,
                 ck: int = 1024) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks of ck keys, in q's
    dtype. q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D]; positions int [Sq] /
    [Sk]; keys at k_pos >= kv_len are masked; softcap > 0 applies
    c * tanh(s / c) to the scores."""
    return sdpa_chunked_f32(q, k, v, q_pos, k_pos, window, kv_len,
                            softcap=softcap, ck=ck).to(q.dtype)


def _qkv(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg):
    """Projections and RoPE. x [B, S, d]; positions [S] or [B, S] ->
    q [B, S, Hq, hd], k/v [B, S, Hkv, hd]."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q = (x @ params["wq"]).reshape(B, S, nq, hd)
    k = (x @ params["wk"]).reshape(B, S, nkv, hd)
    v = (x @ params["wv"]).reshape(B, S, nkv, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos[..., None, :], sin[..., None, :])
    k = apply_rope(k, cos[..., None, :], sin[..., None, :])
    return q, k, v


def attn_forward(params: dict, x: torch.Tensor, *, cfg,
                 positions: torch.Tensor, window: int = 0,
                 return_kv: bool = False):
    """Full-sequence causal self-attention. x [B, S, d]; positions [S].
    With return_kv also the post-RoPE (k, v) for the KV cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg)
    out = sdpa_chunked(q, k, v, positions, positions, window, S + 10**9)
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
                cfg, window: int = 0,
                block_table: torch.Tensor | None = None):
    """Single-token decode. `t` is the position: an int (static batch) or
    [B]. The new token's K/V are written IN PLACE (JAX returns updated
    caches): into a dense cache [B, Smax, Hkv, hd] at row t, or, with
    `block_table` [B, P] int32, into the shared page pool
    [NP, ps, Hkv, hd] at page bt[b, t // ps], offset t % ps (0 = the null
    page: retired rows write there). An int8 pool comes as (pages,
    scales) tuples, written through Q.scatter_token. Attention then runs
    over the dense rows, or walks the block table through K3
    (paged_attn_decode)."""
    B = x_t.shape[0]
    hd = cfg.resolved_head_dim()
    nq = cfg.num_heads
    dev = x_t.device
    if isinstance(t, int):      # a fill on the device, not a host copy
        t_vec = torch.full((B,), t, dtype=torch.int32, device=dev)
    else:
        t_vec = t.to(torch.int32).reshape(-1).expand(B)
    q, k, v = _qkv(params, x_t, t_vec[:, None], cfg)

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
                                      t_vec, window=window, softcap=0.0,
                                      k_scales=k_scales, v_scales=v_scales)
        return out.to(x_t.dtype).reshape(B, 1, nq * hd) @ params["wo"]
    cache_k[rows, tl] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, tl] = v[:, 0].to(cache_v.dtype)
    Smax = cache_k.shape[1]
    k_pos = torch.arange(Smax, dtype=torch.int32, device=dev)
    mask = k_pos[None, :] <= t_vec[:, None]                     # [B, Smax]
    if window > 0:
        mask = mask & (k_pos[None, :] > t_vec[:, None] - window)
    out = _decode_sdpa(q, cache_k, cache_v, mask)
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
                                     kvl, window=window, softcap=0.0,
                                     k_scales=k_scales, v_scales=v_scales)
        return out.to(x.dtype).reshape(B, Cs, nq * hd) @ params["wo"]
    cache_k[:, start:start + Cs] = k.to(cache_k.dtype)
    cache_v[:, start:start + Cs] = v.to(cache_v.dtype)
    Smax = cache_k.shape[1]
    k_pos = torch.arange(Smax, dtype=torch.int32, device=dev)
    out = sdpa_chunked(q, cache_k, cache_v, positions, k_pos, window,
                       Smax if kv_len is None else kv_len)
    return out.reshape(B, Cs, nq * hd) @ params["wo"]
