"""Grouped-query attention: the full-sequence pass and single-token decode
against a dense KV cache.

Counterpart of repro/models/attention.py (`attn_forward` with the numerics
of `sdpa_chunked`/`sdpa_flash`, and the dense branch of `attn_decode`). The
reference code here is plain jnp, not Pallas, so the port is plain
torch.matmul and softmax: scores and the value product take fp32 inputs,
which is what JAX's preferred_element_type=float32 computes.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, rope_angles

NEG_INF = -1e30


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                 kv_len: int, *, ck: int = 1024) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks of ck keys.
    q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D]; positions int [Sq] / [Sk]."""
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
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def attn_forward(params: dict, x: torch.Tensor, *, cfg,
                 positions: torch.Tensor, window: int = 0,
                 return_kv: bool = False):
    """Full-sequence causal self-attention. x [B, S, d]; positions [S].
    With return_kv also the post-RoPE (k, v) for the KV cache."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q = (x @ params["wq"]).reshape(B, S, nq, hd)
    k = (x @ params["wk"]).reshape(B, S, nkv, hd)
    v = (x @ params["wv"]).reshape(B, S, nkv, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos[:, None, :], sin[:, None, :])
    k = apply_rope(k, cos[:, None, :], sin[:, None, :])
    out = sdpa_chunked(q, k, v, positions, positions, window, S + 10**9)
    out = out.reshape(B, S, nq * hd) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


def _decode_sdpa(q, k, v, mask):
    """Single-query SDPA. q [B, 1, Hq, D]; k/v [B, S, Hkv, D]; mask [B, S]."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()                   # [B, Hkv, G, D]
    kt = k.permute(0, 2, 3, 1).float()                     # [B, Hkv, D, S]
    s = (qg @ kt) / (D ** 0.5)                             # [B, Hkv, G, S]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p.to(v.dtype).float() @ v.permute(0, 2, 1, 3).float()  # [B,Hkv,G,D]
    return out.reshape(B, 1, Hq, D)


def attn_decode(params: dict, x_t: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, t, *, cfg, window: int = 0):
    """Single-token decode against a dense KV cache [B, Smax, Hkv, hd].
    `t` is the position: an int (static batch) or [B]. The new token's K/V
    are written into the cache IN PLACE (JAX returns updated caches)."""
    B = x_t.shape[0]
    hd = cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dev = x_t.device
    if isinstance(t, int):      # a fill on the device, not a host copy
        t_vec = torch.full((B,), t, dtype=torch.int32, device=dev)
    else:
        t_vec = t.to(torch.int32).reshape(-1).expand(B)
    q = (x_t @ params["wq"]).reshape(B, 1, nq, hd)
    k = (x_t @ params["wk"]).reshape(B, 1, nkv, hd)
    v = (x_t @ params["wv"]).reshape(B, 1, nkv, hd)
    cos, sin = rope_angles(t_vec[:, None], hd, cfg.rope_theta)   # [B,1,hd/2]
    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
    k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])

    rows = torch.arange(B, device=dev)
    cache_k[rows, t_vec.long()] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, t_vec.long()] = v[:, 0].to(cache_v.dtype)
    Smax = cache_k.shape[1]
    k_pos = torch.arange(Smax, dtype=torch.int32, device=dev)
    mask = k_pos[None, :] <= t_vec[:, None]                     # [B, Smax]
    if window > 0:
        mask = mask & (k_pos[None, :] > t_vec[:, None] - window)
    out = _decode_sdpa(q, cache_k, cache_v, mask)
    return out.to(x_t.dtype).reshape(B, 1, nq * hd) @ params["wo"]
