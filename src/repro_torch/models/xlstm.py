"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel training form with
exact log-domain stabilization) and sLSTM (scalar memory, recurrent).

Counterpart of repro/models/xlstm.py, same functions, same op order.

mLSTM semantics (per head):
  C_t = f_t C_{t-1} + i_t k_t v_t^T      n_t = f_t n_{t-1} + i_t k_t
  h_t = (q_t^T C_t) / max(|q_t^T n_t|, 1)
with f_t = sigmoid(f_raw), i_t = exp(i_raw). The chunkwise form carries a
log-scale M per head so all exponentials stay bounded; the decode path is the
stabilized recurrence and matches the chunkwise form. The mLSTM has no TPU
kernel in the reference and stays plain PyTorch here. The sLSTM's
full-sequence mode runs K9 (`kernels/slstm_cell.slstm_seq`): one launch per
block on a card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import slstm_cell as SC
from repro_torch.models.layers import dense_init, dtype_of, rmsnorm

LOG_EPS = -1e30


# ------------------------------------------------------------- mLSTM core

def mlstm_chunked(q, k, v, li, lf, chunk: int, state=None):
    """q/k/v [B,S,H,D]; li/lf [B,S,H] (log input gate, log forget gate).

    Returns h [B,S,H,D] in q's dtype and the final state (C_hat [B,H,D,D],
    n_hat [B,H,D], M [B,H]), fp32.
    """
    B, S, H, D = q.shape
    scale = 1.0 / (D ** 0.5)
    L = min(chunk, S)
    while S % L:
        L -= 1
    c = S // L

    qc = (q * scale).reshape(B, c, L, H, D).float()
    kc = k.reshape(B, c, L, H, D).float()
    vc = v.reshape(B, c, L, H, D).float()
    lic = li.reshape(B, c, L, H).float()
    lfc = lf.reshape(B, c, L, H).float()
    bc = torch.cumsum(lfc, dim=2)                          # [B,c,L,H]
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    if state is None:
        C_hat = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
        n_hat = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
        M = torch.full((B, H), LOG_EPS, dtype=torch.float32, device=q.device)
    else:
        C_hat, n_hat, M = state

    hs = []
    for ci in range(c):
        qb, kb, vb = qc[:, ci], kc[:, ci], vc[:, ci]       # [B,L,H,D]
        lib, bb = lic[:, ci], bc[:, ci]                     # [B,L,H]
        bT = bb.transpose(1, 2)                             # [B,H,L]
        liT = lib.transpose(1, 2)
        logD = bT[:, :, :, None] - bT[:, :, None, :] + liT[:, :, None, :]
        logD = torch.where(tril, logD, LOG_EPS)
        m_intra = logD.amax(dim=-1)                         # [B,H,L]
        m_inter = bT + M[:, :, None]
        m = torch.maximum(m_intra, m_inter)
        Dm = torch.exp(logD - m[..., None])                 # [B,H,L,L]
        scores = torch.einsum("blhd,bmhd->bhlm", qb, kb)
        w = scores * Dm
        num = torch.einsum("bhlm,bmhd->bhld", w, vb)
        num = num + torch.exp(m_inter - m)[..., None] * torch.einsum(
            "blhd,bhdv->bhlv", qb, C_hat)
        qn = w.sum(dim=-1) + torch.exp(m_inter - m) * torch.einsum(
            "blhd,bhd->bhl", qb, n_hat)
        den = torch.maximum(qn.abs(), torch.exp(-m))
        hs.append((num / den[..., None]).transpose(1, 2))   # [B,L,H,D]

        bL = bb[:, -1]                                      # [B,H]
        g = bL[:, None] - bb + lib                          # [B,L,H]
        M_new = torch.maximum(M + bL, g.amax(dim=1))
        sc_old = torch.exp(M + bL - M_new)
        sc_new = torch.exp(g - M_new[:, None])              # [B,L,H]
        # the reference's three-operand einsum "blhd,blhv,blh->bhdv", with
        # the gate folded into k first (no [B,L,H,D,D] intermediate)
        C_hat = C_hat * sc_old[..., None, None] + torch.einsum(
            "blhd,blhv->bhdv", kb * sc_new[..., None], vb)
        n_hat = n_hat * sc_old[..., None] + torch.einsum(
            "blhd,blh->bhd", kb, sc_new)
        M = M_new
    return torch.cat(hs, dim=1).to(q.dtype), (C_hat, n_hat, M)


def mlstm_decode_step(state, q_t, k_t, v_t, li_t, lf_t):
    """One-token stabilized recurrence. q/k/v_t [B,H,D]; li/lf [B,H]."""
    C_hat, n_hat, M = state
    D = q_t.shape[-1]
    q_t = q_t.float() / (D ** 0.5)
    k_t = k_t.float()
    v_t = v_t.float()
    M_new = torch.maximum(lf_t + M, li_t)
    sc_old = torch.exp(lf_t + M - M_new)
    sc_in = torch.exp(li_t - M_new)
    C_new = C_hat * sc_old[..., None, None] + sc_in[..., None, None] * (
        k_t[..., :, None] * v_t[..., None, :])
    n_new = n_hat * sc_old[..., None] + sc_in[..., None] * k_t
    num = torch.einsum("bhd,bhdv->bhv", q_t, C_new)
    qn = torch.einsum("bhd,bhd->bh", q_t, n_new)
    den = torch.maximum(qn.abs(), torch.exp(-M_new))
    h = num / den[..., None]
    return (C_new, n_new, M_new), h


# ------------------------------------------------------------- mLSTM block

def mlstm_block_init(g: torch.Generator, cfg, dtype, device) -> dict:
    """Random weights with the reference's distributions (the bits differ
    from JAX's)."""
    d = cfg.d_model
    di = 2 * d
    h = cfg.num_heads
    conv_w = torch.randn((cfg.conv_width, di), generator=g, device=device,
                         dtype=torch.float32) * 0.1
    return {
        "norm": {"scale": torch.ones(d, device=device)},
        "up": dense_init(g, d, 2 * di, dtype, device),    # (x_m, gate)
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=device),
        "wq": dense_init(g, di, di, dtype, device),
        "wk": dense_init(g, di, di, dtype, device),
        "wv": dense_init(g, di, di, dtype, device),
        "w_if": dense_init(g, di, 2 * h, dtype, device),
        "gn": torch.ones(di, device=device),
        "down": dense_init(g, di, d, dtype, device),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv over S: K shifted products summed, then b, all
    in u's dtype (the reference's op order)."""
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + u.shape[1], :] * w[i] for i in range(K)) + b


def _headnorm(y, scale, H):
    """Per-head group RMS norm; y [B,S,H,D] -> [B,S,H*D] fp32."""
    B, S = y.shape[0], y.shape[1]
    yf = y.float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6)
    return yf.reshape(B, S, -1) * scale


def mlstm_block(params, x, *, cfg, decode_state=None):
    """Full mLSTM residual block. x [B,S,D].

    decode_state None -> chunkwise parallel over S (returns out only);
    else single-token decode (S == 1) returning (out, new_state).
    """
    B, S, d = x.shape
    di = 2 * d
    H = cfg.num_heads
    hd = di // H
    xin = rmsnorm(params["norm"], x, cfg.norm_eps)
    up = xin @ params["up"]
    xm, gate = up.chunk(2, dim=-1)

    if decode_state is None:
        xc = F.silu(_causal_conv(xm, params["conv_w"], params["conv_b"]))
        new_conv = None
    else:
        hist = torch.cat([decode_state["conv"], xm], dim=1)
        xc = F.silu(torch.einsum("bkc,kc->bc", hist, params["conv_w"])
                    + params["conv_b"])[:, None, :]
        new_conv = hist[:, 1:, :]

    q = (xc @ params["wq"]).reshape(B, S, H, hd)
    k = (xc @ params["wk"]).reshape(B, S, H, hd)
    v = (xm @ params["wv"]).reshape(B, S, H, hd)
    if_raw = (xm @ params["w_if"]).float()
    li = if_raw[..., :H]                                  # log input gate
    lf = F.logsigmoid(if_raw[..., H:])

    if decode_state is None:
        hseq, _ = mlstm_chunked(q, k, v, li, lf, chunk=min(128, S))
        out = _headnorm(hseq, params["gn"], H)
        out = out * F.silu(gate.float())
        return x + (out.to(x.dtype) @ params["down"])
    st, h1 = mlstm_decode_step(decode_state["mlstm"], q[:, 0], k[:, 0],
                               v[:, 0], li[:, 0], lf[:, 0])
    out = _headnorm(h1[:, None], params["gn"], H)
    out = out * F.silu(gate.float())
    y = x + (out.to(x.dtype) @ params["down"])
    return y, {"mlstm": st, "conv": new_conv}


def mlstm_init_state(cfg, batch: int, device, lead: tuple = ()) -> dict:
    """Zero mLSTM decode state, with `lead` stacked axes in front:
    {"mlstm": (C [.., B, H, hd, hd], n [.., B, H, hd], M [.., B, H]),
    "conv": [.., B, conv_width - 1, 2d]}."""
    d = cfg.d_model
    di = 2 * d
    H = cfg.num_heads
    hd = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mlstm": (torch.zeros((*lead, batch, H, hd, hd), **f32),
                  torch.zeros((*lead, batch, H, hd), **f32),
                  torch.full((*lead, batch, H), LOG_EPS, **f32)),
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, di),
                            dtype=dtype_of(cfg), device=device),
    }


# ------------------------------------------------------------- sLSTM block

def slstm_block_init(g: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    ff = max(d * 4 // 3, 64)
    r = torch.randn((4, H, hd, hd), generator=g, device=device,
                    dtype=torch.float32) / (hd ** 0.5)
    return {
        "norm": {"scale": torch.ones(d, device=device)},
        "w_in": dense_init(g, d, 4 * d, dtype, device),   # i,f,z,o inputs
        "r": r.to(dtype),                                 # block-diag
        "gn": torch.ones(d, device=device),
        "ff_norm": {"scale": torch.ones(d, device=device)},
        "ff_up": dense_init(g, d, 2 * ff, dtype, device),
        "ff_down": dense_init(g, ff, d, dtype, device),
    }


def _slstm_cell(params, u, state, H, hd):
    """One time step. u [B, 4d] pre-activations from input; state dict."""
    return SC.slstm_step(params["r"], u, state, H, hd)


def slstm_init_state(cfg, batch: int, device, lead: tuple = ()) -> dict:
    """Zero sLSTM decode state c/n/m/h [.., B, H, hd] fp32 (m starts at
    0.0, as in the reference, not at -inf)."""
    H = cfg.num_heads
    hd = cfg.d_model // H
    return {k: torch.zeros((*lead, batch, H, hd), dtype=torch.float32,
                           device=device) for k in ("c", "n", "m", "h")}


def slstm_block(params, x, *, cfg, decode_state=None):
    """sLSTM residual block + gated FFN. x [B,S,D]."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H
    xin = rmsnorm(params["norm"], x, cfg.norm_eps)
    u = xin @ params["w_in"]                              # [B,S,4d]

    if decode_state is None:
        # K9 writes h in u's dtype; the reference's scan keeps h in fp32 up
        # to the norm below, so u goes in upcast (exact) and h comes back
        # fp32 whatever the activations' dtype.
        h = SC.slstm_seq(u.float(), params["r"]).reshape(B, S, H, hd)
        new_state = None
    else:
        st = _slstm_cell(params, u[:, 0], decode_state, H, hd)
        h = st["h"][:, None]
        new_state = st

    hf = h.float()
    var = (hf * hf).mean(dim=-1, keepdim=True)
    hf = hf * torch.rsqrt(var + 1e-6)
    out = hf.reshape(B, S, d) * params["gn"]
    x = x + out.to(x.dtype)
    # gated FFN
    xin2 = rmsnorm(params["ff_norm"], x, cfg.norm_eps)
    a, b = (xin2 @ params["ff_up"]).chunk(2, dim=-1)
    x = x + (F.silu(a) * b) @ params["ff_down"]
    if decode_state is None:
        return x
    return x, new_state

