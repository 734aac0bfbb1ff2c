"""Mamba2 (SSD, state-space duality) block: chunked-parallel forward and the
recurrent decode step.

Counterpart of repro/models/ssm.py, same functions, same op order. The
minimal-SSD form of the Mamba2 paper: a scalar A per head, B and C shared
by the heads (ngroups 1), a short causal conv over (x, B, C), and a
chunked scan (the quadratic term inside a chunk, a state recurrence across
chunks). Decode is the O(1) recurrence on the [H, P, N] state. Plain
PyTorch: the reference has no TPU kernel here.

The reference's three- and four-operand einsums accumulate in fp32
(`preferred_element_type`) with x in the config's dtype; torch.einsum
takes one dtype, so x is upcast first and the operands are contracted in
pairs, never through a [b, c, l, m, h, p] temporary. Each path keeps the
reference's own rounding: the chunked forward rounds y to x's dtype before
the gated RMSNorm, the decode step hands ssd_decode_step fp32 x_t, so its y
stays fp32 up to the norm. At bf16 the two paths differ by design.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dtype_of
from repro_torch.models.xlstm import _causal_conv


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., L] -> [..., L, L] lower-triangular segment sums:
    out[i, j] = sum_{k=j+1..i} x[k] for j < i, 0 for i == j, -inf above."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(L, device=x.device)
    return torch.where(i[:, None] >= i[None, :], out, float("-inf"))


def ssd_chunked(x, dt, A, B, C, D_skip, chunk: int):
    """SSD forward. x [b, s, h, p] per-head inputs; dt [b, s, h] positive
    step sizes; A [h] negative scalars; B, C [b, s, n] (fp32); D_skip [h].
    The chunk length shrinks to the largest divisor of s not above `chunk`.
    Returns y [b, s, h, p] in x's dtype and the final state [b, h, p, n]
    fp32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    while s % L:
        L -= 1
    c = s // L

    xc = x.reshape(b, c, L, h, p).float()
    dtc = dt.reshape(b, c, L, h)
    Bc = B.reshape(b, c, L, n)
    Cc = C.reshape(b, c, L, n)

    dA = dtc * A                                                  # [b,c,L,h]
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic within a chunk)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))             # [b,c,h,L,L]
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)              # [b,c,L,L]
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", scores[:, :, None] * Lmat,
                          dtc[..., None] * xc)

    # chunk states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)         # [b,c,L,h]
    states = torch.einsum("bclhp,bcln->bchpn",
                          (dtc * decay_states)[..., None] * xc, Bc)

    # inter-chunk recurrence over c; each chunk sees the state entering it
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                   # [b,c,h]
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for ci in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                        # [b,c,h,p,n]

    # inter-chunk contribution to the outputs
    state_decay = torch.exp(dA_cs)                                # [b,c,L,h]
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc,
                         prev_states) * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p) + x * D_skip[None, None, :, None]
    return y.to(x.dtype), carry


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D_skip):
    """One-token recurrence. state [b, h, p, n]; x_t [b, h, p]; dt_t [b, h];
    B_t, C_t [b, n]. Returns (new state, y [b, h, p] in x_t's dtype)."""
    dA = torch.exp(dt_t * A)                                      # [b,h]
    upd = (dt_t[..., None] * x_t)[..., None] * B_t[:, None, None, :]
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C_t) + x_t * D_skip[None, :, None]
    return state, y.to(x_t.dtype)


# ------------------------------------------------------------- mamba2 block

def mamba2_init(g: torch.Generator, cfg, device) -> dict:
    """Random weights with the reference's distributions (the bits differ
    from JAX's); A_log, D, dt_bias and norm_scale stay fp32 in any
    dtype."""
    d = cfg.d_model
    di = 2 * d
    n = cfg.ssm_state
    h = cfg.num_heads
    dt = dtype_of(cfg)
    conv_ch = di + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.conv_width, conv_ch), generator=g, **f32) * 0.1
    return {
        "in_proj": dense_init(g, d, 2 * di + 2 * n + h, dt, device),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, float(h), h, **f32)),
        "D": torch.ones(h, **f32),
        "dt_bias": torch.zeros(h, **f32),
        "out_proj": dense_init(g, di, d, dt, device),
        "norm_scale": torch.ones(di, **f32),
    }


def _mamba2_project(params, x, cfg):
    """x @ in_proj split into (z, x, B, C, dt) and the widths."""
    di = 2 * cfg.d_model
    n = cfg.ssm_state
    h = cfg.num_heads
    z, xs, Bc, Cc, dt = torch.split(x @ params["in_proj"],
                                    [di, di, n, n, h], dim=-1)
    return z, xs, Bc, Cc, dt, di, n, h


def _gated_norm_out(params, y, z, dtype):
    """Mamba2's gated RMSNorm over y * silu(z) in fp32, then out_proj."""
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * params["norm_scale"]
    return yf.to(dtype) @ params["out_proj"]


def mamba2_forward(params, x, *, cfg):
    """x [B, S, D] -> [B, S, D] (full-sequence chunked SSD)."""
    z, xs, Bc, Cc, dt, di, n, h = _mamba2_project(params, x, cfg)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"]))
    xs, Bc, Cc = torch.split(conv_out, [di, n, n], dim=-1)
    b, s = x.shape[0], x.shape[1]
    p = di // h
    dt_pos = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, _ = ssd_chunked(xs.reshape(b, s, h, p), dt_pos, A, Bc.float(),
                       Cc.float(), params["D"], cfg.ssm_chunk)
    return _gated_norm_out(params, y.reshape(b, s, di), z, x.dtype)


def mamba2_init_state(cfg, batch: int, device, lead: tuple = ()) -> dict:
    """Zero decode state, with `lead` stacked axes in front: "ssm"
    [.., B, H, P, N] fp32 and "conv" [.., B, K - 1, di + 2n] in the
    config's dtype."""
    di = 2 * cfg.d_model
    h = cfg.num_heads
    return {
        "ssm": torch.zeros((*lead, batch, h, di // h, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1,
                             di + 2 * cfg.ssm_state),
                            dtype=dtype_of(cfg), device=device),
    }


def mamba2_decode(params, x_t, state, *, cfg):
    """x_t [B, 1, D]; state {"ssm", "conv"} -> (y [B, 1, D], new state)."""
    z, xs, Bc, Cc, dt, di, n, h = _mamba2_project(params, x_t, cfg)
    hist = torch.cat([state["conv"], torch.cat([xs, Bc, Cc], dim=-1)],
                     dim=1)                                       # [B,K,C]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, params["conv_w"])
                      + params["conv_b"])
    xs, Bc, Cc = torch.split(conv_out, [di, n, n], dim=-1)
    b = x_t.shape[0]
    dt_pos = F.softplus(dt[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    new_ssm, y = ssd_decode_step(
        state["ssm"], xs.reshape(b, h, di // h).float(), dt_pos, A,
        Bc.float(), Cc.float(), params["D"])
    out = _gated_norm_out(params, y.reshape(b, 1, di), z, x_t.dtype)
    return out, {"ssm": new_ssm, "conv": hist[:, 1:, :]}
