"""MoE layer, expert-choice routing on the grouped-GEMM decomposition.

Counterpart of repro/core/moe.py for the slice the port serves: expert
choice (Zhou et al.) at prefill, whose routing output seeds the GO cache.
The FFN runs through kernels/ops.py:moe_ffn_fused, i.e. the hand-written
grouped GEMMs on a card and their plain versions on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import routing as R
from repro_torch.kernels import ops as OPS


def check_backend(e: MoEConfig) -> None:
    """`MoEConfig.backend`: "auto" and "pallas" both mean the grouped-GEMM
    decomposition (the JAX `pallas` backend's); whether its kernels or
    their plain versions run follows the tensors' device, never a
    fallback. "xla" is not ported yet."""
    b = e.backend
    if b in ("auto", "pallas"):
        return
    if b == "xla":
        raise NotImplementedError(
            "MoE backend 'xla' (the masked-einsum realization) is not ported "
            "yet: ROADMAP.md Queue 1 item 4 (the MoE layer's other paths)")
    raise ValueError(f"unknown MoE backend: {b!r}")


def ec_capacity(num_tokens: int, e: MoEConfig) -> int:
    """Expert-choice capacity: on average top_k experts per token."""
    return max(1, (num_tokens * e.top_k) // e.num_experts)


def reject_shared(params: dict) -> None:
    """Raise on always-on shared experts (deepseek-style): the served model
    has none, and a config with them is not ported yet. Without them the
    reference's shared output is zero, so nothing is added."""
    if "shared" in params:
        raise NotImplementedError(
            "shared experts are not ported yet (ROADMAP.md Queue 1 item 4)")


def _token_counts(token_idx: torch.Tensor, T: int) -> torch.Tensor:
    """[B, n] chosen token ids -> [B, T] experts per token (a scatter-add:
    bincount would read its size back to the host)."""
    out = torch.zeros((token_idx.shape[0], T), dtype=torch.int64,
                      device=token_idx.device)
    return out.scatter_add_(1, token_idx.long(), torch.ones_like(
        token_idx, dtype=torch.int64))


def expert_choice_forward(params: dict, x: torch.Tensor,
                          e: MoEConfig) -> tuple:
    """One sequence, x [T, d] -> (y [T, d], aux): each expert gathers its
    top-C tokens; aux carries what the GO cache needs."""
    check_backend(e)
    reject_shared(params)
    T, d = x.shape
    cap = ec_capacity(T, e)
    E = e.num_experts
    r = R.expert_choice(x, params["gate"], cap)
    ef = torch.arange(E, dtype=torch.int32,
                      device=x.device).repeat_interleave(cap)
    tok = r.token_idx.reshape(-1)
    y, y_rows, plan = OPS.moe_ffn_fused(
        x, tok, ef, r.weights.reshape(-1), params["experts"], E, T)
    contrib = OPS.gather_rows(y_rows, plan).reshape(E, cap, d)     # fp32
    aux = {
        "counts": _token_counts(r.token_idx.reshape(1, -1), T)[0],
        "chosen_tokens": r.token_idx,
        "chosen_scores": r.weights,
        "weighted_outputs": contrib.to(x.dtype),                  # [E, C, d]
        "scores": r.scores,
    }
    return y.to(x.dtype), aux


def expert_choice_forward_batched(params: dict, h: torch.Tensor,
                                  e: MoEConfig, valid_len=None) -> tuple:
    """h [B, S, d] -> (y [B, S, d], aux with a leading batch axis). Routing
    stays per sequence (the GO cache's semantics), but the FFN pairs of the
    whole batch go through ONE tile plan, so the grouped GEMM pays its
    per-expert tile padding once, not B times. `valid_len` (an int; the
    last, right-padded prefill chunk) masks positions >= valid_len out of
    the routing, so a pad never wins an expert slot."""
    check_backend(e)
    reject_shared(params)
    B, S, d = h.shape
    cap = ec_capacity(S, e)
    E = e.num_experts
    r = R.expert_choice(h, params["gate"], cap, valid_len=valid_len)
    ef = torch.arange(E, dtype=torch.int32,
                      device=h.device).repeat_interleave(cap).repeat(B)
    offs = torch.arange(B, dtype=torch.int32, device=h.device) * S
    tok = (r.token_idx + offs[:, None, None]).reshape(-1)
    y, y_rows, plan = OPS.moe_ffn_fused(
        h.reshape(B * S, d), tok, ef, r.weights.reshape(-1),
        params["experts"], E, B * S)
    contrib = OPS.gather_rows(y_rows, plan).reshape(B, E, cap, d)
    y = y.reshape(B, S, d).to(h.dtype)
    counts = _token_counts(r.token_idx.reshape(B, -1), S)
    aux = {
        "counts": counts,
        "chosen_tokens": r.token_idx,
        "chosen_scores": r.weights,
        "weighted_outputs": contrib.to(h.dtype),                  # [B,E,C,d]
        "scores": r.scores,
    }
    return y, aux
