"""MoE routing: token choice (eq. 1-3), expert choice, and the paper's
incremental TopKUpdate (eq. 4-5).

Counterpart of repro/core/routing.py. `jax.lax.top_k` breaks ties toward
the lower index and the GO cache relies on it, while `torch.topk` promises
no order on ties; every top-k here goes through `stable_topk`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis; equal values keep ascending index order
    (jax.lax.top_k's tie rule). Returns (values, indices int64)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class TokenChoiceRouting(NamedTuple):
    expert_idx: torch.Tensor  # [T, k] int32 chosen experts per token
    weights: torch.Tensor     # [T, k] fp32 combine weights (softmax over k)
    scores: torch.Tensor      # [T, E] fp32 raw gate scores (pre-softmax)


class ExpertChoiceRouting(NamedTuple):
    token_idx: torch.Tensor   # [E, C] int32 tokens chosen by each expert
    weights: torch.Tensor     # [E, C] fp32 combine weights G[t, e]
    scores: torch.Tensor      # [T, E] fp32 gate affinities (softmax over E)


def gate_scores(x: torch.Tensor, w_gate: torch.Tensor) -> torch.Tensor:
    """x [T, d] -> raw scores [T, E] in fp32."""
    return x.float() @ w_gate.float()


def token_choice(x: torch.Tensor, w_gate: torch.Tensor,
                 k: int) -> TokenChoiceRouting:
    """Eq. (1)-(2): softmax(KeepTopK(x W_G, k)), the softmax over the k
    kept scores."""
    s = gate_scores(x, w_gate)                             # [T, E]
    top_s, top_i = stable_topk(s, k)                       # [T, k]
    return TokenChoiceRouting(top_i.to(torch.int32),
                              torch.softmax(top_s, dim=-1), s)


def load_balance_loss(scores: torch.Tensor, expert_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Shazeer-style auxiliary loss (importance * load) for token choice;
    a scalar fp32 tensor."""
    g = torch.softmax(scores, dim=-1)                      # [T, E]
    importance = g.mean(dim=0)
    k = expert_idx.shape[-1]
    onehot = torch.nn.functional.one_hot(expert_idx.long(), num_experts)
    load = onehot.sum(dim=1).float().mean(dim=0) / max(1, k)
    return num_experts * torch.sum(importance * load) * k


def expert_choice(x: torch.Tensor, w_gate: torch.Tensor, capacity: int,
                  valid_len: int | None = None) -> ExpertChoiceRouting:
    """Zhou et al. expert choice: G = softmax over experts; each expert takes
    its top-`capacity` tokens by affinity. x may carry leading batch axes
    ([..., T, d]); routing stays per sequence. `valid_len` zeroes the
    affinities of positions >= valid_len before the selection, so a pad
    never outranks a real token."""
    g = torch.softmax(gate_scores(x, w_gate), dim=-1)      # [..., T, E]
    if valid_len is not None:
        T = x.shape[-2]
        keep = torch.arange(T, device=x.device) < valid_len
        g = g * keep[:, None]
    top_g, top_t = stable_topk(g.transpose(-1, -2), capacity)   # [..., E, C]
    return ExpertChoiceRouting(top_t.to(torch.int32), top_g, g)


class TopKUpdateResult(NamedTuple):
    new_scores: torch.Tensor     # [..., E, k] updated cached top-k scores
    new_token_ids: torch.Tensor  # [..., E, k] updated token ids per slot
    selected: torch.Tensor       # [..., E] bool: expert took the new token
    slot: torch.Tensor           # [..., E] int32 slot replaced (where selected)


def topk_update(s_prev: torch.Tensor, tok_prev: torch.Tensor,
                s_new: torch.Tensor, new_token_id) -> TopKUpdateResult:
    """Paper eq. (5): per expert, a new score at least the cached minimum
    replaces that minimum's slot (the FIRST minimum, as jnp.argmin picks);
    otherwise the cache is unchanged. Leading axes broadcast; the JAX
    function is vmapped over the batch instead."""
    slot = torch.argmin(s_prev, dim=-1)                   # first minimum
    cur_min = torch.gather(s_prev, -1, slot[..., None])[..., 0]
    selected = s_new >= cur_min
    k = s_prev.shape[-1]
    onehot = slot[..., None] == torch.arange(k, device=s_prev.device)
    upd = selected[..., None] & onehot
    new_scores = torch.where(upd, s_new[..., None], s_prev)
    if torch.is_tensor(new_token_id):
        tid = new_token_id.to(tok_prev.dtype)
        if tid.ndim:
            tid = tid[..., None, None]                    # [B] -> [B, 1, 1]
    else:
        tid = int(new_token_id)     # a scalar operand: no host-to-device copy
    new_tok = torch.where(upd, tid, tok_prev)
    return TopKUpdateResult(new_scores, new_tok, selected,
                            slot.to(torch.int32))
