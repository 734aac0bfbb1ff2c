"""MoE layer on the grouped-GEMM decomposition (the reference's "pallas"
backend).

Counterpart of repro/core/moe.py for the paths the port serves:

  dispatch_forward   token choice through one tile plan over the experts
                     (dropless); token-choice decode runs it.
  group_forward      C1 group multiplexing: token choice with POOLED group
                     capacity, the group's member lanes fused pairwise in
                     the tile plan (K7/K8 on a card).
  expert choice      (Zhou et al.) at prefill, whose routing output seeds
                     the GO cache.

The FFN runs through kernels/ops.py:moe_ffn_fused, i.e. the hand-written
grouped GEMMs on a card and their plain versions on the CPU.
"""
from __future__ import annotations

import functools
import math

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


def block_rows(e: MoEConfig, device) -> int:
    """The tile plan's row height: `gmm_block_rows` when set (a card's
    kernels then raise unless it is their tile), else the device's."""
    return e.gmm_block_rows or OPS.default_block_rows(device)


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
        x, tok, ef, r.weights.reshape(-1), params["experts"], E, T,
        bn=block_rows(e, x.device), max_per_token=E)
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
        params["experts"], E, B * S, bn=block_rows(e, h.device),
        max_per_token=E)
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


# ------------------------------------------------------------- token choice

def _token_pairs(x: torch.Tensor, params: dict, e: MoEConfig):
    """Token-choice routing of x [T, d] flattened to pairs, token-major:
    (routing, expert per pair [T*k] int32, weight [T*k], token [T*k])."""
    T = x.shape[0]
    r = R.token_choice(x, params["gate"], e.top_k)
    tok = torch.arange(T, dtype=torch.int32,
                       device=x.device).repeat_interleave(e.top_k)
    return r, r.expert_idx.reshape(-1), r.weights.reshape(-1), tok


def dispatch_forward(params: dict, x: torch.Tensor, e: MoEConfig) -> tuple:
    """Token choice, x [T, d] -> (y [T, d], aux): the reference's pallas
    branch, dropless (tile padding absorbs the worst case, so there is no
    capacity to pass)."""
    check_backend(e)
    reject_shared(params)
    return _dispatch_forward_pallas(params, x, e)


def _dispatch_ffn(params: dict, x: torch.Tensor, e: MoEConfig):
    """Token choice through one tile plan over the experts (dropless):
    (y [T, d] fp32, routing, plan)."""
    T = x.shape[0]
    r, ef, wf, tok = _token_pairs(x, params, e)
    y, _, plan = OPS.moe_ffn_fused(x, tok, ef, wf, params["experts"],
                                   e.num_experts, T,
                                   max_per_token=e.top_k, token_major=True,
                                   bn=block_rows(e, x.device))
    return y, r, plan


def _dispatch_forward_pallas(params: dict, x: torch.Tensor,
                             e: MoEConfig) -> tuple:
    """Token choice through one tile plan over the experts (dropless)."""
    y, r, plan = _dispatch_ffn(params, x, e)
    aux = {
        "counts": plan.counts,
        "balance_loss": R.load_balance_loss(r.scores, r.expert_idx,
                                            e.num_experts),
        "dropped": torch.zeros((), dtype=torch.int64, device=x.device),
    }
    return y.to(x.dtype), aux


# share of the group's summed expert capacities that its pooled lane buffer
# holds (the reference's `pool_factor` default, which every path uses)
POOL_FACTOR = 0.7


def group_forward(params: dict, x: torch.Tensor, e: MoEConfig,
                  group_of_expert: torch.Tensor,
                  members: torch.Tensor | None = None) -> tuple:
    """C1 — group-multiplexed token choice with POOLED group capacity.

    Experts of a group share one lane buffer of C_grp = g * C_exp *
    POOL_FACTOR slots, so a hot expert borrows slots from its cold
    group-mates. T is the row count of x, pads included: a chunk and a
    one-shot prompt pool differently, as in the reference. `members` is
    the [G, g] expert-id matrix of the deployment
    (models/model.py:expert_group_members); None derives it from
    `group_of_expert`."""
    check_backend(e)
    reject_shared(params)
    T = x.shape[0]
    E, k, g = e.num_experts, e.top_k, e.group_size
    G = E // g
    C_exp = max(1, int(math.ceil(T * k / E * e.capacity_factor)))
    C_grp = max(1, int(math.ceil(g * C_exp * POOL_FACTOR)))
    if members is None:
        members = _members_matrix(group_of_expert, G, g)
    return _group_forward_pallas(params, x, e, group_of_expert, members,
                                 C_grp)


def _group_sorted_positions(grp: torch.Tensor, ef: torch.Tensor, E: int):
    """(group, expert)-stable sort of the routed pairs and each pair's
    position within its GROUP's run: the pooled-capacity drop order
    (pos >= C_grp drops), as the reference defines it."""
    key = grp.long() * E + ef.long()
    order = torch.sort(key, stable=True)[1]
    sg = grp[order].contiguous()
    pos = (torch.arange(order.shape[0], device=grp.device)
           - torch.searchsorted(sg, sg))
    return order, sg, pos


@functools.lru_cache(maxsize=None)
def _group_fuse_pairs(E: int, g: int) -> tuple:
    """Pairwise lane fusion over the group-major lane ranks: the members of
    one C2 group pair up two at a time (an odd trailing member rides
    alone), static per deployment."""
    fuse = [0] * E
    nid = 0
    for grp in range(E // g):
        for j in range(0, g, 2):
            fuse[grp * g + j] = nid
            if j + 1 < g:
                fuse[grp * g + j + 1] = nid
            nid += 1
    return tuple(fuse)


def group_lane_map(members: torch.Tensor, group_size: int):
    """The C1 group-major lane layout: lane rank r holds expert
    `lane_of_rank[r]`, and lanes fuse pairwise within their group. Returns
    (lane_of_rank [E], rank_of_expert [E], fuse tuple [E])."""
    lane_of_rank = members.reshape(-1).to(torch.int32)
    E = lane_of_rank.shape[0]
    rank_of_expert = torch.empty(E, dtype=torch.int32,
                                 device=members.device)
    rank_of_expert[lane_of_rank.long()] = torch.arange(
        E, dtype=torch.int32, device=members.device)
    return lane_of_rank, rank_of_expert, _group_fuse_pairs(E, group_size)


def _group_forward_pallas(params: dict, x: torch.Tensor, e: MoEConfig,
                          group_of_expert: torch.Tensor,
                          members: torch.Tensor, C_grp: int) -> tuple:
    """C1 pooled-capacity semantics on the grouped GEMM: pairs past C_grp
    in the (group, expert)-stable order keep their rows but get a ZERO
    combine weight (the reference's drop, bit for bit); the tiles are
    planned in group-major lane order with each group's lanes fused
    pairwise, so a straddle tile runs through K7/K8."""
    T = x.shape[0]
    E, g = e.num_experts, e.group_size
    G = E // g
    _, ef, wf, tok = _token_pairs(x, params, e)
    grp = group_of_expert[ef.long()]
    N = ef.shape[0]
    order, _, pos = _group_sorted_positions(grp, ef, E)
    keep = torch.empty(N, dtype=torch.bool, device=x.device)
    keep[order] = pos < C_grp
    wf = torch.where(keep, wf, 0.0)
    lane_of_rank, rank_of_expert, fuse = group_lane_map(members, g)
    y, _, plan = OPS.moe_ffn_fused(
        x, tok, rank_of_expert[ef.long()], wf, params["experts"], E, T,
        expert_of_lane=lane_of_rank, max_per_token=e.top_k, token_major=True,
        bn=block_rows(e, x.device), fuse=fuse)
    aux = {
        "counts": plan.counts[rank_of_expert.long()],      # per expert
        "dropped": (~keep).sum(),
        "kept": keep,
        "slots": G * C_grp,
    }
    return y.to(x.dtype), aux


def _members_matrix(group_of_expert: torch.Tensor, G: int,
                    g: int) -> torch.Tensor:
    """[E] group ids -> [G, g] expert ids per group, ascending within a
    group."""
    E = group_of_expert.shape[0]
    key = group_of_expert.long() * E + torch.arange(
        E, device=group_of_expert.device)
    return torch.sort(key, stable=True)[1].reshape(G, g).to(torch.int32)


def token_choice_decode(params: dict, x: torch.Tensor,
                        e: MoEConfig) -> torch.Tensor:
    """Token-choice decode, x [B, d] one token per row (free and retired
    pool rows included, as in the reference) -> y [B, d]: dispatch_forward
    without its aux outputs, which no decode step reads (the reference's
    jit drops them)."""
    check_backend(e)
    reject_shared(params)
    return _dispatch_ffn(params, x, e)[0].to(x.dtype)


def moe_forward(params: dict, x: torch.Tensor, e: MoEConfig,
                group_of_expert=None, group_members=None) -> tuple:
    """Router for the full-sequence token-choice paths; x [T, d]."""
    if e.routing == "expert_choice":
        return expert_choice_forward(params, x, e)
    if e.use_grouped_gemm and e.group_size > 1 and group_of_expert is not None:
        return group_forward(params, x, e, group_of_expert,
                             members=group_members)
    return dispatch_forward(params, x, e)
