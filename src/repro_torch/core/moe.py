"""MoE layer on two realizations, selected by `MoEConfig.backend`
(`resolve_backend`).

Counterpart of repro/core/moe.py:

  dispatch_forward   token choice; token-choice decode runs it.
  group_forward      C1 group multiplexing: token choice with POOLED group
                     capacity.
  expert choice      (Zhou et al.) at prefill and in training, whose routing
                     output seeds the GO cache.
  dense_forward      the oracle: every expert over every token, masked.

"auto" and "pallas" run the grouped-GEMM decomposition: kernels/ops.py's
moe_ffn_fused, i.e. the hand-written grouped GEMMs on a card and their
plain versions on the CPU (dropless dispatch; the group path's pooled
overflow as zero combine weights, its member lanes fused pairwise). "xla"
is the reference's masked, capacity-padded einsum realization: [E, C, d]
capacity buffers for dispatch, pooled [G, C_grp, d] lanes masked over the
g members for the group path, a gather of each expert's top-C tokens for
expert choice. It is the one autograd trains through; its gathers and
sums run through models/layers.py `take_rows` / `add_rows`, whose
gradients are sums in a fixed order on every device. Both realizations
drop pairs by the one order `_expert_positions` / `_group_sorted_positions`
define. Always-on shared experts (deepseek-style, `params["shared"]`) add
`_shared_out` to every path's output, as plain products outside the
grouped GEMM, where the reference adds them.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import routing as R
from repro_torch.kernels import ops as OPS
from repro_torch.models.layers import add_rows, take_rows


def resolve_backend(e: MoEConfig, refs=None) -> str:
    """`MoEConfig.backend` -> "xla" (the masked einsum realization) or
    "pallas" (the grouped-GEMM decomposition, which "auto" also means:
    whether its kernels or their plain versions run follows the tensors'
    device, never a fallback).

    Pass the layer's inputs and params (tensors, or dicts and sequences of
    them) as `refs`: an EXPLICIT "pallas" then raises where autograd would
    need its gradient (grad mode on and any of them requires grad), as the
    reference fails fast under a JAX grad trace. The CUDA kernels have no
    backward pass (their wrappers raise too)."""
    b = e.backend
    if b not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown MoE backend: {b!r}")
    if b == "pallas" and refs is not None and _under_autograd(refs):
        raise NotImplementedError(
            "pallas backend has no backward pass yet; use backend='auto' or "
            "'xla' for training (loss_fn already pins 'auto' to xla — see "
            "ROADMAP: custom VJP over gmm/gmm_swiglu)")
    return "xla" if b == "xla" else "pallas"


def _under_autograd(refs) -> bool:
    """Grad mode is on and a tensor of `refs` requires grad."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(refs, dict):
        return any(_under_autograd(v) for v in refs.values())
    if isinstance(refs, (tuple, list)):
        return any(_under_autograd(v) for v in refs)
    return torch.is_tensor(refs) and refs.requires_grad


def block_rows(e: MoEConfig, device) -> int:
    """The tile plan's row height: `gmm_block_rows` when set (a card's
    kernels then raise unless it is their tile), else the device's."""
    return e.gmm_block_rows or OPS.default_block_rows(device)


def ec_capacity(num_tokens: int, e: MoEConfig) -> int:
    """Expert-choice capacity: on average top_k experts per token."""
    return max(1, (num_tokens * e.top_k) // e.num_experts)


def _shared_out(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Always-on shared experts (deepseek-style), x [T, d] -> [T, d] in
    x's dtype: each shared expert's SwiGLU FFN, one contraction over
    (expert, hidden), as the reference's `stf,sfd->td`. Zero without a
    `"shared"` bank."""
    if "shared" not in params:
        return torch.zeros_like(x)
    sh = params["shared"]
    h = torch.nn.functional.silu(torch.einsum("td,sdf->stf", x, sh["wg"])) \
        * torch.einsum("td,sdf->stf", x, sh["wi"])
    return torch.einsum("stf,sfd->td", h, sh["wo"]).to(x.dtype)


def add_shared(params: dict, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y + _shared_out(params, x): the MoE output with the shared experts'
    added; y itself without a shared bank (no zeros launched for a model
    that has none)."""
    return y + _shared_out(params, x) if "shared" in params else y


def _bincount(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each value 0..n-1 along idx's last axis, [..., n]
    int64 (an integer scatter-add: bincount would read its size back to
    the host)."""
    out = torch.zeros((*idx.shape[:-1], n), dtype=torch.int64,
                      device=idx.device)
    return out.scatter_add_(-1, idx.long(), torch.ones_like(
        idx, dtype=torch.int64))


def expert_choice_forward(params: dict, x: torch.Tensor, e: MoEConfig,
                          valid_len=None) -> tuple:
    """One sequence, x [T, d] -> (y [T, d], aux): each expert gathers its
    top-C tokens; aux carries what the GO cache needs. `valid_len` masks
    positions >= valid_len out of the routing."""
    if resolve_backend(e, (x, params)) == "xla":
        return _expert_choice_forward_xla(params, x, e, valid_len)
    T, d = x.shape
    cap = ec_capacity(T, e)
    E = e.num_experts
    r = R.expert_choice(x, params["gate"], cap, valid_len=valid_len)
    ef = torch.arange(E, dtype=torch.int32,
                      device=x.device).repeat_interleave(cap)
    tok = r.token_idx.reshape(-1)
    y, y_rows, plan = OPS.moe_ffn_fused(
        x, tok, ef, r.weights.reshape(-1), params["experts"], E, T,
        bn=block_rows(e, x.device), max_per_token=E)
    contrib = OPS.gather_rows(y_rows, plan).reshape(E, cap, d)     # fp32
    aux = {
        "counts": _bincount(r.token_idx.reshape(-1), T),
        "chosen_tokens": r.token_idx,
        "chosen_scores": r.weights,
        "weighted_outputs": contrib.to(x.dtype),                  # [E, C, d]
        "scores": r.scores,
    }
    return add_shared(params, y.to(x.dtype), x), aux


def expert_choice_forward_batched(params: dict, h: torch.Tensor,
                                  e: MoEConfig, valid_len=None) -> tuple:
    """h [B, S, d] -> (y [B, S, d], aux with a leading batch axis). Routing
    stays per sequence (the GO cache's semantics), but the FFN pairs of the
    whole batch go through ONE tile plan, so the grouped GEMM pays its
    per-expert tile padding once, not B times. `valid_len` (an int; the
    last, right-padded prefill chunk) masks positions >= valid_len out of
    the routing, so a pad never wins an expert slot. The grouped-GEMM
    realization only: "xla" runs expert_choice_forward per sequence."""
    resolve_backend(e, (h, params))
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
    y = add_shared(params, y.to(h.dtype), h.reshape(B * S, d)).reshape(
        B, S, d)
    counts = _bincount(r.token_idx.reshape(B, -1), S)
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


def dispatch_forward(params: dict, x: torch.Tensor, e: MoEConfig,
                     capacity: int = 0) -> tuple:
    """Token choice, x [T, d] -> (y [T, d], aux). The grouped GEMM is
    dropless (tile padding absorbs the worst case); "xla" packs [E, C, d]
    capacity buffers, C = `capacity` or ceil(T k / E * capacity_factor),
    and drops each expert's pairs past C in the expert-stable order."""
    if resolve_backend(e, (x, params)) == "xla":
        return _dispatch_forward_xla(params, x, e, capacity)
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
    return add_shared(params, y.to(x.dtype), x), aux


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
    `group_of_expert`. Both realizations drop the same pairs: those past
    C_grp in the (group, expert)-stable order."""
    backend = resolve_backend(e, (x, params))
    T = x.shape[0]
    E, k, g = e.num_experts, e.top_k, e.group_size
    G = E // g
    C_exp = max(1, int(math.ceil(T * k / E * e.capacity_factor)))
    C_grp = max(1, int(math.ceil(g * C_exp * POOL_FACTOR)))
    if members is None:
        members = _members_matrix(group_of_expert, G, g)
    if backend == "xla":
        return _group_forward_xla(params, x, e, group_of_expert, members,
                                  C_grp)
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
    return add_shared(params, y.to(x.dtype), x), aux


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
    jit drops them), shared experts included. Dropless on both
    realizations: "xla" sizes its capacity for the worst case, every row
    picking the same expert."""
    if resolve_backend(e, (x, params)) == "xla":
        return _dispatch_forward_xla(params, x, e,
                                     max(1, x.shape[0] * e.top_k))[0]
    return add_shared(params, _dispatch_ffn(params, x, e)[0].to(x.dtype), x)


def moe_forward(params: dict, x: torch.Tensor, e: MoEConfig,
                group_of_expert=None, group_members=None) -> tuple:
    """Router for the full-sequence token-choice paths; x [T, d]."""
    if e.routing == "expert_choice":
        return expert_choice_forward(params, x, e)
    if e.use_grouped_gemm and e.group_size > 1 and group_of_expert is not None:
        return group_forward(params, x, e, group_of_expert,
                             members=group_members)
    return dispatch_forward(params, x, e)


# ------------------------------------------------ the "xla" realization

def _expert_gemm(bank: dict, x: torch.Tensor) -> torch.Tensor:
    """x [E, C, d] -> [E, C, d] through each expert's SwiGLU FFN."""
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", x, bank["wg"])) \
        * torch.einsum("ecd,edf->ecf", x, bank["wi"])
    return torch.einsum("ecf,efd->ecd", h, bank["wo"])


def expert_ffn_all(params: dict, x: torch.Tensor) -> torch.Tensor:
    """All-expert outputs for a token batch, x [B, d] -> [B, E, d]: the GO
    decode step's dense fallback on "xla", and the oracle's."""
    b = params["experts"]
    h = torch.nn.functional.silu(torch.einsum("td,edf->etf", x, b["wg"])) \
        * torch.einsum("td,edf->etf", x, b["wi"])
    return torch.einsum("etf,efd->ted", h, b["wo"])


def dense_forward(params: dict, x: torch.Tensor, e: MoEConfig) -> torch.Tensor:
    """Reference oracle, x [T, d] -> [T, d]: every expert over every token,
    masked by the routing's combine weights; no capacity limits (expert
    choice takes its exact top-C over the whole batch)."""
    T = x.shape[0]
    eo = expert_ffn_all(params, x)                               # [T, E, d]
    if e.routing == "token_choice":
        r = R.token_choice(x, params["gate"], e.top_k)
        mask = torch.zeros((T, e.num_experts), dtype=torch.float32,
                           device=x.device).scatter(
            1, r.expert_idx.long(), r.weights)
    else:
        r = R.expert_choice(x, params["gate"], ec_capacity(T, e))
        mask = torch.zeros((e.num_experts, T), dtype=torch.float32,
                           device=x.device).scatter(
            1, r.token_idx.long(), r.weights).T
    y = torch.einsum("te,ted->td", mask, eo.float())
    return (y + _shared_out(params, x).float()).to(x.dtype)


class DispatchPlan(NamedTuple):
    x_disp: torch.Tensor     # [E, C, d] dispatched tokens (zeros where empty)
    dest: torch.Tensor       # [N] flat slot (E*C = dropped)
    weights: torch.Tensor    # [N] combine weights
    token: torch.Tensor      # [N] source token per pair
    counts: torch.Tensor     # [E] tokens routed per expert (pre-capacity)


def _expert_positions(expert_flat: torch.Tensor):
    """Stable expert sort of the routed pairs and each pair's position
    within its expert's run: THE capacity-eviction order. The buffer
    eviction here and the grouped GEMM's `capacity` (its plan's `pos`, the
    same rank) drop the same pairs."""
    N = expert_flat.shape[0]
    se, order = torch.sort(expert_flat, stable=True)
    pos = torch.arange(N, device=expert_flat.device) - torch.searchsorted(
        se, se)
    return order, se, pos


def _pack(x: torch.Tensor, dest: torch.Tensor, token: torch.Tensor,
          slots: int) -> torch.Tensor:
    """Capacity buffer [slots, d]: slot dest[j] holds x[token[j]], zeros
    where no pair landed; dest == slots drops the pair. One gather of x's
    rows (a zero row appended), so every row's gradient is a sum in a
    fixed order."""
    T = x.shape[0]
    src = torch.full((slots + 1,), T, dtype=torch.long, device=x.device)
    src[dest] = token.long()        # duplicates only on the dropped slot
    xz = torch.cat([x, x.new_zeros((1, x.shape[-1]))])
    return take_rows(xz, src[:slots])


def _plan_dispatch(x, expert_flat, weights_flat, token_flat, E: int,
                   C: int) -> DispatchPlan:
    N = expert_flat.shape[0]
    order, se, pos = _expert_positions(expert_flat)
    dest_sorted = torch.where(pos < C, se.long() * C + pos, E * C)
    dest = torch.empty(N, dtype=torch.long, device=x.device)
    dest[order] = dest_sorted
    x_disp = _pack(x, dest, token_flat, E * C).reshape(E, C, -1)
    return DispatchPlan(x_disp, dest, weights_flat, token_flat,
                        _bincount(expert_flat, E))


def _combine(y_disp: torch.Tensor, plan: DispatchPlan, T: int,
             out_dtype) -> torch.Tensor:
    """Each pair reads its slot (a dropped one the appended zero row),
    times its combine weight in fp32; each token's k pairs summed (the
    pairs come k per token in token order: a reshape and one sum)."""
    d = y_disp.shape[-1]
    flat = torch.cat([y_disp.reshape(-1, d), y_disp.new_zeros((1, d))])
    y_pairs = take_rows(flat, plan.dest).float() * plan.weights[:, None]
    k = plan.dest.shape[0] // T
    return OPS.combine_pairs(y_pairs, plan.token, T, k,
                             token_major=True).to(out_dtype)


def _dispatch_forward_xla(params: dict, x: torch.Tensor, e: MoEConfig,
                          capacity: int = 0) -> tuple:
    T = x.shape[0]
    E, k = e.num_experts, e.top_k
    C = capacity or max(1, int(math.ceil(T * k / E * e.capacity_factor)))
    r, ef, wf, tok = _token_pairs(x, params, e)
    plan = _plan_dispatch(x, ef, wf, tok, E, C)
    y_disp = _expert_gemm(params["experts"], plan.x_disp)
    y = add_shared(params, _combine(y_disp, plan, T, x.dtype), x)
    aux = {
        "counts": plan.counts,
        "balance_loss": R.load_balance_loss(r.scores, r.expert_idx, E),
        "dropped": (plan.dest == E * C).sum(),
        "kept": plan.dest != E * C,
    }
    return y, aux


def _group_forward_xla(params: dict, x: torch.Tensor, e: MoEConfig,
                       group_of_expert: torch.Tensor, members: torch.Tensor,
                       C_grp: int) -> tuple:
    """Pairs dispatch by GROUP into pooled [G, C_grp, d] lanes, rows sorted
    by (group, expert); each of the g members runs over its whole lane and
    keeps its own rows (g x redundant FLOPs, the reference's masked XLA
    realization)."""
    T = x.shape[0]
    E, g = e.num_experts, e.group_size
    G = E // g
    r, ef, wf, tok = _token_pairs(x, params, e)
    grp = group_of_expert[ef.long()]
    N = ef.shape[0]
    order, sg, pos = _group_sorted_positions(grp, ef, E)
    dest_sorted = torch.where(pos < C_grp, sg.long() * C_grp + pos,
                              G * C_grp)
    dest = torch.empty(N, dtype=torch.long, device=x.device)
    dest[order] = dest_sorted
    x_disp = _pack(x, dest, tok, G * C_grp).reshape(G, C_grp, -1)
    row_expert = torch.full((G * C_grp + 1,), -1, dtype=torch.int32,
                            device=x.device)
    row_expert[dest] = ef.to(torch.int32)
    row_expert = row_expert[:-1].reshape(G, C_grp)
    bank = params["experts"]
    y_disp = torch.zeros(x_disp.shape, dtype=torch.float32, device=x.device)
    for j in range(g):
        eid = members[:, j]                                       # [G]
        wg, wi, wo = (take_rows(bank[n], eid) for n in ("wg", "wi", "wo"))
        h = torch.nn.functional.silu(
            torch.einsum("gcd,gdf->gcf", x_disp, wg)) * torch.einsum(
            "gcd,gdf->gcf", x_disp, wi)
        yj = torch.einsum("gcf,gfd->gcd", h, wo)
        m = (row_expert == eid[:, None])[..., None]
        y_disp = y_disp + torch.where(m, yj.float(), 0.0)
    plan = DispatchPlan(x_disp, dest, wf, tok, _bincount(ef, E))
    y = add_shared(params, _combine(y_disp.to(x.dtype), plan, T, x.dtype), x)
    aux = {
        "counts": plan.counts,
        "balance_loss": R.load_balance_loss(r.scores, r.expert_idx, E),
        "dropped": (dest == G * C_grp).sum(),
        "kept": dest != G * C_grp,
        "slots": G * C_grp,
    }
    return y, aux


def _expert_choice_forward_xla(params: dict, x: torch.Tensor, e: MoEConfig,
                               valid_len=None) -> tuple:
    """Each expert gathers its top-C tokens [E, C, d], runs its FFN over
    them, and the weighted rows sum back per token."""
    T, d = x.shape
    r = R.expert_choice(x, params["gate"], ec_capacity(T, e),
                        valid_len=valid_len)
    y_disp = _expert_gemm(params["experts"], take_rows(x, r.token_idx))
    contrib = y_disp.float() * r.weights[..., None]               # [E, C, d]
    out = add_rows(contrib.reshape(-1, d), r.token_idx.reshape(-1), T)
    aux = {
        "counts": _bincount(r.token_idx.reshape(-1), T),
        "chosen_tokens": r.token_idx,
        "chosen_scores": r.weights,
        "weighted_outputs": contrib.to(x.dtype),                  # [E, C, d]
        "scores": r.scores,
    }
    return add_shared(params, out.to(x.dtype), x), aux
