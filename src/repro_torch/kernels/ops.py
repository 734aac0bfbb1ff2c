"""The tile-dispatch planner and the MoE executors over the grouped GEMMs.

Counterpart of repro/kernels/ops.py without the local-expert window
(`num_local=0`); the host-side `PlanCache` is not ported yet.

`plan_tile_dispatch` sorts (token, expert) pairs into lane runs padded to
row tiles of `bn` rows, so each tile of the grouped GEMM reads one expert's
weights. With `fuse` (C2 lane fusion) the two lanes of a fusion pair
concatenate unpadded and round to the tile boundary together: at most one
tile per pair straddles both lanes, and the kernels resolve it per row
(`row_sel`) with a second weight stream (`tile_expert2`). Every shape is
static; no step reads a value back to the host.

  moe_ffn_fused     (token, expert) pairs -> combined [T, d] output, the
                    combine weights applied in the K2/K8 epilogue; each
                    token's pair rows are then summed in pair order
                    (`combine_pairs`: a reshape for token-major pairs, else
                    a sort and a gather, then one reduction; no float
                    atomics, so repeated runs on a card agree bit for bit).
  go_selected_ffn   C4 decode: only the pairs the TopKUpdate selected
                    (`go_plan_ffn` over a lane plan: the router's, or one
                    built here with `go_topk.go_lane_plan`).
  go_decode_budget  the reference's fast-plan row budget a lane, a rule
                    of shapes; the port's decode keeps the full plan.
  expert_ffn_gmm    tile-aligned rows through each tile's expert FFN (K1
                    then K6), uncombined.
  moe_ffn_pallas    [T, k] routing -> [T, d] through moe_ffn_fused.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.go_topk import GOPlan, go_lane_plan
from repro_torch.kernels.moe_gmm import (KERNEL_BLOCK_ROWS, gmm,
                                         gmm_scaled, gmm_swiglu)

_I32 = torch.int32


def default_block_rows(device: torch.device | str) -> int:
    """Row-tile height: the CUDA kernels' 64-row tile on a card (one block
    per tile, 4 wmma row fragments); 8 on the CPU, the JAX package's value
    off the TPU, so plans compare field by field with the reference."""
    return KERNEL_BLOCK_ROWS if torch.device(device).type == "cuda" else 8


class TilePlan(NamedTuple):
    dest: torch.Tensor          # [N] packed row per pair
    row_pair: torch.Tensor      # [n_pad] source pair per packed row (N = pad)
    row_sel: torch.Tensor       # [n_pad, 1] fp32 1.0 primary-lane row, 0.0
                                # secondary-lane row of a fused pair
    tile_expert: torch.Tensor   # [n_tiles] primary lane per row tile
    tile_expert2: torch.Tensor  # [n_tiles] secondary lane (== tile_expert
                                # except on a fused pair's straddle tile)
    tile_valid: torch.Tensor    # [n_tiles] bool — tile carries a real row
    row_valid: torch.Tensor     # [n_pad] bool — real row vs tile padding
    counts: torch.Tensor        # [lanes] pairs per lane
    pos: torch.Tensor           # [N] rank of the pair within its lane's run
    occupied: torch.Tensor      # [] number of valid tiles
    n_pad: int                  # static packed row count
    n_tiles: int                # static grid size (n_pad // bn)


def padded_rows(num_pairs: int, num_lanes: int, bn: int,
                num_pairs_fused: int = 0) -> int:
    """Static packed row bound: whole-N tiles plus one boundary tile per
    lane pair (every lane its own pair without fusion)."""
    P = num_pairs_fused or num_lanes
    return -(-num_pairs // bn) * bn + P * bn


class _FusionLayout(NamedTuple):
    prim: np.ndarray          # [P] primary lane of each pair
    sec: np.ndarray           # [P] secondary lane (== prim for singletons)
    pair_of: np.ndarray       # [L] pair id per lane
    is_sec: np.ndarray        # [L] lane is its pair's secondary member
    P: int


@functools.lru_cache(maxsize=None)
def _fusion_layout(L: int, fuse: tuple | None) -> _FusionLayout:
    """Host-side structure of a plan, once per (lane count, pairing):
    `fuse` maps each lane to a fusion-pair id owning one or two lanes."""
    if fuse is None:
        ar = np.arange(L)
        return _FusionLayout(ar, ar.copy(), ar.copy(), np.zeros(L, bool), L)
    fuse = np.asarray(fuse, np.int64)
    assert fuse.shape == (L,), f"fuse covers {fuse.shape} of {L} lanes"
    ids = np.unique(fuse)
    prim = np.empty(len(ids), np.int64)
    sec = np.empty(len(ids), np.int64)
    pair_of = np.empty(L, np.int64)
    is_sec = np.zeros(L, bool)
    for j, fid in enumerate(ids):
        members = np.where(fuse == fid)[0]
        assert 1 <= len(members) <= 2, \
            f"fusion pair {fid} has {len(members)} lanes (max 2)"
        prim[j], sec[j] = members[0], members[-1]
        pair_of[members] = j
        if len(members) == 2:
            is_sec[members[1]] = True
    return _FusionLayout(prim, sec, pair_of, is_sec, len(ids))


@functools.lru_cache(maxsize=None)
def _layout_on(L: int, fuse: tuple | None, device: str):
    """The layout's index arrays (prim, sec, pair_of, is_sec) on `device`,
    copied there once per shape: a copy from host memory would wait for
    the card's queue to drain on every plan."""
    lay = _fusion_layout(L, fuse)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (lay.prim, lay.sec, lay.pair_of, lay.is_sec))


def _fuse_key(fuse):
    if fuse is None:
        return None
    return tuple(int(v) for v in np.asarray(fuse).reshape(-1))


def _lane_rank(lane: torch.Tensor, L: int):
    """Stable rank of each pair within its lane, and per-lane counts [L].
    Small inputs use a one-hot cumsum (a counting sort), large ones a
    stable argsort; both give the same order."""
    N = lane.shape[0]
    if N * (L + 1) <= (1 << 16):
        oh = lane[:, None] == torch.arange(L, dtype=lane.dtype,
                                           device=lane.device)[None, :]
        cs = torch.cumsum(oh.to(_I32), dim=0)
        pos = torch.gather(cs, 1, lane.clamp(max=L - 1).long()[:, None])[:, 0] - 1
        counts = cs[-1] if N else torch.zeros(L, dtype=_I32,
                                              device=lane.device)
    else:
        se, order = torch.sort(lane, stable=True)
        ps = (torch.arange(N, dtype=_I32, device=lane.device)
              - torch.searchsorted(se, se).to(_I32))
        pos = torch.empty(N, dtype=_I32, device=lane.device)
        pos[order] = ps
        counts = torch.zeros(L, dtype=_I32, device=lane.device).scatter_add_(
            0, lane.long(), torch.ones_like(lane))
    return torch.where(lane < L, pos, 0).to(_I32), counts.to(_I32)


def plan_tile_dispatch(expert_flat: torch.Tensor, num_experts: int,
                       bn: int, *, fuse=None) -> TilePlan:
    """expert_flat [N] int (one lane per (token, expert) pair) -> packed
    tile layout: each lane's pairs in stable order; a lane's run (or a
    fusion pair's two runs, primary first) padded to a multiple of bn rows.
    `fuse` (static, [lanes] pair ids with at most 2 lanes per id) turns on
    lane fusion: the grid drops from N/bn + L to N/bn + P tiles."""
    lane = expert_flat.to(_I32)
    dev = lane.device
    L = num_experts
    N = lane.shape[0]
    fuse_t = _fuse_key(fuse)
    lay = _fusion_layout(L, fuse_t)
    n_pad = padded_rows(N, L, bn, lay.P)
    n_tiles = n_pad // bn

    pos, counts = _lane_rank(lane, L)
    # without fusion every lane is its own pair and the layout is the
    # identity: its gathers are skipped (each is a launch on a card)
    unfused = fuse_t is None
    if unfused:
        cA = pair_rows = counts
    else:
        prim, sec, pair_of, is_sec = _layout_on(L, fuse_t, str(dev))
        cA = counts[prim]
        cB = torch.where(prim != sec, counts[sec], 0)
        pair_rows = (cA + cB).to(_I32)
    pair_pad = ((pair_rows + bn - 1) // bn) * bn
    ends = torch.cumsum(pair_pad, dim=0).to(_I32)
    pair_off = (ends - pair_pad).to(_I32)
    lane_start = pair_off if unfused else pair_off[pair_of] + torch.where(
        is_sec, cA[pair_of], 0).to(_I32)
    dest = torch.where(lane < L, lane_start[lane.clamp(max=L - 1).long()]
                       + pos, n_pad).to(_I32)
    # scatter with a sink row n_pad (the reference's mode="drop"), then cut
    row_pair = torch.full((n_pad + 1,), N, dtype=_I32, device=dev)
    row_pair[dest.long()] = torch.arange(N, dtype=_I32, device=dev)
    row_pair = row_pair[:n_pad]

    # tile t covers packed rows [t*bn, (t+1)*bn); within a pair primary rows
    # precede secondary rows, so at most one boundary (the straddle) falls
    # inside a tile. Trailing tiles clamp to the last pair and are invalid.
    ts = torch.arange(n_tiles, dtype=_I32, device=dev) * bn
    tp_raw = torch.searchsorted(ends, ts, right=True).to(_I32)
    tp = tp_raw.clamp(max=lay.P - 1).long()
    real_end = pair_off[tp] + pair_rows[tp]
    if unfused:
        te = tp.to(_I32)
        te2 = te.clone()
    else:
        bound = pair_off[tp] + cA[tp]
        te = torch.where(ts < bound, prim[tp], sec[tp]).to(_I32)
        te2 = torch.where(
            (bound > ts) & (bound < torch.minimum(ts + bn, real_end)),
            sec[tp], te).to(_I32)
    tile_valid = (tp_raw < lay.P) & (ts < real_end)

    ri = torch.arange(n_pad, dtype=_I32, device=dev)
    rp = torch.searchsorted(ends, ri, right=True).clamp(max=lay.P - 1)
    row_valid = ri < (pair_off + pair_rows)[rp]
    row_sel = (row_valid if unfused else ri < (pair_off + cA)[rp]).to(
        torch.float32)[:, None]
    return TilePlan(dest, row_pair, row_sel, te, te2, tile_valid, row_valid,
                    counts, pos, tile_valid.sum(), n_pad, n_tiles)


def scatter_rows(x_pairs: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """x_pairs [N, d] -> packed rows [n_pad, d] (zeros in padding)."""
    xz = torch.cat([x_pairs, x_pairs.new_zeros((1, x_pairs.shape[-1]))])
    return xz[plan.row_pair.long()]


def gather_rows(y_rows: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Packed rows back to pair order [N, d]."""
    yz = torch.cat([y_rows, y_rows.new_zeros((1, y_rows.shape[-1]))])
    return yz[plan.dest.long()]


def expert_ffn_gmm(x_rows: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                   wo: torch.Tensor, tile_expert: torch.Tensor,
                   tile_valid: torch.Tensor | None = None, *,
                   bn: int) -> torch.Tensor:
    """Tile-aligned rows [N_pad, d] through per-expert SwiGLU FFNs: K1
    (gmm_swiglu) then K6 (gmm) -> [N_pad, d] in x_rows' dtype; rows of
    invalid tiles are zero."""
    h = gmm_swiglu(x_rows, wg, wi, tile_expert, tile_valid, bn=bn)
    return gmm(h, wo, tile_expert, tile_valid, bn=bn)


def combine_pairs(y_pairs: torch.Tensor, tok: torch.Tensor, num_tokens: int,
                  max_per_token: int, *, token_major: bool = False
                  ) -> torch.Tensor:
    """y_pairs [N, d] in pair order -> [num_tokens, d]: every token's rows
    summed in ascending pair order, the same code on every device.

    One stable sort groups the pairs by token; token t's j-th pair lands in
    slot [t, j] of a [num_tokens, R] index table (an unused slot points at
    an appended zero row), and one gather and one reduction over R do the
    sum. No float atomics: the reference's `.at[row_token].add` is
    deterministic, and so is this on a card, where a float `index_add_`
    would sum in another order on every run.

    `max_per_token` (R) is an exact bound on one token's pairs: top_k for
    token choice (k distinct experts per token), the expert count for
    expert choice (an expert picks a token at most once). `token_major`
    says the pairs already come R per token in token order (token choice:
    tok = repeat_interleave(arange(T), R)); the table is then the pairs
    themselves, so a reshape and the same reduction give the same bits
    with no sort or gather. On the CPU a bound too small raises."""
    N, d = y_pairs.shape
    if token_major:
        return y_pairs.view(num_tokens, max_per_token, d).sum(dim=1)
    dev = y_pairs.device
    R = max_per_token
    st, order = torch.sort(tok.long(), stable=True)
    rank = torch.arange(N, device=dev) - torch.searchsorted(st, st)
    if dev.type == "cpu" and N and int(rank.max()) >= R:
        raise ValueError(f"a token owns {int(rank.max()) + 1} pairs, more "
                         f"than max_per_token={R}")
    slot = torch.full(((num_tokens + 1) * R,), N, dtype=torch.long,
                      device=dev)
    slot[st * R + rank] = order
    yz = torch.cat([y_pairs, y_pairs.new_zeros((1, d))])
    return yz[slot.view(num_tokens + 1, R)[:num_tokens]].sum(dim=1)


def moe_ffn_fused(x_src: torch.Tensor, tok: torch.Tensor, ef: torch.Tensor,
                  wf: torch.Tensor, bank: dict, num_experts: int,
                  num_tokens: int, *, expert_of_lane: torch.Tensor | None = None,
                  max_per_token: int, token_major: bool = False,
                  bn: int = 0, capacity: int = 0, fuse=None):
    """Grouped-GEMM MoE FFN over (token, expert) pairs with fused combine.

    x_src [T_src, d] source rows; tok [N] source row per pair; ef [N] lane
    per pair (an expert id, or a group-major lane rank when
    `expert_of_lane` maps lanes back to weight indices); wf [N] combine
    weights (a zero weight drops the pair's contribution).

    `capacity > 0` zeroes the weight of pairs past that rank in their
    lane's stable run (`plan.pos`). `fuse` (static pair ids per lane) packs
    paired lanes into shared tiles, resolved per row in the fused kernels
    K7/K8, so fusion is exact. `max_per_token` and `token_major` describe
    the pairs' layout to `combine_pairs`.

    Returns (y [num_tokens, d] fp32 combined output, y_rows [n_pad, d] fp32
    weighted per-row outputs, plan)."""
    bn = bn or default_block_rows(x_src.device)
    plan = plan_tile_dispatch(ef, num_experts, bn, fuse=fuse)
    if capacity:
        wf = torch.where(plan.pos < capacity, wf, 0.0)
    te, te2 = plan.tile_expert, plan.tile_expert2
    if expert_of_lane is not None:
        te = expert_of_lane[te.long()].to(_I32)
        te2 = expert_of_lane[te2.long()].to(_I32)
    fused = dict(tile_expert2=te2, row_sel=plan.row_sel) if fuse is not None \
        else {}
    d = x_src.shape[-1]
    rp = plan.row_pair.long()
    # one gather per operand through row_pair; sentinel N reads the
    # appended zero entry
    tok_z = torch.cat([tok.to(_I32), tok.new_full((1,), num_tokens,
                                                  dtype=_I32)])
    x_z = torch.cat([x_src, x_src.new_zeros((1, d))])
    x_rows = x_z[tok_z[rp].long()]
    wf_z = torch.cat([wf.float(), wf.new_zeros((1,), dtype=torch.float32)])
    scale = wf_z[rp][:, None]
    h = gmm_swiglu(x_rows, bank["wg"], bank["wi"], te, plan.tile_valid,
                   bn=bn, **fused)
    y_rows = gmm_scaled(h, bank["wo"], te, plan.tile_valid, scale, bn=bn,
                        **fused)
    y = combine_pairs(gather_rows(y_rows, plan), tok, num_tokens,
                      max_per_token, token_major=token_major)
    return y, y_rows, plan


def moe_ffn_pallas(x: torch.Tensor, expert_idx: torch.Tensor,
                   weights: torch.Tensor, bank: dict, num_experts: int, *,
                   bn: int = 0) -> torch.Tensor:
    """Full MoE FFN over a [T, k] routing: x [T, d]; expert_idx [T, k];
    weights [T, k] -> y [T, d] in x's dtype. Every pair runs (no capacity
    drops); the pairs come k per token in token order, so the combine is a
    reshape and one sum."""
    T = x.shape[0]
    k = expert_idx.shape[1]
    tok = torch.arange(T, dtype=_I32, device=x.device).repeat_interleave(k)
    y, _, _ = moe_ffn_fused(x, tok, expert_idx.reshape(-1).to(_I32),
                            weights.reshape(-1), bank, num_experts, T,
                            max_per_token=k, token_major=True, bn=bn)
    return y.to(x.dtype)


# ------------------------------------------------------------ GO decode

def go_decode_budget(batch: int, num_experts: int, topk_hint: int,
                     bn: int) -> int:
    """The reference's per-lane row budget of its fast decode plan
    (repro/kernels/ops.py:go_decode_budget, copied): with a warm GO cache
    each tick selects ~B*k pairs, so 2*B*k/E rows per expert plus two rows
    of headroom, rounded up to the row tile and capped at B. A pure
    function of shapes. The port's decode does not run that plan: it
    keeps the full one (`go_selected_ffn`), whose invalid tiles cost no
    weight reads, and needs no branch on the counts."""
    if topk_hint <= 0:
        return batch
    c = -(-2 * batch * topk_hint // num_experts) + 2
    return min(-(-c // bn) * bn, batch)


def go_selected_ffn(x: torch.Tensor, selected: torch.Tensor,
                    g: torch.Tensor, bank: dict, num_experts: int, *,
                    bn: int = 0) -> torch.Tensor:
    """C4 decode FFN over ONLY the (token, expert) pairs the TopKUpdate
    selected. x [B, d]; selected [B, E] bool; g [B, E] affinities.

    Lane e owns rows [e*Cp, (e+1)*Cp) and holds its selected rows in
    ascending batch order (`go_lane_plan`; on the decode the router K5R
    builds the same plan in its launch up to 64 rows). Branch decision:
    the port always runs the full plan (C = B rows per lane, Cp = B
    rounded up to bn) with `tile_valid` taken from the per-expert counts,
    and never the fast plan that `go_decode_budget` sizes. Past 64 rows a
    lane spans ceil(B/bn) tiles of the CUDA kernels' 64 rows; a tile
    holding no selected row is invalid, skips its multiply-adds and reads
    no weights, so the work tracks the selected pairs as the reference's
    fast plan does. It is exact, drops nothing and needs no host sync,
    where the reference's `lax.cond` between the C_fast and C_full plans
    branches on the counts: on a card that branch is one host read per
    layer and tick. At bn >= B the two plans are the same plan.

    Returns contrib [B, E, d] fp32, zero where unselected.
    """
    del num_experts                          # selected's E lanes
    bn = bn or default_block_rows(x.device)
    return go_plan_ffn(x, go_lane_plan(selected, g, bn), bank)


def go_plan_ffn(x: torch.Tensor, plan: GOPlan, bank: dict) -> torch.Tensor:
    """The decode FFN over a lane plan: gather the lanes' rows, K1 then K2
    (scaled by the plan's g), and scatter the selected rows back to
    token-major order. x [B, d] -> contrib [B, E, d] fp32, zero where
    unselected."""
    B, d = x.shape
    E, Cp = plan.idx_p.shape
    dev = x.device
    x_rows = x[plan.idx_p].reshape(E * Cp, d)
    te, tv = plan.tile_expert, plan.tile_valid
    h = gmm_swiglu(x_rows, bank["wg"], bank["wi"], te, tv, bn=plan.bn)
    y_rows = gmm_scaled(h, bank["wo"], te, tv, plan.scale.view(E * Cp, 1),
                        bn=plan.bn)
    y = y_rows.reshape(E, Cp, d)[:, :B]
    w = plan.scale.view(E, Cp)[:, :B]
    # scatter into the token-major buffer; unselected slots hit sink row B
    z = torch.zeros((B + 1, E, d), dtype=torch.float32, device=dev)
    eix = torch.arange(E, device=dev)[:, None].expand(E, B)
    z[torch.where(w > 0, plan.idx_p[:, :B], B), eix] = y
    return z[:B]
