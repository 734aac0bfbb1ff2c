"""The tile-dispatch planner and the MoE executors over the grouped GEMMs.

Counterpart of repro/kernels/ops.py, in its unfused form: no lane fusion
(`fuse=None`) and no local-expert window (`num_local=0`); the host-side
`PlanCache` is not ported yet.

`plan_tile_dispatch` sorts (token, expert) pairs into expert runs padded to
row tiles of `bn` rows, so each tile of the grouped GEMM reads one expert's
weights. Every shape is static; no step reads a value back to the host.

  moe_ffn_fused     (token, expert) pairs -> combined [T, d] output, the
                    combine weights applied in the K2 epilogue and rows
                    scatter-added into the token buffer.
  go_selected_ffn   C4 decode: only the pairs the TopKUpdate selected.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.moe_gmm import (KERNEL_BLOCK_ROWS, gmm_scaled,
                                         gmm_swiglu)

_I32 = torch.int32


def default_block_rows(device: torch.device | str) -> int:
    """Row-tile height: the CUDA kernels' 64-row tile on a card (one block
    per tile, 4 wmma row fragments); 8 on the CPU, the JAX package's value
    off the TPU, so plans compare field by field with the reference."""
    return KERNEL_BLOCK_ROWS if torch.device(device).type == "cuda" else 8


class TilePlan(NamedTuple):
    dest: torch.Tensor          # [N] packed row per pair
    row_pair: torch.Tensor      # [n_pad] source pair per packed row (N = pad)
    row_sel: torch.Tensor       # [n_pad, 1] fp32 1.0 primary-lane row
    tile_expert: torch.Tensor   # [n_tiles] lane per row tile
    tile_expert2: torch.Tensor  # [n_tiles] == tile_expert (no fusion)
    tile_valid: torch.Tensor    # [n_tiles] bool — tile carries a real row
    row_valid: torch.Tensor     # [n_pad] bool — real row vs tile padding
    counts: torch.Tensor        # [lanes] pairs per lane
    pos: torch.Tensor           # [N] rank of the pair within its lane's run
    occupied: torch.Tensor      # [] number of valid tiles
    n_pad: int                  # static packed row count
    n_tiles: int                # static grid size (n_pad // bn)


def padded_rows(num_pairs: int, num_lanes: int, bn: int) -> int:
    """Static packed row bound: whole-N tiles plus one boundary tile per
    lane."""
    return -(-num_pairs // bn) * bn + num_lanes * bn


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
                       bn: int) -> TilePlan:
    """expert_flat [N] int (one entry per (token, expert) pair) -> packed
    tile layout: each expert's pairs in stable order, its run padded to a
    multiple of bn rows."""
    lane = expert_flat.to(_I32)
    dev = lane.device
    L = num_experts
    N = lane.shape[0]
    n_pad = padded_rows(N, L, bn)
    n_tiles = n_pad // bn

    pos, counts = _lane_rank(lane, L)
    run_pad = ((counts + bn - 1) // bn) * bn
    ends = torch.cumsum(run_pad, dim=0).to(_I32)
    run_off = (ends - run_pad).to(_I32)
    dest = torch.where(lane < L, run_off[lane.clamp(max=L - 1).long()] + pos,
                       n_pad).to(_I32)
    # scatter with a sink row n_pad (the reference's mode="drop"), then cut
    row_pair = torch.full((n_pad + 1,), N, dtype=_I32, device=dev)
    row_pair[dest.long()] = torch.arange(N, dtype=_I32, device=dev)
    row_pair = row_pair[:n_pad]

    # tile t covers packed rows [t*bn, (t+1)*bn); trailing tiles clamp to
    # the last lane and are marked invalid
    ts = torch.arange(n_tiles, dtype=_I32, device=dev) * bn
    tp_raw = torch.searchsorted(ends, ts, right=True).to(_I32)
    tp = tp_raw.clamp(max=L - 1)
    real_end = run_off[tp.long()] + counts[tp.long()]
    te = tp.to(_I32)
    tile_valid = (tp_raw < L) & (ts < real_end)

    ri = torch.arange(n_pad, dtype=_I32, device=dev)
    rp = torch.searchsorted(ends, ri, right=True).clamp(max=L - 1)
    row_end = (run_off + counts)[rp]
    row_sel = (ri < row_end).to(torch.float32)[:, None]
    row_valid = ri < row_end
    return TilePlan(dest, row_pair, row_sel, te, te.clone(), tile_valid,
                    row_valid, counts, pos, tile_valid.sum(), n_pad, n_tiles)


def scatter_rows(x_pairs: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """x_pairs [N, d] -> packed rows [n_pad, d] (zeros in padding)."""
    xz = torch.cat([x_pairs, x_pairs.new_zeros((1, x_pairs.shape[-1]))])
    return xz[plan.row_pair.long()]


def gather_rows(y_rows: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Packed rows back to pair order [N, d]."""
    yz = torch.cat([y_rows, y_rows.new_zeros((1, y_rows.shape[-1]))])
    return yz[plan.dest.long()]


def moe_ffn_fused(x_src: torch.Tensor, tok: torch.Tensor, ef: torch.Tensor,
                  wf: torch.Tensor, bank: dict, num_experts: int,
                  num_tokens: int, *, bn: int = 0):
    """Grouped-GEMM MoE FFN over (token, expert) pairs with fused combine.

    x_src [T_src, d] source rows; tok [N] source row per pair; ef [N] expert
    per pair; wf [N] combine weights. Returns (y [num_tokens, d] fp32
    combined output, y_rows [n_pad, d] fp32 weighted per-row outputs,
    plan)."""
    bn = bn or default_block_rows(x_src.device)
    plan = plan_tile_dispatch(ef, num_experts, bn)
    te = plan.tile_expert
    d = x_src.shape[-1]
    rp = plan.row_pair.long()
    # one gather per operand through row_pair; sentinel N reads the
    # appended zero / sink entry
    tok_z = torch.cat([tok.to(_I32), tok.new_full((1,), num_tokens,
                                                  dtype=_I32)])
    row_token = tok_z[rp]
    x_z = torch.cat([x_src, x_src.new_zeros((1, d))])
    x_rows = x_z[row_token.long()]
    wf_z = torch.cat([wf.float(), wf.new_zeros((1,), dtype=torch.float32)])
    scale = wf_z[rp][:, None]
    h = gmm_swiglu(x_rows, bank["wg"], bank["wi"], te, plan.tile_valid,
                   bn=bn)
    y_rows = gmm_scaled(h, bank["wo"], te, plan.tile_valid, scale, bn=bn)
    y = torch.zeros((num_tokens + 1, d), dtype=torch.float32,
                    device=x_src.device)
    y.index_add_(0, row_token.long(), y_rows)
    return y[:num_tokens], y_rows, plan


# ------------------------------------------------------------ GO decode

def go_selected_ffn(x: torch.Tensor, selected: torch.Tensor,
                    g: torch.Tensor, bank: dict, num_experts: int, *,
                    bn: int = 0) -> torch.Tensor:
    """C4 decode FFN over ONLY the (token, expert) pairs the TopKUpdate
    selected. x [B, d]; selected [B, E] bool; g [B, E] affinities.

    Lane e owns rows [e*Cp, (e+1)*Cp) and one sort per tick gathers its
    selected rows in ascending batch order. Branch decision: the port
    always runs the full plan (C = B rows per lane) with `tile_valid` taken
    from the per-expert counts. A tile holding no selected row skips its
    multiply-adds and reads no weights, so the work tracks the selected
    pairs as the reference's fast plan does; it is exact, drops nothing,
    and needs no host sync, where the reference's `lax.cond` between the
    C_fast and C_full plans would cost one sync per layer per tick on a
    GPU. At bn >= B (the CUDA tile of 64 rows at batch <= 64) the two plans
    are the same plan, so the reference's fast-plan budget is not kept.

    Returns contrib [B, E, d] fp32, zero where unselected.
    """
    B, d = x.shape
    E = num_experts
    bn = bn or default_block_rows(x.device)
    dev = x.device
    selT = selected.T                                       # [E, B]
    counts = selT.sum(dim=1).to(_I32)
    ar = torch.arange(B, dtype=_I32, device=dev)
    # selected rows get descending positive keys, unselected distinct
    # negative ones: one sort yields each lane's selected rows in order
    keys = torch.where(selT, B - ar[None, :], -1 - ar[None, :])
    gsel = torch.where(selT, g.T, 0.0)                      # affinities > 0
    C = B
    idx = torch.sort(keys, dim=1, descending=True, stable=True)[1][:, :C]
    w = torch.gather(gsel, 1, idx)                          # 0 off-selection
    Cp = -(-C // bn) * bn
    idx_p = torch.nn.functional.pad(idx, (0, Cp - C))
    x_rows = x[idx_p].reshape(E * Cp, d)
    scale = torch.nn.functional.pad(w, (0, Cp - C)).reshape(E * Cp, 1)
    te = torch.arange(E, dtype=_I32, device=dev).repeat_interleave(Cp // bn)
    slot = torch.arange(Cp // bn, dtype=_I32, device=dev) * bn
    tv = (slot[None, :] < counts[:, None]).reshape(-1)
    h = gmm_swiglu(x_rows, bank["wg"], bank["wi"], te, tv, bn=bn)
    y_rows = gmm_scaled(h, bank["wo"], te, tv, scale, bn=bn)
    y = y_rows.reshape(E, Cp, d)[:, :C]
    # scatter into the token-major buffer; unselected slots hit sink row B
    z = torch.zeros((B + 1, E, d), dtype=torch.float32, device=dev)
    eix = torch.arange(E, device=dev)[:, None].expand(E, C)
    z[torch.where(w > 0, idx, B), eix] = y
    return z[:B]
