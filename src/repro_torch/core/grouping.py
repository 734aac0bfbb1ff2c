"""C2 — static load-aware expert grouping (deployment time, host-side numpy).

A copy of the parts of repro/core/grouping.py that the served paths read.
The groups are the C1 multiplexing groups: the experts that share one
grouped-GEMM lane, whose runs the tile planner fuses pairwise.

`sorted_grouping` is the paper's workload-sorted heuristic: experts sorted
by load and folded so the lightest pair with the heaviest. `uniform_grouping`
is the random baseline. `default_groups` draws its synthetic load trace
from numpy's seeded generator, so the port's groups equal the reference's.
"""
from __future__ import annotations

import numpy as np


def uniform_grouping(num_experts: int, group_size: int,
                     seed: int = 0) -> np.ndarray:
    """Random assignment -> groups [G, g] of expert ids (paper baseline
    'U')."""
    assert num_experts % group_size == 0
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_experts)
    return perm.reshape(-1, group_size)


def sorted_grouping(loads: np.ndarray, group_size: int) -> np.ndarray:
    """Paper's workload-sorted grouping ('S'): sort by load, fold so each
    group mixes light and heavy experts (boustrophedon fill)."""
    E = len(loads)
    assert E % group_size == 0
    G = E // group_size
    order = np.argsort(loads)                 # light -> heavy
    groups = np.empty((G, group_size), np.int64)
    for col in range(group_size):
        block = order[col * G:(col + 1) * G]
        if col % 2 == 1:
            block = block[::-1]
        groups[:, col] = block
    return groups


def group_of_expert_from_groups(groups: np.ndarray) -> np.ndarray:
    """groups [G, g] expert ids -> [E] group id per expert."""
    out = np.empty(groups.size, np.int32)
    for gid, members in enumerate(groups):
        out[members] = gid
    return out


def default_groups(e) -> np.ndarray:
    """Deployment-time groups for an MoEConfig `e`: uniform with seed 0, or
    'sorted' over a synthetic zipf(1.5) load trace drawn with seed 0."""
    if e.group_size <= 1:
        return np.arange(e.num_experts)[:, None]
    if e.grouping == "uniform":
        return uniform_grouping(e.num_experts, e.group_size, seed=0)
    rng = np.random.default_rng(0)
    loads = rng.zipf(1.5, size=e.num_experts).astype(np.float64)
    return sorted_grouping(loads, e.group_size)
