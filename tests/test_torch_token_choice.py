"""The port's token-choice pieces against the JAX package: the C2 group
maps, token-choice routing and its balance loss, the fused (lane-paired)
tile plans, the fused grouped GEMMs K7/K8 (plain versions against the
reference's Pallas kernels in interpret mode), the deterministic combine,
and the MoE layer's dispatch and C1 group paths with their drop sets.

Integers must be equal. Floats: fp32 on both sides, sums in another order
-> rtol = atol = 1e-5 (routing weights 2e-6 and the balance loss rtol
2e-6: a softmax in fp32 differs by a few ulps, ~1.6e-7; the combine
against a plain sum 1e-6); each at least 10x the largest error seen.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import given, settings, st  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import grouping as JGRP  # noqa: E402
from repro.core import moe as JMOE  # noqa: E402
from repro.core import routing as JR  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels.moe_gmm import gmm_scaled as j_gmm_scaled  # noqa: E402
from repro.kernels.moe_gmm import gmm_swiglu as j_gmm_swiglu  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import grouping as GRP  # noqa: E402
from repro_torch.core import moe as MOE  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ["dest", "row_pair", "row_sel", "tile_expert", "tile_expert2",
          "tile_valid", "row_valid", "counts", "pos", "occupied"]


# --------------------------------------------------------------- grouping

@pytest.mark.parametrize("E", [10, 40])
@pytest.mark.parametrize("grouping", ["sorted", "uniform"])
def test_group_maps_equal_reference(E, grouping):
    kw = dict(num_experts=E, top_k=2, d_expert=8, group_size=2,
              grouping=grouping)
    gj = JGRP.default_groups(JMoEConfig(**kw))
    gt = GRP.default_groups(MoEConfig(**kw))
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(GRP.group_of_expert_from_groups(gt),
                                  JGRP.group_of_expert_from_groups(gj))
    assert sorted(gt.reshape(-1).tolist()) == list(range(E))


# ---------------------------------------------------------------- routing

def test_token_choice_and_balance_loss_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 16)).astype(np.float32)
    gate = rng.standard_normal((16, 10)).astype(np.float32)
    x[5] = 0.0                                   # a row of exact ties
    rj = JR.token_choice(jnp.asarray(x), jnp.asarray(gate), 3)
    rt = R.token_choice(torch.from_numpy(x), torch.from_numpy(gate), 3)
    np.testing.assert_array_equal(rt.expert_idx.numpy(),
                                  np.asarray(rj.expert_idx))
    assert rt.expert_idx[5].tolist() == [0, 1, 2]     # lax.top_k's tie rule
    np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores),
                               rtol=1e-5, atol=1e-5)
    lj = JR.load_balance_loss(rj.scores, rj.expert_idx, 10)
    lt = R.load_balance_loss(rt.scores, rt.expert_idx, 10)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-6)


# ------------------------------------------------------ fused tile plans

def _assert_plans_equal(ef, E, bn, fuse):
    pj = JOPS.plan_tile_dispatch(jnp.asarray(ef), E, bn, fuse=fuse)
    pt = OPS.plan_tile_dispatch(torch.from_numpy(ef), E, bn, fuse=fuse)
    assert (pt.n_pad, pt.n_tiles) == (pj.n_pad, pj.n_tiles)
    for f in FIELDS:
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    return pt


FUSE6 = (0, 0, 1, 1, 2, 2)          # three lane pairs
# (name, lane per pair): the straddle cases of a fused plan at bn=8
STRADDLE = {
    # lane 0 empty: pair 0's boundary sits at its first tile's start
    "empty_primary": [1] * 11 + [2] * 3 + [3] * 6,
    # lane 0 holds 7 rows: the boundary is the tile's last row
    "boundary_at_last_row": [0] * 7 + [1] * 5 + [4] * 9 + [5] * 2,
    # both lanes of a pair exactly fill tiles: no straddle at all
    "tile_aligned": [0] * 8 + [1] * 16 + [2] * 3,
    # a pair with an empty secondary, one with both empty, runs > 2 tiles
    "long_runs": [2] * 3 + [0] * 21 + [1] * 19 + [5] * 4,
}


@pytest.mark.parametrize("case", sorted(STRADDLE))
def test_fused_plan_straddle_cases(case):
    ef = np.asarray(STRADDLE[case], np.int32)
    np.random.default_rng(1).shuffle(ef)
    pt = _assert_plans_equal(ef, 6, 8, FUSE6)
    te, te2 = pt.tile_expert, pt.tile_expert2
    straddle = te2 != te
    # invalid tail tiles exist (one boundary tile per pair is budgeted)
    assert not bool(pt.tile_valid[-1])
    # a straddle tile is valid and holds both of its lanes' rows
    for t in straddle.nonzero()[:, 0].tolist():
        sel = pt.row_sel[t * 8:(t + 1) * 8, 0]
        assert bool(pt.tile_valid[t]) and 0 < sel.sum() < 8
    if case == "boundary_at_last_row":
        t = int(straddle.nonzero()[0, 0])
        assert pt.row_sel[t * 8:(t + 1) * 8, 0].tolist() == [1.0] * 7 + [0.0]
    if case == "empty_primary":
        assert int(te[0]) == 1 and not bool(straddle[0])
    if case == "tile_aligned":
        assert not bool(straddle.any())


def test_fused_plan_matches_reference_group_lanes():
    """The granite smoke deployment's lane map (E=10, g=2) on routed
    lanes, with the argsort ranking (N*(E+1) > 2**16) too."""
    fuse = JMOE._group_fuse_pairs(10, 2)
    assert MOE._group_fuse_pairs(10, 2) == fuse
    rng = np.random.default_rng(2)
    for N in (64, 7000):
        _assert_plans_equal(rng.integers(0, 10, N).astype(np.int32), 10, 8,
                            fuse)


@settings(derandomize=True, database=None, max_examples=12, deadline=None)
@given(st.lists(st.integers(0, 5), min_size=1, max_size=60))
def test_fused_plan_matches_reference_property(ef):
    _assert_plans_equal(np.asarray(ef, np.int32), 6, 8, FUSE6)


# ------------------------------------------------- K7/K8 plain versions

def _fused_inputs(seed, ef, K, F, E, bn):
    rng = np.random.default_rng(seed)
    plan = OPS.plan_tile_dispatch(torch.from_numpy(ef), E, bn, fuse=FUSE6)
    N = plan.n_pad
    x = (rng.standard_normal((N, K)) * 0.5).astype(np.float32)
    x *= plan.row_valid.numpy()[:, None]
    w = [(rng.standard_normal((E, K, F)) / np.sqrt(K)).astype(np.float32)
         for _ in range(2)]
    wo = (rng.standard_normal((E, F, K)) / np.sqrt(F)).astype(np.float32)
    scale = rng.random((N, 1)).astype(np.float32)
    return plan, x, w[0], w[1], wo, scale


@pytest.mark.parametrize("case", ["boundary_at_last_row", "long_runs"])
def test_fused_gmm_plain_matches_pallas_interpret(case):
    """K7/K8's plain versions against the reference's _gmm_*_fused in
    interpret mode on a real fused plan (straddle tiles, invalid tail
    tiles); ragged K and F against the reference's block sizes."""
    ef = np.asarray(STRADDLE[case], np.int32)
    K, F, E, bn = 40, 24, 6, 8
    plan, x, wg, wi, wo, scale = _fused_inputs(3, ef, K, F, E, bn)
    assert bool((plan.tile_expert2 != plan.tile_expert).any())
    te, te2 = plan.tile_expert.numpy(), plan.tile_expert2.numpy()
    tv, sel = plan.tile_valid.numpy(), plan.row_sel.numpy()
    t = torch.from_numpy
    before = dict(G.LAUNCHES)
    h = G.gmm_swiglu(t(x), t(wg), t(wi), plan.tile_expert, plan.tile_valid,
                     tile_expert2=plan.tile_expert2, row_sel=plan.row_sel,
                     bn=bn)
    y = G.gmm_scaled(h, t(wo), plan.tile_expert, plan.tile_valid, t(scale),
                     tile_expert2=plan.tile_expert2, row_sel=plan.row_sel,
                     bn=bn)
    assert G.LAUNCHES == before              # the plain versions count nothing
    hj = j_gmm_swiglu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wi),
                      jnp.asarray(te), jnp.asarray(tv),
                      tile_expert2=jnp.asarray(te2), row_sel=jnp.asarray(sel),
                      bn=bn, bk=16, bf=16, interpret=True)
    yj = j_gmm_scaled(hj, jnp.asarray(wo), jnp.asarray(te), jnp.asarray(tv),
                      jnp.asarray(scale), tile_expert2=jnp.asarray(te2),
                      row_sel=jnp.asarray(sel), bn=bn, bk=16, bf=16,
                      interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    rows_invalid = ~np.repeat(tv, bn)
    assert (h.numpy()[rows_invalid] == 0).all()
    assert (y.numpy()[rows_invalid] == 0).all()


def test_fused_gmm_equals_unfused_on_non_straddle_tiles():
    """te2 == te everywhere: K7/K8's plain versions are K1/K2's, bit for
    bit, whatever row_sel says."""
    rng = np.random.default_rng(4)
    N, K, F, E, bn = 32, 16, 12, 3, 8
    x = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32))
    wg, wi = (torch.from_numpy(rng.standard_normal((E, K, F)).astype(
        np.float32)) for _ in range(2))
    te = torch.tensor([0, 2, 1, 1], dtype=torch.int32)
    tv = torch.tensor([True, True, False, True])
    sel = torch.from_numpy((rng.random((N, 1)) > 0.5).astype(np.float32))
    h1 = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)
    h2 = G.gmm_swiglu(x, wg, wi, te, tv, tile_expert2=te, row_sel=sel, bn=bn)
    assert torch.equal(h1, h2)
    with pytest.raises(ValueError, match="come together"):
        G.gmm_swiglu(x, wg, wi, te, tv, tile_expert2=te, bn=bn)


# ---------------------------------------------------------------- combine

@pytest.mark.parametrize("layout", ["token_major", "expert_major"])
def test_combine_sums_each_token_in_pair_order(layout):
    """combine_pairs against a plain per-token loop (1e-6), with a token
    no pair names (expert-major) and a bound too small for the data
    raising; on token-major pairs the reshape path gives the sort path's
    bits."""
    rng = np.random.default_rng(5)
    T, d = 9, 6
    if layout == "token_major":
        tok = np.repeat(np.arange(T), 3)
        R_ = 3
    else:
        tok = np.concatenate([rng.permutation(T)[:5] for _ in range(4)])
        R_ = 4
    yp = rng.standard_normal((tok.shape[0], d)).astype(np.float32)
    ref = np.zeros((T, d), np.float32)
    for i, t in enumerate(tok):
        ref[t] += yp[i]
    got = OPS.combine_pairs(torch.from_numpy(yp), torch.from_numpy(tok), T,
                            R_)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    if layout == "token_major":
        fast = OPS.combine_pairs(torch.from_numpy(yp), torch.from_numpy(tok),
                                 T, R_, token_major=True)
        assert torch.equal(fast, got)
    else:
        assert not np.isin(np.arange(T), tok).all()
    with pytest.raises(ValueError, match="max_per_token"):
        OPS.combine_pairs(torch.from_numpy(yp), torch.from_numpy(tok), T,
                          R_ - 1)


def _bank(rng, E, d, de):
    return {k: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
            for k, s in (("wg", (E, d, de)), ("wi", (E, d, de)),
                         ("wo", (E, de, d)))}


@pytest.mark.parametrize("capacity", [0, 3])
def test_moe_ffn_fused_with_fusion_and_capacity(capacity):
    """The executor on a fused group-major lane layout with expert_of_lane,
    and the capacity mask (pairs past rank 3 in their lane lose their
    weight), against the reference."""
    rng = np.random.default_rng(6)
    T, d, de, E, k = 20, 16, 12, 6, 2
    ef = np.stack([rng.permutation(E)[:k] for _ in range(T)]).reshape(-1)
    ef = ef.astype(np.int32)
    tok = np.repeat(np.arange(T, dtype=np.int32), k)
    wf = rng.random(T * k).astype(np.float32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    bank = _bank(rng, E, d, de)
    lanes = np.asarray([3, 0, 5, 1, 2, 4], np.int32)     # lane -> expert
    rank = np.argsort(lanes).astype(np.int32)
    yj, yrj, pj = JOPS.moe_ffn_fused(
        jnp.asarray(x), jnp.asarray(tok), jnp.asarray(rank[ef]),
        jnp.asarray(wf), {k_: jnp.asarray(v) for k_, v in bank.items()}, E,
        T, expert_of_lane=jnp.asarray(lanes), bn=8, interpret=True,
        capacity=capacity, fuse=FUSE6)
    yt, yrt, pt = OPS.moe_ffn_fused(
        torch.from_numpy(x), torch.from_numpy(tok),
        torch.from_numpy(rank[ef]), torch.from_numpy(wf),
        {k_: torch.from_numpy(v) for k_, v in bank.items()}, E, T,
        expert_of_lane=torch.from_numpy(lanes), capacity=capacity,
        fuse=FUSE6, max_per_token=k)
    np.testing.assert_array_equal(pt.pos.numpy(), np.asarray(pj.pos))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(yrt.numpy(), np.asarray(yrj), **TOL)


# --------------------------------------------------------------- MoE layer

def _layer(E=8, T=24, d=32, de=16, seed=7, **kw):
    cfg = dict(num_experts=E, top_k=2, d_expert=de, group_size=2,
               backend="pallas", **kw)
    je, te = JMoEConfig(**cfg), MoEConfig(**cfg)
    rng = np.random.default_rng(seed)
    bank = _bank(rng, E, d, de)
    gate = rng.standard_normal((d, E)).astype(np.float32)
    jp = {"gate": jnp.asarray(gate),
          "experts": {k: jnp.asarray(v) for k, v in bank.items()}}
    tp = {"gate": torch.from_numpy(gate),
          "experts": {k: torch.from_numpy(v) for k, v in bank.items()}}
    x = (rng.standard_normal((T, d)) * 0.5).astype(np.float32)
    return je, te, jp, tp, x


def test_dispatch_forward_matches_reference():
    je, te, jp, tp, x = _layer()
    yj, aj = jax.jit(JMOE.dispatch_forward, static_argnames="e")(
        jp, jnp.asarray(x), je)
    yt, at = MOE.dispatch_forward(tp, torch.from_numpy(x), te)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(at["counts"].numpy(),
                                  np.asarray(aj["counts"]))
    np.testing.assert_allclose(at["balance_loss"].item(),
                               float(aj["balance_loss"]), rtol=2e-6)
    assert int(at["dropped"]) == 0
    dj = jax.jit(JMOE.token_choice_decode, static_argnames="e")(
        jp, jnp.asarray(x[:5]), je)
    dt = MOE.token_choice_decode(tp, torch.from_numpy(x[:5]), te)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)


def _reference_keep(jp, x, je, goe, C_grp):
    r = JR.token_choice(jnp.asarray(x), jp["gate"], je.top_k)
    ef = r.expert_idx.reshape(-1)
    order, _, pos = JMOE._group_sorted_positions(goe[ef], ef,
                                                 je.num_experts)
    return np.asarray(jnp.zeros(ef.shape[0], bool).at[order].set(
        pos < C_grp))


@pytest.mark.parametrize("members", ["deployment", "derived"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_group_forward_matches_reference_drop_set_included(
        members, capacity_factor):
    """The C1 path on the deployment's member matrix (sorted grouping,
    unsorted within a group) and on the one derived from the group map:
    dropless and under pooled-capacity overflow. The kept pairs equal the
    reference's exactly, and so does the output within 1e-5."""
    je, te, jp, tp, x = _layer(capacity_factor=capacity_factor)
    groups = JGRP.default_groups(je)
    goe = JGRP.group_of_expert_from_groups(groups)
    mj = jnp.asarray(groups, jnp.int32) if members == "deployment" else None
    mt = torch.from_numpy(groups.astype(np.int32)) \
        if members == "deployment" else None
    yj, aj = JMOE.group_forward(jp, jnp.asarray(x), je, jnp.asarray(goe),
                                members=mj)
    yt, at = MOE.group_forward(tp, torch.from_numpy(x), te,
                               torch.from_numpy(goe), members=mt)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert int(at["dropped"]) == int(aj["dropped"])
    assert at["slots"] == int(aj["slots"])
    np.testing.assert_array_equal(
        at["kept"].numpy(),
        _reference_keep(jp, x, je, jnp.asarray(goe), at["slots"] // 4))
    assert (int(at["dropped"]) > 0) == (capacity_factor < 2)
    np.testing.assert_array_equal(at["counts"].numpy(),
                                  np.asarray(aj["counts"]))


def test_moe_forward_routes_like_the_reference():
    """moe_forward: the group path with a group map and use_grouped_gemm,
    dispatch otherwise."""
    je, te, jp, tp, x = _layer(capacity_factor=1.25)
    goe = JGRP.group_of_expert_from_groups(JGRP.default_groups(je))
    for use in (True, False):
        je_u = dataclasses.replace(je, use_grouped_gemm=use)
        te_u = dataclasses.replace(te, use_grouped_gemm=use)
        yj, aj = JMOE.moe_forward(jp, jnp.asarray(x), je_u, jnp.asarray(goe))
        yt, at = MOE.moe_forward(tp, torch.from_numpy(x), te_u,
                                 torch.from_numpy(goe))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        assert ("slots" in at) == use == ("slots" in aj)


def test_block_rows_honours_gmm_block_rows():
    e = MoEConfig(num_experts=4, top_k=2, d_expert=8)
    assert MOE.block_rows(e, "cpu") == 8
    assert MOE.block_rows(e, "cuda") == 64
    assert MOE.block_rows(dataclasses.replace(e, gmm_block_rows=16),
                          "cpu") == 16
