"""The port's grouped GEMMs K1 (gmm_swiglu) and K2 (gmm_scaled) against the
JAX package's Pallas kernels (interpret mode) and its jnp oracles.

On the CPU the wrappers run their plain versions; the CUDA kernels are
compared with those plain versions in tests/test_torch_cuda.py. Tolerance: fp32 on both sides, only the order of
the sums differs -> rtol = atol = 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.moe_gmm import gmm_scaled as j_gmm_scaled  # noqa: E402
from repro.kernels.moe_gmm import gmm_swiglu as j_gmm_swiglu  # noqa: E402
from repro_torch.kernels import moe_gmm as G  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-5, atol=1e-5)

# (N, K, F, E, bn): ragged K/F against every block size, a row count that
# is no multiple of bn, and the CPU tile of 8 rows
CASES = [
    (64, 72, 44, 3, 8),
    (60, 72, 44, 3, 8),
    (48, 16, 24, 2, 8),
    (128, 40, 96, 4, 16),
]


def _inputs(seed, N, K, F, E, bn):
    rng = np.random.default_rng(seed)
    ni = -(-N // bn)
    x = (rng.standard_normal((N, K)) * 0.5).astype(np.float32)
    wg = (rng.standard_normal((E, K, F)) / np.sqrt(K)).astype(np.float32)
    wi = (rng.standard_normal((E, K, F)) / np.sqrt(K)).astype(np.float32)
    wo = (rng.standard_normal((E, F, K)) / np.sqrt(F)).astype(np.float32)
    te = rng.integers(0, E, size=ni).astype(np.int32)
    tv = rng.random(ni) > 0.3
    tv[0], tv[-1] = True, False             # at least one of each
    scale = rng.random((N, 1)).astype(np.float32)
    return x, wg, wi, wo, te, tv, scale


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("N,K,F,E,bn", CASES)
def test_gmm_swiglu_plain_matches_pallas_and_oracle(N, K, F, E, bn):
    x, wg, wi, _, te, tv, _ = _inputs(N + K, N, K, F, E, bn)
    before = dict(G.LAUNCHES)
    h = G.gmm_swiglu(_t(x), _t(wg), _t(wi), _t(te), _t(tv), bn=bn).numpy()
    assert G.LAUNCHES == before            # the plain version counts nothing
    assert h.shape == (N, F) and h.dtype == np.float32
    hj = np.asarray(j_gmm_swiglu(jnp.asarray(x), jnp.asarray(wg),
                                 jnp.asarray(wi), jnp.asarray(te),
                                 jnp.asarray(tv), bn=bn, interpret=True))
    np.testing.assert_allclose(h, hj, **TOL)
    # the oracle knows no tile_valid: valid rows match it, invalid are zero
    ni = te.shape[0]
    xp = np.pad(x, ((0, ni * bn - N), (0, 0)))
    hr = np.asarray(ref.gmm_swiglu_ref(jnp.asarray(xp), jnp.asarray(wg),
                                       jnp.asarray(wi), jnp.asarray(te),
                                       bn))[:N]
    rows_valid = np.repeat(tv, bn)[:N]
    np.testing.assert_allclose(h[rows_valid], hr[rows_valid], **TOL)
    assert (h[~rows_valid] == 0).all()


@pytest.mark.parametrize("N,K,F,E,bn", CASES)
def test_gmm_scaled_plain_matches_pallas_and_oracle(N, K, F, E, bn):
    _, _, _, wo, te, tv, scale = _inputs(N + F, N, K, F, E, bn)
    h = np.random.default_rng(N).standard_normal((N, F)).astype(np.float32)
    y = G.gmm_scaled(_t(h), _t(wo), _t(te), _t(tv), _t(scale),
                     bn=bn).numpy()
    assert y.shape == (N, K) and y.dtype == np.float32
    yj = np.asarray(j_gmm_scaled(jnp.asarray(h), jnp.asarray(wo),
                                 jnp.asarray(te), jnp.asarray(tv),
                                 jnp.asarray(scale), bn=bn, interpret=True))
    np.testing.assert_allclose(y, yj, **TOL)
    ni = te.shape[0]
    hp = np.pad(h, ((0, ni * bn - N), (0, 0)))
    sp = np.pad(scale, ((0, ni * bn - N), (0, 0)))
    yr = np.asarray(ref.gmm_scaled_ref(jnp.asarray(hp), jnp.asarray(wo),
                                       jnp.asarray(te), jnp.asarray(sp),
                                       bn))[:N]
    rows_valid = np.repeat(tv, bn)[:N]
    np.testing.assert_allclose(y[rows_valid], yr[rows_valid], **TOL)
    assert (y[~rows_valid] == 0).all()


def test_plain_versions_accept_bf16_and_keep_dtypes():
    x, wg, wi, wo, te, tv, scale = _inputs(3, 32, 24, 16, 2, 8)
    bf = torch.bfloat16
    h = G.gmm_swiglu(_t(x).to(bf), _t(wg).to(bf), _t(wi).to(bf), _t(te),
                     _t(tv), bn=8)
    assert h.dtype == bf
    y = G.gmm_scaled(h, _t(wo).to(bf), _t(te), _t(tv), _t(scale), bn=8)
    assert y.dtype == torch.float32


@pytest.mark.parametrize("which", ["swiglu", "scaled"])
def test_short_tile_map_raises(which):
    x, wg, wi, wo, te, tv, scale = _inputs(0, 64, 16, 8, 2, 8)
    short = _t(te[:-1])                      # 7 tiles for 8 tiles of rows
    with pytest.raises(ValueError, match="different bn"):
        if which == "swiglu":
            G.gmm_swiglu(_t(x), _t(wg), _t(wi), short, None, bn=8)
        else:
            G.gmm_scaled(_t(x[:, :8]), _t(wo), short, None, _t(scale), bn=8)


def test_longer_tile_map_is_fine_and_none_means_all_valid():
    x, wg, wi, _, te, _, _ = _inputs(1, 24, 16, 8, 2, 8)
    longer = np.concatenate([te, te])        # 6 entries for 3 tiles
    h = G.gmm_swiglu(_t(x), _t(wg), _t(wi), _t(longer), None, bn=8).numpy()
    hj = np.asarray(j_gmm_swiglu(jnp.asarray(x), jnp.asarray(wg),
                                 jnp.asarray(wi), jnp.asarray(longer),
                                 None, bn=8, interpret=True))
    np.testing.assert_allclose(h, hj, **TOL)


def test_device_without_a_path_raises():
    x = torch.zeros((8, 4), device="meta")
    w = torch.zeros((1, 4, 4), device="meta")
    te = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no grouped-GEMM path"):
        G.gmm_swiglu(x, w, w, te, None, bn=8)


# ------------------------------------ the bf16 body's ring and tile pairs

# (N, K, F, E, swiglu) -> (tiles per block, ring depth): llama's K1 prefill
# and decode, K2/K6 at prefill and decode, granite's decode and K7/K8
# prefill, a small shape, and one whose rows are not 16-byte multiples
RING_CASES = {
    "llama_k1_prefill": ((3072, 4096, 688, 16, True), (2, 3)),
    "llama_k1_decode": ((1024, 4096, 688, 16, True), (1, 6)),
    "llama_k2_prefill": ((3072, 688, 4096, 16, False), (2, 4)),
    "llama_k2_decode": ((1024, 688, 4096, 16, False), (1, 4)),
    "granite_k1_decode": ((2624, 1536, 512, 40, True), (1, 4)),
    "granite_k7_prefill": ((5376, 1536, 512, 40, True), (2, 3)),
    "granite_k8_prefill": ((5376, 512, 1536, 40, False), (2, 4)),
    "small": ((300, 200, 136, 5, True), (1, 6)),
    "unaligned": ((100, 48, 172, 4, False), (1, 6)),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_gemm_ring_matches_a_brute_force_edge_mask(case):
    """The ring's ragged edges against every element of the edge blocks:
    with K and F multiples of 8 a chunk of 8 is zero-filled exactly when
    none of its elements lies inside the matrix (x: the last k stage's
    columns; weights: its rows and the last stripe's columns), and padding
    rows are those of the last row tile past N. Pairs of planner tiles go
    to prefills (at least two tiles per expert), single tiles to decodes;
    a grid of at most two single-tile blocks per SM takes the deep ring
    (6), any other 4 stages where they fit 113 KB, else 3."""
    (N, K, F, E, swiglu), (tm, depth) = RING_CASES[case]
    r = G.gemm_ring(N, K, F, E, swiglu=swiglu)
    assert (r["tiles_per_block"], r["ring_depth"]) == (tm, depth)
    bm, bk, bnc = G.KERNEL_BLOCK_ROWS, G.GEMM_BK, G.GEMM_BN
    ni, nk, stripes = -(-N // bm), -(-K // bk), -(-F // bnc)
    assert r["grid"] == (stripes, -(-ni // tm)) and r["k_stages"] == nk
    assert G.gemm_ring(N, K, F, E, straddle=True)["k_stages"] == 2 * nk
    assert r["vec"] == (K % 8 == 0 and F % 8 == 0)
    cols = (nk - 1) * bk + np.arange(bk)          # the last stage's columns
    fcols = (stripes - 1) * bnc + np.arange(bnc)  # the last stripe's columns
    rows = (ni - 1) * bm + np.arange(bm)          # the last row tile
    if r["vec"]:
        x_dead = [c for c in range(bk // 8) if (cols[8 * c:8 * c + 8] >= K).all()]
        w_dead = [c for c in range(bnc // 8)
                  if (fcols[8 * c:8 * c + 8] >= F).all()]
        assert r["x_zero"] == x_dead and r["w_zero_cols"] == w_dead
        # no chunk is cut by an edge: each lies wholly inside or outside
        for edge, idx in ((K, cols), (F, fcols)):
            inside = (idx < edge).reshape(-1, 8)
            assert (inside.all(1) | ~inside.any(1)).all()
    assert r["w_zero_rows"] == [i for i in range(bk) if cols[i] >= K]
    assert r["pad_rows"] == [i for i in range(bm) if rows[i] >= N]


def _gmm_tc_emulated(x, wg, wi, te, te2, tv, sel, tm):
    """The bf16 body's passes in fp32 on the CPU: blocks of `tm` planner
    tiles of 64 rows; each row's expert (te, or te2 on a straddle tile
    where sel <= 0.5; none on an invalid tile); one pass per distinct
    expert of the block's valid tiles, with the other rows zeroed; the
    rows of invalid tiles write zeros."""
    N, F = x.shape[0], wg.shape[2]
    bm = G.KERNEL_BLOCK_ROWS
    ni = -(-N // bm)
    out = np.zeros((N, F), np.float32)
    for t0 in range(0, ni, tm):
        tiles = range(t0, min(t0 + tm, ni))
        r = np.arange(t0 * bm, min((t0 + tm) * bm, N))
        t = r // bm
        row_e = np.where(~tv[t], -1,
                         np.where((te2[t] != te[t]) & ~(sel[r] > 0.5),
                                  te2[t], te[t]))
        passes = list(dict.fromkeys(int(e) for j in tiles if tv[j]
                                    for e in (te[j], te2[j])))
        g = np.zeros((len(r), F), np.float32)
        u = np.zeros((len(r), F), np.float32)
        for e in passes:
            xm = np.where((row_e == e)[:, None], x[r], 0.0)
            g += xm @ wg[e]
            u += xm @ wi[e]
        h = g / (1 + np.exp(-g)) * u
        out[r] = np.where((row_e >= 0)[:, None], h, 0.0)
    return out


@pytest.mark.parametrize("tm", [1, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_gmm_tc_passes_match_pallas(tm, fused):
    """The bf16 body's row-expert passes, on blocks of one or two planner
    tiles (a pair of two experts, straddle tiles, invalid tiles), emulated
    on the CPU in fp32, against the JAX Pallas kernel (interpret mode) at
    the card's 64-row tile: 1e-5, sums in another order."""
    from repro_torch.kernels import ops as OPS
    rng = np.random.default_rng(40 + tm + 2 * fused)
    per_lane = (61, 3, 0, 70, 63, 1)
    ef = np.concatenate([np.full(n, e, np.int32)
                         for e, n in enumerate(per_lane)])
    rng.shuffle(ef)
    plan = OPS.plan_tile_dispatch(torch.from_numpy(ef), 6,
                                  G.KERNEL_BLOCK_ROWS,
                                  fuse=(0, 0, 1, 1, 2, 2) if fused else None)
    te = plan.tile_expert.numpy()
    te2 = plan.tile_expert2.numpy() if fused else te
    tv = plan.tile_valid.numpy().astype(bool)
    sel = plan.row_sel.numpy().reshape(-1) if fused else np.ones(plan.n_pad)
    tv[-1] = False
    if fused:
        assert (te2 != te).any()
    N, K, F = plan.n_pad, 24, 40
    x = (rng.standard_normal((N, K)) * 0.5).astype(np.float32)
    wg, wi = ((rng.standard_normal((6, K, F)) / np.sqrt(K)).astype(np.float32)
              for _ in range(2))
    got = _gmm_tc_emulated(x, wg, wi, te, te2, tv, sel, tm)
    kw = (dict(tile_expert2=jnp.asarray(te2),
               row_sel=jnp.asarray(sel.astype(np.float32)[:, None]))
          if fused else {})
    want = np.asarray(j_gmm_swiglu(jnp.asarray(x), jnp.asarray(wg),
                                   jnp.asarray(wi), jnp.asarray(te),
                                   jnp.asarray(tv), bn=G.KERNEL_BLOCK_ROWS,
                                   interpret=True, **kw))
    np.testing.assert_allclose(got, want, **TOL)
