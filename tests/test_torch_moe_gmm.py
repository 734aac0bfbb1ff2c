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
