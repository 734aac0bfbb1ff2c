"""The port's tile planner against the JAX package's: every TilePlan field
equal, integers exactly, at the CPU row tile bn=8 (the JAX value off the
TPU), on the expert-choice layout and on random routings, through both the
counting-sort and the argsort ranking.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import given, settings, st  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402

FIELDS = ["dest", "row_pair", "row_sel", "tile_expert", "tile_expert2",
          "tile_valid", "row_valid", "counts", "pos", "occupied"]


def _assert_plans_equal(ef: np.ndarray, E: int, bn: int):
    pj = JOPS.plan_tile_dispatch(jnp.asarray(ef), E, bn)
    pt = OPS.plan_tile_dispatch(torch.from_numpy(ef), E, bn)
    assert (pt.n_pad, pt.n_tiles) == (pj.n_pad, pj.n_tiles)
    for f in FIELDS:
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    return pj, pt


@pytest.mark.parametrize("B,S,E,k", [(1, 16, 8, 2), (2, 16, 8, 2),
                                     (4, 24, 16, 4)])
def test_expert_choice_layout(B, S, E, k):
    cap = max(1, S * k // E)
    ef = np.tile(np.repeat(np.arange(E, dtype=np.int32), cap), B)
    _assert_plans_equal(ef, E, 8)


@pytest.mark.parametrize("seed,N,E", [(0, 37, 8), (1, 200, 4), (2, 512, 16),
                                      (3, 9000, 8)])
def test_random_routing(seed, N, E):
    """N=9000, E=8 takes the argsort ranking (N*(E+1) > 2**16)."""
    ef = np.random.default_rng(seed).integers(0, E, N).astype(np.int32)
    _assert_plans_equal(ef, E, 8)


def test_skewed_routing_with_empty_experts():
    ef = np.array([3] * 19 + [0] * 2 + [3] * 4, np.int32)
    _, pt = _assert_plans_equal(ef, 6, 8)
    # experts 1, 2, 4, 5 own no tile row; every planned pair is in place
    assert pt.counts.tolist() == [2, 0, 0, 23, 0, 0]


def test_scatter_and_gather_rows_round_trip():
    rng = np.random.default_rng(5)
    ef = rng.integers(0, 4, 30).astype(np.int32)
    x = rng.standard_normal((30, 6)).astype(np.float32)
    pj = JOPS.plan_tile_dispatch(jnp.asarray(ef), 4, 8)
    pt = OPS.plan_tile_dispatch(torch.from_numpy(ef), 4, 8)
    rows = OPS.scatter_rows(torch.from_numpy(x), pt)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(JOPS.scatter_rows(jnp.asarray(x), pj)))
    np.testing.assert_array_equal(OPS.gather_rows(rows, pt).numpy(), x)


def test_default_block_rows_per_device():
    assert OPS.default_block_rows("cpu") == 8
    assert OPS.default_block_rows("cuda") == 64


@settings(derandomize=True, database=None, max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 5), min_size=1, max_size=60))
def test_plan_matches_reference_property(ef):
    _assert_plans_equal(np.asarray(ef, np.int32), 6, 8)
