"""Expert-choice routing, TopKUpdate and the GO cache against the JAX
package. Integer outputs (chosen tokens, slots, token ids) must be equal;
floats agree to 1e-6 (fp32 softmax / one gate matmul). Tie cases pin the
stable top-k: on equal scores the lower index wins, as in jax.lax.top_k.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import given, settings, st  # noqa: E402
from repro.core import go_cache as JGO  # noqa: E402
from repro.core import routing as JR  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro_torch.core import go_cache as GO  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("valid_len", [None, 9])
def test_expert_choice_matches_reference(valid_len):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 12)).astype(np.float32)
    w = rng.standard_normal((12, 6)).astype(np.float32)
    rj = JR.expert_choice(jnp.asarray(x), jnp.asarray(w), 5,
                          valid_len=valid_len)
    rt = R.expert_choice(_t(x), _t(w), 5, valid_len=valid_len)
    np.testing.assert_array_equal(rt.token_idx.numpy(),
                                  np.asarray(rj.token_idx))
    np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights),
                               **TOL)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores),
                               **TOL)


def test_expert_choice_ties_pick_the_lower_index():
    """Identical rows tie on every expert's affinity; with valid_len the
    masked pads tie at zero as well (the bucketed-prefill case)."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((3, 8)).astype(np.float32)
    x = np.repeat(base, 4, axis=0)                   # 12 tokens, ties of 4
    w = rng.standard_normal((8, 4)).astype(np.float32)
    for vl in (None, 7):
        rj = JR.expert_choice(jnp.asarray(x), jnp.asarray(w), 6, valid_len=vl)
        rt = R.expert_choice(_t(x), _t(w), 6, valid_len=vl)
        np.testing.assert_array_equal(rt.token_idx.numpy(),
                                      np.asarray(rj.token_idx))


def test_batched_expert_choice_routes_per_sequence():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 10, 8)).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    rt = R.expert_choice(_t(x), _t(w), 3)
    for b in range(3):
        rj = JR.expert_choice(jnp.asarray(x[b]), jnp.asarray(w), 3)
        np.testing.assert_array_equal(rt.token_idx[b].numpy(),
                                      np.asarray(rj.token_idx))


@pytest.mark.parametrize("case", ["random", "ties"])
def test_topk_update_matches_reference(case):
    rng = np.random.default_rng(3)
    E, k = 8, 4
    if case == "random":
        s_prev = rng.standard_normal((E, k)).astype(np.float32)
        s_new = rng.standard_normal(E).astype(np.float32)
    else:
        # duplicate minima (the FIRST one is replaced), -inf empty slots and
        # incoming scores exactly equal to the minimum (>= selects)
        s_prev = np.array([[0.5, 0.1, 0.1, 0.9]] * 4
                          + [[-np.inf, -np.inf, 0.2, 0.3]] * 4, np.float32)
        s_new = np.array([0.1, 0.05, 0.2, 0.1, 0.0, -1.0, 0.4, 0.2],
                         np.float32)
    tok_prev = rng.integers(0, 50, (E, k)).astype(np.int32)
    uj = JR.topk_update(jnp.asarray(s_prev), jnp.asarray(tok_prev),
                        jnp.asarray(s_new), 77)
    ut = R.topk_update(_t(s_prev), _t(tok_prev), _t(s_new), 77)
    for a, b in zip(uj, ut):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("C,k", [(6, 4), (2, 4), (4, 4)])
def test_go_cache_prefill_matches_reference(C, k):
    rng = np.random.default_rng(C)
    B, E, d = 2, 3, 5
    outs = rng.standard_normal((B, E, C, d)).astype(np.float32)
    toks = rng.integers(0, 40, (B, E, C)).astype(np.int32)
    # quantized scores make ties among an expert's chosen tokens
    scores = (rng.integers(0, 3, (B, E, C)) / 4).astype(np.float32)
    gj = JGO.go_cache_prefill(None, None, jnp.asarray(outs),
                              jnp.asarray(toks), jnp.asarray(scores), k)
    gt = GO.go_cache_prefill(None, None, _t(outs), _t(toks), _t(scores), k)
    np.testing.assert_array_equal(gt.token_ids.numpy(),
                                  np.asarray(gj.token_ids))
    np.testing.assert_array_equal(gt.scores.numpy(), np.asarray(gj.scores))
    np.testing.assert_array_equal(gt.outputs.numpy(), np.asarray(gj.outputs))


def test_go_cache_step_matches_reference_and_updates_in_place():
    """Three decode steps from a prefilled cache; the port's contrib comes
    from its go_selected_ffn, the reference's from its own."""
    rng = np.random.default_rng(4)
    B, E, k, d, de = 3, 6, 2, 8, 5
    bank = {"wg": rng.standard_normal((E, d, de)).astype(np.float32),
            "wi": rng.standard_normal((E, d, de)).astype(np.float32),
            "wo": rng.standard_normal((E, de, d)).astype(np.float32)}
    gate = rng.standard_normal((d, E)).astype(np.float32)
    outs = rng.standard_normal((B, E, 3, d)).astype(np.float32)
    toks = rng.integers(0, 10, (B, E, 3)).astype(np.int32)
    sc = rng.random((B, E, 3)).astype(np.float32) * 0.3
    cj = JGO.go_cache_prefill(None, None, jnp.asarray(outs),
                              jnp.asarray(toks), jnp.asarray(sc), k)
    ct = GO.go_cache_prefill(None, None, _t(outs), _t(toks), _t(sc), k)
    jb = {n: jnp.asarray(v) for n, v in bank.items()}
    tb = {n: _t(v) for n, v in bank.items()}
    for step in range(3):
        x = rng.standard_normal((B, d)).astype(np.float32)
        rj = JGO.go_cache_step(
            cj, jnp.asarray(x), 10 + step, jnp.asarray(gate),
            contrib_fn=lambda xt, s, g: JOPS.go_selected_ffn(
                xt, s, g, jb, E, bn=8, topk_hint=k)[0])
        scores_buf = ct.scores
        rt = GO.go_cache_step(
            ct, _t(x), 10 + step, _t(gate),
            contrib_fn=lambda xt, s, g: OPS.go_selected_ffn(
                xt, s, g, tb, E))
        assert rt.cache.scores is scores_buf            # written in place
        cj, ct = rj.cache, rt.cache
        np.testing.assert_array_equal(rt.selected.numpy(),
                                      np.asarray(rj.selected))
        np.testing.assert_array_equal(ct.token_ids.numpy(),
                                      np.asarray(cj.token_ids))
        np.testing.assert_allclose(ct.scores.numpy(), np.asarray(cj.scores),
                                   **TOL)
        np.testing.assert_allclose(ct.outputs.numpy(),
                                   np.asarray(cj.outputs), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y),
                                   rtol=1e-5, atol=1e-5)


def test_go_cache_init_matches_reference():
    gj = JGO.go_cache_init(2, 4, 3, 5, jnp.float32)
    gt = GO.go_cache_init(2, 4, 3, 5, torch.float32, "cpu")
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@settings(derandomize=True, database=None, max_examples=40, deadline=None)
@given(st.lists(st.integers(-3, 3), min_size=1, max_size=24),
       st.integers(1, 24))
def test_stable_topk_matches_lax_top_k(vals, k):
    """Small integer values force many ties."""
    k = min(k, len(vals))
    x = np.asarray(vals, np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), k)
    vt, it = R.stable_topk(_t(x), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
