"""The GO-cache decode past the router's bound of 64 rows or 64 experts.

`go_cache_step` picks its route by shape (`go_topk.router_fits`): up to 64
rows and 64 experts the router K5R, past that the gate row and softmax,
K5 in place and `go_lane_plan`. On the CPU both routes run their plain
versions. Held against the JAX package on the same seeded numpy inputs:

  * `go_cache_step` at (B 65, E 8), (B 96, E 16) and (B 4, E 72) against
    the JAX `go_cache_step` (its `go_selected_ffn` as contrib_fn):
    selected and token ids exactly, y, scores and outputs within G_TOL
    (the packages' g differ in the last bits: exp and the gate row's sums
    in other orders), and the scores exactly against the JAX TopKUpdate
    on the port's own g;
  * static `generate()` at batch 65 and a 65-slot paged engine on the
    smoke llama_moe_4_16 against the JAX package's: greedy tokens equal;
  * `go_decode_budget` against the reference's over a grid of shapes, and
    the GEMM body's launch arithmetic on decode plans of several tiles a
    lane.

The card's K5 route is checked in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import go_cache as JGO  # noqa: E402
from repro.core import routing as JR  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro_torch.core import go_cache as GO  # noqa: E402
from repro_torch.kernels import go_topk as GT  # noqa: E402
from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
# g, y and the cached outputs against JAX's: fp32 in other orders (the
# tolerance of tests/test_torch_go_router.py)
G_TOL = 1e-6
BN = 8                                     # the CPU's row tile


def test_router_fits_on_its_edges():
    assert GT.router_fits(64, 64) and GT.router_fits(1, 1)
    assert not GT.router_fits(65, 8) and not GT.router_fits(4, 65)
    assert GT.router_fits(64, 8) and not GT.router_fits(0, 8)
    assert GT.ROUTER_MAX == 64


def _inputs(seed, B, E, k, d, de=16):
    """x, gate_w, a cache (scores in [0, 2/E) with empty rows: -inf and
    id -1; outputs), per-row token ids and an expert bank, as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, w = f(B, d), (f(d, E) / np.sqrt(d)).astype(np.float32)
    sp = (rng.random((B, E, k)) * 2.0 / E).astype(np.float32)
    tp = rng.integers(0, 1000, (B, E, k)).astype(np.int32)
    empty = rng.permutation(B * E)[:max(1, B * E // 8)]
    sp.reshape(-1, k)[empty] = -np.inf
    tp.reshape(-1, k)[empty] = -1
    out = f(B, E, k, d)
    tid = rng.integers(1000, 2000, B).astype(np.int32)
    bank = {"wg": f(E, d, de) / 8, "wi": f(E, d, de) / 8,
            "wo": f(E, de, d) / 4}
    return x, w, (sp, tp, out), tid, bank


def _port_cache(c):
    """The cache as the decode state holds it: contiguous per-layer views
    of a [1, B, E, k(, d)] buffer."""
    sp, tp, out = c
    B, E, k, d = out.shape
    state = GO.go_cache_init(B, E, k, d, torch.float32, "cpu", lead=(1,))
    for dst, src in zip(state, c):
        dst[0].copy_(torch.from_numpy(src))
    return GO.GOCache(*(a[0] for a in state))


@pytest.mark.parametrize("B,E,k,d", [(65, 8, 2, 32), (96, 16, 4, 32),
                                     (4, 72, 4, 32)])
def test_go_cache_step_past_the_router_matches_jax(B, E, k, d, monkeypatch):
    x, w, c, tid, bank = _inputs(B * E + k, B, E, k, d)

    def no_router(*a, **kw):
        raise AssertionError("K5R's route taken past its bound")
    monkeypatch.setattr(GO, "go_router_", no_router)
    cache = _port_cache(c)
    tbank = {n: torch.from_numpy(a) for n, a in bank.items()}
    plans = []

    def contrib(xt, sel, g, plan):
        plans.append(plan)
        return OPS.go_plan_ffn(xt, plan, tbank)
    res = GO.go_cache_step(cache, torch.from_numpy(x), torch.from_numpy(tid),
                           torch.from_numpy(w), contrib_fn=contrib, bn=BN)
    # the wide route's plan: every lane spans ceil(B / bn) tiles
    assert plans[0].idx_p.shape == (E, -(-B // BN) * BN)

    jbank = {n: jnp.asarray(a) for n, a in bank.items()}
    jres = JGO.go_cache_step(
        JGO.GOCache(*(jnp.asarray(a) for a in c)), jnp.asarray(x),
        jnp.asarray(tid), jnp.asarray(w),
        contrib_fn=lambda xt, sel, g: JOPS.go_selected_ffn(
            xt, sel, g, jbank, E, bn=BN)[0])
    sel = res.selected.numpy()
    assert sel.any() and not sel.all()
    np.testing.assert_array_equal(sel, np.asarray(jres.selected))
    np.testing.assert_array_equal(cache.token_ids.numpy(),
                                  np.asarray(jres.cache.token_ids))
    for got, want in ((res.y, jres.y), (cache.scores, jres.cache.scores),
                      (cache.outputs, jres.cache.outputs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=G_TOL, atol=G_TOL)
    # the scores exactly: JAX's TopKUpdate on the port's own g
    g = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), dim=-1)
    upd = jax.vmap(JR.topk_update)(jnp.asarray(c[0]), jnp.asarray(c[1]),
                                   jnp.asarray(g.numpy()), jnp.asarray(tid))
    np.testing.assert_array_equal(cache.scores.numpy(),
                                  np.asarray(upd.new_scores))
    np.testing.assert_array_equal(cache.token_ids.numpy(),
                                  np.asarray(upd.new_token_ids))


def test_the_route_is_chosen_by_shape(monkeypatch):
    """At 64 rows the router runs; at 65 it does not, and the step leaves
    the cache as the router's route would on the same g."""
    calls = []
    real = GO.go_router_
    monkeypatch.setattr(GO, "go_router_",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    fn = lambda tb: (lambda xt, sel, g, plan:  # noqa: E731
                     OPS.go_plan_ffn(xt, plan, tb))
    for B, routed in ((64, 1), (65, 0)):
        calls.clear()
        x, w, c, tid, bank = _inputs(B, B, 8, 2, 32)
        tb = {k: torch.from_numpy(a) for k, a in bank.items()}
        wide = _port_cache(c)
        r = GO.go_cache_step(wide, torch.from_numpy(x), torch.from_numpy(tid),
                             torch.from_numpy(w), contrib_fn=fn(tb), bn=BN)
        assert len(calls) == routed
        # the router's plain route on the same inputs (no bound on the CPU
        # plain version) leaves the same cache and y
        ref = _port_cache(c)
        s, t, route = GT.go_router_plain(
            torch.from_numpy(x), torch.from_numpy(w), ref.scores,
            ref.token_ids, torch.from_numpy(tid), BN)
        assert torch.equal(s, wide.scores) and torch.equal(t, wide.token_ids)
        assert torch.equal(route.selected, r.selected)
        y = OPS.go_plan_ffn(torch.from_numpy(x), route.plan, tb).sum(dim=1)
        assert torch.equal(y, r.y)


@pytest.mark.parametrize("B", [1, 4, 16, 64, 65, 72, 96, 300])
def test_go_decode_budget_matches_reference(B):
    for E, k, bn in ((8, 2, 8), (16, 4, 8), (16, 4, 64), (40, 8, 64),
                     (72, 0, 8), (64, 6, 16)):
        assert OPS.go_decode_budget(B, E, k, bn) == \
            JOPS.go_decode_budget(B, E, k, bn)


@pytest.mark.parametrize("B", [65, 72, 128, 129, 200])
def test_gemm_ring_takes_a_decode_plan_of_several_tiles_a_lane(B):
    """The bf16 GEMM body's launch arithmetic at llama's full-width decode
    plan past 64 rows (lanes of ceil(B / 64) tiles of the card's 64 rows):
    its blocks cover every tile, lanes are whole tiles (no pad rows), and
    at two tiles a block a block holds one lane's pair or straddles two
    lanes, which the body runs as one pass per expert."""
    E, d, de, bm = 16, 4096, 688, G.KERNEL_BLOCK_ROWS
    N = E * -(-B // bm) * bm
    for K, F, swiglu in ((d, de, True), (de, d, False)):
        r = G.gemm_ring(N, K, F, E, swiglu=swiglu)
        assert r["tiles_per_block"] in (1, 2) and r["pad_rows"] == []
        assert r["grid"][1] * r["tiles_per_block"] >= N // bm
    assert G.gemm_ring(E * 128, d, de, E, swiglu=True)["tiles_per_block"] == 2


# ------------------------------------------------- the slice at 65 rows

@pytest.fixture(scope="module")
def bridged():
    return smoke_pair("llama_moe_4_16")


def test_static_generate_at_batch_65_equals_jax(bridged):
    jcfg, tcfg, p, tp = bridged
    prompts = np.random.default_rng(65).integers(
        0, jcfg.vocab_size, size=(65, 8), dtype=np.int32)
    rj = JS.generate(p, jcfg, jnp.asarray(prompts), 4)
    rt = TS.generate(tp, tcfg, torch.from_numpy(prompts), 4, device="cpu")
    np.testing.assert_array_equal(rt["tokens"].numpy(),
                                  np.asarray(rj["tokens"]))


def test_engine_of_65_slots_equals_jax_engine(bridged):
    """65 requests of one prompt length (one JAX prefill compile), 3 new
    tokens each, all admitted at once into a 65-slot paged pool."""
    jcfg, tcfg, p, tp = bridged
    rng = np.random.default_rng(66)
    prompts = [rng.integers(0, jcfg.vocab_size, size=6, dtype=np.int32)
               for _ in range(65)]
    pool = dict(num_slots=65, max_tokens=12, paged=True, page_size=4)
    ref = JS.serve_continuous(p, jcfg, prompts, 3, **pool)
    eng = ServingEngine(tp, tcfg, device="cpu", **pool)
    rids = [eng.submit(q, 3) for q in prompts]
    fin = eng.run()
    for rid in rids:
        assert fin[rid].tokens == ref["tokens"][rid].tolist(), rid
    assert eng.peak_active == 65 == ref["stats"]["peak_active"]
