"""The port's GO decode router (K5R `go_router`: the gate row, its softmax,
the TopKUpdate and the selected-pair lane plan in one launch on a card).

On the CPU the wrappers run the plain version, which these tests hold
against the JAX package: g against `softmax(routing.gate_scores)`, and the
TopKUpdate on that same g against `jax.vmap(routing.topk_update)` and the
Pallas `go_topk_update` in interpret mode, exactly. The lane plan is held
bit for bit against the plan `go_selected_ffn` built before the router
existed (copied here as the yardstick) and against a brute force; the
GO-cache step through the router against the step before it. The CUDA
kernel is compared with the plain version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import routing as JR  # noqa: E402
from repro.kernels.go_topk import go_topk_update as j_go_topk  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import go_cache as GO  # noqa: E402
from repro_torch.core.routing import topk_update  # noqa: E402
from repro_torch.kernels import go_topk as GT  # noqa: E402
from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402

torch.set_float32_matmul_precision("highest")

# K5's four shapes (B, E, k) (tests/test_kernels.py::test_go_topk_sweep)
# with a width d each, and the llama smoke decode (E 8, k 2, d 64)
SHAPES = [(1, 4, 2, 16), (4, 16, 4, 32), (8, 64, 6, 24), (3, 40, 8, 40),
          (4, 8, 2, 64)]
# g against the JAX package's: fp32 sums of the gate row in another order
G_TOL = 1e-6


def _inputs(seed, B, E, k, d):
    """x, gate_w, and a cache built around this input's g (the plain gate
    row and softmax): empty rows (-inf, id -1), rows of tied minima, rows
    whose minimum equals the new score (>= selects) and rows whose minimum
    lies one ulp above it (no selection); per-row token ids."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    w = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    g = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w),
                      dim=-1).numpy()
    sp = (rng.random((B, E, k)) * 2.0 / E).astype(np.float32)
    tp = rng.integers(0, 1000, (B, E, k)).astype(np.int32)
    rows = rng.permutation(B * E)
    n = max(1, B * E // 8)
    empty, ties, at_min, above = (rows[i * n:(i + 1) * n] for i in range(4))
    s2, t2, g1 = sp.reshape(-1, k), tp.reshape(-1, k), g.reshape(-1)
    s2[empty] = -np.inf
    t2[empty] = -1
    s2[ties] = s2[ties].min(axis=1, keepdims=True)
    for r in at_min:
        s2[r] = g1[r] + np.abs(s2[r]) + 1e-3
        s2[r, rng.integers(k)] = g1[r]
    for r in above:
        s2[r] = g1[r] + np.abs(s2[r]) + 1e-3
        s2[r, rng.integers(k)] = np.nextafter(g1[r], np.float32(np.inf))
    tid = rng.integers(1000, 2000, B).astype(np.int32)
    return x, w, sp, tp, tid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plan_before(selected, g, bn):
    """The lane plan as go_selected_ffn built it before the router (kept
    here as the yardstick): (idx_p int64 [E, Cp], scale [E*Cp, 1], te,
    tv)."""
    B, E = selected.shape
    selT = selected.T
    counts = selT.sum(dim=1).to(torch.int32)
    ar = torch.arange(B, dtype=torch.int32)
    keys = torch.where(selT, B - ar[None, :], -1 - ar[None, :])
    gsel = torch.where(selT, g.T, 0.0)
    C = B
    idx = torch.sort(keys, dim=1, descending=True, stable=True)[1][:, :C]
    w = torch.gather(gsel, 1, idx)
    Cp = -(-C // bn) * bn
    idx_p = torch.nn.functional.pad(idx, (0, Cp - C))
    scale = torch.nn.functional.pad(w, (0, Cp - C)).reshape(E * Cp, 1)
    te = torch.arange(E, dtype=torch.int32).repeat_interleave(Cp // bn)
    slot = torch.arange(Cp // bn, dtype=torch.int32) * bn
    tv = (slot[None, :] < counts[:, None]).reshape(-1)
    return idx_p, scale, te, tv


def _plan_brute(sel, g, bn):
    """The same plan from its definition, by loops over numpy arrays."""
    B, E = sel.shape
    Cp = -(-B // bn) * bn
    idx = np.zeros((E, Cp), np.int32)
    scale = np.zeros((E, Cp), np.float32)
    tv = np.zeros((E, Cp // bn), bool)
    for e in range(E):
        rows = [b for b in range(B) if sel[b, e]]
        idx[e, :B] = rows + [b for b in range(B) if not sel[b, e]]
        scale[e, :len(rows)] = g[rows, e]
        tv[e] = np.arange(Cp // bn) * bn < len(rows)
    te = np.repeat(np.arange(E, dtype=np.int32), Cp // bn)
    return idx, scale.reshape(-1), tv.reshape(-1), te


def _jax_topk(sp, tp, g, token_id):
    """JAX's TopKUpdate on the port's g: the vmapped jnp function and the
    Pallas kernel in interpret mode (a [B] token id runs it row by row: it
    broadcasts one scalar over the batch)."""
    B = sp.shape[0]
    tid = np.broadcast_to(np.asarray(token_id, np.int32), (B,))
    v = jax.vmap(JR.topk_update)(jnp.asarray(sp), jnp.asarray(tp),
                                 jnp.asarray(g), jnp.asarray(tid))
    rows = [j_go_topk(jnp.asarray(sp[b:b + 1]), jnp.asarray(tp[b:b + 1]),
                      jnp.asarray(g[b:b + 1]), int(tid[b]), interpret=True)
            for b in range(B)]
    pallas = [np.concatenate([np.asarray(r[i]) for r in rows])
              for i in range(4)]
    return [np.asarray(a) for a in v], pallas


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("B,E,k,d", SHAPES)
def test_plain_router_matches_jax(B, E, k, d, per_row):
    x, w, sp, tp, tid = _inputs(B * E + k + d, B, E, k, d)
    token_id = tid if per_row else 1001
    before = dict(GT.LAUNCHES)
    s, t, r = GT.go_router(_t(x), _t(w), _t(sp), _t(tp),
                           _t(tid) if per_row else 1001, 8)
    assert GT.LAUNCHES == before             # the plain version counts nothing
    assert [a.dtype for a in (s, t, r.g, r.selected, r.slot)] == [
        torch.float32, torch.int32, torch.float32, torch.bool, torch.int32]
    gj = np.asarray(jax.nn.softmax(JR.gate_scores(jnp.asarray(x),
                                                  jnp.asarray(w)), axis=-1))
    np.testing.assert_allclose(r.g.numpy(), gj, rtol=G_TOL, atol=G_TOL)
    g = r.g.numpy()
    for want in _jax_topk(sp, tp, g, token_id):
        for got, wv in zip((s, t, r.selected, r.slot), want):
            np.testing.assert_array_equal(got.numpy(), wv)
    # the cases the inputs were built to hold
    sel = r.selected.numpy()
    empty = np.isneginf(sp).all(axis=2)
    assert empty.any() and sel[empty].all()
    assert (r.slot.numpy()[empty] == 0).all()
    assert sel.any() and not sel.all()


@pytest.mark.parametrize("bn", [1, 8, 64])
@pytest.mark.parametrize("B,E,k,d", SHAPES)
def test_lane_plan_equals_the_plan_before_and_brute_force(B, E, k, d, bn):
    x, w, sp, tp, tid = _inputs(3 * B + E, B, E, k, d)
    _, _, r = GT.go_router(_t(x), _t(w), _t(sp), _t(tp), _t(tid), bn)
    p = r.plan
    idx_p, scale, te, tv = _plan_before(r.selected, r.g, bn)
    assert p.bn == bn and p.idx_p.dtype == torch.int32
    assert torch.equal(p.idx_p.long(), idx_p)
    assert torch.equal(p.scale.view(-1, 1), scale)
    assert torch.equal(p.tile_expert, te) and torch.equal(p.tile_valid, tv)
    bi, bs, btv, bte = _plan_brute(r.selected.numpy(), r.g.numpy(), bn)
    np.testing.assert_array_equal(p.idx_p.numpy(), bi)
    np.testing.assert_array_equal(p.scale.numpy(), bs)
    np.testing.assert_array_equal(p.tile_valid.numpy(), btv)
    np.testing.assert_array_equal(p.tile_expert.numpy(), bte)


@pytest.mark.parametrize("B,E,k,d", SHAPES)
def test_in_place_router_equals_functional(B, E, k, d):
    x, w, sp, tp, tid = _inputs(11 + k, B, E, k, d)
    s0, t0, want = GT.go_router(_t(x), _t(w), _t(sp), _t(tp),
                                _t(tid).long(), 8)
    s, t = _t(sp.copy()), _t(tp.copy())
    got = GT.go_router_(_t(x), _t(w), s, t, _t(tid).long(), 8)
    assert torch.equal(s, s0) and torch.equal(t, t0)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for a, b in zip(got.plan[:4], want.plan[:4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d,E,w_bytes", [(4096, 16, 4), (4096, 16, 2),
                                         (64, 8, 4), (256, 40, 4),
                                         (4096, 64, 4), (16384, 64, 2),
                                         (1000, 4, 2), (1, 1, 4)])
def test_router_splits_cover_the_gate_rows_once(d, E, w_bytes):
    """K5R's grid: spans of gate_w rows of about ROUTER_SPLIT_BYTES cover
    the d rows exactly once, at most ROUTER_MAX_SPLITS of them; the gate row
    summed span by span in span order (the kernel's order across CTAs)
    gives g within G_TOL of the plain g."""
    rows, splits = GT.router_splits(d, E, w_bytes)
    assert 1 <= splits <= GT.ROUTER_MAX_SPLITS
    assert (splits - 1) * rows < d <= splits * rows
    assert splits == 1 or rows * E * w_bytes >= GT.ROUTER_SPLIT_BYTES - (
        E * w_bytes - 1)
    if (d, E) == (4096, 16):
        assert (rows, splits) == ((128, 32) if w_bytes == 4 else (256, 16))
    rng = np.random.default_rng(d + E)
    x = _t(rng.standard_normal((4, d)).astype(np.float32))
    w = _t((rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32))
    s = sum(x[:, c * rows:(c + 1) * rows] @ w[c * rows:(c + 1) * rows]
            for c in range(splits))
    torch.testing.assert_close(torch.softmax(s, dim=-1),
                               torch.softmax(x @ w, dim=-1), rtol=G_TOL,
                               atol=G_TOL)


def test_router_raises_beyond_its_bounds_and_on_bad_operands():
    x, w, sp, tp, _ = _inputs(0, 4, 16, 4, 32)
    X, W, S, T = _t(x), _t(w), _t(sp), _t(tp)
    with pytest.raises(ValueError, match="must lie in 1..64"):
        GT.go_router(torch.zeros(65, 32), W, torch.zeros(65, 16, 4),
                     torch.zeros(65, 16, 4, dtype=torch.int32), 3, 8)
    with pytest.raises(ValueError, match="must lie in 1..64"):
        GT.go_router_(X, torch.zeros(32, 65), torch.zeros(4, 65, 4),
                      torch.zeros(4, 65, 4, dtype=torch.int32), 3, 8)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(4, 16, 8)
        GT.go_router_(X, W, wide[..., :4], T, 3, 8)
    with pytest.raises(TypeError, match="int32"):
        GT.go_router_(X, W, S, T.long(), 3, 8)
    with pytest.raises(ValueError, match="want"):
        GT.go_router(X, W[:, :8], S, T, 3, 8)
    with pytest.raises(ValueError, match="want an int or"):
        GT.go_router(X, W, S, T, torch.zeros(3, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="tile height"):
        GT.go_router(X, W, S, T, 3, 0)
    with pytest.raises(ValueError, match="no router path"):
        m = torch.zeros(4, 32, device="meta")
        GT.go_router(m, torch.zeros(32, 16, device="meta"),
                     torch.zeros(4, 16, 4, device="meta"),
                     torch.zeros(4, 16, 4, dtype=torch.int32, device="meta"),
                     3, 8)


def _selected_ffn_before(x, selected, g, bank, bn):
    """go_selected_ffn as it was before the router (kept here as the
    yardstick): the sort-based plan, K1 and K2's plain versions, the
    scatter back to token-major order."""
    B, d = x.shape
    E = selected.shape[1]
    idx_p, scale, te, tv = _plan_before(selected, g, bn)
    Cp = idx_p.shape[1]
    x_rows = x[idx_p].reshape(E * Cp, d)
    h = G.gmm_swiglu(x_rows, bank["wg"], bank["wi"], te, tv, bn=bn)
    y_rows = G.gmm_scaled(h, bank["wo"], te, tv, scale, bn=bn)
    y = y_rows.reshape(E, Cp, d)[:, :B]
    w = scale.view(E, Cp)[:, :B]
    z = torch.zeros((B + 1, E, d), dtype=torch.float32)
    eix = torch.arange(E)[:, None].expand(E, B)
    z[torch.where(w > 0, idx_p[:, :B], B), eix] = y
    return z[:B]


def _step_before(cache, x_t, token_id, gate_w, bank, bn):
    """go_cache_step before the router: the gate row, softmax,
    routing.topk_update, the FFN over the sort-based plan, then the cache's
    copies."""
    g = torch.softmax(x_t.float() @ gate_w.float(), dim=-1)
    upd = topk_update(cache.scores, cache.token_ids, g, token_id)
    contrib = _selected_ffn_before(x_t, upd.selected, g, bank, bn)
    k = cache.scores.shape[-1]
    onehot = upd.slot[..., None] == torch.arange(k)
    write = (upd.selected[..., None] & onehot)[..., None]
    cache.outputs.copy_(torch.where(
        write, contrib[:, :, None, :].to(cache.outputs.dtype), cache.outputs))
    cache.scores.copy_(upd.new_scores)
    cache.token_ids.copy_(upd.new_token_ids)
    return contrib.sum(dim=1).to(x_t.dtype), upd.selected


def _smoke_setup(B=3, C=5, seed=5):
    cfg = get_config("llama_moe_4_16", smoke=True)
    E, k, d, de = (cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model,
                   cfg.moe.d_expert)
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(                     # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    bank = {"wg": f(E, d, de) / 8, "wi": f(E, d, de) / 8,
            "wo": f(E, de, d) / 6}
    gate = f(d, E)
    pre = GO.go_cache_prefill(
        None, None, f(B, E, C, d),
        torch.from_numpy(rng.integers(0, 20, (B, E, C)).astype(np.int32)),
        torch.rand(B, E, C, generator=torch.Generator().manual_seed(0)) * 0.2,
        k)
    return cfg, bank, gate, pre, f


@pytest.mark.parametrize("bn", [8, 64])
@pytest.mark.parametrize("engine", [False, True])
def test_go_cache_step_through_the_router_is_bit_equal_to_the_step_before(
        engine, bn):
    """Four decode steps on the llama smoke MoE from a prefilled cache held,
    as the decode state holds it, in a contiguous [L, B, E, k] buffer; the
    FFN runs the router's plan (bn given, go_plan_ffn) on one copy and the
    pre-router composition on the other: the same selected, y, scores, ids
    and outputs, bit for bit."""
    cfg, bank, gate, pre, f = _smoke_setup()
    B, E = pre.scores.shape[:2]
    k, d = pre.scores.shape[2], pre.outputs.shape[-1]
    caches = []
    for _ in range(2):
        state = GO.go_cache_init(B, E, k, d, torch.float32, "cpu", lead=(2,))
        for dst, src in zip(state, pre):
            dst[1].copy_(src)
        caches.append(GO.GOCache(*(a[1] for a in state)))
    new, old = caches
    fn = lambda xt, sel, g, plan: OPS.go_plan_ffn(xt, plan, bank)  # noqa
    for step in range(4):
        x = f(B, d)
        tid = (torch.arange(B, dtype=torch.int32) + 20 + step if engine
               else 20 + step)
        res = GO.go_cache_step(new, x, tid, gate, contrib_fn=fn, bn=bn)
        y, sel = _step_before(old, x, tid, gate, bank, bn)
        assert torch.equal(res.selected, sel) and torch.equal(res.y, y)
        for a, b in zip(new, old):
            assert torch.equal(a, b)
    assert bool(sel.any()) and not bool(sel.all())


def test_go_cache_step_on_a_strided_cache_builds_the_same_plan():
    """A standalone go_cache_prefill result (strided top-k views) keeps the
    functional K5 and builds the plan with go_lane_plan: the same step as
    on a contiguous copy of the cache through the router."""
    cfg, bank, gate, pre, f = _smoke_setup(seed=9)
    assert not pre.scores.is_contiguous()
    dense = GO.GOCache(*(a.contiguous().clone() for a in pre))
    assert dense.scores.is_contiguous()
    plans = []
    fn = lambda xt, sel, g, plan: (plans.append(plan),  # noqa: E731
                                   OPS.go_plan_ffn(xt, plan, bank))[1]
    for step in range(3):
        x = f(pre.scores.shape[0], pre.outputs.shape[-1])
        a = GO.go_cache_step(pre, x, 7 + step, gate, contrib_fn=fn, bn=8)
        b = GO.go_cache_step(dense, x, 7 + step, gate, contrib_fn=fn, bn=8)
        assert torch.equal(a.y, b.y) and torch.equal(a.selected, b.selected)
        for u, v in zip(plans[-2][:4], plans[-1][:4]):
            assert torch.equal(u, v)
        for u, v in zip(pre, dense):
            assert torch.equal(u, v)
