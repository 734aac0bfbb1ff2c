"""The port's TopKUpdate (K5 `go_topk_update`) against the JAX package's
Pallas kernel (interpret mode) and its oracle `ref.go_topk_ref`, and the
GO-cache decode step that now runs it.

On the CPU the wrappers run the plain version; the CUDA kernel is compared
with it in tests/test_torch_cuda.py. Every output is a copy or a
comparison, so all four (scores, ids, selected, slot) must be EQUAL.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.go_topk import go_topk_update as j_go_topk  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import go_cache as GO  # noqa: E402
from repro_torch.core.routing import topk_update  # noqa: E402
from repro_torch.kernels import go_topk as GT  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402

torch.set_float32_matmul_precision("highest")

# tests/test_kernels.py::test_go_topk_sweep's shapes (B, E, k)
SHAPES = [(1, 4, 2), (4, 16, 4), (8, 64, 6), (3, 40, 8)]


def _inputs(seed, B, E, k):
    """Random cached scores with empty rows (-inf, id -1), rows of tied
    minima, and new scores equal to a row's minimum (>= selects)."""
    rng = np.random.default_rng(seed)
    sp = rng.standard_normal((B, E, k)).astype(np.float32)
    tp = rng.integers(0, 1000, (B, E, k)).astype(np.int32)
    sn = rng.standard_normal((B, E)).astype(np.float32)
    rows = rng.permutation(B * E)
    n = max(1, B * E // 6)
    empty, ties, at_min = rows[:n], rows[n:2 * n], rows[2 * n:3 * n]
    sp.reshape(-1, k)[empty] = -np.inf
    tp.reshape(-1, k)[empty] = -1
    sp.reshape(-1, k)[ties] = np.round(sp.reshape(-1, k)[ties])
    sn.reshape(-1)[at_min] = sp.reshape(-1, k)[at_min].min(axis=1)
    tid = rng.integers(1000, 2000, B).astype(np.int32)
    return sp, tp, sn, tid


def _jax(sp, tp, sn, token_id):
    """JAX's kernel in interpret mode; a [B] token id runs it row by row
    (it broadcasts one scalar over the batch)."""
    if np.ndim(token_id) == 0:
        return [np.asarray(a) for a in j_go_topk(
            jnp.asarray(sp), jnp.asarray(tp), jnp.asarray(sn),
            int(token_id), interpret=True)]
    rows = [j_go_topk(jnp.asarray(sp[b:b + 1]), jnp.asarray(tp[b:b + 1]),
                      jnp.asarray(sn[b:b + 1]), int(token_id[b]),
                      interpret=True) for b in range(sp.shape[0])]
    return [np.concatenate([np.asarray(r[i]) for r in rows])
            for i in range(4)]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("B,E,k", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(B, E, k, per_row):
    sp, tp, sn, tid = _inputs(B * E + k, B, E, k)
    token_id = tid if per_row else 1001
    tid_t = torch.from_numpy(tid) if per_row else 1001
    before = dict(GT.LAUNCHES)
    got = GT.go_topk_update(torch.from_numpy(sp), torch.from_numpy(tp),
                            torch.from_numpy(sn), tid_t)
    assert GT.LAUNCHES == before             # the plain version counts nothing
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.bool,
                                      torch.int32]
    want = _jax(sp, tp, sn, token_id)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if not per_row:
        oracle = ref.go_topk_ref(jnp.asarray(sp), jnp.asarray(tp),
                                 jnp.asarray(sn), 1001)
        for g, w in zip(got, oracle):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the cases the inputs were built to hold
    empty = np.isneginf(sp).all(axis=2)
    assert empty.any()
    sel, slot = got[2].numpy(), got[3].numpy()
    assert sel[empty].all() and (slot[empty] == 0).all()


@pytest.mark.parametrize("B,E,k", SHAPES)
def test_in_place_form_equals_functional(B, E, k):
    sp, tp, sn, tid = _inputs(7 + k, B, E, k)
    s, t = torch.from_numpy(sp.copy()), torch.from_numpy(tp.copy())
    want = GT.go_topk_update(torch.from_numpy(sp), torch.from_numpy(tp),
                             torch.from_numpy(sn), torch.from_numpy(tid))
    sel, slot = GT.go_topk_update_(s, t, torch.from_numpy(sn),
                                   torch.from_numpy(tid))
    for g, w in zip((s, t, sel, slot), want):
        assert torch.equal(g, w)


def test_in_place_form_raises_on_a_strided_view_and_bad_operands():
    sp, tp, sn, _ = _inputs(0, 4, 16, 4)
    wide = torch.zeros(4, 16, 8)
    view = wide[..., :4]                     # [4, 16, 4], not contiguous
    view.copy_(torch.from_numpy(sp))
    t = torch.from_numpy(tp)
    with pytest.raises(ValueError, match="contiguous"):
        GT.go_topk_update_(view, t, torch.from_numpy(sn), 3)
    with pytest.raises(ValueError, match="contiguous"):
        GT.go_topk_update_(torch.from_numpy(sp), t.transpose(1, 2)
                           .contiguous().transpose(1, 2), torch.from_numpy(sn),
                           3)
    with pytest.raises(TypeError, match="int32"):
        GT.go_topk_update_(torch.from_numpy(sp), t.long(),
                           torch.from_numpy(sn), 3)
    with pytest.raises(ValueError, match="want an int or"):
        GT.go_topk_update(torch.from_numpy(sp), t, torch.from_numpy(sn),
                          torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="want"):
        GT.go_topk_update(torch.from_numpy(sp), t, torch.from_numpy(sn[:2]),
                          3)
    with pytest.raises(ValueError, match="no TopKUpdate path"):
        m = torch.zeros(1, 2, 2, device="meta")
        GT.go_topk_update(m, m.int(), m[:, :, 0], 3)


def _step_before(cache, x_t, token_id, gate_w, *, contrib_fn):
    """go_cache_step as it was before K5: routing.topk_update, then the
    cache's copies (kept here as the yardstick)."""
    g = torch.softmax(x_t.float() @ gate_w.float(), dim=-1)
    upd = topk_update(cache.scores, cache.token_ids, g, token_id)
    contrib = contrib_fn(x_t, upd.selected, g)
    k = cache.scores.shape[-1]
    onehot = upd.slot[..., None] == torch.arange(k)
    write = (upd.selected[..., None] & onehot)[..., None]
    cache.outputs.copy_(torch.where(
        write, contrib[:, :, None, :].to(cache.outputs.dtype), cache.outputs))
    cache.scores.copy_(upd.new_scores)
    cache.token_ids.copy_(upd.new_token_ids)
    return contrib.sum(dim=1).to(x_t.dtype), upd.selected


@pytest.mark.parametrize("engine", [False, True])
def test_go_cache_step_is_bit_equal_to_the_step_before_k5(engine):
    """Four decode steps on the llama smoke MoE (8 experts, k = 2, d 64)
    from a prefilled cache held, as the decode state holds it, in a
    contiguous [L, B, E, k] buffer: the same selected, y, scores, ids and
    outputs, bit for bit; the token id an int (static batch) or [B]
    (the engine's per-slot positions)."""
    cfg = get_config("llama_moe_4_16", smoke=True)
    E, k, d, de = (cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model,
                   cfg.moe.d_expert)
    B, C = 3, 5
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(                     # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    bank = {"wg": f(E, d, de) / 8, "wi": f(E, d, de) / 8, "wo": f(E, de, d) / 6}
    gate = f(d, E)
    pre = GO.go_cache_prefill(
        None, None, f(B, E, C, d),
        torch.from_numpy(rng.integers(0, 20, (B, E, C)).astype(np.int32)),
        torch.rand(B, E, C, generator=torch.Generator().manual_seed(0)) * 0.2,
        k)
    caches = []
    for _ in range(2):
        state = GO.go_cache_init(B, E, k, d, torch.float32, "cpu", lead=(2,))
        for dst, src in zip(state, pre):
            dst[1].copy_(src)
        caches.append(GO.GOCache(*(a[1] for a in state)))
    new, old = caches
    assert new.scores.is_contiguous()
    fn = lambda xt, sel, g: OPS.go_selected_ffn(xt, sel, g, bank, E)  # noqa
    for step in range(4):
        x = f(B, d)
        tid = (torch.arange(B, dtype=torch.int32) + 20 + step if engine
               else 20 + step)
        res = GO.go_cache_step(new, x, tid, gate, contrib_fn=fn)
        y, sel = _step_before(old, x, tid, gate, contrib_fn=fn)
        assert torch.equal(res.selected, sel) and torch.equal(res.y, y)
        for a, b in zip(new, old):
            assert torch.equal(a, b)
    assert bool(sel.any()) and not bool(sel.all())
