"""The port's MoE executors against the JAX package's: `moe_ffn_fused` on
the expert-choice layout and on random routings, and `go_selected_ffn` on
a decode tick within the reference's fast budget and on one that
overflows it (C_fast < C_full). The JAX side runs its Pallas kernels in
interpret mode. Tolerance: fp32, summation order only -> 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as JOPS  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-5, atol=1e-5)


def _bank(rng, E, d, de):
    return {"wg": (rng.standard_normal((E, d, de)) / np.sqrt(d)).astype(np.float32),
            "wi": (rng.standard_normal((E, d, de)) / np.sqrt(d)).astype(np.float32),
            "wo": (rng.standard_normal((E, de, d)) / np.sqrt(de)).astype(np.float32)}


def _both(bank):
    return ({k: jnp.asarray(v) for k, v in bank.items()},
            {k: torch.from_numpy(v) for k, v in bank.items()})


@pytest.mark.parametrize("layout", ["expert_choice", "random"])
def test_moe_ffn_fused_matches_reference(layout):
    rng = np.random.default_rng(11)
    T, d, de, E = 24, 32, 20, 4
    if layout == "expert_choice":
        cap = 6
        ef = np.repeat(np.arange(E, dtype=np.int32), cap)
        tok = rng.integers(0, T, E * cap).astype(np.int32)
    else:
        ef = rng.integers(0, E, 40).astype(np.int32)
        tok = rng.integers(0, T, 40).astype(np.int32)
    wf = rng.random(ef.shape[0]).astype(np.float32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    jb, tb = _both(_bank(rng, E, d, de))
    yj, yrj, _ = JOPS.moe_ffn_fused(jnp.asarray(x), jnp.asarray(tok),
                                    jnp.asarray(ef), jnp.asarray(wf), jb, E,
                                    T, bn=8, interpret=True)
    yt, yrt, plan = OPS.moe_ffn_fused(torch.from_numpy(x),
                                      torch.from_numpy(tok),
                                      torch.from_numpy(ef),
                                      torch.from_numpy(wf), tb, E, T,
                                      max_per_token=int(np.bincount(tok).max()))
    assert plan.n_pad == yrt.shape[0]
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(yrt.numpy(), np.asarray(yrj), **TOL)


def _decode_tick(rng, B, E, max_per_expert):
    """A selection mask with at most max_per_expert rows per expert (and
    exactly that many in expert 0)."""
    sel = np.zeros((B, E), bool)
    for e in range(E):
        n = max_per_expert if e == 0 else rng.integers(0, max_per_expert + 1)
        sel[rng.choice(B, size=n, replace=False), e] = True
    return sel


@pytest.mark.parametrize("executor", ["xla", "pallas"])
@pytest.mark.parametrize("overflow", [False, True])
def test_go_selected_ffn_budget_and_overflow_ticks(executor, overflow):
    """B=32, E=8, k=2 at bn=8: the reference's budget C_fast is 24 rows per
    expert (18 with its bn=1 xla executor), C_full 32. An overflow tick puts
    more selected rows on expert 0 than either budget holds."""
    rng = np.random.default_rng(3 + overflow)
    B, d, de, E, k = 32, 32, 16, 8, 2
    x = rng.standard_normal((B, d)).astype(np.float32)
    g = rng.random((B, E)).astype(np.float32) + 0.01
    g /= g.sum(-1, keepdims=True)
    sel = _decode_tick(rng, B, E, 28 if overflow else 4)
    jb, tb = _both(_bank(rng, E, d, de))
    cj, pj = JOPS.go_selected_ffn(jnp.asarray(x), jnp.asarray(sel),
                                  jnp.asarray(g), jb, E, bn=8,
                                  interpret=True, topk_hint=k,
                                  executor=executor)
    # the reference took its fast plan on a budget tick, C_full on overflow
    assert pj.C_fast < pj.C_full == B
    assert bool(pj.fallback) == overflow
    ct = OPS.go_selected_ffn(torch.from_numpy(x), torch.from_numpy(sel),
                             torch.from_numpy(g), tb, E)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    assert (ct.numpy()[~sel] == 0).all()
    assert (np.abs(ct.numpy()[sel]).sum(-1) > 0).all()


def test_shared_experts_are_rejected_not_dropped():
    """A bank with always-on shared experts raises instead of serving
    without them."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import moe as MOE

    e = MoEConfig(num_experts=4, top_k=2, d_expert=8,
                  routing="expert_choice")
    rng = np.random.default_rng(0)
    p = {"gate": torch.zeros(16, 4), "experts": _both(_bank(rng, 4, 16, 8))[1],
         "shared": {}}
    x = torch.zeros(2, 8, 16)
    with pytest.raises(NotImplementedError, match="shared experts"):
        MOE.expert_choice_forward_batched(p, x, e)
    with pytest.raises(NotImplementedError, match="shared experts"):
        MOE.expert_choice_forward(p, x[0], e)


@pytest.mark.parametrize("batched", [False, True])
def test_expert_choice_forward_matches_reference(batched):
    """The MoE layer on the expert-choice path, unbatched and with the whole
    batch in one tile plan, against the JAX pallas backend."""
    import dataclasses

    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.core import moe as JMOE
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import moe as MOE

    kw = dict(num_experts=8, top_k=2, d_expert=16, routing="expert_choice",
              backend="pallas")
    je, te = JMoEConfig(**kw), MoEConfig(**kw)
    rng = np.random.default_rng(5)
    d = 24
    bank = _bank(rng, 8, d, 16)
    gate = rng.standard_normal((d, 8)).astype(np.float32)
    jp = {"gate": jnp.asarray(gate), "experts": _both(bank)[0]}
    tp = {"gate": torch.from_numpy(gate), "experts": _both(bank)[1]}
    x = rng.standard_normal((3, 20, d)).astype(np.float32)
    if batched:
        yj, aj = JMOE.expert_choice_forward_batched(jp, jnp.asarray(x), je)
        yt, at = MOE.expert_choice_forward_batched(tp, torch.from_numpy(x), te)
    else:
        yj, aj = JMOE.expert_choice_forward(jp, jnp.asarray(x[0]), je)
        yt, at = MOE.expert_choice_forward(tp, torch.from_numpy(x[0]), te)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for k in ("counts", "chosen_tokens"):
        np.testing.assert_array_equal(at[k].numpy(), np.asarray(aj[k]))
    for k in ("chosen_scores", "weighted_outputs", "scores"):
        np.testing.assert_allclose(at[k].numpy(), np.asarray(aj[k]), **TOL)
    assert MOE.ec_capacity(20, te) == JMOE.ec_capacity(20, je) == 5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MOE.check_backend(dataclasses.replace(te, backend="xla"))
