"""The port's MoE executors against the JAX package's: `moe_ffn_fused` on
the expert-choice layout and on random routings, and `go_selected_ffn` on
a decode tick within the reference's fast budget and on one that
overflows it (C_fast < C_full); the MoE layer's paths with always-on
shared experts (1e-4). The JAX side runs its Pallas kernels in
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
    """A bank with always-on shared experts is served, never served without
    them: on the expert-choice path, unbatched and batched, the output is
    the same bank's output without the shared bank plus the shared
    experts' SwiGLU FFN, and that addition is not zero."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import moe as MOE

    e = MoEConfig(num_experts=4, top_k=2, d_expert=8,
                  routing="expert_choice", num_shared_experts=2)
    rng = np.random.default_rng(0)
    gate = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    routed = {"gate": gate, "experts": _both(_bank(rng, 4, 16, 8))[1]}
    p = dict(routed, shared=_both(_bank(rng, 2, 16, 8))[1])
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    sh = p["shared"]
    want = sum(
        (torch.nn.functional.silu(x @ sh["wg"][s]) * (x @ sh["wi"][s]))
        @ sh["wo"][s] for s in range(2))
    assert want.abs().max() > 0.1
    got = (MOE.expert_choice_forward_batched(p, x, e)[0]
           - MOE.expert_choice_forward_batched(routed, x, e)[0])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got = (MOE.expert_choice_forward(p, x[0], e)[0]
           - MOE.expert_choice_forward(routed, x[0], e)[0])
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-5)


SHARED_PATHS = ["dispatch", "group", "expert_choice",
                "expert_choice_batched", "token_choice_decode",
                "go_decode_step"]


def _shared_moe(rng, path):
    """A small MoE with two shared experts, in both packages: (JAX config,
    port config, JAX params, port params)."""
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro_torch.configs.base import MoEConfig

    routing = "expert_choice" if path.startswith("expert") else \
        "token_choice"
    kw = dict(num_experts=8, top_k=2, d_expert=16, num_shared_experts=2,
              routing=routing, group_size=2, backend="pallas")
    d = 24
    bank, shared = _bank(rng, 8, d, 16), _bank(rng, 2, d, 16)
    gate = rng.standard_normal((d, 8)).astype(np.float32)
    jp = {"gate": jnp.asarray(gate), "experts": _both(bank)[0],
          "shared": _both(shared)[0]}
    tp = {"gate": torch.from_numpy(gate), "experts": _both(bank)[1],
          "shared": _both(shared)[1]}
    return JMoEConfig(**kw), MoEConfig(**kw), jp, tp


def _go_decode_logits(jax_cfg, port_cfg, steps=3):
    """The smoke llama_moe_4_16 with two shared experts a layer through
    prefill and `steps` GO-cache decode steps in both packages on the same
    weights: the logits of every step, (JAX, port) pairs."""
    import dataclasses

    import jax

    from repro.models import model as JM
    from repro_torch import bridge
    from repro_torch.models import model as TM

    jcfg = jax_cfg("llama_moe_4_16", smoke=True)
    jcfg = jcfg.with_overrides(moe=dataclasses.replace(
        jcfg.moe, backend="pallas", num_shared_experts=2))
    tcfg = port_cfg("llama_moe_4_16", smoke=True)
    tcfg = tcfg.with_overrides(moe=dataclasses.replace(
        tcfg.moe, num_shared_experts=2))
    p = JM.model_init(jax.random.PRNGKey(4), jcfg)
    assert p["layers"]["moe"]["shared"]["wo"].shape[:2] == (2, 2)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(2, 12), dtype=np.int32)
    j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_len"))
    j_step = jax.jit(JM.serve_step, static_argnames="cfg")
    st, lg = j_prefill(p, jnp.asarray(prompts), jcfg, max_len=16)
    tst, tlg = TM.prefill(tp, torch.from_numpy(prompts).long(), tcfg,
                          max_len=16)
    out = [(np.asarray(lg), tlg.numpy())]
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for _ in range(steps):
        lg, st = j_step(p, st, tok, jcfg)
        tlg, tst = TM.serve_step(tp, tst, torch.from_numpy(np.array(tok)),
                                 tcfg)
        out.append((np.asarray(lg), tlg.numpy()))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return out


@pytest.mark.parametrize("path", SHARED_PATHS)
def test_shared_experts_match_reference(path):
    """Every MoE path with two always-on shared experts against the JAX
    package's (`repro.core.moe`, backend "pallas" in interpret mode), fp32,
    to 1e-4: dispatch, the C1 group path (with drops), expert choice
    unbatched and batched, the token-choice decode, and the GO-cache decode
    step (through the models' prefill and serve_step, whose decode blocks
    add the shared output to the GO cache's). Without the shared bank the
    port's output moves by more than 0.1."""
    from repro.configs.registry import get_config as jax_config
    from repro.core import moe as JMOE
    from repro_torch.configs.registry import get_config
    from repro_torch.core import grouping as GR
    from repro_torch.core import moe as MOE

    tol = dict(rtol=1e-4, atol=1e-4)
    if path == "go_decode_step":
        for want, got in _go_decode_logits(jax_config, get_config):
            np.testing.assert_allclose(got, want, **tol)
        return
    rng = np.random.default_rng(SHARED_PATHS.index(path))
    je, te, jp, tp = _shared_moe(rng, path)
    x = rng.standard_normal((3, 10, 24)).astype(np.float32)
    if path != "expert_choice_batched":
        x = x.reshape(30, 24)
    groups = GR.default_groups(te)
    goe = GR.group_of_expert_from_groups(groups)
    ja, ta = (jnp.asarray(goe), jnp.asarray(groups, jnp.int32)), \
        (torch.from_numpy(goe), torch.from_numpy(groups.astype(np.int32)))
    fns = {"expert_choice_batched": "expert_choice_forward_batched",
           "expert_choice": "expert_choice_forward",
           "dispatch": "dispatch_forward",
           "token_choice_decode": "token_choice_decode",
           "group": "group_forward"}

    def run(mod, p, xs, e, grp):
        """(y, aux); aux None for the decode, which returns y alone."""
        args = (grp[0],) if path == "group" else ()
        kw = {"members": grp[1]} if path == "group" else {}
        out = getattr(mod, fns[path])(p, xs, e, *args, **kw)
        return (out, None) if path == "token_choice_decode" else out

    yj, aj = run(JMOE, jp, jnp.asarray(x), je, ja)
    yt, at = run(MOE, tp, torch.from_numpy(x), te, ta)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **tol)
    if path == "group":
        assert int(at["dropped"]) == int(aj["dropped"]) > 0
    routed = {k: v for k, v in tp.items() if k != "shared"}
    y0, _ = run(MOE, routed, torch.from_numpy(x), te, ta)
    assert (yt - y0).abs().max() > 0.1


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
    xla = dataclasses.replace(te, backend="xla")
    assert MOE.resolve_backend(xla) == "xla"
    yx, ax = MOE.expert_choice_forward(tp, torch.from_numpy(x[0]), xla)
    yj, aj = JMOE.expert_choice_forward(
        jp, jnp.asarray(x[0]), dataclasses.replace(je, backend="xla"))
    np.testing.assert_allclose(yx.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(ax["chosen_tokens"].numpy(),
                                  np.asarray(aj["chosen_tokens"]))
