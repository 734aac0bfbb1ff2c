"""Training's loss and gradients: the port's `loss_fn` against
`jax.value_and_grad(loss_fn)` of the JAX package on the same weights and
batch, on the fp32 smoke configs: llama (expert choice on "xla"), granite
(C1 group path on "xla", pooled-capacity drops), deepseek (dispatch with
shared experts) and gemma3 (local and global windows) with
logit_softcap=0.5 on both sides. Also `sdpa_flash`'s gradients against the
reference's custom VJP, the first MoE layer's routing, drops and aux
against the reference's "xla" `_ffn_apply`, and the backend rules
("auto" trains on "xla"; an explicit "pallas" raises under autograd).

Tolerances: the loss within 1e-5 relative; every gradient leaf within
rtol 1e-4 and atol 1e-4 times the leaf's largest JAX entry (fp32 on both
sides, sums in another order, through two layers and the backward);
attention gradients within 1e-5. Routing, drop counts and token counts
are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import moe as MOE  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

torch.set_float32_matmul_precision("highest")
B, S = 2, 24
ARCHS = ["llama_moe_4_16", "granite-moe-3b-a800m", "deepseek-moe-16b",
         "gemma3-27b"]


def _configs(arch):
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    if arch == "gemma3-27b":
        jcfg = jcfg.with_overrides(logit_softcap=0.5)
        tcfg = tcfg.with_overrides(logit_softcap=0.5)
    if jcfg.moe is not None:
        # the reference memoizes its group map per MoE config; filled here,
        # outside any jit, for the config loss_fn trains on too, or a
        # traced copy would leak into a later test
        for b in ("auto", "xla"):
            c = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe,
                                                            backend=b))
            JM.expert_groups(c), JM.expert_group_members(c)
    return jcfg, tcfg


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, size=(B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1                                 # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _grad_params(tp):
    def req(t):
        if isinstance(t, dict):
            return {k: req(v) for k, v in t.items()}
        return t.clone().requires_grad_(True)
    return req(tp)


def to_jax(tree):
    """The port's params -> the JAX package's (the same nesting)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Weights from the port's seeded init, carried into the JAX package
    (the JAX init costs seconds a model on the CPU)."""
    jcfg, tcfg = _configs(request.param)
    tp = TM.model_init(tcfg, torch.Generator().manual_seed(1), "cpu")
    return request.param, jcfg, tcfg, to_jax(tp), tp


def test_loss_and_every_grad_match_reference(pair):
    arch, jcfg, tcfg, p, tp = pair
    batch = _batch(jcfg.vocab_size)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                           static_argnums=2)(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    gp = _grad_params(tp)
    tl, tm = TM.loss_fn(gp, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, tcfg)
    leaves = tree_leaves(gp)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["balance"].detach()), float(jm["balance"]),
                               rtol=1e-5, atol=1e-6)
    assert (float(tm["balance"].detach()) > 0) == (tcfg.moe is not None and
                                          tcfg.moe.routing == "token_choice")

    def check(j, t, path):
        if isinstance(j, dict):
            for k in j:
                check(j[k], t[k], f"{path}/{k}")
            return
        ref = np.asarray(j)
        np.testing.assert_allclose(
            grads[id(t)].numpy(), ref, rtol=1e-4,
            atol=1e-4 * float(np.abs(ref).max()), err_msg=f"{arch} {path}")
    check(jg, gp, "")


def test_first_moe_layer_routing_drops_and_aux_match_reference(pair):
    """The reference's "xla" `_ffn_apply` (vmapped per sequence) against
    the port's (a loop over the rows): counts, drops and chosen tokens
    exact, balance loss and output within 1e-5."""
    arch, jcfg, tcfg, p, tp = pair
    if tcfg.moe is None:
        pytest.skip(f"{arch} has a dense MLP")
    jx = dataclasses.replace(jcfg.moe, backend="xla")
    jcfg = jcfg.with_overrides(moe=jx)
    tcfg = TM._training_cfg(tcfg)
    lp = jax.tree.map(lambda a: a[0], p["layers"])
    x = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    groups = dict(group_of_expert=None) if jx.routing == "expert_choice" \
        else dict(group_of_expert=JM.expert_groups(jcfg),
                  group_members=JM.expert_group_members(jcfg))
    yj, aj = jax.jit(JB._ffn_apply, static_argnums=2)(
        lp, jnp.asarray(x), jcfg, **groups)
    yt, at = TB._ffn_apply(TM.layer_params(tp["layers"], 0),
                           torch.from_numpy(x), tcfg,
                           **TM._groups(tcfg, "cpu"))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    exact = ("chosen_tokens", "counts") if jx.routing == "expert_choice" \
        else ("counts", "dropped")
    for k in exact:
        np.testing.assert_array_equal(at[k].numpy(), np.asarray(aj[k]))
    if jx.routing == "token_choice":
        np.testing.assert_allclose(float(at["balance_loss"]),
                                   float(aj["balance_loss"]), rtol=1e-5)
        if arch == "granite-moe-3b-a800m":
            assert int(at["dropped"]) > 0        # the pooled lanes overflow


@pytest.mark.parametrize("window,softcap,ck", [(0, 0.0, 1024), (5, 2.0, 8)])
def test_sdpa_flash_grads_match_reference_custom_vjp(window, softcap, ck):
    """GQA 4/2 over 24 keys: one chunk, and three chunks of 8 with a window
    and a softcap. Forward bits equal sdpa_chunked's (the served path)."""
    rng = np.random.default_rng(4)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, 24, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16), (2, 24, 4, 16)))
    pos = np.arange(24, dtype=np.int32)
    jf = lambda q, k, v: JA.sdpa_flash(  # noqa: E731
        q, k, v, jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(window),
        jnp.asarray(24 + 10**9), True, softcap, ck)
    jo, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    to = TA.sdpa_flash(tq, tk, tv, tpos, tpos, window, 24 + 10**9,
                       softcap=softcap, ck=ck)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    with torch.no_grad():
        served = TA.sdpa_chunked(tq, tk, tv, tpos, tpos, window, 24 + 10**9,
                                 softcap=softcap, ck=ck)
    assert torch.equal(served, to.detach())


def test_auto_trains_on_xla_and_explicit_pallas_raises(pair):
    arch, _, tcfg, _, tp = pair
    if tcfg.moe is None:
        pytest.skip(f"{arch} has a dense MLP")
    batch = {k: torch.from_numpy(v) for k, v in _batch(
        tcfg.vocab_size, seed=5).items()}
    gp = _grad_params(tp)
    with_backend = lambda b: tcfg.with_overrides(  # noqa: E731
        moe=dataclasses.replace(tcfg.moe, backend=b))
    auto, _ = TM.loss_fn(gp, batch, tcfg)
    xla, _ = TM.loss_fn(gp, batch, with_backend("xla"))
    assert torch.equal(auto, xla)
    assert TM._training_cfg(tcfg).moe.backend == "xla"
    with pytest.raises(NotImplementedError, match="no backward pass"):
        TM.loss_fn(gp, batch, with_backend("pallas"))
    # the layer guard: explicit "pallas" with an input that requires grad
    pal = with_backend("pallas").moe
    lp = TM.layer_params(gp["layers"], 0)["moe"]
    h = torch.zeros((S, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="no backward pass"):
        MOE.moe_forward(lp, h, pal, TM.expert_groups(tcfg, "cpu"),
                        TM.expert_group_members(tcfg, "cpu"))
    with torch.no_grad():          # no gradient asked for: it runs
        MOE.moe_forward(lp, h, pal, TM.expert_groups(tcfg, "cpu"),
                        TM.expert_group_members(tcfg, "cpu"))
