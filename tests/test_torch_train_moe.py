"""The MoE layer's "xla" realization, port against port and against the
JAX package.

Contract (port against port): "xla" and the grouped-GEMM decomposition's
plain versions drop the same (token, expert) pairs and give the same
outputs within 1e-5 (fp32, sums in another order), on the dispatch path
(the grouped GEMM given the capacity: its plan's rank in the expert-stable
run decides, as `_expert_positions` does), the C1 group path (the pooled
lanes' overflow) and expert choice (no drops; the same chosen tokens); the
token-choice decode is dropless on both. Against the reference: the
oracle `dense_forward` within 1e-5, and static `generate()` on
backend="xla" for the llama smoke model (the GO decode's dense
fallback) gives the JAX package's greedy tokens.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import moe as JMOE  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import moe as MOE  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-5, atol=1e-5)
T, D, DE, E = 40, 24, 16, 10


def _layer(seed, shared=0):
    rng = np.random.default_rng(seed)
    w = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32))
    p = {"gate": w(D, E),
         "experts": {"wg": w(E, D, DE), "wi": w(E, D, DE), "wo": w(E, DE, D)}}
    if shared:
        p["shared"] = {"wg": w(shared, D, DE), "wi": w(shared, D, DE),
                       "wo": w(shared, DE, D)}
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    return p, x


def _cfg(backend, **kw):
    base = dict(num_experts=E, top_k=2, d_expert=DE, group_size=2,
                capacity_factor=1.0, backend=backend)
    return MoEConfig(**{**base, **kw})


@pytest.mark.parametrize("shared", [0, 2])
def test_dispatch_xla_drops_what_the_grouped_gemm_drops(shared):
    p, x = _layer(0, shared)
    e = _cfg("xla")
    C = max(1, int(math.ceil(T * e.top_k / E * e.capacity_factor)))
    y, aux = MOE.dispatch_forward(p, x, e)
    assert int(aux["dropped"]) > 0
    r, ef, wf, tok = MOE._token_pairs(x, p, e)
    yg, _, plan = OPS.moe_ffn_fused(x, tok, ef, wf, p["experts"], E, T,
                                    max_per_token=e.top_k, token_major=True,
                                    bn=8, capacity=C)
    assert torch.equal(aux["kept"], plan.pos < C)
    torch.testing.assert_close(y, MOE.add_shared(p, yg, x), **TOL)


def test_group_xla_drops_what_the_grouped_gemm_drops():
    p, x = _layer(1)
    goe = torch.from_numpy(np.repeat(np.arange(E // 2), 2).astype(np.int32))
    goe = goe[torch.from_numpy(np.random.default_rng(1).permutation(E))]
    yx, ax = MOE.group_forward(p, x, _cfg("xla"), goe)
    yp, ap = MOE.group_forward(p, x, _cfg("pallas"), goe)
    assert int(ax["dropped"]) == int(ap["dropped"]) > 0
    assert torch.equal(ax["kept"], ap["kept"])
    torch.testing.assert_close(yx, yp, **TOL)


def test_expert_choice_xla_equals_the_grouped_gemm():
    p, x = _layer(2, shared=1)
    e = dict(routing="expert_choice", top_k=3)
    yx, ax = MOE.expert_choice_forward(p, x, _cfg("xla", **e), valid_len=33)
    yp, ap = MOE.expert_choice_forward(p, x, _cfg("pallas", **e),
                                       valid_len=33)
    for k in ("chosen_tokens", "counts"):
        assert torch.equal(ax[k], ap[k])
    assert int(ax["chosen_tokens"].max()) < 33          # pads never chosen
    torch.testing.assert_close(yx, yp, **TOL)
    torch.testing.assert_close(ax["weighted_outputs"], ap["weighted_outputs"],
                               **TOL)


def test_token_choice_decode_is_dropless_on_both():
    p, x = _layer(3, shared=1)
    y = MOE.token_choice_decode(p, x[:6], _cfg("xla"))
    torch.testing.assert_close(
        y, MOE.token_choice_decode(p, x[:6], _cfg("pallas")), **TOL)


@pytest.mark.parametrize("routing", ["token_choice", "expert_choice"])
def test_dense_forward_matches_reference_oracle(routing):
    p, x = _layer(4, shared=1)
    kw = dict(num_experts=E, top_k=2, d_expert=DE, routing=routing)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    yj = JMOE.dense_forward(jp, jnp.asarray(x.numpy()), JMoEConfig(**kw))
    yt = MOE.dense_forward(p, x, MoEConfig(**kw))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(
        MOE.expert_ffn_all(p, x[:3]).numpy(),
        np.asarray(JMOE.expert_ffn_all(jp, jnp.asarray(x[:3].numpy()))),
        **TOL)


def test_resolve_backend_rules():
    assert MOE.resolve_backend(_cfg("auto")) == "pallas"
    assert MOE.resolve_backend(_cfg("xla")) == "xla"
    with pytest.raises(ValueError, match="unknown MoE backend"):
        MOE.resolve_backend(_cfg("triton"))
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward pass"):
        MOE.resolve_backend(_cfg("pallas"), ({"a": [w]},))
    with torch.no_grad():
        assert MOE.resolve_backend(_cfg("pallas"), ({"a": [w]},)) == "pallas"
    assert MOE.resolve_backend(_cfg("xla"), (w,)) == "xla"


def test_generate_on_xla_gives_reference_greedy_tokens():
    """llama smoke on backend="xla" in both packages: prefill through the
    xla expert choice, decode through the GO cache's dense fallback
    (`expert_fn`: every expert over every row, masked)."""
    jcfg = jax_config("llama_moe_4_16", smoke=True)
    jcfg = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe,
                                                       backend="xla"))
    tcfg = get_config("llama_moe_4_16", smoke=True)
    tcfg = tcfg.with_overrides(moe=dataclasses.replace(tcfg.moe,
                                                       backend="xla"))
    tp = TM.model_init(tcfg, torch.Generator().manual_seed(2), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    prompts = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, size=(2, 12)).astype(np.int32)
    rj = JS.generate(jp, jcfg, jnp.asarray(prompts), 6)
    rt = TS.generate(tp, tcfg, torch.from_numpy(prompts), 6, device="cpu")
    np.testing.assert_array_equal(rt["tokens"].numpy(),
                                  np.asarray(rj["tokens"]))
