"""The smoke zamba2-1.2b (Mamba2 layers with one weight-shared attention +
SwiGLU block after every `attn_every`-th, fp32) through the port's
model_forward, prefill, serve_step and generate(), against the JAX package
on the same weights (JAX's `model_init`, carried across by
`bridge.params_from_numpy`).

The smoke config has 4 layers with attn_every 2: two applications and no
trailing layers. The full config has 38 with attn_every 6: six
applications and 2 trailing layers. A `num_layers=5` override of both
packages covers the trailing layers (one).

Tolerances: hidden states and logits 1e-4 (fp32 on both sides, a few
layers); greedy tokens equal; the stepwise path against the
chunked-parallel forward at the reference's own decode-consistency
tolerance (rtol 1e-2, atol 5e-3, tests/test_decode_consistency.py).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from torch_bridged import bridged, logits_match  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "zamba2-1.2b"
B, S, T, GEN = 2, 12, 8, 4
_FORWARD = jax.jit(JM.model_forward, static_argnames="cfg")


@functools.lru_cache(maxsize=None)
def _pair(num_layers):
    """(JAX config, port config, JAX params, port params) at num_layers."""
    jcfg = jax_config(ARCH, smoke=True).with_overrides(num_layers=num_layers)
    tcfg = get_config(ARCH, smoke=True).with_overrides(num_layers=num_layers)
    p = JM.model_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, p, bridged(p)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, size=(B, S),
                                             dtype=np.int32)


def test_config_is_a_copy_of_the_reference():
    for smoke in (False, True):
        jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.block == "mamba2" and tc.moe is None and tc.d_ff > 0
    full = get_config(ARCH)
    assert TM._zamba_segments(full) == (6, 6)
    assert [TM._shared_attn_after(l, full) for l in range(38)].count(
        None) == 32


def test_model_init_matches_reference_tree():
    """Same nesting (stacked `layers`, ONE `shared_attn` block), shapes and
    dtypes; in bf16 the mixer's A_log, D, dt_bias and norm_scale and the
    norms stay fp32 (tests/test_torch_ssm.py holds the mixer's tree to
    the reference's in bf16)."""
    _, tcfg, p, _ = _pair(5)
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p)
    mine = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                        mine) == ref
    bf = TM.model_init(tcfg.with_overrides(dtype="bfloat16"),
                       torch.Generator().manual_seed(0), "cpu")
    f32 = {k for k, v in bf["layers"]["mix"].items()
           if v.dtype == torch.float32}
    assert f32 == {"A_log", "D", "dt_bias", "norm_scale"}
    assert bf["shared_attn"]["mlp"]["wi"].dtype == torch.bfloat16


@pytest.mark.parametrize("num_layers", [4, 5])
def test_model_forward_matches_reference(tokens, num_layers):
    jcfg, tcfg, p, tp = _pair(num_layers)
    x, aux = _FORWARD(p, jnp.asarray(tokens), jcfg)
    tx, taux = TM.model_forward(tp, torch.from_numpy(tokens).long(), tcfg)
    assert tx.shape == (B, S, tcfg.d_model) and tx.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), **TOL)
    assert float(taux) == float(aux) == 0.0


@pytest.mark.parametrize("num_layers", [4, 5])
def test_prefill_and_serve_step_logits_match_reference(tokens, num_layers):
    """The stepwise prefill, then greedy serve_steps, on both sides."""
    jcfg, tcfg, p, tp = _pair(num_layers)
    logits_match(jcfg, tcfg, p, tp, tokens[:, :T], GEN, 16, TOL)


def test_generate_matches_reference(tokens):
    jcfg, tcfg, p, tp = _pair(4)
    ref = JS.generate(p, jcfg, jnp.asarray(tokens[:, :T]), GEN)
    res = TS.generate(tp, tcfg, torch.from_numpy(tokens[:, :T]).long(), GEN,
                      device="cpu")
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(ref["tokens"]))
    assert res["state"]["t"] == T + GEN
    assert res["state"]["k"].shape[2] == T + GEN + 1


@pytest.mark.parametrize("num_layers", [4, 5])
def test_stepwise_matches_chunked_forward(tokens, num_layers):
    """The mirror of tests/test_decode_consistency.py's RECURRENT case for
    zamba2, port against port: prefill steps serve_step over all but the
    last token; one more step gives the forward's last logits (chunk 4:
    three SSD chunks carry state across)."""
    _, tcfg, _, tp = _pair(num_layers)
    cfg = tcfg.with_overrides(ssm_chunk=4)
    tok = torch.from_numpy(tokens).long()
    x, _ = TM.model_forward(tp, tok, cfg)
    ref = TM.logits_from_hidden(tp, x[:, -1, :], cfg)
    st, _ = TM.prefill(tp, tok[:, :-1], cfg, max_len=16)
    logits, st = TM.serve_step(tp, st, tok[:, -1], cfg)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-2,
                               atol=5e-3)
    assert st["t"] == S


def test_shared_block_takes_no_window(tokens):
    """The reference's shared block passes no window (layer_windows is not
    consulted): a sliding_window on the config changes nothing."""
    _, tcfg, _, tp = _pair(4)
    tok = torch.from_numpy(tokens).long()
    x, _ = TM.model_forward(tp, tok, tcfg)
    xw, _ = TM.model_forward(tp, tok, tcfg.with_overrides(sliding_window=2))
    assert torch.equal(x, xw)
    _, lg = TM.prefill(tp, tok, tcfg.with_overrides(sliding_window=2),
                       max_len=16)
    _, lg0 = TM.prefill(tp, tok, tcfg, max_len=16)
    assert torch.equal(lg, lg0)


def test_decode_state_matches_reference():
    """The bridged JAX decode state (per-slot t) has the port's nesting,
    shapes, dtypes and values: ssm fp32 [L, B, H, P, N], conv in the
    config's dtype, dense KV rows [n_app, B, max_len, Hkv, hd]."""
    for num_layers in (4, 5):
        jcfg, tcfg = _pair(num_layers)[:2]
        ref = JM.init_decode_state(jcfg, 3, 16, per_slot_t=True)
        ref = bridged(ref)
        mine = TM.init_decode_state(tcfg, 3, 16, "cpu", per_slot_t=True)
        flat = lambda tr: jax.tree_util.tree_flatten_with_path(tr)[0]  # noqa
        got, want = flat(mine), flat(ref)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="attention-family only"):
        TM.init_decode_state(tcfg, 1, 16, "cpu", paged=(4, 4))
