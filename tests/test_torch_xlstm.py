"""The xlstm slice: the port's mLSTM/sLSTM modules, `model_forward` and
static `generate()` on the smoke xlstm-1.3b against the JAX package on the
same weights (JAX's `model_init`, carried across by
`bridge.params_from_numpy`) and the same numpy-seeded inputs, all fp32.

Tolerances: modules 1e-5 (fp32 on both sides, sums in another order);
`model_forward` hidden states and generate()'s logits 1e-4 (the same, over
4 layers); greedy tokens equal; prefill + serve_step against model_forward
at the reference's own decode-consistency tolerance (rtol 1e-2, atol 5e-3,
tests/test_decode_consistency.py:44).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import slstm_cell as SC  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

torch.set_float32_matmul_precision("highest")
ARCH = "xlstm-1.3b"
MOD = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, T, GEN = 2, 12, 8, 4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def xl():
    jcfg = jax_config(ARCH, smoke=True)
    tcfg = get_config(ARCH, smoke=True)
    p = JM.model_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, S), dtype=np.int32)
    return jcfg, tcfg, p, tp, tokens


@pytest.fixture(scope="module")
def jax_forward(xl):
    jcfg, _, p, _, tokens = xl
    x, aux = JM.model_forward(p, jnp.asarray(tokens), jcfg)
    return np.asarray(x), float(aux)


@pytest.fixture(scope="module")
def jax_generate(xl):
    """JAX's generate() tokens, and the logits that chose them (the same
    jitted prefill and serve_step replayed, a cache hit)."""
    jcfg, _, p, _, tokens = xl
    prompts = jnp.asarray(tokens[:, :T])
    res = JS.generate(p, jcfg, prompts, GEN)
    st, lg = jax.jit(JM.prefill, static_argnames=("cfg", "max_len"))(
        p, prompts, jcfg, {}, max_len=T + GEN + 1)
    step = jax.jit(JM.serve_step, static_argnames="cfg")
    chose = []
    for i in range(GEN):
        chose.append(np.asarray(lg))
        lg, st = step(p, st, res["tokens"][:, i], jcfg)
    return np.asarray(res["tokens"]), np.stack(chose)


def _layers(xl):
    """Segment 0's first mLSTM and its sLSTM, on both sides."""
    _, _, p, tp, _ = xl
    jm = jax.tree.map(lambda a: a[0, 0], p["mlayers"])
    js = jax.tree.map(lambda a: a[0], p["slayers"])
    tm = TM.layer_params(TM.layer_params(tp["mlayers"], 0), 0)
    ts = TM.layer_params(tp["slayers"], 0)
    return jm, js, tm, ts


def _close(got, ref, tol=MOD):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


# ------------------------------------------------------------ mLSTM core

@pytest.mark.parametrize("S_,chunk", [(12, 4), (10, 4), (7, 128)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_reference(S_, chunk, with_state):
    """S = 10 with chunk 4: the reference shrinks the chunk to 2 (5
    chunks); S = 7 with chunk 128: one chunk of 7."""
    rng = np.random.default_rng(S_ + chunk)
    Bq, H, D = 2, 2, 16
    q, k, v = (rng.standard_normal((Bq, S_, H, D)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((Bq, S_, H)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((Bq, S_, H)).astype(np.float32) + 2))
    state = None
    if with_state:
        state = (rng.standard_normal((Bq, H, D, D)).astype(np.float32),
                 rng.standard_normal((Bq, H, D)).astype(np.float32),
                 rng.standard_normal((Bq, H)).astype(np.float32))
    h, (C, n, M) = JX.mlstm_chunked(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)), chunk=chunk,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    th, (tC, tn, tM) = TX.mlstm_chunked(
        *(_t(a) for a in (q, k, v, li, lf)), chunk=chunk,
        state=None if state is None else tuple(map(_t, state)))
    for got, ref in ((th, h), (tC, C), (tn, n), (tM, M)):
        _close(got, ref)


def test_mlstm_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    Bq, H, D = 2, 2, 16
    state = (rng.standard_normal((Bq, H, D, D)).astype(np.float32),
             rng.standard_normal((Bq, H, D)).astype(np.float32),
             rng.standard_normal((Bq, H)).astype(np.float32))
    q, k, v = (rng.standard_normal((Bq, H, D)).astype(np.float32)
               for _ in range(3))
    li, lf = (rng.standard_normal((Bq, H)).astype(np.float32) - 1
              for _ in range(2))
    (C, n, M), h = JX.mlstm_decode_step(tuple(map(jnp.asarray, state)),
                                        *map(jnp.asarray, (q, k, v, li, lf)))
    (tC, tn, tM), th = TX.mlstm_decode_step(tuple(map(_t, state)),
                                            *map(_t, (q, k, v, li, lf)))
    for got, ref in ((th, h), (tC, C), (tn, n), (tM, M)):
        _close(got, ref)


# --------------------------------------------------------------- blocks

def _decode_states(xl, rng):
    """A random (not zero) decode state of one mLSTM and one sLSTM block,
    so that every term of the step is exercised."""
    jcfg = xl[0]
    d, H = jcfg.d_model, jcfg.num_heads
    di, hs = 2 * d, d // H
    m = {"mlstm": (rng.standard_normal((B, H, di // H, di // H)),
                   rng.standard_normal((B, H, di // H)),
                   rng.standard_normal((B, H))),
         "conv": rng.standard_normal((B, jcfg.conv_width - 1, di))}
    s = {"c": rng.standard_normal((B, H, hs)),
         "n": np.abs(rng.standard_normal((B, H, hs))) + 0.5,
         "m": rng.standard_normal((B, H, hs)),
         "h": rng.standard_normal((B, H, hs)) * 0.5}
    return jax.tree.map(lambda a: a.astype(np.float32), (m, s))


@pytest.mark.parametrize("decode", [False, True])
def test_mlstm_block_matches_reference(xl, decode):
    jcfg, tcfg = xl[0], xl[1]
    jm, _, tm, _ = _layers(xl)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 1 if decode else S, jcfg.d_model)).astype(
        np.float32)
    if not decode:
        _close(TX.mlstm_block(tm, _t(x), cfg=tcfg),
               JX.mlstm_block(jm, jnp.asarray(x), cfg=jcfg))
        return
    st = _decode_states(xl, rng)[0]
    y, new = JX.mlstm_block(jm, jnp.asarray(x), cfg=jcfg,
                            decode_state=jax.tree.map(jnp.asarray, st))
    ty, tnew = TX.mlstm_block(tm, _t(x), cfg=tcfg, decode_state={
        "mlstm": tuple(map(_t, st["mlstm"])), "conv": _t(st["conv"])})
    _close(ty, y)
    for got, ref in zip((*tnew["mlstm"], tnew["conv"]),
                        (*new["mlstm"], new["conv"])):
        _close(got, ref)


@pytest.mark.parametrize("decode", [False, True])
def test_slstm_block_matches_reference(xl, decode):
    jcfg, tcfg = xl[0], xl[1]
    _, js, _, ts = _layers(xl)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1 if decode else S, jcfg.d_model)).astype(
        np.float32)
    if not decode:
        _close(TX.slstm_block(ts, _t(x), cfg=tcfg),
               JX.slstm_block(js, jnp.asarray(x), cfg=jcfg))
        return
    st = _decode_states(xl, rng)[1]
    y, new = JX.slstm_block(js, jnp.asarray(x), cfg=jcfg,
                            decode_state=jax.tree.map(jnp.asarray, st))
    ty, tnew = TX.slstm_block(ts, _t(x), cfg=tcfg,
                              decode_state={k: _t(v) for k, v in st.items()})
    _close(ty, y)
    for k in ("c", "n", "m", "h"):
        _close(tnew[k], new[k])


def test_slstm_block_hands_k9_fp32_in_bf16(xl, monkeypatch):
    """The dtype trap: K9 writes h in u's dtype, while the reference's scan
    keeps h fp32 up to the group norm. In a bf16 model the block must pass
    u upcast to fp32 and get fp32 h back, exactly the plain fp32 recurrence
    of the bf16 pre-activations."""
    tcfg = xl[1].with_overrides(dtype="bfloat16")
    ts = {k: v.to(torch.bfloat16) if k not in ("gn", "norm", "ff_norm")
          else v for k, v in _layers(xl)[3].items()}
    seen = []
    real = SC.slstm_seq

    def spy(u, r):
        out = real(u, r)
        seen.append((u.dtype, r.dtype, out.dtype))
        return out

    monkeypatch.setattr(SC, "slstm_seq", spy)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    y = TX.slstm_block(ts, x, cfg=tcfg)
    assert seen == [(torch.float32, torch.bfloat16, torch.float32)]
    assert y.dtype == torch.bfloat16


# ----------------------------------------------------------- whole model

def test_model_init_matches_reference_tree(xl):
    """Same nesting ([n_seg, n_m, ...] and [n_seg, ...]), shapes and
    dtypes; the distributions' scales agree."""
    _, tcfg, p, _, _ = xl
    mine = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p)
    got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), mine)
    assert got == ref
    r = mine["slayers"]["r"].numpy()
    assert abs(r.std() * np.sqrt(r.shape[-1]) - 1) < 0.05
    assert abs(mine["mlayers"]["conv_w"].numpy().std() / 0.1 - 1) < 0.05


def test_model_forward_matches_reference(xl, jax_forward):
    _, tcfg, _, tp, tokens = xl
    x, aux = TM.model_forward(tp, torch.from_numpy(tokens).long(), tcfg)
    assert x.shape == (B, S, tcfg.d_model) and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), jax_forward[0], **TOL)
    assert float(aux) == jax_forward[1] == 0.0


def test_generate_matches_reference(xl, jax_generate):
    _, tcfg, _, tp, tokens = xl
    res = TS.generate(tp, tcfg, torch.from_numpy(tokens[:, :T]).long(), GEN,
                      device="cpu")
    np.testing.assert_array_equal(res["tokens"].numpy(), jax_generate[0])
    np.testing.assert_allclose(res["logits"].numpy(), jax_generate[1], **TOL)


def test_prefill_decode_matches_forward(xl):
    """The mirror of tests/test_decode_consistency.py:44 for xlstm, port
    against port: the chunked/one-launch forward's last logits equal the
    step-by-step prefill plus one serve_step."""
    _, tcfg, _, tp, tokens = xl
    tok = torch.from_numpy(tokens).long()
    x, _ = TM.model_forward(tp, tok, tcfg)
    ref = TM.logits_from_hidden(tp, x[:, -1, :], tcfg)
    st, _ = TM.prefill(tp, tok[:, :-1], tcfg, max_len=16)
    logits, st = TM.serve_step(tp, st, tok[:, -1], tcfg)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-2,
                               atol=5e-3)
    assert st["t"] == S


def test_decode_state_nesting_matches_reference(xl):
    """The bridged JAX decode state has the port's nesting, shapes, dtypes
    and values (m starts at 0.0, M at -1e30)."""
    jcfg, tcfg, _, _, _ = xl
    ref = JM.init_decode_state(jcfg, B, 16)
    ref = {k: v for k, v in ref.items() if k != "t"}
    ref["mlstm"]["mlstm"] = {str(i): a
                             for i, a in enumerate(ref["mlstm"]["mlstm"])}
    ref = bridge.params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    mine = TM.init_decode_state(tcfg, B, 16, "cpu")
    assert mine.pop("t") == 0
    mine["mlstm"]["mlstm"] = {str(i): a
                              for i, a in enumerate(mine["mlstm"]["mlstm"])}
    flat = lambda tr: jax.tree_util.tree_flatten_with_path(tr)[0]  # noqa
    got, want = flat(mine), flat(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- gates

def test_model_forward_raises_for_the_attention_family():
    cfg = get_config("llama_moe_4_16", smoke=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        TM.model_forward({}, torch.zeros((1, 4), dtype=torch.long), cfg)


def test_engine_raises_for_a_recurrent_family(xl):
    _, tcfg, _, tp, _ = xl
    with pytest.raises(NotImplementedError, match="item 9"):
        ServingEngine(tp, tcfg, num_slots=2, max_tokens=16, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        TS.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "2", "--prompt", "4", "--gen", "2"])
    with pytest.raises(ValueError, match="attention-family only"):
        TM.init_decode_state(tcfg, 1, 16, "cpu", paged=(4, 4))


def test_static_cli_runs_xlstm_on_cpu(capsys):
    res = TS.main(["--arch", ARCH, "--smoke", "--static", "--device", "cpu",
                   "--batch", "2", "--prompt", "6", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert "xlstm-smoke on cpu" in capsys.readouterr().out
