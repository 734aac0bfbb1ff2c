"""The smoke starcoder2-3b (dense SwiGLU MLP, GQA 4/2, a 32-token sliding
window on every layer, fp32) through the port's mlp, prefill, serve_step,
generate() and continuous-batching engine, against the JAX package on the
same weights (`bridge.params_from_numpy`).

The prompts are 40 tokens long, so the window binds: the last positions
attend to 32 keys of 40 (the test shows that the JAX model without the
window gives other logits there). Paged attention runs its plain version
on the CPU (K3/K4's gather realization, the JAX engine's on the CPU too).

Tolerance for the MLP: 1e-5 (one fp32 layer, products summed in another
order); for logits: atol = rtol = 1e-4 (fp32 on both sides, two layers).
Greedy tokens and engine streams must be equal; port against port, the
engine streams what static generate() streams, bit for bit. The dense
prefix extension is tests/test_torch_prefix_share.py's, its crash
recovery tests/test_torch_crash_recovery.py's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.kernels import paged_attn as PA  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "starcoder2-3b"
B, T, GEN = 2, 40, 8
# the staggered paged, chunked trace: the 40-token prompt prefills in
# chunks at 0, 16 and 32 (the window binds in the last), the others
# one-shot or in two chunks
LENS = [40, 9, 21]
ARRIVALS = [0, 1, 3]
POOL = dict(num_slots=2, max_tokens=48, paged=True, page_size=8,
            prefill_chunk=16)


@pytest.fixture(scope="module")
def starcoder2():
    return smoke_pair(ARCH)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, size=n, dtype=np.int32) for n in LENS]


def test_config_is_a_copy_of_the_reference():
    for smoke in (False, True):
        jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.moe is None and jc.block == "attn" and jc.tie_embeddings
        assert (jc.qkv_bias, jc.logit_softcap, jc.local_global_ratio) == \
            (False, 0.0, 0)
    full = get_config(ARCH)
    assert TM.layer_windows(full) == [4096] * 30


def test_mlp_bridges_and_matches_reference(starcoder2):
    """The `mlp` subtree crosses unchanged, model_init builds it with the
    reference's shapes, and layers.mlp is the JAX SwiGLU within 1e-5."""
    jcfg, tcfg, p, tp = starcoder2
    L, d, f = tcfg.num_layers, tcfg.d_model, tcfg.d_ff
    assert "moe" not in tp["layers"] and set(tp["layers"]["mlp"]) == \
        {"wi", "wg", "wo"}
    for k, w in tp["layers"]["mlp"].items():
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(p["layers"]["mlp"][k]))
    own = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = {k: tuple(v.shape) for k, v in own["layers"]["mlp"].items()}
    assert shapes == {"wi": (L, d, f), "wg": (L, d, f), "wo": (L, f, d)}
    assert shapes == {k: tuple(v.shape) for k, v in
                      tp["layers"]["mlp"].items()}
    x = np.random.default_rng(0).standard_normal((3, 5, d)).astype(
        np.float32)
    w = TM.layer_params(tp["layers"], 1)["mlp"]
    ref = JL.mlp(jax.tree.map(lambda a: a[1], p["layers"]["mlp"]),
                 jnp.asarray(x))
    np.testing.assert_allclose(TL.mlp(w, torch.from_numpy(x)).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_prefill_and_decode_logits_match_reference(starcoder2):
    """40-token prompts (window 32 binds): prefill logits and KV, then four
    decode steps, within 1e-4; the reference without the window gives
    other logits, so the window is not a no-op."""
    jcfg, tcfg, p, tp = starcoder2
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, T), dtype=np.int32)
    j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_len"))
    j_step = jax.jit(JM.serve_step, static_argnames="cfg")
    st, lg = j_prefill(p, jnp.asarray(tokens), jcfg, max_len=T + 8)
    tst, tlg = TM.prefill(tp, torch.from_numpy(tokens).long(), tcfg,
                          max_len=T + 8)
    assert "go" not in tst
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    np.testing.assert_allclose(tst["k"].numpy(), np.asarray(st["k"]), **TOL)
    _, lg0 = j_prefill(p, jnp.asarray(tokens),
                       jcfg.with_overrides(sliding_window=0), max_len=T + 8)
    assert np.abs(np.asarray(lg0) - np.asarray(lg)).max() > 1e-2
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for _ in range(4):
        lg, st = j_step(p, st, tok, jcfg)
        tlg, tst = TM.serve_step(tp, tst, torch.from_numpy(np.array(tok)),
                                 tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)


def test_generate_greedy_tokens_equal_reference(starcoder2):
    jcfg, tcfg, p, tp = starcoder2
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(B, T), dtype=np.int32)
    rj = JS.generate(p, jcfg, jnp.asarray(tokens), GEN)
    before = (dict(G.LAUNCHES), dict(PA.LAUNCHES))
    rt = TS.generate(tp, tcfg, torch.from_numpy(tokens), GEN, device="cpu")
    assert (G.LAUNCHES, PA.LAUNCHES) == before   # CPU: plain versions only
    np.testing.assert_array_equal(rt["tokens"].numpy(),
                                  np.asarray(rj["tokens"]))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_streams_equal_jax_engine(starcoder2, prompts, kv_quant,
                                         monkeypatch):
    """The staggered trace on a paged pool with chunked prefill, fp32 and
    int8 pages: streams and the tick counts equal the JAX engine's."""
    monkeypatch.delenv("REPRO_PREFIX_SHARE", raising=False)
    jcfg, tcfg, p, tp = starcoder2
    pool = dict(POOL, kv_quant=kv_quant)
    ref = JS.serve_continuous(p, jcfg, prompts, 7, arrival_steps=ARRIVALS,
                              **pool)
    got = TS.serve_continuous(tp, tcfg, prompts, 7, arrival_steps=ARRIVALS,
                              device="cpu", **pool)
    for rid, toks in ref["tokens"].items():
        np.testing.assert_array_equal(got["tokens"][rid], toks,
                                      err_msg=f"request {rid}")
    s, rs = got["stats"], ref["stats"]
    assert (s["steps"], s["chunk_ticks"], s["peak_active"]) == \
        (rs["steps"], rs["chunk_ticks"], rs["peak_active"])
    assert s["chunk_ticks"] == 3 + 2 and s["pages_in_use"] == 0
    state = got["engine"].pool.state
    assert "go" not in state and "go_scales" not in state
    assert state["k_pages"].dtype == (torch.int8 if kv_quant == "int8"
                                      else torch.float32)


def test_engine_bit_identical_to_static_generate(starcoder2, prompts):
    """Port against port: without chunking each request streams what it
    streams alone through generate() at the pool's cache capacity, the
    40-token one past its window."""
    _, tcfg, _, tp = starcoder2
    gens = [7, 5, 6]
    eng = ServingEngine(tp, tcfg, device="cpu", num_slots=2, max_tokens=48,
                        paged=True, page_size=8)
    rids = [eng.submit(pr, g, arrival_step=a)
            for pr, g, a in zip(prompts, gens, ARRIVALS)]
    fin = eng.run()
    for pr, g, rid in zip(prompts, gens, rids):
        ref = TS.generate(tp, tcfg, torch.from_numpy(pr)[None], g,
                          device="cpu", max_len=48)
        assert fin[rid].tokens == ref["tokens"][0].tolist()


def test_cli_smoke_on_cpu(capsys):
    res = TS.main(["--arch", ARCH, "--smoke", "--static", "--device", "cpu",
                   "--batch", "2", "--prompt", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    res = TS.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--requests", "3", "--slots", "2", "--prompt", "20",
                   "--gen", "3", "--paged", "--page-size", "8",
                   "--chunk-prefill", "8", "--prefix-share"])
    assert res["stats"]["finished"] == 3
    assert "starcoder2-smoke on cpu" in capsys.readouterr().out
    with pytest.raises(ValueError, match="MoE"):
        TS.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--paged",
                 "--expert-aware"])
