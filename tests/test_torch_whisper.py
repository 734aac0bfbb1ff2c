"""The smoke whisper-base (encoder-decoder: a bidirectional encoder without
RoPE, learned decoder positions, decoder self-attention without an MLP,
cross-attention blocks with the gelu MLP; fp32) through the port's
gelu_mlp, attention, model_forward, prefill, serve_step, generate() and
continuous-batching engine, against the JAX package on the same weights
(JAX's `model_init`, carried across by `bridge.params_from_numpy`).

Every request and every static row gets its own random memory (std 1, a
seeded generator): zero memory zeroes the cross layers' K and V, so a
broken cross path would go unseen. The serve path reads the memory as
already encoded, as the reference's does; the decode-consistency mirror
builds it from the encoder's own output.

Tolerances: gelu_mlp 1e-6 (one fp32 product pair; the erf gelu would
miss it), attention 1e-5, hidden states and logits 1e-4 (fp32 on both
sides, a few layers); greedy tokens and engine streams equal; the
stepwise decode against the teacher-forced forward at the reference's own
tolerance (rtol 1e-2, atol 5e-3, tests/test_decode_consistency.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from torch_bridged import (cross_streams, logits_match, memories,  # noqa: E402
                           smoke_pair)

torch.set_float32_matmul_precision("highest")
ARCH = "whisper-base"
TOL = dict(rtol=1e-4, atol=1e-4)
B, T, GEN = 2, 6, 4
# four staggered requests on two dense slots (the last two take the rows
# the first two retire from); one prompt length, one JAX prefill compile
LENS = (5, 5, 5, 5)
ARRIVALS = (0, 1, 2, 3)
POOL = dict(num_slots=2, max_tokens=16)


@pytest.fixture(scope="module")
def whisper():
    return smoke_pair(ARCH)


@pytest.fixture(scope="module")
def trace(whisper):
    """(prompts, memories, the JAX engine's streams) of the staggered
    trace, a memory a request."""
    jcfg, tcfg, p, _ = whisper
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n, dtype=np.int32)
               for n in LENS]
    mems = memories(tcfg, len(LENS), 4)
    ref = cross_streams(JaxEngine(p, jcfg, **POOL), prompts, mems, ARRIVALS,
                        GEN, jnp.asarray)
    return prompts, mems, ref


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_is_a_copy_of_the_reference():
    for smoke in (False, True):
        jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.encoder_layers > 0 and tc.num_audio_frames > 0
        assert not TM.paged_supported(tc)


def test_model_init_matches_reference_tree(whisper):
    """Same nesting (pos_embed, encoder, dec_self without an MLP, dec_cross
    with the gelu MLP and no QKV bias, enc_norm), shapes and dtypes."""
    _, tcfg, p, _ = whisper
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p)
    mine = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                        mine) == ref
    assert set(mine["dec_self"]) == {"ln1", "attn"}
    assert set(mine["dec_cross"]["mlp"]) == {"wi", "wo"}
    std = float(mine["pos_embed"].std())
    assert 0.018 < std < 0.022


def test_gelu_mlp_matches_reference(whisper):
    """The tanh-approximated gelu, as jax.nn.gelu computes by default,
    within 1e-6; the exact erf form lies outside that."""
    _, _, p, tp = whisper
    w, tw = p["dec_cross"]["mlp"], TM.layer_params(tp["dec_cross"], 0)["mlp"]
    w0 = jax.tree.map(lambda a: a[0], w)
    x = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(
        np.float32)
    ref = np.asarray(JL.gelu_mlp(w0, jnp.asarray(x)))
    got = TL.gelu_mlp(tw, _t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    erf = (torch.nn.functional.gelu(_t(x) @ tw["wi"]) @ tw["wo"]).numpy()
    assert np.abs(erf - ref).max() > 1e-6


@pytest.mark.parametrize("layer,kw", [
    ("encoder", dict(causal=False, use_rope=False)),
    ("dec_self", dict(causal=True, use_rope=False)),
    ("dec_cross", dict(causal=False, use_rope=False, cross=True)),
])
def test_attn_forward_matches_reference(whisper, layer, kw):
    """The encoder's bidirectional attention, the decoder's causal one
    without RoPE and the cross attention over a memory of other length,
    within 1e-5."""
    jcfg, tcfg, p, tp = whisper
    kw = dict(kw)
    cross = kw.pop("cross", False)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 16, 64)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    jp = jax.tree.map(lambda a: a[0], p[layer]["attn"])
    ref = JA.attn_forward(jp, jnp.asarray(x), cfg=jcfg,
                          positions=jnp.asarray(pos),
                          kv_source=jnp.asarray(mem) if cross else None,
                          **kw)
    got = TA.attn_forward(TM.layer_params(tp[layer], 0)["attn"], _t(x),
                          cfg=tcfg, positions=_t(pos),
                          kv_source=_t(mem) if cross else None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_cross_attn_decode_matches_reference(whisper):
    jcfg, tcfg, p, tp = whisper
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    mem = rng.standard_normal((3, 16, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], p["dec_cross"]["attn"])
    ref = JA.cross_attn_decode(jp, jnp.asarray(x), jnp.asarray(mem),
                               cfg=jcfg)
    got = TA.cross_attn_decode(TM.layer_params(tp["dec_cross"], 1)["attn"],
                               _t(x), _t(mem), cfg=tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_model_forward_matches_reference(whisper):
    jcfg, tcfg, p, tp = whisper
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, size=(B, 9), dtype=np.int32)
    frames = rng.standard_normal((B, 16, 64)).astype(np.float32)
    x, aux = jax.jit(JM.model_forward, static_argnames="cfg")(
        p, jnp.asarray(tokens), jcfg, {"audio_frames": jnp.asarray(frames)})
    tx, taux = TM.model_forward(tp, _t(tokens).long(), tcfg,
                                {"audio_frames": _t(frames)})
    assert tx.shape == (B, 9, 64)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), **TOL)
    assert float(taux) == float(aux) == 0.0


def test_prefill_and_serve_step_logits_match_reference(whisper):
    """The stepwise prefill over a memory a row, then 4 greedy serve_steps
    (each adding its learned position), on both sides."""
    jcfg, tcfg, p, tp = whisper
    tokens = np.random.default_rng(6).integers(0, 256, size=(B, T),
                                               dtype=np.int32)
    mem = np.concatenate(memories(tcfg, B, 7))
    logits_match(jcfg, tcfg, p, tp, tokens, 4, 16, TOL, memory=mem)


def test_generate_matches_reference(whisper):
    jcfg, tcfg, p, tp = whisper
    tokens = np.random.default_rng(8).integers(0, 256, size=(B, T),
                                               dtype=np.int32)
    mem = np.concatenate(memories(tcfg, B, 9))
    ref = JS.generate(p, jcfg, jnp.asarray(tokens), GEN,
                      {"memory": jnp.asarray(mem)})
    res = TS.generate(tp, tcfg, _t(tokens).long(), GEN, device="cpu",
                      extras={"memory": _t(mem)})
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(ref["tokens"]))
    assert res["state"]["t"] == T + GEN


def test_engine_streams_equal_jax_engine_and_static(whisper, trace):
    """The staggered trace, a memory a request: the port's streams equal
    the JAX engine's, and each request's stream equals static generate()
    of it alone at the pool's max_tokens; the last two requests took the
    rows the first two retired from."""
    _, tcfg, _, tp = whisper
    prompts, mems, ref = trace
    eng = ServingEngine(tp, tcfg, device="cpu", **POOL)
    got = cross_streams(eng, prompts, mems, ARRIVALS, GEN, _t)
    for rid, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g, r, err_msg=f"request {rid}")
        alone = TS.generate(tp, tcfg, _t(prompts[rid])[None].long(), GEN,
                            device="cpu", max_len=POOL["max_tokens"],
                            extras={"memory": _t(mems[rid])})
        np.testing.assert_array_equal(alone["tokens"][0].numpy(), g,
                                      err_msg=f"request {rid} alone")
    fin = eng.finished
    assert {fin[2].slot, fin[3].slot} == {fin[0].slot, fin[1].slot}
    assert eng.stats()["peak_active"] == 2
    # retired rows leave zero memory behind
    assert not eng.pool.state["memory"].any()


def test_swapping_memories_swaps_streams(whisper, trace):
    """Two requests with ONE prompt and their own memories stream
    differently (the memory reaches the tokens), and swapping the
    memories swaps the streams."""
    _, tcfg, _, tp = whisper
    prompts, mems, _ = trace
    two = [prompts[0], prompts[0]]

    def run(ms):
        return cross_streams(ServingEngine(tp, tcfg, device="cpu", **POOL),
                             two, ms, (0, 1), 8, _t)
    a, b = run(mems[:2]), run(mems[1::-1])
    assert not np.array_equal(a[0], a[1])
    np.testing.assert_array_equal(b[0], a[1])
    np.testing.assert_array_equal(b[1], a[0])


def test_decode_matches_forward():
    """The mirror of tests/test_decode_consistency.py's whisper case, port
    against port: the memory is the encoder's own output over the frames
    (encoded once), the prompt prefills step by step over it, and one more
    serve_step gives the teacher-forced forward's last logits."""
    cfg = get_config(ARCH, smoke=True)
    params = TM.model_init(cfg, torch.Generator().manual_seed(2), "cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    frames = torch.randn((2, cfg.num_audio_frames, cfg.d_model), generator=g)
    x, _ = TM.model_forward(params, tokens, cfg, {"audio_frames": frames})
    ref = TM.logits_from_hidden(params, x[:, -1, :], cfg)
    pos = torch.arange(frames.shape[1], dtype=torch.int32)
    h = frames
    for l in range(cfg.encoder_layers):
        h, _ = TB.attn_block(TM.layer_params(params["encoder"], l), h,
                             cfg=cfg, positions=pos, causal=False,
                             use_rope=False)
    memory = TL.rmsnorm(params["enc_norm"], h, cfg.norm_eps)
    st, _ = TM.prefill(params, tokens[:, :-1], cfg, max_len=16,
                       extras={"memory": memory})
    logits, _ = TM.serve_step(params, st, tokens[:, -1], cfg)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-2,
                               atol=5e-3)


def test_slot_ops_match_reference(whisper):
    """init_decode_slot and write_decode_slot on a pool state whose every
    leaf is random: the port's result equals the reference's leaf for leaf
    (t, the KV rows and the memory row, which write_decode_slot copies and
    init_decode_slot zeroes)."""
    jcfg = whisper[0]
    rng = np.random.default_rng(5)

    def rand(batch, per_slot_t):
        st = JM.init_decode_state(jcfg, batch, 8, per_slot_t=per_slot_t)
        return jax.tree.map(
            lambda a: jnp.asarray(rng.integers(1, 9, a.shape), a.dtype)
            if jnp.issubdtype(a.dtype, jnp.integer)
            else jnp.asarray(rng.standard_normal(a.shape), a.dtype), st)
    pool, src = rand(3, True), rand(1, False)
    assert set(pool) == {"t", "k", "v", "memory"}
    for op, args in ((JM.init_decode_slot, ()), (JM.write_decode_slot,
                                                 (src,))):
        want = op(pool, 1, *args)
        got = {k: _t(v) for k, v in pool.items()}
        getattr(TM, op.__name__)(got, 1, *(
            {k: _t(v) for k, v in a.items()} for a in args))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{op.__name__} {k}")


@pytest.mark.parametrize("kw,phrase", [
    (dict(paged=True, page_size=4), "paged pool is attention-family only"),
    (dict(prefill_chunk=8), "chunked prefill is attention-family only"),
    (dict(prefix_share=True), "prefix sharing needs a paged pool"),
    (dict(preemption=True), "preemption needs a paged pool"),
    (dict(expert_aware=True), "expert-aware admission needs a plain-"),
    (dict(kv_quant="int8"), "requires a paged pool"),
    (dict(journal_dir="unused"), "journaling needs a paged pool"),
])
def test_refused_options_raise_as_the_reference(whisper, kw, phrase,
                                                tmp_path):
    jcfg, tcfg, p, tp = whisper
    if "journal_dir" in kw:
        kw = dict(journal_dir=str(tmp_path))
    with pytest.raises(ValueError, match=phrase):
        JaxEngine(p, jcfg, **POOL, **kw)
    with pytest.raises(ValueError, match=phrase):
        ServingEngine(tp, tcfg, **POOL, **kw, device="cpu")


def test_buckets_off_and_training_and_valid_len_raise(whisper):
    """prompt_buckets is off for an encoder-decoder, as in the reference;
    a bucketed prefill (valid_len) raises, and so does loss_fn: whisper's
    training is ROADMAP.md Queue 1 item 10."""
    jcfg, tcfg, p, tp = whisper
    assert not JaxEngine(p, jcfg, prompt_buckets=True, **POOL).prompt_buckets
    assert not ServingEngine(tp, tcfg, prompt_buckets=True, device="cpu",
                             **POOL).prompt_buckets
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="attention-family only"):
        TM.prefill(tp, tokens, tcfg, max_len=16, valid_len=5)
    with pytest.raises(NotImplementedError, match="item 10"):
        TM.loss_fn(tp, {"tokens": tokens, "labels": tokens}, tcfg)
