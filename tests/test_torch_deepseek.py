"""The smoke deepseek-moe-16b (token choice, top-2 of 8 routed experts plus
one always-on shared expert, group size 2 with "sorted" grouping, MHA 4/4,
fp32) through the port's prefill, serve_step, generate() and
continuous-batching engine, against the JAX package on the same weights
(`bridge.params_from_numpy`). The JAX side runs backend="pallas", its
grouped-GEMM decomposition in interpret mode: on the CPU "auto" would pick
its xla realization, another drop set.

Prefill goes through the C1 group path with lane fusion (K7/K8's plain
versions here), decode through token-choice dispatch (K1/K2's); the
shared expert's output is added on both, outside the grouped GEMM.

Tolerance for logits: atol = rtol = 1e-4 (fp32 on both sides, sums taken
in another order). Greedy tokens and engine streams must be equal; port
against port, the engine streams what static generate() streams, bit for
bit. The int8 engine against the JAX int8 engine is
tests/test_torch_kv_quant.py's deepseek case; prefix sharing and the gate
probe are tests/test_torch_prefix_share.py's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import moe as MOE  # noqa: E402
from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek-moe-16b"
B, T, GEN = 2, 16, 8
# the staggered paged, chunked trace of tests/test_torch_granite.py
LENS = [5, 20, 8, 11, 3]
ARRIVALS = [0, 0, 1, 4, 6]
POOL = dict(num_slots=2, max_tokens=32, paged=True, page_size=4,
            num_pages=10, prefill_chunk=8)


@pytest.fixture(scope="module")
def deepseek():
    return smoke_pair(ARCH)


def test_config_is_a_copy_of_the_reference():
    for smoke in (False, True):
        jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            if f.name != "moe":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        for f in dataclasses.fields(tc.moe):
            assert getattr(tc.moe, f.name) == getattr(jc.moe, f.name), f.name
    # the full-width "sorted" group map at E = 64: every integer the
    # reference's
    full, jfull = get_config(ARCH), jax_config(ARCH)
    assert full.moe.num_shared_experts == 2 and full.moe.num_experts == 64
    np.testing.assert_array_equal(
        TM.expert_group_members(full, "cpu").numpy(),
        np.asarray(JM.expert_group_members(jfull)))
    np.testing.assert_array_equal(TM.expert_groups(full, "cpu").numpy(),
                                  np.asarray(JM.expert_groups(jfull)))


def test_params_carry_the_shared_bank_across(deepseek):
    """model_init adds the stacked shared bank [L, S, d, de] / [L, S, de, d]
    as the reference does, and the bridge carries it bit for bit."""
    jcfg, tcfg, p, tp = deepseek
    sh = tp["layers"]["moe"]["shared"]
    L, S = tcfg.num_layers, tcfg.moe.num_shared_experts
    d, de = tcfg.d_model, tcfg.moe.d_expert
    for k in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(
            sh[k].numpy(), np.asarray(p["layers"]["moe"]["shared"][k]))
    own = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = {k: tuple(v.shape)
           for k, v in own["layers"]["moe"]["shared"].items()}
    assert got == {"wi": (L, S, d, de), "wg": (L, S, d, de),
                   "wo": (L, S, de, d)}
    assert got == {k: tuple(v.shape) for k, v in sh.items()}


def test_prefill_and_decode_logits_match_reference(deepseek):
    jcfg, tcfg, p, tp = deepseek
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, T), dtype=np.int32)
    j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_len"))
    j_step = jax.jit(JM.serve_step, static_argnames="cfg")
    st, lg = j_prefill(p, jnp.asarray(prompts), jcfg, max_len=T + 8)
    tst, tlg = TM.prefill(tp, torch.from_numpy(prompts).long(), tcfg,
                          max_len=T + 8)
    assert "go" not in tst and "go" not in st     # token choice: no GO rows
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    np.testing.assert_allclose(tst["k"].numpy(), np.asarray(st["k"]), **TOL)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for _ in range(4):
        lg, st = j_step(p, st, tok, jcfg)
        tlg, tst = TM.serve_step(tp, tst, torch.from_numpy(np.array(tok)),
                                 tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)


def test_generate_greedy_tokens_equal_reference(deepseek):
    jcfg, tcfg, p, tp = deepseek
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(B, T), dtype=np.int32)
    rj = JS.generate(p, jcfg, jnp.asarray(prompts), GEN)
    before = dict(G.LAUNCHES)
    rt = TS.generate(tp, tcfg, torch.from_numpy(prompts), GEN, device="cpu")
    assert G.LAUNCHES == before              # CPU: plain versions only
    np.testing.assert_array_equal(rt["tokens"].numpy(),
                                  np.asarray(rj["tokens"]))


def test_token_choice_moe_decode_matches_forward_dropless(deepseek):
    """tests/test_decode_consistency.py's case on the port: with a capacity
    factor of 8 nothing drops, so the port's prefill of all but the last
    token and one serve_step give the logits of the JAX package's
    model_forward over every token (its "auto" backend: the xla
    realization on the CPU) at the last position. fp32 on both sides and
    no drop on either: 1e-4, tighter than the reference's bf16-minded
    1e-2 / 5e-3."""
    jcfg, tcfg, p, tp = deepseek
    jcfg = jcfg.with_overrides(moe=dataclasses.replace(
        jcfg.moe, capacity_factor=8.0, backend="auto"))
    tcfg = tcfg.with_overrides(moe=dataclasses.replace(
        tcfg.moe, capacity_factor=8.0))
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, size=(2, 12), dtype=np.int32)
    x, _ = JM.model_forward(p, jnp.asarray(tokens), jcfg, {})
    ref = np.asarray(JM.logits_from_hidden(p, x[:, -1, :], jcfg))
    st, _ = TM.prefill(tp, torch.from_numpy(tokens[:, :-1]).long(), tcfg,
                       max_len=16)
    logits, _ = TM.serve_step(tp, st, torch.from_numpy(tokens[:, -1]).long(),
                              tcfg)
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)


def _serve(params, cfg, prompts, gens, arrivals=None, **kw):
    eng = ServingEngine(params, cfg, device="cpu", **kw)
    rids = [eng.submit(pr, g, arrival_step=arrivals[i] if arrivals else 0)
            for i, (pr, g) in enumerate(zip(prompts, gens))]
    eng.run()
    return [eng.finished[r].tokens for r in rids], eng


def test_engine_streams_equal_jax_engine(deepseek):
    """The staggered trace on a paged pool with chunked prefill (pooled
    capacity over each chunk's rows, pads included, as in the
    reference)."""
    jcfg, tcfg, p, tp = deepseek
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n, dtype=np.int32)
               for n in LENS]
    ref = JS.serve_continuous(p, jcfg, prompts, 7, arrival_steps=ARRIVALS,
                              **POOL)
    got, eng = _serve(tp, tcfg, prompts, [7] * len(LENS), ARRIVALS, **POOL)
    for rid, toks in enumerate(got):
        assert toks == ref["tokens"][rid].tolist(), f"request {rid}"
    s, rs = eng.stats(), ref["stats"]
    assert (s["steps"], s["chunk_ticks"], s["peak_active"]) == \
        (rs["steps"], rs["chunk_ticks"], rs["peak_active"])
    assert s["chunk_ticks"] == 3 + 2 and s["pages_in_use"] == 0
    assert "go" not in eng.pool.state


def test_engine_bit_identical_to_static_generate(deepseek):
    """Port against port: without chunking each request streams what it
    streams alone through generate() at the pool's cache capacity."""
    _, tcfg, _, tp = deepseek
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n, dtype=np.int32)
               for n in (12, 9, 12, 5)]
    gens = [6, 4, 7, 5]
    got, _ = _serve(tp, tcfg, prompts, gens, [0, 0, 2, 3], num_slots=2,
                    max_tokens=32, paged=True, page_size=4)
    for pr, g, toks in zip(prompts, gens, got):
        ref = TS.generate(tp, tcfg, torch.from_numpy(pr)[None], g,
                          device="cpu", max_len=32)
        assert toks == ref["tokens"][0].tolist()


def test_shared_expert_moves_the_logits(deepseek):
    """The shared bank is served, not dropped: zeroing its output weights
    changes the prefill logits by more than the tolerance, and the decode's
    MoE output equals the routed part plus the shared expert's FFN."""
    _, tcfg, _, tp = deepseek
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, size=(B, T), dtype=np.int64))
    _, lg = TM.prefill(tp, prompts, tcfg, max_len=T + 4)
    cut = {**tp, "layers": {**tp["layers"], "moe": {
        **tp["layers"]["moe"], "shared": {
            **tp["layers"]["moe"]["shared"],
            "wo": torch.zeros_like(tp["layers"]["moe"]["shared"]["wo"])}}}}
    _, lg0 = TM.prefill(cut, prompts, tcfg, max_len=T + 4)
    assert (lg - lg0).abs().max() > 1e-2
    moe_p = TM.layer_params(tp["layers"], 0)["moe"]
    x = torch.randn(3, tcfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    routed = {k: v for k, v in moe_p.items() if k != "shared"}
    torch.testing.assert_close(
        MOE.token_choice_decode(moe_p, x, tcfg.moe),
        MOE.token_choice_decode(routed, x, tcfg.moe)
        + MOE._shared_out(moe_p, x))


def test_cli_smoke_on_cpu_and_cuda_by_default(capsys, monkeypatch):
    res = TS.main(["--arch", ARCH, "--smoke", "--static", "--device", "cpu",
                   "--batch", "2", "--prompt", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    res = TS.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--requests", "3", "--slots", "2", "--prompt", "10",
                   "--gen", "3", "--paged", "--page-size", "4",
                   "--chunk-prefill", "8"])
    assert res["stats"]["finished"] == 3
    assert "deepseek-moe-smoke on cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        TS.main(["--arch", ARCH, "--smoke", "--static"])
