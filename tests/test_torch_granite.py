"""Slice 3: the smoke granite-moe-3b-a800m (token choice, top-2 of 10
experts, group size 2 with "sorted" grouping, GQA 4/2, fp32) through the
port's prefill, serve_step, generate() and continuous-batching engine,
against the JAX package on the same weights (`bridge.params_from_numpy`).
The JAX side runs backend="pallas", its grouped-GEMM decomposition in
interpret mode: on the CPU "auto" would pick its xla realization, which
routes per sequence and evicts from a buffer, another drop set.

Prefill goes through the C1 group path with lane fusion (K7/K8's plain
versions here), decode through token-choice dispatch (K1/K2's).

Tolerance for logits: atol = rtol = 1e-4 (fp32 on both sides, sums taken
in another order). Greedy tokens and engine streams must be equal; port
against port, the engine streams what static generate() streams, bit for
bit.
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
from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "granite-moe-3b-a800m"
B, T, GEN = 2, 16, 8
# the staggered paged, chunked trace of tests/test_torch_serving.py
LENS = [5, 20, 8, 11, 3]
ARRIVALS = [0, 0, 1, 4, 6]
POOL = dict(num_slots=2, max_tokens=32, paged=True, page_size=4,
            num_pages=10, prefill_chunk=8)


@pytest.fixture(scope="module")
def granite():
    jcfg = jax_config(ARCH, smoke=True)
    jcfg = jcfg.with_overrides(
        moe=dataclasses.replace(jcfg.moe, backend="pallas"))
    tcfg = get_config(ARCH, smoke=True)
    # the reference memoizes its group map per MoE config; build it outside
    # any jit trace, or the first traced call would memoize a tracer
    JM.expert_groups(jcfg), JM.expert_group_members(jcfg)
    p = JM.model_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    return jcfg, tcfg, p, tp


def test_config_is_a_copy_of_the_reference():
    for smoke in (False, True):
        jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            if f.name != "moe":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        for f in dataclasses.fields(tc.moe):
            assert getattr(tc.moe, f.name) == getattr(jc.moe, f.name), f.name
    np.testing.assert_array_equal(
        TM.expert_group_members(get_config(ARCH), "cpu").numpy(),
        np.asarray(JM.expert_group_members(jax_config(ARCH))))


def test_prefill_and_decode_logits_match_reference(granite):
    jcfg, tcfg, p, tp = granite
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, T), dtype=np.int32)
    # jitted as the reference's generate() runs them (eager interpret-mode
    # dispatch is slow)
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


def test_generate_greedy_tokens_equal_reference(granite):
    jcfg, tcfg, p, tp = granite
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(B, T), dtype=np.int32)
    rj = JS.generate(p, jcfg, jnp.asarray(prompts), GEN)
    before = dict(G.LAUNCHES)
    rt = TS.generate(tp, tcfg, torch.from_numpy(prompts), GEN, device="cpu")
    assert G.LAUNCHES == before              # CPU: plain versions only
    np.testing.assert_array_equal(rt["tokens"].numpy(),
                                  np.asarray(rj["tokens"]))


def _serve(params, cfg, prompts, gens, arrivals=None, **kw):
    eng = ServingEngine(params, cfg, device="cpu", **kw)
    rids = [eng.submit(pr, g, arrival_step=arrivals[i] if arrivals else 0)
            for i, (pr, g) in enumerate(zip(prompts, gens))]
    eng.run()
    return [eng.finished[r].tokens for r in rids], eng


def test_engine_streams_equal_jax_engine(granite):
    """The staggered trace on a paged pool with chunked prefill (pooled
    capacity over each chunk's rows, pads included, as in the
    reference)."""
    jcfg, tcfg, p, tp = granite
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


def test_engine_bit_identical_to_static_generate(granite):
    """Port against port: without chunking each request streams what it
    streams alone through generate() at the pool's cache capacity."""
    _, tcfg, _, tp = granite
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


def test_cli_smoke_on_cpu_and_cuda_by_default(capsys, monkeypatch):
    res = TS.main(["--arch", ARCH, "--smoke", "--static", "--device", "cpu",
                   "--batch", "2", "--prompt", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    res = TS.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--requests", "3", "--slots", "2", "--prompt", "10",
                   "--gen", "3", "--paged", "--page-size", "4",
                   "--chunk-prefill", "8"])
    assert res["stats"]["finished"] == 3
    assert "granite-moe-smoke on cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        TS.main(["--arch", ARCH, "--smoke", "--static"])


def test_unported_variants_raise(granite):
    _, tcfg, _, tp = granite
    prompts = torch.zeros((1, 4), dtype=torch.long)
    xla = tcfg.with_overrides(moe=dataclasses.replace(tcfg.moe,
                                                      backend="xla"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.prefill(tp, prompts, xla)
    shared = tcfg.with_overrides(moe=dataclasses.replace(
        tcfg.moe, num_shared_experts=2))
    with pytest.raises(NotImplementedError, match="shared experts"):
        TM.init_decode_state(shared, 1, 8, "cpu")
