"""The port's continuous-batching engine (serving/engine.py) on the smoke
llama_moe_4_16, fp32, on the CPU, where the paged attention runs its plain
version (the reference's gather realization).

Against the JAX package (same weights through `bridge.params_from_numpy`;
the JAX side runs backend="pallas", its grouped-GEMM decomposition in
interpret mode):
  * greedy streams of one staggered trace on a paged pool with chunked
    prefill must be EQUAL to the JAX engine's;
  * a paged `prefill_chunk` and a paged `serve_step` agree to
    atol = rtol = 1e-4 (fp32 on both sides, sums in another order), with
    equal GO-cache token ids.

Port against port, bit for bit (the reference's own contracts,
tests/test_serving.py): the paged engine streams what the dense engine
streams; the engine streams what the port's static generate() streams; a
tight page budget serializes without deadlock; EOS retires early and the
slot is reused; an oversized request raises RequestTooLarge.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch.serve import serve_continuous as jax_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import paged_attn as PA  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import (QueueFull, RequestStatus,  # noqa: E402
                                 RequestTooLarge, ServingEngine)

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)

# The staggered trace: 5 over 2 slots (slot reuse), a 3-token prompt and a
# 5-token prompt shorter than one chunk of 8, a 20-token prompt spanning
# three chunks (the last one ragged), 7 new tokens each, so decode crosses
# page boundaries of 4. With 9 usable pages the 20-token request (7 pages
# at worst) waits for pages while a slot is free.
LENS = [5, 20, 8, 11, 3]
ARRIVALS = [0, 0, 1, 4, 6]
GEN = 7
POOL = dict(num_slots=2, max_tokens=32, paged=True, page_size=4,
            num_pages=10, prefill_chunk=8)


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_config("llama_moe_4_16", smoke=True)
    jcfg = jcfg.with_overrides(
        moe=dataclasses.replace(jcfg.moe, backend="pallas"))
    p = JM.model_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n, dtype=np.int32)
               for n in LENS]
    return jcfg, get_config("llama_moe_4_16", smoke=True), p, tp, prompts


@pytest.fixture(scope="module")
def port_params():
    cfg = get_config("llama_moe_4_16", smoke=True)
    return cfg, TM.model_init(cfg, torch.Generator().manual_seed(5), "cpu")


def _serve(params, cfg, prompts, gens, arrivals=None, *, eos=None, **kw):
    """Drive an engine tick by tick; returns (streams, engine, whether an
    admission ever waited on pages while a slot was free)."""
    eng = ServingEngine(params, cfg, device="cpu", **kw)
    rids = [eng.submit(p, g, arrival_step=arrivals[i] if arrivals else 0,
                       eos_id=eos[i] if eos else None)
            for i, (p, g) in enumerate(zip(prompts, gens))]
    page_wait = False
    while eng.has_work():
        eng.step()
        job = eng._chunk_job
        free = [s for s in eng.pool.free_slots()
                if job is None or s != job.slot]
        if free and eng.scheduler.queue and eng.pool.paged:
            head = eng.scheduler.queue[0][2]
            lane_busy = job is not None and \
                head.prompt_len > eng.prefill_chunk
            page_wait |= not lane_busy and not eng.pool.can_admit(head)
    return [eng.finished[r].tokens for r in rids], eng, page_wait


# --------------------------------------------------- against the JAX package

def test_engine_streams_equal_jax_engine(bridged):
    jcfg, tcfg, p, tp, prompts = bridged
    ref = jax_serve(p, jcfg, prompts, GEN, arrival_steps=ARRIVALS, **POOL)
    got, eng, page_wait = _serve(tp, tcfg, prompts, [GEN] * len(LENS),
                                 ARRIVALS, **POOL)
    for rid, toks in enumerate(got):
        assert toks == ref["tokens"][rid].tolist(), f"request {rid}"
    s, rs = eng.stats(), ref["stats"]
    assert (s["steps"], s["chunk_ticks"], s["peak_active"]) == \
        (rs["steps"], rs["chunk_ticks"], rs["peak_active"])
    assert s["chunk_ticks"] == 3 + 2      # the 20- and 11-token prompts
    assert page_wait, "the trace never made an admission wait on pages"
    slots = [eng.finished[r].slot for r in range(len(LENS))]
    assert max(np.bincount(slots)) >= 2           # a slot was reused
    assert s["pages_in_use"] == 0
    eng.pool.alloc.check()


def _paged_states(jcfg, tcfg, batch, max_len, num_pages, ps, seed):
    """The same paged decode state on both sides: random page contents,
    shuffled block tables (rows past their allocation on the null page)."""
    rng = np.random.default_rng(seed)
    L, hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim()
    P = max_len // ps
    kp = rng.standard_normal((L, num_pages, ps, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((L, num_pages, ps, hkv, hd)).astype(np.float32)
    ids = iter(rng.permutation(np.arange(1, num_pages)))
    bt = np.zeros((batch, P), np.int32)
    for b in range(batch):
        for j in range(P - b):
            bt[b, j] = next(ids)
    js = JM.init_decode_state(jcfg, batch, max_len, per_slot_t=True,
                              paged=(num_pages, ps))
    js.update(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp),
              block_table=jnp.asarray(bt))
    ts = TM.init_decode_state(tcfg, batch, max_len, "cpu", per_slot_t=True,
                              paged=(num_pages, ps))
    ts["k_pages"].copy_(torch.from_numpy(kp))
    ts["v_pages"].copy_(torch.from_numpy(vp))
    ts["block_table"].copy_(torch.from_numpy(bt))
    return js, ts


def _assert_go_close(tgo, jgo):
    np.testing.assert_array_equal(tgo.token_ids.numpy(),
                                  np.asarray(jgo.token_ids))
    np.testing.assert_allclose(tgo.scores.numpy(), np.asarray(jgo.scores),
                               **TOL)
    np.testing.assert_allclose(tgo.outputs.numpy(), np.asarray(jgo.outputs),
                               **TOL)


def test_paged_prefill_chunk_matches_jax(bridged):
    """A 20-token prompt in chunks of 8 straight into a paged pool: chunk
    logits, the merged GO caches and the written pages."""
    jcfg, tcfg, p, tp, prompts = bridged
    js, ts = _paged_states(jcfg, tcfg, 1, 32, 10, 4, seed=1)
    del js["t"], ts["t"]
    prompt = np.pad(prompts[1], (0, 4))
    for start in range(0, 24, 8):
        valid = min(8, 20 - start)
        chunk = prompt[start:start + 8][None, :]
        js, jl = JM.prefill_chunk(p, js, jnp.asarray(chunk), jcfg, start,
                                  valid)
        ts, tl = TM.prefill_chunk(tp, ts, torch.from_numpy(chunk).long(),
                                  tcfg, start, valid)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert ts["t"] == int(js["t"]) == start + valid
    _assert_go_close(ts["go"], js["go"])
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   **TOL)


def test_paged_serve_step_matches_jax(bridged):
    """One decode tick of a 3-row paged pool at ragged positions (one on a
    page boundary) with random page contents and empty GO rows."""
    jcfg, tcfg, p, tp, _ = bridged
    js, ts = _paged_states(jcfg, tcfg, 3, 16, 13, 4, seed=2)
    t = np.array([5, 8, 0], np.int32)
    js["t"] = jnp.asarray(t)
    ts["t"] = torch.from_numpy(t.copy())
    tok = np.array([3, 17, 250], np.int32)
    jl, js = JM.serve_step(p, js, jnp.asarray(tok), jcfg)
    tl, ts = TM.serve_step(tp, ts, torch.from_numpy(tok).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(ts["t"].numpy(), np.asarray(js["t"]))
    _assert_go_close(ts["go"], js["go"])
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   **TOL)


# ------------------------------------------------------- port against port

def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
            for n in lens]


@pytest.mark.parametrize("chunk", [0, 8])
def test_paged_engine_bit_identical_to_dense(port_params, chunk):
    cfg, params = port_params
    prompts = _prompts(cfg, LENS, 0)
    kw = dict(num_slots=2, max_tokens=32, prefill_chunk=chunk)
    dense, _, _ = _serve(params, cfg, prompts, [GEN] * 5, ARRIVALS, **kw)
    before = dict(PA.LAUNCHES)
    paged, eng, _ = _serve(params, cfg, prompts, [GEN] * 5, ARRIVALS,
                           paged=True, page_size=4, **kw)
    assert paged == dense
    assert PA.LAUNCHES == before               # CPU: plain versions only
    assert eng.stats()["chunk_ticks"] == (5 if chunk else 0)
    assert eng.pool.alloc.pages_in_use == 0
    eng.pool.alloc.check()


def test_engine_bit_identical_to_static_generate(port_params):
    """Without chunking each request streams what it streams alone through
    generate() at the pool's cache capacity."""
    cfg, params = port_params
    prompts = _prompts(cfg, [12, 9, 12, 5], 1)
    gens = [6, 4, 7, 5]
    got, eng, _ = _serve(params, cfg, prompts, gens, [0, 0, 2, 3],
                         num_slots=2, max_tokens=32, paged=True, page_size=4)
    for p, g, toks in zip(prompts, gens, got):
        ref = TS.generate(params, cfg, torch.from_numpy(p)[None], g,
                          device="cpu", max_len=32)
        assert toks == ref["tokens"][0].tolist()


def test_tight_page_budget_serializes_without_deadlock(port_params):
    """Pages for one request at a time: the second waits on pages (not on
    a slot) until the first retires; both stream as they do alone."""
    cfg, params = port_params
    prompts = _prompts(cfg, [12, 12], 9)
    alone = [_serve(params, cfg, [p], [6], num_slots=1, max_tokens=32,
                    paged=True, page_size=8)[0][0] for p in prompts]
    # each needs ceil((12 + 6) / 8) = 3 pages; the pool has 4
    got, eng, page_wait = _serve(params, cfg, prompts, [6, 6], num_slots=2,
                                 max_tokens=32, paged=True, page_size=8,
                                 num_pages=1 + 4)
    assert got == alone and page_wait
    assert eng.finished[1].admit_step >= eng.finished[0].finish_step
    assert eng.pool.alloc.pages_in_use == 0


def test_eos_retires_early_and_slot_is_reused(port_params):
    cfg, params = port_params
    p0, p1 = _prompts(cfg, [12, 12], 1)
    ref0, _, _ = _serve(params, cfg, [p0], [8], num_slots=1, max_tokens=32)
    eos = ref0[0][2]                          # retire after 3 tokens
    got, eng, _ = _serve(params, cfg, [p0, p1], [8, 4], eos=[eos, None],
                         num_slots=1, max_tokens=32, paged=True, page_size=4)
    ref1, _, _ = _serve(params, cfg, [p1], [4], num_slots=1, max_tokens=32)
    assert got[0] == ref0[0][:ref0[0].index(eos) + 1]
    assert got[1] == ref1[0]
    assert eng.finished[0].slot == eng.finished[1].slot == 0
    assert all(r.status == RequestStatus.DONE for r in eng.finished.values())


def test_oversized_and_unsupported_requests_raise(port_params):
    cfg, params = port_params
    eng = ServingEngine(params, cfg, num_slots=1, max_tokens=16,
                        device="cpu")
    with pytest.raises(RequestTooLarge, match="max_tokens=16"):
        eng.submit(np.zeros(12, np.int32), 8)
    paged = ServingEngine(params, cfg, num_slots=1, max_tokens=32,
                          paged=True, page_size=4, num_pages=5,
                          max_queue=1, device="cpu")
    with pytest.raises(RequestTooLarge, match="4 usable pages"):
        paged.submit(np.zeros(12, np.int32), 8)    # 5 pages at worst
    paged.submit(np.zeros(4, np.int32), 2)
    with pytest.raises(QueueFull):
        paged.submit(np.zeros(4, np.int32), 2)
    assert paged.stats()["rejected"] == {"queue_full": 1, "oversized": 1}
    with pytest.raises(ValueError, match="top_p"):
        paged.submit(np.zeros(4, np.int32), 2, temperature=0.7, top_p=0.0)


def test_engine_without_a_device_never_runs_on_the_cpu(port_params,
                                                        monkeypatch):
    cfg, params = port_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        ServingEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        TS.serve_continuous(params, cfg, [np.zeros(4, np.int32)], 2,
                            num_slots=1)
