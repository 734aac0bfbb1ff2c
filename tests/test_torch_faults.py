"""The port engine's fault domain (serving/engine.py, serving/pool.py,
serving/scheduler.py, serving/paging.py) on the smoke llama_moe_4_16, fp32,
on the CPU (the paged attention runs its plain version).

Port against port, the reference's contracts (tests/test_serving.py
fault-domain section, tests/test_kv_quant.py, tests/test_paging.py): a
deadline expires a queued request and max_wall_s a decoding one (TIMEOUT,
prefix kept); cancel retires a request wherever it is (queued,
trace-pending, parked after preemption, mid-chunk-prefill, decoding) and
hands its pages back; a high-priority arrival under page pressure evicts a
low-priority stream that later resumes by block-table surgery, every
stream equal to running alone, on fp32 and int8 pages; a poisoned
slot is quarantined FAILED with its prefix kept while its cohabitant
streams on, dense, paged and int8; the scrubbed pages a later request
reuses give the stream a fresh pool gives; a fault inside the decode step
raises RestartRequired with no retry (the port's tick writes in place);
arbitrary admit / tick / preempt / resume / cancel interleavings keep the
pool's audit green.

Against the JAX package (same weights through `bridge.params_from_numpy`):
the preemption trace's streams and preemption counts equal the JAX
engine's.
"""
import numpy as np
import pytest
from conftest import given, settings, st

torch = pytest.importorskip("torch")

from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.fault import RestartRequired  # noqa: E402
from repro_torch.serving import (RequestStatus, ServingEngine,  # noqa: E402
                                 SlotPool)
from repro_torch.serving import engine as ENG  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
MAX_TOKENS = 48
# the reference's page-pressure trace: two low-priority streams fill 8
# usable pages of 8 (4 each at worst), a high-priority one arrives at tick 6
PRESSURE = dict(num_slots=3, max_tokens=MAX_TOKENS, paged=True, page_size=8,
                num_pages=9, preemption=True)


@pytest.fixture(scope="module")
def port_params():
    cfg = get_config("llama_moe_4_16", smoke=True)
    return cfg, TM.model_init(cfg, torch.Generator().manual_seed(5), "cpu")


def _prompts(cfg, seed, n, size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=size, dtype=np.int32)
            for _ in range(n)]


def _static(params, cfg, prompt, gen):
    """The request alone through the port's static generate() at the
    engine's cache capacity."""
    res = TS.generate(params, cfg, torch.from_numpy(prompt)[None], gen,
                      device="cpu", max_len=MAX_TOKENS)
    return res["tokens"][0].tolist()


def _solo(params, cfg, prompt, gen, **kw):
    """The request alone on a 1-slot engine of the same pool kind: the
    oracle of an int8 pool, whose quantized pages generate() lacks."""
    kw = {"max_tokens": MAX_TOKENS, **kw, "num_slots": 1}
    kw.pop("num_pages", None)
    kw.pop("preemption", None)
    eng = ServingEngine(params, cfg, device="cpu", **kw)
    rid = eng.submit(prompt, gen)
    return eng.run()[rid].tokens


def _slot_of(eng, rid):
    return next((s for s, o in enumerate(eng.pool.owner)
                 if o is not None and o.request_id == rid), None)


def _step_until_tokens(eng, rid, n):
    """Tick until request `rid` holds n tokens; returns its slot."""
    for _ in range(40):
        eng.step()
        slot = _slot_of(eng, rid)
        if slot is not None and len(eng.pool.owner[slot].tokens) >= n:
            return slot
    raise AssertionError(f"request {rid} never reached {n} tokens")


# ------------------------------------------------------ deadlines and cancel

def test_deadline_expires_queued_request_without_touching_survivors(
        port_params):
    cfg, params = port_params
    p0, p1 = _prompts(cfg, 21, 2, 12)
    eng = ServingEngine(params, cfg, num_slots=1, max_tokens=MAX_TOKENS,
                        device="cpu")
    r0 = eng.submit(p0, 8)
    r1 = eng.submit(p1, 6, deadline_s=0.0)    # expires while queued
    fin = eng.run()
    assert fin[r1].status is RequestStatus.TIMEOUT
    assert fin[r1].tokens == [] and fin[r1].fail_reason
    assert fin[r0].status is RequestStatus.DONE
    assert fin[r0].tokens == _static(params, cfg, p0, 8)
    assert eng.stats()["statuses"] == {"DONE": 1, "TIMEOUT": 1}


@pytest.mark.parametrize("paged", [False, True])
def test_max_wall_retires_mid_decode_and_frees_the_slot(port_params, paged):
    cfg, params = port_params
    p0, p1 = _prompts(cfg, 22, 2, 12)
    kw = dict(paged=True, page_size=8) if paged else {}
    eng = ServingEngine(params, cfg, num_slots=2, max_tokens=MAX_TOKENS,
                        device="cpu", **kw)
    eng.audit_every_tick = True
    r0 = eng.submit(p0, 24, max_wall_s=0.0)   # blown right after admission
    r1 = eng.submit(p1, 8)
    fin = eng.run()
    assert fin[r0].status is RequestStatus.TIMEOUT
    ref0 = _static(params, cfg, p0, 24)
    assert 0 < len(fin[r0].tokens) < 24
    assert fin[r0].tokens == ref0[:len(fin[r0].tokens)]
    assert fin[r1].status is RequestStatus.DONE
    assert fin[r1].tokens == _static(params, cfg, p1, 8)
    assert not eng.pool.any_active()
    if paged:
        assert eng.pool.alloc.pages_in_use == 0


def test_cancel_across_the_request_lifecycle(port_params):
    """cancel() retires a request queued (no tokens), trace-pending (no
    tokens) and decoding (a prefix kept, slot and pages freed), and
    returns False for unknown ids and double cancels."""
    cfg, params = port_params
    p0, p1, p2 = _prompts(cfg, 23, 3, 12)
    eng = ServingEngine(params, cfg, num_slots=1, max_tokens=MAX_TOKENS,
                        paged=True, page_size=8, device="cpu")
    eng.audit_every_tick = True
    r0 = eng.submit(p0, 16)
    r1 = eng.submit(p1, 8)                    # queued behind the only slot
    r2 = eng.submit(p2, 8, arrival_step=100)  # not arrived yet
    for _ in range(6):
        eng.step()
    assert eng.cancel(r1)                     # still queued
    assert eng.cancel(r2)                     # trace-pending
    assert eng.cancel(r0)                     # mid-decode
    assert not eng.cancel(r0)                 # already terminal
    assert not eng.cancel(10 ** 6)            # unknown id
    fin = eng.run()
    ref0 = _static(params, cfg, p0, 16)
    assert fin[r0].status is RequestStatus.CANCELLED
    assert 0 < len(fin[r0].tokens) < 16
    assert fin[r0].tokens == ref0[:len(fin[r0].tokens)]
    for r in (r1, r2):
        assert fin[r].status is RequestStatus.CANCELLED and fin[r].tokens == []
    assert not eng.pool.any_active() and not eng.has_work()
    assert eng.pool.alloc.pages_in_use == 0


def test_cancel_mid_chunk_prefill_frees_claimed_pages(port_params):
    cfg, params = port_params
    rng = np.random.default_rng(24)
    long_p = rng.integers(0, cfg.vocab_size, size=28, dtype=np.int32)
    p1 = rng.integers(0, cfg.vocab_size, size=8, dtype=np.int32)  # one-shot
    eng = ServingEngine(params, cfg, num_slots=2, max_tokens=MAX_TOKENS,
                        paged=True, page_size=8, prefill_chunk=8,
                        device="cpu")
    r0 = eng.submit(long_p, 8)
    eng.step()
    assert eng._chunk_job is not None and eng._chunk_job.req.request_id == r0
    assert eng.pool.alloc.pages_in_use > 0
    assert eng.cancel(r0)
    assert eng._chunk_job is None
    assert eng.pool.alloc.pages_in_use == 0
    eng.pool.alloc.check()
    assert eng.finished[r0].status is RequestStatus.CANCELLED
    r1 = eng.submit(p1, 6)
    fin = eng.run()
    assert fin[r1].tokens == _static(params, cfg, p1, 6)


# ---------------------------------------------------------------- preemption

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_page_pressure_preemption_resumes_bit_identical(port_params,
                                                        kv_quant):
    """Two low-priority streams fill the page pool; a high-priority arrival
    evicts one (snapshot, pages freed), finishes first, and the evicted
    stream resumes by block-table surgery: every stream equals running
    alone, the pool drains clean and the audit stays green every tick. On
    int8 pages the snapshot carries the pages' scales and GO row scales."""
    cfg, params = port_params
    rng = np.random.default_rng(2)
    lo = [rng.integers(0, cfg.vocab_size, size=8, dtype=np.int32)
          for _ in range(2)]
    hi = rng.integers(0, cfg.vocab_size, size=8, dtype=np.int32)
    kw = dict(PRESSURE, kv_quant=kv_quant)
    eng = ServingEngine(params, cfg, device="cpu", **kw)
    eng.audit_every_tick = True
    r_lo = [eng.submit(p, 24, priority=5) for p in lo]
    r_hi = eng.submit(hi, 8, priority=0, arrival_step=6)
    fin = eng.run()
    s = eng.stats()
    assert s["preemptions"] >= 1 and s["resumes"] == s["preemptions"]
    assert s["preempted_waiting"] == 0
    oracle = _static if kv_quant == "none" else \
        (lambda p_, c, q, g: _solo(p_, c, q, g, **kw))
    for rid, p, g in [(r_lo[0], lo[0], 24), (r_lo[1], lo[1], 24),
                      (r_hi, hi, 8)]:
        assert fin[rid].status is RequestStatus.DONE
        assert fin[rid].tokens == oracle(params, cfg, p, g), \
            f"request {rid} diverged after preemption churn"
    assert any(fin[r].preemptions >= 1 for r in r_lo)
    # the high-priority request overtook the stream evicted for it
    assert fin[r_hi].finish_step < max(fin[r].finish_step for r in r_lo)
    assert eng.pool.alloc.pages_in_use == 0
    eng.pool.audit()


def test_cancel_parked_preempted_request(port_params):
    cfg, params = port_params
    lo = _prompts(cfg, 2, 2, 8)
    hi = _prompts(cfg, 3, 1, 8)[0]
    eng = ServingEngine(params, cfg, device="cpu", **PRESSURE)
    eng.audit_every_tick = True
    r_lo = [eng.submit(p, 24, priority=5) for p in lo]
    eng.submit(hi, 8, priority=0, arrival_step=6)
    while not eng._preempted:
        eng.step()
    (parked,) = eng._preempted
    assert eng.scheduler.queue and parked in r_lo
    assert eng.cancel(parked)
    assert not eng._preempted
    fin = eng.run()
    assert fin[parked].status is RequestStatus.CANCELLED
    assert 0 < len(fin[parked].tokens) < 24
    assert eng.stats()["resumes"] == 0
    assert eng.pool.alloc.pages_in_use == 0


def test_preemption_needs_a_paged_pool(port_params):
    cfg, params = port_params
    with pytest.raises(ValueError, match="paged pool"):
        ServingEngine(params, cfg, num_slots=2, max_tokens=MAX_TOKENS,
                      preemption=True, device="cpu")


def _pressure_trace(eng, prompts):
    """The page-pressure trace on an engine of either package."""
    return [eng.submit(p, g, priority=pr, arrival_step=a)
            for p, g, pr, a in zip(prompts, (24, 24, 8), (5, 5, 0),
                                   (0, 0, 6))]


def test_preemption_trace_streams_equal_jax_engine(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    jcfg, tcfg, jp, tp = smoke_pair("llama_moe_4_16")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, size=8, dtype=np.int32)
               for _ in range(3)]
    jeng = JaxEngine(jp, jcfg, **PRESSURE)
    jids = _pressure_trace(jeng, prompts)
    jfin = jeng.run()
    eng = ServingEngine(tp, tcfg, device="cpu", **PRESSURE)
    ids = _pressure_trace(eng, prompts)
    fin = eng.run()
    for r, jr in zip(ids, jids):
        assert fin[r].tokens == jfin[jr].tokens, f"request {r}"
        assert (fin[r].preemptions, fin[r].finish_step) == \
            (jfin[jr].preemptions, jfin[jr].finish_step), f"request {r}"
    s, js = eng.stats(), jeng.stats()
    assert s["preemptions"] == js["preemptions"] >= 1
    assert (s["resumes"], s["steps"]) == (js["resumes"], js["steps"])


# ------------------------------------------------------ NaN quarantine, scrub

@pytest.mark.parametrize("mode", ["dense", "paged", "int8"])
def test_nan_poison_quarantines_one_slot_not_its_cohabitants(port_params,
                                                             mode):
    """Poisoning one slot mid-flight retires THAT request FAILED ("non-
    finite logits") with its pre-poison prefix kept, and the cohabiting
    stream finishes bit-identical. int8 pages hold no NaN, so the poison
    lands on the page's scale; the quarantine scrubs it back to 0."""
    cfg, params = port_params
    p0, p1 = _prompts(cfg, 27, 2, 12)
    kw = {"dense": {}, "paged": dict(paged=True, page_size=8),
          "int8": dict(paged=True, page_size=8, kv_quant="int8")}[mode]
    eng = ServingEngine(params, cfg, num_slots=2, max_tokens=MAX_TOKENS,
                        device="cpu", **kw)
    eng.audit_every_tick = True
    r0 = eng.submit(p0, 16)
    r1 = eng.submit(p1, 16)
    slot0 = _step_until_tokens(eng, r0, 4)
    eng.pool.poison_slot(slot0)
    fin = eng.run()
    oracle = _static if mode != "int8" else \
        (lambda p_, c, q, g: _solo(p_, c, q, g, **kw))
    ref0, ref1 = (oracle(params, cfg, p, 16) for p in (p0, p1))
    assert fin[r0].status is RequestStatus.FAILED
    assert fin[r0].fail_reason == "non-finite logits"
    assert 4 <= len(fin[r0].tokens) < 16
    assert fin[r0].tokens == ref0[:len(fin[r0].tokens)]
    assert fin[r1].status is RequestStatus.DONE and fin[r1].tokens == ref1
    assert not eng.pool.any_active()
    assert eng.stats()["statuses"] == {"DONE": 1, "FAILED": 1}
    st_ = eng.pool.state
    for key in ("k", "v", "k_pages", "v_pages", "k_scales", "v_scales"):
        if key in st_:
            assert bool(torch.isfinite(st_[key].float()).all()), key


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_scrubbed_page_reused_streams_as_a_fresh_pool(port_params, kv_quant):
    """The quarantine zeroes the poisoned slot's pages (and their scales)
    as they are freed; a request admitted right after maps those pages
    (the allocator hands out the last freed first) and streams what it
    streams on a fresh pool. Without the scrub the plain attention, which
    gathers every page and masks afterwards, would meet 0 * NaN."""
    cfg, params = port_params
    p0, p1, p2 = _prompts(cfg, 28, 3, 12)
    kw = dict(num_slots=2, max_tokens=MAX_TOKENS, paged=True, page_size=8,
              kv_quant=kv_quant)
    eng = ServingEngine(params, cfg, device="cpu", **kw)
    eng.audit_every_tick = True
    r0 = eng.submit(p0, 16)
    eng.submit(p1, 16)
    slot0 = _step_until_tokens(eng, r0, 4)
    eng.pool.poison_slot(slot0)
    poisoned = set(eng.pool.alloc.owned(r0))
    done = eng.step()
    assert [r.request_id for r in done] == [r0]
    assert done[0].status is RequestStatus.FAILED
    ids = torch.tensor(sorted(poisoned))
    for key in ("k_pages", "v_pages", "k_scales", "v_scales"):
        if key in eng.pool.state:
            assert bool((eng.pool.state[key][:, ids] == 0).all()), key
    r2 = eng.submit(p2, 12)
    eng.step()
    slot2 = _slot_of(eng, r2)
    reused = poisoned & set(eng.pool.block_table[slot2].tolist())
    assert reused, "the new request took none of the scrubbed pages"
    fin = eng.run()
    fresh = ServingEngine(params, cfg, device="cpu", **kw)
    rf = fresh.submit(p2, 12)
    assert fin[r2].tokens == fresh.run()[rf].tokens
    assert fin[r2].status is RequestStatus.DONE


@pytest.mark.parametrize("chunk", [0, 8])
def test_non_finite_prefill_fails_before_admission(port_params, monkeypatch,
                                                   chunk):
    """A request whose prefill logits are not all finite retires FAILED
    ("non-finite prefill logits") with no token and never takes its slot;
    a chunked run's claimed pages, which its NaN KV filled, are scrubbed
    and freed; the other request streams as it does alone."""
    cfg, params = port_params
    p0 = _prompts(cfg, 30, 1, 12)[0]           # chunked when chunk is 8
    p1 = _prompts(cfg, 31, 1, 6)[0]            # one-shot either way
    real_prefill, real_chunk = ENG.prefill, ENG.prefill_chunk

    def bad_prefill(prm, tokens, cfg_, **kw):
        st_, logits = real_prefill(prm, tokens, cfg_, **kw)
        if tokens.shape[1] == len(p0):
            logits = torch.full_like(logits, float("nan"))
        return st_, logits

    def bad_chunk(prm, state, tokens, cfg_, start, valid):
        state, logits = real_chunk(prm, state, tokens, cfg_, start, valid)
        if start + valid == len(p0):           # the last chunk of p0
            pages = state["block_table"][0]
            state["k_pages"][:, pages[pages > 0].long()] = float("nan")
            logits = torch.full_like(logits, float("nan"))
        return state, logits

    monkeypatch.setattr(ENG, "prefill", bad_prefill)
    monkeypatch.setattr(ENG, "prefill_chunk", bad_chunk)
    eng = ServingEngine(params, cfg, num_slots=2, max_tokens=MAX_TOKENS,
                        paged=True, page_size=8, prefill_chunk=chunk,
                        device="cpu")
    eng.audit_every_tick = True
    r0, r1 = eng.submit(p0, 8), eng.submit(p1, 8)
    fin = eng.run()
    monkeypatch.undo()
    assert fin[r0].status is RequestStatus.FAILED and fin[r0].tokens == []
    assert fin[r0].fail_reason == "non-finite prefill logits"
    assert fin[r1].status is RequestStatus.DONE
    assert fin[r1].tokens == _static(params, cfg, p1, 8)
    assert eng.stats()["chunk_ticks"] == (2 if chunk else 0)
    assert eng.pool.alloc.pages_in_use == 0
    assert bool(torch.isfinite(eng.pool.state["k_pages"]).all())


def test_fault_inside_the_decode_step_restarts_without_retry(port_params,
                                                             monkeypatch):
    """The port's tick writes the pool in place, so a failure inside it is
    not retried: it surfaces at once as RestartRequired, cause chained."""
    cfg, params = port_params
    eng = ServingEngine(params, cfg, num_slots=1, max_tokens=MAX_TOKENS,
                        device="cpu")
    eng.submit(_prompts(cfg, 29, 1, 8)[0], 4)
    calls = []

    def failing_step(*a, **kw):
        calls.append(1)
        raise RuntimeError("device fault inside serve_step")

    monkeypatch.setattr(ENG, "serve_step", failing_step)
    with pytest.raises(RestartRequired) as ei:
        eng.step()
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert "inside serve_step" in str(ei.value.__cause__)
    assert len(calls) == 1 and eng.stats()["tick_retries"] == 0


# ---------------------------------------- pool-level interleaving property

@settings(max_examples=10, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(
           st.sampled_from(["admit", "tick", "preempt", "resume", "cancel"]),
           st.integers(0, 2)),
       min_size=1, max_size=24),
       st.integers(0, 2 ** 31 - 1))
def test_pool_survives_preempt_cancel_interleavings(ops, seed):
    """Arbitrary interleavings of admit / decode tick / preempt (snapshot
    and free) / resume (block-table surgery) / cancel never leak or alias
    a page, reset freed GO rows to -inf, hand a restored slot back exactly
    its snapshotted pages, and pass the audit after every op."""
    cfg = get_config("llama_moe_4_16", smoke=True)
    pool = SlotPool(cfg, 3, 16, "cpu", paged=True, page_size=8)
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    parked: dict = {}                          # rid -> (req, snapshot)
    rid = 0

    def go_cleared(slot):
        return bool(torch.isneginf(pool.state["go"].scores[:, slot]).all())

    for op, slot in ops:
        req = pool.owner[slot]
        if op == "admit" and req is None:
            nreq = Request(
                request_id=rid,
                prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                max_new_tokens=4)
            if pool.can_admit(nreq):           # the engine's admission gate
                rid += 1
                src = TM.init_decode_state(cfg, 1, 16, "cpu")
                src["t"] = 6
                for k in ("k", "v"):
                    src[k] = torch.randn(src[k].shape, generator=g)
                src["go"] = type(src["go"])(*(
                    torch.ones_like(a) if a.dtype != torch.int32
                    else torch.zeros_like(a) for a in src["go"]))
                pool.admit(slot, nreq, src, first_token=1)
        elif op == "tick" and pool.any_active():
            # one decode token for every active slot, the engine's order:
            # grow the write page, bump the device t, mirror it on the host
            pool.grow_active()
            pool.state["t"] = pool.state["t"] + torch.from_numpy(
                pool.active_mask().astype(np.int32))
            pool.note_decoded()
            for s, o in enumerate(pool.owner):
                if o is not None:
                    pool.remaining[s] -= 1
                    if pool.remaining[s] <= 0:
                        pool.retire(s)
        elif op == "preempt" and req is not None:
            snap = pool.snapshot(slot)
            pool.retire(slot)
            parked[req.request_id] = (req, snap)
            assert go_cleared(slot)
        elif op == "resume" and parked and pool.owner[slot] is None:
            prid = min(parked)
            preq, snap = parked[prid]
            if pool.can_resume(snap):
                del parked[prid]
                pool.restore(slot, preq, snap)
                ids = torch.from_numpy(
                    pool.block_table[slot][:snap["n_pages"]].astype(np.int64))
                assert torch.equal(pool.state["k_pages"][:, ids], snap["k"])
                assert torch.equal(pool.state["v_pages"][:, ids], snap["v"])
        elif op == "cancel":
            if req is not None:                # cancel an active stream
                pool.retire(slot)
                assert go_cleared(slot)
            elif parked:                       # cancel a parked snapshot
                parked.pop(min(parked))        # pages were freed at preempt
        pool.audit()
    for s, o in enumerate(pool.owner):         # drain
        if o is not None:
            pool.retire(s)
    pool.audit()
    assert pool.alloc.pages_in_use == 0
    assert bool(torch.isneginf(pool.state["go"].scores).all())
