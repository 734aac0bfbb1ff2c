"""Prefix page sharing and expert-aware admission in the port's engine
(serving/paging.py `PrefixIndex`, serving/scheduler.py
`ExpertAwareScheduler`, serving/pool.py `admit_from_prefix` and the
poison's fork, serving/engine.py), on the smoke llama_moe_4_16,
granite-moe-3b-a800m and deepseek-moe-16b, fp32, on the CPU (the paged
attention runs its plain version). Mirrors tests/test_prefix_share.py.

Port against port: every trace runs through a plain FIFO paged engine and
a sharing and/or expert-aware one, and every stream must be equal bit for
bit, with the counters showing the fast paths fired and a drained pool
holding no page; the audit sweeps every tick. Against the JAX package
(the same weights through `bridge.params_from_numpy`, its MoE on the
Pallas path in interpret mode): the full-match trace's streams, admit
steps and counters, the expert-aware engine's admit steps and streams,
and the gate probe's signatures.

The dense prefix extension on the smoke `starcoder2-3b` (window 32):
consumers map a cached page-aligned prefix and prefill only the rest,
against the FIFO engine and the JAX engine, with a window that binds
across the shared pages, a donor that prefilled through the chunk lane
(the port deposits a dense chunk run; the reference deposits none),
sharing with chunked prefill only up to the consumer's last chunk (the
reference shares every cached page), and an admission gate that counts
only the consumer's own pages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.engine import \
    expert_signature as jax_signature  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import (Chaos, ExpertAwareScheduler,  # noqa: E402
                                 PageAllocator, PrefixIndex, RequestStatus,
                                 ServingEngine, expert_signature)
from repro_torch.serving.engine import _PROBE_TOKENS  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
ARCHS = ["llama_moe_4_16", "granite-moe-3b-a800m", "deepseek-moe-16b"]
# the reference's full-match trace: six requests with one prompt
FULL = dict(num_slots=3, max_tokens=48, paged=True, page_size=8)
FULL_ARRIVALS = [0, 0, 2, 4, 6, 8]


@pytest.fixture(scope="module")
def port_params():
    cfg = get_config("llama_moe_4_16", smoke=True)
    return cfg, TM.model_init(cfg, torch.Generator().manual_seed(5), "cpu")


def _rand(cfg, rng, n):
    return rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)


def _serve(params, cfg, prompts, gen, *, arrivals=None, priorities=None,
           audit=True, **kw):
    """The trace through a fresh port engine with the audit on every tick;
    returns (engine, the finished requests in submit order)."""
    eng = ServingEngine(params, cfg, device="cpu", **kw)
    eng.audit_every_tick = audit
    ids = [eng.submit(p, gen,
                      arrival_step=arrivals[i] if arrivals else 0,
                      priority=priorities[i] if priorities else 0)
           for i, p in enumerate(prompts)]
    fin = eng.run()
    return eng, [fin[r] for r in ids]


def _streams(reqs):
    return [r.tokens for r in reqs]


# ------------------------------------------------------- full-prompt sharing

@pytest.mark.parametrize("arch", ARCHS)
def test_full_match_equals_fifo_and_jax_engine(arch, monkeypatch):
    """Six requests with one prompt (the shared system prompt): the first
    prefills and deposits, the other five admit from the cache, no
    prefill, both full pages mapped copy-on-write, the first token from
    the donor's cached logits. Streams equal the port's FIFO engine's and
    the JAX sharing engine's; admit steps and the three counters equal the
    JAX engine's; the drain returns every page."""
    for knob in ("REPRO_PREFIX_SHARE", "REPRO_EXPERT_AWARE", "REPRO_CHAOS"):
        monkeypatch.delenv(knob, raising=False)
    jcfg, tcfg, jp, tp = smoke_pair(arch)
    prompts = [_rand(tcfg, np.random.default_rng(3), 16)] * 6
    _, base = _serve(tp, tcfg, prompts, 8, arrivals=FULL_ARRIVALS, **FULL)
    eng, got = _serve(tp, tcfg, prompts, 8, arrivals=FULL_ARRIVALS,
                      prefix_share=True, expert_aware=True, **FULL)
    jeng = JaxEngine(jp, jcfg, prefix_share=True, expert_aware=True, **FULL)
    jids = [jeng.submit(p, 8, arrival_step=a)
            for p, a in zip(prompts, FULL_ARRIVALS)]
    jfin = jeng.run()
    ref = [jfin[r] for r in jids]
    s, js = eng.stats(), jeng.stats()
    assert s["prefix_share"] and s["expert_aware"]
    assert (s["prefix_hits"], s["prefill_tokens_skipped"],
            s["pages_shared"]) == (5, 5 * 16, 5 * 2)
    for key in ("prefix_hits", "pages_shared", "prefill_tokens_skipped",
                "statuses", "steps"):
        assert s[key] == js[key], key
    assert s["statuses"] == {"DONE": 6} and s["pages_in_use"] == 0
    assert _streams(got) == _streams(base) == _streams(ref)
    assert [r.admit_step for r in got] == [r.admit_step for r in ref]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_sampled_consumers_draw_from_cached_logits(port_params, kv_quant):
    """Sampled consumers of one prompt (temperature 0.8, top_p 0.9, their
    own seeds) stream as on the FIFO engine: their first token is drawn
    from the cached logits under their own generator, on fp32 and int8
    pages; a prompt of whole pages (no tail) hits too."""
    cfg, params = port_params
    rng = np.random.default_rng(9)
    p, q = _rand(cfg, rng, 12), _rand(cfg, rng, 16)
    trace = [(p, 0.0, 0), (p, 0.8, 1), (p, 0.8, 2), (q, 0.0, 3), (q, 0.8, 4)]
    out = {}
    for share in (False, True):
        eng = ServingEngine(params, cfg, device="cpu", num_slots=3,
                            max_tokens=48, paged=True, page_size=8,
                            kv_quant=kv_quant, prefix_share=share)
        eng.audit_every_tick = True
        ids = [eng.submit(x, 8, temperature=t, top_p=0.9, seed=sd,
                          arrival_step=2 * i)
               for i, (x, t, sd) in enumerate(trace)]
        fin = eng.run()
        out[share] = ([fin[r].tokens for r in ids], eng.stats())
    s = out[True][1]
    assert out[True][0] == out[False][0]
    assert (s["prefix_hits"], s["pages_shared"],
            s["prefill_tokens_skipped"]) == (3, 2 * 1 + 2, 2 * 12 + 16)
    assert s["pages_in_use"] == 0 and s["statuses"] == {"DONE": 5}


def test_moe_divergent_prefix_exact_repeat(port_params):
    """Two prompts share a leading page and diverge after it; an exact
    repeat of the second admits from the cache. The second deposit must
    not chain through the first prompt's node (same tokens, another
    physical page: MoE whole-sequence routing makes that page another
    prompt's KV), or the repeat would map the first prompt's prefix."""
    cfg, params = port_params
    rng = np.random.default_rng(23)
    lead = _rand(cfg, rng, 8)
    pa, pb = (np.concatenate([lead, _rand(cfg, rng, 8)]) for _ in range(2))
    assert not np.array_equal(pa, pb)
    kw = dict(num_slots=3, max_tokens=48, paged=True, page_size=8)
    _, base = _serve(params, cfg, [pa, pb, pb], 8, arrivals=[0, 2, 6], **kw)
    eng, got = _serve(params, cfg, [pa, pb, pb], 8, arrivals=[0, 2, 6],
                      prefix_share=True, **kw)
    s = eng.stats()
    assert s["prefix_hits"] == 1                     # the repeat of B only
    assert s["statuses"] == {"DONE": 3} and s["pages_in_use"] == 0
    assert _streams(got) == _streams(base)


def test_prefix_index_deposit_is_page_strict():
    """Depositing a prompt whose leading page TOKENS match a node but whose
    physical page differs pins the depositor's own page under a private
    node: its entry never returns another prompt's page."""
    alloc = PageAllocator(num_pages=8, page_size=4)
    idx = PrefixIndex(alloc, page_size=4)
    alloc.reserve(1, 2)
    a_pages = alloc.alloc(1, 2)
    alloc.reserve(2, 2)
    b_pages = alloc.alloc(2, 2)
    pa = list(range(8))                       # two full pages
    pb = pa[:4] + [9] * 4                     # the same leading page tokens
    idx.deposit(pa, a_pages, tail_k=None, tail_v=None, go=None, logits=None)
    idx.deposit(pb, b_pages, tail_k=None, tail_v=None, go=None, logits=None)
    assert idx.entry_pages(idx.lookup_full(pa)) == a_pages
    assert idx.entry_pages(idx.lookup_full(pb)) == b_pages
    assert alloc.refcount(b_pages[0]) == 2
    assert alloc.refcount(a_pages[0]) == 2
    idx.flush()                               # private nodes evict cleanly
    assert alloc.refcount(a_pages[0]) == 1
    assert alloc.refcount(b_pages[0]) == 1
    alloc.check()


def test_sharing_survives_preemption(port_params):
    """A consumer admitted from the cache is evicted under page pressure
    and resumed by snapshot and restore: its shared pages were copied like
    any others, the resume maps private pages, and every stream equals
    the FIFO run."""
    cfg, params = port_params
    prompt = _rand(cfg, np.random.default_rng(11), 8)
    kw = dict(num_slots=3, max_tokens=48, paged=True, page_size=8,
              num_pages=9, preemption=True)
    trace = dict(arrivals=[0, 2, 6], priorities=[5, 5, 0])
    beng, base = _serve(params, cfg, [prompt] * 3, 24, **trace, **kw)
    eng, got = _serve(params, cfg, [prompt] * 3, 24, prefix_share=True,
                      **trace, **kw)
    s = eng.stats()
    assert beng.stats()["preemptions"] >= 1 and s["preemptions"] >= 1
    assert s["prefix_hits"] >= 1
    assert s["statuses"] == {"DONE": 3} and s["pages_in_use"] == 0
    assert _streams(got) == _streams(base)


def test_index_pins_yield_to_blocked_admissions(port_params):
    """Distinct prompts on a pool barely big enough for two streams: every
    deposit pins node pages, so without reclaim the later admissions could
    never reserve. The engine evicts LRU entries for a blocked head and
    finishes every stream as the FIFO run does."""
    cfg, params = port_params
    rng = np.random.default_rng(17)
    prompts = [_rand(cfg, rng, 16) for _ in range(4)]
    kw = dict(num_slots=2, max_tokens=24, paged=True, page_size=8)
    _, base = _serve(params, cfg, prompts, 6, arrivals=[0, 2, 4, 6], **kw)
    eng, got = _serve(params, cfg, prompts, 6, arrivals=[0, 2, 4, 6],
                      prefix_share=True, **kw)
    s = eng.stats()
    assert eng.prefix_index.evictions >= 1
    assert s["statuses"] == {"DONE": 4} and s["pages_in_use"] == 0
    assert _streams(got) == _streams(base)


# ------------------------------------------------ the dense prefix extension

DENSE = "starcoder2-3b"


@pytest.fixture(scope="module")
def dense_pair():
    return smoke_pair(DENSE)


def _ext_prompts(cfg, seed, prefix_len, tail_len, n):
    rng = np.random.default_rng(seed)
    prefix = _rand(cfg, rng, prefix_len)
    return [np.concatenate([prefix, _rand(cfg, rng, tail_len)])
            for _ in range(n)]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_dense_prefix_extension_equals_fifo_and_jax_engine(dense_pair,
                                                           kv_quant,
                                                           monkeypatch):
    """tests/test_prefix_share.py's dense case: five requests share a
    page-aligned 16-token prefix and differ in a 6-token tail. The first
    prefills and deposits; the four others map its two full pages and
    prefill only their tails from position 16 (prefill_chunk over the
    shared pages). Counters 4, 64, 8; streams equal the port's run without
    sharing and, on fp32 pages, the JAX sharing engine's, with its counters
    and admit steps."""
    monkeypatch.delenv("REPRO_PREFIX_SHARE", raising=False)
    jcfg, tcfg, jp, tp = dense_pair
    prompts = _ext_prompts(tcfg, 7, 16, 6, 5)
    kw = dict(num_slots=2, max_tokens=48, paged=True, page_size=8,
              kv_quant=kv_quant)
    arrivals = [0, 2, 4, 6, 8]
    _, base = _serve(tp, tcfg, prompts, 6, arrivals=arrivals, **kw)
    eng, got = _serve(tp, tcfg, prompts, 6, arrivals=arrivals,
                      prefix_share=True, **kw)
    s = eng.stats()
    assert (s["prefix_hits"], s["prefill_tokens_skipped"],
            s["pages_shared"]) == (4, 4 * 16, 4 * 2)
    assert s["statuses"] == {"DONE": 5} and s["pages_in_use"] == 0
    assert _streams(got) == _streams(base)
    if kv_quant == "none":
        jeng = JaxEngine(jp, jcfg, prefix_share=True, **kw)
        jids = [jeng.submit(p, 6, arrival_step=a)
                for p, a in zip(prompts, arrivals)]
        jfin = jeng.run()
        js = jeng.stats()
        for key in ("prefix_hits", "pages_shared", "prefill_tokens_skipped",
                    "statuses", "steps"):
            assert s[key] == js[key], key
        assert _streams(got) == [jfin[r].tokens for r in jids]
        assert [r.admit_step for r in got] == \
            [jfin[r].admit_step for r in jids]


@pytest.mark.parametrize("chunk", [0, 16])
def test_dense_prefix_extension_window_binds_across_shared_pages(dense_pair,
                                                                 chunk):
    """A 32-token shared prefix (four pages of 8) and an 8-token tail: the
    window of 32 drops the first shared page from the tail's last queries
    and from every decode step. Without chunking the donor prefills
    one-shot; with chunks of 16 it prefills through the chunk lane (0, 16,
    32) and deposits, and the consumers' 8-token remainders take the
    extension path from 32. Streams equal the run without sharing."""
    _, tcfg, _, tp = dense_pair
    prompts = _ext_prompts(tcfg, 29, 32, 8, 4)
    kw = dict(num_slots=2, max_tokens=64, paged=True, page_size=8,
              prefill_chunk=chunk)
    arrivals = [0, 4, 5, 9]
    _, base = _serve(tp, tcfg, prompts, 12, arrivals=arrivals, **kw)
    eng, got = _serve(tp, tcfg, prompts, 12, arrivals=arrivals,
                      prefix_share=True, **kw)
    s = eng.stats()
    assert (s["prefix_hits"], s["prefill_tokens_skipped"],
            s["pages_shared"]) == (3, 3 * 32, 3 * 4)
    assert s["chunk_ticks"] == (3 if chunk else 0)
    assert s["statuses"] == {"DONE": 4} and s["pages_in_use"] == 0
    assert _streams(got) == _streams(base)


@pytest.mark.parametrize("prefix_len,tail,expect", [
    (24, 8, (3, 3 * 16, 3 * 2, 2)),     # 3 pages cached, 2 shared: [16, 32)
    (8, 30, (0, 0, 0, 4 * 3)),          # 1 page cached, last chunk at 32
])
def test_dense_prefix_extension_shares_up_to_the_last_chunk(dense_pair,
                                                            prefix_len, tail,
                                                            expect):
    """With chunks of 16 a consumer shares the cached chain only up to the
    start of its own last chunk, and prefills that chunk as a cold chunked
    run does (same tokens, position and width). A 24-token prefix (three
    pages, off a chunk boundary) with 8-token tails shares two pages and
    prefills [16, 32); an 8-token prefix with 30-token tails does not
    reach the last chunk (from 32) and takes the chunk lane. Counters
    (hits, tokens skipped, pages shared, chunk ticks) as derived; streams
    equal the run without sharing."""
    _, tcfg, _, tp = dense_pair
    prompts = _ext_prompts(tcfg, 41, prefix_len, tail, 4)
    kw = dict(num_slots=2, max_tokens=64, paged=True, page_size=8,
              prefill_chunk=16)
    arrivals = [0, 3, 4, 8]
    _, base = _serve(tp, tcfg, prompts, 6, arrivals=arrivals, **kw)
    eng, got = _serve(tp, tcfg, prompts, 6, arrivals=arrivals,
                      prefix_share=True, **kw)
    s = eng.stats()
    assert (s["prefix_hits"], s["prefill_tokens_skipped"],
            s["pages_shared"], s["chunk_ticks"]) == expect
    assert s["statuses"] == {"DONE": 4} and s["pages_in_use"] == 0
    assert _streams(got) == _streams(base)


def test_dense_prefix_extension_gate_discounts_shared_pages(dense_pair):
    """A pool of 8 usable pages whose index pins a retired donor's four
    prefix pages: the consumer (40 + 8 tokens, 6 pages at worst) cannot
    reserve cold, but its extension hit needs only 2, so it admits without
    evicting the index and streams as on a roomy pool."""
    _, tcfg, _, tp = dense_pair
    donor, consumer = _ext_prompts(tcfg, 31, 32, 8, 2)
    donor = donor[:32]
    eng = ServingEngine(tp, tcfg, device="cpu", num_slots=2, max_tokens=48,
                        paged=True, page_size=8, num_pages=9,
                        prefix_share=True)
    eng.audit_every_tick = True
    eng.submit(donor, 8)
    while eng.has_work():
        eng.step()
    rid = eng.submit(consumer, 8)
    req = eng.scheduler.queue[0][2]
    assert not eng.pool.can_admit(req)
    assert eng._ext_hit(req) is not None and eng._can_admit_now(req)
    eng.step()
    assert eng.prefix_hits == 1 and eng.prefix_index.evictions == 0
    fin = eng.run()
    _, ref = _serve(tp, tcfg, [consumer], 8, num_slots=1, max_tokens=48,
                    paged=True, page_size=8)
    assert fin[rid].tokens == ref[0].tokens
    assert eng.stats()["pages_in_use"] == 0


# ---------------------------------------------------- the poison of a share

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_poison_of_a_shared_page_forks_it(port_params, kv_quant):
    """A consumer of a 16-token prompt (two full pages, no tail) is
    poisoned right after its cache admission, when its last written
    position lies in a SHARED page: the page is forked (K, V and, on int8
    pages, the scales copied, the block table repointed), the consumer
    retires FAILED, and the donor and the other consumer stream as in the
    unpoisoned run; the drain leaves no page."""
    cfg, params = port_params
    prompt = _rand(cfg, np.random.default_rng(31), 16)
    kw = dict(num_slots=3, max_tokens=48, paged=True, page_size=8,
              kv_quant=kv_quant, prefix_share=True)
    _, clean = _serve(params, cfg, [prompt] * 3, 8, arrivals=[0, 2, 4], **kw)

    eng = ServingEngine(params, cfg, device="cpu", chaos=Chaos(seed=0), **kw)
    eng.audit_every_tick = True
    ids = [eng.submit(prompt, 8, arrival_step=a) for a in (0, 2, 4)]
    forks = []

    def poison_consumer():
        slot = next((s for s, o in enumerate(eng.pool.owner)
                     if o is not None and o.request_id == ids[1]
                     and len(o.tokens) == 1), None)
        if slot is None:
            return
        donor = next(s for s, o in enumerate(eng.pool.owner)
                     if o is not None and o.request_id == ids[0])
        shared = int(eng.pool.block_table[slot, 1])
        assert shared == int(eng.pool.block_table[donor, 1])
        assert eng.pool.alloc.refcount(shared) >= 3   # donor, node, consumer
        before = {k: eng.pool.state[k][:, shared].clone()
                  for k in ("k_pages", "v_pages", "k_scales", "v_scales")
                  if k in eng.pool.state}
        eng.pool.poison_slot(slot)
        new = int(eng.pool.block_table[slot, 1])
        assert new != shared and eng.pool.alloc.refcount(new) == 1
        assert set(eng.pool.alloc.owned(ids[1])) == set(
            eng.pool.block_table[slot][eng.pool.block_table[slot] != 0])
        for k, v in before.items():
            assert torch.equal(eng.pool.state[k][:, shared], v), k
            if k != ("k_scales" if kv_quant == "int8" else "k_pages"):
                assert torch.equal(eng.pool.state[k][:, new], v), k
        forks.append(new)

    eng._inject_state_faults = poison_consumer
    fin = eng.run()
    assert len(forks) == 1
    assert fin[ids[1]].status is RequestStatus.FAILED
    assert fin[ids[1]].tokens == clean[1].tokens[:len(fin[ids[1]].tokens)]
    assert [fin[ids[0]].tokens, fin[ids[2]].tokens] == \
        [clean[0].tokens, clean[2].tokens]
    assert eng.stats()["pages_in_use"] == 0


def test_poison_skips_a_fork_with_no_page_to_spare(port_params):
    """With every free page promised, the fork of a shared page cannot
    draw one: the injection is skipped, the block table and pages stay as
    they were, and the consumer streams as in a clean run."""
    cfg, params = port_params
    kw = dict(num_slots=2, max_tokens=16, paged=True, page_size=8,
              num_pages=4, prefix_share=True)
    prompt = _rand(cfg, np.random.default_rng(4), 8)
    _, clean = _serve(params, cfg, [prompt] * 2, 8, **kw)
    eng = ServingEngine(params, cfg, device="cpu", chaos=Chaos(seed=0), **kw)
    eng.audit_every_tick = True
    ids = [eng.submit(prompt, 8) for _ in range(2)]
    skipped = []

    def poison_consumer():
        slot = next((s for s, o in enumerate(eng.pool.owner)
                     if o is not None and o.request_id == ids[1]
                     and len(o.tokens) == 1), None)
        if slot is None:
            return
        # the donor's two pages and the consumer's fresh one: none free
        assert not eng.pool.alloc.can_reserve(1)
        row = eng.pool.block_table[slot].copy()
        eng.pool.poison_slot(slot)
        assert (eng.pool.block_table[slot] == row).all()
        assert bool(torch.isfinite(eng.pool.state["k_pages"]).all())
        skipped.append(slot)

    eng._inject_state_faults = poison_consumer
    fin = eng.run()
    assert len(skipped) == 1
    assert [fin[r].tokens for r in ids] == _streams(clean)
    assert eng.stats()["statuses"] == {"DONE": 2}


# ---------------------------------------------------------------- gate probe

@pytest.mark.parametrize("arch", ARCHS)
def test_gate_probe_fixed_window_equals_reference(arch):
    """The probe reads a fixed window: a long prompt's signature equals
    that of its _PROBE_TOKENS head, every signature is non-empty, and each
    equals the JAX package's on the same weights (fp32, highest
    precision)."""
    jcfg, tcfg, jp, tp = smoke_pair(arch)
    rng = np.random.default_rng(2)
    long = _rand(tcfg, rng, _PROBE_TOKENS + 33)
    sigs = []
    for n in (3, 7, 20, _PROBE_TOKENS, len(long)):
        got = expert_signature(tp, long[:n], tcfg)
        ref = np.asarray(jax_signature(jp, long[:n], jcfg))
        assert got.dtype == bool and got.shape == (tcfg.moe.num_experts,)
        assert got.any()
        np.testing.assert_array_equal(got, ref)
        sigs.append(got)
    np.testing.assert_array_equal(sigs[-1], sigs[-2])


def test_explicit_flags_validate_config(port_params, dense_pair):
    """Explicit flags on a shape that cannot support them raise the
    reference's errors: prefix sharing on a dense pool, expert-aware
    admission on a config without MoE (starcoder2's too)."""
    cfg, params = port_params
    _, dcfg, _, dparams = dense_pair
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(dparams, dcfg, num_slots=2, max_tokens=48, paged=True,
                      expert_aware=True, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(params, cfg, num_slots=2, max_tokens=48,
                      prefix_share=True, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(params, cfg.with_overrides(moe=None), num_slots=2,
                      max_tokens=48, expert_aware=True, device="cpu")
    eng = ServingEngine(params, cfg, num_slots=2, max_tokens=48,
                        device="cpu")
    s = eng.stats()
    assert (s["prefix_share"], s["expert_aware"]) == (False, False)
    assert eng.prefix_index is None


# -------------------------------------------------- expert-aware scheduler

def _req(rid, sig=None, priority=0):
    return Request(request_id=rid, prompt=np.zeros(4, np.int32),
                   max_new_tokens=4, priority=priority, expert_sig=sig)


def test_expert_aware_degenerates_to_fifo_without_signatures():
    """All-None signatures score 0: admission order, blocked head
    included, is exactly FIFO."""
    sched = ExpertAwareScheduler(2, 64, num_experts=4)
    for i in range(4):
        sched.submit(_req(i))
    assert sched.next_admission(0).request_id == 0
    assert sched.next_admission(1).request_id == 1
    assert sched.next_admission(2) is None          # max_slots
    assert sched.next_admission(1, can_admit=lambda r: False) is None
    assert sched.last_blocked.request_id == 2
    assert sched.next_admission(1).request_id == 2


def test_expert_aware_groups_overlapping_requests():
    """Overlap with the active batch wins within a class, never across
    one; the EWMA load breaks ties toward cold experts; the victim bonus
    counts experts no other stream needs."""
    sched = ExpertAwareScheduler(4, 64, num_experts=4)
    A = np.array([1, 1, 0, 0], bool)
    B = np.array([0, 0, 1, 1], bool)
    sched.note_active([A])
    sched.submit(_req(0, sig=B))
    sched.submit(_req(1, sig=A))
    assert sched.next_admission(1).request_id == 1    # overlap wins
    assert sched.next_admission(1).request_id == 0
    sched.submit(_req(2, sig=B, priority=0))
    sched.submit(_req(3, sig=A, priority=1))
    assert sched.next_admission(1).request_id == 2
    assert sched.next_admission(1).request_id == 3
    sched.note_active([])
    C = np.array([1, 0, 0, 0], bool)
    D = np.array([0, 0, 0, 1], bool)
    for _ in range(4):
        sched.observe(C)                  # expert 0 is hot
    sched.submit(_req(4, sig=C))
    sched.submit(_req(5, sig=D))
    assert sched.next_admission(0).request_id == 5
    assert sched.next_admission(1).request_id == 4
    assert sched.victim_bonus(B, [A, C]) == 2
    assert sched.victim_bonus(A, [A, C]) == 0
    assert sched.victim_bonus(None, [A]) == 0


def test_expert_aware_starvation_bounded_by_aging_cap():
    """A request disjoint from the active batch is force-admitted after
    MAX_SKIPS pass-overs; a blocked tick ages nobody."""
    sched = ExpertAwareScheduler(8, 64, num_experts=4)
    sched.MAX_SKIPS = 3
    A = np.array([1, 1, 0, 0], bool)
    B = np.array([0, 0, 1, 1], bool)
    sched.note_active([A])
    sched.submit(_req(0, sig=B))
    picked = []
    for rid in range(1, 12):
        sched.submit(_req(rid, sig=A))
        picked.append(sched.next_admission(0).request_id)
        if picked[-1] == 0:
            break
    assert 0 in picked and len(picked) == sched.MAX_SKIPS + 1
    sched.submit(_req(99, sig=B))
    skips_before = [e[2].times_skipped for e in sched.queue]
    assert sched.next_admission(0, can_admit=lambda r: False) is None
    assert [e[2].times_skipped for e in sched.queue] == skips_before


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_aware_engine_equals_jax_engine(arch, monkeypatch):
    """Expert-aware admission reorders the queue (six prompts at once on
    the full-match pool; the 16-token prompts bring more experts than the
    8-token ones); every request's admit step equals the JAX expert-aware
    engine's and every stream equals the JAX engine's and the port's FIFO
    engine's. The pool and the 16-token length are the full-match test's,
    so the JAX engine compiles one prefill length more."""
    for knob in ("REPRO_PREFIX_SHARE", "REPRO_EXPERT_AWARE", "REPRO_CHAOS"):
        monkeypatch.delenv(knob, raising=False)
    jcfg, tcfg, jp, tp = smoke_pair(arch)
    rng = np.random.default_rng(5)
    prompts = [_rand(tcfg, rng, n) for n in (16, 8, 16, 8, 16, 8)]
    kw = FULL
    _, base = _serve(tp, tcfg, prompts, 5, **kw)
    eng, got = _serve(tp, tcfg, prompts, 5, expert_aware=True, **kw)
    jeng = JaxEngine(jp, jcfg, expert_aware=True, prefix_share=False, **kw)
    jids = [jeng.submit(p, 5) for p in prompts]
    jfin = jeng.run()
    ref = [jfin[r] for r in jids]
    assert eng.stats()["expert_aware"]
    assert eng.stats()["statuses"] == {"DONE": len(prompts)}
    assert [r.admit_step for r in got] == [r.admit_step for r in ref]
    assert [r.admit_step for r in got] != [r.admit_step for r in base]
    assert _streams(got) == _streams(base) == _streams(ref)


def test_expert_aware_preemption_ranks_victims_by_unique_experts(
        port_params):
    """Within a priority class, a blocked high-priority arrival evicts the
    stream whose experts no other stream needs (the victim bonus), not
    the latest admission; every stream still equals the FIFO run's."""
    cfg, params = port_params
    eng = ServingEngine(params, cfg, device="cpu", num_slots=2,
                        max_tokens=48, paged=True, page_size=8,
                        preemption=True, expert_aware=True)
    eng.audit_every_tick = True
    rng = np.random.default_rng(6)
    prompts = [_rand(cfg, rng, 8) for _ in range(3)]
    ids = [eng.submit(p, 12, priority=5) for p in prompts[:2]]
    eng.step()
    owners = [o for o in eng.pool.owner if o is not None]
    assert len(owners) == 2
    # give the first admission an expert no other stream needs
    E = cfg.moe.num_experts
    owners[0].expert_sig = np.eye(E, dtype=bool)[0]
    owners[1].expert_sig = np.zeros(E, bool)
    slot_of = {o.request_id: s for s, o in enumerate(eng.pool.owner)}
    assert eng._victim_rank(slot_of[owners[0].request_id]) == 1
    assert eng._victim_rank(slot_of[owners[1].request_id]) == 0
    ids.append(eng.submit(prompts[2], 4, priority=0))
    eng.step()
    assert owners[0].status is RequestStatus.PREEMPTED
    assert owners[1].status is RequestStatus.ACTIVE
    fin = eng.run()
    _, base = _serve(params, cfg, prompts[:2], 12, num_slots=2,
                     max_tokens=48, paged=True, page_size=8)
    assert [fin[r].tokens for r in ids[:2]] == _streams(base)
    assert eng.stats()["statuses"] == {"DONE": 3}
    assert eng.stats()["pages_in_use"] == 0
