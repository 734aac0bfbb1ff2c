"""The port's host-side copies (serving/paging.py `PageAllocator`,
`pages_for_tokens`, `PrefixIndex`; serving/scheduler.py `FIFOScheduler`,
`ExpertAwareScheduler`, `Request`) against the reference package's,
driven by the same operations. Every integer result (page ids, refcounts,
released lists, counts, admission order, raised error types) must be
equal.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from conftest import given, settings, st  # noqa: E402
from repro.serving import paging as JP  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro_torch.serving import paging as TP  # noqa: E402
from repro_torch.serving import scheduler as TS  # noqa: E402


def _apply(alloc, op):
    """One operation; returns its result or the name of the error raised."""
    name, rid, n = op
    try:
        if name == "reserve":
            return alloc.reserve(rid, n)
        if name == "alloc":
            return alloc.alloc(rid, n)
        if name == "grow":
            return alloc.grow(rid)
        if name == "free":
            return alloc.free(rid)
        if name == "share":
            # map the first page of request n % 4 into rid (a page rid
            # maps already raises)
            pages = alloc.owned(n % 4)
            return alloc.share(rid, pages[:1])
        if name == "fork":
            pages = [p for p in alloc.owned(rid) if alloc.refcount(p) > 1]
            return alloc.fork(rid, pages[0]) if pages else None
        if name == "can_reserve":
            return alloc.can_reserve(n)
        return alloc.can_grow(rid)
    except (RuntimeError, KeyError) as e:
        return type(e).__name__


def _run_both(ops, num_pages, page_size):
    ref = JP.PageAllocator(num_pages, page_size, max_tokens=8 * page_size)
    got = TP.PageAllocator(num_pages, page_size, max_tokens=8 * page_size)
    for op in ops:
        assert _apply(got, op) == _apply(ref, op), op
        assert (got.free_pages, got.pages_in_use) == \
            (ref.free_pages, ref.pages_in_use), op
        for rid in range(4):
            assert got.owned(rid) == ref.owned(rid), op
        assert got.refcounts() == ref.refcounts(), op
        got.check()
        ref.check()


SCRIPT = [("reserve", 0, 3), ("alloc", 0, 2), ("reserve", 1, 6),
          ("can_reserve", 0, 2), ("reserve", 2, 4), ("alloc", 1, 4),
          ("grow", 0, 0), ("grow", 0, 0), ("alloc", 2, 1), ("grow", 1, 0),
          ("free", 0, 0), ("can_reserve", 0, 4), ("reserve", 2, 4),
          ("alloc", 2, 3), ("grow", 2, 0), ("grow", 3, 0), ("free", 1, 0),
          ("reserve", 3, 5), ("alloc", 3, 5), ("can_grow", 3, 0),
          ("free", 2, 0), ("free", 3, 0), ("free", 3, 0)]


SHARE_SCRIPT = [("reserve", 0, 3), ("alloc", 0, 2), ("share", 1, 0),
                ("share", 1, 0), ("reserve", 1, 4), ("can_reserve", 0, 4),
                ("alloc", 1, 1), ("share", 2, 1), ("fork", 0, 0),
                ("fork", 1, 0), ("grow", 1, 0), ("share", 3, 0),
                ("free", 0, 0), ("fork", 3, 0), ("share", 0, 3),
                ("free", 1, 0), ("free", 2, 0), ("free", 3, 0),
                ("free", 0, 0)]


def test_allocator_matches_reference_on_a_scripted_sequence():
    """Reservations, lazy growth, over-reservation and over-growth errors,
    LIFO reuse of freed pages."""
    _run_both(SCRIPT, num_pages=11, page_size=4)


def test_sharing_allocator_matches_reference_on_a_scripted_sequence():
    """share (a double share and an unallocated page raise), reserve over
    shared pages, fork of a shared and of a private page, release on the
    last reference only."""
    _run_both(SHARE_SCRIPT, num_pages=8, page_size=4)


@settings(derandomize=True, database=None, max_examples=40, deadline=None)
@given(ops=st.lists(st.tuples(
    st.sampled_from(["reserve", "alloc", "grow", "free", "can_reserve",
                     "can_grow", "share", "fork"]),
    st.integers(0, 3), st.integers(0, 6)), max_size=40),
    num_pages=st.integers(2, 14))
def test_allocator_matches_reference_on_random_sequences(ops, num_pages):
    _run_both(ops, num_pages, page_size=4)


def test_allocator_rejects_what_the_reference_rejects():
    for args in [(1, 4), (4, 0), (8, 4, 30)]:
        with pytest.raises(ValueError):
            JP.PageAllocator(*args)
        with pytest.raises(ValueError):
            TP.PageAllocator(*args)
    assert [TP.pages_for_tokens(n, 16) for n in (0, 1, 16, 17, 512)] == \
        [JP.pages_for_tokens(n, 16) for n in (0, 1, 16, 17, 512)]


def _req(mod, rid, n, gen, arrival=0, prio=0):
    return mod.Request(request_id=rid, prompt=np.zeros(n, np.int32),
                       max_new_tokens=gen, arrival_step=arrival,
                       priority=prio)


def test_scheduler_matches_reference_admission_order():
    """Priorities, FIFO within a level, trace arrivals, the slot cap, a
    head blocked by can_admit, and the typed rejections."""
    trace = [(0, 8, 4, 0, 1), (1, 8, 4, 0, 0), (2, 8, 4, 3, 0),
             (3, 20, 4, 0, 1), (4, 8, 4, 5, 0), (5, 8, 4, 0, 0)]
    out = {}
    for name, mod in (("ref", JS), ("got", TS)):
        sch = mod.FIFOScheduler(max_slots=2, max_tokens=32, max_queue=7)
        log = []
        for rid, n, gen, arr, prio in trace:
            sch.submit(_req(mod, rid, n, gen, arr, prio), now_step=0)
        for bad in [_req(mod, 9, 30, 4)]:
            try:
                sch.submit(bad)
            except mod.RequestTooLarge:
                log.append("too_large")
        sch.submit(_req(mod, 6, 8, 4))
        try:
            sch.submit(_req(mod, 7, 8, 4))
        except mod.QueueFull as e:
            log.append(("full", e.depth, e.max_queue))
        blocked = {3}
        for step in range(8):
            log.append(("arrived", step,
                        [r.request_id for r in sch.poll(step)]))
            for busy in (0, 1, 2):
                r = sch.next_admission(
                    busy, can_admit=lambda q: q.request_id not in blocked)
                log.append((busy, None if r is None else r.request_id))
            if step == 4:
                blocked.clear()
            log.append((sch.has_pending(), sch.next_arrival_step()))
        out[name] = log
    assert out["got"] == out["ref"]


# ------------------------------------------------------------ prefix index

def _index_run(mod):
    """A scripted PrefixIndex sequence on a 16-page pool of 4-token pages
    (capacity 3): deposits sharing a leading page, a repeat, the page-
    strict private node, lookups, LRU evictions, reclaim and flush. Logs
    every page id, released list, refcount map and counter."""
    alloc = mod.PageAllocator(16, 4)
    if mod is TP:                 # the port's capacity is a class constant
        idx = mod.PrefixIndex(alloc, 4)
        idx.CAPACITY = 3
    else:
        idx = mod.PrefixIndex(alloc, 4, capacity=3)
    log = []

    def owner(rid, n):
        alloc.reserve(rid, n)
        return alloc.alloc(rid, n)

    def dep(prompt, pages):
        log.append(("deposit", idx.deposit(
            prompt, pages, tail_k=None, tail_v=None, go=None, logits=None,
            sig=len(prompt))))

    a = list(range(10))                       # 2 full pages + 2 tail
    b = a[:4] + [20, 21, 22, 23, 24]          # a's leading page tokens
    c = list(range(30, 38))
    pa = owner(1, 3)
    dep(a, pa)
    dep(a, pa)                                # a repeat: no new entry
    pb = owner(2, 3)
    dep(b, pb)                                # another page: private node
    log.append(("prefix", idx.lookup_prefix(b), idx.lookup_prefix(a + [9])))
    pb2 = [pa[0]] + owner(3, 2)
    alloc.share(3, [pa[0]])
    dep(b[:8], pb2)                           # chains through a's node
    log.append(("full", idx.entry_pages(idx.lookup_full(a)),
                idx.lookup_full(c), len(idx)))
    log.append(("free", alloc.free(1), alloc.free(2)))
    dep(c, owner(4, 2))                       # evicts the LRU entry
    log.append(("reclaim", idx.reclaim_one(), len(idx)))
    log.append(("nodes", sorted(idx.node_pages()), alloc.refcounts()))
    log.append(("flush", idx.flush(), idx.reclaim_one()))
    log.append(("free", alloc.free(3), alloc.free(4), alloc.pages_in_use))
    log.append((idx.deposits, idx.evictions, idx.node_rid(4)))
    alloc.check()
    return log


def test_prefix_index_matches_reference_on_a_scripted_sequence():
    assert _index_run(TP) == _index_run(JP)


# -------------------------------------------------- expert-aware scheduler

def _aware_run(mod, script, num_experts, max_skips, window):
    """Drive an ExpertAwareScheduler: ("submit", rid, sig bits, prio),
    ("active", sig bits list), ("observe", sig bits), ("admit", busy,
    blocked rid or -1). Logs admissions, last_blocked, scores, EWMA loads
    and victim bonuses."""
    if mod is TS:                 # the port's knobs are class constants
        sch = mod.ExpertAwareScheduler(3, 64, num_experts=num_experts)
        sch.MAX_SKIPS, sch.WINDOW = max_skips, window
    else:
        sch = mod.ExpertAwareScheduler(3, 64, num_experts=num_experts,
                                       max_skips=max_skips, window=window)

    def sig(bits):
        return None if bits is None else np.array(
            [(bits >> e) & 1 for e in range(num_experts)], bool)

    log, active = [], []
    for op in script:
        if op[0] == "submit":
            _, rid, bits, prio = op
            r = mod.Request(request_id=rid, prompt=np.zeros(4, np.int32),
                            max_new_tokens=4, priority=prio,
                            expert_sig=sig(bits))
            sch.submit(r)
            log.append(round(sch.score(r), 12))
        elif op[0] == "active":
            active = [sig(b) for b in op[1]]
            sch.note_active(active)
        elif op[0] == "observe":
            sch.observe(sig(op[1]))
            log.append(sch.load.round(12).tolist())
        else:
            _, busy, blocked = op
            r = sch.next_admission(
                busy, can_admit=lambda q: q.request_id != blocked)
            lb = sch.last_blocked
            log.append((None if r is None else r.request_id,
                        None if lb is None else lb.request_id,
                        [e[2].times_skipped for e in sorted(sch.queue)]))
            if r is not None:
                log.append(sch.victim_bonus(r.expert_sig, active))
    return log


AWARE_SCRIPT = [
    ("submit", 0, 0b0011, 0), ("submit", 1, 0b1100, 0),
    ("submit", 2, None, 0), ("submit", 3, 0b0110, 1),
    ("active", [0b1100]), ("admit", 0, -1), ("admit", 1, 0),
    ("observe", 0b0011), ("observe", None), ("submit", 4, 0b1000, 0),
    ("admit", 1, -1), ("admit", 3, -1), ("active", []), ("admit", 0, -1),
    ("admit", 0, 3), ("admit", 0, -1), ("admit", 0, -1)]


def test_expert_aware_scheduler_matches_reference_on_a_script():
    """Overlap, new experts, the load term, strict priority, a blocked
    choice remembered in last_blocked, the slot cap, FIFO among None
    signatures."""
    assert _aware_run(TS, AWARE_SCRIPT, 4, 2, 8) == \
        _aware_run(JS, AWARE_SCRIPT, 4, 2, 8)


@settings(derandomize=True, database=None, max_examples=40, deadline=None)
@given(ops=st.lists(st.one_of(
    st.tuples(st.just("submit"), st.integers(0, 30),
              st.one_of(st.none(), st.integers(0, 63)), st.integers(0, 2)),
    st.tuples(st.just("active"), st.lists(st.one_of(
        st.none(), st.integers(0, 63)), max_size=3)),
    st.tuples(st.just("observe"), st.one_of(st.none(), st.integers(0, 63))),
    st.tuples(st.just("admit"), st.integers(0, 3), st.integers(-1, 30))),
    max_size=40),
    max_skips=st.integers(1, 4), window=st.integers(1, 8))
def test_expert_aware_scheduler_matches_reference_on_random_sequences(
        ops, max_skips, window):
    seen, script = set(), []
    for op in ops:                        # request ids are unique
        if op[0] == "submit":
            if op[1] in seen:
                continue
            seen.add(op[1])
        script.append(op)
    assert _aware_run(TS, script, 6, max_skips, window) == \
        _aware_run(JS, script, 6, max_skips, window)
