"""The port's host-side copies (serving/paging.py `PageAllocator`,
`pages_for_tokens`; serving/scheduler.py `FIFOScheduler`, `Request`)
against the reference package's, driven by the same operations. Every
integer result (page ids, counts, admission order, raised error types)
must be equal.
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
        got.check()
        ref.check()


SCRIPT = [("reserve", 0, 3), ("alloc", 0, 2), ("reserve", 1, 6),
          ("can_reserve", 0, 2), ("reserve", 2, 4), ("alloc", 1, 4),
          ("grow", 0, 0), ("grow", 0, 0), ("alloc", 2, 1), ("grow", 1, 0),
          ("free", 0, 0), ("can_reserve", 0, 4), ("reserve", 2, 4),
          ("alloc", 2, 3), ("grow", 2, 0), ("grow", 3, 0), ("free", 1, 0),
          ("reserve", 3, 5), ("alloc", 3, 5), ("can_grow", 3, 0),
          ("free", 2, 0), ("free", 3, 0), ("free", 3, 0)]


def test_allocator_matches_reference_on_a_scripted_sequence():
    """Reservations, lazy growth, over-reservation and over-growth errors,
    LIFO reuse of freed pages."""
    _run_both(SCRIPT, num_pages=11, page_size=4)


@settings(derandomize=True, database=None, max_examples=40, deadline=None)
@given(ops=st.lists(st.tuples(
    st.sampled_from(["reserve", "alloc", "grow", "free", "can_reserve",
                     "can_grow"]),
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
