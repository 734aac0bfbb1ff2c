"""Host-side page allocator for the paged KV pool.

A copy of the reference package's allocator (repro/serving/paging.py
`PageAllocator`, `pages_for_tokens`), cut to private pages: page refcounts
(each 1 until prefix sharing brings `share` and `fork`) and the deferred
scrub marks of the NaN quarantine, no prefix index. Pure host bookkeeping
(no torch): the engine calls it at admission, growth and retirement and
mirrors the resulting block tables into the device state.

Page 0 is the reserved NULL page: it backs every unallocated block-table
entry and absorbs the decode-step writes of retired slots, so its contents
are trash by design and it is never handed out.

Deadlock freedom comes from RESERVATIONS: admission reserves a request's
worst-case page count (ceil((prompt + max_new) / page_size)) up front,
while physical pages are handed out lazily (`grow` as the sequence crosses
page boundaries). A reserved-but-unused page cannot be promised twice, so
an admitted request can always grow to its declared maximum, and
`can_reserve` is the scheduler's "pages available?" question.
"""
from __future__ import annotations

from collections import Counter


class PageAllocator:
    """Fixed-pool free-list allocator with worst-case reservations."""

    def __init__(self, num_pages: int, page_size: int,
                 max_tokens: int | None = None):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if max_tokens is not None and max_tokens % page_size:
            raise ValueError(
                f"max_tokens={max_tokens} is not a multiple of "
                f"page_size={page_size}: the worst-case page reservation "
                "would miscount the last partial page")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list (page 1 handed out first); page 0 never enters it
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}     # request id -> pages held
        self._reserved: dict[int, int] = {}        # request id -> max pages
        self._refcnt: dict[int, int] = {}          # page -> live references
        self._dirty: set[int] = set()              # scrub due at last free

    # ---------------------------------------------------------------- queries

    @property
    def free_pages(self) -> int:
        """Physically unallocated pages (ignores reservations)."""
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def owned(self, rid: int) -> list[int]:
        return list(self._owned.get(rid, ()))

    def refcount(self, page: int) -> int:
        return self._refcnt.get(page, 0)

    def refcounts(self) -> dict[int, int]:
        """Copy of the page -> reference-count map (the engine's audit
        cross-checks it against the live block-table references)."""
        return dict(self._refcnt)

    def _outstanding(self) -> int:
        """Pages promised to admitted requests but not yet handed out."""
        return sum(max(0, n - len(self._owned.get(r, ())))
                   for r, n in self._reserved.items())

    def can_reserve(self, n: int) -> bool:
        """Would a new request needing `n` pages at worst still be admissible
        without ever deadlocking the in-flight ones?"""
        return n <= len(self._free) - self._outstanding()

    # -------------------------------------------------------------- lifecycle

    def reserve(self, rid: int, n: int) -> None:
        """Promise `rid` up to `n` pages total. Re-reserving keeps the larger
        promise; pages `rid` already holds count as held."""
        have = max(self._reserved.get(rid, 0), len(self._owned.get(rid, ())))
        if n > have and not self.can_reserve(n - have):
            raise RuntimeError(
                f"page pool over-committed: request {rid} wants {n} pages, "
                f"{len(self._free)} free / {self._outstanding()} promised")
        self._reserved[rid] = max(n, self._reserved.get(rid, 0))
        self._owned.setdefault(rid, [])

    def alloc(self, rid: int, n: int) -> list[int]:
        """Hand `rid` `n` physical pages (admission: the pages covering the
        prompt and the first decode write), capped by its reservation."""
        have = len(self._owned.get(rid, ()))
        if have + n > self._reserved.get(rid, 0):
            raise RuntimeError(
                f"request {rid} asked {n} pages over a reservation of "
                f"{self._reserved.get(rid, 0)} (holds {have}) — reserve "
                "before allocating")
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: request {rid} asked {n}, "
                f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcnt[p] = 1
        self._owned.setdefault(rid, []).extend(pages)
        return pages

    def can_grow(self, rid: int) -> bool:
        return rid in self._owned and \
            len(self._owned[rid]) < self._reserved.get(rid, 0)

    def grow(self, rid: int) -> int:
        """Hand `rid` one more page (decode crossed a page boundary). The
        reservation cap is enforced, which is what makes in-reservation
        growth infallible."""
        if rid not in self._owned:
            raise KeyError(f"request {rid} owns no pages")
        if len(self._owned[rid]) >= self._reserved.get(rid, 0):
            raise RuntimeError(
                f"request {rid} is at its reservation cap "
                f"({self._reserved.get(rid, 0)} pages) — growing past it "
                "would steal pages promised to other requests")
        if not self._free:
            raise RuntimeError("page pool exhausted on grow — admission "
                               "reservations make this unreachable")
        page = self._free.pop()
        self._refcnt[page] = 1
        self._owned[rid].append(page)
        return page

    def free(self, rid: int) -> list[int]:
        """Retirement: drop every reference `rid` holds and its reservation.
        Returns the pages actually RELEASED (those whose last reference
        this was). Callers owning device state route them through
        `pop_dirty` and zero the marked ones (deferred NaN scrub)."""
        pages = self._owned.pop(rid, [])
        self._reserved.pop(rid, None)
        released = []
        for p in pages:
            self._refcnt[p] -= 1
            if self._refcnt[p] == 0:
                del self._refcnt[p]
                released.append(p)
        self._free.extend(reversed(released))
        return released

    # ------------------------------------------------------- deferred scrub

    def mark_scrub(self, rid: int) -> None:
        """Flag every page `rid` maps for a zero-on-last-free scrub (the NaN
        quarantine): a page is zeroed when its LAST reference drops, never
        while someone may still read it."""
        self._dirty.update(self._owned.get(rid, ()))

    def pop_dirty(self, pages: list[int]) -> list[int]:
        """Consume the scrub marks among just-released `pages`; the caller
        zeroes exactly these on the device. Marks on live pages stay."""
        out = [p for p in pages if p in self._dirty]
        self._dirty.difference_update(out)
        return out

    # ------------------------------------------------------------- invariants

    def check(self) -> None:
        """Internal-consistency assertions: every page is either free or
        owned by exactly one request, an owned page's refcount equals its
        owners, none leaks, scrub marks sit only on live pages, page 0 is
        never used."""
        owners: Counter[int] = Counter()
        for rid, pages in self._owned.items():
            assert len(set(pages)) == len(pages), \
                f"request {rid} maps a page twice"
            owners.update(pages)
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "free list holds duplicates"
        for p in free_set:
            assert 0 < p < self.num_pages, f"bad page id {p}"
            assert p not in owners, f"page {p} both free and owned"
            assert p not in self._refcnt, f"freed page {p} keeps a refcount"
        for p, n in owners.items():
            assert 0 < p < self.num_pages, f"bad page id {p}"
            assert n == 1, f"page {p} owned by {n} requests"
            assert self._refcnt.get(p) == n, \
                f"page {p}: refcount {self._refcnt.get(p)} != {n} owners"
        assert set(self._refcnt) == set(owners), "refcount on unowned page"
        assert len(free_set) + len(owners) == self.num_pages - 1, \
            f"leaked {self.num_pages - 1 - len(free_set) - len(owners)} pages"
        assert self._dirty <= set(owners), \
            "scrub mark on a released page (scrub must fire ON last free)"


def pages_for_tokens(num_tokens: int, page_size: int) -> int:
    return -(-num_tokens // page_size)
