"""Host-side page allocator and prefix index for the paged KV pool.

A copy of the reference package's allocator and prefix index
(repro/serving/paging.py `PageAllocator`, `pages_for_tokens`,
`PrefixIndex`): reservations, lazy growth, refcounted copy-on-write
sharing (`share`, `fork`), the deferred scrub marks of the NaN quarantine,
and the page-aligned radix index over prompts that lets a repeated prompt
map its donor's pages. Pure host bookkeeping (no torch): the engine calls
it at admission, growth and retirement and mirrors the resulting block
tables into the device state. The index holds the entries' device tensors
(tail KV, GO rows, logits) without reading them.

Page 0 is the reserved NULL page: it backs every unallocated block-table
entry and absorbs the decode-step writes of retired slots, so its contents
are trash by design and it is never handed out.

Deadlock freedom comes from RESERVATIONS: admission reserves a request's
worst-case page count (ceil((prompt + max_new) / page_size)) up front,
while physical pages are handed out lazily (`grow` as the sequence crosses
page boundaries). A reserved-but-unused page cannot be promised twice, so
an admitted request can always grow to its declared maximum, and
`can_reserve` is the scheduler's "pages available?" question.

SHARING: several owners may map the SAME physical page (`share`: a request
admitted from the prefix index, and the index's own node pins, which keep
a retired donor's pages alive). A shared page counts as owned by each
sharer but takes nothing from the free list; `free` releases a page only
when its last reference drops. A divergent write goes through `fork`: the
writer swaps its reference for a fresh private page (the caller copies
the contents). A scrub mark fires on the page's LAST free, so a
quarantined request never zeroes a page someone else still reads.
"""
from __future__ import annotations

import itertools
from collections import Counter, OrderedDict


class PageAllocator:
    """Fixed-pool free-list allocator with worst-case reservations and
    refcounted (copy-on-write) page sharing."""

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
        """Pages promised to admitted requests but not yet handed out.
        Shared pages count as handed out: a sharer's remaining free-list
        demand is its worst case minus everything it already maps."""
        return sum(max(0, n - len(self._owned.get(r, ())))
                   for r, n in self._reserved.items())

    def can_reserve(self, n: int) -> bool:
        """Would a new request needing `n` pages at worst still be admissible
        without ever deadlocking the in-flight ones?"""
        return n <= len(self._free) - self._outstanding()

    # -------------------------------------------------------------- lifecycle

    def reserve(self, rid: int, n: int) -> None:
        """Promise `rid` up to `n` pages total. Re-reserving keeps the larger
        promise; pages `rid` already maps, shared prefix pages included
        (`share` before `reserve`), count as held."""
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

    def share(self, rid: int, pages: list[int]) -> None:
        """Map already-allocated `pages` into `rid` copy-on-write: each
        page's refcount rises by one and `rid` owns it like any other page,
        but nothing leaves the free list. The sharer must never write a
        shared page (fork first); the engine's consumers write only past
        the shared full-page prefix."""
        owned = self._owned.setdefault(rid, [])
        for p in pages:
            p = int(p)
            if self._refcnt.get(p, 0) < 1:
                raise RuntimeError(
                    f"request {rid} cannot share unallocated page {p}")
            if p in owned:
                raise RuntimeError(
                    f"request {rid} already maps page {p}")
            self._refcnt[p] += 1
            owned.append(p)

    def fork(self, rid: int, page: int) -> int:
        """Copy-on-write fork: swap `rid`'s reference to SHARED `page` for a
        fresh private page and return it (the caller copies the contents
        before diverging). The fork draws from the free list outside the
        reservation accounting, so it can fail under pressure; only a
        divergent writer (the chaos poison) needs it."""
        owned = self._owned.get(rid)
        if owned is None or page not in owned:
            raise KeyError(f"request {rid} does not map page {page}")
        if self._refcnt.get(page, 0) < 2:
            raise RuntimeError(
                f"page {page} is not shared — fork would leak its twin")
        if not self._free:
            raise RuntimeError("page pool exhausted on fork")
        new = self._free.pop()
        self._refcnt[new] = 1
        owned[owned.index(page)] = new
        self._refcnt[page] -= 1
        return new

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
        allocated, never both; an allocated page's refcount equals the
        number of owners mapping it; none leaks; scrub marks sit only on
        live pages; page 0 is never used."""
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
            assert self._refcnt.get(p) == n, \
                f"page {p}: refcount {self._refcnt.get(p)} != {n} owners"
        assert set(self._refcnt) == set(owners), "refcount on unowned page"
        assert len(free_set) + len(owners) == self.num_pages - 1, \
            f"leaked {self.num_pages - 1 - len(free_set) - len(owners)} pages"
        assert self._dirty <= set(owners), \
            "scrub mark on a released page (scrub must fire ON last free)"


def pages_for_tokens(num_tokens: int, page_size: int) -> int:
    return -(-num_tokens // page_size)


class PrefixIndex:
    """Page-aligned radix index over prompt tokens: maps prompt prefixes to
    the PHYSICAL pages already holding their KV, plus the per-prompt prefill
    artifacts a zero-compute admission needs.

    One radix NODE per full page of prompt tokens, keyed by (parent node,
    that page's token tuple), so walking a new prompt's leading pages gives
    the longest page-aligned shared prefix in O(pages). Each node pins one
    physical page through the allocator's refcounts under a synthetic owner
    id (negative, so it never collides with a request id); donors may
    retire freely, the node keeps the page alive.

    A node is REUSED by a later deposit only when its pinned page IS the
    depositor's page for those positions (same physical page, same bytes).
    Same tokens on a DIFFERENT page means the two prompts prefilled those
    positions independently, and under MoE's whole-sequence routing their
    KV differs even though the tokens match: the depositor pins its own
    page under a PRIVATE node (key None, unreachable from `_walk`), so its
    full-prompt entry chains its own bytes and an exact-match hit stays
    bit-exact.

    A full-prompt ENTRY (deposited at admission, LRU-bounded by `CAPACITY`)
    also carries what page sharing alone cannot give:

      tail KV   the prompt positions past the last full page (they live in
                the donor's private page, which its decode writes into);
      GO rows   the expert-choice GO cache after prefill: TopKUpdate
                history, not recomputable from the shared pages;
      logits    the prefill logits, so the consumer's first token (greedy
                or sampled under its own temperature and seed) needs no
                forward.

    The engine hands these in as device tensors it cloned; the index only
    holds them. Page release flows back through the pool so scrub marks
    are honoured: every mutating method returns the physical pages it
    RELEASED for that reason."""

    CAPACITY = 32   # full-prompt entries kept (LRU)

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = page_size
        self._ids = itertools.count()
        self._children: dict[tuple, int] = {}   # (parent, tokens) -> node id
        self._nodes: dict[int, dict] = {}       # id -> {page, key, uses}
        self._entries: OrderedDict[tuple, dict] = OrderedDict()
        self.deposits = 0
        self.evictions = 0

    @staticmethod
    def node_rid(node_id: int) -> int:
        """Synthetic allocator owner id of a node's page pin (negative,
        disjoint from every request id)."""
        return -(node_id + 1)

    def __len__(self) -> int:
        return len(self._entries)

    def node_pages(self) -> list[int]:
        """Physical pages pinned by the index (one per node); the engine's
        audit counts them as live references."""
        return [n["page"] for n in self._nodes.values()]

    def _walk(self, prompt) -> list[int]:
        """Node chain matching the prompt's leading FULL pages."""
        ps = self.page_size
        chain, parent = [], -1
        for i in range(len(prompt) // ps):
            key = (parent, tuple(int(t) for t in prompt[i * ps:(i + 1) * ps]))
            nid = self._children.get(key)
            if nid is None:
                break
            chain.append(nid)
            parent = nid
        return chain

    # ----------------------------------------------------------------- lookup

    def lookup_full(self, prompt) -> dict | None:
        """Exact full-prompt entry (zero-prefill admission) or None; a hit
        becomes the most recently used entry."""
        key = tuple(int(t) for t in prompt)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def entry_pages(self, entry: dict) -> list[int]:
        return [self._nodes[n]["page"] for n in entry["nodes"]]

    def lookup_prefix(self, prompt) -> list[int]:
        """Physical pages backing the longest page-aligned prefix of
        `prompt` present in the index (possibly empty)."""
        return [self._nodes[n]["page"] for n in self._walk(prompt)]

    # ---------------------------------------------------------------- deposit

    def deposit(self, prompt, page_ids, *, tail_k, tail_v, go, logits,
                sig=None, tail_ks=None, tail_vs=None,
                go_scales=None) -> list[int]:
        """Record an admitted prompt: pin its full pages as radix nodes
        (sharing the donor's physical `page_ids`; no data moves) and keep
        the tail KV, GO rows and logits under the full-prompt key. Returns
        the pages RELEASED by a capacity eviction (the caller scrubs them)."""
        key = tuple(int(t) for t in prompt)
        if key in self._entries:
            self._entries.move_to_end(key)
            return []
        ps = self.page_size
        n_full = len(key) // ps
        if len(page_ids) < n_full:
            raise ValueError("deposit needs the prompt's full-page ids")
        parent, chain = -1, []
        for i in range(n_full):
            ck = (parent, key[i * ps:(i + 1) * ps])
            nid = self._children.get(ck)
            if nid is not None and \
                    self._nodes[nid]["page"] != int(page_ids[i]):
                # same tokens, another physical page: the node pins another
                # prompt's prefill of these positions; pin the depositor's
                # own page under a private node instead
                nid, ck = None, None
            if nid is None:
                nid = next(self._ids)
                self.alloc.share(self.node_rid(nid), [int(page_ids[i])])
                if ck is not None:
                    self._children[ck] = nid
                self._nodes[nid] = {"page": int(page_ids[i]), "key": ck,
                                    "uses": 0}
            chain.append(nid)
            parent = nid
        for nid in chain:
            self._nodes[nid]["uses"] += 1
        self._entries[key] = {
            "nodes": chain, "tail_k": tail_k, "tail_v": tail_v,
            "go": go, "logits": logits, "sig": sig, "prompt_len": len(key),
            # int8 pools: the tail page's scales and the GO row scales
            # (None on full-precision pages)
            "tail_ks": tail_ks, "tail_vs": tail_vs, "go_scales": go_scales,
        }
        self.deposits += 1
        released: list[int] = []
        while len(self._entries) > self.CAPACITY:
            released += self._evict_one()
        return released

    def _evict_one(self) -> list[int]:
        """Drop the least recently used entry; release the pages of nodes no
        surviving entry walks through (a chain references every ancestor,
        so uses == 0 implies no live descendants either)."""
        _, entry = self._entries.popitem(last=False)
        self.evictions += 1
        released: list[int] = []
        for nid in reversed(entry["nodes"]):
            node = self._nodes[nid]
            node["uses"] -= 1
            if node["uses"] == 0:
                if node["key"] is not None:     # private nodes never registered
                    del self._children[node["key"]]
                del self._nodes[nid]
                released += self.alloc.free(self.node_rid(nid))
        return released

    def reclaim_one(self) -> list[int]:
        """Page-pressure hook: drop the LRU entry on demand (the engine
        calls it when a blocked admission could use the pinned pages: cache
        pins are opportunistic, a stalled request is not). Returns the
        released pages for scrubbing."""
        return self._evict_one() if self._entries else []

    def flush(self) -> list[int]:
        """Drop every entry and node, releasing all pinned pages (the engine
        flushes on drain, so a fully retired pool holds zero pages).
        Returns the released pages for scrubbing."""
        released: list[int] = []
        while self._entries:
            released += self._evict_one()
        assert not self._nodes and not self._children, \
            "prefix index leaked nodes past its entries"
        return released
