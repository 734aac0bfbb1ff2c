"""Slot pool: owns the pooled per-request KV (+ GO) decode state.

Counterpart of repro/serving/pool.py (`SlotPool`): dense and paged pools,
int8 pages (cfg.kv_quant="int8"), admission, lazy page growth,
retirement with the NaN scrub, preemption snapshots and their restore,
admission from a prefix-index entry, the chaos poison (with the
copy-on-write fork of a shared page) and the invariant audit (no mesh).

One decode state of `num_slots` batch rows lives on the device for the
engine's whole life; requests are admitted into free rows and retired out
of them without reshaping anything. Per-slot positions (`state["t"]`, an
int32 tensor [num_slots]) let rows sit at different sequence offsets.
Host-side metadata (which request owns which row, its next input token,
how many tokens it still owes, its next decode position, its temperature
and top_p) stays in numpy, beside each sampling row's CPU
`torch.Generator`.

PAGED mode (`paged=True`) replaces the dense per-slot KV rows with a
shared page pool (`k_pages`/`v_pages` [L, num_pages, page_size, Hkv, hd])
and a per-slot block table of physical page ids (0 = the null page). The
host `PageAllocator` reserves each request's worst-case page count at
admission and hands pages out lazily: `grow_active()` assigns one page as
a slot's sequence crosses a page boundary, right before the decode tick
that writes it. GO rows (expert choice only) stay slot-resident
([E, k]-shaped, not sequence-shaped).

INT8 mode (cfg.kv_quant="int8", paged pools only, page_size a multiple of
8) stores the pages and GO rows as int8 with f32 scales (core/quant.py).
Every released page returns with zeroed scales, so a reused page
quantizes exactly as a fresh one; `dequant_max_abs_err` keeps the largest
round-trip error of the admitted prefills' splats.

SNAPSHOTS (paged pools): `snapshot(slot)` copies a slot's live pages (one
`index_select` a tensor and one device-to-host copy), their int8 scales,
its GO rows and scales, its cursor and its sampling state (the request's
CPU generator itself, which moves with it) into CPU tensors of the pool's
own dtypes, so bf16 pages round-trip bit for bit. `restore` writes them
into freshly allocated pages with `index_copy_` and rebuilds the slot's
block table: a resumed stream equals one that was never evicted.

PREFIX SHARING (`admit_from_prefix`): a request whose prompt equals an
indexed one maps the donor's full pages copy-on-write, takes the tail
positions past the last full page into its first fresh page, and restores
the entry's GO rows; it writes only its fresh pages from then on, so no
shared page is ever written. The one divergent writer, the chaos poison,
forks a shared page first.

Unlike the JAX pool, which threads a new state through jitted functions,
this one writes the device tensors IN PLACE. The one exception is the
block table: the host mirror is the truth, and a dirty mirror is pushed as
a NEW device tensor made from a copy of it, so no host buffer the card may
still be reading is ever written.

THE JOURNAL'S FORM (`to_host_payload`, `from_host_payload`): the engine's
snapshots (live slots, parked preemption snapshots, prefix-index entries)
go to disk as numpy arrays and Python scalars only, so a journal is
independent of the torch build and the device. numpy has no bf16, so a
bf16 tensor is kept as its bits (an int16 view) beside its dtype's name;
a sampling generator as its `get_state()` bytes. Both round-trip bit for
bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.models.model import (init_decode_slot, init_decode_state,
                                      paged_supported, write_decode_slot)
from repro_torch.serving.paging import PageAllocator, pages_for_tokens
from repro_torch.serving.scheduler import Request

# tags of the journal's form of a tensor and of a generator
_TENSOR = "__torch_dtype__"
_GENERATOR = "__generator_state__"


def to_host_payload(tree):
    """The journal's form of a snapshot tree (dicts, lists, tuples): every
    tensor becomes a numpy array tagged with its dtype's name (a bf16
    tensor its int16 bits), every `torch.Generator` its state as uint8;
    everything else passes through."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return {_TENSOR: name, "data": t.cpu().numpy()}
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: tree.get_state().numpy()}
    if isinstance(tree, dict):
        return {k: to_host_payload(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host_payload(v) for v in tree)
    return tree


def from_host_payload(tree, device="cpu"):
    """Inverse of `to_host_payload`: tagged arrays become tensors of their
    dtype on `device`, generator states CPU generators."""
    if isinstance(tree, dict):
        if _TENSOR in tree:
            t = torch.from_numpy(np.array(tree["data"]))
            if tree[_TENSOR] == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(device)
        if _GENERATOR in tree:
            gen = torch.Generator()
            gen.set_state(torch.from_numpy(np.array(tree[_GENERATOR])))
            return gen
        return {k: from_host_payload(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_host_payload(v, device) for v in tree)
    return tree


class SlotPool:
    """Fixed-width pool of per-request decode-cache rows."""

    def __init__(self, cfg, num_slots: int, max_tokens: int, device, *,
                 paged: bool = False, page_size: int = 16,
                 num_pages: int | None = None):
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_tokens = max_tokens
        self.device = torch.device(device)
        self.paged = bool(paged)
        self.page_size = page_size
        self.num_pages = None
        Q.validate_kv_quant(cfg.kv_quant)
        self.quant = cfg.kv_quant != "none"
        self.dequant_max_abs_err = 0.0
        if self.quant and not self.paged:
            # quantized decode state is page-granular by construction:
            # there is no per-page scale to hang off a dense KV row
            raise ValueError(
                f"kv_quant={cfg.kv_quant!r} requires a paged pool (scale "
                "granularity IS page granularity): pass paged=True or "
                "kv_quant='none'")
        if self.paged:
            if not paged_supported(cfg):
                raise ValueError("paged pool is attention-family only "
                                 f"(block={cfg.block!r})")
            if max_tokens % page_size:
                raise ValueError(f"max_tokens={max_tokens} must be a "
                                 f"multiple of page_size={page_size}")
            if self.quant and page_size % 8:
                raise ValueError(
                    f"kv_quant={cfg.kv_quant!r} needs page_size divisible "
                    f"by 8 (the reference's int8 page granule); got "
                    f"page_size={page_size}")
            # default: the dense pool's token capacity plus the null page; a
            # smaller num_pages stands for a tighter memory budget
            if num_pages is None:
                num_pages = num_slots * (max_tokens // page_size) + 1
            self.num_pages = num_pages
            self.alloc = PageAllocator(num_pages, page_size,
                                       max_tokens=max_tokens)
            # host mirror of the device block tables ([B, P] int32)
            self.block_table = np.zeros(
                (num_slots, max_tokens // page_size), np.int32)
            self._bt_dirty = False
        self.state = init_decode_state(
            cfg, num_slots, max_tokens, self.device, per_slot_t=True,
            paged=(num_pages, page_size) if self.paged else None)
        # host-side slot metadata
        self.owner: list[Request | None] = [None] * num_slots
        self.pending = np.zeros(num_slots, np.int32)    # next input token
        self.remaining = np.zeros(num_slots, np.int64)  # tokens still owed
        self.t_host = np.zeros(num_slots, np.int64)     # next decode position
        # sampling: a row with temperature > 0 samples (top-p) from one
        # uniform a token, drawn from its request's CPU generator
        self.temps = np.zeros(num_slots, np.float32)
        self.top_ps = np.ones(num_slots, np.float32)
        self.generators: list[torch.Generator | None] = [None] * num_slots
        self.admitted_total = 0

    # ---------------------------------------------------------------- queries

    def free_slots(self) -> list[int]:
        return [i for i, o in enumerate(self.owner) if o is None]

    def num_active(self) -> int:
        return self.num_slots - len(self.free_slots())

    def any_active(self) -> bool:
        return any(o is not None for o in self.owner)

    def active_mask(self) -> np.ndarray:
        return np.array([o is not None for o in self.owner], bool)

    def pages_needed(self, req: Request) -> int:
        """Worst-case page count: every position the request may ever
        write (prompt + full generation)."""
        return pages_for_tokens(req.prompt_len + req.max_new_tokens,
                                self.page_size)

    def can_admit(self, req: Request) -> bool:
        """The admission gate: a dense pool needs only the free slot the
        engine already found; a paged pool also needs the request's
        worst-case page count to be reservable."""
        return (not self.paged) or self.alloc.can_reserve(
            self.pages_needed(req))

    # -------------------------------------------------------------- lifecycle

    def reserve_pages(self, req: Request) -> None:
        """Reserve a request's worst-case pages ahead of admission (a
        chunked prefill claims its budget when its run STARTS, so decode
        growth can never strand a half-prefilled prompt)."""
        if self.paged:
            self.alloc.reserve(req.request_id, self.pages_needed(req))

    def _first_pages(self, req: Request) -> np.ndarray:
        """Reserve the worst case and allocate the pages covering the prompt
        and the first decode write; returns the full block-table row."""
        self.reserve_pages(req)
        n0 = pages_for_tokens(req.prompt_len + 1, self.page_size)
        row = np.zeros(self.block_table.shape[1], np.int32)
        row[:n0] = self.alloc.alloc(req.request_id, n0)
        return row

    def claim_chunk_pages(self, req: Request) -> np.ndarray:
        """Chunk-run page claim: the request's worst case is reserved and
        its first pages allocated up front, so every prefill chunk scatters
        straight into the pool's pages. Returns the request's block-table
        row (pass it back through `admit(page_row=)` when the run ends)."""
        if not self.paged:
            raise ValueError("chunk-run page claims are paged-pool only")
        return self._first_pages(req)

    def admit(self, slot: int, req: Request, slot_state: dict,
              first_token: int, *, page_row=None,
              generator: torch.Generator | None = None) -> None:
        """Install a prefilled request into a free row: write its KV (and GO)
        entries and its position in place, and arm its first decode input
        and its sampling (temperature, top_p and `generator`, the request's
        uniforms, already advanced past its first token's draw).
        A paged pool allocates the pages covering the prompt and the first
        decode write here (later pages come through grow_active); a chunked
        run that already claimed its pages passes its row as `page_row`,
        and its KV already sits in the pool's pages. A bucketed prefill's
        state is max_tokens long like any other: its pad rows land in the
        request's own pages past its prompt (or on the null page), and
        decode overwrites each before anything attends to it."""
        if self.owner[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied")
        if self.paged:
            row = (self._first_pages(req) if page_row is None
                   else np.asarray(page_row, np.int32))
            self.block_table[slot] = row
            write_decode_slot(self.state, slot, slot_state,
                              torch.from_numpy(row.copy()))
            if self.quant:
                self._note_dequant_err(slot_state)
        else:
            write_decode_slot(self.state, slot, slot_state)
        self._arm(slot, req, first_token, generator)

    def admit_from_prefix(self, slot: int, req: Request, shared,
                          entry: dict, first_token: int, *,
                          generator: torch.Generator | None = None) -> None:
        """Zero-prefill admission from a full-prompt prefix-index entry, by
        block-table surgery as in `restore`: the prompt's full pages map the
        donor's physical pages copy-on-write (`shared`; nothing moves), the
        tail positions past the last full page are copied from the entry's
        device clone into the request's FIRST fresh page (with its scales
        on an int8 pool: the consumer grows that page under the donor's
        scale), the GO rows (and scales) from the entry's clone, and the
        first decode input and sampling are armed as `admit` arms them.
        The request writes only its fresh pages from here on."""
        if not self.paged:
            raise ValueError("prefix sharing is paged-pool only")
        if self.owner[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied")
        rid = req.request_id
        shared = [int(p) for p in shared]
        n_sh = len(shared)
        self.alloc.share(rid, shared)
        self.reserve_pages(req)
        n0 = pages_for_tokens(req.prompt_len + 1, self.page_size)
        fresh = self.alloc.alloc(rid, n0 - n_sh)
        row = np.zeros(self.block_table.shape[1], np.int32)
        row[:n_sh] = shared
        row[n_sh:n0] = fresh
        self.block_table[slot] = row
        st = self.state
        tail = req.prompt_len - n_sh * self.page_size
        if tail:
            pid = int(fresh[0])
            st["k_pages"][:, pid, :tail] = entry["tail_k"]
            st["v_pages"][:, pid, :tail] = entry["tail_v"]
            if self.quant:
                st["k_scales"][:, pid] = entry["tail_ks"]
                st["v_scales"][:, pid] = entry["tail_vs"]
        st["t"][slot] = req.prompt_len
        if "go" in st:
            for a, r in zip(st["go"], entry["go"]):
                a[:, slot] = r
        if "go_scales" in st:
            st["go_scales"][:, slot] = entry["go_scales"]
        self._push_block_table()
        self._arm(slot, req, first_token, generator)

    def _arm(self, slot: int, req: Request, first_token: int,
             generator: torch.Generator | None) -> None:
        """Give `slot` to a newly admitted request: its first decode input,
        the tokens it still owes, its position and its sampling."""
        self.owner[slot] = req
        self.pending[slot] = first_token
        self.remaining[slot] = req.max_new_tokens - 1   # first token emitted
        self.t_host[slot] = req.prompt_len
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        self.generators[slot] = generator
        self.admitted_total += 1
        req.slot = slot

    def _note_dequant_err(self, slot_state: dict) -> None:
        """Keep the largest quantize->dequantize round-trip error of an
        admission's splat (engine stats()). Recomputes the splat's
        quantization, a pure function of the prefill values, so the audit
        needs no full-precision shadow pool."""
        for srck in ("k", "v"):
            if srck not in slot_state:
                continue
            src = slot_state[srck][:, 0].float()
            pages = src.reshape(src.shape[0], -1, self.page_size,
                                *src.shape[2:])
            err = pages - Q.dequantize_pages(*Q.quantize_pages(pages))
            self.dequant_max_abs_err = max(self.dequant_max_abs_err,
                                           float(err.abs().max()))
        go = slot_state.get("go")
        if go is not None:
            out = go.outputs.float()
            err = out - Q.dequantize_rows(*Q.quantize_rows(out))
            self.dequant_max_abs_err = max(self.dequant_max_abs_err,
                                           float(err.abs().max()))

    def grow_active(self) -> None:
        """Paged pools: make sure every active slot owns the page its NEXT
        decode write lands in (position t_host). Reservations guarantee the
        grow succeeds. Call once per engine tick, before the decode step;
        the block table reaches the device only when it changed."""
        if not self.paged:
            return
        for slot, req in enumerate(self.owner):
            if req is None:
                continue
            idx = int(self.t_host[slot]) // self.page_size
            if idx < self.block_table.shape[1] and \
                    self.block_table[slot, idx] == 0:
                self.block_table[slot, idx] = self.alloc.grow(req.request_id)
                self._bt_dirty = True
        if self._bt_dirty:
            self._push_block_table()

    def note_decoded(self) -> None:
        """Advance the host mirror of each active slot's position after a
        decode tick (keeps grow_active off the device)."""
        for slot, req in enumerate(self.owner):
            if req is not None:
                self.t_host[slot] += 1

    def _push_block_table(self) -> None:
        self.state["block_table"] = torch.from_numpy(
            self.block_table.copy()).to(self.device)
        self._bt_dirty = False

    def release_pages(self, rid: int) -> None:
        """Drop every page `rid` holds and its reservation (retirement,
        chunk cancellation), then scrub what was released."""
        if self.paged:
            self.scrub_released(self.alloc.free(rid))

    def scrub_released(self, released) -> None:
        """Clean just-released pages in place. An int8 pool zeroes the
        scales of EVERY released page: the rescale-on-write contract makes
        a page's contents a pure function of the tokens written to it only
        if it starts from scale 0 (the first write then rescales the stale
        int8 bytes by a factor of 0). Pages marked for scrub (a
        quarantined slot's) get their K and V zeroed too: 0 * NaN is NaN,
        so a poisoned page must be clean before another stream maps it.
        (On a card K3 and K4 never read a dead key, but the plain versions
        gather every page and mask afterwards.)"""
        if not self.paged or not released:
            return
        if self.quant:
            ids = torch.tensor(sorted(released), dtype=torch.long,
                               device=self.device)
            self.state["k_scales"][:, ids] = 0
            self.state["v_scales"][:, ids] = 0
        dirty = self.alloc.pop_dirty(released)
        if dirty:
            ids = torch.tensor(sorted(dirty), dtype=torch.long,
                               device=self.device)
            self.state["k_pages"][:, ids] = 0
            self.state["v_pages"][:, ids] = 0

    def retire(self, slot: int, *, scrub: bool = False) -> Request:
        """Free a row: reset its caches (block table to the null page, GO
        scores, if any, to -inf) and return the request. The row is
        reusable at once. The page CONTENTS normally stay: stale positions
        are masked, and masked finite values add exactly 0 to attention.
        `scrub=True` (a quarantine: the slot's state is non-finite) marks
        its pages to be zeroed on their last free."""
        req = self.owner[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} is already free")
        if self.paged:
            if scrub:
                self.alloc.mark_scrub(req.request_id)
            self.release_pages(req.request_id)
            self.block_table[slot] = 0
        init_decode_slot(self.state, slot)
        self.owner[slot] = None
        self.pending[slot] = 0
        self.remaining[slot] = 0
        self.t_host[slot] = 0
        self.temps[slot] = 0.0
        self.top_ps[slot] = 1.0
        self.generators[slot] = None
        return req

    # ------------------------------------------------------------- preemption

    def snapshot(self, slot: int, shared=frozenset()) -> dict:
        """Host-side eviction snapshot of an active PAGED slot: its live KV
        pages (and int8 scales), its GO rows (and scales), its cursor and
        its sampling state. Restoring it is bit-identical to never evicting
        (a re-prefill is not: prefill matmuls differ bitwise from decode
        ones, and a GO cache's decode-time rows are TopKUpdate history).
        Pages in `shared` (physical ids: the journal saves the pages that
        several holders map once, apart) are left out of the contents;
        `snap["shared"]` maps their row positions to those ids."""
        if not self.paged:
            raise ValueError("preemption snapshots are paged-pool only")
        req = self.owner[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} is free")
        row = self.block_table[slot]
        n = int((row != 0).sum())
        assert (row[:n] != 0).all(), "block table is not a contiguous prefix"
        own = [i for i in range(n) if int(row[i]) not in shared]
        ids = torch.from_numpy(row[own].astype(np.int64)).to(self.device)
        st = self.state

        def host(a):
            return a.to("cpu", copy=True)

        snap = {
            "t": int(self.t_host[slot]),
            "pending": int(self.pending[slot]),
            "remaining": int(self.remaining[slot]),
            "temp": float(self.temps[slot]),
            "top_p": float(self.top_ps[slot]),
            "generator": self.generators[slot],
            "n_pages": n,
            "shared": {i: int(row[i]) for i in range(n)
                       if int(row[i]) in shared},
            "k": host(st["k_pages"].index_select(1, ids)),
            "v": host(st["v_pages"].index_select(1, ids)),
        }
        if self.quant:
            snap["ks"] = host(st["k_scales"].index_select(1, ids))
            snap["vs"] = host(st["v_scales"].index_select(1, ids))
        if "go" in st:
            snap["go"] = tuple(host(a[:, slot]) for a in st["go"])
        if "go_scales" in st:
            snap["go_scales"] = host(st["go_scales"][:, slot])
        return snap

    def pages_for_resume(self, snap: dict) -> int:
        """Worst-case page count to finish a snapshotted stream: every
        position it has written plus every token it still owes."""
        return pages_for_tokens(snap["t"] + snap["remaining"], self.page_size)

    def can_resume(self, snap: dict) -> bool:
        return self.alloc.can_reserve(self.pages_for_resume(snap))

    def restore(self, slot: int, req: Request, snap: dict,
                page_map: dict[int, int] | None = None) -> None:
        """Re-admit a preempted request from its snapshot: reserve its
        remaining worst case, allocate fresh pages for the live prefix,
        write the snapshot into them in place, and rebuild the slot's block
        table, GO rows and cursor (block-table surgery, no recompute).
        The snapshot's `shared` positions map the pages `page_map` gives
        for their old ids copy-on-write, as `admit_from_prefix` maps a
        donor's (journal recovery restores those pages first)."""
        if not self.paged or self.owner[slot] is not None:
            raise RuntimeError(f"restore needs a free slot of a paged pool "
                               f"(slot {slot})")
        rid = req.request_id
        shared = {i: page_map[p] for i, p in snap["shared"].items()}
        self.alloc.share(rid, list(shared.values()))
        self.alloc.reserve(rid, self.pages_for_resume(snap))
        own = [i for i in range(snap["n_pages"]) if i not in shared]
        ids = self.alloc.alloc(rid, len(own))
        row = np.zeros(self.block_table.shape[1], np.int32)
        row[own] = ids
        row[list(shared)] = list(shared.values())
        self.block_table[slot] = row
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        st = self.state
        pairs = [("k_pages", "k"), ("v_pages", "v")]
        if self.quant:
            # int8 pages restore verbatim WITH their scales
            pairs += [("k_scales", "ks"), ("v_scales", "vs")]
        for key, sk in pairs:
            st[key].index_copy_(1, idx, snap[sk].to(self.device))
        st["t"][slot] = snap["t"]
        if "go" in st:
            for a, r in zip(st["go"], snap["go"]):
                a[:, slot].copy_(r)
        if "go_scales" in st:
            st["go_scales"][:, slot].copy_(snap["go_scales"])
        self._push_block_table()
        self.owner[slot] = req
        self.pending[slot] = snap["pending"]
        self.remaining[slot] = snap["remaining"]
        self.t_host[slot] = snap["t"]
        self.temps[slot] = snap["temp"]
        self.top_ps[slot] = snap["top_p"]
        self.generators[slot] = snap["generator"]
        self.admitted_total += 1
        req.slot = slot

    # -------------------------------------------------------- fault injection

    def poison_slot(self, slot: int) -> None:
        """Chaos hook: put NaN into one slot's decode state at its last
        written position (always inside the attention window), so the next
        decode tick gives non-finite logits for that row and only that row.
        A dense pool poisons `k[:, slot, t-1]`, a paged pool that position
        in its page, and an int8 pool (int8 holds no NaN) the page's
        `k_scales`. A SHARED page is forked first (K, V and, on int8
        pages, the scales copied into a fresh page the slot's block table
        then maps), so the donor and the other sharers keep their clean
        state; with no page to spare beyond the reservations the injection
        is skipped (taking a promised page would break deadlock freedom)."""
        if self.owner[slot] is None:
            raise RuntimeError(f"slot {slot} is free")
        t = max(0, int(self.t_host[slot]) - 1)
        st = self.state
        if not self.paged:
            st["k"][:, slot, t] = float("nan")
            return
        idx = t // self.page_size
        page = int(self.block_table[slot, idx])
        if self.alloc.refcount(page) > 1:
            if not self.alloc.can_reserve(1):
                return
            new = self.alloc.fork(self.owner[slot].request_id, page)
            names = ["k_pages", "v_pages"] + (
                ["k_scales", "v_scales"] if self.quant else [])
            for name in names:
                st[name][:, new] = st[name][:, page]
            self.block_table[slot, idx] = new
            self._push_block_table()
            page = new
        if self.quant:
            st["k_scales"][:, page] = float("nan")
        else:
            st["k_pages"][:, page, t % self.page_size] = float("nan")

    # ------------------------------------------------------------- invariants

    def audit(self) -> None:
        """Pool and slot invariant sweep (the engine runs it every tick
        with `audit_every_tick`): allocator consistency (a shared page's
        refcount equals its owners), block tables as contiguous prefixes
        equal to the allocator's ownership, host and device positions in
        step, live metadata sane, freed slots clear;
        int8 pools: free pages at scale 0 and no infinite scale (NaN only
        on a live page, a poison on its way to the quarantine)."""
        if self.paged:
            self.alloc.check()
        dev_t = self.state["t"].cpu().numpy()
        for slot, req in enumerate(self.owner):
            if req is None:
                assert self.remaining[slot] == 0 and self.t_host[slot] == 0, \
                    f"freed slot {slot} has stale metadata"
                assert dev_t[slot] == 0, \
                    f"freed slot {slot}: device t={dev_t[slot]} not reset"
                if self.paged:
                    assert (self.block_table[slot] == 0).all(), \
                        f"freed slot {slot} still maps pages"
                continue
            assert self.remaining[slot] > 0, \
                f"active slot {slot} owes no tokens"
            t = int(self.t_host[slot])
            assert 0 < t <= self.max_tokens, f"slot {slot}: t={t} out of range"
            assert dev_t[slot] == t, \
                f"slot {slot}: device t={dev_t[slot]} != host t={t}"
            if self.paged:
                row = self.block_table[slot]
                n = int((row != 0).sum())
                assert (row[:n] != 0).all() and (row[n:] == 0).all(), \
                    f"slot {slot}: block table not a contiguous prefix"
                owned = self.alloc.owned(req.request_id)
                assert set(row[:n].tolist()) == set(owned), \
                    f"slot {slot}: block table != allocator ownership"
                assert n >= pages_for_tokens(t, self.page_size), \
                    f"slot {slot}: {n} pages cannot back {t} positions"
        if self.quant:
            live = set(self.alloc.refcounts())
            free = sorted(set(range(1, self.num_pages)) - live)
            for name in ("k_scales", "v_scales"):
                s = self.state[name].cpu()
                assert not bool(torch.isinf(s).any()), \
                    f"{name} has inf entries"
                assert not free or bool((s[:, free] == 0).all()), \
                    f"{name}: freed pages carry non-zero scales " \
                    f"(pages {free[:8]}...)"
            if "go_scales" in self.state:
                assert bool(torch.isfinite(self.state["go_scales"]).all()), \
                    "go_scales has non-finite entries"
