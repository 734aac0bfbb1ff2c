"""Slot pool: owns the pooled per-request KV (+ GO) decode state.

Counterpart of repro/serving/pool.py (`SlotPool`), cut to the engine core:
dense and paged pools, int8 pages (cfg.kv_quant="int8"), admission, lazy
page growth and retirement (no snapshots, poison, audit or mesh).

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

Unlike the JAX pool, which threads a new state through jitted functions,
this one writes the device tensors IN PLACE. The one exception is the
block table: the host mirror is the truth, and a dirty mirror is pushed as
a NEW device tensor made from a copy of it, so no host buffer the card may
still be reading is ever written.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.models.model import (init_decode_slot, init_decode_state,
                                      paged_supported, write_decode_slot)
from repro_torch.serving.paging import PageAllocator, pages_for_tokens
from repro_torch.serving.scheduler import Request


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
            self.state["block_table"] = torch.from_numpy(
                self.block_table.copy()).to(self.device)
            self._bt_dirty = False

    def note_decoded(self) -> None:
        """Advance the host mirror of each active slot's position after a
        decode tick (keeps grow_active off the device)."""
        for slot, req in enumerate(self.owner):
            if req is not None:
                self.t_host[slot] += 1

    def release_pages(self, rid: int) -> None:
        """Drop every page `rid` holds and its reservation. An int8 pool
        zeroes the scales of every released page: the rescale-on-write
        contract makes a page's contents a pure function of the tokens
        written to it only if it starts from scale 0 (the first write then
        rescales the stale int8 bytes by a factor of 0). The NaN scrub of
        poisoned pages comes with the quarantine (ROADMAP.md Queue 1
        item 7)."""
        if not self.paged:
            return
        released = self.alloc.free(rid)
        if self.quant and released:
            ids = torch.tensor(sorted(released), dtype=torch.long,
                               device=self.device)
            self.state["k_scales"][:, ids] = 0
            self.state["v_scales"][:, ids] = 0

    def retire(self, slot: int) -> Request:
        """Free a row: reset its caches (block table to the null page, GO
        scores, if any, to -inf) and return the finished request. The row is
        reusable at once. The page CONTENTS stay: stale positions are
        masked, and masked finite values add exactly 0 to attention."""
        req = self.owner[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} is already free")
        if self.paged:
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
