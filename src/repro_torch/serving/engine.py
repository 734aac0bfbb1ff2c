"""Continuous-batching serving engine over the pooled KV (+ GO) cache state.

Counterpart of repro/serving/engine.py (`ServingEngine`), the engine's core:

  admit    a queued request prefills into a free slot: one batch-1
           prefill at the pool's max_tokens whose KV (and, for expert
           choice, per-layer GO rows) are written into the slot in place (write_decode_slot), or, for
           a prompt longer than `prefill_chunk`, a chunked prefill that
           runs one chunk per engine tick;
  decode   every tick advances ALL slots one token in one batched
           serve_step; slots sit at different positions through the
           per-slot `t` vector. Retired rows still flow through the step
           with their position pinned to 0 and a null block-table row, as
           the reference's `_decode_step` does;
  retire   a slot frees on EOS or length; its caches reset
           (init_decode_slot) and the row is reusable at once.

The engine reads each tick's tokens back to the host once. Greedy
streams equal the static `launch.serve.generate()`'s for the same cache
capacity, and a paged pool's streams equal a dense pool's (on the CPU the
paged attention runs the reference's gather realization).

SAMPLING (`submit(temperature=, top_p=, seed=)`): a request with
temperature > 0 samples each token from its logits scaled by
1/temperature, cut to the top-p nucleus (`_sample_tokens`, on the
device), by inverse CDF from one uniform. The uniforms come from a CPU
`torch.Generator` a request owns, seeded with `seed` (the request id when
None): one per emitted token, its first included; greedy rows draw none.
So a request draws the same numbers on the CPU and on a card, and its
stream does not depend on its cohabitants. A tick samples only when an
active row has temperature > 0; a greedy-only tick is the greedy tick,
launch for launch, and greedy rows in a sampling tick take the argmax.
The JAX package's PRNG streams are not reproduced.

PROMPT BUCKETS (`prompt_buckets=True`): a one-shot admission pads its
prompt to a power of two from 8 up (capped at max_tokens) and prefills
with the real length as `valid_len` (models/model.py:prefill).
`stats()["prefill_lengths"]` lists the padded lengths seen. Expert-choice
capacity derives from the bucket length, so MoE streams are
deterministic per bucket but may differ from unbucketed ones; chunked
prompts keep their chunks.

PAGED POOL (`paged=True`): the KV rows become a shared page pool with
per-slot block tables (serving/pool.py, serving/paging.py); admission asks
the allocator whether the request's worst-case pages are reservable. On a
card, decode attention walks the block table through K3 and chunked
prefill through K4 (kernels/paged_attn.py).

CHUNKED PREFILL (`prefill_chunk=N`): prompts longer than N are admitted as
chunks of N tokens, one per tick, between the decode ticks of the slots in
flight. Expert-choice MoE routes each chunk at the CHUNK's capacity and
merges GO caches (go_cache_merge); token choice with C1 groups pools its
group capacity over the chunk's rows. Either way the streams are
deterministic per chunking but may differ from one-shot prefill. At most one chunk run is
in flight; it holds a claimed slot and reserved pages from its start, and
on a paged pool it writes its KV straight into the pool's pages.

INT8 DECODE STATE (`kv_quant="int8"`, an explicit kwarg only; paged pools
with pages of a multiple of 8 tokens): KV pages and GO rows are stored as
int8 with f32 scales (core/quant.py). New keys enter through the
rescale-on-write scatters; K3 and K4 read the int8 pages and dequantize
in the kernel; each decode layer dequantizes its GO rows to f32 and
requantizes them after the block. A chunked prefill's batch-1 GO cache
stays full precision and quantizes once when the request installs.
Released pages return with zeroed scales. stats() reports
`kv_quant_dtype`, `kv_bytes_per_token` and `dequant_max_abs_err`.

Not in the port yet (ROADMAP.md Queue 1 item 7): preemption, chaos and
the supervisor, deadlines and cancel, prefix sharing and expert-aware
admission, the journal and the mesh.
The int8 branches of preemption snapshots, prefix-share forks, NaN
poisoning of scales and the journal come with those features.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import (init_decode_state, paged_supported,
                                      prefill, prefill_chunk, serve_step)
from repro_torch.serving.pool import SlotPool
from repro_torch.serving.scheduler import (FIFOScheduler, QueueFull, Request,
                                           RequestStatus, RequestTooLarge)


def _sample_tokens(logits: torch.Tensor, u: torch.Tensor,
                   temps: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / top-p sampling over logits [B, V], on their
    device: u [B] uniforms in [0, 1), temps [B], top_ps [B] (f32). A row
    scales its logits by 1/max(temp, 1e-6), sorts them descending (stable,
    so ties keep the lower index first, as `lax.top_k` does), keeps the
    tokens where cumsum(p) - p < top_p (the first always), and takes the
    first kept token whose cumulative renormalised probability exceeds
    its u. Rows with temp <= 0 take the argmax. Returns [B] int64."""
    greedy = torch.argmax(logits, dim=-1)
    lg = logits.float() / temps.clamp_min(1e-6)[:, None]
    srt, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
    p = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(p, dim=-1) - p) < top_ps[:, None]
    q = torch.softmax(srt.masked_fill(~keep, float("-inf")), dim=-1)
    j = torch.searchsorted(torch.cumsum(q, dim=-1), u[:, None].float(),
                           right=True)
    # u at or past the last kept token's rounded cumulative sum
    j = torch.minimum(j, keep.sum(dim=-1, keepdim=True) - 1)
    sampled = torch.gather(idx, 1, j)[:, 0]
    return torch.where(temps > 0, sampled, greedy)


def _sample_rows(logits: torch.Tensor, u, temps, top_ps) -> torch.Tensor:
    """`_sample_tokens` with the rows' uniforms, temperatures and top-ps
    given as host arrays [B], moved to the logits' device in one copy."""
    host = torch.from_numpy(np.stack([u, temps, top_ps]).astype(np.float32))
    return _sample_tokens(logits, *host.to(logits.device))


@dataclass
class _ChunkJob:
    """One in-flight chunked prefill: a claimed slot, reserved pages and a
    private batch-1 decode state that fills one chunk per tick. A dense
    pool's job carries private KV rows; a paged pool's job carries its
    claimed block-table row and lends the pool's page tensors to each
    chunk, which scatters its KV straight into the job's pages."""
    req: Request
    slot: int
    state: dict
    prompt: np.ndarray            # right-padded to a chunk multiple
    pos: int = 0                  # next chunk start
    logits: torch.Tensor | None = None   # last chunk's logits
    page_row: np.ndarray | None = None


class ServingEngine:
    """Continuous-batching engine: submit requests any time, run ticks."""

    def __init__(self, params, cfg, *, num_slots: int = 8,
                 max_tokens: int = 256, max_queue: int = 0,
                 paged: bool = False, page_size: int = 16,
                 num_pages: int | None = None, prefill_chunk: int = 0,
                 kv_quant: str | None = None, prompt_buckets: bool = False,
                 device=None):
        if cfg.block != "attn":
            raise NotImplementedError(
                f"{cfg.name}: the engine serves the attention family; a "
                "recurrent family's pool slots (the slot ops of its decode "
                "state) are ROADMAP.md Queue 1 item 9. Use the static "
                "generate()")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        # kv_quant None keeps cfg's own mode; "none" or "int8" overrides it
        # (SlotPool raises a typed error where the pool cannot honor it)
        if kv_quant is not None:
            cfg = cfg.with_overrides(kv_quant=kv_quant)
        self.cfg = cfg
        self.pool = SlotPool(cfg, num_slots, max_tokens, self.device,
                             paged=paged, page_size=page_size,
                             num_pages=num_pages)
        self.scheduler = FIFOScheduler(num_slots, max_tokens, max_queue)
        if prefill_chunk:
            if not paged_supported(cfg):
                raise ValueError("chunked prefill is attention-family only")
            if max_tokens % prefill_chunk:
                raise ValueError(f"prefill_chunk={prefill_chunk} must divide "
                                 f"max_tokens={max_tokens}")
            if paged and prefill_chunk % page_size:
                raise ValueError(f"prefill_chunk={prefill_chunk} must be "
                                 f"page-granular (page_size={page_size})")
        self.prefill_chunk = int(prefill_chunk)
        self.prompt_buckets = bool(prompt_buckets)
        self.prefill_lengths: set[int] = set()
        self._chunk_job: _ChunkJob | None = None
        self._next_id = 0
        self.step_count = 0
        self.chunk_ticks = 0
        self.decode_ticks = 0
        # peak occupancy (occupied slots plus the chunk lane), sampled at
        # every admission and after the admission loop, before retirements
        self.peak_active = 0
        self.finished: dict[int, Request] = {}
        self.rejected_full = 0
        self.rejected_oversized = 0
        self.page_waits = 0        # admission checks refused by the page gate

    # ------------------------------------------------------------- submission

    def submit(self, prompt, max_new_tokens: int, *, eos_id: int | None = None,
               arrival_step: int = 0, priority: int = 0,
               request_id: int | None = None, temperature: float = 0.0,
               top_p: float = 1.0, seed: int | None = None) -> int:
        """Queue a request and return its id. `arrival_step` later than the
        current tick defers its arrival to that tick (trace replay);
        `priority` orders admission (lower first, FIFO within a level).
        `temperature` > 0 samples the request's tokens with top-p nucleus
        filtering from uniforms seeded by `seed` (None: the request id).
        Raises RequestTooLarge for a request that could never fit the pool
        and QueueFull at max_queue."""
        rid = request_id if request_id is not None else self._next_id
        self._next_id = max(self._next_id, rid + 1)
        req = Request(request_id=rid,
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                      arrival_step=arrival_step, priority=int(priority),
                      temperature=float(temperature), top_p=float(top_p),
                      seed=seed)
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0.0 < req.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.pool.paged:
            # a worst case over the whole page pool could never reserve, so
            # its admission would stall the queue forever
            need = self.pool.pages_needed(req)
            usable = self.pool.num_pages - 1          # page 0 is the null page
            if need > usable:
                self.rejected_oversized += 1
                raise RequestTooLarge(
                    f"request {rid}: prompt({req.prompt_len}) + "
                    f"max_new_tokens({req.max_new_tokens}) needs {need} "
                    f"pages of {self.pool.page_size} tokens, but the pool "
                    f"only has {usable} usable pages")
        req.arrival_time = req.submit_time = time.monotonic()
        try:
            self.scheduler.submit(req, now_step=self.step_count)
        except QueueFull:
            self.rejected_full += 1
            raise
        except RequestTooLarge:
            self.rejected_oversized += 1
            raise
        return rid

    # ------------------------------------------------------------------ ticks

    def step(self) -> list[Request]:
        """One engine tick: advance the chunked prefill (if any) by one
        chunk, admit due and queued requests into free slots, then advance
        every occupied slot one token. Returns the requests finished on
        this tick."""
        done: list[Request] = []
        for req in self.scheduler.poll(self.step_count):
            req.arrival_time = time.monotonic()

        if self._chunk_job is not None:
            self._advance_chunk_job(done)

        while True:
            free = self.pool.free_slots()
            if self._chunk_job is not None and self._chunk_job.slot in free:
                free.remove(self._chunk_job.slot)
            busy = self.pool.num_active() + \
                (1 if self._chunk_job is not None else 0)
            req = self.scheduler.next_admission(busy,
                                                can_admit=self._can_admit)
            if req is None:
                break
            if self.prefill_chunk and req.prompt_len > self.prefill_chunk:
                self._start_chunk_job(free[0], req)
            else:
                self._admit(free[0], req, done)

        self._note_occupancy()

        if self.pool.any_active():
            self.pool.grow_active()
            toks = self._decode_step()
            self.pool.note_decoded()
            self.step_count += 1
            self.decode_ticks += 1
            for slot, req in enumerate(self.pool.owner):
                if req is None:
                    continue
                tok = int(toks[slot])
                req.tokens.append(tok)
                self.pool.pending[slot] = tok
                self.pool.remaining[slot] -= 1
                if self.pool.remaining[slot] <= 0 or \
                        (req.eos_id is not None and tok == req.eos_id):
                    self._retire_slot(slot, done)
        elif self._chunk_job is not None:
            self.step_count += 1              # prefill-only tick
        else:
            # idle tick: jump straight to the next trace arrival
            nxt = self.scheduler.next_arrival_step()
            self.step_count = max(self.step_count + 1,
                                  nxt if nxt is not None else 0)
        return done

    def has_work(self) -> bool:
        """Anything left to do: queued or deferred requests, occupied
        slots, or an in-flight chunked prefill."""
        return self.scheduler.has_pending() or self.pool.any_active() \
            or self._chunk_job is not None

    def run(self) -> dict[int, Request]:
        """Tick until the queue, the trace, the chunk run and the pool
        drain; returns the finished requests by id (token streams in
        Request.tokens)."""
        while self.has_work():
            self.step()
        return self.finished

    # -------------------------------------------------------------- internals

    def _decode_step(self) -> np.ndarray:
        """One batched decode tick over every row (the reference's
        `_decode_step`): retired rows' positions are pinned back to 0.
        Returns the tokens [num_slots], read back to the host: the argmax,
        or, when an active row samples, `_sample_tokens` with one uniform
        from each sampling row's generator (the uniforms, temperatures and
        top-ps go to the device in one copy)."""
        dev = self.device
        st = self.pool.state
        tokens = torch.from_numpy(self.pool.pending.astype(np.int64)).to(dev)
        active = torch.from_numpy(self.pool.active_mask()).to(dev)
        logits, st = serve_step(self.params, st, tokens, self.cfg)
        st["t"] = torch.where(active, st["t"], 0).to(torch.int32)
        temps = self.pool.temps                 # 0 on free rows
        if not (temps > 0).any():
            return torch.argmax(logits, dim=-1).cpu().numpy()
        u, gens = np.zeros_like(temps), self.pool.generators
        for slot in np.flatnonzero(temps > 0):
            u[slot] = torch.rand(1, generator=gens[slot]).item()
        return _sample_rows(logits, u, temps, self.pool.top_ps).cpu().numpy()

    def _note_occupancy(self) -> None:
        self.peak_active = max(
            self.peak_active,
            self.pool.num_active() + (1 if self._chunk_job is not None else 0))

    def _can_admit(self, req: Request) -> bool:
        """Admission gate: a to-be-chunked prompt waits for the single
        chunk lane, and a paged pool must be able to reserve the request's
        worst-case pages. A blocked head blocks the queue (no overtaking,
        so no starvation)."""
        if self.prefill_chunk and req.prompt_len > self.prefill_chunk \
                and self._chunk_job is not None:
            return False
        if self.pool.can_admit(req):
            return True
        self.page_waits += 1
        return False

    def _bucketed(self, prompt: np.ndarray):
        """Pad the prompt up to its power-of-two bucket (from 8, capped at
        the pool's max_tokens); returns (padded [S_b], valid_len or None
        when no pad is needed)."""
        n = int(prompt.shape[0])
        b = 8
        while b < n:
            b *= 2
        b = min(b, self.pool.max_tokens)
        if b <= n:
            return prompt, None
        return np.pad(prompt, (0, b - n)), n

    def _first_token(self, req: Request, logits):
        """The request's first output token from its prefill logits [1, V]:
        the argmax, or sampled from the first uniform of the request's new
        generator when it asks for temperature > 0. Returns (token, the
        generator or None)."""
        if req.temperature <= 0:
            return int(torch.argmax(logits, dim=-1)[0]), None
        seed = req.seed if req.seed is not None else req.request_id
        gen = torch.Generator().manual_seed(int(seed))
        u = torch.rand(1, generator=gen).item()
        tok = _sample_rows(logits, [u], [req.temperature], [req.top_p])
        return int(tok[0]), gen

    def _admit(self, slot: int, req: Request, done: list[Request]) -> None:
        """One-shot batch-1 prefill at the pool's max_tokens into `slot`
        (padded to its bucket with prompt_buckets); emits the request's
        first token from the prefill logits."""
        prompt, valid_len = (self._bucketed(req.prompt) if self.prompt_buckets
                             else (req.prompt, None))
        self.prefill_lengths.add(int(prompt.shape[0]))
        tokens = torch.from_numpy(np.ascontiguousarray(prompt)).to(self.device)
        slot_state, logits = prefill(self.params, tokens[None, :], self.cfg,
                                     max_len=self.pool.max_tokens,
                                     valid_len=valid_len)
        self._install(slot, req, slot_state, logits, done)

    def _install(self, slot: int, req: Request, slot_state: dict, logits,
                 done: list[Request], page_row=None) -> None:
        """Shared tail of one-shot and chunked admission: emit the first
        token, splat the prefilled state into the pool row, and retire at
        once on EOS or a one-token request."""
        first, gen = self._first_token(req, logits)
        req.admit_step = self.step_count
        req.admit_time = time.monotonic()
        req.status = RequestStatus.ACTIVE
        req.tokens.append(first)
        self.pool.admit(slot, req, slot_state, first, page_row=page_row,
                        generator=gen)
        self._note_occupancy()       # before a possible instant retirement
        if self.pool.remaining[slot] <= 0 or \
                (req.eos_id is not None and first == req.eos_id):
            self._retire_slot(slot, done)

    # ---------------------------------------------------------- chunk prefill

    def _start_chunk_job(self, slot: int, req: Request) -> None:
        """Claim `slot` and the request's worst-case pages, then fill the
        first chunk. A paged pool claims the request's first pages up front
        and its job state is a batch-1 skeleton (position, GO rows, block
        table); the page tensors are the pool's own."""
        Cs = self.prefill_chunk
        padded = -(-req.prompt_len // Cs) * Cs
        prompt = np.pad(req.prompt, (0, padded - req.prompt_len))
        page_row = None
        if self.pool.paged:
            page_row = self.pool.claim_chunk_pages(req)
            # an int8 pool's skeleton stays full precision: its GO rows
            # accumulate across chunks (go_cache_merge) and quantize once,
            # at the install; only the pool's pages and scales are lent
            skel_cfg = (self.cfg.with_overrides(kv_quant="none")
                        if self.pool.quant else self.cfg)
            state = init_decode_state(skel_cfg, 1, self.pool.max_tokens,
                                      self.device,
                                      paged=(1, self.pool.page_size))
            del state["k_pages"], state["v_pages"]
            state["block_table"] = torch.from_numpy(
                page_row[None, :].copy()).to(self.device)
        else:
            state = init_decode_state(self.cfg, 1, self.pool.max_tokens,
                                      self.device)
            self.pool.reserve_pages(req)
        self._chunk_job = _ChunkJob(req=req, slot=slot, state=state,
                                    prompt=prompt, page_row=page_row)
        self._advance_chunk_job_once()

    def _advance_chunk_job(self, done: list[Request]) -> None:
        self._advance_chunk_job_once()
        job = self._chunk_job
        if job is not None and job.pos >= len(job.prompt):
            self._chunk_job = None
            self._install(job.slot, job.req, job.state, job.logits, done,
                          page_row=job.page_row)

    def _advance_chunk_job_once(self) -> None:
        """Prefill the job's next chunk. A paged job lends the pool's page
        tensors to the chunk, which writes only the job's claimed pages
        (disjoint from every active slot's), in place."""
        job = self._chunk_job
        Cs = self.prefill_chunk
        chunk = torch.from_numpy(job.prompt[job.pos:job.pos + Cs].copy())
        valid = min(Cs, job.req.prompt_len - job.pos)
        paged = job.page_row is not None
        lent = [k for k in ("k_pages", "v_pages", "k_scales", "v_scales")
                if paged and k in self.pool.state]
        for k in lent:
            job.state[k] = self.pool.state[k]
        job.state, job.logits = prefill_chunk(
            self.params, job.state, chunk.to(self.device)[None, :], self.cfg,
            job.pos, valid)
        for k in lent:
            del job.state[k]
        job.pos += Cs
        self.chunk_ticks += 1

    def _retire_slot(self, slot: int, done: list[Request]) -> None:
        self._mark_finished(self.pool.retire(slot), done)

    def _mark_finished(self, req: Request, done: list[Request]) -> None:
        req.status = RequestStatus.DONE
        req.finish_step = self.step_count
        req.finish_time = time.monotonic()
        self.finished[req.request_id] = req
        done.append(req)

    def stats(self) -> dict:
        reqs = self.finished.values()
        return {
            "steps": self.step_count,
            "decode_ticks": self.decode_ticks,
            "chunk_ticks": self.chunk_ticks,
            "admitted": self.pool.admitted_total,
            "finished": len(self.finished),
            "queued": len(self.scheduler.queue),
            "active": self.pool.num_active(),
            "tokens_out": sum(len(r.tokens) for r in reqs),
            "peak_active": self.peak_active,
            "paged": self.pool.paged,
            "page_size": self.pool.page_size if self.pool.paged else None,
            "num_pages": self.pool.num_pages,
            "pages_in_use": (self.pool.alloc.pages_in_use
                             if self.pool.paged else None),
            "page_waits": self.page_waits,
            "rejected": {"queue_full": self.rejected_full,
                         "oversized": self.rejected_oversized},
            "kv_quant_dtype": (self.cfg.kv_quant
                               if self.cfg.kv_quant != "none" else None),
            "kv_bytes_per_token": (
                Q.kv_bytes_per_token(self.cfg, self.pool.page_size)
                if self.pool.paged else None),
            "dequant_max_abs_err": (self.pool.dequant_max_abs_err
                                    if self.pool.quant else None),
            "prefill_lengths": sorted(self.prefill_lengths),
        }
