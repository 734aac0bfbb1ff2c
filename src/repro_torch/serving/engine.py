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

FAULT DOMAIN: every request ends in a typed terminal status
(Request.status: DONE, TIMEOUT, CANCELLED or FAILED). Requests carry wall
budgets (`deadline_s` from submit, `max_wall_s` from first admission),
checked at the head of every tick; `cancel(rid)` retires a request
wherever it is (queued or trace-pending, parked after preemption,
mid-chunk-prefill, decoding). With `preemption=True` (paged pools only) a
blocked higher-priority admission EVICTS the lowest-priority active stream
(ties: the latest admitted): its live pages, GO rows, cursor and sampling
generator go to a host snapshot (SlotPool.snapshot), its pages are freed,
and it resumes later by block-table surgery into fresh pages
(SlotPool.restore), bit-identical to never being evicted. A row whose
logits are not all finite is quarantined: it retires FAILED ("non-finite
logits") with no token appended and its pages marked for a zero scrub,
and its cohabitants never notice (every batched op is row-wise
independent). The tick's one host read carries that check: the tokens come
back as one [num_slots] int64 copy with -1 where a row is not finite.
`chaos=` (serving/chaos.py) injects seeded faults in the reference's
order: admission pressure once a tick, a forced preemption then a NaN
victim, and a tick fault at the start of each supervised attempt
(`chaos.preempt > 0` on a paged pool turns preemption on).
`audit_every_tick` sweeps the pool's and the engine's invariants after
every tick (an attribute, off by default).

THE TICK SUPERVISOR retries less than the reference's. The reference
retries a failed decode tick with identical inputs because its tick is
functional: pool state and sampling keys are committed only after success.
The port's tick is not: `serve_step` writes KV pages, int8 scales, GO rows
and the K5/K5R cache in place, and an in-place TopKUpdate run twice over
one score can insert it twice. So the supervised region retries only a
fault raised before the tick's first write (chaos's `maybe_tick_fault`,
called first as in the reference); any exception from inside the decode
step or the sampler surfaces at once as `RestartRequired`, its cause
chained, with no retry.

Not in the port yet (ROADMAP.md Queue 1 item 7): prefix sharing (and the
copy-on-write fork a poison of a shared page needs), expert-aware
admission (the victim rank is 0 under FIFOScheduler), the journal with
its crash classes, and the mesh.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import (init_decode_state, paged_supported,
                                      prefill, prefill_chunk, serve_step)
from repro_torch.runtime.fault import RestartRequired, StepSupervisor
from repro_torch.serving.chaos import Chaos
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
    # u at or past the last kept token's rounded cumulative sum; a
    # non-finite row keeps nothing, and its index stays in range (the
    # engine quarantines that row)
    j = torch.minimum(j, (keep.sum(dim=-1, keepdim=True) - 1).clamp_min(0))
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
                 preemption: bool = False, chaos: Chaos | None = None,
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
        # --- fault domain ---
        self.chaos = chaos
        if chaos is not None and chaos.preempt > 0 and self.pool.paged:
            preemption = True      # forced evictions need the resume path
        if preemption and not self.pool.paged:
            raise ValueError("preemption needs a paged pool (eviction "
                             "snapshots are block-table surgery)")
        self.preemption = bool(preemption)
        # max_retries must exceed chaos's consecutive tick faults (2)
        self.supervisor = StepSupervisor(max_retries=3)
        self._preempted: dict[int, dict] = {}   # rid -> eviction snapshot
        self.preempted_total = 0
        self.resumed_total = 0
        self.audit_every_tick = False

    # ------------------------------------------------------------- submission

    def submit(self, prompt, max_new_tokens: int, *, eos_id: int | None = None,
               arrival_step: int = 0, priority: int = 0,
               request_id: int | None = None, temperature: float = 0.0,
               top_p: float = 1.0, seed: int | None = None,
               deadline_s: float | None = None,
               max_wall_s: float | None = None) -> int:
        """Queue a request and return its id. `arrival_step` later than the
        current tick defers its arrival to that tick (trace replay);
        `priority` orders admission (lower first, FIFO within a level).
        `temperature` > 0 samples the request's tokens with top-p nucleus
        filtering from uniforms seeded by `seed` (None: the request id).
        `deadline_s` / `max_wall_s` bound the request's wall clock from
        submission / first admission: past either it retires TIMEOUT.
        Raises RequestTooLarge for a request that could never fit the pool
        and QueueFull at max_queue."""
        rid = request_id if request_id is not None else self._next_id
        self._next_id = max(self._next_id, rid + 1)
        req = Request(request_id=rid,
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                      arrival_step=arrival_step, priority=int(priority),
                      temperature=float(temperature), top_p=float(top_p),
                      seed=seed, deadline_s=deadline_s,
                      max_wall_s=max_wall_s)
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

    def cancel(self, rid: int) -> bool:
        """Retire request `rid` wherever it is (queued or trace-pending,
        parked after preemption, mid-chunk-prefill, decoding), freeing its
        slot and pages and marking it CANCELLED (its tokens so far kept).
        Returns False for an unknown or already terminal id."""
        if rid in self.finished:
            return False
        done: list[Request] = []
        req = self.scheduler.remove(rid)
        if req is not None:
            self._preempted.pop(rid, None)
            self._mark_finished(req, RequestStatus.CANCELLED, done,
                                reason="cancelled")
            return True
        job = self._chunk_job
        if job is not None and job.req.request_id == rid:
            self.pool.release_pages(rid)   # claimed chunk pages + reservation
            self._chunk_job = None
            self._mark_finished(job.req, RequestStatus.CANCELLED, done,
                                reason="cancelled")
            return True
        for slot, owner in enumerate(self.pool.owner):
            if owner is not None and owner.request_id == rid:
                self._retire_slot(slot, RequestStatus.CANCELLED, done,
                                  reason="cancelled")
                return True
        return False

    # ------------------------------------------------------------------ ticks

    def step(self) -> list[Request]:
        """One engine tick: expire blown wall budgets, advance the chunked
        prefill (if any) by one chunk, admit due and queued requests into
        free slots (evicting lower-priority streams under pressure when
        preemption is on; chaos pressure skips the admissions of a tick),
        inject chaos's state faults, then advance every occupied slot one
        token under the tick supervisor, quarantining non-finite rows.
        Returns the requests finished on this tick."""
        done: list[Request] = []
        self._expire(time.monotonic(), done)

        for req in self.scheduler.poll(self.step_count):
            req.arrival_time = time.monotonic()

        if self._chunk_job is not None:
            self._advance_chunk_job(done)

        if self.chaos is None or not self.chaos.pressure_event():
            while True:
                free = self.pool.free_slots()
                if self._chunk_job is not None and \
                        self._chunk_job.slot in free:
                    free.remove(self._chunk_job.slot)
                busy = self.pool.num_active() + \
                    (1 if self._chunk_job is not None else 0)
                req = self.scheduler.next_admission(
                    busy, can_admit=self._can_admit)
                if req is None:
                    # a blocked head with preemption on: evict a
                    # lower-priority stream and try again
                    if self.preemption and self._preempt_for_head():
                        continue
                    break
                if req.request_id in self._preempted:
                    self._resume(free[0], req)
                elif self.prefill_chunk and \
                        req.prompt_len > self.prefill_chunk:
                    self._start_chunk_job(free[0], req)
                else:
                    self._admit(free[0], req, done)

        self._note_occupancy()

        if self.chaos is not None:
            self._inject_state_faults()

        if self.pool.any_active():
            self.pool.grow_active()
            toks = self._supervised_decode()
            self.pool.note_decoded()
            self.step_count += 1
            self.decode_ticks += 1
            for slot, req in enumerate(self.pool.owner):
                if req is None:
                    continue
                tok = int(toks[slot])
                if tok < 0:
                    # quarantine: the row's logits went non-finite; it
                    # retires FAILED with no token appended
                    self._retire_slot(slot, RequestStatus.FAILED, done,
                                      reason="non-finite logits")
                    continue
                req.tokens.append(tok)
                self.pool.pending[slot] = tok
                self.pool.remaining[slot] -= 1
                if self.pool.remaining[slot] <= 0 or \
                        (req.eos_id is not None and tok == req.eos_id):
                    self._retire_slot(slot, RequestStatus.DONE, done)
        elif self._chunk_job is not None:
            self.step_count += 1              # prefill-only tick
        else:
            # idle tick: jump straight to the next trace arrival
            nxt = self.scheduler.next_arrival_step()
            self.step_count = max(self.step_count + 1,
                                  nxt if nxt is not None else 0)

        if self.audit_every_tick:
            self._audit()
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

    def _supervised_decode(self) -> np.ndarray:
        """The decode tick under the StepSupervisor. Only chaos's injected
        tick fault, raised before the tick's first write, is retried; the
        tick writes the pool in place, so a failure inside it surfaces as
        RestartRequired (cause chained) with no retry (module docstring)."""
        def tick():
            if self.chaos is not None:
                self.chaos.maybe_tick_fault(self.step_count)
            try:
                return self._decode_step()
            except Exception as e:
                raise RestartRequired(
                    f"decode tick {self.step_count} failed after writing "
                    f"the pool in place: {e}") from e
        return self.supervisor.run(tick, step=self.step_count)

    def _decode_step(self) -> np.ndarray:
        """One batched decode tick over every row (the reference's
        `_decode_step`): retired rows' positions are pinned back to 0.
        Returns the tokens [num_slots], read back to the host in one copy:
        the argmax, or, when an active row samples, `_sample_tokens` with
        one uniform from each sampling row's generator (the uniforms,
        temperatures and top-ps go to the device in one copy); -1 where a
        row's logits are not all finite."""
        dev = self.device
        st = self.pool.state
        tokens = torch.from_numpy(self.pool.pending.astype(np.int64)).to(dev)
        active = torch.from_numpy(self.pool.active_mask()).to(dev)
        logits, st = serve_step(self.params, st, tokens, self.cfg)
        st["t"] = torch.where(active, st["t"], 0).to(torch.int32)
        ok = torch.isfinite(logits).all(dim=-1)
        temps = self.pool.temps                 # 0 on free rows
        if not (temps > 0).any():
            tok = torch.argmax(logits, dim=-1)
        else:
            u, gens = np.zeros_like(temps), self.pool.generators
            for slot in np.flatnonzero(temps > 0):
                u[slot] = torch.rand(1, generator=gens[slot]).item()
            tok = _sample_rows(logits, u, temps, self.pool.top_ps)
        return torch.where(ok, tok, -1).cpu().numpy()

    def _note_occupancy(self) -> None:
        self.peak_active = max(
            self.peak_active,
            self.pool.num_active() + (1 if self._chunk_job is not None else 0))

    def _can_admit(self, req: Request) -> bool:
        """Admission gate: a to-be-chunked prompt waits for the single
        chunk lane, and a paged pool must be able to reserve the request's
        worst-case pages. A PREEMPTED head resumes from its snapshot: it
        needs only its remaining worst case and never re-prefills, so the
        chunk lane does not concern it. A blocked head blocks the queue (no
        overtaking, so no starvation)."""
        snap = self._preempted.get(req.request_id)
        if snap is not None:
            ok = self.pool.can_resume(snap)
        elif self.prefill_chunk and req.prompt_len > self.prefill_chunk \
                and self._chunk_job is not None:
            return False
        else:
            ok = self.pool.can_admit(req)
        if not ok:
            self.page_waits += 1
        return ok

    # -------------------------------------------------------------- preemption

    def _preempt_for_head(self) -> bool:
        """The head of the admission heap is blocked on slots or pages:
        evict ONE active stream of strictly lower priority (the greatest
        priority value; ties go to the latest admission, the least work
        lost) and report whether one fell. The admission loop retries after
        each eviction, so as many fall as the head needs. The victim rank
        between priority and admission is 0 (FIFOScheduler only)."""
        if not (self.pool.paged and self.scheduler.queue):
            return False
        head = self.scheduler.queue[0][2]
        if head.request_id not in self._preempted and self.prefill_chunk \
                and head.prompt_len > self.prefill_chunk \
                and self._chunk_job is not None:
            return False     # blocked on the chunk LANE: eviction can't help
        victims = [(owner.priority, 0, owner.admit_step, slot)
                   for slot, owner in enumerate(self.pool.owner)
                   if owner is not None and owner.priority > head.priority]
        if not victims:
            return False
        self._preempt(max(victims)[3])
        return True

    def _preempt(self, slot: int) -> None:
        """Evict the stream in `slot`: snapshot it to the host, free its
        pages, park it PREEMPTED and requeue it under its original submit
        order."""
        req = self.pool.owner[slot]
        snap = self.pool.snapshot(slot)
        self.pool.retire(slot)
        req.slot = -1
        req.status = RequestStatus.PREEMPTED
        req.preemptions += 1
        self._preempted[req.request_id] = snap
        self.scheduler.requeue(req)
        self.preempted_total += 1

    def _resume(self, slot: int, req: Request) -> None:
        """Un-park a preempted stream into a free slot by block-table
        surgery (SlotPool.restore): no re-prefill, bit-identical to an
        uninterrupted run."""
        snap = self._preempted.pop(req.request_id)
        self.pool.restore(slot, req, snap)
        req.status = RequestStatus.ACTIVE
        self.resumed_total += 1
        self._note_occupancy()

    # ------------------------------------------------------ faults, deadlines

    def _expire(self, now: float, done: list[Request]) -> None:
        """Retire every request whose wall budget ran out, wherever it is:
        queued, pending or parked (the scheduler's heaps), mid-chunk-prefill
        or decoding."""
        for req in self.scheduler.expire(now):
            self._preempted.pop(req.request_id, None)
            self._mark_finished(req, RequestStatus.TIMEOUT, done,
                                reason="deadline exceeded before admission"
                                if req.admit_time == 0 else
                                "deadline exceeded while preempted")
        job = self._chunk_job
        if job is not None and job.req.expired(now):
            self.pool.release_pages(job.req.request_id)
            self._chunk_job = None
            self._mark_finished(job.req, RequestStatus.TIMEOUT, done,
                                reason="deadline exceeded during prefill")
        for slot, req in enumerate(self.pool.owner):
            if req is not None and req.expired(now):
                self._retire_slot(slot, RequestStatus.TIMEOUT, done,
                                  reason="deadline exceeded")

    def _inject_state_faults(self) -> None:
        """Chaos's state faults for this tick, in the reference's order: a
        forced eviction (snapshot and restore, semantics-preserving), then
        a poisoned slot (NaN state, the quarantine path)."""
        active = [s for s, o in enumerate(self.pool.owner) if o is not None]
        if self.preemption and self.pool.paged:
            victim = self.chaos.preempt_victim(active)
            if victim is not None:
                self._preempt(victim)
                active.remove(victim)
        victim = self.chaos.nan_victim(active)
        if victim is not None:
            self.pool.poison_slot(victim)

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
        generator when it asks for temperature > 0; -1 when the logits are
        not all finite (one host read either way). Returns (token, the
        generator or None)."""
        ok = torch.isfinite(logits).all()
        if req.temperature <= 0:
            return int(torch.where(ok, torch.argmax(logits, dim=-1)[0],
                                   -1)), None
        seed = req.seed if req.seed is not None else req.request_id
        gen = torch.Generator().manual_seed(int(seed))
        u = torch.rand(1, generator=gen).item()
        tok = _sample_rows(logits, [u], [req.temperature], [req.top_p])
        return int(torch.where(ok, tok[0], -1)), gen

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
        once on EOS or a one-token request. Non-finite prefill logits
        quarantine the request to FAILED before it occupies the slot (a
        chunk run's claimed pages are scrubbed and freed)."""
        first, gen = self._first_token(req, logits)
        if first < 0:
            if page_row is not None:
                self.pool.alloc.mark_scrub(req.request_id)
                self.pool.release_pages(req.request_id)
            self._mark_finished(req, RequestStatus.FAILED, done,
                                reason="non-finite prefill logits")
            return
        req.admit_step = self.step_count
        req.admit_time = time.monotonic()
        req.status = RequestStatus.ACTIVE
        req.tokens.append(first)
        self.pool.admit(slot, req, slot_state, first, page_row=page_row,
                        generator=gen)
        self._note_occupancy()       # before a possible instant retirement
        if self.pool.remaining[slot] <= 0 or \
                (req.eos_id is not None and first == req.eos_id):
            self._retire_slot(slot, RequestStatus.DONE, done)

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

    def _retire_slot(self, slot: int, status: RequestStatus,
                     done: list[Request], reason: str | None = None) -> None:
        """Retire an occupied slot into terminal `status`. A FAILED
        retirement is a quarantine: its state is non-finite, so its pages
        are scrubbed before another stream can map them."""
        req = self.pool.retire(slot, scrub=status is RequestStatus.FAILED)
        self._mark_finished(req, status, done, reason=reason)

    def _mark_finished(self, req: Request, status: RequestStatus,
                       done: list[Request], reason: str | None = None) -> None:
        req.status = status
        req.fail_reason = reason
        req.finish_step = self.step_count
        req.finish_time = time.monotonic()
        self.finished[req.request_id] = req
        done.append(req)

    def _audit(self) -> None:
        """The invariant sweep of `audit_every_tick`: the pool's
        (SlotPool.audit), then the engine's cross-checks: page refcounts
        equal the live references (slot block tables and the chunk run's
        claimed row), the chunk lane's slot stays unoccupied, and parked
        preempted requests are neither active nor finished."""
        self.pool.audit()
        job = self._chunk_job
        if self.pool.paged:
            refs: Counter[int] = Counter()
            for slot, owner in enumerate(self.pool.owner):
                if owner is not None:
                    r = self.pool.block_table[slot]
                    refs.update(int(p) for p in r[r != 0])
            if job is not None and job.page_row is not None:
                r = job.page_row
                refs.update(int(p) for p in r[r != 0])
            rc = Counter(self.pool.alloc.refcounts())
            assert refs == rc, \
                f"page refcounts != live references: {rc - refs} over, " \
                f"{refs - rc} under"
        if job is not None:
            assert self.pool.owner[job.slot] is None, \
                "chunk job's claimed slot was given away"
        for rid in self._preempted:
            assert all(o is None or o.request_id != rid
                       for o in self.pool.owner), \
                f"preempted request {rid} also occupies a slot"
            assert rid not in self.finished, \
                f"preempted request {rid} already finished"

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
            # --- fault domain ---
            "statuses": dict(Counter(r.status.value for r in reqs)),
            "preemptions": self.preempted_total,
            "resumes": self.resumed_total,
            "preempted_waiting": len(self._preempted),
            "tick_retries": self.supervisor.stats.retries,
            "chaos": (dict(self.chaos.injected)
                      if self.chaos is not None else None),
        }
