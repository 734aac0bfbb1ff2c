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
chained, with no retry. A journaled engine makes that recoverable: the
process exits, and `recover()` resumes from the last committed snapshot,
taken at a tick boundary.

PREFIX SHARING (`prefix_share=True`, paged pools): every one-shot
admission deposits its prompt into a `PrefixIndex` (serving/paging.py):
its full pages are pinned as radix nodes (refcounts; nothing moves), and
its tail KV past the last full page, its GO rows and its prefill logits
are kept as device clones (the donor's decode rewrites its GO rows and,
on int8 pages, its tail page's scale, and a retired donor's private pages
go to other requests). A later request with the same prompt admits from
the entry without a prefill: its full pages map the donor's copy-on-write,
the tail and GO rows are copied in, and its first token comes from the
cached logits under its own temperature and generator, so its stream is
the cold admission's bit for bit. It reserves only its non-shared pages.
A chunked prefill deposits nothing (its expert-choice routing ran at
chunk capacities). Under page pressure the index gives up its LRU
entries before an admission waits; `run()` flushes it on drain. Only the
exact full-prompt match is served: an MoE prefill routes with
whole-sequence competition, so a shared prefix's KV under a longer prompt
is not that prompt's; the dense prefix extension waits for a dense family
(ROADMAP.md Queue 1 item 9).

EXPERT-AWARE ADMISSION (`expert_aware=True`, MoE configs): submit
fingerprints each prompt with `expert_signature` (the layer-0 gate over
the first `_PROBE_TOKENS` embedded tokens, top-k, one host read), refined
at admission from the GO rows an expert-choice prefill kept; the
`ExpertAwareScheduler` orders admissions within a priority class by
overlap with the active batch's experts, and preemption picks, within a
priority class, the victim with the most experts no other stream needs.
Admission order is the only thing it changes.

DURABILITY (`journal_dir=`, paged pools; serving/journal.py): the engine
journals every request's lifecycle (`submit`, the `install` of its first
token, one `tick` record of each decode tick's tokens, `terminal`), fsync'd
record by record, and every `snapshot_every` ticks commits an atomic
snapshot of the whole engine at the tick boundary, after the tick's one
host read (the tick writes pages, scales, GO rows and the K5R cache in
place, so a snapshot taken anywhere else would catch it half written):
the pages several holders map (copy-on-write prefix pages), once each,
each live slot's `SlotPool.snapshot` of its other pages, the parked
preemption snapshots, the scheduler's heaps and load EWMAs, the prefix
index, the counters, and the config's name and the params' checksum
(`params_checksum`), all in the journal's numpy form
(serving/pool.py `to_host_payload`: bf16 as its bits, a generator as its
state). A chunk job is recorded as its request only and restarts its
chunked prefill under its original submit order. `ServingEngine.recover`
rebuilds an engine from the latest committed snapshot, for the same config
and weights only: the shared pages come back into fresh pages first, the
slots by block-table surgery that maps them copy-on-write again (slots that
fit the pool only by sharing fit after recovery too), the prefix index's
nodes pin them, requests journaled after the snapshot are queued again,
and the tokens the dead process journaled become a replay oracle the
recovered streams must re-emit bit for bit. Greedy and sampled streams
equal the uninterrupted run's: a live or parked request resumes its
generator's saved state, a request admitted later draws from its seed.
Chaos's crash classes (`crash_step`, `crash`) kill a journaled engine's
process at a tick: straight away, after tearing the journal's last
record, or after writing the next snapshot without its COMMITTED marker.
The process supervisor (runtime/fault.py `ProcessSupervisor`) restarts a
dead or silent serving process; the engine touches `heartbeat_file` once
a tick and reports the supervisor's `restart_count`. No environment
variable is read: `journal_dir`, `heartbeat_file` and `restart_count` are
kwargs.

Not in the port yet: the mesh (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import heapq
import itertools
import os
import signal
import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.core.routing import stable_topk
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import (init_decode_state, paged_supported,
                                      prefill, prefill_chunk, serve_step)
from repro_torch.runtime.fault import RestartRequired, StepSupervisor
from repro_torch.serving.chaos import Chaos
from repro_torch.serving.journal import (EngineJournal, JournalError,
                                         request_from_record, request_record)
from repro_torch.serving.paging import PrefixIndex
from repro_torch.serving.pool import (SlotPool, from_host_payload,
                                      to_host_payload)
from repro_torch.serving.scheduler import (ExpertAwareScheduler,
                                           FIFOScheduler, QueueFull, Request,
                                           RequestStatus, RequestTooLarge)

# the submit-time gate probe reads at most this many leading prompt tokens,
# zero-padded to exactly this length (one shape for every prompt)
_PROBE_TOKENS = 64


def expert_signature(params, prompt, cfg) -> np.ndarray:
    """Predicted expert footprint of a prompt, bool [num_experts]: the
    experts each of its first _PROBE_TOKENS tokens would pick (top_k) if
    the layer-0 gate saw the token's embedding directly, on the params'
    device with one host read. A heuristic (the real gate input is the
    post-attention hidden state, deeper layers route on their own, tokens
    past the window are unseen) that steers admission order only."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)[:_PROBE_TOKENS]
    valid = int(prompt.shape[0])
    embed = params["embed"]
    tokens = torch.zeros(_PROBE_TOKENS, dtype=torch.long)
    tokens[:valid] = torch.from_numpy(prompt.astype(np.int64))
    x = embed[tokens.to(embed.device)].float()                # [P, d]
    gate = params["layers"]["moe"]["gate"][0].float()         # [d, E]
    _, idx = stable_topk(x @ gate, cfg.moe.top_k)
    sig = torch.zeros(cfg.moe.num_experts, dtype=torch.bool,
                      device=embed.device)
    sig[idx[:valid].reshape(-1)] = True                       # pad rows out
    return sig.cpu().numpy()


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}
_CHECKSUM_MOD = (1 << 61) - 1


def params_checksum(params) -> int:
    """An exact fingerprint of the weights: each tensor's bit patterns
    summed as integers (exact in any order, so the CPU and the card agree),
    folded in the tree's order. The journal stores it; recovery refuses
    weights that give another."""
    if isinstance(params, dict):
        leaves = [params_checksum(params[k]) for k in sorted(params)]
    elif isinstance(params, (list, tuple)):
        leaves = [params_checksum(p) for p in params]
    else:
        bits = params.detach().reshape(-1).view(
            _INT_OF_WIDTH[params.element_size()])
        return sum(int(part.sum(dtype=torch.int64))
                   for part in bits.split(1 << 26))
    h = 0
    for v in leaves:
        h = (h * 1_000_003 + v) % _CHECKSUM_MOD
    return h


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
                 prefix_share: bool = False, expert_aware: bool = False,
                 journal_dir: str | None = None, snapshot_every: int = 0,
                 heartbeat_file: str | None = None, restart_count: int = 0,
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
        if prefix_share and not paged:
            raise ValueError("prefix sharing needs a paged pool (it is "
                             "copy-on-write block-table surgery)")
        if expert_aware and cfg.moe is None:
            raise ValueError("expert-aware admission needs a plain-attention "
                             "MoE config (it scores routing overlap)")
        self.pool = SlotPool(cfg, num_slots, max_tokens, self.device,
                             paged=paged, page_size=page_size,
                             num_pages=num_pages)
        self.prefix_share = bool(prefix_share)
        self.expert_aware = bool(expert_aware)
        self.scheduler = (
            ExpertAwareScheduler(num_slots, max_tokens, max_queue,
                                 num_experts=cfg.moe.num_experts)
            if self.expert_aware
            else FIFOScheduler(num_slots, max_tokens, max_queue))
        self.prefix_index = (
            PrefixIndex(self.pool.alloc, self.pool.page_size)
            if self.prefix_share else None)
        self.prefix_hits = 0
        self.pages_shared = 0
        self.prefill_tokens_skipped = 0
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
        # --- durability (serving/journal.py) ---
        self.journal: EngineJournal | None = None
        self.recoveries = 0
        self.replayed_events = 0
        self.recovered_info: dict | None = None
        self.restart_count = int(restart_count)   # the supervisor's generation
        self._replay_expect: dict[int, list[int]] = {}
        self._tick_toks: dict[int, int] = {}
        self._heartbeat = heartbeat_file
        self._checksum: int | None = None
        self._engine_kw = dict(
            num_slots=num_slots, max_tokens=self.pool.max_tokens,
            max_queue=max_queue, paged=self.pool.paged,
            page_size=self.pool.page_size, num_pages=self.pool.num_pages,
            prefill_chunk=self.prefill_chunk, kv_quant=self.cfg.kv_quant,
            prompt_buckets=self.prompt_buckets, preemption=self.preemption,
            prefix_share=self.prefix_share, expert_aware=self.expert_aware)
        if journal_dir is not None:
            self._attach_journal(journal_dir, snapshot_every)

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
        submission / first admission: past either it retires TIMEOUT. An
        expert-aware engine fingerprints the prompt here. Raises
        RequestTooLarge for a request that could never fit the pool and
        QueueFull at max_queue."""
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
        if self.expert_aware:
            req.expert_sig = expert_signature(self.params, req.prompt,
                                              self.cfg)
        req.arrival_time = req.submit_time = time.monotonic()
        try:
            self.scheduler.submit(req, now_step=self.step_count)
        except QueueFull:
            self.rejected_full += 1
            raise
        except RequestTooLarge:
            self.rejected_oversized += 1
            raise
        if self.journal is not None:
            # after the scheduler's acceptance: a rejected request has no
            # lifecycle to recover
            self.journal.append("submit", req=request_record(req))
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
        token under the tick supervisor, quarantining non-finite rows. A
        journaled engine then writes the tick's record, commits a snapshot
        every `snapshot_every` ticks, touches its heartbeat file and lets
        chaos crash the process. Returns the requests finished on this
        tick."""
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
                if self.expert_aware:
                    # each admission changes the active batch: re-note it
                    self.scheduler.note_active(
                        [o.expert_sig for o in self.pool.owner
                         if o is not None])
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
                        req.prompt_len > self.prefill_chunk and \
                        self._full_hit(req) is None:
                    # a long prompt with no cached prefix: chunked prefill
                    # (a hit skips the prefill, so it does not wait for the
                    # chunk lane)
                    self._start_chunk_job(free[0], req)
                else:
                    self._admit_any(free[0], req, done)

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
                self._journal_token(req, tok)
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

        if self.journal is not None:
            if self._tick_toks:
                # ONE durable record a decode tick: the token watermark
                # every recovered stream is held to
                self.journal.append("tick", step=self.step_count,
                                    toks=dict(self._tick_toks))
                self._tick_toks.clear()
            if self.step_count - self.journal.last_snapshot_step >= \
                    self.journal.snapshot_every:
                self.journal.commit_snapshot(self._snapshot_payload(),
                                             self.step_count)
        if self._heartbeat:
            # liveness for the process supervisor (mtime staleness)
            with open(self._heartbeat, "a"):
                os.utime(self._heartbeat, None)
        self._maybe_crash()

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
        Request.tokens). The drain also flushes the prefix index (its
        released pages scrubbed), so a drained pool holds zero pages; an
        open-ended `while has_work(): step()` loop keeps it warm."""
        while self.has_work():
            self.step()
        if self.prefix_index is not None:
            self.pool.scrub_released(self.prefix_index.flush())
        return self.finished

    # -------------------------------------------------------------- internals

    def _supervised_decode(self) -> np.ndarray:
        """The decode tick under the StepSupervisor. Only chaos's injected
        tick fault, raised before the tick's first write, is retried; the
        tick writes the pool in place, so a failure inside it surfaces as
        RestartRequired (cause chained) with no retry (module docstring).
        On a journaled engine the caller exits and `recover()` resumes from
        the last committed snapshot, taken between ticks."""
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
        """Admission gate with page-pressure reclaim: the prefix index's
        node pins are opportunistic, a blocked admission is not, so while
        the request's pages are not reservable the index gives up its LRU
        entries (their released pages scrubbed). A refusal for pages counts
        one page wait."""
        ok = self._can_admit_now(req)
        while not ok and self.prefix_index is not None \
                and len(self.prefix_index) and not self.pool.can_admit(req):
            self.pool.scrub_released(self.prefix_index.reclaim_one())
            ok = self._can_admit_now(req)
        if ok is False:
            self.page_waits += 1
        return bool(ok)

    def _can_admit_now(self, req: Request) -> bool | None:
        """One evaluation of the gate: a paged pool must be able to reserve
        the request's worst-case pages, less the pages a prefix-index hit
        shares (a copy-on-write reference takes nothing from the free
        list); a to-be-chunked prompt without a hit waits for the single
        chunk lane (None: blocked by the lane, not by pages). A PREEMPTED
        head resumes from its snapshot: it needs only its remaining worst
        case and never re-prefills. A blocked head blocks the queue (no
        overtaking, so no starvation)."""
        snap = self._preempted.get(req.request_id)
        if snap is not None:
            return self.pool.can_resume(snap)
        if self.prefix_share:
            entry = self._full_hit(req)
            if entry is not None:
                return self.pool.alloc.can_reserve(
                    self.pool.pages_needed(req) - len(entry["nodes"]))
        if self.prefill_chunk and req.prompt_len > self.prefill_chunk \
                and self._chunk_job is not None:
            return None
        return self.pool.can_admit(req)

    # -------------------------------------------------------------- preemption

    def _preempt_for_head(self) -> bool:
        """The head of the admission heap is blocked on slots or pages:
        evict ONE active stream of strictly lower priority (the greatest
        priority value; then, expert-aware, the most experts no other
        stream needs; then the latest admission, the least work lost) and
        report whether one fell. The admission loop retries after each
        eviction, so as many fall as the head needs. An
        ExpertAwareScheduler's head is the candidate its cost model chose
        before the gate refused it (`last_blocked`)."""
        if not (self.pool.paged and self.scheduler.queue):
            return False
        head = getattr(self.scheduler, "last_blocked", None) or \
            self.scheduler.queue[0][2]
        if head.request_id not in self._preempted and self.prefill_chunk \
                and head.prompt_len > self.prefill_chunk \
                and self._full_hit(head) is None \
                and self._chunk_job is not None:
            return False     # blocked on the chunk LANE: eviction can't help
        victims = [(owner.priority, self._victim_rank(slot),
                    owner.admit_step, slot)
                   for slot, owner in enumerate(self.pool.owner)
                   if owner is not None and owner.priority > head.priority]
        if not victims:
            return False
        self._preempt(max(victims)[3])
        return True

    def _victim_rank(self, slot: int) -> int:
        """Preemption cost model of an expert-aware engine: a victim
        touching more experts nobody else needs ranks higher. 0 under the
        FIFOScheduler, so the (priority, admit_step) order stands."""
        if not self.expert_aware:
            return 0
        others = [o.expert_sig for s, o in enumerate(self.pool.owner)
                  if o is not None and s != slot]
        return self.scheduler.victim_bonus(
            self.pool.owner[slot].expert_sig, others)

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
                 done: list[Request], page_row=None, *,
                 deposit: bool = True) -> None:
        """Shared tail of one-shot and chunked admission: emit the first
        token, splat the prefilled state into the pool row, and retire at
        once on EOS or a one-token request. Non-finite prefill logits
        quarantine the request to FAILED before it occupies the slot (a
        chunk run's claimed pages are scrubbed and freed). An expert-aware
        engine refines the signature and feeds the load EWMAs; with prefix
        sharing the prompt deposits its artifacts (`deposit=False` for a
        chunk run: its routing ran at chunk capacities, so its GO rows and
        logits are not the one-shot ones an entry promises)."""
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
        self._journal_token(req, first, install=True)
        self.pool.admit(slot, req, slot_state, first, page_row=page_row,
                        generator=gen)
        if self.expert_aware:
            self._refine_sig(slot, req)
            self.scheduler.observe(req.expert_sig)
        if deposit:
            self._deposit(slot, req, logits)
        self._note_occupancy()       # before a possible instant retirement
        if self.pool.remaining[slot] <= 0 or \
                (req.eos_id is not None and first == req.eos_id):
            self._retire_slot(slot, RequestStatus.DONE, done)

    def _refine_sig(self, slot: int, req: Request) -> None:
        """Replace the submit-time probe with the routing the prefill
        OBSERVED, where it is observable: an expert-choice GO cache records
        which (layer, expert, token) pairs were kept (one host read).
        Unless that union covers every expert (expert choice fills every
        expert once the prompt is long enough): an all-experts signature
        carries no grouping signal, so the probe stays."""
        if "go" not in self.pool.state:
            return
        tid = self.pool.state["go"].token_ids[:, slot]          # [L, E, k]
        sig = (tid >= 0).any(dim=2).any(dim=0).cpu().numpy()
        if not sig.all():
            req.expert_sig = sig

    # --------------------------------------------------------- prefix sharing

    def _full_hit(self, req: Request):
        """The exact full-prompt prefix-index entry for `req`, or None."""
        if self.prefix_index is None:
            return None
        return self.prefix_index.lookup_full(req.prompt)

    def _admit_any(self, slot: int, req: Request,
                   done: list[Request]) -> None:
        """Admission dispatch: a full-prompt cache hit (no prefill), or a
        cold one-shot prefill."""
        entry = self._full_hit(req)
        if entry is not None:
            self._admit_from_cache(slot, req, entry, done)
            return
        self._admit(slot, req, done)

    def _admit_from_cache(self, slot: int, req: Request, entry: dict,
                          done: list[Request]) -> None:
        """Zero-prefill admission from a full-prompt entry: block-table
        surgery (SlotPool.admit_from_prefix) instead of a prefill. The first
        token comes from the entry's cached prefill logits, the donor's own
        (already checked finite), so a greedy stream equals a cold
        admission's and a sampling request draws under its own temperature
        and generator."""
        shared = self.prefix_index.entry_pages(entry)
        first, gen = self._first_token(req, entry["logits"])
        req.admit_step = self.step_count
        req.admit_time = time.monotonic()
        req.status = RequestStatus.ACTIVE
        req.tokens.append(first)
        self._journal_token(req, first, install=True)
        self.pool.admit_from_prefix(slot, req, shared, entry, first,
                                    generator=gen)
        if req.expert_sig is None and entry["sig"] is not None:
            req.expert_sig = entry["sig"]
        if self.expert_aware:
            self.scheduler.observe(req.expert_sig)
        self.prefix_hits += 1
        self.pages_shared += len(shared)
        self.prefill_tokens_skipped += req.prompt_len
        self._note_occupancy()
        if self.pool.remaining[slot] <= 0 or \
                (req.eos_id is not None and first == req.eos_id):
            self._retire_slot(slot, RequestStatus.DONE, done)

    def _deposit(self, slot: int, req: Request, logits) -> None:
        """Record a freshly admitted prompt in the prefix index: pin its
        full pages as radix nodes (a refcount each; nothing moves) and keep
        device clones of what pages alone cannot give a consumer: the tail
        KV past the last full page (and its page's scales on int8 pages),
        the GO rows (and scales) and the prefill logits. Clones, not views:
        the donor's decode rewrites its GO rows and its tail page (and
        rescales it on int8 pages), and its private pages go to other
        requests once it retires. Device to device: no host copy."""
        idx = self.prefix_index
        if idx is None:
            return
        ps = self.pool.page_size
        st = self.pool.state
        row = self.pool.block_table[slot]
        n_full = req.prompt_len // ps
        tail = req.prompt_len - n_full * ps
        tail_k = tail_v = tail_ks = tail_vs = None
        if tail:
            pid = int(row[n_full])
            tail_k = st["k_pages"][:, pid, :tail].clone()
            tail_v = st["v_pages"][:, pid, :tail].clone()
            if self.pool.quant:
                tail_ks = st["k_scales"][:, pid].clone()
                tail_vs = st["v_scales"][:, pid].clone()
        go = (tuple(a[:, slot].clone() for a in st["go"])
              if "go" in st else None)
        go_scales = (st["go_scales"][:, slot].clone()
                     if "go_scales" in st else None)
        released = idx.deposit(
            req.prompt, row[:n_full], tail_k=tail_k, tail_v=tail_v, go=go,
            logits=logits.reshape(1, -1).clone(), sig=req.expert_sig,
            tail_ks=tail_ks, tail_vs=tail_vs, go_scales=go_scales)
        self.pool.scrub_released(released)

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
                          page_row=job.page_row, deposit=False)

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
        if self.journal is not None:
            self.journal.append("terminal", rid=req.request_id,
                                status=status.value, reason=reason)

    # -------------------------------------------------------------- durability

    def _attach_journal(self, directory: str, snapshot_every: int = 0) -> None:
        """Open the engine's write-ahead journal and commit the first
        snapshot. Journaling rides on the paged pool's snapshots
        (SlotPool.snapshot), so a dense pool refuses it."""
        if not self.pool.paged:
            raise ValueError("journaling needs a paged pool (engine "
                             "snapshots are SlotPool.snapshot block-table "
                             "surgery)")
        self.journal = EngineJournal(directory,
                                     snapshot_every=snapshot_every or 32)
        self.journal.commit_snapshot(self._snapshot_payload(),
                                     self.step_count)

    def _journal_token(self, req: Request, tok: int, *,
                       install: bool = False) -> None:
        """Journal one emitted token and hold it to the replay oracle: the
        tokens the CRASHED process journaled past its snapshot must be
        re-emitted bit for bit before anything new."""
        exp = self._replay_expect.get(req.request_id)
        if exp:
            want = exp.pop(0)
            if not exp:
                del self._replay_expect[req.request_id]
            assert tok == want, (
                f"recovery divergence: request {req.request_id} emitted "
                f"token {tok} where the journal watermark says {want}")
        if self.journal is None:
            return
        if install:
            self.journal.append("install", rid=req.request_id,
                                step=self.step_count, token=tok)
        else:
            self._tick_toks[req.request_id] = tok

    def _maybe_crash(self) -> None:
        """Chaos's crash classes: SIGKILL this process at this tick straight
        away ("kill"), after tearing the journal's last record ("torn"),
        or after writing the next snapshot WITHOUT its COMMITTED marker
        ("snap"). Journaled engines only: recover() must undo the damage."""
        if self.journal is None or self.chaos is None:
            return
        crash = self.chaos.crash_event(self.step_count)
        if crash is None:
            return
        if crash == "torn":
            self.journal.tear_tail(
                self.chaos.torn_cut(self.journal._last_record_bytes))
        elif crash == "snap":
            self.journal.write_uncommitted_snapshot(self._snapshot_payload())
        os.kill(os.getpid(), signal.SIGKILL)

    def _snapshot_payload(self) -> dict:
        """The whole engine at this tick boundary, in the journal's numpy
        form (`to_host_payload`): the contents of every page that several
        holders map (copy-on-write prefix pages: live slots and the prefix
        index's node pins) saved once by physical id, every live slot's
        SlotPool.snapshot (its private pages, its shared ones by id, GO
        rows, cursor, generator state), the scheduler's heaps, the parked
        preemption snapshots, the prefix index (structure and entries), the
        load EWMAs, the counters, and the config's name and the params'
        checksum that recovery holds the caller's to. A chunk job is
        recorded as its REQUEST only: recovery queues it again and reruns
        its chunked prefill, deterministic per chunking. The PageAllocator
        is not saved: restoring re-reserves and re-allocates, under fresh
        physical ids (ids are invisible to streams)."""
        live = [(slot, req) for slot, req in enumerate(self.pool.owner)
                if req is not None]
        holders: Counter[int] = Counter()
        for slot, _ in live:
            r = self.pool.block_table[slot]
            holders.update(int(p) for p in r[r != 0])
        nodes = (self.prefix_index.node_pages()
                 if self.prefix_index is not None else [])
        holders.update(nodes)
        ids = sorted({p for p, n in holders.items() if n > 1} | set(nodes))
        pages = None
        if ids:
            idx = torch.tensor(ids, dtype=torch.long, device=self.device)
            pages = {"ids": ids, **{
                key: self.pool.state[name].index_select(1, idx)
                for key, name in self._page_tensors()}}
        shared = frozenset(ids)
        slots = [(slot, request_record(req, runtime=True),
                  self.pool.snapshot(slot, shared))
                 for slot, req in live]
        job = self._chunk_job
        reqs = ([r for _, _, r in self.scheduler.queue] +
                [r for _, _, r in self.scheduler._pending] +
                [req for _, req in live] +
                list(self.finished.values()) +
                ([job.req] if job is not None else []))
        prefix = (self.prefix_index.snapshot_state(to_host_payload)
                  if self.prefix_index is not None else None)
        return to_host_payload({
            "meta": {
                "step": self.step_count,
                "recoveries": self.recoveries,
                "next_id": self._next_id,
                "seq_next": max((r.seq for r in reqs), default=-1) + 1,
                "snapshot_every": (self.journal.snapshot_every
                                   if self.journal is not None else 32),
                "cfg": self.cfg.name,
                "params_checksum": self._params_checksum(),
            },
            "engine_kw": dict(self._engine_kw),
            "pages": pages,
            "slots": slots,
            "queued": [request_record(r, runtime=True)
                       for _, _, r in self.scheduler.queue],
            "pending": [request_record(r, runtime=True)
                        for _, _, r in self.scheduler._pending],
            "chunk_req": (request_record(job.req, runtime=True)
                          if job is not None else None),
            "preempted": dict(self._preempted),
            "finished": [request_record(r, runtime=True)
                         for r in self.finished.values()],
            "prefix": prefix,
            "sched_load": (self.scheduler.load.copy()
                           if self.expert_aware else None),
            "counters": {
                "admitted_total": self.pool.admitted_total,
                "preempted_total": self.preempted_total,
                "resumed_total": self.resumed_total,
                "rejected_full": self.rejected_full,
                "rejected_oversized": self.rejected_oversized,
                "peak_active": self.peak_active,
                "chunk_ticks": self.chunk_ticks,
                "decode_ticks": self.decode_ticks,
                "page_waits": self.page_waits,
                "prefix_hits": self.prefix_hits,
                "pages_shared": self.pages_shared,
                "prefill_tokens_skipped": self.prefill_tokens_skipped,
            },
        })

    def _params_checksum(self) -> int:
        if self._checksum is None:
            self._checksum = params_checksum(self.params)
        return self._checksum

    def _page_tensors(self) -> list[tuple[str, str]]:
        """(payload key, pool state name) of the page tensors the journal
        saves of a shared page: K and V, and their scales on int8 pages."""
        return [("k", "k_pages"), ("v", "v_pages")] + (
            [("ks", "k_scales"), ("vs", "v_scales")] if self.pool.quant
            else [])

    def _restore_shared_pages(self, pages: dict | None, owner: int
                              ) -> dict[int, int]:
        """Write a snapshot's shared pages into fresh pages held by the
        temporary `owner` (`index_copy_`) and return the old -> new id
        map. The restored slots and the prefix index's nodes then map them
        copy-on-write, and freeing `owner` leaves them held by those alone,
        so slots that fit only by sharing still fit after recovery."""
        if pages is None:
            return {}
        ids = [int(p) for p in pages["ids"]]
        self.pool.alloc.reserve(owner, len(ids))
        fresh = self.pool.alloc.alloc(owner, len(ids))
        idx = torch.tensor(fresh, dtype=torch.long, device=self.device)
        for key, name in self._page_tensors():
            self.pool.state[name].index_copy_(
                1, idx, from_host_payload(pages[key], self.device))
        return dict(zip(ids, fresh))

    @classmethod
    def recover(cls, journal_dir: str, params, cfg, *, device=None,
                chaos: Chaos | None = None, snapshot_every: int = 0,
                **overrides) -> "ServingEngine":
        """Rebuild a crashed engine from its journal directory: restore the
        latest COMMITTED snapshot (uncommitted crash artifacts are skipped),
        replay the journal's tail and commit a fresh snapshot. Raises
        JournalError if the snapshot was written for another config name or
        other weights (`params_checksum`).

        The snapshot's shared pages are written into fresh pages first
        (`_restore_shared_pages`); slots live at the snapshot resume
        through SlotPool.restore, mapping those copy-on-write, and the
        prefix index's nodes pin them again (beyond the reference, which
        gives every restored slot private pages and the index pages of its
        own, so a pool that fit only by sharing could not be restored); decode
        is deterministic given the restored pages, GO rows, cursor and
        generator state, so greedy AND sampled streams continue as in the
        uninterrupted run. Requests submitted after the snapshot, and a
        chunk job's request, are queued again and prefilled anew
        (deterministic too). Tokens the dead process journaled past the
        snapshot become the replay oracle (`_journal_token`). Of the
        terminal events only CANCELLED replays (an outside decision); DONE,
        TIMEOUT and FAILED are recomputed by running, wall budgets
        re-anchored at recovery. `overrides` replace the saved engine
        kwargs (and pass `heartbeat_file`, `restart_count`).
        `recovered_info` gives the snapshot's seq, the events replayed and
        the ms of the load, the restore, the replay and the fresh commit."""
        t0 = time.perf_counter()
        latest = EngineJournal.latest_committed(journal_dir)
        if latest is None:
            raise JournalError(
                f"no committed snapshot under {journal_dir!r}: nothing to "
                "recover from")
        seq, payload = latest
        t_load = time.perf_counter()
        meta = payload["meta"]
        checksum = params_checksum(params)
        if (meta["cfg"], meta["params_checksum"]) != (cfg.name, checksum):
            raise JournalError(
                f"the journal under {journal_dir!r} was written by "
                f"{meta['cfg']} with params checksum "
                f"{meta['params_checksum']}; recovery was given {cfg.name} "
                f"with {checksum}: its streams would go on under another "
                "model")
        kw = dict(payload["engine_kw"])
        kw.update(overrides)
        eng = cls(params, cfg, device=device, chaos=chaos, **kw)
        eng._checksum = checksum
        eng.step_count = meta["step"]
        eng.recoveries = meta["recoveries"] + 1
        eng._next_id = meta["next_id"]
        seq_next = meta["seq_next"]
        for rec in payload["finished"]:
            req = request_from_record(rec)
            eng.finished[req.request_id] = req
        for rec in payload["queued"]:
            req = request_from_record(rec)
            heapq.heappush(eng.scheduler.queue,
                           (req.priority, req.seq, req))
        for rec in payload["pending"]:
            req = request_from_record(rec)
            heapq.heappush(eng.scheduler._pending,
                           (req.arrival_step, req.seq, req))
        if payload["chunk_req"] is not None:
            # the interrupted chunk run prefills again from its first chunk;
            # its original seq keeps its place in the admission order
            req = request_from_record(payload["chunk_req"])
            req.status = RequestStatus.QUEUED
            heapq.heappush(eng.scheduler.queue,
                           (req.priority, req.seq, req))
        # parked snapshots stay on the host until their resume, as CPU
        # tensors and a generator (what SlotPool.snapshot gives)
        eng._preempted = {rid: from_host_payload(snap)
                          for rid, snap in payload["preempted"].items()}
        tmp = -(10 ** 9)        # disjoint from request ids and node owners
        page_map = eng._restore_shared_pages(payload["pages"], tmp)
        for slot, rec, snap in payload["slots"]:
            eng.pool.restore(slot, request_from_record(rec),
                             from_host_payload(snap), page_map)
        if eng.prefix_index is not None and payload["prefix"] is not None:
            eng.prefix_index.restore_state(
                payload["prefix"], page_map,
                lambda e: from_host_payload(e, eng.device))
        # the slots' and the nodes' references keep every page alive
        eng.pool.release_pages(tmp)
        if eng.expert_aware and payload["sched_load"] is not None:
            eng.scheduler.load[:] = payload["sched_load"]
        for name, val in payload["counters"].items():
            if name == "admitted_total":
                eng.pool.admitted_total = val   # pool.restore counted too
            else:
                setattr(eng, name, val)
        t_restore = time.perf_counter()
        # --- replay the journal's tail (a torn tail is already dropped) ---
        events = EngineJournal.read_tail(journal_dir, seq)
        cancelled: list[int] = []
        for kind, p in events:
            if kind == "submit":
                req = request_from_record(p["req"])
                heap, key = ((eng.scheduler._pending, req.arrival_step)
                             if req.arrival_step > eng.step_count
                             else (eng.scheduler.queue, req.priority))
                heapq.heappush(heap, (key, req.seq, req))
                eng._next_id = max(eng._next_id, req.request_id + 1)
                seq_next = max(seq_next, req.seq + 1)
            elif kind == "install":
                eng._replay_expect.setdefault(p["rid"], []).append(p["token"])
            elif kind == "tick":
                for rid, tok in p["toks"].items():
                    eng._replay_expect.setdefault(rid, []).append(tok)
            elif kind == "terminal" and \
                    p["status"] == RequestStatus.CANCELLED.value:
                cancelled.append(p["rid"])
        eng.scheduler._seq = itertools.count(seq_next)
        eng.replayed_events = len(events)
        t_replay = time.perf_counter()
        # a fresh snapshot collapses the replayed tail: a second crash
        # re-runs from HERE, never from the torn log
        eng._attach_journal(journal_dir,
                            snapshot_every or meta["snapshot_every"])
        for rid in cancelled:
            eng.cancel(rid)
        t_end = time.perf_counter()
        eng.recovered_info = {
            "snapshot_seq": seq,
            "events": len(events),
            "load_ms": (t_load - t0) * 1e3,
            "restore_ms": (t_restore - t_load) * 1e3,
            "replay_ms": (t_replay - t_restore) * 1e3,
            "commit_ms": (t_end - t_replay) * 1e3,
            "wall_ms": (t_end - t0) * 1e3,
        }
        return eng

    def _audit(self) -> None:
        """The invariant sweep of `audit_every_tick`: the pool's
        (SlotPool.audit), then the engine's cross-checks: page refcounts
        equal the live references (slot block tables, the chunk run's
        claimed row and the prefix index's node pins), the chunk lane's
        slot stays unoccupied, and parked preempted requests are neither
        active nor finished."""
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
            if self.prefix_index is not None:
                refs.update(self.prefix_index.node_pages())
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
            # --- prefix sharing, expert-aware admission ---
            "prefix_share": self.prefix_share,
            "expert_aware": self.expert_aware,
            "prefix_hits": self.prefix_hits,
            "pages_shared": self.pages_shared,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            # --- fault domain ---
            "statuses": dict(Counter(r.status.value for r in reqs)),
            "preemptions": self.preempted_total,
            "resumes": self.resumed_total,
            "preempted_waiting": len(self._preempted),
            "tick_retries": self.supervisor.stats.retries,
            "chaos": (dict(self.chaos.injected)
                      if self.chaos is not None else None),
            # --- durability ---
            "recoveries": self.recoveries,
            "restart_count": self.restart_count,
            "replayed_events": self.replayed_events,
            "journal_bytes": (self.journal.bytes_written
                              if self.journal is not None else 0),
            "snapshots": (self.journal.snapshots_committed
                          if self.journal is not None else 0),
            "snapshot_age_ticks": (
                self.step_count - self.journal.last_snapshot_step
                if self.journal is not None else None),
        }
