"""Admission scheduling for the continuous-batching engine.

A copy of the reference package's host-side scheduler
(repro/serving/scheduler.py), cut to what the port's engine uses: the request
record with its wall budgets, its lifecycle status, the typed submit-time
rejections and the priority-heap FIFO scheduler with requeue (preemption),
remove (cancel) and expire (deadlines). Host-only: numpy, no torch.

  max_slots   pool width: at most this many requests in flight at once
  max_tokens  pool sequence capacity: prompt + generation of every request
              must fit (enforced at submit; nothing is silently truncated)
  max_queue   optional backlog bound (0 = unbounded) over queued AND
              not-yet-arrived trace requests; submit raises when it is full

Admission order is a priority heap: lower `priority` is admitted earlier,
ties break by submission order (FIFO within a level). A `can_admit`
predicate (the paged pool's "are enough pages reservable?") gates the HEAD
only: a blocked head blocks everything behind it, which keeps the order
starvation-free. Requests with an `arrival_step` wait in a pending heap
until the engine's tick counter reaches it (trace replay).
"""
from __future__ import annotations

import enum
import heapq
import itertools
from dataclasses import dataclass, field

import numpy as np


class RequestStatus(str, enum.Enum):
    """Request lifecycle states. str-mixin so `status == "DONE"` works."""

    QUEUED = "QUEUED"          # waiting for admission (incl. trace-deferred)
    ACTIVE = "ACTIVE"          # occupying a slot (prefilling or decoding)
    PREEMPTED = "PREEMPTED"    # evicted under page pressure, awaiting resume
    DONE = "DONE"              # terminal: EOS or length
    TIMEOUT = "TIMEOUT"        # terminal: deadline_s / max_wall_s exceeded
    CANCELLED = "CANCELLED"    # terminal: engine.cancel(rid)
    FAILED = "FAILED"          # terminal: quarantined (non-finite logits)


TERMINAL_STATUSES = frozenset({
    RequestStatus.DONE, RequestStatus.TIMEOUT,
    RequestStatus.CANCELLED, RequestStatus.FAILED,
})


class QueueFull(RuntimeError):
    """Typed backpressure signal: the admission backlog is at max_queue.
    Carries the observed depth so callers can shed load proportionally."""

    def __init__(self, depth: int, max_queue: int):
        self.depth = depth
        self.max_queue = max_queue
        super().__init__(
            f"admission queue full: depth {depth} >= max_queue {max_queue}")


class RequestTooLarge(ValueError):
    """Typed submit-time rejection: the request could never fit the pool
    (prompt + max_new_tokens over max_tokens, or over the paged pool's
    usable page count), so admitting it would stall the queue forever."""


@dataclass
class Request:
    """One generation request plus its lifecycle bookkeeping."""

    request_id: int
    prompt: np.ndarray               # [T] int32 token ids
    max_new_tokens: int
    eos_id: int | None = None
    arrival_step: int = 0            # engine step at which the request arrives
    priority: int = 0                # admission class: lower = admitted first
    temperature: float = 0.0         # > 0 samples; 0 decodes greedily
    top_p: float = 1.0               # nucleus mass kept when sampling
    seed: int | None = None          # sampling seed (None: the request id)
    deadline_s: float | None = None  # wall budget from submission
    max_wall_s: float | None = None  # wall budget from FIRST admission

    # --- filled in by the engine ---
    status: RequestStatus = RequestStatus.QUEUED
    fail_reason: str | None = None   # set on FAILED/TIMEOUT/CANCELLED
    arrival_time: float = 0.0        # wall-clock when it joined the queue
    submit_time: float = 0.0         # wall-clock at submit (deadline_s anchor)
    admit_time: float = 0.0          # wall-clock at FIRST admission
    admit_step: int = -1
    finish_step: int = -1
    finish_time: float = 0.0
    slot: int = -1                   # slot it was admitted into
    seq: int = -1                    # scheduler submit order (heap tie-break)
    preemptions: int = 0             # times evicted under page pressure
    tokens: list[int] = field(default_factory=list)

    @property
    def latency_s(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def expired(self, now: float) -> bool:
        """Has either wall budget run out? deadline_s counts from submit
        (queue wait included); max_wall_s counts from first admission and
        keeps counting across preemptions (a parked request still holds a
        snapshot)."""
        if self.deadline_s is not None and \
                now - self.submit_time > self.deadline_s:
            return True
        if self.max_wall_s is not None and self.admit_time > 0 and \
                now - self.admit_time > self.max_wall_s:
            return True
        return False


class FIFOScheduler:
    """Priority-heap admission (FIFO within a level) with the max-slots /
    max-tokens policy."""

    def __init__(self, max_slots: int, max_tokens: int, max_queue: int = 0):
        self.max_slots = max_slots
        self.max_tokens = max_tokens
        self.max_queue = max_queue
        self.queue: list[tuple[int, int, Request]] = []      # (prio, seq, req)
        self._pending: list[tuple[int, int, Request]] = []   # arrival-step heap
        self._seq = itertools.count()                        # submit order

    def submit(self, req: Request, *, now_step: int = 0) -> None:
        """Queue a request (immediately, or at its arrival_step if later).
        Raises RequestTooLarge for a request that could never fit the pool,
        QueueFull (carrying the depth) at max_queue."""
        need = req.prompt_len + req.max_new_tokens
        if need > self.max_tokens:
            raise RequestTooLarge(
                f"request {req.request_id}: prompt({req.prompt_len}) + "
                f"max_new_tokens({req.max_new_tokens}) = {need} exceeds the "
                f"pool's max_tokens={self.max_tokens}")
        backlog = len(self.queue) + len(self._pending)
        if self.max_queue and backlog >= self.max_queue:
            raise QueueFull(backlog, self.max_queue)
        req.seq = next(self._seq)
        req.status = RequestStatus.QUEUED
        if req.arrival_step > now_step:
            heapq.heappush(self._pending, (req.arrival_step, req.seq, req))
            return
        heapq.heappush(self.queue, (req.priority, req.seq, req))

    def requeue(self, req: Request) -> None:
        """Put a PREEMPTED request back in the admission heap under its
        ORIGINAL submit order, so it resumes ahead of everything submitted
        after it in its priority class. Bypasses max_queue: the request was
        admitted once already."""
        if req.seq < 0:
            raise ValueError("requeue() is for previously submitted requests")
        heapq.heappush(self.queue, (req.priority, req.seq, req))

    def poll(self, step: int) -> list[Request]:
        """Move trace-replay requests whose arrival step has come into the
        admission heap; returns the newly arrived requests."""
        arrived = []
        while self._pending and self._pending[0][0] <= step:
            _, seq, req = heapq.heappop(self._pending)
            heapq.heappush(self.queue, (req.priority, seq, req))
            arrived.append(req)
        return arrived

    def next_admission(self, num_active: int,
                       can_admit=None) -> Request | None:
        """Pop the next request to admit, or None (empty heap, the pool is
        already at max_slots, or `can_admit` rejects the head)."""
        if not self.queue or num_active >= self.max_slots:
            return None
        head = self.queue[0][2]
        if can_admit is not None and not can_admit(head):
            return None
        return heapq.heappop(self.queue)[2]

    def remove(self, rid: int) -> Request | None:
        """Pull a request out of the admission heap or the pending trace
        heap by id (cancellation before admission). Returns it, or None if
        it is not queued here."""
        for heap in (self.queue, self._pending):
            for i, (_, _, req) in enumerate(heap):
                if req.request_id == rid:
                    heap.pop(i)
                    heapq.heapify(heap)
                    return req
        return None

    def expire(self, now: float) -> list[Request]:
        """Drop every queued or pending request whose wall budget has run
        out (Request.expired) and return them; the engine marks them
        TIMEOUT. Covers PREEMPTED requests parked here awaiting resume."""
        out = [req for _, _, req in self.queue if req.expired(now)]
        out += [req for _, _, req in self._pending if req.expired(now)]
        if out:
            gone = {r.request_id for r in out}
            self.queue = [e for e in self.queue
                          if e[2].request_id not in gone]
            heapq.heapify(self.queue)
            self._pending = [e for e in self._pending
                             if e[2].request_id not in gone]
            heapq.heapify(self._pending)
        return out

    def has_pending(self) -> bool:
        return bool(self.queue) or bool(self._pending)

    def next_arrival_step(self) -> int | None:
        """Earliest future arrival step (None when no trace-replay requests
        remain): lets an idle engine fast-forward its tick counter."""
        return self._pending[0][0] if self._pending else None
