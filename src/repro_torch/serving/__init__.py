"""Continuous-batching serving over the KV + GO cache pool (counterpart of
repro/serving, the engine's core):

  scheduler  priority-heap admission (FIFO within a level) and the
             max-slots / max-tokens policy (host-side), with requeue,
             remove and expire for the fault domain
  paging     host page allocator for the paged KV pool (reservations,
             lazy growth, the null page, refcounts, scrub marks)
  pool       fixed-width slot pool owning the pooled decode state: dense
             per-slot KV rows or the paged block-table pool; snapshots,
             restore, the NaN poison and scrub, the audit
  engine     admit -> prefill (one-shot or chunked) -> batched decode ->
             retire; the request-lifecycle fault domain (deadlines,
             cancel, preemption and resume, NaN quarantine, the tick
             supervisor)
  chaos      seeded fault injector (no environment lane)
"""
from repro_torch.serving.chaos import Chaos, ChaosError
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.pool import SlotPool
from repro_torch.serving.scheduler import (TERMINAL_STATUSES, FIFOScheduler,
                                           QueueFull, Request, RequestStatus,
                                           RequestTooLarge)

__all__ = ["ServingEngine", "SlotPool", "FIFOScheduler", "PageAllocator",
           "Request", "RequestStatus", "TERMINAL_STATUSES", "QueueFull",
           "RequestTooLarge", "Chaos", "ChaosError"]
