"""Continuous-batching serving over the KV + GO cache pool (counterpart of
repro/serving, the engine's core):

  scheduler  priority-heap admission (FIFO within a level) and the
             max-slots / max-tokens policy (host-side), with requeue,
             remove and expire for the fault domain; the expert-aware
             scheduler (routing-overlap order within a priority class)
  paging     host page allocator for the paged KV pool (reservations,
             lazy growth, the null page, refcounted copy-on-write sharing,
             scrub marks) and the prefix index over prompts
  pool       fixed-width slot pool owning the pooled decode state: dense
             per-slot KV rows or the paged block-table pool; snapshots,
             restore, admission from a prefix entry, the NaN poison (with
             its fork of a shared page) and scrub, the audit
  engine     admit -> prefill (one-shot, chunked, or none on a prefix
             hit) -> batched decode -> retire; the request-lifecycle fault
             domain (deadlines, cancel, preemption and resume, NaN
             quarantine, the tick supervisor); the gate probe
             (expert_signature)
  chaos      seeded fault injector (no environment lane)
"""
from repro_torch.serving.chaos import Chaos, ChaosError
from repro_torch.serving.engine import ServingEngine, expert_signature
from repro_torch.serving.paging import PageAllocator, PrefixIndex
from repro_torch.serving.pool import SlotPool
from repro_torch.serving.scheduler import (TERMINAL_STATUSES,
                                           ExpertAwareScheduler,
                                           FIFOScheduler, QueueFull, Request,
                                           RequestStatus, RequestTooLarge)

__all__ = ["ServingEngine", "SlotPool", "FIFOScheduler",
           "ExpertAwareScheduler", "PageAllocator", "PrefixIndex",
           "expert_signature", "Request", "RequestStatus",
           "TERMINAL_STATUSES", "QueueFull", "RequestTooLarge", "Chaos",
           "ChaosError"]
