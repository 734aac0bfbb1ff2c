"""Continuous-batching serving over the KV + GO cache pool (counterpart of
repro/serving, the engine's core):

  scheduler  priority-heap admission (FIFO within a level) and the
             max-slots / max-tokens policy (host-side)
  paging     host page allocator for the paged KV pool (reservations,
             lazy growth, the null page)
  pool       fixed-width slot pool owning the pooled decode state: dense
             per-slot KV rows or the paged block-table pool
  engine     admit -> prefill (one-shot or chunked) -> batched decode ->
             retire
"""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.pool import SlotPool
from repro_torch.serving.scheduler import (FIFOScheduler, QueueFull, Request,
                                           RequestStatus, RequestTooLarge)

__all__ = ["ServingEngine", "SlotPool", "FIFOScheduler", "PageAllocator",
           "Request", "RequestStatus", "QueueFull", "RequestTooLarge"]
