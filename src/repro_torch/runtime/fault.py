"""Step supervision: retry policy, give-up signal and straggler detection.

A copy of the reference package's `RestartRequired`, `StepStats` and
`StepSupervisor` (repro/runtime/fault.py). The reference's `_block`
(JAX's `block_until_ready`, which makes asynchronous dispatch errors
surface inside the supervised region) is left out: the port's serving
tick ends in its one host read, which already waits for the device.
`ProcessSupervisor` comes with the journal (ROADMAP.md Queue 1 item 7).

`StepSupervisor.run` retries a failed step up to `max_retries` times with
the same inputs, raises `RestartRequired` (the give-up signal, never
retried) past that, and records each step's wall time, flagging a step
slower than median * straggler_factor.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


class RestartRequired(RuntimeError):
    """Raised when a step cannot be completed in place; the caller must
    restore from its latest committed state."""


@dataclass
class StepStats:
    times: list = field(default_factory=list)
    retries: int = 0
    stragglers: list = field(default_factory=list)

    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[len(s) // 2]


class StepSupervisor:
    """Runs one step with retry and timing. `retry_on` names the transient
    error classes (RestartRequired is never retried: it IS the give-up
    signal)."""

    def __init__(self, max_retries: int = 2, straggler_factor: float = 3.0,
                 on_straggler=None,
                 retry_on: tuple = (RuntimeError, ValueError)):
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self.retry_on = tuple(retry_on)
        self.stats = StepStats()

    def run(self, step_fn, *args, step: int = -1, **kw):
        """Execute step_fn with retry and timing. Returns its result."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                out = step_fn(*args, **kw)
                break
            except self.retry_on as e:
                if isinstance(e, RestartRequired):
                    raise
                attempt += 1
                self.stats.retries += 1
                if attempt > self.max_retries:
                    raise RestartRequired(
                        f"step {step} failed {attempt} times: {e}") from e
        dt = time.perf_counter() - t0
        med = self.stats.median()
        self.stats.times.append(dt)
        if med > 0 and dt > med * self.straggler_factor:
            self.stats.stragglers.append((step, dt, med))
            if self.on_straggler is not None:
                self.on_straggler(step, dt, med)
        return out
