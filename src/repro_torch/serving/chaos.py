"""Seeded fault injection for the serving engine.

A copy of the reference package's injector (repro/serving/chaos.py
`Chaos`, `ChaosError`) without its environment constructor: the port
reads no environment, so a caller builds `Chaos(...)` and passes it as
`ServingEngine(chaos=)`. The fields, the seeded
`np.random.default_rng(seed)` and the order of draws inside every event
method are the reference's, so an engine that calls the events in the
reference's order injects the same faults from the same seed.

It forces the faults the engine's fault domain claims to survive:
transient tick failures (the supervisor retries), admission pressure
(admissions wait a tick, never reorder), forced preemptions (snapshot and
restore must stay bit-identical) and poisoned decode state (the NaN
quarantine fails ONE slot). The crash fields (`crash`, `crash_step`,
`crash_class`) fire, as the reference's do, only in a journaled engine,
whose `_maybe_crash` SIGKILLs its own process after the tick (after
tearing the journal's last record for "torn", after writing an
uncommitted snapshot for "snap").
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class ChaosError(RuntimeError):
    """An injected transient tick failure. RuntimeError, so the serving
    supervisor's default `retry_on` catches it."""


_CRASH_CLASSES = ("kill", "torn", "snap")


@dataclass
class Chaos:
    """Seeded fault injector; all rates are per-tick probabilities."""

    seed: int = 0
    tick_fail: float = 0.0    # transient decode-tick failures (retried)
    pressure: float = 0.0     # skip this tick's admissions (delay only)
    preempt: float = 0.0      # force-evict a random active slot
    nan: float = 0.0          # poison a random active slot's decode state
    crash: float = 0.0        # kill the process (journaled engines only)
    crash_step: int = -1      # deterministic crash AT this tick (-1 = off)
    crash_class: str = "kill"  # kill | torn | snap | mix (seeded pick)
    # never inject more consecutive tick failures than the supervisor will
    # retry: chaos proves the fault domain, it does not exhaust it
    max_consecutive_faults: int = 2
    injected: dict = field(default_factory=lambda: {
        "tick_faults": 0, "pressure": 0, "preempts": 0, "nans": 0,
        "crashes": 0})

    def __post_init__(self):
        if self.crash_class not in _CRASH_CLASSES + ("mix",):
            raise ValueError(
                f"crash_class={self.crash_class!r} not in "
                f"{_CRASH_CLASSES + ('mix',)}")
        self._rng = np.random.default_rng(self.seed)
        self._consecutive = 0
        self._crash_fired = False

    def describe(self) -> str:
        """One line with everything needed to replay this configuration."""
        return (f"chaos seed={self.seed} tick={self.tick_fail} "
                f"press={self.pressure} preempt={self.preempt} "
                f"nan={self.nan} crash={self.crash} "
                f"crash_step={self.crash_step} "
                f"crash_class={self.crash_class}")

    # ----------------------------------------------------------------- events

    def maybe_tick_fault(self, step: int) -> None:
        """Raise ChaosError with probability tick_fail, capped at
        max_consecutive_faults in a row so the supervisor always wins."""
        if self.tick_fail > 0 and \
                self._consecutive < self.max_consecutive_faults and \
                self._rng.random() < self.tick_fail:
            self._consecutive += 1
            self.injected["tick_faults"] += 1
            raise ChaosError(f"injected transient tick failure @ step {step}")
        self._consecutive = 0

    def pressure_event(self) -> bool:
        """Should this tick's admissions be skipped (allocator pressure)?"""
        hit = self.pressure > 0 and self._rng.random() < self.pressure
        if hit:
            self.injected["pressure"] += 1
        return hit

    def preempt_victim(self, slots: list[int]) -> int | None:
        """Pick a slot to force-evict this tick, or None."""
        if not slots or self.preempt <= 0 or \
                self._rng.random() >= self.preempt:
            return None
        self.injected["preempts"] += 1
        return slots[int(self._rng.integers(len(slots)))]

    def nan_victim(self, slots: list[int]) -> int | None:
        """Pick a slot whose decode state gets poisoned, or None."""
        if not slots or self.nan <= 0 or self._rng.random() >= self.nan:
            return None
        self.injected["nans"] += 1
        return slots[int(self._rng.integers(len(slots)))]

    def crash_event(self, step: int) -> str | None:
        """Should the PROCESS die at this engine tick? Returns the crash
        class ("kill" | "torn" | "snap") or None. A pinned `crash_step`
        fires exactly once per process."""
        hit = (step == self.crash_step and not self._crash_fired) or \
            (self.crash > 0 and self._rng.random() < self.crash)
        if not hit:
            return None
        self._crash_fired = True
        self.injected["crashes"] += 1
        if self.crash_class == "mix":
            return _CRASH_CLASSES[int(self._rng.integers(
                len(_CRASH_CLASSES)))]
        return self.crash_class

    def torn_cut(self, record_bytes: int) -> int:
        """How many bytes of a journal's last record a torn-write crash
        truncates: seeded in [1, record_bytes]."""
        return 1 + int(self._rng.integers(max(1, record_bytes)))
