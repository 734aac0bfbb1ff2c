"""Step and process supervision: retry policy, give-up signal, straggler
detection, and the restart loop of a serving process.

A copy of the reference package's `RestartRequired`, `StepStats`,
`StepSupervisor`, `SupervisorStats` and `ProcessSupervisor`
(repro/runtime/fault.py). The reference's `_block` (JAX's
`block_until_ready`, which makes asynchronous dispatch errors surface
inside the supervised region) is left out: the port's serving tick ends in
its one host read, which already waits for the device.

`StepSupervisor.run` retries a failed step up to `max_retries` times with
the same inputs, raises `RestartRequired` (the give-up signal, never
retried) past that, and records each step's wall time, flagging a step
slower than median * straggler_factor.

`ProcessSupervisor` runs the serving engine in a CHILD process that
journals every request's lifecycle (serving/journal.py; the serve CLI's
`--supervise` re-executes itself); it watches for exits and missed
heartbeats, SIGKILLs a hung child, restarts it with exponential backoff,
and each restarted generation resumes through `ServingEngine.recover()`.
Heartbeats are file mtimes (the engine touches its `heartbeat_file` once a
tick): no pipe to deadlock on, and SIGKILL-proof. The port reads no
environment variable, so where the reference passes the generation and the
heartbeat path as `REPRO_SUPERVISE_GENERATION` and `REPRO_HEARTBEAT`, this
supervisor appends `--generation <n>` and `--heartbeat <path>` to the
child's argv.
"""
from __future__ import annotations

import os
import subprocess
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


@dataclass
class SupervisorStats:
    restarts: int = 0
    heartbeat_kills: int = 0
    exit_codes: list = field(default_factory=list)


class ProcessSupervisor:
    """Run a child process under restart supervision with file-mtime
    heartbeats.

    Each generation runs `cmd + ["--generation", <n>]` (generation 0 is the
    first launch), plus `["--heartbeat", <path>]` when a heartbeat file is
    configured: the serving engine touches that file every tick. A child
    that exits 0 ends supervision; any other exit (a SIGKILL from a chaos
    crash included) restarts it after an exponentially growing delay, up
    to MAX_RESTARTS restarts, after which RestartRequired propagates. A
    child whose heartbeat is older than HEARTBEAT_TIMEOUT_S is SIGKILLed
    and restarted the same way: a hang and a crash are one failure to the
    recovery contract. The child decides WHAT a later generation does (the
    serve CLI recovers from its journal); the supervisor decides only
    WHETHER it runs. The default timeout is generous: the first ticks
    build kernels and warm caches."""

    HEARTBEAT_TIMEOUT_S = 120.0
    MAX_RESTARTS = 3
    BACKOFF_S = 0.25
    BACKOFF_FACTOR = 2.0
    POLL_S = 0.1

    def __init__(self, cmd: list, *, heartbeat_file: str | None = None):
        self.cmd = list(cmd)
        self.heartbeat_file = heartbeat_file
        self.stats = SupervisorStats()

    def run(self) -> int:
        """Supervise until a generation exits 0 (returns 0) or the restart
        budget is spent (raises RestartRequired)."""
        generation = 0
        backoff = self.BACKOFF_S
        while True:
            argv = self.cmd + ["--generation", str(generation)]
            if self.heartbeat_file:
                argv += ["--heartbeat", self.heartbeat_file]
                # prime the mtime so staleness counts from LAUNCH, not from
                # whenever a previous generation last ticked
                with open(self.heartbeat_file, "a"):
                    os.utime(self.heartbeat_file, None)
            proc = subprocess.Popen(argv)
            code = self._watch(proc)
            self.stats.exit_codes.append(code)
            if code == 0:
                return 0
            if self.stats.restarts >= self.MAX_RESTARTS:
                raise RestartRequired(
                    f"child failed {self.stats.restarts + 1} times "
                    f"(exit codes {self.stats.exit_codes}): restart budget "
                    f"of {self.MAX_RESTARTS} exhausted")
            self.stats.restarts += 1
            generation += 1
            time.sleep(backoff)
            backoff *= self.BACKOFF_FACTOR

    def _watch(self, proc) -> int:
        """Poll one generation until it exits, SIGKILLing it on a stale
        heartbeat. Returns its exit code."""
        while True:
            code = proc.poll()
            if code is not None:
                return code
            if self.heartbeat_file:
                try:
                    age = time.time() - os.path.getmtime(self.heartbeat_file)
                except OSError:
                    age = 0.0
                if age > self.HEARTBEAT_TIMEOUT_S:
                    proc.kill()
                    proc.wait()
                    self.stats.heartbeat_kills += 1
                    return -9
            time.sleep(self.POLL_S)
