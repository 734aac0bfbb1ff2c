"""Durable request journal and atomic engine snapshots (crash recovery).

A copy of the reference package's durability layer
(repro/serving/journal.py): the same record format (the `REPROJNL` segment
magic, a `<II` length + CRC32 header, pickle protocol 4 payloads), the
same directory layout and the same pruning, over the port's `Request`.
Numpy and the standard library only: the engine hands it payloads that
hold numpy arrays and Python scalars (serving/pool.py `to_host_payload`),
so a journal does not depend on the torch build or the device that wrote
it.

The GO cache's rows are TopKUpdate history, not recomputable from the
prompt, so a crash without durability loses every in-flight stream and
forgets which requests were admitted. The recovery path
(`ServingEngine.recover`) replays what this module keeps:

  records        an fsync'd append-only log of length-prefixed,
                 CRC-guarded records. A crash mid-write leaves a TORN TAIL
                 (short header, short payload or CRC mismatch);
                 `read_records` stops at the first bad record and returns
                 the valid prefix, so replay never fails on a torn journal.

  EngineJournal  one journal SEGMENT per snapshot generation, plus
                 whole-engine snapshots committed by writing everything
                 into `snap_<seq>.tmp/`, fsyncing, writing an empty
                 COMMITTED marker LAST and renaming into place. A snapshot
                 without COMMITTED is a crash artifact; recovery skips it
                 for the previous committed one. Committing snapshot N
                 opens segment `journal_<N>.log`, so recovery is the latest
                 committed snapshot plus the replay of one segment.

Event kinds written by the engine (serving/engine.py):

  submit    the request record (prompt, budgets, sampling seed, priority,
            submit order): everything needed to rebuild the Request
  install   a request's FIRST token, emitted at admission (cold, from the
            prefix index, or at the end of a chunked prefill)
  tick      the token watermark of one decode tick: {request id: token}
            for every slot that decoded
  terminal  a request reached a terminal status; replay re-applies
            CANCELLED, the rest are recomputed by resuming decode

Durable: request identity and parameters, admission watermarks, emitted
tokens, terminal statuses and, through snapshots, the live KV pages, GO
rows, decode cursors, sampling generator states, the scheduler's load
EWMAs and the prefix index with its pinned page contents. Not durable:
wall-clock anchors (deadlines re-anchor at recovery) and chaos's RNG
position.

Beyond the reference, each commit records its snapshot's bytes and the
milliseconds of its pickle + write and of its fsyncs (`last_commit`).
"""
from __future__ import annotations

import os
import pickle
import re
import shutil
import struct
import time
import zlib

import numpy as np

from repro_torch.serving.scheduler import Request, RequestStatus

# one record = HEADER (payload length + CRC32 of the payload) + pickle
# payload. The length makes a torn tail DETECTABLE (a short read never
# parses as a record); the CRC makes it UNAMBIGUOUS (a cut landing inside
# the next record's bytes cannot fake a record).
_HEADER = struct.Struct("<II")
_SEGMENT_MAGIC = b"REPROJNL"
_SNAP_RE = re.compile(r"^snap_(\d{8})$")
_SEG_RE = re.compile(r"^journal_(\d{8})\.log$")


class JournalError(RuntimeError):
    """A journal directory is unusable for recovery (no committed snapshot
    at all, as opposed to a torn tail, which replay tolerates)."""


# --------------------------------------------------------------- record log


def append_record(f, obj) -> int:
    """Append one durable record to the open file `f`: length + CRC +
    payload, flushed and fsync'd, so a SIGKILL after the return cannot lose
    it. Returns the record's size on disk in bytes."""
    payload = pickle.dumps(obj, protocol=4)
    f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
    f.write(payload)
    f.flush()
    os.fsync(f.fileno())
    return _HEADER.size + len(payload)


def read_records(path: str) -> list:
    """Replay a journal segment, tolerating a torn tail: records up to the
    first short header, short payload or CRC mismatch, which a crash
    mid-append leaves behind and which is dropped. Everything before it is
    returned intact (a valid prefix, never garbage)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path, "rb") as f:
        if f.read(len(_SEGMENT_MAGIC)) != _SEGMENT_MAGIC:
            return out                       # foreign or torn-at-birth file
        while True:
            head = f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                return out                   # torn tail: short header
            length, crc = _HEADER.unpack(head)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return out                   # torn tail: short/corrupt payload
            try:
                out.append(pickle.loads(payload))
            except Exception:
                return out                   # CRC-valid but unloadable: stop


# ------------------------------------------------------- request (de)serde


def request_record(req: Request, *, runtime: bool = False) -> dict:
    """Picklable record of a Request. `runtime=True` adds its lifecycle
    state (emitted tokens, status, admission steps) for engine snapshots;
    a submit event needs only the identity fields."""
    rec = {
        "rid": req.request_id,
        "prompt": np.asarray(req.prompt, np.int32),
        "max_new_tokens": req.max_new_tokens,
        "eos_id": req.eos_id,
        "arrival_step": req.arrival_step,
        "priority": req.priority,
        "temperature": req.temperature,
        "top_p": req.top_p,
        "seed": req.seed,
        "deadline_s": req.deadline_s,
        "max_wall_s": req.max_wall_s,
        "seq": req.seq,
        "times_skipped": req.times_skipped,
        "expert_sig": (None if req.expert_sig is None
                       else np.asarray(req.expert_sig, bool)),
    }
    if runtime:
        rec.update(tokens=list(req.tokens), status=req.status.value,
                   fail_reason=req.fail_reason, admit_step=req.admit_step,
                   finish_step=req.finish_step, preemptions=req.preemptions,
                   slot=req.slot)
    return rec


def request_from_record(rec: dict) -> Request:
    """Rebuild a Request from `request_record`. Wall-clock anchors
    re-anchor at NOW: deadline budgets are wall time, which a dead process
    cannot have been spending (expiring everything that out-waited the
    outage would turn every recovery into a mass TIMEOUT)."""
    req = Request(
        request_id=rec["rid"],
        prompt=np.asarray(rec["prompt"], np.int32),
        max_new_tokens=rec["max_new_tokens"],
        eos_id=rec["eos_id"],
        arrival_step=rec["arrival_step"],
        priority=rec["priority"],
        temperature=rec["temperature"],
        top_p=rec["top_p"],
        seed=rec["seed"],
        deadline_s=rec["deadline_s"],
        max_wall_s=rec["max_wall_s"],
    )
    req.seq = rec["seq"]
    req.times_skipped = rec["times_skipped"]
    req.expert_sig = rec["expert_sig"]
    now = time.monotonic()
    req.arrival_time = req.submit_time = now
    if "status" in rec:
        req.status = RequestStatus(rec["status"])
        req.fail_reason = rec["fail_reason"]
        req.tokens = list(rec["tokens"])
        req.admit_step = rec["admit_step"]
        req.finish_step = rec["finish_step"]
        req.preemptions = rec["preemptions"]
        req.slot = rec["slot"]
        if req.admit_step >= 0:
            req.admit_time = now             # max_wall_s re-anchors too
    return req


# ----------------------------------------------------------- engine journal


class EngineJournal:
    """Snapshot-segmented write-ahead journal of one ServingEngine.

    Layout under `directory`:
        snap_<seq>/state.pkl + COMMITTED   atomic engine snapshot
        journal_<seq>.log                  events SINCE snapshot <seq>

    `commit_snapshot` is the generation boundary: snapshot N commits
    (marker last, rename into place), THEN segment N opens and later events
    land there. A crash between the two leaves a committed snapshot with no
    segment, which replays as an empty tail, never a stale one. Old
    generations are pruned to KEEP committed snapshots; uncommitted
    leftovers older than the newest committed snapshot are swept at the
    next commit."""

    KEEP = 2

    def __init__(self, directory: str, *, snapshot_every: int = 32):
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        self.dir = directory
        self.snapshot_every = int(snapshot_every)
        os.makedirs(directory, exist_ok=True)
        self._seq = -1
        self._f = None
        self._last_record_bytes = 0
        self.bytes_written = 0
        self.events_written = 0
        self.snapshots_committed = 0
        self.last_snapshot_step = 0
        # the last snapshot written: its state.pkl bytes and the ms of its
        # pickle + write and of its fsyncs (file, marker, directory)
        self.last_commit: dict = {}

    # ------------------------------------------------------------- appending

    def append(self, kind: str, **payload) -> None:
        """Durably append one event to the current segment."""
        assert self._f is not None, "no open segment: commit_snapshot first"
        self._last_record_bytes = append_record(self._f, (kind, payload))
        self.bytes_written += self._last_record_bytes
        self.events_written += 1

    # ------------------------------------------------------------- snapshots

    def _snap_dir(self, seq: int) -> str:
        return os.path.join(self.dir, f"snap_{seq:08d}")

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"journal_{seq:08d}.log")

    def _write_snapshot_files(self, target: str, payload: dict,
                              committed: bool) -> None:
        tmp = target + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "state.pkl"), "wb") as f:
            pickle.dump(payload, f, protocol=4)
            f.flush()
            nbytes = f.tell()
            t1 = time.perf_counter()
            os.fsync(f.fileno())
        if committed:
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, target)
        self._fsync_dir(self.dir)
        self.last_commit = {"bytes": nbytes,
                            "write_ms": (t1 - t0) * 1e3,
                            "fsync_ms": (time.perf_counter() - t1) * 1e3}

    @staticmethod
    def _fsync_dir(path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:                       # platforms without dir fds
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def commit_snapshot(self, payload: dict, step: int) -> int:
        """Atomically commit an engine snapshot (marker written LAST) and
        open the next journal segment. Returns the new generation's seq."""
        seq = self._seq + 1 if self._seq >= 0 else _next_seq(self.dir)
        self._write_snapshot_files(self._snap_dir(seq), payload,
                                   committed=True)
        if self._f is not None:
            self._f.close()
        self._f = open(self._seg_path(seq), "wb")
        self._f.write(_SEGMENT_MAGIC)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._seq = seq
        self.snapshots_committed += 1
        self.last_snapshot_step = int(step)
        self._last_record_bytes = 0
        self._prune(seq)
        return seq

    def write_uncommitted_snapshot(self, payload: dict) -> None:
        """Crash hook: write the NEXT snapshot's files WITHOUT the
        COMMITTED marker, as a crash between the data write and the marker
        leaves them. Recovery must skip it."""
        self._write_snapshot_files(self._snap_dir(self._seq + 1), payload,
                                   committed=False)

    def tear_tail(self, cut_bytes: int) -> None:
        """Crash hook: truncate the current segment `cut_bytes` into its
        LAST record (the torn-write crash class). The cut is clamped so at
        least one byte of the record is lost and the records before it
        stay intact (replay must recover exactly them)."""
        if self._f is None or self._last_record_bytes == 0:
            return
        cut = max(1, min(int(cut_bytes), self._last_record_bytes))
        self._f.flush()
        size = self._f.tell()
        self._f.truncate(size - cut)
        self._f.flush()
        os.fsync(self._f.fileno())

    def _prune(self, newest: int) -> None:
        """Keep the last KEEP committed generations; sweep everything
        older, uncommitted snapshot leftovers and stale .tmp directories of
        crashed commits (a generation < newest that never committed is an
        orphan by construction)."""
        committed = sorted(s for s in _snapshot_seqs(self.dir)
                           if os.path.exists(
                               os.path.join(self._snap_dir(s), "COMMITTED")))
        drop = set(committed[:-self.KEEP])
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
                continue
            m = _SNAP_RE.match(name)
            if m:
                seq = int(m.group(1))
                uncommitted = not os.path.exists(
                    os.path.join(self.dir, name, "COMMITTED"))
                if seq in drop or (uncommitted and seq < newest):
                    shutil.rmtree(os.path.join(self.dir, name),
                                  ignore_errors=True)
                continue
            m = _SEG_RE.match(name)
            if m and int(m.group(1)) in drop:
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # -------------------------------------------------------------- recovery

    @staticmethod
    def recoverable(directory: str) -> bool:
        """Does `directory` hold at least one committed snapshot? Reads the
        COMMITTED markers only, not the payloads (`latest_committed` loads
        them, and falls back past an unloadable one)."""
        if not os.path.isdir(directory):
            return False
        return any(os.path.exists(os.path.join(
            directory, f"snap_{seq:08d}", "COMMITTED"))
            for seq in _snapshot_seqs(directory))

    @staticmethod
    def latest_committed(directory: str):
        """(seq, payload) of the newest COMMITTED and loadable snapshot, or
        None. A snapshot without its marker is a crash artifact and is
        skipped; a committed but unloadable one (disk corruption) is
        skipped too, for the previous generation: older but consistent
        beats newer but broken."""
        if not os.path.isdir(directory):
            return None
        for seq in sorted(_snapshot_seqs(directory), reverse=True):
            d = os.path.join(directory, f"snap_{seq:08d}")
            if not os.path.exists(os.path.join(d, "COMMITTED")):
                continue
            try:
                with open(os.path.join(d, "state.pkl"), "rb") as f:
                    return seq, pickle.load(f)
            except Exception:
                continue
        return None

    @staticmethod
    def read_tail(directory: str, seq: int) -> list:
        """The events journaled since snapshot `seq` (torn tail dropped). A
        missing segment (a crash between the snapshot's commit and the
        segment's opening) is an empty tail, not an error."""
        return read_records(os.path.join(directory, f"journal_{seq:08d}.log"))


def _snapshot_seqs(directory: str) -> list[int]:
    out = []
    for name in os.listdir(directory):
        m = _SNAP_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return out


def _next_seq(directory: str) -> int:
    seqs = _snapshot_seqs(directory)
    return max(seqs) + 1 if seqs else 0
