"""The port's durability layer in isolation (serving/journal.py): record
framing, torn-tail tolerance, snapshot commit atomicity and the request
records, mirroring tests/test_journal.py on the port's copy; then the
format against the reference's: a segment written by either package reads
back to the same events through the other's `read_records`. And the
journal's numpy form of the engine's state (serving/pool.py
`to_host_payload` / `from_host_payload`): bf16 tensors as their bits and
generators as their states round-trip bit for bit, and a real
`_snapshot_payload()` (live slots, a parked preempted request, a chunk job
and prefix entries, fp32 and int8 pages) holds numpy arrays and Python
scalars only, and unpickles without torch."""
import io
import os
import pickle
import tempfile

import numpy as np
import pytest
from conftest import given, settings, st

torch = pytest.importorskip("torch")

from repro.serving import journal as RJ  # noqa: E402
from repro_torch.serving import EngineJournal  # noqa: E402
from repro_torch.serving import journal as TJ  # noqa: E402
from repro_torch.serving.journal import (_HEADER, _SEGMENT_MAGIC,  # noqa: E402
                                         append_record, read_records,
                                         request_from_record, request_record)
from repro_torch.serving.pool import (from_host_payload,  # noqa: E402
                                      to_host_payload)
from repro_torch.serving.scheduler import Request, RequestStatus  # noqa: E402


def _write_segment(path, events, append=append_record):
    sizes = []
    with open(path, "wb") as f:
        f.write(_SEGMENT_MAGIC)
        for ev in events:
            sizes.append(append(f, ev))
    return sizes


_EVENTS = [("submit", {"rid": 0, "prompt": np.arange(7, dtype=np.int32)}),
           ("install", {"rid": 0, "step": 1, "token": 42}),
           ("tick", {"toks": {0: 5, 1: 7}}),
           ("terminal", {"rid": 1, "status": "DONE"}),
           ("tick", {"toks": {0: 9}})]


def _assert_prefix(got, want):
    assert len(got) <= len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert set(g[1]) == set(w[1])


def test_truncation_at_every_byte_offset(tmp_path):
    """Cut the segment at EVERY byte from empty to full: replay never
    raises and returns exactly the records that fit whole below the cut."""
    seg = str(tmp_path / "journal_00000000.log")
    sizes = _write_segment(seg, _EVENTS)
    blob = open(seg, "rb").read()
    bounds = [len(_SEGMENT_MAGIC)]
    for s in sizes:
        bounds.append(bounds[-1] + s)
    cut_path = str(tmp_path / "cut.log")
    for cut in range(len(blob) + 1):
        with open(cut_path, "wb") as f:
            f.write(blob[:cut])
        got = read_records(cut_path)
        want_n = sum(1 for b in bounds[1:] if b <= cut)
        assert len(got) == want_n, f"cut at byte {cut}"
        _assert_prefix(got, _EVENTS)


def test_corrupt_byte_yields_valid_prefix(tmp_path):
    """A flipped byte fails the CRC and stops replay at its record; every
    record before it comes back intact."""
    seg = str(tmp_path / "journal_00000000.log")
    sizes = _write_segment(seg, _EVENTS)
    blob = bytearray(open(seg, "rb").read())
    off = len(_SEGMENT_MAGIC) + sizes[0] + sizes[1] + _HEADER.size + 2
    blob[off] ^= 0xFF
    with open(seg, "wb") as f:
        f.write(bytes(blob))
    got = read_records(seg)
    assert len(got) == 2
    _assert_prefix(got, _EVENTS)


def test_foreign_file_is_empty_tail(tmp_path):
    assert read_records(str(tmp_path / "nope.log")) == []
    foreign = str(tmp_path / "foreign.log")
    with open(foreign, "wb") as f:
        f.write(b"NOTAJRNL" + b"\x00" * 64)
    assert read_records(foreign) == []


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(
           st.sampled_from(["submit", "install", "tick", "terminal"]),
           st.dictionaries(st.sampled_from(["rid", "step", "token", "n"]),
                           st.integers(0, 2 ** 30), max_size=4)),
       min_size=1, max_size=8),
       st.integers(0, 10 ** 9))
def test_truncation_property(events, cut_seed):
    """Random event shapes, random cut point: replay is total and returns
    a prefix of what was written."""
    with tempfile.TemporaryDirectory() as d:
        seg = os.path.join(d, "journal_00000000.log")
        _write_segment(seg, events)
        blob = open(seg, "rb").read()
        cut = cut_seed % (len(blob) + 1)
        with open(seg, "wb") as f:
            f.write(blob[:cut])
        got = read_records(seg)
        assert got == events[:len(got)]


# ----------------------------------------------------------- EngineJournal


def test_commit_and_latest_committed(tmp_path):
    j = EngineJournal(str(tmp_path), snapshot_every=4)
    seq = j.commit_snapshot({"meta": {"step": 0}}, 0)
    j.append("tick", toks={0: 1})
    j.append("tick", toks={0: 2})
    assert j.events_written == 2 and j.bytes_written > 0
    assert j.last_commit["bytes"] > 0 and j.last_commit["fsync_ms"] >= 0
    got_seq, payload = EngineJournal.latest_committed(str(tmp_path))
    assert got_seq == seq and payload["meta"]["step"] == 0
    tail = EngineJournal.read_tail(str(tmp_path), seq)
    assert [k for k, _ in tail] == ["tick", "tick"]
    assert EngineJournal.recoverable(str(tmp_path))
    j.close()


def test_uncommitted_snapshot_skipped_for_previous(tmp_path):
    """A snapshot that crashed before its COMMITTED marker loses to the
    older committed one, whose tail still replays."""
    j = EngineJournal(str(tmp_path), snapshot_every=4)
    j.commit_snapshot({"meta": {"step": 0}, "gen": "old"}, 0)
    j.append("tick", toks={0: 1})
    j.write_uncommitted_snapshot({"meta": {"step": 5}, "gen": "torn"})
    assert os.path.isdir(tmp_path / "snap_00000001")
    assert not os.path.exists(tmp_path / "snap_00000001" / "COMMITTED")
    seq, payload = EngineJournal.latest_committed(str(tmp_path))
    assert seq == 0 and payload["gen"] == "old"
    assert len(EngineJournal.read_tail(str(tmp_path), seq)) == 1
    j.close()


def test_committed_but_unloadable_snapshot_falls_back(tmp_path):
    j = EngineJournal(str(tmp_path), snapshot_every=4)
    j.commit_snapshot({"gen": "old"}, 0)
    j.commit_snapshot({"gen": "new"}, 8)
    with open(tmp_path / "snap_00000001" / "state.pkl", "wb") as f:
        f.write(b"\x00garbage")
    seq, payload = EngineJournal.latest_committed(str(tmp_path))
    assert seq == 0 and payload["gen"] == "old"
    j.close()


def test_tear_tail_drops_only_last_record(tmp_path):
    j = EngineJournal(str(tmp_path), snapshot_every=4)
    seq = j.commit_snapshot({}, 0)
    j.append("tick", toks={0: 1})
    j.append("tick", toks={0: 2})
    j.tear_tail(3)
    tail = EngineJournal.read_tail(str(tmp_path), seq)
    assert [p["toks"] for _, p in tail] == [{0: 1}]
    j.close()


def test_prune_keeps_last_committed_and_sweeps_orphans(tmp_path):
    j = EngineJournal(str(tmp_path), snapshot_every=4)
    assert j.KEEP == 2
    for step in range(4):
        j.commit_snapshot({"step": step}, step)
        j.append("tick", toks={0: step})
    snaps = sorted(p.name for p in tmp_path.iterdir()
                   if p.name.startswith("snap_"))
    segs = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("journal_"))
    assert snaps == ["snap_00000002", "snap_00000003"]
    assert segs == ["journal_00000002.log", "journal_00000003.log"]
    os.makedirs(tmp_path / "snap_00000009.tmp")
    j.commit_snapshot({"step": 9}, 9)
    assert not os.path.exists(tmp_path / "snap_00000009.tmp")
    j.close()


def test_journal_validates_cadence_and_requires_segment(tmp_path):
    with pytest.raises(ValueError, match="snapshot_every"):
        EngineJournal(str(tmp_path), snapshot_every=0)
    j = EngineJournal(str(tmp_path / "j"), snapshot_every=1)
    with pytest.raises(AssertionError, match="commit_snapshot"):
        j.append("tick", toks={})
    assert not EngineJournal.recoverable(str(tmp_path / "j"))
    assert not EngineJournal.recoverable(str(tmp_path / "absent"))


def _request():
    req = Request(request_id=7, prompt=np.arange(5, dtype=np.int32),
                  max_new_tokens=9, eos_id=3, arrival_step=2, priority=-1,
                  temperature=0.7, top_p=0.9, seed=123, deadline_s=4.5,
                  max_wall_s=2.0)
    req.seq = 11
    req.times_skipped = 2
    req.tokens = [1, 2, 3]
    req.status = RequestStatus.ACTIVE
    req.admit_step = 4
    req.slot = 1
    req.expert_sig = np.array([True, False, True])
    return req


_FIELDS = ("request_id", "max_new_tokens", "eos_id", "arrival_step",
           "priority", "temperature", "top_p", "seed", "deadline_s",
           "max_wall_s", "seq", "times_skipped", "tokens", "status",
           "admit_step", "slot")


def test_request_record_roundtrip():
    req = _request()
    back = request_from_record(pickle.loads(pickle.dumps(
        request_record(req, runtime=True))))
    for f in _FIELDS:
        assert getattr(back, f) == getattr(req, f), f
    np.testing.assert_array_equal(back.prompt, req.prompt)
    np.testing.assert_array_equal(back.expert_sig, req.expert_sig)
    slim = request_from_record(request_record(req))
    assert slim.tokens == [] and slim.status is RequestStatus.QUEUED


# ------------------------------------------------ parity with the reference


def test_segments_read_back_through_the_other_package(tmp_path):
    """The same events written by the port's EngineJournal and by the
    reference's read back identically through both `read_records`, and the
    two segments are byte-identical; request records written by one
    package rebuild the same request in the other."""
    req = _request()
    events = [("submit", {"req": request_record(req)}),
              ("install", {"rid": 7, "step": 4, "token": 42}),
              ("tick", {"step": 5, "toks": {7: 5, 8: 6}}),
              ("terminal", {"rid": 8, "status": "CANCELLED",
                            "reason": "cancelled"})]
    segs = {}
    for name, mod in (("port", TJ), ("ref", RJ)):
        d = str(tmp_path / name)
        j = mod.EngineJournal(d, snapshot_every=4)
        seq = j.commit_snapshot({"meta": {"step": 3}}, 3)
        for kind, p in events:
            j.append(kind, **p)
        j.close()
        segs[name] = os.path.join(d, f"journal_{seq:08d}.log")
    for seg in segs.values():
        for reader in (TJ.read_records, RJ.read_records):
            got = reader(seg)
            assert [k for k, _ in got] == [k for k, _ in events]
            assert got[1:] == events[1:]
            np.testing.assert_array_equal(got[0][1]["req"]["prompt"],
                                          req.prompt)
    assert open(segs["port"], "rb").read() == open(segs["ref"], "rb").read()
    for rec in (request_record(req, runtime=True),
                RJ.request_record(RJ.request_from_record(
                    request_record(req, runtime=True)), runtime=True)):
        port, ref = request_from_record(rec), RJ.request_from_record(rec)
        for f in _FIELDS:
            a, b = getattr(port, f), getattr(ref, f)
            assert (a.value if f == "status" else a) == \
                (b.value if f == "status" else b), f


# ------------------------------------------------------ the numpy form


def test_bf16_bits_and_generator_state_round_trip():
    """A bf16 tensor goes to disk as its int16 bits with its dtype's name
    (numpy has no bf16; float32 would double the bytes) and comes back bit
    for bit, NaN, -0 and denormals included; a generator goes as its
    state and the rebuilt one draws what the original would have."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 5, 6, generator=g).to(torch.bfloat16)
    x[0, 0, :4] = torch.tensor([float("nan"), -0.0, 1e-40, float("inf")])
    gen = torch.Generator().manual_seed(9)
    torch.rand(3, generator=gen)
    tree = {"k": x[:, 1:], "s": torch.arange(3, dtype=torch.int8),
            "f": torch.rand(2, 2, generator=g), "gen": gen,
            "go": (x[0], torch.tensor([1, -1])), "n": 4, "none": None}
    host = to_host_payload(tree)
    assert host["k"]["data"].dtype == np.int16
    assert host["k"]["data"].nbytes == x[:, 1:].numel() * 2
    assert host["gen"]["__generator_state__"].dtype == np.uint8
    back = from_host_payload(pickle.loads(pickle.dumps(host)))
    assert back["k"].dtype == torch.bfloat16
    assert torch.equal(back["k"].view(torch.int16),
                       x[:, 1:].view(torch.int16))
    for k in ("s", "f"):
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k],
                                                              tree[k])
    assert isinstance(back["go"], tuple) and torch.equal(
        back["go"][0].view(torch.int16), x[0].view(torch.int16))
    assert back["n"] == 4 and back["none"] is None
    assert torch.equal(torch.rand(8, generator=back["gen"]),
                       torch.rand(8, generator=gen))


class _NumpyOnly(pickle.Unpickler):
    """Unpickles numpy and builtins only: a torch object in the payload
    (a tensor, a generator) raises."""

    def find_class(self, module, name):
        if module.split(".")[0] not in ("numpy", "builtins", "copyreg"):
            raise pickle.UnpicklingError(f"{module}.{name} in the payload")
        return super().find_class(module, name)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            assert isinstance(k, (str, int)), f"{path}: key {k!r}"
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_snapshot_payload_is_numpy_and_scalars(kv_quant, tmp_path):
    """A real engine snapshot, taken where it holds live slots, a parked
    preempted (sampled) request, a chunk job and prefix entries: every leaf
    is a numpy array or a Python scalar, and the pickle loads with numpy
    and builtins only."""
    from test_torch_crash_recovery import full_trace_engine
    eng, _ = full_trace_engine(kv_quant, str(tmp_path))
    payload = eng._snapshot_payload()
    assert payload["slots"] and payload["preempted"]
    assert payload["chunk_req"] is not None
    assert payload["prefix"]["entries"] and payload["pages"]["ids"]
    parked = next(iter(payload["preempted"].values()))
    assert "__generator_state__" in parked["generator"]
    for path, leaf in _leaves(payload):
        assert leaf is None or type(leaf) in (bool, int, float, str) or \
            isinstance(leaf, np.ndarray), f"{path}: {type(leaf)}"
    back = _NumpyOnly(io.BytesIO(pickle.dumps(payload, protocol=4))).load()
    assert back["meta"] == payload["meta"]
