"""Kill, recover, resume: the port engine's crash-tolerance contract
(serving/engine.py `recover`, serving/journal.py, runtime/fault.py
`ProcessSupervisor`, the serve CLI's --journal-dir / --crash-step /
--supervise) on the smoke llama_moe_4_16, fp32, on the CPU.

Port against port, the reference's contracts (tests/test_crash_recovery.py):
a journaled engine abandoned mid-run (everything durable is fsync'd, as
after a SIGKILL) and recovered into a second engine finishes every stream
as the uninterrupted run does, greedy and sampled, across the three crash
classes (abandoned, torn journal write, snapshot without its COMMITTED
marker); the replay oracle trips on a planted divergence; a second crash
re-runs from the fresh post-recovery snapshot; a cancel replays; the
prefix cache survives. Beyond the reference's suite: a trace whose
snapshot holds live slots, a parked preempted (sampled) request, a chunk
job and prefix entries, on fp32 and int8 pages, under each crash class;
the "torn" and "snap" classes of `_maybe_crash` in a child process. The
reference's REPRO_CRASH lane is replaced by plain tests (the port reads no
environment): one real SIGKILL and one --supervise run through the port's
CLI, each a few seconds.

Against the JAX package (same weights through `bridge.params_from_numpy`):
the recovered greedy streams equal the JAX engine's.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.runtime.fault import (ProcessSupervisor,  # noqa: E402
                                       RestartRequired)
from repro_torch.serving import (EngineJournal, JournalError,  # noqa: E402
                                 RequestStatus, ServingEngine)
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
MAX_TOKENS = 48
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _setup():
    _, cfg, _, params = smoke_pair("llama_moe_4_16")
    return cfg, params


def _engine(params, cfg, jdir=None, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_tokens", MAX_TOKENS)
    kw.setdefault("paged", True)
    kw.setdefault("page_size", 8)
    if jdir is not None:
        kw.setdefault("snapshot_every", 4)
    return ServingEngine(params, cfg, device="cpu",
                         journal_dir=None if jdir is None else str(jdir),
                         **kw)


def _prompts(cfg, seed, n, size=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=size, dtype=np.int32)
            for _ in range(n)]


def _uninterrupted(params, cfg, prompts, gen, **submit):
    eng = _engine(params, cfg)
    rids = [eng.submit(p, gen, **submit) for p in prompts]
    fin = eng.run()
    return [fin[r].tokens for r in rids]


def _recover(jdir, params, cfg, **kw):
    return ServingEngine.recover(str(jdir), params, cfg, device="cpu", **kw)


# ------------------------------------------------- in-process crash classes


def test_recover_greedy_bit_identical(tmp_path):
    """Abandon a journaled engine mid-decode (live slots, queued requests,
    events past the last snapshot): the recovered engine finishes every
    stream as the uninterrupted port engine and the JAX engine do."""
    jcfg, cfg, jparams, params = smoke_pair("llama_moe_4_16")
    prompts = _prompts(cfg, 0, 4)
    eng = _engine(params, cfg, tmp_path)
    rids = [eng.submit(p, 12) for p in prompts]
    for _ in range(6):
        eng.step()
    assert eng.pool.num_active() > 0, "the crash point must have live slots"

    rec = _recover(tmp_path, params, cfg)
    assert rec.recovered_info["events"] == rec.replayed_events > 0
    fin = rec.run()
    got = [fin[r].tokens for r in rids]
    assert all(fin[r].status is RequestStatus.DONE for r in rids)
    assert got == _uninterrupted(params, cfg, prompts, 12)
    jeng = JaxEngine(jparams, jcfg, num_slots=2, max_tokens=MAX_TOKENS,
                     paged=True, page_size=8)
    jids = [jeng.submit(p, 12) for p in prompts]
    jfin = jeng.run()
    assert got == [jfin[r].tokens for r in jids]
    s = rec.stats()
    assert s["recoveries"] == 1 and s["restart_count"] == 0
    assert s["journal_bytes"] > 0 and s["snapshots"] >= 1
    assert s["snapshot_age_ticks"] is not None
    assert rec.pool.alloc.pages_in_use == 0


def test_recover_sampled_streams_bit_identical(tmp_path):
    """Sampled streams resume from the journaled generator states: the
    recovered run equals an uninterrupted engine token for token at
    temperature 0.8."""
    cfg, params = _setup()
    prompts = _prompts(cfg, 1, 4)
    kw = dict(temperature=0.8, top_p=0.9)
    ref = _engine(params, cfg)
    ref_ids = [ref.submit(p, 12, seed=100 + i, **kw)
               for i, p in enumerate(prompts)]
    ref_fin = ref.run()
    eng = _engine(params, cfg, tmp_path)
    rids = [eng.submit(p, 12, seed=100 + i, **kw)
            for i, p in enumerate(prompts)]
    for _ in range(6):
        eng.step()
    fin = _recover(tmp_path, params, cfg).run()
    for rid, ref_rid in zip(rids, ref_ids):
        assert fin[rid].status is RequestStatus.DONE
        assert fin[rid].tokens == ref_fin[ref_rid].tokens, rid


def test_recover_from_torn_journal_tail(tmp_path):
    """The torn-write class: the last record is cut mid-write. Replay
    drops it (a watermark never durably emitted) and the streams still
    finish exactly."""
    cfg, params = _setup()
    prompts = _prompts(cfg, 2, 3)
    eng = _engine(params, cfg, tmp_path, snapshot_every=64)
    rids = [eng.submit(p, 12) for p in prompts]
    for _ in range(5):
        eng.step()
    intact = eng.journal.events_written
    eng.journal.tear_tail(eng.journal._last_record_bytes)
    rec = _recover(tmp_path, params, cfg)
    assert rec.replayed_events == intact - 1
    fin = rec.run()
    assert [fin[r].tokens for r in rids] == \
        _uninterrupted(params, cfg, prompts, 12)


def test_uncommitted_snapshot_skipped_at_recovery(tmp_path):
    """The snapshot-interrupted class: state.pkl written, no COMMITTED
    marker. Recovery falls back to the previous committed snapshot and its
    tail, and still resumes bit for bit."""
    cfg, params = _setup()
    prompts = _prompts(cfg, 3, 3)
    eng = _engine(params, cfg, tmp_path, snapshot_every=4)
    rids = [eng.submit(p, 12) for p in prompts]
    for _ in range(6):
        eng.step()
    committed = eng.journal._seq
    eng.journal.write_uncommitted_snapshot(eng._snapshot_payload())
    rec = _recover(tmp_path, params, cfg)
    assert rec.recovered_info["snapshot_seq"] == committed
    fin = rec.run()
    assert [fin[r].tokens for r in rids] == \
        _uninterrupted(params, cfg, prompts, 12)


def test_replay_oracle_trips_on_divergence(tmp_path):
    """A recovery that would re-emit another token than the dead process
    journaled fails loudly instead of serving a forked stream."""
    cfg, params = _setup()
    eng = _engine(params, cfg, tmp_path, snapshot_every=64)
    eng.submit(_prompts(cfg, 4, 1)[0], 12)
    for _ in range(4):
        eng.step()
    rec = _recover(tmp_path, params, cfg)
    assert rec._replay_expect, "the crash point left no watermarks"
    rid = next(iter(rec._replay_expect))
    rec._replay_expect[rid][-1] ^= 1          # a forged watermark
    with pytest.raises(AssertionError, match="recovery divergence"):
        rec.run()


def test_repeated_crashes_are_idempotent(tmp_path):
    """Crashing again after a recovery re-runs from the fresh
    post-recovery snapshot: recover(recover(x)) finishes as recover(x)."""
    cfg, params = _setup()
    prompts = _prompts(cfg, 5, 3)
    eng = _engine(params, cfg, tmp_path)
    rids = [eng.submit(p, 12) for p in prompts]
    for _ in range(5):
        eng.step()
    rec1 = _recover(tmp_path, params, cfg)
    for _ in range(2):
        rec1.step()
    rec2 = _recover(tmp_path, params, cfg)
    assert rec2.recoveries == 2
    fin = rec2.run()
    assert [fin[r].tokens for r in rids] == \
        _uninterrupted(params, cfg, prompts, 12)


def test_cancel_replays_but_outcomes_recompute(tmp_path):
    """CANCELLED is an outside decision and survives the crash; DONE
    outcomes are recomputed by resuming. A request submitted after
    recovery takes a fresh id."""
    cfg, params = _setup()
    prompts = _prompts(cfg, 6, 3)
    eng = _engine(params, cfg, tmp_path, snapshot_every=64)
    rids = [eng.submit(p, 12) for p in prompts]
    for _ in range(2):
        eng.step()
    eng.cancel(rids[2])
    rec = _recover(tmp_path, params, cfg)
    late = rec.submit(prompts[0], 12)
    assert late not in rids
    fin = rec.run()
    assert fin[rids[2]].status is RequestStatus.CANCELLED
    ref = _uninterrupted(params, cfg, prompts[:2], 12)
    assert [fin[r].tokens for r in rids[:2]] == ref
    assert fin[late].tokens == ref[0]


def test_recover_preserves_prefix_cache(tmp_path):
    """The prefix index is part of the snapshot: a request admitted after
    recovery hits the cache warmed before the crash (its pages written back
    from the snapshot's page contents, its entry's tensors restored)."""
    cfg, params = _setup()
    prompt = _prompts(cfg, 7, 1, size=20)[0]
    eng = _engine(params, cfg, tmp_path, prefix_share=True,
                  snapshot_every=64)
    eng.submit(prompt, 8)
    while eng.has_work():           # run() would flush the cache at drain
        eng.step()
    assert eng.prefix_index.node_pages()
    eng.journal.commit_snapshot(eng._snapshot_payload(), eng.step_count)

    rec = _recover(tmp_path, params, cfg)
    assert rec.prefix_share and len(rec.prefix_index.node_pages()) == 2
    rid = rec.submit(prompt, 8)
    rec.audit_every_tick = True
    fin = rec.run()
    assert rec.prefix_hits == 1 and rec.prefill_tokens_skipped == 20
    assert fin[rid].tokens == _uninterrupted(params, cfg, [prompt], 8)[0]


# The trace of the full snapshot (3 slots, pages of 8, chunks of 16,
# preemption and prefix sharing): (prompt, priority, arrival, temperature,
# seed), FULL_GEN new tokens each, top_p 0.9 where sampled. A (12 tokens)
# twice at tick 0, the second a sampled cache admission; C (56 tokens)
# prefills in 4 chunks from tick 1; H (12 tokens, priority 0) arrives at
# tick 2 on 3 busy slots and evicts the sampled A; B and a third A later.
# The snapshot at tick 4 holds 2 live slots, the parked A, C's chunk job
# and 2 prefix entries; the crash comes at tick 5, past C's install.
FULL_POOL = dict(num_slots=3, max_tokens=64, paged=True, page_size=8,
                 prefill_chunk=16, preemption=True, prefix_share=True)
FULL_LENS = {"A": 12, "B": 10, "C": 56, "H": 12}
FULL_TRACE = [("A", 5, 0, 0.0, None), ("A", 5, 0, 0.8, 11),
              ("C", 5, 1, 0.0, None), ("H", 0, 2, 0.0, None),
              ("B", 5, 3, 0.0, None), ("A", 5, 5, 0.8, 12)]
FULL_GEN = 8
FULL_EVERY, FULL_SNAP, FULL_CRASH = 2, 4, 5


def _full_submit(eng, cfg):
    rng = np.random.default_rng(11)
    prompts = {k: rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for k, n in FULL_LENS.items()}
    return [eng.submit(prompts[k], FULL_GEN, priority=pr, arrival_step=a,
                       temperature=t, top_p=0.9, seed=sd)
            for k, pr, a, t, sd in FULL_TRACE]


def full_trace_engine(kv_quant, jdir):
    """A journaled engine of FULL_TRACE stopped at tick FULL_SNAP, right
    after the snapshot that holds every kind of state; returns (engine,
    request ids)."""
    cfg, params = _setup()
    eng = ServingEngine(params, cfg, device="cpu", kv_quant=kv_quant,
                        journal_dir=jdir, snapshot_every=FULL_EVERY,
                        **FULL_POOL)
    rids = _full_submit(eng, cfg)
    while eng.step_count < FULL_SNAP:
        eng.step()
    return eng, rids


@pytest.mark.parametrize("crash", ["abandon", "torn", "uncommitted"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_full_snapshot_recovers_every_kind_of_state(tmp_path, kv_quant,
                                                    crash):
    """FULL_TRACE, fp32 or int8 pages: the snapshot at tick FULL_SNAP
    holds live slots, the parked sampled request (its generator's state),
    C's chunk job and prefix entries; each crash class at tick FULL_CRASH
    recovers to the uninterrupted run's streams and statuses, the chunk
    job's prefill rerun, the parked request resumed, the oracle drained,
    the audit green on every tick."""
    cfg, params = _setup()
    plain = ServingEngine(params, cfg, device="cpu", kv_quant=kv_quant,
                          **FULL_POOL)
    pids = _full_submit(plain, cfg)
    pfin = plain.run()
    ps = plain.stats()
    assert ps["preemptions"] == 1 and ps["prefix_hits"] >= 1

    eng, rids = full_trace_engine(kv_quant, str(tmp_path))
    payload = EngineJournal.latest_committed(str(tmp_path))[1]
    assert payload["meta"]["step"] == FULL_SNAP
    assert len(payload["slots"]) == 2 and len(payload["preempted"]) == 1
    assert payload["chunk_req"] is not None
    assert len(payload["prefix"]["entries"]) == 2
    while eng.step_count < FULL_CRASH:
        eng.step()
    committed = eng.journal._seq
    tail = len(EngineJournal.read_tail(str(tmp_path), committed))
    if crash == "torn":
        eng.journal.tear_tail(eng.journal._last_record_bytes)
        tail -= 1
    elif crash == "uncommitted":
        eng.journal.write_uncommitted_snapshot(eng._snapshot_payload())

    rec = _recover(tmp_path, params, cfg)
    assert rec.recovered_info["snapshot_seq"] == committed
    assert rec.replayed_events == tail > 0
    assert rec._preempted and rec.prefix_index.node_pages()
    rec.audit_every_tick = True
    fin = rec.run()
    assert [fin[r].tokens for r in rids] == [pfin[r].tokens for r in pids]
    assert rec.stats()["statuses"] == ps["statuses"] == {"DONE": 6}
    assert not rec._replay_expect and rec.pool.alloc.pages_in_use == 0


# A page-bound pool (7 usable pages of 8 tokens) that holds its two streams
# only because they share: the donor of a 30-token prompt (3 full pages and
# a tail) allocates 4 pages and reserves 5; its repeat, a sampled cache
# admission, maps the 3 full pages and allocates 1 of its own, reserving 5
# with the shared ones counted as held. Privately, the two would need 10.
SHARED_POOL = dict(num_slots=2, max_tokens=40, paged=True, page_size=8,
                   num_pages=8, prefix_share=True)


def test_recover_slots_that_fit_only_by_sharing(tmp_path):
    """The snapshot saves the pages that several holders map once; recovery
    writes them back first and the restored slots map them copy-on-write
    again, so a pool that fit its streams only by sharing is restored (it
    would be over-committed were each slot given private pages) and the
    recovered streams equal the uninterrupted run's."""
    cfg, params = _setup()
    prompt = _prompts(cfg, 8, 1, size=30)[0]

    def submit(eng):
        return [eng.submit(prompt, 8),
                eng.submit(prompt, 8, temperature=0.8, top_p=0.9, seed=5)]

    plain = ServingEngine(params, cfg, device="cpu", **SHARED_POOL)
    pids = submit(plain)
    pfin = plain.run()
    assert plain.prefix_hits == 1
    eng = ServingEngine(params, cfg, device="cpu", journal_dir=str(tmp_path),
                        snapshot_every=2, **SHARED_POOL)
    rids = submit(eng)
    while eng.step_count < 3:
        eng.step()
    payload = EngineJournal.latest_committed(str(tmp_path))[1]
    assert payload["meta"]["step"] == 2 and len(payload["slots"]) == 2
    assert len(payload["pages"]["ids"]) == 3
    assert [len(s[2]["shared"]) for s in payload["slots"]] == [3, 3]

    rec = _recover(tmp_path, params, cfg)
    pages = rec.prefix_index.node_pages()
    assert len(pages) == 3 and all(
        rec.pool.alloc.refcount(p) == 3 for p in pages)
    rec.audit_every_tick = True
    fin = rec.run()
    assert [fin[r].tokens for r in rids] == [pfin[r].tokens for r in pids]
    assert rec.stats()["statuses"] == {"DONE": 2}
    assert not rec._replay_expect and rec.pool.alloc.pages_in_use == 0


# ------------------------------------------------------- contract refusals


def test_recover_without_snapshot_raises(tmp_path):
    cfg, params = _setup()
    with pytest.raises(JournalError, match="no committed snapshot"):
        _recover(tmp_path / "absent", params, cfg)


def test_recover_refuses_other_weights_or_config(tmp_path):
    """The snapshot records the config's name and the params' checksum:
    recovery under other weights, or another config, raises instead of
    continuing the streams under another model."""
    cfg, params = _setup()
    eng = _engine(params, cfg, tmp_path)
    eng.submit(_prompts(cfg, 9, 1)[0], 4)
    eng.step()
    other = {k: v for k, v in params.items()}
    other["embed"] = params["embed"] + 1.0
    with pytest.raises(JournalError, match="another model"):
        _recover(tmp_path, other, cfg)
    with pytest.raises(JournalError, match="another model"):
        _recover(tmp_path, params, cfg.with_overrides(name="other"))
    assert _recover(tmp_path, params, cfg).run()


def test_journal_requires_paged_pool(tmp_path):
    cfg, params = _setup()
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(params, cfg, device="cpu", num_slots=1,
                      max_tokens=MAX_TOKENS, journal_dir=str(tmp_path))


# ------------------------------------------------------- process supervisor


def _gen_script(body0, body1):
    """A child that branches on the generation the supervisor appends to
    its argv (`--generation <n>`)."""
    return ("import os, sys, time\n"
            "gen = int(sys.argv[sys.argv.index('--generation') + 1])\n"
            f"if gen == 0:\n    {body0}\nelse:\n    {body1}\n")


def test_supervisor_restarts_until_clean_exit():
    sup = ProcessSupervisor(
        [sys.executable, "-c", _gen_script("os._exit(3)", "os._exit(0)")])
    sup.BACKOFF_S = 0.01
    assert sup.run() == 0
    assert sup.stats.restarts == 1
    assert sup.stats.exit_codes == [3, 0]


def test_supervisor_budget_exhausted_raises():
    sup = ProcessSupervisor(
        [sys.executable, "-c", "import os; os._exit(2)"])
    sup.MAX_RESTARTS, sup.BACKOFF_S = 1, 0.01
    with pytest.raises(RestartRequired, match="restart budget"):
        sup.run()
    assert sup.stats.exit_codes == [2, 2]


def test_supervisor_kills_on_stale_heartbeat(tmp_path):
    """A hung child (alive, never ticking) is SIGKILLed on heartbeat
    staleness and restarted as a crash is; the child gets the heartbeat
    path on its argv."""
    hb = str(tmp_path / "hb")
    body1 = ("assert sys.argv[sys.argv.index('--heartbeat') + 1] == "
             f"{hb!r}; os._exit(0)")
    sup = ProcessSupervisor(
        [sys.executable, "-c", _gen_script("time.sleep(120)", body1)],
        heartbeat_file=hb)
    sup.HEARTBEAT_TIMEOUT_S, sup.POLL_S, sup.BACKOFF_S = 0.5, 0.05, 0.01
    assert sup.run() == 0
    assert sup.stats.heartbeat_kills == 1
    assert sup.stats.exit_codes == [-9, 0]


# ------------------------------------------------- real SIGKILLs, the CLI


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


# the CLI's workload: seed-0 weights, default_rng(0) prompts, one arrival
# every other tick
CLI = ["--arch", "llama_moe_4_16", "--smoke", "--device", "cpu",
       "--requests", "4", "--slots", "2", "--prompt", "12", "--gen", "12",
       "--paged", "--page-size", "8", "--snapshot-every", "4"]


def _serve_cmd(jdir, *extra):
    return [sys.executable, "-m", "repro_torch.launch.serve", *CLI,
            "--journal-dir", str(jdir), *extra]


def _cli_reference():
    """The CLI's workload uninterrupted, in this process."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import model_init
    cfg = get_config("llama_moe_4_16", smoke=True)
    params = model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=12, dtype=np.int32)
               for _ in range(4)]
    ref = TS.serve_continuous(params, cfg, prompts, 12, num_slots=2,
                              arrival_steps=[0, 2, 4, 6], paged=True,
                              page_size=8, device="cpu")
    return cfg, params, ref


def test_sigkill_mid_decode_then_recover(tmp_path):
    """A real `kill -9` at tick 6 of the CLI's journaled run: the child dies
    by SIGKILL after printing its params' checksum (this process's copy's),
    and recovering its journal here finishes every stream as the
    uninterrupted workload does."""
    jdir = tmp_path / "jnl"
    out = subprocess.run(_serve_cmd(jdir, "--crash-step", "6"), env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -signal.SIGKILL, out.stderr[-2000:]
    assert EngineJournal.recoverable(str(jdir))
    cfg, params, ref = _cli_reference()
    assert f"params checksum {TS.params_checksum(params)!r}" in out.stdout
    rec = _recover(jdir, params, cfg)
    fin = rec.run()
    assert rec.stats()["statuses"] == {"DONE": 4}
    for rid, toks in ref["tokens"].items():
        assert fin[rid].tokens == toks.tolist(), rid


@pytest.mark.parametrize("crash_class", ["torn", "snap"])
def test_maybe_crash_classes_in_a_child(tmp_path, crash_class):
    """Chaos's "torn" and "snap" classes kill a journaled engine's process
    at tick 6 after tearing the last record or writing an uncommitted
    snapshot; the journal still recovers to the uninterrupted streams."""
    jdir = tmp_path / "jnl"
    script = (
        "import sys, numpy as np, torch\n"
        "from repro_torch.configs.registry import get_config\n"
        "from repro_torch.models.model import model_init\n"
        "from repro_torch.serving import Chaos, ServingEngine\n"
        "cfg = get_config('llama_moe_4_16', smoke=True)\n"
        "p = model_init(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        f"chaos = Chaos(seed=1, crash_step=6, crash_class={crash_class!r})\n"
        f"eng = ServingEngine(p, cfg, device='cpu', num_slots=2, "
        f"max_tokens=48, paged=True, page_size=8, chaos=chaos, "
        f"journal_dir={str(jdir)!r}, snapshot_every=4)\n"
        "rng = np.random.default_rng(0)\n"
        "for i in range(4):\n"
        "    eng.submit(rng.integers(0, cfg.vocab_size, size=12, "
        "dtype=np.int32), 12, arrival_step=2 * i)\n"
        "eng.run()\n")
    out = subprocess.run([sys.executable, "-c", script], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -signal.SIGKILL, out.stderr[-2000:]
    names = os.listdir(jdir)
    if crash_class == "snap":
        assert "snap_00000002" in names and not os.path.exists(
            jdir / "snap_00000002" / "COMMITTED")
    cfg, params, ref = _cli_reference()
    rec = _recover(jdir, params, cfg)
    assert rec.recovered_info["snapshot_seq"] == 1
    fin = rec.run()
    for rid, toks in ref["tokens"].items():
        assert fin[rid].tokens == toks.tolist(), rid


def test_supervised_serve_survives_crash(tmp_path):
    """--supervise runs the CLI as a watched child; chaos SIGKILLs
    generation 0 at tick 6, the supervisor restarts it, and generation 1
    recovers from the journal and drains to exit 0."""
    jdir = tmp_path / "jnl"
    out = subprocess.run(_serve_cmd(jdir, "--supervise", "--crash-step", "6"),
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    assert "supervised serve exited 0 after 1 restart(s)" in out.stdout
    assert "recovered from" in out.stdout
    assert "'DONE': 4" in out.stdout and "restart generation: 1" in \
        out.stdout


def test_crashing_command_run_again_recovers(tmp_path):
    """--crash-step fires only in a fresh run: the same command run again
    on the killed run's journal recovers and drains instead of crashing."""
    jdir = tmp_path / "jnl"
    cmd = _serve_cmd(jdir, "--crash-step", "6")
    first = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                           timeout=120)
    assert first.returncode == -signal.SIGKILL, first.stderr[-2000:]
    again = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                           timeout=120)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "recovered from" in again.stdout and "'DONE': 4" in again.stdout
