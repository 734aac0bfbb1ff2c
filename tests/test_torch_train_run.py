"""The trainer's substrate against the JAX package, and its restart
contract port against port: AdamW, clipping and the cosine schedule on
one tree (within 1e-6 relative: fp32 elementwise on both sides, the norm's
sums in another order); the synthetic corpus (batches equal); three
`train.run` steps on the llama smoke model from the same weights (losses
within 1e-5 relative); checkpoints across the two packages, bf16 leaves
included; a run interrupted by RestartRequired, or resumed from its
latest committed step, bit-equal to an uninterrupted one; the step's
retry rule; the reference's checkpoint corruption cases, mirrored.
"""
import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as JC  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt as TC  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.runtime.fault import RestartRequired  # noqa: E402

torch.set_float32_matmul_precision("highest")
ARCH = "llama_moe_4_16"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"a": f(4, 3), "b": {"c": f(5), "d": np.arange(2, dtype=np.int32)}}
    grads = {"a": f(4, 3) * 3, "b": {"c": f(5) * 3,
                                     "d": np.zeros(2, np.int32)}}
    m = {"a": f(4, 3) * 0.1, "b": {"c": f(5) * 0.1, "d": None}}
    v = {"a": np.abs(f(4, 3)) * 0.1, "b": {"c": np.abs(f(5)) * 0.1,
                                           "d": None}}
    return params, grads, JO.AdamWState(np.int32(3), m, v)


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_and_clip_match_reference(grad_clip):
    params, grads, state = _opt_tree(0)
    jp, js, jm = JO.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), lr=jnp.float32(1e-2),
        grad_clip=grad_clip)
    tp = bridge.params_from_numpy(params, "cpu")
    ts = bridge.opt_state_from_numpy(state, "cpu")
    tp2, ts2, tm = TO.adamw_update(tp, bridge.params_from_numpy(grads, "cpu"),
                                   ts, lr=torch.tensor(1e-2),
                                   grad_clip=grad_clip)
    assert tp2 is tp and ts2.m is ts.m            # updated in place
    tol = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert int(ts2.step) == int(js.step) == 4
    for got, ref in ((tp2, jp), (ts2.m, js.m), (ts2.v, js.v)):
        for a, b in zip(TO.tree_leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    g32 = jax.tree.map(lambda g: jnp.asarray(g, jnp.float32), grads)
    jc, jn = JO.clip_by_global_norm(g32, 1.0)
    tc, tn = TO.clip_by_global_norm(bridge.params_from_numpy(grads, "cpu"),
                                    1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(TO.tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    init = TO.adamw_init(tp)
    assert init.m["b"]["d"] is None and init.m["a"].dtype == torch.float32


def test_cosine_lr_matches_reference():
    for step in range(12):
        kw = dict(base_lr=3e-4, warmup=3, total=10)
        np.testing.assert_allclose(float(TO.cosine_lr(step, **kw)),
                                   float(JO.cosine_lr(jnp.int32(step), **kw)),
                                   rtol=1e-6)


def test_corpus_batches_equal_reference():
    kw = dict(vocab_size=300, seq_len=24, global_batch=4, seed=3)
    jc, tc = JD.SyntheticCorpus(JD.DataConfig(**kw)), \
        TD.SyntheticCorpus(TD.DataConfig(**kw))
    for args in ((0,), (5,), (2, 1, 2)):
        ja, ta = jc.batch(*args), tc.batch(*args)
        for k in ("tokens", "labels"):
            assert ta[k].dtype == ja[k].dtype
            np.testing.assert_array_equal(ta[k], ja[k])
    it = TD.make_batch_iterator(TD.DataConfig(**kw), start_step=7)
    step, b = next(it)
    assert step == 7
    np.testing.assert_array_equal(b["tokens"], jc.batch(7)["tokens"])


def test_three_train_steps_match_reference(monkeypatch):
    """Both drivers from the port's seeded weights (the JAX run's init
    patched to return them: the JAX init costs seconds on the CPU)."""
    kw = dict(steps=3, seq_len=16, global_batch=2, warmup_steps=1,
              ckpt_every=0, log_every=100)
    tcfg = get_config(ARCH, smoke=True)
    tp = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    monkeypatch.setattr(JT, "model_init", lambda key, cfg: jp)
    ref = JT.run(jax_config(ARCH, smoke=True),
                 JTrainConfig(ckpt_dir=tempfile.mkdtemp(), **kw),
                 resume=False, log=lambda s: None)
    got = TT.run(tcfg, TrainConfig(ckpt_dir=tempfile.mkdtemp(), **kw),
                 resume=False, device="cpu", log=lambda s: None, params=tp)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert got["steps"] == ref["steps"] == 3


def _llama_run(ckpt_dir, steps=5, fault=None, resume=False):
    tc = TrainConfig(steps=steps, seq_len=16, global_batch=2, warmup_steps=1,
                     ckpt_every=2, log_every=100, ckpt_dir=ckpt_dir)
    return TT.run(get_config(ARCH, smoke=True), tc, resume=resume,
                  device="cpu", log=lambda s: None, fault=fault)


def _checksum(tree):
    return [t.detach().clone() for t in TO.tree_leaves(tree)]


@pytest.fixture(scope="module")
def uninterrupted():
    out = _llama_run(tempfile.mkdtemp())
    return out["losses"], _checksum(out["params"])


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_restart_resumes_bit_equal(uninterrupted, tmp_path):
    """RestartRequired raised after step 3's in-place update: the driver
    restores step 2's checkpoint and runs 2, 3, 4 again."""
    losses, final = uninterrupted
    fired = []

    def fault(step, phase):
        if step == 3 and phase == "update" and not fired:
            fired.append(step)
            raise RestartRequired("injected")
    out = _llama_run(str(tmp_path), fault=fault)
    assert fired == [3]
    assert out["losses"] == losses[:3] + losses[2:]
    assert _equal(_checksum(out["params"]), final)


def test_retry_rule_before_and_after_the_first_write(uninterrupted,
                                                     tmp_path):
    """A transient error before the in-place update is retried with the
    same inputs; one after it turns into RestartRequired and a restore.
    Both end bit-equal to the uninterrupted run."""
    losses, final = uninterrupted
    seen = []

    def fault(step, phase):
        if (step, phase) in ((1, "grads"), (3, "update")) and \
                (step, phase) not in seen:
            seen.append((step, phase))
            raise RuntimeError(f"transient at {step} {phase}")
    out = _llama_run(str(tmp_path), fault=fault)
    assert out["retries"] == 1 and len(seen) == 2
    assert out["losses"] == losses[:3] + losses[2:]
    assert _equal(_checksum(out["params"]), final)


class _Abort(Exception):
    """Not a transient error class: it ends the run."""


def test_resume_from_latest_committed_step(uninterrupted, tmp_path):
    """A run that dies in step 4 leaves step 4's checkpoint; a new run
    resumes there and ends bit-equal to the uninterrupted one."""
    losses, final = uninterrupted

    def die(step, phase):
        if step == 4:
            raise _Abort()
    with pytest.raises(_Abort):
        _llama_run(str(tmp_path), fault=die)
    assert TC.latest_step(str(tmp_path)) == 4
    second = _llama_run(str(tmp_path), resume=True)
    assert second["steps"] == 1 and second["losses"] == losses[4:]
    assert _equal(_checksum(second["params"]), final)


def _cross_tree():
    rng = np.random.default_rng(9)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"z": rng.standard_normal(5).astype(np.float32)},
            "h": (rng.standard_normal((2, 3)) * 8).astype(np.float32)}


def test_checkpoints_cross_between_packages(tmp_path):
    """The port restores what the JAX package wrote (a bf16 leaf and an
    AdamWState included) and the JAX package what the port wrote; the
    port's files are byte-for-byte the JAX package's for the same tree."""
    tree = _cross_tree()
    jtree = {"w": jnp.asarray(tree["w"]), "b": {"z": jnp.asarray(tree["b"]["z"])},
             "h": jnp.asarray(tree["h"], jnp.bfloat16)}
    jstate = JO.AdamWState(jnp.int32(7), {"a": jnp.ones(3)}, {"a": jnp.zeros(3)})
    JC.save(str(tmp_path / "jax"), 3, {"p": jtree, "o": jstate})
    ttree = bridge.params_from_numpy(_np_tree(jtree), "cpu")
    tstate = bridge.opt_state_from_numpy(_np_tree(jstate), "cpu")
    like = {"p": {k: torch.zeros_like(v) if torch.is_tensor(v) else
                  {"z": torch.zeros(5)} for k, v in ttree.items()},
            "o": TO.adamw_init({"a": torch.zeros(3)})}
    got = TC.restore(str(tmp_path / "jax"), 3, like)
    assert got["p"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["p"]["h"], ttree["h"])
    assert torch.equal(got["p"]["w"], ttree["w"])
    assert isinstance(got["o"], TO.AdamWState) and int(got["o"].step) == 7
    assert torch.equal(got["o"].m["a"], tstate.m["a"])

    TC.save(str(tmp_path / "port"), 3, {"p": ttree, "o": tstate})
    jd, td = tmp_path / "jax" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    # the JAX package restores the port's fp32 tree and state...
    TC.save(str(tmp_path / "port32"), 4, {"p": {"w": ttree["w"]},
                                          "o": tstate})
    back = JC.restore(str(tmp_path / "port32"), 4,
                      {"p": {"w": jtree["w"]}, "o": jstate})
    np.testing.assert_array_equal(np.asarray(back["p"]["w"]), tree["w"])
    assert int(back["o"].step) == 7
    # ...but rejects a bf16 leaf, its own as well as the port's (its header
    # check compares numpy's '|V2' with the manifest's "bfloat16")
    for d in ("jax", "port"):
        with pytest.raises(JC.CorruptCheckpoint, match="V2"):
            JC.restore(str(tmp_path / d), 3, {"p": jtree, "o": jstate})


def test_ckpt_roundtrip_gc_async_and_uncommitted(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    TC.save(str(tmp_path), 10, tree)
    w = TC.save(str(tmp_path), 20, tree, async_=True)
    w.wait()
    assert TC.latest_step(str(tmp_path)) == 20
    back = TC.restore(str(tmp_path), 10, tree)
    assert torch.equal(back["a"], tree["a"])
    os.makedirs(tmp_path / "step_00000030")           # crashed before marker
    assert TC.latest_step(str(tmp_path)) == 20
    for s in range(21, 25):
        TC.save(str(tmp_path), s, tree)
    assert TC.committed_steps(str(tmp_path)) == [22, 23, 24]
    manifest = json.loads((tmp_path / "step_00000024" /
                           "manifest.json").read_text())
    assert [m["file"] for m in manifest["leaves"]] == ["arr_0.npy",
                                                       "arr_1.npy"]


def test_ckpt_truncated_leaf_raises_typed_error(tmp_path):
    tree = {"a": torch.arange(64, dtype=torch.float32), "b": torch.ones(4),
            "h": torch.ones(8, dtype=torch.bfloat16)}
    TC.save(str(tmp_path), 1, tree)
    for i in (0, 2):
        f = tmp_path / "step_00000001" / f"arr_{i}.npy"
        good = f.read_bytes()
        f.write_bytes(good[:-4])
        with pytest.raises(TC.CorruptCheckpoint,
                           match=f"arr_{i}.npy.*truncated"):
            TC.restore(str(tmp_path), 1, tree)
        f.write_bytes(good)
    assert torch.equal(TC.restore(str(tmp_path), 1, tree)["h"], tree["h"])


def test_ckpt_garbage_header_and_shape_mismatch_raise(tmp_path):
    tree = {"a": torch.arange(12).reshape(3, 4)}
    TC.save(str(tmp_path), 1, tree)
    with pytest.raises(TC.CorruptCheckpoint, match="leaf 0.*ckpt shape"):
        TC.restore(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
    (tmp_path / "step_00000001" / "arr_0.npy").write_bytes(b"not an npy")
    with pytest.raises(TC.CorruptCheckpoint, match="arr_0.npy.*header"):
        TC.restore(str(tmp_path), 1, tree)
    os.unlink(tmp_path / "step_00000001" / "arr_0.npy")
    with pytest.raises(TC.CorruptCheckpoint, match="missing"):
        TC.restore(str(tmp_path), 1, tree)


def test_ckpt_orphan_dirs_swept_on_next_save(tmp_path):
    tree = {"a": torch.ones(3)}
    TC.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000007")          # crashed before marker
    os.makedirs(tmp_path / "step_00000003.tmp")      # crashed mid-write
    TC.save(str(tmp_path), 2, tree)
    assert not (tmp_path / "step_00000007").exists()
    assert not (tmp_path / "step_00000003.tmp").exists()
    assert TC.committed_steps(str(tmp_path)) == [1, 2]


def test_cli_trains_on_cpu_and_needs_a_card_by_default(tmp_path, capsys,
                                                        monkeypatch):
    out = TT.main(["--arch", ARCH, "--smoke", "--steps", "2", "--seq-len",
                   "8", "--global-batch", "2", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "final loss" in capsys.readouterr().out
    assert TC.latest_step(str(tmp_path)) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        TT.main(["--arch", ARCH, "--smoke", "--steps", "1",
                 "--ckpt-dir", str(tmp_path), "--fresh"])


def test_microbatched_step_equals_the_whole_batch_within_fp32():
    """Gradient accumulation over two microbatches of one sequence: the
    mean of the two gradients, within 1e-5 of the whole batch's step."""
    kw = dict(steps=2, seq_len=16, global_batch=2, warmup_steps=1,
              ckpt_every=0, log_every=100, ckpt_dir=tempfile.mkdtemp())
    cfg = get_config(ARCH, smoke=True)
    whole = TT.run(cfg, TrainConfig(**kw), resume=False, device="cpu",
                   log=lambda s: None)
    micro = TT.run(cfg, TrainConfig(microbatch=1, **kw), resume=False,
                   device="cpu", log=lambda s: None)
    np.testing.assert_allclose(micro["losses"], whole["losses"], rtol=1e-5)
    for a, b in zip(TO.tree_leaves(micro["params"]),
                    TO.tree_leaves(whole["params"])):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-4,
                                   atol=1e-5)
    assert dataclasses.replace(TrainConfig(), seed=1).seed == 1
