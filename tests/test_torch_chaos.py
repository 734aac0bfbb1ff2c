"""The port's chaos lane (serving/chaos.py, a copy of the reference's
injector without its environment constructor) driving the engine's fault
domain, on the smoke llama_moe_4_16, fp32, on the CPU.

Against the JAX package:
  * the injector itself: one seed and one scripted sequence of event calls
    give the reference's draws, victims and counts;
  * the chaos churn (tick faults, admission pressure, forced preemptions
    under Chaos(seed=3, tick_fail=0.3, pressure=0.2, preempt=0.4) on a
    paged pool, the audit on every tick) gives the JAX engine's streams,
    statuses, injected counts, preemptions, tick retries and finish steps
    on the same weights: the engine calls the events in the reference's
    order.

Port against port, the reference's contracts (tests/test_chaos.py): under
the churn every stream equals running alone and the pool drains; heavy
tick faults on a dense pool are retried and change nothing; a fault that
never clears raises RestartRequired past the supervisor's budget; seeded
NaN injections fail only the poisoned streams, each a prefix of its clean
stream; the audit catches pages freed behind the pool's back.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import Chaos as JaxChaos  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.fault import RestartRequired  # noqa: E402
from repro_torch.serving import (TERMINAL_STATUSES, Chaos,  # noqa: E402
                                 ChaosError, RequestStatus, ServingEngine)
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
MAX_TOKENS = 48
CHURN = dict(seed=3, tick_fail=0.3, pressure=0.2, preempt=0.4)
CHURN_POOL = dict(num_slots=3, max_tokens=MAX_TOKENS, paged=True,
                  page_size=8)


@pytest.fixture(scope="module")
def port_params():
    cfg = get_config("llama_moe_4_16", smoke=True)
    return cfg, TM.model_init(cfg, torch.Generator().manual_seed(5), "cpu")


def _static(params, cfg, prompt, gen):
    res = TS.generate(params, cfg, torch.from_numpy(prompt)[None], gen,
                      device="cpu", max_len=MAX_TOKENS)
    return res["tokens"][0].tolist()


def _prompts(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=12, dtype=np.int32)
            for _ in range(n)]


def _churn(eng, prompts):
    """The churn trace on an engine of either package: audit every tick,
    six 12-token prompts, 16 new tokens each. Returns the finished
    requests in submit order."""
    eng.audit_every_tick = True
    rids = [eng.submit(p, 16) for p in prompts]
    fin = eng.run()
    return [fin[r] for r in rids]


# ------------------------------------------------------------ the injector

def test_injector_draws_equal_the_reference():
    """One scripted sequence of every event method, with faults in and out
    of the consecutive cap, on the port's and the reference's injector
    from one seed: the same outcomes, victims and counts."""
    kw = dict(seed=11, tick_fail=0.5, pressure=0.3, preempt=0.4, nan=0.2,
              crash=0.1, crash_step=7, crash_class="mix")
    port, ref = Chaos(**kw), JaxChaos(**kw)

    def script(c, raises):
        out = []
        for step in range(40):
            out.append(c.pressure_event())
            out.append(c.preempt_victim([0, 2, 5][:1 + step % 3]))
            out.append(c.nan_victim([1, 4]))
            try:
                c.maybe_tick_fault(step)
                out.append("ok")
            except raises:
                out.append("fault")
            out.append(c.crash_event(step))
            out.append(c.torn_cut(1 + step))
        return out, dict(c.injected), c.describe()

    got, want = script(port, ChaosError), script(ref, RuntimeError)
    assert got == want
    assert min(got[1].values()) >= 1          # every event fired
    with pytest.raises(ValueError, match="crash_class"):
        Chaos(crash_class="explode")
    assert not hasattr(Chaos, "from_env")


# --------------------------------------------------------------- the churn

def test_chaos_churn_equals_jax_engine(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    jcfg, tcfg, jp, tp = smoke_pair("llama_moe_4_16")
    prompts = _prompts(tcfg, 0, 6)
    jeng = JaxEngine(jp, jcfg, chaos=JaxChaos(**CHURN), **CHURN_POOL)
    ref = _churn(jeng, prompts)
    eng = ServingEngine(tp, tcfg, chaos=Chaos(**CHURN), device="cpu",
                        **CHURN_POOL)
    got = _churn(eng, prompts)
    for r, j in zip(got, ref):
        assert (r.tokens, r.status.value, r.finish_step, r.preemptions) == \
            (j.tokens, j.status.value, j.finish_step, j.preemptions), \
            f"request {r.request_id}"
    s, js = eng.stats(), jeng.stats()
    for key in ("chaos", "preemptions", "resumes", "tick_retries",
                "statuses", "steps"):
        assert s[key] == js[key], key
    assert s["preemptions"] >= 1 and s["tick_retries"] >= 1


def test_chaos_churn_preserves_streams_and_pages(port_params):
    """Tick failures, admission pressure and forced evictions are invisible
    in the output: every stream equals running alone, every preempted
    stream resumed, no page leaks, the audit green every tick."""
    cfg, params = port_params
    prompts = _prompts(cfg, 0, 6)
    eng = ServingEngine(params, cfg, chaos=Chaos(**CHURN), device="cpu",
                        **CHURN_POOL)
    assert eng.preemption          # chaos preempt > 0 arms the resume path
    fin = _churn(eng, prompts)
    s = eng.stats()
    assert s["chaos"]["tick_faults"] >= 1 and s["tick_retries"] >= 1
    assert s["chaos"]["pressure"] >= 1
    assert s["preemptions"] >= 1 and s["resumes"] == s["preemptions"]
    assert all(req.status in TERMINAL_STATUSES for req in fin)
    for req, p in zip(fin, prompts):
        assert req.status is RequestStatus.DONE
        assert req.tokens == _static(params, cfg, p, 16), \
            f"request {req.request_id} diverged under chaos"
    assert eng.pool.alloc.pages_in_use == 0
    eng.pool.audit()


def test_chaos_tick_faults_retried_bit_identical_dense(port_params):
    cfg, params = port_params
    prompts = _prompts(cfg, 1, 3)
    eng = ServingEngine(params, cfg, num_slots=2, max_tokens=MAX_TOKENS,
                        chaos=Chaos(seed=1, tick_fail=0.5), device="cpu")
    assert not eng.preemption
    rids = [eng.submit(p, 12) for p in prompts]
    fin = eng.run()
    assert eng.stats()["tick_retries"] >= 1
    for rid, p in zip(rids, prompts):
        assert fin[rid].status is RequestStatus.DONE
        assert fin[rid].tokens == _static(params, cfg, p, 12)


def test_supervisor_exhaustion_raises_restart_required(port_params):
    """A fault that never clears does not spin: past the supervisor's retry
    budget the tick raises RestartRequired with the chaos error chained."""
    cfg, params = port_params
    chaos = Chaos(seed=0, tick_fail=1.0, max_consecutive_faults=10 ** 6)
    eng = ServingEngine(params, cfg, num_slots=1, max_tokens=MAX_TOKENS,
                        chaos=chaos, device="cpu")
    eng.submit(_prompts(cfg, 2, 1)[0][:8], 4)
    with pytest.raises(RestartRequired) as ei:
        eng.run()
    assert isinstance(ei.value.__cause__, ChaosError)
    assert eng.stats()["tick_retries"] == 4      # max_retries 3, then out


@pytest.mark.parametrize("paged", [False, True])
def test_chaos_nan_injection_quarantines_without_cross_contamination(
        port_params, paged):
    """Seeded NaN poisoning fails the poisoned streams (each a prefix of
    its clean stream) and leaves every survivor bit-identical; the pool
    drains with its scrubbed pages clean."""
    cfg, params = port_params
    prompts = _prompts(cfg, 3, 4)
    kw = dict(paged=True, page_size=8) if paged else {}
    eng = ServingEngine(params, cfg, num_slots=2, max_tokens=MAX_TOKENS,
                        chaos=Chaos(seed=2, nan=0.12), device="cpu", **kw)
    eng.audit_every_tick = True
    rids = [eng.submit(p, 12) for p in prompts]
    fin = eng.run()
    statuses = eng.stats()["statuses"]
    assert statuses.get("FAILED", 0) >= 1, "seeded NaN never landed"
    assert statuses.get("DONE", 0) >= 1, "no survivors to check isolation"
    assert eng.stats()["chaos"]["nans"] >= 1
    for rid, p in zip(rids, prompts):
        ref = _static(params, cfg, p, 12)
        if fin[rid].status is RequestStatus.DONE:
            assert fin[rid].tokens == ref
        else:
            assert fin[rid].status is RequestStatus.FAILED
            assert fin[rid].fail_reason == "non-finite logits"
            assert fin[rid].tokens == ref[:len(fin[rid].tokens)]
    assert not eng.pool.any_active()
    for key in ("k", "v", "k_pages", "v_pages"):
        if key in eng.pool.state:
            assert bool(torch.isfinite(eng.pool.state[key]).all()), key


def test_audit_catches_page_accounting_corruption(port_params):
    """Freeing a live slot's pages behind the pool's back (its block table
    still mapping them) fails the next audit."""
    cfg, params = port_params
    eng = ServingEngine(params, cfg, num_slots=2, max_tokens=MAX_TOKENS,
                        paged=True, page_size=8, device="cpu")
    rid = eng.submit(_prompts(cfg, 4, 1)[0], 8)
    for _ in range(3):
        eng.step()
    eng.pool.audit()                           # clean while consistent
    eng._audit()
    eng.pool.alloc.free(rid)                   # corrupt: pages freed, table live
    with pytest.raises(AssertionError, match="block table"):
        eng.pool.audit()
