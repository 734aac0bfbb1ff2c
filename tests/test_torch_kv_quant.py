"""The port's int8 decode state (cfg.kv_quant="int8": int8 KV pages with
one f32 scale per (page, kv head), int8 GO rows with one per row) through
the continuous-batching engine, on the smoke configs, fp32, on the CPU
(K3/K4 run their plain versions: gather, then dequantize).

Against the JAX package (same weights through `bridge.params_from_numpy`;
the JAX side runs backend="pallas" in interpret mode): the greedy streams
of a staggered trace on an int8 paged pool with chunked prefill are EQUAL
to the JAX int8 engine's, for llama_moe_4_16 (expert choice, GO cache)
and granite-moe-3b-a800m (token choice, no GO cache).

Port against port, the reference's contracts (tests/test_kv_quant.py):
pooled int8 streams equal solo int8 streams and a rerun repeats streams,
pages, scales and GO rows bit for bit (the null page 0 left out); released
pages return with zero scales; an idle GO row keeps its int8 bits across
ticks; impossible pools raise typed errors naming kv_quant; stats() report
the int8 fields; int8 attention stays a bounded distance from fp32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch.serve import serve_continuous as jax_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.kernels import paged_attn as PA  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

torch.set_float32_matmul_precision("highest")
MAX_TOKENS = 48
# the staggered trace of tests/test_torch_serving.py on pages of 8 (int8
# pages need a multiple of 8): 5 requests over 2 slots, the 20- and
# 11-token prompts chunked by 8, the 20-token one waiting for pages
LENS = [5, 20, 8, 11, 3]
ARRIVALS = [0, 0, 1, 4, 6]
GEN = 7
POOL = dict(num_slots=2, max_tokens=32, paged=True, page_size=8,
            num_pages=6, prefill_chunk=8, kv_quant="int8")


def _bridged(arch):
    jcfg = jax_config(arch, smoke=True)
    jcfg = jcfg.with_overrides(
        moe=dataclasses.replace(jcfg.moe, backend="pallas"))
    JM.expert_groups(jcfg), JM.expert_group_members(jcfg)
    p = JM.model_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n, dtype=np.int32)
               for n in LENS]
    return jcfg, get_config(arch, smoke=True), p, tp, prompts


@pytest.fixture(scope="module")
def port_params():
    cfg = get_config("llama_moe_4_16", smoke=True)
    return cfg, TM.model_init(cfg, torch.Generator().manual_seed(5), "cpu")


def _engine(params, cfg, **kw):
    kw = {"num_slots": 2, "max_tokens": MAX_TOKENS, "paged": True,
          "page_size": 8, "kv_quant": "int8", **kw}
    return ServingEngine(params, cfg, device="cpu", **kw)


def _solo(params, cfg, prompt, gen, **kw):
    """The request alone on a 1-slot int8 engine (the same chunking):
    expert-choice decode through the GO cache is row-wise independent, so
    this is the bit-identity oracle for pooled streams."""
    eng = _engine(params, cfg, num_slots=1, **kw)
    rid = eng.submit(prompt, gen)
    return eng.run()[rid].tokens


def _state_without_null_page(state):
    """Every tensor of an int8 pool's state, page 0 left out of the pages
    and scales (retired rows write the null page, several to one position
    in a tick, and nothing reads it)."""
    out = {}
    for k, v in state.items():
        if k in ("k_pages", "v_pages", "k_scales", "v_scales"):
            out[k] = v[:, 1:]
        elif k == "go":
            out.update({f"go.{f}": a for f, a in zip(v._fields, v)})
        elif isinstance(v, torch.Tensor):
            out[k] = v
    return out


# --------------------------------------------------- against the JAX package

@pytest.mark.parametrize("arch", ["llama_moe_4_16", "granite-moe-3b-a800m"])
def test_int8_engine_streams_equal_jax_engine(arch):
    jcfg, tcfg, p, tp, prompts = _bridged(arch)
    ref = jax_serve(p, jcfg, prompts, GEN, arrival_steps=ARRIVALS, **POOL)
    got = TS.serve_continuous(tp, tcfg, prompts, GEN, arrival_steps=ARRIVALS,
                              device="cpu", **POOL)
    for rid, toks in ref["tokens"].items():
        np.testing.assert_array_equal(got["tokens"][rid], toks,
                                      err_msg=f"request {rid}")
    s, rs = got["stats"], ref["stats"]
    assert (s["steps"], s["chunk_ticks"], s["peak_active"]) == \
        (rs["steps"], rs["chunk_ticks"], rs["peak_active"])
    assert s["chunk_ticks"] == 3 + 2 and s["page_waits"] > 0
    assert s["kv_quant_dtype"] == rs["kv_quant_dtype"] == "int8"
    assert s["kv_bytes_per_token"] == rs["kv_bytes_per_token"]
    eng = got["engine"]
    assert eng.pool.state["k_pages"].dtype == torch.int8
    assert ("go_scales" in eng.pool.state) == \
        (tcfg.moe.routing == "expert_choice")
    assert s["pages_in_use"] == 0


# ----------------------------------------------------------- port vs port

def test_pooled_streams_equal_solo_and_reruns_repeat(port_params):
    """Staggered arrivals and slot reuse on a 2-slot int8 pool: every stream
    equals the request alone on a 1-slot int8 engine; a rerun repeats the
    streams and the drained pool's pages, scales and GO rows bit for bit."""
    cfg, params = port_params
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (12, 12, 16, 12)]
    gens = [8, 5, 7, 6]

    def run():
        eng = _engine(params, cfg, prefill_chunk=8)
        rids = [eng.submit(p, g, arrival_step=a)
                for p, g, a in zip(prompts, gens, [0, 3, 7, 7])]
        fin = eng.run()
        return [fin[r].tokens for r in rids], eng

    got, eng = run()
    got2, eng2 = run()
    assert got == got2
    a = _state_without_null_page(eng.pool.state)
    b = _state_without_null_page(eng2.pool.state)
    assert a.keys() == b.keys() and "go_scales" in a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for toks, p, g in zip(got, prompts, gens):
        assert toks == _solo(params, cfg, p, g, prefill_chunk=8)
    assert eng.pool.alloc.pages_in_use == 0
    eng.pool.alloc.check()


def test_released_pages_return_with_zero_scales(port_params):
    """A retired request's pages come back with zero K and V scales on
    every layer; a live request's pages keep theirs."""
    cfg, params = port_params
    rng = np.random.default_rng(32)
    eng = _engine(params, cfg)
    short = eng.submit(rng.integers(0, cfg.vocab_size, 10, dtype=np.int32), 3)
    eng.submit(rng.integers(0, cfg.vocab_size, 10, dtype=np.int32), 30)
    owned = {}
    while short not in eng.finished:
        owned = {r: eng.pool.alloc.owned(r) for r in (0, 1)
                 if eng.pool.alloc.owned(r)} or owned
        eng.step()
    freed = owned[short]
    live = eng.pool.alloc.owned(1)
    assert freed and live and not set(freed) & set(live)
    st = eng.pool.state
    for key in ("k_scales", "v_scales"):
        assert (st[key][:, freed] == 0).all()
        assert (st[key][:, live] > 0).all()
    eng.run()
    for key in ("k_scales", "v_scales"):
        assert (st[key][:, 1:] == 0).all()


def test_idle_go_row_int8_bits_are_stable(port_params):
    """A GO row the decode does not replace goes through dequantize (f32)
    and requantize at every layer of every tick and keeps its int8 bits;
    the rows that change get new bits and scales."""
    cfg, params = port_params
    rng = np.random.default_rng(33)
    eng = _engine(params, cfg, num_slots=1)
    eng.submit(rng.integers(0, cfg.vocab_size, 16, dtype=np.int32), 12)
    eng.step()                                       # admit + first decode
    go = eng.pool.state["go"]
    changed = torch.zeros_like(go.token_ids, dtype=torch.bool)
    for _ in range(8):
        ids, outs = go.token_ids.clone(), go.outputs.clone()
        eng.step()
        same = go.token_ids == ids                   # rows not replaced
        changed |= ~same
        assert torch.equal(go.outputs[same], outs[same])
    assert changed.any() and (~changed).any()
    assert go.outputs.dtype == torch.int8


def test_typed_validation_fail_fast(port_params):
    cfg, params = port_params
    with pytest.raises(ValueError, match="kv_quant"):
        ServingEngine(params, cfg, num_slots=1, max_tokens=MAX_TOKENS,
                      kv_quant="int8", device="cpu")            # dense pool
    with pytest.raises(ValueError, match="kv_quant"):
        _engine(params, cfg, page_size=4)                       # untileable
    with pytest.raises(ValueError, match="kv_quant"):
        _engine(params, cfg, kv_quant="fp4")                    # unknown
    xl = get_config("xlstm-1.3b", smoke=True)
    xp = TM.model_init(xl, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises((ValueError, NotImplementedError)):      # recurrent
        ServingEngine(xp, xl, num_slots=1, max_tokens=16, paged=True,
                      page_size=8, kv_quant="int8", device="cpu")
    with pytest.raises(SystemExit):
        TS.main(["--arch", "llama_moe_4_16", "--smoke", "--device", "cpu",
                 "--kv-quant", "int8"])                         # no --paged


def test_stats_surface_quant_fields(port_params):
    cfg, params = port_params
    rng = np.random.default_rng(30)
    eng = _engine(params, cfg)
    eng.submit(rng.integers(0, cfg.vocab_size, 12, dtype=np.int32), 6)
    eng.run()
    s = eng.stats()
    assert s["kv_quant_dtype"] == "int8"
    assert s["kv_bytes_per_token"] == Q.kv_bytes_per_token(eng.cfg, 8)
    fp32 = _engine(params, cfg, kv_quant="none")
    assert s["kv_bytes_per_token"] < fp32.stats()["kv_bytes_per_token"] / 3
    assert fp32.stats()["kv_quant_dtype"] is None
    assert fp32.stats()["dequant_max_abs_err"] is None
    assert fp32.pool.state["k_pages"].dtype == torch.float32
    # nonzero once pages were written, finite, small at these magnitudes
    assert 0 < s["dequant_max_abs_err"] < 1.0
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    assert PA.page_bytes(eng.cfg, 8) == 2 * (8 * hkv * hd + hkv * 4)
    assert PA.page_bytes(fp32.cfg, 8) == 2 * 8 * hkv * hd * 4


def test_quantized_attention_bounded_divergence_from_fp32():
    """Paged decode attention over int8 pages against the same pages in
    fp32: the outputs differ (the quantization is real) by at most 10x the
    V half-quantum (the reference's ceiling, tests/test_kv_quant.py)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.layers import dense_init
    cfg = ModelConfig(name="tiny", family="dense", num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=64,
                      dtype="float32")
    hd = cfg.resolved_head_dim()
    g = torch.Generator().manual_seed(0)
    params = {k: dense_init(g, 32, n, torch.float32, "cpu", ())
              for k, n in (("wq", 4 * hd), ("wk", 2 * hd), ("wv", 2 * hd))}
    params["wo"] = dense_init(g, 4 * hd, 32, torch.float32, "cpu", ())
    rng = np.random.default_rng(11)
    NP, ps, B = 9, 8, 2
    kp = torch.from_numpy(rng.normal(size=(NP, ps, 2, hd)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(NP, ps, 2, hd)).astype(np.float32))
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    t = torch.tensor([17, 25], dtype=torch.int32)
    x_t = torch.from_numpy(rng.normal(size=(B, 1, 32)).astype(np.float32))
    (qk, ks), (qv, vs) = Q.quantize_pages(kp), Q.quantize_pages(vp)
    ref = ATT.attn_decode(params, x_t, kp.clone(), vp.clone(), t, cfg=cfg,
                          block_table=bt)
    got = ATT.attn_decode(params, x_t, (qk, ks), (qv, vs), t, cfg=cfg,
                          block_table=bt)
    diff = float((got - ref).abs().max())
    tol = 10 * float(vs.max()) / 2
    assert 0 < diff <= tol, f"divergence {diff} outside (0, {tol}]"


def test_granite_int8_engine_runs_and_repeats():
    """granite's smoke config (token choice, no GO cache) on an int8 pool
    with chunked prefill: every request finishes, the state holds int8
    pages and no GO rows, and a rerun repeats the streams and the drained
    pool's pages and scales bit for bit. (Token choice routes the pool's
    rows together under a capacity, so a solo engine is no oracle here;
    the JAX engine is, above.)"""
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    params = TM.model_init(cfg, torch.Generator().manual_seed(6), "cpu")
    rng = np.random.default_rng(34)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (9, 17, 6)]

    def run():
        eng = _engine(params, cfg, prefill_chunk=8)
        rids = [eng.submit(p, 6, arrival_step=a)
                for p, a in zip(prompts, [0, 0, 2])]
        fin = eng.run()
        return [fin[r].tokens for r in rids], eng

    got, eng = run()
    got2, eng2 = run()
    assert got == got2 and all(len(t) == 6 for t in got)
    assert "go" not in eng.pool.state and "go_scales" not in eng.pool.state
    assert eng.pool.state["v_pages"].dtype == torch.int8
    a = _state_without_null_page(eng.pool.state)
    b = _state_without_null_page(eng2.pool.state)
    assert all(torch.equal(a[k], b[k]) for k in a)
