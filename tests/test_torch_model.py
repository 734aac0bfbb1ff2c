"""The whole slice: the smoke llama_moe_4_16 through the port's prefill,
serve_step and generate() against the JAX package on the same weights,
carried across by `bridge.params_from_numpy`. The JAX side runs
backend="pallas" (its grouped-GEMM decomposition, in interpret mode).

Tolerance for logits: atol = rtol = 1e-4 (fp32 on both sides, sums taken
in another order). Greedy tokens must be equal.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import attention as JATT  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
B, T, GEN = 2, 16, 8


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = jax_config("llama_moe_4_16", smoke=True)
    jcfg = jcfg.with_overrides(
        moe=dataclasses.replace(jcfg.moe, backend="pallas"))
    tcfg = get_config("llama_moe_4_16", smoke=True)
    p = JM.model_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, T), dtype=np.int32)
    return jcfg, tcfg, p, tp, prompts


def test_bridge_keeps_nesting_and_values(slice_setup):
    _, _, p, tp, _ = slice_setup
    flat_j = jax.tree_util.tree_flatten_with_path(p)[0]
    assert len(flat_j) == len(jax.tree.leaves(tp))
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_model_init_matches_reference_tree(slice_setup):
    """Same nesting, shapes and dtypes; the distributions' scales agree."""
    _, tcfg, p, tp, _ = slice_setup
    mine = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p)
    got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), mine)
    assert got == ref
    wq = mine["layers"]["attn"]["wq"].numpy()
    assert abs(wq.std() * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(mine["embed"].numpy().std() / 0.02 - 1) < 0.05


def test_prefill_and_decode_logits_match_reference(slice_setup):
    jcfg, tcfg, p, tp, prompts = slice_setup
    st, lg = JM.prefill(p, jnp.asarray(prompts), jcfg, max_len=T + 8)
    tst, tlg = TM.prefill(tp, torch.from_numpy(prompts).long(), tcfg,
                          max_len=T + 8)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    np.testing.assert_allclose(tst["k"].numpy(), np.asarray(st["k"]), **TOL)
    np.testing.assert_array_equal(tst["go"].token_ids.numpy(),
                                  np.asarray(st["go"].token_ids))
    np.testing.assert_allclose(tst["go"].outputs.numpy(),
                               np.asarray(st["go"].outputs), **TOL)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for _ in range(6):
        lg, st = JM.serve_step(p, st, tok, jcfg)
        tlg, tst = TM.serve_step(tp, tst, torch.from_numpy(np.array(tok)),
                                 tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    np.testing.assert_array_equal(tst["go"].token_ids.numpy(),
                                  np.asarray(st["go"].token_ids))
    np.testing.assert_allclose(tst["go"].scores.numpy(),
                               np.asarray(st["go"].scores), **TOL)
    assert tst["t"] == int(st["t"]) == T + 6


def test_generate_greedy_tokens_equal_reference(slice_setup):
    jcfg, tcfg, p, tp, prompts = slice_setup
    rj = JS.generate(p, jcfg, jnp.asarray(prompts), GEN)
    before = dict(G.LAUNCHES)
    rt = TS.generate(tp, tcfg, torch.from_numpy(prompts), GEN, device="cpu")
    assert G.LAUNCHES == before              # CPU: plain versions only
    np.testing.assert_array_equal(rt["tokens"].numpy(),
                                  np.asarray(rj["tokens"]))
    assert rt["logits"].shape == (GEN, B, tcfg.vocab_size)
    np.testing.assert_array_equal(rt["logits"].argmax(-1).T.numpy(),
                                  rt["tokens"].numpy())


def test_generate_without_a_device_never_runs_on_the_cpu(slice_setup,
                                                          monkeypatch):
    _, tcfg, _, tp, prompts = slice_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        TS.generate(tp, tcfg, torch.from_numpy(prompts), 2)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        TS.main(["--arch", "llama_moe_4_16", "--smoke", "--static"])


def test_cli_static_smoke_on_cpu(capsys):
    res = TS.main(["--arch", "llama_moe_4_16", "--smoke", "--static",
                   "--device", "cpu", "--batch", "2", "--prompt", "8",
                   "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["logits"]).all()
    assert "llama-moe-smoke on cpu" in capsys.readouterr().out


def test_cli_continuous_batching_is_slice_two(capsys):
    """Continuous batching (slice 2) is the CLI's default mode: a paged
    pool with chunked prefill serves every request to its length."""
    res = TS.main(["--arch", "llama_moe_4_16", "--smoke", "--device", "cpu",
                   "--requests", "3", "--slots", "2", "--prompt", "10",
                   "--gen", "3", "--paged", "--page-size", "4",
                   "--chunk-prefill", "8"])
    s = res["stats"]
    assert s["finished"] == 3 and s["paged"] and s["chunk_ticks"] == 3 * 2
    assert all(len(t) == 3 for t in res["tokens"].values())
    assert s["pages_in_use"] == 0
    assert "served 3 requests" in capsys.readouterr().out


def test_xla_backend_is_not_ported(slice_setup):
    _, tcfg, _, tp, prompts = slice_setup
    cfg = tcfg.with_overrides(
        moe=dataclasses.replace(tcfg.moe, backend="xla"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.prefill(tp, torch.from_numpy(prompts).long(), cfg)


# ------------------------------------------- chip_smoke's logit tolerance

def _smoke_tolerance() -> float:
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SMOKE_LOGIT_TOL


def _drop_last_valid_tile(tv):
    tv = tv.clone()
    nz = tv.nonzero()
    if len(nz):
        tv[nz[-1]] = 0
    return tv


_SW, _SC = G.gmm_swiglu_plain, G.gmm_scaled_plain
FAULTS = {
    # K2 forgets the combine weights
    "k2_no_row_scale": ("gmm_scaled_plain", lambda x, w, te, tv, s, bn: _SC(
        x, w, te, tv, torch.ones_like(s), bn)),
    # K2 applies the row scale rounded to bf16
    "k2_row_scale_bf16": ("gmm_scaled_plain", lambda x, w, te, tv, s, bn: _SC(
        x, w, te, tv, s.to(torch.bfloat16).float(), bn)),
    # K1 masks the ragged F edge one column short
    "k1_last_column_lost": ("gmm_swiglu_plain",
                            lambda x, wg, wi, te, tv, bn: torch.cat(
                                [_SW(x, wg, wi, te, tv, bn)[:, :-1],
                                 x.new_zeros((x.shape[0], 1))], dim=1)),
    # K1 skips the last valid tile
    "k1_valid_tile_skipped": ("gmm_swiglu_plain",
                              lambda x, wg, wi, te, tv, bn: _SW(
                                  x, wg, wi, te, _drop_last_valid_tile(tv),
                                  bn)),
}


@pytest.fixture(scope="module")
def smoke_run():
    """chip_smoke.py's smoke phase on the CPU: its weights, prompts and
    length, through the plain versions."""
    cfg = get_config("llama_moe_4_16", smoke=True)
    params = TM.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (4, 32),
                            generator=torch.Generator().manual_seed(1))
    return cfg, params, prompts, TS.generate(params, cfg, prompts, 8,
                                             device="cpu")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_smoke_logit_tolerance_catches_a_faulty_kernel(smoke_run, fault,
                                                       monkeypatch):
    """chip_smoke.py holds the card's smoke logits to SMOKE_LOGIT_TOL of the
    CPU's. Each fault, injected into a plain version, moves the logits by
    far more, the subtlest (a bf16 row scale) by about 9e-4."""
    cfg, params, prompts, sound = smoke_run
    attr, faulty = FAULTS[fault]
    monkeypatch.setattr(G, attr, faulty)
    bad = TS.generate(params, cfg, prompts, 8, device="cpu")
    gap = (bad["logits"] - sound["logits"]).abs().max().item()
    print(f"{fault}: smoke logits move by {gap:.3e}")
    assert gap > 10 * _smoke_tolerance()


# ----------------------------------------------------------- layer pieces

def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.random(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm({"scale": torch.from_numpy(scale)},
                   torch.from_numpy(x)).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(5, dtype=np.int32) * 37
    cj, sj = JL.rope_angles(jnp.asarray(pos), 16, 10000.0)
    ct, stn = TL.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
    np.testing.assert_allclose(stn.numpy(), np.asarray(sj), atol=2e-6)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), ct[:, None], stn[:, None]).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), cj[:, None], sj[:, None])),
        atol=1e-5)


@pytest.mark.parametrize("window,nkv", [(0, 4), (5, 2)])
def test_attention_forward_and_decode_match_reference(slice_setup, window,
                                                      nkv):
    """GQA (nkv < heads), the causal mask and a sliding window."""
    jcfg, tcfg, _, _, _ = slice_setup
    cfg = tcfg.with_overrides(num_kv_heads=nkv)
    jcfg = jcfg.with_overrides(num_kv_heads=nkv)
    rng = np.random.default_rng(window)
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    w = {"wq": rng.standard_normal((d, 4 * hd)), "wk":
         rng.standard_normal((d, nkv * hd)), "wv":
         rng.standard_normal((d, nkv * hd)), "wo":
         rng.standard_normal((4 * hd, d))}
    w = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in w.items()}
    wj = {k: jnp.asarray(v) for k, v in w.items()}
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    oj, kj, vj = JATT.attn_forward(wj, jnp.asarray(x), cfg=jcfg,
                                   positions=jnp.asarray(pos),
                                   window=window, return_kv=True)
    ot, kt, vt = ATT.attn_forward(wt, torch.from_numpy(x), cfg=cfg,
                                  positions=torch.from_numpy(pos),
                                  window=window, return_kv=True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    # decode at t = 12 on a cache holding the 12 prefix positions
    ck = np.zeros((2, 16, nkv, hd), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :12], cv[:, :12] = np.asarray(kj), np.asarray(vj)
    xt = rng.standard_normal((2, 1, d)).astype(np.float32)
    dj, ckj, _ = JATT.attn_decode(wj, jnp.asarray(xt), jnp.asarray(ck),
                                  jnp.asarray(cv), 12, cfg=jcfg,
                                  window=window)
    ckt, cvt = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    dt = ATT.attn_decode(wt, torch.from_numpy(xt), ckt, cvt, 12, cfg=cfg,
                         window=window)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    np.testing.assert_allclose(ckt.numpy(), np.asarray(ckj), **TOL)
