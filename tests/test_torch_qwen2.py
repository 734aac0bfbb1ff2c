"""The smoke qwen2-7b (dense SwiGLU MLP, GQA 4/2, QKV bias, fp32) through
the port's prefill, serve_step, generate() and continuous-batching engine,
against the JAX package on the same weights.

The reference initialises the QKV biases to zeros, so a bridged fresh
model would pass even if the port never added them: every parity check
here runs on biases set to seeded nonzero values in the reference's params
before bridging, and a negative control shows that the zero biases give
other logits. qwen2's full width has seven query heads a kv head; the
smoke config has two, so a `num_heads=14, num_kv_heads=2, head_dim=16`
override of both packages holds group 7 (and a head width apart from
d_model / num_heads); K3's and K4's launch arithmetic and emulated bodies
at group 7 are cases of tests/test_torch_paged_attn.py.

Tolerance for logits: atol = rtol = 1e-4 (fp32 on both sides, two
layers). Greedy tokens and engine streams must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import paged_attn as PA  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from torch_bridged import (bridged, engine_streams_match,  # noqa: E402
                           logits_match, smoke_pair, with_attn)

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen2-7b"
B, T, GEN = 2, 12, 6
BIAS_SCALE = 0.5


def _biases(cfg, seed):
    """Seeded nonzero QKV biases [L, width] for the reference's params."""
    rng = np.random.default_rng(seed)
    hd, L = cfg.resolved_head_dim(), cfg.num_layers
    widths = {"bq": cfg.num_heads * hd, "bk": cfg.num_kv_heads * hd,
              "bv": cfg.num_kv_heads * hd}
    return {k: (BIAS_SCALE * rng.standard_normal((L, w))).astype(np.float32)
            for k, w in widths.items()}


@pytest.fixture(scope="module")
def qwen2():
    """(JAX config, port config, JAX params, port params) with nonzero
    biases, and the port's params with the reference's zero biases."""
    jcfg, tcfg, p, tp0 = smoke_pair(ARCH)
    pb = with_attn(p, **_biases(jcfg, 11))
    return jcfg, tcfg, pb, bridged(pb), tp0


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, size=(B, T),
                                             dtype=np.int32)


def test_config_is_a_copy_of_the_reference():
    for smoke in (False, True):
        jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.qkv_bias and tc.moe is None and jc.tie_embeddings
    full = get_config(ARCH)
    assert full.num_heads // full.num_kv_heads == 7
    assert TM.layer_windows(full) == [0] * 28


def test_biases_bridge_with_the_reference_shapes(qwen2):
    """model_init makes bq/bk/bv as zeros in the stacked layer axis, with
    the reference's shapes; the bridge carries nonzero ones unchanged."""
    jcfg, tcfg, pb, tp, tp0 = qwen2
    own = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    for k in ("bq", "bk", "bv"):
        assert tuple(own["layers"]["attn"][k].shape) == \
            tuple(tp0["layers"]["attn"][k].shape)
        assert not own["layers"]["attn"][k].any()
        np.testing.assert_array_equal(tp["layers"]["attn"][k].numpy(),
                                      np.asarray(pb["layers"]["attn"][k]))
        assert tp["layers"]["attn"][k].abs().max() > 0.1
    assert "bq" not in TM.model_init(get_config("starcoder2-3b", smoke=True),
                                     torch.Generator().manual_seed(0),
                                     "cpu")["layers"]["attn"]


def test_prefill_and_decode_logits_match_reference(qwen2, tokens):
    """Nonzero biases: prefill logits, then four decode steps, within 1e-4;
    the port with the reference's zero biases gives other logits."""
    jcfg, tcfg, pb, tp, tp0 = qwen2
    lg = logits_match(jcfg, tcfg, pb, tp, tokens, 4, T + 8, TOL)
    _, lg0 = TM.prefill(tp0, torch.from_numpy(tokens).long(), tcfg,
                        max_len=T + 8)
    assert np.abs(lg0.numpy() - lg).max() > 1e-2


def test_generate_greedy_tokens_equal_reference(qwen2, tokens):
    jcfg, tcfg, pb, tp, _ = qwen2
    rj = JS.generate(pb, jcfg, jnp.asarray(tokens), GEN)
    before = dict(PA.LAUNCHES)
    rt = TS.generate(tp, tcfg, torch.from_numpy(tokens), GEN, device="cpu")
    assert PA.LAUNCHES == before           # CPU: plain versions only
    np.testing.assert_array_equal(rt["tokens"].numpy(),
                                  np.asarray(rj["tokens"]))


def test_engine_streams_equal_jax_engine(qwen2, monkeypatch):
    """Nonzero biases on a staggered paged, chunked trace (a 20-token
    prompt in chunks of 8 beside one-shot ones): streams and tick counts
    equal the JAX engine's."""
    monkeypatch.delenv("REPRO_PREFIX_SHARE", raising=False)
    jcfg, tcfg, pb, tp, _ = qwen2
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n, dtype=np.int32)
               for n in (20, 6, 11)]
    got = engine_streams_match(jcfg, tcfg, pb, tp, prompts, 6,
                               arrival_steps=[0, 1, 3], num_slots=2,
                               max_tokens=32, paged=True, page_size=8,
                               prefill_chunk=8)
    assert got["stats"]["chunk_ticks"] >= 3


def test_group_7_and_head_dim_override_match_reference(tokens):
    """Both packages overridden to 14 query heads on 2 kv heads of 16 (a
    group of 7, qwen2's full-width group; nq * hd = 224 != d_model 64),
    nonzero biases: prefill and three decode steps within 1e-4."""
    over = dict(num_heads=14, num_kv_heads=2, head_dim=16)
    jcfg = jax_config(ARCH, smoke=True).with_overrides(**over)
    tcfg = get_config(ARCH, smoke=True).with_overrides(**over)
    p = with_attn(JM.model_init(jax.random.PRNGKey(3), jcfg),
                  **_biases(jcfg, 12))
    tp = bridged(p)
    assert tuple(tp["layers"]["attn"]["wq"].shape) == (2, 64, 224)
    logits_match(jcfg, tcfg, p, tp, tokens, 3, T + 8, TOL)


def test_cli_smoke_on_cpu(capsys):
    res = TS.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--requests", "3", "--slots", "2", "--prompt", "20",
                   "--gen", "3", "--paged", "--page-size", "8",
                   "--chunk-prefill", "8"])
    assert res["stats"]["finished"] == 3
    assert "qwen2-smoke on cpu" in capsys.readouterr().out
