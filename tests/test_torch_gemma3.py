"""The smoke gemma3-27b (dense SwiGLU MLP, GQA 4/2, three layers: local,
local, global with a 16-token window; fp32) through the port's prefill,
serve_step, generate() and continuous-batching engine, against the JAX
package on the same weights.

The prompts are 28 to 40 tokens long, so the window binds on the local
layers and not on the global one: all-local and all-global windows each
give other logits (negative controls). The smoke config's head_dim equals
d_model / num_heads (16); a `head_dim=32` override of both packages (64 /
4 = 16 != 32) shows that every projection and page is sized by
cfg.resolved_head_dim(). The dense prefix extension runs port against
port (its streams against the run without sharing), over shared pages
that the local layers' window leaves behind.

Tolerance for logits: atol = rtol = 1e-4 (fp32 on both sides, three
layers). Greedy tokens and engine streams must be equal; port against
port, the engine streams what static generate() streams, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from torch_bridged import (bridged, engine_streams_match,  # noqa: E402
                           logits_match, smoke_pair)

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "gemma3-27b"
B, T = 2, 28


@pytest.fixture(scope="module")
def gemma3():
    return smoke_pair(ARCH)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, size=(B, T),
                                             dtype=np.int32)


def test_config_is_a_copy_of_the_reference():
    for smoke in (False, True):
        jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert TM.layer_windows(tc) == JM.layer_windows(jc).tolist()
        assert tc.moe is None and not tc.qkv_bias and jc.tie_embeddings
    full = get_config(ARCH)
    w = TM.layer_windows(full)
    assert w == ([1024] * 5 + [0]) * 10 + [1024] * 2
    assert (w.count(1024), w.count(0)) == (52, 10)
    assert full.resolved_head_dim() == 128 != full.d_model // full.num_heads
    assert TM.layer_windows(get_config(ARCH, smoke=True)) == [16, 16, 0]
    # no ratio: every layer takes sliding_window (starcoder2's rule)
    assert TM.layer_windows(get_config("starcoder2-3b")) == [4096] * 30


def test_prefill_and_decode_logits_match_reference(gemma3, tokens):
    """28-token prompts (the window of 16 binds on the local layers):
    prefill logits and four decode steps within 1e-4. All-local (no
    ratio) and all-global (no window) layers give other logits."""
    jcfg, tcfg, p, tp = gemma3
    lg = logits_match(jcfg, tcfg, p, tp, tokens, 4, T + 8, TOL)
    x = torch.from_numpy(tokens).long()
    for over in (dict(local_global_ratio=0), dict(sliding_window=0)):
        _, other = TM.prefill(tp, x, tcfg.with_overrides(**over),
                              max_len=T + 8)
        assert np.abs(other.numpy() - lg).max() > 1e-2, over


def test_head_dim_apart_from_width_matches_reference(tokens):
    """head_dim 32 on d_model 64 and 4 heads (d_model // num_heads = 16):
    the projections are [64, 128] and [128, 64]; prefill and three decode
    steps within 1e-4 of the JAX package."""
    jcfg = jax_config(ARCH, smoke=True).with_overrides(head_dim=32)
    tcfg = get_config(ARCH, smoke=True).with_overrides(head_dim=32)
    p = JM.model_init(jax.random.PRNGKey(5), jcfg)
    tp = bridged(p)
    own = TM.model_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    for k in ("wq", "wk", "wv", "wo"):
        assert own["layers"]["attn"][k].shape == tp["layers"]["attn"][k].shape
    assert tuple(tp["layers"]["attn"]["wq"].shape) == (3, 64, 128)
    logits_match(jcfg, tcfg, p, tp, tokens, 3, T + 8, TOL)
    state = TM.init_decode_state(tcfg, 2, 32, "cpu", per_slot_t=True,
                                 paged=(9, 8))
    assert tuple(state["k_pages"].shape) == (3, 9, 8, 2, 32)


# the staggered paged, chunked trace: the 40-token prompt prefills in
# chunks at 0, 16 and 32 (the window binds on the local layers of the
# last two), the others one-shot or in two chunks
LENS = [40, 9, 30]
ARRIVALS = [0, 1, 3]


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, size=n, dtype=np.int32) for n in LENS]


def test_engine_streams_equal_jax_engine(gemma3, prompts, monkeypatch):
    monkeypatch.delenv("REPRO_PREFIX_SHARE", raising=False)
    jcfg, tcfg, p, tp = gemma3
    got = engine_streams_match(jcfg, tcfg, p, tp, prompts, 7,
                               arrival_steps=ARRIVALS, num_slots=2,
                               max_tokens=48, paged=True, page_size=8,
                               prefill_chunk=16)
    assert got["stats"]["chunk_ticks"] == 3 + 2
    assert got["stats"]["pages_in_use"] == 0


def test_engine_bit_identical_to_static_generate(gemma3, prompts):
    """Port against port: without chunking each request streams what it
    streams alone through generate() at the pool's cache capacity, the
    40-token one past the local window."""
    _, tcfg, _, tp = gemma3
    gens = [7, 5, 6]
    eng = ServingEngine(tp, tcfg, device="cpu", num_slots=2, max_tokens=48,
                        paged=True, page_size=8)
    rids = [eng.submit(pr, g, arrival_step=a)
            for pr, g, a in zip(prompts, gens, ARRIVALS)]
    fin = eng.run()
    for pr, g, rid in zip(prompts, gens, rids):
        ref = TS.generate(tp, tcfg, torch.from_numpy(pr)[None], g,
                          device="cpu", max_len=48)
        assert fin[rid].tokens == ref["tokens"][0].tolist()


@pytest.mark.parametrize("chunk", [0, 16])
def test_dense_prefix_extension_across_local_and_global_layers(gemma3,
                                                               chunk):
    """A 32-token shared prefix (four pages of 8) and 8-token tails: the
    local layers' window of 16 leaves the first two shared pages behind
    the tails' queries and every decode step, the global layer reads all
    four. Three consumers extend the donor's chain (one-shot donor, or
    chunks of 16 with a deposit); streams equal the run without
    sharing."""
    _, tcfg, _, tp = gemma3
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, 256, size=32, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 256, size=8,
                                                    dtype=np.int32)])
               for _ in range(4)]

    def serve(share):
        eng = ServingEngine(tp, tcfg, device="cpu", num_slots=2,
                            max_tokens=64, paged=True, page_size=8,
                            prefill_chunk=chunk, prefix_share=share)
        eng.audit_every_tick = True
        rids = [eng.submit(x, 12, arrival_step=a)
                for x, a in zip(prompts, [0, 4, 5, 9])]
        fin = eng.run()
        return eng.stats(), [fin[r].tokens for r in rids]

    s, got = serve(True)
    assert (s["prefix_hits"], s["prefill_tokens_skipped"],
            s["pages_shared"]) == (3, 3 * 32, 3 * 4)
    assert s["statuses"] == {"DONE": 4} and s["pages_in_use"] == 0
    assert got == serve(False)[1]


def test_cli_smoke_on_cpu(capsys):
    res = TS.main(["--arch", ARCH, "--smoke", "--static", "--device", "cpu",
                   "--batch", "2", "--prompt", "20", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    res = TS.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--requests", "3", "--slots", "2", "--prompt", "20",
                   "--gen", "3", "--paged", "--page-size", "8",
                   "--chunk-prefill", "8", "--kv-quant", "int8"])
    assert res["stats"]["finished"] == 3
    assert "gemma3-smoke on cpu" in capsys.readouterr().out
