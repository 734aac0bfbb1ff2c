"""The attention logit softcap (scores c * tanh(s / c)) on every served
call site of the port, against the JAX package with the same
`logit_softcap`. No reference config sets it, so both packages take it as
an override of the smoke gemma3-27b (local and global layers, window 16):

  attn_forward's sdpa_chunked    prefill (static generate()'s first pass)
  _decode_sdpa                   serve_step on a dense cache
  K3 (paged_attn_decode)         the engine's decode tick on a paged pool
  K4 (paged_attn_chunk)          the engine's chunk tick on a paged pool
  attn_chunk's sdpa_chunked      prefill_chunk on a dense cache

K3/K4 run their plain versions on the CPU. The cap of 0.5 binds on the
smoke model's scores (without it the logits move). Tolerance for logits:
atol = rtol = 1e-4 (fp32 on both sides); greedy streams equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from torch_bridged import (engine_streams_match, logits_match,  # noqa: E402
                           smoke_pair)

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
CAP = 0.5


@pytest.fixture(scope="module")
def capped():
    jcfg, tcfg, p, tp = smoke_pair("gemma3-27b")
    return (jcfg.with_overrides(logit_softcap=CAP),
            tcfg.with_overrides(logit_softcap=CAP), p, tp)


def test_prefill_and_dense_decode_match_reference(capped):
    """attn_forward and _decode_sdpa: 24-token prompts, four decode steps,
    within 1e-4; the port without the cap gives other logits."""
    jcfg, tcfg, p, tp = capped
    tokens = np.random.default_rng(1).integers(0, 256, size=(2, 24),
                                               dtype=np.int32)
    lg = logits_match(jcfg, tcfg, p, tp, tokens, 4, 32, TOL)
    _, free = TM.prefill(tp, torch.from_numpy(tokens).long(),
                         tcfg.with_overrides(logit_softcap=0.0), max_len=32)
    assert np.abs(free.numpy() - lg).max() > 1e-2


def test_dense_chunk_matches_reference(capped):
    """attn_chunk's dense branch: a 24-token prompt as chunks of 8 into a
    dense cache, each chunk's last logits within 1e-4."""
    jcfg, tcfg, p, tp = capped
    tokens = np.random.default_rng(2).integers(0, 256, size=(1, 24),
                                               dtype=np.int32)
    step = jax.jit(JM.prefill_chunk, static_argnames="cfg")
    st = JM.init_decode_state(jcfg, 1, 32)
    tst = TM.init_decode_state(tcfg, 1, 32, "cpu")
    for start in range(0, 24, 8):
        chunk = tokens[:, start:start + 8]
        st, lg = step(p, st, jnp.asarray(chunk), jcfg, start)
        tst, tlg = TM.prefill_chunk(tp, tst, torch.from_numpy(chunk).long(),
                                    tcfg, start)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)


def test_paged_engine_streams_equal_jax_engine(capped, monkeypatch):
    """K3's and K4's call sites: a staggered paged trace with chunks of 8
    (a 26-token prompt in four chunks), streams equal the JAX engine's."""
    monkeypatch.delenv("REPRO_PREFIX_SHARE", raising=False)
    jcfg, tcfg, p, tp = capped
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, size=n, dtype=np.int32)
               for n in (26, 7, 12)]
    got = engine_streams_match(jcfg, tcfg, p, tp, prompts, 6,
                               arrival_steps=[0, 1, 2], num_slots=2,
                               max_tokens=40, paged=True, page_size=8,
                               prefill_chunk=8)
    assert got["stats"]["chunk_ticks"] >= 4
