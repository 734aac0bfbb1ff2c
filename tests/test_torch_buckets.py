"""Bucketed prefill (`prefill(valid_len=)`) and the engine's prompt buckets
(`ServingEngine(prompt_buckets=True)`), on the CPU at the smoke
llama_moe_4_16 (expert choice, GO cache) and granite-moe-3b-a800m (token
choice on the C1 group path), fp32, against the JAX package on the same
weights (its side on backend="pallas", in interpret mode):

  * prefill of right-padded prompts with valid_len: logits (taken at
    valid_len - 1) and the KV of the real rows to 1e-4, t exactly, and the
    GO cache's token ids exactly with no pad position among them; its
    scores to 1e-4 (the packages' gate softmax differs in the last bits);
  * a bucketed engine (prompts of 5, 6, 7, 9, 12 and 13 tokens on 2 slots,
    dense and paged): streams equal to the JAX bucketed engine's, and
    prefill_lengths [8, 16] on both;
  * a recurrent family refuses valid_len, as the reference does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.launch.serve import serve_continuous as jax_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama_moe_4_16", "granite-moe-3b-a800m"]
LENS = [5, 6, 7, 9, 12, 13]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("valid_len", [5, 11, 16])
def test_bucketed_prefill_matches_jax(arch, valid_len):
    jcfg, tcfg, p, tp = smoke_pair(arch)
    S, B, max_len = 16, 2, 24
    rng = np.random.default_rng(valid_len)
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S), dtype=np.int32)
    toks[:, valid_len:] = 0                          # the bucket's pads
    js, jl = JM.prefill(p, jnp.asarray(toks), jcfg, max_len=max_len,
                        valid_len=jnp.asarray(valid_len, jnp.int32))
    ts, tl = TM.prefill(tp, torch.from_numpy(toks).long(), tcfg,
                        max_len=max_len, valid_len=valid_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert ts["t"] == int(js["t"]) == valid_len
    for key in ("k", "v"):
        np.testing.assert_allclose(ts[key][:, :, :valid_len].numpy(),
                                   np.asarray(js[key])[:, :, :valid_len],
                                   **TOL)
    if "go" not in ts:
        assert "go" not in js
        return
    ids = ts["go"].token_ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(js["go"].token_ids))
    assert (ids < valid_len).all() and (ids >= 0).any()
    np.testing.assert_allclose(ts["go"].scores.numpy(),
                               np.asarray(js["go"].scores), **TOL)
    np.testing.assert_allclose(ts["go"].outputs.numpy(),
                               np.asarray(js["go"].outputs), **TOL)


def test_unpadded_prefill_is_the_full_length_bucket():
    """valid_len equal to the prompt's length is the plain prefill, bit
    for bit."""
    _, tcfg, _, tp = smoke_pair("llama_moe_4_16")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(2, 8), dtype=np.int32)).long()
    a, la = TM.prefill(tp, toks, tcfg, max_len=16)
    b, lb = TM.prefill(tp, toks, tcfg, max_len=16, valid_len=8)
    assert torch.equal(la, lb) and a["t"] == b["t"] == 8
    for x, y in zip(a["go"], b["go"]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="valid_len"):
        TM.prefill(tp, toks, tcfg, max_len=16, valid_len=9)


def test_recurrent_prefill_refuses_valid_len():
    cfg = get_config("xlstm-1.3b", smoke=True)
    params = TM.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="attention-family only"):
        TM.prefill(params, torch.zeros((1, 8), dtype=torch.long), cfg,
                   valid_len=5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("paged", [False, True])
def test_bucketed_engine_streams_equal_jax(arch, paged):
    jcfg, tcfg, p, tp = smoke_pair(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n, dtype=np.int32)
               for n in LENS]
    kw = dict(num_slots=2, max_tokens=24, prompt_buckets=True)
    if paged:
        kw.update(paged=True, page_size=4)
    arrivals = [0, 0, 1, 2, 3, 5]
    ref = jax_serve(p, jcfg, prompts, 5, arrival_steps=arrivals, **kw)
    got = TS.serve_continuous(tp, tcfg, prompts, 5, arrival_steps=arrivals,
                              device="cpu", **kw)
    for rid in range(len(LENS)):
        np.testing.assert_array_equal(got["tokens"][rid], ref["tokens"][rid])
    assert got["stats"]["prefill_lengths"] == \
        ref["stats"]["prefill_lengths"] == [8, 16]
    assert got["stats"]["steps"] == ref["stats"]["steps"]


def test_bucketed_admission_writes_only_its_own_pages():
    """A paged pool admits a 5-token prompt padded to its bucket of 8: the
    prefill's rows land in the request's own pages (pads past its prompt,
    which decode overwrites before anything attends to them) and on the
    null page, never in another request's pages."""
    from repro_torch.serving import ServingEngine
    _, tcfg, _, tp = smoke_pair("llama_moe_4_16")
    eng = ServingEngine(tp, tcfg, device="cpu", num_slots=2, max_tokens=16,
                        paged=True, page_size=4, prompt_buckets=True)
    rng = np.random.default_rng(3)
    eng.submit(rng.integers(0, tcfg.vocab_size, 11, dtype=np.int32), 4)
    eng.step()                           # request 0 admitted and decoding
    row0 = eng.pool.block_table[0].copy()
    own0 = row0[row0 > 0]
    before = [eng.pool.state[k][:, own0].clone()
              for k in ("k_pages", "v_pages")]
    eng.submit(rng.integers(0, tcfg.vocab_size, 5, dtype=np.int32), 3)
    eng.step()                           # request 1 admitted at bucket 8
    assert eng.stats()["prefill_lengths"] == [8, 16]
    row1 = eng.pool.block_table[1]
    # pages for the prompt and the first decode write only (5 + 1 tokens)
    assert (row1 > 0).sum() == 2 and not set(row1[row1 > 0]) & set(own0)
    for k, b in zip(("k_pages", "v_pages"), before):
        assert torch.equal(eng.pool.state[k][:, own0], b)
    fin = eng.run()
    assert [len(fin[r].tokens) for r in (0, 1)] == [4, 3]
