"""The smoke granite-8b (dense SwiGLU MLP, GQA 4/2, global attention on
every layer, fp32) through the port's generate() and continuous-batching
engine, against the JAX package on the same weights: greedy tokens and
engine streams (paged pool, chunked prefill) must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from torch_bridged import engine_streams_match, smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
ARCH = "granite-8b"


@pytest.fixture(scope="module")
def granite8b():
    return smoke_pair(ARCH)


def test_config_is_a_copy_of_the_reference():
    for smoke in (False, True):
        jc, tc = jax_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.moe is None and not tc.qkv_bias and jc.tie_embeddings
        assert (tc.sliding_window, tc.local_global_ratio,
                tc.logit_softcap) == (0, 0, 0.0)
    assert TM.layer_windows(get_config(ARCH)) == [0] * 36


def test_generate_greedy_tokens_equal_reference(granite8b):
    jcfg, tcfg, p, tp = granite8b
    tokens = np.random.default_rng(1).integers(0, 256, size=(2, 16),
                                               dtype=np.int32)
    rj = JS.generate(p, jcfg, jnp.asarray(tokens), 8)
    rt = TS.generate(tp, tcfg, torch.from_numpy(tokens), 8, device="cpu")
    np.testing.assert_array_equal(rt["tokens"].numpy(),
                                  np.asarray(rj["tokens"]))


def test_engine_streams_equal_jax_engine(granite8b, monkeypatch):
    monkeypatch.delenv("REPRO_PREFIX_SHARE", raising=False)
    jcfg, tcfg, p, tp = granite8b
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n, dtype=np.int32)
               for n in (30, 9, 17)]
    got = engine_streams_match(jcfg, tcfg, p, tp, prompts, 7,
                               arrival_steps=[0, 1, 3], num_slots=2,
                               max_tokens=48, paged=True, page_size=8,
                               prefill_chunk=16)
    assert got["stats"]["chunk_ticks"] == 2 + 2


def test_cli_smoke_on_cpu(capsys):
    res = TS.main(["--arch", ARCH, "--smoke", "--static", "--device", "cpu",
                   "--batch", "2", "--prompt", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    res = TS.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--requests", "3", "--slots", "2", "--prompt", "20",
                   "--gen", "3", "--paged", "--page-size", "8",
                   "--chunk-prefill", "8"])
    assert res["stats"]["finished"] == 3
    assert "granite-smoke on cpu" in capsys.readouterr().out
