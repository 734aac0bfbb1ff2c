"""Sampling in the port's engine and static generate() (temperature,
top-p, a per-request seed), on the CPU at the smoke llama_moe_4_16 and
granite-moe-3b-a800m, fp32, with the JAX package's weights carried across.

The JAX package draws with its own PRNG, which torch does not reproduce,
so sampled streams are held against the port itself, and the sampler
against the reference's `_sample_tokens` by distribution:

  * a request at top_p=1e-9 keeps only the argmax: its stream equals the
    JAX greedy generate() stream;
  * a sampled request repeats under its seed; a greedy request pooled
    with sampled ones keeps the JAX greedy stream; a pooled sampled
    request equals the same request alone on a 1-slot engine (paged, with
    chunks); generate(greedy=False) at batch 1 equals the engine's request
    at temperature 1.0, top_p 1.0 and the same seed;
  * on fixed logits over 16 tokens, the tokens JAX's sampler draws over
    2000 keys are the port's nucleus, and the port's frequencies over
    20000 seeded draws lie within 4 sigma of the filtered softmax.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as JS  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.engine import _sample_tokens  # noqa: E402
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
ARCHS = ["llama_moe_4_16", "granite-moe-3b-a800m"]
MAX = 32


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    return smoke_pair(request.param)


@pytest.fixture(scope="module")
def llama():
    cfg = get_config("llama_moe_4_16", smoke=True)
    from repro_torch.models import model as TM
    return cfg, TM.model_init(cfg, torch.Generator().manual_seed(5), "cpu")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in lens]


def _run(params, cfg, reqs, **pool):
    """reqs: (prompt, max_new, submit kwargs) -> the streams in order."""
    eng = ServingEngine(params, cfg, device="cpu", max_tokens=MAX, **pool)
    rids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    fin = eng.run()
    return [fin[r].tokens for r in rids]


def test_top_p_near_zero_is_the_jax_greedy_stream(bridged):
    jcfg, tcfg, p, tp = bridged
    prompt = _prompts(jcfg.vocab_size, [9], 1)[0]
    ref = JS.generate(p, jcfg, jnp.asarray(prompt)[None], 6, max_len=MAX)
    got = _run(tp, tcfg, [(prompt, 6, dict(temperature=0.8, top_p=1e-9,
                                           seed=3))], num_slots=1)
    assert got[0] == np.asarray(ref["tokens"])[0].tolist()


def test_generate_sampled_at_batch_one_equals_the_engine(bridged):
    _, tcfg, _, tp = bridged
    prompt = _prompts(tcfg.vocab_size, [7], 2)[0]
    res = TS.generate(tp, tcfg, torch.from_numpy(prompt)[None], 6,
                      device="cpu", max_len=MAX, greedy=False,
                      generator=torch.Generator().manual_seed(11))
    got = _run(tp, tcfg, [(prompt, 6, dict(temperature=1.0, top_p=1.0,
                                           seed=11))], num_slots=1)
    assert got[0] == res["tokens"][0].tolist()
    with pytest.raises(ValueError, match="generator"):
        TS.generate(tp, tcfg, torch.from_numpy(prompt)[None], 2,
                    device="cpu", greedy=False)


def test_a_sampled_request_repeats_under_its_seed(llama):
    cfg, params = llama
    prompt = _prompts(cfg.vocab_size, [10], 3)[0]
    runs = [_run(params, cfg, [(prompt, 12, dict(temperature=1.5,
                                                 top_p=0.95, seed=s))],
                 num_slots=2)[0] for s in (7, 7, 8)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    greedy = _run(params, cfg, [(prompt, 12, {})], num_slots=1)[0]
    assert runs[0] != greedy
    # seed None draws from the request id
    by_id = _run(params, cfg, [(prompt, 12, dict(temperature=1.5, top_p=0.95,
                                                 request_id=7))],
                 num_slots=1)[0]
    assert by_id == runs[0]


def test_greedy_rows_pooled_with_sampled_keep_the_jax_stream():
    """Expert choice decodes each pool row on its own, so a greedy
    request's stream is the JAX greedy generate()'s whatever its
    cohabitants sample (token choice routes the pool's rows together
    under a capacity: no per-request oracle there, so llama only)."""
    jcfg, tcfg, p, tp = smoke_pair("llama_moe_4_16")
    prompts = _prompts(jcfg.vocab_size, [6, 11, 8, 5], 4)
    reqs = [(q, 7, dict(temperature=0.0 if i % 2 == 0 else 0.9,
                        top_p=0.8, seed=i)) for i, q in enumerate(prompts)]
    got = _run(tp, tcfg, reqs, num_slots=4, paged=True, page_size=4)
    for i in (0, 2):
        ref = JS.generate(p, jcfg, jnp.asarray(prompts[i])[None], 7,
                          max_len=MAX)
        assert got[i] == np.asarray(ref["tokens"])[0].tolist(), i
    assert got[1] != got[3]


def test_pooled_sampled_request_equals_it_alone(llama):
    """Paged with chunked prefill: each request, pooled among greedy and
    sampled ones, streams what it streams alone on a 1-slot engine."""
    cfg, params = llama
    prompts = _prompts(cfg.vocab_size, [5, 20, 8, 11, 3], 5)
    reqs = [(q, 6, dict(temperature=0.0 if i % 2 else 0.8, top_p=0.9,
                        seed=100 + i, arrival_step=i))
            for i, q in enumerate(prompts)]
    pool = dict(paged=True, page_size=4, prefill_chunk=8)
    got = _run(params, cfg, reqs, num_slots=2, **pool)
    for i, r in enumerate(reqs):
        alone = _run(params, cfg, [(r[0], r[1], dict(r[2], arrival_step=0))],
                     num_slots=1, **pool)[0]
        assert got[i] == alone, i


# ------------------------------------------------ the sampler on its own

V = 16
# a tie (1.6, 1.6) and every token at least ~0.6% likely at temperature 1
LOGITS = np.array([2.0, 1.6, 1.6, 1.2, 0.4, 0.1, -0.2, -0.5, -0.8, -1.0,
                   -1.2, 1.9, -1.4, 0.8, 0.0, -1.5], np.float32)


def _filtered(temp, top_p):
    """The reference's nucleus and its renormalised probabilities, in
    numpy (float64): sort descending with ties by index, keep where
    cumsum(p) - p < top_p."""
    lg = LOGITS.astype(np.float64) / max(temp, 1e-6)
    order = np.argsort(-lg, kind="stable")
    p = np.exp(lg[order] - lg[order].max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < top_p
    probs = np.zeros(V)
    probs[order[keep]] = p[keep] / p[keep].sum()
    return probs


@pytest.mark.parametrize("temp,top_p", [(0.8, 0.9), (1.0, 1.0), (2.0, 0.5),
                                        (0.5, 0.75)])
def test_sampler_draws_the_reference_nucleus(temp, top_p):
    probs = _filtered(temp, top_p)
    nucleus = set(np.flatnonzero(probs).tolist())
    n = 2000
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(n))
    ref = JE._sample_tokens(jnp.tile(jnp.asarray(LOGITS), (n, 1)), keys,
                            jnp.full((n,), temp, jnp.float32),
                            jnp.full((n,), top_p, jnp.float32))
    drawn_jax = set(np.asarray(ref).tolist())
    m = 20000
    lg = torch.from_numpy(LOGITS).repeat(m, 1)
    u = torch.rand(m, generator=torch.Generator().manual_seed(0))
    full = lambda x: torch.full((m,), x, dtype=torch.float32)  # noqa: E731
    got = _sample_tokens(lg, u, full(temp), full(top_p)).numpy()
    drawn_port = set(got.tolist())
    # a dense grid of uniforms reaches every kept token: the port's nucleus
    grid = torch.arange(m, dtype=torch.float32) / m
    port_nucleus = set(_sample_tokens(lg, grid, full(temp),
                                      full(top_p)).numpy().tolist())
    assert port_nucleus == nucleus
    assert drawn_jax == nucleus and drawn_port == nucleus
    freq = np.bincount(got, minlength=V) / m
    sigma = np.sqrt(probs * (1 - probs) / m)
    assert (np.abs(freq - probs) <= 4 * sigma + 1e-12).all(), (freq, probs)


def test_sampler_takes_the_argmax_where_temperature_is_zero():
    lg = torch.from_numpy(np.stack([LOGITS, LOGITS[::-1].copy()]))
    tok = _sample_tokens(lg, torch.tensor([0.99, 0.99]),
                         torch.tensor([0.0, -1.0]), torch.tensor([0.5, 1.0]))
    assert tok.tolist() == [0, V - 1]
    # ties break by the lower index, as lax.top_k's order does
    tie = torch.zeros(1, V)
    assert _sample_tokens(tie, torch.tensor([0.0]), torch.tensor([1.0]),
                          torch.tensor([1e-9])).tolist() == [0]
