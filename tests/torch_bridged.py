"""The smoke models both packages run in the port's parity tests, on the
same weights: the JAX model (MoE, where it has one, on backend="pallas", in
interpret mode on the CPU) and the port's, with the JAX weights carried across. Built once
per process and architecture. With them, the parity checks the dense
models' test files share: logits through prefill and decode steps, and
one trace through both engines; for the cross-attention families
(whisper, llama-vision), a random memory a request and one trace with
them through both engines."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jax_config
from repro.launch import serve as JS
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM


@functools.lru_cache(maxsize=None)
def smoke_pair(arch):
    """(JAX config, port config, JAX params, port params on the CPU)."""
    jcfg = jax_config(arch, smoke=True)
    if jcfg.moe is not None:
        jcfg = jcfg.with_overrides(
            moe=dataclasses.replace(jcfg.moe, backend="pallas"))
    p = JM.model_init(jax.random.PRNGKey(0), jcfg)
    # the JAX model caches its expert groups per MoE config on first use;
    # made here, outside any jit, so no traced copy lands in that cache
    # (a later trace of another function would meet it as a leaked tracer)
    JM.expert_groups(jcfg)
    return jcfg, get_config(arch, smoke=True), p, bridged(p)


def bridged(p):
    """JAX params -> the port's on the CPU (the same values)."""
    return bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def with_attn(p, **leaves):
    """A copy of the JAX params `p` whose stacked `layers.attn` also holds
    `leaves` (numpy arrays, e.g. nonzero QKV biases); p is left as is."""
    attn = {**p["layers"]["attn"],
            **{k: jnp.asarray(v) for k, v in leaves.items()}}
    return {**p, "layers": {**p["layers"], "attn": attn}}


_PREFILL = jax.jit(JM.prefill, static_argnames=("cfg", "max_len"))
_STEP = jax.jit(JM.serve_step, static_argnames="cfg")


def logits_match(jcfg, tcfg, p, tp, tokens, steps, max_len, tol,
                 memory=None):
    """Prefill `tokens` [B, T] (numpy int32), then `steps` greedy decode
    steps, in both packages; every step's logits within `tol` (a dict of
    rtol/atol). `memory` [B, M, d] (numpy) is a cross-attention family's
    decode-state memory. Returns the JAX prefill logits (numpy)."""
    if memory is None:
        st, lg = _PREFILL(p, jnp.asarray(tokens), jcfg, max_len=max_len)
        extras = None
    else:
        st, lg = _PREFILL(p, jnp.asarray(tokens), jcfg,
                          {"memory": jnp.asarray(memory)}, max_len=max_len)
        extras = {"memory": torch.from_numpy(memory)}
    tst, tlg = TM.prefill(tp, torch.from_numpy(tokens).long(), tcfg,
                          max_len=max_len, extras=extras)
    first = np.asarray(lg)
    np.testing.assert_allclose(tlg.numpy(), first, **tol)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for _ in range(steps):
        lg, st = _STEP(p, st, tok, jcfg)
        tlg, tst = TM.serve_step(tp, tst, torch.from_numpy(np.array(tok)),
                                 tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **tol)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return first


def engine_streams_match(jcfg, tcfg, p, tp, prompts, gen, **pool):
    """One trace through the JAX engine and the port's (device "cpu"):
    streams and the tick counts equal. Returns the port's result."""
    ref = JS.serve_continuous(p, jcfg, prompts, gen, **pool)
    got = TS.serve_continuous(tp, tcfg, prompts, gen, device="cpu", **pool)
    for rid, toks in ref["tokens"].items():
        np.testing.assert_array_equal(got["tokens"][rid], toks,
                                      err_msg=f"request {rid}")
    s, rs = got["stats"], ref["stats"]
    assert (s["steps"], s["chunk_ticks"], s["peak_active"]) == \
        (rs["steps"], rs["chunk_ticks"], rs["peak_active"])
    return got


def memories(cfg, n, seed):
    """n random cross-attention memories [1, M, d] (numpy fp32, std 1; M
    the config's audio frames or image tokens), one a request. Not zeros:
    zero memory makes the cross layers' K and V zero, so their output
    would be zero and a broken cross path would go unseen."""
    M = cfg.num_audio_frames or cfg.num_image_tokens
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, M, cfg.d_model)).astype(np.float32)
            for _ in range(n)]


def cross_streams(eng, prompts, mems, arrivals, gen, to):
    """Submit each prompt with its own memory (`to` makes the engine's
    array of a numpy one) at its arrival tick, run the engine dry; the
    streams in submission order (numpy int32)."""
    rids = [eng.submit(pr, gen, extras={"memory": to(m)}, arrival_step=a)
            for pr, m, a in zip(prompts, mems, arrivals)]
    fin = eng.run()
    return [np.asarray(fin[r].tokens, np.int32) for r in rids]
