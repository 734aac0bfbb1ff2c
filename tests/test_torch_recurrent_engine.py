"""The continuous-batching engine on the recurrent families: the smoke
xlstm-1.3b (mLSTM and sLSTM states) and zamba2-1.2b (Mamba2 SSM and conv
states beside the dense KV rows of its weight-shared attention block), on
a dense pool, against the JAX package's engine and the port's own static
generate(), on the same weights (JAX's `model_init`, bridged), fp32.

The trace: four staggered requests on two slots, so a request takes a row
its predecessor retired from, and the retired rows keep stepping with t
pinned to 0 in between. Greedy streams must be equal. The slot ops must
write every leaf of their row and no other row's, bit for bit as the
reference's do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import RequestStatus, ServingEngine  # noqa: E402
from torch_bridged import smoke_pair  # noqa: E402

torch.set_float32_matmul_precision("highest")
ARCHS = ["xlstm-1.3b", "zamba2-1.2b"]
LENS = (6, 6, 6, 6)      # one length: one JAX prefill compile an arch
ARRIVALS = (0, 1, 2, 3)
GEN = 4
POOL = dict(num_slots=2, max_tokens=16)


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
            for n in LENS]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(arch, port config, port params, prompts, the JAX engine's result
    on the trace)."""
    jcfg, tcfg, p, tp = smoke_pair(request.param)
    prompts = _prompts(tcfg)
    ref = JS.serve_continuous(p, jcfg, prompts, GEN,
                              arrival_steps=list(ARRIVALS), **POOL)
    return request.param, tcfg, tp, prompts, ref


def _port(tcfg, tp, prompts, **kw):
    return TS.serve_continuous(tp, tcfg, prompts, GEN,
                               arrival_steps=list(ARRIVALS), device="cpu",
                               **dict(POOL, **kw))


def test_streams_equal_jax_engine_and_static(served):
    _, tcfg, tp, prompts, ref = served
    got = _port(tcfg, tp, prompts)
    s, rs = got["stats"], ref["stats"]
    assert (s["steps"], s["peak_active"], s["finished"]) == \
        (rs["steps"], rs["peak_active"], rs["finished"]) == (s["steps"], 2, 4)
    for rid, toks in ref["tokens"].items():
        np.testing.assert_array_equal(got["tokens"][rid], toks,
                                      err_msg=f"request {rid}")
        alone = TS.generate(tp, tcfg, torch.from_numpy(prompts[rid])[None],
                            GEN, device="cpu", max_len=POOL["max_tokens"])
        np.testing.assert_array_equal(alone["tokens"][0].numpy(), toks,
                                      err_msg=f"request {rid} alone")
    # the last two requests took rows the first two retired from
    fin = got["engine"].finished
    assert {fin[2].slot, fin[3].slot} == {fin[0].slot, fin[1].slot}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _random_state(jcfg, batch, rng, per_slot_t):
    """A JAX decode state of `batch` rows with every leaf random."""
    st = JM.init_decode_state(jcfg, batch, POOL["max_tokens"],
                              per_slot_t=per_slot_t)
    return jax.tree.map(
        lambda a: jnp.asarray(rng.integers(1, 9, a.shape), a.dtype)
        if jnp.issubdtype(a.dtype, jnp.integer)
        else jnp.asarray(rng.standard_normal(a.shape), a.dtype), st)


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_ops_write_their_row_only(arch):
    """init_decode_slot and write_decode_slot on a pool state whose every
    leaf is random: the port's result equals the reference's leaf for
    leaf, the row's every leaf changed, and no other row's."""
    jcfg = smoke_pair(arch)[0]
    rng = np.random.default_rng(5)
    pool = _random_state(jcfg, 3, rng, True)
    src = _random_state(jcfg, 1, rng, False)
    ref_reset = JM.init_decode_slot(pool, 1)
    ref_write = JM.write_decode_slot(pool, 1, src)
    reset, write = _torch_tree(pool), _torch_tree(pool)
    TM.init_decode_slot(reset, 1)
    TM.write_decode_slot(write, 1, _torch_tree(src))
    before = _leaves(pool)
    for got, want in ((reset, ref_reset), (write, ref_write)):
        got_l = [a.numpy() for a in jax.tree_util.tree_leaves(
            got, is_leaf=lambda a: isinstance(a, torch.Tensor))]
        want_l = _leaves(want)
        assert len(got_l) == len(want_l) == len(before)
        for g, w, b in zip(got_l, want_l, before):
            np.testing.assert_array_equal(g, w)
            # the batch axis: 0 for t, 2 for the mLSTM leaves, 1 otherwise
            ax = 0 if g.ndim == 1 else next(
                i for i, n in enumerate(g.shape) if n == 3)
            moved = np.moveaxis(g != b, ax, 0).reshape(3, -1)
            assert moved[1].all() and not moved[[0, 2]].any()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw,phrase", [
    (dict(paged=True, page_size=4), "paged pool is attention-family only"),
    (dict(prefill_chunk=8), "chunked prefill is attention-family only"),
    (dict(prefix_share=True), "prefix sharing needs a paged pool"),
    (dict(preemption=True), "preemption needs a paged pool"),
    (dict(expert_aware=True), "expert-aware admission needs a plain-"),
    (dict(kv_quant="int8"), "requires a paged pool"),
    (dict(journal_dir="unused"), "journaling needs a paged pool"),
])
def test_refused_options_raise_as_the_reference(arch, kw, phrase, tmp_path):
    jcfg, tcfg, p, tp = smoke_pair(arch)
    if "journal_dir" in kw:
        kw = dict(journal_dir=str(tmp_path))
    with pytest.raises(ValueError, match=phrase):
        JaxEngine(p, jcfg, **POOL, **kw)
    with pytest.raises(ValueError, match=phrase):
        ServingEngine(tp, tcfg, **POOL, **kw, device="cpu")


@pytest.mark.parametrize("flag", [["--paged"], ["--chunk-prefill", "8"],
                                  ["--prefix-share"], ["--expert-aware"],
                                  ["--paged", "--kv-quant", "int8"]])
def test_cli_refuses_paged_options(flag):
    with pytest.raises(SystemExit):
        TS.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                 *flag])


def test_buckets_are_off(served):
    """prompt_buckets=True is silently off: the prompts prefill at their
    own lengths and the streams are the unbucketed ones."""
    _, tcfg, tp, prompts, ref = served
    got = _port(tcfg, tp, prompts, prompt_buckets=True)
    assert not got["engine"].prompt_buckets
    assert got["stats"]["prefill_lengths"] == sorted(set(LENS))
    for rid, toks in ref["tokens"].items():
        np.testing.assert_array_equal(got["tokens"][rid], toks)


def test_nan_row_retires_failed_cohabitants_unchanged(served):
    """Request 0's row poisoned after its second decode tick (the chaos
    hook: zamba2's attention rows, xlstm's recurrent leaves): it retires
    FAILED with a prefix of its stream; request 1 beside it and request 2,
    which takes the quarantined row, stream as in the clean run."""
    _, tcfg, tp, prompts, ref = served
    eng = ServingEngine(tp, tcfg, **POOL, device="cpu")
    rids = [eng.submit(p, GEN, arrival_step=a)
            for p, a in zip(prompts, ARRIVALS)]
    while eng.step_count < 2:
        eng.step()
    slot = next(s for s, o in enumerate(eng.pool.owner)
                if o is not None and o.request_id == rids[0])
    eng.pool.poison_slot(slot)
    fin = eng.run()
    r0 = fin[rids[0]]
    assert r0.status == RequestStatus.FAILED and len(r0.tokens) < GEN
    np.testing.assert_array_equal(r0.tokens, ref["tokens"][0][:len(r0.tokens)])
    for rid in rids[1:]:
        assert fin[rid].status == RequestStatus.DONE
        np.testing.assert_array_equal(fin[rid].tokens, ref["tokens"][rid])
    assert fin[rids[2]].slot == slot
