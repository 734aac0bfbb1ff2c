"""Paged attention (K3 `paged_attn_decode`, K4 `paged_attn_chunk`) of the
port against the JAX package, on the same numpy inputs. On the CPU the
port's wrappers run their plain versions (the reference's gather
realization), which are held against

  the JAX kernel   (Pallas in interpret mode): atol = rtol = 1e-5, an
                   online softmax page by page against a one-shot softmax;
  the JAX gather   (attention.py `_decode_sdpa` / `sdpa_chunked` over the
                   block table gathered to the dense layout): atol = rtol =
                   1e-6, the same algorithm with sums in another order.

Cases: ragged positions on and around page boundaries, shuffled physical
page ids, null pages behind short rows, GQA ratios 4/2/1 and the window and
softcap cases of tests/test_paged_attn.py. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attn as JPA  # noqa: E402
from repro.models import attention as JATT  # noqa: E402
from repro_torch.kernels import paged_attn as PA  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL_KERNEL = dict(rtol=1e-5, atol=1e-5)
TOL_GATHER = dict(rtol=1e-6, atol=1e-6)

PS, P, HQ, HD = 8, 4, 4, 8          # page size, pages per row, heads, hd
RAGGED_T = np.array([0, 1, 7, 8, 9, 15, 24, 31])
CASES = [(0, 0.0), (5, 0.0), (0, 4.0)]      # (window, softcap)


def _pools(nkv, live_tokens, seed=0):
    """Random pages and block tables with SHUFFLED physical ids: row b owns
    the pages covering its first live_tokens[b] positions; the rest of its
    row is the null page 0, whose contents are random too."""
    rng = np.random.default_rng(seed)
    B = len(live_tokens)
    NP = B * P + 1
    kp = rng.standard_normal((NP, PS, nkv, HD)).astype(np.float32)
    vp = rng.standard_normal((NP, PS, nkv, HD)).astype(np.float32)
    ids = iter(rng.permutation(np.arange(1, NP)))
    bt = np.zeros((B, P), np.int32)
    for b in range(B):
        for j in range(-(-int(live_tokens[b]) // PS)):
            bt[b, j] = next(ids)
    return kp, vp, bt


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("nkv", [1, 2, 4])
@pytest.mark.parametrize("window,softcap", CASES)
def test_decode_plain_matches_jax_kernel_and_gather(nkv, window, softcap):
    rng = np.random.default_rng(1)
    B = len(RAGGED_T)
    q = rng.standard_normal((B, HQ, HD)).astype(np.float32)
    kp, vp, bt = _pools(nkv, RAGGED_T + 1)
    t = RAGGED_T.astype(np.int32)

    got = PA.paged_attn_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(t),
                               window=window, softcap=softcap).numpy()
    kern = JPA.paged_attn_decode(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(t), window=window,
                                 softcap=softcap, interpret=True)
    k_pos = np.arange(P * PS)
    mask = k_pos[None, :] <= t[:, None]
    if window:
        mask &= k_pos[None, :] > t[:, None] - window
    gath = JATT._decode_sdpa(jnp.asarray(q)[:, None],
                             jnp.asarray(kp[bt].reshape(B, P * PS, nkv, HD)),
                             jnp.asarray(vp[bt].reshape(B, P * PS, nkv, HD)),
                             jnp.asarray(mask), softcap)[:, 0]
    assert got.shape == (B, HQ, HD) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(kern), **TOL_KERNEL)
    np.testing.assert_allclose(got, np.asarray(gath), **TOL_GATHER)


@pytest.mark.parametrize("nkv", [1, 2, 4])
@pytest.mark.parametrize("window,softcap", CASES)
def test_chunk_plain_matches_jax_kernel_and_gather(nkv, window, softcap):
    """The last, right-padded chunk of a 21-token prompt: 8 queries at
    positions 16..23, kv_len 21 (queries past it are pads)."""
    rng = np.random.default_rng(2)
    B, Cs, start, kv_len = 3, 8, 16, 21
    q = rng.standard_normal((B, Cs, HQ, HD)).astype(np.float32)
    kp, vp, bt = _pools(nkv, [start + Cs] * B, seed=3)

    got = PA.paged_attn_chunk(_t(q), _t(kp), _t(vp), _t(bt), start, kv_len,
                              window=window, softcap=softcap).numpy()
    kern = JPA.paged_attn_chunk(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(bt), start,
                                kv_len, window=window, softcap=softcap,
                                interpret=True)
    gath = JATT.sdpa_chunked(
        jnp.asarray(q), jnp.asarray(kp[bt].reshape(B, P * PS, nkv, HD)),
        jnp.asarray(vp[bt].reshape(B, P * PS, nkv, HD)),
        jnp.arange(start, start + Cs, dtype=jnp.int32),
        jnp.arange(P * PS, dtype=jnp.int32), jnp.asarray(window, jnp.int32),
        jnp.asarray(kv_len, jnp.int32), causal=True, softcap=softcap)
    assert got.shape == (B, Cs, HQ, HD) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(kern), **TOL_KERNEL)
    np.testing.assert_allclose(got, np.asarray(gath), **TOL_GATHER)


def test_unreachable_pages_never_leak():
    """Poisoning every position a row must not read (the null page, pages
    past the row's allocation, the stale tail of its last page) changes no
    output bit, for decode and for a chunk (tests/test_paged_attn.py's
    adversarial case)."""
    t = np.array([0, 3, 11, 20], np.int32)
    kp, vp, bt = _pools(2, t + 1, seed=5)
    live = np.zeros(kp.shape[:2], bool)
    for b in range(len(t)):
        for pos in range(int(t[b]) + 1):
            live[bt[b, pos // PS], pos % PS] = True
    rng = np.random.default_rng(6)
    q = _t(rng.standard_normal((len(t), HQ, HD)).astype(np.float32))
    qc = _t(rng.standard_normal((len(t), 4, HQ, HD)).astype(np.float32))

    def pools(fill):
        sel = live[:, :, None, None]
        return (_t(np.where(sel, kp, fill).astype(np.float32)),
                _t(np.where(sel, vp, -fill).astype(np.float32)))

    (kc, vc), (kx, vx) = pools(0.0), pools(1e4)
    btt, tt = _t(bt), _t(t)
    assert torch.equal(PA.paged_attn_decode(q, kc, vc, btt, tt),
                       PA.paged_attn_decode(q, kx, vx, btt, tt))
    # chunk: queries at 0..3 against kv_len 1 (row 0's one live key)
    assert torch.equal(PA.paged_attn_chunk(qc, kc, vc, btt, 0, 1),
                       PA.paged_attn_chunk(qc, kx, vx, btt, 0, 1))


def test_int_position_broadcasts_over_rows():
    kp, vp, bt = _pools(2, [10, 10], seed=7)
    q = _t(np.random.default_rng(8).standard_normal((2, HQ, HD))
           .astype(np.float32))
    a = PA.paged_attn_decode(q, _t(kp), _t(vp), _t(bt), 9)
    b = PA.paged_attn_decode(q, _t(kp), _t(vp), _t(bt),
                             torch.tensor([9, 9], dtype=torch.int32))
    assert torch.equal(a, b)


def test_wrappers_raise_on_what_the_kernel_does_not_take():
    kp, vp, bt = (_t(a) for a in _pools(2, [9], seed=9))
    q = torch.zeros(1, HQ, HD)
    qc = torch.zeros(1, 2, HQ, HD)
    t = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of num_kv_heads"):
        PA.paged_attn_decode(torch.zeros(1, 3, HD), kp, vp, bt, t)
    with pytest.raises(TypeError, match="share a dtype"):
        PA.paged_attn_decode(q.double(), kp, vp, bt, t)
    with pytest.raises(TypeError, match="int32"):
        PA.paged_attn_decode(q, kp, vp, bt.long(), t)
    with pytest.raises(TypeError, match="int32"):
        PA.paged_attn_chunk(qc, kp, vp, bt.long(), 0, 2)
    with pytest.raises(ValueError, match="v_pages"):
        PA.paged_attn_chunk(qc, kp, vp[:, :4], bt, 0, 2)
    # the kernel's own limits are checked before a launch; on the CPU they
    # are reachable through the validator alone
    with pytest.raises(ValueError, match="head_dim"):
        PA._check_cuda("paged_attn_decode", torch.zeros(1, HQ, 24),
                       torch.zeros(3, PS, 2, 24))
    with pytest.raises(TypeError, match="no kernel for dtype"):
        PA._check_cuda("paged_attn_decode", q.half(), kp.half())
    with pytest.raises(ValueError, match="query heads per kv head"):
        PA._check_cuda("paged_attn_decode", torch.zeros(1, 64, 16),
                       torch.zeros(3, PS, 2, 16))


@pytest.mark.parametrize("which", ["decode", "chunk"])
def test_int8_scales_wait_for_item_7(which):
    kp, vp, bt = (_t(a) for a in _pools(2, [9], seed=9))
    sc = torch.ones(kp.shape[0], 2)
    with pytest.raises(NotImplementedError, match="item 7"):
        if which == "decode":
            PA.paged_attn_decode(torch.zeros(1, HQ, HD), kp, vp, bt, 8,
                                 k_scales=sc, v_scales=sc)
        else:
            PA.paged_attn_chunk(torch.zeros(1, 2, HQ, HD), kp, vp, bt, 0, 2,
                                k_scales=sc, v_scales=sc)


def test_page_traffic_model_matches_reference():
    class Cfg:
        dtype = "bfloat16"
        num_kv_heads = 32

        def resolved_head_dim(self):
            return 128

    from repro.configs.base import ModelConfig
    jcfg = ModelConfig(name="x", family="dense", num_layers=1, d_model=4096,
                       num_heads=32, num_kv_heads=32, d_ff=0,
                       vocab_size=8, dtype="bfloat16")
    assert PA.page_bytes(Cfg(), 16) == JPA.page_bytes(jcfg, 16) == 262144
    t_host = np.array([448, 0, 15, 16])
    active = np.array([True, False, True, True])
    assert PA.decode_tick_pages(t_host, active, 16, 4, 32) == \
        JPA.decode_tick_pages(t_host, active, 16, 4, 32) == (29 + 1 + 2, 128)
