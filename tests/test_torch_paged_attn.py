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
softcap cases of tests/test_paged_attn.py; the same on int8 pages with
k_scales/v_scales (the JAX kernel's quantized operand, pages quantized by
repro.core.quant), and K3's and K4's CUDA algorithms on int8 pages
emulated on the CPU against the JAX kernel. The CUDA kernels themselves are
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


# ------------------------------- int8 dequantization of the CUDA bodies

def _prmt(x, y, sel: int):
    """PRMT (CUDA's __byte_perm) on int64 tensors of 32-bit words: byte n of
    the result is byte (sel >> 4n) & 7 of the eight bytes y:x."""
    both = (y << 32) | x
    out = torch.zeros_like(x)
    for n in range(4):
        out |= ((both >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
    return out


def _f32(bits):
    """int64 tensor of 32-bit patterns -> float32 of those bits."""
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits) \
        .to(torch.int32).view(torch.float32)


def _i8_f32(x8, word_bytes: int = 4):
    """csrc/paged_attn.cu `i8_flip` and `i8_f32` bit for bit: the int8 values
    x8 [..., n] packed little-endian `word_bytes` to a 32-bit word (as
    load_f32 loads them: 16- and 4-byte loads fill words, 2- and 1-byte
    loads their low bytes), the sign bits flipped (x ^ 0x80), each byte
    moved into the low mantissa of 2^23 by PRMT 0x754k, and 2^23 + 128
    subtracted in fp32."""
    b = (x8.to(torch.int64) & 0xFF).reshape(*x8.shape[:-1], -1, word_bytes)
    w = sum(b[..., k] << (8 * k) for k in range(word_bytes)) ^ 0x80808080
    f = torch.stack([_f32(_prmt(w, torch.full_like(w, 0x4B000000),
                                0x7540 | k)) for k in range(word_bytes)], -1)
    return (f - 8388736.0).reshape(x8.shape)


def _widen16(x8):
    """csrc `widen16`: int8 [..., n] (n even) -> bf16, each pair of
    `_i8_f32` floats packed by `bf16_pair_exact` (PRMT 0x7632: the high
    halves, lo first)."""
    bits = _i8_f32(x8).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = bits.reshape(*x8.shape[:-1], -1, 2)
    w = _prmt(bits[..., 0], bits[..., 1], 0x7632)
    half = torch.stack([w & 0xFFFF, w >> 16], -1).reshape(x8.shape)
    return torch.where(half >= 2 ** 15, half - 2 ** 16, half) \
        .to(torch.int16).view(torch.bfloat16)


def test_prmt_emulation_follows_byte_perm():
    """CUDA's __byte_perm examples: selector 0x3210 returns x, 0x7654 y,
    and 0x7540 takes x's byte 0 under y's bytes 0, 1 and 3."""
    x, y = torch.tensor([0x33221100]), torch.tensor([0x77665544])
    assert _prmt(x, y, 0x3210).item() == 0x33221100
    assert _prmt(x, y, 0x7654).item() == 0x77665544
    assert _prmt(x, y, 0x7540).item() == 0x77554400


@pytest.mark.parametrize("word_bytes", [1, 2, 4])
def test_int8_dequant_is_exact_for_every_byte(word_bytes):
    """The kernels' conversion-free int8 -> fp32 (LOP3, PRMT, FADD) gives
    float(x) bit for bit for all 256 bytes, from every load width of
    load_f32."""
    x8 = torch.arange(-128, 128, dtype=torch.int64).to(torch.int8)
    got = _i8_f32(x8, word_bytes)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32),
                       x8.float().view(torch.int32))


def test_int8_widen_to_bf16_is_exact_for_every_byte():
    """widen16's bf16 pairs hold torch's int8 -> bf16 cast bit for bit for
    all 256 bytes, in both halves of a pair (bytes in both orders)."""
    x8 = torch.arange(-128, 128, dtype=torch.int64).to(torch.int8)
    for x in (x8, x8.flip(0), x8.reshape(2, 128).T.reshape(-1)):
        assert torch.equal(_widen16(x).view(torch.int16),
                           x.to(torch.bfloat16).view(torch.int16))


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
    """The int8 operand is ported; what the wrappers refuse of it: scales
    beside full-precision pages, one scale tensor without the other (the
    reference's ValueError), scales of another dtype or shape."""
    kp, vp, bt = (_t(a) for a in _pools(2, [9], seed=9))
    k8, v8 = kp.to(torch.int8), vp.to(torch.int8)
    sc = torch.ones(kp.shape[0], 2)

    def call(k, v, **kw):
        if which == "decode":
            return PA.paged_attn_decode(torch.zeros(1, HQ, HD), k, v, bt, 8,
                                        **kw)
        return PA.paged_attn_chunk(torch.zeros(1, 2, HQ, HD), k, v, bt, 0, 2,
                                   **kw)
    with pytest.raises(TypeError, match="int8 pool"):
        call(kp, vp, k_scales=sc, v_scales=sc)
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        call(k8, v8, k_scales=sc)
    with pytest.raises(TypeError, match="float32"):
        call(k8, v8, k_scales=sc.double(), v_scales=sc)
    with pytest.raises(TypeError, match="float32"):
        call(k8, v8, k_scales=sc, v_scales=sc[:, :1])
    with pytest.raises(TypeError, match="share a dtype"):
        call(k8, v8)
    assert call(k8, v8, k_scales=sc, v_scales=sc).dtype == torch.float32


# ---------------------------------------------------------- int8 pages

def _int8_pools(nkv, live_tokens, seed):
    """_pools, each (page, kv head) scaled by its own factor in [0.2, 1]
    (the values stay within the fp32 cases' magnitudes), quantized by the
    reference (repro.core.quant): int8 pages and f32 [NP, Hkv] scales,
    numpy."""
    from repro.core import quant as JQ
    kp, vp, bt = _pools(nkv, live_tokens, seed=seed)
    scale = np.random.default_rng(seed).uniform(
        0.2, 1.0, size=(kp.shape[0], 1, nkv, 1)).astype(np.float32)
    (k8, ks), (v8, vs) = (JQ.quantize_pages(jnp.asarray(a * scale))
                          for a in (kp, vp))
    return (*(np.asarray(a) for a in (k8, v8, ks, vs)), bt)


def _deq(pages, scales, bt):
    B = bt.shape[0]
    return (pages[bt].astype(np.float32) * scales[bt][:, :, None, :, None]
            ).reshape(B, P * PS, *pages.shape[2:])


@pytest.mark.parametrize("nkv", [1, 2, 4])
@pytest.mark.parametrize("window,softcap", CASES)
def test_decode_plain_int8_matches_jax_kernel_and_gather(nkv, window,
                                                         softcap):
    """K3's plain version on int8 pages (gather, then dequantize) against
    the JAX kernel's int8 operand and the JAX gather of the dequantized
    pages, at the fp32 tolerances above."""
    rng = np.random.default_rng(11)
    B = len(RAGGED_T)
    q = rng.standard_normal((B, HQ, HD)).astype(np.float32)
    k8, v8, ks, vs, bt = _int8_pools(nkv, RAGGED_T + 1, seed=12)
    t = RAGGED_T.astype(np.int32)
    got = PA.paged_attn_decode(_t(q), _t(k8), _t(v8), _t(bt), _t(t),
                               window=window, softcap=softcap,
                               k_scales=_t(ks), v_scales=_t(vs)).numpy()
    kern = JPA.paged_attn_decode(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(bt),
        jnp.asarray(t), window=window, softcap=softcap,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True)
    k_pos = np.arange(P * PS)
    mask = k_pos[None, :] <= t[:, None]
    if window:
        mask &= k_pos[None, :] > t[:, None] - window
    gath = JATT._decode_sdpa(jnp.asarray(q)[:, None],
                             jnp.asarray(_deq(k8, ks, bt)),
                             jnp.asarray(_deq(v8, vs, bt)),
                             jnp.asarray(mask), softcap)[:, 0]
    np.testing.assert_allclose(got, np.asarray(kern), **TOL_KERNEL)
    np.testing.assert_allclose(got, np.asarray(gath), **TOL_GATHER)


@pytest.mark.parametrize("nkv", [1, 2, 4])
@pytest.mark.parametrize("window,softcap", CASES)
def test_chunk_plain_int8_matches_jax_kernel_and_gather(nkv, window,
                                                        softcap):
    """K4's plain version on int8 pages, the right-padded chunk of
    test_chunk_plain_matches_jax_kernel_and_gather."""
    rng = np.random.default_rng(13)
    B, Cs, start, kv_len = 3, 8, 16, 21
    q = rng.standard_normal((B, Cs, HQ, HD)).astype(np.float32)
    k8, v8, ks, vs, bt = _int8_pools(nkv, [start + Cs] * B, seed=14)
    got = PA.paged_attn_chunk(_t(q), _t(k8), _t(v8), _t(bt), start, kv_len,
                              window=window, softcap=softcap,
                              k_scales=_t(ks), v_scales=_t(vs)).numpy()
    kern = JPA.paged_attn_chunk(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(bt),
        start, kv_len, window=window, softcap=softcap,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True)
    gath = JATT.sdpa_chunked(
        jnp.asarray(q), jnp.asarray(_deq(k8, ks, bt)),
        jnp.asarray(_deq(v8, vs, bt)),
        jnp.arange(start, start + Cs, dtype=jnp.int32),
        jnp.arange(P * PS, dtype=jnp.int32), jnp.asarray(window, jnp.int32),
        jnp.asarray(kv_len, jnp.int32), causal=True, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL_KERNEL)
    np.testing.assert_allclose(got, np.asarray(gath), **TOL_GATHER)


def test_int8_unreachable_pages_and_nan_scales_never_leak():
    """The kernels' contract for an int8 pool, held by the plain versions
    where they can: +-127 at every unreadable position of a live page
    changes no output bit. (NaN scales on dead pages reach the plain
    versions' gather, 0 * NaN; the kernels read a dead key's scale as 0,
    which chip_smoke.py and tests/test_torch_cuda.py check on the card.)"""
    t = np.array([0, 3, 11, 20], np.int32)
    k8, v8, ks, vs, bt = _int8_pools(2, t + 1, seed=15)
    live = np.zeros(k8.shape[:2], bool)
    for b in range(len(t)):
        for pos in range(int(t[b]) + 1):
            live[bt[b, pos // PS], pos % PS] = True
    q = _t(np.random.default_rng(16).standard_normal(
        (len(t), HQ, HD)).astype(np.float32))

    def pools(fill):
        sel = live[:, :, None, None]
        return (_t(np.where(sel, k8, fill).astype(np.int8)),
                _t(np.where(sel, v8, -fill).astype(np.int8)))
    sc = dict(k_scales=_t(ks), v_scales=_t(vs))
    (kc, vc), (kx, vx) = pools(0), pools(127)
    assert torch.equal(PA.paged_attn_decode(q, kc, vc, _t(bt), _t(t), **sc),
                       PA.paged_attn_decode(q, kx, vx, _t(bt), _t(t), **sc))


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
    Cfg.kv_quant = "int8"
    assert PA.page_bytes(Cfg(), 16) == JPA.page_bytes(
        jcfg.with_overrides(kv_quant="int8"), 16) == 131072 + 256
    t_host = np.array([448, 0, 15, 16])
    active = np.array([True, False, True, True])
    assert PA.decode_tick_pages(t_host, active, 16, 4, 32) == \
        JPA.decode_tick_pages(t_host, active, 16, 4, 32) == (29 + 1 + 2, 128)


# ------------------------------------------ K4's bf16 body: launch arithmetic

# (Cs, G, hd, ps, P, start, kv_len, window): llama's and granite's last
# engine chunk, a window, kv_len inside a page with pad queries, a chunk
# starting at 0, head_dim 256 (32-key tiles), a chunk of 16 rows (W = 1)
TILE_CASES = {
    "llama": (128, 1, 128, 16, 32, 320, 448, 0),
    "granite": (128, 3, 64, 16, 32, 320, 448, 0),
    "window": (128, 1, 128, 16, 32, 320, 448, 100),
    "kv_len_in_page": (32, 3, 64, 16, 4, 16, 37, 0),
    "start_0": (128, 1, 128, 16, 32, 0, 128, 0),
    "hd256_window": (24, 4, 256, 16, 5, 37, 57, 9),
    "one_warp": (16, 1, 64, 8, 6, 5, 21, 3),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_chunk_tiles_cover_exactly_the_visible_keys(case):
    """Each CTA's key tiles, against a brute-force mask of every (row, key):
    the rows partition the chunk in blocks of 16 W; every key a row of the
    CTA may see lies in its tiles; and its first and last tiles hold such
    a key (no dead tile is loaded) wherever the CTA has a real query
    (q_pos < kv_len; pad queries alone may make the range looser, never
    narrower)."""
    Cs, G, hd, ps, P, start, kv_len, window = TILE_CASES[case]
    W, ctas = PA.chunk_tiles(Cs, G, hd, ps, P, start, kv_len, window)
    KT = PA.chunk_key_tile(hd)
    assert W == PA.chunk_warps(Cs * G) and KT == (32 if hd > 128 else 64)
    assert [c[:2] for c in ctas] == [
        (lo, min(lo + 16 * W, Cs * G)) for lo in range(0, Cs * G, 16 * W)]
    k_pos = np.arange(P * ps)
    for row_lo, row_hi, t_lo, t_hi in ctas:
        q_pos = start + np.arange(row_lo, row_hi) // G
        seen = (k_pos[None] < kv_len) & (k_pos[None] <= q_pos[:, None])
        if window > 0:
            seen &= k_pos[None] > q_pos[:, None] - window
        keys = k_pos[seen.any(0)]
        if keys.size == 0:
            assert t_hi < t_lo
            continue
        assert t_lo * KT <= keys.min() and keys.max() < (t_hi + 1) * KT
        if q_pos.min() < kv_len:
            assert keys.min() // KT == t_lo and keys.max() // KT == t_hi
    if case in ("llama", "granite"):       # 64 rows per CTA, 7 key tiles
        assert W == 4 and len(ctas) == Cs * G // 64
        assert ctas[0][2:] == (0, 5) and ctas[-1][2:] == (0, 6)


def _widened(x):
    """Page rows as K4's bf16 body reads them, in fp32: int8 through
    `widen16` (emulated bit for bit), other dtypes as they are."""
    return _widen16(x).float() if x.dtype == torch.int8 else x.float()


def _chunk_tc_emulated(q, kp, vp, bt, start, kv_len, window, softcap,
                       k_scales=None, v_scales=None):
    """K4's bf16 body, step for step, in fp32 torch on the CPU (p is not
    rounded: fp32 pages): CTAs of chunk_tiles, warps of 16 rows skipping
    the tiles outside their own key range, tiles zero-filled outside the
    CTA's range, masked scores -inf against a running max from -1e30, l
    summed from p, out = acc / max(l, 1e-20). With int8 pages, each tile
    widened to bf16 by the kernel's bit arithmetic, and each key's scales
    (0 outside the CTA's range) multiply its scores and its p before PV."""
    B, Cs, Hq, hd = q.shape
    _, ps, Hkv, _ = kp.shape
    G, P, R = Hq // Hkv, bt.shape[1], Cs * Hq // Hkv
    W, ctas = PA.chunk_tiles(Cs, G, hd, ps, P, start, kv_len, window)
    KT = PA.chunk_key_tile(hd)
    out = torch.zeros(B, Cs, Hq, hd)
    for b in range(B):
        for h in range(Hkv):
            for row_lo, row_hi, t_lo, t_hi in ctas:
                first, last = PA.chunk_key_range(row_lo, row_hi, G, ps, P,
                                                 start, kv_len, window)
                for w0 in range(row_lo, row_hi, 16):
                    rows = torch.arange(w0, min(w0 + 16, R))
                    w_first, w_last = PA.chunk_key_range(
                        w0, int(rows[-1]) + 1, G, ps, P, start, kv_len,
                        window)
                    qr = q[b, rows // G, h * G + rows % G]
                    q_pos = start + rows // G
                    m = torch.full((len(rows),), -1e30)
                    l = torch.zeros(len(rows))
                    o = torch.zeros(len(rows), hd)
                    for t in range(t_lo, t_hi + 1):
                        if t * KT > w_last or (t + 1) * KT - 1 < w_first:
                            continue
                        pos = t * KT + torch.arange(KT)
                        load = (pos >= first) & (pos <= last)
                        k = torch.zeros(KT, hd)
                        v = torch.zeros(KT, hd)
                        page = bt[b, pos[load] // ps].long()
                        k[load] = _widened(kp[page, pos[load] % ps, h])
                        v[load] = _widened(vp[page, pos[load] % ps, h])
                        ksc, vsc = torch.zeros(KT), torch.zeros(KT)
                        if k_scales is not None:
                            ksc[load] = k_scales[page, h]
                            vsc[load] = v_scales[page, h]
                        s = qr @ k.T
                        if k_scales is not None:
                            s = s * ksc[None]
                        s = s * hd ** -0.5
                        if softcap > 0:
                            s = softcap * torch.tanh(s / softcap)
                        live = ((pos[None] <= last) & (pos[None] < kv_len)
                                & (pos[None] <= q_pos[:, None]))
                        if window > 0:
                            live &= pos[None] > q_pos[:, None] - window
                        s = torch.where(live, s, -torch.inf)
                        m_new = torch.maximum(m, s.max(1).values)
                        corr = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * corr + p.sum(1)
                        if v_scales is not None:
                            p = torch.where(p > 0, p * vsc[None], 0.0)
                        o = o * corr[:, None] + p @ v
                        m = m_new
                    out[b, rows // G, h * G + rows % G] = \
                        o / torch.clamp(l, min=1e-20)[:, None]
    return out


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (50, 0.0), (0, 4.0),
                                            (70, 3.0)])
def test_chunk_tc_algorithm_matches_jax_kernel(window, softcap):
    """The new body's tiling on several key tiles (192 positions, pages of
    16, GQA 3 so rows fold across warps and CTAs, a last CTA of pad rows),
    emulated on the CPU, against the JAX Pallas chunk kernel in interpret
    mode on the real queries: 1e-5 (fp32, sums in another order)."""
    rng = np.random.default_rng(30 + window)
    B, Cs, nkv, G_, hd, ps, Pn, start, kv_len = 2, 40, 2, 3, 16, 16, 12, \
        130, 165
    q = rng.standard_normal((B, Cs, nkv * G_, hd)).astype(np.float32)
    NP = B * Pn + 1
    kp = rng.standard_normal((NP, ps, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, nkv, hd)).astype(np.float32)
    bt = (rng.permutation(np.arange(1, NP))[:B * Pn]
          .reshape(B, Pn).astype(np.int32))
    bt[:, -(-kv_len // ps):] = 0                  # the null page past kv_len
    got = _chunk_tc_emulated(_t(q), _t(kp), _t(vp), _t(bt), start, kv_len,
                             window, softcap)
    kern = JPA.paged_attn_chunk(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(bt), start,
                                kv_len, window=window, softcap=softcap,
                                interpret=True)
    n = kv_len - start
    np.testing.assert_allclose(got.numpy()[:, :n], np.asarray(kern)[:, :n],
                               **TOL_KERNEL)


# ---------------------------------------- K3's split-KV body: launch arithmetic

# (P, ps, window): the engine's pool (32 pages of 16), pages of 8 and 4
# (several pages a split), pages larger than a split (128), a page count
# the splits do not divide, windows that leave the first splits empty
SPLIT_CASES = [(32, 16, 0), (32, 16, 100), (24, 8, 40), (10, 4, 0),
               (4, 128, 0), (7, 16, 30), (3, 24, 0)]


@pytest.mark.parametrize("P_,ps,window", SPLIT_CASES)
def test_decode_splits_cover_exactly_the_visible_keys(P_, ps, window):
    """Each split is a span of whole pages, about 64 keys (at least one
    page), the splits cover the row's P pages, and over every position t
    the splits' key ranges are disjoint and their union is exactly the
    keys the row may see (a brute-force mask: k_pos <= t, and k_pos > t -
    window when window > 0)."""
    pages, splits = PA.decode_splits(P_, ps)
    assert pages == max(1, PA.DECODE_SPLIT_KEYS // ps)
    assert (splits - 1) * pages < P_ <= splits * pages
    k_pos = np.arange(P_ * ps)
    for t in range(P_ * ps):
        seen = k_pos <= t
        if window > 0:
            seen &= k_pos > t - window
        got = np.zeros(P_ * ps, int)
        for s in range(splits):
            first, last = PA.decode_split_keys(s, pages, ps, P_, t, window)
            if last < first:
                continue
            assert s * pages * ps <= first and last < (s + 1) * pages * ps
            got[first:last + 1] += 1
        np.testing.assert_array_equal(got, seen.astype(int), err_msg=f"t={t}")


def _decode_split_emulated(q, kp, vp, bt, t, window, softcap,
                           k_scales=None, v_scales=None):
    """K3's split-KV body step by step in fp32 torch on the CPU: per (row,
    kv head) a partial (m, l, acc) per split, the empty partial (-1e30, 0,
    0) where the split holds no visible key; inside a split, warps of
    32-key tiles (tile j to warp j mod 2) each with its own online softmax
    (masked scores -inf against a running max from -1e30; p rounded to
    the page dtype only for PV, l summing it unrounded) and keys outside
    the split's range zero-filled; the warps merged in order; then the
    splits combined in index order, out = sum e^(m_s - M) acc_s /
    max(sum e^(m_s - M) l_s, 1e-20). With int8 pages, K and V widened to
    fp32 by the kernel's bit arithmetic, and each lane's key's scales (0
    for a dead key) multiply its scores and its unrounded p before PV."""
    B, Hq, hd = q.shape
    _, ps, Hkv, _ = kp.shape
    G, P_ = Hq // Hkv, bt.shape[1]
    pages, splits = PA.decode_splits(P_, ps)
    f32 = _i8_f32 if kp.dtype == torch.int8 else (lambda x: x.float())
    SK, W, TILE = pages * ps, 2, 32
    out = torch.zeros(B, Hq, hd)
    for b in range(B):
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G]
            parts = []
            for s in range(splits):
                first, last = PA.decode_split_keys(s, pages, ps, P_,
                                                   int(t[b]), window)
                if last < first:
                    parts.append((torch.full((G,), -1e30), torch.zeros(G),
                                  torch.zeros(G, hd)))
                    continue
                warps = [(torch.full((G,), -1e30), torch.zeros(G),
                          torch.zeros(G, hd)) for _ in range(W)]
                for j in range(-(-SK // TILE)):
                    pos = s * SK + j * TILE + torch.arange(TILE)
                    live = (pos >= first) & (pos <= last)
                    if not bool(live.any()):
                        continue
                    k = torch.zeros(TILE, hd, dtype=kp.dtype)
                    v = torch.zeros(TILE, hd, dtype=vp.dtype)
                    page = bt[b, pos[live] // ps].long()
                    k[live] = kp[page, pos[live] % ps, h]
                    v[live] = vp[page, pos[live] % ps, h]
                    ksc, vsc = torch.zeros(TILE), torch.zeros(TILE)
                    if k_scales is not None:
                        ksc[live] = k_scales[page, h]
                        vsc[live] = v_scales[page, h]
                    sc = qg.float() @ f32(k).T
                    if k_scales is not None:
                        sc = sc * ksc[None]
                    sc = sc * hd ** -0.5
                    if softcap > 0:
                        sc = softcap * torch.tanh(sc / softcap)
                    sc = torch.where(live[None], sc, -torch.inf)
                    m, l, acc = warps[j % W]
                    m_new = torch.maximum(m, sc.max(1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    pv = (torch.where(p > 0, p * vsc[None], 0.0)
                          if v_scales is not None else p.to(v.dtype).float())
                    warps[j % W] = (m_new, l * corr + p.sum(1),
                                    acc * corr[:, None] + pv @ f32(v))
                M = torch.stack([w[0] for w in warps]).max(0).values
                c = [torch.exp(w[0] - M) for w in warps]
                parts.append((M, sum(ci * w[1] for ci, w in zip(c, warps)),
                              sum(ci[:, None] * w[2]
                                  for ci, w in zip(c, warps))))
            M = torch.stack([p[0] for p in parts]).max(0).values
            c = [torch.exp(p[0] - M) for p in parts]
            num = sum(ci[:, None] * p[2] for ci, p in zip(c, parts))
            den = sum(ci * p[1] for ci, p in zip(c, parts))
            out[b, h * G:(h + 1) * G] = num / torch.clamp(den,
                                                          min=1e-20)[:, None]
    return out


@pytest.mark.parametrize("G_,window,softcap", [(3, 0, 0.0), (3, 40, 0.0),
                                               (3, 0, 4.0), (1, 70, 3.0),
                                               (4, 100, 0.0)])
def test_decode_split_algorithm_matches_jax_kernel(G_, window, softcap):
    """K3's split-KV algorithm, emulated on the CPU at pages of 8 (8 pages,
    64 keys a split, 3 splits of 24 pages; two 32-key tiles a split, one a
    warp): rows at t = 0, on split edges and at the end, windows that
    empty the first splits, a softcap and GQA 1/3/4, against the JAX
    Pallas decode kernel in interpret mode: 1e-5 (fp32, sums in another
    order)."""
    rng = np.random.default_rng(60 + G_ + window)
    t = np.array([0, 63, 64, 100, 191], np.int32)
    B, nkv, hd, ps, Pn = len(t), 2, 16, 8, 24
    q = rng.standard_normal((B, nkv * G_, hd)).astype(np.float32)
    NP = B * Pn + 1
    kp = rng.standard_normal((NP, ps, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, nkv, hd)).astype(np.float32)
    ids = iter(rng.permutation(np.arange(1, NP)))
    bt = np.zeros((B, Pn), np.int32)
    for b in range(B):
        for j in range(int(t[b]) // ps + 1):
            bt[b, j] = next(ids)
    assert PA.decode_splits(Pn, ps) == (8, 3)
    got = _decode_split_emulated(_t(q), _t(kp), _t(vp), _t(bt), t, window,
                                 softcap)
    kern = JPA.paged_attn_decode(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(t), window=window,
                                 softcap=softcap, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL_KERNEL)


def _quantized(rng, shape, nkv):
    """Random fp32 pages scaled per (page, kv head) into [0.2, 1], quantized
    by the reference: (int8 pages, f32 scales), numpy."""
    from repro.core import quant as JQ
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(
        0.2, 1.0, size=(shape[0], 1, nkv, 1)).astype(np.float32)
    q8, sc = JQ.quantize_pages(jnp.asarray(x))
    return np.asarray(q8), np.array(sc)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (50, 0.0), (70, 3.0)])
def test_chunk_tc_int8_algorithm_matches_jax_kernel(window, softcap):
    """K4's tensor-core body on int8 pages (the scale per key column of S,
    p * s_v before PV), emulated on the CPU, against the JAX Pallas chunk
    kernel's int8 operand in interpret mode on the real queries: 1e-5 (fp32,
    sums in another order). NaN in the scales of the null page past kv_len
    reaches no real query."""
    rng = np.random.default_rng(40 + window)
    B, Cs, nkv, G_, hd, ps, Pn, start, kv_len = 2, 40, 2, 3, 16, 16, 12, \
        130, 165
    q = rng.standard_normal((B, Cs, nkv * G_, hd)).astype(np.float32)
    NP = B * Pn + 1
    k8, ks = _quantized(rng, (NP, ps, nkv, hd), nkv)
    v8, vs = _quantized(rng, (NP, ps, nkv, hd), nkv)
    bt = (rng.permutation(np.arange(1, NP))[:B * Pn]
          .reshape(B, Pn).astype(np.int32))
    bt[:, -(-kv_len // ps):] = 0                  # the null page past kv_len
    kern = JPA.paged_attn_chunk(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(bt),
        start, kv_len, window=window, softcap=softcap,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True)
    ks[0] = vs[0] = np.nan
    got = _chunk_tc_emulated(_t(q), _t(k8), _t(v8), _t(bt), start, kv_len,
                             window, softcap, _t(ks), _t(vs))
    n = kv_len - start
    np.testing.assert_allclose(got.numpy()[:, :n], np.asarray(kern)[:, :n],
                               **TOL_KERNEL)


@pytest.mark.parametrize("G_,window,softcap", [(3, 0, 0.0), (1, 70, 3.0),
                                               (4, 100, 0.0)])
def test_decode_split_int8_algorithm_matches_jax_kernel(G_, window, softcap):
    """K3's split-KV body on int8 pages (each lane's key's scales on its
    scores and its p), emulated on the CPU at the cases of
    test_decode_split_algorithm_matches_jax_kernel, against the JAX Pallas
    decode kernel's int8 operand in interpret mode: 1e-5. NaN in the null
    page's scales reaches no output."""
    rng = np.random.default_rng(70 + G_ + window)
    t = np.array([0, 63, 64, 100, 191], np.int32)
    B, nkv, hd, ps, Pn = len(t), 2, 16, 8, 24
    q = rng.standard_normal((B, nkv * G_, hd)).astype(np.float32)
    NP = B * Pn + 1
    k8, ks = _quantized(rng, (NP, ps, nkv, hd), nkv)
    v8, vs = _quantized(rng, (NP, ps, nkv, hd), nkv)
    ids = iter(rng.permutation(np.arange(1, NP)))
    bt = np.zeros((B, Pn), np.int32)
    for b in range(B):
        for j in range(int(t[b]) // ps + 1):
            bt[b, j] = next(ids)
    kern = JPA.paged_attn_decode(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(bt),
        jnp.asarray(t), window=window, softcap=softcap,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True)
    ks[0] = vs[0] = np.nan
    got = _decode_split_emulated(_t(q), _t(k8), _t(v8), _t(bt), t, window,
                                 softcap, _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL_KERNEL)
