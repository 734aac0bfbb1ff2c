"""The port's int8 decode-state arithmetic (repro_torch/core/quant.py)
against the reference's (repro/core/quant.py), on the same numpy inputs.

Bit for bit: int8 values and f32 scales of quantize_pages / quantize_rows,
their dequantizations, and the rescale-on-write scatters (a token whose
amax grows its page's scale, a chunk with several positions on one page,
duplicate writes to the null page 0, whose contents nobody reads and are
left out of the comparison). Then the reference's own properties
(tests/test_kv_quant.py): the round-trip error bound amax / (2 * QMAX) per
page and head and per row, and a reused page (stale int8 bytes, scale
zeroed) that ends bit-equal to a fresh one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import given, settings, st  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _pages(rng, shape, spread=100.0):
    """Pages whose (page, kv head) blocks span two decades of magnitude,
    with an all-zero page."""
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(
        1 / spread, spread, size=(shape[0], 1, shape[2], 1)).astype(np.float32)
    x[1] = 0.0
    return x


def test_quantize_dequantize_pages_and_rows_equal_reference():
    rng = np.random.default_rng(0)
    x = _pages(rng, (6, 8, 2, 16))
    q, s = Q.quantize_pages(torch.from_numpy(x))
    jq, js = JQ.quantize_pages(jnp.asarray(x))
    _eq(q, jq)
    _eq(s, js)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    _eq(Q.dequantize_pages(q, s), JQ.dequantize_pages(jq, js))
    # a leading layer axis, as write_decode_slot passes [L, P, ps, Hkv, hd]
    x5 = x.reshape(2, 3, 8, 2, 16)
    q5, s5 = Q.quantize_pages(torch.from_numpy(x5))
    _eq(q5, JQ.quantize_pages(jnp.asarray(x5))[0])
    _eq(s5, JQ.quantize_pages(jnp.asarray(x5))[1])
    r = rng.standard_normal((2, 3, 4, 32)).astype(np.float32) * 7
    r[0, 0, 1] = 0.0
    qr, sr = Q.quantize_rows(torch.from_numpy(r))
    jqr, jsr = JQ.quantize_rows(jnp.asarray(r))
    _eq(qr, jqr)
    _eq(sr, jsr)
    _eq(Q.dequantize_rows(qr, sr), JQ.dequantize_rows(jqr, jsr))


def test_bf16_rows_quantize_as_reference():
    """GO rows arrive in the compute dtype: bf16 rows widen to f32 first,
    on both sides."""
    rng = np.random.default_rng(1)
    r = rng.standard_normal((3, 4, 64)).astype(np.float32) * 3
    rt = torch.from_numpy(r).to(torch.bfloat16)
    rj = jnp.asarray(rt.float().numpy()).astype(jnp.bfloat16)
    qr, sr = Q.quantize_rows(rt)
    jqr, jsr = JQ.quantize_rows(rj)
    _eq(qr, jqr)
    _eq(sr, jsr)


def _state(rng, NP=6, ps=8, H=2, hd=16):
    c = rng.integers(-127, 128, size=(NP, ps, H, hd)).astype(np.int8)
    s = (np.abs(rng.standard_normal((NP, H))) * 0.02).astype(np.float32)
    return c, s


def test_scatter_token_equals_reference():
    """Rows 0 and 1 grow their pages' scales (values ~40x the page's
    amax), row 2 writes a small token (factor 1.0: the page must stay
    bit-stable), rows 3 and 4 are retired rows writing the null page."""
    rng = np.random.default_rng(2)
    c, s = _state(rng)
    page = np.array([3, 4, 5, 0, 0], np.int32)
    off = np.array([2, 7, 1, 0, 0], np.int32)
    val = rng.standard_normal((5, 2, 16)).astype(np.float32)
    val[:2] *= 5
    val[2] *= 1e-3
    ct, stt = torch.from_numpy(c.copy()), torch.from_numpy(s.copy())
    got = Q.scatter_token(ct, stt, torch.from_numpy(page),
                          torch.from_numpy(off), torch.from_numpy(val))
    assert got[0] is ct and got[1] is stt              # in place
    jc, js = JQ.scatter_token(jnp.asarray(c), jnp.asarray(s),
                              jnp.asarray(page), jnp.asarray(off),
                              jnp.asarray(val))
    _eq(ct[1:], np.asarray(jc)[1:])
    _eq(stt, js)
    assert (stt[3:5] > torch.from_numpy(s[3:5])).all()     # scales grew
    # the small token's page: every other position unchanged
    keep = np.ones(8, bool)
    keep[1] = False
    _eq(ct[5][keep], c[5][keep])


def test_scatter_chunk_equals_reference():
    """A chunk of 10 positions: three on page 1 (the scale grows across
    them), two on page 2, the rest pads on the null page."""
    rng = np.random.default_rng(3)
    c, s = _state(rng)
    pages = np.array([[1, 1, 1, 2, 2, 0, 0, 0, 0, 0],
                      [4, 4, 4, 4, 0, 0, 0, 0, 0, 0]], np.int32)
    offs = np.array([[5, 6, 7, 0, 1, 2, 3, 4, 5, 6],
                     [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]], np.int32)
    vals = (rng.standard_normal((2, 10, 2, 16)) *
            np.linspace(1, 6, 10)[None, :, None, None]).astype(np.float32)
    ct, stt = torch.from_numpy(c.copy()), torch.from_numpy(s.copy())
    Q.scatter_chunk(ct, stt, torch.from_numpy(pages), torch.from_numpy(offs),
                    torch.from_numpy(vals))
    jc, js = JQ.scatter_chunk(jnp.asarray(c), jnp.asarray(s),
                              jnp.asarray(pages), jnp.asarray(offs),
                              jnp.asarray(vals))
    _eq(ct[1:], np.asarray(jc)[1:])
    _eq(stt, js)


def test_a_stream_of_scatters_equals_reference():
    """Sixteen decode ticks of two rows into fresh pages of 8 (page 1 then
    2, page 3 then 4) with growing magnitudes: every tick's pages and
    scales equal the reference's."""
    rng = np.random.default_rng(4)
    c = np.zeros((5, 8, 2, 16), np.int8)
    s = np.zeros((5, 2), np.float32)
    ct, stt = torch.from_numpy(c.copy()), torch.from_numpy(s.copy())
    jc, js = jnp.asarray(c), jnp.asarray(s)
    for i in range(16):
        page = np.array([1 + i // 8, 3 + i // 8], np.int32)
        off = np.array([i % 8, i % 8], np.int32)
        val = (rng.standard_normal((2, 2, 16)) * (1 + i % 5)).astype(
            np.float32)
        Q.scatter_token(ct, stt, torch.from_numpy(page),
                        torch.from_numpy(off), torch.from_numpy(val))
        jc, js = JQ.scatter_token(jc, js, jnp.asarray(page),
                                  jnp.asarray(off), jnp.asarray(val))
        _eq(ct, jc)
        _eq(stt, js)


@pytest.mark.parametrize("arch", ["llama_moe_4_16", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("smoke", [True, False])
def test_kv_bytes_per_token_equals_reference(arch, smoke):
    for mode in Q.KV_QUANT_MODES:
        cfg = get_config(arch, smoke=smoke).with_overrides(kv_quant=mode)
        jcfg = jax_config(arch, smoke=smoke).with_overrides(kv_quant=mode)
        assert Q.kv_bytes_per_token(cfg, 16) == JQ.kv_bytes_per_token(jcfg,
                                                                      16)


def test_validate_kv_quant():
    for mode in Q.KV_QUANT_MODES:
        Q.validate_kv_quant(mode)
    assert Q.KV_QUANT_MODES == JQ.KV_QUANT_MODES and Q.QMAX == JQ.QMAX
    with pytest.raises(ValueError, match="kv_quant"):
        Q.validate_kv_quant("fp4")


# ------------------------------------------------- the reference's properties

def _page_roundtrip_bound(x):
    q, s = Q.quantize_pages(torch.from_numpy(x))
    back = Q.dequantize_pages(q, s).numpy()
    bound = np.abs(x).max(axis=(-3, -1)) / (2 * Q.QMAX)
    err = np.abs(back - x).max(axis=(-3, -1))
    # (1 + 1e-6) absorbs f32 rounding in the quotient and product themselves
    assert (err <= bound * (1 + 1e-6) + 1e-30).all(), err.max()
    return q, s, back


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2 ** 32 - 1), st.integers(-6, 6), st.booleans(),
       st.booleans())
def test_page_roundtrip_error_bound_property(seed, expo, zero_page, outlier):
    """Per (page, head) error <= amax / (2 * QMAX) over magnitudes
    1e-6..1e6, all-zero pages (exact zeros, scale 0) and pages whose amax
    is one outlier 1e3 above the rest."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 8, 2, 4)).astype(np.float32) * (10.0 ** expo)
    if outlier:
        x[2, 3, 1, 2] *= 1e3
    if zero_page:
        x[1] = 0.0
    q, s, back = _page_roundtrip_bound(x)
    if zero_page:
        assert (q[1] == 0).all() and (s[1] == 0).all() and (back[1] == 0).all()


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2 ** 32 - 1), st.integers(-6, 6))
def test_row_roundtrip_error_bound_property(seed, expo):
    """Per-row error <= row amax / (2 * QMAX) (the GO-cache layout)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3, 4, 8)).astype(np.float32) * (10.0 ** expo)
    x[0, 0, 1] = 0.0
    q, s = Q.quantize_rows(torch.from_numpy(x))
    back = Q.dequantize_rows(q, s).numpy()
    bound = np.abs(x).max(axis=-1) / (2 * Q.QMAX)
    assert (np.abs(back - x).max(axis=-1) <= bound * (1 + 1e-6) + 1e-30).all()
    assert (back[0, 0, 1] == 0).all()


@settings(max_examples=20, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_chunk_scatter_roundtrip_bound_property(seed):
    """scatter_chunk into empty pages: written positions round-trip within
    the final scales' half-quantum; untouched pages stay zero."""
    rng = np.random.default_rng(seed)
    cache = torch.zeros((4, 8, 2, 4), dtype=torch.int8)
    scales = torch.zeros((4, 2))
    vals = rng.normal(size=(1, 8, 2, 4)).astype(np.float32)
    Q.scatter_chunk(cache, scales, torch.ones((1, 8), dtype=torch.int32),
                    torch.arange(8)[None], torch.from_numpy(vals))
    back = Q.dequantize_pages(cache, scales).numpy()
    bound = scales.numpy()[1] / 2
    assert (np.abs(back[1] - vals[0]).max(axis=(0, 2))
            <= bound * (1 + 1e-6) + 1e-30).all()
    assert (back[[0, 2, 3]] == 0).all()


def test_page_roundtrip_bound_cases():
    """The property's named edge cases, deterministic: an all-zero page and
    an outlier page whose outlier survives within half a quantum."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 8, 2, 4)).astype(np.float32)
    x[1] = 0.0
    x[2, 0, 0, 0] = 1e4
    q, s, back = _page_roundtrip_bound(x)
    assert (back[1] == 0).all() and (s[1] == 0).all()
    assert abs(back[2, 0, 0, 0] - 1e4) <= 1e4 / (2 * Q.QMAX) * (1 + 1e-6)


def test_scatter_reused_page_equals_fresh_page():
    """A page whose previous tenant left int8 bytes behind (scale zeroed on
    release, contents not) ends bit-equal to a fresh zero page after the
    same token stream: the first write's factor-0 rescale wipes them."""
    rng = np.random.default_rng(0)
    fresh = torch.zeros((3, 8, 2, 4), dtype=torch.int8)
    dirty = torch.from_numpy(
        rng.integers(-127, 128, size=(3, 8, 2, 4)).astype(np.int8))
    fs, ds = torch.zeros(3, 2), torch.zeros(3, 2)
    for i in range(8):
        # growing magnitudes force a scale-growth rescale on every write
        val = torch.from_numpy((rng.normal(size=(1, 2, 4)) * (i + 1))
                               .astype(np.float32))
        page, off = torch.tensor([1]), torch.tensor([i])
        Q.scatter_token(fresh, fs, page, off, val)
        Q.scatter_token(dirty, ds, page, off, val)
    assert torch.equal(fresh[1], dirty[1]) and torch.equal(fs, ds)
