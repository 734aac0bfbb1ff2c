"""K9 `slstm_seq` on the CPU (its plain version) against the JAX package's
Pallas kernel in interpret mode and against a loop of the JAX model's own
cell, at the shapes of tests/test_kernels.py:306. Inputs from a numpy seed.

Tolerance: rtol 1e-5 / atol 1e-6 (fp32 on both sides, the recurrent
products summed in another order), the reference test's own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.slstm_cell import slstm_seq as jax_slstm_seq  # noqa: E402
from repro.models.xlstm import _slstm_cell as jax_cell  # noqa: E402
from repro_torch.kernels import slstm_cell as SC  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(1, 16, 2, 8), (2, 24, 4, 16), (3, 33, 4, 32)]


def _inputs(B, S, H, hd, seed=0):
    rng = np.random.default_rng(seed + B * S)
    u = (rng.standard_normal((B, S, 4 * H * hd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((4, H, hd, hd)) / np.sqrt(hd)).astype(np.float32)
    return u, r


def _jax_cell_loop(u, r, H, hd):
    B, S, _ = u.shape
    st = {k: jnp.zeros((B, H, hd)) for k in ("c", "n", "m", "h")}
    hs = []
    for t in range(S):
        st = jax_cell({"r": jnp.asarray(r)}, jnp.asarray(u[:, t]), st, H, hd)
        hs.append(np.asarray(st["h"]).reshape(B, -1))
    return np.stack(hs, axis=1)


@pytest.mark.parametrize("B,S,H,hd", SHAPES)
def test_slstm_seq_matches_reference_kernel_and_cell(B, S, H, hd):
    u, r = _inputs(B, S, H, hd)
    before = dict(SC.LAUNCHES)
    got = SC.slstm_seq(torch.from_numpy(u), torch.from_numpy(r))
    assert SC.LAUNCHES == before            # the plain version counts nothing
    assert got.shape == (B, S, H * hd) and got.dtype == torch.float32
    ref_kernel = np.asarray(jax_slstm_seq(jnp.asarray(u), jnp.asarray(r),
                                          interpret=True))
    np.testing.assert_allclose(got.numpy(), ref_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), _jax_cell_loop(u, r, H, hd),
                               **TOL)


def test_slstm_seq_output_follows_u_dtype_bf16():
    """bf16 u: the output is bf16 as the TPU kernel's (`out_shape` in u's
    dtype), the state fp32. The fp32 values agree to ~1e-6, so the rounded
    outputs differ by at most one bf16 ulp: rtol = atol = 2^-7."""
    B, S, H, hd = 2, 24, 4, 16
    u, r = _inputs(B, S, H, hd, seed=5)
    ub = torch.from_numpy(u).to(torch.bfloat16)
    got = SC.slstm_seq(ub, torch.from_numpy(r))
    assert got.dtype == torch.bfloat16
    ref = jax_slstm_seq(jnp.asarray(ub.float().numpy()).astype(jnp.bfloat16),
                        jnp.asarray(r), interpret=True)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)
    # the same values as the fp32 run, rounded once at the output
    full = SC.slstm_seq(ub.float(), torch.from_numpy(r))
    torch.testing.assert_close(got, full.to(torch.bfloat16), rtol=0, atol=0)


def test_slstm_seq_rejects_mismatched_shapes():
    u, r = _inputs(1, 4, 2, 8)
    with pytest.raises(ValueError, match="want u"):
        SC.slstm_seq(torch.from_numpy(u)[..., :-1], torch.from_numpy(r))
    with pytest.raises(ValueError, match="want u"):
        SC.slstm_seq(torch.from_numpy(u), torch.from_numpy(r)[:, :, :, :4])


# ------------------------------------------- K9's cluster body: its shapes

@pytest.mark.parametrize("B,hd,r_bytes,want", [
    (4, 512, 2, 16),          # xlstm-1.3b's full width, bf16 r: 128 KB a CTA
    (4, 512, 4, None),        # fp32 r: 256 KB a CTA even at 16 CTAs
    (2, 32, 4, 1),            # the xlstm smoke model (2 heads of 32)
    (3, 32, 4, 1), (2, 20, 4, 1), (1, 8, 4, 1),   # the card tests' shapes
    (4, 256, 4, 8), (4, 256, 2, 4), (64, 512, 2, None)])
def test_slstm_cluster_picks_the_smallest_cluster_that_fits(B, hd, r_bytes,
                                                            want):
    """The smallest power of two <= 16 whose r slice, h buffers and sums
    fit a CTA's shared memory (and whose cells fit its threads), or None;
    a smaller cluster than the choice never fits."""
    CL = SC.slstm_cluster(B, hd, r_bytes)
    assert CL == want
    if CL is not None:
        assert SC.slstm_cluster_smem(B, hd, r_bytes, CL) <= SC.SMEM_PER_CTA
        assert B * -(-hd // CL) <= SC.CLUSTER_THREADS * SC.CLUSTER_CELLS
    for smaller in (1, 2, 4, 8, 16):
        if CL is None or smaller < CL:
            assert SC.slstm_cluster_smem(B, hd, r_bytes, smaller) > \
                SC.SMEM_PER_CTA or \
                B * -(-hd // smaller) > SC.CLUSTER_THREADS * SC.CLUSTER_CELLS


def _cluster_emulated(u, r, CL):
    """K9's cluster body step by step in fp32 torch: CTA c of a head's
    cluster holds the rows g U + i of r for its units [c hd // CL,
    (c + 1) hd // CL) (some CTAs own none when CL > hd), computes their
    recurrent sums for all batch rows from its own copy of h_prev (the
    buffer of the step's parity), runs the cell update of its units, and
    writes h into every CTA's buffer of the other parity."""
    B, S, _ = u.shape
    _, H, hd, _ = r.shape
    out = torch.empty(B, S, H * hd)
    for head in range(H):
        bufs = [[torch.zeros(B, hd) for _ in range(CL)] for _ in range(2)]
        ctas = []
        for c in range(CL):
            lo, hi = c * hd // CL, (c + 1) * hd // CL
            r_s = torch.cat([r[g, head, lo:hi] for g in range(4)])
            ctas.append((lo, hi, r_s, [torch.zeros(B, hi - lo)
                                       for _ in range(3)]))
        for t in range(S):
            gates = u[:, t].reshape(B, 4, H, hd)[:, :, head]
            for c, (lo, hi, r_s, (cs, ns, ms)) in enumerate(ctas):
                U = hi - lo
                if U == 0:
                    continue
                rec = (bufs[t % 2][c] @ r_s.T).reshape(B, 4, U)
                g_in = gates[:, :, lo:hi] + rec
                li, lf, z, o = g_in.unbind(1)
                lf = torch.nn.functional.logsigmoid(lf)
                m_new = torch.maximum(lf + ms, li)
                fi, ii = torch.exp(lf + ms - m_new), torch.exp(li - m_new)
                cs.copy_(fi * cs + ii * torch.tanh(z))
                ns.copy_(fi * ns + ii)
                ms.copy_(m_new)
                h = torch.sigmoid(o) * cs / torch.clamp(ns, min=1e-6)
                out[:, t, head * hd + lo:head * hd + hi] = h
                for q in range(CL):
                    bufs[(t + 1) % 2][q][:, lo:hi] = h
    return out


@pytest.mark.parametrize("B,S,H,hd", SHAPES)
def test_cluster_partition_matches_reference_kernel(B, S, H, hd):
    """The cluster body's partition of a head over 1 to 16 CTAs (unit
    slices that do not divide evenly, empty CTAs at hd 8), emulated on the
    CPU, against the JAX Pallas kernel in interpret mode: rtol 1e-5 / atol
    1e-6 (fp32; only the order of the recurrent sums differs)."""
    u, r = _inputs(B, S, H, hd, seed=11)
    ref = np.asarray(jax_slstm_seq(jnp.asarray(u), jnp.asarray(r),
                                   interpret=True))
    for CL in (1, 2, 4, 8, 16):
        got = _cluster_emulated(torch.from_numpy(u), torch.from_numpy(r), CL)
        np.testing.assert_allclose(got.numpy(), ref, err_msg=f"CL={CL}",
                                   **TOL)
