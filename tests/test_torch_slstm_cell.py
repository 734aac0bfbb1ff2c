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
