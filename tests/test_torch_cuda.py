"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA card and skips without one; the
module imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest -q -m requires_cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, N, K, F, E, bn, device):
    rng = np.random.default_rng(seed)
    ni = -(-N // bn)
    t = lambda a: torch.from_numpy(a).to(device)      # noqa: E731
    tv = rng.random(ni) > 0.3
    tv[0], tv[-1] = True, False
    return (t((rng.standard_normal((N, K)) * 0.5).astype(np.float32)),
            t((rng.standard_normal((E, K, F)) / np.sqrt(K)).astype(np.float32)),
            t((rng.standard_normal((E, K, F)) / np.sqrt(K)).astype(np.float32)),
            t((rng.standard_normal((E, F, K)) / np.sqrt(F)).astype(np.float32)),
            t(rng.integers(0, E, size=ni).astype(np.int32)), t(tv),
            t(rng.random((N, 1)).astype(np.float32)))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, tol):
    """Ragged K and F, rows past the last full tile, invalid tiles. fp32:
    summation order only (1e-4). bf16: K1 rounds its output to bf16, one
    ulp at the values' scale (2e-2); K2's fp32 output stays at 1e-4."""
    N, K, F, E, bn = 300, 200, 136, 5, G.KERNEL_BLOCK_ROWS
    x, wg, wi, wo, te, tv, scale = _inputs(7, N, K, F, E, bn, cuda_device)
    x, wg, wi, wo = (a.to(dtype) for a in (x, wg, wi, wo))
    before = dict(G.LAUNCHES)
    h = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)
    y = G.gmm_scaled(h, wo, te, tv, scale, bn=bn)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gmm_swiglu"] == before["gmm_swiglu"] + 1
    assert G.LAUNCHES["gmm_scaled"] == before["gmm_scaled"] + 1
    hp = G.gmm_swiglu_plain(x, wg, wi, te, tv, bn)
    yp = G.gmm_scaled_plain(h, wo, te, tv, scale, bn)
    torch.testing.assert_close(h.float(), hp.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    rows_invalid = (~tv).repeat_interleave(bn)[:N]
    assert bool((h[rows_invalid] == 0).all() and (y[rows_invalid] == 0).all())


@pytest.mark.requires_cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    x, wg, wi, wo, te, tv, scale = _inputs(1, 64, 16, 8, 2, 8, cuda_device)
    with pytest.raises(ValueError, match="tiles 64 rows"):
        G.gmm_swiglu(x, wg, wi, te, tv, bn=8)           # another row tile
    x64, te64 = x[:64], te[:1]
    with pytest.raises(TypeError, match="no kernel for dtype"):
        G.gmm_swiglu(x64.half(), wg.half(), wi.half(), te64, None, bn=64)
    with pytest.raises(ValueError, match="contiguous"):
        G.gmm_swiglu(x64, wg.transpose(1, 2).contiguous().transpose(1, 2),
                     wi, te64, None, bn=64)


@pytest.mark.requires_cuda
def test_cuda_moe_ffn_matches_cpu(cuda_device):
    """The executor end to end on the card (bn=64) against the CPU (bn=8):
    same plan semantics, fp32, summation order and atomics -> 1e-4."""
    rng = np.random.default_rng(2)
    T, d, de, E = 40, 48, 24, 4
    ef = torch.from_numpy(rng.integers(0, E, 60).astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, T, 60).astype(np.int32))
    wf = torch.from_numpy(rng.random(60).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    bank = {"wg": torch.randn(E, d, de), "wi": torch.randn(E, d, de),
            "wo": torch.randn(E, de, d)}
    y_cpu, _, _ = OPS.moe_ffn_fused(x, tok, ef, wf, bank, E, T)
    dev = {k: v.to(cuda_device) for k, v in bank.items()}
    y_gpu, _, plan = OPS.moe_ffn_fused(x.to(cuda_device), tok.to(cuda_device),
                                       ef.to(cuda_device), wf.to(cuda_device),
                                       dev, E, T)
    assert plan.n_pad % 64 == 0
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
