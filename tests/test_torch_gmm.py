"""The port's plain grouped GEMM (K6 `gmm`) and its two entry points,
`expert_ffn_gmm` (K1 then K6) and `moe_ffn_pallas`, against the JAX
package: its Pallas kernels in interpret mode and its jnp oracle.

On the CPU the wrappers run their plain versions; the CUDA kernel is
compared with them in tests/test_torch_cuda.py. Tolerances are the
reference's own: tests/test_kernels.py::test_gmm_sweep (2e-5 fp32, 2e-2
bf16: one rounding of the output to bf16) and
tests/test_moe_paths.py::test_pallas_moe_matches_dispatch (rtol 1e-4,
atol 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import moe as JMOE  # noqa: E402
from repro.core.routing import token_choice as j_token_choice  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.moe_gmm import gmm as j_gmm  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.kernels import moe_gmm as G  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402

torch.set_float32_matmul_precision("highest")

# tests/test_kernels.py:SWEEP, (N, K, F, E, bn, bf16)
SWEEP = [
    (128, 256, 128, 2, 64, False),
    (256, 512, 256, 4, 128, False),
    (256, 512, 384, 8, 64, False),
    (512, 1024, 512, 8, 128, True),
    (128, 512, 128, 3, 32, False),
    (128, 48, 96, 4, 32, False),
    (64, 688, 172, 4, 32, False),
]


def _both(a, bf16=False):
    """The same values for both packages (bf16: rounded once, to nearest
    even, on each side)."""
    j, t = jnp.asarray(a), torch.from_numpy(np.array(a))
    if bf16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("N,K,F,E,bn,bf16", SWEEP)
def test_gmm_plain_matches_pallas_and_oracle(N, K, F, E, bn, bf16):
    rng = np.random.default_rng(N + K)
    xj, xt = _both((rng.standard_normal((N, K)) * 0.1).astype(np.float32),
                   bf16)
    wj, wt = _both((rng.standard_normal((E, K, F)) * 0.05).astype(np.float32),
                   bf16)
    te = rng.integers(0, E, N // bn).astype(np.int32)
    before = dict(G.LAUNCHES)
    y = G.gmm(xt, wt, torch.from_numpy(te), bn=bn)
    assert G.LAUNCHES == before            # the plain version counts nothing
    assert y.shape == (N, F) and y.dtype == xt.dtype
    tol = 2e-2 if bf16 else 2e-5
    yj = j_gmm(xj, wj, jnp.asarray(te), bn=bn, interpret=True)
    y_ref = ref.gmm_ref(xj, wj, jnp.asarray(te), bn)
    for want in (yj, y_ref):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    # out_dtype: the fp32 sum, unrounded
    y32 = G.gmm(xt, wt, torch.from_numpy(te), bn=bn, out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    yj32 = j_gmm(xj, wj, jnp.asarray(te), bn=bn, interpret=True,
                 out_dtype=jnp.float32)
    np.testing.assert_allclose(y32.numpy(), np.asarray(yj32), rtol=2e-5,
                               atol=2e-5)


def test_gmm_tile_valid_skips_compute():
    """tests/test_kernels.py::test_gmm_tile_valid_skips_compute: invalid
    tiles give zero rows, valid tiles what the all-valid call gives."""
    rng = np.random.default_rng(11)
    N, K, F, E, bn = 64, 32, 32, 2, 16
    x = torch.from_numpy((rng.standard_normal((N, K)) * 0.1).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((E, K, F)) * 0.05)
                         .astype(np.float32))
    te = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    tv = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    y = G.gmm(x, w, te, tv, bn=bn)
    y_full = G.gmm(x, w, te, None, bn=bn)
    assert (y[bn:2 * bn] == 0).all() and (y[3 * bn:] == 0).all()
    torch.testing.assert_close(y[:bn], y_full[:bn], rtol=0, atol=0)
    yj = j_gmm(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
               jnp.asarray(te.numpy()), jnp.asarray(tv.numpy()), bn=bn,
               interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=2e-5,
                               atol=2e-5)


def test_gmm_shape_errors():
    x, w = torch.zeros(64, 8), torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="different bn"):
        G.gmm(x, w, torch.zeros(7, dtype=torch.int32), bn=8)
    with pytest.raises(ValueError, match="gmm: x"):
        G.gmm(x, torch.zeros(2, 6, 4), torch.zeros(8, dtype=torch.int32),
              bn=8)


def test_expert_ffn_gmm_matches_reference_on_a_smoke_plan():
    """The llama smoke MoE's expert-choice prefill plan (2 sequences of 16
    tokens, 8 experts of 32, capacity 4 each; the CPU's 8-row tiles with
    padding tiles): the packed rows through K1 and K6 on both sides."""
    cfg = get_config("llama_moe_4_16", smoke=True)
    E, d, de = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    rng = np.random.default_rng(3)
    Bq, S = 2, 16
    x = rng.standard_normal((Bq * S, d)).astype(np.float32)
    gate = rng.standard_normal((d, E)).astype(np.float32)
    cap = S * cfg.moe.top_k // E
    r = R.expert_choice(torch.from_numpy(x).reshape(Bq, S, d),
                        torch.from_numpy(gate), cap)
    ef = torch.arange(E, dtype=torch.int32).repeat_interleave(cap).repeat(Bq)
    tok = (r.token_idx + torch.arange(Bq)[:, None, None] * S).reshape(-1)
    plan = OPS.plan_tile_dispatch(ef, E, 8)
    assert not bool(plan.tile_valid.all())
    x_rows = OPS.scatter_rows(torch.from_numpy(x)[tok.long()], plan)
    bank = {"wg": rng.standard_normal((E, d, de)) / np.sqrt(d),
            "wi": rng.standard_normal((E, d, de)) / np.sqrt(d),
            "wo": rng.standard_normal((E, de, d)) / np.sqrt(de)}
    bank = {n: v.astype(np.float32) for n, v in bank.items()}
    before = dict(G.LAUNCHES)
    y = OPS.expert_ffn_gmm(x_rows, *(torch.from_numpy(bank[n])
                                     for n in ("wg", "wi", "wo")),
                           plan.tile_expert, plan.tile_valid, bn=8)
    assert G.LAUNCHES == before
    yj = JOPS.expert_ffn_gmm(jnp.asarray(x_rows.numpy()),
                             *(jnp.asarray(bank[n]) for n in ("wg", "wi", "wo")),
                             jnp.asarray(plan.tile_expert.numpy()),
                             jnp.asarray(plan.tile_valid.numpy()), bn=8,
                             interpret=True)
    assert y.shape == x_rows.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-5)
    assert (y[~plan.row_valid] == 0).all()


def test_moe_ffn_pallas_matches_reference():
    """tests/test_moe_paths.py::test_pallas_moe_matches_dispatch's setup:
    8 experts of 32, top-2 token choice over 24 tokens of 64, bn=8."""
    e = JMoEConfig(num_experts=8, top_k=2, d_expert=32, capacity_factor=8.0,
                   group_size=2)
    p = JMOE.moe_init(jax.random.PRNGKey(0), 64, e, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (24, 64)) * 0.3
    r = j_token_choice(x, p["gate"], e.top_k)
    yj = JOPS.moe_ffn_pallas(x, r.expert_idx, r.weights, p["experts"],
                             e.num_experts, bn=8, interpret=True)
    bank = {n: torch.from_numpy(np.array(v))
            for n, v in p["experts"].items()}
    y = OPS.moe_ffn_pallas(torch.from_numpy(np.array(x)),
                           torch.from_numpy(np.array(r.expert_idx)),
                           torch.from_numpy(np.array(r.weights)), bank,
                           e.num_experts, bn=8)
    assert y.shape == (24, 64) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-5)
