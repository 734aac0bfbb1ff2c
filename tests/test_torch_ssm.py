"""models/ssm.py (the Mamba2 SSD block) against the JAX package's
repro/models/ssm.py on the same numpy-seeded inputs and the same weights
(JAX's `mamba2_init` on the smoke zamba2-1.2b, carried across by
`bridge.params_from_numpy`), all fp32. The reference's functions are plain
jnp: no interpret mode is involved.

Tolerances: 1e-5 against JAX (fp32 on both sides, sums in another order:
the port contracts the reference's three- and four-operand einsums in
pairs); the port's stepwise decode against its chunked forward at 1e-4
(the same math through another summation order over 12 steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

torch.set_float32_matmul_precision("highest")
ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


def _ssd_inputs(rng, b, s, h, p, n):
    """x, positive dt, negative A, B, C, D_skip (fp32 numpy)."""
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(f)
    Bm = rng.standard_normal((b, s, n)).astype(f)
    Cm = rng.standard_normal((b, s, n)).astype(f)
    D = rng.standard_normal(h).astype(f)
    return x, dt, A, Bm, Cm, D


@pytest.fixture(scope="module")
def mamba():
    """(JAX config, port config, one Mamba2 mixer's JAX and port params)."""
    jcfg = jax_config(ARCH, smoke=True)
    p = JS.mamba2_init(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    return jcfg, get_config(ARCH, smoke=True), p, tp


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(
        np.float32)
    got = TS._segsum(_t(x))
    _close(got, JS._segsum(jnp.asarray(x)))
    assert bool(torch.isinf(got[..., 0, 1]).all())


@pytest.mark.parametrize("s,chunk", [(12, 4), (13, 4), (8, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    """s = 13 with chunk 4: the chunk shrinks to 1 (13 chunks); s = 8
    with chunk 16: one chunk of 8."""
    args = _ssd_inputs(np.random.default_rng(s + chunk), 2, s, 3, 4, 5)
    y, final = JS.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, tfinal = TS.ssd_chunked(*map(_t, args), chunk=chunk)
    assert ty.dtype == torch.float32 and tfinal.shape == (2, 3, 4, 5)
    _close(ty, y)
    _close(tfinal, final)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(7)
    b, h, p, n = 2, 3, 4, 5
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x, dt, A, Bm, Cm, D = _ssd_inputs(rng, b, 1, h, p, n)
    args = (state, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)
    st, y = JS.ssd_decode_step(*map(jnp.asarray, args))
    tst, ty = TS.ssd_decode_step(*map(_t, args))
    _close(tst, st)
    _close(ty, y)


def test_mamba2_init_matches_reference_tree(mamba):
    """Same leaves, shapes and dtypes (A_log, D, dt_bias and norm_scale
    fp32 in a bf16 model too); A_log and the fixed leaves equal."""
    jcfg, tcfg, p, tp = mamba
    for cfg_j, cfg_t in ((jcfg, tcfg), (jcfg.with_overrides(dtype="bfloat16"),
                                        tcfg.with_overrides(
                                            dtype="bfloat16"))):
        ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           JS.mamba2_init(jax.random.PRNGKey(0), cfg_j))
        mine = TS.mamba2_init(torch.Generator().manual_seed(0), cfg_t, "cpu")
        assert {k: (tuple(v.shape), str(v.dtype)[6:])
                for k, v in mine.items()} == ref
    mine = TS.mamba2_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    for k in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
        _close(mine[k], p[k])
    w = mine["conv_w"].numpy()
    assert abs(w.std() / 0.1 - 1) < 0.1


def test_mamba2_forward_matches_reference(mamba):
    jcfg, tcfg, p, tp = mamba
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    _close(TS.mamba2_forward(tp, _t(x), cfg=tcfg),
           JS.mamba2_forward(p, jnp.asarray(x), cfg=jcfg))


def test_mamba2_decode_matches_reference(mamba):
    """From a random (not zero) state, so every term of the step runs."""
    jcfg, tcfg, p, tp = mamba
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    st = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in JS.mamba2_init_state(jcfg, B).items()}
    y, new = JS.mamba2_decode(p, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, st), cfg=jcfg)
    ty, tnew = TS.mamba2_decode(tp, _t(x), {k: _t(v) for k, v in st.items()},
                                cfg=tcfg)
    _close(ty, y)
    for k in ("ssm", "conv"):
        _close(tnew[k], new[k])


def test_mamba2_init_state_matches_reference(mamba):
    jcfg, tcfg = mamba[0], mamba[1]
    ref = JS.mamba2_init_state(jcfg, 3)
    mine = TS.mamba2_init_state(tcfg, 3, "cpu", lead=(2,))
    for k in ("ssm", "conv"):
        assert tuple(mine[k].shape) == (2, *ref[k].shape)
        assert str(mine[k].dtype)[6:] == str(ref[k].dtype)
        assert not mine[k].any()


def test_stepwise_decode_matches_chunked_forward(mamba):
    """Port against port: S decode steps from the zero state give the
    chunked forward's outputs (chunk 4: three chunks carry state)."""
    _, tcfg, _, tp = mamba
    cfg = tcfg.with_overrides(ssm_chunk=4)
    x = _t(np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    ref = TS.mamba2_forward(tp, x, cfg=cfg)
    st = TS.mamba2_init_state(cfg, B, "cpu")
    ys = []
    for i in range(S):
        y, st = TS.mamba2_decode(tp, x[:, i:i + 1], st, cfg=cfg)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-4)
