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
    # the fused kernels (K7/K8) check the same way
    sel = torch.ones(64, 1, device=cuda_device)
    with pytest.raises(ValueError, match="tiles 64 rows"):
        G.gmm_swiglu(x, wg, wi, te, tv, tile_expert2=te, row_sel=sel[:64],
                     bn=8)
    with pytest.raises(TypeError, match="no kernel for dtype"):
        G.gmm_scaled(torch.zeros(64, 8, device=cuda_device).half(),
                     wo.half(), te64, None, scale[:64], tile_expert2=te64,
                     row_sel=sel, bn=64)


@pytest.mark.requires_cuda
def test_cuda_moe_ffn_matches_cpu(cuda_device):
    """The executor end to end on the card (bn=64) against the CPU (bn=8):
    same plan semantics, fp32, summation order -> 1e-4."""
    rng = np.random.default_rng(2)
    T, d, de, E = 40, 48, 24, 4
    ef = torch.from_numpy(rng.integers(0, E, 60).astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, T, 60).astype(np.int32))
    wf = torch.from_numpy(rng.random(60).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    bank = {"wg": torch.randn(E, d, de), "wi": torch.randn(E, d, de),
            "wo": torch.randn(E, de, d)}
    R_ = int(torch.bincount(tok).max())
    y_cpu, _, _ = OPS.moe_ffn_fused(x, tok, ef, wf, bank, E, T,
                                    max_per_token=R_)
    dev = {k: v.to(cuda_device) for k, v in bank.items()}
    y_gpu, _, plan = OPS.moe_ffn_fused(x.to(cuda_device), tok.to(cuda_device),
                                       ef.to(cuda_device), wf.to(cuda_device),
                                       dev, E, T, max_per_token=R_)
    assert plan.n_pad % 64 == 0
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)


def _fused_plan(seed, device, E=6, per_lane=(61, 3, 0, 70, 63, 1)):
    """A fused plan at the card's 64-row tile: lanes paired (0,1), (2,3),
    (4,5), with straddles mid-tile and at a tile's last row, an empty
    primary lane and invalid tail tiles."""
    rng = np.random.default_rng(seed)
    ef = np.concatenate([np.full(n, e, np.int32)
                         for e, n in enumerate(per_lane)])
    rng.shuffle(ef)
    return OPS.plan_tile_dispatch(torch.from_numpy(ef).to(device), E,
                                  G.KERNEL_BLOCK_ROWS, fuse=(0, 0, 1, 1, 2, 2))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_fused_kernels_match_plain_versions(cuda_device, dtype, tol):
    """K7 and K8 on straddle tiles against their plain versions. fp32:
    summation order only (1e-4). bf16: K7 rounds its output to bf16 (2e-2);
    K8's fp32 output stays at 1e-4."""
    plan = _fused_plan(8, cuda_device)
    assert bool((plan.tile_expert2 != plan.tile_expert).any())
    N, K, F, E, bn = plan.n_pad, 200, 136, 6, G.KERNEL_BLOCK_ROWS
    x, wg, wi, wo, _, _, scale = _inputs(9, N, K, F, E, bn, cuda_device)
    x = x * plan.row_valid[:, None]
    x, wg, wi, wo = (a.to(dtype) for a in (x, wg, wi, wo))
    kw = dict(tile_expert2=plan.tile_expert2, row_sel=plan.row_sel)
    te, tv = plan.tile_expert, plan.tile_valid
    before = dict(G.LAUNCHES)
    h = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn, **kw)
    y = G.gmm_scaled(h, wo, te, tv, scale, bn=bn, **kw)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gmm_swiglu_fused"] == before["gmm_swiglu_fused"] + 1
    assert G.LAUNCHES["gmm_scaled_fused"] == before["gmm_scaled_fused"] + 1
    assert G.LAUNCHES["gmm_swiglu"] == before["gmm_swiglu"]
    hp = G.gmm_swiglu_fused_plain(x, wg, wi, te, plan.tile_expert2, tv,
                                  plan.row_sel, bn)
    yp = G.gmm_scaled_fused_plain(h, wo, te, plan.tile_expert2, tv,
                                  plan.row_sel, scale, bn)
    torch.testing.assert_close(h.float(), hp.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    rows_invalid = (~tv).repeat_interleave(bn)[:N]
    assert bool((h[rows_invalid] == 0).all() and (y[rows_invalid] == 0).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("token_major", [False, True])
def test_cuda_moe_combine_is_deterministic(cuda_device, token_major):
    """Two calls of the fused executor on identical inputs, many pairs per
    token (token-major top-8), are bit-equal: the combine sums each
    token's pairs in one order, with no float atomics, through the sort
    and through the reshape alike."""
    rng = np.random.default_rng(10)
    T, d, de, E, k = 512, 256, 64, 40, 8
    ef = np.stack([rng.permutation(E)[:k] for _ in range(T)]).reshape(-1)
    t = lambda a: torch.from_numpy(a).to(cuda_device)      # noqa: E731
    ef = t(ef.astype(np.int32))
    tok = torch.arange(T, device=cuda_device).repeat_interleave(k)
    wf = t(rng.random(T * k).astype(np.float32))
    x = t(rng.standard_normal((T, d)).astype(np.float32)).bfloat16()
    bank = {n: t(rng.standard_normal(s).astype(np.float32)).bfloat16()
            for n, s in (("wg", (E, d, de)), ("wi", (E, d, de)),
                         ("wo", (E, de, d)))}
    fuse = tuple(i // 2 for i in range(E))
    ys = [OPS.moe_ffn_fused(x, tok, ef, wf, bank, E, T, fuse=fuse,
                            max_per_token=k, token_major=token_major)[0]
          for _ in range(2)]
    assert torch.equal(ys[0], ys[1])


# --------------------------------------------------------- paged attention

from repro_torch.kernels import paged_attn as PA  # noqa: E402


def _paged(seed, nkv, live, device, dtype, ps=8, P=6, hq=4, hd=64,
           poison=None):
    """Pages with shuffled physical ids (rows past their live tokens on the
    null page); `poison` fills every position no row may read."""
    rng = np.random.default_rng(seed)
    B = len(live)
    NP = B * P + 2
    kp = rng.standard_normal((NP, ps, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, nkv, hd)).astype(np.float32)
    ids = iter(rng.permutation(np.arange(1, NP)))
    bt = np.zeros((B, P), np.int32)
    readable = np.zeros((NP, ps), bool)
    for b in range(B):
        for j in range(-(-int(live[b]) // ps)):
            bt[b, j] = next(ids)
        for pos in range(int(live[b])):
            readable[bt[b, pos // ps], pos % ps] = True
    if poison is not None:
        kp = np.where(readable[:, :, None, None], kp, poison)
        vp = np.where(readable[:, :, None, None], vp, -poison)
    t = lambda a, dt=dtype: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(device=device, dtype=dt)
    return t(kp), t(vp), t(bt, torch.int32), hq, hd


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nkv", [1, 2, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 4.0)])
def test_cuda_paged_attn_matches_plain(cuda_device, nkv, window, softcap):
    """K3 at ragged positions around page boundaries and K4 on a ragged
    last chunk, fp32, against the plain versions: the online softmax sums
    in another order than the one-shot one (2e-5, as the reference's
    kernel-vs-gather tests)."""
    t = np.array([0, 1, 7, 8, 9, 15, 24, 47], np.int32)
    kp, vp, bt, hq, hd = _paged(3, nkv, t + 1, cuda_device, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(len(t), hq, hd, device="cuda", generator=g)
    tt = torch.from_numpy(t).to(cuda_device)
    before = dict(PA.LAUNCHES)
    out = PA.paged_attn_decode(q, kp, vp, bt, tt, window=window,
                               softcap=softcap)
    ref = PA.paged_attn_decode_plain(q, kp, vp, bt, tt, window=window,
                                     softcap=softcap)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    qc = torch.randn(len(t), 16, hq, hd, device="cuda", generator=g)
    for start, kv_len in [(0, 11), (16, 29), (32, 48)]:
        out = PA.paged_attn_chunk(qc, kp, vp, bt, start, kv_len,
                                  window=window, softcap=softcap)
        ref = PA.paged_attn_chunk_plain(qc, kp, vp, bt, start, kv_len,
                                        window=window, softcap=softcap)
        # only real queries: the caller discards pads (q_pos >= kv_len),
        # which under a window may see no key at all
        n = kv_len - start
        torch.testing.assert_close(out[:, :n], ref[:, :n], rtol=2e-5,
                                   atol=2e-5)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["paged_attn_decode"] == \
        before["paged_attn_decode"] + 1
    assert PA.LAUNCHES["paged_attn_chunk"] == before["paged_attn_chunk"] + 3


@pytest.mark.requires_cuda
def test_cuda_paged_attn_bf16_and_unreachable_pages(cuda_device):
    """bf16 pages at the main path's head_dim against the plain versions
    (K4's plain version rounds q * scale to bf16, as sdpa_chunked does:
    2e-2), and poisoned unreachable positions change no output bit."""
    t = np.array([3, 16, 40, 95], np.int32)
    bf, tol = torch.bfloat16, 2e-2
    kp, vp, bt, hq, _ = _paged(5, 2, t + 1, cuda_device, bf, ps=16, hd=128)
    q = torch.randn(len(t), hq, 128, device="cuda").to(bf)
    tt = torch.from_numpy(t).to(cuda_device)
    torch.testing.assert_close(
        PA.paged_attn_decode(q, kp, vp, bt, tt),
        PA.paged_attn_decode_plain(q, kp, vp, bt, tt), rtol=tol, atol=tol)
    qc = torch.randn(len(t), 32, hq, 128, device="cuda").to(bf)
    torch.testing.assert_close(
        PA.paged_attn_chunk(qc, kp, vp, bt, 32, 60),
        PA.paged_attn_chunk_plain(qc, kp, vp, bt, 32, 60), rtol=tol, atol=tol)
    clean = _paged(6, 2, t + 1, cuda_device, torch.float32, ps=16,
                   poison=0.0)
    dirty = _paged(6, 2, t + 1, cuda_device, torch.float32, ps=16,
                   poison=1e4)
    q = torch.randn(len(t), 4, 64, device="cuda")
    tt = torch.from_numpy(t).to(cuda_device)
    assert torch.equal(PA.paged_attn_decode(q, *clean[:3], tt),
                       PA.paged_attn_decode(q, *dirty[:3], tt))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 4e-2)])
def test_cuda_paged_attn_gqa3_head_dim_64(cuda_device, dtype, tol):
    """K3/K4 at granite's grouping: 3 query heads per kv head, head_dim 64
    (fp32 6/2 heads, 2e-5 as above; bf16 at the full width's 24/8, where
    the plain chunk rounds q * scale to bf16 and the kernel does not: 4e-2,
    over 10x the ~3e-3 seen on an H100)."""
    t = np.array([0, 7, 16, 33, 95], np.int32)
    hq, nkv = (6, 2) if dtype == torch.float32 else (24, 8)
    kp, vp, bt, _, hd = _paged(11, nkv, t + 1, cuda_device, dtype, ps=16,
                               hq=hq, hd=64)
    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn(len(t), hq, hd, device="cuda", generator=g).to(dtype)
    tt = torch.from_numpy(t).to(cuda_device)
    torch.testing.assert_close(
        PA.paged_attn_decode(q, kp, vp, bt, tt),
        PA.paged_attn_decode_plain(q, kp, vp, bt, tt), rtol=tol, atol=tol)
    qc = torch.randn(len(t), 32, hq, hd, device="cuda", generator=g).to(dtype)
    out = PA.paged_attn_chunk(qc, kp, vp, bt, 64, 90)
    ref = PA.paged_attn_chunk_plain(qc, kp, vp, bt, 64, 90)
    torch.testing.assert_close(out[:, :26], ref[:, :26], rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_cuda_paged_attn_raises_instead_of_falling_back(cuda_device):
    kp, vp, bt, hq, _ = _paged(1, 2, [9], cuda_device, torch.float32, hd=24)
    t = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        PA.paged_attn_decode(torch.zeros(1, hq, 24, device="cuda"), kp, vp,
                             bt, t)
    kp, vp, bt, hq, hd = _paged(1, 2, [9], cuda_device, torch.float16)
    with pytest.raises(TypeError, match="no kernel for dtype"):
        PA.paged_attn_decode(torch.zeros(1, hq, hd, device="cuda").half(),
                             kp, vp, bt, t)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["llama_moe_4_16", "granite-moe-3b-a800m"])
def test_cuda_engine_streams_equal_cpu(cuda_device, arch):
    """The smoke engine on a paged pool with chunked prefill: the card
    (K1-K4, and K7/K8 for granite's grouped prefill) streams what the CPU
    (plain versions) streams."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models.model import model_init
    cfg = get_config(arch, smoke=True)
    params = model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 20, 8, 11, 3)]
    kw = dict(num_slots=2, max_tokens=32, arrival_steps=[0, 0, 1, 4, 6],
              paged=True, page_size=4, num_pages=10, prefill_chunk=8)
    cpu = serve_continuous(params, cfg, prompts, 7, device="cpu", **kw)
    gpu_params = _to(params, cuda_device)
    before = dict(PA.LAUNCHES)
    gpu = serve_continuous(gpu_params, cfg, prompts, 7, device="cuda", **kw)
    for rid, toks in cpu["tokens"].items():
        np.testing.assert_array_equal(gpu["tokens"][rid], toks)
    L = cfg.num_layers
    s = gpu["stats"]
    assert PA.LAUNCHES["paged_attn_decode"] - before["paged_attn_decode"] \
        == L * s["decode_ticks"]
    assert PA.LAUNCHES["paged_attn_chunk"] - before["paged_attn_chunk"] \
        == L * s["chunk_ticks"]


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _slstm_inputs(B, S, H, hd, device, r_dtype, seed=0):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy((rng.standard_normal((B, S, 4 * H * hd)) * 0.5)
                         .astype(np.float32)).to(device)
    r = torch.from_numpy((rng.standard_normal((4, H, hd, hd)) / np.sqrt(hd))
                         .astype(np.float32)).to(device, r_dtype)
    return u, r


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,H,hd,r_dtype,tol", [
    (3, 33, 4, 32, torch.float32, 1e-5),
    (2, 9, 2, 20, torch.float32, 1e-5),     # hd not a multiple of 4 or 8
    (4, 128, 4, 512, torch.bfloat16, 1e-4)])
def test_cuda_slstm_seq_matches_plain(cuda_device, B, S, H, hd, r_dtype, tol):
    """K9 against its plain version: the JAX test's largest fp32 shape, a
    ragged head width, and xlstm-1.3b's full-width sLSTM (fp32 u, bf16 r,
    as model_forward passes them). fp32 throughout; only the order of the
    recurrent sums differs. Repeated launches give the same bits."""
    from repro_torch.kernels import slstm_cell as SC
    u, r = _slstm_inputs(B, S, H, hd, cuda_device, r_dtype)
    before = SC.LAUNCHES["slstm_seq"]
    h = SC.slstm_seq(u, r)
    h2 = SC.slstm_seq(u, r)
    torch.cuda.synchronize()
    assert SC.LAUNCHES["slstm_seq"] == before + 2
    torch.testing.assert_close(h, SC.slstm_seq_plain(u, r), rtol=tol,
                               atol=tol)
    assert torch.equal(h, h2)
    hb = SC.slstm_seq(u.to(torch.bfloat16), r)       # output follows u
    assert hb.dtype == torch.bfloat16


@pytest.mark.requires_cuda
def test_cuda_slstm_seq_raises_instead_of_falling_back(cuda_device):
    from repro_torch.kernels import slstm_cell as SC
    u, r = _slstm_inputs(1, 4, 1, 520, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="at most 512"):
        SC.slstm_seq(u, r)
    u, r = _slstm_inputs(1, 4, 2, 16, cuda_device, torch.float32)
    with pytest.raises(TypeError, match="no kernel"):
        SC.slstm_seq(u.half(), r)
    with pytest.raises(ValueError, match="u on"):
        SC.slstm_seq(u, r.cpu())


@pytest.mark.requires_cuda
def test_cuda_xlstm_forward_launches_k9_and_equals_cpu(cuda_device):
    """The smoke xlstm model_forward on the card launches K9 once per sLSTM
    block (2) and gives the CPU's hidden states to 1e-4 (fp32; the random
    smoke model amplifies rounding: the CPU's fp32 forward lies ~2e-5 from
    its fp64 one, chip_smoke.py XLSTM_SMOKE_HIDDEN_TOL)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import slstm_cell as SC
    from repro_torch.models.model import model_forward, model_init
    cfg = get_config("xlstm-1.3b", smoke=True)
    params = model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)))
    x_cpu, _ = model_forward(params, tokens, cfg)
    SC.reset_launches()
    x_gpu, _ = model_forward(_to(params, cuda_device), tokens.to(cuda_device),
                             cfg)
    assert SC.LAUNCHES["slstm_seq"] == 2
    torch.testing.assert_close(x_gpu.cpu(), x_cpu, rtol=1e-4, atol=1e-4)


# ------------------------------------------------- K5 TopKUpdate, K6 gmm

from repro_torch.kernels import go_topk as GT  # noqa: E402


def _topk_inputs(seed, B, E, k, device):
    """Cached scores with empty rows (-inf, id -1), tied minima, and new
    scores equal to a row's minimum; per-row token ids."""
    rng = np.random.default_rng(seed)
    sp = rng.standard_normal((B, E, k)).astype(np.float32)
    tp = rng.integers(0, 1000, (B, E, k)).astype(np.int32)
    sn = rng.standard_normal((B, E)).astype(np.float32)
    rows = rng.permutation(B * E)
    n = max(1, B * E // 6)
    sp.reshape(-1, k)[rows[:n]] = -np.inf
    tp.reshape(-1, k)[rows[:n]] = -1
    sp.reshape(-1, k)[rows[n:2 * n]] = np.round(sp.reshape(-1, k)[rows[n:2 * n]])
    sn.reshape(-1)[rows[2 * n:3 * n]] = sp.reshape(-1, k)[rows[2 * n:3 * n]].min(1)
    tid = rng.integers(1000, 2000, B).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)      # noqa: E731
    return t(sp), t(tp), t(sn), t(tid)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,E,k", [(1, 4, 2), (4, 16, 4), (8, 64, 6),
                                   (3, 40, 8)])
def test_cuda_go_topk_equals_plain_bit_for_bit(cuda_device, B, E, k):
    """K5 against its plain version at tests/test_kernels.py's four
    shapes, with an int and a [B] token id, functional and in place: every
    output is a copy or a comparison, so all four are equal."""
    sp, tp, sn, tid = _topk_inputs(B + E + k, B, E, k, cuda_device)
    for token_id in (1001, tid):
        before = GT.LAUNCHES["go_topk_update"]
        got = GT.go_topk_update(sp, tp, sn, token_id)
        s, t = sp.clone(), tp.clone()
        sel, slot = GT.go_topk_update_(s, t, sn, token_id)
        want = GT.go_topk_update_plain(sp, tp, sn, token_id)
        torch.cuda.synchronize()
        assert GT.LAUNCHES["go_topk_update"] == before + 2
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip((s, t, sel, slot), want):
            assert torch.equal(g, w)


@pytest.mark.requires_cuda
def test_cuda_go_topk_raises_instead_of_falling_back(cuda_device):
    sp, tp, sn, tid = _topk_inputs(0, 4, 16, 4, cuda_device)
    wide = torch.zeros(4, 16, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        GT.go_topk_update_(wide[..., :4], tp, sn, 3)
    with pytest.raises(TypeError, match="int32"):
        GT.go_topk_update_(sp.clone(), tp.long(), sn, 3)
    with pytest.raises(ValueError, match="operands on"):
        GT.go_topk_update(sp, tp, sn.cpu(), 3)
    with pytest.raises(ValueError, match="operands on"):
        GT.go_topk_update(sp, tp, sn, tid.cpu())


# K5R go_router: g within ROUTER_G_TOL of the plain version's (relative;
# the gate row sums in another order than cuBLAS), everything after g bit
# for bit against the plain TopKUpdate and lane plan on the kernel's own g
ROUTER_G_TOL = 1e-5


def _router_inputs(seed, B, E, k, d, device, xdt, wdt):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)      # noqa: E731
    x = t(rng.standard_normal((B, d)).astype(np.float32)).to(xdt)
    w = t((rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32))
    sp = (rng.random((B, E, k)) * 2.0 / E).astype(np.float32)
    sp.reshape(-1, k)[rng.permutation(B * E)[:max(1, B * E // 8)]] = -np.inf
    tp = rng.integers(0, 1000, (B, E, k)).astype(np.int32)
    tid = rng.integers(1000, 2000, B).astype(np.int32)
    return x, w.to(wdt), t(sp), t(tp), t(tid)


def _router_check(x, w, sp, tp, token_id, bn):
    """Launch K5R in place and functional; check g against the plain
    version's, the rest bit for bit on the kernel's own g; returns the
    in-place route and g's relative error."""
    before = GT.LAUNCHES["go_router"]
    s, t = sp.clone(), tp.clone()
    r = GT.go_router_(x, w, s, t, token_id, bn)
    s2, t2, r2 = GT.go_router(x, w, sp, tp, token_id, bn)
    _, _, rp = GT.go_router_plain(x, w, sp, tp, token_id, bn)
    torch.cuda.synchronize()
    assert GT.LAUNCHES["go_router"] == before + 2
    err = ((r.g - rp.g).abs() / rp.g).max().item()
    assert err <= ROUTER_G_TOL
    ws, wt, wsel, wslot = GT.go_topk_update_plain(sp, tp, r.g, token_id)
    plan = GT.go_lane_plan(wsel, r.g, bn)
    for got in ((s, t, r), (s2, t2, r2)):
        gs, gt_, gr = got
        assert torch.equal(gs, ws) and torch.equal(gt_, wt)
        assert torch.equal(gr.g, r.g)
        assert torch.equal(gr.selected, wsel) and torch.equal(gr.slot, wslot)
        for a, b in zip(gr.plan[:4], plan[:4]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    return r, err


@pytest.mark.requires_cuda
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,E,k,d", [(1, 4, 2, 16), (4, 16, 4, 32),
                                     (8, 64, 6, 24), (3, 40, 8, 40),
                                     (4, 8, 2, 64), (4, 16, 4, 4096),
                                     (64, 64, 4, 4096), (3, 40, 8, 1000)])
def test_cuda_go_router_two_step_check(cuda_device, B, E, k, d, xdt, wdt):
    """K5R at K5's four shapes, the llama smoke and full-width decode
    shapes, B and E at their bound of 64 over 128 CTAs of the gate row, a
    ragged last span: every dtype pair, g within ROUTER_G_TOL, the rest
    bit for bit; an int, an int32 and an int64 [B] token id; a repeat
    gives the same bits."""
    x, w, sp, tp, tid = _router_inputs(B + E + k + d, B, E, k, d,
                                       cuda_device, xdt, wdt)
    for token_id in (1001, tid, tid.long()):
        r, _ = _router_check(x, w, sp, tp, token_id, 64)
        s, t = sp.clone(), tp.clone()
        again = GT.go_router_(x, w, s, t, token_id, 64)
        for a, b in zip(again[:3], r[:3]):
            assert torch.equal(a, b)
        for a, b in zip(again.plan[:4], r.plan[:4]):
            assert torch.equal(a, b)
    assert bool(r.selected.any())


@pytest.mark.requires_cuda
def test_cuda_go_router_planted_near_tie(cuda_device):
    """Cached minima planted at the kernel's own g (>= selects) and one ulp
    above it (no selection), at llama's full-width shape in bf16: the
    selection follows the kernel's g, and everything after g equals the
    plain TopKUpdate and plan on that g."""
    B, E, k, d = 4, 16, 4, 4096
    x, w, sp, tp, tid = _router_inputs(3, B, E, k, d, cuda_device,
                                       torch.bfloat16, torch.float32)
    g = GT.go_router(x, w, sp, tp, tid, 64)[2].g
    tie = torch.zeros(B, E, dtype=torch.bool, device=cuda_device)
    tie[:, ::2] = True
    up = torch.nextafter(g, torch.full_like(g, float("inf")))
    sp = torch.where(tie, g, up)[..., None] + torch.tensor(
        [0.0, 0.5, 0.25, 0.125], device=cuda_device)
    r, _ = _router_check(x, w, sp.contiguous(), tp, tid, 64)
    assert torch.equal(r.selected, tie) and bool((r.slot[tie] == 0).all())


@pytest.mark.requires_cuda
def test_cuda_go_router_raises_instead_of_falling_back(cuda_device):
    x, w, sp, tp, tid = _router_inputs(0, 4, 16, 4, 32, cuda_device,
                                       torch.float32, torch.float32)
    z = lambda *s, **kw: torch.zeros(*s, device=cuda_device, **kw)  # noqa
    with pytest.raises(ValueError, match="must lie in 1..64"):
        GT.go_router_(z(65, 32), w, z(65, 16, 4), z(65, 16, 4,
                                                    dtype=torch.int32), 3, 64)
    with pytest.raises(ValueError, match="must lie in 1..64"):
        GT.go_router_(x, z(32, 65), z(4, 65, 4), z(4, 65, 4,
                                                   dtype=torch.int32), 3, 64)
    with pytest.raises(TypeError, match="no kernel for x"):
        GT.go_router_(x.half(), w, sp.clone(), tp.clone(), 3, 64)
    with pytest.raises(ValueError, match="contiguous"):
        GT.go_router_(x, w.T.contiguous().T, sp.clone(), tp.clone(), 3, 64)
    with pytest.raises(ValueError, match="contiguous"):
        GT.go_router_(x, w, z(4, 16, 8)[..., :4], tp.clone(), 3, 64)
    with pytest.raises(TypeError, match="want int32 or int64"):
        GT.go_router_(x, w, sp.clone(), tp.clone(), tid.short(), 64)
    with pytest.raises(ValueError, match="operands on"):
        GT.go_router_(x, w.cpu(), sp.clone(), tp.clone(), 3, 64)
    with pytest.raises(ValueError, match="operands on"):
        GT.go_router(x, w, sp, tp, tid.cpu(), 64)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,E,k", [(65, 16, 4), (96, 8, 2), (4, 72, 4)])
def test_cuda_go_cache_step_past_the_router_runs_k5(cuda_device, B, E, k):
    """go_cache_step past K5R's bound on the card: K5 in place once and
    K1/K2 once over a plan of several 64-row tiles a lane (B > 64), K5R
    never; against the same step on the CPU (plain versions): selected,
    scores and ids bit-equal to the CPU's TopKUpdate on the card's own g
    (the same ops on the card), g within the router's 1e-5 relative, y
    within 1e-4."""
    from repro_torch.core import go_cache as GO
    d, de = 128, 64
    x, w, sp, tp, tid = _router_inputs(B + E, B, E, k, d, cuda_device,
                                       torch.float32, torch.float32)
    rng = np.random.default_rng(B * E)
    bank = {n: torch.from_numpy((rng.standard_normal(s) / 8).astype(
        np.float32)).to(cuda_device)
        for n, s in (("wg", (E, d, de)), ("wi", (E, d, de)),
                     ("wo", (E, de, d)))}
    out = torch.zeros(B, E, k, d, device=cuda_device)

    def step(dev):
        cache = GO.GOCache(sp.to(dev).clone(), tp.to(dev).clone(),
                           out.to(dev).clone())
        tb = {n: a.to(dev) for n, a in bank.items()}
        res = GO.go_cache_step(
            cache, x.to(dev), tid.to(dev), w.to(dev),
            bn=OPS.default_block_rows(dev),
            contrib_fn=lambda xt, sel, g, plan: OPS.go_plan_ffn(xt, plan,
                                                                tb))
        return res, cache

    before = {**GT.LAUNCHES, **G.LAUNCHES}
    res, cache = step(cuda_device)
    torch.cuda.synchronize()
    after = {**GT.LAUNCHES, **G.LAUNCHES}
    assert {n: after[n] - before[n] for n in after} == {
        "go_topk_update": 1, "go_router": 0, "gmm_swiglu": 1,
        "gmm_scaled": 1, "gmm_swiglu_fused": 0, "gmm_scaled_fused": 0,
        "gmm": 0}
    g = torch.softmax(x @ w, dim=-1)
    s_ref, t_ref, sel_ref, _ = GT.go_topk_update_plain(
        sp.cpu(), tp.cpu(), g.cpu(), tid.cpu())
    assert torch.equal(res.selected.cpu(), sel_ref)
    assert torch.equal(cache.scores.cpu(), s_ref)
    assert torch.equal(cache.token_ids.cpu(), t_ref)
    cpu, _ = step("cpu")
    g_cpu = torch.softmax(x.cpu() @ w.cpu(), dim=-1)
    assert ((g.cpu() - g_cpu).abs() / g_cpu).max() <= 1e-5
    torch.testing.assert_close(res.y.cpu(), cpu.y, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N,K,F,E", [(128, 256, 128, 2), (128, 48, 96, 4),
                                     (64, 688, 172, 4)])
def test_cuda_gmm_matches_plain_and_k2_at_unit_scale(cuda_device, N, K, F, E):
    """K6 at three of tests/test_kernels.py's SWEEP shapes, re-tiled at the
    card's 64 rows, with an invalid tile: fp32 against its plain version at
    the reference's 2e-5; K6 shares K2's body, so its fp32 output equals
    K2's with row_scale = 1 bit for bit, and its bf16 output is that
    result rounded once."""
    bn = G.KERNEL_BLOCK_ROWS
    N = N + 40                                   # a ragged last tile
    x, wg, _, _, te, tv, _ = _inputs(N + K, N, K, F, E, bn, cuda_device)
    before = G.LAUNCHES["gmm"]
    y = G.gmm(x, wg, te, tv, bn=bn)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gmm"] == before + 1
    torch.testing.assert_close(y, G.gmm_plain(x, wg, te, tv, bn), rtol=2e-5,
                               atol=2e-5)
    one = torch.ones(N, 1, device=cuda_device)
    assert torch.equal(y, G.gmm_scaled(x, wg, te, tv, one, bn=bn))
    xb, wb = x.bfloat16(), wg.bfloat16()
    y2 = G.gmm_scaled(xb, wb, te, tv, one, bn=bn)
    assert torch.equal(G.gmm(xb, wb, te, tv, bn=bn), y2.bfloat16())
    assert torch.equal(G.gmm(xb, wb, te, tv, bn=bn, out_dtype=torch.float32),
                       y2)
    rows_invalid = (~tv).repeat_interleave(bn)[:N]
    assert bool((y[rows_invalid] == 0).all())


@pytest.mark.requires_cuda
def test_cuda_gmm_raises_instead_of_falling_back(cuda_device):
    x, wg, _, _, te, tv, _ = _inputs(1, 64, 16, 8, 2, 64, cuda_device)
    with pytest.raises(ValueError, match="tiles 64 rows"):
        G.gmm(x, wg, torch.zeros(8, dtype=torch.int32, device=cuda_device),
              bn=8)
    with pytest.raises(TypeError, match="no kernel for dtype"):
        G.gmm(x.half(), wg.half(), te, tv, bn=64)
    with pytest.raises(TypeError, match="no kernel writes"):
        G.gmm(x, wg, te, tv, bn=64, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="operands on"):
        G.gmm(x, wg.cpu(), te, tv, bn=64)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", [False, True])
def test_cuda_llama_decode_runs_k5_once_per_layer_and_step(cuda_device,
                                                            engine):
    """The smoke llama decode on the card: K5's router form (K5R) launched
    layers x decode steps and K5 alone never (static generate() and the
    engine), the tokens the CPU gives."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import generate, serve_continuous
    from repro_torch.models.model import model_init
    cfg = get_config("llama_moe_4_16", smoke=True)
    params = model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = _to(params, cuda_device)
    L = cfg.num_layers
    if engine:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                   for n in (6, 9, 4)]
        kw = dict(num_slots=2, max_tokens=32, arrival_steps=[0, 0, 2],
                  paged=True, page_size=4, num_pages=12, prefill_chunk=8)
        cpu = serve_continuous(params, cfg, prompts, 5, device="cpu", **kw)
        GT.reset_launches()
        gpu = serve_continuous(gpu_params, cfg, prompts, 5, device="cuda",
                               **kw)
        for rid, toks in cpu["tokens"].items():
            np.testing.assert_array_equal(gpu["tokens"][rid], toks)
        steps = gpu["stats"]["decode_ticks"]
    else:
        prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                                generator=torch.Generator().manual_seed(1))
        cpu = generate(params, cfg, prompts, 6, device="cpu")
        GT.reset_launches()
        gpu = generate(gpu_params, cfg, prompts.to(cuda_device), 6,
                       device="cuda")
        assert torch.equal(gpu["tokens"].cpu(), cpu["tokens"])
        steps = 6
    # the decode runs K5's router form (K5R): one launch per layer and step
    assert steps > 0 and GT.LAUNCHES["go_router"] == L * steps
    assert GT.LAUNCHES["go_topk_update"] == 0


# ------------------------------------- the bf16 bodies: K4 and the GEMM ring

def _chunk_inputs(seed, nkv, G_, hd, device, B=2, Cs=24, ps=16, P=5,
                  kv_len=57, poison=None):
    """bf16 pages for a chunk of Cs queries ending past kv_len (pad
    queries), and q for Hq = nkv * G_ heads."""
    kp, vp, bt, _, _ = _paged(seed, nkv, [kv_len] * B, device,
                              torch.bfloat16, ps=ps, P=P, hd=hd,
                              poison=poison)
    rng = np.random.default_rng(seed + 1)
    q = torch.from_numpy(rng.standard_normal(
        (B, Cs, nkv * G_, hd)).astype(np.float32)).to(device).bfloat16()
    return q, kp, vp, bt


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G_", [1, 3, 4, 16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_chunk_bf16_every_head_dim_and_group(cuda_device, hd, G_):
    """K4's bf16 body at every head_dim the wrapper takes and GQA 1/3/4/16
    (rows folded r = qi * G + g over 16-row warps, a ragged last warp),
    against its plain version on the real queries: 2e-2, as
    PAGED_TOL_BF16 (the plain path rounds q * scale to bf16, the kernel
    scales the fp32 product)."""
    assert hd in PA.KERNEL_HEAD_DIMS and G_ <= PA.KERNEL_MAX_GROUP
    start, kv_len = 37, 57
    q, kp, vp, bt = _chunk_inputs(hd + G_, 2, G_, hd, cuda_device,
                                  kv_len=kv_len)
    before = PA.LAUNCHES["paged_attn_chunk"]
    out = PA.paged_attn_chunk(q, kp, vp, bt, start, kv_len)
    ref = PA.paged_attn_chunk_plain(q, kp, vp, bt, start, kv_len)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["paged_attn_chunk"] == before + 1
    n = kv_len - start
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[:, :n], ref[:, :n], rtol=2e-2, atol=2e-2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G_", [1, 3])
@pytest.mark.parametrize("window,softcap,start", [(9, 0.0, 37), (0, 4.0, 37),
                                                  (20, 3.0, 0)])
def test_cuda_chunk_bf16_window_softcap(cuda_device, G_, window, softcap,
                                        start):
    """K4's bf16 body with a sliding window (tiles before the window are
    skipped), a softcap, and a chunk starting at 0, at head_dim 128:
    2e-2 against the plain version."""
    kv_len = start + 20
    q, kp, vp, bt = _chunk_inputs(5 + window, 2, G_, 128, cuda_device,
                                  kv_len=kv_len)
    out = PA.paged_attn_chunk(q, kp, vp, bt, start, kv_len, window=window,
                              softcap=softcap)
    ref = PA.paged_attn_chunk_plain(q, kp, vp, bt, start, kv_len,
                                    window=window, softcap=softcap)
    torch.testing.assert_close(out[:, :20], ref[:, :20], rtol=2e-2,
                               atol=2e-2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G_", [1, 3])
def test_cuda_chunk_bf16_poisoned_pages_change_no_bit(cuda_device, G_):
    """K4's bf16 body reads no position past kv_len: pages holding +-1e4
    there (and on the null page) give the same output bits as clean
    pages, pad queries included; two launches give the same bits."""
    start, kv_len = 37, 57
    clean = _chunk_inputs(21, 2, G_, 128, cuda_device, kv_len=kv_len,
                          poison=0.0)
    dirty = _chunk_inputs(21, 2, G_, 128, cuda_device, kv_len=kv_len,
                          poison=1e4)
    a = PA.paged_attn_chunk(*clean, start, kv_len)
    assert torch.equal(a, PA.paged_attn_chunk(*dirty, start, kv_len))
    assert torch.equal(a, PA.paged_attn_chunk(*clean, start, kv_len))


@pytest.mark.requires_cuda
def test_cuda_gemm_ring_bf16_is_deterministic(cuda_device):
    """Two launches of each kernel of the bf16 GEMM body (K1, K2, K6, K7,
    K8) on the same inputs give the same bits, at a ragged K = F = 688
    (the last ring stage zero-filled) with invalid tiles; and at a shape
    whose rows are not 16-byte multiples (F = 172: staged element by
    element) the kernels still match their plain versions."""
    bn = G.KERNEL_BLOCK_ROWS
    N, K, F, E = 300, 688, 688, 5
    x, wg, wi, wo, te, tv, scale = _inputs(13, N, K, F, E, bn, cuda_device)
    x, wg, wi, wo = (a.bfloat16() for a in (x, wg, wi, wo))
    plan = _fused_plan(14, cuda_device)
    xf, wg6, wi6, wo6, _, _, sf = _inputs(15, plan.n_pad, K, F, 6, bn,
                                          cuda_device)
    xf = (xf * plan.row_valid[:, None]).bfloat16()
    wg6, wi6, wo6 = (a.bfloat16() for a in (wg6, wi6, wo6))
    kw = dict(tile_expert2=plan.tile_expert2, row_sel=plan.row_sel)
    for fn in (lambda: G.gmm_swiglu(x, wg, wi, te, tv, bn=bn),
               lambda: G.gmm_scaled(x, wo, te, tv, scale, bn=bn),
               lambda: G.gmm(x, wo, te, tv, bn=bn),
               lambda: G.gmm_swiglu(xf, wg6, wi6, plan.tile_expert,
                                    plan.tile_valid, bn=bn, **kw),
               lambda: G.gmm_scaled(xf, wo6, plan.tile_expert,
                                    plan.tile_valid, sf, bn=bn, **kw)):
        assert torch.equal(fn(), fn())
    xs, ws = x[:, :48].contiguous(), wg[:, :48, :172].contiguous()
    wis = wi[:, :48, :172].contiguous()
    torch.testing.assert_close(
        G.gmm_swiglu(xs, ws, wis, te, tv, bn=bn).float(),
        G.gmm_swiglu_plain(xs, ws, wis, te, tv, bn).float(), rtol=1e-2,
        atol=1e-2)
    torch.testing.assert_close(
        G.gmm(xs, ws, te, tv, bn=bn, out_dtype=torch.float32),
        G.gmm_plain(xs, ws, te, tv, bn, torch.float32), rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_cuda_fused_bf16_equals_unfused_off_straddle_at_granite_width(
        cuda_device):
    """K7/K8 in bf16 at granite's full-width prefill plan (4 x 128 tokens,
    top-8 of 40, lanes fused pairwise): on every tile that straddles
    nothing they equal K1/K2 bit for bit (one body, one pass), and they
    match their plain versions (K7 1e-2, K8 1e-4)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import moe as MOE
    from repro_torch.core import routing as R
    from repro_torch.models import model as TM
    cfg = get_config("granite-moe-3b-a800m")
    e = cfg.moe
    bn, E, K, F, k, T = (G.KERNEL_BLOCK_ROWS, e.num_experts, cfg.d_model,
                         e.d_expert, e.top_k, 512)
    g = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    wg, wi = (torch.randn(E, K, F, device="cuda", generator=g).div_(
        K ** 0.5).to(bf) for _ in range(2))
    wo = torch.randn(E, F, K, device="cuda", generator=g).div_(F ** 0.5).to(bf)
    gate = torch.randn(K, E, device="cuda", generator=g) / K ** 0.5
    xt = torch.randn(T, K, device="cuda", generator=g).to(bf)
    r = R.token_choice(xt, gate, k)
    members = TM.expert_group_members(cfg, "cuda")
    lane_of_rank, rank_of_expert, fuse = MOE.group_lane_map(members,
                                                            e.group_size)
    plan = OPS.plan_tile_dispatch(rank_of_expert[r.expert_idx.reshape(-1)
                                                 .long()], E, bn, fuse=fuse)
    te = lane_of_rank[plan.tile_expert.long()].int()
    te2 = lane_of_rank[plan.tile_expert2.long()].int()
    tv, sel = plan.tile_valid, plan.row_sel
    tok = torch.arange(T, device="cuda").repeat_interleave(k)
    rp = plan.row_pair.long()
    x = torch.cat([xt, xt.new_zeros((1, K))])[
        torch.cat([tok, tok.new_full((1,), T)])[rp]]
    sc = torch.cat([r.weights.reshape(-1), r.weights.new_zeros(1)])[rp][:, None]
    kw = dict(tile_expert2=te2, row_sel=sel)
    strad = te2 != te
    assert bool((strad & tv).any())
    h = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn, **kw)
    y = G.gmm_scaled(h, wo, te, tv, sc, bn=bn, **kw)
    h1 = G.gmm_swiglu(x, wg, wi, te, tv, bn=bn)
    y1 = G.gmm_scaled(h, wo, te, tv, sc, bn=bn)
    rows = (~strad).repeat_interleave(bn)
    assert torch.equal(h[rows], h1[rows]) and torch.equal(y[rows], y1[rows])
    torch.testing.assert_close(
        h.float(), G.gmm_swiglu_fused_plain(x, wg, wi, te, te2, tv, sel,
                                            bn).float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(
        y, G.gmm_scaled_fused_plain(h, wo, te, te2, tv, sel, sc, bn),
        rtol=1e-4, atol=1e-4)


# ------------------------------------- K3 split-KV body, K9 cluster body

# the engine cell's last decode tick (chip_smoke.py paged_phase_full):
# positions of the four first requests, pages of 16, 32 pages a row
ENGINE_T = [64 + 31, 448 + 31, 128 + 31, 320 + 31]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,nkv,hd", [(32, 32, 128), (24, 8, 64)])
def test_cuda_decode_split_at_engine_shape(cuda_device, dtype, tol, hq, nkv,
                                           hd):
    """K3's split-KV body at the engine's decode shapes (llama 32/32 heads
    of 128, granite 24/8 of 64; 8 splits of 4 pages, rows reaching 2 to 8
    of them) against its plain version: fp32 at 2e-5 (the online softmax
    sums in another order), bf16 at 2e-2 (p rounded per split). NaN in
    every position no row may read (the tail of each row's last page, the
    pages past it, the null page) changes no output bit, and a second
    launch repeats every bit."""
    t = np.array(ENGINE_T, np.int32)
    kw = dict(ps=16, P=32, hq=hq, hd=hd)
    kp, vp, bt, _, _ = _paged(40, nkv, t + 1, cuda_device, dtype, poison=0.0,
                              **kw)
    dirty = _paged(40, nkv, t + 1, cuda_device, dtype, poison=np.nan, **kw)
    assert PA.decode_splits(32, 16) == (4, 8)
    g = torch.Generator(device="cuda").manual_seed(41)
    q = torch.randn(len(t), hq, hd, device="cuda", generator=g).to(dtype)
    tt = torch.from_numpy(t).to(cuda_device)
    before = PA.LAUNCHES["paged_attn_decode"]
    out = PA.paged_attn_decode(q, kp, vp, bt, tt)
    out_dirty = PA.paged_attn_decode(q, *dirty[:3], tt)
    again = PA.paged_attn_decode(q, kp, vp, bt, tt)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["paged_attn_decode"] == before + 3
    torch.testing.assert_close(out, PA.paged_attn_decode_plain(
        q, kp, vp, bt, tt), rtol=tol, atol=tol)
    assert torch.equal(out, out_dirty) and torch.equal(out, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G_,hd,ps", [(1, 128, 8), (3, 64, 16), (4, 128, 4),
                                      (16, 256, 32), (3, 16, 128)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 0.0), (70, 3.0)])
def test_cuda_decode_split_window_and_groups(cuda_device, dtype, tol, G_, hd,
                                             ps, window, softcap):
    """K3's split-KV body at GQA 1/3/4/16, head_dim 16 to 256, pages of 4
    to 128 (one to 16 pages a split; two tiles a warp at 128), t = 0 and
    positions on split edges, a window that leaves the first splits empty,
    a softcap; against its plain version at PAGED_TOL_F32 / _BF16."""
    t = np.array([0, 63, 64, 200, 255], np.int32)
    P = 256 // ps
    kp, vp, bt, _, _ = _paged(50 + G_, 2, t + 1, cuda_device, dtype, ps=ps,
                              P=P, hq=2 * G_, hd=hd, poison=0.0)
    g = torch.Generator(device="cuda").manual_seed(51)
    q = torch.randn(len(t), 2 * G_, hd, device="cuda", generator=g).to(dtype)
    tt = torch.from_numpy(t).to(cuda_device)
    out = PA.paged_attn_decode(q, kp, vp, bt, tt, window=window,
                               softcap=softcap)
    torch.testing.assert_close(out, PA.paged_attn_decode_plain(
        q, kp, vp, bt, tt, window=window, softcap=softcap), rtol=tol,
        atol=tol)


def _slstm_cl(SC, u, r, CL):
    """K9 through its C entry at a forced cluster size (0: the per-(head,
    batch row) body); the wrapper picks slstm_cluster's."""
    B, S, _ = u.shape
    _, H, hd, _ = r.shape
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    out = torch.empty(B, S, H * hd, device=u.device, dtype=u.dtype)
    rc = getattr(SC._lib(), f"slstm_seq_{names[u.dtype]}_{names[r.dtype]}")(
        u.data_ptr(), r.data_ptr(), out.data_ptr(), B, S, H, hd, CL,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"cudaError {rc}"
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,H,hd,r_dtype", [
    (3, 33, 4, 32, torch.float32), (2, 9, 2, 20, torch.float32),
    (5, 17, 2, 40, torch.bfloat16), (1, 6, 1, 8, torch.float32)])
def test_cuda_slstm_cluster_sizes_match_plain(cuda_device, B, S, H, hd,
                                              r_dtype):
    """K9's cluster body at every cluster size from 1 to 16, unit slices
    that do not divide evenly (hd 20, 40), CTAs that own no unit (hd 8 at
    CL 16), more than 4 batch rows (two passes), fp32 and bf16 r: 1e-5
    against the plain version (fp32 arithmetic, only the order of the
    recurrent sums differs), and CL 0, the other body, too."""
    from repro_torch.kernels import slstm_cell as SC
    u, r = _slstm_inputs(B, S, H, hd, cuda_device, r_dtype, seed=hd)
    ref = SC.slstm_seq_plain(u, r)
    for CL in (0, 1, 2, 4, 8, 16):
        torch.testing.assert_close(_slstm_cl(SC, u, r, CL), ref, rtol=1e-5,
                                   atol=1e-5, msg=f"CL={CL}")


@pytest.mark.requires_cuda
def test_cuda_slstm_full_width_runs_on_a_16_cta_cluster(cuda_device):
    """xlstm-1.3b's full-width sLSTM (4 x 128, 4 heads of 512, bf16 r)
    runs on a cluster of 16 CTAs with r resident in shared memory, within
    1e-4 of the plain version and bit-equal when launched again; fp32 r at
    hd 512 does not fit a CTA, keeps the per-(head, batch row) body and
    matches too."""
    from repro_torch.kernels import slstm_cell as SC
    B, S, H, hd = 4, 128, 4, 512
    assert SC.slstm_cluster(B, hd, 2) == 16
    assert SC.slstm_cluster(B, hd, 4) is None
    u, r = _slstm_inputs(B, S, H, hd, cuda_device, torch.bfloat16)
    h, h2 = SC.slstm_seq(u, r), SC.slstm_seq(u, r)
    torch.testing.assert_close(h, SC.slstm_seq_plain(u, r), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(h, h2) and torch.equal(h, _slstm_cl(SC, u, r, 16))
    u, r = _slstm_inputs(B, 16, H, hd, cuda_device, torch.float32)
    torch.testing.assert_close(SC.slstm_seq(u, r), SC.slstm_seq_plain(u, r),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------- int8 paged attention

from repro_torch.core import quant as Q  # noqa: E402


def _paged_int8(seed, nkv, live, device, ps=16, P=6, hq=4, hd=64):
    """An int8 pool built as the engine builds one: pages quantized against
    their own amax, then one token rewritten per live row through
    scatter_token (a larger value: its page's scale grows and the page
    rescales). Returns (k, v, k_scales, v_scales, bt, readable [NP, ps])
    with NaN in the scales of every page no row may read (the null page
    and the rows' unused pages) and +-127 at every unreadable position,
    and the same pool with those scales 0 and those positions 0."""
    kp, vp, bt, _, _ = _paged(seed, nkv, live, device, torch.float32, ps=ps,
                              P=P, hq=hq, hd=hd)
    k8, ks = Q.quantize_pages(kp)
    v8, vs = Q.quantize_pages(vp)
    rng = np.random.default_rng(seed + 100)
    B = len(live)
    rows = torch.arange(B, device=device)
    pos = torch.tensor([int(n) - 1 for n in live], device=device)
    page = bt[rows, pos // ps].long()
    for c, s in ((k8, ks), (v8, vs)):
        val = torch.from_numpy(3 * rng.standard_normal(
            (B, nkv, hd)).astype(np.float32)).to(device)
        Q.scatter_token(c, s, page, pos % ps, val)
    NP = kp.shape[0]
    readable = torch.zeros(NP, ps, dtype=torch.bool, device=device)
    for b in range(B):
        p = torch.arange(int(live[b]), device=device)
        readable[bt[b, p // ps].long(), p % ps] = True
    live_page = readable.any(dim=1)[:, None]
    sel = readable[:, :, None, None]
    clean = (torch.where(sel, k8, 0), torch.where(sel, v8, 0),
             torch.where(live_page, ks, 0), torch.where(live_page, vs, 0))
    dirty = (torch.where(sel, k8, 127).to(torch.int8),
             torch.where(sel, v8, -127).to(torch.int8),
             torch.where(live_page, ks, float("nan")),
             torch.where(live_page, vs, float("nan")))
    return clean, dirty, bt


@pytest.mark.requires_cuda
@pytest.mark.parametrize("qdtype,tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nkv,hq,hd", [(2, 8, 128), (2, 6, 64), (2, 2, 64)])
def test_cuda_paged_attn_int8_matches_plain(cuda_device, qdtype, tol, nkv,
                                            hq, hd):
    """K3 and K4 on int8 pages (q fp32: K3's split body and K4's fp32
    body; q bf16: K3 and K4's tensor-core body) against the plain versions
    (gather, then dequantize): fp32 sums in another order (2e-5, as the
    fp32 pages); bf16 rounds q * scale (chunk) and p * s_v (K4) to bf16
    (2e-2, as the bf16 pages). Pages whose scale grew, a partly filled last
    page, the null page; NaN scales and +-127 at every unreadable page and
    position move no output bit, and a second launch repeats every bit."""
    live = np.array([1, 17, 33, 64, 90], np.int32)
    (clean, dirty, bt) = _paged_int8(21, nkv, live, cuda_device, hq=hq,
                                     hd=hd)
    k8, v8, ks, vs = clean
    g = torch.Generator(device="cuda").manual_seed(22)
    tt = torch.from_numpy(live - 1).to(cuda_device)
    q = torch.randn(len(live), hq, hd, device="cuda", generator=g).to(qdtype)
    before = dict(PA.LAUNCHES)
    for window in (0, 20):
        out = PA.paged_attn_decode(q, k8, v8, bt, tt, window=window,
                                   k_scales=ks, v_scales=vs)
        ref = PA.paged_attn_decode_plain(q, k8, v8, bt, tt, window=window,
                                         k_scales=ks, v_scales=vs)
        torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
        assert torch.equal(out, PA.paged_attn_decode(
            q, dirty[0], dirty[1], bt, tt, window=window, k_scales=dirty[2],
            v_scales=dirty[3]))
        assert torch.equal(out, PA.paged_attn_decode(
            q, k8, v8, bt, tt, window=window, k_scales=ks, v_scales=vs))
    qc = torch.randn(len(live), 24, hq, hd, device="cuda",
                     generator=g).to(qdtype)
    for start, kv_len in ((0, 17), (40, 64), (66, 90)):
        n = kv_len - start
        kw = dict(window=0)
        out = PA.paged_attn_chunk(qc, k8, v8, bt, start, kv_len,
                                  k_scales=ks, v_scales=vs, **kw)
        ref = PA.paged_attn_chunk_plain(qc, k8, v8, bt, start, kv_len,
                                        k_scales=ks, v_scales=vs, **kw)
        # rows whose block table ends before kv_len read the null page:
        # compare the rows that own every page up to kv_len
        full = [b for b in range(len(live)) if live[b] >= kv_len]
        torch.testing.assert_close(out[full, :n], ref[full, :n], rtol=tol,
                                   atol=tol)
        again = PA.paged_attn_chunk(qc, k8, v8, bt, start, kv_len,
                                    k_scales=ks, v_scales=vs, **kw)
        assert torch.equal(out, again)
        dirt = PA.paged_attn_chunk(qc, dirty[0], dirty[1], bt, start, kv_len,
                                   k_scales=dirty[2], v_scales=dirty[3], **kw)
        assert torch.equal(out[full], dirt[full])
    torch.cuda.synchronize()
    assert PA.LAUNCHES["paged_attn_decode_int8"] == \
        before["paged_attn_decode_int8"] + 6
    assert PA.LAUNCHES["paged_attn_chunk_int8"] == \
        before["paged_attn_chunk_int8"] + 9
    assert PA.LAUNCHES["paged_attn_decode"] == before["paged_attn_decode"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attn_int8_live_nan_scale_propagates(cuda_device, qdtype):
    """A NaN in a LIVE page's K scale (the quarantine's poison) makes the
    reading row's output NaN, as the plain versions (and the reference)
    give it, and moves no bit of the other rows: K3, and K4 on the fp32
    and tensor-core bodies."""
    live = np.array([17, 33, 64], np.int32)
    (k8, v8, ks, vs), _, bt = _paged_int8(24, 2, live, cuda_device, hq=8,
                                          hd=128)
    g = torch.Generator(device="cuda").manual_seed(25)
    tt = torch.from_numpy(live - 1).to(cuda_device)
    q = torch.randn(3, 8, 128, device="cuda", generator=g).to(qdtype)
    clean = PA.paged_attn_decode(q, k8, v8, bt, tt, k_scales=ks, v_scales=vs)
    ks_nan = ks.clone()
    ks_nan[int(bt[1, (live[1] - 1) // 16])] = float("nan")
    out = PA.paged_attn_decode(q, k8, v8, bt, tt, k_scales=ks_nan,
                               v_scales=vs)
    ref = PA.paged_attn_decode_plain(q, k8, v8, bt, tt, k_scales=ks_nan,
                                     v_scales=vs)
    assert bool(torch.isnan(out[1]).all() and torch.isnan(ref[1]).all())
    assert torch.equal(out[[0, 2]], clean[[0, 2]])
    qc = torch.randn(3, 24, 8, 128, device="cuda", generator=g).to(qdtype)
    ks_nan = ks.clone()
    ks_nan[int(bt[2, 0])] = float("nan")       # row 2's first page
    kw = dict(window=0, v_scales=vs)
    out = PA.paged_attn_chunk(qc, k8, v8, bt, 40, 64, k_scales=ks_nan, **kw)
    ref = PA.paged_attn_chunk_plain(qc, k8, v8, bt, 40, 64, k_scales=ks_nan,
                                    **kw)
    assert bool(torch.isnan(out[2]).all() and torch.isnan(ref[2]).all())


@pytest.mark.requires_cuda
def test_cuda_paged_attn_int8_raises_instead_of_falling_back(cuda_device):
    (k8, v8, ks, vs), _, bt = _paged_int8(23, 2, [9], cuda_device, hd=24)
    t = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    q = torch.zeros(1, 4, 24, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        PA.paged_attn_decode(q, k8, v8, bt, t, k_scales=ks, v_scales=vs)
    with pytest.raises(ValueError, match="both"):
        PA.paged_attn_decode(q, k8, v8, bt, t, k_scales=ks)
    with pytest.raises(TypeError, match="scales"):
        PA.paged_attn_chunk(q[:, None], k8, v8, bt, 0, 9,
                            k_scales=ks.double(), v_scales=vs)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["llama_moe_4_16", "granite-moe-3b-a800m"])
def test_cuda_int8_engine_streams_equal_cpu(cuda_device, arch):
    """The smoke engine on an int8 paged pool (pages of 8) with chunked
    prefill: the card (K3/K4 on int8 pages) streams what the CPU (plain
    versions) streams, and launches only the int8 paged kernels."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models.model import model_init
    cfg = get_config(arch, smoke=True)
    params = model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 20, 8, 11, 3)]
    kw = dict(num_slots=2, max_tokens=32, arrival_steps=[0, 0, 1, 4, 6],
              paged=True, page_size=8, num_pages=7, prefill_chunk=8,
              kv_quant="int8")
    cpu = serve_continuous(params, cfg, prompts, 7, device="cpu", **kw)
    before = dict(PA.LAUNCHES)
    gpu = serve_continuous(_to(params, cuda_device), cfg, prompts, 7,
                           device="cuda", **kw)
    for rid, toks in cpu["tokens"].items():
        np.testing.assert_array_equal(gpu["tokens"][rid], toks)
    L, s = cfg.num_layers, gpu["stats"]
    got = {k: PA.LAUNCHES[k] - before[k] for k in PA.LAUNCHES}
    assert got == {"paged_attn_decode": 0, "paged_attn_chunk": 0,
                   "paged_attn_decode_int8": L * s["decode_ticks"],
                   "paged_attn_chunk_int8": L * s["chunk_ticks"]}


def _paged_every_byte(seed, nkv, live, device, unit, ps=16, P=6, hq=4,
                      hd=64):
    """int8 pages whose readable positions hold every byte from -128 to 127
    (a shuffled cycle of them), with unit scales or scales in [0.5, 1] /
    128 per (page, kv head). Returns (clean, dirty, bt) as _paged_int8:
    dirty holds NaN in the scales of every page no row may read and +-127
    at every unreadable position."""
    _, _, bt, _, _ = _paged(seed, nkv, live, device, torch.float32, ps=ps,
                            P=P, hq=hq, hd=hd)
    g = torch.Generator().manual_seed(seed)
    B = len(live)
    NP = B * P + 2                  # as _paged
    n = NP * ps * nkv * hd
    vals = [(torch.arange(n) % 256 - 128)[torch.randperm(n, generator=g)]
            .to(torch.int8).reshape(NP, ps, nkv, hd).to(device)
            for _ in range(2)]
    scales = [torch.ones(NP, nkv) if unit else
              (0.5 + 0.5 * torch.rand(NP, nkv, generator=g)) / 128
              for _ in range(2)]
    readable = torch.zeros(NP, ps, dtype=torch.bool, device=device)
    for b in range(B):
        p = torch.arange(int(live[b]), device=device)
        readable[bt[b, p // ps].long(), p % ps] = True
    sel, used = readable[:, :, None, None], readable.any(dim=1)[:, None]
    clean = [torch.where(sel, x, 0).to(torch.int8) for x in vals] + \
        [torch.where(used, s.to(device), 0.0) for s in scales]
    dirty = [torch.where(sel, x, c).to(torch.int8)
             for x, c in zip(vals, (127, -127))] + \
        [torch.where(used, s.to(device), float("nan")) for s in scales]
    for x in clean[:2]:
        assert torch.unique(x[readable]).numel() == 256
    return clean, dirty, bt


@pytest.mark.requires_cuda
@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("qdtype,tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nkv,hq,hd", [(2, 8, 128), (2, 6, 64)])
def test_cuda_paged_attn_int8_every_byte(cuda_device, unit, qdtype, tol,
                                         nkv, hq, hd):
    """K3 and K4 on int8 pages that hold every byte from -128 to 127 (the
    bodies' dequantization without conversion instructions). Scales in
    [0.5, 1] / 128 keep the values near 1: against the plain versions at
    the tolerances of test_cuda_paged_attn_int8_matches_plain. Unit scales
    leave the values at +-128, where those tolerances would not cover
    the fp32 sums' rounding, so the check is exact: bit for bit the same
    kernel on pages of q's dtype that hold the same integers (every int8
    value is exact in fp32 and bf16, the bodies keep one order and a unit
    scale multiplies exactly); K3 with bf16 q, whose bf16-page body rounds
    p to bf16 and whose int8 body does not, against the plain version at
    its tolerance. A second launch repeats every bit, and NaN scales on
    dead and null pages and +-127 at unreadable positions move no bit."""
    live = np.array([1, 17, 33, 64, 90], np.int32)
    clean, dirty, bt = _paged_every_byte(31, nkv, live, cuda_device, unit,
                                         hq=hq, hd=hd)
    k8, v8, ks, vs = clean
    kf, vf = k8.to(qdtype), v8.to(qdtype)
    g = torch.Generator(device="cuda").manual_seed(32)
    tt = torch.from_numpy(live - 1).to(cuda_device)
    q = torch.randn(len(live), hq, hd, device="cuda", generator=g)
    q = (q / 64 if unit else q).to(qdtype)
    qc = torch.randn(len(live), 24, hq, hd, device="cuda", generator=g)
    qc = (qc / 64 if unit else qc).to(qdtype)
    calls = [(PA.paged_attn_decode, PA.paged_attn_decode_plain, q, (tt,),
              [slice(None)], w) for w in (0, 20)]
    calls += [(PA.paged_attn_chunk, PA.paged_attn_chunk_plain, qc,
               (start, kv_len),
               # rows that own every page up to kv_len, real queries
               [[b for b in range(len(live)) if live[b] >= kv_len],
                slice(0, kv_len - start)], 0)
              for start, kv_len in ((0, 17), (40, 64), (66, 90))]
    for kern, plain, qq, pos, rows, window in calls:
        out = kern(qq, k8, v8, bt, *pos, window=window, k_scales=ks,
                   v_scales=vs)
        assert torch.equal(out, kern(qq, k8, v8, bt, *pos, window=window,
                                     k_scales=ks, v_scales=vs))
        dirt = kern(qq, dirty[0], dirty[1], bt, *pos, window=window,
                    k_scales=dirty[2], v_scales=dirty[3])
        assert torch.equal(out[rows[0]], dirt[rows[0]])
        out = out[tuple(rows)]
        if unit and not (kern is PA.paged_attn_decode and
                         qdtype == torch.bfloat16):
            same = kern(qq, kf, vf, bt, *pos, window=window)[tuple(rows)]
            assert torch.equal(out, same)
        else:
            ref = plain(qq, k8, v8, bt, *pos, window=window, k_scales=ks,
                        v_scales=vs)[tuple(rows)]
            torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


# ------------------------------------------------- the engine's fault domain

def _smoke_engine(dtype="float32"):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import model_init
    cfg = get_config("llama_moe_4_16", smoke=True).with_overrides(dtype=dtype)
    return cfg, model_init(cfg, torch.Generator().manual_seed(5), "cpu")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,kv_quant", [("bfloat16", "none"),
                                            ("float32", "int8")])
def test_cuda_preemption_resumes_bit_equal(cuda_device, dtype, kv_quant):
    """The page-pressure trace on the card (K1-K4 and K5R; bf16 pages, or
    int8 pages and scales): a low-priority stream is evicted, snapshotted
    to the host and restored into other physical pages, and every stream
    equals the same trace on a pool that never evicts and each request
    alone on a 1-slot engine, bit for bit."""
    from repro_torch.serving import ServingEngine
    cfg, params = _smoke_engine(dtype)
    params = _to(params, cuda_device)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=8, dtype=np.int32)
               for _ in range(3)]
    trace = list(zip(prompts, (24, 24, 8), (5, 5, 0), (0, 0, 6)))
    kw = dict(max_tokens=48, paged=True, page_size=8, kv_quant=kv_quant)

    def run(**more):
        eng = ServingEngine(params, cfg, device="cuda", **kw, **more)
        eng.audit_every_tick = True
        rids = [eng.submit(p, g, priority=pr, arrival_step=a)
                for p, g, pr, a in trace]
        fin = eng.run()
        return eng, [fin[r].tokens for r in rids]

    eng, got = run(num_slots=3, num_pages=9, preemption=True)
    _, roomy = run(num_slots=3)
    s = eng.stats()
    assert s["preemptions"] >= 1 and s["resumes"] == s["preemptions"]
    assert got == roomy
    for (p, g, _, _), toks in zip(trace, got):
        solo = ServingEngine(params, cfg, device="cuda", num_slots=1, **kw)
        rid = solo.submit(p, g)
        assert solo.run()[rid].tokens == toks
    assert eng.pool.alloc.pages_in_use == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_cuda_quarantine_and_scrubbed_page_reuse(cuda_device, kv_quant):
    """A poisoned slot on the card retires FAILED with a prefix of its
    clean stream while its cohabitant streams on; a request admitted right
    after maps the scrubbed pages. The card and the CPU (whose plain
    attention gathers every page) give the same streams, and the reused
    pages give a fresh pool's stream."""
    from repro_torch.serving import ServingEngine
    cfg, params = _smoke_engine()
    rng = np.random.default_rng(28)
    p0, p1, p2 = (rng.integers(0, cfg.vocab_size, size=12, dtype=np.int32)
                  for _ in range(3))
    kw = dict(num_slots=2, max_tokens=48, paged=True, page_size=8,
              kv_quant=kv_quant)

    def run(dev, prm):
        eng = ServingEngine(prm, cfg, device=dev, **kw)
        eng.audit_every_tick = True
        r0, r1 = eng.submit(p0, 16), eng.submit(p1, 16)
        eng.step()                       # both admitted, r0 in slot 0
        while len(eng.pool.owner[0].tokens) < 4:
            eng.step()
        poisoned = set(eng.pool.alloc.owned(r0))
        eng.pool.poison_slot(0)
        eng.step()
        r2 = eng.submit(p2, 12)
        eng.step()
        reused = poisoned & set(eng.pool.block_table[0].tolist())
        fin = eng.run()
        fresh = ServingEngine(prm, cfg, device=dev, **kw)
        rf = fresh.submit(p2, 12)
        return ([fin[r].tokens for r in (r0, r1, r2)],
                [fin[r].status.value for r in (r0, r1, r2)], reused,
                fresh.run()[rf].tokens)

    card = run("cuda", _to(params, cuda_device))
    cpu = run("cpu", params)
    toks, statuses, reused, fresh = card
    assert statuses == ["FAILED", "DONE", "DONE"]
    assert 4 <= len(toks[0]) < 16 and reused
    assert toks[2] == fresh
    assert card == cpu


@pytest.mark.requires_cuda
def test_cuda_int8_scatter_keeps_a_nan_scale(cuda_device):
    """A page whose scale is NaN (the quarantine's poison) keeps it
    through a token write on the card, as on the CPU and under the
    reference's scatter max (CUDA's atomic max alone drops it); finite
    pages are written bit for bit as on the CPU."""
    g = torch.Generator().manual_seed(3)
    cache = torch.randint(-127, 128, (6, 8, 2, 64), generator=g,
                          dtype=torch.int8)
    scales = torch.rand(6, 2, generator=g) * 0.05
    scales[2, 1] = float("nan")
    page, off = torch.tensor([2, 4, 0, 0]), torch.tensor([3, 5, 1, 1])
    val = torch.randn(4, 2, 64, generator=g)
    cpu = Q.scatter_token(cache.clone(), scales.clone(), page, off, val)
    card = Q.scatter_token(*(t.to(cuda_device) for t in
                             (cache, scales, page, off, val)))
    assert torch.isnan(card[1][2, 1]) and torch.isnan(cpu[1][2, 1])
    keep = torch.ones(6, dtype=torch.bool)
    keep[0] = False                          # the null page: duplicate rows
    torch.testing.assert_close(card[1].cpu()[keep], cpu[1][keep],
                               rtol=0, atol=0, equal_nan=True)
    assert torch.equal(card[0].cpu()[4], cpu[0][4])
