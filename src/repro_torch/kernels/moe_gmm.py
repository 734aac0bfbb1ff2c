"""Grouped expert GEMMs (K1 `gmm_swiglu`, K2 `gmm_scaled`, their fused
forms K7 and K8, and the plain K6 `gmm`): wrappers, plain versions and
launch counters.

Rows arrive packed by expert in row tiles of `bn` rows; tile t uses expert
`tile_expert[t]`, and a tile with `tile_valid[t] == 0` contributes zeros.

  gmm_swiglu(x, wg, wi, te, tv)      h[i] = silu(x[i] @ wg[e]) * (x[i] @ wi[e])
  gmm_scaled(x, w, te, tv, scale)    y[i] = (x[i] @ w[e]) * scale[i]   (fp32)
  gmm(x, w, te, tv)                  y[i] = x[i] @ w[e]   (x.dtype or out_dtype)

With `tile_expert2=` and `row_sel=` (a fused lane pair's plan) the same
wrappers run K7 and K8: on a straddle tile (te2[t] != te[t]) row i uses
expert te[t] where row_sel[i] > 0.5 and te2[t] otherwise; on every other
tile all rows use te[t], as in K1/K2.

Each wrapper dispatches on where its tensors lie: on the CPU it runs the plain
PyTorch version; on a CUDA device it launches the hand-written kernel of
`csrc/moe_gmm.cu` or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

KERNEL_BLOCK_ROWS = 64          # the CUDA kernels' row tile (csrc BM)
# the bf16 body's ring (csrc GEMM_BK, BN, GEMM_LDX/LDW, GEMM_RING_BYTES)
GEMM_BK = 64                    # reduction depth per ring stage
GEMM_BN = 64                    # output columns per block
GEMM_ROW_PAD = 8                # elements that pad each staged row
GEMM_RING_BYTES = 113 * 1024    # a block's ring: two blocks share an SM
GEMM_DEEP_RING = 6              # stages of a grid of few blocks
H100_SMS = 132

# Launch counts, one per wrapper: raised by one at each kernel launch and
# nowhere else (the plain versions do not count).
LAUNCHES = {"gmm_swiglu": 0, "gmm_scaled": 0, "gmm_swiglu_fused": 0,
            "gmm_scaled_fused": 0, "gmm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _row_tiles(N: int, bn: int, tile_expert: torch.Tensor,
               tile_valid: torch.Tensor | None):
    """Validate the (tile_expert, tile_valid) map against ceil(N/bn) row
    tiles. A short map was built with another bn; extending it would zero
    real rows, so it raises. A longer map is fine (its tail is unused)."""
    ni = -(-N // bn)
    if tile_expert.shape[0] < ni:
        raise ValueError(
            f"tile_expert covers {tile_expert.shape[0]} tiles but x has "
            f"{N} rows at bn={bn} ({ni} tiles) — tile map built with a "
            "different bn, or rows not padded to the tile boundary?")
    te = tile_expert[:ni].to(torch.int32)
    tv = (torch.ones_like(te) if tile_valid is None
          else tile_valid[:ni].to(torch.int32))
    return ni, te, tv


def ring_launch(N: int, K: int, F: int, E: int, *,
                swiglu: bool = False) -> tuple[int, int]:
    """(tiles_per_block, ring_depth) of the bf16 body for x [N, K] and
    weights [E, K, F] (csrc `gmm_tc`); the wrapper passes both to the
    kernel on every launch, so this is arithmetic only. A block owns one or
    two planner tiles of KERNEL_BLOCK_ROWS rows and a stripe of GEMM_BN
    columns: two where the experts average at least two tiles each
    (N >= 2 * E tiles, a prefill) and the grid still gives every SM a
    block, so one weight stage feeds two tiles of one expert; else one (a
    decode: one tile per expert, where pairs would halve the blocks for
    nothing). The ring is GEMM_DEEP_RING deep for single tiles on a grid of
    at most two blocks per SM (a decode, where about one block per SM has
    a valid tile: it keeps five stages in flight alone), else 4 stages, or
    3 where 4 would not fit GEMM_RING_BYTES (two blocks share an SM).
    Shapes only: the choice never waits on the device."""
    bm = KERNEL_BLOCK_ROWS
    ni, stripes = -(-N // bm), -(-F // GEMM_BN)
    tm = 2 if ni >= 2 * E and -(-ni // 2) * stripes >= H100_SMS else 1
    if tm == 1 and ni * stripes <= 2 * H100_SMS:
        return tm, GEMM_DEEP_RING
    ld = GEMM_BK + GEMM_ROW_PAD            # = GEMM_BN + GEMM_ROW_PAD
    stage_bytes = 2 * (bm * tm * ld + (2 if swiglu else 1) * GEMM_BK * ld)
    return tm, 4 if 4 * stage_bytes <= GEMM_RING_BYTES else 3


def gemm_ring(N: int, K: int, F: int, E: int, *, swiglu: bool = False,
              straddle: bool = False) -> dict:
    """The bf16 body's launch and ragged edges for x [N, K] and weights
    [E, K, F]: `ring_launch`'s tiles per block and ring depth, the grid,
    and `k_stages` stages of GEMM_BK per block (per pass: a straddle tile,
    or a pair of two experts, runs one pass per expert). Every stage moves
    16-byte chunks of 8 elements, each copied or zero-filled by cp.async
    (src-size 0) when `vec` (K and F multiples of 8, so no chunk is cut by
    an edge), else staged element by element. Zero-filled, in the edge
    blocks: `x_zero`, the chunk columns of the last stage at or past K;
    `w_zero_rows`, its rows at or past K; `w_zero_cols`, the chunk columns
    of the last stripe at or past F; `pad_rows`, the rows of the last row
    tile at or past N (and, per pass, the rows of another expert:
    row_sel and tile_expert, not shape). `ring_chunk_live` is the
    per-chunk rule."""
    bm = KERNEL_BLOCK_ROWS
    ni, stripes, nk = -(-N // bm), -(-F // GEMM_BN), -(-K // GEMM_BK)
    tm, depth = ring_launch(N, K, F, E, swiglu=swiglu)
    k_last = (nk - 1) * GEMM_BK
    f_last = (stripes - 1) * GEMM_BN
    r_last = (ni - 1) * bm
    return {
        "tiles_per_block": tm,
        "grid": (stripes, -(-ni // tm)),
        "ring_depth": depth,
        "k_stages": nk * (2 if straddle else 1),
        "vec": K % 8 == 0 and F % 8 == 0,
        "x_zero": [c for c in range(GEMM_BK // 8)
                   if not ring_chunk_live(0, k_last + 8 * c, 1, K)],
        "w_zero_rows": [r for r in range(GEMM_BK)
                        if not ring_chunk_live(k_last + r, 0, K, 1)],
        "w_zero_cols": [c for c in range(GEMM_BN // 8)
                        if not ring_chunk_live(0, f_last + 8 * c, 1, F)],
        "pad_rows": [r for r in range(bm) if r_last + r >= N],
    }


def ring_chunk_live(row: int, col: int, nrows: int, ncols: int) -> bool:
    """Whether the ring copies the chunk at (row, col..col+7) of a matrix
    with nrows x ncols valid elements (csrc `stage_chunk`, vec case); a
    chunk that is not live is zero-filled."""
    return row < nrows and col < ncols


# ------------------------------------------------------------ plain versions

def _tiled(x: torch.Tensor, ni: int, bn: int) -> torch.Tensor:
    """x [N, K] -> fp32 [ni, bn, K], zero rows past N."""
    xp = F.pad(x.float(), (0, 0, 0, ni * bn - x.shape[0]))
    return xp.reshape(ni, bn, x.shape[1])


def gmm_swiglu_plain(x, wg, wi, te, tv, bn: int) -> torch.Tensor:
    """Reference arithmetic of K1 (repro/kernels/ref.py:gmm_swiglu_ref plus
    the zero rows of invalid tiles): fp32 products, output in x.dtype."""
    N = x.shape[0]
    ni = te.shape[0]
    xt = _tiled(x, ni, bn)
    g = torch.bmm(xt, wg[te.long()].float())
    u = torch.bmm(xt, wi[te.long()].float())
    h = torch.where(tv.bool()[:, None, None], F.silu(g) * u, 0.0)
    return h.reshape(ni * bn, -1)[:N].to(x.dtype)


def gmm_scaled_plain(x, w, te, tv, row_scale, bn: int) -> torch.Tensor:
    """Reference arithmetic of K2 (ref.py:gmm_scaled_ref plus invalid-tile
    zeros): the fp32 product times the fp32 row scale."""
    N = x.shape[0]
    ni = te.shape[0]
    y = torch.bmm(_tiled(x, ni, bn), w[te.long()].float())
    y = y.reshape(ni * bn, -1)[:N] * row_scale.reshape(N, 1).float()
    valid_rows = tv.bool().repeat_interleave(bn)[:N]
    return torch.where(valid_rows[:, None], y, 0.0)


def gmm_plain(x, w, te, tv, bn: int, out_dtype=None) -> torch.Tensor:
    """Reference arithmetic of K6 (ref.py:gmm_ref plus invalid-tile
    zeros): the fp32 product, rounded once to out_dtype or x.dtype."""
    N = x.shape[0]
    ni = te.shape[0]
    y = torch.bmm(_tiled(x, ni, bn), w[te.long()].float())
    valid_rows = tv.bool().repeat_interleave(bn)[:N]
    y = torch.where(valid_rows[:, None], y.reshape(ni * bn, -1)[:N], 0.0)
    return y.to(out_dtype or x.dtype)


def _fused_bmm(x, w, te, te2, row_sel, bn: int) -> torch.Tensor:
    """fp32 [ni, bn, F]: every tile's rows times its expert te[t]'s weights,
    except a straddle tile's (te2[t] != te[t]) rows with row_sel <= 0.5,
    which take te2[t]'s: the reference's two masked products, x*sel and
    x*(1-sel), as a per-row choice."""
    N = x.shape[0]
    ni = te.shape[0]
    xt = _tiled(x, ni, bn)
    sel = F.pad(row_sel.reshape(N).float(), (0, ni * bn - N)).reshape(ni, bn)
    second = ((te2 != te)[:, None] & (sel <= 0.5))[..., None]
    return torch.where(second, torch.bmm(xt, w[te2.long()].float()),
                       torch.bmm(xt, w[te.long()].float()))


def gmm_swiglu_fused_plain(x, wg, wi, te, te2, tv, row_sel,
                           bn: int) -> torch.Tensor:
    """Reference arithmetic of K7: K1's with a per-row expert on straddle
    tiles; output in x.dtype."""
    N = x.shape[0]
    g = _fused_bmm(x, wg, te, te2, row_sel, bn)
    u = _fused_bmm(x, wi, te, te2, row_sel, bn)
    h = torch.where(tv.bool()[:, None, None], F.silu(g) * u, 0.0)
    return h.reshape(-1, h.shape[-1])[:N].to(x.dtype)


def gmm_scaled_fused_plain(x, w, te, te2, tv, row_sel, row_scale,
                           bn: int) -> torch.Tensor:
    """Reference arithmetic of K8: K2's with K7's per-row expert choice."""
    N = x.shape[0]
    y = _fused_bmm(x, w, te, te2, row_sel, bn)
    y = y.reshape(-1, y.shape[-1])[:N] * row_scale.reshape(N, 1).float()
    valid_rows = tv.bool().repeat_interleave(bn)[:N]
    return torch.where(valid_rows[:, None], y, 0.0)


# ------------------------------------------------------------------ wrappers

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_cuda(name: str, bn: int, x: torch.Tensor, *tensors) -> str:
    """Validate the kernel's operands; return its dtype suffix."""
    if bn != KERNEL_BLOCK_ROWS:
        raise ValueError(f"{name}: the CUDA kernel tiles {KERNEL_BLOCK_ROWS} "
                         f"rows, got bn={bn}")
    suffix = _KERNEL_DTYPES.get(x.dtype)
    if suffix is None:
        raise TypeError(f"{name}: no kernel for dtype {x.dtype}")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return suffix


def _lib():
    lib = build.load("moe_gmm")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        for dt in _KERNEL_DTYPES.values():
            f = getattr(lib, f"gmm_swiglu_{dt}")
            f.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
            f.restype = I
            f = getattr(lib, f"gmm_scaled_{dt}")
            f.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
            f.restype = I
            f = getattr(lib, f"gmm_swiglu_fused_{dt}")
            f.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
            f.restype = I
            f = getattr(lib, f"gmm_scaled_fused_{dt}")
            f.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
            f.restype = I
        for fn in ("gmm_f32", "gmm_bf16", "gmm_bf16_out_f32"):
            f = getattr(lib, fn)
            f.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
            f.restype = I
        lib._typed = True
    return lib


def _where(x: torch.Tensor) -> str:
    if x.device.type == "cpu":
        return "cpu"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no grouped-GEMM path for device {x.device}")


def _ring_args(x: torch.Tensor, N: int, K: int, F: int, E: int,
               swiglu: bool) -> tuple[int, int]:
    """The kernel's (planner tiles per block, ring depth): ring_launch's
    choice in bf16; (1, 1) in fp32, whose body has no ring."""
    if x.dtype != torch.bfloat16:
        return 1, 1
    return ring_launch(N, K, F, E, swiglu=swiglu)


def _fused_operands(N: int, ni: int, tile_expert2, row_sel):
    """The fused plan's te2 [ni] int32 and row_sel [N] fp32, or None for
    the unfused kernels."""
    if (tile_expert2 is None) != (row_sel is None):
        raise ValueError("tile_expert2 and row_sel come together")
    if tile_expert2 is None:
        return None, None
    if tile_expert2.shape[0] < ni or row_sel.numel() != N:
        raise ValueError(f"tile_expert2 {tuple(tile_expert2.shape)} / "
                         f"row_sel {tuple(row_sel.shape)} do not cover "
                         f"{ni} tiles of {N} rows")
    return (tile_expert2[:ni].to(torch.int32),
            row_sel.reshape(N).to(torch.float32).contiguous())


def gmm_swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
               tile_expert: torch.Tensor,
               tile_valid: torch.Tensor | None = None, *,
               tile_expert2: torch.Tensor | None = None,
               row_sel: torch.Tensor | None = None,
               bn: int) -> torch.Tensor:
    """K1, or K7 with `tile_expert2`/`row_sel`. x [N, K], wg/wi [E, K, F]
    -> [N, F] in x.dtype."""
    N, K = x.shape
    E, K2, Fd = wg.shape
    if K2 != K or wi.shape != wg.shape:
        raise ValueError(f"gmm_swiglu: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wi {tuple(wi.shape)}")
    ni, te, tv = _row_tiles(N, bn, tile_expert, tile_valid)
    te2, sel = _fused_operands(N, ni, tile_expert2, row_sel)
    fused = te2 is not None
    if _where(x) == "cpu":
        if fused:
            return gmm_swiglu_fused_plain(x, wg, wi, te, te2, tv, sel, bn)
        return gmm_swiglu_plain(x, wg, wi, te, tv, bn)
    name = "gmm_swiglu_fused" if fused else "gmm_swiglu"
    dt = _check_cuda(name, bn, x, wg, wi, te, tv,
                     *((te2, sel) if fused else ()))
    if wg.dtype != x.dtype or wi.dtype != x.dtype:
        raise TypeError(f"{name}: x, wg and wi must share a dtype")
    out = torch.empty((N, Fd), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(_lib(), f"{name}_{dt}")
    ring = _ring_args(x, N, K, Fd, E, True)
    if fused:
        rc = fn(x.data_ptr(), wg.data_ptr(), wi.data_ptr(), te.data_ptr(),
                te2.data_ptr(), tv.data_ptr(), sel.data_ptr(),
                out.data_ptr(), N, K, Fd, bn, *ring, stream)
    else:
        rc = fn(x.data_ptr(), wg.data_ptr(), wi.data_ptr(), te.data_ptr(),
                tv.data_ptr(), out.data_ptr(), N, K, Fd, bn, *ring, stream)
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def gmm_scaled(x: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
               tile_valid: torch.Tensor | None, row_scale: torch.Tensor, *,
               tile_expert2: torch.Tensor | None = None,
               row_sel: torch.Tensor | None = None,
               bn: int) -> torch.Tensor:
    """K2, or K8 with `tile_expert2`/`row_sel`. x [N, K], w [E, K, F],
    row_scale [N, 1] -> fp32 [N, F]."""
    N, K = x.shape
    E, K2, Fd = w.shape
    if K2 != K or row_scale.numel() != N:
        raise ValueError(f"gmm_scaled: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, row_scale "
                         f"{tuple(row_scale.shape)}")
    ni, te, tv = _row_tiles(N, bn, tile_expert, tile_valid)
    te2, sel = _fused_operands(N, ni, tile_expert2, row_sel)
    fused = te2 is not None
    if _where(x) == "cpu":
        if fused:
            return gmm_scaled_fused_plain(x, w, te, te2, tv, sel, row_scale,
                                          bn)
        return gmm_scaled_plain(x, w, te, tv, row_scale, bn)
    name = "gmm_scaled_fused" if fused else "gmm_scaled"
    scale = row_scale.reshape(N).to(torch.float32).contiguous()
    dt = _check_cuda(name, bn, x, w, te, tv, scale,
                     *((te2, sel) if fused else ()))
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must share a dtype")
    out = torch.empty((N, Fd), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(_lib(), f"{name}_{dt}")
    ring = _ring_args(x, N, K, Fd, E, False)
    if fused:
        rc = fn(x.data_ptr(), w.data_ptr(), te.data_ptr(), te2.data_ptr(),
                tv.data_ptr(), sel.data_ptr(), scale.data_ptr(),
                out.data_ptr(), N, K, Fd, bn, *ring, stream)
    else:
        rc = fn(x.data_ptr(), w.data_ptr(), te.data_ptr(), tv.data_ptr(),
                scale.data_ptr(), out.data_ptr(), N, K, Fd, bn, *ring,
                stream)
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def gmm(x: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
        tile_valid: torch.Tensor | None = None, *, bn: int,
        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K6. x [N, K], w [E, K, F] -> [N, F] in out_dtype or x.dtype, one
    rounding of the fp32 sum; rows of invalid tiles are zero. The kernel
    writes x.dtype or fp32."""
    N, K = x.shape
    E, K2, Fd = w.shape
    if K2 != K:
        raise ValueError(f"gmm: x {tuple(x.shape)}, w {tuple(w.shape)}")
    ni, te, tv = _row_tiles(N, bn, tile_expert, tile_valid)
    if _where(x) == "cpu":
        return gmm_plain(x, w, te, tv, bn, out_dtype)
    dt = _check_cuda("gmm", bn, x, w, te, tv)
    if w.dtype != x.dtype:
        raise TypeError("gmm: x and w must share a dtype")
    od = out_dtype or x.dtype
    if od == x.dtype:
        name = f"gmm_{dt}"
    elif od == torch.float32:
        name = f"gmm_{dt}_out_f32"
    else:
        raise TypeError(f"gmm: no kernel writes {od} from {x.dtype}")
    out = torch.empty((N, Fd), dtype=od, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(_lib(), name)(x.data_ptr(), w.data_ptr(), te.data_ptr(),
                               tv.data_ptr(), out.data_ptr(), N, K, Fd, bn,
                               *_ring_args(x, N, K, Fd, E, False), stream)
    build.check(rc, "gmm")
    LAUNCHES["gmm"] += 1
    return out
