"""Paged attention (K3 `paged_attn_decode`, K4 `paged_attn_chunk`): wrappers,
plain versions, launch counters and the page-traffic arithmetic.

Counterpart of repro/kernels/paged_attn.py. Attention walks a block table
of fixed-size KV pages instead of a dense [B, max_tokens] cache:

  paged_attn_decode(q, k_pages, v_pages, block_table, t)   -> [B, Hq, hd]
      one query per row at position t[b]: keys k_pos <= t, and
      k_pos > t - window when window > 0
  paged_attn_chunk(q, k_pages, v_pages, block_table, start, kv_len)
      a chunk of Cs queries at start..start+Cs-1: keys k_pos < kv_len,
      k_pos <= q_pos, and k_pos > q_pos - window

Pages are [NP, ps, Hkv, hd] (one layer's pool, the new keys already
scattered in), the block table [B, P] int32 (0 = the null page). Outputs
are fp32. An int8 pool (cfg.kv_quant="int8", core/quant.py) passes
`k_scales`/`v_scales` [NP, Hkv] f32, one per (page, kv head): the kernels
read the int8 page and dequantize it in the kernel; the plain versions
dequantize after the gather, as the reference's gather path does. Each
wrapper dispatches on where its tensors lie: on the CPU it runs the plain
version, the reference's gather realization (the block table
gathered into the dense [B, P*ps] layout, then the masked single-query SDPA
or `sdpa_chunked`, models/attention.py), which makes a paged pool on the
CPU bit-identical to a dense one; on a CUDA device it launches the
hand-written kernel of `csrc/paged_attn.cu` or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.models import attention as ATT

KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
KERNEL_MAX_GROUP = 16           # query heads per kv head the kernel holds

# Launch counts, one per kernel: raised by one at each kernel launch and
# nowhere else (the plain versions do not count). A launch on int8 pages
# counts under the `_int8` name only.
LAUNCHES = {"paged_attn_decode": 0, "paged_attn_chunk": 0,
            "paged_attn_decode_int8": 0, "paged_attn_chunk_int8": 0}
# The launches of LAUNCHES made with a window (> 0), by the same names: on
# a model whose layers mix windowed and global attention, the windowed
# layers' share.
LAUNCHES_WINDOWED = dict.fromkeys(LAUNCHES, 0)

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = LAUNCHES_WINDOWED[k] = 0


def _gather(pages: torch.Tensor, block_table: torch.Tensor,
            scales: torch.Tensor | None = None) -> torch.Tensor:
    """[NP, ps, Hkv, hd] pages -> the dense [B, P*ps, Hkv, hd] layout; int8
    pages with their [NP, Hkv] scales -> f32, dequantized after the gather
    (repro/models/attention.py attn_decode's quantized gather)."""
    B, P = block_table.shape
    _, ps, Hkv, hd = pages.shape
    bt = block_table.long()
    g = pages[bt]
    if scales is not None:
        g = g.float() * scales[bt][:, :, None, :, None]
    return g.reshape(B, P * ps, Hkv, hd)


# ------------------------------------------------------------ plain versions

def paged_attn_decode_plain(q, k_pages, v_pages, block_table, t, *,
                            window: int = 0, softcap: float = 0.0,
                            k_scales=None, v_scales=None) -> torch.Tensor:
    """K3's function as the reference's gather path computes it
    (repro/models/attention.py attn_decode, paged branch). t [B] int."""
    P, ps = block_table.shape[1], k_pages.shape[1]
    k_pos = torch.arange(P * ps, dtype=torch.int32, device=q.device)
    t_vec = t.to(torch.int32).reshape(-1, 1)
    mask = k_pos[None, :] <= t_vec                           # [B, P*ps]
    if window > 0:
        mask = mask & (k_pos[None, :] > t_vec - window)
    out = ATT._decode_sdpa(q[:, None], _gather(k_pages, block_table, k_scales),
                           _gather(v_pages, block_table, v_scales), mask,
                           softcap)
    return out[:, 0]


def paged_attn_chunk_plain(q, k_pages, v_pages, block_table, start: int,
                           kv_len: int, *, window: int = 0,
                           softcap: float = 0.0, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """K4's function as the reference's gather path computes it
    (repro/models/attention.py attn_chunk, paged branch), before the cast
    to the activations' dtype."""
    Cs = q.shape[1]
    P, ps = block_table.shape[1], k_pages.shape[1]
    q_pos = start + torch.arange(Cs, dtype=torch.int32, device=q.device)
    k_pos = torch.arange(P * ps, dtype=torch.int32, device=q.device)
    return ATT.sdpa_chunked_f32(q, _gather(k_pages, block_table, k_scales),
                                _gather(v_pages, block_table, v_scales),
                                q_pos, k_pos, window, kv_len, softcap=softcap)


# ------------------------------------------------------------------ wrappers

def _check(name: str, q, k_pages, v_pages, block_table, k_scales,
           v_scales) -> bool:
    """Checks shared by both wrappers, on any device; whether the pool is
    int8 (scales passed)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: pass both k_scales and v_scales or "
                         "neither")
    quant = k_scales is not None
    Hq, hd = q.shape[-2], q.shape[-1]
    NP, _, Hkv, hd_p = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_p != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    if Hq % Hkv:
        raise ValueError(f"{name}: num_heads={Hq} must be a multiple of "
                         f"num_kv_heads={Hkv}")
    if quant:
        if not (k_pages.dtype == v_pages.dtype == torch.int8):
            raise TypeError(f"{name}: scales mark an int8 pool, but the "
                            f"pages are {k_pages.dtype}, {v_pages.dtype}")
        for sc in (k_scales, v_scales):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (NP, Hkv):
                raise TypeError(f"{name}: scales must be float32 "
                                f"[{NP}, {Hkv}], got {sc.dtype} "
                                f"{tuple(sc.shape)}")
    elif not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"{name}: q, k_pages and v_pages must share a dtype "
                        f"(got {q.dtype}, {k_pages.dtype}, {v_pages.dtype})")
    if block_table.dtype != torch.int32:
        raise TypeError(f"{name}: block_table must be int32, got "
                        f"{block_table.dtype}")
    return quant


def _check_cuda(name: str, q, *tensors) -> str:
    """Validate the kernel's operands; return its dtype suffix."""
    build.no_autograd(name, q, *tensors)
    suffix = _KERNEL_DTYPES.get(q.dtype)
    if suffix is None:
        raise TypeError(f"{name}: no kernel for dtype {q.dtype}")
    hd, Hq, Hkv = q.shape[-1], q.shape[-2], tensors[0].shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if Hq // Hkv > KERNEL_MAX_GROUP:
        raise ValueError(f"{name}: the CUDA kernel holds at most "
                         f"{KERNEL_MAX_GROUP} query heads per kv head, got "
                         f"{Hq // Hkv}")
    for t in (q, *tensors):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if tensors[0].data_ptr() % 16 or tensors[1].data_ptr() % 16:
        raise ValueError(f"{name}: pages must be 16-byte aligned (the "
                         "kernel stages them with 16-byte loads)")
    return suffix


def _lib():
    lib = build.load("paged_attn")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for dt in _KERNEL_DTYPES.values():
            # the int8 entries take k_scales, v_scales after the pages
            for i8 in ("", "i8_"):
                sc = [P, P] if i8 else []
                f = getattr(lib, f"paged_attn_decode_{i8}{dt}")
                f.argtypes = [P] * 3 + sc + [P] * 5 + [I] * 9 + [F, P]
                f.restype = I
                f = getattr(lib, f"paged_attn_chunk_{i8}{dt}")
                f.argtypes = [P] * 3 + sc + [P, P] + [I] * 10 + [F] + \
                    [I] * (dt == "bf16") + [P]
                f.restype = I
        lib._typed = True
    return lib


def _where(x: torch.Tensor) -> str:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise ValueError(f"no paged-attention path for device {x.device}")


def paged_attn_decode(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_table: torch.Tensor, t, *,
                      window: int = 0, softcap: float = 0.0,
                      k_scales=None, v_scales=None) -> torch.Tensor:
    """K3. q [B, Hq, hd] (post-RoPE); pages [NP, ps, Hkv, hd]; block_table
    [B, P] int32; t an int or [B] int (each row's position); int8 pages
    with `k_scales`/`v_scales` [NP, Hkv] f32. Returns fp32 [B, Hq, hd], the
    attention output before `wo`."""
    quant = _check("paged_attn_decode", q, k_pages, v_pages, block_table,
                   k_scales, v_scales)
    B, Hq, hd = q.shape
    if isinstance(t, int):
        t = torch.full((B,), t, dtype=torch.int32, device=q.device)
    t = t.to(torch.int32).reshape(-1).expand(B).contiguous()
    if _where(q) == "cpu":
        return paged_attn_decode_plain(q, k_pages, v_pages, block_table, t,
                                       window=window, softcap=softcap,
                                       k_scales=k_scales, v_scales=v_scales)
    sc = (k_scales, v_scales) if quant else ()
    dt = _check_cuda("paged_attn_decode", q, k_pages, v_pages, block_table,
                     t, *sc)
    _, ps, Hkv, _ = k_pages.shape
    P, G = block_table.shape[1], Hq // Hkv
    pages, splits = decode_splits(P, ps)
    out = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    ws = torch.empty(B * Hkv * splits * G * (hd + 2), dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    name = "paged_attn_decode" + ("_int8" if quant else "")
    rc = getattr(_lib(), f"paged_attn_decode_{'i8_' if quant else ''}{dt}")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(x.data_ptr() for x in sc), block_table.data_ptr(), t.data_ptr(),
        ws.data_ptr(), _counters(q.device, B * Hkv).data_ptr(),
        out.data_ptr(), B, Hkv, G, hd, ps, P, pages, splits, int(window),
        float(softcap), stream)
    build.check(rc, name)
    LAUNCHES[name] += 1
    LAUNCHES_WINDOWED[name] += window > 0
    return out


def paged_attn_chunk(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_table: torch.Tensor,
                     start: int, kv_len: int, *, window: int = 0,
                     softcap: float = 0.0, k_scales=None,
                     v_scales=None) -> torch.Tensor:
    """K4. q [B, Cs, Hq, hd] (post-RoPE, the chunk's K/V already scattered
    into the pages); start / kv_len host ints (chunk-absolute start, total
    valid key count; pad queries at q_pos >= kv_len give finite values the
    caller discards); int8 pages with `k_scales`/`v_scales` as in K3.
    Returns fp32 [B, Cs, Hq, hd]."""
    quant = _check("paged_attn_chunk", q, k_pages, v_pages, block_table,
                   k_scales, v_scales)
    if _where(q) == "cpu":
        return paged_attn_chunk_plain(q, k_pages, v_pages, block_table,
                                      int(start), int(kv_len), window=window,
                                      softcap=softcap, k_scales=k_scales,
                                      v_scales=v_scales)
    sc = (k_scales, v_scales) if quant else ()
    dt = _check_cuda("paged_attn_chunk", q, k_pages, v_pages, block_table,
                     *sc)
    B, Cs, Hq, hd = q.shape
    _, ps, Hkv, _ = k_pages.shape
    out = torch.empty((B, Cs, Hq, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    warps = (chunk_warps(Cs * (Hq // Hkv)),) if dt == "bf16" else ()
    name = "paged_attn_chunk" + ("_int8" if quant else "")
    rc = getattr(_lib(), f"paged_attn_chunk_{'i8_' if quant else ''}{dt}")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(x.data_ptr() for x in sc), block_table.data_ptr(), out.data_ptr(),
        B, Cs, Hkv, Hq // Hkv, hd, ps, block_table.shape[1], int(start),
        int(kv_len), int(window), float(softcap), *warps, stream)
    build.check(rc, name)
    LAUNCHES[name] += 1
    LAUNCHES_WINDOWED[name] += window > 0
    return out


# ------------------------------------------------------ K3's launch arithmetic

DECODE_SPLIT_KEYS = 64          # about this many keys per split of K3

# K3's arrival counters, one per (row, kv head) and device: 0 between
# launches (the last CTA of each resets its own), so they are made once and
# only grown. Launches of K3 on one device run in stream order.
_COUNTERS: dict = {}


def _counters(device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def decode_splits(P: int, ps: int) -> tuple[int, int]:
    """K3's split-KV launch: (pages per split, splits). A split is a fixed
    span of whole pages, about DECODE_SPLIT_KEYS keys and at least one
    page, and `splits` of them cover a row's P pages: the grid is (kv head,
    row, split). Shapes only, so the split a key falls in never depends on
    the batch, the positions or the device. int8 pages take the same
    split: at 128 keys their body was no faster at llama's decode and
    ~30% slower at granite's (`chip_smoke.py`'s K3 int8 split sweep)."""
    pages = max(1, DECODE_SPLIT_KEYS // ps)
    return pages, -(-P // pages)


def decode_split_keys(split: int, pages: int, ps: int, P: int, t: int,
                      window: int = 0) -> tuple[int, int]:
    """(first, last): the keys of `split` (of `pages` pages) a row at
    position t may see, k_pos <= t and k_pos > t - window when window > 0;
    empty when last < first, and then the split's CTA writes the empty
    partial (m = -1e30, l = 0, acc = 0). csrc/paged_attn.cu
    `paged_decode_split_kernel` follows the same formulas."""
    lo = split * pages * ps
    last = min(t, min(lo + pages * ps, P * ps) - 1)
    first = max(lo, t - window + 1) if window > 0 else lo
    return first, last


# ------------------------------------------------- K4's bf16 launch arithmetic

def chunk_key_tile(hd: int) -> int:
    """Keys per K/V tile of K4's bf16 body (csrc `chunk_kt`): 64, or 32 at
    head_dim 256, where 64 keys would not leave registers for the output."""
    return 32 if hd > 128 else 64


def chunk_warps(rows: int) -> int:
    """Warps per CTA of K4's bf16 body (16 (query, head) rows each): 4, or
    fewer where a chunk has at most 32 rows per kv head. Each K/V tile a
    CTA gathers feeds all its warps, so more warps per CTA move fewer
    bytes from L2; at both served chunk shapes 4 warps beat 1 and 2,
    on bf16 pages and on int8 ones, although they leave SMs idle (llama:
    64 CTAs, granite: 48): see `chip_smoke.py`'s K4 warps sweeps. Shapes
    only, so the choice never waits on the device."""
    return 4 if rows > 32 else 2 if rows > 16 else 1


def chunk_tiles(Cs: int, G: int, hd: int, ps: int, P: int, start: int,
                kv_len: int, window: int = 0):
    """K4's bf16 launch: (W, ctas), ctas[z] = (row_lo, row_hi, tile_lo,
    tile_hi) for the CTA at grid z of every (kv head, row): its (query,
    head) rows r = qi * G + g in [row_lo, row_hi), and the first and last
    key tile (of `chunk_key_tile(hd)` keys from position 0) it loads;
    tile_hi < tile_lo loads none. The keys run from the first one the
    window reaches for the CTA's first query to the last one < kv_len its
    last query may see (the block table's end included); keys of those
    tiles outside that range are zero-filled, never read. The CUDA body
    (csrc/paged_attn.cu `chunk_key_range`) follows the same formulas."""
    W, KT, R = chunk_warps(Cs * G), chunk_key_tile(hd), Cs * G
    ctas = []
    for row_lo in range(0, R, 16 * W):
        row_hi = min(row_lo + 16 * W, R)
        first, last = chunk_key_range(row_lo, row_hi, G, ps, P, start,
                                      kv_len, window)
        t_lo = first // KT
        ctas.append((row_lo, row_hi, t_lo,
                     last // KT if last >= first else t_lo - 1))
    return W, ctas


def chunk_key_range(row_lo: int, row_hi: int, G: int, ps: int, P: int,
                    start: int, kv_len: int, window: int = 0):
    """(first, last): the keys the (query, head) rows [row_lo, row_hi) of
    a chunk may see, empty when last < first (csrc `chunk_key_range`; a
    warp's 16 rows skip the tiles outside their own range)."""
    q_first, q_last = row_lo // G, (row_hi - 1) // G
    last = min(kv_len - 1, start + q_last, P * ps - 1)
    first = max(0, start + q_first - window + 1) if window > 0 else 0
    return first, last


# ------------------------------------------------------------ traffic model

def page_bytes(cfg, page_size: int) -> int:
    """Device bytes one physical page costs to stage (K + V), per layer.
    An int8 pool pays int8 values plus one f32 scale per (page, kv head),
    the scale operand the kernel reads beside the page."""
    hd = cfg.resolved_head_dim()
    if getattr(cfg, "kv_quant", "none") == "int8":
        return 2 * (page_size * cfg.num_kv_heads * hd
                    + cfg.num_kv_heads * 4)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return 2 * page_size * cfg.num_kv_heads * hd * item


def decode_tick_pages(t_host, active, page_size: int, num_slots: int,
                      pages_per_slot: int) -> tuple[int, int]:
    """Per-tick page-traffic model of one decode tick: (kernel_pages,
    gather_pages). The kernel stages each active row's live pages,
    floor(t/ps)+1, while the gather re-materializes every block-table entry
    of every slot. Pure host arithmetic."""
    live = sum(int(t_host[i]) // page_size + 1
               for i in range(num_slots) if active[i])
    return live, num_slots * pages_per_slot
