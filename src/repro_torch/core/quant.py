"""Quantized decode state: int8 pages + per-page scales (cfg.kv_quant).

Counterpart of repro/core/quant.py. KV pages store int8 values with one f32
amax scale per (page, kv head); GO rows store int8 with one f32 scale per
cached row. Everything here operates on raw tensors; layout and layer
handling belong to the callers (models/model.py, serving/pool.py).

The arithmetic is the reference's, step for step, so the int8 values and
scales equal JAX's bit for bit on the same inputs: `x / _safe(s)` (a
division, not a multiply by a reciprocal), `torch.round` (half to even, as
`jnp.rint`), a clip to +-QMAX, and `amax / QMAX`.

Write-side contract (the part determinism rests on):

  * splat (one-shot prefill -> write_decode_slot): each page quantizes
    against the amax of its OWN contents, a pure function of the tokens.
  * incremental scatter (decode / chunked prefill): scales only ever GROW
    (a scatter-max, `scatter_reduce_(..., "amax")`, which is order-free).
    When a new token raises a page's amax, the page's existing int8 values
    are re-quantized by the exact ratio old/new in f32 (`factor == 1.0`
    leaves them bit-identical through round), so a page's contents depend
    only on the tokens written to it, never on page-reuse history. Freed
    pages MUST therefore return with zeroed scales (SlotPool's release),
    or a reused page would inherit an inflated amax and quantize
    differently from a fresh one.

Unlike the reference, the scatters write the cache and the scales IN
PLACE (they are views of the decode state); they return both as well.

Error model: with scale = amax / QMAX and no clipping (|x| <= amax by
construction), the round-trip error per element is bounded by scale / 2 =
amax / (2 * QMAX). GO rows are dequantized to f32 at the layer boundary
(f32, NOT the cfg compute dtype: in f32 the dequant->requant cycle of an
UNCHANGED row recovers its int8 values exactly, so idle rows are
bit-stable across ticks).
"""
from __future__ import annotations

import torch

QMAX = 127.0                # int8 symmetric range

KV_QUANT_MODES = ("none", "int8")


def validate_kv_quant(kv_quant: str) -> None:
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"kv_quant={kv_quant!r} is not a known mode {KV_QUANT_MODES}")


def _safe(scales: torch.Tensor) -> torch.Tensor:
    """Divide-safe scales: all-zero pages (scale 0) quantize to 0."""
    return torch.where(scales > 0, scales, 1.0)


def _to_int8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -QMAX, QMAX).to(torch.int8)


def quantize_pages(pages: torch.Tensor):
    """Quantize float pages [..., ps, Hkv, hd] -> (int8 pages, f32 scales
    [..., Hkv]): one symmetric amax scale per (page, kv head)."""
    x = pages.float()
    amax = x.abs().amax(dim=(-3, -1))                         # [..., Hkv]
    scales = amax / QMAX
    return _to_int8(x / _safe(scales)[..., None, :, None]), scales


def dequantize_pages(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 pages [..., ps, Hkv, hd] + scales [..., Hkv] -> f32 pages."""
    return q.float() * scales[..., None, :, None]


def quantize_rows(x: torch.Tensor):
    """Quantize float rows [..., d] -> (int8 rows, f32 scales [...]): one
    symmetric amax scale per row (the GO-cache layout)."""
    xf = x.float()
    scales = xf.abs().amax(dim=-1) / QMAX
    return _to_int8(xf / _safe(scales)[..., None]), scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales[..., None]


def _scatter(cache, scales, pages, offs, vals):
    """The shared body of scatter_token / scatter_chunk: `pages` and `offs`
    of any index shape I, `vals` [*I, Hkv, hd]."""
    vals = vals.float()
    amax = vals.abs().amax(dim=-1)                            # [*I, Hkv]
    idx = pages.long()
    old_s = scales[idx]                                       # [*I, Hkv]
    hkv = scales.shape[-1]
    scales.scatter_reduce_(0, idx.reshape(-1, 1).expand(-1, hkv),
                           (amax / QMAX).reshape(-1, hkv), "amax")
    # a NaN scale stays NaN, as under the reference's scatter max: CUDA's
    # atomic max (fmaxf) drops a NaN operand, torch.maximum keeps it, and
    # for finite scales it is the identity (the scatter never shrinks)
    new_s = torch.maximum(old_s, scales[idx])                 # post-update
    scales[idx] = new_s
    factor = torch.where(new_s > 0, old_s / _safe(new_s), 1.0)
    # every duplicate index re-writes IDENTICAL values (old and new scales
    # and the page are read outside the scatter), so the write is
    # deterministic
    cache[idx] = torch.round(cache[idx].float()
                             * factor[..., None, :, None]).to(torch.int8)
    cache[idx, offs.long()] = _to_int8(vals / _safe(new_s)[..., None])
    return cache, scales


def scatter_token(cache, scales, page, off, val):
    """Decode-tick token write into int8 pages with rescale-on-write.

    cache  int8 [NP, ps, Hkv, hd]     scales f32 [NP, Hkv]
    page   int [B]   off int [B]      val float [B, Hkv, hd]

    The page's scale grows to cover the new token's amax (never shrinks);
    when it grows, the page's existing values are re-quantized by the f32
    ratio old/new; a ratio of exactly 1.0 is an int8 identity through
    round, so untouched pages stay bit-stable. Duplicate page indices only
    occur on the null page 0 (retired rows), whose contents are trash by
    design and are never read. Writes in place; returns (cache, scales)."""
    return _scatter(cache, scales, page, off, val)


def scatter_chunk(cache, scales, pages, offs, vals):
    """Chunked-prefill scatter into int8 pages with rescale-on-write.

    cache  int8 [NP, ps, Hkv, hd]        scales f32 [NP, Hkv]
    pages  int [B, Cs]  offs [B, Cs]     vals float [B, Cs, Hkv, hd]

    Same contract as scatter_token. Several chunk positions may land on
    the SAME page: the scale update is a scatter-max (order-free), and the
    whole-page re-quantization writes IDENTICAL values for every duplicate
    index, so the duplicate scatter is deterministic. Writes in place;
    returns (cache, scales)."""
    return _scatter(cache, scales, pages, offs, vals)


def kv_bytes_per_token(cfg, page_size: int) -> float:
    """Resident KV bytes per token across all layers: K + V values plus the
    per-page scales amortized over the page's tokens."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    if cfg.kv_quant == "int8":
        per_page = 2 * (page_size * hkv * hd * 1 + hkv * 4)
    else:
        item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        per_page = 2 * page_size * hkv * hd * item
    return cfg.num_layers * per_page / page_size
