"""Shared building blocks: device and dtype resolution, inits, RMSNorm, RoPE.

Counterpart of repro/models/layers.py. Compute convention: activations in
cfg.dtype, normalization and RoPE in fp32.
"""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA on a host without a card raises; nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, lead: tuple = ()) -> torch.Tensor:
    """N(0, 1/d_in) weights [*lead, d_in, d_out] (layers.py:64's
    distribution; the bits differ from JAX's)."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * (1.0 / d_in ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ------------------------------------------------------------------- RMSNorm

def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------- RoPE

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [*, S] -> (cos, sin) each [*, S, head_dim//2], fp32."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin broadcastable [..., S, 1, D//2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
