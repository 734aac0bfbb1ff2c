"""Shared building blocks: device and dtype resolution, inits, RMSNorm, RoPE,
the dense SwiGLU and gelu MLPs, and the row gathers and row sums that training
differentiates through.

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


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype,
             device) -> dict:
    """The dense SwiGLU MLP's weights (layers.py:109's wi, wg, wo)."""
    return {"wi": dense_init(gen, d, d_ff, dtype, device),
            "wg": dense_init(gen, d, d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d, dtype, device)}


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


# --------------------------------------------------------------------- SwiGLU

def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x Wg) * (x Wi), then Wo, in x's dtype. The reference computes
    these products in plain jnp, outside any Pallas kernel, so they stay
    torch.matmul here."""
    h = torch.nn.functional.silu(x @ params["wg"]) * (x @ params["wi"])
    return h @ params["wo"]


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype,
                  device) -> dict:
    """The gelu MLP's weights (layers.py:123's wi, wo): whisper's blocks."""
    return {"wi": dense_init(gen, d, d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d, dtype, device)}


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """gelu(x Wi) Wo in x's dtype, with the tanh approximation that
    jax.nn.gelu takes by default (the exact erf form differs by up to
    5e-4)."""
    h = torch.nn.functional.gelu(x @ params["wi"], approximate="tanh")
    return h @ params["wo"]


# ------------------------------------------------- row gathers and row sums

def add_rows(src: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out[i] = the sum of the rows src[j] with idx[j] == i; src [N, ...],
    idx [N] -> [n, ...] in src's dtype. One product with a one-hot [N, n]
    matrix: a sum in one fixed order on every device and every run, where
    a float `index_add_` on a card sums with atomics in a different order
    each time. Differentiable (its gradient is the matching gather)."""
    N = src.shape[0]
    onehot = torch.zeros((N, n), dtype=src.dtype, device=src.device)
    onehot.scatter_(1, idx.reshape(N, 1).long(), 1)
    return (onehot.T @ src.reshape(N, -1)).reshape(n, *src.shape[1:])


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx.long()]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        g = grad.reshape(idx.numel(), *grad.shape[idx.dim():])
        return add_rows(g, idx.reshape(-1), ctx.rows), None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along x's first axis (idx of any shape). Where autograd
    records it, the gradient of a row picked several times sums through
    `add_rows`, not through indexing's scatter-add, so a training step
    repeats bit for bit on a card (the embedding lookup, the MoE
    dispatch's gathers)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _TakeRows.apply(x, idx)
    return x[idx.long()]
