"""The sLSTM sequence (K9 `slstm_seq`): wrapper, plain version, launch
counter.

Counterpart of repro/kernels/slstm_cell.py. One call runs the whole sLSTM
recurrence over S steps from a zero state (m = 0):

  rec      = r · h_prev, per head (r [4, H, hd, hd] is block-diagonal)
  li, lf, z, o = u_t + rec              (gate-major: u_t.reshape(4, H, hd))
  lf       = log_sigmoid(lf)
  m_new    = max(lf + m, li)
  c        = exp(lf + m - m_new) c + exp(li - m_new) tanh(z)
  n        = exp(lf + m - m_new) n + exp(li - m_new)
  h        = sigmoid(o) c / max(n, 1e-6)

u [B, S, 4·H·hd] gate pre-activations -> h [B, S, H·hd] in u's dtype; the
state stays fp32. On a CPU tensor the wrapper runs the plain version, a
per-step loop of the reference cell (`slstm_step`, which models/xlstm.py's
`_slstm_cell` also runs); on a CUDA tensor it launches the hand-written
kernel of `csrc/slstm_cell.cu` or raises: a thread-block cluster per head
with its slice of r resident in each CTA's shared memory, where
`slstm_cluster` finds a cluster size that fits, else one block per (head,
batch row).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

KERNEL_MAX_HD = 512             # units per head the kernel holds (xlstm-1.3b)

# The cluster body (csrc `slstm_cluster_kernel`): its threads per CTA, the
# (batch row, unit) cells one thread holds, the largest cluster, and the
# dynamic shared memory one CTA may use on an H100.
CLUSTER_THREADS = 256
CLUSTER_CELLS = 4
CLUSTER_MAX = 16
SMEM_PER_CTA = 232448

# Launch count: raised by one at each kernel launch and nowhere else.
LAUNCHES = {"slstm_seq": 0}

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain version

def slstm_step(r: torch.Tensor, u_t: torch.Tensor, state: dict, H: int,
               hd: int) -> dict:
    """One step of the reference cell (repro/models/xlstm.py:232): u_t
    [B, 4·H·hd] pre-activations, state c/n/m/h [B, H, hd] fp32 -> the new
    state."""
    rec = torch.einsum("ghij,bhj->bghi", r.float(), state["h"])
    B = u_t.shape[0]
    gates = u_t.float().reshape(B, 4, H, hd) + rec
    li, lf, z, o = gates[:, 0], gates[:, 1], gates[:, 2], gates[:, 3]
    lf = F.logsigmoid(lf)
    m_new = torch.maximum(lf + state["m"], li)
    fi = torch.exp(lf + state["m"] - m_new)
    ii = torch.exp(li - m_new)
    c = fi * state["c"] + ii * torch.tanh(z)
    n = fi * state["n"] + ii
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}


def slstm_seq_plain(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """K9's function as a loop of `slstm_step` from the zero state."""
    B, S, _ = u.shape
    _, H, hd, _ = r.shape
    rf = r.float()
    z = torch.zeros((B, H, hd), dtype=torch.float32, device=u.device)
    st = {"c": z, "n": z, "m": z, "h": z}
    out = torch.empty((B, S, H * hd), dtype=u.dtype, device=u.device)
    for t in range(S):
        st = slstm_step(rf, u[:, t], st, H, hd)
        out[:, t] = st["h"].reshape(B, -1)
    return out


# ---------------------------------------------- the cluster body's shapes

def slstm_cluster_smem(B: int, hd: int, r_bytes: int, CL: int) -> int:
    """Dynamic shared memory of one CTA of the cluster body (csrc
    `cl_smem`): its slice of r, 4 ceil(hd / CL) rows of hd padded to 16
    bytes; h_prev double-buffered, [2, B] rows of the same width, fp32;
    the recurrent sums [B, 4 ceil(hd / CL)], fp32."""
    v = 16 // r_bytes
    ld = -(-hd // v) * v
    units = -(-hd // CL)
    return 4 * units * ld * r_bytes + 2 * B * ld * 4 + 4 * units * B * 4


def slstm_cluster(B: int, hd: int, r_bytes: int):
    """K9's body for a shape: the smallest power of two CL <= CLUSTER_MAX
    whose CTAs (each owning ceil(hd / CL) units of a head for all B rows)
    fit a CTA's shared memory and threads, or None, where the shape keeps
    the per-(head, batch row) body. Shapes only: no device value
    decides."""
    CL = 1
    while CL <= CLUSTER_MAX:
        if B * -(-hd // CL) <= CLUSTER_THREADS * CLUSTER_CELLS and \
                slstm_cluster_smem(B, hd, r_bytes, CL) <= SMEM_PER_CTA:
            return CL
        CL *= 2
    return None


# ------------------------------------------------------------------ wrapper

def _lib():
    lib = build.load("slstm_cell")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        for du in _KERNEL_DTYPES.values():
            for dr in _KERNEL_DTYPES.values():
                f = getattr(lib, f"slstm_seq_{du}_{dr}")
                f.argtypes = [P, P, P, I, I, I, I, I, P]
                f.restype = I
                f = getattr(lib, f"slstm_cluster_capacity_{du}_{dr}")
                f.argtypes = [I, I, I]
                f.restype = I
        lib._typed = True
    return lib


_CLUSTERS_FIT: dict = {}


def _check_cluster(lib, du: str, dr: str, B: int, hd: int, CL: int) -> None:
    """At first use of a (dtypes, B, hd, CL): raise unless at least one
    cluster of CL CTAs can be resident on this card
    (cudaOccupancyMaxActiveClusters). There is no fallback to the other
    body."""
    key = (du, dr, B, hd, CL)
    if key not in _CLUSTERS_FIT:
        n = getattr(lib, f"slstm_cluster_capacity_{du}_{dr}")(B, hd, CL)
        if n < 1:
            raise RuntimeError(
                f"slstm_seq: no cluster of {CL} CTAs fits on this card for "
                f"B={B}, hd={hd} (cudaOccupancyMaxActiveClusters gave "
                f"{n if n == 0 else f'cudaError {-n}'})")
        _CLUSTERS_FIT[key] = n


def slstm_seq(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """K9. u [B, S, 4·H·hd] (fp32 or bf16), r [4, H, hd, hd] (fp32 or bf16)
    -> h [B, S, H·hd] in u's dtype."""
    B, S, four_d = u.shape
    if r.dim() != 4 or r.shape[0] != 4 or r.shape[2] != r.shape[3] \
            or four_d != 4 * r.shape[1] * r.shape[2]:
        raise ValueError(f"slstm_seq: u {tuple(u.shape)} and r "
                         f"{tuple(r.shape)} (want u [B, S, 4*H*hd], r "
                         "[4, H, hd, hd])")
    _, H, hd, _ = r.shape
    if u.device.type == "cpu" and r.device.type == "cpu":
        return slstm_seq_plain(u, r)
    if u.device.type != "cuda" or r.device != u.device:
        raise ValueError(f"slstm_seq: u on {u.device}, r on {r.device}")
    du, dr = _KERNEL_DTYPES.get(u.dtype), _KERNEL_DTYPES.get(r.dtype)
    if du is None or dr is None:
        raise TypeError(f"slstm_seq: no kernel for u {u.dtype}, r {r.dtype}")
    if hd > KERNEL_MAX_HD:
        raise ValueError(f"slstm_seq: the CUDA kernel holds at most "
                         f"{KERNEL_MAX_HD} units per head, got {hd}")
    if not (u.is_contiguous() and r.is_contiguous()):
        raise ValueError("slstm_seq: u and r must be contiguous")
    if r.data_ptr() % 16:
        raise ValueError("slstm_seq: r must be 16-byte aligned (the kernel "
                         "reads its rows with 16-byte loads)")
    lib = _lib()
    CL = slstm_cluster(B, hd, r.element_size())
    if CL is not None:
        _check_cluster(lib, du, dr, B, hd, CL)
    out = torch.empty((B, S, H * hd), dtype=u.dtype, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = getattr(lib, f"slstm_seq_{du}_{dr}")(
        u.data_ptr(), r.data_ptr(), out.data_ptr(), B, S, H, hd, CL or 0,
        stream)
    build.check(rc, "slstm_seq")
    LAUNCHES["slstm_seq"] += 1
    return out

