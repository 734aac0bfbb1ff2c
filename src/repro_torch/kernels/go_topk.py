"""The GO cache's TopKUpdate (K5 `go_topk_update`): wrappers, the plain
version and the launch counter.

Counterpart of repro/kernels/go_topk.py. Per (batch row, expert), over the
cached top-k scores [E, k]: the first slot holding the minimum, whether
the new score is at least that minimum (`selected`), and where it is, that
slot takes the new score and the token id (paper eq. 5).

  go_topk_update(s, ids, s_new, tid)   -> (new_s, new_ids, selected, slot)
  go_topk_update_(s, ids, s_new, tid)  -> (selected, slot); s and ids are
                                          written in place (the decode
                                          path's form: they are views of
                                          the decode state)

Both forms go through one kernel (`csrc/go_topk.cu`) and one plain
version, the batched `core/routing.py:topk_update`. A wrapper runs the
plain version when its tensors lie on the CPU; on a CUDA device it
launches the kernel or raises. `tid` is an int (the static batch's
position, passed to the kernel by value) or a [B] tensor (the engine's
per-slot positions).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.routing import topk_update
from repro_torch.kernels import build

# Launch count: raised by one at each kernel launch and nowhere else.
LAUNCHES = {"go_topk_update": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def go_topk_update_plain(s_prev: torch.Tensor, tok_prev: torch.Tensor,
                         s_new: torch.Tensor, token_id):
    """K5's function through the batched `topk_update` (the reference's
    oracle, repro/kernels/ref.py:go_topk_ref, vmaps the same update)."""
    u = topk_update(s_prev.float(), tok_prev.to(torch.int32), s_new.float(),
                    token_id)
    return u.new_scores, u.new_token_ids, u.selected, u.slot


def _check(name: str, s_prev, tok_prev, s_new, token_id):
    """Validate shapes; return the device kind ("cpu" or "cuda")."""
    if s_prev.dim() != 3 or tok_prev.shape != s_prev.shape \
            or s_new.shape != s_prev.shape[:2]:
        raise ValueError(f"{name}: scores {tuple(s_prev.shape)}, ids "
                         f"{tuple(tok_prev.shape)}, s_new "
                         f"{tuple(s_new.shape)} (want [B, E, k], [B, E, k], "
                         "[B, E])")
    if torch.is_tensor(token_id) and tuple(token_id.shape) != (s_prev.shape[0],):
        raise ValueError(f"{name}: token_id {tuple(token_id.shape)}, want an "
                         f"int or [{s_prev.shape[0]}]")
    devs = {s_prev.device, tok_prev.device, s_new.device}
    if torch.is_tensor(token_id):
        devs.add(token_id.device)
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on {sorted(map(str, devs))}")
    kind = s_prev.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no TopKUpdate path for device "
                         f"{s_prev.device}")
    return kind


def _lib():
    lib = build.load("go_topk")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.go_topk_update_f32.argtypes = [P, P, P, P, I, P, P, P, P, I, I, I,
                                           P]
        lib.go_topk_update_f32.restype = I
        lib._typed = True
    return lib


def _launch(s_prev, tok_prev, s_new, token_id, s_out, t_out):
    """Launch K5 on contiguous fp32 scores and int32 ids; returns
    (selected, slot)."""
    B, E, k = s_prev.shape
    sn = s_new.to(torch.float32).contiguous()
    if torch.is_tensor(token_id):
        tid_vec = token_id.to(torch.int32).contiguous()
        tid_ptr, tid = tid_vec.data_ptr(), 0
    else:
        tid = int(token_id)
        if not -2 ** 31 <= tid < 2 ** 31:
            raise ValueError(f"go_topk_update: token id {tid} is no int32")
        tid_ptr = None
    sel = torch.empty((B, E), dtype=torch.bool, device=s_prev.device)
    slot = torch.empty((B, E), dtype=torch.int32, device=s_prev.device)
    stream = torch.cuda.current_stream(s_prev.device).cuda_stream
    rc = _lib().go_topk_update_f32(
        s_prev.data_ptr(), tok_prev.data_ptr(), sn.data_ptr(), tid_ptr, tid,
        s_out.data_ptr(), t_out.data_ptr(), sel.data_ptr(), slot.data_ptr(),
        B, E, k, stream)
    build.check(rc, "go_topk_update")
    LAUNCHES["go_topk_update"] += 1
    return sel, slot


def go_topk_update(s_prev: torch.Tensor, tok_prev: torch.Tensor,
                   s_new: torch.Tensor, token_id):
    """K5, functional. s_prev [B, E, k] fp32, tok_prev [B, E, k] int32,
    s_new [B, E] fp32, token_id an int or [B] -> (new_scores, new_tok,
    selected [B, E] bool, slot [B, E] int32), as the reference returns."""
    if _check("go_topk_update", s_prev, tok_prev, s_new, token_id) == "cpu":
        return go_topk_update_plain(s_prev, tok_prev, s_new, token_id)
    sp = s_prev.to(torch.float32).contiguous()
    tp = tok_prev.to(torch.int32).contiguous()
    s_out, t_out = torch.empty_like(sp), torch.empty_like(tp)
    sel, slot = _launch(sp, tp, s_new, token_id, s_out, t_out)
    return s_out, t_out, sel, slot


def go_topk_update_(scores: torch.Tensor, token_ids: torch.Tensor,
                    s_new: torch.Tensor, token_id):
    """K5 in place: the new scores and ids are written into `scores` (fp32)
    and `token_ids` (int32), which must be contiguous (a hidden copy would
    drop the write). Returns (selected [B, E] bool, slot [B, E] int32)."""
    kind = _check("go_topk_update_", scores, token_ids, s_new, token_id)
    if not (scores.is_contiguous() and token_ids.is_contiguous()):
        raise ValueError("go_topk_update_: scores and token_ids must be "
                         "contiguous to be updated in place")
    if scores.dtype != torch.float32 or token_ids.dtype != torch.int32:
        raise TypeError(f"go_topk_update_: scores {scores.dtype} and ids "
                        f"{token_ids.dtype}, want float32 and int32")
    if kind == "cpu":
        s, t, sel, slot = go_topk_update_plain(scores, token_ids, s_new,
                                               token_id)
        scores.copy_(s)
        token_ids.copy_(t)
        return sel, slot
    return _launch(scores, token_ids, s_new, token_id, scores, token_ids)
