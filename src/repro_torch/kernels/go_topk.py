"""The GO cache's TopKUpdate (K5 `go_topk_update`) and the GO decode's
router (K5R `go_router`): wrappers, plain versions and launch counters.

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

K5R folds the work around K5 on the decode into one launch: the gate row
s = x . gate_w and g = softmax(s) (repro/core/go_cache.py's go_cache_step),
the TopKUpdate with g, and the lane plan of the selected (row, expert)
pairs that the decode FFN runs (`GOPlan`, built on the CPU by the sort of
`go_lane_plan`).

  go_router(x, gate_w, s, ids, tid, bn)   -> (new_s, new_ids, GORoute)
  go_router_(x, gate_w, s, ids, tid, bn)  -> GORoute; s and ids are written
                                             in place

On a card the gate row is read by several CTAs (`router_splits`) and the
last of them to finish does the rest. B and E are at most 64 (ROUTER_MAX:
that CTA keeps the [B, E] selection in shared memory); both forms raise
beyond, on every device. `router_fits(B, E)` is that bound as a rule of
shapes: the GO decode (core/go_cache.py:go_cache_step) asks it before any
launch and runs a wider step as the gate row and softmax, K5 in place and
`go_lane_plan`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.routing import topk_update
from repro_torch.kernels import build

# Launch count: raised by one at each kernel launch and nowhere else.
LAUNCHES = {"go_topk_update": 0, "go_router": 0}


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
    if kind == "cuda":
        build.no_autograd(name, s_prev, tok_prev, s_new)
    return kind


def _lib():
    lib = build.load("go_topk")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.go_topk_update_f32.argtypes = [P, P, P, P, I, P, P, P, P, I, I, I,
                                           P]
        lib.go_topk_update_f32.restype = I
        for dx in _ROUTER_DTYPES.values():
            for dw in _ROUTER_DTYPES.values():
                f = getattr(lib, f"go_router_{dx}_{dw}")
                f.argtypes = [P] * 5 + [I, I] + [P] * 11 + [I] * 8 + [P]
                f.restype = I
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


# ------------------------------------------------------------ K5R go_router

ROUTER_MAX = 64                   # bound on B and on E (one CTA's selection)
ROUTER_SPLIT_BYTES = 8192         # bytes of gate_w a CTA of the gate row reads
ROUTER_MAX_SPLITS = 128
_ROUTER_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_COUNTERS: dict = {}              # device -> the last-CTA counter (0 between
                                  # launches)


def router_fits(B: int, E: int) -> bool:
    """Whether K5R takes a decode of B rows over E experts: both within
    1..ROUTER_MAX (its last CTA keeps the [B, E] selection in shared
    memory). Shapes only."""
    return 1 <= B <= ROUTER_MAX and 1 <= E <= ROUTER_MAX


def router_splits(d: int, E: int, w_bytes: int) -> tuple[int, int]:
    """K5R's grid: (rows of gate_w per CTA, CTAs). One SM streams gate_w
    too slowly, so the gate row is split into spans of about
    ROUTER_SPLIT_BYTES (one 16-byte load a thread of a 512-thread CTA), at
    most ROUTER_MAX_SPLITS of them; shapes only."""
    rows = max(1, ROUTER_SPLIT_BYTES // (E * w_bytes),
               -(-d // ROUTER_MAX_SPLITS))
    return rows, -(-d // rows)


def _counter(device) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None:
        c = torch.zeros(1, dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


class GOPlan(NamedTuple):
    """Which rows the decode FFN runs: lane e owns rows [e*Cp, (e+1)*Cp)."""
    idx_p: torch.Tensor        # [E, Cp] int32 batch row of each lane row
    scale: torch.Tensor        # [E * Cp] fp32 g of a selected pair, else 0
    tile_valid: torch.Tensor   # [E * Cp / bn] bool: a selected row inside
    tile_expert: torch.Tensor  # [E * Cp / bn] int32 the tile's expert
    bn: int                    # rows per tile


class GORoute(NamedTuple):
    g: torch.Tensor            # [B, E] fp32 gate affinities
    selected: torch.Tensor     # [B, E] bool: the expert took the token
    slot: torch.Tensor         # [B, E] int32 the cache slot it replaced
    plan: GOPlan


def go_lane_plan(selected: torch.Tensor, g: torch.Tensor, bn: int) -> GOPlan:
    """The selected-pair lane plan, plain: per lane (expert) the selected
    rows in ascending batch order, then the unselected ones in ascending
    order, then row 0 up to Cp = B rounded up to bn. C = B rows a lane (the
    full plan, exact, no host sync); a tile holding no selected row is
    invalid, so it runs no multiply-add and reads no weights."""
    B, E = selected.shape
    dev = selected.device
    selT = selected.T                                       # [E, B]
    counts = selT.sum(dim=1).to(torch.int32)
    ar = torch.arange(B, dtype=torch.int32, device=dev)
    # selected rows get descending positive keys, unselected distinct
    # negative ones: one sort yields each lane's selected rows in order
    keys = torch.where(selT, B - ar[None, :], -1 - ar[None, :])
    gsel = torch.where(selT, g.T, 0.0)                      # affinities > 0
    C = B
    idx = torch.sort(keys, dim=1, descending=True, stable=True)[1][:, :C]
    w = torch.gather(gsel, 1, idx)                          # 0 off-selection
    Cp = -(-C // bn) * bn
    idx_p = torch.nn.functional.pad(idx, (0, Cp - C)).to(torch.int32)
    scale = torch.nn.functional.pad(w, (0, Cp - C)).reshape(E * Cp)
    te = torch.arange(E, dtype=torch.int32, device=dev).repeat_interleave(
        Cp // bn)
    slot = torch.arange(Cp // bn, dtype=torch.int32, device=dev) * bn
    tv = (slot[None, :] < counts[:, None]).reshape(-1)
    return GOPlan(idx_p, scale, tv, te, bn)


def go_router_plain(x: torch.Tensor, gate_w: torch.Tensor,
                    s_prev: torch.Tensor, tok_prev: torch.Tensor, token_id,
                    bn: int):
    """K5R's function as the decode composed it before: the gate row in
    fp32, its softmax, the TopKUpdate (K5's plain version) and the sort-based
    lane plan. Returns (new_scores, new_ids, GORoute)."""
    g = torch.softmax(x.float() @ gate_w.float(), dim=-1)          # [B, E]
    s, t, sel, slot = go_topk_update_plain(s_prev, tok_prev, g, token_id)
    return s, t, GORoute(g, sel, slot, go_lane_plan(sel, g, bn))


def _check_router(name, x, gate_w, s_prev, tok_prev, token_id, bn):
    """Validate shapes and bounds (on every device); on a card also dtypes
    and layouts. Returns the device kind ("cpu" or "cuda")."""
    if x.dim() != 2 or gate_w.dim() != 2 or gate_w.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, gate_w "
                         f"{tuple(gate_w.shape)} (want [B, d], [d, E])")
    B, E = x.shape[0], gate_w.shape[1]
    if s_prev.dim() != 3 or tuple(s_prev.shape[:2]) != (B, E) \
            or tok_prev.shape != s_prev.shape:
        raise ValueError(f"{name}: scores {tuple(s_prev.shape)}, ids "
                         f"{tuple(tok_prev.shape)} (want [{B}, {E}, k])")
    if torch.is_tensor(token_id) and tuple(token_id.shape) != (B,):
        raise ValueError(f"{name}: token_id {tuple(token_id.shape)}, want an "
                         f"int or [{B}]")
    if not router_fits(B, E):
        raise ValueError(f"{name}: B {B} and E {E} must lie in 1.."
                         f"{ROUTER_MAX} (the router keeps the [B, E] "
                         "selection in one CTA)")
    if int(bn) < 1:
        raise ValueError(f"{name}: bn {bn}, want a positive tile height")
    devs = {x.device, gate_w.device, s_prev.device, tok_prev.device}
    if torch.is_tensor(token_id):
        devs.add(token_id.device)
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on {sorted(map(str, devs))}")
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no router path for device {x.device}")
    if kind == "cuda":
        build.no_autograd(name, x, gate_w, s_prev, tok_prev)
        if x.dtype not in _ROUTER_DTYPES or gate_w.dtype not in _ROUTER_DTYPES:
            raise TypeError(f"{name}: no kernel for x {x.dtype} and gate_w "
                            f"{gate_w.dtype} (float32 or bfloat16)")
        if not (x.is_contiguous() and gate_w.is_contiguous()):
            raise ValueError(f"{name}: x and gate_w must be contiguous")
        if torch.is_tensor(token_id) and token_id.dtype not in (torch.int32,
                                                                torch.int64):
            raise TypeError(f"{name}: token ids {token_id.dtype}, want int32 "
                            "or int64")
    return kind


def _route(x, gate_w, s_prev, tok_prev, token_id, bn, s_out, t_out):
    """Launch K5R on contiguous fp32 scores and int32 ids; returns the
    GORoute."""
    B, E, k = s_prev.shape
    d = x.shape[1]
    Cp = -(-B // bn) * bn
    nt = E * Cp // bn
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    g = torch.empty((B, E), dtype=f32, device=dev)
    sel = torch.empty((B, E), dtype=torch.bool, device=dev)
    slot = torch.empty((B, E), dtype=i32, device=dev)
    idx = torch.empty((E, Cp), dtype=i32, device=dev)
    scale = torch.empty(E * Cp, dtype=f32, device=dev)
    tv = torch.empty(nt, dtype=torch.bool, device=dev)
    te = torch.empty(nt, dtype=i32, device=dev)
    rows, splits = router_splits(d, E, gate_w.element_size())
    ws = torch.empty(splits * B * E, dtype=f32, device=dev)
    if torch.is_tensor(token_id):
        tid_vec = token_id.contiguous()
        tid_ptr, tid_bytes, tid = tid_vec.data_ptr(), tid_vec.element_size(), 0
    else:
        tid = int(token_id)
        if not -2 ** 31 <= tid < 2 ** 31:
            raise ValueError(f"go_router: token id {tid} is no int32")
        tid_ptr, tid_bytes = None, 0
    fn = getattr(_lib(), f"go_router_{_ROUTER_DTYPES[x.dtype]}_"
                         f"{_ROUTER_DTYPES[gate_w.dtype]}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(x.data_ptr(), gate_w.data_ptr(), s_prev.data_ptr(),
            tok_prev.data_ptr(), tid_ptr, tid_bytes, tid, s_out.data_ptr(),
            t_out.data_ptr(), g.data_ptr(), sel.data_ptr(), slot.data_ptr(),
            idx.data_ptr(), scale.data_ptr(), tv.data_ptr(), te.data_ptr(),
            ws.data_ptr(), _counter(dev).data_ptr(), B, E, k, d, rows, splits,
            Cp, bn, stream)
    build.check(rc, "go_router")
    LAUNCHES["go_router"] += 1
    return GORoute(g, sel, slot, GOPlan(idx, scale, tv, te, bn))


def go_router(x: torch.Tensor, gate_w: torch.Tensor, s_prev: torch.Tensor,
              tok_prev: torch.Tensor, token_id, bn: int):
    """K5R, functional. x [B, d], gate_w [d, E], s_prev [B, E, k] fp32,
    tok_prev [B, E, k] int32, token_id an int or [B], bn the decode tile's
    rows -> (new_scores, new_ids, GORoute)."""
    if _check_router("go_router", x, gate_w, s_prev, tok_prev, token_id,
                     bn) == "cpu":
        return go_router_plain(x, gate_w, s_prev, tok_prev, token_id, bn)
    sp = s_prev.to(torch.float32).contiguous()
    tp = tok_prev.to(torch.int32).contiguous()
    s_out, t_out = torch.empty_like(sp), torch.empty_like(tp)
    r = _route(x, gate_w, sp, tp, token_id, int(bn), s_out, t_out)
    return s_out, t_out, r


def go_router_(x: torch.Tensor, gate_w: torch.Tensor, scores: torch.Tensor,
               token_ids: torch.Tensor, token_id, bn: int) -> GORoute:
    """K5R in place (the decode's form): the new scores and ids are written
    into `scores` (fp32) and `token_ids` (int32), which must be contiguous
    (a hidden copy would drop the write). Returns the GORoute."""
    kind = _check_router("go_router_", x, gate_w, scores, token_ids,
                         token_id, bn)
    if not (scores.is_contiguous() and token_ids.is_contiguous()):
        raise ValueError("go_router_: scores and token_ids must be "
                         "contiguous to be updated in place")
    if scores.dtype != torch.float32 or token_ids.dtype != torch.int32:
        raise TypeError(f"go_router_: scores {scores.dtype} and ids "
                        f"{token_ids.dtype}, want float32 and int32")
    if kind == "cpu":
        s, t, r = go_router_plain(x, gate_w, scores, token_ids, token_id, bn)
        scores.copy_(s)
        token_ids.copy_(t)
        return r
    return _route(x, gate_w, scores, token_ids, token_id, int(bn), scores,
                  token_ids)
