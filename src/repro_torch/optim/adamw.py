"""AdamW, the cosine schedule, global-norm clipping and gradient
accumulation. Counterpart of repro/optim/adamw.py.

A parameter tree is nested dicts of tensors. The optimizer state keeps
the reference's layout (`AdamWState`: an int32 step, fp32 first and
second moments in the parameters' tree, None for a non-float leaf), so
the checkpointer writes it as the JAX package does. Where the reference
returns new trees, `adamw_update` writes the parameters and moments IN
PLACE, with the reference's order of operations. It casts the gradients
to fp32 leaf by leaf, and a large leaf slice by slice along its first
axis (every operation is elementwise, so the numbers are the same): a
full-width step never holds a second fp32 copy of every gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

# elements of one leaf's fp32 working slice in adamw_update (512 MB)
_SLICE = 1 << 27


class AdamWState(NamedTuple):
    step: torch.Tensor       # [] int32
    m: dict                  # first moment (fp32, same tree as params)
    v: dict                  # second moment (fp32)


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in sorted-key order (jax.tree.leaves's
    order), Nones left out."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def adamw_init(params: dict) -> AdamWState:
    some = tree_leaves(params)[0]

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                        if p.is_floating_point() else None, params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=some.device),
                      zeros(), zeros())


def cosine_lr(step, *, base_lr: float, warmup: int, total: int,
              min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup over `warmup` steps, then a cosine decay to
    min_frac * base_lr at `total`; fp32, on the step's device."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = base_lr * (step + 1) / max(1, warmup)
    prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos).float()


def _slices(t: torch.Tensor) -> list:
    """Views of t covering it: t itself, or, past _SLICE elements, runs of
    its first axis."""
    if t.numel() <= _SLICE or t.dim() == 0:
        return [t]
    per = max(1, _SLICE // max(1, t[0].numel()))
    return list(t.split(per, dim=0))


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    total = 0
    for part in _slices(x):
        total = total + torch.sum(torch.square(part.float()))
    return total


def _norm(leaves: list) -> torch.Tensor:
    total = 0
    for x in leaves:
        total = total + _sq_sum(x)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def global_norm(tree) -> torch.Tensor:
    return _norm(tree_leaves(tree))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm) in fp32, norm)."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x.float() * scale, grads), g


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step IN PLACE on `params` and the state's moments.
    Returns (params, new_state, {"grad_norm"}); the new state holds the
    same moment tensors and step + 1."""
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(tree_map(lambda p, g: g if p.is_floating_point()
                                  else None, params, grads))
    flat_m, flat_v = tree_leaves(state.m), tree_leaves(state.v)
    floats = [p for p in flat_p if p.is_floating_point()]
    gnorm = _norm(flat_g)
    scale = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if grad_clip > 0 else None)
    t = state.step + 1
    c1 = 1.0 - b1 ** t.float()
    c2 = 1.0 - b2 ** t.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    for p, g, m, v in zip(floats, flat_g, flat_m, flat_v):
        for ps, gs, ms, vs in zip(*map(_slices, (p, g, m, v))):
            g32 = gs.float()
            if scale is not None:
                g32 = g32 * scale
            ms.mul_(b1).add_((1 - b1) * g32)
            vs.mul_(b2).add_((1 - b2) * g32 * g32)
            del g32
            upd = (ms / c1).div_(torch.sqrt(vs / c2).add_(eps))
            p32 = ps.float()
            upd.add_(weight_decay * p32)
            ps.copy_(p32.sub_(lr * upd))
    return params, AdamWState(t, state.m, state.v), {"grad_norm": gnorm}


def accumulate_grads(loss_fn, params: dict, microbatches: dict, cfg):
    """Gradient accumulation over the leading microbatch axis of every
    batch array: (fp32 mean gradient tree, mean loss). `params`' float
    leaves must require grad."""
    leaves = [p for p in tree_leaves(params) if p.requires_grad]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=leaves[0].device)
    n = next(iter(microbatches.values())).shape[0]
    for i in range(n):
        loss, _ = loss_fn(params, {k: v[i] for k, v in microbatches.items()},
                          cfg)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g.float())
        loss_acc = loss_acc + loss.detach()
    inv = 1.0 / n
    by_leaf = {id(p): a * inv for p, a in zip(leaves, acc)}
    return (tree_map(lambda p: by_leaf.get(id(p)), params), loss_acc * inv)
