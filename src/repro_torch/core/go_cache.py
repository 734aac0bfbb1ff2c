"""C4 — the gate-output (GO) cache for expert-choice decoding (paper §III.C,
eq. 4-5). Counterpart of repro/core/go_cache.py.

  scores    [B, E, k]      cached top-k gate affinities per expert
  token_ids [B, E, k]      which absolute token each slot holds
  outputs   [B, E, k, d]   cached weighted expert outputs G[t,e] * E_e(x_t)

Each decode step runs one gate row, a TopKUpdate against the cached minima,
and expert FFNs only for the experts that selected the incoming token; on
a card the first two and the FFN's lane plan are one launch (the router
K5R, kernels/go_topk.py) up to 64 rows and 64 experts, and past that the
TopKUpdate is K5's launch.
Unlike the JAX version, `go_cache_step` and the slot ops write the updated
entries into the cache's tensors IN PLACE (they are views of the decode
state's per-layer buffers), where JAX carries a new cache through its
layer scan.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.routing import stable_topk
from repro_torch.kernels.go_topk import (GORoute, go_lane_plan, go_router_,
                                         go_topk_update, go_topk_update_,
                                         router_fits)
from repro_torch.kernels.ops import default_block_rows


class GOCache(NamedTuple):
    scores: torch.Tensor      # [..., B, E, k] fp32
    token_ids: torch.Tensor   # [..., B, E, k] int32
    outputs: torch.Tensor     # [..., B, E, k, d] (cfg dtype)


def go_cache_init(batch: int, num_experts: int, k: int, d: int, dtype,
                  device, lead: tuple = ()) -> GOCache:
    """Empty cache (scores -inf, ids -1, outputs 0); `lead` prepends axes
    (the decode state's layer axis)."""
    shp = (*lead, batch, num_experts, k)
    return GOCache(
        scores=torch.full(shp, float("-inf"), dtype=torch.float32,
                          device=device),
        token_ids=torch.full(shp, -1, dtype=torch.int32, device=device),
        outputs=torch.zeros((*shp, d), dtype=dtype, device=device),
    )


def go_cache_init_slot(cache: GOCache, slot: int) -> None:
    """Reset batch row `slot` to the empty state (scores -inf, ids -1,
    outputs 0) IN PLACE; leading (layer) axes before the batch axis are
    all reset."""
    cache.scores[..., slot, :, :] = float("-inf")
    cache.token_ids[..., slot, :, :] = -1
    cache.outputs[..., slot, :, :, :] = 0


def go_cache_write_slot(cache: GOCache, slot: int, src: GOCache) -> None:
    """Write a batch-1 cache (a single-request prefill) into batch row
    `slot` of a pooled cache IN PLACE; leading (layer) axes match."""
    cache.scores[..., slot, :, :] = src.scores[..., 0, :, :]
    cache.token_ids[..., slot, :, :] = src.token_ids[..., 0, :, :]
    cache.outputs[..., slot, :, :, :] = src.outputs[..., 0, :, :, :].to(
        cache.outputs.dtype)


def go_cache_prefill(scores, token_ids, expert_outputs: torch.Tensor,
                     chosen_tokens: torch.Tensor, chosen_scores: torch.Tensor,
                     k: int) -> GOCache:
    """Build the cache from a prefill pass: per expert, the k best of its C
    chosen tokens. expert_outputs [B, E, C, d]; chosen_* [B, E, C]. When
    C < k the spare slots stay empty (-inf / -1 / 0). `scores` and
    `token_ids` are unused, as in the reference signature."""
    del scores, token_ids
    C = chosen_scores.shape[-1]
    if C < k:
        pad = k - C
        chosen_scores = torch.nn.functional.pad(
            chosen_scores, (0, pad), value=float("-inf"))
        chosen_tokens = torch.nn.functional.pad(chosen_tokens, (0, pad),
                                                value=-1)
        expert_outputs = torch.nn.functional.pad(expert_outputs,
                                                 (0, 0, 0, pad))
    top_s, top_slot = stable_topk(chosen_scores, k)               # [B, E, k]
    tok = torch.gather(chosen_tokens, -1, top_slot)
    out = torch.gather(
        expert_outputs, 2,
        top_slot[..., None].expand(*top_slot.shape, expert_outputs.shape[-1]))
    return GOCache(top_s.float(), tok.to(torch.int32), out)


def go_cache_merge(old: GOCache, new: GOCache) -> GOCache:
    """Merge two caches over the same [B, E] grid: per expert, keep the k
    best-scoring entries of the union (the chunked-prefill hook: each chunk
    builds its own cache and folds into the accumulated one). Pass the
    OLDER cache first: on a tie the earlier operand wins, as with
    `jax.lax.top_k` in the reference, so the chunked stream is
    deterministic."""
    k = old.scores.shape[-1]
    scores = torch.cat([old.scores, new.scores], dim=-1)         # [B, E, 2k]
    top_s, idx = stable_topk(scores, k)
    tok = torch.gather(torch.cat([old.token_ids, new.token_ids], dim=-1),
                       -1, idx)
    outs = torch.cat([old.outputs, new.outputs.to(old.outputs.dtype)], dim=-2)
    out = torch.gather(outs, -2, idx[..., None].expand(*idx.shape,
                                                       outs.shape[-1]))
    return GOCache(top_s, tok, out)


class GOStepResult(NamedTuple):
    y: torch.Tensor             # [B, d] MoE output for the incoming token
    cache: GOCache              # the same tensors, updated in place
    selected: torch.Tensor      # [B, E] bool — which experts took the token


def go_cache_step(cache: GOCache, x_t: torch.Tensor, token_id,
                  gate_w: torch.Tensor, expert_fn=None, *, contrib_fn=None,
                  bn: int | None = None) -> GOStepResult:
    """One expert-choice decode step through the GO cache (eq. 4).

    x_t [B, d]; token_id an int (static batch) or [B]. Expert compute comes
    from exactly one of two callables: `expert_fn(x)` -> [B, E, d], all E
    expert FFNs (the "xla" dense fallback, weighted by g and masked to the
    selecting experts here), or `contrib_fn(x, sel, g)`, which returns the
    fp32 weighted contributions [B, E, d] of the SELECTED pairs, zero
    elsewhere (kernels/ops.py:go_selected_ffn). With `bn` (the
    decode tile's rows) the step also hands it the lane plan of those
    pairs at that tile, `contrib_fn(x, sel, g, plan=plan)`
    (kernels/ops.py:go_plan_ffn); without, the reference's three-argument
    contract holds. The cache's tensors are updated in place, then the
    selected outputs land in the slots the update replaced.

    The route is a rule of shapes and layout, chosen before any launch:
    a contiguous cache of B and E within the router's bound
    (`router_fits`) takes the router (K5R, one launch on a card: the gate
    row, its softmax, the TopKUpdate and the plan); a wider one runs the
    gate row and its softmax in fp32, K5 in place and `go_lane_plan`,
    which leave the cache's tensors as K5R would; a cache of strided views
    runs the same steps through K5's functional form and two copies."""
    if (expert_fn is None) == (contrib_fn is None):
        raise ValueError("pass exactly one of expert_fn / contrib_fn")
    B, E = x_t.shape[0], gate_w.shape[1]
    contiguous = cache.scores.is_contiguous() and \
        cache.token_ids.is_contiguous()
    if contiguous and router_fits(B, E):
        r = go_router_(x_t, gate_w, cache.scores, cache.token_ids, token_id,
                       bn or default_block_rows(x_t.device))
    else:
        g = torch.softmax(x_t.float() @ gate_w.float(), dim=-1)     # [B, E]
        if contiguous:
            # the decode state's per-layer views past the router's bound
            selected, slot = go_topk_update_(cache.scores, cache.token_ids,
                                             g, token_id)
        else:
            # a cache of strided views (go_cache_prefill's top-k slices,
            # used on their own); making the slices contiguous would cost
            # every prefill a copy per layer
            s, t, selected, slot = go_topk_update(
                cache.scores, cache.token_ids, g, token_id)
            cache.scores.copy_(s)
            cache.token_ids.copy_(t)
        r = GORoute(g, selected, slot,
                    go_lane_plan(selected, g, bn) if bn else None)
    if expert_fn is not None:
        contrib = r.g[..., None] * expert_fn(x_t).float()          # [B, E, d]
        y = torch.where(r.selected[..., None], contrib, 0.0).sum(dim=1)
    else:
        if bn:
            contrib = contrib_fn(x_t, r.selected, r.g, plan=r.plan)
        else:
            contrib = contrib_fn(x_t, r.selected, r.g)
        y = contrib.sum(dim=1)
    k = cache.scores.shape[-1]
    onehot = r.slot[..., None] == torch.arange(k, device=x_t.device)
    write = (r.selected[..., None] & onehot)[..., None]            # [B,E,k,1]
    cache.outputs.copy_(torch.where(
        write, contrib[:, :, None, :].to(cache.outputs.dtype), cache.outputs))
    return GOStepResult(y.to(x_t.dtype), cache, r.selected)
