"""Eviction: top-k selection + per-kv-head gather into a budgeted cache.

``evict_layer`` turns one layer's scores into that layer's decode cache:
``capacity`` kept slots per (batch, kv head) in position order, a validity
mask, and ``extra_slots`` empty tail rows for decode appends.

Tie rule: ``jax.lax.top_k`` breaks ties toward the lower index, and the
scores reach it after max-pooling, whose plateaus are exact ties.
``torch.topk`` promises no order on ties, so selection here is a stable
descending sort (equal scores keep index order), which keeps the same
sets as the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_INT32_MAX = 2**31 - 1


class EvictedKV(NamedTuple):
    k: torch.Tensor  # (B, capacity, KV, hd)
    v: torch.Tensor  # (B, capacity, KV, hd)
    pos: torch.Tensor  # (B, capacity, KV) original token positions, int32
    mask: torch.Tensor  # (B, capacity, KV) slot validity


def uniform_budgets(num_layers: int, budget: int) -> list:
    return [budget] * num_layers


def select_topk(
    scores: torch.Tensor,  # (B, KV, n) post-processed scores
    capacity: int,
    *,
    layer_budget: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``capacity`` indices per (batch, kv head), sorted by position.
    Returns (idx (B, KV, capacity) int64, mask (B, KV, capacity) bool)."""
    n = scores.shape[-1]
    cap = min(capacity, n)
    idx = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[..., :cap]
    mask = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    if layer_budget is not None:
        mask &= torch.arange(cap, device=idx.device) < layer_budget
    if cap < capacity:  # pad to the static capacity
        pad = capacity - cap
        idx = torch.nn.functional.pad(idx, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    # restore temporal order (invalid slots last, in selection order)
    key = torch.where(mask, idx, torch.full_like(idx, _INT32_MAX))
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.gather(idx, -1, order), torch.gather(mask, -1, order)


def gather_kv(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
              mask: torch.Tensor) -> EvictedKV:
    """Per-kv-head gather of the kept slots; invalid slots are zeroed."""
    B, S, KV, hd = k.shape
    cap = idx.shape[-1]
    ik = idx.transpose(1, 2)  # (B, cap, KV)
    g = ik[..., None].expand(B, cap, KV, hd)
    m = mask.transpose(1, 2)
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    kk = torch.where(m[..., None], torch.gather(k, 1, g), zero)
    vv = torch.where(m[..., None], torch.gather(v, 1, g), zero)
    return EvictedKV(k=kk, v=vv, pos=ik.to(torch.int32), mask=m)


def evict_layer(
    scores: torch.Tensor,  # (B, KV, n_prompt)
    k: torch.Tensor,  # (B, n_prompt, KV, hd)
    v: torch.Tensor,
    capacity: int,
    *,
    layer_budget: Optional[int] = None,
    extra_slots: int = 0,
    key_mask: Optional[torch.Tensor] = None,  # (B, n_prompt) real keys
) -> EvictedKV:
    """Evict one layer's prompt KV down to ``capacity`` kept slots, plus
    ``extra_slots`` empty tail rows.  Keys outside ``key_mask`` may still
    be selected (capacity beyond the prompt) but come out masked."""
    idx, mask = select_topk(scores, capacity, layer_budget=layer_budget)
    if key_mask is not None:
        mask &= torch.gather(key_mask[:, None, :].expand(-1, idx.shape[1], -1),
                             -1, idx)
    ev = gather_kv(k, v, idx, mask)
    if extra_slots:
        def pad(x):
            return torch.nn.functional.pad(
                x, (0, 0) * (x.dim() - 2) + (0, extra_slots))

        ev = EvictedKV(k=pad(ev.k), v=pad(ev.v), pos=pad(ev.pos),
                       mask=pad(ev.mask))
    return ev
