"""Eviction: top-k selection + per-kv-head gather into a budgeted cache.

``evict_layer`` turns one layer's scores into that layer's decode cache:
``capacity`` kept slots per (batch, kv head) in position order, a validity
mask, and ``extra_slots`` empty tail rows for decode appends.  A per-layer
budget (PyramidKV, ``pyramid_budgets``) or per-(sequence, kv head) budgets
(Ada-KV, ``adaptive_head_budgets``) invalidate slots past the budget.

Position policies (StreamingLLM's sink + recent, random, full) are
synthetic score vectors (``position_scores``), so one top-k path serves
every policy.  ``random`` draws JAX's own numbers: ``threefry2x32`` below
is the ``jax.random`` block cipher, so the port keeps the same random
positions as the JAX package for the same seeds.  The sampled decode of
``policies`` draws from the same stream (``PRNGKey``, ``split``,
``categorical``), so it samples the JAX package's tokens.

Tie rule: ``jax.lax.top_k`` breaks ties toward the lower index, and the
scores reach it after max-pooling, whose plateaus are exact ties.
``torch.topk`` promises no order on ties, so selection here is a stable
descending sort (equal scores keep index order), which keeps the same
sets as the JAX package.
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple, Optional

import numpy as np
import torch

_INT32_MAX = 2**31 - 1


class EvictedKV(NamedTuple):
    k: torch.Tensor  # (B, capacity, KV, hd)
    v: torch.Tensor  # (B, capacity, KV, hd)
    pos: torch.Tensor  # (B, capacity, KV) original token positions, int32
    mask: torch.Tensor  # (B, capacity, KV) slot validity


_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(key: tuple, count: tuple) -> tuple:
    """The Threefry-2x32 block cipher (20 rounds) of ``jax.random``'s
    default generator: (key1, key2) encrypts (count1, count2).  Every
    operand is an int64 tensor (or int) holding a uint32; the result is
    two such tensors, broadcast over the operands."""
    k1, k2 = (torch.as_tensor(x, dtype=torch.int64) for x in key)
    x0, x1 = (torch.as_tensor(x, dtype=torch.int64) for x in count)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def PRNGKey(seed) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (an int or an int
    tensor, broadcast): the raw key (0, seed mod 2^32)."""
    s = torch.as_tensor(seed, dtype=torch.int64) & _MASK32
    return torch.zeros_like(s), s


def fold_in(key: tuple, data) -> tuple:
    """``jax.random.fold_in`` on a raw (key1, key2) key: ``data`` is a
    uint32 (an int64 tensor, masked to 32 bits), broadcast."""
    d = torch.as_tensor(data, dtype=torch.int64) & _MASK32
    return threefry2x32(key, (torch.zeros_like(d), d))


def _counters(n: int, device) -> tuple:
    """The flat iota 0..n-1 as (high, low) uint32 words (JAX's
    ``iota_2x32_shape``)."""
    c = torch.arange(n, dtype=torch.int64, device=device)
    return c >> 32, c & _MASK32


def split(key: tuple, num: int) -> tuple:
    """``jax.random.split(key, num)`` (``jax_threefry_partitionable``):
    key ``i`` is the cipher of counter ``i``, returned as two (num,)
    words, one key per index."""
    k1, k2 = (torch.as_tensor(x, dtype=torch.int64) for x in key)
    return threefry2x32((k1, k2), _counters(num, k1.device))


def random_bits(key: tuple, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` as uint32 values in int64 (the
    partitionable stream: element ``i`` of the flattened shape is the XOR
    of the cipher's two words of counter ``i``).  The key's words may
    carry a batch shape K, one key per index; the result is K + shape."""
    k1, k2 = (torch.as_tensor(x, dtype=torch.int64) for x in key)
    n = 1
    for d in shape:
        n *= d
    hi, lo = (c.reshape(shape) for c in _counters(n, k1.device))
    lead = k1.shape + (1,) * len(shape)
    b1, b2 = threefry2x32((k1.reshape(lead), k2.reshape(lead)), (hi, lo))
    return b1 ^ b2


def uniform(key: tuple, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits of ``random_bits`` as a mantissa of [1, 2), minus 1,
    scaled into [minval, maxval) and floored at ``minval``.  XLA fuses
    the scale and shift into one multiply-add, rounded once: the float64
    product here is exact and its sum rounds to float32 as that does.
    With the default ``shape`` one number per key (counter 0)."""
    bits = random_bits(key, shape)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    # float32 bounds as host scalars: no tensor is copied to the device
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(lo))
    return torch.clamp((f.double() * scale + lo).float(), min=lo)


_TINY32 = float(torch.finfo(torch.float32).tiny)


def gumbel(key: tuple, shape: tuple) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default "low"
    mode: ``-log(-log(u))`` of a uniform ``u`` in [tiny, 1).  The bits
    are JAX's exactly; the two logs may differ from XLA's by an ulp."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_TINY32,
                                         maxval=1.0)))


def categorical(key: tuple, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max
    trick, ties to the lower index as ``argmax``).  One key for the whole
    array draws its Gumbel noise over ``logits.shape``; keys with a batch
    shape K (``jax.vmap`` over rows) draw over ``logits.shape[len(K):]``
    each."""
    key = tuple(torch.as_tensor(x, dtype=torch.int64, device=logits.device)
                for x in key)
    noise = gumbel(key, tuple(logits.shape[key[0].dim():]))
    return torch.argmax(noise + logits, dim=-1)


def position_scores(
    policy: str,
    n_prompt: int,
    batch: int,
    num_kv_heads: int,
    *,
    sink: int = 4,
    seeds: Optional[torch.Tensor] = None,  # (B,) per-request seeds
    device=None,
) -> torch.Tensor:
    """Synthetic (B, KV, n_prompt) float32 scores for the attention-free
    policies: ``streaming_llm`` ranks the ``sink`` first positions, then
    the most recent; ``full`` scores every position 1; ``random`` draws
    ``uniform(fold_in(fold_in(PRNGKey(0), seeds[b]), p))`` for
    position p of row b (without ``seeds``, ``uniform(fold_in(
    PRNGKey(0), p))`` for every row), folded per position so that the
    value at a position does not depend on the vector's length (chunked
    and monolithic prefill score different lengths).  The JAX package's
    numbers, bit for bit."""
    pos = torch.arange(n_prompt, dtype=torch.float32, device=device)
    if policy == "streaming_llm":
        s = pos + torch.where(pos < sink, 1e9, 0.0)
    elif policy == "full":
        s = torch.ones((n_prompt,), dtype=torch.float32, device=device)
    elif policy == "random":
        base = (0, 0)  # jax.random.PRNGKey(0)
        p = torch.arange(n_prompt, dtype=torch.int64, device=device)
        if seeds is not None:
            rs = seeds.to(device=p.device, dtype=torch.int64)[:, None]
            s = uniform(fold_in(fold_in(base, rs), p))  # (B, n_prompt)
            return s[:, None, :].expand(batch, num_kv_heads, n_prompt)
        s = uniform(fold_in(base, p))
    else:
        raise ValueError(f"not a position policy: {policy}")
    return s[None, None, :].expand(batch, num_kv_heads, n_prompt)


def keep_window(scores: torch.Tensor, window: int) -> torch.Tensor:
    """Force-keep the last ``window`` prompt tokens (SnapKV convention)."""
    n = scores.shape[-1]
    boost = torch.where(torch.arange(n, device=scores.device) >= n - window,
                        1e9, 0.0)
    return scores + boost


def uniform_budgets(num_layers: int, budget: int) -> list:
    return [budget] * num_layers


def _fma32(a, b, c) -> np.float32:
    """float32 fused multiply-add, a * b + c rounded once (to nearest,
    ties to even), from the exact rational value."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                     int(np.asarray(x).view(np.int32)) & 1))


def pyramid_budgets(num_layers: int, budget: int, beta: float) -> list:
    """PyramidKV's funnel: per-layer budgets falling linearly from
    ~2β/(β+1)·budget to ~2/(β+1)·budget (mean ``budget``), at least 1.

    The JAX package takes ``jnp.linspace(hi, lo, L)`` in float32 and
    truncates; the budgets here are the values XLA's CPU compilation of
    it gives, checked against JAX over a grid of (L, budget, β) by the
    tests: with ``r = 1 / (L - 1)``, entry i is ``fma(i, lo * r, hi * (1
    - i * r))``, except that for L <= 34 (a loop XLA unrolls, where i = 1
    folds to a constant) entry 1 is ``fma(hi, 1 - r, lo * r)``; the last
    entry is ``lo``.  ``torch.linspace`` rounds otherwise.  Fitted to
    XLA's CPU backend in jax / jaxlib 0.9.0: another XLA build may round
    otherwise, and then this emulation is refitted (ROADMAP C)."""
    f32 = np.float32
    hi = f32(2.0 * beta / (beta + 1.0) * budget)
    lo = f32(2.0 / (beta + 1.0) * budget)
    vals = [hi]
    div = num_layers - 1
    if div > 0:
        r = f32(1) / f32(div)
        lr = f32(lo * r)
        for i in range(1, div):
            om = f32(1) - f32(i) * r
            vals.append(_fma32(hi, om, lr) if i == 1 and div <= 33
                        else _fma32(i, lr, hi * om))
        vals.append(lo)
    return [max(int(v), 1) for v in np.asarray(vals, f32).astype(np.int32)]


def adaptive_head_budgets(
    scores: torch.Tensor,  # (B, KV, n) post-processed scores
    total_budget: int,  # per-head budget x KV = the global pool
    capacity: int,  # static per-head slot count (>= any budget)
    *,
    floor: int = 4,
) -> torch.Tensor:
    """Ada-KV's adaptive allocation: the pool ``KV * total_budget`` is
    shared among the kv heads of each sequence in proportion to the mass
    of each head's top ``total_budget`` scores, clipped to ``[floor,
    capacity]``, with three rounds of water-filling for what the clips
    strand and a final one-slot bonus to the heads of highest raw share
    that still have room (ranked by a stable sort, as JAX's argsort).
    Returns (B, KV) int64 budgets."""
    B, KV, n = scores.shape
    pool = KV * total_budget
    k = min(total_budget, n)
    top = torch.sort(scores, dim=-1, descending=True,
                     stable=True).values[..., :k]
    mass = top.sum(-1)
    frac = mass / torch.clamp(mass.sum(dim=1, keepdim=True), min=1e-9)
    raw = frac * pool
    b = torch.clamp(raw.to(torch.int32).long(), floor, capacity)
    for _ in range(3):
        deficit = torch.clamp(pool - b.sum(dim=1, keepdim=True), min=0)
        room = capacity - b
        nroom = torch.clamp((room > 0).sum(dim=1, keepdim=True), min=1)
        b = b + torch.minimum(room, torch.div(deficit, nroom,
                                              rounding_mode="floor"))
    leftover = torch.clamp(pool - b.sum(dim=1, keepdim=True), min=0)
    key = -torch.where(b < capacity, raw, float("-inf"))
    order = torch.argsort(key, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    bonus = (rank < leftover).long()
    return torch.clamp(b + bonus, floor, capacity)


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


def select_topk_per_head(
    scores: torch.Tensor,  # (B, KV, n)
    capacity: int,
    head_budgets: torch.Tensor,  # (B, KV) budgets <= capacity
) -> tuple[torch.Tensor, torch.Tensor]:
    """``select_topk`` with a budget per (sequence, kv head): the same
    ``capacity`` slots, those past the head's budget masked invalid."""
    n = scores.shape[-1]
    cap = min(capacity, n)
    idx = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[..., :cap]
    mask = torch.arange(cap, device=idx.device) < head_budgets[..., None]
    if cap < capacity:
        pad = capacity - cap
        idx = torch.nn.functional.pad(idx, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
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
    head_budgets: Optional[torch.Tensor] = None,  # (B, KV) Ada-KV budgets
    extra_slots: int = 0,
    key_mask: Optional[torch.Tensor] = None,  # (B, n_prompt) real keys
) -> EvictedKV:
    """Evict one layer's prompt KV down to ``capacity`` kept slots, plus
    ``extra_slots`` empty tail rows.  Keys outside ``key_mask`` may still
    be selected (capacity beyond the prompt) but come out masked."""
    if head_budgets is not None:
        idx, mask = select_topk_per_head(scores, capacity, head_budgets)
    else:
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
