"""Plain PyTorch versions of the port's kernels.

Deliberately naive (full score matrices in float32): they define the
numbers each CUDA kernel is held to on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``) and they are what a CPU tensor runs
(``kernels/ops.py``).  Each mirrors its JAX counterpart in
``repro/kernels/ref.py`` with the same masking rules.

Shared conventions
------------------
q:  (B, Sq, H, hd)       queries
k:  (B, Sk, KV, hd)      keys   (GQA: H = KV * G, query head h reads kv head h // G)
v:  (B, Sk, KV, hd)      values
Masked logits are ``NEG_INF``; positions are absolute.

Above ``DIRECT_SEQ`` keys the plain route streams instead
(``ops.py``): ``chunked_attention``, ``chunked_lookahead_score`` and
``paged_decode_streaming`` are the JAX package's memory-bounded forms
(``ops._chunked_attention``, ``_chunked_lookahead_score``,
``_paged_decode_streaming``), and ``ChunkedAttention`` is the streaming
attention's gradient, which recomputes each tile's probabilities.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30

#: keys at or below which the plain route forms the whole (Sq, Sk) logits
#: block; above it, it streams (the JAX package's ``ops._DIRECT_SEQ``)
DIRECT_SEQ = 2048


def check_offset(q_offset: int, C: int, K: int) -> None:
    """The chunk must fit the buffer: unlike ``dynamic_update_slice``,
    nothing here clamps the start index silently."""
    if q_offset < 0 or q_offset + C > K:
        raise ValueError(f"chunk of {C} rows at q_offset {q_offset} does not "
                         f"fit a {K}-deep key buffer")


def check_cross(Sq: int, Sk: int, causal: bool, window) -> None:
    """Queries and keys of different lengths take no positions: raise
    unless the call is non-causal and unwindowed."""
    if Sq != Sk and (causal or window is not None):
        raise ValueError(f"flash_attention with Sq {Sq} != Sk {Sk} takes "
                         "causal=False and no window")


def _expand_gqa(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*G, hd) by repeating each kv head."""
    return torch.repeat_interleave(x, group, dim=2)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=None,
    q_pos: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Sk) valid keys
) -> torch.Tensor:
    """Naive (optionally causal and windowed) softmax attention of queries
    at absolute positions ``q_pos`` (B, Sq) (default: the last Sq of the Sk
    positions) over keys at positions 0..Sk-1; ``kv_mask`` hides the keys
    it marks False from every row.  Returns (B, Sq, H, hd) in q.dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(Sk - Sq, Sk, device=dev).expand(B, Sq)
    k_pos = torch.arange(Sk, device=dev)
    kf = _expand_gqa(k, H // KV).float()
    vf = _expand_gqa(v, H // KV).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    ok = torch.ones((B, Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        ok &= k_pos <= q_pos[:, :, None]
    if window is not None:
        ok &= (q_pos[:, :, None] - k_pos) < window
    if kv_mask is not None:
        ok &= kv_mask[:, None, :]
    logits = torch.where(ok[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention of a whole sequence (Sq == Sk): causal, or with
    ``causal=False`` a full softmax over every key; an optional window
    hides keys with ``q_pos - k_pos >= window``, and ``kv_mask`` (B, Sk)
    the keys it marks False.  Without a mask every row sees at least its
    own key; with one, a row that sees no key is the mean of V (softmax
    over ``NEG_INF`` logits, as the JAX reference), which the kernel does
    not reproduce (it gives zeros): callers keep every row a valid key.

    Sq != Sk (whisper's cross-attention: decoder rows over encoder
    frames) only with ``causal=False`` and no window, where positions do
    not enter; it raises otherwise (the JAX package has no such
    caller)."""
    check_cross(q.shape[1], k.shape[1], causal, window)
    return attention(q, k, v, causal=causal, window=window, kv_mask=kv_mask)


def chunk_attention(q, k, v, *, q_offset: int, window=None) -> torch.Tensor:
    """Attention of a C-row chunk at absolute position ``q_offset`` over a
    K-deep buffer (earlier columns visible, causal inside the chunk, later
    columns invisible).  Raises unless the chunk fits: q_offset + C <= K."""
    B, C = q.shape[:2]
    check_offset(q_offset, C, k.shape[1])
    q_pos = (q_offset + torch.arange(C, device=q.device)).expand(B, C)
    return attention(q, k, v, window=window, q_pos=q_pos)


def decode_attention(q, k, v, *,
                     kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query token (B, H, hd) over (B, Sk, KV, hd), with no mask, a
    per-row mask (B, Sk) or a per-kv-head mask (B, Sk, KV).  A (sequence,
    kv head) with no valid row is exact zeros (the kernels' ``l -> max(l,
    1e-30)`` rule), never NaN and never the mean of V."""
    B, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    kf = _expand_gqa(k, group).float()
    vf = _expand_gqa(v, group).float()
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), kf) / math.sqrt(hd)
    if kv_mask is None:
        return torch.einsum("bhk,bkhd->bhd", torch.softmax(logits, dim=-1),
                            vf).to(q.dtype)
    if kv_mask.dim() == 2:
        ok = kv_mask[:, None, :].expand(B, H, Sk)
    else:  # (B, Sk, KV) -> (B, H, Sk)
        ok = torch.repeat_interleave(kv_mask.transpose(1, 2), group, dim=1)
    logits = torch.where(ok, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, vf)
    alive = ok.any(dim=-1)  # (B, H)
    out = torch.where(alive[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.to(q.dtype)


def decode_attention_stats(q, k, v, *,
                           kv_mask: Optional[torch.Tensor] = None):
    """Unnormalised flash-decode partials of one query token (B, H, hd)
    over (B, Sk, KV, hd) under ``decode_attention``'s masks: (m (B, H),
    l (B, H), acc (B, H, hd)), all float32, with m the largest valid
    logit, l = sum exp(s - m) and acc = sum exp(s - m) v over the valid
    rows.  A (sequence, head) with no valid row gives m = ``NEG_INF``
    (finite, as in the JAX package), l = 0 and acc = 0.  Disjoint row
    segments merge exactly with ``merge_attention_stats``."""
    B, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    kf = _expand_gqa(k, group).float()
    vf = _expand_gqa(v, group).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kf) / math.sqrt(hd)
    if kv_mask is None:
        ok = torch.ones((B, H, Sk), dtype=torch.bool, device=q.device)
    elif kv_mask.dim() == 2:
        ok = kv_mask[:, None, :].expand(B, H, Sk)
    else:  # (B, Sk, KV) -> (B, H, Sk)
        ok = torch.repeat_interleave(kv_mask.transpose(1, 2), group, dim=1)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bhk,bkhd->bhd", p, vf)


def merge_attention_stats(parts) -> torch.Tensor:
    """Combine [(m, l, acc), ...] partials of disjoint row segments into
    the normalised attention output (B, H, hd) float32: rescale each to
    the largest m, sum, divide by ``max(l, 1e-30)``, so a (sequence, head)
    empty in every part gives zeros, never NaN (the JAX package's
    ``merge_attention_stats``)."""
    m = parts[0][0]
    for mp, _, _ in parts[1:]:
        m = torch.maximum(m, mp)
    l = acc = 0.0
    for mp, lp, ap in parts:
        corr = torch.exp(mp - m)
        l = l + lp * corr
        acc = acc + ap * corr[..., None]
    return acc / torch.clamp(l, min=1e-30)[..., None]


def lookahead_score(
    q_obs: torch.Tensor,  # (B, n_obs, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd) — prompt keys then obs keys
    n_prompt: int,
    *,
    kv_mask: Optional[torch.Tensor] = None,  # (B, n_prompt) prompt-key validity
    window=None,
    q_offset: Optional[int] = None,  # absolute position of obs row 0
    row_valid: Optional[torch.Tensor] = None,  # (B, n_obs) real-row mask
) -> torch.Tensor:
    """scores[b, h, j] = (1/n_obs) Σ_i softmax_i(q_obs·Kᵀ/√d)[j] over the
    first ``n_prompt`` keys: (B, H, n_prompt) float32.  Obs rows are causal
    among themselves; invalid rows contribute zeros, the denominator stays
    ``n_obs``."""
    B, n_obs, H, hd = q_obs.shape
    Sk, KV = k.shape[1], k.shape[2]
    dev = q_obs.device
    kf = _expand_gqa(k, H // KV).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q_obs.float(), kf) / math.sqrt(hd)
    q_pos = (n_prompt if q_offset is None else q_offset) + torch.arange(
        n_obs, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    ok = k_pos[None, :] <= q_pos[:, None]  # (n_obs, Sk)
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    ok = ok.expand(B, n_obs, Sk)
    if kv_mask is not None:
        full = torch.cat([kv_mask, torch.ones((B, Sk - n_prompt),
                                              dtype=torch.bool, device=dev)],
                         dim=1)
        ok = ok & full[:, None, :]
    logits = torch.where(ok[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)  # (B, H, n_obs, Sk)
    if row_valid is not None:
        probs = probs * row_valid[:, None, :, None].float()
    return probs[..., :n_prompt].mean(dim=2)


def chunk_column_masses(
    q: torch.Tensor,  # (B, C, H, hd) rotary-encoded chunk queries
    k: torch.Tensor,  # (B, K, KV, hd) key buffer; column j holds position j
    *,
    q_offset: int,  # absolute position of q row 0
    window=None,
    row_valid: Optional[torch.Tensor] = None,  # (B, C) real-row mask
) -> torch.Tensor:
    """Summed softmax column masses of the chunk's rows: (B, H, K) float32,
    ``masses[b, h, j] = Σ_i softmax_i[j]`` over the rows ``row_valid``
    keeps (all rows when None).  The row softmax is the chunk attention's
    (causal on absolute positions, optional window, ``NEG_INF`` masking);
    a column no kept row can see is an exact zero, so the h2o accumulator
    summed over chunks matches the monolithic scores up to summation
    order.  The plain version of kernel 2's second output."""
    B, C, H, hd = q.shape
    K, KV = k.shape[1], k.shape[2]
    dev = q.device
    kf = _expand_gqa(k, H // KV).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(C, device=dev)
    k_pos = torch.arange(K, device=dev)
    ok = k_pos[None, :] <= q_pos[:, None]  # (C, K)
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    logits = torch.where(ok[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)  # (B, H, C, K)
    if row_valid is not None:
        probs = probs * row_valid[:, None, :, None].float()
    return probs.sum(dim=2)


def gather_paged(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Block-table view of a paged pool as the dense cache layout:
    pool (N, bs, ...) + table (B, nb) -> (B, nb*bs, ...); logical row c of
    sequence b is ``pool[table[b, c // bs], c % bs]``."""
    B, nb = table.shape
    g = pool[table.long()]  # (B, nb, bs, ...)
    return g.reshape((B, nb * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_decode_attention(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # (N, bs, KV, hd)
    v_pool: torch.Tensor,
    mask_pool: torch.Tensor,  # (N, bs, KV) bool
    table: torch.Tensor,  # (B, nb) int32, 0 = null block
    *,
    pos_pool: Optional[torch.Tensor] = None,  # (N, bs, KV) int32
    new_pos: Optional[torch.Tensor] = None,  # (B,) query positions
    window=None,
) -> torch.Tensor:
    """Gather the whole block-table view and run masked decode attention
    over it.  A sequence/head with no attendable row is exact zeros (the
    kernels' ``l -> max(l, 1e-30)`` rule), never NaN."""
    mask = gather_paged(mask_pool, table)  # (B, S, KV)
    k = gather_paged(k_pool, table)
    v = gather_paged(v_pool, table)
    if window is not None:
        assert pos_pool is not None and new_pos is not None, \
            "sliding-window masking needs pos_pool and new_pos"
        pos = gather_paged(pos_pool, table)
        mask = mask & ((new_pos[:, None, None] - pos) < window)
    return decode_attention(q, k, v, kv_mask=mask)


def paged_decode_masses(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # (N, bs, KV, hd)
    mask_pool: torch.Tensor,  # (N, bs, KV) bool
    table: torch.Tensor,  # (B, nb) int32, 0 = null block
    *,
    pos_pool: Optional[torch.Tensor] = None,  # (N, bs, KV) int32
    new_pos: Optional[torch.Tensor] = None,  # (B,) query positions
    window=None,
    depth: Optional[int] = None,
) -> torch.Tensor:
    """The decode token's normalised softmax mass on every logical cache
    row: (B, H, S) float32, S = nb * bs (or ``depth``, which also limits
    the softmax to the first ``depth`` rows).  Masked rows are exact zeros
    and a (sequence, head) with no attendable row is all zero (the
    kernels' ``l -> max(l, 1e-30)`` rule), so summing masses over steps
    gives the dense evicting step's score recurrence."""
    mask = gather_paged(mask_pool, table)  # (B, S, KV)
    k = gather_paged(k_pool, table)
    if depth is not None:
        k, mask = k[:, :depth], mask[:, :depth]
    if window is not None:
        assert pos_pool is not None and new_pos is not None, \
            "sliding-window masking needs pos_pool and new_pos"
        pos = gather_paged(pos_pool, table)
        if depth is not None:
            pos = pos[:, :depth]
        mask = mask & ((new_pos[:, None, None] - pos) < window)
    B, H, hd = q.shape
    group = H // k.shape[2]
    kf = _expand_gqa(k, group).float()
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), kf) / math.sqrt(hd)
    ok = torch.repeat_interleave(mask.transpose(1, 2), group, dim=1)
    logits = torch.where(ok, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


# ---------------------------------------------------------------------------
# The streaming tier: bounded temporaries above DIRECT_SEQ keys
# ---------------------------------------------------------------------------
#
# Query heads stay grouped by kv head, (B, rows, KV, G, hd), so that no
# key tile is repeated G times.  A tile no row of a block may see by
# position (wholly above the causal diagonal, or wholly before the
# window) is skipped.  That is exact once a row's running max is finite:
# the skipped tile's weights would be exp(NEG_INF - m) = 0.  Before that
# (a row whose first tiles are all masked) m is NEG_INF, the masked
# logits' exp(0) = 1 is garbage in l and acc, and the first tile with a
# key the row sees zeroes it (corr = exp(NEG_INF - m_new) = 0), as in the
# JAX package; skipping such a tile only leaves less garbage to zero.
# A row that sees no key at all (every visible key masked by kv_mask) is
# undefined here as on every route: callers keep every row a valid key.


def _grouped(x: torch.Tensor, kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> float32 (B, S, KV, G, hd)."""
    B, S, H, hd = x.shape
    return x.float().reshape(B, S, kv, H // kv, hd)


def _tile_seen(r_lo: int, r_hi: int, c_lo: int, c_hi: int, causal: bool,
               window) -> bool:
    """Whether some row at a position in [r_lo, r_hi] may see some key in
    [c_lo, c_hi] by position alone (causal, window)."""
    if causal and c_lo > r_hi:
        return False
    return window is None or r_lo - c_hi < window


def _tile_ok(q_pos: torch.Tensor, k0: int, k1: int, causal: bool, window,
             kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The (row, key) pairs a tile may use: (B or 1, rows, k1 - k0)."""
    k_pos = torch.arange(k0, k1, device=q_pos.device)
    ok = torch.ones((1, q_pos.shape[0], k1 - k0), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
    if kv_mask is not None:
        ok = ok & kv_mask[:, None, k0:k1]
    return ok


def _tile_logits(qg: torch.Tensor, kt: torch.Tensor, ok: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Masked logits of grouped queries (B, bq, KV, G, hd) over a key tile
    (B, bk, KV, hd): (B, KV, G, bq, bk) float32."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kt.float()) * scale
    return torch.where(ok[:, None, None], s, NEG_INF)


def _chunked_attention_stats(q, k, v, *, causal, window, q_offset, kv_mask,
                             block_q, block_k):
    """``chunked_attention`` and each row's final running max m and
    normaliser l, float32 (B, H, Sq)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs, ms, ls = [], [], []
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        qg = _grouped(q[:, q0:q1], KV)
        q_pos = q_offset + torch.arange(q0, q1, device=dev)
        m = torch.full((B, KV, G, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q1 - q0), device=dev)
        acc = torch.zeros((B, KV, G, q1 - q0, hd), device=dev)
        for k0 in range(0, Sk, block_k):
            k1 = min(k0 + block_k, Sk)
            if not _tile_seen(q_offset + q0, q_offset + q1 - 1, k0, k1 - 1,
                              causal, window):
                continue
            ok = _tile_ok(q_pos, k0, k1, causal, window, kv_mask)
            s = _tile_logits(qg, k[:, k0:k1], ok, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, v[:, k0:k1].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q1 - q0, H, hd))
        ms.append(m.reshape(B, H, q1 - q0))
        ls.append(l.reshape(B, H, q1 - q0))
    return (torch.cat(outs, dim=1).to(q.dtype), torch.cat(ms, dim=-1),
            torch.cat(ls, dim=-1))


def chunked_attention(q, k, v, *, causal: bool, window=None,
                      q_offset: int = 0,
                      kv_mask: Optional[torch.Tensor] = None,
                      block_q: int = 512, block_k: int = 1024
                      ) -> torch.Tensor:
    """Online-softmax attention over (``block_q`` rows) x (``block_k``
    keys) tiles, the JAX package's ``ops._chunked_attention``: queries at
    ``q_offset + i`` over keys at 0..Sk-1, causal and windowed by those
    positions, ``kv_mask`` (B, Sk) hiding keys; float32 accumulation,
    output (B, Sq, H, hd) in q's dtype.  Sq != Sk with ``causal=False``
    and no window is whisper's cross-attention.  No temporary is larger
    than one tile.  Under autograd every tile's probabilities would be
    kept for the backward: ``ChunkedAttention`` is its gradient."""
    return _chunked_attention_stats(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        kv_mask=kv_mask, block_q=block_q, block_k=block_k)[0]


class ChunkedAttention(torch.autograd.Function):
    """``chunked_attention`` with a backward that recomputes each tile's
    probabilities from the rows' saved (m, l).  Saved: q, k, v in their
    own dtype, the output, and (m, l) float32 (B, H, Sq); no (Sq, Sk)
    tensor outlives a tile.  Per tile, P = exp(S - m) / l, dP = dO V^T,
    dS = P (dP - D) with D = rowsum(dO O); dQ += dS K / sqrt(hd), and
    dK += dS^T Q / sqrt(hd), dV += P^T dO each summed over the kv head's
    group of query heads, in float32.

        ChunkedAttention.apply(q, k, v, causal, window, q_offset, kv_mask,
                               block_q, block_k)
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_mask, block_q,
                block_k):
        out, m, l = _chunked_attention_stats(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            kv_mask=kv_mask, block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, m, l, kv_mask)
        ctx.geometry = (causal, window, q_offset, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l, kv_mask = ctx.saved_tensors
        causal, window, q_offset, block_q, block_k = ctx.geometry
        B, Sq, H, hd = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        G = H // KV
        scale = 1.0 / math.sqrt(hd)
        dev = q.device
        dq = torch.empty((B, Sq, KV, G, hd), device=dev)
        dk = torch.zeros((B, Sk, KV, hd), device=dev)
        dv = torch.zeros((B, Sk, KV, hd), device=dev)
        for q0 in range(0, Sq, block_q):
            q1 = min(q0 + block_q, Sq)
            n = q1 - q0
            qg = _grouped(q[:, q0:q1], KV)
            dog = _grouped(dout[:, q0:q1], KV)
            # D = rowsum(dO O): (B, KV, G, n)
            d = (dog * _grouped(out[:, q0:q1], KV)).sum(-1).permute(
                0, 2, 3, 1)
            mb = m[..., q0:q1].reshape(B, KV, G, n)[..., None]
            lb = torch.clamp(l[..., q0:q1], min=1e-30).reshape(
                B, KV, G, n)[..., None]
            q_pos = q_offset + torch.arange(q0, q1, device=dev)
            dqb = torch.zeros((B, n, KV, G, hd), device=dev)
            for k0 in range(0, Sk, block_k):
                k1 = min(k0 + block_k, Sk)
                if not _tile_seen(q_offset + q0, q_offset + q1 - 1, k0,
                                  k1 - 1, causal, window):
                    continue
                ok = _tile_ok(q_pos, k0, k1, causal, window, kv_mask)
                kt, vt = k[:, k0:k1].float(), v[:, k0:k1].float()
                s = _tile_logits(qg, kt, ok, scale)
                p = torch.where(ok[:, None, None], torch.exp(s - mb) / lb,
                                0.0)
                dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vt)
                ds = p * (dp - d[..., None])
                dqb += torch.einsum("bkgqs,bskd->bqkgd", ds, kt)
                dk[:, k0:k1] += torch.einsum("bkgqs,bqkgd->bskd", ds,
                                             qg) * scale
                dv[:, k0:k1] += torch.einsum("bkgqs,bqkgd->bskd", p, dog)
            dq[:, q0:q1] = dqb * scale
        return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None, None)


def chunked_lookahead_score(
    q_obs: torch.Tensor,  # (B, n_obs, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    n_prompt: int,
    *,
    kv_mask: Optional[torch.Tensor] = None,  # (B, n_prompt)
    window=None,
    q_offset: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,  # (B, n_obs)
    reduce: str = "mean",
    block_k: int = 2048,
) -> torch.Tensor:
    """The two-pass streaming form of ``lookahead_score`` (``reduce=
    "mean"``) and of ``chunk_column_masses`` (``reduce="sum"``), the JAX
    package's ``ops._chunked_lookahead_score``: pass 1 streams each row's
    max and normaliser over ``block_k``-key tiles, pass 2 revisits each
    tile and reduces its normalised probabilities over the rows (invalid
    rows zeroed; the mean's denominator stays n_obs).  Returns (B, H,
    n_prompt) float32; a key no row sees is an exact zero.  Plain
    autograd differentiates it: its tiles total (B, H, n_obs, Sk)."""
    B, n_obs, H, hd = q_obs.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q_obs.device
    scale = 1.0 / math.sqrt(hd)
    off = n_prompt if q_offset is None else int(q_offset)
    q_pos = off + torch.arange(n_obs, device=dev)
    full = None
    if kv_mask is not None:
        full = torch.cat([kv_mask, torch.ones(
            (B, Sk - n_prompt), dtype=torch.bool, device=dev)], dim=1)
    qg = _grouped(q_obs, KV)
    tiles = [(k0, min(k0 + block_k, Sk)) for k0 in range(0, Sk, block_k)]
    seen = [_tile_seen(off, off + n_obs - 1, k0, k1 - 1, True, window)
            for k0, k1 in tiles]

    def logits(k0, k1):
        ok = _tile_ok(q_pos, k0, k1, True, window, full)
        return _tile_logits(qg, k[:, k0:k1], ok, scale)

    m = torch.full((B, KV, G, n_obs), NEG_INF, device=dev)
    l = torch.zeros((B, KV, G, n_obs), device=dev)
    for (k0, k1), keep in zip(tiles, seen):  # pass 1: row max, normaliser
        if keep:
            s = logits(k0, k1)
            m_new = torch.maximum(m, s.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(
                s - m_new[..., None]).sum(dim=-1)
            m = m_new
    l = torch.clamp(l, min=1e-30)
    rv = None
    if row_valid is not None:
        rv = row_valid.float()[:, None, None, :, None]  # (B, 1, 1, n, 1)
    cols = []
    for (k0, k1), keep in zip(tiles, seen):  # pass 2: the rows' mass
        if k0 >= n_prompt:
            break
        if not keep:
            cols.append(torch.zeros((B, H, k1 - k0), device=dev))
            continue
        p = torch.exp(logits(k0, k1) - m[..., None]) / l[..., None]
        if rv is not None:
            p = p * rv
        red = p.mean(dim=3) if reduce == "mean" else p.sum(dim=3)
        cols.append(red.reshape(B, H, k1 - k0))
    return torch.cat(cols, dim=-1)[..., :n_prompt]


def paged_decode_streaming(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # (N, bs, KV, hd)
    v_pool: torch.Tensor,
    mask_pool: torch.Tensor,  # (N, bs, KV) bool
    table: torch.Tensor,  # (B, nb) int32, 0 = null block
    *,
    pos_pool: Optional[torch.Tensor] = None,  # (N, bs, KV) int32
    new_pos: Optional[torch.Tensor] = None,  # (B,) query positions
    window=None,
    score_masses: bool = False,
):
    """Decode attention over the paged pool without the dense gather, the
    JAX package's ``ops._paged_decode_streaming``: an online-softmax scan
    over the block table's columns, one (B, bs) K/V tile at a time.  With
    ``score_masses`` a second scan revisits each tile with the final
    (m, l) and returns ``(out, masses)``, masses (B, H, nb * bs) float32.
    Masked rows weigh exactly zero (a (sequence, head) with no attendable
    row gives zeros, as ``paged_decode_attention``)."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    if window is not None:
        assert pos_pool is not None and new_pos is not None, \
            "sliding-window masking needs pos_pool and new_pos"
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, KV, G, hd)
    cols = table.long().t()  # (nb, B)

    def tile_logits(tb):
        mb = mask_pool[tb]  # (B, bs, KV)
        if window is not None:
            mb = mb & ((new_pos[:, None, None] - pos_pool[tb]) < window)
        s = torch.einsum("bkgd,bskd->bkgs", qg, k_pool[tb].float()) * scale
        mh = mb.permute(0, 2, 1)[:, :, None, :]  # (B, KV, 1, bs)
        return torch.where(mh, s, NEG_INF), mh

    m = torch.full((B, KV, G), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, G), device=q.device)
    acc = torch.zeros((B, KV, G, hd), device=q.device)
    for tb in cols:
        s, mh = tile_logits(tb)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # the where keeps a dead (sequence, head) at l == 0 (m stays
        # NEG_INF, so exp(s - m) would be 1, not 0)
        p = torch.where(mh, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgs,bskd->bkgd", p, v_pool[tb].float())
        m = m_new
    lsafe = torch.clamp(l, min=1e-30)
    out = (acc / lsafe[..., None]).reshape(B, H, hd).to(q.dtype)
    if not score_masses:
        return out
    masses = []
    for tb in cols:
        s, mh = tile_logits(tb)
        p = torch.where(mh, torch.exp(s - m[..., None]), 0.0)
        masses.append((p / lsafe[..., None]).reshape(B, H, -1))
    return out, torch.cat(masses, dim=-1)


# ---------------------------------------------------------------------------
# Mamba-2 SSD scan (ngroups = 1 in every config: B/C shared by the heads)
# ---------------------------------------------------------------------------


def ssd_scan(
    x: torch.Tensor,  # (B, S, nh, hd) pre-discretisation inputs
    dt: torch.Tensor,  # (B, S, nh) softplus'd timesteps
    A: torch.Tensor,  # (nh,) negative decay rates
    Bm: torch.Tensor,  # (B, S, G, ds)
    Cm: torch.Tensor,  # (B, S, G, ds)
    *,
    initial_state: Optional[torch.Tensor] = None,  # (B, nh, hd, ds)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential recurrence (the oracle; tests only):

        h_t = exp(A dt_t) h_{t-1} + dt_t x_t ⊗ B_t,   y_t = h_t · C_t

    Returns (y (B, S, nh, hd), final state (B, nh, hd, ds)), float32."""
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    Bf = torch.repeat_interleave(Bm, nh // G, dim=2).float()
    Cf = torch.repeat_interleave(Cm, nh // G, dim=2).float()
    x, dt, A = x.float(), dt.float(), A.float()
    h = (torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(A[None] * dt[:, t])  # (B, nh)
        h = h * decay[..., None, None] + (
            (dt[:, t, :, None] * x[:, t])[..., None] * Bf[:, t, :, None, :])
        ys.append(torch.einsum("bnhs,bns->bnh", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


def _decay(x: torch.Tensor) -> torch.Tensor:
    """exp of a log-decay clipped to [-60, 0], as every SSD exponent is."""
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssd_scan_chunked(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh)
    A: torch.Tensor,  # (nh,)
    Bm: torch.Tensor,  # (B, S, G, ds)
    Cm: torch.Tensor,  # (B, S, G, ds)
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, nh, hd, ds)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked state-space-duality scan (the JAX package's
    ``ops.ssd_scan_chunked_jnp``): within a chunk of ``chunk`` rows a
    masked quadratic form, y_t = sum_{s<=t} (C_t.B_s) exp(L_t - L_s) dt_s
    x_s + (C_t.h) exp(L_t) with L = cumsum(A dt); between chunks the
    state h <- exp(L_Q) h + sum_s exp(L_Q - L_s) dt_s x_s ⊗ B_s.  Every
    exponent is clipped to [-60, 0].  A ragged tail is zero-padded to
    whole chunks: pad rows have dt = 0, so they leave the state unchanged
    and the padding is exact.  Returns (y (B, S, nh, hd), final state (B,
    nh, hd, ds)), float32."""
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    Q = chunk
    # every chunk's quadratic form at once; only the state carried from
    # chunk to chunk runs in order (one multiply-add per chunk)
    x = x.float().reshape(B, nc, Q, nh, hd)
    dt = dt.float().reshape(B, nc, Q, nh)
    Bf = torch.repeat_interleave(Bm, nh // G, dim=2).float().reshape(
        B, nc, Q, nh, ds)
    Cf = torch.repeat_interleave(Cm, nh // G, dim=2).float().reshape(
        B, nc, Q, nh, ds)
    L = torch.cumsum(A.float()[None, None, None, :] * dt, dim=2)  # log-decays
    idx = torch.arange(Q, device=x.device)
    causal = (idx[:, None] >= idx[None, :]).float()  # (t, s): s <= t
    cb = torch.einsum("bctnd,bcsnd->bcnts", Cf, Bf)  # (B, nc, nh, Q, Q)
    decay = _decay(L[:, :, :, None, :] - L[:, :, None, :, :])  # (.., t, s, nh)
    w = cb * decay.permute(0, 1, 4, 2, 3) * causal
    y_intra = torch.einsum("bcnts,bcsn,bcsnh->bctnh", w, dt, x)
    Lq = L[:, :, -1]  # (B, nc, nh)
    rem = _decay(Lq[:, :, None, :] - L)  # (B, nc, Q, nh)
    dstate = torch.einsum("bcsn,bcsn,bcsnh,bcsnd->bcnhd", rem, dt, x, Bf)
    carry = _decay(Lq)[..., None, None]  # (B, nc, nh, 1, 1)
    h = (torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    hs = []  # the state entering each chunk
    for c in range(nc):
        hs.append(h)
        h = torch.addcmul(dstate[:, c], h, carry[:, c])
    y_inter = torch.einsum("bctnd,bcnhd,bctn->bctnh", Cf, torch.stack(hs, 1),
                           _decay(L))
    y = (y_intra + y_inter).reshape(B, nc * Q, nh, hd)
    return y[:, :S], h
