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
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def check_offset(q_offset: int, C: int, K: int) -> None:
    """The chunk must fit the buffer: unlike ``dynamic_update_slice``,
    nothing here clamps the start index silently."""
    if q_offset < 0 or q_offset + C > K:
        raise ValueError(f"chunk of {C} rows at q_offset {q_offset} does not "
                         f"fit a {K}-deep key buffer")


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
    hides keys with ``q_pos - k_pos >= window``, and ``kv_mask`` (B, S)
    the keys it marks False.  Without a mask every row sees at least its
    own key; with one, a row that sees no key is the mean of V (softmax
    over ``NEG_INF`` logits, as the JAX reference), which the kernel does
    not reproduce (it gives zeros): callers keep every row a valid key."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention needs Sq == Sk, got {q.shape[1]} "
                         f"and {k.shape[1]}")
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
    x, dt, A = x.float(), dt.float(), A.float()
    Bf = torch.repeat_interleave(Bm, nh // G, dim=2).float()
    Cf = torch.repeat_interleave(Cm, nh // G, dim=2).float()
    a = A[None, None, :] * dt  # (B, Sp, nh) log-decays, <= 0
    h = (torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :]).float()  # (t, s): s <= t
    ys = []
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, bc, cc = x[:, rows], dt[:, rows], Bf[:, rows], Cf[:, rows]
        L = torch.cumsum(a[:, rows], dim=1)  # (B, Q, nh)
        cb = torch.einsum("btnd,bsnd->bnts", cc, bc)  # (B, nh, Q, Q)
        decay = _decay(L[:, :, None, :] - L[:, None, :, :])  # (B, t, s, nh)
        w = cb * decay.permute(0, 3, 1, 2) * causal
        y_intra = torch.einsum("bnts,bsn,bsnh->btnh", w, dtc, xc)
        y_inter = torch.einsum("btnd,bnhd,btn->btnh", cc, h, _decay(L))
        Lq = L[:, -1]  # (B, nh)
        rem = _decay(Lq[:, None, :] - L)  # (B, Q, nh)
        dstate = torch.einsum("bsn,bsn,bsnh,bsnd->bnhd", rem, dtc, xc, bc)
        h = h * _decay(Lq)[..., None, None] + dstate
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h
