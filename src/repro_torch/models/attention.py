"""Grouped-query attention block: projections with RoPE and lookahead-LoRA
hooks, the monolithic and the streaming prefill attention, and the decode
steps over a dense cache and over the paged pool.

Single-layer params (stacked along L by transformer.py):

    {"wq": (D, H*hd), "wk": (D, KV*hd), "wv": (D, KV*hd), "wo": (H*hd, D),
     ["bq","bk","bv"]: biases when cfg.attn.qkv_bias}

Where the JAX package returns updated copies of the prompt buffer, the
dense decode cache and the block pool, the port writes them in place
(noted at each write).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.config import AttentionConfig, ModelConfig
from repro_torch.core.scoring import decode_mass_update
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, check_offset
from repro_torch.models import rope
from repro_torch.models.layers import dense_init, linear


def init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, *,
         lead=()) -> dict:
    a = cfg.attn
    return {
        "wq": dense_init(gen, cfg.d_model, a.q_dim, dtype, lead=lead),
        "wk": dense_init(gen, cfg.d_model, a.kv_dim, dtype, lead=lead),
        "wv": dense_init(gen, cfg.d_model, a.kv_dim, dtype, lead=lead),
        "wo": dense_init(gen, a.q_dim, cfg.d_model, dtype, lead=lead),
    }


def _lora_for(lora: Optional[dict], name: str) -> Optional[dict]:
    return None if lora is None else lora.get(name)


def qkv(
    p: dict,
    a: AttentionConfig,
    h: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) absolute positions
    *,
    lookahead_mask: Optional[torch.Tensor] = None,  # (B, S, 1)
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    rope_tables: Optional[tuple] = None,  # rope.rope_tables(positions, ...)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + rotate.  Returns q (B,S,H,hd), k/v (B,S,KV,hd).  A caller
    running many layers at the same positions passes ``rope_tables`` once."""
    B, S, _ = h.shape
    lm = lookahead_mask
    q = linear(h, p["wq"], p.get("bq"), lora=_lora_for(lora, "wq"),
               lora_mask=lm, lora_scale=lora_scale)
    k = linear(h, p["wk"], p.get("bk"), lora=_lora_for(lora, "wk"),
               lora_mask=lm, lora_scale=lora_scale)
    v = linear(h, p["wv"], p.get("bv"), lora=_lora_for(lora, "wv"),
               lora_mask=lm, lora_scale=lora_scale)
    q = q.reshape(B, S, a.num_heads, a.head_dim)
    k = k.reshape(B, S, a.num_kv_heads, a.head_dim)
    v = v.reshape(B, S, a.num_kv_heads, a.head_dim)
    if rope_tables is None:
        rope_tables = rope.rope_tables(positions, a.head_dim, a.rope_theta)
    return rope.rotate(q, rope_tables), rope.rotate(k, rope_tables), v


def layer_window(a: AttentionConfig, is_global: bool = True) -> Optional[int]:
    """The attention window of one layer: None (full attention) or an int
    (sliding window; patterned local:global archs give global layers
    None)."""
    if a.global_every > 0 or len(a.global_layers) > 0:
        return None if is_global else a.sliding_window
    if a.sliding_window > 0:
        return a.sliding_window
    return None


def prefill_attention(
    p: dict,
    a: AttentionConfig,
    h: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) absolute positions
    *,
    window: Optional[int] = None,
    lookahead_mask: Optional[torch.Tensor] = None,
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    rope_tables: Optional[tuple] = None,
    kv_mask: Optional[torch.Tensor] = None,  # (B, S) valid keys
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention of the whole sequence (``ops.flash_attention``,
    optional sliding window); ``kv_mask`` hides keys (the bucket-padded
    prompt rows) from every query.  Returns (out (B, S, D), q, k, v); the
    caller scores and evicts from q and k."""
    q, k, v = qkv(p, a, h, positions, lookahead_mask=lookahead_mask,
                  lora=lora, lora_scale=lora_scale, rope_tables=rope_tables)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              kv_mask=kv_mask)
    B, S = h.shape[:2]
    out = linear(out.reshape(B, S, a.q_dim), p["wo"],
                 lora=_lora_for(lora, "wo"), lora_mask=lookahead_mask,
                 lora_scale=lora_scale)
    return out, q, k, v


def chunk_prefill_attention(
    p: dict,
    a: AttentionConfig,
    h: torch.Tensor,  # (B, C, D) chunk hidden states
    positions: torch.Tensor,  # (B, C) = q_offset + arange(C)
    k_buf: torch.Tensor,  # (B, K, KV, hd) prompt keys so far
    v_buf: torch.Tensor,
    *,
    q_offset: int,
    window: Optional[int] = None,
    score_masses: bool = False,  # h2o: the chunk's column masses too
    n_total: Optional[int] = None,  # true prompt length (masks pad rows)
    lookahead_mask: Optional[torch.Tensor] = None,
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    rope_tables: Optional[tuple] = None,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Streaming-prefill attention: project + rotate the chunk, write its
    K/V into the prompt buffer at ``q_offset`` and attend its queries over
    the buffer (``ops.chunk_attention``).  Returns (out, rotated q,
    masses): with ``score_masses`` the chunk's summed softmax column
    masses (B, H, K) over its rows below ``n_total`` (kernel 2 on the
    card), the h2o score of the chunk; None otherwise.

    The buffer must be deep enough for the write: ``q_offset + C <= K``
    raises otherwise (the JAX ``dynamic_update_slice`` would clamp the
    start silently and corrupt earlier chunks' keys)."""
    q, k, v = qkv(p, a, h, positions, lookahead_mask=lookahead_mask,
                  lora=lora, lora_scale=lora_scale, rope_tables=rope_tables)
    B, C = h.shape[:2]
    check_offset(q_offset, C, k_buf.shape[1])  # before the write below
    # in place: the chunk's K/V land in the caller's buffer (JAX returns
    # an updated copy of the buffer)
    k_buf[:, q_offset:q_offset + C] = k.to(k_buf.dtype)
    v_buf[:, q_offset:q_offset + C] = v.to(v_buf.dtype)
    masses = None
    if score_masses:
        out, masses = ops.chunk_attention(
            q, k_buf, v_buf, q_offset=q_offset, window=window,
            score_masses=True, n_total=n_total)
    else:
        out = ops.chunk_attention(q, k_buf, v_buf, q_offset=q_offset,
                                  window=window)
    out = linear(out.reshape(B, C, a.q_dim), p["wo"],
                 lora=_lora_for(lora, "wo"), lora_mask=lookahead_mask,
                 lora_scale=lora_scale)
    return out, q, masses


def dense_append_rows(cursor, capacity: int, batch: int, device,
                      active: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each sequence's next token lands in a dense cache of
    ``capacity`` rows: (row (B,) int64, write_ok (B,) bool), the same for
    every layer, so a decode step computes it once.

    * Scalar cursor (lockstep: one int for the batch): every sequence
      writes row ``min(cursor, capacity - 1)`` — the start-index clamp of
      the JAX step's ``dynamic_update_slice``, so a full cache overwrites
      its last row.
    * Per-slot cursors (B,) (continuous batching): a slot writes row
      ``cursor`` while ``cursor < capacity``; a full slot writes nothing.

    ``active`` (B,) additionally gates the write: the port writes the live
    cache in place, so an inactive slot must not write at all (JAX writes
    every slot and rolls inactive ones back with ``select_cache_slots``)."""
    if isinstance(cursor, torch.Tensor) and cursor.dim() == 1:
        row = torch.clamp(cursor, 0, capacity - 1).long()
        write_ok = cursor < capacity
    else:
        row = torch.full((batch,), min(int(cursor), capacity - 1),
                         dtype=torch.long, device=device)
        write_ok = torch.ones((batch,), dtype=torch.bool, device=device)
    if active is not None:
        write_ok = write_ok & active
    return row, write_ok


def decode_attention_step(
    p: dict,
    a: AttentionConfig,
    h1: torch.Tensor,  # (B, 1, D) current token hidden
    positions: torch.Tensor,  # (B, 1) the token's absolute positions
    cache: dict,  # this layer's cache: k/v (B, C, KV, hd), pos/mask (B, C, KV)
    *,
    rows: tuple,  # dense_append_rows(...), shared by the layers
    window: Optional[int] = None,
    rope_tables: Optional[tuple] = None,
) -> torch.Tensor:
    """One decode step against a dense cache: append the token's K/V at
    each sequence's row (``dense_append_rows``), then attend over the cache
    with its per-kv-head mask (``ops.decode_attention``; a window is folded
    into that mask).  The cache is written in place, only where
    ``write_ok``.  Returns (B, 1, D)."""
    B = h1.shape[0]
    KV = a.num_kv_heads
    q, k_new, v_new = qkv(p, a, h1, positions, rope_tables=rope_tables)
    row, write_ok = rows
    b = torch.arange(B, device=h1.device)
    ok = write_ok[:, None]
    new_pos = positions.to(torch.int32).expand(B, KV)
    # in place: write-gated row update (JAX returns an updated copy)
    for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0]),
                      ("pos", new_pos), ("mask", ok.expand(B, KV))):
        buf = cache[name]
        old = buf[b, row]
        gate = ok if new.dim() == 2 else ok[..., None]
        buf[b, row] = torch.where(gate, new.to(buf.dtype), old)
    att_mask = cache["mask"]
    if window is not None:
        att_mask = att_mask & ((positions[:, :, None] - cache["pos"]) < window)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                               kv_mask=att_mask)
    return linear(out.reshape(B, 1, a.q_dim), p["wo"])


def append_slots(table: torch.Tensor, cursor: torch.Tensor, depth: int,
                 block_size: int, active: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each slot's next token lands in the pool: (block id, row in the
    block, write_ok), all (B,).  Inactive or full slots, and a live slot
    whose append block is missing (table entry 0), are routed to the null
    block with ``write_ok`` False, so they can neither mark a phantom row
    valid nor touch a neighbour's blocks.  The same for every layer (the
    table is shared across layers), so a decode step computes it once."""
    nb = table.shape[1]
    write_ok = cursor < depth  # full caches stop appending
    if active is not None:
        write_ok &= active
    jb = torch.clamp(cursor // block_size, 0, nb - 1)
    off = torch.clamp(cursor - jb * block_size, 0, block_size - 1).long()
    pb = torch.gather(table, 1, jb[:, None].long())[:, 0]
    write_ok &= pb != 0
    pb = torch.where(write_ok, pb, torch.zeros_like(pb)).long()
    return pb, off, write_ok


def decode_attention_step_paged(
    p: dict,
    a: AttentionConfig,
    h1: torch.Tensor,  # (B, 1, D) current token hidden
    positions: torch.Tensor,  # (B, 1) the token's absolute positions
    pool: dict,  # this layer's pool: k/v (N, bs, KV, hd), pos/mask (N, bs, KV)
    *,
    table: torch.Tensor,  # (B, nb) int32 physical block ids (0 = null)
    cursor: torch.Tensor,  # (B,) append rows
    depth: int,  # logical cache depth (capacity + margin)
    active: Optional[torch.Tensor] = None,  # (B,) live slots
    window: Optional[int] = None,
    rope_tables: Optional[tuple] = None,
    slots: Optional[tuple] = None,  # append_slots(...), shared by layers
) -> torch.Tensor:
    """One decode step against the paged cache (``serving/kv_pool.py``).

    Appends the token's K/V at each slot's cursor row ``(table[b, c // bs],
    c % bs)`` — null-routed where the slot may not write, see
    ``append_slots`` — then attends straight out of the pool.  Returns
    (B, 1, D).

    Decode-time eviction rides an optional ``"score"`` leaf of the pool
    slice ((B, depth, KV) cumulative masses): then the attention goes
    through kernel 5 (``score_masses=True``), whose row masses of the
    cache after the append are added to the score in place, only where
    ``write_ok`` (``core.scoring.decode_mass_update``).  The output is the
    unscored one bit for bit."""
    B = h1.shape[0]
    KV = a.num_kv_heads
    bs = pool["k"].shape[1]
    assert depth <= table.shape[1] * bs, \
        "block table shallower than the logical cache"
    q, k_new, v_new = qkv(p, a, h1, positions, rope_tables=rope_tables)
    if slots is None:
        slots = append_slots(table, cursor, depth, bs, active)
    pb, off, write_ok = slots
    # in place: scatter into the shared pool (JAX returns updated copies)
    pool["k"][pb, off] = k_new[:, 0].to(pool["k"].dtype)
    pool["v"][pb, off] = v_new[:, 0].to(pool["v"].dtype)
    pool["pos"][pb, off] = positions.to(torch.int32).expand(B, KV)
    pool["mask"][pb, off] = write_ok[:, None].expand(B, KV)

    kw = dict(pos_pool=pool["pos"], new_pos=positions[:, 0].to(torch.int32),
              window=window)
    score = pool.get("score")
    if score is None:
        out = ops.paged_decode_attention(q[:, 0], pool["k"], pool["v"],
                                         pool["mask"], table, **kw)
    else:
        out, masses = ops.paged_decode_attention(
            q[:, 0], pool["k"], pool["v"], pool["mask"], table, depth=depth,
            score_masses=True, **kw)
        score += decode_mass_update(masses, KV, active=write_ok)  # in place
    return linear(out.reshape(B, 1, a.q_dim), p["wo"])


def decode_attention_step_evicting(
    p: dict,
    a: AttentionConfig,
    h1: torch.Tensor,  # (B, 1, D) current token hidden
    positions: torch.Tensor,  # (B, 1) the token's absolute positions
    cache: dict,  # this layer's cache: k/v, pos/mask and score (B, C, KV)
    *,
    cursor,  # int (lockstep) or (B,) per-slot cursors
    active: Optional[torch.Tensor] = None,  # (B,) live slots
    window: Optional[int] = None,
    rope_tables: Optional[tuple] = None,
) -> torch.Tensor:
    """Decoding-stage eviction over a dense cache (beyond-paper: the paper
    names decode eviction as future work).  The cache's ``score`` holds
    each row's cumulative attention mass per kv head (H2O heavy hitters).
    The step adds the new query's GQA-mean softmax masses over the cache
    *before* the append (plain torch, as the JAX step), then writes the
    token at the cursor while capacity remains, else over the valid row
    of lowest score (``argmin``: the first on ties, as ``jnp.argmin``),
    per kv head; that row's score restarts at its mass this step.  Then it
    attends over the updated cache (``ops.decode_attention``).

    The cache is written in place, gated by ``active``: an inactive
    slot's k, v, pos, mask and score stay bit for bit as they were (JAX
    writes a one-hot blend of the whole cache and rolls inactive slots
    back with ``select_cache_slots``).  Returns (B, 1, D)."""
    B = h1.shape[0]
    KV, hd = a.num_kv_heads, a.head_dim
    C = cache["k"].shape[1]
    G = a.num_heads // KV
    dev = h1.device
    q, k_new, v_new = qkv(p, a, h1, positions, rope_tables=rope_tables)

    # the new query's masses over the cache as it stands: (B, KV, C)
    qg = q[:, 0].reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgd,bckd->bkgc", qg,
                          cache["k"].float()) / math.sqrt(hd)
    mask_bkc = cache["mask"].transpose(1, 2)
    logits = torch.where(mask_bkc[:, :, None], logits, NEG_INF)
    add = torch.softmax(logits, dim=-1).mean(dim=2).transpose(1, 2)
    score = cache["score"] + torch.where(cache["mask"], add, 0.0)

    if isinstance(cursor, torch.Tensor) and cursor.dim() == 1:
        cur = cursor[:, None].long()  # (B, 1) against (B, KV)
    else:
        cur = torch.full((B, 1), int(cursor), dtype=torch.long, device=dev)
    victim = torch.argmin(
        torch.where(cache["mask"], score, float("inf")), dim=1)  # (B, KV)
    row = torch.where(cur >= C, victim, torch.clamp(cur, max=C - 1))
    b = torch.arange(B, device=dev)[:, None].expand(B, KV)
    h = torch.arange(KV, device=dev)[None, :].expand(B, KV)
    gate = (torch.ones((B, 1), dtype=torch.bool, device=dev)
            if active is None else active[:, None])
    # a fresh row restarts its tally at this step's mass
    score[b, row, h] = add[b, row, h]
    # in place, only where `gate` (JAX: one-hot blend, then rollback)
    cache["score"].copy_(torch.where(gate[..., None], score, cache["score"]))
    new_pos = positions.to(torch.int32).expand(B, KV)
    for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0]),
                      ("pos", new_pos),
                      ("mask", torch.ones_like(gate).expand(B, KV))):
        buf = cache[name]
        g = gate if new.dim() == 2 else gate[..., None]
        buf[b, row, h] = torch.where(g, new.to(buf.dtype), buf[b, row, h])
    att_mask = cache["mask"]
    if window is not None:
        att_mask = att_mask & ((positions[:, :, None] - cache["pos"])
                               < window)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                               kv_mask=att_mask)
    return linear(out.reshape(B, 1, a.q_dim), p["wo"])
