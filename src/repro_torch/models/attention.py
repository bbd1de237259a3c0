"""Grouped-query attention block: projections with RoPE and lookahead-LoRA
hooks, the monolithic and the streaming prefill attention, the decode
steps over a dense cache, over a split cache (frozen rows + hot ring)
and over the paged pool, and whisper's
cross-attention (decoder rows over the encoder frames' K/V, evicted or
not).

Single-layer params (stacked along L by transformer.py):

    {"wq": (D, H*hd), "wk": (D, KV*hd), "wv": (D, KV*hd), "wo": (H*hd, D),
     ["bq","bk","bv"]: biases when cfg.attn.qkv_bias}

Where the JAX package returns updated copies of the prompt buffer, the
dense decode cache and the block pool, the port writes them in place
(noted at each write).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.common.config import AttentionConfig, ModelConfig
from repro_torch.core.scoring import decode_mass_update
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, check_offset
from repro_torch.models import rope
from repro_torch.models.layers import dense_init, linear, lora_delta


def init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, *,
         lead=()) -> dict:
    """The four projections.  The JAX package's qkv biases (zeros, and
    none on a cross-attention block) are left out: a missing bias is a
    zero one (``linear``), and bridged JAX trees carry their own."""
    a = cfg.attn
    return {
        "wq": dense_init(gen, cfg.d_model, a.q_dim, dtype, lead=lead),
        "wk": dense_init(gen, cfg.d_model, a.kv_dim, dtype, lead=lead),
        "wv": dense_init(gen, cfg.d_model, a.kv_dim, dtype, lead=lead),
        "wo": dense_init(gen, a.q_dim, cfg.d_model, dtype, lead=lead),
    }


def _lora_for(lora: Optional[dict], name: str) -> Optional[dict]:
    return None if lora is None else lora.get(name)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------
#
# Over a mesh (``launch/mesh.py``) every rank runs the model functions on
# its own shard (``common/sharding.py::serving_specs``): the contiguous
# slice of q heads, kv heads, d_ff columns, vocab rows and of ``wo`` /
# ``w_down``'s output columns.  Activations stay replicated.  Attention
# and its kernels run per rank on the local heads (``local_config``: H/N
# and KV/N heads); every product contracts its full input in
# single-device order, with the activation all-gathered first where that
# input is sharded (the JAX helpers' ``all_gather`` inside ``shard_map``),
# so no partial sum ever crosses ranks and the results are the
# single-device ones bit for bit wherever a column slice of a product is.
#
# The trainer differentiates through this (the lookahead pass, with
# respect to the replicated lookahead modules), so each crossing between
# replicated and per-rank values has a conjugate backward:
#
# * per-rank -> replicated (``all_gather``): the backward is the rank's
#   own slice of the incoming gradient, with no communication.  That
#   gradient is the same on every model rank, because everything
#   downstream of a gather is computed replicated and every replicated
#   value's gradient is complete (next item).
# * replicated -> per-rank: the backward sums the ranks' partial
#   gradients over the model group (an all-reduce), since each rank's
#   product saw only its own columns.  ``column_linears`` does so for a
#   replicated input times column slices of frozen weights: each rank's
#   partial input gradient in float32, one all-reduce for every product
#   of that input, rounded once, as one rank's full product rounds its
#   float32 accumulation once (summed in bf16, the partials drifted the
#   gradient of 32 bf16 layers by ~1%).  Its LoRA sums the gradient of
#   the rank-r intermediate ``(x * mask) @ a`` instead (``enter_sharded``,
#   the identity forward: a few values a row), so that ``a`` and the
#   input's LoRA gradient come out whole; ``local_lora`` marks the
#   replicated ``b`` before it is column-sliced.
#
# So every replicated leaf (the lookahead rows ``emb`` and every LoRA
# ``a`` / ``b``) gets its full gradient on every model rank.  Layers that
# run whole on every rank (the MoE, heads that divide no model axis,
# ``replicated_apply``) cross nothing and need no sum: a blanket
# all-reduce of the gradients over "model" would count them N times.
# ``all_reduce`` (partials merged by the split decode) and the frozen
# weights' gathers (``transformer._layer_params``) carry no gradient.


def model_shard_mesh(mesh, a: Optional[AttentionConfig]):
    """The mesh when per-shard head dispatch applies, else None: kv heads
    (and so q heads) must divide a "model" axis above 1."""
    if a is None or mesh is None or "model" not in getattr(
            mesh, "axis_names", ()):
        return None
    msize = int(mesh.shape["model"])
    if msize == 1 or a.num_kv_heads % msize or a.num_heads % msize:
        return None
    return mesh


def local_config(cfg: ModelConfig, smesh) -> ModelConfig:
    """``cfg`` as one rank's shard sees it: H/N q heads and KV/N kv heads
    (the head dim, the GQA group and every other field unchanged)."""
    if smesh is None:
        return cfg
    n = int(smesh.shape["model"])
    a = cfg.attn
    return dataclasses.replace(cfg, attn=dataclasses.replace(
        a, num_heads=a.num_heads // n, num_kv_heads=a.num_kv_heads // n))


def all_gather_raw(x: torch.Tensor, dim: int, mesh,
                   axis: str = "model") -> torch.Tensor:
    """The ``axis`` ranks' ``x`` concatenated along ``dim`` in rank order
    (``jax.lax.all_gather(..., tiled=True)``): the model-axis ranks of
    this rank's data row, or with ``axis="data"`` the data-axis ranks of
    its model column.  Over NCCL (one card per rank)
    ``all_gather_into_tensor`` on the card; over gloo (ranks sharing a
    card, or the CPU) through the host.  No gradient: ``all_gather``
    carries one."""
    group = mesh.axis_group(axis)
    if group is None:
        raise ValueError(f"no {axis}-axis ranks to gather from (a "
                         "shape-only mesh, or an axis of size 1)")
    n = int(mesh.shape[axis])
    if dist.get_backend(group) == "nccl":
        xs = x.detach().contiguous()
        out = torch.empty((n * xs.shape[0], *xs.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, xs, group=group)
        return torch.cat(out.chunk(n, dim=0), dim=dim)
    host = x.detach().to("cpu").contiguous()
    # the parts land in one buffer, which goes to the device in one copy;
    # they are laid along ``dim`` there (on the card, not the host)
    parts = torch.empty((n, *host.shape), dtype=host.dtype)
    dist.all_gather(list(parts.unbind(0)), host, group=group)
    if n == 1 or dim % x.dim() == 0:
        return parts.reshape(n * host.shape[0], *host.shape[1:]).to(x.device)
    return torch.cat(parts.to(x.device).unbind(0), dim=dim)


class _Gather(torch.autograd.Function):
    """per-rank -> replicated: forward ``all_gather_raw``; backward the
    rank's own slice of the (replicated) incoming gradient."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.n = dim % x.dim(), int(mesh.shape["model"])
        ctx.index = mesh.model_index
        return all_gather_raw(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        w = g.shape[ctx.dim] // ctx.n
        return g.narrow(ctx.dim, ctx.index * w, w), None, None


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or as it is where its type is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _model_sum(g: torch.Tensor, mesh) -> torch.Tensor:
    """The model ranks' partial gradients ``g`` summed in float32 (or
    wider) and rounded once to ``g``'s type."""
    return all_reduce(_wide(g).contiguous(), dist.ReduceOp.SUM,
                      mesh.group).to(g.dtype)


class _EnterSharded(torch.autograd.Function):
    """replicated -> per-rank: the identity forward; backward the sum of
    the model ranks' partial gradients (``_model_sum``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g, ctx.mesh), None


class _ColumnProducts(torch.autograd.Function):
    """``x @ w`` for each ``w`` of ``ws``, the rank's column slices of
    frozen weights, and a replicated ``x``.  Backward: the rank's partial
    input gradient of every product summed in float32, then over the
    model group in one all-reduce; the weights take none."""

    @staticmethod
    def forward(ctx, x, mesh, *ws):
        ctx.mesh, ctx.dtype = mesh, x.dtype
        ctx.save_for_backward(*ws)
        return tuple(x @ w for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        part = None
        for g, w in zip(gs, ctx.saved_tensors):
            if g is None:
                continue
            d = _wide(g) @ _wide(w).T
            part = d if part is None else part + d
        grad = all_reduce(part, dist.ReduceOp.SUM, ctx.mesh.group)
        return (grad.to(ctx.dtype), None) + (None,) * len(gs)


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(x: torch.Tensor, dim: int, mesh,
               axis: str = "model") -> torch.Tensor:
    """``all_gather_raw``, differentiable over "model": where ``x`` takes
    a gradient, the backward hands this rank its own slice of the
    replicated result's gradient (no communication; module comment
    above).  The data rows hold different batch rows, so a gather over
    "data" carries no gradient and refuses one."""
    if not _differentiable(x):
        return all_gather_raw(x, dim, mesh, axis)
    if axis != "model":
        raise ValueError(f"a gather over {axis!r} carries no gradient")
    return _Gather.apply(x, dim, mesh)


def enter_sharded(x: torch.Tensor, smesh) -> torch.Tensor:
    """A replicated ``x`` about to enter a rank's own share of a product
    (its head or column slice): ``x`` itself, whose gradient is summed
    over the model group in the backward.  ``x`` as it is without a
    mesh or a gradient."""
    if smesh is None or not _differentiable(x):
        return x
    return _EnterSharded.apply(x, smesh)


def model_slice(x: torch.Tensor, smesh, dim: int = -1) -> torch.Tensor:
    """This rank's contiguous slice of a replicated tensor along ``dim``."""
    n = int(smesh.shape["model"])
    w = x.shape[dim] // n
    return x.narrow(dim, smesh.model_index * w, w)


def local_lora(lora: Optional[dict], smesh) -> Optional[dict]:
    """A replicated LoRA of a column-sliced weight as the shard applies it:
    A in full (the delta contracts the full input), B's local columns."""
    if lora is None or smesh is None:
        return lora
    return {"a": lora["a"],
            "b": model_slice(enter_sharded(lora["b"], smesh),
                             smesh).contiguous()}


def column_linears(x: torch.Tensor, ws: list, smesh, *, biases=None,
                   loras=None, lora_mask: Optional[torch.Tensor] = None,
                   lora_scale: float = 1.0) -> list:
    """``linear(x, w, b, lora=...)`` for each of ``ws`` with their
    ``biases`` and ``loras`` (replicated trees, sliced by ``local_lora``):
    under ``smesh`` ``ws`` and ``biases`` are the rank's column slices and
    ``x`` is replicated; the forward is ``linear``'s, and a gradient
    through ``x`` is summed over the model group (``_ColumnProducts``;
    the LoRA's through its rank-r intermediate)."""
    n = len(ws)
    biases = biases or [None] * n
    loras = loras or [None] * n
    if smesh is None:
        return [linear(x, w, b, lora=lo, lora_mask=lora_mask,
                       lora_scale=lora_scale)
                for w, b, lo in zip(ws, biases, loras)]
    if any(w.requires_grad for w in ws) and torch.is_grad_enabled():
        raise ValueError("column-sliced weights are frozen: their "
                         "gradient is not computed")
    ys = (_ColumnProducts.apply(x, smesh, *ws) if _differentiable(x)
          else [x @ w for w in ws])
    out = []
    for y, b, lo in zip(ys, biases, loras):
        if b is not None:
            y = y + b
        if lo is not None and lora_mask is not None:
            y = y + lora_delta(x, local_lora(lo, smesh), lora_mask,
                               lora_scale,
                               enter=lambda u: enter_sharded(u, smesh))
        out.append(y)
    return out


def replicated_apply(fn, smesh, *args):
    """``fn(*args)`` computed whole on every rank: the operands are
    replicated, so each rank runs the single-device computation (JAX
    gathers them inside ``shard_map``; here every rank holds them)."""
    del smesh
    return fn(*args)


def sharded_wo_linear(out_flat: torch.Tensor, w: torch.Tensor, smesh, *,
                      lora: Optional[dict] = None,
                      lm: Optional[torch.Tensor] = None,
                      ls: float = 1.0) -> torch.Tensor:
    """The attention out-projection with its contraction in single-device
    order: the head-sharded output is all-gathered, each rank computes its
    columns of d_model from the full contraction (``w`` is its column
    slice of ``wo``), and the columns are all-gathered.  The LoRA delta
    rides along (A in full, B column-sliced)."""
    if smesh is None:
        return linear(out_flat, w, lora=lora, lora_mask=lm, lora_scale=ls)
    of = all_gather(out_flat, -1, smesh)
    y, = column_linears(of, [w], smesh, loras=[lora], lora_mask=lm,
                        lora_scale=ls)
    return all_gather(y, -1, smesh)


def qkv(
    p: dict,
    a: AttentionConfig,
    h: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) absolute positions
    *,
    lookahead_mask: Optional[torch.Tensor] = None,  # (B, S, 1)
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    rope_tables: Optional[tuple] = None,  # rope_tables or mrope_tables
    rotary: bool = True,  # False: whisper's encoder (no positions)
    smesh=None,  # model_shard_mesh-vetted: p holds this rank's heads
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + rotate.  Returns q (B,S,H,hd), k/v (B,S,KV,hd).  A caller
    running many layers at the same positions passes ``rope_tables`` once.
    Under ``smesh`` the projections are column-parallel: ``p`` holds the
    rank's head columns (and biases), the LoRA its B columns, and ``a``
    the local head counts."""
    B, S, _ = h.shape
    names = ("wq", "wk", "wv")
    q, k, v = column_linears(
        h, [p[n] for n in names], smesh,
        biases=[p.get("b" + n[1]) for n in names],
        loras=[_lora_for(lora, n) for n in names],
        lora_mask=lookahead_mask, lora_scale=lora_scale)
    q = q.reshape(B, S, a.num_heads, a.head_dim)
    k = k.reshape(B, S, a.num_kv_heads, a.head_dim)
    v = v.reshape(B, S, a.num_kv_heads, a.head_dim)
    if not rotary:
        return q, k, v
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
    causal: bool = True,
    rotary: bool = True,
    smesh=None,  # tensor-parallel: the rank's heads (``a`` local)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention of the whole sequence (``ops.flash_attention``):
    causal with an optional sliding window, or (``causal=False``, the
    window then ignored) bidirectional, as whisper's encoder runs it with
    ``rotary=False``.  ``kv_mask`` hides keys (the bucket-padded prompt
    rows) from every query.  Returns (out (B, S, D), q, k, v); the caller
    scores and evicts from q and k.  Under ``smesh`` q, k and v are the
    rank's heads and ``out`` the replicated whole
    (``sharded_wo_linear``)."""
    q, k, v = qkv(p, a, h, positions, lookahead_mask=lookahead_mask,
                  lora=lora, lora_scale=lora_scale, rope_tables=rope_tables,
                  rotary=rotary, smesh=smesh)
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=window if causal else None,
                              kv_mask=kv_mask)
    B, S = h.shape[:2]
    out = sharded_wo_linear(out.reshape(B, S, a.q_dim), p["wo"], smesh,
                            lora=_lora_for(lora, "wo"), lm=lookahead_mask,
                            ls=lora_scale)
    return out, q, k, v


def cross_attention(
    p: dict,
    a: AttentionConfig,
    h: torch.Tensor,  # (B, Sq, D) decoder hidden states
    enc_k: torch.Tensor,  # (B, Se, KV, hd) the encoder frames' keys
    enc_v: torch.Tensor,
    *,
    enc_mask: Optional[torch.Tensor] = None,  # (B, Se) valid frames
    lora: Optional[dict] = None,
    lora_mask: Optional[torch.Tensor] = None,  # (B, Sq, 1)
    lora_scale: float = 1.0,
    smesh=None,  # tensor-parallel: the rank's heads (``a`` local)
) -> torch.Tensor:
    """Whisper's decoder-to-encoder attention (no positions): the rows'
    queries over every frame (``ops.flash_attention`` with Sq != Sk,
    non-causal), the lookahead LoRA on ``wq`` and ``wo`` only, as in the
    JAX package.  Returns (B, Sq, D).  Under ``smesh`` ``p``, ``enc_k``
    and ``enc_v`` hold the rank's heads: ``wq`` is column-parallel and
    ``wo`` takes the gathered heads (``sharded_wo_linear``), as in
    ``prefill_attention``."""
    B, Sq, _ = h.shape
    q, = column_linears(h, [p["wq"]], smesh, biases=[p.get("bq")],
                        loras=[_lora_for(lora, "wq")], lora_mask=lora_mask,
                        lora_scale=lora_scale)
    q = q.reshape(B, Sq, a.num_heads, a.head_dim)
    out = ops.flash_attention(q, enc_k, enc_v, causal=False,
                              kv_mask=enc_mask)
    return sharded_wo_linear(out.reshape(B, Sq, a.q_dim), p["wo"], smesh,
                             lora=_lora_for(lora, "wo"), lm=lora_mask,
                             ls=lora_scale)


def cross_attention_decode_evicted(
    p: dict,
    a: AttentionConfig,
    h1: torch.Tensor,  # (B, 1, D)
    cross_cache: dict,  # k/v (B, Cc, KV, hd), mask (B, Cc, KV)
) -> torch.Tensor:
    """One token's cross-attention over an evicted encoder cache (each kv
    head keeps its own frames, so the mask is per head: kernel 6), no
    LoRA.  Returns (B, 1, D)."""
    B = h1.shape[0]
    q = linear(h1, p["wq"], p.get("bq")).reshape(B, a.num_heads, a.head_dim)
    out = ops.decode_attention(q, cross_cache["k"], cross_cache["v"],
                               kv_mask=cross_cache["mask"])
    return linear(out.reshape(B, 1, a.q_dim), p["wo"])


def encode_kv(p: dict, a: AttentionConfig, h_enc: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder states (B, Se, D) projected once into one decoder
    layer's cross-attention K/V (B, Se, KV, hd), no LoRA; with ``p`` a
    rank's column slices and ``a`` its local config, the rank's kv
    heads."""
    B, Se, _ = h_enc.shape
    k = linear(h_enc, p["wk"], p.get("bk"))
    v = linear(h_enc, p["wv"], p.get("bv"))
    return (k.reshape(B, Se, a.num_kv_heads, a.head_dim),
            v.reshape(B, Se, a.num_kv_heads, a.head_dim))


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
    smesh=None,  # tensor-parallel: the rank's heads (``a`` local)
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
                  lora=lora, lora_scale=lora_scale, rope_tables=rope_tables,
                  smesh=smesh)
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
    out = sharded_wo_linear(out.reshape(B, C, a.q_dim), p["wo"], smesh,
                            lora=_lora_for(lora, "wo"), lm=lookahead_mask,
                            ls=lora_scale)
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
    smesh=None,  # tensor-parallel: the rank's heads (``a`` local)
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
    return sharded_wo_linear(out.reshape(B, 1, a.q_dim), p["wo"], smesh)


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced by ``op`` (a ``dist.ReduceOp``) over ``group``'s
    ranks, a new tensor on ``x``'s device (``jax.lax.pmax`` / ``psum``):
    on the card over NCCL, else (gloo: ranks sharing a card, or the CPU)
    through the host."""
    if dist.get_backend(group) == "nccl":
        out = x.clone()
        dist.all_reduce(out, op=op, group=group)
        return out
    host = x.detach().to("cpu", copy=True)
    dist.all_reduce(host, op=op, group=group)
    return host.to(x.device)


def frozen_rows_group(mesh, axis):
    """The process group whose ranks hold the other slices of the split
    cache's frozen rows (``cache["frozen_axis"]``): the model axis's, or
    the whole world's where the rows lie over every axis."""
    if axis is None or mesh is None:
        return None
    if axis == "model":
        return mesh.axis_group("model")
    if set(axis) != set(mesh.axis_names):
        raise ValueError(f"frozen rows over {axis}: only 'model' or every "
                         f"axis of {mesh.axis_names}")
    return mesh.world


def frozen_cache_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor, *, group=None) -> tuple:
    """Flash-decode partials (m, l, acc) of q (B, H, hd) over the split
    cache's frozen rows (``ops.decode_attention_stats``).  With ``group``
    (``frozen_rows_group``) each rank holds a slice of the rows for every
    head: its local partials merge over the group, the max of m, then the
    sums of l and acc rescaled to it (one all-reduce each; (B, H) and
    (B, H, hd + 1) float32 per layer), as JAX's ``pmax`` / ``psum``."""
    m, l, acc = ops.decode_attention_stats(q, k, v, kv_mask=mask)
    if group is None:
        return m, l, acc
    gm = all_reduce(m, dist.ReduceOp.MAX, group)
    corr = torch.exp(m - gm)
    la = all_reduce(torch.cat([(l * corr)[..., None],
                               acc * corr[..., None]], dim=-1),
                    dist.ReduceOp.SUM, group)
    return gm, la[..., 0], la[..., 1:]


def decode_attention_step_split(
    p: dict,
    a: AttentionConfig,
    h1: torch.Tensor,  # (B, 1, D) current token hidden
    positions: torch.Tensor,  # (B, 1) the token's absolute positions
    cache: dict,  # this layer's: k/v/pos/mask (frozen), hot_k/v/pos/mask
    *,
    slot: int,  # the ring row this step writes: counter % hot_slots
    window: Optional[int] = None,
    rope_tables: Optional[tuple] = None,
    smesh=None,  # tensor-parallel: the rank's heads (``a`` local)
    group=None,  # ``frozen_rows_group``: ranks holding the other rows
) -> torch.Tensor:
    """Split-cache decode (the JAX package's
    ``decode_attention_step_split``): the prompt cache is frozen (read
    only; over a mesh it may stay sliced by sequence) and the token's K/V
    go into row ``slot`` of the hot ring, overwriting its oldest row once
    the ring is full, as in JAX.  The two segments attend apart
    (``ops.decode_attention_stats``, a window masking both) and their
    partials merge (``ops.merge_attention_stats``), then ``wo``.  The
    ring is written in place (JAX returns an updated copy).  Returns
    (B, 1, D)."""
    B = h1.shape[0]
    KV = a.num_kv_heads
    q, k_new, v_new = qkv(p, a, h1, positions, rope_tables=rope_tables)
    new_pos = positions.to(torch.int32)[:, :, None]  # (B, 1, 1)
    cache["hot_k"][:, slot] = k_new[:, 0]
    cache["hot_v"][:, slot] = v_new[:, 0]
    cache["hot_pos"][:, slot] = new_pos[:, 0].expand(B, KV)
    cache["hot_mask"][:, slot] = True
    froz_mask, hot_mask = cache["mask"], cache["hot_mask"]
    if window is not None:
        froz_mask = froz_mask & ((new_pos - cache["pos"]) < window)
        hot_mask = hot_mask & ((new_pos - cache["hot_pos"]) < window)
    s1 = frozen_cache_stats(q[:, 0], cache["k"], cache["v"], froz_mask,
                            group=group)
    s2 = ops.decode_attention_stats(q[:, 0], cache["hot_k"], cache["hot_v"],
                                    kv_mask=hot_mask)
    out = ops.merge_attention_stats([s1, s2]).to(h1.dtype)
    return sharded_wo_linear(out.reshape(B, 1, a.q_dim), p["wo"], smesh)


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
    smesh=None,  # tensor-parallel: the rank's heads (``a`` local)
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
    return sharded_wo_linear(out.reshape(B, 1, a.q_dim), p["wo"], smesh)


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
    smesh=None,  # tensor-parallel: the rank's heads (``a`` local)
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
    return sharded_wo_linear(out.reshape(B, 1, a.q_dim), p["wo"], smesh)
