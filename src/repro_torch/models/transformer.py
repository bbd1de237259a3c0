"""Decoder stack of the port: parameters, embedding, the streaming prefill
(``prefill_chunk`` / ``prefill_finalize``) and the paged decode step.

Slice 1 covers the attention-only llama family and the paper's
``lookaheadkv`` policy.  Per-layer parameters are stacked along a leading
L axis (the JAX package's tree layout); the depth is a Python loop over
layer slices, which are views of the stacked tensors.

Block: h += attn(rms_norm(h, ln1));  h += mlp(rms_norm(h, ln2))
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.common.config import EvictionConfig, ModelConfig
from repro_torch.core import eviction as ev
from repro_torch.core import scoring
from repro_torch.core.lookahead import lora_scale
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import layer_window
from repro_torch.models.layers import dense_init, embed_init, rms_norm
from repro_torch.models.rope import rope_tables

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_arch(cfg: ModelConfig) -> None:
    a = cfg.attn
    if (a is None or cfg.moe is not None or cfg.ssm is not None
            or cfg.encoder is not None or cfg.embeds_in or a.mrope
            or cfg.d_ff <= 0):
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention-only dense decoders; "
            "other archs are ROADMAP A10")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> dict:
    """Random parameters in the JAX tree layout, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    _check_arch(cfg)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    L, d = cfg.num_layers, cfg.d_model
    dev = gen.device
    layers = {
        "ln1": torch.zeros((L, d), dtype=dtype, device=dev),
        "attn": attn_mod.init(gen, cfg, dtype, lead=(L,)),
        "ln2": torch.zeros((L, d), dtype=dtype, device=dev),
        "mlp": mlp_mod.init(gen, cfg, dtype, lead=(L,)),
    }
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, d, dtype),
        "layers": layers,
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.padded_vocab, dtype)
    return params


def layer_slice(tree: Optional[dict], layer: int) -> Optional[dict]:
    """Layer ``layer`` of a stacked tree (views, no copies)."""
    if tree is None:
        return None
    return {k: layer_slice(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in tree.items()}


def is_global_flags(cfg: ModelConfig) -> Optional[np.ndarray]:
    """Per-layer bool array for local:global patterns, or None if uniform."""
    a = cfg.attn
    if a.global_layers:
        f = np.zeros(cfg.num_layers, bool)
        f[list(a.global_layers)] = True
        return f
    if a.global_every > 0:
        idx = np.arange(cfg.num_layers)
        return (idx % a.global_every) == (a.global_every - 1)
    return None


def _windows(cfg: ModelConfig) -> list:
    flags = is_global_flags(cfg)
    return [layer_window(cfg.attn, True if flags is None else bool(flags[i]))
            for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def unembed(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits (float32) over the padded vocab; pad rows are -1e30."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = (h @ params["embed"].T).float()
    else:
        logits = (h @ params["lm_head"]).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


def _ffn_residual(h, lp, cfg: ModelConfig, *, lora_l=None, lora_mask=None,
                  ls: float = 1.0):
    u = rms_norm(h, lp["ln2"], cfg.norm_eps)
    mlp_lora = None if lora_l is None else lora_l.get("mlp")
    return h + mlp_mod.apply(lp["mlp"], cfg, u, lora=mlp_lora,
                             lora_mask=lora_mask, lora_scale=ls)


# ---------------------------------------------------------------------------
# Streaming (chunked) prefill
# ---------------------------------------------------------------------------


@dataclass
class ChunkState:
    """Carried state of a streaming prefill: the materialised prompt KV and
    the policy's score accumulator.  The buffers are written in place by
    each chunk (the JAX package threads updated copies)."""

    k: torch.Tensor  # (L, B, K, KV, hd) prompt keys; column j = position j
    v: torch.Tensor  # (L, B, K, KV, hd)
    score: scoring.ScoreState
    pos: int  # tokens streamed so far


def init_chunk_state(cfg: ModelConfig, policy: str, batch: int,
                     capacity: int, *, device="cuda") -> ChunkState:
    """Fresh state with a ``capacity``-deep KV buffer, which must hold the
    prompt plus the appended observation rows."""
    _check_arch(cfg)
    a = cfg.attn
    shape = (cfg.num_layers, batch, capacity, a.num_kv_heads, a.head_dim)
    k = torch.zeros(shape, dtype=torch_dtype(cfg), device=device)
    return ChunkState(k=k, v=torch.zeros_like(k),
                      score=scoring.init_score_state(policy), pos=0)


def prefill_chunk(
    params: dict,
    cfg: ModelConfig,
    state: ChunkState,
    tokens: torch.Tensor,  # (B, chunk) tokens; rows past n_total are pad
    n_total: int,  # true prompt length
    *,
    policy: str,
) -> tuple[ChunkState, torch.Tensor]:
    """Process one chunk starting at ``state.pos``.  Returns (state',
    logits (B, V) of the chunk's last real row).  Pad rows of a partial
    final chunk are inert: causal masking hides their keys from every real
    row and finalize masks their columns out of the cache."""
    scoring.init_score_state(policy)  # only final-observation policies
    a = cfg.attn
    h = embed(params, cfg, tokens)
    B, C = h.shape[:2]
    s = state.pos
    positions = (s + torch.arange(C, device=h.device)).expand(B, C)
    tables = rope_tables(positions, a.head_dim, a.rope_theta)
    for layer, window in enumerate(_windows(cfg)):
        lp = layer_slice(params["layers"], layer)
        u = rms_norm(h, lp["ln1"], cfg.norm_eps)
        out, _ = attn_mod.chunk_prefill_attention(
            lp["attn"], a, u, positions, state.k[layer], state.v[layer],
            q_offset=s, window=window, rope_tables=tables)
        h = _ffn_residual(h + out, lp, cfg)
    row = min(max(n_total - 1 - s, 0), C - 1)
    logits = unembed(params, cfg, h[:, row])
    return ChunkState(k=state.k, v=state.v, score=state.score,
                      pos=s + C), logits


def _chunk_observation_pass(params: dict, cfg: ModelConfig, state: ChunkState,
                            n_total: int, *, lkv_params: dict
                            ) -> torch.Tensor:
    """The lookahead observation pass: the learned lookahead rows (with
    their selective LoRA) run through the stack at positions ``n_total +
    arange(n_obs)`` against the materialised prompt KV, appending their
    keys after the prompt so each row's softmax includes the observation
    keys as in monolithic prefill.  Returns obs masses (L, B, H, K): the
    mean over observation rows of each q head's softmax mass per key."""
    a = cfg.attn
    L, B, K = state.k.shape[:3]
    emb = lkv_params["emb"].to(torch_dtype(cfg))
    n_obs = emb.shape[0]
    h = emb[None].expand(B, n_obs, emb.shape[1])
    ls = lora_scale(cfg)
    lmask = torch.ones((B, n_obs, 1), dtype=h.dtype, device=h.device)
    positions = (n_total + torch.arange(n_obs, device=h.device)).expand(
        B, n_obs)
    tables = rope_tables(positions, a.head_dim, a.rope_theta)
    masses = []
    for layer, window in enumerate(_windows(cfg)):
        lp = layer_slice(params["layers"], layer)
        lora_l = layer_slice(lkv_params.get("lora"), layer)
        u = rms_norm(h, lp["ln1"], cfg.norm_eps)
        out, q = attn_mod.chunk_prefill_attention(
            lp["attn"], a, u, positions, state.k[layer], state.v[layer],
            q_offset=n_total, window=window, lookahead_mask=lmask,
            lora=None if lora_l is None else lora_l.get("attn"),
            lora_scale=ls, rope_tables=tables)
        h = _ffn_residual(h + out, lp, cfg, lora_l=lora_l, lora_mask=lmask,
                          ls=ls)
        masses.append(ops.lookahead_score(q, state.k[layer], K,
                                          q_offset=n_total, window=window))
    return torch.stack(masses)


def _policy_budget_schedule(cfg: ModelConfig, policy: str, budget: int,
                            beta: float) -> tuple[list, int]:
    if policy == "pyramidkv":
        raise NotImplementedError("pyramidkv budgets: ROADMAP A3")
    return ev.uniform_budgets(cfg.num_layers, budget), budget


def decode_cache_capacity(cfg: ModelConfig, policy: str,
                          evict: EvictionConfig, *, n_keys_max: int) -> int:
    """Kept-slot capacity of the decode cache a prefill under ``policy``
    produces for prompts up to ``n_keys_max`` tokens."""
    if evict.head_alloc == "adaptive" and policy != "full":
        raise NotImplementedError("adaptive head budgets: ROADMAP A3")
    _, capacity = _policy_budget_schedule(
        cfg, policy, evict.budget if policy != "full" else n_keys_max,
        evict.pyramid_beta)
    return min(capacity, n_keys_max)


def prefill_finalize(
    params: dict,
    cfg: ModelConfig,
    state: ChunkState,
    n_total: int,
    *,
    policy: str,
    evict: Optional[EvictionConfig] = None,
    lkv_params: Optional[dict] = None,
    extra_slots: int = 0,
) -> dict:
    """Close a streaming prefill: run the observation pass, turn its masses
    into eviction scores and evict every layer once over the materialised
    buffer.  Returns the decode cache {"attn": {k, v (L, B, cap, KV, hd),
    pos, mask (L, B, cap, KV)}, "cursor": capacity, "next_pos": (B, 1)}
    with ``cap = capacity + extra_slots``."""
    if policy != "lookaheadkv":
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet: ROADMAP A3")
    if lkv_params is None:
        raise ValueError("lookaheadkv needs lookahead modules (lkv_params)")
    a = cfg.attn
    lk = cfg.lookahead
    evict = evict or EvictionConfig()
    L, B, K = state.k.shape[:3]
    obs = _chunk_observation_pass(params, cfg, state, n_total,
                                  lkv_params=lkv_params)
    budgets, _ = _policy_budget_schedule(cfg, policy, evict.budget,
                                         evict.pyramid_beta)
    capacity = decode_cache_capacity(cfg, policy, evict, n_keys_max=K)
    dev = state.k.device
    key_mask = (torch.arange(K, device=dev) < n_total).expand(B, K)
    layers = []
    for layer in range(L):
        s_kv = scoring.finalize_layer_scores(
            policy, K, n_total, obs_masses_l=obs[layer],
            num_kv_heads=a.num_kv_heads, pool_kernel=lk.pool_kernel)
        layers.append(ev.evict_layer(
            s_kv, state.k[layer], state.v[layer], capacity,
            layer_budget=budgets[layer], extra_slots=extra_slots,
            key_mask=key_mask))
    attn = {f: torch.stack([getattr(e, f) for e in layers])
            for f in ev.EvictedKV._fields}
    return {
        "attn": attn,
        "cursor": capacity,
        "next_pos": torch.full((B, 1), n_total, dtype=torch.int32,
                               device=dev),
    }


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------


def decode_step(
    params: dict,
    cfg: ModelConfig,
    token: torch.Tensor,  # (B, 1) tokens
    cache: dict,
    *,
    active: Optional[torch.Tensor] = None,  # (B,) live slots
    paged_depth: int,
) -> tuple[torch.Tensor, dict]:
    """One decode step against a paged cache.  ``cache`` holds the shared
    pool (``"pool"``: k/v (L, N, bs, KV, hd), pos/mask (L, N, bs, KV)),
    the block table (``cache["attn"]["table"]``, (B, nb) int32), the
    per-slot append cursors (B,) and positions (B, 1).  Appends go into
    the pool in place; the cursor and position advance only for active
    slots (a retired slot's state cannot be rolled back in a shared pool,
    so it is gated here).  Returns (logits (B, V) float32, new cache)."""
    if "pool" not in cache:
        raise NotImplementedError("dense slot decode caches: ROADMAP A4")
    a = cfg.attn
    h = embed(params, cfg, token)
    positions = cache["next_pos"]
    cursor = cache["cursor"]
    table = cache["attn"]["table"]
    pool = cache["pool"]
    tables = rope_tables(positions, a.head_dim, a.rope_theta)
    slots = attn_mod.append_slots(table, cursor, paged_depth,
                                  pool["k"].shape[2], active)
    for layer, window in enumerate(_windows(cfg)):
        lp = layer_slice(params["layers"], layer)
        u = rms_norm(h, lp["ln1"], cfg.norm_eps)
        out = attn_mod.decode_attention_step_paged(
            lp["attn"], a, u, positions, layer_slice(pool, layer),
            table=table, cursor=cursor, depth=paged_depth, active=active,
            window=window, rope_tables=tables, slots=slots)
        h = _ffn_residual(h + out, lp, cfg)
    logits = unembed(params, cfg, h[:, 0])
    adv_c = torch.clamp(cursor + 1, max=paged_depth)
    adv_p = positions + 1
    if active is not None:
        adv_c = torch.where(active, adv_c, cursor)
        adv_p = torch.where(active[:, None], adv_p, positions)
    new_cache = dict(cache)
    new_cache["cursor"] = adv_c
    new_cache["next_pos"] = adv_p
    return logits, new_cache
