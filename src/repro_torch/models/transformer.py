"""Decoder stack of the port: parameters, embedding, the monolithic
prefill (``prefill``), the streaming prefill (``prefill_chunk`` /
``prefill_finalize``), the dense decode cache and its slot surgery, and
the decode step over a dense cache or the paged pool.

The port covers the attention-only llama family, the MoE archs
(deepseek-moe, phi3.5-moe), qwen2-vl's language backbone (M-RoPE
positions, embedding inputs), the SSM archs (the attention-free mamba2
and the hybrid hymba), the encoder-decoder whisper (``encode`` over
stubbed frame embeddings, cross-attention in every decoder block, and
optionally a cross-KV eviction) and every single-pass
eviction policy of the JAX package (``lookaheadkv``, ``gt_oracle``, the
window policies ``snapkv``/``pyramidkv``/``tova``, ``h2o`` and the
position policies ``streaming_llm``/``random``/``full``), with uniform,
pyramid or Ada-KV adaptive budgets, and the bucket-padded monolithic
prefill (``prompt_lens``); the draft-based policies compose these passes
in ``policies.run_eviction``.  Eviction applies to the attention
KV; the SSM's recurrent state is constant-size.  The streaming prefill
and the paged and slot-batched caches serve attention-only archs
(``chunkable``), as in the JAX package.  Per-layer parameters are
stacked along a leading L axis (the JAX package's tree layout); the
depth is a Python loop over layer slices, which are views of the
stacked tensors.

Block, by arch type:
    dense / vlm : h += attn(u);         h += mlp(rms_norm(h, ln2))
    moe    : h += attn(u);              h += moe(rms_norm(h, ln2))
    ssm    : h += ssd(u)                (no MLP when d_ff == 0)
    hybrid : h += (attn(u) + ssd(u)) / 2;  h += mlp(rms_norm(h, ln2))
    audio  : encoder blocks: h += attn(u) (bidirectional, no rotary);
             h += mlp(rms_norm(h, ln2));
             decoder blocks: h += attn(u);
             h += cross(rms_norm(h, ln_cross));  h += mlp(rms_norm(h, ln2))
with u = rms_norm(h, ln1).  The MoE block's load-balance loss (``aux``)
is summed over the layers by ``prefill`` and dropped elsewhere, as in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.config import EvictionConfig, ModelConfig
from repro_torch.common.sharding import (frozen_rows_axis, layer_gathers,
                                         mesh_signature, serving_cache_specs,
                                         shard_bounds)
from repro_torch.core import eviction as ev
from repro_torch.core import scoring
from repro_torch.core.lookahead import append_lookahead, lora_scale
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import layer_window
from repro_torch.models.layers import (dense_init, embed_init, gen_device,
                                      linear, rms_norm)
from repro_torch.models.rope import (rope_tables, tables_for,
                                     text_mrope_positions)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_arch(cfg: ModelConfig) -> None:
    a = cfg.attn
    ffn = cfg.d_ff > 0 or cfg.moe is not None
    if not (cfg.uses_ssm or (a is not None and ffn)):
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention blocks with an FFN "
            "(dense, MoE, the VLM backbone, whisper's encoder-decoder) and "
            "the SSM archs (ssm, hybrid)")


def chunkable(cfg: ModelConfig) -> bool:
    """Whether the streaming prefill (and so the continuous engine) serves
    ``cfg``: attention-only decoders, as in the JAX package."""
    a = cfg.attn
    return (cfg.uses_attention and not cfg.uses_ssm
            and not cfg.is_encoder_decoder and not a.mrope
            and not cfg.embeds_in)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> dict:
    """Random parameters in the JAX tree layout, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``; on the meta device, the
    tree's shapes and dtypes with nothing drawn."""
    _check_arch(cfg)
    dtype = torch_dtype(cfg)
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
    L, d = cfg.num_layers, cfg.d_model
    dev = gen_device(gen)
    layers = {"ln1": torch.zeros((L, d), dtype=dtype, device=dev)}
    if cfg.uses_attention:
        layers["attn"] = attn_mod.init(gen, cfg, dtype, lead=(L,))
    if cfg.uses_ssm:
        layers["ssm"] = ssm_mod.init(gen, cfg, dtype, lead=(L,))
    if cfg.moe is not None:
        layers["moe"] = moe_mod.init(gen, cfg, dtype, lead=(L,))
        layers["ln2"] = torch.zeros((L, d), dtype=dtype, device=dev)
    elif cfg.d_ff > 0:
        layers["ln2"] = torch.zeros((L, d), dtype=dtype, device=dev)
        layers["mlp"] = mlp_mod.init(gen, cfg, dtype, lead=(L,))
    if cfg.is_encoder_decoder:
        layers["cross"] = attn_mod.init(gen, cfg, dtype, lead=(L,))
        layers["ln_cross"] = torch.zeros((L, d), dtype=dtype, device=dev)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, d, dtype),
        "layers": layers,
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.padded_vocab, dtype)
    if cfg.is_encoder_decoder:
        Le, F = cfg.encoder.num_layers, cfg.encoder.num_frames
        params["encoder"] = {
            "layers": {
                "ln1": torch.zeros((Le, d), dtype=dtype, device=dev),
                "attn": attn_mod.init(gen, cfg, dtype, lead=(Le,)),
                "ln2": torch.zeros((Le, d), dtype=dtype, device=dev),
                "mlp": mlp_mod.init(gen, cfg, dtype, lead=(Le,)),
            },
            # drawn in float32, then cast (the JAX package's init)
            "pos_emb": (torch.randn((F, d), generator=gen, device=dev,
                                    dtype=torch.float32) * 0.02).to(dtype),
            "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        }
    return params


def layer_slice(tree: Optional[dict], layer: int) -> Optional[dict]:
    """Layer ``layer`` of a stacked tree (views, no copies)."""
    if tree is None:
        return None
    return {k: layer_slice(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in tree.items()}


def _layer_params(params: dict, layer: int, gathers: tuple,
                  mesh, stack: Optional[dict] = None) -> dict:
    """Layer ``layer`` of ``params`` (of ``stack``, the encoder's stacked
    layers, when given) as its products take it: over a mesh, every leaf
    ``gathers`` (``sharding.layer_gathers``, taken with the global config)
    names is all-gathered along its dims (ZeRO storage over "data", the
    MoE's shards over "model"), whole for this layer's use and dropped
    after.  These are the frozen weights: their gathers carry no
    gradient, and a leaf that asks for one raises."""
    lp = layer_slice(params["layers"] if stack is None else stack, layer)
    for path, dims in gathers:
        node = lp  # layer_slice made fresh dicts: safe to write into
        for k in path[:-1]:
            node = node[k]
        x = node[path[-1]]
        if x.requires_grad:
            raise ValueError(f"layer weight {'/'.join(path)} requires a "
                             "gradient: the gathered weights are frozen")
        for d, axis in dims:
            x = attn_mod.all_gather_raw(x, d, mesh, axis)
        node[path[-1]] = x
    return lp


def is_global_flags(cfg: ModelConfig) -> Optional[np.ndarray]:
    """Per-layer bool array for local:global patterns, or None if uniform
    (or without attention)."""
    a = cfg.attn
    if a is None:
        return None
    if a.global_layers:
        f = np.zeros(cfg.num_layers, bool)
        f[list(a.global_layers)] = True
        return f
    if a.global_every > 0:
        idx = np.arange(cfg.num_layers)
        return (idx % a.global_every) == (a.global_every - 1)
    return None


def check_policy(policy: Optional[str]) -> None:
    """Raise for a policy the prefill functions do not serve: the
    draft-based ones, which compose several passes
    (``policies.run_eviction``), and unknown names."""
    if policy in scoring.MULTI_PASS:
        raise ValueError(
            f"policy {policy!r} is draft-based (a draft, then a rescoring "
            "prefill): run it through policies.run_eviction")
    if policy not in (None,) + scoring.SINGLE_PASS:
        raise ValueError(f"unknown policy {policy!r}")


def _windows(cfg: ModelConfig) -> list:
    """Each layer's attention window (None: full, or no attention)."""
    if cfg.attn is None:
        return [None] * cfg.num_layers
    flags = is_global_flags(cfg)
    return [layer_window(cfg.attn, True if flags is None else bool(flags[i]))
            for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(params: dict, cfg: ModelConfig, inputs: torch.Tensor,
          smesh=None) -> torch.Tensor:
    """Token ids (B, S) through the embedding table; an ``embeds_in``
    arch also takes float embeddings (B, S, D) (qwen2-vl's projected
    patches), cast to the model dtype.  Under ``smesh`` with the table
    sharded by vocab rows, each rank looks up the rows it owns (zeros
    elsewhere) and the gathered parts are summed in rank order, exactly,
    since every token has one nonzero part."""
    if cfg.embeds_in and inputs.is_floating_point():
        return inputs.to(torch_dtype(cfg))
    table = params["embed"]
    ids = inputs.long()
    rows = table.shape[0]
    if smesh is None or rows == cfg.padded_vocab:
        return table[ids]
    local = ids - smesh.model_index * rows
    own = (local >= 0) & (local < rows)
    part = torch.where(own[..., None], table[local.clamp(0, rows - 1)], 0)
    parts = attn_mod.all_gather(part[None], 0, smesh)
    out = parts[0]
    for r in range(1, parts.shape[0]):
        out = out + parts[r]
    return out


def unembed(params: dict, cfg: ModelConfig, h: torch.Tensor,
            smesh=None) -> torch.Tensor:
    """Logits (float32) over the padded vocab; pad rows are -1e30.  Under
    ``smesh`` with the vocab sharded, each rank computes its vocab
    columns and the columns are all-gathered, so every rank holds the
    full logits."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = (h @ params["embed"].T).float()
    else:
        logits = (h @ params["lm_head"]).float()
    if smesh is not None and logits.shape[-1] != cfg.padded_vocab:
        logits = attn_mod.all_gather(logits, -1, smesh)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


def _ffn_residual(h, lp, cfg: ModelConfig, *, lora_l=None, lora_mask=None,
                  ls: float = 1.0, smesh=None):
    """The post-attention half of a block: (h + ffn(rms_norm(h, ln2)),
    aux), the MoE (``cfg.moe.dispatch`` picks ``moe.apply`` or
    ``apply_sparse``; its LoRA is the shared experts') or the MLP; aux is
    the MoE load-balance loss, None without MoE.  Under ``smesh`` the MLP
    runs tensor-parallel (``mlp.apply_sharded``); an MoE layer runs whole
    on every rank, on the params ``_layer_params`` gathered whole (JAX's
    ``replicated_apply``)."""
    if cfg.moe is not None:
        u = rms_norm(h, lp["ln2"], cfg.norm_eps)
        moe_lora = None
        if lora_l is not None and lora_l.get("moe"):
            moe_lora = lora_l["moe"].get("shared")
        apply = (moe_mod.apply_sparse if cfg.moe.dispatch == "sparse"
                 else moe_mod.apply)
        mo, aux = apply(lp["moe"], cfg, u, lora=moe_lora,
                        lora_mask=lora_mask, lora_scale=ls)
        return h + mo, aux
    if cfg.d_ff <= 0:  # mamba2: Mamba-2 blocks only
        return h, None
    u = rms_norm(h, lp["ln2"], cfg.norm_eps)
    mlp_lora = None if lora_l is None else lora_l.get("mlp")
    return h + mlp_mod.apply_sharded(lp["mlp"], cfg, u, smesh, lora=mlp_lora,
                                     lora_mask=lora_mask,
                                     lora_scale=ls), None


# ---------------------------------------------------------------------------
# Whisper encoder
# ---------------------------------------------------------------------------


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """Whisper's bidirectional encoder: frames (B, F, D), the stubbed
    frontend's embeddings, cast to the model dtype plus ``pos_emb``,
    through the encoder blocks (non-causal attention without rotary:
    kernel 7 on the card; then the MLP) and a final ``rms_norm``.
    Returns (B, F, D).  Over ``mesh`` (the trainer's, ``prefill(mesh=)``)
    ``params`` is the rank's shard: each block's weights are gathered at
    use as a decoder layer's, and its attention and MLP run at the rank's
    heads and columns where the heads divide the model axis, else
    whole."""
    enc = params["encoder"]
    smesh = attn_mod.model_shard_mesh(mesh, cfg.attn)
    gathers = layer_gathers(cfg, mesh, ("encoder", "layers"))
    la = attn_mod.local_config(cfg, smesh).attn
    h = frames.to(torch_dtype(cfg)) + enc["pos_emb"][None]
    B, F, _ = h.shape
    positions = torch.arange(F, device=h.device).expand(B, F)
    for layer in range(cfg.encoder.num_layers):
        lp = _layer_params(params, layer, gathers, mesh, enc["layers"])
        u = rms_norm(h, lp["ln1"], cfg.norm_eps)
        out, *_ = attn_mod.prefill_attention(lp["attn"], la, u, positions,
                                             causal=False, rotary=False,
                                             smesh=smesh)
        h = h + out
        u = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + mlp_mod.apply_sharded(lp["mlp"], cfg, u, smesh)
    return rms_norm(h, enc["final_norm"], cfg.norm_eps)


def encode_cross_kv(params: dict, cfg: ModelConfig, h_enc: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K/V of the encoder states:
    stacked (L, B, Se, KV, hd) each."""
    kv = [attn_mod.encode_kv(layer_slice(params["layers"]["cross"], i),
                             cfg.attn, h_enc)
          for i in range(cfg.num_layers)]
    return (torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


def _cross_evicted(lp: dict, cfg: ModelConfig, u_cross: torch.Tensor,
                   ck: torch.Tensor, cv: torch.Tensor, boundary: int,
                   cross_budget: int) -> ev.EvictedKV:
    """One layer's encoder KV evicted to ``min(cross_budget, Se)`` frames
    per kv head (beyond-paper), scored by the observation rows' queries
    ``[boundary:]`` projected with the cross block's ``wq`` and no LoRA,
    every frame visible (kernel 3 with ``q_offset = Se``).  h2o's rows
    ``[S:]`` are none: every frame then scores alike and the first are
    kept, as the JAX package's mean over no rows (NaN everywhere) ranks
    them."""
    a = cfg.attn
    B, Se = u_cross.shape[0], ck.shape[1]
    qc = linear(u_cross[:, boundary:], lp["cross"]["wq"],
                lp["cross"].get("bq"))
    qc = qc.reshape(B, -1, a.num_heads, a.head_dim)
    if qc.shape[1]:
        sc = scoring.observation_scores(qc, ck, Se, q_offset=Se)
    else:
        sc = torch.zeros((B, a.num_heads, Se), dtype=torch.float32,
                         device=ck.device)
    lk = cfg.lookahead
    sc = scoring.postprocess(sc, a.num_kv_heads, lk.pool_kernel if lk else 7)
    return ev.evict_layer(sc, ck, cv, min(cross_budget, Se))


# ---------------------------------------------------------------------------
# Monolithic prefill
# ---------------------------------------------------------------------------


class PrefillResult(NamedTuple):
    logits: Optional[torch.Tensor]  # (B, V) last-real-row logits, or (B, S, V)
    cache: Optional[dict]  # decode cache, or None without a policy
    scores: Optional[torch.Tensor]  # (L, B, H, n_keys) f32 with capture_scores
    aux: torch.Tensor  # MoE load-balance loss over layers: 0 without MoE


def prefill(
    params: dict,
    cfg: ModelConfig,
    inputs: torch.Tensor,  # (B, S) int tokens, or (B, S, D) embeddings
    *,
    lkv_params: Optional[dict] = None,
    policy: Optional[str] = None,  # eviction policy; None => no cache
    evict: Optional[EvictionConfig] = None,
    extra_slots: int = 0,  # empty tail rows for decode appends
    capture_scores: bool = False,
    gt_boundary: Optional[int] = None,  # gt_oracle: X|Y boundary in inputs
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S) M-RoPE
    encoder_embeds: Optional[torch.Tensor] = None,
    want_logits: str = "last",  # "last" | "all" | "none"
    want_ssm_cache: bool = False,  # the SSM's decode cache, even unevicted
    prompt_lens: Optional[torch.Tensor] = None,
    seeds: Optional[torch.Tensor] = None,  # (B,) request seeds (random)
    mesh=None,  # the trainer's passes over a mesh: the rank's shard
) -> PrefillResult:
    """The whole prompt in one forward pass (``ops.flash_attention``);
    each layer, right after its pass, scores the prompt keys, pools the
    scores and evicts its K/V to the budget, so only one layer's full K/V
    is alive at a time.

    Per policy: ``lookaheadkv`` appends the learned lookahead rows (and
    their selective LoRA) and scores from them; ``gt_oracle`` scores from
    the response rows ``inputs[:, gt_boundary:]`` (logits and positions
    then stop at ``gt_boundary``); ``snapkv``/``pyramidkv`` score from the
    last ``window_size`` prompt rows, ``tova`` from the last row, and both
    force-keep those rows; ``h2o`` scores from every row (kernel 3 with
    ``q_offset=0``); ``streaming_llm``, ``random`` (``seeds``: one per
    row) and ``full`` use ``eviction.position_scores``.  ``pyramidkv``
    takes per-layer budgets, ``evict.head_alloc="adaptive"`` per-head
    budgets.  The decode cache is {"attn": {k, v (L, B, cap, KV, hd),
    pos, mask (L, B, cap, KV)}, "cursor": capacity (int), "next_pos":
    (B, 1)} with ``cap = capacity + extra_slots``.  With ``policy=None``
    there is no cache.

    SSM archs: each layer's SSM runs the prompt, then the observation rows
    (the lookahead rows, or the response rows after ``gt_boundary``) as a
    chained second segment, so its cached state is the prompt's; hybrid
    blocks average the attention and SSM outputs.  The cache then also
    holds "ssm": {conv (L, B, cw - 1, conv_dim), state (L, B, nh, hd, ds)
    float32}, whenever a policy evicts or ``want_ssm_cache`` is set.
    Without attention (mamba2) nothing is evicted: the cache has no
    "attn" and no "cursor".

    ``prompt_lens`` (B,) enables bucket-padded prefill (the continuous
    engine's ``BucketedEngine``): ``inputs`` are right-padded to a shared
    length, and every consumer of the padded rows is masked: they are
    invalid attention keys (kernel 7's key mask, kernel 3's ``kv_mask``),
    score ``-1e30`` and never enter the decode cache.  Appended
    observation rows take positions after each row's true length, so
    lookaheadkv is exact under padding; the window policies' observation
    rows overlap the padding and are approximate there, as in the JAX
    package.  Attention-only archs, and not with ``gt_boundary``.

    M-RoPE archs (qwen2-vl) rotate by ``mrope_positions`` (3, B, S); the
    lookahead rows appended after them take each stream's own maximum +
    1 + i, and without given positions every row takes the text stream
    (t == h == w == its position).  An ``embeds_in`` arch takes float
    ``inputs`` (B, S, D) as the embedded prompt.  MoE archs sum each
    layer's load-balance loss into ``aux``.

    Encoder-decoder archs (whisper) need ``encoder_embeds`` (B, F, D),
    the stubbed frontend's frames (ValueError without them; any other
    arch raises ValueError when given them): ``encode`` runs once, every
    decoder layer's cross K/V are projected from it, and each block adds
    its cross-attention (the lookahead LoRA on its ``wq`` and ``wo`` on
    the lookahead rows) between the self-attention and the FFN.  The
    cache then holds "cross": the full encoder K/V {k, v (L, B, F, KV,
    hd)}, or with ``evict.cross_budget > 0`` under an evicting policy
    that has observation rows, each layer's frames evicted to
    ``min(cross_budget, F)`` per kv head {k, v, pos, mask}, scored by
    the observation rows' plain cross queries (``_cross_evicted``).

    ``capture_scores`` (training, ``core/objective.py``) returns every
    layer's per-q-head observation scores of the scored keys, before
    pooling, stacked as ``scores`` (L, B, H, n_keys) float32: those of
    ``policy`` when it is attention-scored, else of ``gt_oracle`` when
    ``gt_boundary`` is given (the GT pass over [X; Y]) and of
    ``lookaheadkv`` otherwise (the lookahead pass: ``lkv_params``' rows are
    appended whatever the policy).

    ``mesh`` runs the objective's two passes over a mesh (the JAX package
    has no such argument: GSPMD partitions its ``prefill``): ``params``
    is the rank's shard (``sharding.serving_specs``) and ``inputs`` its
    data row's batch rows.  Attention runs at the rank's heads where they
    divide the model axis (kernels 7 and 3 on the card; the lookahead
    rows' LoRA through ``attention.local_lora``), else whole, as serving
    does; the frozen weights are gathered at use (``_layer_params``) and
    the captured scores all-gathered over heads to (L, B, H, n).  M-RoPE
    streams are the data row's (3, B_row, S); whisper's encoder
    (``encode(mesh=)``) and each cross-attention run at the rank's heads
    where they divide the model axis, else whole, on the data row's
    frames.  Only ``capture_scores`` with ``gt_boundary`` or
    ``lkv_params``, ``want_logits="none"`` and no policy or bucket
    padding take a mesh; any other combination raises ``ValueError``
    (the monolithic serving routes take none, as the JAX launcher's)."""
    _check_arch(cfg)
    check_policy(policy)
    if mesh_signature(mesh) is None:
        mesh = None
    elif not (capture_scores and (gt_boundary is not None
                                  or lkv_params is not None)
              and want_logits == "none" and policy is None
              and prompt_lens is None):
        raise ValueError(
            "prefill over a mesh runs the training objective's passes only "
            "(capture_scores with gt_boundary or lkv_params, want_logits="
            "'none', no policy or prompt_lens): the monolithic serving "
            "routes take no mesh")
    smesh = attn_mod.model_shard_mesh(mesh, cfg.attn)
    gathers = layer_gathers(cfg, mesh)
    la = attn_mod.local_config(cfg, smesh).attn
    if prompt_lens is not None:
        if cfg.uses_ssm or cfg.is_encoder_decoder:
            raise ValueError("bucket-padded prefill supports attention-only "
                             "archs")
        if gt_boundary is not None:
            raise ValueError("prompt_lens and gt_boundary are exclusive")
    if want_logits not in ("last", "all", "none"):
        raise NotImplementedError(f"not ported yet: want_logits "
                                  f"{want_logits!r}")
    if cfg.is_encoder_decoder and encoder_embeds is None:
        raise ValueError(f"{cfg.name} needs frame embeddings "
                         "(encoder_embeds (B, F, D))")
    if encoder_embeds is not None and not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} has no encoder: encoder_embeds "
                         "apply to encoder-decoder archs only")
    if policy == "gt_oracle" and gt_boundary is None:
        raise ValueError("gt_oracle needs gt_boundary")
    a = cfg.attn
    lk = cfg.lookahead
    evict = evict or EvictionConfig()
    # the policy whose observation scores are computed (for eviction, for
    # capture, or both)
    obs_policy = policy if policy in scoring.OBS_POLICIES else None
    if capture_scores and obs_policy is None:
        if gt_boundary is None and lkv_params is None:
            raise ValueError("capture_scores needs gt_boundary (the GT "
                             "pass) or lkv_params (the lookahead pass)")
        obs_policy = "gt_oracle" if gt_boundary is not None \
            else "lookaheadkv"
    use_lookahead = policy == "lookaheadkv" or (
        capture_scores and lkv_params is not None and gt_boundary is None)
    h = embed(params, cfg, inputs, smesh)
    B, n_real = h.shape[:2]
    lmask = None
    if use_lookahead:
        if lkv_params is None:
            raise ValueError("lookaheadkv needs lookahead modules "
                             "(lkv_params)")
        h, lmask = append_lookahead(h, lkv_params)
    S = h.shape[1]
    dev = h.device
    col = torch.arange(S, device=dev)
    positions = col.expand(B, S)
    key_valid = None  # (B, S) valid keys under bucket padding
    if prompt_lens is not None:
        pl = prompt_lens.to(device=dev, dtype=torch.long)
        # observation rows sit right after each row's true prompt, not
        # after the padding, so their rotary positions are the unpadded
        # prefill's
        positions = torch.where(col < n_real, positions,
                                pl[:, None] + (col - n_real))
        key_valid = (col < pl[:, None]) | (col >= n_real)
    mrope = None
    if cfg.uses_attention and a.mrope:
        if mrope_positions is None:
            mrope = text_mrope_positions(positions)
        elif mrope_positions.shape[2] < S:  # extend for the lookahead rows
            given = mrope_positions.to(device=dev)
            extra = S - given.shape[2]
            mx = given.amax(dim=2, keepdim=True)
            ext = mx + 1 + torch.arange(extra, device=dev,
                                        dtype=given.dtype)
            mrope = torch.cat([given, ext], dim=2)
        else:
            mrope = mrope_positions.to(device=dev)
    tables = (tables_for(a, positions, mrope)
              if cfg.uses_attention else None)
    do_evict = policy is not None and cfg.uses_attention
    # hybrid archs need their recurrent state whenever a cache is built
    want_ssm_cache = want_ssm_cache or (do_evict and cfg.uses_ssm)
    # score geometry: the observation rows are [boundary, S); eviction
    # keeps rows of the first n_keys
    window_size = lk.window_size if lk else 32
    boundary = {"lookaheadkv": n_real, "gt_oracle": gt_boundary,
                "snapkv": S - window_size, "pyramidkv": S - window_size,
                "tova": S - 1}.get(obs_policy, S)
    if boundary < 0:
        raise ValueError(f"{obs_policy}: a prompt of {S} tokens is shorter "
                         f"than its {window_size}-row observation window")
    n_keys = boundary if obs_policy in scoring.FINAL_OBS else n_real
    n_obs = S if obs_policy == "h2o" else S - boundary
    score_layers = cfg.uses_attention and obs_policy is not None and (
        capture_scores or do_evict)
    if do_evict:
        adaptive = evict.head_alloc == "adaptive" and policy != "full"
        budgets, _ = _policy_budget_schedule(
            cfg, policy, evict.budget if policy != "full" else n_keys,
            evict.pyramid_beta)
        capacity = decode_cache_capacity(cfg, policy, evict,
                                         n_keys_max=n_keys)
        if policy in scoring.POSITION_POLICIES:
            pos_scores = ev.position_scores(
                policy, n_keys, B, a.num_kv_heads, sink=evict.sink,
                seeds=seeds, device=dev)
    # the SSM runs the observation rows (lookahead rows, a response suffix)
    # as a second segment chained after the prompt, whose state is cached
    ssm_split = n_real if use_lookahead else gt_boundary
    if ssm_split is not None and ssm_split >= S:
        ssm_split = None
    ls = lora_scale(cfg) if use_lookahead else 1.0
    lora_tree = lkv_params.get("lora") if use_lookahead else None
    pool_kernel = lk.pool_kernel if lk else 7
    h_enc = cross_layers = cross_kv = None
    if cfg.is_encoder_decoder:
        # the encoder runs once; each decoder layer projects its cross K/V
        # from it (at the rank's kv heads over a mesh)
        h_enc = encode(params, cfg, encoder_embeds, mesh)
        evict_cross = do_evict and evict.cross_budget > 0 and n_obs > 0
        cross_layers = [] if evict_cross else None
        if do_evict and not evict_cross:  # the cache keeps them whole
            cross_kv = ([], [])
    layers, ssm_caches, captured, auxes = [], [], [], []
    for layer, window in enumerate(_windows(cfg)):
        lp = _layer_params(params, layer, gathers, mesh)
        lora_l = layer_slice(lora_tree, layer)
        u = rms_norm(h, lp["ln1"], cfg.norm_eps)
        delta = None
        if cfg.uses_attention:
            delta, q, k, v = attn_mod.prefill_attention(
                lp["attn"], la, u, positions, window=window,
                lookahead_mask=lmask,
                lora=None if lora_l is None else lora_l.get("attn"),
                lora_scale=ls, rope_tables=tables, kv_mask=key_valid,
                smesh=smesh)
        if cfg.uses_ssm:
            s_out, ssm_cache = _ssm_prefill(lp["ssm"], cfg, u, ssm_split,
                                            lora_l=lora_l, ls=ls)
            delta = s_out if delta is None else delta + s_out
            if want_ssm_cache:
                ssm_caches.append(ssm_cache)
        if cfg.hybrid:
            delta = delta * 0.5
        h = h + delta
        if h_enc is not None:
            ck, cv = attn_mod.encode_kv(lp["cross"], la, h_enc)
            if cross_kv is not None:
                cross_kv[0].append(ck)
                cross_kv[1].append(cv)
            u_cross = rms_norm(h, lp["ln_cross"], cfg.norm_eps)
            h = h + attn_mod.cross_attention(
                lp["cross"], la, u_cross, ck, cv,
                lora=None if lora_l is None else lora_l.get("cross"),
                lora_mask=lmask, lora_scale=ls, smesh=smesh)
            if cross_layers is not None:
                cross_layers.append(_cross_evicted(
                    lp, cfg, u_cross, ck, cv, boundary, evict.cross_budget))
        h, aux_l = _ffn_residual(h, lp, cfg, lora_l=lora_l,
                                 lora_mask=lmask, ls=ls, smesh=smesh)
        if aux_l is not None:
            auxes.append(aux_l)
        if score_layers:
            s_qh = _observation_scores(obs_policy, q, k, boundary, n_keys,
                                       window, key_valid)
            if smesh is not None:  # the rank's heads -> every head
                s_qh = attn_mod.all_gather(s_qh, 1, smesh)
            if capture_scores:
                captured.append(s_qh)
        if do_evict:
            if policy in scoring.OBS_POLICIES:
                s_kv = scoring.postprocess(s_qh, a.num_kv_heads, pool_kernel)
                if policy in scoring.STREAMING_WINDOW:
                    # scored keys cover [0, boundary): the window's
                    # columns are zero-padded and force-kept
                    s_kv = torch.nn.functional.pad(
                        s_kv, (0, n_keys - s_kv.shape[-1]))
                    s_kv = ev.keep_window(s_kv, S - boundary)
            else:
                s_kv = pos_scores
            prompt_valid = (None if key_valid is None
                            else key_valid[:, :n_keys])
            s_mass = s_kv
            if prompt_valid is not None:
                # padded keys rank last (the max-pool may have spread real
                # neighbours' mass onto them) and stay out of the cache
                s_kv = torch.where(prompt_valid[:, None, :], s_kv, -1e30)
                # the -1e30 sentinels would corrupt the head-mass totals
                s_mass = s_kv.clamp(min=0.0)
            hb = (ev.adaptive_head_budgets(s_mass, evict.budget, capacity)
                  if adaptive else None)
            layers.append(ev.evict_layer(
                s_kv, k[:, :n_keys], v[:, :n_keys], capacity,
                layer_budget=None if adaptive else budgets[layer],
                head_budgets=hb, extra_slots=extra_slots,
                key_mask=prompt_valid))
        q = k = v = None  # only one layer's full K/V is alive at a time
    # gt_oracle: the "current" position is the X|Y boundary, not the end
    # of the response rows
    n_pos = gt_boundary if gt_boundary is not None else n_real
    cache = None
    if do_evict or (want_ssm_cache and cfg.uses_ssm):
        cache = {}
        if do_evict:
            cache["attn"] = {f: torch.stack([getattr(e, f) for e in layers])
                             for f in ev.EvictedKV._fields}
            cache["cursor"] = capacity
        if ssm_caches:
            cache["ssm"] = {f: torch.stack([c[f] for c in ssm_caches])
                            for f in ("conv", "state")}
        if cross_layers:
            cache["cross"] = {f: torch.stack([getattr(e, f)
                                              for e in cross_layers])
                              for f in ev.EvictedKV._fields}
        elif cross_kv is not None:
            cache["cross"] = {"k": torch.stack(cross_kv[0]),
                              "v": torch.stack(cross_kv[1])}
        cache["next_pos"] = (
            torch.full((B, 1), n_pos, dtype=torch.int32, device=dev)
            if prompt_lens is None else pl[:, None].to(torch.int32))
    logits = None
    if want_logits == "last" and prompt_lens is not None:
        # the last *real* row of each sequence
        logits = unembed(params, cfg, h[torch.arange(B, device=dev), pl - 1])
    elif want_logits == "last":
        logits = unembed(params, cfg, h[:, n_pos - 1])
    elif want_logits == "all":
        logits = unembed(params, cfg, h[:, :n_real])
    aux = (torch.stack(auxes).sum() if auxes
           else torch.zeros((), dtype=torch.float32, device=dev))
    scores = torch.stack(captured) if captured else None
    return PrefillResult(logits=logits, cache=cache, scores=scores, aux=aux)


def _ssm_prefill(p: dict, cfg: ModelConfig, u: torch.Tensor,
                 split: Optional[int], *, lora_l: Optional[dict],
                 ls: float) -> tuple[torch.Tensor, dict]:
    """One layer's SSM over the whole sequence, or over the prompt
    ``[:split]`` and then the observation rows chained after it (the
    prompt's conv tail and state carried in, the lookahead LoRA on them).
    Returns (out (B, S, D), the prompt's cache {"conv", "state"})."""
    if split is None:
        return ssm_mod.apply(p, cfg, u)
    out1, cache = ssm_mod.apply(p, cfg, u[:, :split])
    B, S = u.shape[:2]
    out2, _ = ssm_mod.apply(
        p, cfg, u[:, split:],
        lora=None if lora_l is None else lora_l.get("ssm"),
        lora_mask=torch.ones((B, S - split, 1), dtype=u.dtype,
                             device=u.device),
        lora_scale=ls, initial_state=cache["state"],
        conv_tail=cache["conv"])
    return torch.cat([out1, out2], dim=1), cache


def _observation_scores(policy: str, q: torch.Tensor, k: torch.Tensor,
                        boundary: int, n_keys: int, window,
                        key_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """One layer's per-q-head scores (B, H, n_scored) in the monolithic
    prefill: h2o scores every row at ``q_offset=0`` over the ``n_keys``
    prompt keys; the others score the rows ``[boundary, S)`` over every
    key, on the first ``boundary`` (none when the window is the whole
    prompt).  ``key_valid`` (B, S) masks the bucket padding out of the
    scored keys.  The kernel takes contiguous rows."""
    if policy == "h2o":
        return scoring.observation_scores(
            q.contiguous(), k, n_keys, window=window, q_offset=0,
            kv_mask=None if key_valid is None
            else key_valid[:, :n_keys].contiguous())
    if boundary == 0:
        B, _, H, _ = q.shape
        return torch.zeros((B, H, 0), dtype=torch.float32, device=q.device)
    return scoring.observation_scores(
        q[:, boundary:].contiguous(), k, boundary, window=window,
        kv_mask=None if key_valid is None
        else key_valid[:, :boundary].contiguous())


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
                     capacity: int, *, device="cuda",
                     mesh=None) -> ChunkState:
    """Fresh state with a ``capacity``-deep KV buffer, which must hold the
    prompt plus the appended observation rows, and the policy's zero
    ``ScoreState``.  Attention-only archs (``chunkable``).  Over a mesh,
    the rank's local heads."""
    _check_arch(cfg)
    cfg = attn_mod.local_config(
        cfg, attn_mod.model_shard_mesh(mesh, cfg.attn))
    check_policy(policy)
    if not chunkable(cfg):
        raise ValueError(f"{cfg.name}: chunked prefill serves "
                         "attention-only decoder archs (the SSM and hybrid "
                         "archs prefill monolithically)")
    a = cfg.attn
    lk = cfg.lookahead
    shape = (cfg.num_layers, batch, capacity, a.num_kv_heads, a.head_dim)
    k = torch.zeros(shape, dtype=torch_dtype(cfg), device=device)
    score = scoring.init_score_state(
        policy, cfg.num_layers, batch, a.num_heads, a.head_dim, capacity,
        window_size=lk.window_size if lk else 32, dtype=torch_dtype(cfg),
        device=device)
    return ChunkState(k=k, v=torch.zeros_like(k), score=score, pos=0)


def snapshot_chunk_state(state: ChunkState, n: int) -> ChunkState:
    """Chunk-boundary snapshot of a streaming prefill: K/V columns
    ``[:n]`` and the trimmed ``ScoreState``, everything a later request
    sharing this ``n``-token prefix needs to resume at ``pos = n``.

    Contiguous copies: the donor's buffers are written in place by its
    next chunks, and a view of them would pin the whole capacity-deep
    buffer out of sight of the prefix cache's byte budget.  Sound because
    every ``prefill_chunk`` quantity at a boundary covered by full chunks
    is a function of the prefix tokens alone (causal attention; rows past
    ``n_total`` gated; seeds enter at finalize), so the snapshot is bitwise
    what another request with this prefix computes at the same buffer
    capacity."""
    if n > state.k.shape[2]:
        raise ValueError("snapshot deeper than the KV buffer")
    return ChunkState(k=state.k[:, :, :n].clone(),
                      v=state.v[:, :, :n].clone(),
                      score=state.score.snapshot(n), pos=n)


def resume_chunk_state(snap: ChunkState, capacity: int) -> ChunkState:
    """Inverse of ``snapshot_chunk_state``: new ``capacity``-deep buffers
    holding the snapshot's columns and zeros after them (bitwise a fresh
    buffer streamed to ``pos = n``), resuming at ``pos = n``.  New
    tensors, since the resumed request writes them in place."""
    n = snap.k.shape[2]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < snapshot depth {n}")
    shape = (snap.k.shape[:2] + (capacity,) + tuple(snap.k.shape[3:]))
    k = torch.zeros(shape, dtype=snap.k.dtype, device=snap.k.device)
    v = torch.zeros_like(k)
    k[:, :, :n] = snap.k
    v[:, :, :n] = snap.v
    return ChunkState(k=k, v=v, score=snap.score.restore(capacity), pos=n)


def prefill_chunk(
    params: dict,
    cfg: ModelConfig,
    state: ChunkState,
    tokens: torch.Tensor,  # (B, chunk) tokens; rows past n_total are pad
    n_total: int,  # true prompt length
    *,
    policy: str,
    mesh=None,  # tensor-parallel serving: the rank's shard of params
) -> tuple[ChunkState, torch.Tensor]:
    """Process one chunk starting at ``state.pos``: its K/V land in the
    buffer and its scores in the state (in place).  Returns (state',
    logits (B, V) of the chunk's last real row).  Pad rows of a partial
    final chunk are inert: causal masking hides their keys from every real
    row, they carry no score (h2o's masses count only rows below
    ``n_total``; the query window rolls in only real rows) and finalize
    masks their columns out of the cache.  Only h2o asks the attention
    for column masses (kernel 2 on the card; kernel 1 otherwise).  Over a
    ``mesh`` whose model axis divides the heads, ``params`` and ``state``
    are the rank's shards and every rank returns the full logits."""
    smesh = attn_mod.model_shard_mesh(mesh, cfg.attn)
    gathers = layer_gathers(cfg, mesh)
    cfg = attn_mod.local_config(cfg, smesh)
    a = cfg.attn
    h = embed(params, cfg, tokens, smesh)
    B, C = h.shape[:2]
    s = state.pos
    positions = (s + torch.arange(C, device=h.device)).expand(B, C)
    tables = rope_tables(positions, a.head_dim, a.rope_theta)
    score = state.score
    want_masses = policy in scoring.STREAMING_CUMULATIVE
    for layer, window in enumerate(_windows(cfg)):
        lp = _layer_params(params, layer, gathers, mesh)
        u = rms_norm(h, lp["ln1"], cfg.norm_eps)
        out, q, masses = attn_mod.chunk_prefill_attention(
            lp["attn"], a, u, positions, state.k[layer], state.v[layer],
            q_offset=s, window=window, score_masses=want_masses,
            n_total=n_total, rope_tables=tables, smesh=smesh)
        h, _ = _ffn_residual(h + out, lp, cfg, smesh=smesh)
        scoring.update_layer_scores(
            policy, None if score.acc is None else score.acc[layer],
            None if score.qbuf is None else score.qbuf[layer], q,
            masses_l=masses, q_offset=s, n_total=n_total)
    if score.acc is not None:
        score = score._replace(cnt=score.cnt + min(max(n_total - s, 0), C))
    row = min(max(n_total - 1 - s, 0), C - 1)
    logits = unembed(params, cfg, h[:, row], smesh)
    return ChunkState(k=state.k, v=state.v, score=score, pos=s + C), logits


def _chunk_observation_pass(params: dict, cfg: ModelConfig, state: ChunkState,
                            n_total: int, *, policy: str,
                            lkv_params: Optional[dict] = None,
                            obs_tokens: Optional[torch.Tensor] = None,
                            smesh=None, mesh=None,
                            gathers: tuple = ()) -> torch.Tensor:
    """The final-observation pass of lookaheadkv (the learned lookahead
    rows, with their selective LoRA) or gt_oracle (the response rows
    ``obs_tokens``): the rows run through the stack at positions
    ``n_total + arange(n_obs)`` against the materialised prompt KV,
    appending their keys after the prompt so each row's softmax includes
    the observation keys as in monolithic prefill.  Returns obs masses
    (L, B, H, K): the mean over observation rows of each q head's softmax
    mass per key.  Over a mesh, ``cfg`` is the rank's local config and
    ``gathers`` the global one's ``layer_gathers``."""
    a = cfg.attn
    L, B, K = state.k.shape[:3]
    if policy == "lookaheadkv":
        if lkv_params is None:
            raise ValueError("lookaheadkv needs lookahead modules "
                             "(lkv_params)")
        emb = lkv_params["emb"].to(torch_dtype(cfg))
        n_obs = emb.shape[0]
        h = emb[None].expand(B, n_obs, emb.shape[1])
        lora_tree, ls = lkv_params.get("lora"), lora_scale(cfg)
        lmask = torch.ones((B, n_obs, 1), dtype=h.dtype, device=h.device)
    else:  # gt_oracle: the response rows are the observation window
        if obs_tokens is None:
            raise ValueError("gt_oracle needs the response rows "
                             "(obs_tokens)")
        h = embed(params, cfg, obs_tokens, smesh)
        n_obs = h.shape[1]
        lora_tree, ls, lmask = None, 1.0, None
    positions = (n_total + torch.arange(n_obs, device=h.device)).expand(
        B, n_obs)
    tables = rope_tables(positions, a.head_dim, a.rope_theta)
    masses = []
    for layer, window in enumerate(_windows(cfg)):
        lp = _layer_params(params, layer, gathers, mesh)
        lora_l = layer_slice(lora_tree, layer)
        u = rms_norm(h, lp["ln1"], cfg.norm_eps)
        out, q, _ = attn_mod.chunk_prefill_attention(
            lp["attn"], a, u, positions, state.k[layer], state.v[layer],
            q_offset=n_total, window=window, lookahead_mask=lmask,
            lora=None if lora_l is None else lora_l.get("attn"),
            lora_scale=ls, rope_tables=tables, smesh=smesh)
        h, _ = _ffn_residual(h + out, lp, cfg, lora_l=lora_l,
                             lora_mask=lmask, ls=ls, smesh=smesh)
        masses.append(ops.lookahead_score(q, state.k[layer], K,
                                          q_offset=n_total, window=window))
    return torch.stack(masses)


def _policy_budget_schedule(cfg: ModelConfig, policy: str, budget: int,
                            beta: float) -> tuple[list, int]:
    """(per-layer budgets, kept-slot capacity): PyramidKV's funnel, whose
    first layer keeps up to ``int(2β/(β+1)·budget) + 1`` rows, or
    ``budget`` on every layer."""
    if policy == "pyramidkv":
        return (ev.pyramid_budgets(cfg.num_layers, budget, beta),
                int(2.0 * beta / (beta + 1.0) * budget) + 1)
    return ev.uniform_budgets(cfg.num_layers, budget), budget


def decode_cache_capacity(cfg: ModelConfig, policy: str,
                          evict: EvictionConfig, *, n_keys_max: int) -> int:
    """Kept-slot capacity of the decode cache a prefill under ``policy``
    produces for prompts up to ``n_keys_max`` tokens: the budget (the
    prompt for ``full``), PyramidKV's first-layer capacity, or with
    adaptive head budgets ``int(budget * adaptive_ceiling)``; the serving
    engines size their slots and pool blocks with it."""
    _, capacity = _policy_budget_schedule(
        cfg, policy, evict.budget if policy != "full" else n_keys_max,
        evict.pyramid_beta)
    if evict.head_alloc == "adaptive" and policy != "full":
        capacity = int(evict.budget * evict.adaptive_ceiling)
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
    obs_tokens: Optional[torch.Tensor] = None,  # (B, n_obs) gt_oracle only
    extra_slots: int = 0,
    seeds: Optional[torch.Tensor] = None,  # (B,) request seeds (random)
    mesh=None,  # tensor-parallel serving: the rank's shard of params
) -> dict:
    """Close a streaming prefill: run the deferred observation pass (for
    lookaheadkv and gt_oracle), turn the ``ScoreState`` into eviction
    scores (position policies: ``position_scores`` over the K-deep
    buffer) and evict every layer once over the materialised buffer.
    Returns the decode cache {"attn": {k, v (L, B, cap, KV, hd), pos, mask
    (L, B, cap, KV)}, "cursor": capacity, "next_pos": (B, 1)} with ``cap
    = capacity + extra_slots``: the kept slots of the monolithic
    ``prefill``, with surplus slots masked invalid.

    Over a ``mesh``, each rank scores, pools and selects over its local kv
    heads and returns their cache; what couples the heads is taken at the
    global head count and sliced: the position policies' scores (the
    random draws), and the adaptive head budgets (over the all-gathered
    scores)."""
    check_policy(policy)
    smesh = attn_mod.model_shard_mesh(mesh, cfg.attn)
    kv_global = cfg.attn.num_kv_heads
    gathers = layer_gathers(cfg, mesh)
    cfg = attn_mod.local_config(cfg, smesh)
    a = cfg.attn
    lk = cfg.lookahead
    evict = evict or EvictionConfig()
    L, B, K = state.k.shape[:3]
    dev = state.k.device
    obs = None
    if policy in scoring.FINAL_OBS:
        obs = _chunk_observation_pass(params, cfg, state, n_total,
                                      policy=policy, lkv_params=lkv_params,
                                      obs_tokens=obs_tokens, smesh=smesh,
                                      mesh=mesh, gathers=gathers)
    budgets, _ = _policy_budget_schedule(
        cfg, policy, evict.budget if policy != "full" else K,
        evict.pyramid_beta)
    capacity = decode_cache_capacity(cfg, policy, evict, n_keys_max=K)
    adaptive = evict.head_alloc == "adaptive" and policy != "full"
    key_mask = (torch.arange(K, device=dev) < n_total).expand(B, K)
    if policy in scoring.POSITION_POLICIES:
        pos = ev.position_scores(policy, K, B, kv_global, sink=evict.sink,
                                 seeds=seeds, device=dev)
        if smesh is not None:
            pos = attn_mod.model_slice(pos, smesh, dim=1)
        pos_scores = torch.where(key_mask[:, None, :], pos, NEG_INF)
    sc = state.score
    layers = []
    for layer, window in enumerate(_windows(cfg)):
        if policy in scoring.OBS_POLICIES:
            s_kv = scoring.finalize_layer_scores(
                policy, state.k[layer], n_total,
                acc_l=None if sc.acc is None else sc.acc[layer], cnt=sc.cnt,
                qbuf_l=None if sc.qbuf is None else sc.qbuf[layer],
                obs_masses_l=None if obs is None else obs[layer],
                num_kv_heads=a.num_kv_heads,
                pool_kernel=lk.pool_kernel if lk else 7,
                window_size=lk.window_size if lk else 32, window=window)
        else:
            s_kv = pos_scores
        hb = None
        if adaptive:
            s_all = torch.clamp(s_kv, min=0.0)
            if smesh is not None:
                s_all = attn_mod.all_gather(s_all, 1, smesh)
            hb = ev.adaptive_head_budgets(s_all, evict.budget, capacity)
            if smesh is not None:
                hb = attn_mod.model_slice(hb, smesh, dim=1)
        layers.append(ev.evict_layer(
            s_kv, state.k[layer], state.v[layer], capacity,
            layer_budget=None if adaptive else budgets[layer],
            head_budgets=hb, extra_slots=extra_slots, key_mask=key_mask))
    attn = {f: torch.stack([getattr(e, f) for e in layers])
            for f in ev.EvictedKV._fields}
    return {
        "attn": attn,
        "cursor": capacity,
        "next_pos": torch.full((B, 1), n_total, dtype=torch.int32,
                               device=dev),
    }


# ---------------------------------------------------------------------------
# Dense decode caches and their slot surgery
# ---------------------------------------------------------------------------
#
# Post-eviction decode caches have the same shape whatever the prompt
# length: (capacity + margin) rows.  The continuous engine exploits that: a
# freshly prefilled request's cache goes into any free slot of the live
# slot-batched cache without reshaping anything.  Where the JAX package
# returns updated copies, ``insert_request_cache`` writes the live cache in
# place.


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int, *,
                      fill_len: int = 0, hot_slots: int = 0,
                      per_slot_cursor: bool = False, device="cuda",
                      mesh=None) -> dict:
    """Fresh dense decode cache: k/v (L, batch, capacity, KV, hd) zeros,
    pos (L, batch, capacity, KV) = row index, mask true on the first
    ``fill_len`` rows (a cache already holding that many tokens, as the
    dry-run's decode shapes model it) and false past them, the cursor and
    positions ``fill_len``.  ``per_slot_cursor`` gives every batch row
    (serving slot) its own append cursor, a (batch,) tensor; otherwise
    the cursor is one int for the batch (lockstep).  SSM archs add "ssm":
    {conv (L, batch, cw - 1, conv_dim), state (L, batch, nh, hd, ds)
    float32} zeros; without attention there is no "attn" and no cursor.
    Encoder-decoder archs add "cross": {k, v (L, batch, F, KV, hd)}
    zeros, the unevicted encoder K/V.

    ``hot_slots`` selects the split-cache decode's layout: the rows above
    are the frozen prompt cache (read only), and "attn" adds the hot ring
    hot_k/hot_v (L, batch, hot_slots, KV, hd) zeros, hot_pos (L, batch,
    hot_slots, KV) zeros and hot_mask false, which new tokens append to;
    the cursor becomes the ring's counter, 0 (``per_slot_cursor`` raises,
    as the JAX package asserts).

    Over a mesh, each leaf is the rank's block in the layout of
    ``sharding.serving_cache_specs`` (its kv heads where the heads shard;
    with ``hot_slots`` also its batch rows over the data axes, and else
    its slice of the frozen rows over "model", which ``pos`` numbers
    globally and ``"frozen_axis"`` names)."""
    _check_arch(cfg)
    if hot_slots and per_slot_cursor:
        raise ValueError("split-cache decode uses the shared hot-ring "
                         "counter, not per-slot cursors")
    a = cfg.attn
    L = cfg.num_layers
    dtype = torch_dtype(cfg)
    if mesh is not None and mesh_signature(mesh) is not None:
        specs = serving_cache_specs(cfg, mesh, batch, capacity, hot_slots)
    else:
        mesh = specs = None

    def block(group: str, name: str, shape: tuple) -> tuple:
        """(local shape, start of each dim) of a leaf."""
        if specs is None:
            return shape, (0,) * len(shape)
        b = shard_bounds(shape, specs[group][name], mesh, mesh.rank)
        return tuple(n for _, n in b), tuple(s0 for s0, _ in b)

    cache = {}
    if cfg.uses_attention:
        attn = {}
        full = (L, batch, capacity, a.num_kv_heads)
        shape, start = block("attn", "k", full + (a.head_dim,))
        attn["k"] = torch.zeros(shape, dtype=dtype, device=device)
        attn["v"] = torch.zeros_like(attn["k"])
        rows = torch.arange(start[2], start[2] + shape[2], dtype=torch.int32,
                            device=device)
        attn["pos"] = rows[None, None, :, None].expand(shape[:4]).clone()
        attn["mask"] = (rows < fill_len)[None, None, :, None].expand(
            shape[:4]).clone()
        cache["cursor"] = (torch.full((batch,), fill_len, dtype=torch.int32,
                                      device=device)
                           if per_slot_cursor else fill_len)
        cache["attn"] = attn
    nb = batch  # the rank's batch rows (split over data with hot_slots)
    if specs is not None:
        nb = shard_bounds((batch, 1), specs["next_pos"], mesh,
                          mesh.rank)[0][1]
    if cfg.uses_ssm:
        cache["ssm"] = ssm_mod.init_cache(cfg, nb, dtype, lead=(L,),
                                          device=device)
    if cfg.is_encoder_decoder:
        shape, _ = block("cross", "k", (L, batch, cfg.encoder.num_frames,
                                        a.num_kv_heads, a.head_dim))
        k = torch.zeros(shape, dtype=dtype, device=device)
        cache["cross"] = {"k": k, "v": torch.zeros_like(k)}
    cache["next_pos"] = torch.full((nb, 1), fill_len, dtype=torch.int32,
                                   device=device)
    if not (hot_slots and cfg.uses_attention):
        return cache
    cache = add_hot_ring(cache, hot_slots)
    axis = None if specs is None else frozen_rows_axis(cfg, mesh, batch,
                                                       capacity)
    if axis is not None:
        cache["frozen_axis"] = axis
    return cache


def add_decode_eviction_scores(cache: dict) -> dict:
    """Arm a dense decode cache for decoding-stage eviction
    (``attention.decode_attention_step_evicting``): a ``score`` leaf
    (L, B, C, KV) float32 where valid kept rows start at 1.0 (they already
    won prefill eviction) and every other row at 0.  Returns a new dict
    sharing the other leaves."""
    out = dict(cache)
    out["attn"] = dict(cache["attn"],
                       score=cache["attn"]["mask"].to(torch.float32))
    return out


def add_hot_ring(cache: dict, hot_slots: int) -> dict:
    """A dense decode cache (a prefill's, or a rank's block of one) as the
    split-cache decode's: its rows frozen, an empty hot ring of
    ``hot_slots`` rows beside them with the rows' batch and kv heads
    (hot_k/hot_v zeros, hot_pos zeros, hot_mask false) and the cursor the
    ring's counter, 0.  Returns a new dict sharing the frozen leaves."""
    attn = cache["attn"]
    L, B, _, KV, hd = attn["k"].shape
    k = torch.zeros((L, B, hot_slots, KV, hd), dtype=attn["k"].dtype,
                    device=attn["k"].device)
    out = dict(cache, cursor=0)
    out["attn"] = dict(attn, hot_k=k, hot_v=torch.zeros_like(k),
                       hot_pos=torch.zeros(k.shape[:4], dtype=torch.int32,
                                           device=k.device),
                       hot_mask=torch.zeros(k.shape[:4], dtype=torch.bool,
                                            device=k.device))
    return out


def pad_cache_capacity(cache: dict, capacity: int) -> dict:
    """Right-pad the attention row axis to ``capacity`` (mask False): small
    prompts clamp the kept capacity below the budget, so their caches are
    shallower than the live cache."""
    attn = cache["attn"]
    C = attn["k"].shape[2]
    if C == capacity:
        return cache
    if C > capacity:
        raise ValueError(f"cache deeper ({C}) than live capacity "
                         f"({capacity})")
    out = dict(cache)
    out["attn"] = {
        name: torch.nn.functional.pad(
            leaf, (0, 0) * (leaf.dim() - 3) + (0, capacity - C))
        for name, leaf in attn.items()}
    return out


def insert_request_cache(live: dict, req: dict, slot: int) -> dict:
    """Write a batch-1 request cache (a prefill's) into slot ``slot`` of the
    live slot-batched cache, in place: its rows (capacity-padded first;
    every leaf of ``attn``, the decode-eviction ``score`` too), its
    position, and its scalar cursor into the live per-slot cursors.
    Returns ``live``."""
    req = pad_cache_capacity(req, live["attn"]["k"].shape[2])
    for name, leaf in live["attn"].items():
        leaf[:, slot] = req["attn"][name][:, 0].to(leaf.dtype)
    live["next_pos"][slot] = req["next_pos"][0]
    if "cursor" in live:
        live["cursor"][slot] = int(req["cursor"])
    return live


def extract_request_cache(live: dict, slot: int) -> dict:
    """Copy slot ``slot`` back out as a batch-1 request cache: the inverse
    of ``insert_request_cache`` up to capacity padding."""
    out = {"attn": {name: leaf[:, slot:slot + 1].clone()
                    for name, leaf in live["attn"].items()},
           "next_pos": live["next_pos"][slot:slot + 1].clone()}
    cur = live.get("cursor")
    if cur is not None:
        out["cursor"] = (cur[slot:slot + 1].clone()
                         if isinstance(cur, torch.Tensor) and cur.dim()
                         else cur)
    return out


def select_cache_slots(active: torch.Tensor, new_cache: dict,
                       old_cache: dict) -> dict:
    """Per-slot select between two decode caches of the same structure:
    slot b takes ``new_cache`` where ``active[b]``, else ``old_cache``.  A
    scalar (lockstep) cursor comes from ``new_cache``.  (The port's own
    decode step gates its in-place writes by ``active`` instead, which
    gives the same cache; this is the JAX package's out-of-place form.)"""
    def sel(new, old, axis):
        if not isinstance(old, torch.Tensor) or old.dim() == 0:
            return new
        shape = [1] * new.dim()
        shape[axis] = active.shape[0]
        return torch.where(active.reshape(shape), new, old)

    out = {"attn": {name: sel(leaf, old_cache["attn"][name], 1)
                    for name, leaf in new_cache["attn"].items()}}
    for name in ("cursor", "next_pos"):
        if name in new_cache:
            out[name] = sel(new_cache[name], old_cache[name], 0)
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(
    params: dict,
    cfg: ModelConfig,
    token: torch.Tensor,  # (B, 1) tokens, or (B, 1, D) embeddings
    cache: dict,
    *,
    active: Optional[torch.Tensor] = None,  # (B,) live slots
    paged_depth: Optional[int] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, 1) M-RoPE
    mesh=None,  # tensor-parallel serving: the rank's shard of params
) -> tuple[torch.Tensor, dict]:
    """One decode step.  Returns (logits (B, V) float32, new cache).

    A dense cache holds ``cache["attn"]`` (k/v (L, B, C, KV, hd), pos/mask
    (L, B, C, KV)), the cursor (an int for the batch, or (B,) per-slot
    cursors) and the positions (B, 1); with a ``score`` leaf (L, B, C, KV)
    (``add_decode_eviction_scores``) every layer takes the evicting step.
    A paged cache holds the shared pool (``"pool"``: k/v (L, N, bs, KV,
    hd), pos/mask (L, N, bs, KV), and under decode-time eviction the
    engine's ``score`` (L, B, depth, KV)), the block table
    (``cache["attn"]["table"]``, (B, nb) int32), per-slot cursors (B,) and
    positions, and needs ``paged_depth``.

    Both write their cache in place, gated by ``active``: an inactive
    slot writes nothing and its cursor and position do not advance, so a
    retired slot stays bit for bit unchanged (the JAX package gates the
    shared pool the same way and rolls a dense cache back with
    ``select_cache_slots``).

    M-RoPE archs rotate by ``mrope_positions`` (3, B, 1) when given, else
    by the text stream of ``next_pos`` (as the JAX step: not each
    stream's maximum + 1).

    SSM archs carry ``cache["ssm"]`` (conv, state), which the recurrent
    step rewrites in place for every row: they are served by the lockstep
    engine only, which decodes the whole batch.  A cache without
    attention leaves (mamba2, or a hybrid prefilled without a policy)
    runs no attention, as in the JAX package.

    Encoder-decoder archs carry ``cache["cross"]``, read only: each
    block's cross-attention of the token over the full encoder K/V
    (``ops.flash_attention`` with one query row: kernel 6 on the card),
    or with a ``mask`` leaf (a ``cross_budget`` eviction) over its kept
    frames under the per-kv-head mask (``ops.decode_attention``).

    A split cache (``init_decode_cache(hot_slots=)``: hot_k/hot_v/hot_pos/
    hot_mask beside the frozen rows) takes the split step in every layer
    (``attention.decode_attention_step_split``): the token goes into the
    hot ring at the counter modulo its rows, and the counter advances by
    one.

    Over a ``mesh`` whose model axis divides the heads, ``params`` and the
    cache are the rank's shards (its kv heads), attention runs on its
    local heads and every rank returns the full logits.  A split cache
    whose frozen rows the mesh slices by sequence (``"frozen_axis"``)
    merges each layer's frozen partials over the ranks holding them."""
    smesh = attn_mod.model_shard_mesh(mesh, cfg.attn)
    gathers = layer_gathers(cfg, mesh)
    cfg = attn_mod.local_config(cfg, smesh)
    a = cfg.attn
    h = embed(params, cfg, token, smesh)
    B = h.shape[0]
    positions = cache["next_pos"]
    paged = "pool" in cache
    attend = cfg.uses_attention and (paged or "attn" in cache)
    split = False
    if attend:
        cursor = cache["cursor"]
        mrope = None
        if a.mrope:
            mrope = (text_mrope_positions(positions)
                     if mrope_positions is None
                     else mrope_positions.to(device=h.device))
        tables = tables_for(a, positions, mrope)
    if attend and paged:
        if paged_depth is None:
            raise ValueError("paged decode needs paged_depth")
        table = cache["attn"]["table"]
        pool = cache["pool"]
        slots = attn_mod.append_slots(table, cursor, paged_depth,
                                      pool["k"].shape[2], active)
        depth = paged_depth
    elif attend:
        depth = cache["attn"]["k"].shape[2]
        evicting = "score" in cache["attn"]
        split = "hot_k" in cache["attn"]
        if split:
            if active is not None:
                raise ValueError("the split-cache decode steps the whole "
                                 "batch (no active mask)")
            slot = int(cursor) % cache["attn"]["hot_k"].shape[2]
            group = attn_mod.frozen_rows_group(mesh,
                                               cache.get("frozen_axis"))
        elif not evicting:
            rows = attn_mod.dense_append_rows(cursor, depth, B, h.device,
                                              active)
    cross = cache.get("cross") if cfg.is_encoder_decoder else None
    for layer, window in enumerate(_windows(cfg)):
        lp = _layer_params(params, layer, gathers, mesh)
        u = rms_norm(h, lp["ln1"], cfg.norm_eps)
        delta = None
        if attend and paged:
            delta = attn_mod.decode_attention_step_paged(
                lp["attn"], a, u, positions, layer_slice(pool, layer),
                table=table, cursor=cursor, depth=paged_depth,
                active=active, window=window, rope_tables=tables,
                slots=slots, smesh=smesh)
        elif attend and split:
            delta = attn_mod.decode_attention_step_split(
                lp["attn"], a, u, positions,
                layer_slice(cache["attn"], layer), slot=slot, window=window,
                rope_tables=tables, smesh=smesh, group=group)
        elif attend and evicting:
            delta = attn_mod.decode_attention_step_evicting(
                lp["attn"], a, u, positions,
                layer_slice(cache["attn"], layer), cursor=cursor,
                active=active, window=window, rope_tables=tables,
                smesh=smesh)
        elif attend:
            delta = attn_mod.decode_attention_step(
                lp["attn"], a, u, positions,
                layer_slice(cache["attn"], layer), rows=rows, window=window,
                rope_tables=tables, smesh=smesh)
        if cfg.uses_ssm:
            s_out = _ssm_decode(lp["ssm"], cfg, u,
                                layer_slice(cache["ssm"], layer))
            delta = s_out if delta is None else delta + s_out
        if cfg.hybrid:
            delta = delta * 0.5
        h = h + delta
        if cross is not None:
            u = rms_norm(h, lp["ln_cross"], cfg.norm_eps)
            if "mask" in cross:
                h = h + attn_mod.cross_attention_decode_evicted(
                    lp["cross"], a, u, layer_slice(cross, layer))
            else:
                h = h + attn_mod.cross_attention(
                    lp["cross"], a, u, cross["k"][layer], cross["v"][layer])
        h, _ = _ffn_residual(h, lp, cfg, smesh=smesh)
    logits = unembed(params, cfg, h[:, 0], smesh)
    new_cache = dict(cache)
    adv_p = positions + 1
    if active is not None:
        adv_p = torch.where(active[:, None], adv_p, positions)
    new_cache["next_pos"] = adv_p
    if not attend:
        return logits, new_cache
    if split:  # the hot ring's counter
        adv_c = int(cursor) + 1
    elif isinstance(cursor, torch.Tensor) and cursor.dim() == 1:
        adv_c = torch.clamp(cursor + 1, max=depth)
        if active is not None:
            adv_c = torch.where(active, adv_c, cursor)
    else:  # the lockstep batch shares one cursor
        adv_c = min(int(cursor) + 1, depth)
    new_cache["cursor"] = adv_c
    return logits, new_cache


def _ssm_decode(p: dict, cfg: ModelConfig, u: torch.Tensor,
                cache_l: dict) -> torch.Tensor:
    """One layer's recurrent SSM step; writes the new conv tail and state
    into the layer's cache views in place.  Returns its output (B, 1, D)."""
    out, new = ssm_mod.step(p, cfg, u, cache_l)
    for name, leaf in cache_l.items():
        leaf.copy_(new[name])
    return out
