"""Policy orchestration of the port: prefill + eviction (``run_eviction``
monolithic, ``run_eviction_chunked`` streamed), greedy decode
(``greedy_decode`` for the lockstep engine, ``decode_chunk`` for the
continuous one) and the chunked prefill's buffer sizing.

Every policy of the JAX package is served, with greedy decode or with
temperature / top-k / top-p sampling (``Sampling``) on the JAX
package's random stream.  The single-pass ones call
``transformer.prefill`` once; the draft-based baselines compose passes:

* **LAQ** (Lookahead Q-Cache): a snapkv prefill, a greedy draft of
  ``evict.draft_len`` tokens over that compressed cache, then a
  ``gt_oracle`` prefill over [prompt; draft] that rescores the prompt's
  keys with the draft rows as observation queries;
* **SpecKV**: a separate draft model prefills the prompt with the
  ``full`` policy and drafts greedily; the target model then rescores as
  LAQ does.

Both recompute the scoring prefill over [prompt; draft] (the JAX
package's adaptation), and neither serves bucket-padded prompts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.common.config import EvictionConfig, ModelConfig
from repro_torch.core.eviction import (PRNGKey, categorical, fold_in,
                                       split)
from repro_torch.core.scoring import (  # noqa: F401  (re-exported)
    ALL_POLICIES, MULTI_PASS, SINGLE_PASS)
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import transformer as tf


class EvictionResult(NamedTuple):
    logits: torch.Tensor  # (B, V) next-token logits after the prompt
    cache: dict  # budgeted decode cache


class Sampling(NamedTuple):
    """Sampling settings of the decode loop.  ``temperature <= 0`` is
    greedy argmax (the filters are then ignored); ``top_k = 0`` and
    ``top_p = 1.0`` disable their filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


def filter_logits(logits: torch.Tensor, *, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Top-k / nucleus (top-p) filtering over the last axis: logits outside
    the kept set drop to -1e30, kept ones pass unchanged.  Top-k keeps the
    k largest and every tie at the k-th value; top-p keeps the descending
    prefix whose mass before each token is below ``top_p`` (always at
    least the argmax).  Both are the identity when disabled."""
    V = logits.shape[-1]
    if top_k and top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p  # the mass before each token < p
        thr = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thr, NEG_INF, logits)
    return logits


def fold_keys(seeds: torch.Tensor, positions: torch.Tensor) -> tuple:
    """Per-row keys ``fold_in(PRNGKey(seeds[b]), positions[b])``, as the two
    (B,) words of a raw key.  Keyed on the absolute position of the
    sampled token, so a preempted request that replays the same positions
    samples the same tokens."""
    return fold_in(PRNGKey(seeds), positions)


def sample_logits(logits: torch.Tensor, keys: tuple, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """(B,) ids from (B, V) logits: argmax at ``temperature <= 0``, else
    the float32 logits over ``temperature``, filtered, then one
    categorical draw per row with its key (``fold_keys``).  Everything
    stays on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    x = logits.to(torch.float32) / temperature
    x = filter_logits(x, top_k=top_k, top_p=top_p)
    return categorical(keys, x)


def _draft_then_rescore(params: dict, cfg: ModelConfig,
                        tokens: torch.Tensor, draft: torch.Tensor,
                        evict: EvictionConfig,
                        extra_slots: int) -> EvictionResult:
    """The second half of LAQ and SpecKV: a ``gt_oracle`` prefill over
    [tokens; draft] that evicts the prompt's KV with the draft rows as
    observation queries.  Its logits are row ``n_in - 1``'s, the target
    model's next-token distribution after the prompt."""
    n_in = tokens.shape[1]
    xy = torch.cat([tokens, draft.to(tokens.dtype)], dim=1)
    res = tf.prefill(params, cfg, xy, policy="gt_oracle", gt_boundary=n_in,
                     evict=evict, extra_slots=extra_slots,
                     want_logits="last")
    return EvictionResult(logits=res.logits, cache=res.cache)


def run_eviction(policy: str, params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor, *, evict: EvictionConfig,
                 lkv_params: Optional[dict] = None,
                 draft_params: Optional[dict] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 extra_slots: int = 0,
                 encoder_embeds: Optional[torch.Tensor] = None,
                 mrope_positions: Optional[torch.Tensor] = None,
                 prompt_lens: Optional[torch.Tensor] = None,
                 seeds: Optional[torch.Tensor] = None) -> EvictionResult:
    """Prefill + evict under ``policy``: the next-token logits and the
    budgeted decode cache.  A single-pass policy is one
    ``transformer.prefill`` (``prompt_lens``: bucket-padded rows);
    ``laq`` and ``speckv`` draft ``evict.draft_len`` tokens and rescore
    (module docstring; ``speckv`` drafts with ``draft_params`` /
    ``draft_cfg``, a model of the same vocabulary).  ``lkv_params`` is
    read by ``lookaheadkv`` only, ``seeds`` (B,) by ``random`` only.
    ``tokens`` may be embeddings (B, n_in, D) for an ``embeds_in`` arch;
    ``mrope_positions`` (3, B, n_in) go to the single-pass prefill and to
    the first prefill of ``laq`` / ``speckv`` (their draft and rescoring
    passes take the text stream), as in the JAX package.
    ``encoder_embeds`` (B, F, D) are an encoder-decoder arch's frames
    (whisper), for the single-pass policies; ``laq`` and ``speckv`` raise
    ``NotImplementedError`` for such an arch (the JAX package's rescoring
    prefill drops the frames and fails there)."""
    kw = dict(encoder_embeds=encoder_embeds, mrope_positions=mrope_positions)
    if policy in SINGLE_PASS:
        res = tf.prefill(
            params, cfg, tokens, policy=policy, evict=evict,
            lkv_params=lkv_params if policy == "lookaheadkv" else None,
            extra_slots=extra_slots, prompt_lens=prompt_lens, seeds=seeds,
            **kw)
        return EvictionResult(logits=res.logits, cache=res.cache)
    if policy not in MULTI_PASS:
        raise ValueError(f"unknown policy {policy}; known: {ALL_POLICIES}")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{policy} on {cfg.name}: the draft-based policies have no "
            "encoder-decoder path (the JAX package's rescoring prefill "
            "drops the frames and fails)")
    if prompt_lens is not None:
        raise ValueError(
            f"{policy} (multi-pass) cannot serve bucket-padded prompts; "
            "group its requests by exact length instead")
    if policy == "laq":
        # a cheap snapkv eviction, then a draft over the compressed cache
        # (the pseudo future)
        res1 = tf.prefill(params, cfg, tokens, policy="snapkv", evict=evict,
                          extra_slots=evict.draft_len + 1, **kw)
        first = torch.argmax(res1.logits, dim=-1)[:, None].to(torch.int32)
        draft, _ = greedy_decode(params, cfg, first, res1.cache,
                                 evict.draft_len)
    else:
        if draft_params is None or draft_cfg is None:
            raise ValueError("speckv needs a draft model")
        dres = tf.prefill(draft_params, draft_cfg, tokens, policy="full",
                          extra_slots=evict.draft_len + 1, **kw)
        first = torch.argmax(dres.logits, dim=-1)[:, None].to(torch.int32)
        draft, _ = greedy_decode(draft_params, draft_cfg, first, dres.cache,
                                 evict.draft_len)
    return _draft_then_rescore(params, cfg, tokens, draft, evict,
                               extra_slots)


def decode_one(params: dict, cfg: ModelConfig, token: torch.Tensor,
               cache: dict, *, active: Optional[torch.Tensor] = None,
               paged_depth: Optional[int] = None,
               sampling: Optional[Sampling] = None,
               seeds: Optional[torch.Tensor] = None,
               mesh=None) -> tuple[torch.Tensor, dict]:
    """One decode step.  Returns (next token (B, 1), new cache);
    inactive slots keep their token, and their cache, which
    ``decode_step`` never writes for them (the JAX package rolls a dense
    cache back with ``select_cache_slots`` instead).  The token is the
    argmax, or with ``sampling`` at a temperature above 0 a draw under
    the key of each row's seed (``seeds`` (B,)) folded with the sampled
    token's position, one past the input token's ``next_pos``.  Over a
    ``mesh`` (tensor-parallel serving) the step runs on the rank's shard
    and the sampler on the all-gathered logits, identically on every
    rank."""
    positions = cache["next_pos"][:, 0]
    logits, cache = tf.decode_step(params, cfg, token, cache, active=active,
                                   paged_depth=paged_depth, mesh=mesh)
    if sampling is not None and sampling.temperature > 0.0:
        if seeds is None:
            raise ValueError("sampling needs per-request seeds")
        keys = fold_keys(seeds, positions + 1)
        nxt = sample_logits(
            logits, keys, temperature=sampling.temperature,
            top_k=sampling.top_k, top_p=sampling.top_p)
    else:
        nxt = torch.argmax(logits, dim=-1)
    nxt = nxt[:, None].to(token.dtype)
    if active is not None:
        nxt = torch.where(active[:, None], nxt, token)
    return nxt, cache


def greedy_decode(params: dict, cfg: ModelConfig, first_token: torch.Tensor,
                  cache: dict, steps: int, *,
                  active: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, dict]:
    """Greedy continuation of ``steps`` decode steps.  Returns (tokens (B,
    steps) starting with ``first_token``, cache); the token the last step
    computes is not among them."""
    tok, toks = first_token, []
    for _ in range(steps):
        toks.append(tok[:, 0])
        tok, cache = decode_one(params, cfg, tok, cache, active=active)
    return torch.stack(toks, dim=1), cache


def decode_chunk(params: dict, cfg: ModelConfig, token: torch.Tensor,
                 cache: dict, steps: int, *,
                 active: Optional[torch.Tensor] = None,
                 paged_depth: Optional[int] = None,
                 sampling: Optional[Sampling] = None,
                 seeds: Optional[torch.Tensor] = None,
                 mesh=None) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """``steps`` decode steps after ``token`` (greedy, or sampled as
    ``decode_one`` says).  Returns (last token (B, 1), cache, new tokens
    (B, steps)); the input token is not among the emitted ones.  No step
    reads anything back to the host.  A decode-eviction ``score`` leaf (in
    the dense ``cache["attn"]`` or the paged ``cache["pool"]``) rides the
    cache through every step like its other leaves; the attention steps
    add to it in place."""
    toks = []
    for _ in range(steps):
        token, cache = decode_one(params, cfg, token, cache, active=active,
                                  paged_depth=paged_depth, sampling=sampling,
                                  seeds=seeds, mesh=mesh)
        toks.append(token[:, 0])
    return token, cache, torch.stack(toks, dim=1)


def sample_decode(params: dict, cfg: ModelConfig, first_logits: torch.Tensor,
                  cache: dict, steps: int, *, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0,
                  key: Optional[tuple] = None) -> tuple[torch.Tensor, dict]:
    """``steps`` tokens after the prefill's logits (B, V), greedy at
    ``temperature <= 0`` (the filters are then ignored), else sampled:
    ``split(key, steps)`` gives one key per token, shared by the batch's
    rows, the first token drawn with ``keys[0]``.  Returns (tokens (B,
    steps), cache)."""
    if temperature <= 0.0:
        first = torch.argmax(first_logits, dim=-1)[:, None].to(torch.int32)
        return greedy_decode(params, cfg, first, cache, steps)
    if key is None:
        raise ValueError("sampling needs a key")
    k1, k2 = split(key, steps)

    def pick(logits, i):
        x = filter_logits(logits / temperature, top_k=top_k, top_p=top_p)
        return categorical((k1[i], k2[i]), x)[:, None].to(torch.int32)

    tok = pick(first_logits, 0)
    toks = [tok[:, 0]]
    for i in range(1, steps):
        logits, cache = tf.decode_step(params, cfg, tok, cache)
        tok = pick(logits, i)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), cache


def chunk_capacity_for(cfg: ModelConfig, policy: str, n_prompt: int,
                       chunk: int, *, n_obs: int = 0) -> int:
    """KV-buffer depth for a chunked prefill of ``n_prompt`` tokens: the
    prompt plus the policy's appended observation rows (lookaheadkv's
    learned rows, or gt_oracle's ``n_obs`` response rows), rounded up to
    whole chunks."""
    if policy == "lookaheadkv":
        n_obs = cfg.lookahead.n_lookahead if cfg.lookahead else 0
    need = n_prompt + n_obs
    return -(-need // chunk) * chunk


def run_eviction_chunked(
    policy: str,
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, n_in) tokens, every row the same length
    *,
    chunk: int,
    evict: EvictionConfig,
    lkv_params: Optional[dict] = None,
    extra_slots: int = 0,
    gt_boundary: Optional[int] = None,  # gt_oracle: X|Y boundary in tokens
    seeds: Optional[torch.Tensor] = None,
) -> EvictionResult:
    """Streamed prefill + evict: the prompt in fixed ``chunk`` blocks
    with online scores, one eviction at prompt end; the same kept cache
    and next-token logits as ``run_eviction`` for every single-pass
    policy (the serving engine drives the same two steps itself, to
    interleave decode between chunks).  The draft-based policies cannot
    stream and raise."""
    if policy in MULTI_PASS:
        raise ValueError(f"{policy} cannot stream (multi-pass): run it "
                         "through run_eviction")
    n_tokens = tokens.shape[1]
    n = gt_boundary if gt_boundary is not None else n_tokens
    obs_tokens = tokens[:, n:] if gt_boundary is not None else None
    capacity = chunk_capacity_for(cfg, policy, n, chunk, n_obs=n_tokens - n)
    B = tokens.shape[0]
    state = tf.init_chunk_state(cfg, policy, B, capacity,
                                device=tokens.device)
    logits = None
    for s in range(0, n, chunk):
        blk = tokens[:, s:s + chunk]
        if blk.shape[1] < chunk:  # partial final chunk: pad rows are inert
            blk = torch.nn.functional.pad(blk, (0, chunk - blk.shape[1]))
        state, logits = tf.prefill_chunk(params, cfg, state, blk, n,
                                         policy=policy)
    cache = tf.prefill_finalize(
        params, cfg, state, n, policy=policy, evict=evict,
        lkv_params=lkv_params if policy == "lookaheadkv" else None,
        obs_tokens=obs_tokens, extra_slots=extra_slots, seeds=seeds)
    return EvictionResult(logits=logits, cache=cache)
