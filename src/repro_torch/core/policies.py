"""Policy orchestration of the port: prefill + eviction (``run_eviction``),
greedy decode (``greedy_decode`` for the lockstep engine, ``decode_chunk``
for the continuous one) and the chunked prefill's buffer sizing.

The port serves the paper's ``lookaheadkv`` policy with greedy decode;
the other single-pass policies are ROADMAP A3, the draft-based baselines
(LAQ, SpecKV) come with them, and sampling is A8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.common.config import EvictionConfig, ModelConfig
from repro_torch.models import transformer as tf


class EvictionResult(NamedTuple):
    logits: torch.Tensor  # (B, V) next-token logits after the prompt
    cache: dict  # budgeted decode cache


def run_eviction(policy: str, params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor, *, evict: EvictionConfig,
                 lkv_params: Optional[dict] = None,
                 extra_slots: int = 0) -> EvictionResult:
    """Prefill + evict under ``policy``: the next-token logits and the
    budgeted decode cache (``transformer.prefill``)."""
    if policy != "lookaheadkv":
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet: ROADMAP A3")
    res = tf.prefill(params, cfg, tokens, policy=policy, evict=evict,
                     lkv_params=lkv_params, extra_slots=extra_slots)
    return EvictionResult(logits=res.logits, cache=res.cache)


def decode_one(params: dict, cfg: ModelConfig, token: torch.Tensor,
               cache: dict, *, active: Optional[torch.Tensor] = None,
               paged_depth: Optional[int] = None
               ) -> tuple[torch.Tensor, dict]:
    """One greedy decode step.  Returns (next token (B, 1), new cache);
    inactive slots keep their token, and their cache, which
    ``decode_step`` never writes for them (the JAX package rolls a dense
    cache back with ``select_cache_slots`` instead)."""
    logits, cache = tf.decode_step(params, cfg, token, cache, active=active,
                                   paged_depth=paged_depth)
    nxt = torch.argmax(logits, dim=-1)[:, None].to(token.dtype)
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
                 paged_depth: Optional[int] = None
                 ) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """``steps`` greedy decode steps after ``token``.  Returns (last token
    (B, 1), cache, new tokens (B, steps)); the input token is not among
    the emitted ones.  A decode-eviction ``score`` leaf (in the dense
    ``cache["attn"]`` or the paged ``cache["pool"]``) rides the cache
    through every step like its other leaves; the attention steps add to
    it in place."""
    toks = []
    for _ in range(steps):
        token, cache = decode_one(params, cfg, token, cache, active=active,
                                  paged_depth=paged_depth)
        toks.append(token[:, 0])
    return token, cache, torch.stack(toks, dim=1)


def chunk_capacity_for(cfg: ModelConfig, policy: str, n_prompt: int,
                       chunk: int, *, n_obs: int = 0) -> int:
    """KV-buffer depth for a chunked prefill of ``n_prompt`` tokens: the
    prompt plus the policy's appended observation rows, rounded up to whole
    chunks."""
    if policy == "lookaheadkv":
        n_obs = cfg.lookahead.n_lookahead if cfg.lookahead else 0
    need = n_prompt + n_obs
    return -(-need // chunk) * chunk
