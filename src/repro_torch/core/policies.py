"""Policy orchestration of the port: greedy decode chunks and the chunked
prefill's buffer sizing.

Slice 1 ports the paper's ``lookaheadkv`` policy with greedy decode; the
other single-pass policies are ROADMAP A3, the draft-based baselines
(LAQ, SpecKV) and sampling come later (ROADMAP A3, A8).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import transformer as tf


def decode_one(params: dict, cfg: ModelConfig, token: torch.Tensor,
               cache: dict, *, active: Optional[torch.Tensor] = None,
               paged_depth: int) -> tuple[torch.Tensor, dict]:
    """One greedy decode step.  Returns (next token (B, 1), new cache);
    inactive slots keep their token."""
    logits, cache = tf.decode_step(params, cfg, token, cache, active=active,
                                   paged_depth=paged_depth)
    nxt = torch.argmax(logits, dim=-1)[:, None].to(token.dtype)
    if active is not None:
        nxt = torch.where(active[:, None], nxt, token)
    return nxt, cache


def decode_chunk(params: dict, cfg: ModelConfig, token: torch.Tensor,
                 cache: dict, steps: int, *,
                 active: Optional[torch.Tensor] = None,
                 paged_depth: int) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """``steps`` greedy decode steps after ``token``.  Returns (last token
    (B, 1), cache, new tokens (B, steps)); the input token is not among
    the emitted ones."""
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
