"""Importance-score post-processing (paper §2, §3.1) for the port.

The final-observation policy ``lookaheadkv`` scores the prompt's keys once,
at prompt end: the learned lookahead rows run through the stack after the
prompt and ``ops.lookahead_score`` gives each q head's mean softmax mass
per key (``observation_scores`` in the monolithic prefill, the chunked
observation pass in the streaming one).  Here those masses become
eviction-ready scores: GQA mean over each kv group's q heads, then a 1-D
max-pool (paper kernel 7) over the scored region.

Decode-time eviction adds each decode step's masses (kernel 5) to a
cumulative per-row score (``decode_mass_update``).

The streaming policies of the JAX package (cumulative h2o, observation-
window snapkv/pyramidkv/tova) come later (ROADMAP A3, A6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF

FINAL_OBS = ("lookaheadkv", "gt_oracle")


class ScoreState(NamedTuple):
    """Streaming score accumulator of a chunked prefill.  Final-observation
    policies accumulate nothing across chunks (their observation pass runs
    once at prompt end), so their state has no fields set; the cumulative
    and window fields arrive with those policies."""

    acc: Optional[torch.Tensor] = None
    cnt: Optional[torch.Tensor] = None
    qbuf: Optional[torch.Tensor] = None


def init_score_state(policy: str) -> ScoreState:
    if policy in FINAL_OBS:
        return ScoreState()
    raise NotImplementedError(
        f"streaming scores for policy {policy!r} are not ported yet: "
        "ROADMAP A3 (window policies) / A6 (h2o)")


def observation_scores(
    q_obs: torch.Tensor,  # (B, n_obs, H, hd)
    k_full: torch.Tensor,  # (B, n_prompt + n_obs, KV, hd)
    n_prompt: int,
    *,
    window=None,
) -> torch.Tensor:
    """Per-q-head scores (B, H, n_prompt), float32: softmax rows include
    the observation keys (Algorithm 2 slices after the softmax).  The
    observation rows follow the prompt (no ``q_offset``), and every key is
    valid (the padded prompts' key mask arrives with bucket-padded prefill,
    ROADMAP A3)."""
    return ops.lookahead_score(q_obs, k_full, n_prompt, window=window)


def gqa_reduce(scores: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """(B, H, S) -> (B, KV, S): mean over each kv group's query heads."""
    B, H, S = scores.shape
    return scores.reshape(B, num_kv_heads, H // num_kv_heads, S).mean(dim=2)


def decode_mass_update(
    masses: torch.Tensor,  # (B, H, D) decode token's normalised masses
    num_kv_heads: int,
    active: Optional[torch.Tensor] = None,  # (B,) slots that wrote a row
) -> torch.Tensor:
    """One decode step's increment to the cumulative (H2O) decode-eviction
    scores: (B, D, KV) float32.  The GQA mean of the per-q-head masses of
    ``ops.paged_decode_attention(score_masses=True)``, in the cache's
    (row, kv head) layout, as the dense evicting step accumulates them;
    slots that are not ``active`` get zeros, so their scores stay as they
    are."""
    add = gqa_reduce(masses, num_kv_heads).transpose(1, 2)  # (B, D, KV)
    if active is not None:
        add = torch.where(active[:, None, None], add, 0.0)
    return add


def maxpool1d(scores: torch.Tensor, kernel: int) -> torch.Tensor:
    """Max-pool along the last axis with 'same' padding (-inf edges)."""
    if kernel <= 1:
        return scores
    pad = kernel // 2
    x = torch.nn.functional.pad(scores, (pad, pad), value=float("-inf"))
    n = scores.shape[-1]
    return torch.stack([x[..., i:i + n] for i in range(kernel)]).amax(dim=0)


def postprocess(scores_per_qhead: torch.Tensor, num_kv_heads: int,
                pool_kernel: int) -> torch.Tensor:
    """Eviction-time pipeline of the monolithic prefill: GQA reduce, then
    max-pool.  (B, H, S) -> (B, KV, S)."""
    return maxpool1d(gqa_reduce(scores_per_qhead, num_kv_heads), pool_kernel)


def finalize_layer_scores(
    policy: str,
    n_keys: int,  # buffer depth K
    n_total: int,  # true prompt length
    *,
    obs_masses_l: torch.Tensor,  # (B, H, K) mean observation masses
    num_kv_heads: int,
    pool_kernel: int,
) -> torch.Tensor:
    """Eviction-ready scores (B, KV, K) of one layer at prompt end: GQA
    reduce, max-pool over the scored region only (columns past the prompt
    are -inf, as the monolithic pool's edge padding), then every column
    at or past ``n_total`` set to ``NEG_INF`` so it ranks last."""
    if policy not in FINAL_OBS:
        init_score_state(policy)  # raises, naming the ROADMAP item
    col = torch.arange(n_keys, device=obs_masses_l.device)
    s_kv = gqa_reduce(obs_masses_l, num_kv_heads)
    s_kv = torch.where(col < n_total, s_kv, float("-inf"))
    s_kv = maxpool1d(s_kv, pool_kernel)
    return torch.where(col < n_total, s_kv, NEG_INF)
