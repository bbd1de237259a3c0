"""Importance-score computation (paper §2, §3.1) for the port.

Every attention-based score comes from softmax masses of some
observation queries over the prompt's keys:

    lookaheadkv : the learned lookahead rows appended after the prompt
    gt_oracle   : the true response rows appended after the prompt
    snapkv      : the last ``window`` prompt rows (pyramidkv: the same,
                  with per-layer budgets)
    tova        : the last prompt row
    h2o         : every prompt row (cumulative column mass)

Position policies (streaming_llm, random, full) need no attention and are
scored in ``eviction.position_scores``.  Post-processing: GQA mean over
each kv group's q heads, then a 1-D max-pool (paper kernel 7) over the
scored region; the window policies then force-keep their window.

Streaming (chunked-prefill) scoring
-----------------------------------
``ScoreState`` makes each single-pass policy an online quantity over
prompt chunks, so a chunked prefill evicts exactly like the monolithic
one:

* cumulative (h2o): each chunk adds its rows' softmax column masses to a
  per-key accumulator ``acc``; the chunk attention emits them itself
  (``ops.chunk_attention(..., score_masses=True)``, kernel 2 on the
  card), and ``cnt`` counts the prompt rows seen;
* observation window (snapkv, pyramidkv, tova): only the last ``W``
  prompt queries count, so ``qbuf`` rolls the newest ``W`` rotary
  queries, and finalize scores them over the whole buffer
  (``ops.lookahead_score`` at ``q_offset = n_total - W``);
* final observation (lookaheadkv, gt_oracle): nothing accumulates; the
  observation rows run once at prompt end (``transformer``'s observation
  pass) through the same scoring primitive.

Decode-time eviction adds each decode step's masses (kernel 5) to a
cumulative per-row score (``decode_mass_update``).  The prefix cache's
``snapshot``/``restore`` of the state are not ported (ROADMAP A7).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF

# The policy classification, defined here once.  Attention-based
# policies by how the chunked prefill streams them (module docstring):
STREAMING_CUMULATIVE = ("h2o",)
STREAMING_WINDOW = ("snapkv", "pyramidkv", "tova")
FINAL_OBS = ("lookaheadkv", "gt_oracle")
OBS_POLICIES = FINAL_OBS + STREAMING_WINDOW + STREAMING_CUMULATIVE
# attention-free, scored by ``eviction.position_scores``
POSITION_POLICIES = ("full", "random", "streaming_llm")
# one prefill pass each (the JAX package's order), and the draft-based
# policies of several passes (``policies.run_eviction``)
SINGLE_PASS = POSITION_POLICIES + STREAMING_WINDOW + STREAMING_CUMULATIVE \
    + FINAL_OBS
MULTI_PASS = ("laq", "speckv")
ALL_POLICIES = SINGLE_PASS + MULTI_PASS


class ScoreState(NamedTuple):
    """Streaming score state of a chunked prefill; the fields a policy
    does not use are None.  The tensors carry a leading layer axis L and
    are updated in place by each chunk (the JAX package threads updated
    copies)."""

    acc: Optional[torch.Tensor] = None  # (L, B, H, K) f32 column-mass sums
    cnt: Optional[float] = None  # prompt rows scored so far
    qbuf: Optional[torch.Tensor] = None  # (L, B, W, H, hd) newest W queries


def stream_window(policy: str, window_size: int) -> int:
    """Observation-window width a streaming-window policy defers on."""
    return 1 if policy == "tova" else window_size


def init_score_state(policy: str, num_layers: int, batch: int,
                     num_heads: int, head_dim: int, capacity: int, *,
                     window_size: int = 32, dtype=torch.float32,
                     device="cuda") -> ScoreState:
    """Zero state for a ``capacity``-deep key buffer, shaped by the
    policy."""
    if policy in STREAMING_CUMULATIVE:
        return ScoreState(
            acc=torch.zeros((num_layers, batch, num_heads, capacity),
                            dtype=torch.float32, device=device),
            cnt=0.0)
    if policy in STREAMING_WINDOW:
        w = stream_window(policy, window_size)
        return ScoreState(qbuf=torch.zeros(
            (num_layers, batch, w, num_heads, head_dim), dtype=dtype,
            device=device))
    return ScoreState()  # final-observation and position policies


def update_layer_scores(
    policy: str,
    acc_l: Optional[torch.Tensor],  # (B, H, K) this layer's accumulator
    qbuf_l: Optional[torch.Tensor],  # (B, W, H, hd) this layer's window
    q_rot: torch.Tensor,  # (B, C, H, hd) the chunk's rotary queries
    *,
    masses_l: Optional[torch.Tensor] = None,  # (B, H, K) kernel 2's masses
    q_offset: int,  # chunk start
    n_total: int,  # true prompt length
) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One chunk's streaming update of one layer, in place; returns
    (acc_l, qbuf_l).  h2o adds the chunk's column masses (rows at or past
    ``n_total`` already count zero in them); the window policies roll
    the newest ``W`` valid queries in: global rows ``[total - W, total)``
    with ``total = min(n_total, chunk end)`` (slots an early chunk shorter
    than W leaves stale are displaced before any read)."""
    if policy in STREAMING_CUMULATIVE:
        if masses_l is None:
            raise ValueError(f"{policy} needs the chunk attention's masses")
        acc_l += masses_l
    elif policy in STREAMING_WINDOW:
        W, C = qbuf_l.shape[1], q_rot.shape[1]
        total = min(n_total, q_offset + C)
        start = min(max(total - q_offset, 0), C)
        joined = torch.cat([qbuf_l, q_rot], dim=1)
        qbuf_l.copy_(joined[:, start:start + W])
    return acc_l, qbuf_l


def observation_scores(
    q_obs: torch.Tensor,  # (B, n_obs, H, hd)
    k_full: torch.Tensor,  # (B, n_prompt + n_obs, KV, hd)
    n_prompt: int,
    *,
    window=None,
    kv_mask: Optional[torch.Tensor] = None,  # (B, n_prompt) valid keys
    q_offset: Optional[int] = None,  # position of obs row 0 (n_prompt)
) -> torch.Tensor:
    """Per-q-head scores (B, H, n_prompt), float32: softmax rows include
    the observation keys (Algorithm 2 slices after the softmax).  The
    observation rows follow the prompt unless ``q_offset`` says otherwise
    (monolithic h2o scores every prompt row, ``q_offset=0``)."""
    return ops.lookahead_score(q_obs, k_full, n_prompt, kv_mask=kv_mask,
                               window=window, q_offset=q_offset)


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


def normalize_l1(scores: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """L1 normalisation s / ||s||_1 over the key axis (paper eq. (4))."""
    return scores / torch.clamp(scores.abs().sum(dim=-1, keepdim=True),
                                min=eps)


def postprocess(scores_per_qhead: torch.Tensor, num_kv_heads: int,
                pool_kernel: int) -> torch.Tensor:
    """Eviction-time pipeline of the monolithic prefill: GQA reduce, then
    max-pool.  (B, H, S) -> (B, KV, S)."""
    return maxpool1d(gqa_reduce(scores_per_qhead, num_kv_heads), pool_kernel)


def finalize_layer_scores(
    policy: str,
    k_buf: torch.Tensor,  # (B, K, KV, hd) this layer's key buffer
    n_total: int,  # true prompt length
    *,
    acc_l: Optional[torch.Tensor] = None,
    cnt: Optional[float] = None,
    qbuf_l: Optional[torch.Tensor] = None,
    obs_masses_l: Optional[torch.Tensor] = None,  # (B, H, K) obs masses
    num_kv_heads: int,
    pool_kernel: int,
    window_size: int = 32,
    window=None,
) -> torch.Tensor:
    """Eviction-ready scores (B, KV, K) of one layer at prompt end, as
    the monolithic pipeline forms them: GQA reduce, max-pool over the
    scored region only (columns past the policy's boundary are -inf, as
    the monolithic pool's edge padding), the window policies' force-keep
    of their window (exactly 1e9), then every column at or past
    ``n_total`` set to ``NEG_INF`` so it ranks last."""
    K = k_buf.shape[1]
    col = torch.arange(K, device=k_buf.device)
    if policy in STREAMING_CUMULATIVE:
        s_qh = acc_l / max(cnt, 1.0)
        boundary = n_total
    elif policy in STREAMING_WINDOW:
        # the rolled window's queries over the whole buffer; the mean
        # over its W rows is the monolithic sum / W
        boundary = n_total - stream_window(policy, window_size)
        s_qh = ops.lookahead_score(qbuf_l, k_buf, K, q_offset=boundary,
                                   window=window)
    elif policy in FINAL_OBS:
        if obs_masses_l is None:
            raise ValueError(f"{policy} needs an observation pass")
        s_qh, boundary = obs_masses_l, n_total
    else:
        raise ValueError(f"{policy!r} is not an attention-scored policy")
    s_kv = gqa_reduce(s_qh, num_kv_heads)
    s_kv = torch.where(col < boundary, s_kv, float("-inf"))
    s_kv = maxpool1d(s_kv, pool_kernel)
    if policy in STREAMING_WINDOW:
        s_kv = torch.where((col >= boundary) & (col < n_total), 1e9, s_kv)
    return torch.where(col < n_total, s_kv, NEG_INF)
