"""LookaheadKV training objective (paper §3.2, Algorithm 1).

One training iteration:
  1. GT pass        frozen model over [X; Y]; per-(layer, head) importance
                    scores of X's keys from Y's queries (no gradient).
  2. Lookahead pass frozen model + lookahead tokens + selective LoRA over
                    [X; P]; the same scores from P's queries.
  3. Loss           mean over L·H of KL(ŝ_GT ‖ ŝ_LKV) with L1-normalised
                    score vectors (ListNet ranking loss with identity φ).

Only ``lkv_params`` receive gradients; the model tree is a constant.

Over a mesh (``mesh=``, the trainer's ranks: ``launch/steps.py``) each
function runs on the rank's shard of the model and its data row's batch
rows (``transformer.prefill(mesh=)``); the scores come back whole over
heads, and the loss is the data row's.

Dispatch: the GT pass runs under ``torch.no_grad()`` through the normal
device dispatch, so on the card it runs kernels 7 and 3 (the JAX package
traces it under ``reference_mode()`` only because ``jax.value_and_grad``
cannot cross a ``pallas_call``; no gradient is taken through it).  The
lookahead pass and ``lm_loss`` run under ``ops.reference_mode()``: the
kernels are forward-only, and these are the passes gradients flow
through.  ``predictor_scores`` is the lookahead pass without a gradient,
on the kernels (the drift monitor's, ``obs/quality.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.core.scoring import normalize_l1
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf


def kl_divergence(p: torch.Tensor, q: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """KL(p ‖ q) along the last axis; p, q L1-normalised score vectors.

    xlogy-style safe form: zero-mass ``p`` entries contribute exactly 0
    and both logs see the same clamp, so ``KL(p ‖ p) == 0`` exactly."""
    p = torch.clamp(p, min=0.0)
    log_ratio = (torch.log(torch.clamp(p, min=eps))
                 - torch.log(torch.clamp(q, min=eps)))
    return torch.where(p > 0, p * log_ratio, 0.0).sum(dim=-1)


def gt_scores(
    params: dict,
    cfg: ModelConfig,
    xy_tokens: torch.Tensor,  # (B, n_in + n_out)
    n_in: int,
    *,
    encoder_embeds: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Ground-truth per-head scores (L, B, H, n_in), float32, without a
    gradient: kernels 7 and 3 on the card."""
    with torch.no_grad():
        res = tf.prefill(
            params, cfg, xy_tokens, capture_scores=True, gt_boundary=n_in,
            want_logits="none", encoder_embeds=encoder_embeds,
            mrope_positions=mrope_positions, mesh=mesh)
    return res.scores


def lookahead_scores(
    params: dict,
    cfg: ModelConfig,
    lkv_params: dict,
    x_tokens: torch.Tensor,  # (B, n_in)
    *,
    encoder_embeds: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Lookahead-estimated per-head scores (L, B, H, n_in), differentiable
    with respect to ``lkv_params``: the plain versions on every device
    (``ops.reference_mode()``)."""
    with ops.reference_mode():
        res = tf.prefill(
            params, cfg, x_tokens, lkv_params=lkv_params,
            capture_scores=True, want_logits="none",
            encoder_embeds=encoder_embeds, mrope_positions=mrope_positions,
            mesh=mesh)
    return res.scores


def predictor_scores(
    params: dict,
    cfg: ModelConfig,
    lkv_params: dict,
    x_tokens: torch.Tensor,  # (B, n_in)
) -> torch.Tensor:
    """``lookahead_scores`` without a gradient: the same prefill through
    the device dispatch, kernels 7 and 3 on the card (the serving
    predictor's scores, which the drift monitor reads)."""
    with torch.no_grad():
        res = tf.prefill(params, cfg, x_tokens, lkv_params=lkv_params,
                         capture_scores=True, want_logits="none")
    return res.scores


class LossReport(NamedTuple):
    loss: torch.Tensor
    kl_per_layer: torch.Tensor  # (L,)


def _kl_loss(s_gt: torch.Tensor, s_lkv: torch.Tensor
             ) -> tuple[torch.Tensor, LossReport]:
    kl = kl_divergence(normalize_l1(s_gt.detach()),
                       normalize_l1(s_lkv))  # (L, B, H)
    loss = kl.mean()
    return loss, LossReport(loss=loss, kl_per_layer=kl.mean(dim=(1, 2)))


def lkv_loss(
    params: dict,
    cfg: ModelConfig,
    lkv_params: dict,
    x_tokens: torch.Tensor,
    xy_tokens: torch.Tensor,
    n_in: int,
    **kw,
) -> tuple[torch.Tensor, LossReport]:
    s_gt = gt_scores(params, cfg, xy_tokens, n_in, **kw)  # (L, B, H, n)
    s_lkv = lookahead_scores(params, cfg, lkv_params, x_tokens, **kw)
    return _kl_loss(s_gt, s_lkv)


def lkv_loss_from_targets(
    params: dict,
    cfg: ModelConfig,
    lkv_params: dict,
    x_tokens: torch.Tensor,  # (B, n_in)
    s_gt: torch.Tensor,  # (L, B, H, n_in) harvested gt_oracle scores
    **kw,
) -> tuple[torch.Tensor, LossReport]:
    """Distillation against precomputed gt targets (harvested from serving
    traces, ``data/harvest.py``): ``lkv_loss`` with the GT pass replaced by
    stored score vectors, so each step runs only the lookahead pass."""
    s_lkv = lookahead_scores(params, cfg, lkv_params, x_tokens, **kw)
    return _kl_loss(s_gt, s_lkv)


def lm_loss(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S)
    *,
    encoder_embeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain next-token cross-entropy (the SSM arch's training loss)."""
    with ops.reference_mode():
        res = tf.prefill(params, cfg, tokens[:, :-1], want_logits="all",
                         encoder_embeds=encoder_embeds)
    logp = torch.log_softmax(res.logits, dim=-1)  # (B, S-1, V) f32
    targets = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean() + res.aux
