"""Training step functions of the port (the JAX package's
``launch/steps.py``, training half).

* ``make_train_step``   the paper's module training (GT pass + lookahead
                        pass + KL + Adam on the lookahead modules) for the
                        technique's archs; plain LM loss + Adam on every
                        parameter for an arch the technique does not apply
                        to.
* ``make_distill_step`` the same against harvested gt targets
                        (``data/harvest.py``): only the lookahead pass.

Each step returns ``(trained tree, AdamState, loss, {"lr",
"grad_norm"})``; the JAX steps return the first three and drop the
optimizer's metrics.  Gradients come from ``torch.autograd.grad`` over
the trained tree's leaves (taken as fresh leaves that require a
gradient), and Adam returns new trees instead of updating in place.
The dry-run half of the JAX module (``make_prefill_step``,
``make_decode_step`` and the ``*_batch_shapes`` abstract inputs) lowers
programs for a mesh and comes with ``launch/dryrun.py`` (ROADMAP A11).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.core import objective
from repro_torch.optim import adam


def _with_leaves(like, it):
    """``like``'s nested dict with its leaves taken in order from ``it``
    (``adam.leaves`` order)."""
    if isinstance(like, dict):
        return {k: _with_leaves(like[k], it) for k in sorted(like)}
    return next(it)


def value_and_grad(loss_fn: Callable, tree: dict):
    """(loss, gradient tree) of ``loss_fn(tree)`` with respect to every leaf
    of ``tree`` (a leaf the loss does not reach gets zeros)."""
    req = _with_leaves(tree, (x.detach().requires_grad_(True)
                              for x in adam.leaves(tree)))
    loss = loss_fn(req)
    flat = adam.leaves(req)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = (torch.zeros_like(x) if g is None else g
             for x, g in zip(flat, grads))
    return loss.detach(), _with_leaves(tree, grads)


def _refuse_a10(cfg: ModelConfig) -> None:
    if cfg.embeds_in or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"not ported yet: training {cfg.name} (VLM patch embeddings or "
            "encoder frames): ROADMAP A10")


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """(params, lkv, opt_state, batch {"x", "xy"}) -> (lkv', opt_state',
    loss, metrics); for an arch the technique does not apply to, the LM
    variant (params, opt_state, batch {"xy"}) -> (params', ...)."""
    _refuse_a10(cfg)
    if not cfg.technique_applies:

        def lm_step(params, opt_state, batch):
            loss, grads = value_and_grad(
                lambda p: objective.lm_loss(p, cfg, batch["xy"]), params)
            params, opt_state, metrics = adam.update(params, grads,
                                                     opt_state, tc)
            return params, opt_state, loss, metrics

        return lm_step

    def lkv_step(params, lkv, opt_state, batch):
        def loss_fn(lkv):
            loss, _ = objective.lkv_loss(params, cfg, lkv, batch["x"],
                                         batch["xy"], batch["x"].shape[1])
            return loss

        loss, grads = value_and_grad(loss_fn, lkv)
        lkv, opt_state, metrics = adam.update(lkv, grads, opt_state, tc)
        return lkv, opt_state, loss, metrics

    return lkv_step


def make_distill_step(cfg: ModelConfig, tc: TrainConfig):
    """(params, lkv, opt_state, batch {"x": (B, n), "s_gt": (L, B, H, n)})
    -> (lkv', opt_state', loss, metrics) against harvested gt targets:
    each step runs only the lookahead pass."""
    if not cfg.technique_applies:
        raise ValueError("distillation trains lookahead modules; "
                         f"{cfg.name} has none")
    _refuse_a10(cfg)

    def distill_step(params, lkv, opt_state, batch):
        def loss_fn(lkv):
            loss, _ = objective.lkv_loss_from_targets(
                params, cfg, lkv, batch["x"], batch["s_gt"])
            return loss

        loss, grads = value_and_grad(loss_fn, lkv)
        lkv, opt_state, metrics = adam.update(lkv, grads, opt_state, tc)
        return lkv, opt_state, loss, metrics

    return distill_step
