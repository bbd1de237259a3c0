"""Step functions of the port (the JAX package's ``launch/steps.py``).

* ``make_train_step``   the paper's module training (GT pass + lookahead
                        pass + KL + Adam on the lookahead modules) for the
                        technique's archs; plain LM loss + Adam on every
                        parameter for an arch the technique does not apply
                        to.
* ``make_distill_step`` the same against harvested gt targets
                        (``data/harvest.py``): only the lookahead pass.
                        Both take a ``mesh``: the rank's shard, its data
                        row's batch rows, the gradient averaged over the
                        batch axes (``batch_mean``).
* ``make_prefill_step`` serving prefill with in-pass lookaheadkv eviction
                        (plain forward + state cache for the SSM arch).
* ``make_decode_step``  one token against a cache (dense, or the split
                        cache's frozen rows + hot ring).
* ``*_batch_shapes``    each step's inputs as meta tensors (shapes and
                        dtypes, nothing allocated), for the dry-run
                        (``launch/dryrun.py``).

Each step returns ``(trained tree, AdamState, loss, {"lr",
"grad_norm"})``, the lookahead steps with "grads" too (the gradient Adam
was given, before its clip); the JAX steps return the first three and
drop the optimizer's metrics.  Gradients come from
``torch.autograd.grad`` over the trained tree's leaves (taken as fresh
leaves that require a gradient), and Adam returns new trees instead of
updating in place.
The JAX module's abstract inputs are ``ShapeDtypeStruct``s; the port's
are tensors on the ``meta`` device, which the model functions take as
they are (``kernels/ops.py`` sends them to the plain versions).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.common.config import (EvictionConfig, ModelConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.common.sharding import mesh_signature
from repro_torch.core import objective
from repro_torch.core.scoring import normalize_l1
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.optim import adam

# Response length for training shapes (paper: max generation length 512).
TRAIN_N_OUT = 512
# Serving eviction budget for prefill shapes (paper evaluates 64..2048).
PREFILL_BUDGET = 2048
DECODE_MARGIN = 128

META = torch.device("meta")


def train_batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The training step's batch: {"n_in", "n_out", "x", "xy"} (token
    archs) or {"x" (B, n_in, D) bf16, "y", "mrope"} (embedding inputs),
    plus "frames" for encoder-decoder archs; meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    n_out = min(TRAIN_N_OUT, S // 8)
    n_in = S - n_out
    d = {"n_in": n_in, "n_out": n_out}
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.embeds_in:
        d["x"] = torch.empty((B, n_in, cfg.d_model), dtype=bf16, device=META)
        d["y"] = torch.empty((B, n_out), dtype=i32, device=META)
        d["mrope"] = torch.empty((3, B, n_in), dtype=i32, device=META)
    else:
        d["x"] = torch.empty((B, n_in), dtype=i32, device=META)
        d["xy"] = torch.empty((B, S), dtype=i32, device=META)
    if cfg.is_encoder_decoder:
        d["frames"] = torch.empty((B, cfg.encoder.num_frames, cfg.d_model),
                                  dtype=bf16, device=META)
    return d


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


def batch_mean(loss: torch.Tensor, grads: dict, mesh) -> tuple:
    """(loss, gradient tree) averaged over the mesh's batch axes: each
    data row computed them over its own batch rows, so the global batch's
    mean is the rows' mean (equal row counts), taken in one all-reduce
    (SUM) of every leaf and the loss over the batch group, then scaled.
    The model ranks of a row already hold the same whole gradient
    (``models/attention.py``'s collectives), so nothing is summed over
    "model".  As they are without a batch axis above 1."""
    n = 1 if mesh_signature(mesh) is None else mesh.batch_size
    if n == 1:
        return loss, grads
    flat = adam.leaves(grads)
    buf = torch.cat([loss.reshape(1).to(torch.float32)]
                    + [g.reshape(-1).to(torch.float32) for g in flat])
    buf = attn_mod.all_reduce(buf, dist.ReduceOp.SUM,
                              mesh.batch_group) / n
    out, at = [], 1
    for g in flat:
        out.append(buf[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return buf[0].to(loss.dtype), _with_leaves(grads, iter(out))


def make_lkv_grad(cfg: ModelConfig, mesh=None, *, distill: bool = False):
    """(params, lkv, batch) -> (loss, gradient tree): the lookahead
    modules' loss and gradient that ``make_train_step`` (``distill``:
    ``make_distill_step``) hands to Adam, over ``mesh`` the global
    batch's (``batch_mean``).

    The batch, by arch (JAX's ``lkv_step`` branches): {"x", "xy"} token
    ids; an encoder-decoder arch also "frames" (B, F, D), its encoder's
    input in both passes; an ``embeds_in`` arch {"x" (B, n_in, D) patch
    embeddings, "y" (B, n_out) response tokens, optionally "mrope" (3, B,
    n_in)}, whose GT pass runs over ``cat(x, embed(y))``.  Distillation
    takes {"x", "s_gt"}."""
    def grad(params, lkv, batch):
        kw = {"mesh": mesh}
        if cfg.is_encoder_decoder and not distill:
            kw["encoder_embeds"] = batch["frames"]

        def loss_fn(lkv):
            if distill:
                loss, _ = objective.lkv_loss_from_targets(
                    params, cfg, lkv, batch["x"], batch["s_gt"], **kw)
            elif cfg.embeds_in:
                x = batch["x"]
                smesh = attn_mod.model_shard_mesh(mesh, cfg.attn)
                y_emb = tf.embed(params, cfg, batch["y"], smesh)
                xy = torch.cat([x.to(y_emb.dtype), y_emb], dim=1)
                # the GT pass runs without the M-RoPE streams (the text
                # stream over [X; Y]), the lookahead pass with them: JAX's
                # make_train_step does so, and the port keeps it
                s_gt = objective.gt_scores(params, cfg, xy, x.shape[1],
                                           mrope_positions=None, **kw)
                s_lkv = objective.lookahead_scores(
                    params, cfg, lkv, x, mrope_positions=batch.get("mrope"),
                    **kw)
                loss = objective.kl_divergence(
                    normalize_l1(s_gt), normalize_l1(s_lkv)).mean()
            else:
                loss, _ = objective.lkv_loss(
                    params, cfg, lkv, batch["x"], batch["xy"],
                    batch["x"].shape[1], **kw)
            return loss

        loss, grads = value_and_grad(loss_fn, lkv)
        return batch_mean(loss, grads, mesh)

    return grad


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """(params, lkv, opt_state, batch) -> (lkv', opt_state', loss,
    metrics), the batch as ``make_lkv_grad`` takes it; for an arch the
    technique does not apply to, the LM variant (params, opt_state, batch
    {"xy"}) -> (params', ...).

    Over ``mesh`` (one rank: ``params`` its shard in ``serving_specs``'
    layout, ``lkv`` and ``opt_state`` replicated, ``batch`` its data
    row's rows) each data row takes ``kl.mean()`` over its own rows and
    the gradient is averaged over the batch axes before ``adam.update``,
    so the clip sees the global gradient's norm and every rank returns
    the same modules, state and loss.  The LM variant has no launcher
    route in either package and takes no mesh (``ValueError``)."""
    if not cfg.technique_applies:
        if mesh_signature(mesh) is not None:
            raise ValueError(
                f"{cfg.name}: the LM variant (an arch the technique does "
                "not apply to) has no launcher route and takes no mesh")

        def lm_step(params, opt_state, batch):
            loss, grads = value_and_grad(
                lambda p: objective.lm_loss(p, cfg, batch["xy"]), params)
            params, opt_state, metrics = adam.update(params, grads,
                                                     opt_state, tc)
            return params, opt_state, loss, metrics

        return lm_step

    return _adam_step(make_lkv_grad(cfg, mesh), tc)


def _adam_step(grad: Callable, tc: TrainConfig):
    """(params, lkv, opt_state, batch) -> (lkv', opt_state', loss,
    {"lr", "grad_norm", "grads"}): ``grad``'s gradient through Adam."""
    def step(params, lkv, opt_state, batch):
        loss, grads = grad(params, lkv, batch)
        lkv, opt_state, metrics = adam.update(lkv, grads, opt_state, tc)
        return lkv, opt_state, loss, dict(metrics, grads=grads)

    return step


def make_distill_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """(params, lkv, opt_state, batch {"x": (B, n), "s_gt": (L, B, H, n)})
    -> (lkv', opt_state', loss, metrics) against harvested gt targets:
    each step runs only the lookahead pass.  Over ``mesh`` as
    ``make_train_step``: ``batch`` holds the data row's rows of "x" and
    of "s_gt"'s batch dim."""
    if not cfg.technique_applies:
        raise ValueError("distillation trains lookahead modules; "
                         f"{cfg.name} has none")
    if cfg.is_encoder_decoder:
        # JAX's distill step asserts "whisper needs frame embeddings" when
        # it runs: harvested batches carry no frames
        raise ValueError(f"{cfg.name} needs frame embeddings, which a "
                         "distillation batch ({x, s_gt}) does not carry")
    return _adam_step(make_lkv_grad(cfg, mesh, distill=True), tc)


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                      budget: int = PREFILL_BUDGET):
    """(params, lkv, batch) -> (logits, cache): the prompt under
    lookaheadkv at ``min(budget, seq_len // 4)`` with ``DECODE_MARGIN``
    rows for decode appends; for an arch the technique does not apply to,
    (params, batch) -> (logits, the SSM state cache)."""
    evict = EvictionConfig(policy="lookaheadkv",
                           budget=min(budget, shape.seq_len // 4))

    if not cfg.technique_applies:

        def ssm_prefill(params, batch):
            res = tf.prefill(params, cfg, batch["tokens"],
                             want_ssm_cache=True)
            return res.logits, res.cache

        return ssm_prefill

    def prefill_step(params, lkv, batch):
        res = tf.prefill(
            params, cfg, batch["tokens"], lkv_params=lkv,
            policy="lookaheadkv", evict=evict, extra_slots=DECODE_MARGIN,
            encoder_embeds=batch.get("frames"),
            mrope_positions=batch.get("mrope"))
        return res.logits, res.cache

    return prefill_step


def prefill_batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{"tokens" (B, S) int32 or (B, S, D) bf16 embeddings, ["mrope"],
    ["frames"]} as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    d: dict = {}
    if cfg.embeds_in:
        d["tokens"] = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                                  device=META)
        d["mrope"] = torch.empty((3, B, S), dtype=torch.int32, device=META)
    else:
        d["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
    if cfg.is_encoder_decoder:
        d["frames"] = torch.empty((B, cfg.encoder.num_frames, cfg.d_model),
                                  dtype=torch.bfloat16, device=META)
    return d


def make_decode_step(cfg: ModelConfig, mesh=None):
    """(params, token, cache) -> (logits, cache): ``transformer.
    decode_step`` over ``mesh`` (the rank's shards), a split cache's
    frozen partials merged over the ranks holding its rows."""
    def decode(params, token, cache):
        return tf.decode_step(params, cfg, token, cache, mesh=mesh)

    return decode


def decode_batch_shapes(cfg: ModelConfig, shape: ShapeConfig,
                        hot_slots: int = 0, *, mesh=None):
    """(token (B, 1) int32, cache) as meta tensors, for a cache holding
    ``seq_len`` tokens: its ``seq_len - 1`` first rows valid, or with
    ``hot_slots`` the split layout, all ``seq_len`` frozen rows valid and
    an empty hot ring.  Over ``mesh``, the rank's block
    (``init_decode_cache(mesh=)``)."""
    B, S = shape.global_batch, shape.seq_len
    token = torch.empty((B, 1), dtype=torch.int32, device=META)
    capacity = S if cfg.uses_attention else 0
    fill = capacity if hot_slots else max(S - 1, 0)
    cache = tf.init_decode_cache(cfg, B, capacity, fill_len=fill,
                                 hot_slots=hot_slots, device=META, mesh=mesh)
    return token, cache
