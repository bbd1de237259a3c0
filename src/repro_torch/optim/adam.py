"""Adam with a cosine schedule and global-norm clipping, in the JAX
package's arithmetic.  State and updates are trees shaped like the
trainable parameters (nested dicts of tensors); the moments are float32
whatever the parameters' type, the update is computed in float32 and cast
back to each parameter's type.

The paper's recipe (Table 16): Adam β = (0.9, 0.95), cosine to 0, 2%
warmup, gradient clipping at 1.0.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.common.config import TrainConfig


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Any  # first moment (float32 tree)
    nu: Any  # second moment (float32 tree)


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    """The leaves of a nested dict in sorted key order (the JAX package's
    leaf order, ``checkpoint.io``'s too)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64, which has
    room for no double rounding): PyTorch's vectorised float32 ``sqrt`` on
    the CPU is off by one ulp for some inputs, XLA's is exact."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def init(params: Any) -> AdamState:
    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    dev = leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=_map(zeros, params), nu=_map(zeros, params))


def cosine_lr(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup over ``warmup_frac`` of the steps, then a cosine to 0;
    float32, like the JAX package's weakly typed schedule."""
    warmup = max(int(tc.warmup_frac * tc.steps), 1)
    s = step.to(torch.float32)
    warm = tc.lr * (s + 1) / warmup
    prog = torch.clamp((s - warmup) / max(tc.steps - warmup, 1), 0.0, 1.0)
    # cos through float64: correctly rounded on every device (XLA's
    # float32 cos is within one ulp of it)
    cos = 0.5 * tc.lr * (1.0 + torch.cos((math.pi * prog).to(torch.float64))
                         .to(torch.float32))
    return torch.where(step < warmup, warm, cos)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(grads)]
    gnorm = _sqrt(sum(sq))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return _map(lambda g: g * scale, grads), gnorm


def update(params: Any, grads: Any, state: AdamState, tc: TrainConfig
           ) -> tuple[Any, AdamState, dict]:
    """One Adam step.  Returns (new params, new state, {"lr",
    "grad_norm"}); nothing is updated in place."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    step = state.step
    lr = cosine_lr(step, tc)
    b1, b2, eps = tc.beta1, tc.beta2, 1e-8
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        new_p = p.to(torch.float32) - lr * mhat / (_sqrt(vhat) + eps)
        return new_p.to(p.dtype), m, v

    out = _map(upd, params, grads, state.mu, state.nu)  # (p, m, v) leaves
    p, m, v = (_map(lambda o, i=i: o[i], out) for i in range(3))
    return p, AdamState(step + 1, m, v), {"lr": lr, "grad_norm": gnorm}
