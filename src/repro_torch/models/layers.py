"""Primitive layers: RMSNorm, LoRA-aware linear, init helpers.

Parameters are plain nested dicts of tensors in the JAX package's tree
layout (per-layer leaves stacked along a leading L axis by
``transformer.init_params``), so ``bridge.py`` can carry the JAX trees
across leaf for leaf.  Initialisers draw from an explicit
``torch.Generator`` (they give other numbers than ``jax.random`` from the
same seed; parity tests bridge the JAX parameters instead).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where an initialiser draws: the generator's device, or the meta
    device for ``gen`` None (shapes and dtypes, nothing drawn)."""
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype, *, lead=()) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape (*lead, d_in, d_out), drawn one
    (d_in, d_out) matrix at a time so the float32 draw never holds more
    than one layer's matrix."""
    dev = gen_device(gen)
    out = torch.empty((*lead, d_in, d_out), dtype=dtype, device=dev)
    if gen is None:
        return out
    flat = out.view(-1, d_in, d_out)
    for i in range(flat.shape[0]):
        w = torch.randn((d_in, d_out), generator=gen, device=dev,
                        dtype=torch.float32)
        flat[i] = w.mul_(1.0 / math.sqrt(d_in))
    return out


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    if gen is None:
        return torch.empty((vocab, d), dtype=dtype, device="meta")
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def lora_init(gen: torch.Generator, d_in: int, d_out: int, rank: int, *,
              lead=(), device=None) -> dict:
    """Standard LoRA init: a ~ N(0, 1/r), b = 0.  Stored in float32, on
    ``device`` (default: the generator's; ``"meta"`` draws nothing)."""
    device = gen.device if device is None else device
    a = torch.randn((*lead, d_in, rank), generator=gen, device=device,
                    dtype=torch.float32) / math.sqrt(rank)
    b = torch.zeros((*lead, rank, d_out), device=device,
                    dtype=torch.float32)
    return {"a": a, "b": b}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + w), in float32, cast back to x's
    type (the JAX package's form); one ``F.rms_norm`` call instead of
    six elementwise launches."""
    y = F.rms_norm(x.float(), (x.shape[-1],), weight=1.0 + w.float(),
                   eps=eps)
    return y.to(x.dtype)


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    lora: Optional[dict] = None,
    lora_mask: Optional[torch.Tensor] = None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    """y = x @ w (+ b) (+ selective LoRA on the rows where ``lora_mask``,
    broadcastable to x[..., :1], is 1 — other rows are untouched)."""
    y = x @ w
    if b is not None:
        y = y + b
    if lora is not None and lora_mask is not None:
        y = y + lora_delta(x, lora, lora_mask, lora_scale)
    return y


def lora_delta(x: torch.Tensor, lora: dict, lora_mask: torch.Tensor,
               lora_scale: float, enter=None) -> torch.Tensor:
    """The selective LoRA's ``((x * mask) @ a) @ b * scale``; ``enter``
    (tensor-parallel: ``attention.enter_sharded``) marks the rank-r
    intermediate before it meets a column slice of ``b``."""
    xm = x * lora_mask.to(x.dtype)
    u = xm @ lora["a"].to(x.dtype)
    if enter is not None:
        u = enter(u)
    return (u @ lora["b"].to(x.dtype)) * torch.tensor(
        lora_scale, dtype=x.dtype, device=x.device)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind}")
