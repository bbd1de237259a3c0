"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060) of the port.

in_proj fans the hidden state out to (z, x, B, C, dt); a short causal
conv mixes x/B/C locally; the SSD scan (``ops.ssd_scan``: kernel 8 on the
card, the chunked plain version on the CPU) runs the selective
state-space recurrence; a gated RMSNorm and out_proj close the block.

Decode keeps a constant-size recurrent cache: the conv tail (the last
conv_width - 1 pre-conv inputs) and the SSM state (nh, hd, ds) float32.

Single-layer params (the JAX package's tree; stacked on a leading L axis
by ``transformer.init_params``):
    in_proj: (D, 2*di + 2*G*ds + nh)   [z | x | B | C | dt]
    conv_w: (cw, di + 2*G*ds), conv_b: (di + 2*G*ds)
    A_log: (nh,) f32, D_skip: (nh,) f32, dt_bias: (nh,) f32, norm: (di,)
    out_proj: (di, D)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, gen_device, linear,
                                      rms_norm)

# B/C share a single group in every config (Mamba-2's default ngroups = 1)
NGROUPS = 1


def dims(cfg: ModelConfig):
    """(ssm config, d_inner, heads, conv channels)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    return s, di, nh, di + 2 * NGROUPS * s.d_state


def init(gen: Optional[torch.Generator], cfg: ModelConfig,
         dtype: torch.dtype, *, lead=()) -> dict:
    """Random parameters drawn from ``gen`` (the JAX package's
    distributions): A = -uniform(a_init_range) per head, dt_bias the
    inverse softplus of dt drawn log-uniformly in [dt_min, dt_max]."""
    s, di, nh, conv_dim = dims(cfg)
    dev = gen_device(gen)
    d_in_proj = 2 * di + 2 * NGROUPS * s.d_state + nh
    lo, hi = s.a_init_range

    def uniform(shape):
        return torch.rand((*lead, *shape), generator=gen, device=dev,
                          dtype=torch.float32)

    a_init = lo + (hi - lo) * uniform((nh,))
    dt = torch.exp(uniform((nh,)) * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    conv_w = torch.randn((*lead, s.conv_width, conv_dim), generator=gen,
                         device=dev, dtype=torch.float32) * 0.1
    return {
        "in_proj": dense_init(gen, cfg.d_model, d_in_proj, dtype, lead=lead),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=dev),
        "A_log": torch.log(a_init),
        "D_skip": torch.ones((*lead, nh), dtype=torch.float32, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus
        "norm": torch.zeros((*lead, di), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, cfg.d_model, dtype, lead=lead),
    }


def init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, *,
               lead=(), device="cuda") -> dict:
    """Zero decode cache: conv (*lead, batch, cw - 1, conv_dim) in the model
    type, state (*lead, batch, nh, hd, ds) float32."""
    s, _, nh, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((*lead, batch, s.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((*lead, batch, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (logaddexp(x, 0)): max(x, 0) + log1p(exp(-|x|)),
    without ``F.softplus``'s linear branch above its threshold."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """[z | x B C | dt] views; x, B and C share the conv."""
    s, di, nh, _ = dims(cfg)
    return torch.split(zxbcdt, [di, di + 2 * NGROUPS * s.d_state, nh],
                       dim=-1)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    """x (..., nh, hd), B and C (..., G, ds): views of the conv output."""
    s, di, nh, _ = dims(cfg)
    gds = NGROUPS * s.d_state
    x, Bm, Cm = torch.split(xbc, [di, gds, gds], dim=-1)
    return (x.unflatten(-1, (nh, s.head_dim)),
            Bm.unflatten(-1, (NGROUPS, s.d_state)),
            Cm.unflatten(-1, (NGROUPS, s.d_state)))


def _causal_conv(w: torch.Tensor, b: torch.Tensor, xbc: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis, xbc (B, S, C), in the
    working type: the JAX package's sum of cw shifted slices, added in the
    same order (``sum`` starts from 0), then SiLU.  Not ``F.conv1d``: a
    float32 convolution runs on cuDNN in TF32 by default on the card."""
    cw = w.shape[0]
    if tail is None:
        tail = torch.zeros((xbc.shape[0], cw - 1, xbc.shape[2]),
                           dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([tail, xbc], dim=1)  # (B, S + cw - 1, C)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(cw))
    return F.silu(out + b[None, None, :])


def apply(
    p: dict,
    cfg: ModelConfig,
    h: torch.Tensor,  # (B, S, D)
    *,
    lora: Optional[dict] = None,
    lora_mask: Optional[torch.Tensor] = None,
    lora_scale: float = 1.0,
    initial_state: Optional[torch.Tensor] = None,  # (B, nh, hd, ds) f32
    conv_tail: Optional[torch.Tensor] = None,  # (B, cw - 1, conv_dim)
) -> tuple[torch.Tensor, dict]:
    """Full-sequence SSD pass.  Returns (out (B, S, D), cache {"conv": the
    last cw - 1 pre-conv rows, "state": the final state}).

    ``initial_state``/``conv_tail`` chain segments: the hybrid prefill runs
    the real prompt first (its final state becomes the decode cache) and
    then the appended observation rows, so the cached state holds no
    observation token."""
    s, di, _, _ = dims(cfg)
    B, S, _ = h.shape

    def _l(name):
        return None if lora is None else lora.get(name)

    zxbcdt = linear(h, p["in_proj"], lora=_l("in_proj"), lora_mask=lora_mask,
                    lora_scale=lora_scale)
    z, xbc_pre, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(p["conv_w"], p["conv_b"], xbc_pre, tail=conv_tail)
    x, Bm, Cm = _split_xbc(cfg, xbc)
    dt = softplus(dt_raw.float() + p["dt_bias"])  # (B, S, nh)
    A = -torch.exp(p["A_log"])  # (nh,) negative rates
    y, final_state = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=s.chunk_size,
                                  initial_state=initial_state)  # float32
    y = y + p["D_skip"][None, None, :, None] * x.float()
    y = y.reshape(B, S, di).to(h.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = linear(y, p["out_proj"], lora=_l("out_proj"), lora_mask=lora_mask,
                 lora_scale=lora_scale)
    # the conv tail is the last cw - 1 pre-conv rows, the carry-in first so
    # that a short segment still has a full tail; a copy, so that the cache
    # does not hold the whole projection alive
    if conv_tail is not None:
        xbc_pre = torch.cat([conv_tail, xbc_pre], dim=1)
    return out, {"conv": xbc_pre[:, -(s.conv_width - 1):].contiguous(),
                 "state": final_state}


def step(p: dict, cfg: ModelConfig, h1: torch.Tensor,  # (B, 1, D)
         cache: dict) -> tuple[torch.Tensor, dict]:
    """Single-token recurrent step.  Returns (out (B, 1, D), new cache)."""
    s, di, _, _ = dims(cfg)
    B = h1.shape[0]
    z, xbc_new, dt_raw = _split_proj(cfg, linear(h1, p["in_proj"]))
    conv_in = torch.cat([cache["conv"], xbc_new], dim=1)  # (B, cw, C)
    xbc = sum(conv_in[:, i:i + 1] * p["conv_w"][i][None, None, :]
              for i in range(s.conv_width))
    xbc = F.silu(xbc + p["conv_b"][None, None, :])
    x, Bm, Cm = _split_xbc(cfg, xbc)
    dt = softplus(dt_raw.float() + p["dt_bias"])  # (B, 1, nh)
    A = -torch.exp(p["A_log"])
    y, new_state = ops.ssd_step(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                cache["state"])
    # the step rounds y to x's type before the skip term (JAX's ssd_step)
    y = y.float() + p["D_skip"][None, :, None] * x[:, 0].float()
    y = y.reshape(B, 1, di).to(h1.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return linear(y, p["out_proj"]), {"conv": conv_in[:, 1:],
                                      "state": new_state}
