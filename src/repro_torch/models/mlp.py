"""Gated MLP (SwiGLU / GeGLU) block with lookahead-LoRA hooks, and its
tensor-parallel form (``apply_sharded``).

Params: {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import activation, dense_init, linear


def init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, *,
         lead=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, d, f, dtype, lead=lead),
        "w_up": dense_init(gen, d, f, dtype, lead=lead),
        "w_down": dense_init(gen, f, d, dtype, lead=lead),
    }


def apply(
    p: dict,
    cfg: ModelConfig,
    h: torch.Tensor,
    *,
    lora: Optional[dict] = None,
    lora_mask: Optional[torch.Tensor] = None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    def _l(name):
        return None if lora is None else lora.get(name)

    g = linear(h, p["w_gate"], lora=_l("w_gate"), lora_mask=lora_mask,
               lora_scale=lora_scale)
    u = linear(h, p["w_up"], lora=_l("w_up"), lora_mask=lora_mask,
               lora_scale=lora_scale)
    y = activation(g, cfg.act) * u
    return linear(y, p["w_down"], lora=_l("w_down"), lora_mask=lora_mask,
                  lora_scale=lora_scale)


def apply_sharded(
    p: dict,
    cfg: ModelConfig,
    h: torch.Tensor,
    smesh,
    *,
    lora: Optional[dict] = None,
    lora_mask: Optional[torch.Tensor] = None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    """``apply`` under tensor parallelism, bit for bit ``apply`` wherever a
    column slice of a product is: column-parallel gate/up (``p`` holds the
    rank's d_ff columns; the full d_model contraction per column), the
    gating on the local columns, the activation all-gathered so that the
    rank's column slice of ``w_down`` contracts the full d_ff in
    single-device order, and the output columns all-gathered.  LoRA deltas
    ride along (A in full, B column-sliced like its base weight).  The
    products are ``attention.column_linears``, so a gradient taken
    through the MLP is whole on every rank (``models/attention.py``'s
    tensor-parallel comment).  Where d_ff or d_model does not divide the
    model axis ``p`` holds the whole MLP (``sharding.serving_specs``) and
    every rank evaluates it whole."""
    if smesh is None or p["w_gate"].shape[-1] == cfg.d_ff:
        return attn_mod.replicated_apply(
            lambda: apply(p, cfg, h, lora=lora, lora_mask=lora_mask,
                          lora_scale=lora_scale), smesh)

    def _l(name):
        return None if lora is None else lora.get(name)

    kw = dict(lora_mask=lora_mask, lora_scale=lora_scale)
    g, u = attn_mod.column_linears(h, [p["w_gate"], p["w_up"]], smesh,
                                   loras=[_l("w_gate"), _l("w_up")], **kw)
    y = attn_mod.all_gather(activation(g, cfg.act) * u, -1, smesh)
    out, = attn_mod.column_linears(y, [p["w_down"]], smesh,
                                   loras=[_l("w_down")], **kw)
    return attn_mod.all_gather(out, -1, smesh)
