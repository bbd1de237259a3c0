"""Gated MLP (SwiGLU / GeGLU) block with lookahead-LoRA hooks.

Params: {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
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
