"""Lookahead parameters: learnable lookahead tokens + selective LoRA tree.

The LoRA tree mirrors the model's stacked layer tree: every stacked
linear weight ``(L, d_in, d_out)`` whose leaf name is in
``cfg.lookahead.lora_targets`` gets ``{"a": (L, d_in, r), "b": (L, r,
d_out)}`` in float32, so module code looks adapters up by the weight's own
name (the JAX package's layout, which ``bridge.py`` carries across).
"""

from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import lora_init


def lora_scale(cfg: ModelConfig) -> float:
    lk = cfg.lookahead
    return lk.lora_alpha / lk.lora_rank


def init_lookahead_params(gen: torch.Generator, cfg: ModelConfig,
                          layer_params: dict) -> dict:
    """Build {"emb": (n_lookahead, D) f32, "lora": mirrored tree} from the
    stacked per-layer tree (leaves with a leading L axis)."""
    lk = cfg.lookahead
    emb = torch.randn((lk.n_lookahead, cfg.d_model), generator=gen,
                      device=gen.device, dtype=torch.float32) * 0.02

    def build(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                sub = build(leaf)
                if sub:
                    out[name] = sub
            elif name in lk.lora_targets and leaf.dim() == 3:
                L, d_in, d_out = leaf.shape
                out[name] = lora_init(gen, d_in, d_out, lk.lora_rank,
                                      lead=(L,))
        return out

    return {"emb": emb, "lora": build(layer_params)}


def append_lookahead(h: torch.Tensor, lkv_params: dict
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate the learned lookahead rows after the embedded prompt
    (B, S, D).  Returns (h' (B, S + n, D), lookahead_mask (B, S + n, 1)),
    the mask 1 on the lookahead rows (where the selective LoRA applies)."""
    B, S, D = h.shape
    emb = lkv_params["emb"].to(h.dtype)  # (n, D)
    n = emb.shape[0]
    h2 = torch.cat([h, emb[None].expand(B, n, D)], dim=1)
    mask = torch.cat([torch.zeros((B, S, 1), dtype=h.dtype, device=h.device),
                      torch.ones((B, n, 1), dtype=h.dtype, device=h.device)],
                     dim=1)
    return h2, mask
