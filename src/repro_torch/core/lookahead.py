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
                          layer_params: dict, *, device=None) -> dict:
    """Build {"emb": (n_lookahead, D) f32, "lora": mirrored tree} from the
    stacked per-layer tree (leaves with a leading L axis), on ``device``
    (default: the generator's; ``"meta"``: shapes only)."""
    lk = cfg.lookahead
    device = gen.device if device is None else device
    emb = torch.randn((lk.n_lookahead, cfg.d_model), generator=gen,
                      device=device, dtype=torch.float32) * 0.02

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
                                      lead=(L,), device=device)
        return out

    return {"emb": emb, "lora": build(layer_params)}


def lookahead_count(lkv_params: dict) -> int:
    """Number of trainable lookahead parameters (every leaf's size)."""
    return sum(lookahead_count(v) if isinstance(v, dict) else int(v.numel())
               for v in lkv_params.values())


def load_lookahead_params(path: str, cfg: ModelConfig, layer_params: dict,
                          *, device="cpu") -> dict:
    """Load trained lookahead modules from a checkpoint onto ``device``.

    Takes both layouts the trainer writes (``launch/train.py``, in either
    package): a bare lkv tree (the final export) and the trainer state
    ``{"lkv": tree, "opt": AdamState}`` (a periodic ``--ckpt-every``
    save)."""
    from repro_torch.checkpoint import io as ckpt

    like = init_lookahead_params(torch.Generator().manual_seed(0), cfg,
                                 layer_params)
    flat = ckpt.load(path, device=device)
    if any(k.startswith("lkv/") for k in flat):
        flat = {k[len("lkv/"):]: v
                for k, v in flat.items() if k.startswith("lkv/")}
    return ckpt.unflatten(flat, like)


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
