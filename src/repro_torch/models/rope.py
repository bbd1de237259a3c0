"""Rotary position embeddings (standard RoPE, half-split layout).

    x: (B, S, H, hd)   positions: (B, S) int   ->  rotated x

``rope_tables`` computes the (cos, sin) tables of one set of positions
once, so every layer of a forward pass (and both q and k) reuses them
instead of rebuilding them, which in eager PyTorch is a dozen launches
per call.  M-RoPE (qwen2-vl) comes with the VLM archs (ROADMAP A10).
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim // 2,) inverse frequencies, float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cat(cos, cos), cat(-sin, sin)), each (B, S, 1, hd) float32, for
    ``positions`` — the full-width form ``rotate`` multiplies with."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freqs  # (B, S, hd // 2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], -1)[:, :, None, :],
            torch.cat([-sin, sin], -1)[:, :, None, :])


def rotate(x: torch.Tensor, tables: tuple[torch.Tensor, torch.Tensor]
           ) -> torch.Tensor:
    """[x1 cos - x2 sin, x2 cos + x1 sin] for x = [x1, x2], computed as
    x * cat(cos, cos) + cat(x2, x1) * cat(-sin, sin): the same float32
    products and sums (a - b is a + (-b) exactly), in 5 launches
    instead of 8."""
    cos2, sin2 = tables
    hd = x.shape[-1]
    swapped = torch.cat([x[..., hd // 2:], x[..., : hd // 2]], dim=-1)
    return (x * cos2 + swapped * sin2).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    return rotate(x, rope_tables(positions, x.shape[-1], theta))
