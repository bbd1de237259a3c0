"""Rotary position embeddings: standard RoPE and qwen2-vl's M-RoPE
(half-split layout).

    x: (B, S, H, hd)   positions: (B, S) int   ->  rotated x

``rope_tables`` computes the (cos, sin) tables of one set of positions
once, so every layer of a forward pass (and both q and k) reuses them
instead of rebuilding them, which in eager PyTorch is a dozen launches
per call.

M-RoPE (arXiv:2409.12191) splits the head dim's frequencies into three
sections driven by (temporal, height, width) position streams (3, B, S):
frequency j turns by the position of its section's stream.
``mrope_tables`` gives the same table form; text tokens use t == h == w
== the absolute position (``text_mrope_positions``), where M-RoPE is
RoPE.
"""

from __future__ import annotations

from typing import Optional

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


def mrope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_tables`` for M-RoPE positions (3, B, S): angles[b, s, j] =
    positions[section(j), b, s] * freq[j] in float32, ``sections`` the
    (t, h, w) half-dim section sizes (summing to head_dim // 2)."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover half "
                         f"of head dim {head_dim}")
    dev = positions.device
    freqs = rope_freqs(head_dim, theta, dev)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=dev), torch.tensor(sections, device=dev),
        output_size=head_dim // 2)
    pos = positions.float()[sec_ids]  # (hd // 2, B, S): each slot's stream
    angles = pos.permute(1, 2, 0) * freqs  # (B, S, hd // 2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], -1)[:, :, None, :],
            torch.cat([-sin, sin], -1)[:, :, None, :])


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """The text stream: t == h == w == the absolute position, (B, S) ->
    (3, B, S)."""
    return positions[None].expand(3, *positions.shape)


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """x (B, S, H, hd) rotated by M-RoPE positions (3, B, S)."""
    return rotate(x, mrope_tables(positions, x.shape[-1], theta, sections))


def tables_for(a, positions: torch.Tensor,
               mrope_positions: Optional[torch.Tensor] = None) -> tuple:
    """The rotary tables of one attention config: M-RoPE's from
    ``mrope_positions`` (3, B, S) when ``a.mrope`` and they are given,
    else RoPE's from ``positions`` (B, S)."""
    if a.mrope and mrope_positions is not None:
        return mrope_tables(mrope_positions, a.head_dim, a.rope_theta,
                            a.mrope_sections)
    return rope_tables(positions, a.head_dim, a.rope_theta)
