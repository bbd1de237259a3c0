"""LookaheadKV importance scores on the card (``csrc/lookahead_score.cu``).

The Hopper port of the JAX package's ``lookahead_score_pallas``:
scores[b, h, j] = (1/n_obs) Σ_i softmax_i(q_obs·Kᵀ/√d)[j] for the first
``n_prompt`` keys, float32.  The TPU kernel's two phases become two
launches on the current stream (row statistics, split over key ranges,
then column means); the wrapper sizes the split and owns the (B, H,
n_split, n_obs) float32 scratch.  Plain version: ``ref.lookahead_score``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

#: wrapper calls that launched the kernel pair since the last reset
launches = 0

_TILE = 64  # keys per tile (csrc/lookahead_score.cu: BK)
_TILES_PER_SPLIT = 8  # visible key tiles one pass-1 CTA streams
_MAX_SPLIT = 16


def key_splits(n_visible: int) -> int:
    """Pass-1 key splits: about ``_TILES_PER_SPLIT`` tiles per CTA, so a
    long prompt spreads over many CTAs instead of one per (row tile, head)."""
    tiles = -(-max(n_visible, 1) // _TILE)
    return max(1, min(_MAX_SPLIT, -(-tiles // _TILES_PER_SPLIT)))


def _mask_arg(m: Optional[torch.Tensor], shape, device) -> Optional[int]:
    if m is None:
        return None
    if m.dtype != torch.bool or tuple(m.shape) != tuple(shape) \
            or m.device != device or not m.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool {tuple(shape)} "
                         f"tensor on {device}, got {m.dtype} "
                         f"{tuple(m.shape)} on {m.device}")
    return m.data_ptr()


def lookahead_score(q_obs: torch.Tensor, k: torch.Tensor, n_prompt: int, *,
                    kv_mask: Optional[torch.Tensor] = None, window=None,
                    q_offset: Optional[int] = None,
                    row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q_obs (B, n_obs, H, hd), k (B, Sk, KV, hd) -> (B, H, n_prompt) f32."""
    global launches
    B, n_obs, H, hd = q_obs.shape
    Sk, KV = k.shape[1], k.shape[2]
    if not (q_obs.is_cuda and k.device == q_obs.device):
        raise ValueError("lookahead_score kernel takes CUDA tensors")
    if q_obs.dtype not in build.DTYPE_CODES or k.dtype != q_obs.dtype:
        raise ValueError(f"unsupported dtypes {q_obs.dtype}/{k.dtype}")
    if k.shape != (B, Sk, KV, hd) or H % KV or not 0 < n_prompt <= Sk:
        raise ValueError(f"shape mismatch q_obs {tuple(q_obs.shape)} k "
                         f"{tuple(k.shape)} n_prompt {n_prompt}")
    if hd not in (32, 64, 128):
        raise ValueError(f"head_dim {hd} not built (32, 64, 128)")
    if not (q_obs.is_contiguous() and k.is_contiguous()):
        raise ValueError("lookahead_score kernel takes contiguous tensors")
    km = _mask_arg(kv_mask, (B, n_prompt), q_obs.device)
    rv = _mask_arg(row_valid, (B, n_obs), q_obs.device)
    dev = q_obs.device
    off = n_prompt if q_offset is None else int(q_offset)
    n_split = key_splits(min(Sk, off + n_obs))
    m_buf = torch.empty((B, H, n_split, n_obs), dtype=torch.float32,
                        device=dev)
    l_buf = torch.empty_like(m_buf)
    out = torch.empty((B, H, n_prompt), dtype=torch.float32, device=dev)
    err = build.library("lookahead_score")(
        q_obs.data_ptr(), k.data_ptr(), km, rv, m_buf.data_ptr(),
        l_buf.data_ptr(), out.data_ptr(), B, n_obs, H, Sk, KV, hd, n_prompt,
        off, int(window or 0), n_split, build.DTYPE_CODES[q_obs.dtype],
        build.stream_ptr())
    build.check(err, "lookahead_score")
    launches += 1
    return out
