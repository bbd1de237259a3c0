"""Chunk attention on the card (``csrc/chunk_attention.cu``).

The Hopper port of the JAX package's ``chunk_attention_pallas``: C query
rows at absolute position ``q_offset`` attend over a K-deep key/value
buffer (earlier columns visible, causal within the chunk, later columns
invisible, optional sliding window).  It serves both the prefill chunks
(C = chunk) and the lookahead observation pass (C = n_lookahead rows at
``q_offset = n_total``).  Plain version: ``ref.chunk_attention``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import check_offset

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, window=None) -> torch.Tensor:
    """q (B, C, H, hd), k/v (B, K, KV, hd) on the card -> (B, C, H, hd)."""
    global launches
    B, C, H, hd = q.shape
    K, KV = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("chunk_attention kernel takes CUDA tensors")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, K, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in (32, 64, 128):
        raise ValueError(f"head_dim {hd} not built (32, 64, 128)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("chunk_attention kernel takes contiguous tensors")
    check_offset(q_offset, C, K)
    out = torch.empty_like(q)
    err = build.library("chunk_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, C, H, K,
        KV, hd, int(q_offset), int(window or 0), build.DTYPE_CODES[q.dtype],
        build.stream_ptr())
    build.check(err, "chunk_attention")
    launches += 1
    return out
