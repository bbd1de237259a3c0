"""Chunk attention on the card (``csrc/chunk_attention.cu``).

The Hopper port of the JAX package's ``chunk_attention_pallas``: C query
rows at absolute position ``q_offset`` attend over a K-deep key/value
buffer (earlier columns visible, causal within the chunk, later columns
invisible, optional sliding window).  It serves both the prefill chunks
(C = chunk) and the lookahead observation pass (C = n_lookahead rows at
``q_offset = n_total``).  Plain version: ``ref.chunk_attention``.

``chunk_attention_masses`` ports ``chunk_attention_masses_pallas`` (the
h2o chunk): the same attention, bitwise, plus the summed softmax column
masses of the rows below ``n_total``.  Plain version: ``ref.chunk_attention``
and ``ref.chunk_column_masses``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import check_offset

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0
#: ``chunk_attention_masses`` calls that launched kernel 2 (its two
#: launches) since the last reset
masses_launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    """Raise on what the kernels do not take."""
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


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, window=None) -> torch.Tensor:
    """q (B, C, H, hd), k/v (B, K, KV, hd) on the card -> (B, C, H, hd)."""
    global launches
    _check(q, k, v, q_offset)
    B, C, H, hd = q.shape
    K, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = build.library("chunk_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, C, H, K,
        KV, hd, int(q_offset), int(window or 0), build.DTYPE_CODES[q.dtype],
        build.stream_ptr())
    build.check(err, "chunk_attention")
    launches += 1
    return out


def chunk_attention_masses(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, q_offset: int, n_total: int,
                           window=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2: (out (B, C, H, hd), masses (B, H, K) float32).  ``out``
    is bitwise ``chunk_attention``'s; ``masses[b, h, j]`` sums row i's
    softmax mass on key j over the rows with ``q_offset + i < n_total``.
    Two launches on the current stream: the attention, which also stores
    each row's final (m, l) into a (B, H, C) float32 scratch, then the
    column masses from those statistics."""
    global masses_launches
    _check(q, k, v, q_offset)
    B, C, H, hd = q.shape
    K, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    m_buf = torch.empty((B, H, C), dtype=torch.float32, device=q.device)
    l_buf = torch.empty_like(m_buf)
    masses = torch.empty((B, H, K), dtype=torch.float32, device=q.device)
    err = build.library("chunk_attention", "chunk_attention_masses")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m_buf.data_ptr(), l_buf.data_ptr(), masses.data_ptr(), B, C, H, K,
        KV, hd, int(q_offset), int(n_total), int(window or 0),
        build.DTYPE_CODES[q.dtype], build.stream_ptr())
    build.check(err, "chunk_attention_masses")
    masses_launches += 1
    return out, masses
