"""Dense flash-decode on the card (``csrc/decode_attention.cu``).

The Hopper port of the JAX package's ``decode_attention_pallas``: one
query token per sequence over a dense (B, C, KV, hd) cache, with no
mask, a (B, C) mask or the per-kv-head (B, C, KV) mask of the evicted
decode caches (the Pallas kernel takes only the first two, so the JAX
decode step runs its jnp reference there).  A (sequence, kv head) with no
valid row gives exact zeros.  Plain version: ``ref.decode_attention``.

The kernel splits each (sequence, kv head)'s rows over the CTAs of one
thread-block cluster (``csrc/decode_split.cuh``, the routine of the paged
kernels 4 and 5): ``row_splits`` picks how many from the shapes and the
card's SM count; the CTAs merge in rank order in the same launch, so
results are deterministic.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, paged_attention

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0


def row_splits(B: int, KV: int, C: int, sms: int) -> int:
    """CTAs per (sequence, kv head): the paged kernels' rule
    (``paged_attention.row_splits``) with each row a block of one, so at
    least ``MIN_ROWS_PER_SPLIT`` rows per CTA, at most ``MAX_SPLITS``
    CTAs, and one wave of CTAs on the ``sms`` SMs."""
    return paged_attention.row_splits(B, KV, C, 1, sms)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, hd), k/v (B, C, KV, hd), kv_mask None, (B, C) or (B, C, KV)
    bool, on the card -> (B, H, hd) in q's type."""
    global launches
    B, H, hd = q.shape
    C, KV = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention kernel takes CUDA tensors")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, C, KV, hd) or v.shape != k.shape or H % KV \
            or not 1 <= H // KV <= 32:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in (32, 64, 128):
        raise ValueError(f"head_dim {hd} not built (32, 64, 128)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention kernel takes contiguous tensors")
    kind = 0
    if kv_mask is not None:
        if kv_mask.dtype != torch.bool or tuple(kv_mask.shape) not in (
                (B, C), (B, C, KV)) or kv_mask.device != q.device \
                or not kv_mask.is_contiguous():
            raise ValueError(f"kv_mask must be a contiguous bool (B, C) or "
                             f"(B, C, KV) tensor on {q.device}, got "
                             f"{kv_mask.dtype} {tuple(kv_mask.shape)} on "
                             f"{kv_mask.device}")
        kind = kv_mask.dim()
    out = torch.empty_like(q)
    err = build.library("decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), build.ptr(kv_mask),
        out.data_ptr(), B, H, KV, C, hd, kind,
        row_splits(B, KV, C, build.sm_count(q.device)),
        build.DTYPE_CODES[q.dtype], build.stream_ptr())
    build.check(err, "decode_attention")
    launches += 1
    return out
