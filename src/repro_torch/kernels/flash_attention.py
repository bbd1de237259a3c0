"""Monolithic flash attention on the card (``csrc/chunk_attention.cu``,
entry ``flash_attention``).

The Hopper port of the JAX package's ``flash_attention_pallas``: GQA
self-attention of a whole sequence (Sq == Sk), causal or, with
``causal=False``, over every key, with an optional sliding window: the
chunk attention with ``q_offset = 0`` and the chunk spanning the buffer.
bfloat16 at head dims 64, 128 and 256 (the served models) runs the wgmma +
TMA tile of ``csrc/attention_sm90.cuh`` (128-row query tiles of two
consumer warpgroups, a producer warpgroup feeding a three-stage TMA ring of
128-key K/V tiles, at hd 256 a two-stage ring of 64-key tiles); float32
and head dim 32 run the chunk-attention kernels of
``csrc/chunk_attention.cu``.  This wrapper has its own entry point and
launch counter.  Any S: the ragged last tile is masked (the Pallas kernel
asserts block multiples).  Plain version: ``ref.flash_attention``.

Cross-attention (whisper's decoder rows over its encoder frames): q (B,
Sq, H, hd) over k/v (B, Sk, KV, hd) with Sq != Sk, non-causal and
unwindowed, on the same kernels (the Q and O maps span Sq rows, the K/V
maps Sk keys).  The JAX package computes it in jnp (``ops.py:97-113``),
so this form replaces no Pallas kernel; the port keeps it on the card as
it keeps the key mask.

A key mask ``kv_mask`` (B, S) bool hides the keys it marks False from
every row: the bucket-padded prefill's padding rows
(``transformer.prefill(prompt_lens=)``).  The JAX package sends a masked
call to its jnp attention, not to Pallas; here it runs the same kernels,
the Hopper tile in its ``MASKED`` instantiations, which skip a key tile
with no valid key and mask in registers only a tile that holds a masked
one.  An unmasked call runs the unmasked code unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_attention import HEAD_DIMS, key_tile
from repro_torch.kernels.ref import check_cross

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0


#: key tiles a masked call may span (the Hopper tile keeps two bits per
#: tile in shared memory): Sk up to 262,144 at hd 64 and 128, 131,072 at
#: 256 (whisper's 1,500 frames are 12 tiles at hd 64)
MAX_MASKED_TILES = 2048


def max_masked_s(hd: int) -> int:
    """The longest key axis a masked call takes at head dim ``hd``."""
    return MAX_MASKED_TILES * key_tile(hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) on the card -> (B, Sq, H,
    hd), Sq != Sk only with ``causal=False`` and no window; ``kv_mask``
    None or a contiguous bool (B, Sk) tensor on q's device.

    Contract under a mask: every query row sees at least one valid key
    (tail padding under the causal mask, as the padded prefill gives).  A
    row that sees none comes out as zeros, never NaN; the plain version
    (softmax over ``NEG_INF`` logits) gives it the mean of V instead."""
    global launches
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel takes CUDA tensors")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Sk, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    check_cross(Sq, Sk, causal, window)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not built {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if kv_mask is not None:
        if kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (B, Sk) \
                or kv_mask.device != q.device \
                or not kv_mask.is_contiguous():
            raise ValueError(f"kv_mask must be a contiguous bool (B, Sk) "
                             f"tensor on {q.device}, got {kv_mask.dtype} "
                             f"{tuple(kv_mask.shape)} on {kv_mask.device}")
        if Sk > max_masked_s(hd):
            raise ValueError(f"a masked call takes Sk <= {max_masked_s(hd)} "
                             f"at head_dim {hd}, got {Sk}")
    out = torch.empty_like(q)
    err = build.library("chunk_attention", "flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), build.ptr(kv_mask),
        out.data_ptr(), B, Sq, Sk, H, KV, hd, int(bool(causal)),
        int(window or 0), build.DTYPE_CODES[q.dtype], build.stream_ptr())
    build.check(err, "flash_attention")
    launches += 1
    return out
