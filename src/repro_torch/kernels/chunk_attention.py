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

bfloat16 at head dims 64 and 128 (the served models) runs the wgmma + TMA
tile of ``csrc/attention_sm90.cuh`` for both (kernel 2: the tile storing
each row's (m, l), then its ``column_masses_sm90`` over 128-key tiles);
float32 and head dim 32 run the kernels of ``csrc/chunk_attention.cu``.
A short chunk makes few of the tile's CTAs (one per 128-row query tile
and head), so ``key_splits`` spreads each one's key range over up to 4
CTAs when the card has SMs to spare; the kernels merge the float32
partials in split order, so results stay deterministic, and the two
kernels split alike, so kernel 2's ``out`` stays bitwise kernel 1's.
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


#: the Hopper tile's query rows and keys per tile (csrc/attention_sm90.cuh)
TILE = 128
#: at most this many CTAs share one query tile's key range ...
MAX_SPLITS = 4
#: ... and each takes at least this many key tiles
MIN_TILES_PER_SPLIT = 4


def key_splits(B: int, C: int, H: int, K: int, hd: int, dtype, *,
               q_offset: int, window, sms: int) -> int:
    """CTAs per (query tile, head, sequence) of the Hopper tile: 1 unless
    the tile runs (bfloat16 at hd 64 or 128) and its B * H * ceil(C / 128)
    CTAs leave SMs idle; then as many as fill the ``sms`` SMs, at most
    ``MAX_SPLITS``, with at least ``MIN_TILES_PER_SPLIT`` of the 128-key
    tiles the chunk's first row visits each."""
    if dtype != torch.bfloat16 or hd not in (64, 128):
        return 1
    ctas = B * H * -(-C // TILE)
    k_lo = 0
    if window:
        k_lo = max(0, q_offset - int(window) + 1) // TILE * TILE
    n_tiles = -(-(min(K, q_offset + C) - k_lo) // TILE)
    return max(1, min(MAX_SPLITS, sms // ctas,
                      n_tiles // MIN_TILES_PER_SPLIT))


def _split_scratch(q, k, q_offset, window):
    """(n_split, o_part, m_part, l_part) for one call: float32 partials
    (n_split, B, H, C, hd) and (n_split, B, H, C), or Nones for 1."""
    B, C, H, hd = q.shape
    dev = q.device
    n = key_splits(B, C, H, k.shape[1], hd, q.dtype, q_offset=q_offset,
                   window=window, sms=build.sm_count(dev))
    if n == 1:
        return 1, None, None, None
    rows = n * B * H * C
    buf = torch.empty(rows * (hd + 2), dtype=torch.float32, device=dev)
    return (n, buf[:rows * hd].view(n, B, H, C, hd),
            buf[rows * hd:rows * (hd + 1)].view(n, B, H, C),
            buf[rows * (hd + 1):].view(n, B, H, C))


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, window=None) -> torch.Tensor:
    """q (B, C, H, hd), k/v (B, K, KV, hd) on the card -> (B, C, H, hd)."""
    global launches
    _check(q, k, v, q_offset)
    B, C, H, hd = q.shape
    K, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    n, o_part, m_part, l_part = _split_scratch(q, k, q_offset, window)
    err = build.library("chunk_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.ptr(o_part), build.ptr(m_part), build.ptr(l_part), B, C, H, K,
        KV, hd, int(q_offset), int(window or 0), n,
        build.DTYPE_CODES[q.dtype], build.stream_ptr())
    build.check(err, "chunk_attention")
    launches += 1
    return out


def chunk_attention_masses(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, q_offset: int, n_total: int,
                           window=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2: (out (B, C, H, hd), masses (B, H, K) float32).  ``out``
    is bitwise ``chunk_attention``'s; ``masses[b, h, j]`` sums row i's
    softmax mass on key j over the rows with ``q_offset + i < n_total``.
    Launches on the current stream: the attention, which also stores each
    row's final (m, l) into a (B, H, C) float32 scratch (through the
    combine of its key splits when ``key_splits`` gives more than one),
    then the column masses from those statistics."""
    global masses_launches
    _check(q, k, v, q_offset)
    B, C, H, hd = q.shape
    K, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    m_buf = torch.empty((B, H, C), dtype=torch.float32, device=q.device)
    l_buf = torch.empty_like(m_buf)
    masses = torch.empty((B, H, K), dtype=torch.float32, device=q.device)
    n, o_part, m_part, l_part = _split_scratch(q, k, q_offset, window)
    err = build.library("chunk_attention", "chunk_attention_masses")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m_buf.data_ptr(), l_buf.data_ptr(), masses.data_ptr(),
        build.ptr(o_part), build.ptr(m_part), build.ptr(l_part), B, C, H, K,
        KV, hd, int(q_offset), int(n_total), int(window or 0), n,
        build.DTYPE_CODES[q.dtype], build.stream_ptr())
    build.check(err, "chunk_attention_masses")
    masses_launches += 1
    return out, masses
