"""LookaheadKV importance scores on the card (``csrc/lookahead_score.cu``).

The Hopper port of the JAX package's ``lookahead_score_pallas``:
scores[b, h, j] = (1/n_obs) Σ_i softmax_i(q_obs·Kᵀ/√d)[j] for the first
``n_prompt`` keys, float32.  The TPU kernel's two phases become two
launches on the current stream (row statistics, split over key ranges,
then column means); the wrapper sizes the split and owns the (B, H,
n_split, n_obs) float32 scratch.  bf16 runs on tensor cores with each kv
head's group of query heads packed into one tile (16-row fragments, 8 to
a row block); float32 on scalar FMAs.  Plain version:
``ref.lookahead_score``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_attention import HEAD_DIMS

#: wrapper calls that launched the kernel pair since the last reset
launches = 0

_TILE = 64  # keys per tile (csrc/lookahead_score.cu: BK)
#: 16-row fragments of one kv head's packed query rows per row block
#: (csrc/lookahead_score.cu: MAXF)
_FRAGMENTS = 8
#: key splits of launch (a): at most this many ...
MAX_SPLITS = 16
#: ... each streaming at least this many key tiles ...
MIN_TILES_PER_SPLIT = 4
#: ... and no more CTAs in all than this many per SM (two 128-thread CTAs
#: of up to ~110 KB of shared memory fit one): one wave (launch (b) too)
CTAS_PER_SM = 2
#: dynamic shared memory a CTA may take on the H100, 227 KB
#: (csrc/lookahead_score.cu: MAX_SMEM)
MAX_SMEM = 232448


def row_blocks(n_obs: int, group: int) -> int:
    """Launch (a)'s row blocks per (sequence, kv head): each query head's
    ``n_obs`` rows padded to 16, ``_FRAGMENTS`` 16-row fragments a block."""
    return -(-(-(-n_obs // 16) * group) // _FRAGMENTS)


def key_splits(B: int, n_obs: int, H: int, KV: int, n_visible: int,
               sms: int, hd: int) -> int:
    """Key splits of launch (a): as many as give each at least
    ``MIN_TILES_PER_SPLIT`` of the ``n_visible`` keys' tiles, at most
    ``MAX_SPLITS``, and no more than fit ``CTAS_PER_SM`` CTAs of all
    (sequence, kv head, row block)s on each of the ``sms`` SMs: at
    llama3-8b's finalize (B 1, 8 kv heads, 4032 visible keys) 16 splits
    of ~4 tiles, 128 CTAs.  Launch (b) stages every split's partials, so
    no more than leave a CTA of it room for one key tile
    (``column_smem``; it binds only at hd 256 with two row blocks)."""
    tiles = -(-max(n_visible, 1) // _TILE)
    ctas = B * KV * row_blocks(n_obs, H // KV)
    n = max(1, min(MAX_SPLITS, -(-tiles // MIN_TILES_PER_SPLIT),
                   CTAS_PER_SM * sms // ctas))
    while n > 1 and column_smem(n_obs, H // KV, hd, n, 1) > MAX_SMEM:
        n -= 1
    return n


def column_smem(n_obs: int, G: int, hd: int, n_split: int,
                t_per: int) -> int:
    """Bytes of dynamic shared memory a CTA of launch (b) takes (bf16;
    csrc/lookahead_score.cu: launch_mma): the 2-tile K ring and
    ``qstages`` (two when there is more than one row block) x (packed Q
    rows, raw partials) in bf16 and float32, then each row's (m, 1 / l),
    the fragments' column sums and the G heads' column sums over
    ``t_per`` tiles."""
    rows = 16 * _FRAGMENTS
    qstages = 2 if row_blocks(n_obs, G) > 1 else 1
    return ((2 * _TILE + qstages * rows) * (hd + 8) * 2
            + (qstages * n_split * 2 * rows + 2 * rows + _FRAGMENTS * _TILE
               + G * t_per * _TILE) * 4)


def column_tiles(B: int, n_obs: int, H: int, KV: int, hd: int,
                 n_prompt: int, n_split: int, sms: int) -> int:
    """Key tiles each CTA of launch (b) takes (bf16): the fewest that keep
    its CTAs (key ranges x kv heads x sequences) within ``CTAS_PER_SM``
    per SM, so the packed Q rows and the row partials are staged once per
    range rather than once per tile: 2 at llama3-8b's finalize (256
    CTAs).  No more than fit a CTA's shared memory (``column_smem``,
    ``MAX_SMEM``): beyond that launch (b) takes more than one wave (154
    tiles a CTA at llama3-8b's G 4 and hd 128 with 2 key splits)."""
    tiles = -(-n_prompt // _TILE)
    G = H // KV
    fit = (MAX_SMEM - column_smem(n_obs, G, hd, n_split, 0)) // (
        G * _TILE * 4)
    return max(1, min(fit, -(-tiles * B * KV // (CTAS_PER_SM * sms))))


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not built {HEAD_DIMS}")
    if not (q_obs.is_contiguous() and k.is_contiguous()):
        raise ValueError("lookahead_score kernel takes contiguous tensors")
    km = _mask_arg(kv_mask, (B, n_prompt), q_obs.device)
    rv = _mask_arg(row_valid, (B, n_obs), q_obs.device)
    dev = q_obs.device
    off = n_prompt if q_offset is None else int(q_offset)
    sms = build.sm_count(dev)
    n_split = key_splits(B, n_obs, H, KV, min(Sk, off + n_obs), sms, hd)
    m_buf = torch.empty((B, H, n_split, n_obs), dtype=torch.float32,
                        device=dev)
    l_buf = torch.empty_like(m_buf)
    out = torch.empty((B, H, n_prompt), dtype=torch.float32, device=dev)
    err = build.library("lookahead_score")(
        q_obs.data_ptr(), k.data_ptr(), km, rv, m_buf.data_ptr(),
        l_buf.data_ptr(), out.data_ptr(), B, n_obs, H, Sk, KV, hd, n_prompt,
        off, int(window or 0), n_split,
        column_tiles(B, n_obs, H, KV, hd, n_prompt, n_split, sms),
        build.DTYPE_CODES[q_obs.dtype],
        build.stream_ptr())
    build.check(err, "lookahead_score")
    launches += 1
    return out
