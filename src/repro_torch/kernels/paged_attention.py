"""Paged flash-decode on the card (``csrc/paged_attention.cu``).

The Hopper ports of the JAX package's ``paged_decode_attention_pallas``
(kernel 4) and ``paged_decode_masses_pallas`` (kernel 5), both in their
plain and windowed forms: one query token per sequence over a
block-table view of the shared KV pool, with per-kv-head validity and an
optional ``new_pos - pos < window`` predicate.  The kernels read the
block table themselves.  Kernel 5 also returns every table row's
normalised softmax mass per query head (the decode-time eviction
scores); its ``out`` is bitwise kernel 4's.  Plain versions:
``ref.paged_decode_attention`` and ``ref.paged_decode_masses``.

Both kernels split each (sequence, kv head)'s rows over the CTAs of one
thread-block cluster (``csrc/decode_split.cuh``): ``row_splits`` picks how
many from the shapes and the card's SM count, the CTAs merge in rank
order through distributed shared memory in the same launch, so results
are deterministic, and the two kernels split alike, so kernel 5's ``out``
stays bitwise kernel 4's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

#: launches of kernel 4 (``paged_decode_attention``) and kernel 5
#: (``paged_decode_masses``) since the last reset (``ops.reset_launch_counts``)
launches = 0
mass_launches = 0

#: CTAs of one cluster that share a (sequence, kv head)'s rows: at most
#: 4 (the card takes up to 8, the portable cluster size, but 8 lost to 4
#: at every table size ``chip_ab.py --splits`` timed) ...
MAX_SPLITS = 4
#: ... each taking at least this many rows (4 warps of 4 steps of 2 rows
#: at bf16 hd 128: one round of K/V copies) ...
MIN_ROWS_PER_SPLIT = 32
#: ... and no more CTAs in all than this many per SM (two 128-thread CTAs
#: of ~175 registers fit one): one wave
CTAS_PER_SM = 2


def row_splits(B: int, KV: int, nb: int, bs: int, sms: int) -> int:
    """CTAs per (sequence, kv head) of kernels 4 and 5: as many as give
    each at least ``MIN_ROWS_PER_SPLIT`` of the table's ``nb * bs`` rows
    (and at least one block), at most ``MAX_SPLITS``, and no more than
    fit ``CTAS_PER_SM`` CTAs on each of the ``sms`` SMs.  Sized per
    sequence, not from ``B * KV`` alone: a decode step with one live slot
    of four still spreads that slot's rows over ``KV`` clusters."""
    return max(1, min(MAX_SPLITS, nb, nb * bs // MIN_ROWS_PER_SPLIT,
                      CTAS_PER_SM * sms // (B * KV)))


def _need(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check(q, k_pool, v_pool, mask_pool, table, pos_pool, new_pos,
           window) -> int:
    """Validate the shared arguments of both kernels; returns the window
    (0: none)."""
    B, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    nb = table.shape[1]
    dev = q.device
    if not q.is_cuda:
        raise ValueError("paged decode kernels take CUDA tensors")
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if H % KV or not 1 <= H // KV <= 32 or hd not in (32, 64, 128):
        raise ValueError(f"unsupported heads H={H} KV={KV} hd={hd}")
    _need(q, "q", q.dtype, (B, H, hd), dev)
    _need(k_pool, "k_pool", q.dtype, (N, bs, KV, hd), dev)
    _need(v_pool, "v_pool", q.dtype, (N, bs, KV, hd), dev)
    _need(mask_pool, "mask_pool", torch.bool, (N, bs, KV), dev)
    _need(table, "table", torch.int32, (B, nb), dev)
    win = int(window or 0)
    if win > 0:
        if pos_pool is None or new_pos is None:
            raise ValueError("sliding-window masking needs pos_pool and "
                             "new_pos")
        _need(pos_pool, "pos_pool", torch.int32, (N, bs, KV), dev)
        _need(new_pos, "new_pos", torch.int32, (B,), dev)
    return win


def _args(q, k_pool, v_pool, mask_pool, table, pos_pool, new_pos, win):
    return (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            mask_pool.data_ptr(), build.ptr(pos_pool) if win > 0 else None,
            table.data_ptr(), build.ptr(new_pos) if win > 0 else None)


def _dims(q, k_pool, table, win):
    B, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    nb = table.shape[1]
    n = row_splits(B, KV, nb, bs, build.sm_count(q.device))
    return (B, H, KV, hd, bs, nb, win, n, build.DTYPE_CODES[q.dtype],
            build.stream_ptr())


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, mask_pool: torch.Tensor,
                           table: torch.Tensor, *,
                           pos_pool: Optional[torch.Tensor] = None,
                           new_pos: Optional[torch.Tensor] = None,
                           window=None) -> torch.Tensor:
    """Kernel 4.  q (B, H, hd); pools (N, bs, KV, hd); mask/pos (N, bs,
    KV); table (B, nb) int32; new_pos (B,) int32 -> (B, H, hd) in q's
    type."""
    global launches
    win = _check(q, k_pool, v_pool, mask_pool, table, pos_pool, new_pos,
                 window)
    out = torch.empty_like(q)
    err = build.library("paged_attention")(
        *_args(q, k_pool, v_pool, mask_pool, table, pos_pool, new_pos, win),
        out.data_ptr(), *_dims(q, k_pool, table, win))
    build.check(err, "paged_decode_attention")
    launches += 1
    return out


def paged_decode_masses(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, mask_pool: torch.Tensor,
                        table: torch.Tensor, *,
                        pos_pool: Optional[torch.Tensor] = None,
                        new_pos: Optional[torch.Tensor] = None,
                        window=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5.  The arguments of kernel 4 -> (out (B, H, hd) in q's type,
    bitwise kernel 4's; masses (B, H, nb * bs) float32, exact zeros on
    masked rows and on a (sequence, kv head) with no attendable row)."""
    global mass_launches
    win = _check(q, k_pool, v_pool, mask_pool, table, pos_pool, new_pos,
                 window)
    B, H, _ = q.shape
    out = torch.empty_like(q)
    masses = torch.empty((B, H, table.shape[1] * k_pool.shape[1]),
                         dtype=torch.float32, device=q.device)
    err = build.library("paged_attention", "paged_decode_masses")(
        *_args(q, k_pool, v_pool, mask_pool, table, pos_pool, new_pos, win),
        out.data_ptr(), masses.data_ptr(), *_dims(q, k_pool, table, win))
    build.check(err, "paged_decode_masses")
    mass_launches += 1
    return out, masses
