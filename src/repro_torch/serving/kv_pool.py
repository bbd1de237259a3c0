"""Paged KV memory: a global device-resident block pool for decode caches.

The decode KV of every live request lives in fixed-size blocks drawn from
one shared pool; a request holds blocks only for rows it uses (kept
post-eviction rows plus the decode tokens so far), and retiring returns
them.  Better eviction -> fewer kept rows -> fewer blocks per request ->
more concurrent requests at a fixed ``--kv-pool-mb``.

Layout (per layer, stacked along a leading L axis): K and V pools of
``(num_blocks, block_size, kv_heads, head_dim)`` plus ``(num_blocks,
block_size, kv_heads)`` int32 ``pos`` and bool ``mask`` metadata —
eviction keeps different positions per kv head, so validity is per head.
A request's block table is a row of physical block ids: logical cache row
``c`` lives at ``(table[c // bs], c % bs)`` in every layer.

Block 0 is the reserved null block: never allocated, its mask rows stay
False, and unallocated table entries point at it, so a ragged table reads
as a cache whose missing rows are masked.

Allocation is host-side (a free list + per-block refcounts).  Device
writes go straight into the pool tensors, in place (the JAX package runs
jitted functional scatters and rebinds the arrays).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.transformer import torch_dtype

__all__ = ["KVBlockPool"]


class KVBlockPool:
    """Global paged KV store: device block tensors + a host free-list
    allocator.  Exactly one of ``num_blocks`` / ``pool_mb`` sizes it;
    ``pool_mb`` counts K+V payload bytes (the ``pos``/``mask`` metadata is
    reported separately in ``stats()``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        pool_mb: Optional[float] = None,
        device="cuda",
    ):
        if cfg.attn is None or block_size <= 0:
            raise ValueError("paged KV serves attention archs with "
                             "block_size > 0")
        a = cfg.attn
        L, KV, hd = cfg.num_layers, a.num_kv_heads, a.head_dim
        dtype = torch_dtype(cfg)
        self.block_size = block_size
        # K+V payload bytes of one block across all layers
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.block_bytes = 2 * L * block_size * KV * hd * itemsize
        if num_blocks is None:
            if pool_mb is None:
                raise ValueError("size the pool: num_blocks or pool_mb")
            num_blocks = int(pool_mb * (1 << 20)) // self.block_bytes
        num_blocks += 1  # block 0 is the reserved null block
        if num_blocks < 2:
            raise ValueError("pool too small for even one block")
        self.num_blocks = N = num_blocks
        self.device = torch.device(device)
        shape = (L, N, block_size, KV)
        self.k = torch.zeros(shape + (hd,), dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)
        self.pos = torch.zeros(shape, dtype=torch.int32, device=device)
        self.mask = torch.zeros(shape, dtype=torch.bool, device=device)
        # host allocator state: ids 1..N-1 are allocatable
        self._free: list[int] = list(range(N - 1, 0, -1))
        self._refs = np.zeros(N, np.int32)
        # blocks promised to admitted requests' future decode appends but
        # not yet handed out — ordinary allocs may not dip into them, so an
        # admitted request can always grow to its cap
        self.reserved = 0
        self.high_water = 0  # peak blocks in use over the pool's lifetime
        # tail blocks that decode-eviction sweeps returned mid-generation
        self.blocks_reclaimed_decode = 0

    # -- geometry ---------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # minus the null block

    def blocks_for(self, rows: int) -> int:
        """Blocks needed to hold ``rows`` logical cache rows."""
        return -(-max(rows, 0) // self.block_size)

    def free_blocks(self) -> int:
        return len(self._free)

    def available_blocks(self) -> int:
        """Free blocks not promised to an admitted request's growth."""
        return len(self._free) - self.reserved

    def used_blocks(self) -> int:
        return self.usable_blocks - len(self._free)

    # -- allocator --------------------------------------------------------
    def alloc(self, n: int, *,
              from_reserved: bool = False) -> Optional[np.ndarray]:
        """Take ``n`` blocks (refcount 1 each), or None if the free list
        cannot cover them.  Never partially allocates.  ``from_reserved``
        redeems part of an earlier ``reserve``."""
        assert n >= 0
        limit = len(self._free) if from_reserved \
            else len(self._free) - self.reserved
        if n > limit:
            return None
        if from_reserved:
            assert self.reserved >= n, "redeeming more than was reserved"
            self.reserved -= n
        ids = np.asarray([self._free.pop() for _ in range(n)], np.int32)
        self._refs[ids] = 1
        self.high_water = max(self.high_water, self.used_blocks())
        return ids

    def reserve(self, n: int) -> bool:
        """Promise ``n`` free blocks to a request's future appends; False
        when the unreserved headroom cannot cover the promise."""
        assert n >= 0
        if n > len(self._free) - self.reserved:
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        """Return an unredeemed promise (retirement)."""
        assert 0 <= n <= self.reserved
        self.reserved -= n

    def free(self, ids) -> None:
        """Drop one reference per block; blocks return to the free list at
        refcount zero.  Double-frees and the null block fail loudly."""
        for b in np.asarray(ids, np.int32).tolist():
            assert b != 0, "freeing the null block"
            assert self._refs[b] > 0, f"double-free of block {b}"
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(int(b))

    def free_run(self, ids) -> None:
        """Return a *partial* block run of a live request: the tail blocks
        a decode-eviction sweep compacted away mid-generation.  ``free``,
        counted apart as ``blocks_reclaimed_decode`` so eviction-driven
        reclaim is told from retirement frees."""
        ids = np.asarray(ids, np.int32)
        self.free(ids)
        self.blocks_reclaimed_decode += len(ids)

    # -- device views -----------------------------------------------------
    def tree(self) -> dict:
        """The pool tensors as the dict the paged decode step writes into
        (in place) and reads from."""
        return {"k": self.k, "v": self.v, "pos": self.pos, "mask": self.mask}

    def write_cache(self, attn_cache: dict, ids: np.ndarray) -> None:
        """Scatter an admitted request's decode cache (the
        ``prefill_finalize`` output: k/v (L, 1, C, KV, hd), pos/mask
        (L, 1, C, KV)) into blocks ``ids`` — rows [0, len(ids)·bs); rows
        past C pad with mask False."""
        n = len(ids)
        assert n > 0
        rows = n * self.block_size
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        for name, pool in self.tree().items():
            x = attn_cache[name][:, 0]
            C = x.shape[1]
            if C < rows:
                pad = torch.zeros((x.shape[0], rows - C) + tuple(x.shape[2:]),
                                  dtype=x.dtype, device=x.device)
                x = torch.cat([x, pad], dim=1)
            x = x[:, :rows].reshape((x.shape[0], n, self.block_size)
                                    + tuple(x.shape[2:]))
            pool[:, idx] = x.to(pool.dtype)  # in place

    def zero_mask(self, ids) -> None:
        """Invalidate every row of blocks ``ids`` — required when a freed
        block is reallocated as a decode append block, whose previous
        owner's mask rows would otherwise read as valid."""
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                              device=self.device)
        self.mask[:, idx] = False  # in place

    # -- observability ----------------------------------------------------
    def check(self) -> None:
        """Allocator invariants: the pool is conserved, the free list holds
        no duplicates or live blocks, the null block is never handed out."""
        assert len(set(self._free)) == len(self._free), "free-list duplicate"
        assert 0 not in self._free, "null block on the free list"
        assert (self._refs[self._free] == 0).all(), "live block marked free"
        live = int((self._refs[1:] > 0).sum())
        assert live + len(self._free) == self.usable_blocks, "pool leak"
        assert 0 <= self.reserved <= len(self._free), "reservation overhang"
        assert self._refs[0] == 0

    def stats(self) -> dict:
        used = self.used_blocks()
        return {
            "block_size": self.block_size,
            "block_bytes": self.block_bytes,
            "blocks_total": self.usable_blocks,
            "blocks_used": used,
            "blocks_free": len(self._free),
            "blocks_reserved": self.reserved,
            "high_water_blocks": self.high_water,
            "bytes_total": self.usable_blocks * self.block_bytes,
            "bytes_used": used * self.block_bytes,
            "bytes_high_water": self.high_water * self.block_bytes,
            "metadata_bytes": (self.pos.numel() * 4 + self.mask.numel()),
            "blocks_reclaimed_decode": self.blocks_reclaimed_decode,
        }
