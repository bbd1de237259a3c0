"""Carry parameter trees across from the JAX package.

The port keeps the JAX package's tree layout (same keys, per-layer leaves
stacked on a leading L axis), so a tree of numpy arrays — what
``jax.tree.map(np.asarray, params)`` gives for the model parameters or
the lookahead modules — maps leaf for leaf onto tensors, and both
packages then compute the same function.  bfloat16 leaves (numpy's
``ml_dtypes.bfloat16``) are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    a = np.array(x)  # a private, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def to_torch(tree, *, device="cuda"):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device=device) for k, v in tree.items()}
    return _leaf(tree, device)


def shard_to_torch(tree, cfg, mesh, *, device="cuda", rank=None):
    """The JAX package's full numpy parameter tree -> one rank's shard
    (``rank``, by default the mesh's own) on ``device``, in the layout of
    the tensor-parallel serving path (``common.sharding.serving_specs``):
    ``to_torch``, then ``shard_tree``."""
    from repro_torch.common.sharding import serving_specs, shard_tree

    return shard_tree(to_torch(tree, device=device), serving_specs(cfg, mesh),
                      mesh, mesh.rank if rank is None else rank)


def decode_cache_to_torch(tree, *, device="cuda", cfg=None, mesh=None,
                          rank=None, hot_slots: int = 0) -> dict:
    """The JAX package's dense decode cache (``jax.tree.map(np.asarray,
    cache)``; a split cache with its hot ring too) -> the port's: the
    same leaves as tensors on ``device`` and a scalar cursor as a Python
    int, as the port's lockstep cursor.  With ``mesh`` (and ``cfg``), one
    rank's block (``rank``, by default the mesh's own) in the layout of
    ``init_decode_cache(mesh=)`` (``sharding.serving_cache_specs``), the
    frozen rows' axis noted as the port's cache notes it."""
    out = {}
    for k, v in tree.items():
        if k == "cursor" and np.ndim(v) == 0:
            out[k] = int(v)
        elif isinstance(v, dict):
            out[k] = to_torch(v, device=device)
        else:
            out[k] = _leaf(v, device)
    if mesh is None:
        return out
    from repro_torch.common.sharding import (frozen_rows_axis,
                                             serving_cache_specs,
                                             shard_tree)

    rank = mesh.rank if rank is None else rank
    k = out["attn"]["k"]
    batch, capacity = k.shape[1], k.shape[2]
    specs = serving_cache_specs(cfg, mesh, batch, capacity, hot_slots)
    tensors = {n: v for n, v in out.items() if n != "cursor"}
    local = shard_tree(tensors, {n: specs[n] for n in tensors}, mesh, rank)
    local["cursor"] = out["cursor"]
    axis = frozen_rows_axis(cfg, mesh, batch, capacity) if hot_slots \
        else None
    if axis is not None:
        local["frozen_axis"] = axis
    return local
