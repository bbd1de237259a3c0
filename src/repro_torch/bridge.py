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
