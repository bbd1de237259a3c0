"""Small tree utilities over the port's parameter trees: nested dicts
(and lists or tuples) of tensors, ``None`` an empty subtree as in JAX.
Parameter counting, dtype casting, tree maps with '/'-joined paths
(``layers/attn/wq``), the global norm and a finiteness check: the JAX
package's ``common/pytree.py`` over ``torch`` leaves."""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_leaves(tree: Any) -> list:
    """The leaves in JAX's order: dict entries by sorted key, lists and
    tuples by index."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest)`` over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, _path: str = "") -> Any:
    """``fn(path_str, leaf)`` -> new leaf; ``path_str`` like
    ``layers/attn/wq`` (list and tuple entries by index)."""
    if tree is None:
        return None
    if isinstance(tree, (dict, list, tuple)):
        items = (tree.items() if isinstance(tree, dict)
                 else enumerate(tree))
        out = {k: tree_map_with_path(
            fn, v, f"{_path}/{k}" if _path else str(k)) for k, v in items}
        return out if isinstance(tree, dict) else type(tree)(out.values())
    return fn(_path, tree)


def tree_size(tree: Any) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda x: x.to(dtype), tree)


def tree_zeros_like(tree: Any, dtype=None) -> Any:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (the leaves summed in order, as the JAX package's Python ``sum``)."""
    total = torch.zeros((), dtype=torch.float32)
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float())).cpu()
    return torch.sqrt(total)


def check_finite(tree: Any) -> torch.Tensor:
    """True iff every leaf is finite everywhere."""
    oks = [bool(torch.isfinite(x).all()) for x in tree_leaves(tree)]
    return torch.tensor(all(oks))
