"""Flat-npz checkpoints of tensor trees, in the JAX package's layout.

A tree (nested dicts, lists, tuples and NamedTuples such as
``optim.adam.AdamState``, with tensors at the leaves) is flattened to
``path -> array`` with '/'-joined keys: dicts in sorted key order,
sequences in numeric order (a NamedTuple is the tuple of its fields, so
``AdamState`` is ``opt/0``, ``opt/1/...``, ``opt/2/...``), which is the
leaf order of ``jax.tree.flatten``.  So a file written by either package
loads in the other, bit for bit.

On-disk layout: the arrays are members ``a0, a1, ...`` of one npz, and
the path keys ride a ``__keys__`` JSON manifest (aligned by index), the
dtypes a ``__dtypes__`` one and an optional ``__meta__`` dict a third.
bfloat16 is stored as its uint16 bits (no ``ml_dtypes``: the tensor's
bits are viewed as int16).  Files of the older layout (path keys mangled
``"/" -> "__"``, no ``__keys__``) still load when their keys are
unambiguous.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict:
    """Path-keyed leaves in the JAX package's leaf order: dicts sorted,
    sequences numerically, so the dict's insertion order is the tree's
    leaf order."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(host array, dtype name) of a leaf; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path: str, tree: Any, *, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes, keys = {}, {}, []
    for i, (k, v) in enumerate(_flatten(tree).items()):
        arrays[f"a{i}"], dtypes[k] = _to_numpy(v)
        keys.append(k)
    arrays["__keys__"] = np.frombuffer(json.dumps(keys).encode(),
                                       dtype=np.uint8)
    arrays["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(),
                                         dtype=np.uint8)
    if metadata:
        arrays["__meta__"] = np.frombuffer(json.dumps(metadata).encode(),
                                           dtype=np.uint8)
    np.savez(path, **arrays)


def _load_flat(path: str, device) -> dict:
    with np.load(path) as z:
        dtypes = json.loads(bytes(z["__dtypes__"]).decode())
        if "__keys__" in z.files:
            keys = json.loads(bytes(z["__keys__"]).decode())
            members = {k: f"a{i}" for i, k in enumerate(keys)}
        else:
            # older layout: path keys mangled "/" -> "__" (ambiguous for
            # keys that contain "__"; such files predate the manifest)
            members = {k.replace("__", "/"): k
                       for k in z.files if not k.startswith("__")}
        flat = {}
        for path_key, member in members.items():
            a = np.array(z[member])  # a private, writable copy
            if dtypes[path_key] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            flat[path_key] = t.to(device)
    return flat


def unflatten(flat: dict, like: Any) -> Any:
    """Rebuild ``like``'s structure from a ``{path: tensor}`` dict (shapes
    checked leaf by leaf; ``like``'s leaves give only their shapes)."""
    ref = _flatten(like)
    if set(ref) != set(flat):
        raise ValueError(f"checkpoint/tree mismatch: {set(ref) ^ set(flat)}")
    for k, leaf in ref.items():
        if tuple(leaf.shape) != tuple(flat[k].shape):
            raise ValueError(f"checkpoint/tree mismatch at {k}: shape "
                             f"{tuple(flat[k].shape)}, expected "
                             f"{tuple(leaf.shape)}")

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [build(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            if hasattr(node, "_fields"):  # a NamedTuple
                return type(node)(*items)
            return type(node)(items)
        return flat[prefix[:-1]]

    return build(like, "")


def load(path: str, like: Any = None, *, device="cpu") -> Any:
    """Restore onto ``device``.  With ``like`` given, unflatten into its
    structure (and check shapes); otherwise return the flat {path:
    tensor} dict."""
    flat = _load_flat(path, device)
    if like is None:
        return flat
    return unflatten(flat, like)


def metadata(path: str) -> dict:
    with np.load(path) as z:
        if "__meta__" in z.files:
            return json.loads(bytes(z["__meta__"]).decode())
    return {}
