"""Logical -> physical sharding rules, path-driven: the JAX package's
``common/sharding.py`` with its ``PartitionSpec``s as plain tuples, entry
for entry (``None``, an axis name, or a tuple of axis names per dim).

``param_specs(cfg, mesh)`` mirrors the parameter tree:

* attention q/o projections shard the head dim on "model" when the head
  count divides the axis (GQA: k/v shard only when kv heads divide);
* the MLP shards d_ff column -> row;
* MoE experts shard the expert dim on "model";
* embeddings shard vocab when divisible, else d_model, else replicate;
* ``cfg.fsdp`` also shards the d_model dim of big weights over "data";
* Mamba-2, norms and scalars replicate.

The tensor-parallel serving path holds each rank's shard of a tree
(``shard_tree``: each leaf's contiguous slice along every dim its spec
puts on a mesh axis) in ``serving_specs``' layout.  That is
``param_specs`` but for the two row-parallel weights, the attention
``wo`` and the dense MLP's ``w_down``, which it keeps column-sliced: the
JAX helpers take them in that layout (``sharded_wo_linear`` and
``mlp.apply_sharded``'s ``P(None, "model")`` in-specs, which re-lay the
row-sharded weights out at every call), so that each product contracts
its full input in single-device order.  Storing them so once costs
nothing per call.  Three more rules of the serving layout:

* ``cfg.fsdp``: the big weights' "data" dims of ``param_specs`` (ZeRO-3
  storage); ``wo`` and ``w_down``, whose d_model dim holds "model", put
  "data" on their other dim.  ``layer_gathers`` says what a layer
  all-gathers at use: every "data" dim, so that each product runs on
  the whole weight (a gather does no arithmetic, so it is exact).
* MoE: the expert dim on "model" and the shared experts by their own
  rule, as ``param_specs``; ``layer_gathers`` gathers the whole "moe"
  subtree over "model" too, and every rank runs the layer whole (JAX's
  ``replicated_apply``).
* heads that do not divide the model axis: every layer runs whole on
  every rank (JAX's ``model_shard_mesh`` fallback), so nothing is on
  "model"; the "data" dims stay.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.pytree import tree_map, tree_map_with_path


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def param_specs(cfg: ModelConfig, mesh, *,
                embed_replicated: bool = False) -> Any:
    """Spec tree mirroring the parameter tree (with the JAX package's qkv
    bias leaves where ``cfg.attn.qkv_bias``).  ``embed_replicated``: the
    dp_all variant (batch over data and model, so vocab sharding would
    conflict at the unembed)."""
    msize = mesh.shape["model"]
    dsize = mesh.shape["data"]
    a = cfg.attn
    fsdp = "data" if (cfg.fsdp and _div(cfg.d_model, dsize)) else None

    shard_q = a is not None and _div(a.num_heads, msize)
    shard_kv = a is not None and _div(a.num_kv_heads, msize)
    shard_ff = _div(cfg.d_ff, msize)
    shard_exp = cfg.moe is not None and _div(cfg.moe.num_experts, msize)
    shard_shared = (cfg.moe is not None and
                    _div(cfg.moe.num_shared_experts * cfg.moe.d_expert,
                         msize))
    if embed_replicated:
        embed_spec = (None, None)
    elif _div(cfg.padded_vocab, msize):
        embed_spec = ("model", None)
    elif _div(cfg.d_model, msize):
        embed_spec = (None, "model")
    else:
        embed_spec = (None, None)
    q_ax = "model" if shard_q else None
    kv_ax = "model" if shard_kv else None

    def rule(path: str, leaf) -> tuple:
        parts = path.split("/")
        name = parts[-1]
        pre = (None,) if "layers" in parts else ()  # the stacked L axis
        if name == "embed":
            return embed_spec
        if name == "lm_head":
            return embed_spec[::-1]
        if name == "pos_emb":
            return (None, None)
        if name == "wq":
            return (*pre, fsdp, q_ax)
        if name in ("wk", "wv"):
            return (*pre, fsdp, kv_ax)
        if name == "wo":
            return (*pre, q_ax, fsdp)
        if name == "bq":
            return (*pre, q_ax)
        if name in ("bk", "bv"):
            return (*pre, kv_ax)
        if "experts" in parts:
            e_ax = "model" if shard_exp else None
            if name in ("w_gate", "w_up"):
                return (*pre, e_ax, fsdp, None)
            if name == "w_down":
                return (*pre, e_ax, None, fsdp)
        if name == "router":
            return (*pre, fsdp, None)
        if "shared" in parts:
            s_ax = "model" if shard_shared else None
            if name in ("w_gate", "w_up"):
                return (*pre, fsdp, s_ax)
            if name == "w_down":
                return (*pre, s_ax, fsdp)
        if name in ("w_gate", "w_up"):
            return (*pre, fsdp, "model" if shard_ff else None)
        if name == "w_down":
            return (*pre, "model" if shard_ff else None, fsdp)
        # Mamba-2, norms, scalars, anything unmatched: replicate
        return (None,) * leaf.dim()

    return tree_map_with_path(rule, _as_shaped(cfg))


def _as_shaped(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the port's ``init_params`` on the meta
    device), with the zero qkv biases the JAX package's init adds and the
    port's leaves out (a missing bias is a zero one)."""
    from repro_torch.models import transformer as tf

    params = tf.init_params(cfg, device="meta")
    a = cfg.attn
    if a is not None and a.qkv_bias:
        blocks = [params["layers"]]
        if "encoder" in params:
            blocks.append(params["encoder"]["layers"])
        for blk in blocks:
            L = blk["ln1"].shape[0]
            for name, dim in (("bq", a.q_dim), ("bk", a.kv_dim),
                              ("bv", a.kv_dim)):
                blk["attn"][name] = torch.empty(
                    (L, dim), dtype=blk["attn"]["wq"].dtype, device="meta")
    return params


def serving_specs(cfg: ModelConfig, mesh) -> Any:
    """The layout of one rank's shard on the tensor-parallel serving path:
    ``param_specs`` with ``wo`` and the dense MLP's ``w_down``
    column-sliced (the JAX helpers' in-specs; under ``cfg.fsdp`` "data"
    moves to their other dim, where it divides), the MLP replicated where
    d_ff does not divide the model axis (``mlp.apply_sharded``'s
    fallback), and the embedding replicated unless it shards by vocab
    rows (the unembed then contracts the full d_model).  Where the heads
    do not divide the model axis nothing is on "model" (the layers run
    whole on every rank).  Heads that divide with a d_model that does not
    raise ValueError: the column-sliced products need it."""
    msize = mesh.shape["model"]
    dsize = mesh.shape.get("data", 1)
    a = cfg.attn  # heads shard as ``attention.model_shard_mesh`` asks
    tp = (msize > 1 and a is not None and _div(a.num_heads, msize)
          and _div(a.num_kv_heads, msize))
    if tp and not _div(cfg.d_model, msize):
        raise ValueError(f"{cfg.name}: tensor-parallel serving over "
                         f"{msize} model shards needs a d_model that "
                         "divides it")
    mlp_sharded = _div(cfg.d_ff, msize)
    specs = param_specs(cfg, mesh)
    shaped = _as_shaped(cfg)

    def fix(path: str, leaf) -> tuple:
        parts = path.split("/")
        spec = specs
        for k in parts:
            spec = spec[k]
        name = parts[-1]
        if not tp:
            return tuple(None if e == "model" else e for e in spec)
        if name in ("embed", "lm_head") and "model" not in (
                spec[0] if name == "embed" else spec[1],):
            return (None, None)
        if "mlp" in parts and not mlp_sharded:
            return tuple("data" if e == "data" else None for e in spec)
        if name == "wo" or (name == "w_down" and "mlp" in parts):
            fsdp = "data" in spec and _div(leaf.shape[-2], dsize)
            return (*spec[:-2], "data" if fsdp else None, "model")
        return spec

    return tree_map_with_path(fix, shaped)


class _ShapeMesh:
    """A mesh's shape alone, for the cached rules below."""

    def __init__(self, sig: tuple):
        self.axis_names = tuple(n for n, _ in sig)
        self.shape = dict(sig)


@functools.lru_cache(maxsize=32)
def _layer_gathers(cfg: ModelConfig, sig: tuple, stack: tuple) -> tuple:
    sizes = dict(sig)
    specs = serving_specs(cfg, _ShapeMesh(sig))
    for k in stack:
        specs = specs[k]
    out = []

    def walk(tree, path):
        for k, v in tree.items():
            p = (*path, k)
            if isinstance(v, dict):
                walk(v, p)
                continue
            dims = tuple((d - 1, e) for d, e in enumerate(v)
                         if (e == "data" or (e == "model" and "moe" in p))
                         and sizes[e] > 1)
            if dims:
                out.append((p, dims))

    walk(specs, ())
    return tuple(out)


def layer_gathers(cfg: ModelConfig, mesh,
                  stack: tuple = ("layers",)) -> tuple:
    """What one layer's leaves gather at use on the serving path:
    ((path keys, ((dim of the per-layer leaf, axis), ...)), ...): every
    "data" dim (ZeRO storage), and the "model" dims of the MoE subtree
    (its layer runs whole on every rank).  ``stack`` is the stacked
    layers' path in the tree (``("encoder", "layers")``: whisper's
    encoder blocks).  Empty without a mesh."""
    sig = mesh_signature(mesh)
    if sig is None:
        return ()
    return _layer_gathers(cfg, sig, tuple(stack))


def lkv_specs(lkv_shapes: Any) -> Any:
    """Lookahead params replicate everywhere (tiny: <0.5% of the model)."""
    return tree_map(lambda x: (None,) * x.dim(), lkv_shapes)


def batch_axes(mesh) -> tuple:
    return tuple(n for n in mesh.axis_names if n != "model")


def _entry(axes: tuple):
    """One dim's entry as ``PartitionSpec`` normalises it: None for no
    axis, the name for one, the tuple for several."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def cache_specs(cfg: ModelConfig, mesh, batch: int, capacity: int,
                hot_slots: int = 0) -> dict:
    """Specs of the dense decode cache: batch over the data axes; kv heads
    on "model" when divisible, else the sequence dim (sequence-parallel
    decode); with ``hot_slots`` the split cache's replicated hot ring."""
    dp = batch_axes(mesh)
    msize = mesh.shape["model"]
    dp_total = 1
    for x in dp:
        dp_total *= mesh.shape[x]
    bshard = dp if _div(batch, dp_total) else (
        ("data",) if _div(batch, mesh.shape["data"]) else ())
    bspec = _entry(bshard)
    a = cfg.attn
    specs: dict = {}
    if a is not None:
        if _div(a.num_kv_heads, msize):
            kv_s, seq_s = "model", None
        elif _div(capacity, msize):
            kv_s, seq_s = None, "model"
        else:
            kv_s = seq_s = None
        if batch == 1 and seq_s is not None:
            # long-context decode: the cache sequence over everything
            seq_s = _entry(tuple(list(dp) + ["model"]))
            bspec = None
        specs["attn"] = {
            "k": (None, bspec, seq_s, kv_s, None),
            "v": (None, bspec, seq_s, kv_s, None),
            "pos": (None, bspec, seq_s, kv_s),
            "mask": (None, bspec, seq_s, kv_s),
        }
        if hot_slots:
            specs["attn"].update({
                "hot_k": (None, bspec, None, None, None),
                "hot_v": (None, bspec, None, None, None),
                "hot_pos": (None, bspec, None, None),
                "hot_mask": (None, bspec, None, None),
            })
        specs["cursor"] = ()
    if cfg.uses_ssm:
        specs["ssm"] = {"conv": (None, bspec, None, None),
                        "state": (None, bspec, None, None, None)}
    if cfg.is_encoder_decoder:
        specs["cross"] = {"k": (None, bspec, None, None, None),
                          "v": (None, bspec, None, None, None)}
    specs["next_pos"] = (bspec, None)
    return specs


def pool_specs(cfg: ModelConfig, mesh) -> Optional[dict]:
    """Specs of the paged KV block pool (L, blocks, block_size, KV[, hd]):
    only the kv-head dim shards, on "model", so blocks are whole on every
    shard and the host allocator and block tables stay the same on every
    rank.  None without a "model" axis or when kv heads do not divide."""
    a = cfg.attn
    if a is None or mesh is None:
        return None
    if "model" not in getattr(mesh, "axis_names", ()):
        return None
    if not _div(a.num_kv_heads, mesh.shape["model"]):
        return None
    return {"k": (None, None, None, "model", None),
            "v": (None, None, None, "model", None),
            "pos": (None, None, None, "model"),
            "mask": (None, None, None, "model")}


def mesh_signature(mesh) -> Optional[tuple]:
    """Hashable mesh identity, ``(("data", 4), ("model", 2))``; None for
    no mesh or an all-1 mesh."""
    if mesh is None:
        return None
    sig = tuple((n, int(mesh.shape[n])) for n in mesh.axis_names)
    if all(s == 1 for _, s in sig):
        return None
    return sig


def axis_coords(mesh, rank: int) -> dict:
    """{axis name: index} of global rank ``rank`` (row-major, as
    ``jax.make_mesh`` lays devices out)."""
    coords = {}
    for name, size in reversed(tuple(mesh.shape.items())):
        coords[name] = rank % size
        rank //= size
    return coords


def shard_bounds(shape: tuple, spec: tuple, mesh, rank: int) -> tuple:
    """Rank ``rank``'s block of a leaf of ``shape`` laid out by ``spec``:
    ((start, size), ...) per dim, each dim's contiguous slice along the
    mesh axes its spec entry names (several axes on one dim combine
    row-major).  Raises where a sharded dim does not divide."""
    at = axis_coords(mesh, rank)
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = entry if isinstance(entry, tuple) else (entry,)
        n, i = 1, 0
        for name in names:
            if name is not None:
                n, i = n * mesh.shape[name], i * mesh.shape[name] + at[name]
        if size % n:
            raise ValueError(f"dim {d} of size {size} does not divide "
                             f"{n} shards of {names}")
        w = size // n
        out.append((i * w, w))
    return tuple(out)


def shard_tree(tree: Any, specs: Any, mesh, rank: int) -> Any:
    """Rank ``rank``'s shard of ``tree``: each leaf's block
    (``shard_bounds``), a copy, so the full leaf can be freed; leaves
    whose spec shards nothing as they are.  Concatenating the shards of
    the ranks along an axis, in their order on it, gives back the tree
    sharded on the other axes."""

    def take(leaf, spec):
        out = leaf
        for d, (start, size) in enumerate(shard_bounds(
                tuple(leaf.shape), spec, mesh, rank)):
            if size != leaf.shape[d]:
                out = out.narrow(d, start, size)
        return leaf if out is leaf else out.clone()

    return tree_map(take, tree, specs)


def serving_cache_specs(cfg: ModelConfig, mesh, batch: int, capacity: int,
                        hot_slots: int = 0) -> dict:
    """The layout of one rank's dense decode cache on the port's path
    (``transformer.init_decode_cache(mesh=)``).

    * Without ``hot_slots``: the kv-head dim on "model" where the heads
      shard (``attention.model_shard_mesh``), every other dim whole (the
      engines split slots over data rows at decode time, not in storage).
    * With ``hot_slots`` (the split-cache decode): ``cache_specs``, so
      the frozen rows shard by kv heads, else by sequence over "model",
      and the batch over the data axes; the hot ring as ``cache_specs``
      has it but on the kv heads' axis where they shard (a rank computes
      its own heads' K/V only, so a replicated ring would need a gather
      every step; JAX's is replicated).
    """
    a = cfg.attn
    msize = mesh.shape.get("model", 1)
    heads = (a is not None and msize > 1 and _div(a.num_heads, msize)
             and _div(a.num_kv_heads, msize))
    if not hot_slots:
        kv = "model" if heads else None
        specs: dict = {}
        if a is not None:
            specs["attn"] = {"k": (None, None, None, kv, None),
                             "v": (None, None, None, kv, None),
                             "pos": (None, None, None, kv),
                             "mask": (None, None, None, kv)}
            specs["cursor"] = ()
        if cfg.uses_ssm:
            specs["ssm"] = {"conv": (None,) * 4, "state": (None,) * 5}
        if cfg.is_encoder_decoder:
            specs["cross"] = {n: (None, None, None, kv, None)
                              for n in ("k", "v")}
        specs["next_pos"] = (None, None)
        return specs
    specs = cache_specs(cfg, mesh, batch, capacity, hot_slots=hot_slots)
    if heads:
        for group, names in (("attn", ("hot_k", "hot_v", "hot_pos",
                                       "hot_mask")), ("cross", ("k", "v"))):
            for n in names if group in specs else ():
                sp = list(specs[group][n])
                sp[3] = "model"
                specs[group][n] = tuple(sp)
    return specs


def frozen_rows_axis(cfg: ModelConfig, mesh, batch: int, capacity: int):
    """The mesh axis (a name, or a tuple of names) that
    ``serving_cache_specs`` lays the split cache's frozen rows along, or
    None where each rank holds them whole (by kv heads or replicated)."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    if "attn" not in (specs := cache_specs(cfg, mesh, batch, capacity)):
        return None
    return specs["attn"]["k"][2]
