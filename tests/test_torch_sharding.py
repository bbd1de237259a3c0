"""The port's sharding rules, meshes and tree helpers against the JAX
package's (ROADMAP A11).

* ``param_specs`` (and with ``embed_replicated``), ``cache_specs`` (with
  and without the split cache's ``hot_slots``), ``pool_specs``,
  ``lkv_specs`` and ``mesh_signature`` equal JAX's leaf by leaf, every
  ``PartitionSpec`` as a tuple, for every arch of the JAX registry on the
  production meshes (16, 16) and (2, 16, 16) and the host meshes (1, 2)
  and (1, 4); ``jax.sharding.AbstractMesh`` feeds the JAX functions with
  no devices.
* ``common/pytree.py`` equals JAX's on a bridged parameter tree.
  (Random leaves of the JAX trees' shapes stand in for drawn weights.)
* ``shard_tree``'s shards, concatenated in rank order, give the bridged
  full tree back (llama3-smoke, and qwen2-smoke with its qkv biases), in
  ``param_specs``' layout and in the serving layout.
* ``make_host_mesh`` refuses a model axis that does not divide the world.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.common import pytree as jpytree
from repro.common import sharding as jsharding
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.common import pytree, sharding
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import mesh as tmesh

#: (JAX axis shape, names)
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "host2": ((1, 2), ("data", "model")),
          "host4": ((1, 4), ("data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), tmesh.Mesh(names, shape)


def _flat_jax(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


def _flat_port(tree, path="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, f"{path}/{k}" if path else str(k)))
        return out
    return {path: tree}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_jax(mesh):
    jm, tm = _meshes(mesh)
    for arch in ARCH_IDS:
        for kw in ({}, {"embed_replicated": True}):
            want = _flat_jax(jsharding.param_specs(jax_config(arch), jm,
                                                   **kw))
            got = _flat_port(sharding.param_specs(get_config(arch), tm,
                                                  **kw))
            assert got == want, (arch, mesh, kw)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_pool_specs_and_signature_match_jax(mesh):
    jm, tm = _meshes(mesh)
    assert sharding.mesh_signature(tm) == jsharding.mesh_signature(jm)
    assert sharding.batch_axes(tm) == jsharding.batch_axes(jm)
    for arch in ARCH_IDS:
        jc, tc = jax_config(arch), get_config(arch)
        for batch, cap in ((1, 4096), (8, 1000), (32, 4096), (3, 7)):
            for hot in (0, 64):
                want = _flat_jax(jsharding.cache_specs(jc, jm, batch, cap,
                                                       hot_slots=hot))
                got = _flat_port(sharding.cache_specs(tc, tm, batch, cap,
                                                      hot_slots=hot))
                assert got == want, (arch, mesh, batch, cap, hot)
        jp = jsharding.pool_specs(jc, jm)
        tp = sharding.pool_specs(tc, tm)
        assert (tp is None) == (jp is None), arch
        if jp is not None:
            assert tp == {k: tuple(v) for k, v in jp.items()}, arch


def test_trivial_meshes_and_lkv_specs():
    assert sharding.mesh_signature(None) is None
    assert sharding.mesh_signature(tmesh.Mesh(("data", "model"),
                                              (1, 1))) is None
    assert sharding.pool_specs(get_smoke_config("llama3-8b"), None) is None
    cfg = jax_smoke("llama3-8b")
    jl = jax.eval_shape(lambda: jax_init_lkv(
        jax.random.PRNGKey(1), cfg,
        jtf.init_params(jax.random.PRNGKey(0), cfg)["layers"]))
    tl = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"), jl)
    assert _flat_port(sharding.lkv_specs(tl)) == \
        _flat_jax(jsharding.lkv_specs(jl))


def test_production_and_host_meshes():
    pod, multi = tmesh.make_production_mesh(), \
        tmesh.make_production_mesh(multi_pod=True)
    assert (pod.axis_names, pod.shape) == (("data", "model"),
                                           {"data": 16, "model": 16})
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.data_axes(multi) == ("pod", "data")
    assert tmesh.axis_size(multi, "pod") == 2 and multi.size == 512
    host = tmesh.make_host_mesh()  # no process group: a world of one
    assert host.shape == {"data": 1, "model": 1} and host.group is None
    assert host.model_index == 0
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(model=2)


def _random_tree(arch) -> dict:
    """Random float32 numpy leaves of the JAX package's smoke parameter
    tree (its shapes from ``jax.eval_shape``, qkv biases included)."""
    cfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), shapes)


def test_pytree_helpers_match_jax():
    tree = _random_tree("qwen2-1.5b")
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.to_torch(tree, device="cpu")
    assert pytree.tree_size(tp) == jpytree.tree_size(jp)
    assert pytree.tree_bytes(tp) == jpytree.tree_bytes(jp)
    half = pytree.tree_cast(tp, torch.bfloat16)
    assert pytree.tree_bytes(half) == jpytree.tree_bytes(
        jpytree.tree_cast(jp, jnp.bfloat16))
    got = _flat_port(pytree.tree_map_with_path(lambda p, x: p, tp))
    want = jpytree.tree_map_with_path(lambda p, x: p, jp)
    assert got == _flat_port(want)
    assert all(k == v for k, v in got.items())
    np.testing.assert_allclose(float(pytree.global_norm(tp)),
                               float(jpytree.global_norm(jp)), rtol=1e-6)
    assert bool(pytree.check_finite(tp)) and bool(jpytree.check_finite(jp))
    tp["final_norm"][0] = float("nan")
    assert not bool(pytree.check_finite(tp))
    assert bool(pytree.check_finite({}))
    twice = pytree.tree_add(tp, pytree.tree_scale(tp, 1.0))
    assert torch.equal(twice["embed"], tp["embed"] * 2)
    assert pytree.tree_size(pytree.tree_zeros_like(tp)) == \
        pytree.tree_size(tp)


def _model_dim(spec: tuple):
    """The dim a spec puts on "model", or None."""
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            return d
    return None


def _concat_shards(shards, specs):
    def cat(path, spec):
        leaves = []
        for sh in shards:
            x = sh
            for k in path.split("/"):
                x = x[k]
            leaves.append(x)
        d = _model_dim(spec)
        return leaves[0] if d is None else torch.cat(leaves, dim=d)

    flat = _flat_port(specs)
    return {p: cat(p, s) for p, s in flat.items()}


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-1.5b"])
@pytest.mark.parametrize("layout", ["param_specs", "serving_specs"])
def test_shard_tree_round_trip(arch, layout):
    """Each rank's shard of the bridged JAX tree, concatenated in rank
    order along its model dim, is the full tree; a sharded leaf is a
    contiguous copy of the rank's slice."""
    full_np = _random_tree(arch)
    full = _flat_port(bridge.to_torch(full_np, device="cpu"))
    tcfg = get_smoke_config(arch)
    m = tmesh.Mesh(("data", "model"), (1, 2))
    specs = getattr(sharding, layout)(tcfg, m)
    if layout == "serving_specs":
        shards = [bridge.shard_to_torch(full_np, tcfg, m, device="cpu",
                                        rank=r) for r in range(2)]
    else:
        tree = bridge.to_torch(full_np, device="cpu")
        shards = [sharding.shard_tree(tree, specs, m, r) for r in range(2)]
    assert set(_flat_port(specs)) == set(full)  # biases included
    back = _concat_shards(shards, specs)
    assert set(back) == set(full)
    n_sharded = 0
    for p, x in full.items():
        assert torch.equal(back[p], x), p
        if _model_dim(_flat_port(specs)[p]) is not None:
            n_sharded += 1
            assert _flat_port(shards[1])[p].is_contiguous()
    assert n_sharded >= 6
    if layout == "serving_specs":  # wo and w_down by output columns
        attn = _flat_port(specs)
        assert attn["layers/attn/wo"] == (None, None, "model")
        assert attn["layers/mlp/w_down"] == (None, None, "model")
        assert attn["embed"] == ("model", None)


def _place(shards, specs, mesh, like):
    """The full leaf rebuilt from every rank's shard: each shard written
    at its slice of every dim its spec puts on a mesh axis."""
    full = torch.empty_like(like)
    for r, sh in enumerate(shards):
        at = sharding.axis_coords(mesh, r)
        index = []
        for d, entry in enumerate(specs):
            if entry is None or mesh.shape[entry] == 1:
                index.append(slice(None))
                continue
            w = like.shape[d] // mesh.shape[entry]
            index.append(slice(at[entry] * w, (at[entry] + 1) * w))
        full[tuple(index)] = sh
    return full


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "gemma3-1b"])
def test_shard_tree_over_data_and_experts(arch):
    """On a (2, 2) mesh with ``fsdp``: every rank's serving shard written
    back at its (data, model) slice gives the full tree; the big weights
    are stored ZeRO over "data", deepseek's experts (and shared experts)
    on "model", and gemma3's heads (4 q / 1 kv), which divide nothing,
    leave nothing on "model".  ``layer_gathers`` names exactly the
    per-layer "data" dims and the MoE's "model" dims."""
    full_np = _random_tree(arch)
    full = _flat_port(bridge.to_torch(full_np, device="cpu"))
    cfg = dataclasses.replace(get_smoke_config(arch), fsdp=True)
    m = tmesh.Mesh(("data", "model"), (2, 2))
    specs = _flat_port(sharding.serving_specs(cfg, m))
    shards = [_flat_port(bridge.shard_to_torch(full_np, cfg, m,
                                               device="cpu", rank=r))
              for r in range(4)]
    for p, x in full.items():
        assert torch.equal(_place([s[p] for s in shards], specs[p], m, x),
                           x), p
    assert specs["layers/attn/wq"][1] == "data"
    gathers = dict(sharding.layer_gathers(cfg, m))
    if arch == "deepseek-moe-16b":
        assert specs["layers/moe/experts/w_gate"] == (None, "model", "data",
                                                      None)
        assert specs["layers/moe/shared/w_down"] == (None, "model", "data")
        assert specs["layers/attn/wq"] == (None, "data", "model")
        # column-sliced on d_model, so ZeRO takes the q dim
        assert specs["layers/attn/wo"] == (None, "data", "model")
        assert gathers[("moe", "experts", "w_gate")] == ((0, "model"),
                                                         (1, "data"))
        assert shards[3]["layers/moe/experts/w_up"].is_contiguous()
    else:
        assert not any("model" in s for s in specs.values())
        assert specs["layers/attn/wo"] == (None, None, "data")
        assert specs["layers/mlp/w_down"] == (None, None, "data")
    assert set(gathers) == {tuple(p.split("/")[1:]) for p, s in
                            specs.items() if p.startswith("layers/") and
                            ("data" in s or ("model" in s and "/moe/" in p))}
    for path, dims in gathers.items():
        spec = specs["layers/" + "/".join(path)]
        assert all(spec[d + 1] == axis for d, axis in dims)
    # an axis of size 1 gathers nothing: (1, 2) stores no ZeRO shard
    one_row = dict(sharding.layer_gathers(cfg, tmesh.Mesh(("data", "model"),
                                                          (1, 2))))
    assert all(axis == "model" for dims in one_row.values()
               for _, axis in dims)
