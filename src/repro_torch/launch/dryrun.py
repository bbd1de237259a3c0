"""Dry-run of the port: size every (arch x input shape x mesh) step on the
meta device and write its roofline inputs, with no card and nothing
allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch llama3-8b --shape decode_32k --mesh pod --variant split_cache

The JAX package's dry-run lowers and compiles each step for a forced
512-device host and reads XLA's buffer plan and HLO.  Torch lowers
nothing, so here each step runs once on meta tensors (shapes only):

* globally, under ``FlopCounterMode``: the FLOP count of the whole step
  (``analysis.meta_flops``);
* as one rank of the mesh (rank 0), on its shards in the layout the port
  runs (``sharding.serving_specs`` for the weights,
  ``serving_cache_specs`` for the decode cache), with the port's
  collectives counted (``analysis.collective_bytes``): the bytes each
  gather and merge of the step moves (for training: the two passes'
  gathers, the backward's all-reduces over "model" and the gradient's
  all-reduce over the batch axes), and the rank's argument and output
  bytes (``analysis.memory_dict``).

Per combination it writes JSON with the same file name as the JAX
dry-run's: status, chips, memory per rank, the global FLOP count, the
analytic components and their per-rank fold, the component/counted FLOP
ratio, collectives, the roofline terms on the H100's constants, params
and active params.  A step the port runs on one device only has its
collectives null with the reason (``Built.no_route``: the LM variant of
training, the monolithic prefills).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch

from repro_torch.common import sharding as sh
from repro_torch.common.config import INPUT_SHAPES, TrainConfig
from repro_torch.configs import get_config, shape_applicable
from repro_torch.core.lookahead import init_lookahead_params
from repro_torch.launch import analysis, steps
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.attention import model_shard_mesh
from repro_torch.optim import adam

META = torch.device("meta")

#: stands in for a process group while the collectives are counted: the
#: counters never touch it, and the model code only asks whether it is None
_COUNTED = object()


def counting_mesh(mesh: Mesh, rank: int = 0) -> Mesh:
    """``mesh``'s shape as global rank ``rank`` of a world whose
    collectives ``analysis.collective_bytes`` counts."""
    return Mesh(mesh.axis_names, mesh.axis_sizes, _COUNTED, rank,
                data_group=_COUNTED, world=_COUNTED, batch_group=_COUNTED)


def _v_moe_sparse(cfg):
    assert cfg.moe is not None
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="sparse"))


#: the JAX dry-run's variants: config transforms and layout choices
VARIANTS = {
    "": {},
    # sort-based top-k dispatch (the MoE archs)
    "moe_sparse": {"cfg": _v_moe_sparse},
    # the batch over (data, model) for archs without tensor parallelism
    "dp_all": {"dp_all": True},
    # prefill with the sequence over "model"
    "seq_shard": {"seq_shard": True},
    # split-cache decode: frozen prompt rows + a 128-row hot ring
    "split_cache": {"hot_slots": 128},
}


def _variant_cfg(variant: str, cfg):
    fn = VARIANTS[variant].get("cfg")
    return fn(cfg) if fn else cfg


def batch_specs(mesh, batch: dict, global_batch: int, dp_all: bool = False,
                seq_shard: bool = False) -> dict:
    """The JAX dry-run's input layout: the batch over the data axes (all
    axes with ``dp_all``) where it divides, the sequence over "model"
    with ``seq_shard``."""
    dp = tuple(mesh.axis_names) if dp_all else sh.batch_axes(mesh)
    seq = "model" if seq_shard else None
    dp_total = 1
    for x in dp:
        dp_total *= mesh.shape[x]
    dp_entry = dp[0] if len(dp) == 1 else dp
    bspec = dp_entry if global_batch % dp_total == 0 else (
        "data" if global_batch % mesh.shape["data"] == 0 else None)

    def spec_for(name, t):
        if name == "mrope":
            return (None, bspec, seq) + (None,) * (t.dim() - 3)
        if name == "frames":  # whisper's encoder frames: whole sequence
            return (bspec,) + (None,) * (t.dim() - 1)
        return (bspec, seq) + (None,) * (t.dim() - 2)

    return {k: spec_for(k, v) for k, v in batch.items()
            if isinstance(v, torch.Tensor)}


def meta_lkv(cfg, params) -> dict:
    return init_lookahead_params(torch.Generator(), cfg, params["layers"],
                                 device=META)


@dataclasses.dataclass
class Built:
    """One step, globally (``fn(*args)``, for the FLOP count) and as one
    rank (``rank_fn(*rank_args)``, for its bytes and collectives; None
    where the port has no mesh route for the step, ``no_route`` saying
    why)."""

    fn: object
    args: tuple
    tokens: int
    rank_fn: object = None
    rank_args: tuple = ()
    no_route: str = ""
    layout: dict = dataclasses.field(default_factory=dict)


def _param_layouts(cfg, mesh, rank: int, *, serving: bool,
                   embed_replicated: bool = False) -> tuple:
    """(the rank's params in the layout it runs, {bytes per rank under the
    port's layout and under JAX's ``param_specs``})."""
    params = tf.init_params(cfg, device=META)
    jax_specs = sh.param_specs(cfg, mesh, embed_replicated=embed_replicated)
    port_specs = sh.serving_specs(cfg, mesh) if serving else jax_specs
    mine = sh.shard_tree(params, port_specs, mesh, rank)
    jax_bytes = analysis.tensor_bytes(sh.shard_tree(params, jax_specs,
                                                    mesh, rank))
    port_bytes = analysis.tensor_bytes(mine)
    layout = {"param_bytes_per_rank": port_bytes,
              "param_bytes_per_rank_jax_param_specs": jax_bytes}
    if port_bytes > jax_bytes:
        whole = model_shard_mesh(mesh, cfg.attn) is None
        layout["note"] = (
            "the port's serving layout holds more weight bytes per rank "
            "than JAX's param_specs: " + (
                "the heads divide no model axis (or there are none), so "
                "every layer runs whole on every rank" if whole
                else "wo / w_down are column-sliced and the embedding is "
                     "replicated unless it shards by vocab rows"))
    return mine, layout


def build(arch: str, shape_name: str, mesh: Mesh, variant: str = "",
          rank: int = 0) -> Built:
    """The step of ``shape_name`` for ``arch``: its global meta inputs and
    rank ``rank``'s (``steps.make_*_step`` and
    ``steps.*_batch_shapes``)."""
    cfg = _variant_cfg(variant, get_config(arch))
    shape = INPUT_SHAPES[shape_name]
    opts = VARIANTS[variant]
    dp_all = opts.get("dp_all", False)
    cm = counting_mesh(mesh, rank)

    if shape.kind == "train":
        fn = steps.make_train_step(cfg, TrainConfig())
        bs = steps.train_batch_shapes(cfg, shape)
        bs.pop("n_in"), bs.pop("n_out")
        params = tf.init_params(cfg, device=META)
        mine, layout = _param_layouts(cfg, mesh, rank, serving=True)
        local_b = sh.shard_tree(bs, batch_specs(
            mesh, bs, shape.global_batch, dp_all), mesh, rank)
        tokens = shape.global_batch * shape.seq_len
        if not cfg.technique_applies:
            return Built(fn, (params, adam.init(params), bs), tokens,
                         rank_args=(mine, adam.init(mine), local_b),
                         layout=layout, no_route=(
                             f"{cfg.name} trains the LM variant, which has "
                             "no launcher route and takes no mesh"))
        lkv = meta_lkv(cfg, params)
        built = Built(fn, (params, lkv, adam.init(lkv), bs), tokens,
                      rank_args=(mine, lkv, adam.init(lkv), local_b),
                      layout=layout)
        if dp_all:
            built.no_route = ("the port's trainer shards the batch over "
                              "the batch axes only, not over (data, model)")
        else:
            built.rank_fn = steps.make_train_step(cfg, TrainConfig(),
                                                  mesh=cm)
        return built

    mine, layout = _param_layouts(cfg, mesh, rank, serving=True)
    params = tf.init_params(cfg, device=META)
    if shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg, shape)
        bs = steps.prefill_batch_shapes(cfg, shape)
        local_b = sh.shard_tree(bs, batch_specs(
            mesh, bs, shape.global_batch, dp_all,
            opts.get("seq_shard", False)), mesh, rank)
        tokens = shape.global_batch * shape.seq_len
        if not cfg.technique_applies:
            return Built(fn, (params, bs), tokens, rank_args=(mine, local_b),
                         layout=layout, no_route=(
                             f"{cfg.name} prefills monolithically on one "
                             "device: the port's mesh route is the chunked "
                             "prefill of attention-only decoders"))
        lkv = meta_lkv(cfg, params)
        built = Built(fn, (params, lkv, bs), tokens,
                      rank_args=(mine, lkv, local_b), layout=layout)
        if not tf.chunkable(cfg) or "mrope" in bs:
            built.no_route = (f"{cfg.name} prefills monolithically on one "
                              "device: the port's mesh route is the chunked "
                              "prefill of attention-only text decoders")
            return built
        built.rank_fn = _chunked_prefill_rank(cfg, shape, cm)
        return built

    # decode
    hot = opts.get("hot_slots", 0)
    token, cache = steps.decode_batch_shapes(cfg, shape, hot)
    fn = steps.make_decode_step(cfg)
    r_token, r_cache = steps.decode_batch_shapes(cfg, shape, hot, mesh=cm)
    if r_token.shape[0] != r_cache["next_pos"].shape[0]:
        r_token = r_token[:r_cache["next_pos"].shape[0]]
    layout["cache_bytes_per_rank"] = analysis.tensor_bytes(r_cache)
    return Built(fn, (params, token, cache), shape.global_batch,
                 rank_fn=steps.make_decode_step(cfg, mesh=cm),
                 rank_args=(mine, r_token, r_cache), layout=layout)


def _chunked_prefill_rank(cfg, shape, mesh):
    """The port's prefill over a mesh for one rank: the whole prompt as one
    chunk of ``prefill_chunk`` then ``prefill_finalize`` (lookaheadkv at
    ``make_prefill_step``'s budget and margin)."""
    from repro_torch.common.config import EvictionConfig

    evict = EvictionConfig(policy="lookaheadkv",
                           budget=min(steps.PREFILL_BUDGET,
                                      shape.seq_len // 4))

    def run(params, lkv, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape[:2]
        state = tf.init_chunk_state(cfg, "lookaheadkv", B,
                                    S + cfg.lookahead.n_lookahead,
                                    device=META, mesh=mesh)
        state, logits = tf.prefill_chunk(params, cfg, state, tokens, S,
                                         policy="lookaheadkv", mesh=mesh)
        cache = tf.prefill_finalize(params, cfg, state, S,
                                    policy="lookaheadkv", evict=evict,
                                    lkv_params=lkv,
                                    extra_slots=steps.DECODE_MARGIN,
                                    mesh=mesh)
        return logits, cache

    return run


def _floats(d: dict) -> dict:
    return {k: (v if isinstance(v, int) else float(v)) for k, v in d.items()}


def run_one(arch: str, shape_name: str, mesh_kind: str,
            out_dir: str | None, variant: str = "") -> dict:
    """Dry-run one combination; writes ``<arch>_<shape>_<mesh>[_variant]
    .json`` under ``out_dir`` and returns the result."""
    applicable, reason = shape_applicable(arch, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "variant": variant}
    if not applicable:
        result.update(status="skipped", reason=reason)
        print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}")
        _dump(result, out_dir)
        return result
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    chips = mesh.size
    cfg = _variant_cfg(variant, get_config(arch))
    shape = INPUT_SHAPES[shape_name]
    t0 = time.time()
    b = build(arch, shape_name, mesh, variant)
    with (torch.no_grad() if shape.kind != "train"
          else contextlib.nullcontext()):
        counted = analysis.meta_flops(b.fn, *b.args)
        t_count = time.time() - t0
        collectives = None
        outputs = counted.pop("outputs")
        if b.rank_fn is not None:
            with analysis.collective_bytes() as coll:
                outputs = b.rank_fn(*b.rank_args)
            collectives = coll
    mem = analysis.memory_dict(b.rank_args, outputs)
    mf = analysis.model_flops(cfg, shape.kind, b.tokens)
    eff_mesh = ({"data": chips, "model": 1} if VARIANTS[variant].get(
        "dp_all") else dict(mesh.shape))
    comps = analysis.component_costs(
        cfg, shape.kind, shape.global_batch, shape.seq_len, eff_mesh,
        seq_sharded=VARIANTS[variant].get("seq_shard", False))
    pd = analysis.per_device_cost(comps, eff_mesh, shape.global_batch)
    comp_global = sum(c["flops"] for c in comps.values())
    check = comp_global / counted["flops"] if counted["flops"] else 0.0
    rl = analysis.roofline_terms(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=chips,
        hlo_flops_per_dev=pd["flops_per_dev"],
        hlo_bytes_per_dev=pd["bytes_per_dev"],
        coll_bytes_per_dev=float(collectives["total"]) if collectives
        else 0.0,
        model_flops_global=mf,
        peak_bytes=mem["peak_memory_in_bytes"])
    result.update({
        "status": "ok",
        "chips": chips,
        "count_s": round(t_count, 2),
        "memory": mem,
        "layout": b.layout,
        "flops_meta_global": counted,
        "components": {k: _floats(v) for k, v in comps.items()},
        "per_device": pd,
        "flops_check_ratio": check,
        "collectives": collectives,
        "roofline": rl.to_dict(),
        "params": cfg.num_params(),
        "active_params": cfg.active_params(),
    })
    if collectives is None:
        result["collectives_reason"] = b.no_route
    print(f"[dryrun] OK {arch} x {shape_name} x {mesh_kind}"
          f"{' ' + variant if variant else ''} (counted in {t_count:.1f} s)")
    print(f"  memory/rank: {mem}")
    coll_s = (f"{collectives['total']:.3e}" if collectives
              else f"none ({b.no_route})")
    print(f"  flops/rank: {pd['flops_per_dev']:.3e}  hbm bytes/rank: "
          f"{pd['bytes_per_dev']:.3e}  collective bytes/rank: {coll_s}  "
          f"flops check: {check:.2f}")
    print(f"  roofline (H100): compute {rl.compute_s * 1e3:.2f} ms  memory "
          f"{rl.memory_s * 1e3:.2f} ms  collective "
          f"{rl.collective_s * 1e3:.2f} ms -> {rl.bottleneck}-bound; "
          f"useful-flop ratio {rl.useful_flop_ratio:.3f}")
    _dump(result, out_dir)
    return result


def _dump(result: dict, out_dir: str | None) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    v = f"_{result['variant']}" if result.get("variant") else ""
    name = f"{result['arch']}_{result['shape']}_{result['mesh']}{v}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=2, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--variant", default="", choices=list(VARIANTS))
    args = ap.parse_args(argv)
    res = run_one(args.arch, args.shape, args.mesh, args.out, args.variant)
    sys.exit(0 if res.get("status") in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
