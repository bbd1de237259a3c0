"""The port's dry-run (``launch/analysis.py``, ``launch/dryrun.py``,
``launch/dryrun_all.py`` and the dry-run half of ``launch/steps.py``)
against the JAX package's pieces, on the CPU.

The JAX dry-run itself does not run on this host (its ``tf.embed`` raises
a ``ShardingTypeError`` on the forced 512-device mesh, ROADMAP C), so the
port's is held against the JAX functions that do run:

* ``analysis``'s analytic functions (``roofline_terms``, ``model_flops``,
  ``analytic_hbm_bytes``, ``component_costs``, ``per_device_cost``) for
  every arch x shape x mesh (pod, multipod) x variant, with the JAX
  package's hardware constants patched into the port's: equal exactly
  (the same float arithmetic);
* the step inputs (``*_batch_shapes``, meta tensors) against JAX's
  ``ShapeDtypeStruct``s under ``jax.eval_shape``, at full width;
* the bytes each rank holds against ``NamedSharding(AbstractMesh,
  spec).shard_shape``: equal under ``param_specs`` and ``cache_specs``;
  where the port's serving layout differs, the difference is the one
  named (heads that divide no model axis run every layer whole; the hot
  ring lies on the kv heads' axis where they shard);
* the meta FLOP count (``analysis.meta_flops``) against JAX's
  ``analysis.fn_cost`` at smoke width: equal for prefill and decode; for
  training, JAX's jaxpr runs every layer's backward in one ``lax.scan``
  body, so it transposes the last layer's products that reach no score
  (its attention output, ``wo`` and MLP), which torch's autograd prunes:
  the difference is the same at 2 and 3 layers, and each added layer
  costs both packages the same;
* ``shape_applicable`` against JAX's; ``run_one`` and ``dryrun_all`` on
  two archs, JSON files written, every status ok or skipped, qwen2-vl's
  and whisper's training steps with their collectives counted;
* the sharded training step's collectives, counted per layer: the two
  passes' gathers (ZeRO and tensor-parallel), the backward's all-reduces
  over "model", and one gradient all-reduce over the batch axes.

Tolerances: none, every comparison is exact.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.common import sharding as jsh
from repro.common.config import INPUT_SHAPES as J_SHAPES
from repro.common.config import ShapeConfig as JShape
from repro.common.config import TrainConfig as JTrain
from repro.configs import ARCH_IDS as J_ARCHS
from repro.configs import get_config as jget
from repro.configs import get_smoke_config as jsmoke
from repro.configs import shape_applicable as j_applicable
from repro.core.lookahead import init_lookahead_params as j_init_lkv
from repro.launch import analysis as ja
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import adam as jadam
from repro_torch.common import sharding as sh
from repro_torch.common.config import INPUT_SHAPES, ShapeConfig, TrainConfig
from repro_torch.common.pytree import tree_map
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs import shape_applicable
from repro_torch.launch import analysis, dryrun, dryrun_all, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as ttf
from repro_torch.optim import adam

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _variants(cfg):
    """The dry-run's variants that apply to ``cfg`` (JAX's moe_sparse
    asserts an MoE arch)."""
    return [v for v in dryrun.VARIANTS if v != "moe_sparse" or cfg.moe]


def test_arch_ids_and_shape_applicable_match_jax():
    assert ARCH_IDS == J_ARCHS
    for arch in ARCH_IDS + ("llama3-8b",):
        for shape in INPUT_SHAPES:
            assert shape_applicable(arch, shape) == j_applicable(arch, shape)


def test_analytic_functions_match_jax(monkeypatch):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW"):
        monkeypatch.setattr(analysis, name, getattr(ja, name))
    monkeypatch.setattr(analysis, "LINK_BW", ja.ICI_BW)
    n = 0
    for arch in ARCH_IDS:
        for shape_name, shape in INPUT_SHAPES.items():
            for mesh_kind, (sizes, _) in MESHES.items():
                chips = int(np.prod(sizes))
                for variant in _variants(get_config(arch)):
                    tcfg = dryrun._variant_cfg(variant, get_config(arch))
                    jcfg = jget(arch)
                    if variant == "moe_sparse":
                        jcfg = dataclasses.replace(
                            jcfg, moe=dataclasses.replace(
                                jcfg.moe, dispatch="sparse"))
                    opts = dryrun.VARIANTS[variant]
                    mesh = ({"data": chips, "model": 1}
                            if opts.get("dp_all")
                            else dict(zip(MESHES[mesh_kind][1], sizes)))
                    seq = opts.get("seq_shard", False)
                    args = (shape.kind, shape.global_batch, shape.seq_len)
                    want = ja.component_costs(jcfg, *args, mesh,
                                              seq_sharded=seq)
                    got = analysis.component_costs(tcfg, *args, mesh,
                                                   seq_sharded=seq)
                    assert got == want, (arch, shape_name, variant)
                    pd = analysis.per_device_cost(got, mesh,
                                                  shape.global_batch)
                    assert pd == ja.per_device_cost(want, mesh,
                                                    shape.global_batch)
                    assert analysis.analytic_hbm_bytes(tcfg, *args) == \
                        ja.analytic_hbm_bytes(jcfg, *args)
                    tokens = shape.global_batch * (
                        1 if shape.kind == "decode" else shape.seq_len)
                    mf = analysis.model_flops(tcfg, shape.kind, tokens)
                    assert mf == ja.model_flops(jcfg, shape.kind, tokens)
                    kw = dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                              chips=chips,
                              hlo_flops_per_dev=pd["flops_per_dev"],
                              hlo_bytes_per_dev=pd["bytes_per_dev"],
                              coll_bytes_per_dev=1.5e9 * (n % 3),
                              model_flops_global=mf, peak_bytes=7e9)
                    assert analysis.roofline_terms(**kw).to_dict() == \
                        ja.roofline_terms(**kw).to_dict()
                    n += 1
    assert n > 200


def _struct(x):
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""))


def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert _struct(got) == (tuple(want.shape), str(want.dtype)), path
    else:  # the port's scalar cursor is an int where JAX's is an int32 ()
        assert isinstance(got, int) and want.shape == (), path


def test_batch_shapes_match_jax_eval_shape():
    for arch in ARCH_IDS + ("llama3-8b",):
        tcfg, jcfg = get_config(arch), jget(arch)
        for shape_name, shape in INPUT_SHAPES.items():
            js_ = J_SHAPES[shape_name]
            if shape.kind == "train":
                got, want = (steps.train_batch_shapes(tcfg, shape),
                             jsteps.train_batch_shapes(jcfg, js_))
                assert (got.pop("n_in"), got.pop("n_out")) == (
                    want.pop("n_in"), want.pop("n_out"))
                _same_tree(got, want)
            elif shape.kind == "prefill":
                _same_tree(steps.prefill_batch_shapes(tcfg, shape),
                           jsteps.prefill_batch_shapes(jcfg, js_))
            else:
                for hot in (0, 128):
                    t_tok, t_cache = steps.decode_batch_shapes(tcfg, shape,
                                                               hot)
                    j_tok, j_cache = jsteps.decode_batch_shapes(jcfg, js_,
                                                                hot)
                    assert _struct(t_tok) == (j_tok.shape, str(j_tok.dtype))
                    _same_tree(t_cache, j_cache)
    assert steps.PREFILL_BUDGET == jsteps.PREFILL_BUDGET
    assert steps.DECODE_MARGIN == jsteps.DECODE_MARGIN


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v
    return out


def _local_shapes(tree, specs, mesh):
    return tree_map(lambda x, s: tuple(
        n for _, n in sh.shard_bounds(tuple(x.shape), s, mesh, 0)),
        tree, specs)


def _jax_shapes(tree, specs, amesh):
    return jax.tree.map(
        lambda x, s: NamedSharding(amesh, s).shard_shape(x.shape),
        tree, specs, is_leaf=lambda s: isinstance(s, P))


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_per_rank_bytes_match_jax_shard_shapes(mesh_kind):
    """Rank 0's block of every parameter under ``param_specs`` and of the
    decode cache under ``cache_specs`` is JAX's ``shard_shape``; the
    serving layout equals it too, but for the named differences."""
    sizes, names = MESHES[mesh_kind]
    amesh = AbstractMesh(sizes, names)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    shape = INPUT_SHAPES["decode_32k"]
    for arch in ARCH_IDS + ("llama3-8b",):
        tcfg, jcfg = get_config(arch), jget(arch)
        params = ttf.init_params(tcfg, device="meta")
        jparams = jax.eval_shape(lambda: jtf.init_params(
            jax.random.PRNGKey(0), jcfg))
        want = _jax_shapes(jparams, jsh.param_specs(jcfg, amesh), amesh)
        got = _local_shapes(params, sh.param_specs(tcfg, mesh), mesh)
        flat_w = {"/".join(str(k.key) for k in p): v for p, v in
                  jax.tree_util.tree_leaves_with_path(
                      want, is_leaf=lambda x: isinstance(x, tuple))}
        flat_g = _flat(got)
        # the port's tree leaves out the zero qkv biases (a missing bias
        # is a zero one)
        assert {k: v for k, v in flat_w.items() if k in flat_g} == flat_g
        # the serving layout: heads that divide no model axis hold every
        # layer whole; else it holds no more than param_specs' bytes but
        # where wo / w_down / the embedding are laid out differently
        b = dryrun._param_layouts(tcfg, mesh, 0, serving=True)[1]
        a = tcfg.attn
        whole = a is None or a.num_kv_heads % 16 or a.num_heads % 16
        if whole:
            assert b["param_bytes_per_rank"] > \
                b["param_bytes_per_rank_jax_param_specs"]
            assert "divide no model axis" in b["note"]
        if not tcfg.uses_attention:
            continue
        for hot in (0, 128):
            j_tok, j_cache = jsteps.decode_batch_shapes(
                jcfg, J_SHAPES["decode_32k"], hot)
            cspec = jsh.cache_specs(jcfg, amesh, shape.global_batch,
                                    shape.seq_len, hot_slots=hot)
            want_c = _jax_shapes(j_cache, cspec, amesh)
            _, t_cache = steps.decode_batch_shapes(
                tcfg, shape, hot, mesh=dryrun.counting_mesh(mesh))
            for name, leaf in t_cache["attn"].items():
                w = want_c["attn"][name]
                if not hot:  # the port's engines' layout: batch whole
                    assert leaf.shape[2] == shape.seq_len
                    continue
                if name.startswith("hot_") and a.num_kv_heads % 16 == 0 \
                        and a.num_heads % 16 == 0:
                    # the named difference: the ring on the kv heads
                    assert tuple(leaf.shape) == w[:3] + (w[3] // 16,) + \
                        w[4:], (arch, name)
                else:
                    assert tuple(leaf.shape) == w, (arch, name)


def _jax_fn_cost(kind, jcfg, S=64, B=2):
    jshape = JShape("smoke", S, B, kind)
    jp = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                jcfg))
    jl = jax.eval_shape(lambda: j_init_lkv(jax.random.PRNGKey(0), jcfg,
                                           jp["layers"]))
    if kind == "prefill":
        fn = jsteps.make_prefill_step(jcfg, jshape)
        args = (jp, jl, jsteps.prefill_batch_shapes(jcfg, jshape))
    elif kind == "decode":
        fn = jsteps.make_decode_step(jcfg)
        tok, cache = jsteps.decode_batch_shapes(jcfg, jshape, 0)
        args = (jp, tok, cache)
    else:
        fn = jsteps.make_train_step(jcfg, JTrain())
        bs = jsteps.train_batch_shapes(jcfg, jshape)
        bs.pop("n_in"), bs.pop("n_out")
        args = (jp, jl, jax.eval_shape(jadam.init, jl), bs)
    return ja.fn_cost(fn, *args)["flops"]


def _port_flops(kind, tcfg, S=64, B=2):
    shape = ShapeConfig("smoke", S, B, kind)
    tp = ttf.init_params(tcfg, device="meta")
    tl = dryrun.meta_lkv(tcfg, tp)
    if kind == "prefill":
        fn = steps.make_prefill_step(tcfg, shape)
        args = (tp, tl, steps.prefill_batch_shapes(tcfg, shape))
    elif kind == "decode":
        fn = steps.make_decode_step(tcfg)
        args = (tp,) + steps.decode_batch_shapes(tcfg, shape, 0)
    else:
        fn = steps.make_train_step(tcfg, TrainConfig())
        bs = steps.train_batch_shapes(tcfg, shape)
        bs.pop("n_in"), bs.pop("n_out")
        args = (tp, tl, adam.init(tl), bs)
    with torch.no_grad() if kind != "train" else torch.enable_grad():
        return analysis.meta_flops(fn, *args)["flops"]


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-1b"])
def test_meta_flop_count_matches_jaxpr_cost(arch):
    jcfg, tcfg = jsmoke(arch), get_smoke_config(arch)
    for kind in ("prefill", "decode"):
        assert _port_flops(kind, tcfg) == _jax_fn_cost(kind, jcfg), kind
    # training: JAX - port is the last layer's pruned backward, the same
    # at 2 and 3 layers; an added layer costs both the same
    diff = {}
    for L in (2, 3):
        j = _jax_fn_cost("train", dataclasses.replace(jcfg, num_layers=L))
        t = _port_flops("train", dataclasses.replace(tcfg, num_layers=L))
        diff[L] = (j, t)
    (j2, t2), (j3, t3) = diff[2], diff[3]
    assert j2 - t2 == j3 - t3 > 0
    assert j3 - j2 == t3 - t2
    assert j2 - t2 < j3 - j2  # less than one layer's forward + backward


def test_run_one_and_dryrun_all_write_json(tmp_path):
    res = dryrun.run_one("gemma3-1b", "decode_32k", "pod", str(tmp_path),
                         "split_cache")
    assert res["status"] == "ok" and res["chips"] == 256
    path = tmp_path / "gemma3-1b_decode_32k_pod_split_cache.json"
    on_disk = json.loads(path.read_text())
    assert on_disk["status"] == "ok"
    for key in ("memory", "flops_meta_global", "components", "per_device",
                "flops_check_ratio", "collectives", "roofline", "params",
                "active_params"):
        assert key in on_disk, key
    # gemma3-1b's one kv head divides no model axis: the frozen rows lie
    # by sequence over "model", so every layer merges its partials (two
    # all-reduces) and each rank holds its 2,048-row slice
    layers = get_config("gemma3-1b").num_layers
    assert res["collectives"]["counts"]["all-reduce"] == 2 * layers
    out = tmp_path / "all"
    results = dryrun_all.main(["--mesh", "pod", "--out", str(out),
                               "--archs", "smollm-135m,qwen2-vl-72b",
                               "--shapes", "train_4k,decode_32k,long_500k"])
    assert {(r["arch"], r["shape"]): r["status"] for r in results} == {
        ("smollm-135m", "train_4k"): "ok",
        ("smollm-135m", "decode_32k"): "ok",
        ("smollm-135m", "long_500k"): "skipped",
        ("qwen2-vl-72b", "train_4k"): "ok",
        ("qwen2-vl-72b", "decode_32k"): "ok",
        ("qwen2-vl-72b", "long_500k"): "skipped"}
    assert len(list(out.glob("*.json"))) == 6
    train = json.loads((out / "smollm-135m_train_4k_pod.json").read_text())
    # smollm's 9 heads divide no model axis of 16 and it keeps no ZeRO
    # storage: every layer runs whole on every rank, so the step's one
    # collective is the gradient's all-reduce over the batch axes
    assert train["collectives"]["counts"] == {"all-gather": 0,
                                              "all-reduce": 1}
    assert "collectives_reason" not in train
    vlm = json.loads((out / "qwen2-vl-72b_train_4k_pod.json").read_text())
    # qwen2-vl's 8 kv heads divide no model axis of 16 and it keeps ZeRO
    # storage: each of its 80 layers gathers its seven big weights over
    # "data" in each of the two passes (the response tokens' embedding
    # rows from a whole table), then the gradient's one all-reduce
    layers = get_config("qwen2-vl-72b").num_layers
    assert vlm["collectives"]["counts"] == {"all-gather": 2 * 7 * layers,
                                            "all-reduce": 1}
    assert "collectives_reason" not in vlm


def test_whisper_train_shape_runs_whole_on_multipod(tmp_path):
    """whisper-small's training step on the multipod mesh: its 12 heads
    divide no model axis of 16 and it keeps no ZeRO storage, so the
    encoder, the decoder and every cross-attention run whole on every
    rank and the step's one collective is the gradient's all-reduce."""
    res = dryrun.run_one("whisper-small", "train_4k", "multipod",
                         str(tmp_path))
    assert res["status"] == "ok" and res["chips"] == 512
    assert res["collectives"]["counts"] == {"all-gather": 0,
                                            "all-reduce": 1}
    on_disk = json.loads(
        (tmp_path / "whisper-small_train_4k_multipod.json").read_text())
    assert on_disk["status"] == "ok"


@pytest.mark.parametrize("sizes,names,zero", [
    ((2, 2), ("data", "model"), 7), ((2, 1, 2), ("pod", "data", "model"), 0)])
def test_train_collectives_per_layer(monkeypatch, sizes, names, zero):
    """llama3-8b's training step on one rank of a mesh whose model axis
    of 2 shards its heads, at 2 and 3 layers (width uncut): per layer and
    pass, ``zero`` ZeRO gathers over "data" (the seven weights, where the
    data axis is above 1) and five gathers over "model" (attention's
    heads and ``wo``'s columns, the MLP's activation and columns, the
    captured scores); per layer, the backward's 18 all-reduces over
    "model" (``column_linears``: one for each input of the column slices,
    ``qkv``'s, ``wo``'s, the MLP's two; and each of the seven LoRA
    targets' rank-r intermediate and ``b``), but 5 in the last layer,
    whose ``wv``, ``wo`` and MLP reach no score; the vocab-sharded
    embedding once per pass; one gradient all-reduce over the batch
    axes."""
    from repro_torch.launch.mesh import Mesh

    counts = {}
    for L in (2, 3):
        cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=L)
        monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
        b = dryrun.build("llama3-8b", "train_4k", Mesh(names, sizes))
        with analysis.collective_bytes() as coll:
            b.rank_fn(*b.rank_args)
        counts[L] = coll["counts"]
    per_layer = {"all-gather": 2 * (zero + 5), "all-reduce": 18}
    for kind, n in per_layer.items():
        assert counts[3][kind] - counts[2][kind] == n, (kind, counts)
    assert counts[2] == {"all-gather": 2 * 2 * (zero + 5) + 2,
                         "all-reduce": 18 + 5 + 1}
