"""The port's lookahead-module trainer under a mesh against the JAX
package's single-device training step, on the CPU.

The JAX trainer's ``train.main`` fails on a CPU host even under its host
mesh, so the oracle is its step below it: ``jax.value_and_grad`` of
``objective.lkv_loss`` and ``jax.jit(steps.make_train_step)`` (and
``make_distill_step``), compiled once per model in one program.  The
port's ranks are processes: one world of 4 and one of 2 gloo ranks
(``launch/mesh.py::spawn_ranks``, a ``file://`` store, collectives timing
out after 60 s), each running its jobs in order (``mesh.run_jobs``)
while the JAX references compile in this process.  Every rank builds its
shard of the JAX package's own float32 weights
(``bridge.shard_to_torch``) and takes its data row's rows of the same
numpy-seeded batch (``N_IN`` 40 + ``N_OUT`` 8 tokens, B 2, the inputs of
``tests/test_torch_objective.py``); the LoRA ``b`` leaves are drawn, so
that every ``a`` has a gradient.

Meshes: llama3-smoke at 8 q / 4 kv heads of 32, d_model 256, on (1, 2),
(2, 1), (2, 2) with ZeRO storage (``fsdp``), (1, 4) and the pod-shaped
(2, 1, 2); deepseek-smoke (MoE layers whole on every rank) and
gemma3-smoke (one kv head: every layer whole) on (1, 2), where a
gradient summed over "model" after the fact would count twice;
qwen2-vl-smoke (4 / 2 heads, patch embeddings with an M-RoPE grid,
``torch_train_ref.vlm_batch``) on (1, 2) and on (2, 2) with ZeRO, its
train and its distillation step; whisper-smoke (4 / 4 heads: the
encoder and the cross-attention at 2 heads a rank, frames split with
the batch rows) on (1, 2) and (2, 1).  One training step each
(``train.train_shard``, lr 1e-3 of a 10-step schedule, the first step
of its warmup), held to:

* the loss within 1e-5 relative, the same on every rank;
* every lkv gradient leaf within 1e-4 of that leaf's largest JAX
  gradient (nonzero), and within 1e-5 of it against the port's own
  one-process gradient (``steps.make_lkv_grad`` without a mesh);
* the global gradient norm within 1e-5 relative of the port's one-process
  norm, and within 1e-4 of JAX's: the one-process port's float32 norm is
  7.2e-5 from JAX's on llama here (its float64 norm 1.5e-5), as its
  leaves are within 1e-4 (``tests/test_torch_objective.py``);
* Adam's ``m`` and ``v`` after the step, 0.1 g and 0.05 g^2 of the
  clipped gradient g / |g| (clipped at 1.0): the gradient's 1e-4 and the
  norm's 1e-4 add up in ``m`` (2e-4 of its leaf's largest against JAX,
  2e-5 against the one-process port) and double again in ``v`` (4e-4,
  4e-5);
* the updated modules within 1e-6 absolute where JAX's gradient exceeds
  1e-3 of its leaf's largest, elsewhere within 2 x lr (Adam's first step
  is lr * sign(g), and a gradient near zero may take either sign); every
  rank's modules bit for bit the same;
* whisper's cross ``wk`` / ``wv`` LoRA, which no pass applies: zero
  gradients and moments in both packages.

Also: the distillation steps at (2, 2) against ``make_distill_step`` on
the same stored targets; the autograd collectives alone in the world of
2 against the same products on one rank (float64, 1e-12); a run killed
and resumed at (2, 1) bit for bit the straight run, and a checkpoint
written under that mesh resumed by the one-process trainer; refusals:
``--mesh pod`` in a world of one, a global batch the batch axes do not
divide, the LM variant under a mesh, serving prefills under a mesh, a
frozen weight that asks for a gradient (gathered or column-sliced).
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JTrain
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.checkpoint import io as tckpt
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import objective as tobj
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import Mesh, run_jobs, spawn_ranks
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as ttf
from repro_torch.optim import adam as tadam
from torch_mesh_ranks import autograd_collectives, two_products
import torch_train_ref as train_ref

N_IN, N_OUT, B = 40, 8, 2
LR, SCHEDULE = 1e-3, 10
#: (job name, model, mesh sizes, ZeRO storage, world size, distill)
STEP_CASES = (
    ("llama (1, 2)", "llama", (1, 2), False, 2, False),
    ("llama (2, 1)", "llama", (2, 1), False, 2, False),
    ("deepseek (1, 2)", "deepseek", (1, 2), False, 2, False),
    ("gemma (1, 2)", "gemma", (1, 2), False, 2, False),
    ("llama (2, 2) zero", "llama", (2, 2), True, 4, False),
    ("llama (1, 4)", "llama", (1, 4), False, 4, False),
    ("llama (2, 1, 2)", "llama", (2, 1, 2), False, 4, False),
    ("llama (2, 2) zero distill", "llama", (2, 2), True, 4, True),
    ("qwen2-vl (1, 2)", "qwen2-vl", (1, 2), False, 2, False),
    ("qwen2-vl (2, 2) zero", "qwen2-vl", (2, 2), True, 4, False),
    ("qwen2-vl (2, 2) zero distill", "qwen2-vl", (2, 2), True, 4, True),
    ("whisper (1, 2)", "whisper", (1, 2), False, 2, False),
    ("whisper (2, 1)", "whisper", (2, 1), False, 2, False),
)
#: the models whose distillation step is held (their JAX references)
DISTILLED = ("llama", "qwen2-vl")
#: the killed-and-resumed runs at (2, 1): synthetic mixture, 6 steps of
#: B 2, a save every 2
RESUME = dict(steps=6, batch=2, n_in=24, n_out=6, lr=LR, seed=1,
              ckpt_every=2, mesh=(2, 1))


def _llama(base):
    """6a's geometry: 8 q over 4 kv heads of 32, d_model 256, so that 2
    and 4 divide the heads."""
    return dataclasses.replace(
        base, d_model=256, dtype="float32",
        attn=dataclasses.replace(base.attn, num_heads=8, num_kv_heads=4,
                                 head_dim=32))


def _config(get, name):
    if name == "llama":
        return _llama(get("llama3-8b"))
    arch = {"deepseek": "deepseek-moe-16b", "gemma": "gemma3-1b",
            "qwen2-vl": "qwen2-vl-72b", "whisper": "whisper-small"}[name]
    return dataclasses.replace(get(arch), dtype="float32")


def _jtc():
    return JTrain(steps=SCHEDULE, lr=LR, batch_size=B, n_in=N_IN,
                  n_out=N_OUT)


@pytest.fixture(scope="module")
def models():
    """{model: JAX config and port config, JAX params and modules (LoRA
    b drawn), their numpy trees, the train step's batch and, for the
    ``DISTILLED`` models, the distillation's (the port's one-rank gt
    targets)}: tokens for the text archs, patch embeddings with an
    M-RoPE grid for qwen2-vl, tokens and frames for whisper
    (``torch_train_ref``)."""
    toks = np.random.default_rng(7).integers(
        0, 512, (B, N_IN + N_OUT)).astype(np.int32)
    out = {}
    for name in ("llama", "deepseek", "gemma", "qwen2-vl", "whisper"):
        jcfg = _config(jax_smoke, name)
        tcfg = _config(get_smoke_config, name)
        jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        jl = jax_init_lkv(jax.random.PRNGKey(1), jcfg, jp["layers"])
        rng = np.random.default_rng(5)
        jl = jax.tree_util.tree_map_with_path(
            lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05,
                                      x.dtype)
                          if str(p[-1].key) == "b" else x), jl)
        np_params = jax.tree.map(np.asarray, jp)
        if name == "qwen2-vl":
            batch = train_ref.vlm_batch(tcfg, B, N_OUT, seed=11)
        elif name == "whisper":
            batch = train_ref.whisper_batch(tcfg, B, N_IN, N_OUT, seed=13)
        else:
            batch = {"x": toks[:, :N_IN], "xy": toks}
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jl=jl, toks=toks,
                         np_params=np_params, batch=batch,
                         np_lkv=jax.tree.map(np.asarray, jl))
    for name in DISTILLED:
        # the distillation's stored targets: the port's GT pass on one
        # rank (over [X; embed(Y)] for qwen2-vl)
        m = out[name]
        tp = bridge.to_torch(m["np_params"], device="cpu")
        x = torch.from_numpy(m["batch"]["x"])
        xy = (torch.from_numpy(m["batch"]["xy"]) if "xy" in m["batch"]
              else torch.cat([x, ttf.embed(tp, m["tcfg"], torch.from_numpy(
                  m["batch"]["y"]))], dim=1))
        s_gt = tobj.gt_scores(tp, m["tcfg"], xy, N_IN).numpy()
        m["distill_batch"] = {"x": m["batch"]["x"], "s_gt": s_gt}
    return out


def _step_job(m, sizes, zero, distill, ckpt):
    batch = m["distill_batch"] if distill else m["batch"]
    return dict(cfg=dataclasses.replace(m["tcfg"], fsdp=zero), device="cpu",
                steps=SCHEDULE, batch=B, n_in=N_IN, n_out=N_OUT, lr=LR,
                ckpt=ckpt, seed=0, mesh=sizes, params=m["np_params"],
                lkv=m["np_lkv"], batches=[batch], stop_after=1,
                return_grads=True)


def _collective_job():
    rng = np.random.default_rng(3)
    return {"x": rng.normal(size=(2, 5, 12)), "a": rng.normal(size=(12, 3)),
            "b": rng.normal(size=(3, 8)), "w1": rng.normal(size=(12, 8)),
            "w2": rng.normal(size=(8, 6)), "c": rng.normal(size=(2, 5, 6))}


def _resume_job(m, path, **change):
    job = dict(RESUME, cfg=m["tcfg"], device="cpu", ckpt=path,
               params=m["np_params"])
    job.update(change)
    return job


def _spawn_worlds(models, tmp) -> dict:
    """{job name: per-rank results}: the world of 4, then the world of 2
    (its step cases, the collectives, the resume runs)."""
    out = {}
    for n in (4, 2):
        names = [c[0] for c in STEP_CASES if c[4] == n]
        jobs = [(train.train_shard,
                 _step_job(models[c[1]], c[2], c[3], c[5],
                           str(tmp / f"unused{i}.npz")))
                for i, c in enumerate(STEP_CASES) if c[4] == n]
        if n == 2:
            m = models["llama"]
            names += ["collectives", "straight", "killed", "killed once",
                      "resumed"]
            jobs += [
                (autograd_collectives, _collective_job()),
                (train.train_shard, _resume_job(m, str(tmp / "s.npz"))),
                (train.train_shard, _resume_job(m, str(tmp / "k.npz"),
                                                stop_after=3)),
                (train.train_shard, _resume_job(m, str(tmp / "k1.npz"),
                                                stop_after=3)),
                (train.train_shard, _resume_job(m, str(tmp / "k.npz"),
                                                resume=True))]
        res = spawn_ranks(run_jobs, n, (jobs,),
                          init_file=str(tmp / f"store{n}"), timeout_s=60.0,
                          join_s=240.0)
        for i, name in enumerate(names):
            out[name] = [res[r][i] for r in range(n)]
    return out


def _jax_step(m, distill: bool) -> dict:
    """JAX's single-device loss, gradients, global norm and one step, in
    one compiled program (``torch_train_ref.jax_step``)."""
    return train_ref.jax_step(m["jcfg"], m["jp"], m["jl"],
                              m["distill_batch"] if distill else m["batch"],
                              _jtc())


def _port_one_rank(m, distill: bool) -> dict:
    """The port's loss, gradients and global norm in this process, on
    the whole tree and the whole batch (no mesh)."""
    batch = {k: torch.from_numpy(v) for k, v in (
        m["distill_batch"] if distill else m["batch"]).items()}
    loss, grads = steps.make_lkv_grad(m["tcfg"], distill=distill)(
        bridge.to_torch(m["np_params"], device="cpu"),
        bridge.to_torch(m["np_lkv"], device="cpu"), batch)
    _, norm = tadam.clip_by_global_norm(grads, 1.0)
    lkv = bridge.to_torch(m["np_lkv"], device="cpu")
    _, opt, _ = tadam.update(lkv, grads, tadam.init(lkv), TrainConfig(
        steps=SCHEDULE, lr=LR, batch_size=B, n_in=N_IN, n_out=N_OUT))
    return dict(loss=float(loss), norm=float(norm),
                grads=[g.numpy() for g in tadam.leaves(grads)],
                mu=[g.numpy() for g in tadam.leaves(opt.mu)],
                nu=[g.numpy() for g in tadam.leaves(opt.nu)])


@pytest.fixture(scope="module")
def worlds(models, tmp_path_factory):
    """(the spawned worlds' results, {(model, distill): JAX's step});
    the ranks on one CPU thread each, the JAX programs compiled
    meanwhile in this process."""
    box: dict = {}
    tmp = tmp_path_factory.mktemp("train_mesh")

    def spawn():
        try:
            box["out"] = _spawn_worlds(models, tmp)
        except BaseException as e:  # re-raised below
            box["err"] = e

    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # read by the spawned ranks
        th = threading.Thread(target=spawn)
        th.start()
        try:
            for name in models:
                for distill in (False, True) if name in DISTILLED else (
                        False,):
                    refs[name, distill] = _jax_step(models[name], distill)
                    refs[name, distill]["port"] = _port_one_rank(
                        models[name], distill)
        finally:
            th.join()
    if "err" in box:
        raise box["err"]
    return box["out"], refs, tmp


def _close_rel(got, want, rel):
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(got - want).max() <= rel * scale


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_sharded_step_matches_jax_single_device(worlds, case):
    out, refs, _ = worlds
    spec = next(c for c in STEP_CASES if c[0] == case)
    want = refs[spec[1], spec[5]]
    ranks = out[case]
    r0 = ranks[0]
    assert len(r0["losses"]) == 1
    for r in ranks:  # every rank: the same loss and the same modules
        assert r["losses"] == r0["losses"]
        for a, b in zip(tadam.leaves(r["lkv"]), tadam.leaves(r0["lkv"])):
            assert np.array_equal(a, b)
    np.testing.assert_allclose(r0["losses"][0], want["step_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(r0["losses"][0], want["loss"], rtol=1e-5)
    one = want["port"]
    np.testing.assert_allclose(r0["grad_norms"][0], one["norm"], rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norms"][0], want["norm"], rtol=1e-4)
    got = {"grads": tadam.leaves(r0["grads"][0]),
           "mu": tadam.leaves(r0["opt"]["mu"]),
           "nu": tadam.leaves(r0["opt"]["nu"])}
    assert int(r0["opt"]["step"]) == 1
    for i, name in enumerate(want["names"]):
        g_want = want["grads"][i]
        if name in train_ref.UNUSED:  # whisper's: zeros in both packages
            for what in ("grads", "mu", "nu"):
                assert not got[what][i].any(), (case, name, what)
                assert not want[what][i].any(), (case, name, what)
            continue
        scale = np.abs(g_want).max()
        assert scale > 0, f"{name}: JAX gradient is zero"
        for what, rel in (("grads", 1e-4), ("mu", 2e-4), ("nu", 4e-4)):
            w = g_want if what == "grads" else want[what][i]
            assert got[what][i].shape == w.shape, (name, what)
            assert _close_rel(got[what][i], w, rel), (case, name, what)
            assert _close_rel(got[what][i], one[what][i], rel / 10), (
                case, name, what, "one process")
        new = tadam.leaves(r0["lkv"])[i]
        big = np.abs(g_want) > 1e-3 * scale
        err = np.abs(new - want["lkv"][i])
        assert err[big].max() <= 1e-6, (case, name)
        assert err.max() <= 2 * LR, (case, name)


def test_autograd_collectives_match_one_rank(worlds):
    """The gather and ``enter_sharded`` over 2 ranks give every
    replicated leaf the gradient the same products give on one rank."""
    out, _, _ = worlds
    job = _collective_job()
    leaves = {k: torch.tensor(job[k], requires_grad=True)
              for k in ("x", "a", "b")}
    loss = two_products(leaves["x"], torch.tensor(job["w1"]),
                        torch.tensor(job["w2"]),
                        {"a": leaves["a"], "b": leaves["b"]},
                        torch.tensor(job["c"]))
    want = dict(zip(leaves, torch.autograd.grad(loss,
                                                list(leaves.values()))))
    for r in out["collectives"]:
        np.testing.assert_allclose(r["loss"], float(loss.detach()), rtol=1e-12)
        for k, w in want.items():
            np.testing.assert_allclose(r[k], w.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(w.abs().max()))


def _bits(path) -> dict:
    return {k: v.reshape(-1).view(torch.uint8)
            for k, v in tckpt.load(path).items()}


def test_killed_and_resumed_mesh_run_is_bit_exact(worlds):
    out, _, tmp = worlds
    straight, killed, resumed = (out[k][0] for k in ("straight", "killed",
                                                      "resumed"))
    assert killed["step"] == 3
    assert straight["losses"][:3] == killed["losses"]
    assert straight["losses"][2:] == resumed["losses"]
    for name in ("straight", "resumed"):  # every rank the same losses
        assert all(r["losses"] == out[name][0]["losses"] for r in out[name])
    a, b = _bits(tmp / "s.npz"), _bits(tmp / "k.npz")
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert tckpt.metadata(str(tmp / "k.npz"))["step"] == 6


def test_mesh_checkpoint_resumes_in_one_process(worlds, models, tmp_path):
    """The (2, 1) mesh's periodic save at step 2, resumed by the
    one-process trainer: its four losses follow the mesh's straight run
    (the one process takes the batch's mean where the mesh averages its
    two rows' means: 1e-5 relative)."""
    out, _, tmp = worlds
    path = str(tmp_path / "k1.npz")
    shutil.copy(tmp / "k1.npz", path)
    assert tckpt.metadata(path)["step"] == 2
    one = train.train_job(_resume_job(models["llama"], path, resume=True))
    assert len(one["losses"]) == 4 and one["step"] == 6
    np.testing.assert_allclose(one["losses"], out["straight"][0]["losses"][2:],
                               rtol=1e-5)


def test_refusals(models):
    m = models["llama"]
    cfg = m["tcfg"]
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        train.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                    "--mesh", "pod", "--steps", "1"])
    # a global batch of 3 over 2 data rows (a shape-only mesh: the
    # refusal comes before any collective)
    job = _step_job(m, None, False, False, "unused.npz")
    job["batches"] = [{"x": m["toks"][:1, :N_IN].repeat(3, 0),
                       "xy": m["toks"][:1].repeat(3, 0)}]
    with pytest.raises(ValueError, match="does not divide"):
        train.train_job(job, mesh=Mesh(("data", "model"), (2, 1)))
    m2 = Mesh(("data", "model"), (1, 2))
    lm = dataclasses.replace(cfg, technique_applies=False)
    with pytest.raises(ValueError, match="LM variant"):
        steps.make_train_step(lm, TrainConfig(), mesh=m2)
    toks = torch.from_numpy(m["toks"])
    with pytest.raises(ValueError, match="serving routes take no mesh"):
        ttf.prefill({}, cfg, toks, policy="lookaheadkv", mesh=m2)
    # ZeRO storage over a data axis of 2: the frozen weights' gathers
    zero = dataclasses.replace(cfg, fsdp=True)
    params = ttf.init_params(zero, device="cpu")
    params["layers"]["attn"]["wq"].requires_grad_(True)
    gathers = ttf.layer_gathers(zero, Mesh(("data", "model"), (2, 1)))
    with pytest.raises(ValueError, match="frozen"):
        ttf._layer_params(params, 0, gathers,
                          Mesh(("data", "model"), (2, 1)))
    # and a column-sliced weight (the products' backward computes none)
    with pytest.raises(ValueError, match="frozen"):
        attn_mod.column_linears(torch.zeros(1, 4),
                                [torch.zeros(4, 2, requires_grad=True)], m2)
