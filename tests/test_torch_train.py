"""The port's trainer and the serve half of the learning loop, on the CPU.

The JAX trainer's ``train.main`` fails on a CPU host under its host mesh,
so it is not the oracle here: the port's ``launch/train.py`` is held to
its own gates (the loss falls, checkpoints round-trip, a killed and
resumed run is bit-exact), and the serve half is held to the JAX
package's engines.

* ``--verify`` passes at llama3-8b smoke width on the synthetic mixture;
* a run killed after step 3 (``--stop-after``, the last ``--ckpt-every``
  save at step 2) and resumed (``--resume``) ends with the checkpoint and
  the losses of the straight run, bit for bit, on the synthetic mixture
  and on a harvested dataset;
* ``--mesh pod`` in a world of one process raises ``ValueError`` naming
  the 256 ranks the production mesh needs (the trainer under a mesh:
  ``tests/test_torch_train_mesh.py``), and ``--device cuda`` without a
  card raises (no fallback to the CPU);
* a JAX-written checkpoint served by the port (``load_lookahead_params``
  into the lockstep ``ServingEngine``, and ``ServingConfig.lkv_checkpoint``
  into ``ContinuousEngine``) gives the greedy tokens of JAX's engines
  given the same modules, and ``serve --lkv-ckpt`` serves what the same
  modules give in memory.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServing
from repro.serving import ServingEngine as JLockstep
from repro_torch import bridge
from repro_torch.checkpoint import io as tckpt
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.lookahead import load_lookahead_params
from repro_torch.data import harvest
from repro_torch.launch import serve, train
from repro_torch.serving import (ChunkingConfig, ContinuousEngine, Request,
                                 ServingConfig, ServingEngine)

SMOKE = ["--arch", "llama3-8b", "--smoke", "--device", "cpu"]


def _bits(path) -> dict:
    return {k: v.reshape(-1).view(torch.uint8)
            for k, v in tckpt.load(path).items()}


def test_verify_passes_at_smoke_width(tmp_path, capsys):
    out = train.main(SMOKE + ["--steps", "40", "--verify",
                              "--ckpt", str(tmp_path / "lkv.npz")])
    assert "train-smoke verdict: PASS" in capsys.readouterr().out
    assert min(out["losses"][1:]) < out["losses"][0]
    assert tckpt.metadata(str(tmp_path / "lkv.npz"))["step"] == 40


@pytest.fixture(scope="module")
def harvest_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("harvest"))
    harvest.main(SMOKE + ["--out", out, "--requests", "6", "--chunk", "16",
                          "--budget", "32", "--max-new", "4", "--max-obs",
                          "4", "--slots", "2", "--seed", "3"])
    return out


@pytest.mark.parametrize("source", ["synthetic", "harvest"])
def test_killed_and_resumed_run_is_bit_exact(source, harvest_dir, tmp_path):
    common = SMOKE + ["--steps", "6", "--batch", "2", "--ckpt-every", "2",
                      "--seed", "1"]
    if source == "harvest":
        common += ["--harvest", harvest_dir]
    straight = str(tmp_path / "straight.npz")
    killed = str(tmp_path / "killed.npz")
    full = train.main(common + ["--ckpt", straight])
    part = train.main(common + ["--ckpt", killed, "--stop-after", "3"])
    assert part["step"] == 3
    assert tckpt.metadata(killed)["step"] == 2  # the last periodic save
    rest = train.main(common + ["--ckpt", killed, "--resume"])
    assert full["losses"][:3] == part["losses"]
    assert full["losses"][2:] == rest["losses"]
    a, b = _bits(straight), _bits(killed)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert tckpt.metadata(killed)["step"] == 6


def test_trainer_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        train.main(SMOKE + ["--mesh", "pod", "--steps", "1"])
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        train.main(SMOKE + ["--mesh", "multipod", "--steps", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "llama3-8b", "--smoke", "--device", "cuda",
                    "--steps", "1", "--ckpt", str(tmp_path / "x.npz")])


# ---------------------------------------------------------------------------
# serving a JAX-written checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """float32 smoke model and perturbed modules; the JAX trainer's
    periodic-save layout ``{"lkv", "opt"}`` written by JAX."""
    from repro.optim import adam as jadam

    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(13)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "state.npz")
    jckpt.save(path, {"lkv": lkv, "opt": jadam.init(lkv)},
               metadata={"step": 3})
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (37, 50, 23)]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv, path=path,
                prompts=prompts,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"))


def test_jax_checkpoint_serves_jax_tokens_lockstep(jax_ckpt):
    m = jax_ckpt
    batch = np.stack([p[:23] for p in m["prompts"]])
    jdone = JLockstep(m["jp"], m["jcfg"], policy="lookaheadkv",
                      evict=JEvict(budget=16), lkv_params=m["jl"],
                      max_new_tokens=6, eos_id=-1).serve(
        [JRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(batch)])
    lkv = load_lookahead_params(m["path"], m["tcfg"], m["tp"]["layers"],
                                device="cpu")
    tdone = ServingEngine(m["tp"], m["tcfg"], policy="lookaheadkv",
                          evict=EvictionConfig(budget=16), lkv_params=lkv,
                          max_new_tokens=6, eos_id=-1, device="cpu").serve(
        [Request(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(batch)])
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]


def test_jax_checkpoint_serves_jax_tokens_continuous(jax_ckpt):
    m = jax_ckpt
    chunk, budget, new = 16, 16, 5
    jsc = JServing(policy="lookaheadkv", evict=JEvict(budget=budget),
                   chunking=JChunking(chunk=chunk, max_context=64),
                   num_slots=2, max_new_tokens=new, eos_id=-1)
    jdone = JEngine(m["jp"], m["jcfg"], jsc, lkv_params=m["jl"]).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=new)
         for i, p in enumerate(m["prompts"])])
    tsc = ServingConfig(policy="lookaheadkv",
                        evict=EvictionConfig(budget=budget),
                        chunking=ChunkingConfig(chunk=chunk, max_context=64),
                        num_slots=2, max_new_tokens=new, eos_id=-1,
                        lkv_checkpoint=m["path"])
    tdone = ContinuousEngine(m["tp"], m["tcfg"], tsc, device="cpu").run(
        [Request(uid=i, prompt=p, max_new_tokens=new)
         for i, p in enumerate(m["prompts"])])
    want = {r.uid: r.out_tokens for r in jdone}
    assert {r.uid: r.out_tokens for r in tdone} == want


@pytest.mark.parametrize("route", [[], ["--continuous", "--chunk", "16"]])
def test_serve_lkv_ckpt_serves_the_modules(route, tmp_path):
    """``--lkv-ckpt`` on the lockstep and the dense continuous route: the
    same tokens as the launcher's engine given the loaded modules in
    memory."""
    ck = str(tmp_path / "lkv.npz")
    trained = train.main(SMOKE + ["--steps", "3", "--ckpt", ck])
    argv = SMOKE + ["--budget", "16", "--n-in", "40", "--max-new", "6",
                    "--requests", "3"] + route
    res = serve.run(argv + ["--lkv-ckpt", ck])
    reqs = sorted(res["done"], key=lambda r: r.uid)
    eng = serve.build_engine(serve.parse_args(argv), res["cfg"],
                             res["engine"].params, trained["lkv"])
    again = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=6)
             for r in reqs]
    done = eng.serve(again) if not route else eng.run(again)
    assert [r.out_tokens for r in sorted(done, key=lambda r: r.uid)] == [
        r.out_tokens for r in reqs]
