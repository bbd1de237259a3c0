"""Tensor-parallel serving of the port against the JAX package's
single-device engine (ROADMAP A11, serving half).

The JAX test (``tests/test_sharded_serving.py``) proves its sharded
``ContinuousEngine`` bit-exact against a single device on a forced
8-device host.  Here the port's ranks are processes: each world of 2 or 4
ranks (gloo, a ``file://`` store in ``tmp_path``, collectives timing out
after 60 s, the world joined within a time limit) is spawned once for
the module and serves every case in that one spawn
(``launch.serve.serve_shards``), each rank on its shard of the JAX
package's own weights (``bridge.shard_to_torch``).  On the JAX test's
geometry (smollm-smoke-tp: 8 q / 4 kv heads of 16, d_model 128) in
float32, every request's tokens and its kept sets, the ranks' local kv
heads gathered to global ones, must equal the JAX single-device engine's
on a trace with staggered arrivals: paged h2o and lookaheadkv at 2 and 4
ranks, dense-slot and sampled lookaheadkv at 2.  Also the mesh in the
engine's stats, the pool's bytes per shard, the refusals left, and the
launcher's ``--mesh-model``.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.core.policies import Sampling as JSampling
from repro.models import transformer as jtf
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import KVBlockPool as JPool
from repro.serving import ServingConfig as JServing
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.policies import Sampling
from repro_torch.launch import serve
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 DecodeEvictionConfig, KVBlockPool, Request,
                                 ServingConfig)
from trace_utils import kept_sets, make_trace_requests

CHUNK, BUDGET, MAX_NEW, BLOCKS = 32, 8, 4, 64
SAMPLING = (0.7, 50, 0.9)
#: (name, policy, paged, sampled, world sizes)
CASES = (("paged-h2o", "h2o", True, False, (2, 4)),
         ("paged-lookaheadkv", "lookaheadkv", True, False, (2, 4)),
         ("dense-lookaheadkv", "lookaheadkv", False, False, (2,)),
         ("paged-sampled", "lookaheadkv", True, True, (2,)))


def _tp(base):
    """The JAX test's geometry: 8 q over 4 kv heads, so 2 and 4 divide."""
    return dataclasses.replace(
        base, name="smollm-smoke-tp", d_model=128, dtype="float32",
        attn=dataclasses.replace(base.attn, num_heads=8, num_kv_heads=4,
                                 head_dim=16))


@pytest.fixture(scope="module")
def model():
    jcfg = _tp(jax_smoke("smollm-135m"))
    tcfg = _tp(get_smoke_config("smollm-135m"))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jl = jax_init_lkv(jax.random.PRNGKey(1), jcfg, jp["layers"])
    reqs = make_trace_requests(jcfg, chunk=CHUNK, seed=3, n_requests=3,
                               max_new=MAX_NEW)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jl=jl, reqs=reqs,
                np_params=jax.tree.map(np.asarray, jp),
                np_lkv=jax.tree.map(np.asarray, jl))


def _chunking(reqs, chunking):
    return chunking(chunk=CHUNK, max_context=max(len(r.prompt) for r in reqs),
                    decode_chunk=2)


_JAX_RUNS: dict = {}


def _jax_run(m, policy, paged, sampled):
    """The JAX single-device serve of the trace, once per case."""
    key = (policy, paged, sampled)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_serve(m, policy, paged, sampled)
    return _JAX_RUNS[key]


def _jax_serve(m, policy, paged, sampled):
    reqs = m["reqs"]
    sc = JServing(
        policy=policy, evict=JEvict(budget=BUDGET),
        chunking=_chunking(reqs, JChunking), num_slots=2,
        max_new_tokens=MAX_NEW, eos_id=-1, capture_admission=True,
        kv_pool=(JPool(m["jcfg"], block_size=16, num_blocks=BLOCKS)
                 if paged else None),
        sampling=JSampling(*SAMPLING) if sampled else None)
    eng = JEngine(m["jp"], m["jcfg"], sc,
                  lkv_params=m["jl"] if policy == "lookaheadkv" else None)
    return {r.uid: r for r in eng.run([r.clone() for r in reqs])}


def _job(m, policy, paged, sampled):
    reqs = [Request(uid=r.uid, prompt=np.asarray(r.prompt),
                    max_new_tokens=r.max_new_tokens, arrival_s=r.arrival_s)
            for r in m["reqs"]]
    sc = ServingConfig(
        policy=policy, evict=EvictionConfig(budget=BUDGET),
        chunking=_chunking(reqs, ChunkingConfig), num_slots=2,
        max_new_tokens=MAX_NEW, eos_id=-1, capture_admission=True,
        sampling=Sampling(*SAMPLING) if sampled else None)
    return dict(cfg=m["tcfg"], device="cpu", serving=sc, requests=reqs,
                pool=dict(block_size=16, num_blocks=BLOCKS) if paged
                else None, params=m["np_params"],
                lkv=m["np_lkv"] if policy == "lookaheadkv" else None)


@pytest.fixture(scope="module")
def worlds(model, tmp_path_factory):
    """{world size: {case name: per-rank results}}, one spawn per size,
    each rank on one CPU thread (gloo ranks on a shared box)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        for n in (2, 4):
            cases = [c for c in CASES if n in c[4]]
            jobs = [_job(model, *c[1:4]) for c in cases]
            store = str(tmp_path_factory.mktemp(f"world{n}") / "store")
            res = spawn_ranks(serve.serve_shards, n, (jobs,),
                              init_file=store, timeout_s=60.0, join_s=180.0)
            out[n] = {c[0]: [res[r][i] for r in range(n)]
                      for i, c in enumerate(cases)}
    return out


def _gathered_kept(ranks, uid):
    """The kept sets of ``uid`` with each rank's local kv heads gathered
    to global kv-head indices (rank r's head h is r * KV/N + h)."""
    caches = [next(r for r in rk["done"] if r.uid == uid).admission_cache
              for rk in ranks]
    return kept_sets({f: np.concatenate([c[f] for c in caches], axis=-1)
                      for f in ("mask", "pos")})


@pytest.mark.parametrize("case,n", [(c[0], n) for c in CASES
                                    for n in c[4]])
def test_sharded_serving_matches_jax_single_device(model, worlds, case, n):
    _, policy, paged, sampled, _ = next(c for c in CASES if c[0] == case)
    want = _jax_run(model, policy, paged, sampled)
    ranks = worlds[n][case]
    for i, rk in enumerate(ranks):  # every rank serves the same tokens
        got = {r.uid: r for r in rk["done"]}
        assert {u: got[u].out_tokens for u in want} == \
            {u: w.out_tokens for u, w in want.items()}, f"rank {i}"
    for uid, w in want.items():
        assert _gathered_kept(ranks, uid) == kept_sets(w.admission_cache), \
            f"{case} n={n} uid={uid}: kept sets diverged"
    for i, rk in enumerate(ranks):
        assert rk["model_index"] == i
        assert rk["stats"]["mesh"] == {"data": 1, "model": n}
        if paged:
            s = rk["stats"]["kv_pool"]
            assert s["mesh_model"] == n
            assert s["bytes_total_per_shard"] == s["bytes_total"] // n
        assert rk["launches"] == {k: 0 for k in rk["launches"]}  # CPU


def _engine(cfg, mesh, **change):
    sc = ServingConfig(policy="h2o", evict=EvictionConfig(budget=BUDGET),
                       chunking=ChunkingConfig(chunk=CHUNK, max_context=64))
    return ContinuousEngine({}, cfg, sc.replace(mesh=mesh, **change),
                            device="cpu")


@pytest.mark.parametrize("what", [
    "pool-mesh", "decode-evict-pool", "pool-heads", "trainer"])
def test_refusals(model, what):
    """What the port still refuses under a mesh: what the JAX engine and
    pool assert raises ValueError, and the trainer's production mesh in a
    world smaller than its 256 ranks raises ValueError naming them (a
    data axis, MoE archs, the prefix cache and heads that do not divide
    are served: ``tests/test_torch_tp_mesh.py``; the trainer under a
    mesh: ``tests/test_torch_train_mesh.py``)."""
    cfg = model["tcfg"]
    m2 = Mesh(("data", "model"), (1, 2))
    if what == "pool-mesh":
        pool = KVBlockPool(cfg, num_blocks=BLOCKS, device="cpu")
        with pytest.raises(ValueError, match="different mesh"):
            _engine(cfg, m2, kv_pool=pool)
    elif what == "decode-evict-pool":
        pool = KVBlockPool(cfg, num_blocks=BLOCKS, device="cpu", mesh=m2)
        with pytest.raises(ValueError, match="single-device"):
            _engine(cfg, m2, kv_pool=pool,
                    decode_evict=DecodeEvictionConfig(enabled=True))
    elif what == "pool-heads":
        with pytest.raises(ValueError, match="must divide the model axis"):
            KVBlockPool(cfg, num_blocks=BLOCKS, device="cpu",
                        mesh=Mesh(("data", "model"), (1, 8)))
    else:
        from repro_torch.launch import train
        with pytest.raises(ValueError, match="256 ranks"):
            train.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        "--mesh", "pod"])


def test_pool_shards_kv_heads(model):
    """Each rank's pool holds whole blocks of its local kv heads; the
    allocator's geometry is the single-device pool's."""
    cfg = model["tcfg"]
    one = KVBlockPool(cfg, num_blocks=BLOCKS, device="cpu")
    two = KVBlockPool(cfg, num_blocks=BLOCKS, device="cpu",
                      mesh=Mesh(("data", "model"), (1, 2)))
    assert two.k.shape[:3] == one.k.shape[:3]
    assert two.k.shape[3] * 2 == one.k.shape[3]
    assert two.stats()["bytes_total_per_shard"] * 2 == \
        one.stats()["bytes_total_per_shard"]
    assert (two.block_bytes, two.usable_blocks) == \
        (one.block_bytes, one.usable_blocks)


def test_launcher_mesh_model(capfd, tmp_path, monkeypatch):
    """``--mesh-model 2`` serves through two spawned gloo ranks, rank 0
    printing and writing the metrics; the JAX launcher's notes where the
    flag does not apply."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # for the spawned ranks
    common = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
              "--budget", "16", "--chunk", "32", "--n-in", "64",
              "--requests", "2", "--max-new", "4"]
    out = tmp_path / "m.json"
    serve.main(common + ["--continuous", "--kv-pool-mb", "1",
                         "--mesh-model", "2", "--metrics-json", str(out)])
    text = capfd.readouterr().out
    assert "over 2 spawned ranks (gloo, every rank on cpu)" in text
    assert text.count("ContinuousEngine (paged)") == 1
    assert out.exists()
    serve.main(common + ["--mesh-model", "2"])
    assert "ignoring it" in capfd.readouterr().out
    serve.main(common + ["--continuous", "--mesh-model", "3"])
    assert "serving single-device" in capfd.readouterr().out
    with pytest.raises(ValueError, match="spawns them"):
        serve.run(common + ["--continuous", "--mesh-model", "2"])


def test_spawned_world_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the world with its traceback, after the
    other ranks have returned."""
    with pytest.raises(RuntimeError, match="(?s)rank 0.*math domain"):
        spawn_ranks(math.log, 2, init_file=str(tmp_path / "store"),
                    timeout_s=10.0, join_s=60.0)
