"""The port's three serving routes under every single-pass policy they
take, end to end against the JAX package's engines, on the CPU.

The same float32 smoke model (JAX parameters bridged) serves the same
requests (each with its own ``seed``, which ``random`` draws from)
through both packages:

* the paged ``ContinuousEngine`` with decode-time eviction (interval 8,
  so sweeps fire): per request the greedy tokens and the admission and
  retirement kept (layer, kv head, position) sets, and the counts of
  sweeps and blocks reclaimed mid-generation;
* the ``ContinuousEngine`` on dense slot caches: tokens and admission
  kept sets;
* the lockstep ``ServingEngine``: tokens, and the kept sets of its
  prefill (``policies.run_eviction`` with the requests' seeds);

under h2o, snapkv, pyramidkv, tova, streaming_llm and random (and, on
the paged engine, lookaheadkv with adaptive head budgets; on the lockstep
engine, full).  Then what the engines refuse: gt_oracle on both
engines, and on the chunked engine full and the draft-based policies,
which go to ``BucketedEngine`` (with the JAX engine's words); the
lockstep engine serves the draft-based policies; the launcher sends
``--continuous`` with full or laq to ``BucketedEngine``, and speckv,
which has no draft model there, fails as in the JAX launcher.  Tokens,
kept sets and counts must be identical.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core import policies as jpol
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import DecodeEvictionConfig as JDecodeEvict
from repro.serving import KVBlockPool as JPool
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServing
from repro.serving import ServingEngine as JLockstep
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import policies as tpol
from repro_torch.launch import serve
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 DecodeEvictionConfig, KVBlockPool, Request,
                                 ServingConfig, ServingEngine)

POLICIES = ["h2o", "snapkv", "pyramidkv", "tova", "streaming_llm", "random"]
LENS = [37, 11, 50, 23]


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(9)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"),
                tl=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                   device="cpu"))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _kept(mask, pos):
    """{(layer, kv head): kept positions} of a (L, rows, KV) cache view."""
    L, _, KV = mask.shape
    return {(lyr, h): frozenset(pos[lyr, mask[lyr, :, h], h].tolist())
            for lyr in range(L) for h in range(KV)}


def _admitted(req):
    a = req.admission_cache
    return _kept(a["mask"][:, 0], a["pos"][:, 0])


def _retired(req):
    rc = req.retirement_cache
    assert rc is not None, "capture_admission must stash retirement_cache"
    return _kept(rc["mask"], rc["pos"])


def _serve_both(m, policy, prompts, max_new, *, alloc="uniform",
                pool_blocks=None, decode_evict=False):
    """The same requests through the JAX and the port's continuous
    engine; returns ({uid: request} JAX, {uid: request} port, JAX engine,
    port engine)."""
    kw = dict(policy=policy, max_new_tokens=max_new, eos_id=-1,
              capture_admission=True, num_slots=2)
    jsc = JServing(
        evict=JEvict(budget=16, head_alloc=alloc),
        chunking=JChunking(chunk=16, max_context=max(LENS)),
        decode_evict=JDecodeEvict(enabled=decode_evict, interval=8),
        kv_pool=(JPool(m["jcfg"], block_size=4, num_blocks=pool_blocks)
                 if pool_blocks else None), **kw)
    jeng = JEngine(m["jp"], m["jcfg"], jsc, lkv_params=m["jl"])
    jdone = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=max_new,
                               seed=100 + 7 * i)
                      for i, p in enumerate(prompts)])
    tsc = ServingConfig(
        evict=EvictionConfig(budget=16, head_alloc=alloc),
        chunking=ChunkingConfig(chunk=16, max_context=max(LENS)),
        decode_evict=DecodeEvictionConfig(enabled=decode_evict, interval=8),
        kv_pool=(KVBlockPool(m["tcfg"], block_size=4, num_blocks=pool_blocks,
                             device="cpu") if pool_blocks else None), **kw)
    # only lookaheadkv reads lookahead modules
    teng = ContinuousEngine(
        m["tp"], m["tcfg"], tsc,
        lkv_params=m["tl"] if policy == "lookaheadkv" else None,
        device="cpu")
    tdone = teng.run([Request(uid=i, prompt=p, max_new_tokens=max_new,
                              seed=100 + 7 * i)
                      for i, p in enumerate(prompts)])
    assert len(tdone) == len(jdone) == len(prompts)
    return ({r.uid: r for r in jdone}, {r.uid: r for r in tdone}, jeng,
            teng)


@pytest.mark.parametrize("policy,alloc", [(p, "uniform") for p in POLICIES]
                         + [("lookaheadkv", "adaptive")])
def test_paged_engine_with_decode_eviction_matches_jax(model, policy, alloc):
    prompts = _prompts(21, LENS)
    want, got, jeng, teng = _serve_both(model, policy, prompts, 20,
                                        alloc=alloc, pool_blocks=96,
                                        decode_evict=True)
    assert teng.capacity == jeng.capacity
    for uid, w in want.items():
        g = got[uid]
        assert g.out_tokens == w.out_tokens, f"uid {uid}: tokens"
        assert len(g.out_tokens) == 20
        assert _admitted(g) == _admitted(w), f"uid {uid}: admission"
        assert _retired(g) == _retired(w), f"uid {uid}: retirement"
    sweeps = teng.counts["decode_evict_sweeps"]
    assert sweeps > 0
    assert sweeps == int(jeng.metrics.value(
        "serving_decode_evict_sweeps_total"))
    assert teng.pool.blocks_reclaimed_decode == \
        jeng.pool.blocks_reclaimed_decode
    teng.pool.check()
    assert teng.pool.used_blocks() == 0 and teng.pool.reserved == 0


@pytest.mark.parametrize("policy", POLICIES)
def test_dense_slot_engine_matches_jax(model, policy):
    prompts = _prompts(10, LENS + [64])
    want, got, jeng, teng = _serve_both(model, policy, prompts, 6)
    assert teng.capacity == jeng.capacity
    for uid, w in want.items():
        g = got[uid]
        assert g.out_tokens == w.out_tokens, f"uid {uid}: tokens"
        assert _admitted(g) == _admitted(w), f"uid {uid}: admission"
    assert teng.counts["max_concurrency"] == 2


@pytest.mark.parametrize("policy", POLICIES + ["full"])
def test_lockstep_engine_matches_jax(model, policy):
    prompts = _prompts(4, [41] * 3)
    max_new = 7
    reqs = [dict(uid=i, prompt=p, max_new_tokens=max_new, seed=50 + i)
            for i, p in enumerate(prompts)]
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JLockstep(model["jp"], model["jcfg"], policy=policy,
                         evict=JEvict(budget=16), max_new_tokens=max_new,
                         eos_id=-1)
    jdone = jeng.serve([JRequest(**r) for r in reqs])
    teng = ServingEngine(model["tp"], model["tcfg"], policy=policy,
                         evict=EvictionConfig(budget=16),
                         max_new_tokens=max_new, eos_id=-1, device="cpu")
    tdone = teng.serve([Request(**r) for r in reqs])
    for j, t in zip(jdone, tdone):
        assert t.out_tokens == j.out_tokens, f"uid {t.uid}: tokens diverged"
        assert len(t.out_tokens) == max_new
    # the kept sets of the batch's prefill, with the requests' seeds
    tokens = np.stack(prompts)
    seeds = np.asarray([r["seed"] for r in reqs], np.int32)
    jr = jpol.run_eviction(policy, model["jp"], model["jcfg"],
                           jnp.asarray(tokens), evict=JEvict(budget=16),
                           extra_slots=max_new + 1, seeds=jnp.asarray(seeds))
    tr = tpol.run_eviction(policy, model["tp"], model["tcfg"],
                           torch.from_numpy(tokens),
                           evict=EvictionConfig(budget=16),
                           extra_slots=max_new + 1,
                           seeds=torch.from_numpy(seeds))
    ja = {k: np.asarray(v) for k, v in jr.cache["attn"].items()}
    ta = {k: v.numpy() for k, v in tr.cache["attn"].items()}
    assert ta["mask"].shape == ja["mask"].shape
    for b in range(len(prompts)):
        assert _kept(ta["mask"][:, b], ta["pos"][:, b]) == _kept(
            ja["mask"][:, b], ja["pos"][:, b]), f"row {b}: kept sets"
    assert teng.cache_bytes(41) == jeng.cache_bytes(41)
    assert teng.kv_device_bytes(3) == jeng.kv_device_bytes(3)


# ---------------------------------------------------------------------------
# refusals and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,exc,item", [
    ("gt_oracle", ValueError, "response"),
    ("full", ValueError, "use BucketedEngine"),
    (None, ValueError, "needs an eviction policy"),
    ("laq", ValueError, "cannot stream; use BucketedEngine"),
    ("speckv", ValueError, "cannot stream; use BucketedEngine"),
    ("no-such-policy", ValueError, "unknown policy"),
])
def test_continuous_engine_refuses(policy, exc, item):
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    with pytest.raises(exc, match=item):
        ContinuousEngine({}, cfg, ServingConfig(policy=policy),
                         lkv_params={}, device="cpu")


@pytest.mark.parametrize("policy,exc,item", [
    ("gt_oracle", ValueError, "response"),
    # the draft-based policies are served (speckv with a draft model, here
    # the target model itself; without one it fails at the first prefill)
    ("laq", None, None),
    ("speckv", ValueError, "speckv needs a draft model"),
])
def test_lockstep_engine_refuses(model, policy, exc, item):
    cfg = model["tcfg"]
    if policy == "gt_oracle":
        with pytest.raises(exc, match=item):
            ServingEngine({}, cfg, policy=policy, device="cpu")
        return
    prompts = _prompts(17, [30, 30])
    evict = EvictionConfig(budget=8, draft_len=4)
    jevict = JEvict(budget=8, draft_len=4)

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]

    if exc is not None:
        with pytest.raises(exc, match=item):
            ServingEngine(model["tp"], cfg, policy=policy, evict=evict,
                          max_new_tokens=5, device="cpu").serve(reqs(Request))
    draft = dict(draft_params=model["tp"], draft_cfg=cfg)
    got = ServingEngine(model["tp"], cfg, policy=policy, evict=evict,
                        max_new_tokens=5, eos_id=-1, device="cpu",
                        **draft).serve(reqs(Request))
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        want = JLockstep(model["jp"], model["jcfg"], policy=policy,
                         evict=jevict, max_new_tokens=5, eos_id=-1,
                         draft_params=model["jp"],
                         draft_cfg=model["jcfg"]).serve(reqs(JRequest))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


@pytest.mark.parametrize("argv", [
    ["--continuous", "--policy", "full"],
    ["--continuous", "--kv-pool-mb", "1", "--policy", "full"],
    ["--continuous", "--policy", "laq"],
    ["--policy", "speckv"],
])
def test_launcher_refuses_what_the_jax_launcher_sends_to_bucketed(argv):
    """What the JAX launcher sends to its ``BucketedEngine`` the port's
    now serves there too; ``--policy speckv`` gets no draft model from
    either launcher and fails at its first prefill."""
    run = ["--arch", "tiny-llama", "--smoke", "--device", "cpu",
           "--requests", "2", "--n-in", "40", "--max-new", "3", *argv]
    if "speckv" in argv:
        with pytest.raises(ValueError, match="speckv needs a draft model"):
            serve.run(run)
        return
    res = serve.run(run)
    assert type(res["engine"]).__name__ == "BucketedEngine"
    assert [len(r.out_tokens) for r in res["done"]] == [3, 3]


@pytest.mark.parametrize("route", [[], ["--continuous"],
                                   ["--continuous", "--kv-pool-mb", "1"]])
@pytest.mark.parametrize("policy", ["h2o", "snapkv", "random"])
def test_launcher_serves_policies_without_lookahead_modules(
        capsys, route, policy):
    res = serve.run(["--arch", "tiny-llama", "--smoke", "--device", "cpu",
                     "--policy", policy, "--budget", "16", "--chunk", "32",
                     "--requests", "2", "--n-in", "40", "--max-new", "3",
                     *route])
    assert res["engine"].lkv_params is None
    assert res["engine"].policy == policy
    assert [len(r.out_tokens) for r in res["done"]] == [3, 3]
