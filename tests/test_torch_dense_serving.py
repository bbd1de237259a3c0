"""The port's lockstep ``ServingEngine`` and its ``ContinuousEngine`` on
dense slot caches, end to end against the JAX package's engines, on the
CPU; and the launcher's dispatch between the three ways of serving.

The same float32 smoke model (JAX parameters bridged) serves the same
requests through both packages.  Per request, the greedy tokens must be
identical, and for the continuous engine also the admission kept (layer,
head, position) sets.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.serving import (ChunkingConfig, ContinuousEngine, Request,
                                 ServingConfig, ServingEngine)


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


def _kept_sets(adm):
    m, p = adm["mask"], adm["pos"]
    L, _, _, KV = m.shape
    return {(lyr, h): frozenset(p[lyr, 0, m[lyr, 0, :, h], h].tolist())
            for lyr in range(L) for h in range(KV)}


def test_lockstep_engine_matches_jax(model):
    rng = np.random.default_rng(4)
    n_in, max_new = 41, 7
    prompts = [rng.integers(0, 512, n_in).astype(np.int32) for _ in range(3)]
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JLockstep(model["jp"], model["jcfg"], policy="lookaheadkv",
                         evict=JEvict(budget=16), lkv_params=model["jl"],
                         max_new_tokens=max_new, eos_id=-1)
    jdone = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=max_new)
                        for i, p in enumerate(prompts)])
    teng = ServingEngine(model["tp"], model["tcfg"], policy="lookaheadkv",
                         evict=EvictionConfig(budget=16),
                         lkv_params=model["tl"], max_new_tokens=max_new,
                         eos_id=-1, device="cpu")
    tdone = teng.serve([Request(uid=i, prompt=p, max_new_tokens=max_new)
                        for i, p in enumerate(prompts)])
    for j, t in zip(jdone, tdone):
        assert t.out_tokens == j.out_tokens, f"uid {t.uid}: tokens diverged"
        assert len(t.out_tokens) == max_new and t.done
    assert teng.cache_bytes(n_in) == jeng.cache_bytes(n_in)
    assert teng.kv_device_bytes(3) == jeng.kv_device_bytes(3)
    with pytest.raises(ValueError, match="prompt length"):
        teng.serve([Request(uid=0, prompt=prompts[0], max_new_tokens=2),
                    Request(uid=1, prompt=prompts[1][:9], max_new_tokens=2)])


def test_dense_slot_engine_matches_jax(model):
    """Mixed prompt lengths (shorter than the budget, not chunk multiples)
    and more requests than slots, on dense slot caches."""
    rng = np.random.default_rng(10)
    lens, max_new, chunk, budget = [37, 11, 50, 23, 64], 6, 16, 16
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    jsc = JServing(policy="lookaheadkv", evict=JEvict(budget=budget),
                   chunking=JChunking(chunk=chunk, max_context=max(lens)),
                   num_slots=2, max_new_tokens=max_new, eos_id=-1,
                   capture_admission=True)
    jdone = JEngine(model["jp"], model["jcfg"], jsc,
                    lkv_params=model["jl"]).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=max_new)
         for i, p in enumerate(prompts)])
    tsc = ServingConfig(
        policy="lookaheadkv", evict=EvictionConfig(budget=budget),
        chunking=ChunkingConfig(chunk=chunk, max_context=max(lens)),
        num_slots=2, max_new_tokens=max_new, eos_id=-1,
        capture_admission=True)
    eng = ContinuousEngine(model["tp"], model["tcfg"], tsc,
                           lkv_params=model["tl"], device="cpu")
    tdone = eng.run([Request(uid=i, prompt=p, max_new_tokens=max_new)
                     for i, p in enumerate(prompts)])
    want = {r.uid: r for r in jdone}
    got = {r.uid: r for r in tdone}
    assert sorted(got) == sorted(want) == list(range(len(lens)))
    for uid, w in want.items():
        g = got[uid]
        assert g.out_tokens == w.out_tokens, f"uid {uid}: tokens diverged"
        assert len(g.out_tokens) == max_new
        assert _kept_sets(g.admission_cache) == _kept_sets(
            w.admission_cache), f"uid {uid}: kept sets diverged"
    assert eng.counts["max_concurrency"] == 2
    assert eng.kv_device_bytes() == 2 * (budget + max_new + 1) * 2 * 2 * 64 * 4


@pytest.mark.parametrize("argv,kind,paged", [
    ([], ServingEngine, False),
    (["--continuous"], ContinuousEngine, False),
    (["--continuous", "--kv-pool-mb", "1"], ContinuousEngine, True),
    (["--kv-pool-mb", "1"], ServingEngine, False),  # the JAX launcher too
])
def test_launcher_dispatch(argv, kind, paged):
    """No --continuous: the lockstep engine; --continuous: the chunked
    engine, paged with --kv-pool-mb, on dense slot caches without it."""
    args = serve.parse_args(["--arch", "tiny-llama", "--smoke", "--device",
                             "cpu", *argv])
    cfg = get_smoke_config("tiny-llama")
    params = serve.tf.init_params(cfg, seed=0, device="cpu")
    lkv = serve.init_lookahead_params(
        serve.torch.Generator().manual_seed(1), cfg, params["layers"])
    eng = serve.build_engine(args, cfg, params, lkv)
    assert type(eng) is kind
    assert (getattr(eng, "pool", None) is not None) == paged


@pytest.mark.parametrize("extra,engine", [
    ([], "ServingEngine:"),
    (["--continuous"], "ContinuousEngine:"),
])
def test_serve_launcher_routes_on_cpu(capsys, extra, engine):
    serve.main(["--arch", "tiny-llama", "--smoke", "--device", "cpu",
                "--budget", "16", "--chunk", "32", "--requests", "3",
                "--n-in", "40", "--max-new", "4", *extra])
    out = capsys.readouterr().out
    assert out.startswith(engine) and "requests=3" in out
    assert "cache_ratio=" in out and out.count("4 tokens") == 3
    with pytest.raises(ValueError, match="--continuous"):
        serve.parse_args(["--prompt-lens", "40,50"])
