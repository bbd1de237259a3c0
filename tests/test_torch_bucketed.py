"""The bucket-padded serving route of the port against the JAX package, on
the CPU.

* The bucket helpers (``serving.batching``: ``bucket_for``,
  ``batch_bucket``, ``pad_to_bucket``, ``next_pow2``, the public forms'
  ``DeprecationWarning``) and ``SlotScheduler.next_prefill_group``: the
  JAX package's values and groups.
* ``BucketedEngine`` on mixed prompt lengths under lookaheadkv, full,
  snapkv and laq: greedy tokens identical to the JAX package's
  ``BucketedEngine``; under lookaheadkv also to an isolated batch-1
  lockstep run of each request (the JAX package's exactness guarantee).
* The launcher's routes: ``--continuous`` with full, laq and speckv
  builds a ``BucketedEngine`` (``--kv-pool-mb`` ignored with the JAX
  launcher's note), both routes evict with ``draft_len=8``, and speckv
  fails where the JAX launcher's assert does.

Float32 smoke config; prompts from numpy seeds; tokens compared exactly.
"""

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
from repro.serving import BucketedEngine as JBucketed
from repro.serving import Request as JRequest
from repro.serving import SlotScheduler as JScheduler
from repro.serving import batching as jbatching
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.serving import (BucketedEngine, Request, ServingEngine,
                                 SlotScheduler)
from repro_torch.serving import batching

BUCKETS = (16, 32, 64)
# mixed lengths: two share a bucket and are padded, one fills its bucket,
# one passes the largest bucket (its own power-of-two bucket), two share
# an exact length (laq's groups)
LENS = (20, 30, 32, 20, 70, 9)


# ---------------------------------------------------------------------------
# bucket helpers and bucket-grouped admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 9, 16, 17, 32, 33, 64, 65, 100, 1000])
def test_bucket_helpers_match_jax(n):
    for buckets in (BUCKETS, batching.DEFAULT_BUCKETS):
        with pytest.warns(DeprecationWarning):
            got = batching.bucket_for(n, buckets)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert got == jbatching.bucket_for(n, buckets)
    assert batching.DEFAULT_BUCKETS == jbatching.DEFAULT_BUCKETS
    assert batching.next_pow2(n) == jbatching.next_pow2(n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for cap in (1, 4, 16):
            assert batching.batch_bucket(min(n, 16), cap) == \
                jbatching.batch_bucket(min(n, 16), cap)
        rng = np.random.default_rng(n)
        prompts = [rng.integers(0, 512, m).astype(np.int32)
                   for m in (1, n % 17 + 1, 17)]
        for got, want in zip(batching.pad_to_bucket(prompts, 20, 4),
                             jbatching.pad_to_bucket(prompts, 20, 4)):
            np.testing.assert_array_equal(got, want)
    with pytest.warns(DeprecationWarning):
        batching.batch_bucket(3, 4)
    with pytest.warns(DeprecationWarning):
        batching.pad_to_bucket(prompts, 20, 4)


def _bucket(n):
    return batching._bucket_for(n, BUCKETS)


def test_next_prefill_group_matches_jax():
    """Groups of the FCFS head's bucket, capped by the free slots and
    ``max_prefill_batch``, requests arriving over time, slots freed by
    retirement: the same uids, group by group."""
    lens = (20, 30, 5, 31, 70, 32, 12, 100, 18)
    arrivals = (0.0, 0.0, 0.0, 0.5, 0.5, 0.5, 1.0, 1.0, 2.0)
    groups = []
    for sched_cls, req_cls in ((SlotScheduler, Request),
                               (JScheduler, JRequest)):
        sched = sched_cls(3, bucket_for=_bucket, max_prefill_batch=2)
        for uid, (n, t) in enumerate(zip(lens, arrivals)):
            sched.submit(req_cls(uid=uid, prompt=np.zeros(n, np.int32),
                                 max_new_tokens=4, arrival_s=t))
        got = []
        for now in (0.0, 0.0, 0.6, 1.1, 1.1, 2.5, 2.5, 3.0, 3.0, 3.0):
            group = sched.next_prefill_group(now)
            got.append(None if group is None else [r.uid for r in group])
            for r in group or ():
                sched.place(r)
            if len(sched.running) == 3 or now >= 2.5:
                for r in list(sched.running.values())[:2]:
                    sched.retire(r, now=now)
        groups.append(got)
    assert groups[0] == groups[1]
    assert any(g and len(g) == 2 for g in groups[0])
    with pytest.raises(ValueError, match="bucket_for"):
        SlotScheduler(2).next_prefill_group(0.0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(31)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"),
                tl=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                   device="cpu"))


def _prompts(lens=LENS, seed=12):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    prompts[3] = prompts[0].copy()  # an exact repeat of request 0
    return prompts


def _port_run(model, policy, prompts, *, slots=3, max_new=6,
              decode_evict=False):
    eng = BucketedEngine(
        model["tp"], model["tcfg"], policy=policy,
        evict=EvictionConfig(budget=8, draft_len=4),
        lkv_params=model["tl"] if policy == "lookaheadkv" else None,
        num_slots=slots, buckets=BUCKETS, max_new_tokens=max_new, eos_id=-1,
        decode_evict=decode_evict, device="cpu")
    done = eng.run([Request(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)])
    return {r.uid: r.out_tokens for r in done}, eng


@pytest.mark.parametrize("policy,decode_evict", [
    ("lookaheadkv", False), ("full", False), ("snapkv", False),
    ("laq", False),
    # the dense slots' per-step eviction once their 8 margin rows fill
    ("lookaheadkv", True),
])
def test_bucketed_engine_matches_jax(model, policy, decode_evict):
    prompts = _prompts()
    if policy == "full":  # full caches whole prompts: the largest bucket
        prompts = [p[:64] for p in prompts]
    new = 14 if decode_evict else 6
    got, eng = _port_run(model, policy, prompts, max_new=new,
                         decode_evict=decode_evict)
    with warnings.catch_warnings():  # the JAX engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JBucketed(
            model["jp"], model["jcfg"], policy=policy,
            evict=JEvict(budget=8, draft_len=4),
            lkv_params=model["jl"] if policy == "lookaheadkv" else None,
            num_slots=3, buckets=BUCKETS, max_new_tokens=new, eos_id=-1,
            decode_evict=decode_evict)
        jdone = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=new)
                          for i, p in enumerate(prompts)])
    want = {r.uid: r.out_tokens for r in jdone}
    assert got == want
    assert all(len(t) == new for t in got.values())
    assert eng.capacity == jeng.capacity
    assert eng.kv_device_bytes() == jeng.kv_device_bytes()
    # groups: padded and exact buckets (laq: exact lengths only)
    assert eng.counts["prefill_groups"] == (5 if policy == "laq" else 4)
    assert eng.counts["max_concurrency"] == 3


def test_bucketed_lookaheadkv_equals_isolated_lockstep(model):
    """Bucket padding is exact for lookaheadkv: each request's tokens are
    those of a batch-1 lockstep run of it alone."""
    prompts = _prompts()
    got, _ = _port_run(model, "lookaheadkv", prompts, slots=4)
    lock = ServingEngine(model["tp"], model["tcfg"], policy="lookaheadkv",
                         evict=EvictionConfig(budget=8),
                         lkv_params=model["tl"], max_new_tokens=6,
                         eos_id=-1, device="cpu")
    for uid, p in enumerate(prompts):
        r = lock.serve([Request(uid=uid, prompt=p, max_new_tokens=6)])[0]
        assert got[uid] == r.out_tokens, uid


def test_bucketed_engine_refusals(model):
    kw = dict(device="cpu", buckets=BUCKETS)
    with pytest.raises(ValueError, match="gt_oracle"):
        BucketedEngine({}, model["tcfg"], policy="gt_oracle", **kw)
    with pytest.raises(ValueError, match="unknown policy"):
        BucketedEngine({}, model["tcfg"], policy="nope", **kw)
    with pytest.raises(ValueError, match="lkv_params"):
        BucketedEngine({}, model["tcfg"], policy="lookaheadkv", **kw)
    hcfg = dataclasses.replace(get_smoke_config("hymba-1.5b"),
                               dtype="float32")
    with pytest.raises(ValueError, match="attention-only"):
        BucketedEngine({}, hcfg, policy="full", **kw)
    eng = BucketedEngine(model["tp"], model["tcfg"], policy="full",
                         max_new_tokens=4, **kw)
    with pytest.raises(ValueError, match="largest bucket"):
        eng.run([Request(uid=0, prompt=np.zeros(65, np.int32),
                         max_new_tokens=4)])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


SMOKE = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--budget",
         "8", "--max-new", "4", "--prompt-lens", "20,30,32,9"]


@pytest.mark.parametrize("policy", ["full", "laq", "lookaheadkv"])
def test_launcher_continuous_bucketed_route(policy, capsys):
    """``--continuous`` with a policy that cannot stream (or lookaheadkv,
    which streams) picks the JAX launcher's engine; the bucketed route
    serves every request, ignores ``--kv-pool-mb`` with the JAX
    launcher's note, and evicts with ``draft_len=8``."""
    res = serve.run(SMOKE + ["--continuous", "--policy", policy,
                             "--kv-pool-mb", "1"])
    eng = res["engine"]
    streams = policy == "lookaheadkv"
    assert type(eng).__name__ == ("ContinuousEngine" if streams
                                  else "BucketedEngine")
    assert ("--kv-pool-mb requires the chunked continuous engine"
            in capsys.readouterr().out) is not streams
    assert sorted(len(r.out_tokens) for r in res["done"]) == [4] * 4
    assert eng.evict.draft_len == 8 and eng.evict.budget == 8


def test_launcher_lockstep_draft_len_and_speckv_failure():
    res = serve.run(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                     "--policy", "laq", "--budget", "8", "--requests", "2",
                     "--n-in", "24", "--max-new", "3"])
    assert isinstance(res["engine"], ServingEngine)
    assert res["engine"].evict.draft_len == 8
    assert [len(r.out_tokens) for r in res["done"]] == [3, 3]
    for route in ([], ["--continuous"]):
        with pytest.raises(ValueError, match="speckv needs a draft model"):
            serve.run(SMOKE[:-2] + route + ["--policy", "speckv"])
    with pytest.raises(ValueError, match="--prompt-lens needs --continuous"):
        serve.run(SMOKE + ["--policy", "laq"])
