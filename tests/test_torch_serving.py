"""The port's serving stack on the CPU: the block-pool allocator, the
paged continuous-batching engine end to end against the JAX package's
paged ``ContinuousEngine``, and the settings the port refuses.

End to end: the same float32 smoke model (JAX parameters bridged) serves
the same mixed-length trace — prompts shorter than the budget, not
multiples of the chunk, more requests than slots — through both engines.
Per request, the greedy tokens and the admission kept (layer, head,
position) sets must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import sweep_cases
from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import KVBlockPool as JPool
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServing
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 KVBlockPool, Request, ServingConfig)


def _cfg():
    return dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")


# ---------------------------------------------------------------------------
# allocator invariants (no model)
# ---------------------------------------------------------------------------


def _pool(num_blocks):
    return KVBlockPool(_cfg(), block_size=16, num_blocks=num_blocks,
                       device="cpu")


def test_allocator_basics_and_double_free():
    pool = _pool(8)
    assert pool.usable_blocks == 8 and pool.free_blocks() == 8
    assert [pool.blocks_for(n) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]
    a = pool.alloc(3)
    assert a is not None and len(a) == 3 and 0 not in a
    assert pool.used_blocks() == 3 and pool.high_water == 3
    assert pool.alloc(6) is None, "over-allocation must refuse, not split"
    pool.free(a)
    assert pool.used_blocks() == 0
    with pytest.raises(AssertionError):
        pool.free(a[:1])  # double-free
    with pytest.raises(AssertionError):
        pool.free([0])  # the null block is never allocatable
    pool.check()


def test_reservations_fence_ordinary_allocations():
    pool = _pool(8)
    assert pool.reserve(5)
    assert pool.available_blocks() == 3
    assert pool.alloc(4) is None, "ordinary alloc dipped into a reservation"
    assert pool.alloc(3) is not None
    assert not pool.reserve(1), "over-promise accepted"
    got = pool.alloc(2, from_reserved=True)
    assert got is not None and pool.reserved == 3
    pool.unreserve(3)
    assert pool.reserved == 0
    pool.check()


@pytest.mark.parametrize("case", sweep_cases(
    7, 4, lambda r: {"seed": int(r.integers(1e6))}))
def test_allocator_invariants_under_random_interleavings(case):
    rng = np.random.default_rng(case["seed"])
    pool = _pool(int(rng.integers(8, 32)))
    held, promised = [], 0
    for _ in range(200):
        op = rng.integers(4)
        if op == 0:
            ids = pool.alloc(int(rng.integers(1, 4)))
            if ids is not None:
                held.append(ids)
        elif op == 1 and held:
            pool.free(held.pop(int(rng.integers(len(held)))))
        elif op == 2:
            n = int(rng.integers(0, 3))
            if pool.reserve(n):
                promised += n
        elif op == 3 and promised:
            ids = pool.alloc(1, from_reserved=True)
            assert ids is not None, "a reserved block must always be there"
            promised -= 1
            held.append(ids)
        pool.check()
        assert pool.reserved == promised
    for ids in held:
        pool.free(ids)
    pool.unreserve(promised)
    pool.check()
    assert pool.used_blocks() == 0


def test_write_cache_and_zero_mask():
    pool = _pool(6)
    cfg = _cfg()
    L, KV, hd = cfg.num_layers, cfg.attn.num_kv_heads, cfg.attn.head_dim
    rng = np.random.default_rng(0)
    C = 20
    cache = bridge.to_torch({
        "k": rng.normal(size=(L, 1, C, KV, hd)).astype(np.float32),
        "v": rng.normal(size=(L, 1, C, KV, hd)).astype(np.float32),
        "pos": rng.integers(0, 99, (L, 1, C, KV)).astype(np.int32),
        "mask": rng.random((L, 1, C, KV)) > 0.5}, device="cpu")
    ids = pool.alloc(2)
    pool.write_cache(cache, ids)
    got = pool.k[:, ids].reshape(L, 32, KV, hd)
    np.testing.assert_array_equal(got[:, :C], cache["k"][:, 0])
    assert not pool.mask[:, ids].reshape(L, 32, KV)[:, C:].any()
    pool.zero_mask(ids)
    assert not pool.mask.any()


# ---------------------------------------------------------------------------
# end to end against the JAX paged engine
# ---------------------------------------------------------------------------


def _kept_sets(adm):
    m, p = adm["mask"], adm["pos"]
    L, _, _, KV = m.shape
    return {(lyr, h): frozenset(p[lyr, 0, m[lyr, 0, :, h], h].tolist())
            for lyr in range(L) for h in range(KV)}


def test_engine_matches_jax_paged_engine():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = _cfg()
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(9)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    lens, max_new, chunk, budget = [37, 11, 50, 23, 64], 6, 16, 16
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]

    jsc = JServing(policy="lookaheadkv", evict=JEvict(budget=budget),
                   chunking=JChunking(chunk=chunk, max_context=max(lens)),
                   num_slots=2, max_new_tokens=max_new, eos_id=-1,
                   kv_pool=JPool(jcfg, block_size=8, num_blocks=24),
                   capture_admission=True)
    jdone = JEngine(params, jcfg, jsc, lkv_params=lkv).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=max_new)
         for i, p in enumerate(prompts)])

    tsc = ServingConfig(
        policy="lookaheadkv", evict=EvictionConfig(budget=budget),
        chunking=ChunkingConfig(chunk=chunk, max_context=max(lens)),
        num_slots=2, max_new_tokens=max_new, eos_id=-1,
        kv_pool=KVBlockPool(tcfg, block_size=8, num_blocks=24, device="cpu"),
        capture_admission=True)
    eng = ContinuousEngine(
        bridge.to_torch(jax.tree.map(np.asarray, params), device="cpu"), tcfg,
        tsc, lkv_params=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                        device="cpu"),
        device="cpu")
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
    eng.pool.check()
    assert eng.pool.used_blocks() == 0 and eng.pool.reserved == 0


# ---------------------------------------------------------------------------
# what the port refuses, and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change,exc,item", [
    # the draft-based policies cannot stream: the JAX engine's words
    (dict(policy="laq"), ValueError, "cannot stream; use BucketedEngine"),
    (dict(harvest=object()), NotImplementedError, "A9"),
    (dict(policy="speckv"), ValueError, "cannot stream; use BucketedEngine"),
    (dict(lkv_checkpoint="lookahead.npz"), NotImplementedError, "A9"),
    (dict(prefix_cache=object()), NotImplementedError, "A7"),
    (dict(sampling=object()), NotImplementedError, "A8"),
    (dict(mesh=object()), NotImplementedError, "A11"),
    (dict(trace=object()), NotImplementedError, "A12"),
])
def test_engine_refuses_unported_settings(change, exc, item):
    cfg = _cfg()
    sc = ServingConfig(kv_pool=KVBlockPool(cfg, num_blocks=64, device="cpu"))
    with pytest.raises(exc, match=item):
        ContinuousEngine({}, cfg, sc.replace(**change), lkv_params={},
                         device="cpu")


def test_serve_launcher_on_cpu(capsys):
    serve.main(["--arch", "tiny-llama", "--smoke", "--device", "cpu",
                "--continuous", "--kv-pool-mb", "1", "--budget", "16",
                "--chunk", "32",
                "--prompt-lens", "40,70,9", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "requests=3" in out and out.count("4 tokens") == 3
    with pytest.raises(NotImplementedError, match="A7"):
        serve.parse_args(["--kv-pool-mb", "1", "--prefix-cache-mb", "8"])
    with pytest.raises(KeyError, match="A10"):
        serve.run(["--arch", "gemma3-1b", "--smoke", "--kv-pool-mb", "1",
                   "--device", "cpu"])
