"""The port's prefix cache on the CPU, mirroring the JAX package's
``tests/test_prefix_cache.py`` and holding the engine to the JAX one.

1. The radix trie (no model): partial-chunk prefixes never match, LRU
   never evicts a pinned or parented entry and evicts by recency,
   ``materialize`` rebuilds a chain, the byte budget holds after every
   step of adversarial interleavings, and an entry does not alias the
   donor's buffers (the port's state is written in place).
2. Snapshots: ``snapshot_chunk_state`` / ``resume_chunk_state`` round-trip
   every leaf bitwise under every streaming policy, and the resumed
   prefill ends with the same kept cache and logits; a resume into a
   deeper buffer keeps the same evictions.
3. Differential traces: a seeded Zipf-prefix trace served by
   ``ContinuousEngine`` with the cache on gives the tokens and kept
   (layer, head, position) sets of the cache off, under every policy the
   engine streams, chunks 128 and 256, prompts not divisible by the
   chunk; with a tight byte budget; with mixed KV-buffer rungs; with the
   cache pinned in the pool, where live requests reclaim its blocks.  The
   random policy's seed stays out of the cached state.  Against the JAX
   ``ContinuousEngine`` with a ``PrefixCache`` on the same trace (JAX
   parameters bridged): the same tokens, hits, misses and tokens skipped.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import KVBlockPool as JPool
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServing
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import policies, scoring
from repro_torch.core.lookahead import init_lookahead_params
from repro_torch.data.synthetic import make_prefix_trace
from repro_torch.models import transformer as tf
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 KVBlockPool, PrefixCache, Request,
                                 ServingConfig)

# every policy the chunked continuous engine streams
ENGINE_POLICIES = [p for p in policies.SINGLE_PASS
                   if p not in ("gt_oracle", "full")]


def _cfg():
    return dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    params = tf.init_params(cfg, seed=0, device="cpu")
    lkv = init_lookahead_params(torch.Generator().manual_seed(1), cfg,
                                params["layers"])
    gen = torch.Generator().manual_seed(2)
    for ad in lkv["lora"]["attn"].values():  # b starts at zero: draw it
        ad["b"] = torch.randn(ad["b"].shape, generator=gen) * 0.05
    return cfg, params, lkv


# ---------------------------------------------------------------------------
# 1. the radix trie (no model)
# ---------------------------------------------------------------------------

CHUNK = 4


def _state(depth: int, fill: float, capacity: int = 16) -> tf.ChunkState:
    """A tiny streaming state: column j of k/v holds ``fill + j``, so
    materialized chains can be checked value by value."""
    col = torch.arange(capacity, dtype=torch.float32) + fill
    k = col[None, None, :, None, None].expand(1, 1, capacity, 1, 2).clone()
    return tf.ChunkState(k=k, v=k + 0.5, score=scoring.ScoreState(),
                         pos=depth)


def _logits(tag: float) -> torch.Tensor:
    return torch.full((1, 4), tag, dtype=torch.float32)


def _tokens(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 50, n).astype(np.int32)


def _check_invariants(cache: PrefixCache) -> None:
    entries = list(cache._lru)
    assert cache.bytes == sum(e.nbytes for e in entries)
    assert cache.bytes <= cache.max_bytes
    for e in entries:
        assert e.refs >= 0
        if e.parent is not None:
            assert e.parent in cache._lru, "child outlived its parent"


def test_trie_lookup_and_partial_chunk_prefixes_never_match():
    cache = PrefixCache(chunk=CHUNK, max_bytes=1 << 20)
    t = _tokens(0, 8)
    e4 = cache.insert(t[:4], state=_state(4, 0.0), logits=_logits(1))
    e8 = cache.insert(t[:8], state=_state(8, 0.0), logits=_logits(2),
                      parent=e4)
    assert (e4.depth, e8.depth) == (4, 8) and e8.parent is e4
    assert cache.lookup(t[:8]) is e8
    assert cache.lookup(np.concatenate([t, _tokens(1, 5)])) is e8
    assert cache.lookup(t[:4]) is e4
    # 6 shared tokens match only the aligned 4-deep entry
    assert cache.lookup(np.concatenate([t[:6], _tokens(2, 10)])) is e4
    assert cache.lookup(np.concatenate([t[:3], _tokens(3, 9)])) is None
    assert cache.lookup(t[:3]) is None  # shorter than a chunk
    with pytest.raises(AssertionError):
        cache.insert(t[:6], state=_state(6, 0.0), logits=_logits(9))
    assert cache.stats()["hits"] == 4 and cache.stats()["misses"] == 2
    _check_invariants(cache)


def test_lru_never_evicts_pinned_or_parented_entries():
    one = PrefixCache(chunk=CHUNK, max_bytes=1 << 20)
    per = one.insert(_tokens(0, 4), state=_state(4, 0.0),
                     logits=_logits(0)).nbytes
    cache = PrefixCache(chunk=CHUNK, max_bytes=2 * per)
    t = _tokens(1, 8)
    a = cache.insert(t[:4], state=_state(4, 1.0), logits=_logits(1))
    b = cache.insert(t[:8], state=_state(8, 1.0), logits=_logits(2),
                     parent=a)
    cache.acquire(b)  # an in-flight pin
    # a is parented, b pinned: the doomed insert refuses without churning
    assert cache.insert(_tokens(2, 4), state=_state(4, 2.0),
                        logits=_logits(3)) is None
    assert cache.evictions == 0
    assert cache.lookup(t[:8]) is b and cache.bytes <= cache.max_bytes
    cache.release(b)
    c = cache.insert(_tokens(2, 4), state=_state(4, 2.0), logits=_logits(3))
    assert c is not None and cache.lookup(t[:8]) is not b
    _check_invariants(cache)
    with pytest.raises(AssertionError):
        cache.release(c)  # a refcount underflow is loud


def test_lru_recency_orders_eviction():
    one = PrefixCache(chunk=CHUNK, max_bytes=1 << 20)
    per = one.insert(_tokens(0, 4), state=_state(4, 0.0),
                     logits=_logits(0)).nbytes
    cache = PrefixCache(chunk=CHUNK, max_bytes=2 * per)
    ta, tb, tc = _tokens(1, 4), _tokens(2, 4), _tokens(3, 4)
    cache.insert(ta, state=_state(4, 1.0), logits=_logits(1))
    cache.insert(tb, state=_state(4, 2.0), logits=_logits(2))
    assert cache.lookup(ta) is not None  # touch a: b is now the LRU
    cache.insert(tc, state=_state(4, 3.0), logits=_logits(3))
    assert cache.lookup(tb) is None
    assert cache.lookup(ta) is not None and cache.lookup(tc) is not None
    _check_invariants(cache)


@pytest.mark.parametrize("pooled", [False, True])
def test_materialize_rebuilds_the_chain(pooled):
    pool = None
    if pooled:
        cfg = dataclasses.replace(_cfg(), num_layers=1)
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, num_kv_heads=1, head_dim=2, num_heads=1))
        pool = KVBlockPool(cfg, block_size=2, num_blocks=16, device="cpu")
    cache = PrefixCache(chunk=CHUNK, max_bytes=1 << 20, pool=pool)
    t = _tokens(4, 8)
    donor = _state(8, 7.0)
    a = cache.insert(t[:4], state=donor, logits=_logits(1))
    b = cache.insert(t[:8], state=donor, logits=_logits(2), parent=a)
    state, logits = cache.materialize(b, capacity=12)
    assert state.k.shape[2] == 12 and state.pos == 8
    torch.testing.assert_close(state.k[:, :, :8], donor.k[:, :, :8],
                               rtol=0, atol=0)
    torch.testing.assert_close(state.v[:, :, :8], donor.v[:, :, :8],
                               rtol=0, atol=0)
    assert not state.k[:, :, 8:].any()  # a zero tail
    torch.testing.assert_close(logits, _logits(2), rtol=0, atol=0)
    if pooled:
        assert pool.pinned_blocks == 4 == cache.stats()["pool_blocks_pinned"]
        assert cache.stats()["materialize_programs"] == 0
        assert cache.evict_pool_blocks(4) and pool.pinned_blocks == 0
        pool.check()
        assert pool.used_blocks() == 0 and cache.stats()["entries"] == 0


def test_pool_prefix_half_incref_and_pins():
    """The pool's prefix half: ``incref`` adds an owner per block (a block
    returns to the free list only at its last ``free``), ``note_pinned``
    accounts pinned blocks in ``stats()``, and ``write_span`` stores K/V
    columns block by block."""
    pool = KVBlockPool(_cfg(), block_size=4, num_blocks=8, device="cpu")
    ids = pool.alloc(2)
    pool.incref(ids)
    pool.free(ids)
    assert pool.used_blocks() == 2
    pool.free(ids)
    assert pool.used_blocks() == 0
    with pytest.raises(AssertionError):
        pool.incref(ids)  # no longer allocated
    ids = pool.alloc(2)
    L, KV, hd = pool.k.shape[0], pool.k.shape[3], pool.k.shape[4]
    k = torch.randn((L, 1, 8, KV, hd))
    pool.write_span(k, k + 1, ids)
    torch.testing.assert_close(pool.k[:, ids].reshape(L, 8, KV, hd), k[:, 0],
                               rtol=0, atol=0)
    torch.testing.assert_close(pool.v[:, ids].reshape(L, 8, KV, hd),
                               k[:, 0] + 1, rtol=0, atol=0)
    pool.note_pinned(2)
    st = pool.stats()
    assert st["blocks_pinned_prefix"] == 2
    assert st["bytes_pinned_prefix"] == 2 * pool.block_bytes
    pool.note_pinned(-2)
    pool.free(ids)
    pool.check()


@pytest.mark.parametrize("pooled", [False, True])
def test_entry_does_not_alias_the_donor(pooled, model):
    """The donor goes on writing its buffers in place after ``insert``:
    the entry keeps the values it had at the boundary."""
    cfg, params, _ = model
    pool = (KVBlockPool(cfg, block_size=8, num_blocks=16, device="cpu")
            if pooled else None)
    cache = PrefixCache(chunk=16, max_bytes=1 << 30, pool=pool)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, 32)
    state = tf.init_chunk_state(cfg, "h2o", 1, 64, device="cpu")
    state, logits = tf.prefill_chunk(params, cfg, state, torch.as_tensor(
        toks[None, :16].astype(np.int32)), 32, policy="h2o")
    want_k = state.k[:, :, :16].clone()
    want_acc = state.score.acc[..., :16].clone()
    entry = cache.insert(toks[:16], state=state, logits=logits)
    state.k.add_(1.0)
    state.v.add_(1.0)
    state.score.acc.add_(1.0)
    snap, _ = cache.materialize(entry, 64)
    torch.testing.assert_close(snap.k[:, :, :16], want_k, rtol=0, atol=0)
    torch.testing.assert_close(snap.score.acc[..., :16], want_acc, rtol=0,
                               atol=0)
    assert not snap.score.acc[..., 16:].any()
    # the resumed state is new tensors: writing it leaves the entry as is
    snap.k.add_(1.0)
    snap.score.acc.add_(1.0)
    again, _ = cache.materialize(entry, 64)
    torch.testing.assert_close(again.k[:, :, :16], want_k, rtol=0, atol=0)
    torch.testing.assert_close(again.score.acc[..., :16], want_acc, rtol=0,
                               atol=0)


def test_byte_budget_respected_under_adversarial_interleavings():
    """The engine's protocol (lookup and pin, stream and insert, release)
    over interleaved requests with a tight budget: after every step the
    budget holds, refcounts stay non-negative and pinned tips stay."""
    rng = np.random.default_rng(7)
    probe = PrefixCache(chunk=CHUNK, max_bytes=1 << 20)
    per = probe.insert(_tokens(0, 4), state=_state(4, 0.0),
                       logits=_logits(0)).nbytes
    cache = PrefixCache(chunk=CHUNK, max_bytes=5 * per)
    bases = [_tokens(s, 16) for s in range(3)]

    class Sim:
        def __init__(self, uid):
            base = bases[int(rng.integers(3))]
            depth = int(rng.integers(1, 5)) * CHUNK
            self.prompt = base[:depth].copy()
            if rng.random() < 0.5:  # diverge mid-pool: the trie splits
                self.prompt[-1] = 99 + uid
            self.state = _state(0, float(uid), capacity=16)
            self.s, self.tip = 0, None
            hit = cache.lookup(self.prompt)
            if hit is not None:
                cache.acquire(hit)
                self.tip, self.s = hit, hit.depth

        def step(self):
            self.s += CHUNK
            self.state.pos = self.s
            e = cache.insert(self.prompt[:self.s], state=self.state,
                             logits=_logits(self.s), parent=self.tip)
            if e is not None:
                cache.acquire(e)
                if self.tip is not None:
                    cache.release(self.tip)
                self.tip = e

        def finish(self):
            if self.tip is not None:
                cache.release(self.tip)
                self.tip = None

    live, uid = [], 0
    for _ in range(200):
        op = rng.random()
        if (op < 0.25 and len(live) < 6) or not live:
            live.append(Sim(uid))
            uid += 1
        elif op < 0.85:
            sim = live[int(rng.integers(len(live)))]
            if sim.s < len(sim.prompt):
                sim.step()
        else:
            live.pop(int(rng.integers(len(live)))).finish()
        _check_invariants(cache)
        for sim in live:
            if sim.tip is not None:
                assert sim.tip in cache._lru
    for sim in live:
        sim.finish()
    for e in list(cache._lru):  # every ref is now a child link
        assert e.refs == sum(1 for x in cache._lru if x.parent is e)
    _check_invariants(cache)
    assert cache.evictions > 0, "the budget never forced an eviction"


# ---------------------------------------------------------------------------
# 2. ScoreState / ChunkState snapshots
# ---------------------------------------------------------------------------

SNAP_CHUNK, SNAP_N, SNAP_BOUNDARY = 16, 40, 32


def _stream(cfg, params, state, toks, n, policy, start=0):
    logits = None
    for s in range(start, n, SNAP_CHUNK):
        blk = np.zeros((1, SNAP_CHUNK), np.int32)
        seg = toks[0, s:s + SNAP_CHUNK]
        blk[0, :len(seg)] = seg
        state, logits = tf.prefill_chunk(params, cfg, state,
                                         torch.as_tensor(blk), n,
                                         policy=policy)
    return state, logits


def _leaves(state: tf.ChunkState) -> list:
    sc = state.score
    return [state.k, state.v, state.pos, sc.acc, sc.cnt, sc.qbuf]


def _finish(cfg, params, lkv, state, toks, policy):
    end, logits = _stream(cfg, params, state, toks, SNAP_N, policy,
                          start=SNAP_BOUNDARY)
    cache = tf.prefill_finalize(
        params, cfg, end, SNAP_N, policy=policy, evict=EvictionConfig(
            budget=8), lkv_params=lkv if policy == "lookaheadkv" else None,
        seeds=torch.tensor([3], dtype=torch.int32))
    return cache, logits


@pytest.mark.parametrize("policy", ENGINE_POLICIES)
def test_snapshot_restore_bit_exact(model, policy):
    """snapshot -> restore at a chunk boundary gives every leaf back
    bitwise (the window policies' query buffer too), and the prefill
    finished from it keeps the same cache and logits."""
    cfg, params, lkv = model
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (1, SNAP_N)).astype(np.int32)
    cap = policies.chunk_capacity_for(cfg, policy, SNAP_N, SNAP_CHUNK)
    mid, _ = _stream(cfg, params, tf.init_chunk_state(
        cfg, policy, 1, cap, device="cpu"), toks, SNAP_BOUNDARY, policy)
    restored = tf.resume_chunk_state(
        tf.snapshot_chunk_state(mid, SNAP_BOUNDARY), cap)
    for a, b in zip(_leaves(mid), _leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a is not b
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert a == b
    (c_mid, l_mid), (c_res, l_res) = (
        _finish(cfg, params, lkv, st, toks, policy) for st in (mid, restored))
    torch.testing.assert_close(l_mid, l_res, rtol=0, atol=0)
    for key in c_mid["attn"]:
        torch.testing.assert_close(c_mid["attn"][key], c_res["attn"][key],
                                   rtol=0, atol=0)


def _kept(mask, pos) -> dict:
    """{(layer, head): kept positions} of a (L, 1, C, KV) cache."""
    m, p = np.asarray(mask), np.asarray(pos)
    return {(lyr, h): frozenset(p[lyr, 0, m[lyr, 0, :, h], h].tolist())
            for lyr in range(m.shape[0]) for h in range(m.shape[3])}


def test_restore_into_deeper_buffer_keeps_same_evictions(model):
    cfg, params, _ = model
    policy = "h2o"
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (1, SNAP_N)).astype(np.int32)
    cap = policies.chunk_capacity_for(cfg, policy, SNAP_N, SNAP_CHUNK)
    mid, _ = _stream(cfg, params, tf.init_chunk_state(
        cfg, policy, 1, cap, device="cpu"), toks, SNAP_BOUNDARY, policy)
    snap = tf.snapshot_chunk_state(mid, SNAP_BOUNDARY)
    kept = []
    for depth in (cap, 2 * cap):
        end, _ = _stream(cfg, params, tf.resume_chunk_state(snap, depth),
                         toks, SNAP_N, policy, start=SNAP_BOUNDARY)
        c = tf.prefill_finalize(params, cfg, end, SNAP_N, policy=policy,
                                evict=EvictionConfig(budget=8))
        kept.append(_kept(c["attn"]["mask"], c["attn"]["pos"]))
    assert kept[0] == kept[1]


# ---------------------------------------------------------------------------
# 3. differential traces
# ---------------------------------------------------------------------------


def _trace(cfg, chunk, seed=3, n_requests=5):
    """Zipf-shared chunk-aligned prefixes; suffix 77 makes prompts no
    chunk divides, suffix 0 exact duplicates (full hits)."""
    return make_prefix_trace(
        seed, n_requests, cfg.vocab_size, chunk=chunk, n_prefixes=3,
        prefix_chunks=(1, 2) if chunk <= 128 else (1,),
        suffix_lens=(0, 1, 77))


def _serve(cfg, params, lkv, trace, *, policy, chunk, prefix_cache=None,
           pool_blocks=None, max_context=None, max_new=3, budget=8,
           block_size=16, decode_chunk=2):
    pool = None
    if pool_blocks:
        pool = KVBlockPool(cfg, block_size=block_size,
                           num_blocks=pool_blocks, device="cpu")
        if prefix_cache == "pool":
            prefix_cache = PrefixCache(chunk=chunk, max_bytes=1 << 30,
                                       pool=pool)
    sc = ServingConfig(
        policy=policy, evict=EvictionConfig(budget=budget),
        chunking=ChunkingConfig(
            chunk=chunk, decode_chunk=decode_chunk,
            max_context=max_context or max(len(p) for p, _ in trace)),
        num_slots=2, max_new_tokens=max_new, eos_id=-1, kv_pool=pool,
        prefix_cache=prefix_cache, capture_admission=True)
    eng = ContinuousEngine(params, cfg, sc,
                           lkv_params=lkv if policy == "lookaheadkv" else None,
                           device="cpu")
    done = eng.run([Request(uid=i, prompt=p, max_new_tokens=max_new,
                            arrival_s=t) for i, (p, t) in enumerate(trace)])
    assert len(done) == len(trace)
    return {r.uid: r for r in done}, eng


def _assert_same(got, want, label):
    for uid, w in want.items():
        g = got[uid]
        assert g.out_tokens == w.out_tokens, f"{label} uid {uid}: tokens"
        assert _kept(g.admission_cache["mask"], g.admission_cache["pos"]) \
            == _kept(w.admission_cache["mask"], w.admission_cache["pos"]), \
            f"{label} uid {uid}: kept sets"


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("policy", ENGINE_POLICIES)
def test_differential_trace(model, policy, chunk):
    cfg, params, lkv = model
    trace = _trace(cfg, chunk)
    base, _ = _serve(cfg, params, lkv, trace, policy=policy, chunk=chunk)
    cache = PrefixCache(chunk=chunk, max_bytes=1 << 30)
    got, eng = _serve(cfg, params, lkv, trace, policy=policy, chunk=chunk,
                      prefix_cache=cache)
    _assert_same(got, base, f"{policy} chunk {chunk}")
    assert eng.counts["prefix_hits"] > 0  # not vacuous
    assert eng.counts["prefix_tokens_skipped"] > 0
    assert cache.stats()["bytes"] > 0
    assert eng.counts["prefix"]["prefix_hits"] == eng.counts["prefix_hits"]


def test_differential_trace_with_tight_budget(model):
    """Evictions mid-trace (room for about two entries) change no token:
    a miss after an eviction streams as usual."""
    cfg, params, lkv = model
    trace = _trace(cfg, 128, seed=9, n_requests=8)
    probe = PrefixCache(chunk=128, max_bytes=1 << 30)
    _serve(cfg, params, lkv, trace, policy="h2o", chunk=128,
           prefix_cache=probe)
    per = probe.bytes // max(probe.stats()["entries"], 1)
    base, _ = _serve(cfg, params, lkv, trace, policy="h2o", chunk=128)
    cache = PrefixCache(chunk=128, max_bytes=2 * per)
    got, _ = _serve(cfg, params, lkv, trace, policy="h2o", chunk=128,
                    prefix_cache=cache)
    _assert_same(got, base, "tight budget")
    assert cache.stats()["bytes"] <= 2 * per
    assert cache.evictions > 0


def test_differential_trace_mixed_rungs(model):
    """A long prompt climbs past ``max_context``: its snapshots serve only
    its own rung, so base-rung requests sharing its tokens miss, and
    tokens and kept sets stay equal."""
    cfg, params, _ = model
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    long_p = np.concatenate([shared, rng.integers(0, cfg.vocab_size, 96)
                             .astype(np.int32)])
    trace = [(long_p, 0.0), (shared.copy(), 0.02), (long_p.copy(), 0.04),
             (shared.copy(), 0.06)]
    base, _ = _serve(cfg, params, None, trace, policy="h2o", chunk=32,
                     max_context=64)
    got, eng = _serve(cfg, params, None, trace, policy="h2o", chunk=32,
                      max_context=64,
                      prefix_cache=PrefixCache(chunk=32, max_bytes=1 << 30))
    _assert_same(got, base, "mixed rungs")
    assert got[2].cached_prefix_tokens == len(long_p)
    assert got[1].cached_prefix_tokens == 0
    assert got[3].cached_prefix_tokens == 0
    assert eng.counts["prefix_hits"] == 1


def test_random_policy_seed_stays_out_of_cached_state(model):
    """Identical prompts of two requests share the cached prefix, yet draw
    different random evictions: the seed is folded in at finalize."""
    cfg, params, _ = model
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 128)
    prompt = prompt.astype(np.int32)
    trace = [(prompt, 0.0), (prompt.copy(), 0.01)]
    got, eng = _serve(cfg, params, None, trace, policy="random", chunk=128,
                      prefix_cache=PrefixCache(chunk=128, max_bytes=1 << 30))
    assert eng.counts["prefix_hits"] == 1
    assert got[1].cached_prefix_tokens == 128
    a0, a1 = got[0].admission_cache, got[1].admission_cache
    assert _kept(a0["mask"], a0["pos"]) != _kept(a1["mask"], a1["pos"])


@pytest.mark.parametrize("policy", ["lookaheadkv", "h2o"])
def test_pool_pinned_cache_with_reclaim(model, policy):
    """Pinned in a pool too small for both the cached prefixes and the
    live requests: admissions and appends reclaim unpinned entries, and
    the tokens and kept sets are the cache-off serve's."""
    cfg, params, lkv = model
    trace = _trace(cfg, 32, seed=4, n_requests=8)
    base, _ = _serve(cfg, params, lkv, trace, policy=policy, chunk=32,
                     pool_blocks=40, max_new=6)
    got, eng = _serve(cfg, params, lkv, trace, policy=policy, chunk=32,
                      pool_blocks=8, prefix_cache="pool", max_new=6)
    _assert_same(got, base, f"pool-pinned {policy}")
    pc, pool = eng.prefix_cache, eng.pool
    assert eng.counts["prefix_hits"] > 0
    assert eng.counts["prefix_blocks_reclaimed"] > 0
    assert pool.pinned_blocks == pc.stats()["pool_blocks_pinned"] \
        == pool.stats()["blocks_pinned_prefix"]
    pool.check()
    assert pool.used_blocks() == pool.pinned_blocks and pool.reserved == 0


def _jax_model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(9)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    return jcfg, params, lkv


@pytest.mark.parametrize("policy,pooled", [("lookaheadkv", True),
                                           ("h2o", False)])
def test_engine_matches_jax_with_prefix_cache(policy, pooled):
    """The same trace through the JAX ``ContinuousEngine`` and the port's,
    each with a ``PrefixCache`` (pool-pinned or dense): the same tokens,
    and the same hits, misses and prompt tokens skipped."""
    jcfg, jp, jl = _jax_model()
    tcfg = _cfg()
    trace = _trace(tcfg, 32, seed=5, n_requests=6)
    max_ctx = max(len(p) for p, _ in trace)
    jpool = JPool(jcfg, block_size=16, num_blocks=64) if pooled else None
    jcache = JPrefixCache(chunk=32, max_bytes=1 << 30, pool=jpool)
    jsc = JServing(policy=policy, evict=JEvict(budget=8),
                   chunking=JChunking(chunk=32, max_context=max_ctx,
                                      decode_chunk=2),
                   num_slots=2, max_new_tokens=4, eos_id=-1,
                   kv_pool=jpool, prefix_cache=jcache)
    jeng = JEngine(jp, jcfg, jsc,
                   lkv_params=jl if policy == "lookaheadkv" else None)
    jdone = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=4,
                               arrival_s=t) for i, (p, t) in enumerate(trace)])

    def port(tree):
        return bridge.to_torch(jax.tree.map(np.asarray, tree), device="cpu")

    got, eng = _serve(tcfg, port(jp), port(jl), trace, policy=policy,
                      chunk=32, pool_blocks=64 if pooled else None,
                      prefix_cache=("pool" if pooled else PrefixCache(
                          chunk=32, max_bytes=1 << 30)), max_new=4)
    assert {r.uid: r.out_tokens for r in jdone} == {
        uid: r.out_tokens for uid, r in got.items()}
    m = jeng.metrics
    want = {"prefix_hits": m.value("serving_prefix_hits_total"),
            "prefix_misses": m.value("serving_prefix_misses_total"),
            "prefix_tokens_skipped":
                m.value("serving_prefix_tokens_skipped_total")}
    assert {k: eng.counts[k] for k in want} == {
        k: int(v) for k, v in want.items()}
    assert want["prefix_hits"] > 0
    assert {r.uid: r.cached_prefix_tokens for r in jdone} == {
        uid: r.cached_prefix_tokens for uid, r in got.items()}
    assert eng.prefix_cache.stats()["entries"] == jcache.stats()["entries"]
