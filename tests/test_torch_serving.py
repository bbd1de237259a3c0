"""The port's serving stack on the CPU: the block-pool allocator, the
paged continuous-batching engine end to end against the JAX package's
paged ``ContinuousEngine``, the learning loop's two engine settings (the
harvest hook writes a record per retired request, a lookahead checkpoint
serves like the same modules in memory), the old keyword arguments
against JAX's ``ServingConfig.from_legacy``, and the settings the port
refuses.

End to end: the same float32 smoke model (JAX parameters bridged) serves
the same mixed-length trace — prompts shorter than the budget, not
multiples of the chunk, more requests than slots — through both engines.
Per request, the greedy tokens and the admission kept (layer, head,
position) sets must be identical.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.checkpoint import io as tckpt
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.lookahead import init_lookahead_params
from repro_torch.data.harvest import HarvestConfig, HarvestWriter, load_records
from repro_torch.launch import serve
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as ttf
from repro_torch.obs import TraceRecorder, request_span_trees, validate_trace
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 KVBlockPool, PrefixCache, Request, Sampling,
                                 ServingConfig)


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


def test_legacy_kwargs_round_trip_and_match_jax():
    """The old ``ContinuousEngine`` keywords (``ServingConfig.
    from_legacy``) build the config JAX's ``from_legacy`` builds from the
    same keywords, field for field; ``legacy_kwargs`` round-trips it and
    names JAX's keys; the engine takes them with a
    ``DeprecationWarning``, refuses them beside a config (``ValueError``)
    and an unknown name (``TypeError``)."""
    legacy = dict(policy="snapkv", num_slots=3, max_new_tokens=7,
                  eos_id=-1, decode_evict=True, chunk=16, max_context=64,
                  token_budget=48, decode_chunk=4, reserve_appends=False,
                  capture_admission=True)
    tsc = ServingConfig.from_legacy(evict=EvictionConfig(budget=16),
                                    **legacy)
    jsc = JServing.from_legacy(evict=JEvict(budget=16), **legacy)
    got, want = tsc.legacy_kwargs(), jsc.legacy_kwargs()
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        if dataclasses.is_dataclass(w):  # evict, decode_evict
            assert dataclasses.asdict(g) == dataclasses.asdict(w), name
        else:
            assert g == w, name
    assert dataclasses.asdict(tsc.chunking) == dataclasses.asdict(
        jsc.chunking)
    assert ServingConfig.from_legacy(**got) == tsc
    assert tsc.decode_evict.enabled and not tsc.reserve_appends

    cfg = _cfg()
    params = ttf.init_params(cfg, seed=0, device="cpu")
    lkv = init_lookahead_params(torch.Generator().manual_seed(1), cfg,
                                params["layers"], device="cpu")
    with pytest.warns(DeprecationWarning, match="ServingConfig"):
        eng = ContinuousEngine(params, cfg, lkv_params=lkv, device="cpu",
                               evict=EvictionConfig(budget=16), **legacy)
    assert eng.config == tsc
    with pytest.raises(ValueError, match="not both"):
        ContinuousEngine(params, cfg, tsc, lkv_params=lkv, device="cpu",
                         chunk=16)
    with pytest.raises(TypeError, match="unknown ContinuousEngine kwargs"
                       ), pytest.warns(DeprecationWarning):
        ContinuousEngine(params, cfg, lkv_params=lkv, device="cpu",
                         chunks=16)


# ---------------------------------------------------------------------------
# what the port refuses, and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change,exc,item", [
    # the draft-based policies cannot stream: the JAX engine's words
    (dict(policy="laq"), ValueError, "cannot stream; use BucketedEngine"),
    (dict(policy="speckv"), ValueError, "cannot stream; use BucketedEngine"),
    # the prefix cache (A7) and sampling (A8) are served: no refusal
    (dict(prefix_cache="pool"), None, "A7"),
    (dict(sampling=Sampling(temperature=0.7, top_k=50, top_p=0.9)), None,
     "A8"),
    # tensor-parallel serving is ported, a data axis above 1 too (A11b);
    # the pool must be built for the engine's mesh, as JAX asserts
    (dict(mesh=Mesh(("data", "model"), (2, 2))), ValueError,
     "kv pool built for a different mesh"),
    # metrics and tracing (A12) are served too
    (dict(trace="recorder"), None, "A12"),
], ids=[  # the ids of the former refusal table, kept
    "change0-ValueError-cannot stream; use BucketedEngine",
    "change1-ValueError-cannot stream; use BucketedEngine",
    "change2-NotImplementedError-A7", "change3-NotImplementedError-A8",
    "change4-NotImplementedError-A11", "change5-NotImplementedError-A12"])
def test_engine_refuses_unported_settings(change, exc, item):
    """The settings still unported raise naming their ROADMAP item; the
    prefix cache, sampling and tracing serve: on a smoke model with a
    shared 16-token prefix, the cache hits and changes no token, sampled
    tokens replay across runs and differ from the greedy ones, and a
    traced run (synced timers) gives the untraced tokens and a valid
    trace with one closed request span per request."""
    cfg = _cfg()
    if exc is not None:
        sc = ServingConfig(kv_pool=KVBlockPool(cfg, num_blocks=64,
                                               device="cpu"))
        with pytest.raises(exc, match=item):
            ContinuousEngine({}, cfg, sc.replace(**change), lkv_params={},
                             device="cpu")
        return
    cfg, params, lkv = _smoke_model()
    shared = np.random.default_rng(8).integers(0, cfg.vocab_size, 16)
    reqs = _smoke_requests(cfg, max_new=5)
    for r in reqs:
        r.prompt = np.concatenate([shared, r.prompt]).astype(np.int32)

    def serve(**config):
        pool = KVBlockPool(cfg, block_size=8, num_blocks=48, device="cpu")
        if config.get("prefix_cache") == "pool":
            config["prefix_cache"] = PrefixCache(chunk=16, max_bytes=1 << 30,
                                                 pool=pool)
        if config.get("trace") == "recorder":
            config["trace"] = TraceRecorder()
        sc = ServingConfig(evict=EvictionConfig(budget=16),
                           chunking=ChunkingConfig(chunk=16, max_context=80),
                           num_slots=2, max_new_tokens=5, eos_id=-1,
                           kv_pool=pool, **config)
        eng = ContinuousEngine(params, cfg, sc, lkv_params=lkv, device="cpu")
        done = eng.run([Request(uid=r.uid, prompt=r.prompt,
                                max_new_tokens=5) for r in reqs])
        return {r.uid: r.out_tokens for r in done}, eng

    plain, _ = serve()
    got, eng = serve(**change)
    if item == "A7":
        assert got == plain
        assert eng.counts["prefix_hits"] == 2
        assert eng.counts["prefix_tokens_skipped"] == 32
    elif item == "A12":
        assert got == plain
        assert eng._sync_timers and eng.trace.sync
        assert validate_trace(eng.trace)["tracks"] == len(reqs) + 1
        assert [t["end_args"]["outcome"] for uid in got
                for t in request_span_trees(eng.trace, uid)] == \
            ["done"] * len(reqs)
        assert eng.metrics.value("serving_requests_retired_total") == \
            len(reqs)
    else:
        assert got == serve(**change)[0] != plain
        assert all(len(t) == 5 for t in got.values())


def _smoke_model(seed=0):
    cfg = _cfg()
    params = ttf.init_params(cfg, seed=seed, device="cpu")
    lkv = init_lookahead_params(torch.Generator().manual_seed(seed + 1), cfg,
                                params["layers"])
    # LoRA b starts at zero; draw it so that the modules matter
    gen = torch.Generator().manual_seed(seed + 2)
    for ad in lkv["lora"]["attn"].values():
        ad["b"] = torch.randn(ad["b"].shape, generator=gen) * 0.05
    return cfg, params, lkv


def _smoke_requests(cfg, lens=(37, 11, 50), max_new=4):
    rng = np.random.default_rng(4)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=max_new) for i, n in enumerate(lens)]


def test_engine_harvest_hook_writes_a_record_per_request(tmp_path):
    """``ServingConfig.harvest``: a ``HarvestWriter`` receives every
    retired request and writes one gt_oracle record for it (prompt, the
    tokens served, the oracle scores over them)."""
    cfg, params, lkv = _smoke_model()
    writer = HarvestWriter(params, cfg, HarvestConfig(out_dir=str(tmp_path),
                                                      max_obs=3))
    sc = ServingConfig(evict=EvictionConfig(budget=16),
                       chunking=ChunkingConfig(chunk=16, max_context=64),
                       num_slots=2, max_new_tokens=4, eos_id=-1,
                       harvest=writer)
    reqs = _smoke_requests(cfg)
    done = ContinuousEngine(params, cfg, sc, lkv_params=lkv,
                            device="cpu").run(reqs)
    writer.flush()
    records = load_records(str(tmp_path))
    assert writer.records_written == len(records) == len(done) == 3
    by_prompt = {r.prompt.tobytes(): r for r in done}
    for rec in records:
        r = by_prompt[rec["x"].tobytes()]
        assert rec["y"].tolist() == r.out_tokens[:3]
        assert rec["s"].shape == (cfg.num_layers, cfg.attn.num_heads,
                                  len(r.prompt))
        assert np.isfinite(rec["s"]).all()


def test_engine_lkv_checkpoint_serves_like_lkv_params(tmp_path):
    """``ServingConfig.lkv_checkpoint``: modules saved by the port's
    checkpoint writer serve the tokens the same modules give as
    ``lkv_params``; passing both raises."""
    cfg, params, lkv = _smoke_model()
    path = str(tmp_path / "lkv.npz")
    tckpt.save(path, lkv)
    sc = ServingConfig(evict=EvictionConfig(budget=16),
                       chunking=ChunkingConfig(chunk=16, max_context=64),
                       num_slots=2, max_new_tokens=5, eos_id=-1)
    want = ContinuousEngine(params, cfg, sc, lkv_params=lkv,
                            device="cpu").run(_smoke_requests(cfg, max_new=5))
    got = ContinuousEngine(params, cfg, sc.replace(lkv_checkpoint=path),
                           device="cpu").run(_smoke_requests(cfg, max_new=5))
    assert {r.uid: r.out_tokens for r in got} == {
        r.uid: r.out_tokens for r in want}
    with pytest.raises(ValueError, match="not both"):
        ContinuousEngine(params, cfg, sc.replace(lkv_checkpoint=path),
                         lkv_params=lkv, device="cpu")


def test_serve_launcher_on_cpu(capsys):
    serve.main(["--arch", "tiny-llama", "--smoke", "--device", "cpu",
                "--continuous", "--kv-pool-mb", "1", "--budget", "16",
                "--chunk", "32",
                "--prompt-lens", "40,70,9", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "requests=3" in out and out.count("4 tokens") == 3
    # --prefix-cache-mb and --shared-prefix serve (ROADMAP A7): the second
    # and third requests resume from the first's 64-token prefix
    serve.main(["--arch", "tiny-llama", "--smoke", "--device", "cpu",
                "--continuous", "--kv-pool-mb", "1", "--prefix-cache-mb", "1",
                "--shared-prefix", "70", "--budget", "16", "--chunk", "32",
                "--prompt-lens", "40,70,9", "--n-in", "160", "--max-new",
                "4"])
    out = capsys.readouterr().out
    assert "requests=3" in out and out.count("4 tokens") == 3
    assert "prefix cache: hit-rate 0.67, 128/311 prompt tokens served " \
        "from shared prefixes" in out
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.run(["--arch", "whisper-small", "--smoke", "--kv-pool-mb", "1",
                   "--device", "cpu"])
