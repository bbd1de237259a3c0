"""Parity of the port's other dense archs (ROADMAP A10's dense half)
against the JAX package, on the CPU.

Float32 copies of the smoke configs of gemma3-1b (5:1 local:global cut to
2 layers: layer 0 local with window 16, layer 1 global), qwen2-1.5b (qkv
bias), smollm-135m and minitron-8b, and gemma3's with ``head_dim=256``
(the served head dim, which the port's every attention kernel takes),
with the JAX parameters bridged leaf for leaf:

* ``tf.prefill`` under lookaheadkv: logits, the kept (layer, sequence,
  head, position) sets, k/v, positions, masks, cursor and next positions;
  then three dense ``decode_step`` calls on each side's cache: logits and
  caches;
* gemma3 at head dim 256 through the chunked prefill (``prefill_chunk``,
  ``prefill_finalize``) against JAX's, and against the port's monolithic
  prefill;
* the paged ``ContinuousEngine`` for gemma3 and qwen2, and the dense-slot
  and lockstep engines for gemma3, against the JAX engines on one mixed
  trace: tokens and admission kept sets identical;
* the launcher's routes for ``--arch gemma3-1b --smoke``.

Tolerances: logits and k/v 1e-4 (float32, other summation orders); kept
sets, positions, masks, cursors and tokens identical.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import warnings

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
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServing
from repro.serving import ServingEngine as JLockstep
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig as TEvict
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import transformer as ttf
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 KVBlockPool, Request, ServingConfig,
                                 ServingEngine)

TOL = dict(atol=1e-4, rtol=1e-4)
#: the four archs, and gemma3 at its served head dim
ARCHS = ("gemma3-1b", "qwen2-1.5b", "smollm-135m", "minitron-8b",
         "gemma3-1b@256")


def _cfg(get, arch):
    name, _, hd = arch.partition("@")
    cfg = dataclasses.replace(get(name), dtype="float32")
    if hd:
        cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, head_dim=int(hd)))
    return cfg


_MODELS = {}


def _model(arch):
    """The arch's float32 smoke model in both packages (built once per
    worker): JAX parameters and lookahead modules (LoRA b drawn, so the
    selective LoRA matters), bridged to the port."""
    if arch not in _MODELS:
        jcfg, tcfg = _cfg(jax_smoke, arch), _cfg(get_smoke_config, arch)
        params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
        rng = np.random.default_rng(5)
        lkv = jax.tree_util.tree_map_with_path(
            lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05,
                                      x.dtype)
                          if str(p[-1].key) == "b" else x), lkv)
        _MODELS[arch] = dict(
            jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv,
            tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                               device="cpu"),
            tl=bridge.to_torch(jax.tree.map(np.asarray, lkv), device="cpu"))
    return _MODELS[arch]


def _kept(mask, pos):
    L, B, _, KV = mask.shape
    return {(l, b, h): frozenset(pos[l, b, mask[l, b, :, h], h].tolist())
            for l in range(L) for b in range(B) for h in range(KV)}


def _attn_np(cache):
    return {k: np.asarray(v) for k, v in cache["attn"].items()}


def _assert_caches_equal(jcache, tcache):
    ja, ta = _attn_np(jcache), _attn_np(tcache)
    assert ta["mask"].shape == ja["mask"].shape
    assert _kept(ta["mask"], ta["pos"]) == _kept(ja["mask"], ja["pos"])
    np.testing.assert_array_equal(ta["mask"], ja["mask"])
    np.testing.assert_array_equal(ta["pos"], ja["pos"])
    np.testing.assert_allclose(ta["k"], ja["k"], **TOL)
    np.testing.assert_allclose(ta["v"], ja["v"], **TOL)
    assert int(tcache["cursor"]) == int(jcache["cursor"])
    np.testing.assert_array_equal(np.asarray(tcache["next_pos"]),
                                  np.asarray(jcache["next_pos"]))


def test_registry_serves_the_dense_archs():
    """The four archs are ported; their configs name their published
    shapes (gemma3's 26 layers alternate 5 local : 1 global)."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import layer_window
    g = get_config("gemma3-1b")
    assert (g.attn.head_dim, g.attn.num_heads, g.attn.num_kv_heads) == (
        256, 4, 1)
    flags = ttf.is_global_flags(g)
    assert [i for i in range(g.num_layers) if flags[i]] == [5, 11, 17, 23]
    assert [layer_window(g.attn, bool(f)) for f in flags].count(512) == 22
    assert get_config("qwen2-1.5b").attn.qkv_bias
    assert get_config("minitron-8b").vocab_size == 256000
    assert get_config("smollm-135m").attn.num_kv_heads == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """``tf.prefill`` under lookaheadkv (2 x 45 tokens: past gemma3's
    window of 16), then three greedy dense decode steps on each side's
    cache."""
    m = _model(arch)
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, 512, (2, 45)).astype(np.int32)
    jr = jtf.prefill(m["jp"], m["jcfg"], jnp.asarray(tokens),
                     lkv_params=m["jl"], policy="lookaheadkv",
                     evict=JEvict(budget=16), extra_slots=5)
    tr = ttf.prefill(m["tp"], m["tcfg"], torch.from_numpy(tokens),
                     lkv_params=m["tl"], policy="lookaheadkv",
                     evict=TEvict(budget=16), extra_slots=5)
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **TOL)
    _assert_caches_equal(jr.cache, tr.cache)
    assert int(tr.cache["cursor"]) == 16
    jcache, tcache = jr.cache, tr.cache
    tok = np.asarray(jnp.argmax(jr.logits, -1)[:, None]).astype(np.int32)
    for _ in range(3):
        jlog, jcache = jtf.decode_step(m["jp"], m["jcfg"], jnp.asarray(tok),
                                       jcache)
        tlog, tcache = ttf.decode_step(m["tp"], m["tcfg"],
                                       torch.from_numpy(tok), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)[:, None]).astype(np.int32)
    _assert_caches_equal(jcache, tcache)


def test_gemma3_hd256_chunked_prefill_matches_jax_and_monolithic():
    """gemma3 at head dim 256 through the streaming prefill (chunks of
    16, the last partial) against JAX's, and against the port's
    monolithic prefill: logits and kept sets."""
    m = _model("gemma3-1b@256")
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(11)
    n_total, chunk = 45, 16
    tokens = rng.integers(0, 512, (1, n_total)).astype(np.int32)
    jstate = jtf.init_chunk_state(jcfg, "lookaheadkv", 1, 64)
    tstate = ttf.init_chunk_state(tcfg, "lookaheadkv", 1, 64, device="cpu")
    for s in range(0, n_total, chunk):
        blk = np.zeros((1, chunk), np.int32)
        seg = tokens[:, s:s + chunk]
        blk[:, :seg.shape[1]] = seg
        jstate, jlog = jtf.prefill_chunk(
            m["jp"], jcfg, jstate, jnp.asarray(blk),
            jnp.asarray(n_total, jnp.int32), policy="lookaheadkv")
        tstate, tlog = ttf.prefill_chunk(m["tp"], tcfg, tstate,
                                         torch.from_numpy(blk), n_total,
                                         policy="lookaheadkv")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tstate.k[:, :, :n_total].numpy(),
                               np.asarray(jstate.k)[:, :, :n_total], **TOL)
    jcache = jtf.prefill_finalize(m["jp"], jcfg, jstate,
                                  jnp.asarray(n_total, jnp.int32),
                                  policy="lookaheadkv",
                                  evict=JEvict(budget=16),
                                  lkv_params=m["jl"], extra_slots=5)
    tcache = ttf.prefill_finalize(m["tp"], tcfg, tstate, n_total,
                                  policy="lookaheadkv",
                                  evict=TEvict(budget=16),
                                  lkv_params=m["tl"], extra_slots=5)
    _assert_caches_equal(jcache, tcache)
    mono = ttf.prefill(m["tp"], tcfg, torch.from_numpy(tokens),
                       lkv_params=m["tl"], policy="lookaheadkv",
                       evict=TEvict(budget=16), extra_slots=5)
    np.testing.assert_allclose(mono.logits.numpy(), tlog.numpy(), **TOL)
    ma, ca = _attn_np(mono.cache), _attn_np(tcache)
    assert _kept(ma["mask"], ma["pos"]) == _kept(ca["mask"], ca["pos"])
    np.testing.assert_allclose(ma["k"], ca["k"], **TOL)


def _admission_sets(adm):
    m, p = adm["mask"], adm["pos"]
    L, _, _, KV = m.shape
    return {(lyr, h): frozenset(p[lyr, 0, m[lyr, 0, :, h], h].tolist())
            for lyr in range(L) for h in range(KV)}


@pytest.mark.parametrize("arch,paged", [("gemma3-1b", True),
                                        ("qwen2-1.5b", True),
                                        ("gemma3-1b", False)])
def test_continuous_engine_matches_jax(arch, paged):
    """The chunked ``ContinuousEngine`` (paged pool or dense slot caches)
    against JAX's on a mixed trace: prompts shorter than the budget,
    longer than gemma3's window, not multiples of the chunk, more requests
    than slots."""
    m = _model(arch)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(9)
    lens, max_new, chunk, budget = [37, 11, 50, 23], 6, 16, 16
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    jsc = JServing(policy="lookaheadkv", evict=JEvict(budget=budget),
                   chunking=JChunking(chunk=chunk, max_context=max(lens)),
                   num_slots=2, max_new_tokens=max_new, eos_id=-1,
                   kv_pool=(JPool(jcfg, block_size=8, num_blocks=24)
                            if paged else None),
                   capture_admission=True)
    jdone = JEngine(m["jp"], jcfg, jsc, lkv_params=m["jl"]).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=max_new)
         for i, p in enumerate(prompts)])
    tsc = ServingConfig(
        policy="lookaheadkv", evict=TEvict(budget=budget),
        chunking=ChunkingConfig(chunk=chunk, max_context=max(lens)),
        num_slots=2, max_new_tokens=max_new, eos_id=-1,
        kv_pool=(KVBlockPool(tcfg, block_size=8, num_blocks=24,
                             device="cpu") if paged else None),
        capture_admission=True)
    eng = ContinuousEngine(m["tp"], tcfg, tsc, lkv_params=m["tl"],
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
        assert _admission_sets(g.admission_cache) == _admission_sets(
            w.admission_cache), f"uid {uid}: kept sets diverged"
    if paged:
        eng.pool.check()
        assert eng.pool.used_blocks() == 0


def test_gemma3_lockstep_engine_matches_jax():
    m = _model("gemma3-1b")
    rng = np.random.default_rng(17)
    n_in, max_new = 45, 7
    prompts = [rng.integers(0, 512, n_in).astype(np.int32) for _ in range(3)]
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JLockstep(m["jp"], m["jcfg"], policy="lookaheadkv",
                         evict=JEvict(budget=16), lkv_params=m["jl"],
                         max_new_tokens=max_new, eos_id=-1)
    jdone = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=max_new)
                        for i, p in enumerate(prompts)])
    teng = ServingEngine(m["tp"], m["tcfg"], policy="lookaheadkv",
                         evict=TEvict(budget=16), lkv_params=m["tl"],
                         max_new_tokens=max_new, eos_id=-1, device="cpu")
    tdone = teng.serve([Request(uid=i, prompt=p, max_new_tokens=max_new)
                        for i, p in enumerate(prompts)])
    for j, t in zip(jdone, tdone):
        assert t.out_tokens == j.out_tokens, f"uid {t.uid}: tokens diverged"
        assert len(t.out_tokens) == max_new and t.done


@pytest.mark.parametrize("route,engine", [
    ([], "ServingEngine:"),
    (["--continuous"], "ContinuousEngine:"),
    (["--continuous", "--kv-pool-mb", "1"], "ContinuousEngine (paged):"),
    (["--continuous", "--policy", "full"], "BucketedEngine:"),
])
def test_launcher_serves_gemma3_on_each_route(route, engine, capsys):
    serve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                "--budget", "16", "--chunk", "32", "--requests", "3",
                "--n-in", "48", "--max-new", "4"] + route)
    out = capsys.readouterr().out
    assert out.startswith(engine) and "requests=3" in out, out
    assert out.count("4 tokens") == 3
