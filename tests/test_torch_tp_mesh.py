"""Serving under every ("data", "model") mesh the JAX engine takes
(ROADMAP A11b, serving part): a data axis above 1 with ZeRO storage,
heads that do not divide the model axis, MoE archs and the prefix cache.

The JAX test (``tests/test_sharded_serving.py``) serves on a forced
8-device host at (4, 2) and (2, 4) and holds every run equal to its
single-device engine.  Here the port's ranks are processes: one world of
4 gloo ranks and one of 2 are spawned for the module (a ``file://``
store in ``tmp_path``, collectives timing out after 60 s, each rank on
one CPU thread) and each serves every job of its world in that spawn
(``launch.mesh.run_jobs`` over ``launch.serve.serve_shard``; a job's
"mesh_model" picks its mesh),
on its shard of the JAX package's own weights (``bridge``), in float32.

* (2, 2) on 4 ranks, ``fsdp=True`` on the tp geometry (smollm-smoke-tp:
  8 q / 4 kv heads of 16, d_model 128), so the big weights are stored
  ZeRO over "data" and gathered at use: paged h2o, paged lookaheadkv,
  dense-slot lookaheadkv, sampled paged lookaheadkv, and the pool-pinned
  prefix cache; decode splits the two slots over the two data rows.
* (2, 1) on 2 ranks: a data axis only (paged and dense-slot lookaheadkv).
* (1, 2): deepseek-moe-smoke under both dispatches (experts stored on
  "model", gathered whole at use), gemma3-smoke (4 q / 1 kv heads: every
  layer whole on every rank) on dense slots, and the dense-slot prefix
  cache under a byte budget that refuses inserts.

Every request's tokens and kept (layer, kv head, position) sets, each
data row's ranks' kv heads gathered to global ones, equal the JAX
single-device engine's on a trace with staggered arrivals; the MoE runs
equal the port's one-rank engine in every field of every request and
JAX's tokens and kept sets (``test_torch_moe.py``'s rule).  Prefix-cache
hits, tokens skipped and bytes equal JAX's.  Also ``stats["mesh"]``.

The world of 2 also runs the split-cache decode on (1, 2)
(``serve.split_decode_shard``): gemma3-smoke, whose frozen rows each rank
holds half of by sequence and whose partials merge over the two ranks,
and the tp geometry, whose kv heads split; both against the port's
one-rank split decode (float32, logits within 1e-5, the same tokens).
The split decode itself is held against JAX in
``test_torch_split_decode.py``.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import threading

import jax
import jax.numpy as jnp
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
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import ServingConfig as JServing
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.policies import Sampling
from repro_torch.launch import serve
from repro_torch.launch.mesh import run_jobs, spawn_ranks
from repro_torch.serving import ChunkingConfig, Request, ServingConfig
from trace_utils import kept_sets, make_trace_requests

CHUNK, BUDGET, MAX_NEW, BLOCKS = 32, 8, 4, 64
SAMPLING = (0.7, 50, 0.9)
#: the dense prefix cache's budget: one entry of the tp geometry's
#: lookaheadkv snapshots fits in its global bytes (34,816), three would
#: in one rank's bytes, so counting local bytes changes the hits' depth
PREFIX_DENSE_BYTES = 60_000
#: job name -> (model, policy, paged, sampled, prefix cache, worlds as
#: (world size, model shards))
CASES = {
    "paged-h2o": ("tp", "h2o", True, False, None, ((4, 2),)),
    "paged-lookaheadkv": ("tp", "lookaheadkv", True, False, None,
                          ((4, 2), (2, 1))),
    "dense-lookaheadkv": ("tp", "lookaheadkv", False, False, None,
                          ((4, 2), (2, 1))),
    "paged-sampled": ("tp", "lookaheadkv", True, True, None, ((4, 2),)),
    "paged-prefix": ("tp", "lookaheadkv", True, False, 1 << 30,
                     ((4, 2), (2, 2))),
    "dense-prefix": ("tp", "lookaheadkv", False, False, PREFIX_DENSE_BYTES,
                     ((2, 2),)),
    "gemma-dense": ("gemma", "lookaheadkv", False, False, None, ((2, 2),)),
    "moe-dense": ("moe-dense", "lookaheadkv", True, False, None, ((2, 2),)),
    "moe-sparse": ("moe-sparse", "lookaheadkv", True, False, None,
                   ((2, 2),)),
}
RUNS = [(name, n, m) for name, c in CASES.items() for n, m in c[5]]


def _tp(base):
    """The JAX test's geometry: 8 q over 4 kv heads, so 2 divides."""
    return dataclasses.replace(
        base, name="smollm-smoke-tp", d_model=128, dtype="float32",
        attn=dataclasses.replace(base.attn, num_heads=8, num_kv_heads=4,
                                 head_dim=16))


def _moe(base, dispatch):
    return dataclasses.replace(
        base, dtype="float32",
        moe=dataclasses.replace(base.moe, dispatch=dispatch))


def _configs(get, name):
    if name == "tp":
        return _tp(get("smollm-135m"))
    if name == "gemma":
        return dataclasses.replace(get("gemma3-1b"), dtype="float32")
    return _moe(get("deepseek-moe-16b"), name.split("-")[1])


@pytest.fixture(scope="module")
def models():
    """{model: its JAX config, the port's (``fsdp=True``: ZeRO storage
    wherever the data axis divides d_model), JAX params and lookahead
    modules (LoRA b drawn, so that the modules matter) and the trace}."""
    out = {}
    for name in ("tp", "gemma", "moe-dense", "moe-sparse"):
        jcfg = _configs(jax_smoke, name)
        tcfg = dataclasses.replace(_configs(get_smoke_config, name),
                                   fsdp=True)
        jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        jl = jax_init_lkv(jax.random.PRNGKey(1), jcfg, jp["layers"])
        rng = np.random.default_rng(5)
        jl = jax.tree_util.tree_map_with_path(
            lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05,
                                      x.dtype)
                          if str(p[-1].key) == "b" else x), jl)
        reqs = make_trace_requests(jcfg, chunk=CHUNK, seed=3, n_requests=4,
                                   max_new=MAX_NEW)
        if name.startswith("moe"):
            # all at once: the capacity dispatch couples the rows of a
            # decode step, so staggered arrivals would leave its tokens to
            # the clock (which slots decode together)
            for r in reqs:
                r.arrival_s = 0.0
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jl=jl, reqs=reqs,
                         np_params=jax.tree.map(np.asarray, jp),
                         np_lkv=jax.tree.map(np.asarray, jl))
    return out


def _chunking(reqs, chunking):
    return chunking(chunk=CHUNK, max_context=max(len(r.prompt) for r in reqs),
                    decode_chunk=2)


_JAX_RUNS: dict = {}


def _jax_run(m, case):
    """The JAX single-device serve of the case's trace, once per case:
    ({uid: request}, prefix-cache stats or None)."""
    if case not in _JAX_RUNS:
        _, policy, paged, sampled, prefix, _ = CASES[case]
        reqs = m["reqs"]
        pool = (JPool(m["jcfg"], block_size=16, num_blocks=BLOCKS)
                if paged else None)
        pc = (JPrefixCache(chunk=CHUNK, max_bytes=prefix, pool=pool)
              if prefix else None)
        sc = JServing(
            policy=policy, evict=JEvict(budget=BUDGET),
            chunking=_chunking(reqs, JChunking), num_slots=2,
            max_new_tokens=MAX_NEW, eos_id=-1, capture_admission=True,
            kv_pool=pool, prefix_cache=pc,
            sampling=JSampling(*SAMPLING) if sampled else None)
        eng = JEngine(m["jp"], m["jcfg"], sc, lkv_params=m["jl"])
        done = eng.run([r.clone() for r in reqs])
        _JAX_RUNS[case] = ({r.uid: r for r in done},
                           None if pc is None else pc.stats())
    return _JAX_RUNS[case]


def _job(m, case, mesh_model=None):
    _, policy, paged, sampled, prefix, _ = CASES[case]
    reqs = [Request(uid=r.uid, prompt=np.asarray(r.prompt),
                    max_new_tokens=r.max_new_tokens, arrival_s=r.arrival_s)
            for r in m["reqs"]]
    sc = ServingConfig(
        policy=policy, evict=EvictionConfig(budget=BUDGET),
        chunking=_chunking(reqs, ChunkingConfig), num_slots=2,
        max_new_tokens=MAX_NEW, eos_id=-1, capture_admission=True,
        sampling=Sampling(*SAMPLING) if sampled else None)
    job = dict(cfg=m["tcfg"], device="cpu", serving=sc, requests=reqs,
               pool=dict(block_size=16, num_blocks=BLOCKS) if paged
               else None, params=m["np_params"], lkv=m["np_lkv"],
               prefix_cache=dict(max_bytes=prefix) if prefix else None)
    if mesh_model is not None:
        job["mesh_model"] = mesh_model
    return job


#: the split-cache decode over (1, 2) (``serve.split_decode_shard``, in
#: the world of 2): job name -> model.  gemma3-smoke's 1 kv head divides
#: nothing, so each rank holds half the frozen rows and merges its
#: partials with the other's; the tp geometry's 4 kv heads split 2 / 2,
#: so each rank holds its heads' rows and merges nothing
SPLIT_CASES = {"split-gemma": "gemma", "split-tp": "tp"}


def _split_job(m):
    """6 greedy steps over a 32-row frozen cache drawn from a seed, a
    4-row hot ring (it wraps), 2 sequences."""
    rng = np.random.default_rng(7)
    return dict(cfg=m["tcfg"], device="cpu", batch=2, capacity=32,
                hot_slots=4, steps=6, params=m["np_params"], cache_seed=11,
                token=rng.integers(0, m["tcfg"].vocab_size, (2, 1)),
                mesh_model=2)


def _spawn_worlds(models, tmp_path_factory) -> dict:
    """{(world size, model shards): {case: per-rank results}}, one spawn
    per world size; the world of 2 also runs the split-cache decode jobs
    (under (2, 2), as the (1, 2) mesh's)."""
    out = {}
    for n in (4, 2):
        runs = [(c, m) for c, w, m in RUNS if w == n]
        jobs = [(serve.serve_shard, _job(models[CASES[c][0]], c, m))
                for c, m in runs]
        if n == 2:
            runs += [(c, 2) for c in SPLIT_CASES]
            jobs += [(serve.split_decode_shard, _split_job(models[model]))
                     for model in SPLIT_CASES.values()]
        store = str(tmp_path_factory.mktemp(f"world{n}") / "store")
        res = spawn_ranks(run_jobs, n, (jobs,), init_file=store,
                          timeout_s=60.0, join_s=240.0)
        for i, (c, m) in enumerate(runs):
            out.setdefault((n, m), {})[c] = [res[r][i] for r in range(n)]
    return out


@pytest.fixture(scope="module")
def worlds(models, tmp_path_factory):
    """The spawned worlds' results (``_spawn_worlds``), each rank on one
    CPU thread (gloo ranks on a shared box); the JAX single-device runs
    are computed meanwhile, in this process."""
    box: dict = {}

    def spawn():
        try:
            box["out"] = _spawn_worlds(models, tmp_path_factory)
        except BaseException as e:  # re-raised below
            box["err"] = e

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # read by the spawned ranks
        th = threading.Thread(target=spawn)
        th.start()
        try:
            for case, _n, _m in RUNS:
                _jax_run(models[CASES[case][0]], case)
        finally:
            th.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def _row_kept(ranks, uid, field="admission_cache"):
    """Each data row's kept sets of ``uid`` (at admission, or with
    ``field="retirement_cache"`` at retirement), its ranks' local kv
    heads concatenated in model order (rank (d, m)'s head h is global
    m * KV/M + h; with heads that do not divide, each rank holds all)."""
    rows: dict = {}
    for rk in ranks:
        rows.setdefault(rk["data_index"], []).append(rk)
    out = []
    for row in sorted(rows):
        rks = sorted(rows[row], key=lambda rk: rk["model_index"])
        caches = [getattr(next(r for r in rk["done"] if r.uid == uid), field)
                  for rk in rks]
        out.append(_kept({f: np.concatenate([c[f] for c in caches], axis=-1)
                          for f in ("mask", "pos")}))
    return out


def _kept(cache):
    """``kept_sets`` of an admission cache (L, 1, rows, KV) or of a
    retirement cache (L, rows, KV)."""
    if cache["mask"].ndim == 3:
        cache = {f: x[:, None] for f, x in cache.items()}
    return kept_sets(cache)


@pytest.mark.parametrize("case,n,m", RUNS)
def test_mesh_serving_matches_jax_single_device(models, worlds, case, n, m):
    model = CASES[case][0]
    want, want_pc = _jax_run(models[model], case)
    ranks = worlds[(n, m)][case]
    rows = n // m
    for i, rk in enumerate(ranks):  # every rank serves the same tokens
        got = {r.uid: r for r in rk["done"]}
        assert {u: got[u].out_tokens for u in want} == \
            {u: w.out_tokens for u, w in want.items()}, f"rank {i}"
        assert rk["stats"]["mesh"] == {"data": rows, "model": m}
        assert (rk["data_index"], rk["model_index"]) == divmod(i, m)
        assert rk["launches"] == {k: 0 for k in rk["launches"]}  # CPU
        # the two slots split over two data rows (the sparse MoE and a
        # single row decode them all)
        assert rk["decode_slots"] == (None if rows == 1 else [i // m,
                                                              i // m + 1])
    if rows > 1:  # ZeRO: a data row's ranks hold half of what one row's do
        one_row = worlds[(2, 2)]["paged-prefix"][0]["param_bytes"]
        assert ranks[0]["param_bytes"] < one_row * 0.6 * 2 / m
    whole = model == "gemma"  # 1 kv head: every rank holds it whole
    rows_of = ranks if not whole else [dict(rk, model_index=0, data_index=i)
                                       for i, rk in enumerate(ranks)]
    paged = CASES[case][2]
    for uid, w in want.items():
        for row in _row_kept(rows_of, uid):
            assert row == _kept(w.admission_cache), \
                f"{case} ({n // m}, {m}) uid={uid}: kept sets diverged"
        # at retirement: the decode appends, which only the slot's own
        # data row wrote, broadcast to every row
        for row in (_row_kept(rows_of, uid, "retirement_cache") if paged
                    else ()):
            assert row == _kept(w.retirement_cache), \
                f"{case} ({n // m}, {m}) uid={uid}: retirement sets"
    if want_pc is not None:
        for rk in ranks:
            got_pc = rk["stats"]["prefix_cache"]
            assert want_pc["hits"] > 0
            for key in ("hits", "misses", "tokens_hit", "inserts",
                        "evictions", "bytes", "entries"):
                assert got_pc[key] == want_pc[key], (case, key)
            assert rk["counts"]["prefix_tokens_skipped"] == \
                want_pc["tokens_hit"]


@pytest.mark.parametrize("case", ["moe-dense", "moe-sparse"])
def test_moe_mesh_equals_one_rank_engine(models, worlds, case):
    """deepseek-moe-smoke on 2 ranks against the port's one-rank engine,
    bit for bit: tokens, every admission-cache leaf (mask, pos; each
    rank's kv heads) and the retirement kept sets."""
    one = serve.serve_job(_job(models[CASES[case][0]], case))
    want = {r.uid: r for r in one["done"]}
    ranks = worlds[(2, 2)][case]
    for rk in ranks:
        got = {r.uid: r for r in rk["done"]}
        assert [r.uid for r in rk["done"]] == [r.uid for r in one["done"]]
        i = rk["model_index"]
        for uid, w in want.items():
            g = got[uid]
            assert g.out_tokens == w.out_tokens
            for f in ("mask", "pos"):
                kv = g.admission_cache[f].shape[-1]
                np.testing.assert_array_equal(
                    g.admission_cache[f],
                    w.admission_cache[f][..., i * kv:(i + 1) * kv])
                kv = g.retirement_cache[f].shape[-1]
                np.testing.assert_array_equal(
                    g.retirement_cache[f],
                    w.retirement_cache[f][..., i * kv:(i + 1) * kv])
    assert one["stats"]["mesh"] is None


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_decode_over_two_ranks_equals_one_rank(models, worlds, case):
    """The split-cache decode on (1, 2) against the port's one-rank split
    decode of the same job: the same tokens on both ranks, logits within
    1e-5 (float32; the merged partials sum in another order where the
    frozen rows split), and the frozen rows each rank holds: half of them
    (gemma: a sequence slice, merged over the ranks; tp: its kv heads)."""
    job = _split_job(models[SPLIT_CASES[case]])
    one = serve.split_decode_job(job)
    ranks = worlds[(2, 2)][case]
    for rk in ranks:
        np.testing.assert_array_equal(rk["tokens"], one["tokens"])
        np.testing.assert_allclose(rk["logits"], one["logits"], atol=1e-5,
                                   rtol=1e-5)
        assert rk["launches"] == {k: 0 for k in rk["launches"]}  # CPU
        assert rk["cache_bytes"] < one["cache_bytes"]
    assert [rk["model_index"] for rk in ranks] == [0, 1]
    cfg = job["cfg"]
    a = cfg.attn
    rows = cfg.num_layers * 2 * 32 * a.num_kv_heads  # (L, B, C, KV)
    frozen = rows * (2 * a.head_dim * 4 + 5)  # k, v f32; pos i32, mask
    ring = one["cache_bytes"] - frozen - 2 * 4  # next_pos
    want = frozen // 2 + (ring if case == "split-gemma" else ring // 2) + 8
    assert [rk["cache_bytes"] for rk in ranks] == [want, want]
