"""Decode-time eviction in the port, below the engine, against the JAX
package on the CPU.

* The plain ``ref.paged_decode_masses`` (what a CPU tensor runs in place
  of kernel 5) against the JAX ``paged_decode_masses_pallas`` in
  interpret mode, over the JAX package's own sweep of cases (ragged
  tables with null entries, per-head masks, GQA groups, windows); and the
  public ``ops.paged_decode_attention(score_masses=True, depth=...)``.
* ``scoring.decode_mass_update`` and ``engine.paged_sweep`` on the same
  arrays as the JAX functions.
* The dense evicting decode step (through ``transformer.decode_step``,
  which takes it when the cache carries ``score``): scalar and per-slot
  cursors, through the fill and past it, with an inactive slot.
* The paged decode step with a ``score`` leaf: the same tokens as without
  it, and the scores the JAX step accumulates.

Tolerances: masses 2e-5 (the JAX test's own, float32 in another
summation order); logits, K/V and scores 1e-4; kept positions, masks,
cursors, the sweep's pool and score bit-equal (the sweep only moves
values).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import sweep_cases
from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core import scoring as jscoring
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_masses_pallas
from repro.models import transformer as jtf
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import DecodeEvictionConfig as JDecodeEvict
from repro.serving import KVBlockPool as JPool
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServing
from repro.serving import ServingEngine as JLockstep
from repro.serving.engine import paged_sweep as jax_paged_sweep
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import scoring
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import transformer as ttf
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 DecodeEvictionConfig, KVBlockPool, Request,
                                 ServingConfig, ServingEngine)
from repro_torch.serving.engine import paged_sweep

MASS_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"))


# ---------------------------------------------------------------------------
# kernel 5's plain version
# ---------------------------------------------------------------------------


def _masses_case(rng):
    """The JAX package's sweep (tests/test_kv_pool.py, ``_paged_case`` plus
    a window half the time)."""
    kv = int(rng.choice([1, 2]))
    case = {
        "B": int(rng.integers(1, 4)),
        "KV": kv,
        "G": int(rng.choice([1, 3])),
        "hd": int(rng.choice([16, 32])),
        "bs": int(rng.choice([4, 8, 16])),
        "N": int(rng.integers(4, 12)),
        "nb": int(rng.integers(1, 6)),
        "seed": int(rng.integers(1e6)),
    }
    case["window"] = int(rng.integers(3, 30)) if rng.random() < 0.5 else 0
    return case


@pytest.mark.parametrize("case", sweep_cases(17, 8, _masses_case))
def test_plain_masses_match_pallas_interpret(case):
    rng = np.random.default_rng(case["seed"])
    B, KV, hd, bs = case["B"], case["KV"], case["hd"], case["bs"]
    N, nb, H = case["N"], case["nb"], case["KV"] * case["G"]
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    pk = rng.normal(size=(N, bs, KV, hd)).astype(np.float32)
    pv = rng.normal(size=(N, bs, KV, hd)).astype(np.float32)
    pm = rng.random((N, bs, KV)) > 0.3
    pm[0] = False
    tbl = np.zeros((B, nb), np.int32)
    for b in range(B):
        n_live = int(rng.integers(0, min(nb, N - 1) + 1))
        tbl[b, :n_live] = rng.choice(np.arange(1, N), n_live, replace=False)
        rng.shuffle(tbl[b])
    kw = {}
    if case["window"]:
        kw = {"pos_pool": rng.integers(0, 50, (N, bs, KV)).astype(np.int32),
              "new_pos": rng.integers(20, 70, (B,)).astype(np.int32),
              "window": case["window"]}
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    _, want = paged_decode_masses_pallas(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pm),
        jnp.asarray(tbl), interpret=True, **jkw)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, pk, pv))
    tm, tt = torch.from_numpy(pm), torch.from_numpy(tbl)
    got = ref.paged_decode_masses(tq, tk, tm, tt, **tkw)
    assert got.dtype == torch.float32 and got.shape == (B, H, nb * bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MASS_TOL)
    # the public entry: `out` is the unscored call's, masses as above
    plain = ops.paged_decode_attention(tq, tk, tv, tm, tt, **tkw)
    out, masses = ops.paged_decode_attention(tq, tk, tv, tm, tt,
                                             score_masses=True, **tkw)
    assert torch.equal(out, plain)
    assert torch.equal(masses, got)
    # masked rows are exact zeros; a (sequence, head) sums to 1 or to 0
    sums = got.sum(-1)
    assert bool(torch.all(((sums - 1).abs() <= 1e-4) | (sums == 0)))
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_paged_masses_depth_slices_the_window():
    """``depth`` limits the softmax to the first ``depth`` rows (the JAX
    gather tier's rule) and the masses to ``depth`` columns; the engine
    masks every row past it, so nothing else changes."""
    rng = np.random.default_rng(3)
    B, H, KV, hd, bs, N, nb = 2, 6, 2, 16, 4, 11, 5
    depth = 18  # not a multiple of bs: capacity + interval
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    pk = rng.normal(size=(N, bs, KV, hd)).astype(np.float32)
    pv = rng.normal(size=(N, bs, KV, hd)).astype(np.float32)
    pm = rng.random((N, bs, KV)) > 0.2
    pm[0] = False
    tbl = 1 + np.arange(B * nb, dtype=np.int32).reshape(B, nb)
    pm[tbl[:, -1], depth - (nb - 1) * bs:] = False
    want = jref.paged_decode_masses(jnp.asarray(q), jnp.asarray(pk),
                                    jnp.asarray(pm), jnp.asarray(tbl),
                                    depth=depth)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, pk, pv))
    tm, tt = torch.from_numpy(pm), torch.from_numpy(tbl)
    plain = ops.paged_decode_attention(tq, tk, tv, tm, tt)
    out, masses = ops.paged_decode_attention(tq, tk, tv, tm, tt, depth=depth,
                                             score_masses=True)
    assert torch.equal(out, plain)
    assert masses.shape == (B, H, depth)
    np.testing.assert_allclose(masses.numpy(), np.asarray(want), **MASS_TOL)
    full = ref.paged_decode_masses(tq, tk, tm, tt)
    np.testing.assert_allclose(masses.numpy(), full[..., :depth].numpy(),
                               **MASS_TOL)


# ---------------------------------------------------------------------------
# score update and sweep
# ---------------------------------------------------------------------------


def test_decode_mass_update_matches_jax():
    rng = np.random.default_rng(4)
    masses = rng.random((3, 6, 10)).astype(np.float32)
    active = np.asarray([True, False, True])
    want = jscoring.decode_mass_update(jnp.asarray(masses), 2,
                                       active=jnp.asarray(active))
    got = scoring.decode_mass_update(torch.from_numpy(masses), 2,
                                     active=torch.from_numpy(active))
    assert got.shape == (3, 10, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert torch.all(got[1] == 0)
    np.testing.assert_allclose(
        scoring.decode_mass_update(torch.from_numpy(masses), 2).numpy(),
        np.asarray(jscoring.decode_mass_update(jnp.asarray(masses), 2)),
        rtol=1e-6)


@pytest.mark.parametrize("seed,capacity,depth", [(0, 6, 16), (1, 5, 14)])
def test_paged_sweep_matches_jax(seed, capacity, depth):
    """Evict-and-compact one slot on the same arrays: the pool and the
    score buffer come out bit-equal to the JAX sweep's (ties in the score
    included: the top-k keeps the lower row), and nothing outside the
    slot's keep run or score lane moves."""
    rng = np.random.default_rng(seed)
    L, KV, hd, bs = 2, 2, 8, 4
    nb, nb_keep = -(-depth // bs), -(-capacity // bs)
    num_slots, N = 3, 12
    arrs = {
        "k": rng.normal(size=(L, N, bs, KV, hd)).astype(np.float32),
        "v": rng.normal(size=(L, N, bs, KV, hd)).astype(np.float32),
        "pos": rng.integers(0, 500, size=(L, N, bs, KV)).astype(np.int32),
        "mask": rng.random((L, N, bs, KV)) < 0.8,
    }
    arrs["mask"][:, 0] = False  # the null block
    score = rng.random((L, num_slots, depth, KV)).astype(np.float32)
    score[0, 1, :4] = 0.5  # exact ties
    slot = 1
    table = np.zeros((num_slots, nb), np.int32)
    table[slot] = rng.choice(np.arange(1, N), nb, replace=False)
    jpool, jscore = jax_paged_sweep(
        {n: jnp.asarray(x) for n, x in arrs.items()}, jnp.asarray(score),
        jnp.asarray(table), jnp.asarray(slot, jnp.int32), capacity=capacity,
        depth=depth, block_size=bs, nb_keep=nb_keep)
    tpool = bridge.to_torch(arrs, device="cpu")
    tscore = torch.from_numpy(score.copy())
    paged_sweep(tpool, tscore, torch.from_numpy(table), slot,
                capacity=capacity, depth=depth, block_size=bs,
                nb_keep=nb_keep)
    for name in arrs:
        np.testing.assert_array_equal(tpool[name].numpy(),
                                      np.asarray(jpool[name]), err_msg=name)
    np.testing.assert_array_equal(tscore.numpy(), np.asarray(jscore))
    others = np.setdiff1d(np.arange(N), table[slot, :nb_keep])
    for name, old in arrs.items():
        np.testing.assert_array_equal(tpool[name].numpy()[:, others],
                                      old[:, others])


# ---------------------------------------------------------------------------
# decode steps
# ---------------------------------------------------------------------------


def _random_scored_cache(rng, cfg, B, C, fill):
    a = cfg.attn
    L, KV, hd = cfg.num_layers, a.num_kv_heads, a.head_dim
    mask = (rng.random((L, B, C, KV)) > 0.3) \
        & (np.arange(C)[None, None, :, None] < fill)
    return {
        "k": rng.normal(size=(L, B, C, KV, hd)).astype(np.float32),
        "v": rng.normal(size=(L, B, C, KV, hd)).astype(np.float32),
        "pos": rng.integers(0, 40, (L, B, C, KV)).astype(np.int32),
        "mask": mask,
        # distinct tallies: the victim is never a near-tie
        "score": np.where(mask, 1.0 + rng.random(mask.shape), 0.0)
        .astype(np.float32),
    }


@pytest.mark.parametrize("per_slot", [False, True])
def test_evicting_decode_step_matches_jax(model, per_slot):
    """Eight steps over a 7-row cache whose cursors start short of full:
    appends until full, then the lightest row per kv head is overwritten.
    Per-slot: a slot that starts full, one that is inactive (its k, v,
    pos, mask and score stay bit for bit) and two that fill on the way."""
    rng = np.random.default_rng(11 + per_slot)
    B, C = 4, 7
    arrs = _random_scored_cache(rng, model["jcfg"], B, C, fill=4)
    next_pos = np.asarray([[30], [41], [12], [25]], np.int32)
    if per_slot:
        cursor = np.asarray([4, C, 5, 6], np.int32)
        active = np.asarray([True, True, False, True])
        jcur, tcur = jnp.asarray(cursor), torch.from_numpy(cursor.copy())
    else:
        active = None
        jcur, tcur = jnp.asarray(4, jnp.int32), 4
    jcache = {"attn": jax.tree.map(jnp.asarray, arrs), "cursor": jcur,
              "next_pos": jnp.asarray(next_pos)}
    tcache = {"attn": bridge.to_torch(arrs, device="cpu"), "cursor": tcur,
              "next_pos": torch.from_numpy(next_pos.copy())}
    jtok = jnp.asarray(rng.integers(0, 512, (B, 1)).astype(np.int32))
    rows = slice(None) if active is None else active
    for _ in range(8):
        jlog, jnew = jtf.decode_step(model["jp"], model["jcfg"], jtok, jcache)
        if active is not None:
            jnew = jtf.select_cache_slots(jnp.asarray(active), jnew, jcache)
        tlog, tcache = ttf.decode_step(
            model["tp"], model["tcfg"], torch.from_numpy(np.array(jtok)),
            tcache, active=None if active is None
            else torch.from_numpy(active))
        np.testing.assert_allclose(tlog.numpy()[rows],
                                   np.asarray(jlog)[rows], **TOL)
        jcache = jnew
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    ja = {k: np.asarray(v) for k, v in jcache["attn"].items()}
    ta = {k: v.numpy() for k, v in tcache["attn"].items()}
    np.testing.assert_array_equal(ta["mask"], ja["mask"])
    np.testing.assert_array_equal(ta["pos"], ja["pos"])
    for name in ("k", "v", "score"):
        np.testing.assert_allclose(ta[name], ja[name], **TOL, err_msg=name)
    np.testing.assert_array_equal(np.asarray(tcache["cursor"]),
                                  np.asarray(jcache["cursor"]))
    assert ta["mask"].sum() > arrs["mask"].sum()  # appended, then evicted
    if per_slot:
        for name in arrs:  # port-only: the inactive slot is untouched
            np.testing.assert_array_equal(ta[name][:, 2], arrs[name][:, 2])


def test_paged_decode_step_accumulates_scores_like_jax(model):
    """The paged step with a ``score`` leaf: the same logits and pool as
    without it, and the masses of the cache after the append added to
    the score only where the slot wrote (one inactive slot)."""
    cfg_j, cfg_t = model["jcfg"], model["tcfg"]
    a = cfg_t.attn
    L, KV, hd = cfg_t.num_layers, a.num_kv_heads, a.head_dim
    rng = np.random.default_rng(13)
    B, bs, N, nb, depth = 3, 4, 16, 5, 18
    pool = {
        "k": rng.normal(size=(L, N, bs, KV, hd)).astype(np.float32),
        "v": rng.normal(size=(L, N, bs, KV, hd)).astype(np.float32),
        "pos": rng.integers(0, 30, (L, N, bs, KV)).astype(np.int32),
        "mask": rng.random((L, N, bs, KV)) > 0.3,
    }
    pool["mask"][:, 0] = False
    table = (1 + np.arange(B * nb, dtype=np.int32)).reshape(B, nb)
    for b in range(B):
        pool["mask"][:, table[b, -1], depth - (nb - 1) * bs:] = False
    score = rng.random((L, B, depth, KV)).astype(np.float32)
    cursor = np.asarray([9, 12, 15], np.int32)
    next_pos = np.asarray([[30], [41], [12]], np.int32)
    active = np.asarray([True, False, True])
    tok = rng.integers(0, 512, (B, 1)).astype(np.int32)

    jcache = {"attn": {"table": jnp.asarray(table)},
              "pool": dict({n: jnp.asarray(x) for n, x in pool.items()},
                           score=jnp.asarray(score)),
              "cursor": jnp.asarray(cursor), "next_pos": jnp.asarray(next_pos)}
    jlog, jnew = jtf.decode_step(model["jp"], cfg_j, jnp.asarray(tok), jcache,
                                 active=jnp.asarray(active),
                                 paged_depth=depth)

    def port(with_score):
        tpool = bridge.to_torch(pool, device="cpu")
        if with_score:
            tpool["score"] = torch.from_numpy(score.copy())
        tcache = {"attn": {"table": torch.from_numpy(table)}, "pool": tpool,
                  "cursor": torch.from_numpy(cursor.copy()),
                  "next_pos": torch.from_numpy(next_pos.copy())}
        return ttf.decode_step(model["tp"], cfg_t, torch.from_numpy(tok),
                               tcache, active=torch.from_numpy(active),
                               paged_depth=depth)

    tlog, tnew = port(True)
    plog, pnew = port(False)
    assert torch.equal(tlog, plog), "scoring must not change the step"
    np.testing.assert_allclose(tlog.numpy()[active],
                               np.asarray(jlog)[active], **TOL)
    for name in ("pos", "mask"):
        assert torch.equal(tnew["pool"][name], pnew["pool"][name])
        np.testing.assert_array_equal(tnew["pool"][name].numpy(),
                                      np.asarray(jnew["pool"][name]))
    got = tnew["pool"]["score"].numpy()
    np.testing.assert_allclose(got, np.asarray(jnew["pool"]["score"]),
                               **TOL)
    np.testing.assert_array_equal(got[:, 1], score[:, 1])  # inactive slot
    assert not np.array_equal(got[:, 0], score[:, 0])


def test_decode_eviction_config_checks():
    assert DecodeEvictionConfig.coerce(True).enabled
    assert not DecodeEvictionConfig.coerce(None).enabled
    de = DecodeEvictionConfig(enabled=True, interval=8)
    assert DecodeEvictionConfig.coerce(de) is de
    assert de.margin_rows(100) == 8
    assert DecodeEvictionConfig().margin_rows(100) == 101
    with pytest.raises(ValueError, match="interval"):
        DecodeEvictionConfig(interval=0)
    with pytest.raises(ValueError, match="margin"):
        DecodeEvictionConfig(margin=0)
    with pytest.raises(TypeError):
        DecodeEvictionConfig.coerce("yes")


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(model):
    """The model with lookahead modules (LoRA b drawn, so it matters)."""
    rng = np.random.default_rng(9)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), model["jcfg"],
                       model["jp"]["layers"])
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    return dict(model, jl=lkv,
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


def _retired(req):
    rc = req.retirement_cache
    assert rc is not None, "capture_admission must stash retirement_cache"
    return _kept(rc["mask"], rc["pos"])


def _admitted(req):
    a = req.admission_cache
    return _kept(a["mask"][:, 0], a["pos"][:, 0])


def _run_jax(m, prompts, max_new, *, pool_blocks=None, block_size=4,
             **config):
    jsc = JServing(policy="lookaheadkv", max_new_tokens=max_new, eos_id=-1,
                   capture_admission=True,
                   kv_pool=(JPool(m["jcfg"], block_size=block_size,
                                  num_blocks=pool_blocks)
                            if pool_blocks else None), **config)
    eng = JEngine(m["jp"], m["jcfg"], jsc, lkv_params=m["jl"])
    done = eng.run([JRequest(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)])
    return {r.uid: r for r in done}, eng


def _run_port(m, prompts, max_new, *, pool_blocks=None, block_size=4,
              arrivals=None, **config):
    tsc = ServingConfig(policy="lookaheadkv", max_new_tokens=max_new,
                        eos_id=-1, capture_admission=True,
                        kv_pool=(KVBlockPool(m["tcfg"],
                                             block_size=block_size,
                                             num_blocks=pool_blocks,
                                             device="cpu")
                                 if pool_blocks else None), **config)
    eng = ContinuousEngine(m["tp"], m["tcfg"], tsc, lkv_params=m["tl"],
                           device="cpu")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    done = eng.run(reqs)
    assert len(done) == len(prompts)
    return {r.uid: r for r in done}, eng


def _jax_count(eng, name):
    return int(eng.metrics.value(name))


_EVICT_LENS = [37, 11, 50, 23]


def test_paged_decode_evict_engine_matches_jax(served):
    """Sweeps fire (interval 8 over a 16-row capacity, 20 new tokens):
    the same tokens, admission and retirement kept sets, sweep count and
    reclaimed blocks as the JAX engine, and the pool drains conserved."""
    prompts = _prompts(21, _EVICT_LENS)
    common = dict(num_slots=2, pool_blocks=64)
    jdone, jeng = _run_jax(
        served, prompts, 20, evict=JEvict(budget=16),
        chunking=JChunking(chunk=16, max_context=50),
        decode_evict=JDecodeEvict(enabled=True, interval=8), **common)
    tdone, teng = _run_port(
        served, prompts, 20, evict=EvictionConfig(budget=16),
        chunking=ChunkingConfig(chunk=16, max_context=50),
        decode_evict=DecodeEvictionConfig(enabled=True, interval=8),
        **common)
    assert teng._depth == jeng._paged_depth == 16 + 8
    for uid, want in jdone.items():
        got = tdone[uid]
        assert got.out_tokens == want.out_tokens, f"uid {uid}: tokens"
        assert len(got.out_tokens) == 20
        assert _admitted(got) == _admitted(want), f"uid {uid}: admission"
        assert _retired(got) == _retired(want), f"uid {uid}: retirement"
    sweeps = teng.counts["decode_evict_sweeps"]
    assert sweeps > 0
    assert sweeps == _jax_count(jeng, "serving_decode_evict_sweeps_total")
    reclaimed = teng.pool.blocks_reclaimed_decode
    assert reclaimed > 0
    assert reclaimed == jeng.pool.blocks_reclaimed_decode
    assert teng.pool.stats()["blocks_reclaimed_decode"] == reclaimed
    teng.pool.check()
    assert teng.pool.used_blocks() == 0 and teng.pool.reserved == 0


def test_decode_evict_interval_never_reached_changes_nothing(served):
    """The JAX package's contract, held on the port: decode eviction with
    an interval no generation reaches (max_new + the largest decode
    chunk) gives the tokens and retirement kept sets of the path without
    it, and never sweeps."""
    prompts = _prompts(22, [40, 19, 33])
    common = dict(evict=EvictionConfig(budget=16), num_slots=2,
                  chunking=ChunkingConfig(chunk=16, max_context=40),
                  pool_blocks=128)
    base, _ = _run_port(served, prompts, 12, **common)
    never = DecodeEvictionConfig(enabled=True, interval=12 + 16)
    got, eng = _run_port(served, prompts, 12, decode_evict=never, **common)
    assert eng.counts["decode_evict_sweeps"] == 0
    assert eng.pool.blocks_reclaimed_decode == 0
    for uid, want in base.items():
        assert got[uid].out_tokens == want.out_tokens, uid
        assert _retired(got[uid]) == _retired(want), uid


def test_decode_evict_contended_matches_isolated(served):
    """Slot isolation under eviction: a request served beside others
    emits the tokens, and retires with the kept sets, it does alone
    (sweeps fire at fixed per-slot growth marks)."""
    prompts = _prompts(23, [30, 45, 21])
    common = dict(evict=EvictionConfig(budget=16),
                  chunking=ChunkingConfig(chunk=16, max_context=45),
                  decode_evict=DecodeEvictionConfig(enabled=True,
                                                    interval=8),
                  pool_blocks=128)
    got, eng = _run_port(served, prompts, 18, num_slots=2, **common)
    assert eng.counts["decode_evict_sweeps"] > 0
    assert eng.counts["max_concurrency"] == 2
    for uid, p in enumerate(prompts):
        solo, _ = _run_port(served, [p], 18, num_slots=1, **common)
        assert got[uid].out_tokens == solo[0].out_tokens, uid
        assert _retired(got[uid]) == _retired(solo[0]), uid


def test_optimistic_admission_preempts_like_jax(served):
    """Optimistic admission (``reserve_appends=False``) over a pool that
    cannot grow every admitted request: both engines preempt to the
    queue, re-serve to the same tokens, and the port's pool drains
    conserved.  depth = budget 8 + margin 9 = 17 rows, 5 blocks of 4 per
    request: 7 blocks admit two requests but cannot grow both."""
    prompts = _prompts(24, [40, 27, 33, 45, 29, 36])
    common = dict(num_slots=3, pool_blocks=7, reserve_appends=False)
    jdone, jeng = _run_jax(
        served, prompts, 8, evict=JEvict(budget=8),
        chunking=JChunking(chunk=16, max_context=45, decode_chunk=1),
        **common)
    tdone, teng = _run_port(
        served, prompts, 8, evict=EvictionConfig(budget=8),
        chunking=ChunkingConfig(chunk=16, max_context=45, decode_chunk=1),
        **common)
    for uid, want in jdone.items():
        got = tdone[uid]
        assert got.out_tokens == want.out_tokens, f"uid {uid}: tokens"
        assert len(got.out_tokens) == 8
        assert _admitted(got) == _admitted(want), f"uid {uid}: admission"
    assert teng.counts["preemptions"] > 0
    assert _jax_count(jeng, "serving_preemptions_total") > 0
    assert teng.counts["preemptions"] == _jax_count(
        jeng, "serving_preemptions_total")
    teng.pool.check()
    assert teng.pool.used_blocks() == 0 and teng.pool.reserved == 0


def test_dense_engines_with_decode_evict_match_jax(served):
    """The dense continuous engine (per-slot cursors, 8 margin rows, so
    every request evicts per step) and the lockstep engine (one cursor)
    with ``decode_evict``: the JAX engines' tokens, and for the
    continuous one its admission kept sets."""
    prompts = _prompts(25, _EVICT_LENS)
    kw = dict(num_slots=2, decode_evict=True)
    jdone, _ = _run_jax(served, prompts, 20, evict=JEvict(budget=16),
                        chunking=JChunking(chunk=16, max_context=50), **kw)
    tdone, teng = _run_port(served, prompts, 20,
                            evict=EvictionConfig(budget=16),
                            chunking=ChunkingConfig(chunk=16,
                                                    max_context=50), **kw)
    assert teng._depth == 16 + 8 and teng.decode_evict.enabled
    for uid, want in jdone.items():
        assert tdone[uid].out_tokens == want.out_tokens, f"uid {uid}"
        assert _admitted(tdone[uid]) == _admitted(want), f"uid {uid}"

    batch = _prompts(26, [41] * 3)
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jlock = JLockstep(served["jp"], served["jcfg"], policy="lookaheadkv",
                          evict=JEvict(budget=16), lkv_params=served["jl"],
                          max_new_tokens=20, eos_id=-1, decode_evict=True)
    jb = jlock.serve([JRequest(uid=i, prompt=p, max_new_tokens=20)
                      for i, p in enumerate(batch)])
    tlock = ServingEngine(served["tp"], served["tcfg"], policy="lookaheadkv",
                          evict=EvictionConfig(budget=16),
                          lkv_params=served["tl"], max_new_tokens=20,
                          eos_id=-1, decode_evict=True, device="cpu")
    tb = tlock.serve([Request(uid=i, prompt=p, max_new_tokens=20)
                      for i, p in enumerate(batch)])
    assert tlock.decode_margin == jlock.decode_margin == 8
    for j, t in zip(jb, tb):
        assert t.out_tokens == j.out_tokens, f"lockstep uid {t.uid}"


@pytest.mark.parametrize("extra,sweeps", [
    (["--kv-pool-mb", "1", "--decode-evict-interval", "8"], True),
    ([], False),
])
def test_serve_launcher_decode_evict_on_cpu(capsys, extra, sweeps):
    serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                "--continuous", "--decode-evict", "--budget", "16",
                "--chunk", "32", "--prompt-lens", "40,70,9",
                "--max-new", "30"] + extra)
    out = capsys.readouterr().out
    assert "requests=3" in out and out.count("30 tokens") == 3
    assert ("decode eviction:" in out) == sweeps
    if sweeps:
        n = int(out.split("decode eviction: ")[1].split(" sweeps")[0])
        assert n > 0
