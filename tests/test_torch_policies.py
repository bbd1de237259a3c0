"""Every single-pass eviction policy of the port against the JAX package,
on the CPU.

* Kernel 2's plain version (``ref.chunk_column_masses``) and the CPU route
  of ``ops.chunk_attention(score_masses=True)`` against
  ``chunk_attention_masses_pallas`` in interpret mode, over the (C,
  offset, n_total) sweep of ``tests/test_fused_scores.py`` and its
  windowed case; the scored call's ``out`` equals the unscored call's
  bitwise.  (The port's chunk must fit its buffer, so the sweep's buffer
  is 512 deep instead of 384.)
* ``eviction.position_scores`` (streaming_llm, full, random with and
  without seeds, at two lengths), ``pyramid_budgets`` over a grid of (L,
  budget, beta), ``adaptive_head_budgets`` and ``select_topk_per_head``
  on scores with ties: bitwise the JAX package's.
* ``scoring.update_layer_scores`` / ``finalize_layer_scores`` for h2o,
  snapkv and tova.
* For every single-pass policy (and lookaheadkv with adaptive head
  budgets): the monolithic ``transformer.prefill`` and the chunked
  ``policies.run_eviction_chunked`` (chunk 32, prompts not a multiple of
  it; gt_oracle with its response rows) against the JAX functions.

Float32 smoke config; inputs from numpy seeds.  Tolerances: kernel
outputs and scores 1e-5, logits 1e-4 (float32, other summation orders);
kept (layer, kv head, position) sets, budgets and random scores
identical.
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
from repro.core import eviction as jev
from repro.core import policies as jpol
from repro.core import scoring as jscoring
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.kernels import ref as jref
from repro.kernels.chunk_attention import (chunk_attention_masses_pallas,
                                           chunk_attention_pallas)
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig as TEvict
from repro_torch.configs import get_smoke_config
from repro_torch.core import eviction as tev
from repro_torch.core import policies as tpol
from repro_torch.core import scoring as tscoring
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as ttf

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(rng, B, C, K, H, KV, hd):
    return (rng.normal(size=(B, C, H, hd)).astype(np.float32),
            rng.normal(size=(B, K, KV, hd)).astype(np.float32),
            rng.normal(size=(B, K, KV, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# kernel 2: chunk attention with column masses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("off,n_total", [
    (0, 300),  # first chunk, every row valid
    (256, 300),  # partial final chunk: rows past 300 count nothing
    (128, 140),  # nearly empty chunk: 12 valid rows
])
def test_column_masses_match_pallas(C, off, n_total):
    rng = np.random.default_rng(C + off)
    q, k, v = _qkv(rng, 1, C, 512, 4, 2, 16)
    out, masses = ops.chunk_attention(_t(q), _t(k), _t(v), q_offset=off,
                                      score_masses=True, n_total=n_total)
    plain = ops.chunk_attention(_t(q), _t(k), _t(v), q_offset=off)
    assert torch.equal(out, plain), "out must be the unscored call's"
    jout, jm = chunk_attention_masses_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(off),
        jnp.int32(n_total), block_k=64, interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    np.testing.assert_allclose(masses, np.asarray(jm), **TOL)
    rv = (off + torch.arange(C) < n_total).expand(1, C)
    np.testing.assert_array_equal(
        masses, ref.chunk_column_masses(_t(q), _t(k), q_offset=off,
                                        row_valid=rv))
    # columns no valid row can see are exact zeros
    n_vis = min(off + C, n_total)
    assert torch.all(masses[..., n_vis:] == 0)
    # each (b, h) row sums to the number of valid rows
    torch.testing.assert_close(masses.sum(-1), torch.full(
        (1, 4), float(min(C, max(n_total - off, 0)))), atol=1e-3, rtol=0)


@pytest.mark.parametrize("B,C,K,H,KV,hd,off,n_total,window", [
    (1, 1, 200, 2, 1, 16, 150, 151, None),  # one row; K, q_offset off 128
    (1, 129, 300, 4, 2, 32, 100, 200, None),  # 128 + 1 rows, n_total cuts
    (2, 40, 330, 4, 2, 16, 200, 230, 100),  # a window starting across 128
    (1, 32, 200, 4, 2, 16, 150, 140, None),  # n_total <= q_offset: zeros
])
def test_column_masses_match_pallas_at_tile_edges(B, C, K, H, KV, hd, off,
                                                  n_total, window):
    """The shapes that stress the card's 128-key column-mass tiles: the
    plain masses the card is held to against the Pallas kernel (interpret
    mode, its own key blocks) and the JAX oracle."""
    rng = np.random.default_rng(C * 1000 + K)
    q, k, v = _qkv(rng, B, C, K, H, KV, hd)
    out, masses = ops.chunk_attention(_t(q), _t(k), _t(v), q_offset=off,
                                      window=window, score_masses=True,
                                      n_total=n_total)
    assert torch.equal(out, ops.chunk_attention(
        _t(q), _t(k), _t(v), q_offset=off, window=window))
    jout, jm = chunk_attention_masses_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(off),
        jnp.int32(n_total), window=window, block_k=128, interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    np.testing.assert_allclose(masses, np.asarray(jm), **TOL)
    rv = jnp.broadcast_to((off + jnp.arange(C))[None] < n_total, (B, C))
    want = jref.chunk_column_masses(jnp.asarray(q), jnp.asarray(k),
                                    q_offset=off, window=window,
                                    row_valid=rv)
    np.testing.assert_allclose(masses, np.asarray(want), **TOL)
    n_rows = float(min(C, max(n_total - off, 0)))
    torch.testing.assert_close(masses.sum(-1), torch.full(
        (B, H), n_rows), atol=1e-4 * max(n_rows, 1.0), rtol=0)
    if n_rows == 0:
        assert torch.all(masses == 0)


def test_column_masses_windowed_match_pallas():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 32, 96, 6, 2, 16)
    out, masses = ops.chunk_attention(_t(q), _t(k), _t(v), q_offset=40,
                                      window=24, score_masses=True,
                                      n_total=60)
    assert torch.equal(out, ops.chunk_attention(_t(q), _t(k), _t(v),
                                                q_offset=40, window=24))
    jout, jm = chunk_attention_masses_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(40),
        jnp.int32(60), window=24, block_k=32, interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    np.testing.assert_allclose(masses, np.asarray(jm), **TOL)
    rv = jnp.broadcast_to((40 + jnp.arange(32))[None] < 60, (2, 32))
    want = jref.chunk_column_masses(jnp.asarray(q), jnp.asarray(k),
                                    q_offset=40, window=24, row_valid=rv)
    np.testing.assert_allclose(masses, np.asarray(want), **TOL)
    # n_total None: every row counts, as the Pallas kernel at off + C
    _, every = ops.chunk_attention(_t(q), _t(k), _t(v), q_offset=40,
                                   window=24, score_masses=True)
    _, jev_all = chunk_attention_masses_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(40),
        jnp.int32(72), window=24, block_k=32, interpret=True)
    np.testing.assert_allclose(every, np.asarray(jev_all), **TOL)
    plain = chunk_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.int32(40), window=24,
                                   block_k=32, interpret=True)
    np.testing.assert_array_equal(np.asarray(jout), np.asarray(plain))


# ---------------------------------------------------------------------------
# position scores, budgets, per-head selection
# ---------------------------------------------------------------------------


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("policy", ["streaming_llm", "full", "random"])
@pytest.mark.parametrize("seeded", [False, True])
def test_position_scores_bitwise_jax(policy, seeded):
    seeds = np.asarray([0, 7, -3, 2 ** 31 - 1, 123456789], np.int32)
    js = jnp.asarray(seeds) if seeded else None
    ts = torch.from_numpy(seeds) if seeded else None
    B = len(seeds)
    got = {}
    for n in (37, 301):  # two lengths: each position's value is the same
        want = jev.position_scores(policy, n, B, 3, sink=4, seeds=js)
        got[n] = tev.position_scores(policy, n, B, 3, sink=4, seeds=ts)
        assert tuple(got[n].shape) == (B, 3, n)
        np.testing.assert_array_equal(_bits(got[n]), _bits(want))
    np.testing.assert_array_equal(_bits(got[301][..., :37]), _bits(got[37]))
    if policy == "random" and seeded:
        assert not torch.equal(got[37][0], got[37][1]), \
            "seeded rows must draw different numbers"


def test_jax_random_stream_reproduced():
    """The threefry stream itself: fold_in keys and uniforms of many seeds
    and positions, bit for bit."""
    assert tev.uniform(tev.fold_in((0, 0), 5)).item() == float(
        jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(0), 5)))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    k1, k2 = tev.fold_in((0, 0), 5)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(key)) if hasattr(jax.random,
                                                        "key_data")
        else np.asarray(key), [int(k1), int(k2)])
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 2 ** 32, 64, dtype=np.uint64)
    pos = rng.integers(0, 1 << 20, 64)
    want = jax.vmap(lambda s, p: jax.random.uniform(jax.random.fold_in(
        jax.random.PRNGKey(s), p)))(jnp.asarray(seeds.astype(np.uint32)),
                                    jnp.asarray(pos.astype(np.int32)))
    base_lo = torch.as_tensor(seeds.astype(np.int64))
    got = tev.uniform(tev.fold_in((torch.zeros_like(base_lo), base_lo),
                                  torch.as_tensor(pos)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pyramid_budgets_match_jnp_linspace():
    """The budgets as ``jnp.linspace`` computes them on the CPU, over a
    grid that crosses the layer count where XLA stops unrolling."""
    for L in (1, 2, 3, 4, 7, 8, 16, 32, 33, 34, 35, 36, 40, 64, 80):
        for budget in (1, 3, 16, 17, 100, 256, 333, 1000, 2048):
            for beta in (0.5, 1.0, 2.0, 3.0, 7.5):
                want = np.asarray(jev.pyramid_budgets(L, budget, beta))
                assert tev.pyramid_budgets(L, budget, beta) == \
                    want.tolist(), (L, budget, beta)


@pytest.mark.parametrize("seed", range(6))
def test_adaptive_budgets_and_per_head_topk_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    B, KV, n = 2, 4, 40
    s = rng.random((B, KV, n)).astype(np.float32)
    if seed % 2:
        s = (np.round(s * 4) / 4).astype(np.float32)  # plateaus of ties
    if seed % 3 == 0:
        s[:, :, :3] = 1e9  # force-kept columns
        s[:, 1] = 0.25  # a flat head
    total, cap = (8, 16) if seed < 3 else (12, 12)
    want = np.asarray(jev.adaptive_head_budgets(jnp.asarray(s), total, cap))
    got = tev.adaptive_head_budgets(_t(s), total, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    ji, jm = jev.select_topk_per_head(jnp.asarray(s), cap, jnp.asarray(want))
    ti, tm = tev.select_topk_per_head(_t(s), cap, got)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tm.sum(-1) == got).all()


# ---------------------------------------------------------------------------
# streaming scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["h2o", "snapkv", "tova"])
def test_streaming_score_update_and_finalize_match_jax(policy):
    rng = np.random.default_rng(len(policy))
    B, C, K, H, KV, hd, W = 2, 16, 64, 4, 2, 16, 8
    n_total = 45
    w = tscoring.stream_window(policy, W)
    assert w == jscoring.stream_window(policy, W)
    acc = rng.random((B, H, K)).astype(np.float32)
    qbuf = rng.normal(size=(B, w, H, hd)).astype(np.float32)
    k_buf = rng.normal(size=(B, K, KV, hd)).astype(np.float32)
    jacc, jq = (jnp.asarray(acc), jnp.asarray(qbuf))
    tacc, tq = _t(acc), _t(qbuf)
    cnt = 0.0
    for s in (16, 32):  # the second chunk holds the prompt's end
        q_rot = rng.normal(size=(B, C, H, hd)).astype(np.float32)
        masses = rng.random((B, H, K)).astype(np.float32)
        jacc, jq = jscoring.update_layer_scores(
            policy, jacc if policy == "h2o" else None,
            jq if policy != "h2o" else None, jnp.asarray(q_rot),
            masses_l=jnp.asarray(masses), q_offset=jnp.int32(s),
            n_total=jnp.int32(n_total))
        r_acc, r_q = tscoring.update_layer_scores(
            policy, tacc if policy == "h2o" else None,
            tq if policy != "h2o" else None, _t(q_rot),
            masses_l=_t(masses), q_offset=s, n_total=n_total)
        if policy == "h2o":
            assert r_acc is tacc  # in place
            np.testing.assert_allclose(tacc, np.asarray(jacc), **TOL)
        else:
            assert r_q is tq
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        cnt += min(max(n_total - s, 0), C)
    want = jscoring.finalize_layer_scores(
        policy, jnp.asarray(k_buf), jnp.int32(n_total),
        acc_l=jacc if policy == "h2o" else None, cnt=jnp.float32(cnt),
        qbuf_l=jq if policy != "h2o" else None, num_kv_heads=KV,
        pool_kernel=3, window_size=W)
    got = tscoring.finalize_layer_scores(
        policy, _t(k_buf), n_total, acc_l=tacc if policy == "h2o" else None,
        cnt=cnt, qbuf_l=tq if policy != "h2o" else None, num_kv_heads=KV,
        pool_kernel=3, window_size=W)
    want = np.asarray(want)
    big = np.abs(want) >= 1e8  # the force-kept window and the dead columns
    np.testing.assert_array_equal(got.numpy()[big], want[big])
    np.testing.assert_allclose(got.numpy()[~big], want[~big], **TOL)


def test_normalize_l1_matches_jax():
    s = np.random.default_rng(2).normal(size=(2, 3, 17)).astype(np.float32)
    np.testing.assert_allclose(tscoring.normalize_l1(_t(s)),
                               np.asarray(jscoring.normalize_l1(
                                   jnp.asarray(s))), **TOL)


# ---------------------------------------------------------------------------
# prefill, monolithic and chunked, under every single-pass policy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    # LoRA b starts at zero; draw it so the selective-LoRA path matters
    rng = np.random.default_rng(5)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"),
                tl=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                   device="cpu"))


def _kept(mask, pos):
    L, B, _, KV = mask.shape
    return {(lyr, b, h): frozenset(pos[lyr, b, mask[lyr, b, :, h], h].tolist())
            for lyr in range(L) for b in range(B) for h in range(KV)}


# (policy, head allocation)
POLICY_CASES = [(p, "uniform") for p in tpol.SINGLE_PASS] + [
    ("lookaheadkv", "adaptive"), ("h2o", "adaptive"),
    ("pyramidkv", "adaptive")]


def _inputs(policy, n):
    rng = np.random.default_rng(len(policy) + n)
    tokens = rng.integers(0, 512, (2, n)).astype(np.int32)
    seeds = np.asarray([3, 11], np.int32)
    gt = n - 9 if policy == "gt_oracle" else None  # 9 response rows
    return tokens, seeds, gt


def _assert_caches_match(tc, jc):
    ja = {k: np.asarray(v) for k, v in jc["attn"].items()}
    ta = {k: v.numpy() for k, v in tc["attn"].items()}
    assert ta["mask"].shape == ja["mask"].shape
    assert _kept(ta["mask"], ta["pos"]) == _kept(ja["mask"], ja["pos"])
    np.testing.assert_array_equal(ta["mask"], ja["mask"])
    np.testing.assert_array_equal(ta["pos"][ta["mask"]],
                                  ja["pos"][ja["mask"]])
    np.testing.assert_allclose(ta["k"], ja["k"], **LOGIT_TOL)
    assert tc["cursor"] == int(jc["cursor"])
    np.testing.assert_array_equal(tc["next_pos"].numpy(),
                                  np.asarray(jc["next_pos"]))


@pytest.mark.parametrize("policy,alloc", POLICY_CASES)
def test_monolithic_prefill_matches_jax(model, policy, alloc):
    tokens, seeds, gt = _inputs(policy, 45)
    lkv_j = model["jl"] if policy == "lookaheadkv" else None
    lkv_t = model["tl"] if policy == "lookaheadkv" else None
    jr = jtf.prefill(model["jp"], model["jcfg"], jnp.asarray(tokens),
                     lkv_params=lkv_j, policy=policy,
                     evict=JEvict(budget=16, head_alloc=alloc),
                     extra_slots=5, gt_boundary=gt, seeds=jnp.asarray(seeds))
    tr = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(tokens),
                     lkv_params=lkv_t, policy=policy,
                     evict=TEvict(budget=16, head_alloc=alloc),
                     extra_slots=5, gt_boundary=gt,
                     seeds=torch.from_numpy(seeds))
    np.testing.assert_allclose(tr.logits, np.asarray(jr.logits), **LOGIT_TOL)
    _assert_caches_match(tr.cache, jr.cache)


@pytest.mark.parametrize("policy,alloc", POLICY_CASES)
def test_chunked_prefill_matches_jax(model, policy, alloc):
    tokens, seeds, gt = _inputs(policy, 77)  # 3 chunks of 32, one partial
    kw = dict(chunk=32, extra_slots=5, gt_boundary=gt)
    jr = jpol.run_eviction_chunked(
        policy, model["jp"], model["jcfg"], jnp.asarray(tokens),
        evict=JEvict(budget=16, head_alloc=alloc), lkv_params=model["jl"],
        seeds=jnp.asarray(seeds), **kw)
    tr = tpol.run_eviction_chunked(
        policy, model["tp"], model["tcfg"], torch.from_numpy(tokens),
        evict=TEvict(budget=16, head_alloc=alloc), lkv_params=model["tl"],
        seeds=torch.from_numpy(seeds), **kw)
    np.testing.assert_allclose(tr.logits, np.asarray(jr.logits), **LOGIT_TOL)
    _assert_caches_match(tr.cache, jr.cache)


def test_monolithic_and_chunked_keep_the_same_rows(model):
    """Inside the port, h2o (the kernel-2 path) and random: the streamed
    prefill keeps the monolithic prefill's rows."""
    tokens, seeds, _ = _inputs("h2o", 77)
    for policy in ("h2o", "random", "pyramidkv"):
        kw = dict(evict=TEvict(budget=16), extra_slots=3,
                  seeds=torch.from_numpy(seeds))
        mono = tpol.run_eviction(policy, model["tp"], model["tcfg"],
                                 torch.from_numpy(tokens), **kw)
        chunked = tpol.run_eviction_chunked(
            policy, model["tp"], model["tcfg"], torch.from_numpy(tokens),
            chunk=32, **kw)
        m, c = mono.cache["attn"], chunked.cache["attn"]
        assert _kept(m["mask"].numpy(), m["pos"].numpy()) == _kept(
            c["mask"].numpy(), c["pos"].numpy()), policy
        torch.testing.assert_close(mono.logits, chunked.logits,
                                   atol=1e-4, rtol=1e-4)


def test_policies_refuse_what_is_not_ported(model):
    tok = torch.zeros((1, 40), dtype=torch.int32)
    # the draft-based policies: served monolithically (speckv with a draft
    # model, here the target itself), never streamed
    for policy in ("laq", "speckv"):
        res = tpol.run_eviction(policy, model["tp"], model["tcfg"], tok,
                                evict=TEvict(budget=8, draft_len=3),
                                draft_params=model["tp"],
                                draft_cfg=model["tcfg"])
        assert res.logits.shape == (1, model["tcfg"].padded_vocab)
        assert int(res.cache["attn"]["mask"].sum(2).max()) == 8
        assert res.cache["next_pos"].tolist() == [[40]]
        with pytest.raises(ValueError, match="cannot stream"):
            tpol.run_eviction_chunked(policy, model["tp"], model["tcfg"],
                                      tok, chunk=16, evict=TEvict())
    with pytest.raises(ValueError, match="speckv needs a draft model"):
        tpol.run_eviction("speckv", model["tp"], model["tcfg"], tok,
                          evict=TEvict())
    with pytest.raises(ValueError, match="unknown policy"):
        tpol.run_eviction("nope", model["tp"], model["tcfg"], tok,
                          evict=TEvict())
    with pytest.raises(ValueError, match="gt_boundary"):
        ttf.prefill(model["tp"], model["tcfg"], tok, policy="gt_oracle")
    # no policy but lookaheadkv reads lookahead modules
    res = tpol.run_eviction("snapkv", model["tp"], model["tcfg"], tok,
                            evict=TEvict(budget=16), lkv_params=None)
    assert res.cache["attn"]["mask"].shape[2] == 16
    assert tpol.chunk_capacity_for(model["tcfg"], "gt_oracle", 40, 16,
                                   n_obs=9) == 64
    assert tpol.ALL_POLICIES == jpol.ALL_POLICIES
    assert tpol.SINGLE_PASS == jpol.SINGLE_PASS
