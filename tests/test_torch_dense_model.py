"""Parity of the port's monolithic prefill and dense decode against the
JAX package, on the CPU.

The same float32 smoke config, the same parameters (the JAX trees bridged
leaf for leaf) and the same numpy-seeded inputs go through both packages:

* ``tf.prefill`` with ``lookaheadkv`` (B = 2; a prompt of 56 tokens, so
  S = 64 with the 8 lookahead rows, a whole kernel tile, and one of 45,
  S = 53): logits, kept (layer, head, position) sets, kept K/V, cursor
  and positions; and ``policy=None`` with every row's logits;
* the port's monolithic prefill against its own chunked prefill: the
  same kept sets and logits;
* the dense ``decode_step`` with the lockstep scalar cursor (including
  steps at the clamp, where the JAX ``dynamic_update_slice`` rewrites the
  last row) and with per-slot cursors (one inactive slot, one full slot),
  where the JAX package writes every slot and rolls inactive ones back
  with ``select_cache_slots`` and the port gates its in-place writes;
* the slot surgery (``pad_cache_capacity``, ``insert_request_cache``,
  ``extract_request_cache``, ``select_cache_slots``).

Tolerances: logits and K/V 1e-4 (float32, other summation orders); kept
sets, positions, masks and cursors identical.
"""

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
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig as TEvict
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as ttf

TOL = dict(atol=1e-4, rtol=1e-4)


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
    return {(l, b, h): frozenset(pos[l, b, mask[l, b, :, h], h].tolist())
            for l in range(L) for b in range(B) for h in range(KV)}


def _attn_np(cache):
    return {k: np.asarray(v) for k, v in cache["attn"].items()}


@pytest.mark.parametrize("n_real", [56, 45])
def test_prefill_lookaheadkv_matches_jax(model, n_real):
    rng = np.random.default_rng(n_real)
    tokens = rng.integers(0, 512, (2, n_real)).astype(np.int32)
    jr = jtf.prefill(model["jp"], model["jcfg"], jnp.asarray(tokens),
                     lkv_params=model["jl"], policy="lookaheadkv",
                     evict=JEvict(budget=16), extra_slots=7)
    tr = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(tokens),
                     lkv_params=model["tl"], policy="lookaheadkv",
                     evict=TEvict(budget=16), extra_slots=7)
    np.testing.assert_allclose(tr.logits, np.asarray(jr.logits), **TOL)
    ja, ta = _attn_np(jr.cache), _attn_np(tr.cache)
    assert ta["mask"].shape == ja["mask"].shape == (2, 2, 23, 2)
    assert _kept(ta["mask"], ta["pos"]) == _kept(ja["mask"], ja["pos"])
    np.testing.assert_array_equal(ta["mask"], ja["mask"])
    np.testing.assert_array_equal(ta["pos"], ja["pos"])
    np.testing.assert_allclose(ta["k"], ja["k"], **TOL)
    np.testing.assert_allclose(ta["v"], ja["v"], **TOL)
    assert tr.cache["cursor"] == int(jr.cache["cursor"]) == 16
    np.testing.assert_array_equal(tr.cache["next_pos"].numpy(),
                                  np.asarray(jr.cache["next_pos"]))


def test_prefill_without_policy_all_logits_match_jax(model):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (2, 37)).astype(np.int32)
    jr = jtf.prefill(model["jp"], model["jcfg"], jnp.asarray(tokens),
                     want_logits="all")
    tr = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(tokens),
                     want_logits="all")
    assert tr.cache is None and jr.cache is None
    assert tr.logits.shape == (2, 37, 512)
    np.testing.assert_allclose(tr.logits, np.asarray(jr.logits), **TOL)
    none = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(tokens),
                       want_logits="none")
    assert none.logits is None and none.cache is None


def test_prefill_refuses_unported_options(model):
    tok = torch.zeros((1, 8), dtype=torch.int32)
    # the draft-based policies compose passes: policies.run_eviction
    with pytest.raises(ValueError, match="policies.run_eviction"):
        ttf.prefill(model["tp"], model["tcfg"], tok, policy="laq")
    # bucket-padded prefill is served: a row padded past its true length
    # gives the logits of its unpadded prefill
    tok = torch.from_numpy(
        np.random.default_rng(3).integers(0, 512, (1, 8)).astype(np.int32))
    padded = ttf.prefill(model["tp"], model["tcfg"], tok,
                         prompt_lens=torch.tensor([5]))
    exact = ttf.prefill(model["tp"], model["tcfg"], tok[:, :5])
    torch.testing.assert_close(padded.logits, exact.logits, **TOL)
    with pytest.raises(NotImplementedError, match="A9"):
        ttf.prefill(model["tp"], model["tcfg"], tok, capture_scores=True)


def test_monolithic_prefill_matches_chunked(model):
    """Inside the port: the monolithic prefill and the streaming one keep
    the same (layer, head, position) sets and give the same logits."""
    rng = np.random.default_rng(11)
    n_total, chunk = 45, 16
    tokens = rng.integers(0, 512, (1, n_total)).astype(np.int32)
    tcfg = model["tcfg"]
    mono = ttf.prefill(model["tp"], tcfg, torch.from_numpy(tokens),
                       lkv_params=model["tl"], policy="lookaheadkv",
                       evict=TEvict(budget=16), extra_slots=5)
    state = ttf.init_chunk_state(tcfg, "lookaheadkv", 1, 64, device="cpu")
    for s in range(0, n_total, chunk):
        blk = np.zeros((1, chunk), np.int32)
        seg = tokens[:, s:s + chunk]
        blk[:, :seg.shape[1]] = seg
        state, logits = ttf.prefill_chunk(model["tp"], tcfg, state,
                                          torch.from_numpy(blk), n_total,
                                          policy="lookaheadkv")
    chunked = ttf.prefill_finalize(model["tp"], tcfg, state, n_total,
                                   policy="lookaheadkv",
                                   evict=TEvict(budget=16),
                                   lkv_params=model["tl"], extra_slots=5)
    np.testing.assert_allclose(mono.logits, logits, **TOL)
    ma, ca = _attn_np(mono.cache), _attn_np(chunked)
    assert _kept(ma["mask"], ma["pos"]) == _kept(ca["mask"], ca["pos"])
    np.testing.assert_allclose(ma["k"], ca["k"], **TOL)
    assert mono.cache["cursor"] == chunked["cursor"]


def _random_cache(rng, cfg, B, C, fill):
    a = cfg.attn
    L, KV, hd = cfg.num_layers, a.num_kv_heads, a.head_dim
    return {
        "k": rng.normal(size=(L, B, C, KV, hd)).astype(np.float32),
        "v": rng.normal(size=(L, B, C, KV, hd)).astype(np.float32),
        "pos": rng.integers(0, 40, (L, B, C, KV)).astype(np.int32),
        "mask": (rng.random((L, B, C, KV)) > 0.3)
        & (np.arange(C)[None, None, :, None] < fill),
    }


def _step_both(model, jcache, tcache, jtok, active=None):
    jlog, jnew = jtf.decode_step(model["jp"], model["jcfg"], jtok, jcache)
    if active is not None:
        jnew = jtf.select_cache_slots(jnp.asarray(active), jnew, jcache)
    tlog, tnew = ttf.decode_step(
        model["tp"], model["tcfg"], torch.from_numpy(np.array(jtok)), tcache,
        active=None if active is None else torch.from_numpy(active))
    rows = slice(None) if active is None else active
    np.testing.assert_allclose(tlog.numpy()[rows], np.asarray(jlog)[rows],
                               **TOL)
    return jlog, jnew, tnew


def _assert_caches_equal(jcache, tcache):
    ja, ta = _attn_np(jcache), _attn_np(tcache)
    np.testing.assert_array_equal(ta["mask"], ja["mask"])
    np.testing.assert_array_equal(ta["pos"], ja["pos"])
    np.testing.assert_allclose(ta["k"], ja["k"], **TOL)
    np.testing.assert_allclose(ta["v"], ja["v"], **TOL)
    np.testing.assert_array_equal(np.asarray(tcache["next_pos"]),
                                  np.asarray(jcache["next_pos"]))


def test_dense_decode_scalar_cursor_matches_jax_through_the_clamp(model):
    """Lockstep: one cursor for the batch, starting two rows short of the
    end, so the third step finds the cache full and (as the JAX
    ``dynamic_update_slice`` clamps its start) rewrites the last row."""
    rng = np.random.default_rng(7)
    B, C = 2, 12
    arrs = _random_cache(rng, model["jcfg"], B, C, fill=C - 2)
    next_pos = np.asarray([[30], [41]], np.int32)
    jcache = {"attn": jax.tree.map(jnp.asarray, arrs),
              "cursor": jnp.asarray(C - 2, jnp.int32),
              "next_pos": jnp.asarray(next_pos)}
    tcache = {"attn": bridge.to_torch(arrs, device="cpu"), "cursor": C - 2,
              "next_pos": torch.from_numpy(next_pos)}
    jtok = jnp.asarray(rng.integers(0, 512, (B, 1)).astype(np.int32))
    for _ in range(3):
        jlog, jcache, tcache = _step_both(model, jcache, tcache, jtok)
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    assert tcache["cursor"] == int(jcache["cursor"]) == C
    _assert_caches_equal(jcache, tcache)


def test_dense_decode_per_slot_cursors_match_jax(model):
    """Continuous batching: per-slot cursors with a live slot, a full slot
    (writes nothing) and an inactive slot (stays bit for bit as it was)."""
    rng = np.random.default_rng(8)
    B, C = 4, 12
    arrs = _random_cache(rng, model["jcfg"], B, C, fill=C)
    cursor = np.asarray([5, C, 3, 9], np.int32)
    next_pos = np.asarray([[20], [33], [7], [15]], np.int32)
    active = np.asarray([True, True, False, True])
    jcache = {"attn": jax.tree.map(jnp.asarray, arrs),
              "cursor": jnp.asarray(cursor),
              "next_pos": jnp.asarray(next_pos)}
    tcache = {"attn": bridge.to_torch(arrs, device="cpu"),
              "cursor": torch.from_numpy(cursor.copy()),
              "next_pos": torch.from_numpy(next_pos.copy())}
    jtok = jnp.asarray(rng.integers(0, 512, (B, 1)).astype(np.int32))
    for _ in range(3):
        jlog, jcache, tcache = _step_both(model, jcache, tcache, jtok,
                                          active)
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(tcache["cursor"].numpy(),
                                  np.asarray(jcache["cursor"]))
    np.testing.assert_array_equal(tcache["cursor"].numpy(), [8, C, 3, 12])
    _assert_caches_equal(jcache, tcache)
    ta = _attn_np(tcache)
    for name in ("k", "v", "pos", "mask"):  # the inactive slot is untouched
        np.testing.assert_array_equal(ta[name][:, 2], arrs[name][:, 2])


def test_slot_surgery_matches_jax(model):
    rng = np.random.default_rng(9)
    cfg_j, cfg_t = model["jcfg"], model["tcfg"]
    jlive = jtf.init_decode_cache(cfg_j, 3, 10, per_slot_cursor=True)
    tlive = ttf.init_decode_cache(cfg_t, 3, 10, per_slot_cursor=True,
                                  device="cpu")
    _assert_caches_equal(jlive, tlive)
    req = _random_cache(rng, cfg_j, 1, 7, fill=7)
    jreq = {"attn": jax.tree.map(jnp.asarray, req),
            "cursor": jnp.asarray(6, jnp.int32),
            "next_pos": jnp.asarray([[50]], jnp.int32)}
    treq = {"attn": bridge.to_torch(req, device="cpu"), "cursor": 6,
            "next_pos": torch.tensor([[50]], dtype=torch.int32)}
    jlive = jtf.insert_request_cache(jlive, jreq, 1)
    tlive = ttf.insert_request_cache(tlive, treq, 1)
    _assert_caches_equal(jlive, tlive)
    np.testing.assert_array_equal(tlive["cursor"].numpy(),
                                  np.asarray(jlive["cursor"]))
    jx, tx = jtf.extract_request_cache(jlive, 1), \
        ttf.extract_request_cache(tlive, 1)
    _assert_caches_equal(jx, tx)
    np.testing.assert_array_equal(tx["cursor"].numpy(),
                                  np.asarray(jx["cursor"]))
    active = np.asarray([True, False, True])
    jsel = jtf.select_cache_slots(jnp.asarray(active), jlive,
                                  jtf.init_decode_cache(cfg_j, 3, 10,
                                                        per_slot_cursor=True))
    tsel = ttf.select_cache_slots(torch.from_numpy(active), tlive,
                                  ttf.init_decode_cache(cfg_t, 3, 10,
                                                        per_slot_cursor=True,
                                                        device="cpu"))
    _assert_caches_equal(jsel, tsel)
    np.testing.assert_array_equal(tsel["cursor"].numpy(),
                                  np.asarray(jsel["cursor"]))
