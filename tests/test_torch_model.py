"""Parity of the PyTorch port's model against the JAX package, on the CPU.

The same float32 smoke config, the same parameters (the JAX trees bridged
leaf for leaf with ``repro_torch.bridge``) and the same numpy-seeded inputs
go through both packages:

* layers, RoPE and the LoRA-bearing MLP;
* ``prefill_chunk`` (logits and the K/V buffer, including a partial final
  chunk), ``prefill_finalize`` (kept (layer, head, position) sets, kept
  K/V, cursor, positions) and the paged ``decode_step`` (logits and the
  pool after the in-place appends, with an inactive, a full and a
  missing-block slot).

Tolerances: logits and activations 1e-4 (float32, different summation
orders); kept sets identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import rope as trope
from repro_torch.models import transformer as ttf

TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch="llama3-8b"):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return jcfg, tcfg


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    # LoRA b starts at zero; draw it so the selective-LoRA path matters
    rng = np.random.default_rng(5)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    np_params = jax.tree.map(np.asarray, params)
    np_lkv = jax.tree.map(np.asarray, lkv)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv,
                tp=bridge.to_torch(np_params, device="cpu"),
                tl=bridge.to_torch(np_lkv, device="cpu"))


def test_layers_rope_and_lora_mlp_match(model):
    rng = np.random.default_rng(0)
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(jcfg.d_model,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
        _np(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    q = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        trope.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 5e5),
        _np(jrope.apply_rope(jnp.asarray(q), jnp.asarray(pos), 5e5)), **TOL)
    lp_j = jax.tree.map(lambda a: a[0], model["jp"]["layers"]["mlp"])
    lo_j = jax.tree.map(lambda a: a[0], model["jl"]["lora"]["mlp"])
    lp_t = ttf.layer_slice(model["tp"]["layers"]["mlp"], 0)
    lo_t = ttf.layer_slice(model["tl"]["lora"]["mlp"], 0)
    lm = (rng.random((2, 5, 1)) > 0.5).astype(np.float32)
    want = jmlp.apply(lp_j, jcfg, jnp.asarray(x), lora=lo_j,
                      lora_mask=jnp.asarray(lm), lora_scale=4.0)
    got = tmlp.apply(lp_t, tcfg, torch.from_numpy(x), lora=lo_t,
                     lora_mask=torch.from_numpy(lm), lora_scale=4.0)
    np.testing.assert_allclose(got, _np(want), **TOL)


def _prefill_both(model, tokens, n_total, chunk, capacity):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    B = tokens.shape[0]
    jstate = jtf.init_chunk_state(jcfg, "lookaheadkv", B, capacity)
    tstate = ttf.init_chunk_state(tcfg, "lookaheadkv", B, capacity,
                                  device="cpu")
    for s in range(0, n_total, chunk):
        blk = np.zeros((B, chunk), np.int32)
        seg = tokens[:, s:s + chunk]
        blk[:, :seg.shape[1]] = seg
        jstate, jlog = jtf.prefill_chunk(
            model["jp"], jcfg, jstate, jnp.asarray(blk),
            jnp.asarray(n_total, jnp.int32), policy="lookaheadkv")
        tstate, tlog = ttf.prefill_chunk(
            model["tp"], tcfg, tstate, torch.from_numpy(blk), n_total,
            policy="lookaheadkv")
        np.testing.assert_allclose(tlog, _np(jlog), **TOL)
    return jstate, tstate


def test_prefill_chunk_matches(model):
    rng = np.random.default_rng(1)
    n_total, chunk = 45, 16  # 3 chunks, the last one partial
    tokens = rng.integers(0, 512, (2, n_total)).astype(np.int32)
    jstate, tstate = _prefill_both(model, tokens, n_total, chunk, 64)
    assert tstate.pos == int(jstate.pos) == 48
    np.testing.assert_allclose(tstate.k[:, :, :n_total],
                               _np(jstate.k)[:, :, :n_total], **TOL)
    np.testing.assert_allclose(tstate.v[:, :, :n_total],
                               _np(jstate.v)[:, :, :n_total], **TOL)


def _kept(mask, pos):
    L, B, _, KV = mask.shape
    return {(l, b, h): frozenset(pos[l, b, mask[l, b, :, h], h].tolist())
            for l in range(L) for b in range(B) for h in range(KV)}


@pytest.mark.parametrize("n_total,budget", [(45, 16), (13, 16)])
def test_prefill_finalize_kept_sets_match(model, n_total, budget):
    """Kept sets identical, including a prompt shorter than the budget
    (selected pad columns come out masked)."""
    from repro.common.config import EvictionConfig as JEvict
    from repro_torch.common.config import EvictionConfig as TEvict

    rng = np.random.default_rng(n_total)
    chunk = 16
    tokens = rng.integers(0, 512, (1, n_total)).astype(np.int32)
    cap = -(-(n_total + 8) // chunk) * chunk
    jstate, tstate = _prefill_both(model, tokens, n_total, chunk, cap)
    jc = jtf.prefill_finalize(model["jp"], model["jcfg"], jstate,
                              jnp.asarray(n_total, jnp.int32),
                              policy="lookaheadkv",
                              evict=JEvict(budget=budget),
                              lkv_params=model["jl"], extra_slots=5)
    tc = ttf.prefill_finalize(model["tp"], model["tcfg"], tstate, n_total,
                              policy="lookaheadkv",
                              evict=TEvict(budget=budget),
                              lkv_params=model["tl"], extra_slots=5)
    ja = jax.tree.map(np.asarray, jc["attn"])
    ta = {k: v.numpy() for k, v in tc["attn"].items()}
    assert ta["mask"].shape == ja["mask"].shape
    assert _kept(ta["mask"], ta["pos"]) == _kept(ja["mask"], ja["pos"])
    np.testing.assert_array_equal(ta["mask"], ja["mask"])
    np.testing.assert_allclose(ta["k"], ja["k"], **TOL)
    np.testing.assert_allclose(ta["v"], ja["v"], **TOL)
    assert tc["cursor"] == int(jc["cursor"])
    np.testing.assert_array_equal(tc["next_pos"].numpy(),
                                  np.asarray(jc["next_pos"]))


def test_paged_decode_step_matches(model):
    """Three decode steps over a random pool: a live slot, an inactive
    slot, a full slot (cursor at depth) and a slot whose append block is
    missing (null-routed).  Logits and the pool after the appends match."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    a = jcfg.attn
    rng = np.random.default_rng(2)
    L, N, bs, KV, hd = jcfg.num_layers, 12, 4, a.num_kv_heads, a.head_dim
    B, nb, depth = 4, 5, 18
    pool = {
        "k": rng.normal(size=(L, N, bs, KV, hd)).astype(np.float32),
        "v": rng.normal(size=(L, N, bs, KV, hd)).astype(np.float32),
        "pos": rng.integers(0, 30, (L, N, bs, KV)).astype(np.int32),
        "mask": rng.random((L, N, bs, KV)) > 0.3,
    }
    pool["mask"][:, 0] = False  # the null block
    # slot 0's rows 18, 19 lie past the depth: masked, as in a served pool
    # (both the port and the Pallas kernel walk the whole table)
    pool["mask"][:, 5, 2:] = False
    table = np.asarray([[1, 2, 3, 4, 5], [6, 7, 0, 0, 0],
                        [8, 9, 10, 11, 0], [0, 0, 0, 0, 0]], np.int32)
    cursor = np.asarray([9, 8, 18, 3], np.int32)  # slot 1: block 2 missing
    next_pos = np.asarray([[40], [33], [50], [7]], np.int32)
    active = np.asarray([True, True, True, False])
    token = rng.integers(0, 512, (B, 1)).astype(np.int32)
    jcache = {"attn": {"table": jnp.asarray(table)},
              "pool": jax.tree.map(jnp.asarray, pool),
              "cursor": jnp.asarray(cursor), "next_pos": jnp.asarray(next_pos)}
    tcache = {"attn": {"table": torch.from_numpy(table)},
              "pool": bridge.to_torch(pool, device="cpu"),
              "cursor": torch.from_numpy(cursor),
              "next_pos": torch.from_numpy(next_pos)}
    jtok, ttok = jnp.asarray(token), torch.from_numpy(token)
    for _ in range(3):
        jlog, jcache = jtf.decode_step(model["jp"], jcfg, jtok, jcache,
                                       active=jnp.asarray(active),
                                       paged_depth=depth)
        tlog, tcache = ttf.decode_step(model["tp"], tcfg, ttok, tcache,
                                       active=torch.from_numpy(active),
                                       paged_depth=depth)
        np.testing.assert_allclose(tlog, _np(jlog), **TOL)
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
        ttok = torch.from_numpy(np.array(jtok))
    np.testing.assert_array_equal(tcache["cursor"].numpy(),
                                  np.asarray(jcache["cursor"]))
    np.testing.assert_array_equal(tcache["next_pos"].numpy(),
                                  np.asarray(jcache["next_pos"]))
    jp = jax.tree.map(np.asarray, jcache["pool"])
    tp = {k: v.numpy() for k, v in tcache["pool"].items()}
    np.testing.assert_array_equal(tp["mask"], jp["mask"])
    # block 0 takes the null-routed writes (value order undefined there)
    np.testing.assert_array_equal(tp["pos"][:, 1:], jp["pos"][:, 1:])
    np.testing.assert_allclose(tp["k"][:, 1:], jp["k"][:, 1:], **TOL)
    np.testing.assert_allclose(tp["v"][:, 1:], jp["v"][:, 1:], **TOL)
