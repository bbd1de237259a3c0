"""The split-cache decode of the port against the JAX package, on the CPU.

The split cache (``init_decode_cache(hot_slots=)``) keeps the prompt's
rows frozen and appends every new token to a small hot ring; each layer
attends over the two segments apart and merges their online-softmax
partials.  Held against JAX, on float32 smoke configs with inputs drawn
from a numpy seed:

* the plain partials (``ref.decode_attention_stats``) and their merge
  against JAX's ``ops.decode_attention_stats`` / ``merge_attention_stats``
  under every mask kind, with heads and sequences that have no valid row
  (m = -1e30, l = 0, acc = 0; their merge zeros, never NaN), and two
  merged halves against the one-segment decode;
* ``init_decode_cache(fill_len=, hot_slots=)`` against JAX's tree under
  ``jax.eval_shape`` (shapes, dtypes) and JAX's values;
* a prefill, then 6 split decode steps against JAX's ``decode_step``, the
  ring of 4 rows wrapping, on llama3-smoke (no window) and gemma3-smoke
  (window 16 on its local layers, masking both segments);
* the dispatch: meta tensors take the plain versions (shapes only), and
  a device that is neither CPU, CUDA nor meta raises.

The sharded merge (frozen rows sliced by sequence over two ranks) runs
in the spawned world of ``tests/test_torch_tp_mesh.py``.

Tolerances: partials and logits 1e-5 absolute and relative (float32, other
summation orders); tokens, masks and positions exact.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tf

TOL = dict(atol=1e-5, rtol=1e-5)
HOT = 4  # ring rows: 6 steps wrap it


def _stats_inputs(rng, B=3, C=40, H=8, KV=2, hd=32):
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, C, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, KV, hd)).astype(np.float32)
    return q, k, v


def _masks(rng, B, C, KV):
    head = rng.random((B, C, KV)) > 0.3
    head[1, :, 1] = False  # a kv head with no valid row
    head[2] = False  # a sequence with no valid row
    row = rng.random((B, C)) > 0.3
    row[2] = False
    return {"none": None, "row": row, "head": head}


@pytest.mark.parametrize("kind", ["none", "row", "head"])
def test_plain_stats_and_merge_match_jax(kind):
    rng = np.random.default_rng(0)
    q, k, v = _stats_inputs(rng)
    mask = _masks(rng, 3, 40, 2)[kind]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = jops.decode_attention_stats(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), kv_mask=jm)
    got = ref.decode_attention_stats(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), kv_mask=tm)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if kind != "none":  # empty (sequence, head): finite -1e30, 0, 0
        assert np.all(got[0][2].numpy() == np.float32(-1e30))
        assert np.all(got[1][2].numpy() == 0) and np.all(
            got[2][2].numpy() == 0)
    # two halves of the rows merge to the one-segment decode
    half = 17
    parts_t, parts_j = [], []
    for sl in (slice(0, half), slice(half, None)):
        sm = None if mask is None else mask[:, sl]
        parts_t.append(ops.decode_attention_stats(
            torch.from_numpy(q), torch.from_numpy(k[:, sl].copy()),
            torch.from_numpy(v[:, sl].copy()),
            kv_mask=None if sm is None else torch.from_numpy(sm.copy())))
        parts_j.append(jops.decode_attention_stats(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            kv_mask=None if sm is None else jnp.asarray(sm)))
    merged = ops.merge_attention_stats(parts_t)
    assert not torch.isnan(merged).any()
    np.testing.assert_allclose(
        merged.numpy(), np.asarray(jops.merge_attention_stats(parts_j)),
        **TOL)
    whole = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), kv_mask=tm)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **TOL)


def test_merge_of_empty_parts_is_zero_not_nan():
    m = torch.full((2, 3), -1e30)
    z, acc = torch.zeros((2, 3)), torch.zeros((2, 3, 4))
    out = ops.merge_attention_stats([(m, z, acc), (m, z, acc)])
    assert torch.equal(out, torch.zeros_like(out))
    want = jops.merge_attention_stats([(jnp.asarray(m.numpy()),
                                        jnp.asarray(z.numpy()),
                                        jnp.asarray(acc.numpy()))] * 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def _cfgs(arch):
    return (dataclasses.replace(jax_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-1b"])
def test_init_decode_cache_matches_jax_tree(arch):
    jcfg, tcfg = _cfgs(arch)
    B, C, fill = 2, 24, 20
    for hot in (0, HOT):
        kw = dict(fill_len=fill, hot_slots=hot)
        shapes = jax.eval_shape(lambda: jtf.init_decode_cache(jcfg, B, C,
                                                              **kw))
        want = jax.tree.map(np.asarray, jtf.init_decode_cache(jcfg, B, C,
                                                              **kw))
        got = tf.init_decode_cache(tcfg, B, C, device="cpu", **kw)
        meta = tf.init_decode_cache(tcfg, B, C, device="meta", **kw)
        assert got["cursor"] == int(want["cursor"]) == (0 if hot else fill)
        assert set(got) == set(want) and set(got["attn"]) == set(
            want["attn"])
        for name, leaf in shapes["attn"].items():
            for t in (got["attn"][name], meta["attn"][name]):
                assert tuple(t.shape) == leaf.shape, name
                assert str(t.dtype).split(".")[1] == str(leaf.dtype), name
            np.testing.assert_array_equal(got["attn"][name].numpy(),
                                          want["attn"][name])
        np.testing.assert_array_equal(got["next_pos"].numpy(),
                                      want["next_pos"])
    with pytest.raises(ValueError, match="hot-ring"):
        tf.init_decode_cache(tcfg, B, C, hot_slots=HOT, per_slot_cursor=True,
                             device="cpu")


@pytest.fixture(scope="module", params=["llama3-8b", "gemma3-1b"])
def prefilled(request):
    """A lookaheadkv prefill of two 40-token prompts in both packages,
    the same weights (the JAX trees bridged)."""
    jcfg, tcfg = _cfgs(request.param)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jl = jax_init_lkv(jax.random.PRNGKey(1), jcfg, jp["layers"])
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jres = jtf.prefill(jp, jcfg, jnp.asarray(tokens), lkv_params=jl,
                       policy="lookaheadkv", evict=JEvict(budget=24),
                       extra_slots=2)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    tl = bridge.to_torch(jax.tree.map(np.asarray, jl), device="cpu")
    tres = tf.prefill(tp, tcfg, torch.from_numpy(tokens), lkv_params=tl,
                      policy="lookaheadkv", evict=EvictionConfig(budget=24),
                      extra_slots=2)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jres=jres, tres=tres)


def _jax_split(cache, hot):
    """JAX's dense cache with ``init_decode_cache(hot_slots=)``'s ring."""
    a = cache["attn"]
    L, B, _, KV, hd = a["k"].shape
    attn = dict(a, hot_k=jnp.zeros((L, B, hot, KV, hd), a["k"].dtype),
                hot_v=jnp.zeros((L, B, hot, KV, hd), a["k"].dtype),
                hot_pos=jnp.zeros((L, B, hot, KV), jnp.int32),
                hot_mask=jnp.zeros((L, B, hot, KV), bool))
    return dict(cache, attn=attn, cursor=jnp.asarray(0, jnp.int32))


def test_prefill_then_split_decode_matches_jax(prefilled):
    """6 greedy steps with a ring of 4 (it wraps at step 5): logits within
    1e-5 of JAX's at every step, the same tokens, and the rings and
    counters equal after the last step."""
    p = prefilled
    jcache = _jax_split(p["jres"].cache, HOT)
    tcache = tf.add_hot_ring(p["tres"].cache, HOT)
    # the port's own prefill cache, carried across from JAX's, is the same
    from_jax = bridge.decode_cache_to_torch(
        jax.tree.map(np.asarray, jcache), device="cpu")
    for name in ("pos", "mask"):
        assert torch.equal(from_jax["attn"][name], tcache["attn"][name])
    jt = jnp.argmax(p["jres"].logits, -1)[:, None].astype(jnp.int32)
    tt = torch.from_numpy(np.array(jt))
    ops_before = ops.launch_counts()
    for step in range(6):
        jl, jcache = jtf.decode_step(p["jp"], p["jcfg"], jt, jcache)
        tl, tcache = tf.decode_step(p["tp"], p["tcfg"], tt, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = tl.argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tcache["cursor"] == int(jcache["cursor"]) == 6
    for name in ("hot_pos", "hot_mask"):
        np.testing.assert_array_equal(tcache["attn"][name].numpy(),
                                      np.asarray(jcache["attn"][name]))
    np.testing.assert_allclose(tcache["attn"]["hot_k"].numpy(),
                               np.asarray(jcache["attn"]["hot_k"]), **TOL)
    # frozen rows untouched; the CPU launched nothing
    assert torch.equal(tcache["attn"]["k"], p["tres"].cache["attn"]["k"])
    assert ops.launch_counts() == ops_before


def test_windowed_frozen_segment_empties():
    """gemma3-smoke's local layers (window 16): once the decode position
    has moved the window past every frozen row of a layer, its frozen
    partials are empty (m = -1e30, l = 0, acc = 0) in both packages, and
    the step is the hot ring's alone."""
    jcfg, tcfg = _cfgs("gemma3-1b")
    a = tcfg.attn
    cache = tf.init_decode_cache(tcfg, 2, 24, fill_len=24, hot_slots=HOT,
                                 device="cpu")
    lay = tf.layer_slice(cache["attn"], 0)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, a.num_heads, a.head_dim)).astype(np.float32)
    k = rng.normal(size=lay["k"].shape).astype(np.float32)
    for pos, empty in ((30, False), (24 + a.sliding_window, True)):
        m = lay["mask"] & ((pos - lay["pos"]) < a.sliding_window)
        got = ops.decode_attention_stats(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(k), kv_mask=m)
        want = jops.decode_attention_stats(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
            kv_mask=jnp.asarray(m.numpy()))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert bool(torch.all(got[1] == 0)) == empty


def test_meta_takes_the_plain_versions_and_other_devices_raise():
    q = torch.empty((2, 4, 32), device="meta")
    k = torch.empty((2, 9, 2, 32), device="meta")
    m, l, acc = ops.decode_attention_stats(q, k, k)
    assert (m.shape, l.shape, acc.shape) == ((2, 4), (2, 4), (2, 4, 32))
    assert m.device.type == "meta"
    out = ops.decode_attention(q, k, k)
    assert out.shape == (2, 4, 32) and out.device.type == "meta"
    elsewhere = types.SimpleNamespace(device=torch.device("mps"),
                                      shape=(2, 9, 2, 32),
                                      requires_grad=False)
    for call in (lambda: ops.decode_attention_stats(elsewhere, k, k),
                 lambda: ops.decode_attention(elsewhere, k, k),
                 lambda: ops.flash_attention(elsewhere, k, k)):
        with pytest.raises(ValueError, match="no kernel or plain version"):
            call()
