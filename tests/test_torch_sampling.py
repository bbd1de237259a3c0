"""The port's sampled decode against the JAX package's, on the CPU.

* The random stream: ``PRNGKey``, ``split``, ``fold_in`` / ``fold_keys``
  and the bits and uniforms of ``random_bits`` / ``uniform`` equal
  ``jax.random``'s bit for bit (``jax_threefry_partitionable``); the
  Gumbel noise differs only by the rounding of its two logs.
* ``filter_logits``: top-k keeps every tie at the k-th value; top-p's kept
  set equals JAX's except where a token's mass before it lies within 1e-6
  of ``p`` (the two cumulative sums round apart there).
* ``sample_logits`` draws JAX's ids on seeded logits at V 512 and at
  llama3-8b's 128,256.  A row may differ only where its top two perturbed
  logits lie within 1e-5 of each other; such rows are counted, and the
  draws here have none.
* ``sample_decode``, ``ContinuousEngine`` with ``Sampling`` (paged and
  dense) and ``MixtureIterator(temperature=0.7)`` give the JAX package's
  tokens on the float32 llama3-8b smoke model (JAX parameters bridged),
  and a sampled request preempted on a dry pool replays its tokens.
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
from repro.core import policies as jpol
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.data import synthetic as jsyn
from repro.models import transformer as jtf
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import KVBlockPool as JPool
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServing
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import eviction as tev
from repro_torch.core import policies as tpol
from repro_torch.data import synthetic as tsyn
from repro_torch.models import transformer as ttf
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 KVBlockPool, Request, Sampling,
                                 ServingConfig)

SAMPLING = dict(temperature=0.7, top_k=50, top_p=0.9)
TIE_GAP = 1e-5  # top-two perturbed logits closer than this may swap
MASS_GAP = 1e-6  # a kept-set edge this close to p may differ


def _words(jkeys) -> tuple:
    """A JAX raw key array (..., 2) as the port's two int64 words."""
    a = np.asarray(jkeys).astype(np.int64)
    return torch.as_tensor(a[..., 0]), torch.as_tensor(a[..., 1])


def test_random_stream_bits_match_jax():
    key = jax.random.PRNGKey(20261018)
    tkey = tev.PRNGKey(20261018)
    np.testing.assert_array_equal(np.stack([t.numpy() for t in tkey]),
                                  np.asarray(key).astype(np.int64))
    for num in (1, 7, 33):
        got = tev.split(tkey, num)
        want = _words(jax.random.split(key, num))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    seeds = np.array([0, 1, 17, 2**31 - 1, 123456], np.int32)
    pos = np.array([0, 5, 4096, 77, 2**20], np.int32)
    want = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s),
                                                     p))(seeds, pos)
    got = tpol.fold_keys(torch.as_tensor(seeds), torch.as_tensor(pos))
    for g, w in zip(got, _words(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # the bits of a (3, 1000) draw (the flattened counters), of a (V,)
    # draw per row key, and the uniforms in [tiny, 1) built from them
    np.testing.assert_array_equal(
        tev.random_bits(tkey, (3, 1000)).numpy(),
        np.asarray(jax.random.bits(key, (3, 1000))).astype(np.int64))
    want_rows = jax.vmap(lambda k: jax.random.bits(k, (600,)))(want)
    np.testing.assert_array_equal(
        tev.random_bits(got, (600,)).numpy(),
        np.asarray(want_rows).astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0)):
        u = tev.uniform(tkey, (5000,), minval=lo, maxval=hi).numpy()
        ju = np.asarray(jax.random.uniform(key, (5000,), minval=lo,
                                           maxval=hi))
        np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))
    # Gumbel noise: the same uniforms, then two logs that may each round
    # an ulp apart from XLA's
    g = tev.gumbel(tkey, (20000,)).numpy()
    jg = np.asarray(jax.random.gumbel(key, (20000,)))
    ulp = np.spacing(np.abs(jg).astype(np.float32))
    assert np.all(np.abs(g - jg) <= 2 * ulp + 2 * np.spacing(np.float32(1)))


def _ties_logits(rng, B, V):
    """Logits with plateaus: values on a coarse grid, so top-k's k-th
    value is shared by several tokens."""
    return (rng.integers(-40, 40, (B, V)) / 8.0).astype(np.float32)


@pytest.mark.parametrize("top_k", [1, 5, 50])
def test_filter_top_k_keeps_ties_like_jax(top_k):
    x = _ties_logits(np.random.default_rng(top_k), 6, 512)
    want = np.asarray(jpol.filter_logits(jnp.asarray(x), top_k=top_k))
    got = tpol.filter_logits(torch.as_tensor(x), top_k=top_k).numpy()
    np.testing.assert_array_equal(got, want)
    kth = np.sort(x, axis=-1)[:, ::-1][:, top_k - 1:top_k]
    assert ((got > -1e29) == (x >= kth)).all()  # every tie at k-th kept


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.99])
def test_filter_top_p_matches_jax(top_p):
    rng = np.random.default_rng(int(top_p * 100))
    x = (rng.normal(size=(8, 512)) * 3).astype(np.float32)
    want = np.asarray(jpol.filter_logits(jnp.asarray(x), top_p=top_p))
    got = tpol.filter_logits(torch.as_tensor(x), top_p=top_p).numpy()
    # where the kept sets differ, the token's mass before it must sit
    # within MASS_GAP of p (computed on the JAX side)
    srt = -np.sort(-x, axis=-1)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(srt), axis=-1))
    before = np.cumsum(probs, axis=-1) - probs
    edge = np.abs(before - top_p).min(axis=-1)
    differ = ((got > -1e29) != (want > -1e29)).any(axis=-1)
    assert not (differ & (edge > MASS_GAP)).any()
    np.testing.assert_array_equal(got[~differ], want[~differ])
    assert differ.sum() == 0  # none of these draws sits on an edge


def _near_ties(keys, x, temperature, top_k, top_p) -> np.ndarray:
    """Rows whose top two perturbed logits (JAX's Gumbel noise plus the
    filtered logits) lie within TIE_GAP."""
    f = jpol.filter_logits(jnp.asarray(x) / temperature, top_k=top_k,
                           top_p=top_p)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, x.shape[1:]))(keys)
    top2 = -np.sort(-np.asarray(noise + f), axis=-1)[:, :2]
    return top2[:, 0] - top2[:, 1] < TIE_GAP


@pytest.mark.parametrize("V,B", [(512, 64), (128256, 12)])
@pytest.mark.parametrize("sampling", [SAMPLING, dict(temperature=1.3)])
def test_sample_logits_matches_jax(V, B, sampling):
    rng = np.random.default_rng(V + B)
    x = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    pos = rng.integers(0, 8192, B).astype(np.int32)
    jkeys = jpol.fold_keys(jnp.asarray(seeds), jnp.asarray(pos))
    want = np.asarray(jpol.sample_logits(jnp.asarray(x), jkeys, **sampling))
    got = tpol.sample_logits(
        torch.as_tensor(x),
        tpol.fold_keys(torch.as_tensor(seeds), torch.as_tensor(pos)),
        **sampling).numpy()
    ties = _near_ties(jkeys, x, sampling["temperature"],
                      sampling.get("top_k", 0), sampling.get("top_p", 1.0))
    np.testing.assert_array_equal(got[~ties], want[~ties])
    assert ties.sum() == 0, f"{ties.sum()} near-tie rows in this draw"
    # temperature 0 is the argmax, whatever the keys
    np.testing.assert_array_equal(
        tpol.sample_logits(torch.as_tensor(x), None, temperature=0.0).numpy(),
        x.argmax(-1))


# ---------------------------------------------------------------------------
# through the model: sample_decode, the engines, the synthetic mixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(9)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)

    def port(tree):
        return bridge.to_torch(jax.tree.map(np.asarray, tree), device="cpu")

    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv, tp=port(params),
                tl=port(lkv))


def test_sample_decode_matches_jax(model):
    rng = np.random.default_rng(3)
    x = rng.integers(0, model["jcfg"].vocab_size, (3, 20)).astype(np.int32)
    steps = 10
    for temperature, top_k, top_p in ((0.7, 50, 0.9), (1.0, 0, 1.0),
                                      (0.0, 0, 1.0)):
        jres = jtf.prefill(model["jp"], model["jcfg"], jnp.asarray(x),
                           policy="full", extra_slots=steps + 1)
        want, _ = jpol.sample_decode(
            model["jp"], model["jcfg"], jres.logits, jres.cache, steps,
            temperature=temperature, top_k=top_k, top_p=top_p,
            key=jax.random.PRNGKey(11))
        tres = ttf.prefill(model["tp"], model["tcfg"], torch.as_tensor(x),
                           policy="full", extra_slots=steps + 1)
        got, _ = tpol.sample_decode(
            model["tp"], model["tcfg"], tres.logits, tres.cache, steps,
            temperature=temperature, top_k=top_k, top_p=top_p,
            key=tev.PRNGKey(11))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


LENS, MAX_NEW = (37, 11, 50, 23, 64), 7


def _prompts(cfg):
    rng = np.random.default_rng(21)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]


def _serve_port(model, *, sampling, pool_blocks=None, block_size=8,
                reserve_appends=True, decode_chunk=8, budget=16):
    cfg = model["tcfg"]
    pool = (KVBlockPool(cfg, block_size=block_size, num_blocks=pool_blocks,
                        device="cpu") if pool_blocks else None)
    sc = ServingConfig(
        policy="lookaheadkv", evict=EvictionConfig(budget=budget),
        chunking=ChunkingConfig(chunk=16, max_context=max(LENS),
                                decode_chunk=decode_chunk),
        num_slots=2, max_new_tokens=MAX_NEW, eos_id=-1, kv_pool=pool,
        sampling=sampling, reserve_appends=reserve_appends)
    eng = ContinuousEngine(model["tp"], cfg, sc, lkv_params=model["tl"],
                           device="cpu")
    done = eng.run([Request(uid=i, prompt=p, max_new_tokens=MAX_NEW,
                            seed=500 + 31 * i)
                    for i, p in enumerate(_prompts(cfg))])
    return {r.uid: r.out_tokens for r in done}, eng


@pytest.mark.parametrize("paged", [True, False])
def test_continuous_engine_sampling_matches_jax(model, paged):
    """Sampled tokens per request equal the JAX ``ContinuousEngine``'s
    under the same ``Sampling`` and seeds, paged and on dense slots; and
    they are not the greedy ones."""
    jcfg = model["jcfg"]
    s = jpol.Sampling(**SAMPLING)
    jsc = JServing(
        policy="lookaheadkv", evict=JEvict(budget=16),
        chunking=JChunking(chunk=16, max_context=max(LENS)),
        num_slots=2, max_new_tokens=MAX_NEW, eos_id=-1, sampling=s,
        kv_pool=JPool(jcfg, block_size=8, num_blocks=24) if paged else None)
    jdone = JEngine(model["jp"], jcfg, jsc, lkv_params=model["jl"]).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW, seed=500 + 31 * i)
         for i, p in enumerate(_prompts(jcfg))])
    want = {r.uid: r.out_tokens for r in jdone}
    got, _ = _serve_port(model, sampling=Sampling(**SAMPLING),
                         pool_blocks=24 if paged else None)
    assert got == want
    greedy, _ = _serve_port(model, sampling=None,
                            pool_blocks=24 if paged else None)
    assert greedy != got


def test_sampled_replay_under_preemption(model):
    """Optimistic admission on a pool too small for every slot's growth
    preempts requests; each re-serve samples the tokens of an unpreempted
    run, because each token's key is its absolute position."""
    s = Sampling(**SAMPLING)
    want, _ = _serve_port(model, sampling=s, pool_blocks=64, block_size=4,
                          budget=8)
    got, eng = _serve_port(model, sampling=s, pool_blocks=7, block_size=4,
                           budget=8, reserve_appends=False, decode_chunk=1)
    assert eng.counts["preemptions"] > 0
    assert got == want


def test_mixture_iterator_sampled_matches_jax(model):
    j = jsyn.MixtureIterator(model["jcfg"], 2, 24, 6, seed=13,
                             gen_params=model["jp"], temperature=0.7)
    t = tsyn.MixtureIterator(model["tcfg"], 2, 24, 6, seed=13,
                             gen_params=model["tp"], temperature=0.7)
    sampled = []
    for _ in range(4):
        a, b = next(j), next(t)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        sampled.append(b.y)
    greedy = tsyn.MixtureIterator(model["tcfg"], 2, 24, 6, seed=13,
                                  gen_params=model["tp"])
    assert any((next(greedy).y != y).any() for y in sampled)
