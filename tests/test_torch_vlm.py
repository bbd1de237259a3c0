"""Parity of the port's VLM backbone (qwen2-vl-72b's language model:
M-RoPE positions, embedding inputs; ROADMAP A10's VLM part) against the
JAX package, on the CPU.

A float32 copy of qwen2-vl's smoke config (2 layers, 4 / 2 heads of 32,
qkv bias, M-RoPE sections (4, 6, 6)) with the JAX parameters bridged leaf
for leaf and LoRA ``b`` drawn:

* ``apply_mrope`` with three streams that differ, and the text stream
  (where M-RoPE is RoPE), against JAX's;
* ``tf.prefill`` under lookaheadkv from float embeddings with given
  position streams (the lookahead rows extended by each stream's own
  maximum + 1 + i), from tokens with given positions as long as the
  lookahead-extended sequence, and from tokens without positions (the
  text stream): logits and caches; then decode steps with given streams
  and with the text stream of ``next_pos`` (JAX's rule, not maximum + 1);
* the lockstep engine (greedy tokens), ``run_eviction`` under laq with
  given positions, and ``BucketedEngine`` on a padded group, against the
  JAX engines; the launcher's lockstep and bucketed routes serve, its
  chunked continuous routes raise ``ValueError`` (as the JAX engine's
  assert);
* one train step on patch embeddings with M-RoPE streams and one
  distillation step against ``jax.jit(make_train_step)`` /
  ``make_distill_step`` (``torch_train_ref``: loss 1e-5 relative, each
  gradient leaf 1e-4 of its largest, Adam's m 2e-4 and v 4e-4, the
  updated modules 1e-6), while the launcher's trainer, whose data has
  no patch embeddings, stays refused (ROADMAP A10).

Tolerances: float32 1e-4; kept sets, positions, masks and tokens
identical.
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
from repro.common.config import TrainConfig as JTrain
from repro.configs import get_smoke_config as jax_smoke
from repro.core import policies as jpol
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import rope as jrope
from repro.models import transformer as jtf
from repro.serving import BucketedEngine as JBucketed
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JLockstep
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig as TEvict
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import objective as tobj
from repro_torch.core import policies as tpol
from repro_torch.launch import serve, steps, train
from repro_torch.models import rope as trope
from repro_torch.models import transformer as ttf
from repro_torch.optim import adam as tadam
from repro_torch.serving import (BucketedEngine, ChunkingConfig,
                                 ContinuousEngine, KVBlockPool, Request,
                                 ServingConfig, ServingEngine)
import torch_train_ref as train_ref

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen2-vl-72b"
#: the train steps' batch (B x (n_in + n_out), n_in the M-RoPE grid's 40
#: rows) and schedule: lr 1e-3 of a 10-step schedule
B, N_IN, N_OUT = 2, 40, 8
LR, SCHEDULE = 1e-3, 10


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(5)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"),
                tl=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                   device="cpu"))


def _streams(rng, B, S):
    """Three position streams that differ: a temporal stream and a
    16 x 16 patch grid's height / width, with a few repeats."""
    t = np.sort(rng.integers(0, S, (B, S)), axis=1)
    h = rng.integers(0, 16, (B, S))
    w = rng.integers(0, 16, (B, S)) + 3
    return np.stack([t, h, w]).astype(np.int32)


def _kept(mask, pos):
    L, B, _, KV = mask.shape
    return {(l, b, h): frozenset(pos[l, b, mask[l, b, :, h], h].tolist())
            for l in range(L) for b in range(B) for h in range(KV)}


def _assert_caches_equal(jcache, tcache):
    ja = {k: np.asarray(v) for k, v in jcache["attn"].items()}
    ta = {k: np.asarray(v) for k, v in tcache["attn"].items()}
    assert _kept(ta["mask"], ta["pos"]) == _kept(ja["mask"], ja["pos"])
    np.testing.assert_array_equal(ta["mask"], ja["mask"])
    np.testing.assert_array_equal(ta["pos"], ja["pos"])
    np.testing.assert_allclose(ta["k"], ja["k"], **TOL)
    np.testing.assert_allclose(ta["v"], ja["v"], **TOL)
    assert int(tcache["cursor"]) == int(jcache["cursor"])
    np.testing.assert_array_equal(np.asarray(tcache["next_pos"]),
                                  np.asarray(jcache["next_pos"]))


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_jax(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 40, 3, hd)).astype(np.float32)
    pos = _streams(rng, 2, 40)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                             sections)
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the text stream: M-RoPE's tables are RoPE's, bit for bit
    p = torch.from_numpy(pos[0])
    mt = trope.mrope_tables(trope.text_mrope_positions(p), hd, 1e6, sections)
    rt = trope.rope_tables(p, hd, 1e6)
    assert all(torch.equal(a, b) for a, b in zip(mt, rt))
    with pytest.raises(ValueError, match="sections"):
        trope.mrope_tables(pos, hd, 1e6, (1, 2, 3))


@pytest.mark.parametrize("inputs", ["embeds", "tokens", "text"])
def test_prefill_and_decode_match_jax(model, inputs):
    """lookaheadkv prefill of 2 x 40 rows: float embeddings with 40
    given positions (the 8 lookahead rows extended per stream), tokens
    with 48 given positions (nothing to extend), or tokens alone (the
    text stream); then three decode steps, with given streams (embeds) or
    the text stream of ``next_pos``."""
    m = model
    rng = np.random.default_rng(len(inputs))
    B, n = 2, 40
    D = m["jcfg"].d_model
    if inputs == "embeds":
        x = (rng.normal(size=(B, n, D)) * 0.3).astype(np.float32)
        pos = _streams(rng, B, n)
    else:
        x = rng.integers(0, 512, (B, n)).astype(np.int32)
        pos = _streams(rng, B, n + 8) if inputs == "tokens" else None
    jr = jtf.prefill(m["jp"], m["jcfg"], jnp.asarray(x), lkv_params=m["jl"],
                     policy="lookaheadkv", evict=JEvict(budget=16),
                     extra_slots=5,
                     mrope_positions=None if pos is None
                     else jnp.asarray(pos))
    tr = ttf.prefill(m["tp"], m["tcfg"], torch.from_numpy(x),
                     lkv_params=m["tl"], policy="lookaheadkv",
                     evict=TEvict(budget=16), extra_slots=5,
                     mrope_positions=None if pos is None
                     else torch.from_numpy(pos))
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **TOL)
    _assert_caches_equal(jr.cache, tr.cache)
    jcache, tcache = jr.cache, tr.cache
    tok = np.asarray(jnp.argmax(jr.logits, -1)[:, None]).astype(np.int32)
    for i in range(3):
        kw_j, kw_t = {}, {}
        step_in = tok
        if inputs == "embeds":  # an embedded token at given positions
            step_in = (rng.normal(size=(B, 1, D)) * 0.3).astype(np.float32)
            sp = (pos.max(axis=2, keepdims=True) + 9 + i).astype(np.int32)
            kw_j["mrope_positions"] = jnp.asarray(sp)
            kw_t["mrope_positions"] = torch.from_numpy(sp)
        jlog, jcache = jtf.decode_step(m["jp"], m["jcfg"],
                                       jnp.asarray(step_in), jcache, **kw_j)
        tlog, tcache = ttf.decode_step(m["tp"], m["tcfg"],
                                       torch.from_numpy(step_in), tcache,
                                       **kw_t)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)[:, None]).astype(np.int32)
    _assert_caches_equal(jcache, tcache)


def test_lockstep_engine_and_laq_match_jax(model):
    """Greedy tokens of the lockstep engine (text tokens: the text
    stream), and ``run_eviction`` under laq with given streams (its first
    prefill takes them, its draft and rescoring the text stream)."""
    m = model
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 512, 45).astype(np.int32) for _ in range(3)]
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jdone = JLockstep(m["jp"], m["jcfg"], policy="lookaheadkv",
                          evict=JEvict(budget=16), lkv_params=m["jl"],
                          max_new_tokens=6, eos_id=-1).serve(
            [JRequest(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)])
    tdone = ServingEngine(m["tp"], m["tcfg"], policy="lookaheadkv",
                          evict=TEvict(budget=16), lkv_params=m["tl"],
                          max_new_tokens=6, eos_id=-1, device="cpu").serve(
        [Request(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]

    toks = np.stack(prompts[:2])
    pos = _streams(rng, 2, 45)
    jres = jpol.run_eviction("laq", m["jp"], m["jcfg"], jnp.asarray(toks),
                             evict=JEvict(budget=16, draft_len=4),
                             extra_slots=3, mrope_positions=jnp.asarray(pos))
    tres = tpol.run_eviction("laq", m["tp"], m["tcfg"],
                             torch.from_numpy(toks),
                             evict=TEvict(budget=16, draft_len=4),
                             extra_slots=3,
                             mrope_positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tres.logits.numpy(), np.asarray(jres.logits),
                               **TOL)
    _assert_caches_equal(jres.cache, tres.cache)


def test_bucketed_engine_matches_jax(model):
    """``--continuous --policy full`` serves qwen2-vl through
    ``BucketedEngine`` in both packages: a padded group (prompts of 20,
    30 and 64 rows at bucket 64, 11 alone at 16), tokens identical."""
    m = model
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (20, 30, 64, 11)]
    eng = BucketedEngine(m["tp"], m["tcfg"], policy="full",
                         evict=TEvict(budget=8), num_slots=3,
                         buckets=(16, 32, 64), max_new_tokens=5, eos_id=-1,
                         device="cpu")
    got = {r.uid: r.out_tokens for r in eng.run(
        [Request(uid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jdone = JBucketed(m["jp"], m["jcfg"], policy="full",
                          evict=JEvict(budget=8), num_slots=3,
                          buckets=(16, 32, 64), max_new_tokens=5,
                          eos_id=-1).run(
            [JRequest(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)])
    assert got == {r.uid: r.out_tokens for r in jdone}


@pytest.mark.parametrize("route,engine", [
    ([], "ServingEngine:"),
    (["--continuous", "--policy", "full"], "BucketedEngine:"),
    (["--policy", "laq"], "ServingEngine:"),
])
def test_launcher_serves_qwen2_vl(route, engine, capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--budget",
                "16", "--requests", "3", "--n-in", "48", "--max-new",
                "4"] + route)
    out = capsys.readouterr().out
    assert out.startswith(engine) and "requests=3" in out, out
    assert out.count("4 tokens") == 3


@pytest.mark.parametrize("pool", [False, True])
def test_continuous_routes_refuse_mrope(model, pool):
    """The chunked continuous engine (dense slots or paged) raises
    ``ValueError`` for M-RoPE, where the JAX engine asserts
    ``chunkable``; so does the launcher's route."""
    m = model
    sc = ServingConfig(
        chunking=ChunkingConfig(chunk=16, max_context=64),
        kv_pool=KVBlockPool(m["tcfg"], block_size=8, num_blocks=16,
                            device="cpu") if pool else None)
    with pytest.raises(ValueError, match="M-RoPE"):
        ContinuousEngine(m["tp"], m["tcfg"], sc, lkv_params=m["tl"],
                         device="cpu")
    route = ["--continuous"] + (["--kv-pool-mb", "1"] if pool else [])
    with pytest.raises(ValueError, match="M-RoPE"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"] + route)


def _port_step(model, batch: dict, distill: bool) -> dict:
    """One step of the port's ``make_train_step`` (``make_distill_step``)
    on one device, as numpy leaves."""
    make = steps.make_distill_step if distill else steps.make_train_step
    step = make(model["tcfg"], TrainConfig(
        steps=SCHEDULE, lr=LR, batch_size=B, n_in=N_IN, n_out=N_OUT))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lkv, opt, loss, metrics = step(model["tp"], model["tl"],
                                   tadam.init(model["tl"]), tb)
    return {"loss": float(loss),
            "grads": [g.numpy() for g in tadam.leaves(metrics["grads"])],
            "mu": [g.numpy() for g in tadam.leaves(opt.mu)],
            "nu": [g.numpy() for g in tadam.leaves(opt.nu)],
            "lkv": [g.numpy() for g in tadam.leaves(lkv)]}


def _jtc():
    return JTrain(steps=SCHEDULE, lr=LR, batch_size=B, n_in=N_IN,
                  n_out=N_OUT)


def test_train_step_matches_jax(model):
    """One step of the port's ``make_train_step`` on patch embeddings
    with M-RoPE streams of a text prefix and a 4 x 8 image grid, against
    ``jax.jit(make_train_step)`` (the GT pass over [X; embed(Y)] on the
    text stream, as JAX's step runs it): the loss, every gradient leaf,
    Adam's ``m`` and ``v`` and the updated modules
    (``torch_train_ref.assert_step_matches``)."""
    batch = train_ref.vlm_batch(model["tcfg"], B, N_OUT, seed=11)
    want = train_ref.jax_step(model["jcfg"], model["jp"], model["jl"],
                              batch, _jtc())
    train_ref.assert_step_matches(_port_step(model, batch, False), want,
                                  LR, "train")


def test_distill_step_matches_jax(model):
    """The distillation step on patch embeddings (no M-RoPE streams: JAX's
    ``make_distill_step`` passes none) against stored targets, the port's
    one-device GT pass: the same quantities as the train step."""
    batch = train_ref.vlm_batch(model["tcfg"], B, N_OUT, seed=12)
    x, y = torch.from_numpy(batch["x"]), torch.from_numpy(batch["y"])
    xy = torch.cat([x, ttf.embed(model["tp"], model["tcfg"], y)], dim=1)
    s_gt = tobj.gt_scores(model["tp"], model["tcfg"], xy, x.shape[1])
    batch = {"x": batch["x"], "s_gt": s_gt.numpy()}
    want = train_ref.jax_step(model["jcfg"], model["jp"], model["jl"],
                              batch, _jtc())
    train_ref.assert_step_matches(_port_step(model, batch, True), want,
                                  LR, "distill")


def test_training_and_encoder_inputs_stay_refused(model):
    """The launcher's trainer still refuses qwen2-vl (ROADMAP A10): its
    synthetic mixture and harvested traces are token ids, with no patch
    embeddings in either package; frame embeddings raise ValueError
    (qwen2-vl has no encoder: the port refuses what the JAX package
    ignores)."""
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "1"])
    with pytest.raises(ValueError, match="has no encoder"):
        ttf.prefill(model["tp"], model["tcfg"], torch.zeros((1, 8),
                                                            dtype=torch.long),
                    encoder_embeds=torch.zeros((1, 4, 128)))
