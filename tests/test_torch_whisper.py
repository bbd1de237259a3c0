"""Parity of the port's encoder-decoder arch (whisper-small: the encoder
over stubbed frame embeddings, cross-attention, cross-KV eviction) against
the JAX package, on the CPU.

A float32 copy of whisper's smoke config (2 encoder and 2 decoder layers,
4 / 4 heads of 32, 16 frames) with the JAX parameters bridged leaf for
leaf and LoRA ``b`` drawn, so that the lookahead LoRA on the cross block's
``wq`` and ``wo`` matters:

* ``encode`` and ``encode_cross_kv``; ``cross_attention`` with its LoRA
  and ``cross_attention_decode_evicted`` on a per-head mask;
* ``tf.prefill`` under lookaheadkv with ``cross_budget`` 0 and 8 (logits,
  the self and the cross caches), then three ``decode_step`` calls over
  each cache, with decode-time eviction scores on the evicted one;
* ``run_eviction`` + ``greedy_decode`` under snapkv and h2o (h2o's cross
  eviction has no observation rows: the first frames are kept);
* ``lkv_loss`` and its gradient with respect to every lkv leaf (the cross
  ``wk`` / ``wv`` LoRA, which neither package applies, gets none);
* the LoRA tree's keys and shapes, and a JAX-written lookahead checkpoint
  loaded by the port;
* ``ops.flash_attention`` at Sq != Sk, with and without a key mask,
  against ``repro.kernels.ref.attention``;
* one train step with frames against ``jax.jit(make_train_step)``
  (``torch_train_ref``: loss 1e-5 relative, each gradient leaf 1e-4 of
  its largest, Adam's m 2e-4 and v 4e-4, the updated modules 1e-6).

And the refusals, where the JAX package fails too: LAQ and SpecKV,
``prompt_lens``, a missing ``encoder_embeds``, the launcher,
distillation and the launcher's trainer.

Tolerances: float32 1e-4; kept sets, positions, masks and tokens
identical.  JAX compiles are few and small (the prefill and decode steps
run unjitted).
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.common.config import EvictionConfig as JEvict
from repro.common.config import TrainConfig as JTrain
from repro.configs import get_smoke_config as jax_smoke
from repro.core import objective as jobj
from repro.core import policies as jpol
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig as TEvict
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import objective as tobj
from repro_torch.core import policies as tpol
from repro_torch.core.lookahead import (init_lookahead_params,
                                        load_lookahead_params)
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.optim import adam as tadam
import torch_train_ref as train_ref

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper-small"
B, N_IN, N_OUT = 2, 40, 8


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
    F = jcfg.encoder.num_frames
    frames = rng.normal(size=(B, F, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, N_IN + N_OUT)).astype(
        np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv, frames=frames,
                toks=toks,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"),
                tl=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                   device="cpu"))


def _kept(mask, pos):
    L, Bs, _, KV = mask.shape
    return {(l, b, h): frozenset(pos[l, b, mask[l, b, :, h], h].tolist())
            for l in range(L) for b in range(Bs) for h in range(KV)}


def _assert_caches_equal(jcache, tcache):
    """Self and cross caches: kept sets, positions and masks identical,
    K/V within TOL."""
    assert set(tcache) == set(jcache)
    for group in ("attn", "cross"):
        ja = {k: np.asarray(v) for k, v in jcache[group].items()}
        ta = {k: np.asarray(v) for k, v in tcache[group].items()}
        assert set(ta) == set(ja), group
        if "mask" in ja:
            assert _kept(ta["mask"], ta["pos"]) == _kept(ja["mask"],
                                                         ja["pos"])
            np.testing.assert_array_equal(ta["mask"], ja["mask"])
            np.testing.assert_array_equal(ta["pos"], ja["pos"])
        np.testing.assert_allclose(ta["k"], ja["k"], **TOL)
        np.testing.assert_allclose(ta["v"], ja["v"], **TOL)
    assert int(tcache["cursor"]) == int(jcache["cursor"])
    np.testing.assert_array_equal(np.asarray(tcache["next_pos"]),
                                  np.asarray(jcache["next_pos"]))


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def test_encode_and_cross_kv_match_jax(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    fr = model["frames"]
    want = jtf.encode(model["jp"], jcfg, jnp.asarray(fr))
    got = ttf.encode(model["tp"], tcfg, torch.from_numpy(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jk, jv = jtf.encode_cross_kv(model["jp"], jcfg, want)
    tk, tv = ttf.encode_cross_kv(model["tp"], tcfg, got)
    L, F = tcfg.num_layers, tcfg.encoder.num_frames
    assert tuple(tk.shape) == (L, B, F, 4, 32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_cross_attention_matches_jax(model):
    """With the LoRA on ``wq`` / ``wo`` on the masked rows only, and the
    decode form over an evicted cache with a per-kv-head mask."""
    a = model["tcfg"].attn
    rng = np.random.default_rng(11)
    h = rng.normal(size=(B, 12, 128)).astype(np.float32)
    ek, ev_ = (rng.normal(size=(B, 16, 4, 32)).astype(np.float32)
               for _ in range(2))
    lmask = np.zeros((B, 12, 1), np.float32)
    lmask[:, 9:] = 1.0
    jp, tp = _layer0(model["jp"]["layers"]), _layer0(model["tp"]["layers"])
    jl, tl = _layer0(model["jl"]["lora"]), _layer0(model["tl"]["lora"])
    want = jattn.cross_attention(
        jp["cross"], a, jnp.asarray(h), jnp.asarray(ek), jnp.asarray(ev_),
        lora=jl["cross"], lora_mask=jnp.asarray(lmask), lora_scale=2.0)
    got = tattn.cross_attention(
        tp["cross"], a, torch.from_numpy(h), torch.from_numpy(ek),
        torch.from_numpy(ev_), lora=tl["cross"],
        lora_mask=torch.from_numpy(lmask), lora_scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tattn.cross_attention(tp["cross"], a, torch.from_numpy(h),
                                  torch.from_numpy(ek), torch.from_numpy(ev_))
    assert not torch.allclose(plain[:, 9:], got[:, 9:])  # the LoRA matters
    torch.testing.assert_close(plain[:, :9], got[:, :9], rtol=0, atol=0)
    mask = rng.random((B, 16, 4)) > 0.4
    cache = {"k": ek, "v": ev_, "mask": mask}
    want = jattn.cross_attention_decode_evicted(
        jp["cross"], a, jnp.asarray(h[:, :1]),
        {k: jnp.asarray(v) for k, v in cache.items()})
    got = tattn.cross_attention_decode_evicted(
        tp["cross"], a, torch.from_numpy(h[:, :1]),
        {k: torch.from_numpy(v) for k, v in cache.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _decode_three(step, cache, tok0):
    """Three decode steps from ``tok0`` (B, 1) int32 numpy; returns the
    logits of each and the last cache."""
    out, tok = [], tok0
    for _ in range(3):
        logits, cache = step(tok, cache)
        logits = np.asarray(logits)
        out.append(logits)
        tok = logits.argmax(-1)[:, None].astype(np.int32)
    return out, cache


@pytest.mark.parametrize("cross_budget", [0, 8])
def test_prefill_and_decode_match_jax(model, cross_budget):
    """lookaheadkv prefill with the cross cache kept whole or evicted to 8
    of 16 frames, then three decode steps over each cache (the evicted one
    armed with decode-time eviction scores)."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    toks, fr = model["toks"][:, :N_IN], model["frames"]
    jres = jtf.prefill(model["jp"], jcfg, jnp.asarray(toks),
                       lkv_params=model["jl"], policy="lookaheadkv",
                       evict=JEvict(budget=16, cross_budget=cross_budget),
                       extra_slots=4, encoder_embeds=jnp.asarray(fr))
    tres = ttf.prefill(model["tp"], tcfg, torch.from_numpy(toks),
                       lkv_params=model["tl"], policy="lookaheadkv",
                       evict=TEvict(budget=16, cross_budget=cross_budget),
                       extra_slots=4, encoder_embeds=torch.from_numpy(fr))
    np.testing.assert_allclose(tres.logits.numpy(), np.asarray(jres.logits),
                               **TOL)
    _assert_caches_equal(jres.cache, tres.cache)
    assert ("mask" in tres.cache["cross"]) == (cross_budget > 0)
    jcache, tcache = jres.cache, tres.cache
    if cross_budget:
        jcache = jtf.add_decode_eviction_scores(jcache)
        tcache = ttf.add_decode_eviction_scores(tcache)
    tok0 = np.asarray(jres.logits).argmax(-1)[:, None].astype(np.int32)
    jl, jc = _decode_three(
        lambda t, c: jtf.decode_step(model["jp"], jcfg, jnp.asarray(t), c),
        jcache, tok0)
    tl, tc = _decode_three(
        lambda t, c: ttf.decode_step(model["tp"], tcfg, torch.from_numpy(t),
                                     c), tcache, tok0)
    for got, want in zip(tl, jl):
        np.testing.assert_allclose(got, want, **TOL)
    _assert_caches_equal(jc, tc)


@pytest.mark.parametrize("policy,cross_budget", [("snapkv", 8),
                                                 ("h2o", 8)])
def test_run_eviction_and_greedy_decode_match_jax(model, policy,
                                                  cross_budget):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    toks, fr = model["toks"][:, :N_IN], model["frames"]
    jres = jpol.run_eviction(
        policy, model["jp"], jcfg, jnp.asarray(toks),
        evict=JEvict(budget=16, cross_budget=cross_budget), extra_slots=6,
        encoder_embeds=jnp.asarray(fr))
    tres = tpol.run_eviction(
        policy, model["tp"], tcfg, torch.from_numpy(toks),
        evict=TEvict(budget=16, cross_budget=cross_budget), extra_slots=6,
        encoder_embeds=torch.from_numpy(fr))
    np.testing.assert_allclose(tres.logits.numpy(), np.asarray(jres.logits),
                               **TOL)
    _assert_caches_equal(jres.cache, tres.cache)
    if policy == "h2o":  # no observation rows: the first frames are kept
        pos = tres.cache["cross"]["pos"].numpy()
        assert (pos == np.arange(8)[None, None, :, None]).all()
    first = np.asarray(jres.logits).argmax(-1)[:, None].astype(np.int32)
    jt, _ = jpol.greedy_decode(model["jp"], jcfg, jnp.asarray(first),
                               jres.cache, 5)
    tt, _ = tpol.greedy_decode(model["tp"], tcfg, torch.from_numpy(first),
                               tres.cache, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_lkv_loss_and_every_lkv_gradient_match_jax(model):
    """The distillation loss with frames, and its gradient: every leaf
    within 1e-4 of its largest JAX gradient; the cross ``wk`` / ``wv``
    LoRA, which no pass applies, has an exact zero gradient in both."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    toks, fr = model["toks"], model["frames"]
    x, xy = jnp.asarray(toks[:, :N_IN]), jnp.asarray(toks)

    def loss(jl):
        return jobj.lkv_loss(model["jp"], jcfg, jl, x, xy, N_IN,
                             encoder_embeds=jnp.asarray(fr))[0]

    val, want = jax.jit(jax.value_and_grad(loss))(model["jl"])
    tt, tf_ = torch.from_numpy(toks), torch.from_numpy(fr)
    got_loss, grads = steps.value_and_grad(
        lambda lkv: tobj.lkv_loss(model["tp"], tcfg, lkv, tt[:, :N_IN], tt,
                                  N_IN, encoder_embeds=tf_)[0], model["tl"])
    np.testing.assert_allclose(float(got_loss), float(val), rtol=1e-5)
    names = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    for name, g, w in zip(names, tadam.leaves(grads),
                          jax.tree.leaves(want)):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if name.startswith(("lora/cross/wk", "lora/cross/wv")):
            assert not w.any() and not g.any(), name
            continue
        scale = np.abs(w).max()
        assert scale > 0, f"{name}: JAX gradient is zero"
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


def test_lora_tree_and_jax_checkpoint(model, tmp_path):
    """The port's own LoRA tree has JAX's keys and shapes (``attn``,
    ``cross`` with wq, wk, wv, wo, and ``mlp``), and a JAX-written
    lookahead checkpoint loads leaf for leaf and serves JAX's prefill."""
    gen = torch.Generator().manual_seed(0)
    mine = init_lookahead_params(gen, model["tcfg"], model["tp"]["layers"])

    def shapes(tree):
        return {"/".join(str(k.key) for k in p): tuple(x.shape) for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    want = shapes(model["jl"])
    assert shapes(jax.tree.map(lambda t: t.numpy(), mine)) == want
    assert sorted(model["jl"]["lora"]) == ["attn", "cross", "mlp"]
    assert sorted(model["jl"]["lora"]["cross"]) == ["wk", "wo", "wq", "wv"]
    path = str(tmp_path / "lkv.npz")
    jckpt.save(path, model["jl"])
    loaded = load_lookahead_params(path, model["tcfg"],
                                   model["tp"]["layers"], device="cpu")
    for (p, w), g in zip(jax.tree_util.tree_flatten_with_path(
            model["jl"])[0], tadam.leaves(loaded)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), str(p))
    toks, fr = model["toks"][:, :N_IN], model["frames"]
    res = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(toks),
                      lkv_params=loaded, policy="lookaheadkv",
                      evict=TEvict(budget=16),
                      encoder_embeds=torch.from_numpy(fr))
    ref = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(toks),
                      lkv_params=model["tl"], policy="lookaheadkv",
                      evict=TEvict(budget=16),
                      encoder_embeds=torch.from_numpy(fr))
    torch.testing.assert_close(res.logits, ref.logits, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_cross_lengths_match_jax_reference(masked):
    """Sq != Sk (decoder rows over encoder frames), non-causal, GQA 2,
    with and without a (B, Sk) key mask; Sq = 1 (a decode step's
    cross-attention) too."""
    rng = np.random.default_rng(3 + masked)
    for Sq, Sk in ((21, 37), (1, 37), (50, 16)):
        q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
        k, v = (rng.normal(size=(2, Sk, 2, 16)).astype(np.float32)
                for _ in range(2))
        mask = None
        if masked:
            mask = rng.random((2, Sk)) > 0.3
            mask[:, 0] = True
        got = ops.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=False,
            kv_mask=None if mask is None else torch.from_numpy(mask))
        want = jref.attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
            kv_mask=None if mask is None else jnp.asarray(mask))
        assert tuple(got.shape) == (2, Sq, 4, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("what", ["laq", "speckv", "prompt_lens",
                                  "no frames", "launcher", "training"])
def test_whisper_refusals(model, what):
    """Where the JAX package fails on whisper, the port raises clearly:
    LAQ / SpecKV (the rescoring prefill drops the frames), bucket-padded
    prefill, a prefill without frames, the launcher (no engine passes
    frames), distillation (``ValueError`` where JAX's step asserts: a
    harvested batch has no frames) and the launcher's trainer (no
    synthetic frame batch in either package: ROADMAP A10)."""
    tcfg, tp = model["tcfg"], model["tp"]
    toks = torch.from_numpy(model["toks"][:, :N_IN])
    fr = torch.from_numpy(model["frames"])
    if what in ("laq", "speckv"):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            tpol.run_eviction(what, tp, tcfg, toks, evict=TEvict(budget=16),
                              draft_params=tp, draft_cfg=tcfg,
                              encoder_embeds=fr)
    elif what == "prompt_lens":
        with pytest.raises(ValueError, match="attention-only"):
            ttf.prefill(tp, tcfg, toks, policy="snapkv",
                        prompt_lens=torch.tensor([30, 40]),
                        encoder_embeds=fr)
    elif what == "no frames":
        with pytest.raises(ValueError, match="frame embeddings"):
            ttf.prefill(tp, tcfg, toks, policy="snapkv")
    elif what == "launcher":
        with pytest.raises(ValueError, match="run_eviction"):
            serve.run(["--arch", ARCH, "--smoke", "--device", "cpu"])
    else:
        with pytest.raises(ValueError, match="frame embeddings"):
            steps.make_distill_step(tcfg, TrainConfig(steps=1))
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "1"])


def test_train_step_matches_jax(model):
    """One step of the port's ``make_train_step`` with encoder frames in
    both passes against ``jax.jit(make_train_step)``: the loss, every
    gradient leaf, Adam's ``m`` and ``v`` and the updated modules
    (``torch_train_ref.assert_step_matches``; the cross ``wk`` / ``wv``
    LoRA zero in both)."""
    batch = train_ref.whisper_batch(model["tcfg"], B, N_IN, N_OUT,
                                    seed=13)
    want = train_ref.jax_step(model["jcfg"], model["jp"], model["jl"],
                              batch, JTrain(steps=10, lr=1e-3, batch_size=B,
                                            n_in=N_IN, n_out=N_OUT))
    step = steps.make_train_step(model["tcfg"], TrainConfig(
        steps=10, lr=1e-3, batch_size=B, n_in=N_IN, n_out=N_OUT))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lkv, opt, loss, metrics = step(model["tp"], model["tl"],
                                   tadam.init(model["tl"]), tb)
    got = {"loss": float(loss),
           "grads": [g.numpy() for g in tadam.leaves(metrics["grads"])],
           "mu": [g.numpy() for g in tadam.leaves(opt.mu)],
           "nu": [g.numpy() for g in tadam.leaves(opt.nu)],
           "lkv": [g.numpy() for g in tadam.leaves(lkv)]}
    train_ref.assert_step_matches(got, want, 1e-3, "train")
