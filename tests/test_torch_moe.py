"""Parity of the port's MoE archs (ROADMAP A10's MoE part) against the
JAX package, on the CPU.

Float32 copies of the smoke configs of deepseek-moe-16b (4 routed experts,
top-2, one shared expert; the lookahead LoRA on attention and the shared
experts) and phi3.5-moe (4 experts, top-2, no shared expert; LoRA on
attention only), with the JAX parameters bridged leaf for leaf and LoRA
``b`` drawn so that the LoRA matters:

* ``moe.apply`` (dense dispatch) and ``moe.apply_sparse`` (capacity
  dispatch, at the default capacity and at one that drops tokens) against
  JAX's: output and load-balance ``aux``; the router's top-k on exact ties;
  the routed experts as three batched GEMMs whatever the expert count;
* ``tf.prefill`` under lookaheadkv (both dispatches for deepseek): logits,
  kept sets, k/v, positions, masks and ``aux``; then three dense
  ``decode_step`` calls;
* the paged and dense-slot ``ContinuousEngine`` and the lockstep engine
  for deepseek against the JAX engines on one mixed trace: tokens and
  admission kept sets identical;
* the lookahead LoRA tree's keys and shapes against JAX's
  ``init_lookahead_params``;
* ``lm_loss`` and ``lkv_loss`` with every lkv leaf's gradient for
  deepseek;
* MoE parameter trees (a float32 router, 4-D experts) and a JAX-written
  ``--lkv-ckpt`` across the packages, and the launcher's routes.

Tolerances: float32 1e-4 (other summation orders); kept sets, positions,
masks, cursors and tokens identical.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core import objective as jobj
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import KVBlockPool as JPool
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServing
from repro.serving import ServingEngine as JLockstep
from repro_torch import bridge
from repro_torch.checkpoint import io as tckpt
from repro_torch.common.config import EvictionConfig as TEvict
from repro_torch.configs import get_smoke_config
from repro_torch.core import objective as tobj
from repro_torch.core.lookahead import (init_lookahead_params,
                                        load_lookahead_params)
from repro_torch.launch import serve, steps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.optim import adam as tadam
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 KVBlockPool, Request, ServingConfig,
                                 ServingEngine)

TOL = dict(atol=1e-4, rtol=1e-4)
DEEPSEEK, PHI = "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"


def _cfg(get, arch, dispatch="dense"):
    cfg = dataclasses.replace(get(arch), dtype="float32")
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


_MODELS = {}


def _model(arch):
    """The arch's float32 smoke model in both packages (built once per
    worker), LoRA b drawn."""
    if arch not in _MODELS:
        jcfg = _cfg(jax_smoke, arch)
        params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
        rng = np.random.default_rng(5)
        lkv = jax.tree_util.tree_map_with_path(
            lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05,
                                      x.dtype)
                          if str(p[-1].key) == "b" else x), lkv)
        _MODELS[arch] = dict(
            jcfg=jcfg, tcfg=_cfg(get_smoke_config, arch), jp=params, jl=lkv,
            tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                               device="cpu"),
            tl=bridge.to_torch(jax.tree.map(np.asarray, lkv), device="cpu"))
    return _MODELS[arch]


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


def _layer0(m):
    """Layer 0's MoE parameters in both packages, and the shared experts'
    LoRA when the arch has one."""
    jp = jax.tree.map(lambda x: x[0], m["jp"]["layers"]["moe"])
    tp = ttf.layer_slice(m["tp"]["layers"], 0)["moe"]
    jlo = tlo = None
    if "moe" in m["jl"]["lora"]:
        jlo = jax.tree.map(lambda x: x[0], m["jl"]["lora"]["moe"]["shared"])
        tlo = ttf.layer_slice(m["tl"]["lora"], 0)["moe"]["shared"]
    return jp, tp, jlo, tlo


@pytest.mark.parametrize("arch,dispatch,cap", [
    (DEEPSEEK, "dense", None), (PHI, "dense", None),
    (DEEPSEEK, "sparse", None), (DEEPSEEK, "sparse", 5),
    (PHI, "sparse", 3)])
def test_moe_layer_matches_jax(arch, dispatch, cap):
    """One MoE layer over 2 x 300 rows (two dense-dispatch chunks, the
    second partial), the shared experts' LoRA on the last 8 rows; sparse
    at the default capacity and at one that drops tokens."""
    m = _model(arch)
    jp, tp, jlo, tlo = _layer0(m)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 300, m["jcfg"].d_model)).astype(np.float32)
    lm = np.zeros((2, 300, 1), np.float32)
    lm[:, -8:] = 1.0
    jfn = jmoe.apply if dispatch == "dense" else jmoe.apply_sparse
    tfn = tmoe.apply if dispatch == "dense" else tmoe.apply_sparse
    kw = {} if dispatch == "dense" else {"capacity": cap}
    jout, jaux = jax.jit(lambda p, x, lo, msk: jfn(
        p, m["jcfg"], x, lora=lo, lora_mask=msk, lora_scale=8.0, **kw))(
        jp, jnp.asarray(h), jlo, jnp.asarray(lm))
    tout, taux = tfn(tp, m["tcfg"], torch.from_numpy(h), lora=tlo,
                     lora_mask=torch.from_numpy(lm), lora_scale=8.0, **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if cap is not None:  # some (token, choice) pairs were dropped
        _, _, _, idx = tmoe._route(tp, m["tcfg"], torch.from_numpy(h))
        per_expert = torch.bincount(idx.reshape(-1),
                                    minlength=m["tcfg"].moe.num_experts)
        assert int(per_expert.max()) > cap


def _gemms(fn):
    """The names of the aten GEMM calls (mm, bmm, addmm, baddbmm) that
    ``fn()`` makes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in ("mm", "bmm", "addmm",
                                                "baddbmm"):
                seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return seen


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_experts_are_batched_gemms(dispatch):
    """The routed experts take three batched GEMMs a call whatever the
    expert count (no Python loop over experts): the router, three expert
    products and the shared expert's three, at E 4 and E 64; the dense
    dispatch's experts once per 256-row chunk."""
    base = _cfg(get_smoke_config, DEEPSEEK, dispatch)
    counts = []
    for E in (4, 64):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, num_experts=E))
        p = tmoe.init(torch.Generator().manual_seed(0), cfg, torch.float32)
        h = torch.randn((2, 300, cfg.d_model))
        fn = tmoe.apply if dispatch == "dense" else tmoe.apply_sparse
        counts.append(_gemms(lambda: fn(p, cfg, h)))
    chunks = 2 if dispatch == "dense" else 1  # 300 rows: 256 + 44
    assert counts[0] == counts[1]
    assert counts[0].count("bmm") == 3 * chunks
    assert len(counts[0]) == 1 + 3 * chunks + 3


def test_router_top_k_breaks_ties_to_the_lower_index():
    """Exact ties (a plateau of equal probabilities) pick the lower expert
    ids first, as ``jax.lax.top_k`` does."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3, 0.0], [0.2, 0.2, 0.2, 0.2,
                                                       0.2]])
    vals, idx = tmoe.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 3], [0, 1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch,dispatch", [(DEEPSEEK, "dense"),
                                           (PHI, "dense"),
                                           (DEEPSEEK, "sparse")])
def test_prefill_and_decode_match_jax(arch, dispatch):
    """``tf.prefill`` under lookaheadkv (2 x 45 tokens and the 8
    lookahead rows: capacity counts them), then three greedy dense
    decode steps on each side's cache (sparse dispatch: the step's own
    rows compete for capacity)."""
    m = _model(arch)
    jcfg, tcfg = _cfg(jax_smoke, arch, dispatch), _cfg(get_smoke_config,
                                                       arch, dispatch)
    tokens = np.random.default_rng(len(arch)).integers(
        0, 512, (2, 45)).astype(np.int32)
    jr = jtf.prefill(m["jp"], jcfg, jnp.asarray(tokens), lkv_params=m["jl"],
                     policy="lookaheadkv", evict=JEvict(budget=16),
                     extra_slots=5)
    tr = ttf.prefill(m["tp"], tcfg, torch.from_numpy(tokens),
                     lkv_params=m["tl"], policy="lookaheadkv",
                     evict=TEvict(budget=16), extra_slots=5)
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **TOL)
    np.testing.assert_allclose(float(tr.aux), float(jr.aux), rtol=1e-5)
    assert float(tr.aux) > 0
    _assert_caches_equal(jr.cache, tr.cache)
    jcache, tcache = jr.cache, tr.cache
    tok = np.asarray(jnp.argmax(jr.logits, -1)[:, None]).astype(np.int32)
    for _ in range(3):
        jlog, jcache = jtf.decode_step(m["jp"], jcfg, jnp.asarray(tok),
                                       jcache)
        tlog, tcache = ttf.decode_step(m["tp"], tcfg, torch.from_numpy(tok),
                                       tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)[:, None]).astype(np.int32)
    _assert_caches_equal(jcache, tcache)


def _admission_sets(adm):
    m, p = adm["mask"], adm["pos"]
    L, _, _, KV = m.shape
    return {(lyr, h): frozenset(p[lyr, 0, m[lyr, 0, :, h], h].tolist())
            for lyr in range(L) for h in range(KV)}


@pytest.mark.parametrize("paged", [True, False])
def test_continuous_engine_matches_jax(paged):
    """deepseek's chunked ``ContinuousEngine`` (paged pool or dense slot
    caches) against JAX's on a mixed trace: prompts shorter than the
    budget, not multiples of the chunk, more requests than slots."""
    m = _model(DEEPSEEK)
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


def test_lockstep_engine_matches_jax():
    m = _model(DEEPSEEK)
    rng = np.random.default_rng(17)
    n_in, max_new = 45, 7
    prompts = [rng.integers(0, 512, n_in).astype(np.int32) for _ in range(3)]
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jdone = JLockstep(m["jp"], m["jcfg"], policy="lookaheadkv",
                          evict=JEvict(budget=16), lkv_params=m["jl"],
                          max_new_tokens=max_new, eos_id=-1).serve(
            [JRequest(uid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)])
    tdone = ServingEngine(m["tp"], m["tcfg"], policy="lookaheadkv",
                          evict=TEvict(budget=16), lkv_params=m["tl"],
                          max_new_tokens=max_new, eos_id=-1,
                          device="cpu").serve(
        [Request(uid=i, prompt=p, max_new_tokens=max_new)
         for i, p in enumerate(prompts)])
    for j, t in zip(jdone, tdone):
        assert t.out_tokens == j.out_tokens, f"uid {t.uid}: tokens diverged"
        assert len(t.out_tokens) == max_new and t.done


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", [DEEPSEEK, PHI])
def test_lora_tree_matches_jax(arch):
    """deepseek: attention and the shared experts; the routed experts
    (4-D) and the router are left out; phi3.5: attention only."""
    m = _model(arch)
    want = _shapes(jax.tree.map(np.asarray, jax_init_lkv(
        jax.random.PRNGKey(1), m["jcfg"], m["jp"]["layers"])))
    got = _shapes(init_lookahead_params(torch.Generator().manual_seed(1),
                                        m["tcfg"], m["tp"]["layers"]))
    assert got == want
    lora = {k for k in got if k.startswith("lora/")}
    attn = {f"lora/attn/{w}/{ab}" for w in ("wq", "wk", "wv", "wo")
            for ab in "ab"}
    shared = {f"lora/moe/shared/{w}/{ab}"
              for w in ("w_gate", "w_up", "w_down") for ab in "ab"}
    assert lora == (attn | shared if arch == DEEPSEEK else attn)


def test_lm_loss_and_lkv_loss_with_gradients_match_jax():
    """deepseek: ``lm_loss`` (its ``aux`` now the routers' load-balance
    loss), ``lkv_loss`` and its gradient with respect to every lkv leaf
    (the attention and shared-expert LoRA and the rows) within 1e-4 of
    that leaf's largest gradient."""
    m = _model(DEEPSEEK)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    n_in = 40
    x, xy = jnp.asarray(toks[:, :n_in]), jnp.asarray(toks)
    jlm = jax.jit(lambda p, t: jobj.lm_loss(p, jcfg, t))(m["jp"], xy)
    tlm = tobj.lm_loss(m["tp"], tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(float(tlm), float(jlm), rtol=1e-5)
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda jl: jobj.lkv_loss(m["jp"], jcfg, jl, x, xy, n_in)[0]))(
        m["jl"])
    tt = torch.from_numpy(toks)
    tval, tgrads = steps.value_and_grad(
        lambda lkv: tobj.lkv_loss(m["tp"], tcfg, lkv, tt[:, :n_in], tt,
                                  n_in)[0], m["tl"])
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    want = jax.tree.map(np.asarray, jgrads)
    names = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert any("moe/shared" in n for n in names)
    for name, g, w in zip(names, tadam.leaves(tgrads), jax.tree.leaves(want)):
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert scale > 0, f"{name}: JAX gradient is zero"
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


def test_moe_trees_cross_checkpoints(tmp_path):
    """deepseek's parameter tree (a float32 router, 4-D bf16 experts) and
    its LoRA tree: JAX-written files load in the port bit for bit and the
    port's load back in JAX; a JAX-written ``--lkv-ckpt`` (the trainer
    state layout) loads as the same modules and serves JAX's tokens."""
    from repro.optim import adam as jadam

    jcfg = jax_smoke(DEEPSEEK)  # bf16: the served dtype
    jp = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    assert jp["layers"]["moe"]["router"].dtype == jnp.float32
    assert jp["layers"]["moe"]["experts"]["w_gate"].ndim == 4
    path = str(tmp_path / "params.npz")
    jckpt.save(path, jp)
    like = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    back = tckpt.load(path, like=like)
    for a, b in zip(tadam.leaves(like), tadam.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tpath = str(tmp_path / "port.npz")
    tckpt.save(tpath, back)
    again = jckpt.load(tpath, like=jax.tree.map(jnp.zeros_like, jp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(again)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    m = _model(DEEPSEEK)
    ck = str(tmp_path / "lkv.npz")
    jckpt.save(ck, {"lkv": m["jl"], "opt": jadam.init(m["jl"])},
               metadata={"step": 3})
    lkv = load_lookahead_params(ck, m["tcfg"], m["tp"]["layers"],
                                device="cpu")
    for a, b in zip(jax.tree.leaves(m["jl"]), tadam.leaves(lkv)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    prompts = np.random.default_rng(21).integers(0, 512, (2, 30)).astype(
        np.int32)
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jdone = JLockstep(m["jp"], m["jcfg"], policy="lookaheadkv",
                          evict=JEvict(budget=16), lkv_params=m["jl"],
                          max_new_tokens=5, eos_id=-1).serve(
            [JRequest(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)])
    tdone = ServingEngine(m["tp"], m["tcfg"], policy="lookaheadkv",
                          evict=TEvict(budget=16), lkv_params=lkv,
                          max_new_tokens=5, eos_id=-1, device="cpu").serve(
        [Request(uid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]


@pytest.mark.parametrize("arch,route,engine", [
    (DEEPSEEK, [], "ServingEngine:"),
    (DEEPSEEK, ["--continuous"], "ContinuousEngine:"),
    (DEEPSEEK, ["--continuous", "--kv-pool-mb", "1"],
     "ContinuousEngine (paged):"),
    (DEEPSEEK, ["--continuous", "--policy", "full"], "BucketedEngine:"),
    (PHI, [], "ServingEngine:"),
])
def test_launcher_serves_moe_on_each_route(arch, route, engine, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--budget", "16", "--chunk", "32", "--requests", "3",
                "--n-in", "48", "--max-new", "4"] + route)
    out = capsys.readouterr().out
    assert out.startswith(engine) and "requests=3" in out, out
    assert out.count("4 tokens") == 3
