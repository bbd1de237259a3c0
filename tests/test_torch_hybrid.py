"""Parity of the port's hybrid arch (hymba: attention and Mamba-2 heads in
every block) against the JAX package, on the CPU.

A float32 copy of hymba-smoke (2 layers, window 16 on layer 1, layer 0
global, SSM chunk 32) with the JAX parameters bridged leaf for leaf:

* ``tf.prefill`` of 2 x 45 tokens (longer than the window, not a multiple
  of the SSM chunk) under lookaheadkv (lookahead rows chained after the
  prompt in the SSM), gt_oracle (the SSM split at ``gt_boundary``), h2o,
  snapkv, pyramidkv, full, and without a policy but with
  ``want_ssm_cache``: logits, the attention cache (kept (layer, head,
  position) sets identical, k/v, pos, mask), the SSM cache (conv tail,
  state), cursor and positions;
* the lockstep ``ServingEngine`` under lookaheadkv and h2o against the
  JAX one: greedy tokens identical;
* the launcher's lockstep route on hymba-smoke, and the refusal of the
  continuous route and of the streaming prefill.

Tolerances: logits, k/v and the SSM cache 1e-4 (float32, other summation
orders); kept sets, positions, masks, cursors and tokens identical.
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
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JLockstep
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig as TEvict
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import transformer as ttf
from repro_torch.serving import (ContinuousEngine, Request, ServingConfig,
                                 ServingEngine)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("hymba-1.5b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("hymba-1.5b"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    # LoRA b starts at zero; draw it so the selective-LoRA path matters
    rng = np.random.default_rng(7)
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


def test_hybrid_params_bridge_leaf_for_leaf(model):
    """The port's own init draws the JAX package's tree: same leaves,
    shapes and types (A_log, D_skip and dt_bias float32 among the rest)."""
    tp = ttf.init_params(dataclasses.replace(model["tcfg"],
                                             dtype="bfloat16"),
                         seed=0, device="cpu")
    jp = jtf.init_params(jax.random.PRNGKey(0),
                         dataclasses.replace(model["jcfg"], dtype="bfloat16"))
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    tshapes = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[-1]), tp)
    assert tshapes == jshapes
    assert tshapes["layers"]["ssm"]["A_log"][1] == "float32"
    bridged = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    assert bridged["layers"]["ssm"]["dt_bias"].dtype == torch.float32
    assert bridged["layers"]["ssm"]["in_proj"].dtype == torch.bfloat16


# policy -> prefill keywords beyond the policy itself
_POLICIES = {
    "lookaheadkv": {},
    "gt_oracle": dict(gt_boundary=37),
    "h2o": {},
    "snapkv": {},
    "pyramidkv": {},
    "full": {},
}


@pytest.mark.parametrize("policy", list(_POLICIES))
def test_hybrid_prefill_matches_jax(model, policy):
    rng = np.random.default_rng(len(policy))
    tokens = rng.integers(0, 512, (2, 45)).astype(np.int32)
    kw = _POLICIES[policy]
    lkv = policy == "lookaheadkv"
    jr = jtf.prefill(model["jp"], model["jcfg"], jnp.asarray(tokens),
                     lkv_params=model["jl"] if lkv else None, policy=policy,
                     evict=JEvict(budget=16), extra_slots=5, **kw)
    tr = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(tokens),
                     lkv_params=model["tl"] if lkv else None, policy=policy,
                     evict=TEvict(budget=16), extra_slots=5, **kw)
    assert set(tr.cache) == set(jr.cache) == {"attn", "cursor", "ssm",
                                              "next_pos"}
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **TOL)
    ja = {k: np.asarray(v) for k, v in jr.cache["attn"].items()}
    ta = {k: v.numpy() for k, v in tr.cache["attn"].items()}
    assert ta["mask"].shape == ja["mask"].shape
    assert _kept(ta["mask"], ta["pos"]) == _kept(ja["mask"], ja["pos"])
    np.testing.assert_array_equal(ta["mask"], ja["mask"])
    np.testing.assert_array_equal(ta["pos"], ja["pos"])
    np.testing.assert_allclose(ta["k"], ja["k"], **TOL)
    np.testing.assert_allclose(ta["v"], ja["v"], **TOL)
    for name in ("conv", "state"):
        np.testing.assert_allclose(tr.cache["ssm"][name].numpy(),
                                   np.asarray(jr.cache["ssm"][name]), **TOL)
    assert tr.cache["cursor"] == int(jr.cache["cursor"])
    np.testing.assert_array_equal(tr.cache["next_pos"].numpy(),
                                  np.asarray(jr.cache["next_pos"]))


def test_hybrid_prefill_without_policy_keeps_ssm_cache(model):
    """policy None + want_ssm_cache: the SSM cache and positions only, and
    decode steps then run the SSM alone (no attention cache), as in
    JAX."""
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, 512, (2, 45)).astype(np.int32)
    jr = jtf.prefill(model["jp"], model["jcfg"], jnp.asarray(tokens),
                     want_ssm_cache=True)
    tr = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(tokens),
                     want_ssm_cache=True)
    assert set(tr.cache) == set(jr.cache) == {"ssm", "next_pos"}
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **TOL)
    for name in ("conv", "state"):
        np.testing.assert_allclose(tr.cache["ssm"][name].numpy(),
                                   np.asarray(jr.cache["ssm"][name]), **TOL)
    tok = np.asarray(jnp.argmax(jr.logits, -1)[:, None]).astype(np.int32)
    jl, _ = jtf.decode_step(model["jp"], model["jcfg"], jnp.asarray(tok),
                            jr.cache)
    tl, _ = ttf.decode_step(model["tp"], model["tcfg"],
                            torch.from_numpy(tok), tr.cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("policy", ["lookaheadkv", "h2o"])
def test_hybrid_lockstep_engine_matches_jax(model, policy):
    rng = np.random.default_rng(17)
    n_in, max_new = 45, 7
    prompts = [rng.integers(0, 512, n_in).astype(np.int32) for _ in range(3)]
    lkv = policy == "lookaheadkv"
    with warnings.catch_warnings():  # the JAX lockstep engine is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JLockstep(model["jp"], model["jcfg"], policy=policy,
                         evict=JEvict(budget=16),
                         lkv_params=model["jl"] if lkv else None,
                         max_new_tokens=max_new, eos_id=-1)
    jdone = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=max_new)
                        for i, p in enumerate(prompts)])
    teng = ServingEngine(model["tp"], model["tcfg"], policy=policy,
                         evict=TEvict(budget=16),
                         lkv_params=model["tl"] if lkv else None,
                         max_new_tokens=max_new, eos_id=-1, device="cpu")
    tdone = teng.serve([Request(uid=i, prompt=p, max_new_tokens=max_new)
                        for i, p in enumerate(prompts)])
    for j, t in zip(jdone, tdone):
        assert t.out_tokens == j.out_tokens, f"uid {t.uid}: tokens diverged"
        assert len(t.out_tokens) == max_new and t.done


def test_hybrid_launcher_lockstep_and_refusals(model, capsys):
    serve.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                "--budget", "16", "--requests", "2", "--n-in", "40",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "ServingEngine" in out and "requests=2" in out
    assert out.count("4 tokens") == 2
    with pytest.raises(ValueError, match="attention-only"):
        serve.run(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                   "--continuous", "--kv-pool-mb", "1"])
    with pytest.raises(ValueError, match="attention-only"):
        ContinuousEngine(model["tp"], model["tcfg"], ServingConfig(),
                         lkv_params=model["tl"], device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        ttf.init_chunk_state(model["tcfg"], "lookaheadkv", 1, 64,
                             device="cpu")
    assert not ttf.chunkable(model["tcfg"])
    assert not jtf.chunkable(model["jcfg"])
