"""The draft-based baselines and the bucket-padded prefill of the port
against the JAX package, on the CPU.

* Kernel 7's key mask: the plain version (``ref.flash_attention(
  kv_mask=)``, the CPU route of ``ops.flash_attention``) against the JAX
  package's ``ops.flash_attention(kv_mask=)`` (its direct softmax, and
  its online-softmax scan past 2048 keys), at ragged S and GQA, with
  masks under which every row keeps a valid key.
* ``transformer.prefill(prompt_lens=)`` against the JAX package's under
  lookaheadkv (uniform and adaptive budgets), the window policies, h2o
  and the position policies: logits, kept (layer, kv head, position) sets
  and ``next_pos``; and against the port's own unpadded prefill of each
  row (the port's ``test_padded_prefill_parity``).
* ``policies.run_eviction`` for ``laq`` and for ``speckv`` with a
  ``tiny-llama-smoke`` draft model: the draft tokens (each policy's
  first two passes run step by step in both packages), the logits and
  the kept sets.
* What the padded prefill and the draft-based policies refuse.

Float32 smoke configs; inputs from numpy seeds.  Tolerances: attention
outputs 1e-5 (float32, other summation orders), logits 1e-4 (a few
layers of them); kept sets, draft tokens and positions identical.
"""

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
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig as TEvict
from repro_torch.configs import get_smoke_config
from repro_torch.core import policies as tpol
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttf

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BUDGET = 16


def _kept(mask, pos):
    """{(layer, batch row, kv head): kept positions} of an (L, B, C, KV)
    cache."""
    L, B, _, KV = mask.shape
    return {(lyr, b, h): frozenset(pos[lyr, b, mask[lyr, b, :, h], h].tolist())
            for lyr in range(L) for b in range(B) for h in range(KV)}


def _cache_kept(cache):
    a = cache["attn"]
    return _kept(np.asarray(a["mask"]), np.asarray(a["pos"]))


# ---------------------------------------------------------------------------
# kernel 7 under a key mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,KV,hd,lens,n_obs,causal", [
    (2, 37, 4, 2, 16, (20, 37), 0, True),  # ragged S, GQA 2
    (3, 50, 6, 2, 8, (1, 33, 45), 5, True),  # observation rows at the tail
    (2, 29, 3, 3, 16, (29, 10), 0, False),  # every key visible, GQA 1
    (1, 2100, 2, 1, 16, (1500,), 8, True),  # the JAX package's scan
])
def test_masked_flash_attention_matches_jax(B, S, H, KV, hd, lens, n_obs,
                                            causal):
    rng = np.random.default_rng(S)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    j = np.arange(S)
    mask = (j < np.asarray(lens)[:, None]) | (j >= S - n_obs)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              kv_mask=torch.from_numpy(mask))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                kv_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# bucket-padded prefill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    # LoRA b starts at zero; draw it so the selective-LoRA path matters
    rng = np.random.default_rng(21)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"),
                tl=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                   device="cpu"))


LENS = (30, 48, 41)  # one row fills the 48-token bucket


def _padded_tokens(seed=4, lens=LENS, bucket=48):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 512, n)
    return toks


@pytest.mark.parametrize("policy,head_alloc", [
    ("lookaheadkv", "uniform"), ("lookaheadkv", "adaptive"),
    ("snapkv", "uniform"), ("pyramidkv", "uniform"), ("tova", "uniform"),
    ("h2o", "uniform"), ("full", "uniform"), ("streaming_llm", "uniform"),
    ("random", "uniform"),
])
def test_padded_prefill_matches_jax(model, policy, head_alloc):
    toks = _padded_tokens()
    seeds = np.asarray([5, 6, 7], np.int32)
    lkv = policy == "lookaheadkv"
    jr = jtf.prefill(model["jp"], model["jcfg"], jnp.asarray(toks),
                     policy=policy, lkv_params=model["jl"] if lkv else None,
                     evict=JEvict(budget=BUDGET, head_alloc=head_alloc),
                     extra_slots=3, prompt_lens=jnp.asarray(LENS),
                     seeds=jnp.asarray(seeds))
    tr = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(toks),
                     policy=policy, lkv_params=model["tl"] if lkv else None,
                     evict=TEvict(budget=BUDGET, head_alloc=head_alloc),
                     extra_slots=3, prompt_lens=torch.tensor(LENS),
                     seeds=torch.from_numpy(seeds))
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **LOGIT_TOL)
    assert _cache_kept(tr.cache) == _cache_kept(jr.cache)
    assert tr.cache["next_pos"].tolist() == np.asarray(
        jr.cache["next_pos"]).tolist() == [[n] for n in LENS]
    assert tr.cache["cursor"] == int(jr.cache["cursor"])


@pytest.mark.parametrize("policy", ["lookaheadkv", "full", "streaming_llm"])
def test_padded_prefill_equals_unpadded(model, policy):
    """Bucket padding changes nothing for lookaheadkv and the position
    policies: each padded row has its unpadded prefill's next-token
    logits and kept sets, and its true length as ``next_pos``."""
    toks = _padded_tokens(seed=8, lens=(10, 16), bucket=16)
    lkv = model["tl"] if policy == "lookaheadkv" else None
    ev = TEvict(budget=8)
    pad = ttf.prefill(model["tp"], model["tcfg"], torch.from_numpy(toks),
                      policy=policy, evict=ev, lkv_params=lkv,
                      extra_slots=2, prompt_lens=torch.tensor([10, 16]))
    for i, n in enumerate((10, 16)):
        exact = ttf.prefill(model["tp"], model["tcfg"],
                            torch.from_numpy(toks[i:i + 1, :n]),
                            policy=policy, evict=ev, lkv_params=lkv,
                            extra_slots=2)
        torch.testing.assert_close(pad.logits[i], exact.logits[0],
                                   **LOGIT_TOL)
        a, e = pad.cache["attn"], exact.cache["attn"]
        cap = e["mask"].shape[2]
        assert not a["mask"][:, i, cap:].any()  # full: shallower exact cache
        assert _kept(a["mask"][:, i:i + 1, :cap].numpy(),
                     a["pos"][:, i:i + 1, :cap].numpy()) == _kept(
            e["mask"].numpy(), e["pos"].numpy())
        assert int(pad.cache["next_pos"][i, 0]) == n


def test_padded_prefill_refusals(model):
    tok = torch.zeros((2, 8), dtype=torch.int32)
    lens = torch.tensor([5, 8])
    with pytest.raises(ValueError, match="exclusive"):
        ttf.prefill(model["tp"], model["tcfg"], tok, policy="gt_oracle",
                    gt_boundary=4, prompt_lens=lens)
    hcfg = dataclasses.replace(get_smoke_config("hymba-1.5b"),
                               dtype="float32")
    with pytest.raises(ValueError, match="attention-only"):
        ttf.prefill({}, hcfg, tok, prompt_lens=lens)
    for policy in ("laq", "speckv"):
        with pytest.raises(ValueError, match="policies.run_eviction"):
            ttf.prefill(model["tp"], model["tcfg"], tok, policy=policy)
        with pytest.raises(ValueError, match="bucket-padded"):
            tpol.run_eviction(policy, model["tp"], model["tcfg"], tok,
                              evict=TEvict(budget=4), prompt_lens=lens)


# ---------------------------------------------------------------------------
# LAQ and SpecKV
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def draft():
    """tiny-llama-smoke (vocabulary 512, as llama3-8b's smoke config) as
    SpecKV's draft model."""
    jcfg = dataclasses.replace(jax_smoke("tiny-llama"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("tiny-llama"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"))


def _drafts(policy, model, draft, toks, draft_len):
    """Each package's draft tokens (B, draft_len): the policy's first two
    passes, step by step."""
    if policy == "laq":
        jp, jcfg, tp, tcfg = model["jp"], model["jcfg"], model["tp"], \
            model["tcfg"]
        kw = dict(policy="snapkv")
    else:
        jp, jcfg, tp, tcfg = draft["jp"], draft["jcfg"], draft["tp"], \
            draft["tcfg"]
        kw = dict(policy="full")
    jr = jtf.prefill(jp, jcfg, jnp.asarray(toks), extra_slots=draft_len + 1,
                     evict=JEvict(budget=BUDGET) if policy == "laq" else None,
                     **kw)
    jd, _ = jpol.greedy_decode(
        jp, jcfg, jnp.argmax(jr.logits, -1)[:, None].astype(jnp.int32),
        jr.cache, draft_len)
    tr = ttf.prefill(tp, tcfg, torch.from_numpy(toks),
                     extra_slots=draft_len + 1,
                     evict=TEvict(budget=BUDGET) if policy == "laq" else None,
                     **kw)
    td, _ = tpol.greedy_decode(
        tp, tcfg, torch.argmax(tr.logits, -1)[:, None].to(torch.int32),
        tr.cache, draft_len)
    return np.asarray(jd), td.numpy()


@pytest.mark.parametrize("policy", ["laq", "speckv"])
def test_draft_policies_match_jax(model, draft, policy):
    toks = np.random.default_rng(6).integers(0, 512, (2, 40)).astype(np.int32)
    draft_len = 6
    jd, td = _drafts(policy, model, draft, toks, draft_len)
    np.testing.assert_array_equal(td, jd)
    kw = dict(extra_slots=4)
    jr = jpol.run_eviction(policy, model["jp"], model["jcfg"],
                           jnp.asarray(toks),
                           evict=JEvict(budget=BUDGET, draft_len=draft_len),
                           draft_params=draft["jp"], draft_cfg=draft["jcfg"],
                           **kw)
    tr = tpol.run_eviction(policy, model["tp"], model["tcfg"],
                           torch.from_numpy(toks),
                           evict=TEvict(budget=BUDGET, draft_len=draft_len),
                           draft_params=draft["tp"], draft_cfg=draft["tcfg"],
                           **kw)
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **LOGIT_TOL)
    assert _cache_kept(tr.cache) == _cache_kept(jr.cache)
    assert tr.cache["next_pos"].tolist() == [[40], [40]]
    # the rescoring prefill's cache is the gt_oracle prefill's over
    # [prompt; draft]
    xy = torch.from_numpy(np.concatenate([toks, td], axis=1))
    gt = ttf.prefill(model["tp"], model["tcfg"], xy, policy="gt_oracle",
                     gt_boundary=40, evict=TEvict(budget=BUDGET), **kw)
    assert _cache_kept(gt.cache) == _cache_kept(tr.cache)


def test_speckv_needs_a_draft_model(model):
    tok = torch.zeros((1, 20), dtype=torch.int32)
    with pytest.raises(ValueError, match="speckv needs a draft model"):
        tpol.run_eviction("speckv", model["tp"], model["tcfg"], tok,
                          evict=TEvict(budget=4, draft_len=2))
