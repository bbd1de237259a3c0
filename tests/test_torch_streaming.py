"""The port's streaming tier of the plain route against the JAX package's
(``repro/kernels/ops.py``: ``_chunked_attention``,
``_chunked_lookahead_score``, ``_paged_decode_streaming``,
``paged_decode_path``), on the CPU in float32, inputs from numpy seeds.

Tolerances (float32 throughout):

* forward results within 2e-5 of the JAX result's largest magnitude (the
  same online-softmax recurrence over the same tiles; the two differ in
  summation order only);
* gradients of ``ref.ChunkedAttention`` within 1e-4 of each gradient's
  largest magnitude, against ``jax.grad`` through ``_chunked_attention``
  and against torch autograd through the direct ``ref.attention``;
* ``lkv_loss`` within 1e-5 relative and every lkv leaf's gradient within
  1e-4 of that leaf's largest, against ``jax.value_and_grad`` of JAX's
  ``lkv_loss``, on llama3-smoke at n_in 2,100 (both packages stream);
* below ``ref.DIRECT_SEQ`` keys the public entries are bitwise the direct
  plain forms, and the ``meta`` device keeps the direct form at any
  length; nothing the streaming attention saves for its backward is as
  large as one head's (Sq, Sk) block.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import objective as jobj
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import objective as tobj
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.optim import adam as tadam

FWD_REL = 2e-5
GRAD_REL = 1e-4
H, KV, HD = 8, 2, 16  # GQA 4:1


def _close(got, want, rel, label=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, label
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{label}: {err} > {rel} * {scale}"


def _qkv(seed, B, Sq, Sk, heads=(H, KV, HD)):
    h, kv, hd = heads
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, h, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, kv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, kv, hd)).astype(np.float32))


# (label, Sq, Sk, causal, window, q_offset, masked, (H, KV, hd))
ATTENTION_CASES = (
    ("causal", 100, 100, True, None, 0, False, (H, KV, HD)),
    ("window", 100, 100, True, 24, 0, False, (H, KV, HD)),
    ("q_offset", 40, 100, True, None, 60, False, (H, KV, HD)),
    ("q_offset window", 40, 100, True, 30, 60, False, (H, KV, HD)),
    ("kv_mask", 100, 100, True, None, 0, True, (H, KV, HD)),
    ("Sq != Sk", 50, 90, False, None, 0, False, (H, KV, HD)),
    ("Sq != Sk kv_mask", 50, 90, False, None, 0, True, (H, KV, HD)),
    ("mha", 100, 100, True, None, 0, False, (4, 4, HD)),
)


def _attention_inputs(case):
    label, Sq, Sk, causal, window, off, masked, heads = case
    q, k, v = _qkv(1, 2, Sq, Sk, heads)
    mask = None
    if masked:
        mask = np.random.default_rng(2).random((2, Sk)) > 0.25
        mask[:, 0] = True  # every row keeps a valid key
    kw = dict(causal=causal, window=window, q_offset=off)
    return q, k, v, mask, kw


def _jax_chunked(q, k, v, mask, kw, block_q=16, block_k=32):
    return jops._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=None if mask is None else jnp.asarray(mask),
        block_q=block_q, block_k=block_k, **kw)


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=lambda c: c[0])
def test_chunked_attention_matches_jax(case):
    q, k, v, mask, kw = _attention_inputs(case)
    want = _jax_chunked(q, k, v, mask, kw)
    got = ref.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=None if mask is None else torch.from_numpy(mask),
        block_q=16, block_k=32, **kw)
    assert got.dtype == torch.float32
    _close(got, want, FWD_REL, case[0])


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=lambda c: c[0])
def test_chunked_attention_gradient_matches_jax_and_direct(case):
    q, k, v, mask, kw = _attention_inputs(case)
    Sq = q.shape[1]
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(
        _jax_chunked(q_, k_, v_, mask, kw) * g), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    tg = torch.from_numpy(g)
    out = ref.ChunkedAttention.apply(tq, tk, tv, kw["causal"], kw["window"],
                                     kw["q_offset"], tm, 16, 32)
    got = torch.autograd.grad((out * tg).sum(), (tq, tk, tv))
    q_pos = (kw["q_offset"] + torch.arange(Sq)).expand(q.shape[0], Sq)
    direct = torch.autograd.grad((ref.attention(
        tq, tk, tv, causal=kw["causal"], window=kw["window"], q_pos=q_pos,
        kv_mask=tm) * tg).sum(), (tq, tk, tv))
    for name, a, w, d in zip("qkv", got, want, direct):
        _close(a, w, GRAD_REL, f"{case[0]} d{name} vs jax")
        _close(a, d.numpy(), GRAD_REL, f"{case[0]} d{name} vs direct")


SCORE_B, SCORE_OBS, SCORE_SK = 2, 12, 150


def _score_inputs():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((SCORE_B, SCORE_OBS, H, HD)).astype(np.float32)
    k = rng.standard_normal((SCORE_B, SCORE_SK, KV, HD)).astype(np.float32)
    row_valid = rng.random((SCORE_B, SCORE_OBS)) > 0.3
    kv_mask = rng.random((SCORE_B, SCORE_SK - SCORE_OBS)) > 0.2
    return q, k, row_valid, kv_mask


# (label, reduce, n_prompt, q_offset, window, kv_mask, row_valid, traced)
SCORE_CASES = (
    ("mean", "mean", SCORE_SK - SCORE_OBS, None, None, False, False, False),
    ("mean masks", "mean", SCORE_SK - SCORE_OBS, None, None, True, True,
     False),
    ("mean window", "mean", SCORE_SK - SCORE_OBS, None, 40, False, False,
     False),
    ("mean traced offset", "mean", SCORE_SK, 110, None, False, True, True),
    ("mean traced offset window", "mean", SCORE_SK, 110, 33, False, False,
     True),
    ("sum", "sum", SCORE_SK, 100, None, False, True, True),
    ("sum window", "sum", SCORE_SK, 100, 30, False, True, False),
)


@pytest.mark.parametrize("case", SCORE_CASES, ids=lambda c: c[0])
def test_chunked_lookahead_score_matches_jax(case):
    label, reduce, n_prompt, off, window, masked, rows, traced = case
    q, k, row_valid, kv_mask = _score_inputs()
    km = kv_mask if masked else None
    rv = row_valid if rows else None

    def jax_score(offset):
        return jops._chunked_lookahead_score(
            jnp.asarray(q), jnp.asarray(k), n_prompt,
            kv_mask=None if km is None else jnp.asarray(km), window=window,
            q_offset=offset, block_k=32,
            row_valid=None if rv is None else jnp.asarray(rv), reduce=reduce)

    want = (jax.jit(jax_score)(jnp.int32(off)) if traced
            else jax_score(off))
    got = ref.chunked_lookahead_score(
        torch.from_numpy(q), torch.from_numpy(k), n_prompt,
        kv_mask=None if km is None else torch.from_numpy(km), window=window,
        q_offset=off, row_valid=None if rv is None else torch.from_numpy(rv),
        reduce=reduce, block_k=32)
    assert got.shape == (SCORE_B, H, n_prompt)
    _close(got, want, FWD_REL, label)


def _paged_inputs(nb=10, n_blocks=40, bs=16, seed=5):
    rng = np.random.default_rng(seed)
    B = 2
    k_pool = rng.standard_normal((n_blocks, bs, KV, HD)).astype(np.float32)
    v_pool = rng.standard_normal((n_blocks, bs, KV, HD)).astype(np.float32)
    mask_pool = rng.random((n_blocks, bs, KV)) > 0.3
    mask_pool[0] = False  # the null block
    pos_pool = rng.integers(0, nb * bs, (n_blocks, bs, KV)).astype(np.int32)
    table = rng.integers(1, n_blocks, (B, nb)).astype(np.int32)
    table[1, nb // 2:] = 0  # a ragged table
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    new_pos = np.array([nb * bs - 10, nb * bs - 1], np.int32)
    return q, k_pool, v_pool, mask_pool, table, pos_pool, new_pos


@pytest.mark.parametrize("masses", [False, True], ids=["out", "masses"])
@pytest.mark.parametrize("window", [None, 60], ids=["global", "window"])
def test_paged_decode_streaming_matches_jax(masses, window):
    q, kp, vp, mp, table, pp, new_pos = _paged_inputs()
    want = jops._paged_decode_streaming(
        *(jnp.asarray(x) for x in (q, kp, vp, mp, table)),
        pos_pool=jnp.asarray(pp), new_pos=jnp.asarray(new_pos),
        window=window, score_masses=masses)
    got = ref.paged_decode_streaming(
        *(torch.from_numpy(x) for x in (q, kp, vp, mp, table)),
        pos_pool=torch.from_numpy(pp), new_pos=torch.from_numpy(new_pos),
        window=window, score_masses=masses)
    if not masses:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w, name in zip(got, want, ("out", "masses")):
        _close(g, w, FWD_REL, name)


def test_paged_decode_path_matches_jax(monkeypatch):
    monkeypatch.delenv("REPRO_FORCE_PALLAS", raising=False)
    for span in (1, 16, ref.DIRECT_SEQ, ref.DIRECT_SEQ + 1, 32768):
        want = jops.paged_decode_path(span)
        assert ops.paged_decode_path(span, "cpu") == want, span
        # the meta device holds shapes only: always the direct form
        assert ops.paged_decode_path(span, "meta") == "gather"
        # a CUDA tensor goes to kernels 4 and 5 (JAX's Pallas tier) ...
        assert ops.paged_decode_path(span, "cuda") == "kernel"
        # ... and inside reference_mode() to the plain tiers
        with ops.reference_mode():
            assert ops.paged_decode_path(span, "cuda") == want
    assert jops._DIRECT_SEQ == ref.DIRECT_SEQ


# -- the public entries at Sk = DIRECT_SEQ + 256 (B 1, 2 heads of 16) ------

LONG = ref.DIRECT_SEQ + 256
LONG_HEADS = (2, 1, 16)


@pytest.fixture
def no_direct(monkeypatch):
    """The direct plain forms raise: a call above DIRECT_SEQ streams."""
    def refuse(*a, **kw):
        raise AssertionError("the direct form ran above DIRECT_SEQ")
    for name in ("attention", "flash_attention", "chunk_attention",
                 "lookahead_score", "chunk_column_masses",
                 "paged_decode_attention", "paged_decode_masses"):
        monkeypatch.setattr(ref, name, refuse)


# (label, Sq, causal, window, masked)
FLASH_LONG = (("causal", LONG, True, None, False),
              ("window", LONG, True, 300, False),
              ("kv_mask", LONG, True, None, True),
              ("Sq != Sk", 100, False, None, True))


@pytest.mark.parametrize("case", FLASH_LONG, ids=lambda c: c[0])
def test_flash_attention_streams_like_jax(case, no_direct):
    label, Sq, causal, window, masked = case
    q, k, v = _qkv(6, 1, Sq, LONG, LONG_HEADS)
    mask = None
    if masked:
        mask = np.random.default_rng(7).random((1, LONG)) > 0.3
        mask[:, 0] = True
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, kv_mask=None if mask is None else jnp.asarray(mask))
    got = ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want, FWD_REL, label)


@pytest.mark.parametrize("window", [None, 200], ids=["global", "window"])
def test_chunk_attention_and_masses_stream_like_jax(window, no_direct):
    C, off, n_total = 64, LONG - 104, LONG - 64
    q, k, v = _qkv(8, 1, C, LONG, LONG_HEADS)
    want = jops.chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=off,
        window=window, score_masses=True, n_total=n_total)
    got = ops.chunk_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=off, window=window, score_masses=True, n_total=n_total)
    _close(got[0], want[0], FWD_REL, "out")
    _close(got[1], want[1], FWD_REL, "masses")
    alone = ops.chunk_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=off, window=window)
    assert torch.equal(alone, got[0])


@pytest.mark.parametrize("masks", [False, True], ids=["plain", "masks"])
def test_lookahead_score_streams_like_jax(masks, no_direct):
    n_obs = 16
    n_prompt = LONG - n_obs
    q, k, _ = _qkv(9, 1, n_obs, LONG, LONG_HEADS)
    rng = np.random.default_rng(10)
    km = rng.random((1, n_prompt)) > 0.2 if masks else None
    rv = rng.random((1, n_obs)) > 0.3 if masks else None
    want = jops.lookahead_score(
        jnp.asarray(q), jnp.asarray(k), n_prompt,
        kv_mask=None if km is None else jnp.asarray(km),
        row_valid=None if rv is None else jnp.asarray(rv))
    got = ops.lookahead_score(
        torch.from_numpy(q), torch.from_numpy(k), n_prompt,
        kv_mask=None if km is None else torch.from_numpy(km),
        row_valid=None if rv is None else torch.from_numpy(rv))
    _close(got, want, FWD_REL, "scores")


@pytest.mark.parametrize("window", [None, 500], ids=["global", "window"])
def test_paged_decode_attention_streams_like_jax(window, no_direct):
    nb, bs = LONG // 16, 16
    q, kp, vp, mp, table, pp, new_pos = _paged_inputs(nb=nb, n_blocks=200,
                                                      seed=11)
    depth = LONG - 4
    jargs = [jnp.asarray(x) for x in (q, kp, vp, mp, table)]
    targs = [torch.from_numpy(x) for x in (q, kp, vp, mp, table)]
    want = jops.paged_decode_attention(
        *jargs, pos_pool=jnp.asarray(pp), new_pos=jnp.asarray(new_pos),
        window=window, depth=depth, score_masses=True)
    got = ops.paged_decode_attention(
        *targs, pos_pool=torch.from_numpy(pp),
        new_pos=torch.from_numpy(new_pos), window=window, depth=depth,
        score_masses=True)
    assert got[1].shape == (2, H, depth)
    _close(got[0], want[0], FWD_REL, "out")
    _close(got[1], want[1], FWD_REL, "masses")
    out = ops.paged_decode_attention(
        *targs, pos_pool=torch.from_numpy(pp),
        new_pos=torch.from_numpy(new_pos), window=window, depth=depth)
    assert torch.equal(out, got[0])


def test_entries_at_direct_seq_are_the_direct_forms():
    """At DIRECT_SEQ keys every public plain entry is bitwise the direct
    form it was before the streaming tier."""
    S = ref.DIRECT_SEQ
    q, k, v = (torch.from_numpy(x) for x in _qkv(12, 1, S, S, LONG_HEADS))
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v))
    qc = q[:, -32:]
    out, masses = ops.chunk_attention(qc, k, v, q_offset=S - 32,
                                      score_masses=True, n_total=S - 8)
    assert torch.equal(out, ref.chunk_attention(qc, k, v, q_offset=S - 32))
    rv = (S - 32 + torch.arange(32) < S - 8).expand(1, 32)
    assert torch.equal(masses, ref.chunk_column_masses(
        qc, k, q_offset=S - 32, row_valid=rv))
    assert torch.equal(ops.lookahead_score(qc, k, S - 32),
                       ref.lookahead_score(qc, k, S - 32))
    qd, kp, vp, mp, table, pp, new_pos = (torch.from_numpy(x) for x in
                                          _paged_inputs(nb=S // 16,
                                                        n_blocks=150))
    assert torch.equal(
        ops.paged_decode_attention(qd, kp, vp, mp, table),
        ref.paged_decode_attention(qd, kp, vp, mp, table))


def test_meta_device_keeps_the_direct_form(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the meta device streamed")
    monkeypatch.setattr(ref, "chunked_attention", refuse)
    monkeypatch.setattr(ref, "chunked_lookahead_score", refuse)
    monkeypatch.setattr(ref, "paged_decode_streaming", refuse)
    S = 2 * ref.DIRECT_SEQ
    q = torch.empty((1, S, 2, 16), device="meta")
    k = torch.empty((1, S, 1, 16), device="meta")
    assert ops.flash_attention(q, k, k).shape == q.shape
    assert ops.lookahead_score(q[:, -8:], k, S - 8).shape == (1, 2, S - 8)
    out, masses = ops.chunk_attention(q[:, -8:], k, k, q_offset=S - 8,
                                      score_masses=True)
    assert masses.shape == (1, 2, S)
    pool = torch.empty((S // 16 + 1, 16, 1, 16), device="meta")
    table = torch.zeros((1, S // 16), dtype=torch.int32, device="meta")
    mask = torch.empty((S // 16 + 1, 16, 1), dtype=torch.bool, device="meta")
    assert ops.paged_decode_attention(q[:, 0], pool, pool, mask,
                                      table).shape == (1, 2, 16)


def _saved_numels(fn):
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sizes


def test_streaming_attention_saves_no_sq_by_sk_tensor():
    S = LONG
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(13, 1, S, S, LONG_HEADS))
    out, sizes = _saved_numels(lambda: ops.flash_attention(q, k, v))
    assert sizes and max(sizes) < S * S, max(sizes)
    # what it saves: q, k, v, the output, and (m, l) per row
    assert sorted(sizes) == sorted([q.numel(), k.numel(), v.numel(),
                                    q.numel(), 2 * S, 2 * S])
    out.sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    # the direct form, by contrast, keeps whole (Sq, Sk) blocks per head
    qd, kd, vd = (x.detach()[:, :ref.DIRECT_SEQ].requires_grad_()
                  for x in (q, k, v))
    _, direct = _saved_numels(lambda: ops.flash_attention(qd, kd, vd))
    assert max(direct) >= ref.DIRECT_SEQ ** 2


# -- the distillation objective where both packages stream ----------------

N_IN, N_OUT = 2100, 64


@pytest.fixture(scope="module")
def long_model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(14)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    toks = np.random.default_rng(15).integers(
        0, jcfg.vocab_size, (1, N_IN + N_OUT)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv, toks=toks,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"),
                tl=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                   device="cpu"))


def test_lkv_loss_and_gradients_match_jax_when_streaming(long_model):
    m = long_model
    toks = m["toks"]
    assert N_IN + m["tcfg"].lookahead.n_lookahead > ref.DIRECT_SEQ
    x, xy = jnp.asarray(toks[:, :N_IN]), jnp.asarray(toks)
    val, want = jax.jit(jax.value_and_grad(lambda jl: jobj.lkv_loss(
        m["jp"], m["jcfg"], jl, x, xy, N_IN)[0]))(m["jl"])
    tt = torch.from_numpy(toks)
    loss, grads = steps.value_and_grad(
        lambda lkv: tobj.lkv_loss(m["tp"], m["tcfg"], lkv, tt[:, :N_IN], tt,
                                  N_IN)[0], m["tl"])
    np.testing.assert_allclose(float(loss), float(val), rtol=1e-5)
    names = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    for name, g, w in zip(names, tadam.leaves(grads),
                          jax.tree.leaves(want)):
        _close(g, np.asarray(w), GRAD_REL, name)
