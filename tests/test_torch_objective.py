"""The port's distillation objective and optimizer against the JAX
package's, on the CPU, below the JAX trainer's ``train.main`` (which
fails on a CPU host under its host mesh).

The same float32 llama3-8b smoke model (JAX parameters bridged, LoRA ``b``
drawn so that every leaf has a gradient) and the same numpy-seeded
tokens go through both packages:

* ``kl_divergence``: ``KL(p ‖ p) == 0`` exactly, non-negative, finite
  where q has no mass, equal to JAX's within 1e-6 relative;
* ``gt_scores`` and ``lookahead_scores``: every score within 1e-5 of its
  (layer, batch, head) row's largest, 1e-5 relative on the row sums;
* ``lkv_loss`` within 1e-5 relative, and its gradient with respect to
  every lkv leaf (``torch.autograd.grad`` through ``steps.value_and_grad``
  against ``jax.grad``) within 1e-4 of that leaf's largest gradient;
* ``lkv_loss_from_targets`` on JAX's targets, and ``lm_loss`` on
  mamba2-smoke, within 1e-5 relative;
* ``adam.update``: three steps (warmup, then the cosine, with and without
  clipping) within 1 ulp of JAX's parameters and moments (the gradients
  are multiples of 2^-6 of at most 16 such steps, so their squares sum
  exactly in any order: the global norm's float32 reduction order is
  XLA's own; ``clip_by_global_norm`` on random gradients is held to 1 ulp
  of the norm apart); ``cosine_lr`` equal in warmup and within one ulp of
  the peak rate on the cosine (the two float32 cosines differ by an ulp).
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JTrain
from repro.configs import get_smoke_config as jax_smoke
from repro.core import objective as jobj
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro.optim import adam as jadam
from repro_torch import bridge
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import objective as tobj
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.optim import adam as tadam

N_IN, N_OUT, B = 40, 8, 2


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    rng = np.random.default_rng(5)
    lkv = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
                      if str(p[-1].key) == "b" else x), lkv)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, N_IN + N_OUT)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params, jl=lkv, toks=toks,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"),
                tl=bridge.to_torch(jax.tree.map(np.asarray, lkv),
                                   device="cpu"))


@pytest.fixture(scope="module")
def jax_results(model):
    """JAX's scores, loss and gradients: two compiles."""
    jcfg, jp, jl, toks = model["jcfg"], model["jp"], model["jl"], \
        model["toks"]
    x, xy = jnp.asarray(toks[:, :N_IN]), jnp.asarray(toks)

    @jax.jit
    def scores(jl):
        return (jobj.gt_scores(jp, jcfg, xy, N_IN),
                jobj.lookahead_scores(jp, jcfg, jl, x))

    def loss(jl):
        return jobj.lkv_loss(jp, jcfg, jl, x, xy, N_IN)[0]

    s_gt, s_lkv = scores(jl)
    val, grads = jax.jit(jax.value_and_grad(loss))(jl)
    return dict(s_gt=np.asarray(s_gt), s_lkv=np.asarray(s_lkv),
                loss=float(val), grads=jax.tree.map(np.asarray, grads))


def _assert_rows_close(got, want, rel=1e-5):
    got = got.detach().numpy()
    tol = rel * np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    np.testing.assert_allclose(got.sum(-1), want.sum(-1), rtol=rel)


def test_kl_divergence_identities():
    rng = np.random.default_rng(0)
    p = rng.random((3, 4, 50)).astype(np.float32)
    p[..., :5] = 0.0  # zero-mass entries
    p /= p.sum(-1, keepdims=True)
    q = rng.random((3, 4, 50)).astype(np.float32)
    q[..., 10:15] = 0.0  # q without mass where p has some
    q /= q.sum(-1, keepdims=True)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    assert torch.equal(tobj.kl_divergence(tp, tp), torch.zeros(3, 4))
    kl = tobj.kl_divergence(tp, tq)
    assert torch.isfinite(kl).all() and (kl > 0).all()
    np.testing.assert_allclose(
        kl.numpy(), np.asarray(jobj.kl_divergence(jnp.asarray(p),
                                                  jnp.asarray(q))),
        rtol=1e-6)


def test_scores_match_jax(model, jax_results):
    tp, tcfg, toks = model["tp"], model["tcfg"], torch.from_numpy(
        model["toks"])
    s_gt = tobj.gt_scores(tp, tcfg, toks, N_IN)
    s_lkv = tobj.lookahead_scores(tp, tcfg, model["tl"], toks[:, :N_IN])
    L, H = tcfg.num_layers, tcfg.attn.num_heads
    assert s_gt.shape == s_lkv.shape == (L, B, H, N_IN)
    assert s_gt.dtype == s_lkv.dtype == torch.float32
    assert not s_gt.requires_grad
    _assert_rows_close(s_gt, jax_results["s_gt"])
    _assert_rows_close(s_lkv, jax_results["s_lkv"])


def test_loss_and_every_lkv_gradient_match_jax(model, jax_results):
    tp, tcfg, toks = model["tp"], model["tcfg"], torch.from_numpy(
        model["toks"])
    loss, grads = steps.value_and_grad(
        lambda lkv: tobj.lkv_loss(tp, tcfg, lkv, toks[:, :N_IN], toks,
                                  N_IN)[0], model["tl"])
    np.testing.assert_allclose(float(loss), jax_results["loss"], rtol=1e-5)
    want = jax_results["grads"]
    got = tadam.leaves(grads)
    names = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    for name, g, w in zip(names, got, jax.tree.leaves(want)):
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert scale > 0, f"{name}: JAX gradient is zero"
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


def test_loss_from_targets_matches_jax(model, jax_results):
    """Distillation against stored targets: JAX's own gt scores as the
    targets give JAX's loss, and the online loss (same targets)."""
    tp, tcfg, toks = model["tp"], model["tcfg"], torch.from_numpy(
        model["toks"])
    s_gt = np.array(jax_results["s_gt"])
    want, _ = jobj.lkv_loss_from_targets(
        model["jp"], model["jcfg"], model["jl"],
        jnp.asarray(model["toks"][:, :N_IN]), jnp.asarray(s_gt))
    loss, rep = tobj.lkv_loss_from_targets(tp, tcfg, model["tl"],
                                           toks[:, :N_IN],
                                           torch.from_numpy(s_gt))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(loss), jax_results["loss"], rtol=1e-5)
    assert rep.kl_per_layer.shape == (tcfg.num_layers,)


def test_lm_loss_matches_jax_on_mamba2():
    jcfg = dataclasses.replace(jax_smoke("mamba2-130m"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(2), jcfg)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    want = jax.jit(lambda p, t: jobj.lm_loss(p, jcfg, t))(
        params, jnp.asarray(toks))
    tp = bridge.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    got = tobj.lm_loss(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the LM step of the attention-free arch trains every parameter
    step = steps.make_train_step(
        dataclasses.replace(tcfg, technique_applies=False),
        TrainConfig(steps=10))
    new, opt, loss, metrics = step(tp, tadam.init(tp),
                                   {"xy": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert float(metrics["grad_norm"]) > 0 and int(opt.step) == 1
    assert not torch.equal(new["embed"], tp["embed"])


def test_reference_mode_nests_and_restores():
    assert not ops._REFERENCE_ONLY
    with ops.reference_mode():
        with ops.reference_mode():
            assert ops._REFERENCE_ONLY
        assert ops._REFERENCE_ONLY
    assert not ops._REFERENCE_ONLY
    with pytest.raises(KeyError):
        with ops.reference_mode():
            raise KeyError
    assert not ops._REFERENCE_ONLY


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

SHAPES = {"emb": (8, 128), "lora": {"wq": {"a": (2, 128, 4),
                                           "b": (2, 4, 128)},
                                    "w_down": {"a": (2, 384, 4),
                                               "b": (2, 4, 128)}}}


def _draw(rng, shapes, exact):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, exact) for k, v in shapes.items()}
    if exact:  # k / 64 with |k| <= 16: squares sum exactly in float32
        return (rng.integers(-16, 17, size=shapes) / 64.0).astype(np.float32)
    return rng.normal(size=shapes).astype(np.float32)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("steps_total,clip", [
    (200, 1.0),  # warmup of 4 steps: all three steps warm up, clipped
    (10, 1.0),  # warmup of 1 step, then the cosine, clipped
    (10, 100.0),  # unclipped
])
def test_adam_update_matches_jax_within_one_ulp(steps_total, clip):
    rng = np.random.default_rng(steps_total + int(clip))
    p = _draw(rng, SHAPES, exact=False)
    jtc = JTrain(steps=steps_total, lr=1e-3, grad_clip=clip)
    ttc = TrainConfig(steps=steps_total, lr=1e-3, grad_clip=clip)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
    js, ts = jadam.init(jp), tadam.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
    for _ in range(3):
        g = _draw(rng, SHAPES, exact=True)
        jp, js, jm = jadam.update(jp, jax.tree.map(jnp.asarray, g), js, jtc)
        tp, ts, tm = tadam.update(tp, jax.tree.map(torch.from_numpy, g), ts,
                                  ttc)
        assert _ulps(jm["grad_norm"], tm["grad_norm"]) == 0
        assert _ulps(jm["lr"], tm["lr"]) <= 1
        if clip == 1.0:
            assert float(tm["grad_norm"]) > clip  # clipping is active
        for j, t in zip(jax.tree.leaves((jp, js.mu, js.nu)),
                        tadam.leaves(tp) + tadam.leaves(ts.mu)
                        + tadam.leaves(ts.nu)):
            assert t.dtype == torch.float32
            assert _ulps(j, t.numpy()) <= 1
    assert int(ts.step) == int(js.step) == 3


def test_adam_keeps_bf16_params_and_float32_moments():
    p = {"w": torch.randn(4, 8, generator=torch.Generator().manual_seed(0)
                          ).to(torch.bfloat16)}
    st = tadam.init(p)
    assert st.mu["w"].dtype == torch.float32
    new, st, _ = tadam.update(p, {"w": torch.ones(4, 8)}, st,
                              TrainConfig(steps=10))
    assert new["w"].dtype == torch.bfloat16
    assert st.nu["w"].dtype == torch.float32


def test_global_norm_within_one_ulp_of_jax():
    rng = np.random.default_rng(11)
    for _ in range(20):
        g = _draw(rng, SHAPES, exact=False)
        _, jn = jadam.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        _, tn = tadam.clip_by_global_norm(jax.tree.map(torch.from_numpy, g),
                                          1.0)
        assert _ulps(jn, tn.numpy()) <= 1


@pytest.mark.parametrize("steps_total,lr", [(200, 1e-3), (10, 1e-3),
                                            (1000, 3e-4), (37, 2e-2)])
def test_cosine_lr_matches_jax(steps_total, lr):
    jtc, ttc = JTrain(steps=steps_total, lr=lr), TrainConfig(
        steps=steps_total, lr=lr)
    warmup = max(int(ttc.warmup_frac * steps_total), 1)
    at = sorted({0, warmup - 1, warmup, warmup + 1, steps_total // 2,
                 steps_total - 1, steps_total, steps_total + 1})
    for s in at:
        want = np.float32(jadam.cosine_lr(jnp.int32(s), jtc))
        got = tadam.cosine_lr(torch.tensor(s, dtype=torch.int32),
                              ttc).numpy()
        if s < warmup:
            assert got == want, s
        else:
            assert abs(float(got) - float(want)) <= np.spacing(
                np.float32(lr)), s
