"""The JAX package's single-device training step on the embedding-input
(qwen2-vl) and encoder-decoder (whisper) archs, and the numpy-seeded
batches the port's tests hold their steps to it on.

JAX's ``launch/steps.py::make_train_step`` computes its gradient inside
the step and returns only the updated modules, Adam's state and the
loss.  ``jax_step`` runs that step, jitted, and beside it, in the same
compiled program, ``jax.value_and_grad`` of ``jax_loss``: the step's own
loss function for the batch's arch, so that every gradient leaf can be
held too (the tests also hold the two losses to each other).
"""

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import objective as jobj
from repro.core.scoring import normalize_l1
from repro.launch import steps as jsteps
from repro.optim import adam as jadam

#: the M-RoPE grid of ``vlm_batch``: text tokens, then an image of
#: ``GRID`` (rows, columns) patches at one temporal position
TEXT, GRID = 8, (4, 8)


def mrope_grid(B: int) -> np.ndarray:
    """(3, B, TEXT + rows * cols) M-RoPE streams of a text prefix (t == h
    == w == its position) followed by an image whose patches share one
    temporal position and take their row and column after the text
    (Qwen2-VL's layout)."""
    rows, cols = GRID
    t = np.arange(TEXT)
    r, c = np.divmod(np.arange(rows * cols), cols)
    pos = np.stack([np.concatenate([t, np.full(rows * cols, TEXT)]),
                    np.concatenate([t, TEXT + r]),
                    np.concatenate([t, TEXT + c])])
    return np.repeat(pos[:, None], B, axis=1).astype(np.int32)


def vlm_batch(cfg, B: int, n_out: int, seed: int) -> dict:
    """{"x" (B, n_in, D) patch embeddings at the embedding table's scale,
    "y" (B, n_out) response tokens, "mrope" (3, B, n_in)}, numpy, n_in =
    ``TEXT`` + the grid's patches."""
    rng = np.random.default_rng(seed)
    mrope = mrope_grid(B)
    n_in = mrope.shape[2]
    return {"x": (rng.normal(size=(B, n_in, cfg.d_model)) * 0.02).astype(
                np.float32),
            "y": rng.integers(0, cfg.vocab_size, (B, n_out)).astype(
                np.int32),
            "mrope": mrope}


def whisper_batch(cfg, B: int, n_in: int, n_out: int, seed: int) -> dict:
    """{"x" (B, n_in), "xy" (B, n_in + n_out) tokens, "frames" (B, F, D)
    encoder frames}, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n_in + n_out)).astype(
        np.int32)
    frames = rng.normal(size=(B, cfg.encoder.num_frames, cfg.d_model))
    return {"x": toks[:, :n_in], "xy": toks,
            "frames": frames.astype(np.float32)}


def jax_loss(jcfg, jp, batch: dict):
    """The loss function of JAX's ``make_train_step`` (``lkv_step``) or
    ``make_distill_step`` for ``batch`` (jnp arrays), as a function of
    the modules."""
    if "s_gt" in batch:
        return lambda jl: jobj.lkv_loss_from_targets(
            jp, jcfg, jl, batch["x"], batch["s_gt"])[0]
    if jcfg.embeds_in:
        x = batch["x"]
        y_emb = jnp.take(jp["embed"], batch["y"], axis=0)
        xy = jnp.concatenate([x.astype(y_emb.dtype), y_emb], axis=1)

        def loss(jl):
            s_gt = jobj.gt_scores(jp, jcfg, xy, x.shape[1],
                                  mrope_positions=None)
            s_lkv = jobj.lookahead_scores(jp, jcfg, jl, x,
                                          mrope_positions=batch.get("mrope"))
            return jobj.kl_divergence(normalize_l1(s_gt),
                                      normalize_l1(s_lkv)).mean()

        return loss
    kw = ({"encoder_embeds": batch["frames"]} if jcfg.is_encoder_decoder
          else {})
    return lambda jl: jobj.lkv_loss(jp, jcfg, jl, batch["x"], batch["xy"],
                                    batch["x"].shape[1], **kw)[0]


def jax_step(jcfg, jp, jl, batch: dict, tc) -> dict:
    """JAX's loss, gradients, global norm and one step of
    ``jax.jit(make_train_step)`` (``make_distill_step`` for a batch with
    "s_gt"), in one compiled program; numpy results and the leaves'
    names."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    make = (jsteps.make_distill_step if "s_gt" in batch
            else jsteps.make_train_step)
    step = make(jcfg, tc)
    loss = jax_loss(jcfg, jp, jb)

    @jax.jit
    def run(jl, opt):
        val, grads = jax.value_and_grad(loss)(jl)
        _, norm = jadam.clip_by_global_norm(grads, 1.0)
        return val, grads, norm, step(jp, jl, opt, jb)

    val, grads, norm, (lkv, opt, step_loss) = run(jl, jadam.init(jl))
    leaves = jax.tree.leaves
    return dict(loss=float(val), step_loss=float(step_loss),
                norm=float(norm),
                grads=[np.asarray(g) for g in leaves(grads)],
                lkv=[np.asarray(g) for g in leaves(lkv)],
                mu=[np.asarray(g) for g in leaves(opt.mu)],
                nu=[np.asarray(g) for g in leaves(opt.nu)],
                names=["/".join(str(k.key) for k in p) for p, _ in
                       jax.tree_util.tree_flatten_with_path(grads)[0]])


#: the LoRA leaves of whisper's cross ``wk`` / ``wv``, which neither
#: package applies (the cross K/V are the encoder's, without LoRA)
UNUSED = ("lora/cross/wk/a", "lora/cross/wk/b", "lora/cross/wv/a",
          "lora/cross/wv/b")


def assert_step_matches(got: dict, want: dict, lr: float, label: str = ""
                        ) -> None:
    """The port's one step (``got``: {"loss", "grads", "mu", "nu", "lkv"},
    numpy leaves in ``adam.leaves`` order) against ``jax_step``'s at the
    mesh test's tolerances: the loss within 1e-5 relative (and JAX's two
    losses to each other), each gradient leaf within 1e-4 of its largest
    JAX value (nonzero), ``m`` within 2e-4 and ``v`` within 4e-4, the
    updated modules within 1e-6 where JAX's gradient exceeds 1e-3 of its
    leaf's largest, elsewhere within 2 x lr; the ``UNUSED`` leaves zero
    in both."""
    np.testing.assert_allclose(want["step_loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for i, name in enumerate(want["names"]):
        g_want = want["grads"][i]
        if name in UNUSED:  # no pass applies it: zeros in both packages
            for what in ("grads", "mu", "nu"):
                assert not want[what][i].any(), (label, name, what)
                assert not got[what][i].any(), (label, name, what)
            err = np.abs(got["lkv"][i] - want["lkv"][i]).max()
            assert err <= 1e-6, (label, name)
            continue
        scale = np.abs(g_want).max()
        assert scale > 0, f"{label} {name}: JAX gradient is zero"
        for what, rel in (("grads", 1e-4), ("mu", 2e-4), ("nu", 4e-4)):
            w = g_want if what == "grads" else want[what][i]
            assert got[what][i].shape == w.shape, (label, name, what)
            err = np.abs(got[what][i] - w).max()
            assert err <= rel * np.abs(w).max(), (label, name, what, err)
        big = np.abs(g_want) > 1e-3 * scale
        err = np.abs(got["lkv"][i] - want["lkv"][i])
        assert err[big].max() <= 1e-6, (label, name)
        assert err.max() <= 2 * lr, (label, name)
