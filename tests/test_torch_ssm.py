"""Parity of the port's Mamba-2 pieces against the JAX package, on the CPU:
the SSD scan's plain versions (kernel 8's yardstick), the single-token
step, the Mamba-2 block, and mamba2's prefill + decode.

Inputs are drawn with numpy from a seed and handed to both packages; the
model tests use float32 copies of the smoke configs with the JAX
parameters bridged leaf for leaf.

* ``ref.ssd_scan_chunked`` (and ``ops.ssd_scan`` on CPU tensors) against
  the JAX Pallas kernel in interpret mode where it runs (S a multiple of
  the chunk, nh a multiple of its head block), and against the JAX chunked
  fallback and the sequential oracle at ragged S and odd head counts
  (hymba-1.5b has 50), with and without an initial state;
* ``ops.ssd_step`` against JAX's;
* ``ssm.apply`` (one segment, then a second chained on its conv tail and
  state) and ``ssm.step`` on mamba2-smoke and hymba-smoke;
* ``prefill(want_ssm_cache=True)`` + 8 ``decode_step``s of mamba2-smoke:
  logits close, greedy tokens identical; the engines' and the launcher's
  refusal of an arch without attention.

Tolerances: the scan 2e-4 against Pallas and the chunked fallback (float32,
other summation orders over up to 5 chunks) and 1e-3 against the
sequential oracle (another algorithm: the exponent clip and the chunked
decay products round differently; the JAX package's own test takes 2e-3);
model outputs, caches and logits 1e-4 (float32); tokens identical.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as sk
from repro_torch.launch import serve
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serving import ServingEngine

from conftest import sweep_cases

TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_TOL = dict(atol=2e-4, rtol=2e-4)
ORACLE_TOL = dict(atol=1e-3, rtol=1e-3)


def _scan_inputs(seed, B, S, nh, hd, ds, dtype=np.float32):
    """x, dt (softplus'd), A (negative), B, C, h0 as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, nh, hd)).astype(dtype)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(nh,)) * 0.5)).astype(np.float32)
    Bm = rng.normal(size=(B, S, 1, ds)).astype(dtype)
    Cm = rng.normal(size=(B, S, 1, ds)).astype(dtype)
    h0 = rng.normal(size=(B, nh, hd, ds)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _ssd_case(rng):
    """The JAX package's sweep (tests/test_kernels.py): whole chunks."""
    hd = int(rng.choice([16, 32]))
    nh = int(rng.choice([2, 4, 8]))
    ds = int(rng.choice([8, 16]))
    chunk = int(rng.choice([16, 32]))
    nc = int(rng.integers(1, 5))
    return dict(B=int(rng.integers(1, 3)), S=chunk * nc, nh=nh, hd=hd, ds=ds,
                chunk=chunk, seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("case", sweep_cases(15, 4, _ssd_case))
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_chunked_matches_pallas_interpret(case, with_state):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(case["seed"], case["B"], case["S"],
                                        case["nh"], case["hd"], case["ds"])
    h0 = h0 if with_state else None
    jy, jh = ssd_scan_pallas(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm), chunk=case["chunk"], block_nh=min(2, case["nh"]),
        initial_state=None if h0 is None else jnp.asarray(h0),
        interpret=True)
    ty, th = ref.ssd_scan_chunked(
        *_t(x, dt, A, Bm, Cm), chunk=case["chunk"],
        initial_state=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk", [
    (2, 45, 5, 16, 8, 16),  # ragged tail, odd head count
    (1, 7, 3, 32, 16, 32),  # S < chunk
    (2, 1, 5, 16, 8, 32),  # one row
    (1, 70, 7, 16, 16, 32),  # two whole chunks and a ragged one, 7 heads
    (1, 40, 50, 16, 8, 32),  # hymba-1.5b's 50 heads (narrow)
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_ragged_and_odd_heads_match_jax(B, S, nh, hd, ds, chunk,
                                                 with_state):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(S * 31 + nh, B, S, nh, hd, ds)
    h0 = h0 if with_state else None
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    jy, jh = jops.ssd_scan_chunked_jnp(*jargs, chunk=chunk, initial_state=jh0)
    oy, oh = jref.ssd_scan(*jargs, initial_state=jh0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    ty, th = ref.ssd_scan_chunked(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                                  initial_state=th0)
    assert ty.shape == (B, S, nh, hd) and th.shape == (B, nh, hd, ds)
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(oy), **ORACLE_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(oh), **ORACLE_TOL)
    # the port's own oracle, and the CPU dispatch of ops.ssd_scan
    sy, sh = ref.ssd_scan(*_t(x, dt, A, Bm, Cm), initial_state=th0)
    np.testing.assert_allclose(sy.numpy(), np.asarray(oy), **SCAN_TOL)
    np.testing.assert_allclose(sh.numpy(), np.asarray(oh), **SCAN_TOL)
    dy, dh = ops.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                          initial_state=th0)
    assert torch.equal(dy, ty) and torch.equal(dh, th)


def test_ssd_scan_chunked_reads_bf16_inputs_as_jax_does():
    """bf16 x/B/C (the model's type): both upcast the same values."""
    import ml_dtypes

    x, dt, A, Bm, Cm, h0 = _scan_inputs(3, 2, 50, 4, 16, 8)
    xb, Bb, Cb = (a.astype(ml_dtypes.bfloat16) for a in (x, Bm, Cm))
    jy, jh = jops.ssd_scan_chunked_jnp(
        jnp.asarray(xb), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bb),
        jnp.asarray(Cb), chunk=32, initial_state=jnp.asarray(h0))
    tb = [bridge.to_torch(a, device="cpu") for a in (xb, Bb, Cb)]
    assert tb[0].dtype == torch.bfloat16
    ty, th = ref.ssd_scan_chunked(tb[0], torch.from_numpy(dt),
                                  torch.from_numpy(A), tb[1], tb[2],
                                  chunk=32, initial_state=torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)


@pytest.mark.parametrize("B,S", [(4, 2048), (4, 1), (1, 7), (1, 1)])
def test_ssd_scan_kernel_reads_the_blocks_views_in_place(B, S):
    """The kernel takes x, B and C as the Mamba-2 block passes them, views
    of one conv output: the wrapper's row strides (a size-1 dimension may
    report any stride), and its refusal of a batch that is not S rows
    apart."""
    nh, hd, ds = 5, 16, 8
    xbc = torch.zeros((B, S, nh * hd + 2 * ds))
    x, Bm, Cm = torch.split(xbc, [nh * hd, ds, ds], dim=-1)
    x = x.unflatten(-1, (nh, hd))
    Bm, Cm = Bm.unflatten(-1, (1, ds)), Cm.unflatten(-1, (1, ds))
    row = nh * hd + 2 * ds
    strides = [sk._row_stride(t, n) for t, n in ((x, "x"), (Bm, "B"),
                                                 (Cm, "C"))]
    if B * S > 1:  # one row alone: its stride is never read
        assert strides == [row] * 3
        assert sk._row_stride(torch.zeros((B, S, 1, ds)), "B") == ds
    if B > 1 and S > 1:
        with pytest.raises(ValueError, match="batch stride"):
            sk._row_stride(x.transpose(0, 1).contiguous().transpose(0, 1),
                           "x")
    with pytest.raises(ValueError, match="contiguous rows"):
        sk._row_stride(torch.zeros((B, S, nh, 2 * hd))[..., ::2], "x")


def test_ssd_step_matches_jax():
    x, dt, A, Bm, Cm, h0 = _scan_inputs(8, 3, 1, 5, 16, 8)
    jy, jh = jops.ssd_step(jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
                           jnp.asarray(A), jnp.asarray(Bm[:, 0]),
                           jnp.asarray(Cm[:, 0]), jnp.asarray(h0))
    ty, th = ops.ssd_step(*_t(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def _f32(arch):
    return (dataclasses.replace(jax_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


@pytest.fixture(scope="module", params=["mamba2-130m", "hymba-1.5b"])
def block(request):
    jcfg, tcfg = _f32(request.param)
    jp = jssm.init(jax.random.PRNGKey(2), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.to_torch(jax.tree.map(np.asarray, jp),
                                   device="cpu"))


def test_softplus_matches_jax():
    xs = np.linspace(-40, 40, 2001).astype(np.float32)
    np.testing.assert_allclose(
        tssm.softplus(torch.from_numpy(xs)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(xs))), rtol=2e-7, atol=0)


def test_ssm_block_apply_chain_and_step_match_jax(block):
    """One segment of 45 rows (ragged against chunk 32), a chained second
    of 9 rows on its conv tail and state, then 3 recurrent steps."""
    jcfg, tcfg = block["jcfg"], block["tcfg"]
    rng = np.random.default_rng(21)
    D = jcfg.d_model
    h1 = rng.normal(size=(2, 45, D)).astype(np.float32)
    h2 = rng.normal(size=(2, 9, D)).astype(np.float32)
    jo1, jc1 = jssm.apply(block["jp"], jcfg, jnp.asarray(h1))
    to1, tc1 = tssm.apply(block["tp"], tcfg, torch.from_numpy(h1))
    np.testing.assert_allclose(to1.numpy(), np.asarray(jo1), **TOL)
    for name in ("conv", "state"):
        np.testing.assert_allclose(tc1[name].numpy(),
                                   np.asarray(jc1[name]), **TOL)
    jo2, jc2 = jssm.apply(block["jp"], jcfg, jnp.asarray(h2),
                          initial_state=jc1["state"], conv_tail=jc1["conv"])
    to2, tc2 = tssm.apply(block["tp"], tcfg, torch.from_numpy(h2),
                          initial_state=tc1["state"], conv_tail=tc1["conv"])
    np.testing.assert_allclose(to2.numpy(), np.asarray(jo2), **TOL)
    for name in ("conv", "state"):
        np.testing.assert_allclose(tc2[name].numpy(),
                                   np.asarray(jc2[name]), **TOL)
    jc, tc = jc2, tc2
    for i in range(3):
        hs = rng.normal(size=(2, 1, D)).astype(np.float32)
        jo, jc = jssm.step(block["jp"], jcfg, jnp.asarray(hs), jc)
        to, tc = tssm.step(block["tp"], tcfg, torch.from_numpy(hs), tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for name in ("conv", "state"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _f32("mamba2-130m")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.to_torch(jax.tree.map(np.asarray, jp),
                                   device="cpu"))


def test_mamba2_params_bridge_leaf_for_leaf(mamba):
    tp = ttf.init_params(mamba["tcfg"], seed=0, device="cpu")
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), mamba["jp"])
    tshapes = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[-1]), tp)
    assert tshapes == jshapes
    assert "mlp" not in tp["layers"] and "attn" not in tp["layers"]


def test_mamba2_prefill_and_decode_match_jax(mamba):
    """prefill(want_ssm_cache=True) of 2 x 45 tokens, then 8 greedy decode
    steps: logits close at every step, greedy tokens identical."""
    jcfg, tcfg = mamba["jcfg"], mamba["tcfg"]
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, 512, (2, 45)).astype(np.int32)
    jr = jtf.prefill(mamba["jp"], jcfg, jnp.asarray(tokens),
                     want_ssm_cache=True)
    tr = ttf.prefill(mamba["tp"], tcfg, torch.from_numpy(tokens),
                     want_ssm_cache=True)
    assert set(tr.cache) == set(jr.cache) == {"ssm", "next_pos"}
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **TOL)
    for name in ("conv", "state"):
        assert tuple(tr.cache["ssm"][name].shape) == \
            jr.cache["ssm"][name].shape
        np.testing.assert_allclose(tr.cache["ssm"][name].numpy(),
                                   np.asarray(jr.cache["ssm"][name]), **TOL)
    jtok = jnp.argmax(jr.logits, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tr.logits, -1)[:, None].to(torch.int32)
    jc, tc = jr.cache, tr.cache
    jtoks, ttoks = [], []
    for _ in range(8):
        jl, jc = jtf.decode_step(mamba["jp"], jcfg, jtok, jc)
        tl, tc = ttf.decode_step(mamba["tp"], tcfg, ttok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl, -1)[:, None].to(torch.int32)
        jtoks.append(np.asarray(jtok)[:, 0].tolist())
        ttoks.append(ttok[:, 0].tolist())
    assert ttoks == jtoks
    np.testing.assert_array_equal(tc["next_pos"].numpy(),
                                  np.asarray(jc["next_pos"]))
    for name in ("conv", "state"):
        np.testing.assert_allclose(tc["ssm"][name].numpy(),
                                   np.asarray(jc["ssm"][name]), **TOL)


def test_mamba2_fresh_decode_cache_matches_jax(mamba):
    jc = jtf.init_decode_cache(mamba["jcfg"], 3, 16)
    tc = ttf.init_decode_cache(mamba["tcfg"], 3, 16, device="cpu")
    assert set(tc) == set(jc) == {"ssm", "next_pos"}
    for name in ("conv", "state"):
        assert tuple(tc["ssm"][name].shape) == jc["ssm"][name].shape
        assert str(tc["ssm"][name].dtype).split(".")[-1] == \
            str(jc["ssm"][name].dtype)


def test_attention_free_arch_is_refused_by_engines_and_launcher(mamba):
    tcfg = mamba["tcfg"]
    with pytest.raises(ValueError, match="no attention KV"):
        ServingEngine(mamba["tp"], tcfg, policy="h2o", device="cpu")
    with pytest.raises(ValueError, match="no attention KV"):
        serve.run(["--arch", "mamba2-130m", "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="attention-only"):
        ttf.init_chunk_state(tcfg, "h2o", 1, 64, device="cpu")
    assert not ttf.chunkable(tcfg) and not jtf.chunkable(mamba["jcfg"])
