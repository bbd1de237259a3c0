"""The arithmetic of kernel 8 (``csrc/ssd_scan.cu``) on the CPU.

The kernel runs the chunked SSD scan as three launches: (a) each chunk's
own state contribution dh_c and L_Q, (b) the state pass, which turns slot
c into the state entering chunk c, (c) each chunk's output from its own
rows and that state.  In bf16 its products run on tensor cores, and every
float32 operand of a product enters as bf16 parts whose products are
summed in float32: x scaled by exp(L_Q - L_s) dt_s in (a) and the weights
W = C.B^T o exp(L_t - L_s) o causal with dt_s folded in, in (c), as two,
hi = bf16(v) and lo = bf16(v - hi); the incoming state in (c) as three,
hi, mid and lo.

``three_pass`` below writes that decomposition in plain torch.  In
float32 it must equal the JAX package's ``ssd_scan_pallas`` in interpret
mode and ``ref.ssd_scan_chunked`` (2e-4: float32 in other summation
orders, as ``test_torch_ssm.py`` holds the plain version to Pallas), at
ragged S and odd head counts too.  With the kernel's splits emulated
(``.to(torch.bfloat16)`` rounding, products summed in float32) it must
hold each row of y within 2^-12 of that row's largest plain magnitude and
the final state within 2^-12 of its largest, the kernel's tolerance on
the card, at hymba-1.5b's and mamba2-130m's widths (hd 64, d_state 16 and
128, chunk 128) with B, S and the head count cut down, and at
mamba2-130m's whole prefill call (B 4 x S 2048, 24 heads), where the
state split in two instead of three leaves rows ~10x nearer the
tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ref

TOL = dict(atol=2e-4, rtol=2e-4)
REL = 2 ** -12


def _inputs(seed, B, S, nh, hd, ds, *, bf16_inputs=False):
    """x, dt, A, B, C, h0 as numpy float32 arrays: dt = softplus(N - 2) and
    A in -[1, 16] as the Mamba-2 block gives them; x, B and C rounded to
    bf16 values where the kernel would take bf16."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, nh)) - 2.0)).astype(
        np.float32)
    A = -(1.0 + 15.0 * rng.random(nh)).astype(np.float32)
    Bm = rng.normal(size=(B, S, 1, ds)).astype(np.float32)
    Cm = rng.normal(size=(B, S, 1, ds)).astype(np.float32)
    h0 = rng.normal(size=(B, nh, hd, ds)).astype(np.float32)
    if bf16_inputs:
        x, Bm, Cm = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                     for a in (x, Bm, Cm))
    return x, dt, A, Bm, Cm, h0


def _decay(v):
    return torch.exp(torch.clamp(v, -60.0, 0.0))


#: bf16 parts of each float32 operand the kernel splits: the scaled x of
#: (a), the weights of (c), the incoming state of (c)
KERNEL_TERMS = (2, 2, 3)


def _product(a, b, eq, terms):
    """einsum(eq, a, b) in float32, with ``a`` (``terms`` > 0) as that many
    bf16 parts, one product each, summed in float32."""
    parts = [a]
    if terms:
        parts, rest = [], a
        for _ in range(terms):
            parts.append(rest.to(torch.bfloat16).float())
            rest = rest - parts[-1]
    out = 0
    for p in parts:
        out = out + torch.einsum(eq, p, b)
    return out


def three_pass(x, dt, A, Bm, Cm, *, chunk, initial_state=None,
               terms=(0, 0, 0)):
    """Kernel 8's three launches in plain torch (x/B/C (.., 1, ds) with one
    group; ``terms``: the bf16 parts of its three split operands, 0 for
    float32) -> (y (B, S, nh, hd), final state), float32."""
    B, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    x, Bm, Cm = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
                 for t in (x, Bm, Cm))
    dt = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    xc = x.reshape(B, nc, chunk, nh, hd)
    bc = Bm[:, :, 0].reshape(B, nc, chunk, ds)
    cc = Cm[:, :, 0].reshape(B, nc, chunk, ds)
    dtc = dt.reshape(B, nc, chunk, nh)
    L = torch.cumsum(A.float() * dtc, dim=2)  # (B, nc, Q, nh)
    # the last real row's L: pad rows have dt = 0, so L stays there
    lq = L[:, :, -1]  # (B, nc, nh)

    # (a) dh_c = sum_s exp(L_Q - L_s) dt_s x_s (x) B_s; B is exact in bf16
    xs = xc * (_decay(lq[:, :, None] - L) * dtc)[..., None]
    states = _product(xs, bc, "bcsnh,bcsd->bcnhd", terms[0])

    # (b) slot c <- the state entering chunk c
    h = (torch.zeros((B, nh, hd, ds)) if initial_state is None
         else initial_state.float())
    for c in range(nc):
        dh = states[:, c].clone()
        states[:, c] = h
        h = _decay(lq[:, c])[..., None, None] * h + dh

    # (c) y = W x + exp(L_t) C_t . h_in; C.B^T in float32
    cb = torch.einsum("bctd,bcsd->bcts", cc, bc)
    causal = torch.tril(torch.ones((chunk, chunk)))
    w = (cb[..., None] * _decay(L[:, :, :, None] - L[:, :, None, :])
         * causal[..., None] * dtc[:, :, None])  # (B, nc, t, s, nh)
    y = _product(w, xc, "bctsn,bcsnh->bctnh", terms[1])
    carried = _product(states, cc, "bcnhd,bctd->bctnh", terms[2])
    y = y + carried * _decay(L)[..., None]
    return y.reshape(B, nc * chunk, nh, hd)[:, :S], h


def _worst(got, want) -> tuple:
    """(worst y row, final state) error over the 2^-12 tolerance."""
    (gy, gh), (wy, wh) = got, want
    rows = (gy - wy).abs().amax(-1) / (REL * wy.abs().amax(-1))
    return (float(rows.max()),
            float((gh - wh).abs().max()) / (REL * float(wh.abs().max())))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_state", [False, True])
def test_three_pass_matches_pallas_interpret(with_state):
    """Whole chunks and a head count the Pallas kernel's head block divides
    (its asserts)."""
    x, dt, A, Bm, Cm, h0 = _inputs(21, 2, 64, 4, 16, 8)
    h0 = h0 if with_state else None
    jy, jh = ssd_scan_pallas(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=16, block_nh=2,
        initial_state=None if h0 is None else jnp.asarray(h0),
        interpret=True)
    ty, th = three_pass(*_t(x, dt, A, Bm, Cm), chunk=16,
                        initial_state=None if h0 is None
                        else torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk", [
    (2, 45, 7, 16, 8, 16),  # ragged tail, 7 heads
    (1, 70, 7, 32, 16, 32),  # two whole chunks and a ragged one
    (2, 5, 3, 16, 8, 1),  # chunk 1: every row its own chunk
    (1, 300, 2, 16, 8, 256),  # chunk 256 with a ragged second chunk
])
@pytest.mark.parametrize("with_state", [False, True])
def test_three_pass_matches_plain(B, S, nh, hd, ds, chunk, with_state):
    x, dt, A, Bm, Cm, h0 = _inputs(S * 7 + nh, B, S, nh, hd, ds)
    th0 = torch.from_numpy(h0) if with_state else None
    ty, th = three_pass(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                        initial_state=th0)
    ry, rh = ref.ssd_scan_chunked(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                                  initial_state=th0)
    assert ty.shape == ry.shape and th.shape == rh.shape
    torch.testing.assert_close(ty, ry, **TOL)
    torch.testing.assert_close(th, rh, **TOL)


@pytest.mark.parametrize("ds", [16, 128], ids=["hymba-ds16", "mamba2-ds128"])
@pytest.mark.parametrize("with_state", [False, True])
def test_split_products_hold_the_kernel_tolerance(ds, with_state):
    """bf16 x/B/C at the served widths (hd 64, chunk 128), S 300 (three
    chunks, the last ragged) and 3 heads: the kernel's splits keep every row
    of y within 2^-12 of its largest plain magnitude, and the final state
    within 2^-12 of its largest; each operand rounded once to bf16 misses
    by far more."""
    x, dt, A, Bm, Cm, h0 = _inputs(ds + with_state, 1, 300, 3, 64, ds,
                                   bf16_inputs=True)
    args = _t(x, dt, A, Bm, Cm)
    th0 = torch.from_numpy(h0) if with_state else None
    want = ref.ssd_scan_chunked(*args, chunk=128, initial_state=th0)
    y_worst, h_worst = _worst(three_pass(*args, chunk=128, initial_state=th0,
                                         terms=KERNEL_TERMS), want)
    assert y_worst <= 1.0 and h_worst <= 1.0, (y_worst, h_worst)
    once, _ = _worst(three_pass(*args, chunk=128, initial_state=th0,
                                terms=(1, 1, 1)), want)
    assert once > 4 * y_worst


def test_state_split_in_three_at_mamba2_prefill():
    """mamba2-130m's prefill call (B 4 x S 2048, 24 heads of 64, d_state
    128, bf16 inputs): the kernel's splits hold the tolerance; with the
    incoming state in two parts the worst row comes ~10x nearer it (a
    chunk's first rows can be small against |C| |h|)."""
    x, dt, A, Bm, Cm, _ = _inputs(6, 4, 2048, 24, 64, 128, bf16_inputs=True)
    args = _t(x, dt, A, Bm, Cm)
    want = ref.ssd_scan_chunked(*args, chunk=128)
    y_worst, h_worst = _worst(three_pass(*args, chunk=128,
                                         terms=KERNEL_TERMS), want)
    assert y_worst <= 1.0 and h_worst <= 1.0, (y_worst, h_worst)
    two, _ = _worst(three_pass(*args, chunk=128, terms=(2, 2, 2)), want)
    assert two > 4 * y_worst, (two, y_worst)
