"""The port's plain versions of monolithic flash attention and dense
decode attention against the JAX package, on the CPU.

``ref.flash_attention`` (what a CPU tensor runs, and what the CUDA kernel
is held to on the card) against ``flash_attention_pallas`` in interpret
mode at block-multiple lengths (the Pallas kernel asserts them), causal
and not, with and without a window; and against the JAX oracle
``ref.attention`` at ragged lengths, which the port's kernel also takes.

``ref.decode_attention`` against ``decode_attention_pallas`` in interpret
mode with no mask and with a (B, Sk) mask, including a fully masked
sequence (exact zeros on both sides: the kernels' ``max(l, 1e-30)``
rule); and against the JAX oracle ``ref.decode_attention`` with the
per-kv-head (B, Sk, KV) mask the decode step passes, on heads that have a
valid row (the JAX oracle gives the mean of V on an empty head, the port
exact zeros, like the kernels).

Inputs come from a numpy seed; tolerance 1e-5 (float32).  The
interpret-mode grids stay small (B <= 2, H <= 4, S <= 256).
"""

import torch_test_env  # noqa: F401  (first: process settings)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import sweep_cases
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(rng, B, Sq, Sk, H, KV, hd):
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# kernel 7: monolithic flash attention
# ---------------------------------------------------------------------------


def _flash_case(rng):
    KV = int(rng.choice([1, 2]))
    return dict(B=int(rng.integers(1, 3)), S=int(rng.choice([64, 128, 256])),
                KV=KV, H=KV * int(rng.choice([1, 2])),
                hd=int(rng.choice([16, 32])),
                causal=bool(rng.integers(2)),
                window=int(rng.choice([0, 0, 40])),
                seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("case", sweep_cases(21, 6, _flash_case))
def test_flash_attention_plain_matches_pallas(case):
    rng = np.random.default_rng(case["seed"])
    B, S, H, KV, hd = (case[n] for n in ("B", "S", "H", "KV", "hd"))
    q, k, v = _qkv(rng, B, S, S, H, KV, hd)
    w = case["window"] or None
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=case["causal"],
                              window=w)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=case["causal"],
                                  window=w, block_q=32, block_k=64,
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("S,causal,window", [
    (53, True, None),  # a smoke prompt of 45 tokens + 8 lookahead rows
    (97, True, 30),
    (70, False, None),
    (81, False, 25),
])
def test_flash_attention_plain_matches_jax_ref_at_ragged_lengths(
        S, causal, window):
    rng = np.random.default_rng(S)
    q, k, v = _qkv(rng, 2, S, S, 4, 2, 32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_flash_attention_refuses_masks_and_cross_lengths():
    """A key mask (the bucket-padded prefill) is served: masked keys are
    hidden as in the JAX reference.  Sq != Sk (whisper's cross-attention)
    is served non-causally, as the JAX reference computes it; under a
    causal mask or a window it raises (no caller has positions there)."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 8, 8, 2, 2, 16)
    mask = np.ones((2, 8), bool)
    mask[0, 5:] = False
    got = ops.flash_attention(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          kv_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    q, k, v = _qkv(rng, 2, 8, 9, 2, 2, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="Sq 8 != Sk 9"):
            ops.flash_attention(_t(q), _t(k), _t(v), **kw)


# ---------------------------------------------------------------------------
# kernel 6: dense decode attention
# ---------------------------------------------------------------------------


def _decode_case(rng):
    KV = int(rng.choice([1, 2]))
    return dict(B=int(rng.integers(1, 3)), Sk=int(rng.choice([40, 64, 100])),
                KV=KV, H=KV * int(rng.choice([1, 2, 4])),
                hd=int(rng.choice([16, 32])), masked=bool(rng.integers(2)),
                seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("case", sweep_cases(22, 5, _decode_case))
def test_decode_attention_plain_matches_pallas(case):
    rng = np.random.default_rng(case["seed"])
    B, Sk, H, KV, hd = (case[n] for n in ("B", "Sk", "H", "KV", "hd"))
    q, k, v = _qkv(rng, B, 1, Sk, H, KV, hd)
    q = q[:, 0]
    mask = None
    if case["masked"]:
        mask = rng.random((B, Sk)) > 0.3
        mask[-1] = False  # a sequence with no valid row: exact zeros
    got = ops.decode_attention(_t(q), _t(k), _t(v),
                               kv_mask=None if mask is None else _t(mask))
    want = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=None if mask is None else jnp.asarray(mask), block_k=32,
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if mask is not None:
        assert torch.all(got[-1] == 0) and np.all(np.asarray(want)[-1] == 0)


@pytest.mark.parametrize("case", sweep_cases(23, 5, _decode_case))
def test_decode_attention_plain_matches_jax_ref_per_head_mask(case):
    rng = np.random.default_rng(case["seed"])
    B, Sk, H, KV, hd = (case[n] for n in ("B", "Sk", "H", "KV", "hd"))
    q, k, v = _qkv(rng, B, 1, Sk, H, KV, hd)
    q = q[:, 0]
    mask = rng.random((B, Sk, KV)) > 0.4
    mask[:, 0] = True  # every head has a valid row
    got = ops.decode_attention(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), kv_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_decode_attention_empty_head_is_exact_zeros():
    """A per-kv-head mask with an empty head gives exact zeros on that
    head's query group and the JAX oracle's numbers elsewhere."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 1, 30, 4, 2, 16)
    q = q[:, 0]
    mask = rng.random((2, 30, 2)) > 0.3
    mask[:, 0] = True
    mask[1, :, 0] = False  # sequence 1, kv head 0: q heads 0 and 1
    got = ops.decode_attention(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    assert torch.all(got[1, :2] == 0)
    want = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1, 2:], want[1, 2:], **TOL)
