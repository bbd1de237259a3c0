"""The port's plain kernel versions against the JAX package, on the CPU.

Each plain PyTorch version in ``repro_torch.kernels.ref`` (what a CPU
tensor runs, and what the CUDA kernels are held to on the card) is
compared with the JAX oracle in ``repro.kernels.ref`` and with the Pallas
kernel it ports, run in interpret mode, over the shapes and edge cases of
``tests/test_kernels.py``, ``test_fused_scores.py`` and
``test_paged_decode.py``: GQA groups, ragged key depths, windows, masked
keys and rows, ragged block tables with null blocks, fully masked heads.
Inputs come from a numpy seed.  Tolerance 1e-5 (float32); a fully masked
head must come out exact zeros on both sides.

Also the pieces between the kernels that decide kept sets: GQA reduce,
max-pool and the top-k tie rule (lower index first on equal scores).
"""

import torch_test_env  # noqa: F401  (first: process settings)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import sweep_cases
from repro.core import eviction as jev
from repro.core import scoring as jscoring
from repro.kernels import ref as jref
from repro.kernels.chunk_attention import chunk_attention_pallas
from repro.kernels.lookahead_score import lookahead_score_pallas
from repro.kernels.paged_attention import paged_decode_attention_pallas
from repro_torch.core import eviction as tev
from repro_torch.core import scoring as tscoring
from repro_torch.kernels import chunk_attention as _ck
from repro_torch.kernels import decode_attention as _dk
from repro_torch.kernels import lookahead_score as _lk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as _pk

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# kernel 1: chunk attention
# ---------------------------------------------------------------------------


def _chunk_case(rng):
    KV = int(rng.choice([1, 2, 4]))
    C = int(rng.choice([8, 16, 32]))
    K = int(rng.choice([64, 96, 80]))  # 80: not a multiple of the tile
    return dict(B=int(rng.integers(1, 3)), C=C, K=K, KV=KV,
                H=KV * int(rng.choice([1, 2, 4])), hd=int(rng.choice([16, 32])),
                off=int(rng.integers(0, K - C + 1)),
                window=int(rng.choice([0, 0, 24])),
                seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("case", sweep_cases(11, 6, _chunk_case))
def test_chunk_attention_plain_matches_jax(case):
    rng = np.random.default_rng(case["seed"])
    B, C, K, H, KV, hd = (case[n] for n in ("B", "C", "K", "H", "KV", "hd"))
    q = rng.normal(size=(B, C, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, K, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, K, KV, hd)).astype(np.float32)
    off, w = case["off"], case["window"] or None
    got = ops.chunk_attention(_t(q), _t(k), _t(v), q_offset=off, window=w)
    q_pos = jnp.broadcast_to(off + jnp.arange(C), (B, C))
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=w, q_pos=q_pos)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = chunk_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(off), window=w,
                                    block_k=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("B,C,K,H,KV,hd,off,window", [
    (1, 1, 200, 2, 1, 16, 150, None),  # one row; K, q_offset off 128
    (1, 129, 300, 4, 2, 32, 100, None),  # a 128-row tile + 1
    (2, 40, 330, 4, 2, 16, 200, 100),  # a window starting across 128
    (1, 64, 160, 4, 1, 32, 96, 64),  # the diagonal inside a key tile
])
def test_chunk_attention_plain_matches_pallas_at_tile_edges(B, C, K, H, KV,
                                                           hd, off, window):
    """The shapes that stress the card's 128-row, 128-key tiles: the plain
    version the card is held to against the Pallas kernel (interpret
    mode, its own key blocks) and the JAX oracle."""
    rng = np.random.default_rng(C * 1000 + K)
    q = rng.normal(size=(B, C, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, K, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, K, KV, hd)).astype(np.float32)
    got = ops.chunk_attention(_t(q), _t(k), _t(v), q_offset=off,
                              window=window)
    q_pos = jnp.broadcast_to(off + jnp.arange(C), (B, C))
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=window, q_pos=q_pos)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = chunk_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(off),
                                    window=window, block_k=128,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("B,C,H,K,hd,dtype,off,window,want", [
    (1, 256, 32, 4096, 128, torch.bfloat16, 3840, None, 2),  # 64 CTAs
    (1, 32, 32, 4096, 128, torch.bfloat16, 4000, None, 4),  # obs pass
    (1, 256, 32, 4096, 128, torch.bfloat16, 0, None, 1),  # 2 key tiles
    (1, 256, 32, 4096, 128, torch.float32, 3840, None, 1),  # no Hopper tile
    (1, 256, 32, 4096, 32, torch.bfloat16, 3840, None, 1),  # hd 32 neither
    (4, 2080, 32, 2080, 128, torch.bfloat16, 0, None, 1),  # fills the card
    (1, 256, 32, 4096, 128, torch.bfloat16, 3840, 100, 1),  # 3 key tiles
    (1, 32, 8, 1000, 64, torch.bfloat16, 900, None, 2),  # 8 key tiles
    # gemma3-1b at hd 256 (4 heads; the tile's 64-key K/V tiles)
    (1, 256, 4, 4096, 256, torch.bfloat16, 3840, None, 4),  # 8 CTAs
    (1, 256, 4, 4096, 256, torch.bfloat16, 3840, 512, 3),  # 12 key tiles
    (1, 32, 4, 4096, 256, torch.bfloat16, 4000, None, 4),  # obs pass
    (4, 2080, 4, 2080, 256, torch.bfloat16, 0, None, 1),  # 272 CTAs
])
def test_key_splits(B, C, H, K, hd, dtype, off, window, want):
    """How many CTAs share a query tile's key range on a 132-SM card."""
    assert _ck.key_splits(B, C, H, K, hd, dtype, q_offset=off,
                          window=window, sms=132) == want


@pytest.mark.parametrize("B,KV,nb,bs,want", [
    (4, 8, 19, 16, 4),  # kernel 4's main path: 304 rows, 32 clusters
    (4, 8, 20, 16, 4),  # kernel 5's (capacity 256 + interval 64)
    (4, 8, 1, 16, 1),  # one block: nothing to split
    (4, 8, 2, 16, 1),  # 32 rows: one CTA's round of copies
    (4, 8, 4, 16, 2),
    (4, 8, 8, 16, 4),
    (4, 32, 19, 16, 2),  # G = 1 at 32 heads: 128 clusters
    (64, 8, 19, 16, 1),  # 512 clusters already fill the card
    (4, 8, 3, 5, 1),  # an odd block size, 15 rows
    (4, 8, 2, 64, 2),  # no more splits than blocks
])
def test_row_splits(B, KV, nb, bs, want):
    """How many CTAs of one cluster share a (sequence, kv head)'s rows in
    kernels 4 and 5 on a 132-SM card."""
    assert _pk.row_splits(B, KV, nb, bs, 132) == want


@pytest.mark.parametrize("B,C,KV,want", [
    (4, 289, 8, 4),  # kernel 6's main path: 289 rows, 32 clusters
    (4, 289, 5, 4),  # hymba-1.5b's 5 kv heads
    (4, 64, 8, 2),  # 32 rows a CTA
    (1, 1, 8, 1),  # one row: nothing to split
    (4, 31, 8, 1),  # under one CTA's 32 rows
    (64, 289, 8, 1),  # 512 clusters already fill the card
])
def test_dense_row_splits(B, C, KV, want):
    """How many CTAs of one cluster share a (sequence, kv head)'s rows in
    kernel 6 on a 132-SM card: the paged rule with rows as blocks of one."""
    assert _dk.row_splits(B, KV, C, 132) == want


@pytest.mark.parametrize(
    "B,n_obs,H,KV,hd,n_visible,n_prompt,blocks,splits,tiles", [
        # llama3-8b's finalize: 63 key tiles seen, 64 scored
        (1, 32, 32, 8, 128, 4032, 4096, 1, 16, 2),
        (4, 32, 32, 8, 128, 2080, 2048, 1, 8, 4),  # the lockstep call
        (1, 2048, 32, 8, 128, 2048, 2048, 64, 1, 1),  # monolithic h2o
        (1, 32, 32, 8, 128, 40, 8, 1, 1, 1),  # a one-tile prompt
        (4, 32, 25, 5, 64, 2080, 2048, 2, 6, 3),  # hymba-1.5b: 2 row blocks
        (1, 17, 8, 2, 128, 500, 483, 1, 2, 1),  # n_obs 17: heads padded
        # 16 x 32k prompts: launch (b)'s key ranges capped by shared memory
        (16, 32, 32, 8, 128, 32800, 32768, 1, 2, 154),
        # gemma3-1b at hd 256: its finalize and lockstep calls, then G 8
        # and 16: two and four row blocks, whose double-buffered Q rows
        # leave launch (b) room for 12 splits' partials, not 16
        (1, 32, 4, 1, 256, 4032, 4096, 1, 16, 1),
        (4, 32, 4, 1, 256, 2080, 2048, 1, 9, 1),
        (1, 32, 8, 1, 256, 4032, 4096, 2, 12, 1),
        (1, 64, 16, 2, 256, 4032, 4096, 4, 12, 1),
    ])
def test_lookahead_key_splits(B, n_obs, H, KV, hd, n_visible, n_prompt,
                              blocks, splits, tiles):
    """Kernel 3 on a 132-SM card: launch (a)'s row blocks of 8 16-row
    fragments of the packed GQA group and the key splits of each, and
    the key tiles each CTA of launch (b) takes, within a CTA's shared
    memory."""
    assert _lk.row_blocks(n_obs, H // KV) == blocks
    assert _lk.key_splits(B, n_obs, H, KV, n_visible, 132, hd) == splits
    assert _lk.column_tiles(B, n_obs, H, KV, hd, n_prompt, splits,
                            132) == tiles
    assert _lk.column_smem(n_obs, H // KV, hd, splits, tiles) \
        <= _lk.MAX_SMEM


def test_chunk_attention_rejects_overflowing_chunk():
    """The buffer must hold the chunk: no silent clamp of the offset."""
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 32, 1, 16))
    with pytest.raises(ValueError, match="does not fit"):
        ops.chunk_attention(q, k, k, q_offset=25)


# ---------------------------------------------------------------------------
# kernel 3: lookahead scores
# ---------------------------------------------------------------------------


def _score_case(rng):
    KV = int(rng.choice([1, 2]))
    n_obs = int(rng.choice([4, 8, 32]))
    Sk = int(rng.choice([48, 72, 100]))
    return dict(B=int(rng.integers(1, 3)), n_obs=n_obs, Sk=Sk, KV=KV,
                H=KV * int(rng.choice([1, 2, 4])), hd=int(rng.choice([16, 32])),
                n_prompt=int(rng.choice([Sk - n_obs, Sk])),
                window=int(rng.choice([0, 0, 20])),
                masks=bool(rng.integers(2)), seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("case", sweep_cases(12, 6, _score_case) + [
    # the edges of the card's bf16 tile (rows padded to 16 per head, the
    # GQA group packed): n_obs 17 and 40, a group of 5
    dict(B=1, n_obs=17, Sk=72, KV=2, H=10, hd=16, n_prompt=55, window=0,
         masks=True, seed=101),
    dict(B=2, n_obs=17, Sk=100, KV=1, H=5, hd=32, n_prompt=100, window=20,
         masks=False, seed=102),
    dict(B=1, n_obs=40, Sk=100, KV=2, H=8, hd=32, n_prompt=100, window=0,
         masks=True, seed=103),
])
def test_lookahead_score_plain_matches_jax(case):
    """Traced-offset finalize form (n_prompt = Sk, q_offset < Sk) and the
    monolithic form (n_prompt = Sk - n_obs), with kv_mask and row_valid
    (False rows zeroed, denominator n_obs) and windows."""
    rng = np.random.default_rng(case["seed"])
    B, n_obs, Sk, H, KV, hd = (case[n] for n in
                               ("B", "n_obs", "Sk", "H", "KV", "hd"))
    n_prompt = case["n_prompt"]
    q = rng.normal(size=(B, n_obs, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    off = Sk - n_obs - int(rng.integers(0, 10)) if n_prompt == Sk else None
    kvm = rv = None
    if case["masks"]:
        kvm = rng.random((B, n_prompt)) > 0.2
        rv = rng.random((B, n_obs)) > 0.3
    w = case["window"] or None
    got = ops.lookahead_score(
        _t(q), _t(k), n_prompt, q_offset=off, window=w,
        kv_mask=None if kvm is None else _t(kvm),
        row_valid=None if rv is None else _t(rv))
    jkw = dict(q_offset=off, window=w,
               kv_mask=None if kvm is None else jnp.asarray(kvm),
               row_valid=None if rv is None else jnp.asarray(rv))
    want = jref.lookahead_score(jnp.asarray(q), jnp.asarray(k), n_prompt,
                                **jkw)
    assert got.dtype == torch.float32 and got.shape == (B, H, n_prompt)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = lookahead_score_pallas(jnp.asarray(q), jnp.asarray(k), n_prompt,
                                    block_k=32, interpret=True, **jkw)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


# ---------------------------------------------------------------------------
# kernel 4: paged decode attention
# ---------------------------------------------------------------------------


def _paged_inputs(rng, *, B, KV, G, hd, bs, N, nb):
    H = KV * G
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    pk = rng.normal(size=(N, bs, KV, hd)).astype(np.float32)
    pv = rng.normal(size=(N, bs, KV, hd)).astype(np.float32)
    pm = rng.random((N, bs, KV)) > 0.25
    pm[0] = False  # the null block
    pos = rng.integers(0, 64, (N, bs, KV)).astype(np.int32)
    tbl = rng.integers(1, N, (B, nb)).astype(np.int32)
    tbl[0, nb // 2:] = 0  # ragged: null tail
    npos = rng.integers(40, 70, (B,)).astype(np.int32)
    return q, pk, pv, pm, pos, tbl, npos


def _paged_case(rng):
    return dict(B=int(rng.integers(1, 4)), KV=int(rng.choice([1, 2])),
                G=int(rng.choice([1, 2, 4])), hd=int(rng.choice([16, 32])),
                bs=int(rng.choice([4, 8, 16])), nb=int(rng.integers(2, 6)),
                window=int(rng.choice([0, 0, 16])),
                seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("case", sweep_cases(13, 6, _paged_case))
def test_paged_decode_plain_matches_jax(case):
    rng = np.random.default_rng(case["seed"])
    q, pk, pv, pm, pos, tbl, npos = _paged_inputs(
        rng, B=case["B"], KV=case["KV"], G=case["G"], hd=case["hd"],
        bs=case["bs"], N=9, nb=case["nb"])
    w = case["window"] or None
    kw = {} if w is None else dict(pos_pool=pos, new_pos=npos, window=w)
    got = ops.paged_decode_attention(
        _t(q), _t(pk), _t(pv), _t(pm), _t(tbl),
        **{k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    args = tuple(jnp.asarray(x) for x in (q, pk, pv, pm, tbl))
    want = jref.paged_decode_attention(*args, **jkw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = paged_decode_attention_pallas(*args, interpret=True, **jkw)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_paged_decode_dead_sequences_are_exact_zeros():
    """An all-null table, a fully masked block run and a window that
    excludes every row give exact zeros (not NaN), as the Pallas kernel."""
    rng = np.random.default_rng(3)
    q, pk, pv, pm, pos, tbl, _ = _paged_inputs(
        rng, B=3, KV=2, G=2, hd=16, bs=8, N=6, nb=3)
    pm[5] = False
    tbl[1] = 0  # between requests: all null
    tbl[2] = [5, 5, 0]  # allocated but fully masked
    got = ops.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(pm), _t(tbl))
    assert torch.all(got[1:] == 0.0)
    pallas = paged_decode_attention_pallas(
        *(jnp.asarray(x) for x in (q, pk, pv, pm, tbl)), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    npos = np.full((3,), 1000, np.int32)
    out = ops.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(pm), _t(tbl),
                                     pos_pool=_t(pos), new_pos=_t(npos),
                                     window=4)
    assert torch.all(out == 0.0)


def test_paged_decode_depth_slice_changes_nothing():
    """Rows past the logical depth are masked in the pool, so the port's
    whole-table walk agrees with the JAX gather oracle sliced to the
    depth."""
    rng = np.random.default_rng(4)
    q, pk, pv, pm, _, tbl, _ = _paged_inputs(
        rng, B=2, KV=2, G=2, hd=16, bs=4, N=8, nb=4)
    pm[tbl[:, 3]] = False  # rows 12..15 of every sequence: beyond depth
    args = (_t(q), _t(pk), _t(pv), _t(pm), _t(tbl))
    full = ops.paged_decode_attention(*args)
    sliced = jref.paged_decode_attention(
        *(jnp.asarray(x) for x in (q, pk, pv, pm, tbl)), depth=12)
    np.testing.assert_allclose(full, np.asarray(sliced), **TOL)


# ---------------------------------------------------------------------------
# scoring and selection: the kept-set pipeline between the kernels
# ---------------------------------------------------------------------------


def test_gqa_reduce_and_maxpool_match_jax():
    rng = np.random.default_rng(5)
    s = rng.random((2, 8, 37)).astype(np.float32)
    np.testing.assert_allclose(tscoring.gqa_reduce(_t(s), 2),
                               np.asarray(jscoring.gqa_reduce(
                                   jnp.asarray(s), 2)), **TOL)
    for kernel in (1, 3, 7):
        np.testing.assert_array_equal(
            tscoring.maxpool1d(_t(s), kernel),
            np.asarray(jscoring.maxpool1d(jnp.asarray(s), kernel)))


@pytest.mark.parametrize("capacity,budget", [(6, 6), (6, 4), (40, 40)])
def test_select_topk_tie_rule_matches_lax_top_k(capacity, budget):
    """Max-pool plateaus are exact ties; the port's stable sort must keep
    the same indices as ``lax.top_k`` (lower index first), in the same
    position order, including capacity beyond the scores (padding)."""
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 4, (2, 3, 30)).astype(np.float32)
    s = np.asarray(jscoring.maxpool1d(jnp.asarray(raw), 7))  # plateaus
    ji, jm = jev.select_topk(jnp.asarray(s), capacity,
                             layer_budget=jnp.int32(budget))
    ti, tm = tev.select_topk(_t(s), capacity, layer_budget=budget)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
