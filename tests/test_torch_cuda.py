"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA card: it carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false (decided in
the fixture, never at import).  Run them on a card with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances: float32 inputs 1e-4 (another summation order).  Of
bfloat16 attention outputs, each output row (one query row of one head)
within a fraction of that row's own largest plain magnitude (outputs of
random inputs shrink as 1/sqrt(visible keys), so in causal attention a
row that sees one key is ~30x one that sees a thousand, and a tolerance
taken from the whole tensor would let a wrong deep row through): chunk
and monolithic flash attention 2^-5 (their tensor cores take P rounded
to bfloat16, and the output is rounded once), paged and dense decode
2^-7 (float32 on CUDA cores, one rounding of the output); lookahead
scores, float32 throughout, 2^-16 of the largest score.  Paged decode
masses (kernel 5): its ``out`` bitwise kernel 4's, and each (sequence,
head) row of masses within 2^-16 of that row's largest plain mass (both
sides take float32 dot products and exponentials, a few float32 ulps
apart).  Chunk attention with column masses (kernel 2): its ``out``
bitwise kernel 1's, each (sequence, head) row of masses within 2^-16 of
that row's largest plain mass (the same float32 logits and exponentials,
summed over the rows in another order), exact zeros where the plain
masses are, and every row of masses summing to the number of counted
rows within 1e-4 of it.  The SSD scan (kernel 8): each output row of y
(one row of one head) within 2^-12 of that row's largest plain
magnitude, the final state within 2^-12 of its largest plain magnitude
(the plain version is float32; in bf16 the kernel's tensor cores take
every float32 operand as bf16 hi + lo, ~2^-17 of it, and the two prefix
sums of the log-decays take other orders, so near-diagonal decays
exp(L_t - L_s) of large L inherit their ~1e-5 absolute difference).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import chunk_attention as ck
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import lookahead_score as lk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pk
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as sk

from conftest import sweep_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_rows_close(got, want, dtype, rel):
    """float32: 1e-4.  bfloat16: every output row (last axis) within
    ``rel`` times that row's own largest plain magnitude."""
    if dtype != torch.bfloat16:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        return
    err = (got.float() - want.float()).abs().amax(-1)
    tol = rel * want.float().abs().amax(-1)
    bad = err > tol
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} rows out of tolerance; first "
        f"at {tuple(int(i) for i in bad.nonzero()[0])}: err "
        f"{float(err[bad][0]):.3e} > {float(tol[bad][0]):.3e}")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,K,H,KV,hd,off,window", [
    (1, 256, 4096, 32, 8, 128, 3840, None),  # deep chunk of a 4k prompt
    (1, 32, 4096, 32, 8, 128, 4000, None),  # the observation pass
    (2, 50, 333, 4, 2, 32, 100, None),  # K not a multiple of the tile
    (1, 64, 300, 8, 2, 64, 200, 48),  # sliding window
    # the edges of the Hopper tile (bf16, hd 64 and 128): 128-row query
    # tiles of two 64-row warpgroups, 128-key tiles aligned to position 0,
    # the causal diagonal at q_offset + row
    (1, 1, 100, 8, 2, 128, 0, None),  # one row, a buffer under one tile
    (1, 1, 4096, 8, 2, 64, 4095, None),  # one row at the last key
    (1, 32, 1000, 8, 2, 128, 100, None),  # one warpgroup live, off the grid
    (1, 64, 100, 8, 2, 64, 0, None),  # one warpgroup's rows exactly
    (1, 127, 1000, 8, 2, 64, 100, None),  # one row short of a tile
    (1, 128, 4096, 8, 2, 128, 3840, None),  # a tile, diagonal on the grid
    (1, 129, 1000, 8, 2, 128, 100, None),  # one row past a tile
    (1, 256, 1000, 8, 2, 64, 100, None),  # two tiles, a ragged key tail
    (1, 256, 4096, 8, 2, 128, 3840, 1),  # each row sees only itself
    (1, 256, 4096, 8, 2, 64, 3840, 64),  # a window inside one key tile
    (1, 256, 1000, 8, 2, 128, 100, 100),  # a window across key tiles
    (1, 129, 1000, 8, 2, 64, 100, 128),  # a window of one key tile
    (1, 256, 4096, 8, 2, 128, 3840, 1024),  # hymba's window
    (1, 100, 1000, 4, 4, 128, 700, None),  # GQA ratio 1
    (1, 100, 1000, 10, 2, 64, 700, None),  # GQA ratio 5
    (1, 100, 1000, 16, 2, 128, 700, None),  # GQA ratio 8
    (3, 129, 1000, 8, 2, 128, 100, None),  # B = 3
    (1, 1024, 1024, 8, 2, 64, 0, None),  # 2 key splits, one of them empty
])
def test_chunk_attention_matches_plain(dev, dtype, B, C, K, H, KV, hd, off,
                                       window):
    g = torch.Generator(device=dev).manual_seed(0)
    q = _randn(g, (B, C, H, hd), dtype, dev)
    k = _randn(g, (B, K, KV, hd), dtype, dev)
    v = _randn(g, (B, K, KV, hd), dtype, dev)
    got = ck.chunk_attention(q, k, v, q_offset=off, window=window)
    torch.cuda.synchronize()
    want = ref.chunk_attention(q, k, v, q_offset=off, window=window)
    _assert_rows_close(got, want, dtype, 2 ** -5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,K,H,KV,hd,off,n_total,window", [
    (1, 256, 4096, 32, 8, 128, 3840, 4000, None),  # h2o chunk; 96 pad rows
    (1, 256, 4096, 32, 8, 128, 0, 4000, None),  # first chunk: tiles pruned
    (2, 100, 1000, 8, 2, 64, 700, 790, None),  # K not a multiple of 64
    (1, 256, 1000, 32, 8, 128, 500, 1000, 96),  # window 96
    (1, 64, 300, 4, 4, 32, 200, 260, None),  # G = 1
    (1, 64, 300, 64, 8, 128, 200, 264, None),  # G = 8
    # the edges of the Hopper tile (bf16, hd 64 and 128): column masses
    # over 128-key tiles, Q tiles 128-aligned from row 0
    (1, 256, 4096, 8, 2, 128, 3840, 3900, None),  # n_total mid key tile
    (1, 64, 300, 8, 2, 64, 200, 150, None),  # n_total <= q_offset: zeros
    (1, 100, 1000, 8, 2, 128, 700, 1000, None),  # n_total past the chunk
    (1, 1, 100, 8, 2, 64, 0, 1, None),  # one row, a buffer under one tile
    (1, 32, 4096, 8, 2, 128, 4000, 4032, None),  # one warpgroup live
    (1, 129, 1000, 8, 2, 128, 100, 229, None),  # one row past a tile
    (1, 127, 1000, 8, 2, 64, 100, 227, 64),  # a window inside a key tile
    (1, 256, 1000, 8, 2, 64, 100, 300, 100),  # a window across key tiles
    (1, 256, 4096, 8, 2, 128, 3840, 4000, 1),  # each row sees itself
    (1, 256, 4096, 8, 2, 128, 3840, 4000, 1024),  # hymba's window
    (1, 100, 1000, 10, 2, 64, 700, 790, None),  # GQA ratio 5
    (3, 129, 1000, 8, 2, 128, 100, 200, None),  # B = 3
    (1, 1024, 1024, 8, 2, 128, 0, 1000, None),  # a key split left empty
])
def test_chunk_attention_masses_matches_plain(dev, dtype, B, C, K, H, KV,
                                              hd, off, n_total, window):
    g = torch.Generator(device=dev).manual_seed(7)
    q = _randn(g, (B, C, H, hd), dtype, dev)
    k = _randn(g, (B, K, KV, hd), dtype, dev)
    v = _randn(g, (B, K, KV, hd), dtype, dev)
    out, masses = ck.chunk_attention_masses(q, k, v, q_offset=off,
                                            n_total=n_total, window=window)
    plain1 = ck.chunk_attention(q, k, v, q_offset=off, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, plain1), "out must be bitwise kernel 1's"
    _assert_rows_close(out, ref.chunk_attention(q, k, v, q_offset=off,
                                                window=window), dtype,
                       2 ** -5)
    rv = (off + torch.arange(C, device=dev) < n_total).expand(B, C)
    want = ref.chunk_column_masses(q, k, q_offset=off, window=window,
                                   row_valid=rv)
    err = (masses - want).abs().amax(-1)
    tol = 2 ** -16 * want.abs().amax(-1)
    assert bool(torch.all(err <= tol)), float((err - tol).max())
    assert torch.all(masses[want == 0] == 0), "unseen keys: exact zeros"
    n_rows = float(rv[0].sum())
    torch.testing.assert_close(masses.sum(-1), torch.full_like(
        masses[..., 0], n_rows), atol=1e-4 * n_rows, rtol=0)


@pytest.mark.parametrize("hd", [64, 128])
def test_chunk_attention_sm90_counts_one_launch(dev, hd):
    """Kernel 1 on the bf16 tile at hd 64 and 128 counts one launch per
    call, kernel 2 one per call, whatever launches the call makes inside
    (the combine of a split key range, kernel 2's column masses)."""
    g = torch.Generator(device=dev).manual_seed(10)
    q = _randn(g, (1, 32, 8, hd), torch.bfloat16, dev)
    k = _randn(g, (1, 1000, 2, hd), torch.bfloat16, dev)
    v = _randn(g, (1, 1000, 2, hd), torch.bfloat16, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ck.key_splits(1, 32, 8, 1000, hd, q.dtype, q_offset=900,
                         window=None, sms=sms) == 2
    before = ops.launch_counts()
    ops.chunk_attention(q, k, v, q_offset=900)
    assert ck.launches == before["chunk_attention"] + 1
    ops.chunk_attention(q, k, v, q_offset=900, score_masses=True,
                        n_total=920)
    ops.chunk_attention(q, k, v, q_offset=900, window=64, score_masses=True,
                        n_total=920)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    changed = {"chunk_attention": 1, "chunk_attention_masses": 2}
    assert {n: after[n] - before[n] for n in after} == \
        {n: changed.get(n, 0) for n in after}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n_obs,Sk,H,KV,hd,n_prompt,off,window,masks", [
    (1, 32, 4096, 32, 8, 128, 4096, 4000, None, False),  # finalize form
    (4, 32, 2080, 32, 8, 128, 2048, None, None, False),  # lockstep prefill
    (2, 8, 300, 4, 2, 32, 292, None, None, True),  # monolithic form
    (2, 40, 250, 4, 2, 64, 250, 200, 30, True),  # two row tiles, window
    (1, 32, 4096, 32, 8, 128, 4096, 3968, None, False),  # window finalize
    (1, 2048, 2048, 32, 8, 128, 2048, 0, None, False),  # monolithic h2o
    (4, 32, 2080, 25, 5, 64, 2048, None, 1024, False),  # hymba local layer
    (4, 32, 2080, 25, 5, 64, 2048, None, None, False),  # hymba global layer
    # the edges of the bf16 tensor-core tile: each head's rows padded to
    # 16, 8 such fragments of the G heads to a row block, 64-key tiles
    (1, 17, 500, 8, 2, 128, 483, None, None, False),  # n_obs 17
    (1, 40, 1000, 32, 8, 128, 1000, 960, None, False),  # n_obs 40
    (2, 17, 300, 10, 2, 64, 300, 283, None, True),  # G 5 at hd 64
    (1, 32, 1000, 8, 2, 128, 1000, 900, 100, False),  # window ends mid-tile
    (1, 32, 1000, 8, 2, 64, 968, None, None, False),  # Sk 1000: a ragged tile
    (1, 32, 4096, 32, 8, 128, 4096, 3850, None, False),  # last split < a tile
    (2, 20, 400, 8, 2, 32, 380, None, None, "dead"),  # every row invalid
    # 16 x 32k prompts: launch (b)'s key ranges capped by shared memory
    (16, 32, 32800, 32, 8, 128, 32768, None, None, False),
])
def test_lookahead_score_matches_plain(dev, dtype, B, n_obs, Sk, H, KV, hd,
                                       n_prompt, off, window, masks):
    g = torch.Generator(device=dev).manual_seed(1)
    q = _randn(g, (B, n_obs, H, hd), dtype, dev)
    k = _randn(g, (B, Sk, KV, hd), dtype, dev)
    kvm = rv = None
    if masks:
        kvm = torch.rand((B, n_prompt), generator=g, device=dev) > 0.2
        rv = torch.rand((B, n_obs), generator=g, device=dev) > 0.3
        rv[0, 0] = False
        if masks == "dead":
            rv[-1] = False  # a sequence with no valid row
    got = lk.lookahead_score(q, k, n_prompt, kv_mask=kvm, window=window,
                             q_offset=off, row_valid=rv)
    torch.cuda.synchronize()
    want = ref.lookahead_score(q, k, n_prompt, kv_mask=kvm, window=window,
                               q_offset=off, row_valid=rv)
    atol = min(1e-5, 2 ** -16 * float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=atol, rtol=1e-4)
    if masks == "dead":
        assert torch.all(got[-1] == 0)


def test_lookahead_score_is_two_launches(dev):
    """One wrapper call is one count and two CUDA launches: the tensor-core
    kernels in bf16 (main-path shape: 16 key splits), the FMA kernels in
    float32."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(12)
    B, n_obs, Sk, H, KV, hd = 1, 32, 4096, 32, 8, 128
    assert lk.key_splits(B, n_obs, H, KV, 4032, build.sm_count(dev)) > 1
    for dtype, part in ((torch.bfloat16, "_mma"), (torch.float32, "")):
        q = _randn(g, (B, n_obs, H, hd), dtype, dev)
        k = _randn(g, (B, Sk, KV, hd), dtype, dev)
        lk.lookahead_score(q, k, Sk, q_offset=4000)  # built and warm
        before = lk.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lk.lookahead_score(q, k, Sk, q_offset=4000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 2, names
        assert f"obs_row_stats{part}" in names[0], names
        assert f"obs_column_means{part}" in names[1], names
        assert lk.launches == before + 1


#: split counts forced on kernels 4 and 5 (None: ``row_splits``'s pick)
PAGED_SPLITS = [None, 1, 2, 4, 8]


def _force_splits(monkeypatch, n):
    """Replace kernels 4 and 5's split rule by a constant ``n`` (None keeps
    the rule)."""
    if n is not None:
        monkeypatch.setattr(pk, "row_splits", lambda *a, **kw: n)


@pytest.mark.parametrize("splits", PAGED_SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_decode_matches_plain(dev, dtype, window, splits, monkeypatch):
    _force_splits(monkeypatch, splits)
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, KV, hd, bs, N, nb = 4, 32, 8, 128, 16, 96, 19
    q = _randn(g, (B, H, hd), dtype, dev)
    kp = _randn(g, (N, bs, KV, hd), dtype, dev)
    vp = _randn(g, (N, bs, KV, hd), dtype, dev)
    mask = torch.rand((N, bs, KV), generator=g, device=dev) > 0.2
    mask[0] = False  # the null block
    mask[5] = False  # an allocated, fully masked block
    pos = torch.randint(0, 300, (N, bs, KV), generator=g, device=dev,
                        dtype=torch.int32)
    rng = np.random.default_rng(2)
    table = torch.as_tensor(rng.permutation(np.arange(1, N))[:B * nb]
                            .reshape(B, nb).astype(np.int32), device=dev)
    table[1, 10:] = 0  # ragged: null tail
    table[2] = 0  # between requests: all null -> exact zeros
    table[3, :] = 5  # fully masked -> exact zeros
    new_pos = torch.full((B,), 300, dtype=torch.int32, device=dev)
    got = pk.paged_decode_attention(q, kp, vp, mask, table, pos_pool=pos,
                                    new_pos=new_pos, window=window)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention(q, kp, vp, mask, table, pos_pool=pos,
                                      new_pos=new_pos, window=window)
    _assert_rows_close(got, want, dtype, 2 ** -7)
    assert torch.all(got[2:] == 0)


@pytest.mark.parametrize("splits", PAGED_SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,window,bs,nb,layout", [
    (32, 8, 128, None, 16, 20, "ragged"),  # llama3-8b, decode eviction
    (32, 8, 128, 40, 16, 20, "ragged"),
    (8, 8, 64, None, 16, 20, "ragged"),  # G = 1
    (16, 2, 32, 25, 16, 20, "ragged"),  # G = 8
    (32, 2, 64, None, 16, 20, "ragged"),  # G = 16: four passes of 4 heads
    (64, 2, 128, 40, 16, 20, "ragged"),  # G = 32: eight passes
    (32, 8, 128, None, 16, 20, "one live slot"),
    (32, 8, 128, None, 16, 20, "a split all null or masked"),
    (32, 8, 64, None, 16, 3, "ragged"),  # fewer blocks than splits
    (32, 8, 128, 40, 7, 20, "ragged"),  # a block size other than 16
])
def test_paged_decode_masses_matches_plain(dev, dtype, H, KV, hd, window,
                                           bs, nb, layout, splits,
                                           monkeypatch):
    """Kernels 4 and 5 on one input, at each forced split: kernel 5's out
    bitwise kernel 4's, out within tolerance of the plain version and
    exact zeros on a (sequence, head) with no live row, masses within
    2^-16 per row, exact zeros on dead rows, live rows summing to 1."""
    _force_splits(monkeypatch, splits)
    g = torch.Generator(device=dev).manual_seed(6)
    B, N = 4, 96
    q = _randn(g, (B, H, hd), dtype, dev)
    kp = _randn(g, (N, bs, KV, hd), dtype, dev)
    vp = _randn(g, (N, bs, KV, hd), dtype, dev)
    mask = torch.rand((N, bs, KV), generator=g, device=dev) > 0.2
    mask[0] = False  # the null block
    pos = torch.randint(0, 320, (N, bs, KV), generator=g, device=dev,
                        dtype=torch.int32)
    rng = np.random.default_rng(6)
    table = torch.as_tensor(rng.permutation(np.arange(1, N))[:B * nb]
                            .reshape(B, nb).astype(np.int32), device=dev)
    if layout == "ragged":
        table[1, 9:] = 0  # ragged: null tail
        table[0, min(4, nb - 1)] = 0  # a gap
        table[2] = 0  # between requests: all null -> zero out and masses
        mask[table[3].long(), :, KV - 1] = False  # a fully masked kv head
    elif layout == "one live slot":
        table[1:] = 0  # three slots between requests
    else:
        # blocks 10-19 null in sequence 0 and 0-9 masked in sequence 1:
        # whole ranks of 2, 4 and 8 splits see no live row
        table[0, 10:] = 0
        mask[table[1, :10].long()] = False
    new_pos = torch.full((B,), 320, dtype=torch.int32, device=dev)
    kw = dict(pos_pool=pos, new_pos=new_pos, window=window)
    out, masses = pk.paged_decode_masses(q, kp, vp, mask, table, **kw)
    plain4 = pk.paged_decode_attention(q, kp, vp, mask, table, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain4), "out must be bitwise kernel 4's"
    _assert_rows_close(out, ref.paged_decode_attention(
        q, kp, vp, mask, table, **kw), dtype, 2 ** -7)
    want = ref.paged_decode_masses(q, kp, mask, table, **kw)
    err = (masses - want).abs().amax(-1)
    tol = 2 ** -16 * want.abs().amax(-1)
    assert bool(torch.all(err <= tol)), float((err - tol).max())
    if layout == "ragged":
        assert torch.all(masses[2] == 0)
        assert torch.all(masses[3, (KV - 1) * (H // KV):] == 0)
    elif layout == "one live slot":
        assert torch.all(masses[1:] == 0) and torch.all(out[1:] == 0)
    assert torch.all(masses[want == 0] == 0), "dead rows must be exact zeros"
    sums = masses.sum(-1)
    live = want.sum(-1) > 0
    assert torch.all(out[~live] == 0), "a head with no live row: zeros"
    torch.testing.assert_close(sums[live], torch.ones_like(sums[live]),
                               atol=1e-4, rtol=0)


def test_paged_decode_is_one_cluster_launch(dev, monkeypatch):
    """Kernels 4 and 5 each make one launch per call at the main path's
    shape, where the rule splits each (sequence, kv head)'s rows over
    more than one CTA; a split count the card cannot launch raises."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(11)
    B, H, KV, hd, bs, N, nb = 4, 32, 8, 128, 16, 96, 19
    q = _randn(g, (B, H, hd), torch.bfloat16, dev)
    kp = _randn(g, (N, bs, KV, hd), torch.bfloat16, dev)
    mask = torch.ones((N, bs, KV), dtype=torch.bool, device=dev)
    table = torch.arange(1, B * nb + 1, dtype=torch.int32,
                         device=dev).reshape(B, nb)
    assert pk.row_splits(B, KV, nb, bs, build.sm_count(dev)) > 1
    pk.paged_decode_masses(q, kp, kp, mask, table)  # built and warm
    before = ops.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pk.paged_decode_attention(q, kp, kp, mask, table)
        pk.paged_decode_masses(q, kp, kp, mask, table)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("paged_decode" in n for n in names) == 1, names
    assert sum("paged_masses" in n for n in names) == 1, names
    after = ops.launch_counts()
    assert after["paged_decode_attention"] == \
        before["paged_decode_attention"] + 1
    assert after["paged_decode_masses"] == before["paged_decode_masses"] + 1
    _force_splits(monkeypatch, 9)  # past the portable cluster size
    with pytest.raises(RuntimeError, match="paged_decode_attention"):
        pk.paged_decode_attention(q, kp, kp, mask, table)
    assert pk.launches == after["paged_decode_attention"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (4, 2080, 32, 8, 128, True, None),  # lockstep prefill of llama3-8b
    (2, 333, 8, 2, 64, True, None),  # S not a multiple of the tile
    (2, 300, 4, 2, 32, False, None),  # every key visible
    (1, 257, 8, 2, 64, True, 48),  # sliding window
    (1, 200, 4, 1, 128, False, 40),  # window without the causal mask
    (4, 2080, 25, 5, 64, True, 1024),  # hymba-1.5b's local layers
    (4, 2080, 25, 5, 64, True, None),  # hymba-1.5b's global layers
    # the edges of the Hopper tile (bf16, hd 64 and 128): 128-row query
    # tiles of two 64-row warpgroups, 128-key K/V tiles
    (1, 1, 8, 2, 128, True, None),  # one row
    (1, 64, 8, 2, 128, True, None),  # one warpgroup's rows exactly
    (1, 127, 8, 2, 64, True, None),  # one row short of a tile
    (1, 128, 8, 2, 128, True, None),  # one tile exactly
    (1, 129, 8, 2, 64, True, None),  # one row past a tile
    (1, 2080, 8, 2, 128, True, None),  # the served length, a ragged tail
    (1, 700, 8, 2, 128, True, 1),  # each row sees only itself
    (1, 700, 8, 2, 64, True, 64),  # a window inside one key tile
    (1, 700, 8, 2, 128, True, 100),  # a window that straddles key tiles
    (1, 700, 8, 2, 64, True, 128),  # a window of exactly one key tile
    (2, 1500, 8, 2, 128, True, 1024),  # hymba's window at llama's head dim
    (1, 300, 4, 4, 128, True, None),  # GQA ratio 1
    (1, 333, 10, 2, 64, True, None),  # GQA ratio 5
    (2, 300, 8, 2, 128, False, None),  # every key visible, ragged tail
    (1, 333, 8, 2, 64, False, 100),  # window without the causal mask
    (3, 260, 8, 2, 128, True, None),  # B = 3
])
def test_flash_attention_matches_plain(dev, dtype, B, S, H, KV, hd, causal,
                                       window):
    g = torch.Generator(device=dev).manual_seed(4)
    q = _randn(g, (B, S, H, hd), dtype, dev)
    k = _randn(g, (B, S, KV, hd), dtype, dev)
    v = _randn(g, (B, S, KV, hd), dtype, dev)
    got = fk.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    _assert_rows_close(got, want, dtype, 2 ** -5)


def _key_mask(B, S, lens, n_obs, dev, lead=0):
    """(B, S) bool: keys below each row's true length valid, the last
    ``n_obs`` keys (observation rows after the padding) valid, and the
    first ``lead`` keys of sequence 0 masked."""
    j = torch.arange(S, device=dev)
    lens = torch.as_tensor(lens, device=dev)
    mask = (j < lens[:, None]) | (j >= S - n_obs)
    mask[0, :lead] = False
    return mask.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,lens,n_obs,causal,lead", [
    # the padded prefill of llama3-8b (phase 1's shape), hd 64 and 32
    (4, 1024, 32, 8, 128, (512, 700, 900, 1024), 0, True, 0),
    (4, 1024, 8, 2, 64, (512, 700, 900, 1024), 0, True, 0),
    (2, 300, 4, 2, 32, (17, 300), 0, True, 0),
    # observation rows after the padding (lookaheadkv's 32): key tiles
    # with no valid key between the prompt and them
    (2, 1056, 8, 2, 128, (100, 1024), 32, True, 0),
    (2, 700, 8, 2, 64, (1, 600), 32, True, 0),
    # tile edges: lengths at and around 128, B = 3, GQA 5
    (3, 260, 8, 2, 128, (127, 128, 129), 0, True, 0),
    (1, 333, 10, 2, 64, (200,), 5, True, 0),
    # every key visible: the first 200 keys of sequence 0 masked (a tile
    # with no valid key, then rows whose running max is -inf when the
    # next tile arrives), key 0 of sequence 1 masked
    (2, 600, 8, 2, 128, (600, 600), 0, False, 200),
    (2, 300, 4, 2, 32, (300, 299), 1, False, 1),
])
def test_flash_attention_masked_matches_plain(dev, dtype, B, S, H, KV, hd,
                                              lens, n_obs, causal, lead):
    """Kernel 7 under a key mask (every row keeps a valid key) against
    its plain version."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = _randn(g, (B, S, H, hd), dtype, dev)
    k = _randn(g, (B, S, KV, hd), dtype, dev)
    v = _randn(g, (B, S, KV, hd), dtype, dev)
    mask = _key_mask(B, S, lens, n_obs, dev, lead)
    if not causal:
        mask[1, 0] = False
    got = fk.flash_attention(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=causal, kv_mask=mask)
    assert bool(torch.isfinite(got.float()).all())
    _assert_rows_close(got, want, dtype, 2 ** -5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_attention_masked_key0_stays_finite(dev, dtype, hd):
    """Key 0 masked under the causal mask: row 0 sees no valid key (outside
    the contract) and comes out as exact zeros, never NaN; every other
    row matches the plain version."""
    g = torch.Generator(device=dev).manual_seed(12)
    B, S, H, KV = 2, 300, 8, 2
    q = _randn(g, (B, S, H, hd), dtype, dev)
    k = _randn(g, (B, S, KV, hd), dtype, dev)
    v = _randn(g, (B, S, KV, hd), dtype, dev)
    mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    mask[0, 0] = False
    got = fk.flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got[0, 0] == 0).all())
    want = ref.flash_attention(q, k, v, kv_mask=mask)
    _assert_rows_close(got[0, 1:], want[0, 1:], dtype, 2 ** -5)
    _assert_rows_close(got[1], want[1], dtype, 2 ** -5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mask_all_valid_is_unmasked(dev, dtype):
    """An all-true mask gives the unmasked call's result (bf16: the same
    tile with every key tile unmasked, bitwise); one launch per call."""
    g = torch.Generator(device=dev).manual_seed(13)
    q = _randn(g, (2, 333, 8, 2 * 64), dtype, dev)
    k = _randn(g, (2, 333, 2, 128), dtype, dev)
    v = _randn(g, (2, 333, 2, 128), dtype, dev)
    before = fk.launches
    got = fk.flash_attention(q, k, v, kv_mask=torch.ones(
        (2, 333), dtype=torch.bool, device=dev))
    want = fk.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fk.launches == before + 2
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="kv_mask"):
        fk.flash_attention(q, k, v, kv_mask=torch.ones(
            (2, 333), dtype=torch.uint8, device=dev))
    assert fk.launches == before + 2


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_sm90_counts_one_launch(dev, hd):
    """The bf16 tile at hd 64 and 128 is one launch per call."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = _randn(g, (2, 200, 8, hd), torch.bfloat16, dev)
    k = _randn(g, (2, 200, 2, hd), torch.bfloat16, dev)
    v = _randn(g, (2, 200, 2, hd), torch.bfloat16, dev)
    before = ops.launch_counts()
    ops.flash_attention(q, k, v)
    assert fk.launches == before["flash_attention"] + 1
    ops.flash_attention(q, k, v, causal=False, window=64)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 2
    assert {n: c for n, c in after.items() if n != "flash_attention"} == \
        {n: c for n, c in before.items() if n != "flash_attention"}


#: split counts forced on kernel 6 (None: ``row_splits``' pick)
DENSE_SPLITS = [None, 1, 2, 4, 8]


def _force_dense_splits(monkeypatch, n):
    """Replace kernel 6's split rule by a constant ``n`` (None keeps the
    rule)."""
    if n is not None:
        monkeypatch.setattr(dk, "row_splits", lambda *a, **kw: n)


@pytest.mark.parametrize("splits", DENSE_SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,mask_kind,heads", [
    # dense decode of llama3-8b: budget 256 + 33 append rows
    (289, 3, (32, 8, 128)),
    (289, 2, (32, 8, 128)),
    (100, 0, (32, 8, 128)),
    (70, 3, (32, 8, 128)),
    (3, 3, (32, 8, 128)),  # fewer rows than splits
    (1, 2, (32, 8, 128)),  # one row
    (1, 0, (32, 8, 128)),
    (200, 3, (8, 8, 64)),  # G 1
    (200, 3, (10, 2, 64)),  # G 5: a pass of 4 heads, then one of 1
    (200, 2, (64, 8, 128)),  # G 8
    (150, 3, (32, 2, 32)),  # G 16 at hd 32
    (150, 0, (64, 2, 64)),  # G 32
])
def test_decode_attention_matches_plain(dev, dtype, C, mask_kind, heads,
                                        splits, monkeypatch):
    _force_dense_splits(monkeypatch, splits)
    g = torch.Generator(device=dev).manual_seed(5)
    B = 4
    H, KV, hd = heads
    G = H // KV
    q = _randn(g, (B, H, hd), dtype, dev)
    k = _randn(g, (B, C, KV, hd), dtype, dev)
    v = _randn(g, (B, C, KV, hd), dtype, dev)
    mask = None
    dead = min(5, KV - 1)
    if mask_kind == 3:
        mask = torch.rand((B, C, KV), generator=g, device=dev) > 0.3
        mask[1, :, dead] = False  # a fully masked head -> exact zeros
        mask[2] = False  # a sequence with no valid row -> exact zeros
    elif mask_kind == 2:
        mask = torch.rand((B, C), generator=g, device=dev) > 0.3
        mask[2] = False
    got = dk.decode_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    want = ref.decode_attention(q, k, v, kv_mask=mask)
    _assert_rows_close(got, want, dtype, 2 ** -7)
    if mask is not None:
        assert torch.all(got[2] == 0)
    if mask_kind == 3:
        assert torch.all(got[1, dead * G:(dead + 1) * G] == 0)


@pytest.mark.parametrize("splits", DENSE_SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 1024])
def test_decode_attention_at_hymba_shape(dev, dtype, window, splits,
                                         monkeypatch):
    """hymba-1.5b's lockstep decode: 4 x 289 rows, 25 q / 5 kv heads of
    64, the per-kv-head mask with the sliding window folded in (local
    layers) or not (global layers)."""
    _force_dense_splits(monkeypatch, splits)
    g = torch.Generator(device=dev).manual_seed(7)
    B, C, H, KV, hd = 4, 289, 25, 5, 64
    q = _randn(g, (B, H, hd), dtype, dev)
    k = _randn(g, (B, C, KV, hd), dtype, dev)
    v = _randn(g, (B, C, KV, hd), dtype, dev)
    mask = torch.rand((B, C, KV), generator=g, device=dev) > 0.05
    mask[:, 272:] = False  # appends not written yet
    if window is not None:
        pos = torch.randint(0, 2100, (B, C, KV), generator=g, device=dev)
        mask &= (2080 - pos) < window
    got = dk.decode_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    _assert_rows_close(got, ref.decode_attention(q, k, v, kv_mask=mask),
                       dtype, 2 ** -7)


def test_decode_attention_is_one_cluster_launch(dev, monkeypatch):
    """Kernel 6 makes one launch per call at the main path's shape, where
    the rule splits each (sequence, kv head)'s rows over more than one
    CTA; a split count the card cannot launch raises."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(13)
    B, C, H, KV, hd = 4, 289, 32, 8, 128
    q = _randn(g, (B, H, hd), torch.bfloat16, dev)
    k = _randn(g, (B, C, KV, hd), torch.bfloat16, dev)
    mask = torch.ones((B, C, KV), dtype=torch.bool, device=dev)
    assert dk.row_splits(B, KV, C, build.sm_count(dev)) > 1
    dk.decode_attention(q, k, k, kv_mask=mask)  # built and warm
    before = dk.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dk.decode_attention(q, k, k, kv_mask=mask)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "decode_kernel" in names[0], names
    assert dk.launches == before + 1
    _force_dense_splits(monkeypatch, 9)  # past the portable cluster size
    with pytest.raises(RuntimeError, match="decode_attention"):
        dk.decode_attention(q, k, k, kv_mask=mask)
    assert dk.launches == before + 1


def _ssd_case(rng):
    """The JAX package's sweep (tests/test_kernels.py): whole chunks."""
    hd = int(rng.choice([16, 32]))
    nh = int(rng.choice([2, 4, 8]))
    ds = int(rng.choice([8, 16]))
    chunk = int(rng.choice([16, 32]))
    nc = int(rng.integers(1, 5))
    return (int(rng.integers(1, 3)), chunk * nc, nh, hd, ds, chunk)


def _ssd_inputs(g, B, S, nh, hd, ds, dtype, dev):
    x = _randn(g, (B, S, nh, hd), dtype, dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=g, device=dev))
    A = -torch.exp(torch.randn((nh,), generator=g, device=dev) * 0.5)
    Bm = _randn(g, (B, S, 1, ds), dtype, dev)
    Cm = _randn(g, (B, S, 1, ds), dtype, dev)
    h0 = torch.randn((B, nh, hd, ds), generator=g, device=dev)
    return x, dt, A, Bm, Cm, h0


def _assert_ssd_close(got, want):
    (gy, gh), (wy, wh) = got, want
    assert gy.dtype == gh.dtype == torch.float32
    err = (gy - wy).abs().amax(-1)
    tol = 2 ** -12 * wy.abs().amax(-1)
    bad = err > tol
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} y rows out of tolerance; first "
        f"at {tuple(int(i) for i in bad.nonzero()[0])}")
    assert float((gh - wh).abs().max()) <= 2 ** -12 * float(wh.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sweep_cases(7, 8, _ssd_case) + [
    (2, 45, 5, 16, 8, 16),  # ragged tail, odd head count
    (1, 7, 3, 32, 16, 32),  # S < chunk
    (2, 1, 5, 32, 8, 32),  # one row
    (1, 300, 7, 64, 16, 256),  # chunk 256, ragged
    (2, 130, 50, 64, 16, 128),  # hymba-1.5b's 50 heads, ragged
    (1, 200, 3, 64, 128, 64),  # mamba2's d_state
    (1, 96, 4, 32, 32, 32),
    (1, 80, 2, 16, 64, 16),
    (4, 2048, 50, 64, 16, 128),  # 50 heads in blocks of 8: a ragged block
    (8, 2048, 13, 64, 16, 128),  # 13 heads in blocks of 4
    (2, 4096, 8, 64, 128, 128),  # 32 chunks through the state pass
    (2, 64, 8, 32, 16, 1),  # chunk 1
    (2, 300, 6, 64, 8, 128),  # d_state 8 at hd 64
    (1, 600, 3, 64, 128, 256),  # chunk 256 at d_state 128 (one buffer)
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_plain(dev, dtype, case, with_state):
    B, S, nh, hd, ds, chunk = case
    g = torch.Generator(device=dev).manual_seed(8)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(g, B, S, nh, hd, ds, dtype, dev)
    h0 = h0 if with_state else None
    got = sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    _assert_ssd_close(got, ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                                initial_state=h0))


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk", [
    (4, 2048, 50, 64, 16, 128),  # hymba-1.5b's prompt segment
    (4, 32, 50, 64, 16, 128),  # ... and its lookahead segment
    (4, 2048, 24, 64, 128, 128),  # mamba2-130m
])
def test_ssd_scan_at_model_shapes_on_strided_views(dev, B, S, nh, hd, ds,
                                                  chunk):
    """The model's call: x, B and C are views of one conv output (rows
    strided by conv_dim), bf16; the second hymba segment carries a
    state."""
    g = torch.Generator(device=dev).manual_seed(9)
    xbc = _randn(g, (B, S, nh * hd + 2 * ds), torch.bfloat16, dev)
    x, Bm, Cm = torch.split(xbc, [nh * hd, ds, ds], dim=-1)
    x = x.unflatten(-1, (nh, hd))
    Bm, Cm = Bm.unflatten(-1, (1, ds)), Cm.unflatten(-1, (1, ds))
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=g, device=dev) - 2.0)
    A = -(1.0 + 15.0 * torch.rand((nh,), generator=g, device=dev))
    h0 = torch.randn((B, nh, hd, ds), generator=g, device=dev) \
        if S < chunk else None
    assert not x.is_contiguous()
    got = sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    _assert_ssd_close(got, ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                                initial_state=h0))


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 8])
def test_ssd_scan_head_blocks_match_plain(dev, heads, monkeypatch):
    """bf16 with ``heads`` heads forced into each CTA of launches (a) and
    (c): 13 heads leave a ragged last block at every size but 1."""
    monkeypatch.setattr(sk, "head_block", lambda *a, **kw: heads)
    g = torch.Generator(device=dev).manual_seed(11)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(g, 2, 300, 13, 64, 16,
                                       torch.bfloat16, dev)
    got = sk.ssd_scan(x, dt, A, Bm, Cm, chunk=128, initial_state=h0)
    torch.cuda.synchronize()
    _assert_ssd_close(got, ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=128,
                                                initial_state=h0))


def test_ssd_scan_is_three_launches(dev):
    """One wrapper call is one count and three CUDA launches: chunk
    states, the state pass, the chunk scan (the tensor-core kernels in bf16
    at hymba-1.5b's shape, the FMA kernels in float32)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(13)
    B, S, nh, hd, ds, chunk = 4, 2048, 50, 64, 16, 128
    for dtype, part in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(g, B, S, nh, hd, ds, dtype, dev)
        sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)  # built and warm
        before = sk.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 3, names
        for name, want in zip(names, (f"ssd_chunk_states_{part}",
                                      "ssd_state_pass",
                                      f"ssd_chunk_scan_{part}")):
            assert want in name, names
        assert sk.launches == before + 1


def test_ssd_scan_refuses_what_it_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(10)
    x, dt, A, Bm, Cm, _ = _ssd_inputs(g, 1, 40, 2, 32, 16, torch.float32,
                                      dev)
    before = sk.launches
    for kw, what in ((dict(x=x[..., :24].contiguous()), "head_dim"),
                     (dict(chunk=512), "chunk"),
                     (dict(dt=dt.to(torch.bfloat16)), "float32"),
                     (dict(Bm=Bm.to(torch.bfloat16)), "dtypes"),
                     (dict(Cm=torch.stack([Cm, Cm], -1)[..., 0]),
                      "contiguous rows")):
        args = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, chunk=32)
        args.update(kw)
        with pytest.raises(ValueError, match=what):
            sk.ssd_scan(args.pop("x"), args.pop("dt"), args.pop("A"),
                        args.pop("Bm"), args.pop("Cm"), **args)
    # two sequences whose rows interleave: no batch stride of S rows
    x2 = _randn(g, (40, 2, 2, 32), torch.float32, dev).transpose(0, 1)
    bc2 = _randn(g, (2, 40, 1, 16), torch.float32, dev)
    with pytest.raises(ValueError, match="batch stride"):
        sk.ssd_scan(x2, torch.rand((2, 40, 2), device=dev), A, bc2, bc2,
                    chunk=32)
    assert sk.launches == before


def test_wrappers_count_launches(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    q = _randn(g, (1, 8, 4, 32), torch.float32, dev)
    k = _randn(g, (1, 64, 2, 32), torch.float32, dev)
    before = ck.launches
    ck.chunk_attention(q, k, k, q_offset=10)
    assert ck.launches == before + 1
    with pytest.raises(ValueError, match="does not fit"):
        ck.chunk_attention(q, k, k, q_offset=60)
    assert ck.launches == before + 1
    counts = ops.launch_counts()
    fk.flash_attention(k, k, k, causal=False)
    dk.decode_attention(q[:, 0], k, k, kv_mask=torch.ones(
        (1, 64, 2), dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="kv_mask"):
        dk.decode_attention(q[:, 0], k, k, kv_mask=torch.ones((1, 64, 3),
                                                               device=dev))
    table = torch.ones((1, 4), dtype=torch.int32, device=dev)
    pool = k[0].reshape(4, 16, 2, 32)
    pmask = torch.ones((4, 16, 2), dtype=torch.bool, device=dev)
    ck.chunk_attention_masses(q, k, k, q_offset=10, n_total=15)
    pk.paged_decode_masses(q[:, 0], pool, pool, pmask, table)
    ops.paged_decode_attention(q[:, 0], pool, pool, pmask, table, depth=40,
                               score_masses=True)
    after = ops.launch_counts()
    assert after["chunk_attention_masses"] == \
        counts["chunk_attention_masses"] + 1
    assert after["chunk_attention"] == counts["chunk_attention"]
    assert after["flash_attention"] == counts["flash_attention"] + 1
    assert after["decode_attention"] == counts["decode_attention"] + 1
    assert after["paged_decode_masses"] == counts["paged_decode_masses"] + 2
    assert after["paged_decode_attention"] == \
        counts["paged_decode_attention"]
    x = _randn(g, (1, 40, 2, 32), torch.float32, dev)
    dt = torch.rand((1, 40, 2), generator=g, device=dev)
    A = -torch.ones((2,), device=dev)
    bc = _randn(g, (1, 40, 1, 16), torch.float32, dev)
    ops.ssd_scan(x, dt, A, bc, bc, chunk=32)
    assert ops.launch_counts()["ssd_scan"] == after["ssd_scan"] + 1
