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

The learning loop's card cases: a kernel entry given a CUDA tensor that
requires a gradient raises and launches nothing, ``reference_mode()``
runs the plain version with its gradient (above ``ref.DIRECT_SEQ`` keys
the streaming attention, against the direct plain form), and a
checkpoint written from the card loads back onto it bit for bit.
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


def _device_work_per_call(fn, tmp_path, n_calls=4):
    """The device work of each of ``n_calls`` calls of ``fn`` under one
    profile: per call, the names of its kernel launches, copies and
    memsets in launch order, or None where the trace cannot tell.  Each
    call runs in its own ``record_function`` range; its host launch
    records are tied to their device records through the trace's
    correlation ids, never through timestamps, and a call is None when a
    host record's device record is missing (the profiler drops or
    delivers late a short call's device records, which an empty list of
    device events in a one-call profile once showed)."""
    import json
    import re

    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_calls):
            with record_function(f"launch_check_{i}"):
                fn()
                torch.cuda.synchronize()
    trace = tmp_path / f"trace_{len(list(tmp_path.iterdir()))}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    device = {ev["args"]["correlation"]: ev for ev in events
              if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "correlation" in ev.get("args", {})}
    host = sorted((ev for ev in events
                   if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                   and re.search(r"Launch|Memcpy|Memset",
                                 ev.get("name", ""))),
                  key=lambda ev: ev["ts"])
    out = []
    for i in range(n_calls):
        r = next((ev for ev in events if ev.get("cat") == "user_annotation"
                  and ev.get("name") == f"launch_check_{i}"), None)
        mine = [] if r is None else [
            ev for ev in host if r["ts"] <= ev["ts"] <= r["ts"] + r["dur"]]
        ids = [ev.get("args", {}).get("correlation") for ev in mine]
        out.append([device[c]["name"] for c in ids]
                   if mine and all(c in device for c in ids) else None)
    return out


def _assert_launches_each(fn, parts, tmp_path):
    """Every call of ``fn`` whose trace is whole launches exactly
    ``len(parts)`` kernels, the i-th named with ``parts[i]``, and nothing
    else (no copy, no memset); a profile in which no call's trace is whole
    is taken again, up to three times in all."""
    for _ in range(3):
        whole = [c for c in _device_work_per_call(fn, tmp_path)
                 if c is not None]
        for names in whole:
            assert len(names) == len(parts) and all(
                p in n for p, n in zip(parts, names)), names
        if whole:
            return
    pytest.fail(f"no call's trace was whole in three profiles ({parts})")


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
    # hd 256 (gemma3-1b: 4 / 1 heads; the tile's 64-key K/V tiles)
    (1, 256, 4096, 4, 1, 256, 3840, 512),  # a local layer's chunk
    (1, 256, 4096, 4, 1, 256, 3840, None),  # a global layer's chunk
    (1, 32, 4096, 4, 1, 256, 4000, 512),  # the observation pass
    (1, 1, 100, 4, 1, 256, 0, None),  # one row
    (1, 129, 1000, 4, 1, 256, 100, None),  # ragged C and K
    (1, 256, 4096, 4, 1, 256, 3840, 32),  # a window below a key tile
    (1, 200, 1000, 4, 1, 256, 650, 100),  # a window across key tiles
    (1, 100, 1000, 8, 1, 256, 700, None),  # G 8
    (3, 129, 1000, 4, 1, 256, 100, None),  # B = 3
    (1, 1024, 1024, 4, 1, 256, 0, None),  # key splits
    # deepseek-moe-16b: MHA, 16 / 16 heads of 128 (G 1)
    (1, 256, 4096, 16, 16, 128, 3840, None),  # a deep chunk
    (1, 32, 4096, 16, 16, 128, 4000, None),  # the observation pass
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
    # hd 256 (gemma3-1b): column masses over 128-key tiles beside the
    # attention tile's 64-key ones
    (1, 256, 4096, 4, 1, 256, 3840, 4000, 512),  # a local layer's h2o chunk
    (1, 256, 4096, 4, 1, 256, 3840, 4000, None),  # a global layer's
    (1, 129, 1000, 4, 1, 256, 100, 229, 32),  # a window below a key tile
    (2, 100, 1000, 4, 1, 256, 700, 790, None),  # K ragged, B = 2
    (1, 1024, 1024, 4, 1, 256, 0, 1000, None),  # key splits
    # deepseek-moe-16b's h2o chunk (G 1 at hd 128)
    (1, 256, 4096, 16, 16, 128, 3840, 4000, None),
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


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_chunk_attention_sm90_counts_one_launch(dev, hd):
    """Kernel 1 on the bf16 tile at hd 64, 128 and 256 counts one launch per
    call, kernel 2 one per call, whatever launches the call makes inside
    (the combine of a split key range, kernel 2's column masses)."""
    g = torch.Generator(device=dev).manual_seed(10)
    q = _randn(g, (1, 32, 8, hd), torch.bfloat16, dev)
    k = _randn(g, (1, 1000, 2, hd), torch.bfloat16, dev)
    v = _randn(g, (1, 1000, 2, hd), torch.bfloat16, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 932 visible keys: 8 tiles of 128, or 15 of 64 at hd 256
    assert ck.key_splits(1, 32, 8, 1000, hd, q.dtype, q_offset=900,
                         window=None, sms=sms) == (3 if hd == 256 else 2)
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
    # hd 256 (gemma3-1b): A fragments read from shared memory per k-step
    (1, 32, 4096, 4, 1, 256, 4096, 4000, 512, False),  # a local finalize
    (1, 32, 4096, 4, 1, 256, 4096, 4000, None, False),  # a global one
    (4, 32, 2080, 4, 1, 256, 2048, None, 512, False),  # lockstep prefill
    (2, 40, 700, 4, 1, 256, 700, 640, 96, True),  # masks, a window
    (1, 17, 500, 4, 1, 256, 483, None, None, False),  # n_obs 17
    (1, 32, 4096, 8, 1, 256, 4096, 4000, None, False),  # two row blocks
    # deepseek-moe-16b (G 1: one head per 16-row fragment) and the
    # qwen2-vl-72b backbone (G 8, 64 / 8 heads of 128)
    (1, 32, 4096, 16, 16, 128, 4096, 4000, None, False),  # finalize
    (4, 32, 2080, 16, 16, 128, 2048, None, None, False),  # lockstep
    (4, 32, 2080, 64, 8, 128, 2048, None, None, False),  # qwen2-vl lockstep
    # whisper-small's cross-KV eviction: 32 rows over 1,500 frames, every
    # frame visible (n_prompt == Sk, q_offset = Sk: no observation keys)
    (4, 32, 1500, 12, 12, 64, 1500, 1500, None, False),
    (2, 8, 16, 4, 4, 32, 16, 16, None, False),  # whisper-smoke's
    # the GT pass at the paper's lengths: 512 response rows (16 row
    # blocks of packed rows) over 3,584 + 512 keys; with masks, a window
    (1, 512, 4096, 32, 8, 128, 3584, None, None, False),
    (2, 512, 1100, 32, 8, 128, 588, None, None, True),
    (1, 512, 2000, 32, 8, 128, 1488, None, 256, False),
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


def test_lookahead_score_is_two_launches(dev, tmp_path):
    """One wrapper call is one count and two CUDA launches: the tensor-core
    kernels in bf16 (main-path shape: 16 key splits), the FMA kernels in
    float32 (``_assert_launches_each``: every call whose trace is whole)."""
    g = torch.Generator(device=dev).manual_seed(12)
    B, n_obs, Sk, H, KV, hd = 1, 32, 4096, 32, 8, 128
    assert lk.key_splits(B, n_obs, H, KV, 4032, build.sm_count(dev),
                         hd) > 1
    for dtype, part in ((torch.bfloat16, "_mma"), (torch.float32, "")):
        q = _randn(g, (B, n_obs, H, hd), dtype, dev)
        k = _randn(g, (B, Sk, KV, hd), dtype, dev)
        lk.lookahead_score(q, k, Sk, q_offset=4000)  # built and warm
        _assert_launches_each(
            lambda: lk.lookahead_score(q, k, Sk, q_offset=4000),
            (f"obs_row_stats{part}", f"obs_column_means{part}"), tmp_path)
        before = lk.launches
        lk.lookahead_score(q, k, Sk, q_offset=4000)
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
    # hd 256 (gemma3-1b: 4 / 1 heads; float32 lanes load two pieces)
    (4, 1, 256, None, 16, 20, "ragged"),
    (4, 1, 256, 40, 16, 20, "ragged"),
    (4, 1, 256, 40, 16, 20, "one live slot"),
    (8, 1, 256, None, 16, 20, "a split all null or masked"),
    # deepseek-moe-16b (G 1 at hd 128: a pass holds one head of four)
    (16, 16, 128, None, 16, 19, "ragged"),
    (16, 16, 128, None, 16, 20, "one live slot"),
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


def test_paged_decode_is_one_cluster_launch(dev, monkeypatch, tmp_path):
    """Kernels 4 and 5 each make one launch per call at the main path's
    shape, where the rule splits each (sequence, kv head)'s rows over
    more than one CTA; a split count the card cannot launch raises."""
    g = torch.Generator(device=dev).manual_seed(11)
    B, H, KV, hd, bs, N, nb = 4, 32, 8, 128, 16, 96, 19
    q = _randn(g, (B, H, hd), torch.bfloat16, dev)
    kp = _randn(g, (N, bs, KV, hd), torch.bfloat16, dev)
    mask = torch.ones((N, bs, KV), dtype=torch.bool, device=dev)
    table = torch.arange(1, B * nb + 1, dtype=torch.int32,
                         device=dev).reshape(B, nb)
    assert pk.row_splits(B, KV, nb, bs, build.sm_count(dev)) > 1
    pk.paged_decode_masses(q, kp, kp, mask, table)  # built and warm
    _assert_launches_each(
        lambda: (pk.paged_decode_attention(q, kp, kp, mask, table),
                 pk.paged_decode_masses(q, kp, kp, mask, table)),
        ("paged_decode", "paged_masses"), tmp_path)
    before = ops.launch_counts()
    pk.paged_decode_attention(q, kp, kp, mask, table)
    pk.paged_decode_masses(q, kp, kp, mask, table)
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
    # hd 256 (gemma3-1b: 4 / 1 heads; 64-key K/V tiles in 2 stages)
    (4, 2080, 4, 1, 256, True, None),  # a global layer's lockstep prefill
    (4, 2080, 4, 1, 256, True, 512),  # a local layer's
    (1, 1, 4, 1, 256, True, None),  # one row
    (1, 65, 4, 1, 256, True, None),  # one key past a key tile
    (1, 129, 4, 1, 256, True, None),  # one row past a query tile
    (1, 700, 4, 1, 256, True, 32),  # a window below a key tile
    (2, 300, 4, 1, 256, False, None),  # every key visible
    (1, 333, 8, 1, 256, True, None),  # G 8
    # deepseek-moe-16b (MHA, G 1) and the qwen2-vl-72b backbone (64 / 8)
    (4, 2080, 16, 16, 128, True, None),
    (4, 2080, 64, 8, 128, True, None),
    # whisper-small (MHA, 12 / 12 heads of 64): the encoder over 1,500
    # frames, then S = (Sq, Sk): the cross-attention of 2,080 decoder rows
    # over them, and of one row (a decode step's, on kernel 7 itself)
    (4, 1500, 12, 12, 64, False, None),
    (4, (2080, 1500), 12, 12, 64, False, None),
    (4, (1, 1500), 12, 12, 64, False, None),
    # Sq != Sk at the other head dims, ragged both ways, Sq > Sk, and
    # whisper-smoke's hd 32 (float32 and bf16 on this file's kernels)
    (2, (333, 1000), 8, 2, 128, False, None),
    (1, (129, 127), 8, 2, 128, False, None),
    (1, (700, 100), 8, 2, 64, False, None),
    (2, (129, 65), 4, 1, 256, False, None),
    (2, (40, 16), 4, 4, 32, False, None),
    (2, (1, 16), 4, 4, 32, False, None),
])
def test_flash_attention_matches_plain(dev, dtype, B, S, H, KV, hd, causal,
                                       window):
    """``S`` is the sequence (self-attention) or (Sq, Sk)."""
    Sq, Sk = (S, S) if isinstance(S, int) else S
    g = torch.Generator(device=dev).manual_seed(4)
    q = _randn(g, (B, Sq, H, hd), dtype, dev)
    k = _randn(g, (B, Sk, KV, hd), dtype, dev)
    v = _randn(g, (B, Sk, KV, hd), dtype, dev)
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
    # hd 256 (gemma3-1b): 3k's padded group, lengths around a key tile of
    # 64, masked keys spanning whole key tiles
    (4, 1024, 4, 1, 256, (512, 700, 900, 1024), 0, True, 0),
    (3, 260, 4, 1, 256, (63, 64, 65), 0, True, 0),
    (2, 600, 4, 1, 256, (600, 600), 0, False, 200),
    # cross-attention under a (B, Sk) frame mask, S = (Sq, Sk): whisper's
    # shape, hd 32, one query row, a whole key tile masked at hd 128
    (4, (2080, 1500), 12, 12, 64, (1500, 1400, 1000, 1499), 0, False, 0),
    (2, (40, 300), 4, 2, 32, (17, 300), 0, False, 0),
    (2, (1, 300), 4, 2, 32, (170, 300), 0, False, 0),
    (2, (300, 600), 8, 2, 128, (600, 600), 0, False, 200),
    (2, (129, 65), 4, 1, 256, (64, 65), 0, False, 1),
])
def test_flash_attention_masked_matches_plain(dev, dtype, B, S, H, KV, hd,
                                              lens, n_obs, causal, lead):
    """Kernel 7 under a key mask (every row keeps a valid key) against
    its plain version; ``S`` is the sequence or (Sq, Sk)."""
    Sq, Sk = (S, S) if isinstance(S, int) else S
    g = torch.Generator(device=dev).manual_seed(11)
    q = _randn(g, (B, Sq, H, hd), dtype, dev)
    k = _randn(g, (B, Sk, KV, hd), dtype, dev)
    v = _randn(g, (B, Sk, KV, hd), dtype, dev)
    mask = _key_mask(B, Sk, lens, n_obs, dev, lead)
    if not causal:
        mask[1, 0] = False
    got = fk.flash_attention(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=causal, kv_mask=mask)
    assert bool(torch.isfinite(got.float()).all())
    _assert_rows_close(got, want, dtype, 2 ** -5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_sm90_counts_one_launch(dev, hd):
    """The bf16 tile at hd 64, 128 and 256 is one launch per call, a
    cross-attention (Sq != Sk) too; ``ops.flash_attention`` sends one
    non-causal query row (a decode step's cross-attention) to kernel 6,
    one launch of it, and that route matches the plain version; Sq != Sk
    under a causal mask raises before any launch."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = _randn(g, (2, 200, 8, hd), torch.bfloat16, dev)
    k = _randn(g, (2, 200, 2, hd), torch.bfloat16, dev)
    v = _randn(g, (2, 200, 2, hd), torch.bfloat16, dev)
    before = ops.launch_counts()
    ops.flash_attention(q, k, v)
    assert fk.launches == before["flash_attention"] + 1
    ops.flash_attention(q, k, v, causal=False, window=64)
    kx, vx = k[:, :150].contiguous(), v[:, :150].contiguous()
    ops.flash_attention(q, kx, vx, causal=False)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 3
    assert {n: c for n, c in after.items() if n != "flash_attention"} == \
        {n: c for n, c in before.items() if n != "flash_attention"}
    q1 = q[:, :1].contiguous()
    got = ops.flash_attention(q1, k, v, causal=False)
    torch.cuda.synchronize()
    want = ref.flash_attention(q1, k, v, causal=False)
    _assert_rows_close(got, want, torch.bfloat16, 2 ** -7)
    with pytest.raises(ValueError, match="Sq 200 != Sk 150"):
        ops.flash_attention(q, kx, vx)
    last = ops.launch_counts()
    assert last["decode_attention"] == after["decode_attention"] + 1
    assert {n: c for n, c in last.items() if n != "decode_attention"} == \
        {n: c for n, c in after.items() if n != "decode_attention"}


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
    # hd 256 (gemma3-1b): float32 lanes load two 16-byte pieces a row
    (289, 3, (4, 1, 256)),
    (3, 3, (4, 1, 256)),
    (200, 2, (8, 1, 256)),  # G 8
    # deepseek-moe-16b (G 1 at hd 128) and the qwen2-vl-72b backbone
    (289, 3, (16, 16, 128)),
    (289, 2, (16, 16, 128)),
    (289, 3, (64, 8, 128)),
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


def test_decode_attention_is_one_cluster_launch(dev, monkeypatch, tmp_path):
    """Kernel 6 and its stats entry each make one launch per call at the
    main path's shape, where the rule splits each (sequence, kv head)'s
    rows over more than one CTA; a split count the card cannot launch
    raises."""
    g = torch.Generator(device=dev).manual_seed(13)
    B, C, H, KV, hd = 4, 289, 32, 8, 128
    q = _randn(g, (B, H, hd), torch.bfloat16, dev)
    k = _randn(g, (B, C, KV, hd), torch.bfloat16, dev)
    mask = torch.ones((B, C, KV), dtype=torch.bool, device=dev)
    assert dk.row_splits(B, KV, C, build.sm_count(dev)) > 1
    dk.decode_attention(q, k, k, kv_mask=mask)  # built and warm
    dk.decode_attention_stats(q, k, k, kv_mask=mask)
    before = (dk.launches, dk.stats_launches)
    _assert_launches_each(lambda: dk.decode_attention(q, k, k,
                                                      kv_mask=mask),
                          ("decode_kernel",), tmp_path)
    _assert_launches_each(lambda: dk.decode_attention_stats(
        q, k, k, kv_mask=mask), ("decode_kernel",), tmp_path)
    assert dk.launches > before[0] and dk.stats_launches > before[1]
    counts = (dk.launches, dk.stats_launches)
    dk.decode_attention(q, k, k, kv_mask=mask)
    dk.decode_attention_stats(q, k, k, kv_mask=mask)
    assert (dk.launches, dk.stats_launches) == (counts[0] + 1,
                                                counts[1] + 1)
    _force_dense_splits(monkeypatch, 9)  # past the portable cluster size
    with pytest.raises(RuntimeError, match="decode_attention"):
        dk.decode_attention(q, k, k, kv_mask=mask)
    with pytest.raises(RuntimeError, match="decode_attention_stats"):
        dk.decode_attention_stats(q, k, k, kv_mask=mask)
    assert (dk.launches, dk.stats_launches) == (counts[0] + 1,
                                                counts[1] + 1)


def _assert_stats_close(got, want):
    """Kernel 6's partials against the plain ones, both float32 from the
    same inputs (the logits and sums in another order): m within 1e-4 +
    1e-5 |m| (exactly -1e30 where the plain one is), l within 1e-4 of
    itself, each acc row within 1e-4 of its largest plain magnitude
    (exact zeros where the plain row is)."""
    (gm, gl, ga), (wm, wl, wa) = got, want
    for x in got:
        assert x.dtype == torch.float32
    empty = wl == 0
    assert torch.equal(gm[empty], wm[empty]) and torch.all(gl[empty] == 0)
    assert torch.all(ga[empty] == 0)
    torch.testing.assert_close(gm[~empty], wm[~empty], atol=1e-4,
                               rtol=1e-5)
    torch.testing.assert_close(gl, wl, atol=0, rtol=1e-4)
    err = (ga - wa).abs().amax(-1)
    assert bool(torch.all(err <= 1e-4 * wa.abs().amax(-1))), float(
        err.max())


@pytest.mark.parametrize("splits", DENSE_SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,mask_kind,heads", [
    (289, 3, (32, 8, 128)),  # llama3-8b's heads
    (128, 3, (32, 8, 128)),  # the split decode's hot ring
    (300, 2, (32, 8, 128)),
    (100, 0, (32, 8, 128)),
    (3, 3, (32, 8, 128)),  # fewer rows than splits
    (1, 2, (32, 8, 128)),  # one row
    (289, 3, (4, 1, 256)),  # gemma3-1b: hd 256, G 4
    (200, 3, (8, 8, 64)),  # G 1
    (150, 2, (64, 2, 64)),  # G 32
])
def test_decode_attention_stats_matches_plain(dev, dtype, C, mask_kind,
                                              heads, splits, monkeypatch):
    """Kernel 6's stats entry (m, l, acc) against
    ``ref.decode_attention_stats``, with a dead kv head and a dead
    sequence under the masks; merged over two row segments it is kernel
    6 over the whole cache within kernel 6's tolerance (bf16: each row
    within 2^-7 of its largest plain magnitude)."""
    _force_dense_splits(monkeypatch, splits)
    g = torch.Generator(device=dev).manual_seed(17)
    B = 4
    H, KV, hd = heads
    G = H // KV
    q = _randn(g, (B, H, hd), dtype, dev)
    k = _randn(g, (B, C, KV, hd), dtype, dev)
    v = _randn(g, (B, C, KV, hd), dtype, dev)
    mask = None
    if mask_kind == 3:
        mask = torch.rand((B, C, KV), generator=g, device=dev) > 0.1
        mask[1, :, KV - 1] = False  # a fully masked head
        mask[2] = False  # a sequence with no valid row
    elif mask_kind == 2:
        mask = torch.rand((B, C), generator=g, device=dev) > 0.1
        mask[2] = False
    got = dk.decode_attention_stats(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    want = ref.decode_attention_stats(q, k, v, kv_mask=mask)
    _assert_stats_close(got, want)
    if mask is not None:
        assert torch.all(got[0][2] == -1e30) and torch.all(got[1][2] == 0)
    if mask_kind == 3:
        assert torch.all(got[1][1, (KV - 1) * G:] == 0)
    if C < 2:
        return
    cut = C // 3 + 1
    parts = [dk.decode_attention_stats(
        q, k[:, sl].contiguous(), v[:, sl].contiguous(),
        kv_mask=None if mask is None else mask[:, sl].contiguous())
        for sl in (slice(0, cut), slice(cut, None))]
    merged = ops.merge_attention_stats(parts).to(dtype)
    _assert_rows_close(merged, dk.decode_attention(q, k, v, kv_mask=mask),
                       dtype, 2 ** -7)


def test_decode_attention_stats_refuses_what_it_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(19)
    q = _randn(g, (2, 8, 64), torch.float32, dev)
    k = _randn(g, (2, 10, 2, 64), torch.float32, dev)
    before = dk.stats_launches
    with pytest.raises(ValueError, match="at least one row"):
        dk.decode_attention_stats(q, k[:, :0].contiguous(),
                                  k[:, :0].contiguous())
    with pytest.raises(ValueError, match="dtypes"):
        dk.decode_attention_stats(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="kv_mask"):
        dk.decode_attention_stats(q, k, k, kv_mask=torch.ones(
            (2, 10, 3), dtype=torch.bool, device=dev))
    assert dk.stats_launches == before


def test_split_decode_on_the_card_matches_the_cpu(dev):
    """The split-cache decode at smoke width (llama3-smoke and
    gemma3-smoke, float32, a 4-row ring that wraps): 6 greedy steps on the
    card (kernel 6's stats entry, two launches a layer and step, and no
    kernel 6) and on the CPU (the plain versions) give the same tokens
    and logits within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve

    from repro_torch.common.pytree import tree_map
    from repro_torch.models import transformer as tf

    for arch in ("llama3-8b", "gemma3-1b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        # the same weights and frozen rows on both devices: drawn on the
        # CPU, handed over as numpy trees
        cache = tf.init_decode_cache(cfg, 2, 40, fill_len=40, hot_slots=4,
                                     device="cpu")
        serve.fill_frozen_rows(cache, cfg, 2, 40, seed=3)
        cache = dict(cache, attn=tree_map(lambda x: x.numpy(),
                                          cache["attn"]),
                     next_pos=cache["next_pos"].numpy())
        params = tree_map(lambda x: x.numpy(),
                          tf.init_params(cfg, seed=0, device="cpu"))
        job = dict(cfg=cfg, batch=2, capacity=40, hot_slots=4, steps=6,
                   params=params, cache=cache, token=np.array([[5], [7]]))
        card = serve.split_decode_job(dict(job, device="cuda"))
        cpu = serve.split_decode_job(dict(job, device="cpu"))
        np.testing.assert_array_equal(card["tokens"], cpu["tokens"])
        np.testing.assert_allclose(card["logits"], cpu["logits"], atol=1e-4,
                                   rtol=1e-4)
        want = {k: 0 for k in card["launches"]}
        want["decode_attention_stats"] = 2 * cfg.num_layers * 6
        assert card["launches"] == want


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


def test_ssd_scan_is_three_launches(dev, tmp_path):
    """One wrapper call is one count and three CUDA launches: chunk
    states, the state pass, the chunk scan (the tensor-core kernels in bf16
    at hymba-1.5b's shape, the FMA kernels in float32;
    ``_assert_launches_each``: every call whose trace is whole)."""
    g = torch.Generator(device=dev).manual_seed(13)
    B, S, nh, hd, ds, chunk = 4, 2048, 50, 64, 16, 128
    for dtype, part in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(g, B, S, nh, hd, ds, dtype, dev)
        sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)  # built and warm
        _assert_launches_each(
            lambda: sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                initial_state=h0),
            (f"ssd_chunk_states_{part}", "ssd_state_pass",
             f"ssd_chunk_scan_{part}"), tmp_path)
        before = sk.launches
        sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
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


# ---------------------------------------------------------------------------
# the learning loop on the card: the gradient guard, reference_mode and a
# checkpoint round trip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["flash", "lookahead", "chunk", "decode"])
def test_requires_grad_on_the_card_raises_outside_reference_mode(dev, entry):
    """A kernel has no backward: an entry point given a CUDA tensor that
    requires a gradient raises (its result would drop the gradient) and
    launches nothing; under ``reference_mode()`` the plain version runs
    and the gradient arrives; under ``torch.no_grad()`` the kernel runs."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = _randn(g, (1, 40, 4, 32), torch.float32, dev).requires_grad_(True)
    k = _randn(g, (1, 40, 2, 32), torch.float32, dev)
    call = {
        "flash": lambda q: ops.flash_attention(q, k, k),
        "lookahead": lambda q: ops.lookahead_score(q[:, 32:], k, 32),
        "chunk": lambda q: ops.chunk_attention(q[:, :8], k, k, q_offset=4),
        "decode": lambda q: ops.decode_attention(q[:, 0], k, k),
    }[entry]
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="reference_mode"):
        call(q)
    assert ops.launch_counts() == before
    with ops.reference_mode():
        out = call(q)
    assert ops.launch_counts() == before
    (grad,) = torch.autograd.grad(out.float().sum(), q)
    assert torch.isfinite(grad).all() and bool(grad.abs().sum() > 0)
    with torch.no_grad():
        call(q)
    assert sum(ops.launch_counts().values()) == sum(before.values()) + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,hd,window,masked", [
    (ref.DIRECT_SEQ + 252, 32, 8, 128, None, False),  # llama3-8b's heads
    (ref.DIRECT_SEQ + 100, 8, 2, 64, 700, False),  # a window
    (ref.DIRECT_SEQ + 100, 8, 2, 64, None, True),  # a key mask
])
def test_streaming_attention_on_the_card_matches_direct(dev, dtype, S, H, KV,
                                                        hd, window, masked):
    """Above ``ref.DIRECT_SEQ`` keys ``ops.flash_attention`` inside
    ``reference_mode()`` streams (``ref.ChunkedAttention`` under autograd)
    and launches nothing: its output within 2e-5 (float32) or 2^-7
    (bf16) of each row's largest direct magnitude, each gradient within
    1e-4 (float32) or 2^-5 (bf16, D = rowsum(dO O) reads the bf16 output)
    of its largest, against autograd through the direct plain form."""
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (_randn(g, (1, S, n, hd), dtype, dev).requires_grad_()
               for n in (H, KV, KV))
    mask = None
    if masked:
        mask = torch.rand((1, S), generator=g, device=dev) > 0.3
        mask[:, 0] = True
    up = _randn(g, (1, S, H, hd), dtype, dev)
    before = ops.launch_counts()
    with ops.reference_mode():
        out = ops.flash_attention(q, k, v, window=window, kv_mask=mask)
    got = torch.autograd.grad(out, (q, k, v), up)
    assert ops.launch_counts() == before
    want_out = ref.flash_attention(q, k, v, window=window, kv_mask=mask)
    want = torch.autograd.grad(want_out, (q, k, v), up)
    out_rel, grad_rel = (2e-5, 1e-4) if dtype == torch.float32 else \
        (2 ** -7, 2 ** -5)
    err = (out.float() - want_out.float()).abs().amax(-1)
    assert bool((err <= out_rel * want_out.float().abs().amax(-1)).all())
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).abs().max()) <= \
            grad_rel * float(b.float().abs().max())


def test_checkpoint_round_trips_on_the_card(dev, tmp_path):
    """bf16, float32 and int32 leaves and an AdamState written from the
    card and loaded back onto it, bit for bit."""
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.optim import adam

    g = torch.Generator(device=dev).manual_seed(6)
    lkv = {"emb": _randn(g, (8, 64), torch.float32, dev),
           "lora": {"wq": {"a": _randn(g, (2, 64, 4), torch.bfloat16, dev),
                           "b": _randn(g, (2, 4, 64), torch.float32, dev)}}}
    st = adam.init(lkv)._replace(step=torch.tensor(7, dtype=torch.int32,
                                                   device=dev))
    tree = {"lkv": lkv, "opt": st}
    p = str(tmp_path / "state.npz")
    ckpt.save(p, tree, metadata={"step": 7})
    back = ckpt.load(p, like=tree, device=dev)
    want, got = ckpt._flatten(tree), ckpt._flatten(back)
    assert list(want) == list(got)
    for name in want:
        a, b = want[name], got[name]
        assert b.device.type == "cuda" and a.dtype == b.dtype, name
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), name
    assert isinstance(back["opt"], adam.AdamState)
    assert ckpt.metadata(p) == {"step": 7}


def test_random_stream_on_the_card_equals_the_cpu(dev):
    """The sampler's random stream on the card: keys, bits, uniforms and
    Gumbel noise of a (4, V) draw per row key, and the sampled ids, equal
    the CPU's (the bits exactly; the logs within an ulp of the CPU's)."""
    from repro_torch.core import eviction as ev
    from repro_torch.core import policies

    seeds = torch.tensor([0, 7, 2**31 - 1, 123], dtype=torch.int32)
    pos = torch.tensor([1, 4096, 77, 100000], dtype=torch.int32)
    V = 128256
    keys = {d: policies.fold_keys(seeds.to(d), pos.to(d))
            for d in ("cpu", dev)}
    for a, b in zip(keys["cpu"], keys[dev]):
        assert torch.equal(a, b.cpu())
    bits = [ev.random_bits(keys[d], (V,)).cpu() for d in ("cpu", dev)]
    assert torch.equal(*bits)
    tiny = float(torch.finfo(torch.float32).tiny)
    u = [ev.uniform(keys[d], (V,), minval=tiny).cpu() for d in ("cpu", dev)]
    assert torch.equal(u[0].view(torch.int32), u[1].view(torch.int32))
    g = [ev.gumbel(keys[d], (V,)).cpu() for d in ("cpu", dev)]
    ulp = torch.finfo(torch.float32).eps * g[0].abs().clamp(min=1.0)
    assert bool(((g[0] - g[1]).abs() <= 2 * ulp).all())
    k1, k2 = ev.split(ev.PRNGKey(11), 9)
    c1, c2 = ev.split((ev.PRNGKey(11)[0].to(dev), ev.PRNGKey(11)[1].to(dev)),
                      9)
    assert torch.equal(k1, c1.cpu()) and torch.equal(k2, c2.cpu())
    logits = torch.randn((4, V), generator=torch.Generator().manual_seed(3))
    ids = [policies.sample_logits(logits.to(d), keys[d], temperature=0.7,
                                  top_k=50, top_p=0.9).cpu()
           for d in ("cpu", dev)]
    assert torch.equal(*ids)


@pytest.mark.parametrize("pooled", [False, True])
def test_prefix_cache_round_trip_on_the_card(dev, pooled):
    """Insert two chunk boundaries of a streamed h2o prefill into a prefix
    cache on the card (private copies, or pinned pool blocks), then
    materialize: K/V, the accumulator and the count are bitwise the
    streamed state, with a zero tail."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import KVBlockPool, PrefixCache

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="bfloat16")
    params = tf.init_params(cfg, seed=0, device=dev)
    pool = (KVBlockPool(cfg, block_size=16, num_blocks=32, device=dev)
            if pooled else None)
    cache = PrefixCache(chunk=32, max_bytes=1 << 30, pool=pool)
    toks = torch.randint(0, cfg.vocab_size, (1, 96),
                         generator=torch.Generator().manual_seed(4))
    state = tf.init_chunk_state(cfg, "h2o", 1, 128, device=dev)
    tip = None
    for s in (0, 32):
        state, logits = tf.prefill_chunk(params, cfg, state,
                                         toks[:, s:s + 32].to(dev), 96,
                                         policy="h2o")
        tip = cache.insert(toks[0, :s + 32].numpy(), state=state,
                           logits=logits, parent=tip)
    got, got_logits = cache.materialize(tip, 128)
    assert got.pos == 64 and torch.equal(got_logits, logits)
    for a, b in ((got.k, state.k), (got.v, state.v),
                 (got.score.acc, state.score.acc)):
        assert torch.equal(a[..., :64, :, :] if a.dim() == 5 else a[..., :64],
                           b[..., :64, :, :] if b.dim() == 5 else b[..., :64])
    assert not got.k[:, :, 64:].any() and not got.score.acc[..., 64:].any()
    assert got.score.cnt == state.score.cnt == 64
    if pooled:
        assert pool.pinned_blocks == 4


def test_traced_engine_syncs_and_drift_runs_kernels(dev, monkeypatch):
    """Observability on the card: a traced ``ContinuousEngine`` serves the
    untraced tokens, synchronises its device once per prefill chunk,
    finalize and decode chunk (an untraced one never), and records
    ``sync_timers`` and the kernel paths in ``serving_build``; the drift
    monitor's oracle and predictor passes each launch kernels 7 and 3
    once per layer and nothing else."""
    import dataclasses

    from repro_torch.common.config import EvictionConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.lookahead import init_lookahead_params
    from repro_torch.models import transformer as tf
    from repro_torch.obs import DriftMonitor, TraceRecorder, validate_trace
    from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                     KVBlockPool, Request, ServingConfig)
    from repro_torch.serving import engine as engine_mod

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="bfloat16")
    params = tf.init_params(cfg, seed=0, device=dev)
    lkv = init_lookahead_params(torch.Generator(device=dev).manual_seed(1),
                                cfg, params["layers"])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 45)]
    syncs = [0]
    real_sync = engine_mod._sync

    def counting(device):
        syncs[0] += 1
        real_sync(device)

    monkeypatch.setattr(engine_mod, "_sync", counting)

    def serve(trace):
        sc = ServingConfig(
            evict=EvictionConfig(budget=16),
            chunking=ChunkingConfig(chunk=32, max_context=96),
            num_slots=2, max_new_tokens=6, eos_id=-1, trace=trace,
            kv_pool=KVBlockPool(cfg, block_size=16, num_blocks=32,
                                device=dev))
        eng = ContinuousEngine(params, cfg, sc, lkv_params=lkv, device=dev)
        syncs[0] = 0
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                        for i, p in enumerate(prompts)])
        return {r.uid: r.out_tokens for r in done}, eng, syncs[0]

    plain, eng0, n0 = serve(None)
    got, eng, n = serve(TraceRecorder())
    assert got == plain and n0 == 0
    c = eng.counts
    assert n == c["prefill_chunks"] + len(prompts) + c["decode_chunks"]
    assert eng.metrics.value("serving_build") == {
        "sync_timers": "True", "score_path": "cuda-kernel",
        "decode_path": "paged-cuda-kernel", "mesh": "None"}
    assert eng0.metrics.value("serving_build")["sync_timers"] == "False"
    validate_trace(eng.trace)
    mon = DriftMonitor(params, cfg, lkv, budget=16)
    x, y = prompts[0], np.asarray(plain[0], np.int32)
    L = cfg.num_layers
    for fn in (lambda: mon.gt_head_scores(x, y),
               lambda: mon.pred_head_scores(x)):
        ops.reset_launch_counts()
        s = fn()
        want = {k: 0 for k in ops.launch_counts()}
        want.update(flash_attention=L, lookahead_score=L)
        assert ops.launch_counts() == want
        assert s.shape == (L, cfg.attn.num_heads, len(x))
        assert np.isfinite(s).all()
