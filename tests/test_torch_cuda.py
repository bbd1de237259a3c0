"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA card: it carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false (decided in
the fixture, never at import).  Run them on a card with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances: float32 inputs 1e-4 (another summation order).  Of
bfloat16 inputs, a fraction of the plain result's largest magnitude
(outputs of random inputs shrink as 1/sqrt(visible keys), so a fixed
number would let a wrong kernel through at a deep buffer): chunk
attention 2^-5 (its tensor cores take P rounded to bfloat16, and the
output is rounded once), paged decode 2^-7 (float32 on CUDA cores, one
rounding of the output); lookahead scores, float32 throughout, 2^-16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_attention as ck
from repro_torch.kernels import lookahead_score as lk
from repro_torch.kernels import paged_attention as pk
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, want, rel):
    if dtype == torch.bfloat16:
        return dict(atol=rel * float(want.float().abs().max()), rtol=0)
    return dict(atol=1e-4, rtol=1e-4)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,K,H,KV,hd,off,window", [
    (1, 256, 4096, 32, 8, 128, 3840, None),  # deep chunk of a 4k prompt
    (1, 32, 4096, 32, 8, 128, 4000, None),  # the observation pass
    (2, 50, 333, 4, 2, 32, 100, None),  # K not a multiple of the tile
    (1, 64, 300, 8, 2, 64, 200, 48),  # sliding window
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
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(dtype, want, 2 ** -5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n_obs,Sk,H,KV,hd,n_prompt,off,window,masks", [
    (1, 32, 4096, 32, 8, 128, 4096, 4000, None, False),  # finalize form
    (2, 8, 300, 4, 2, 32, 292, None, None, True),  # monolithic form
    (2, 40, 250, 4, 2, 64, 250, 200, 30, True),  # two row tiles, window
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
    got = lk.lookahead_score(q, k, n_prompt, kv_mask=kvm, window=window,
                             q_offset=off, row_valid=rv)
    torch.cuda.synchronize()
    want = ref.lookahead_score(q, k, n_prompt, kv_mask=kvm, window=window,
                               q_offset=off, row_valid=rv)
    atol = min(1e-5, 2 ** -16 * float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=atol, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_decode_matches_plain(dev, dtype, window):
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
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(dtype, want, 2 ** -7))
    assert torch.all(got[2:] == 0)


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
