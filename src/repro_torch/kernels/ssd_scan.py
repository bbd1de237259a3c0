"""Mamba-2 SSD chunked scan on the card (``csrc/ssd_scan.cu``).

The Hopper port of the JAX package's ``ssd_scan_pallas``, chunk-parallel
in three launches on the stream: (a) every chunk's own state contribution
into a float32 scratch (B, nc, nh, hd, ds) and, in bf16, the chunk's
C.B^T, (b) the state pass, which walks the chunks in order and leaves in
each slot the state entering that chunk, (c) every chunk's output from its
rows and that state.  bf16 runs the products with heads on tensor cores,
``head_block`` heads per CTA of (a) and (c); float32 keeps CUDA-core
arithmetic, one head per CTA.  Unlike the Pallas kernel it takes any
sequence length (a ragged last chunk is exact, as the plain version's
zero padding), any head count and any chunk of 1..256 rows.  x, B and C
may be views whose rows are strided (the model's conv output split three
ways), as long as each row's own elements are contiguous.  Plain
version: ``ref.ssd_scan_chunked``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

#: calls since the last reset (``ops.reset_launch_counts``), three CUDA
#: launches each
launches = 0

_HD = (16, 32, 64)
_DS = (8, 16, 32, 64, 128)
_MAX_CHUNK = 256
#: threads of a CTA of the state pass (launch (b)), 4 state elements each
PASS_THREADS = 256
#: the most heads one CTA of launches (a) and (c) takes (bf16)
MAX_HEADS = 8


def _row_stride(t: torch.Tensor, name: str) -> int:
    """Stride between consecutive (b, s) rows of a (B, S, a, c) tensor
    whose (a, c) block is contiguous and whose batch stride is S rows (a
    dimension of size 1 may report any stride)."""
    B, S, a, c = t.shape
    st = t.stride()
    row = st[1] if S > 1 else st[0]
    if st[3] != 1 or (a > 1 and st[2] != c) or (
            B > 1 and S > 1 and st[0] != S * row):
        raise ValueError(f"ssd_scan kernel: {name} must have contiguous rows "
                         f"and a batch stride of S rows, got strides {st}")
    return row


def _chunk_tiles(chunk: int) -> int:
    """n8 tiles of mma fragments of one chunk's C.B^T (``csrc/ssd_scan.cu``:
    ``chunk_tiles``): slab i of 16 rows keeps 2i + 2."""
    n_sl = -(-chunk // 16)
    return n_sl * (n_sl + 1)


def head_block(B: int, S: int, nh: int, chunk: int, sms: int) -> int:
    """Heads per CTA of launches (a) and (c) in bf16: the most, up to
    ``MAX_HEADS``, that still give each of the ``sms`` SMs two CTAs (a CTA
    stages its chunk's B and C, and in (c) its C.B^T, once for all its
    heads), else 1."""
    ctas = -(-S // chunk) * B
    for heads in (MAX_HEADS, 4, 2):
        if ctas * -(-nh // heads) >= 2 * sms:
            return heads
    return 1


def _heads(B: int, S: int, nh: int, chunk: int, dtype, sms: int) -> int:
    return head_block(B, S, nh, chunk, sms) if dtype == torch.bfloat16 else 1


def grids(B: int, S: int, nh: int, hd: int, ds: int, chunk: int, dtype,
          sms: int) -> tuple:
    """The grids of the three launches: (a) and (c) (chunks, head blocks,
    B), one head a block in float32; (b) (CTAs of ``PASS_THREADS``, 1,
    1)."""
    per_chunk = (-(-S // chunk), -(-nh // _heads(B, S, nh, chunk, dtype,
                                                   sms)), B)
    return (per_chunk, (-(-B * nh * hd * ds // (4 * PASS_THREADS)), 1, 1),
            per_chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, nh, hd), dt (B, S, nh) float32, A (nh,) float32, Bm/Cm (B,
    S, 1, ds) in x's type (bf16 or float32), initial_state (B, nh, hd, ds)
    float32 or None, on the card -> (y (B, S, nh, hd), final state (B, nh,
    hd, ds)), both float32."""
    global launches
    B, S, nh, hd = x.shape
    ds = Bm.shape[3]
    tensors = [x, dt, A, Bm, Cm] + ([] if initial_state is None
                                    else [initial_state])
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_scan kernel takes CUDA tensors on one device")
    if x.dtype not in build.DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise ValueError(f"unsupported dtypes x {x.dtype} B {Bm.dtype} "
                         f"C {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or (
            initial_state is not None
            and initial_state.dtype != torch.float32):
        raise ValueError("ssd_scan kernel takes float32 dt, A and state")
    if (dt.shape != (B, S, nh) or A.shape != (nh,)
            or Bm.shape != (B, S, 1, ds) or Cm.shape != Bm.shape
            or (initial_state is not None
                and initial_state.shape != (B, nh, hd, ds))):
        raise ValueError(
            f"shape mismatch x {tuple(x.shape)} dt {tuple(dt.shape)} A "
            f"{tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)} state "
            f"{None if initial_state is None else tuple(initial_state.shape)}"
            " (ngroups must be 1)")
    if hd not in _HD or ds not in _DS:
        raise ValueError(f"head_dim {hd} / d_state {ds} not built "
                         f"({_HD} / {_DS})")
    if not 1 <= chunk <= _MAX_CHUNK or S < 1:
        raise ValueError(f"chunk {chunk} (1..{_MAX_CHUNK}) or S {S} "
                         "out of range")
    if not (dt.is_contiguous() and A.is_contiguous() and (
            initial_state is None or initial_state.is_contiguous())):
        raise ValueError("ssd_scan kernel takes contiguous dt, A and state")
    x_row = _row_stride(x, "x")
    b_row, c_row = _row_stride(Bm, "B"), _row_stride(Cm, "C")
    dev = x.device
    heads = _heads(B, S, nh, chunk, x.dtype, build.sm_count(dev))
    nc = -(-S // chunk)
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=dev)
    hout = torch.empty((B, nh, hd, ds), dtype=torch.float32, device=dev)
    # launch (a) writes every chunk state, (bf16) C.B^T and L_Q: no
    # memset; the states and C.B^T are read 16 bytes at a time
    n_states, n_lq = B * nc * nh * hd * ds, B * nc * nh
    n_cb = (B * nc * _chunk_tiles(chunk) * 128
            if x.dtype == torch.bfloat16 else 0)
    scratch = torch.empty(n_states + n_cb + n_lq, dtype=torch.float32,
                          device=dev)
    if initial_state is not None and initial_state.data_ptr() % 16:
        initial_state = initial_state.clone()
    err = build.library("ssd_scan")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), build.ptr(initial_state), y.data_ptr(),
        hout.data_ptr(), scratch.data_ptr(),
        scratch[n_states + n_cb:].data_ptr(),
        scratch[n_states:].data_ptr() if n_cb else None, B, S, nh, hd, ds,
        chunk, x_row, b_row, c_row, heads, build.DTYPE_CODES[x.dtype],
        build.stream_ptr())
    build.check(err, "ssd_scan")
    launches += 1
    return y, hout
