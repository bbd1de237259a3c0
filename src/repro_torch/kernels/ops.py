"""Public kernel entry points of the port.

Dispatch depends only on where the tensors lie: a CUDA tensor goes to the
hand-written kernel (which launches or raises), a CPU tensor to the plain
PyTorch version in ``ref.py``, and so does a tensor on the ``meta``
device, which carries shapes only (the dry-run's sizes and FLOP counts,
``launch/dryrun.py``).  Any other device raises.  There is no environment
switch and no fallback from a failed kernel to the plain version.

The plain route has the JAX package's two tiers: at or below
``ref.DIRECT_SEQ`` keys it forms the whole logits block; above it it
streams over key tiles (``ref.chunked_attention``, with its gradient
``ref.ChunkedAttention`` under autograd; ``ref.chunked_lookahead_score``;
``ref.paged_decode_streaming``), so that the lookahead pass and its
backward at the paper's lengths never hold a (Sq, Sk) block per head.
The ``meta`` device keeps the direct form (it holds shapes only).
Single-query decode (``decode_attention``, ``decode_attention_stats``)
stays direct, as in the JAX package.

One exception, for gradients: the kernels are forward-only (no backward),
so code that must differentiate through a forward pass (the lookahead
pass of the distillation objective, ``core/objective.py``) runs it inside
``reference_mode()``, where CUDA tensors take the plain versions too, as
in the JAX package's ``ops.reference_mode``.  Outside it, a kernel entry
point given a CUDA tensor that requires a gradient, with autograd on,
raises: the kernel's result would carry no ``grad_fn`` and the gradient
would be lost without a word.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import chunk_attention as _ck
from repro_torch.kernels import decode_attention as _dk
from repro_torch.kernels import flash_attention as _fk
from repro_torch.kernels import lookahead_score as _lk
from repro_torch.kernels import paged_attention as _pk
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _sk

#: kernel name -> (wrapper module, its launch-counter attribute)
KERNEL_COUNTERS = {
    "chunk_attention": (_ck, "launches"),
    "chunk_attention_masses": (_ck, "masses_launches"),
    "lookahead_score": (_lk, "launches"),
    "paged_decode_attention": (_pk, "launches"),
    "paged_decode_masses": (_pk, "mass_launches"),
    "flash_attention": (_fk, "launches"),
    "decode_attention": (_dk, "launches"),
    "decode_attention_stats": (_dk, "stats_launches"),
    "ssd_scan": (_sk, "launches"),
}


# Set only inside ``reference_mode()``: CUDA tensors take the plain
# versions (the JAX package's ``_REFERENCE_ONLY``).
_REFERENCE_ONLY = False


@contextlib.contextmanager
def reference_mode():
    """Send every entry point to its plain version, CUDA tensors included,
    so that autograd can differentiate through it.  The one exception to
    dispatch by device; the distillation objective's lookahead pass and
    ``lm_loss`` run inside it."""
    global _REFERENCE_ONLY
    prev = _REFERENCE_ONLY
    _REFERENCE_ONLY = True
    try:
        yield
    finally:
        _REFERENCE_ONLY = prev


def _on_card(t: torch.Tensor, *grad_inputs: Optional[torch.Tensor]) -> bool:
    """Whether ``t``'s call goes to the kernel.  ``grad_inputs`` are the
    call's float tensors: on the card, outside ``reference_mode()``, one
    that requires a gradient under autograd raises.  CPU and meta tensors
    take the plain versions."""
    if t.device.type in ("cpu", "meta"):
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    if _REFERENCE_ONLY:
        return False
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (t,) + grad_inputs):
        raise RuntimeError(
            "the CUDA kernels have no backward: differentiate through "
            "the plain versions inside ops.reference_mode()")
    return True


def _streams(t: torch.Tensor, n_keys: int) -> bool:
    """Whether a plain-route call over ``n_keys`` keys takes the streaming
    tier: above ``ref.DIRECT_SEQ``, on any device but ``meta``."""
    return t.device.type != "meta" and n_keys > ref.DIRECT_SEQ


def _chunked_attention(q, k, v, **kw) -> torch.Tensor:
    """The streaming attention, through its autograd Function when a
    gradient may be asked of it."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return ref.ChunkedAttention.apply(
            q, k, v, kw["causal"], kw["window"], kw["q_offset"],
            kw["kv_mask"], kw["block_q"], kw["block_k"])
    return ref.chunked_attention(q, k, v, **kw)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of a whole sequence: q (B, Sq, H, hd) over k/v (B, Sk,
    KV, hd), causal or (``causal=False``) over every key, with an optional
    window and key mask ``kv_mask`` (B, Sk) bool (the bucket-padded
    prefill's valid keys; every row must keep a valid key).  Sq == Sk is
    self-attention; Sq != Sk is whisper's cross-attention (decoder rows
    over encoder frames), which takes ``causal=False`` and no window and
    raises otherwise, on every device.

    On the card a non-causal, unwindowed call with one query row (the
    cross-attention of a decode step) goes to kernel 6
    (``decode_attention``, counted as its launch), which computes the
    same function without a 128-row query tile for one live row; every
    other call goes to kernel 7."""
    ref.check_cross(q.shape[1], k.shape[1], causal, window)
    if _on_card(q, k, v):
        if q.shape[1] == 1 and not causal and window is None:
            return _dk.decode_attention(q[:, 0], k, v,
                                        kv_mask=kv_mask)[:, None]
        return _fk.flash_attention(q, k, v, causal=causal, window=window,
                                   kv_mask=kv_mask)
    if _streams(q, k.shape[1]):
        return _chunked_attention(
            q, k, v, causal=causal, window=window,
            q_offset=k.shape[1] - q.shape[1], kv_mask=kv_mask, block_q=512,
            block_k=1024)
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               kv_mask=kv_mask)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query token per sequence (B, H, hd) over a dense (B, C, KV, hd)
    cache, mask None, (B, C) or per kv head (B, C, KV)."""
    if _on_card(q, k, v):
        return _dk.decode_attention(q, k, v, kv_mask=kv_mask)
    return ref.decode_attention(q, k, v, kv_mask=kv_mask)


def decode_attention_stats(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           kv_mask: Optional[torch.Tensor] = None):
    """``decode_attention`` without its final divide: the unnormalised
    partials (m (B, H), l (B, H), acc (B, H, hd)), float32, of one query
    token over one segment of a dense cache (the split-cache decode's
    frozen rows or its hot ring), in natural-log units; an empty
    (sequence, head) gives m = -1e30, l = 0, acc = 0.  The JAX package
    computes them in jnp (``ops.decode_attention_stats``); the card runs
    kernel 6's routine with the partials as its output."""
    if _on_card(q, k, v):
        return _dk.decode_attention_stats(q, k, v, kv_mask=kv_mask)
    return ref.decode_attention_stats(q, k, v, kv_mask=kv_mask)


#: plain torch on every device: a few elementwise ops on (B, H, hd)
merge_attention_stats = ref.merge_attention_stats


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, window=None, score_masses: bool = False,
                    n_total: Optional[int] = None):
    """Attention of one chunk (B, C, H, hd) at ``q_offset`` over the
    (B, K, KV, hd) buffer; both routes raise unless q_offset + C <= K.

    With ``score_masses`` the result is ``(out, masses)``: ``masses[b, h,
    j]`` is the summed softmax mass of column ``j`` over the chunk's rows
    at positions below ``n_total`` (every row when None), float32 (B, H,
    K), exact zeros where no such row sees the key; the h2o score of the
    chunk.  ``out`` is the ``score_masses=False`` result on both routes:
    kernel 2's is bitwise kernel 1's, and the plain route reuses the
    unscored attention."""
    if _on_card(q, k, v):
        if not score_masses:
            return _ck.chunk_attention(q, k, v, q_offset=q_offset,
                                       window=window)
        return _ck.chunk_attention_masses(
            q, k, v, q_offset=q_offset,
            n_total=q_offset + q.shape[1] if n_total is None else n_total,
            window=window)
    B, C = q.shape[:2]
    K = k.shape[1]
    stream = _streams(q, K)
    if stream:
        ref.check_offset(q_offset, C, K)
        out = _chunked_attention(q, k, v, causal=True, window=window,
                                 q_offset=q_offset, kv_mask=None,
                                 block_q=256, block_k=1024)
    else:
        out = ref.chunk_attention(q, k, v, q_offset=q_offset, window=window)
    if not score_masses:
        return out
    row_valid = None
    if n_total is not None:
        row_valid = (q_offset + torch.arange(C, device=q.device)
                     < n_total).expand(B, C)
    if stream:
        return out, ref.chunked_lookahead_score(
            q, k, K, window=window, q_offset=q_offset, row_valid=row_valid,
            reduce="sum", block_k=1024)
    return out, ref.chunk_column_masses(q, k, q_offset=q_offset,
                                        window=window, row_valid=row_valid)


def lookahead_score(q_obs: torch.Tensor, k: torch.Tensor, n_prompt: int, *,
                    kv_mask: Optional[torch.Tensor] = None, window=None,
                    q_offset: Optional[int] = None,
                    row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-q-head importance scores of the first ``n_prompt`` keys:
    (B, H, n_prompt) float32."""
    if _on_card(q_obs, k):
        return _lk.lookahead_score(q_obs, k, n_prompt, kv_mask=kv_mask,
                                   window=window, q_offset=q_offset,
                                   row_valid=row_valid)
    if _streams(q_obs, k.shape[1]):
        return ref.chunked_lookahead_score(
            q_obs, k, n_prompt, kv_mask=kv_mask, window=window,
            q_offset=q_offset, row_valid=row_valid, reduce="mean",
            block_k=2048)
    return ref.lookahead_score(q_obs, k, n_prompt, kv_mask=kv_mask,
                               window=window, q_offset=q_offset,
                               row_valid=row_valid)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, mask_pool: torch.Tensor,
                           table: torch.Tensor, *,
                           pos_pool: Optional[torch.Tensor] = None,
                           new_pos: Optional[torch.Tensor] = None,
                           window=None, depth: Optional[int] = None,
                           score_masses: bool = False):
    """Decode attention of one token per sequence over the paged pool;
    both routes walk the whole block table (rows past a sequence's logical
    depth are masked in the pool).

    With ``score_masses`` the result is ``(out, masses)``: ``masses[b, h,
    j]`` is the query's normalised softmax mass on logical row ``j``,
    float32, exact zeros on masked rows, ``depth`` columns when ``depth``
    is given (else ``nb * bs``); the decode-time eviction scores.  ``out``
    is the ``score_masses=False`` result on both routes: kernel 5's is
    bitwise kernel 4's, and the plain route reuses the unscored
    attention.  ``depth`` changes nothing else: the engine masks every row
    past it."""
    kw = dict(pos_pool=pos_pool, new_pos=new_pos, window=window)
    if _on_card(q, k_pool, v_pool):
        if not score_masses:
            return _pk.paged_decode_attention(q, k_pool, v_pool, mask_pool,
                                              table, **kw)
        out, masses = _pk.paged_decode_masses(q, k_pool, v_pool, mask_pool,
                                              table, **kw)
        return out, (masses if depth is None else masses[..., :depth])
    if paged_decode_path(_span(table, k_pool, depth), q.device) \
            == "fallback":
        # rows past ``depth`` are masked in the pool, so the scan needs no
        # slice before the masses'
        res = ref.paged_decode_streaming(q, k_pool, v_pool, mask_pool,
                                         table, score_masses=score_masses,
                                         **kw)
        if not score_masses:
            return res
        return res[0], (res[1] if depth is None else res[1][..., :depth])
    out = ref.paged_decode_attention(q, k_pool, v_pool, mask_pool, table,
                                     **kw)
    if not score_masses:
        return out
    return out, ref.paged_decode_masses(q, k_pool, mask_pool, table,
                                        depth=depth, **kw)


def _span(table: torch.Tensor, k_pool: torch.Tensor,
          depth: Optional[int]) -> int:
    """The logical rows a paged call walks: the table's columns x the block
    size, capped at ``depth``."""
    span = table.shape[1] * k_pool.shape[1]
    return span if depth is None else min(span, depth)


def paged_decode_path(span: int, device) -> str:
    """Which tier of ``paged_decode_attention`` serves a logical cache of
    ``span`` rows on ``device``: ``"kernel"`` (kernels 4 and 5, a CUDA
    device outside ``reference_mode()``), ``"gather"`` (the plain direct
    form over the gathered block-table view; always on ``meta``) or
    ``"fallback"`` (the plain streaming scan, above ``ref.DIRECT_SEQ``
    rows), the JAX package's tier names."""
    kind = torch.device(device).type
    if kind == "cuda" and not _REFERENCE_ONLY:
        return "kernel"
    if kind == "meta" or span <= ref.DIRECT_SEQ:
        return "gather"
    return "fallback"


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD chunked scan: x (B, S, nh, hd), dt (B, S, nh), A
    (nh,), Bm/Cm (B, S, 1, ds), initial_state (B, nh, hd, ds) or None ->
    (y (B, S, nh, hd), final state (B, nh, hd, ds)), both float32.  Any S
    (a ragged last chunk is exact) and any nh, on both routes."""
    if _on_card(x, dt, A, Bm, Cm, initial_state):
        return _sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                            initial_state=initial_state)
    return ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                initial_state=initial_state)


def ssd_step(x_t: torch.Tensor, dt_t: torch.Tensor, A: torch.Tensor,
             B_t: torch.Tensor, C_t: torch.Tensor, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode token of the SSD recurrence: x_t (B, nh, hd), dt_t (B,
    nh), A (nh,), B_t/C_t (B, G, ds), state (B, nh, hd, ds) float32 ->
    (y_t (B, nh, hd) in x_t's type, new state float32).  Plain PyTorch on
    every device (the JAX package's is plain jnp too): a few elementwise
    launches per layer, no scan."""
    nh = x_t.shape[1]
    G = B_t.shape[1]
    Bf = torch.repeat_interleave(B_t, nh // G, dim=1).float()
    Cf = torch.repeat_interleave(C_t, nh // G, dim=1).float()
    x32, dt32 = x_t.float(), dt_t.float()
    decay = torch.exp(A.float()[None] * dt32)  # (B, nh)
    state = state * decay[..., None, None] + (
        (dt32[..., None] * x32)[..., None] * Bf[..., None, :])
    y = torch.einsum("bnhs,bns->bnh", state, Cf)
    return y.to(x_t.dtype), state
