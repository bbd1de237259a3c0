"""Public kernel entry points of the port.

Dispatch depends only on where the tensors lie: a CUDA tensor goes to the
hand-written kernel (which launches or raises), a CPU tensor to the plain
PyTorch version in ``ref.py``.  There is no environment switch and no
fallback from a failed kernel to the plain version.
"""

from __future__ import annotations

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
    "ssd_scan": (_sk, "launches"),
}


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


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
    """Self-attention of a whole sequence: q (B, S, H, hd), k/v (B, S, KV,
    hd), causal or (``causal=False``) over every key, with an optional
    window and key mask ``kv_mask`` (B, S) bool (the bucket-padded
    prefill's valid keys; every row must keep a valid key).  Sq != Sk (the
    JAX package's cross-attention of whisper) raises on every device."""
    if q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            "flash_attention with Sq != Sk (encoder cross-attention): not "
            "ported yet: ROADMAP A10")
    if _on_card(q):
        return _fk.flash_attention(q, k, v, causal=causal, window=window,
                                   kv_mask=kv_mask)
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               kv_mask=kv_mask)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query token per sequence (B, H, hd) over a dense (B, C, KV, hd)
    cache, mask None, (B, C) or per kv head (B, C, KV)."""
    if _on_card(q):
        return _dk.decode_attention(q, k, v, kv_mask=kv_mask)
    return ref.decode_attention(q, k, v, kv_mask=kv_mask)


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
    if _on_card(q):
        if not score_masses:
            return _ck.chunk_attention(q, k, v, q_offset=q_offset,
                                       window=window)
        return _ck.chunk_attention_masses(
            q, k, v, q_offset=q_offset,
            n_total=q_offset + q.shape[1] if n_total is None else n_total,
            window=window)
    out = ref.chunk_attention(q, k, v, q_offset=q_offset, window=window)
    if not score_masses:
        return out
    B, C = q.shape[:2]
    row_valid = None
    if n_total is not None:
        row_valid = (q_offset + torch.arange(C, device=q.device)
                     < n_total).expand(B, C)
    return out, ref.chunk_column_masses(q, k, q_offset=q_offset,
                                        window=window, row_valid=row_valid)


def lookahead_score(q_obs: torch.Tensor, k: torch.Tensor, n_prompt: int, *,
                    kv_mask: Optional[torch.Tensor] = None, window=None,
                    q_offset: Optional[int] = None,
                    row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-q-head importance scores of the first ``n_prompt`` keys:
    (B, H, n_prompt) float32."""
    if _on_card(q_obs):
        return _lk.lookahead_score(q_obs, k, n_prompt, kv_mask=kv_mask,
                                   window=window, q_offset=q_offset,
                                   row_valid=row_valid)
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
    if _on_card(q):
        if not score_masses:
            return _pk.paged_decode_attention(q, k_pool, v_pool, mask_pool,
                                              table, **kw)
        out, masses = _pk.paged_decode_masses(q, k_pool, v_pool, mask_pool,
                                              table, **kw)
        return out, (masses if depth is None else masses[..., :depth])
    out = ref.paged_decode_attention(q, k_pool, v_pool, mask_pool, table,
                                     **kw)
    if not score_masses:
        return out
    return out, ref.paged_decode_masses(q, k_pool, mask_pool, table,
                                        depth=depth, **kw)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD chunked scan: x (B, S, nh, hd), dt (B, S, nh), A
    (nh,), Bm/Cm (B, S, 1, ds), initial_state (B, nh, hd, ds) or None ->
    (y (B, S, nh, hd), final state (B, nh, hd, ds)), both float32.  Any S
    (a ragged last chunk is exact) and any nh, on both routes."""
    if _on_card(x):
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
