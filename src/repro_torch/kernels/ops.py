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
from repro_torch.kernels import lookahead_score as _lk
from repro_torch.kernels import paged_attention as _pk
from repro_torch.kernels import ref

KERNEL_MODULES = {
    "chunk_attention": _ck,
    "lookahead_score": _lk,
    "paged_decode_attention": _pk,
}


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, window=None) -> torch.Tensor:
    """Attention of one chunk (B, C, H, hd) at ``q_offset`` over the
    (B, K, KV, hd) buffer; both routes raise unless q_offset + C <= K."""
    if _on_card(q):
        return _ck.chunk_attention(q, k, v, q_offset=q_offset, window=window)
    return ref.chunk_attention(q, k, v, q_offset=q_offset, window=window)


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
                           window=None) -> torch.Tensor:
    """Decode attention of one token per sequence over the paged pool;
    both routes walk the whole block table (rows past a sequence's logical
    depth are masked in the pool)."""
    if _on_card(q):
        return _pk.paged_decode_attention(q, k_pool, v_pool, mask_pool, table,
                                          pos_pool=pos_pool, new_pos=new_pos,
                                          window=window)
    return ref.paged_decode_attention(q, k_pool, v_pool, mask_pool, table,
                                      pos_pool=pos_pool, new_pos=new_pos,
                                      window=window)
