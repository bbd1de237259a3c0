"""Fine-grained mixture-of-experts FFN (DeepSeek-MoE, Phi-3.5-MoE).

Shared experts always run; routed experts are chosen per token (top-k of
a float32 softmax router).  Two dispatches, as ``cfg.moe.dispatch``
selects:

* ``apply``: dense dispatch.  Every expert runs over every token and the
  gate weights zero the experts a token did not choose; the sequence runs
  in chunks of ``_CHUNK`` rows so the (E, rows, Fe) intermediates stay
  bounded.  Exact per token (chunking changes no sum), E/K times the
  routed FLOPs of top-k routing.
* ``apply_sparse``: sort-based capacity dispatch (GShard / Switch token
  dropping): each expert takes at most ``cap`` (token, choice) pairs in
  the order of a stable sort, so only top-k FLOPs run.  Capacity couples
  the rows of one call: every row passed in competes for it.

The expert products are batched over the expert axis: ``torch.matmul``
of the (rows, D) activations against the stacked (E, D, Fe) weights is
one batched GEMM that reads each weight where it lies (no per-call
permuted copy, no Python loop over experts).

Params (one layer; stacked along L by ``transformer.init_params``):
    router: (D, E) float32
    experts: {w_gate / w_up: (E, D, Fe), w_down: (E, Fe, D)}
    shared:  {w_gate / w_up: (D, Sh * Fe), w_down: (Sh * Fe, D)}  (fused)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import activation, dense_init, linear

# sequence-chunk length of the dense dispatch: bounds the live (E, B *
# chunk, Fe) intermediates
_CHUNK = 256


def init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, *,
         lead=()) -> dict:
    m = cfg.moe
    E, D, Fe = m.num_experts, cfg.d_model, m.d_expert
    p = {
        "router": dense_init(gen, D, E, torch.float32, lead=lead),
        "experts": {
            "w_gate": dense_init(gen, D, Fe, dtype, lead=(*lead, E)),
            "w_up": dense_init(gen, D, Fe, dtype, lead=(*lead, E)),
            "w_down": dense_init(gen, Fe, D, dtype, lead=(*lead, E)),
        },
    }
    if m.num_shared_experts > 0:
        Fs = m.num_shared_experts * Fe
        p["shared"] = {
            "w_gate": dense_init(gen, D, Fs, dtype, lead=lead),
            "w_up": dense_init(gen, D, Fs, dtype, lead=lead),
            "w_down": dense_init(gen, Fs, D, dtype, lead=lead),
        }
    return p


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, ties to
    the lower index (``jax.lax.top_k``'s order): a stable descending
    sort, never ``torch.topk``, which promises no order on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: dict, cfg: ModelConfig, h: torch.Tensor):
    """Router over (B, S, D): (combine (B, S, E) float32, aux scalar,
    gate values (B, S, K), expert ids (B, S, K)).  ``aux`` is the
    load-balance loss over every row passed in."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    logits = h.float() @ p["router"]  # (B, S, E) float32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = torch.nn.functional.one_hot(gate_idx, E).float()  # (B,S,K,E)
    combine = (onehot * gate_vals[..., None]).sum(dim=2)
    frac_tokens = onehot.sum(dim=2).mean(dim=(0, 1))  # (E,)
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs) * m.load_balance_coef
    return combine, aux, gate_vals, gate_idx


def _shared_out(p: dict, cfg: ModelConfig, h: torch.Tensor, *, lora=None,
                lora_mask=None, lora_scale: float = 1.0) -> torch.Tensor:
    def _l(name):
        return None if lora is None else lora.get(name)

    sh = p["shared"]
    sg = linear(h, sh["w_gate"], lora=_l("w_gate"), lora_mask=lora_mask,
                lora_scale=lora_scale)
    su = linear(h, sh["w_up"], lora=_l("w_up"), lora_mask=lora_mask,
                lora_scale=lora_scale)
    sy = activation(sg, cfg.act) * su
    return linear(sy, sh["w_down"], lora=_l("w_down"), lora_mask=lora_mask,
                  lora_scale=lora_scale)


def _experts(ew: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Every expert over its rows: x (E or 1, N, D) -> (E, N, D) in the
    model dtype, each product one batched GEMM over the expert axis (a
    (1, N, D) ``x`` is broadcast, not copied, to every expert)."""
    g = torch.matmul(x, ew["w_gate"])  # (E, N, Fe)
    u = torch.matmul(x, ew["w_up"])
    y = activation(g, cfg.act) * u
    return torch.matmul(y, ew["w_down"])  # (E, N, D)


def apply(p: dict, cfg: ModelConfig, h: torch.Tensor, *,
          lora: Optional[dict] = None,
          lora_mask: Optional[torch.Tensor] = None,
          lora_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch MoE over h (B, S, D): (out (B, S, D), aux).  The
    JAX package's rounding points: g, u, act(g) * u and each expert's
    output in the model dtype; the outputs cast to float32, weighted by
    ``combine`` and summed over the experts in float32; cast back, then
    the shared experts' output added."""
    B, S, D = h.shape
    combine, aux, _, _ = _route(p, cfg, h)
    chunk = min(_CHUNK, S)
    outs = []
    for s in range(0, S, chunk):
        hc = h[:, s:s + chunk]
        n = hc.shape[1]
        eo = _experts(p["experts"], cfg, hc.reshape(1, B * n, D))
        cc = combine[:, s:s + chunk].reshape(B * n, -1)  # (N, E)
        # sum_e eo[e, n, :] * combine[n, e], in float32
        o = (eo.float() * cc.T[:, :, None]).sum(dim=0)
        outs.append(o.reshape(B, n, D))
    out = torch.cat(outs, dim=1).to(h.dtype)
    if "shared" in p:
        out = out + _shared_out(p, cfg, h, lora=lora, lora_mask=lora_mask,
                                lora_scale=lora_scale)
    return out, aux


def apply_sparse(p: dict, cfg: ModelConfig, h: torch.Tensor, *,
                 capacity: Optional[int] = None,
                 lora: Optional[dict] = None,
                 lora_mask: Optional[torch.Tensor] = None,
                 lora_scale: float = 1.0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch over h (B, S, D): (out, aux), each
    expert taking ``capacity`` pairs, by default ``max(1,
    int(capacity_factor * N * K / E))`` for N = B * S rows.  The
    (token, choice) pairs are stably sorted by expert; the r-th pair of
    expert e lands in slot r of its (cap + 1)-row buffer while r < cap,
    every pair past capacity in the overflow row ``cap``, which is never
    read (a dropped pair contributes nothing; the shared experts and the
    residual still flow).  The pairs inside capacity write unique (expert,
    slot) cells, so the unordered scatter of duplicates can only touch the
    overflow row."""
    m = cfg.moe
    B, S, D = h.shape
    E, K = m.num_experts, m.top_k
    N = B * S
    NK = N * K
    cap = capacity or max(1, int(m.capacity_factor * NK / E))
    hf = h.reshape(N, D)
    dev = h.device

    _, aux, gate_vals, gate_idx = _route(p, cfg, h)
    flat_e = gate_idx.reshape(NK)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank_sorted = torch.arange(NK, device=dev) - first[sorted_e]
    slot = torch.empty_like(rank_sorted)
    slot[order] = rank_sorted

    within = slot < cap
    s_idx = torch.where(within, slot, torch.full_like(slot, cap))
    tok = torch.arange(NK, device=dev) // K
    buf = torch.zeros((E, cap + 1, D), dtype=h.dtype, device=dev)
    buf[flat_e, s_idx] = hf[tok]
    ybuf = _experts(p["experts"], cfg, buf[:, :cap])  # (E, cap, D)

    yk = ybuf[flat_e, torch.clamp(s_idx, max=cap - 1)]  # (NK, D)
    w = gate_vals.reshape(NK) * within.float()
    out = (yk.reshape(N, K, D).float() * w.reshape(N, K, 1)).sum(dim=1)
    out = out.reshape(B, S, D).to(h.dtype)
    if "shared" in p:
        out = out + _shared_out(p, cfg, h, lora=lora, lora_mask=lora_mask,
                                lora_scale=lora_scale)
    return out, aux
