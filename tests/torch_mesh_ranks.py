"""Rank functions of the port's mesh tests that need neither JAX nor a
model: importable by name in the ranks ``launch/mesh.py::spawn_ranks``
spawns (this directory is on the spawned processes' path, as on the
test process's), so that a rank imports torch and the port only.
"""

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import linear

LORA_SCALE = 2.0


def two_products(x, w1, w2, lora, c, mesh=None):
    """A replicated ``x`` (B, S, D) through two column-parallel products,
    as a layer's attention runs them (``attention.column_linears``, the
    outputs gathered): ``tanh(linear(x, w1, lora))`` (``w1``'s columns
    per rank, the LoRA's ``a`` whole and ``b``'s columns), then the
    gathered activation times ``w2``'s columns; the loss ``sum(z * c)``.
    Without ``mesh`` the single-device computation, the same arithmetic."""
    mask = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype)
    if mesh is None:
        y = torch.tanh(linear(x, w1, lora=lora, lora_mask=mask,
                              lora_scale=LORA_SCALE))
        return ((y @ w2) * c).sum()
    y, = attn_mod.column_linears(
        x, [attn_mod.model_slice(w1, mesh).contiguous()], mesh,
        loras=[lora], lora_mask=mask, lora_scale=LORA_SCALE)
    y = attn_mod.all_gather(torch.tanh(y), -1, mesh)
    z, = attn_mod.column_linears(
        y, [attn_mod.model_slice(w2, mesh).contiguous()], mesh)
    return (attn_mod.all_gather(z, -1, mesh) * c).sum()


def autograd_collectives(rank: int, job: dict) -> dict:
    """One rank of a (1, world) mesh: ``two_products`` over the mesh and
    the gradients of its loss with respect to the replicated leaves
    ``x``, ``a`` and ``b`` (float64 numpy)."""
    del rank
    mesh = make_mesh((1, dist.get_world_size()))
    leaves = {k: torch.tensor(job[k], requires_grad=True)
              for k in ("x", "a", "b")}
    loss = two_products(leaves["x"], torch.tensor(job["w1"]),
                        torch.tensor(job["w2"]),
                        {"a": leaves["a"], "b": leaves["b"]},
                        torch.tensor(job["c"]), mesh)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out = {k: g.numpy() for k, g in zip(leaves, grads)}
    out["loss"] = float(loss.detach())
    return out
