"""Training launcher of the port: LookaheadKV module training on one device
or over a mesh of ranks.

    # on the CPU (the plain versions of the kernels), smoke width
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --steps 40 --verify
    # on the card: llama3-8b at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --steps 4 --batch 1 --n-in 1024 --n-out 64
    # the production mesh: 256 ranks (512 with --mesh multipod) under
    # torchrun, which initialises the process group from the environment
    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch llama3-8b --mesh pod --batch 256

Data sources:

* default: the synthetic mixture (``data/synthetic.MixtureIterator``),
  running the full two-pass objective (GT pass + lookahead pass) per step;
* ``--harvest <dir>``: distillation against gt_oracle targets harvested
  from serving traces (``python -m repro_torch.data.harvest``, or the JAX
  package's, which writes the same shards): each step runs only the
  lookahead pass against the stored score vectors;
* ``train_job``'s explicit batches (``job["batches"]``), the only source
  of qwen2-vl's patch embeddings and whisper's encoder frames: both
  sources above are token ids in either package, so the launcher refuses
  those archs (ROADMAP A10), as the JAX trainer has no batch for them.

On the card the GT pass runs kernels 7 and 3 (no gradient is taken
through it) and the lookahead pass the plain versions under
``ops.reference_mode()`` (the kernels have no backward).  There is no
fallback: ``--device cuda`` (the default) without a card raises.

Meshes: ``--mesh host`` is one process (the JAX trainer's host mesh on
one device).  ``--mesh pod|multipod`` is the JAX package's (16, 16) or
(2, 16, 16) mesh over a world of 256 or 512 ranks; a world of another
size raises ``ValueError`` naming the count.  ``train_shard`` runs one
rank of any mesh for ``launch/mesh.py::spawn_ranks``.  Each rank builds
only its shard of the frozen model (``sharding.serving_specs``' layout,
the one-rank tree's values) and the same modules as every other rank,
takes its data row's contiguous rows of the global batch (the JAX
trainer's ``P(dp, None)``; harvested ``s_gt`` on its batch dim,
``P(None, dp)``) and steps with the gradient averaged over the batch axes
(``steps.make_train_step(mesh=)``), so every rank returns the same losses
and modules.  A global batch the batch axes do not divide raises.

Checkpointing: ``--ckpt-every N`` writes the trainer state ``{"lkv",
"opt"}`` (modules + AdamState) every N steps; ``--resume`` picks up from
the last save (step count, optimizer moments and data stream position all
continue, so a killed run replays bit for bit).  Over a mesh rank 0
writes and the ranks meet at a barrier; every rank resumes from the file.
The files are the JAX package's layout (``checkpoint/io.py``): either
package loads the other's, and a checkpoint written under a mesh is the
one-process trainer's.  ``--verify`` turns the run into the train-smoke
gate (on rank 0 over a mesh): the loss must decrease and the final
checkpoint must round-trip bit-exactly.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.checkpoint import io as ckpt
from repro_torch.common.config import TrainConfig
from repro_torch.common.sharding import mesh_signature
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.lookahead import init_lookahead_params
from repro_torch.data import harvest, synthetic
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.analysis import tensor_bytes
from repro_torch.models import transformer as tf
from repro_torch.optim import adam


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-in", type=int, default=64)
    ap.add_argument("--n-out", type=int, default=12)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="experiments/ckpt/train_lkv.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--harvest", default="",
                    help="distill against a harvested gt_oracle dataset "
                         "directory instead of the synthetic mixture")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="write the trainer state (modules + AdamState) "
                         "every N steps (0: final save only)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --ckpt if it exists (step count, "
                         "optimizer moments and data position resume)")
    ap.add_argument("--verify", action="store_true",
                    help="train-smoke gate: assert the loss decreased and "
                         "the checkpoint round-trips bit-exactly")
    ap.add_argument("--device", default="cuda")
    # kill simulation for the resume test: exit (no final save) after N
    # steps, as if the process died mid-run
    ap.add_argument("--stop-after", type=int, default=0,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.technique_applies:
        raise SystemExit(f"{args.arch}: technique inapplicable (no "
                         "lookahead modules to train)")
    job = dict(cfg=cfg, device=args.device, steps=args.steps,
               batch=args.batch, n_in=args.n_in, n_out=args.n_out,
               lr=args.lr, ckpt=args.ckpt, seed=args.seed,
               harvest=args.harvest, ckpt_every=args.ckpt_every,
               resume=args.resume, verify=args.verify,
               stop_after=args.stop_after)
    if args.mesh == "host":
        return train_job(job)
    mesh_mod.init_from_env()
    mesh = mesh_mod.make_mesh(
        mesh_mod.PRODUCTION[args.mesh == "multipod"][0])
    device = args.device
    if torch.device(device).type == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    return train_job(job, mesh=mesh, device=device)


def train_shard(rank: int, job: dict) -> dict:
    """One rank of ``train_job`` for ``launch/mesh.py::spawn_ranks`` /
    ``run_jobs``: the mesh of ``job["mesh"]`` (its sizes: ("data",
    "model") or ("pod", "data", "model")) over the world, on the rank's
    device (``serve.rank_device``).  The result's tensors come back as
    numpy arrays (the AdamState as {"step", "mu", "nu"})."""
    n = dist.get_world_size()
    mesh = mesh_mod.make_mesh(tuple(job["mesh"]))
    res = train_job(job, mesh=mesh,
                    device=serve.rank_device(job["device"], rank, n))
    return to_host(res)


def to_host(tree):
    """A result tree with its tensors as numpy arrays on the host (the
    AdamState as {"step", "mu", "nu"}), picklable across ranks."""
    if isinstance(tree, adam.AdamState):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _rows(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's data row's contiguous rows of the global batch along
    ``dim``."""
    n = mesh.batch_size
    if x.shape[dim] % n:
        raise ValueError(f"a global batch of {x.shape[dim]} does not "
                         f"divide the {n} rows of the batch axes "
                         f"{mesh_mod.data_axes(mesh)}")
    w = x.shape[dim] // n
    return x.narrow(dim, mesh.data_index * w, w)


def _refuse_a10(cfg) -> None:
    """The synthetic mixture and harvested traces are token ids: neither
    package makes a VLM (patch embeddings) or frame batch for them."""
    if cfg.embeds_in or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"not ported yet: training {cfg.name} from the synthetic "
            "mixture or harvested traces, which hold no patch embeddings "
            "or encoder frames (pass explicit batches, job[\"batches\"]): "
            "ROADMAP A10")


def train_job(job: dict, *, mesh=None, device=None) -> dict:
    """Train the lookahead modules in this process, one device or one rank
    of ``mesh``.  ``job`` holds "cfg", "device", "steps", "batch" (the
    global batch), "n_in", "n_out", "lr", "ckpt", "seed" and optionally
    "harvest", "ckpt_every", "resume", "verify", "stop_after" (the
    launcher's flags), the weights as the JAX package's numpy trees
    "params" / "lkv" (``bridge``; else drawn from the seed, the modules
    from ``seed + 1``), "batches" (global batches of numpy arrays in
    place of the data source: {"x", "xy"}, with "frames" for an
    encoder-decoder arch, {"x", "y"[, "mrope"]} for an ``embeds_in``
    arch, or {"x", "s_gt"}; the only source of those two archs) and
    "return_grads" (keep each step's gradient, averaged over the batch
    axes, as the step gave it to Adam).  Returns the losses,
    gradient norms, seconds per step, the final modules and AdamState,
    the checkpoint and step, the kernel launches of the steps, the peak
    device bytes, the bytes of the rank's weights and, on the card, the
    caching allocator's rise while they were built."""
    cfg = job["cfg"]
    if job.get("batches") is None:
        _refuse_a10(cfg)
    dev = torch.device(device or job["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to train on the CPU")
    steps = job["steps"]
    tc = TrainConfig(steps=steps, lr=job["lr"], batch_size=job["batch"],
                     n_in=job["n_in"], n_out=job["n_out"], seed=job["seed"])
    harvest_dir = job.get("harvest", "")
    ckpt_path = job["ckpt"]
    rank0 = mesh is None or mesh.rank == 0
    before = serve.requested_bytes(dev)
    params = serve.job_params(job, cfg, mesh, dev)
    alloc = None if before is None else serve.requested_bytes(dev) - before
    if job.get("lkv") is not None:
        lkv = bridge.to_torch(job["lkv"], device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(job["seed"] + 1)
        lkv = init_lookahead_params(
            gen, cfg, tf.init_params(cfg, device="meta")["layers"],
            device=dev)
    opt = adam.init(lkv)

    start = 0
    if job.get("resume") and os.path.exists(ckpt_path):
        state = ckpt.load(ckpt_path, like={"lkv": lkv, "opt": opt},
                          device=dev)
        lkv, opt = state["lkv"], state["opt"]
        start = int(ckpt.metadata(ckpt_path).get("step", 0))
        if rank0:
            print(f"resumed {ckpt_path} at step {start}", flush=True)

    if job.get("batches") is not None:
        it = iter(job["batches"])
    elif harvest_dir:
        it = harvest.HarvestIterator(harvest_dir, job["batch"],
                                     seed=job["seed"])
    else:
        it = synthetic.MixtureIterator(cfg, job["batch"], job["n_in"],
                                       job["n_out"], seed=job["seed"])
    distill = bool(harvest_dir) or (job.get("batches") is not None
                                    and "s_gt" in job["batches"][0])
    make = steps_mod.make_distill_step if distill else \
        steps_mod.make_train_step
    step_fn = make(cfg, tc, mesh=mesh)
    # both iterators are pure functions of (seed, draw index), so the
    # resumed data stream continues exactly where the killed run left it
    for _ in range(start):
        next(it)

    def save_state(step: int) -> None:
        if rank0:
            ckpt.save(ckpt_path, {"lkv": lkv, "opt": opt},
                      metadata={"arch": cfg.name, "step": step,
                                "steps": steps,
                                "source": harvest_dir or "synthetic"})
        if mesh is not None and mesh.world is not None:
            dist.barrier(group=mesh.world)

    def local(b) -> dict:
        """The step's batch on ``dev``: this data row's rows over a
        mesh."""
        if isinstance(b, dict) and "s_gt" in b:
            batch = {"x": torch.as_tensor(b["x"], device=dev),
                     "s_gt": torch.as_tensor(b["s_gt"], device=dev)}
        elif isinstance(b, dict):  # {x, xy[, frames]} or {x, y[, mrope]}
            batch = {k: torch.as_tensor(b[k], device=dev)
                     for k in ("x", "xy", "y", "mrope", "frames") if k in b}
        else:
            xy = np.concatenate([b.x, b.y], axis=1)
            batch = {"x": torch.as_tensor(b.x, device=dev),
                     "xy": torch.as_tensor(xy, device=dev)}
        if mesh_signature(mesh) is not None:
            batch = {k: _rows(v, 1 if k in ("s_gt", "mrope") else 0, mesh)
                     for k, v in batch.items()}
        return batch

    losses, grad_norms, step_s, grads = [], [], [], []
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.time()

    def result(step: int) -> dict:
        return {"losses": losses, "grad_norms": grad_norms,
                "step_s": step_s, "ckpt": ckpt_path, "step": step,
                "lkv": lkv, "opt": opt, "grads": grads,
                "launches": ops.launch_counts(),
                "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                               if on_card else None),
                "param_bytes": tensor_bytes(params), "alloc_bytes": alloc,
                "model_index": 0 if mesh is None else mesh.model_index,
                "data_index": 0 if mesh is None else mesh.data_index}

    for i in range(start, steps):
        batch = local(next(it))
        t_step = time.perf_counter()
        lkv, opt, loss, metrics = step_fn(params, lkv, opt, batch)
        losses.append(float(loss))  # waits for the step
        grad_norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t_step)
        if job.get("return_grads"):
            grads.append(metrics["grads"])
        if rank0 and (i % 10 == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {losses[-1]:.4f}  grad norm "
                  f"{grad_norms[-1]:.4g}  ({time.time() - t0:.0f}s)",
                  flush=True)
        if (job.get("ckpt_every") and (i + 1) % job["ckpt_every"] == 0
                and (i + 1) < steps):
            save_state(i + 1)
        if job.get("stop_after") and (i + 1) >= job["stop_after"]:
            if rank0:
                print(f"stopped after step {i + 1} (simulated kill)")
            return result(i + 1)
    out = result(steps)
    save_state(steps)
    if rank0:
        print(f"saved -> {ckpt_path}")
    if job.get("verify") and rank0:
        verify(losses, lkv, opt, ckpt_path, steps, dev)
    return out


def verify(losses: list, lkv: dict, opt, ckpt_path: str, steps: int,
           dev) -> None:
    """The train-smoke gate: the loss fell and the checkpoint round-trips
    bit-exactly with the step count in its metadata."""
    if not (len(losses) >= 2 and min(losses[1:]) < losses[0]):
        raise AssertionError(
            f"train-smoke: loss did not decrease ({losses[0]:.4f} -> "
            f"{min(losses[1:]):.4f})")
    tree = {"lkv": lkv, "opt": opt}
    back = ckpt.load(ckpt_path, like=tree, device=dev)
    for a, b in zip(ckpt._flatten(tree).values(),
                    ckpt._flatten(back).values()):
        if a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
            raise AssertionError("train-smoke: the checkpoint does not "
                                 "round-trip bit-exactly")
    meta = ckpt.metadata(ckpt_path)
    if meta["step"] != steps:
        raise AssertionError(f"train-smoke: checkpoint metadata {meta}")
    print(f"train-smoke verdict: PASS (loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, checkpoint round-trips bit-exactly)")


if __name__ == "__main__":
    main()
