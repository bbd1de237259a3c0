"""Training launcher of the port: LookaheadKV module training on one device.

    # on the CPU (the plain versions of the kernels), smoke width
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --steps 40 --verify
    # on the card: llama3-8b at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --steps 4 --batch 1 --n-in 1024 --n-out 64

Data sources:

* default: the synthetic mixture (``data/synthetic.MixtureIterator``),
  running the full two-pass objective (GT pass + lookahead pass) per step;
* ``--harvest <dir>``: distillation against gt_oracle targets harvested
  from serving traces (``python -m repro_torch.data.harvest``, or the JAX
  package's, which writes the same shards): each step runs only the
  lookahead pass against the stored score vectors.

On the card the GT pass runs kernels 7 and 3 (no gradient is taken
through it) and the lookahead pass the plain versions under
``ops.reference_mode()`` (the kernels have no backward).  There is no
fallback: ``--device cuda`` (the default) without a card raises.

Checkpointing: ``--ckpt-every N`` writes the trainer state ``{"lkv",
"opt"}`` (modules + AdamState) every N steps; ``--resume`` picks up from
the last save (step count, optimizer moments and data stream position all
continue, so a killed run replays bit for bit).  The files are the JAX
package's layout (``checkpoint/io.py``): either package loads the other's.
``--verify`` turns the run into the train-smoke gate: the loss must
decrease and the final checkpoint must round-trip bit-exactly.  There is
no device mesh: ``--mesh pod|multipod`` raises (ROADMAP A11).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.lookahead import init_lookahead_params
from repro_torch.data import harvest, synthetic
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as tf
from repro_torch.optim import adam


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def main(argv=None) -> dict:
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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.technique_applies:
        raise SystemExit(f"{args.arch}: technique inapplicable (no "
                         "lookahead modules to train)")
    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh}: not ported yet: a "
                                  "device mesh: ROADMAP A11")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to train on the CPU")
    tc = TrainConfig(steps=args.steps, lr=args.lr, batch_size=args.batch,
                     n_in=args.n_in, n_out=args.n_out, seed=args.seed)

    params = tf.init_params(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    lkv = init_lookahead_params(gen, cfg, params["layers"])
    opt = adam.init(lkv)

    start = 0
    if args.resume and os.path.exists(args.ckpt):
        state = ckpt.load(args.ckpt, like={"lkv": lkv, "opt": opt},
                          device=dev)
        lkv, opt = state["lkv"], state["opt"]
        start = int(ckpt.metadata(args.ckpt).get("step", 0))
        print(f"resumed {args.ckpt} at step {start}", flush=True)

    if args.harvest:
        it = harvest.HarvestIterator(args.harvest, args.batch,
                                     seed=args.seed)
        step_fn = steps_mod.make_distill_step(cfg, tc)
    else:
        it = synthetic.MixtureIterator(cfg, args.batch, args.n_in,
                                       args.n_out, seed=args.seed)
        step_fn = steps_mod.make_train_step(cfg, tc)
    # both iterators are pure functions of (seed, draw index), so the
    # resumed data stream continues exactly where the killed run left it
    for _ in range(start):
        next(it)

    def save_state(step: int) -> None:
        ckpt.save(args.ckpt, {"lkv": lkv, "opt": opt},
                  metadata={"arch": cfg.name, "step": step,
                            "steps": args.steps,
                            "source": args.harvest or "synthetic"})

    losses, grad_norms, step_s = [], [], []
    t0 = time.time()
    for i in range(start, args.steps):
        b = next(it)
        if args.harvest:
            batch = {"x": torch.as_tensor(b["x"], device=dev),
                     "s_gt": torch.as_tensor(b["s_gt"], device=dev)}
        else:
            xy = np.concatenate([b.x, b.y], axis=1)
            batch = {"x": torch.as_tensor(b.x, device=dev),
                     "xy": torch.as_tensor(xy, device=dev)}
        t_step = time.perf_counter()
        lkv, opt, loss, metrics = step_fn(params, lkv, opt, batch)
        losses.append(float(loss))  # waits for the step
        grad_norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t_step)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  grad norm "
                  f"{grad_norms[-1]:.4g}  ({time.time() - t0:.0f}s)",
                  flush=True)
        if (args.ckpt_every and (i + 1) % args.ckpt_every == 0
                and (i + 1) < args.steps):
            save_state(i + 1)
        if args.stop_after and (i + 1) >= args.stop_after:
            print(f"stopped after step {i + 1} (simulated kill)")
            return {"losses": losses, "grad_norms": grad_norms,
                    "step_s": step_s, "ckpt": args.ckpt, "step": i + 1,
                    "lkv": lkv, "opt": opt}
    save_state(args.steps)
    print(f"saved -> {args.ckpt}")

    if args.verify:
        if not (len(losses) >= 2 and min(losses[1:]) < losses[0]):
            raise AssertionError(
                f"train-smoke: loss did not decrease ({losses[0]:.4f} -> "
                f"{min(losses[1:]):.4f})")
        tree = {"lkv": lkv, "opt": opt}
        back = ckpt.load(args.ckpt, like=tree, device=dev)
        for a, b in zip(ckpt._flatten(tree).values(),
                        ckpt._flatten(back).values()):
            if a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
                raise AssertionError("train-smoke: the checkpoint does not "
                                     "round-trip bit-exactly")
        meta = ckpt.metadata(args.ckpt)
        if meta["step"] != args.steps:
            raise AssertionError(f"train-smoke: checkpoint metadata {meta}")
        print(f"train-smoke verdict: PASS (loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, checkpoint round-trips bit-exactly)")
    return {"losses": losses, "grad_norms": grad_norms, "step_s": step_s,
            "ckpt": args.ckpt, "step": args.steps, "lkv": lkv, "opt": opt}


if __name__ == "__main__":
    main()
