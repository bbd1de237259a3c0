"""The port's dry-run sweep: every assigned (arch x shape) on one
mesh kind, one JSON file each (``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all --mesh pod

The combinations run in spawned worker processes, at most ``MAX_WORKERS``
and no more than the CPU cores or the combinations; each counts on the
meta device on one core.
"""

import argparse
import json
import multiprocessing as mp
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

MAX_WORKERS = 4


def _one(args: tuple) -> dict:
    """``run_one`` of one combination, or its error as the result."""
    from repro_torch.launch.dryrun import run_one

    arch, shape, mesh, out = args
    try:
        return run_one(arch, shape, mesh, out)
    except Exception as e:
        traceback.print_exc(limit=4)
        res = {"arch": arch, "shape": shape, "mesh": mesh,
               "status": "error", "error": repr(e)}
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"{arch}_{shape}_{mesh}.json"),
                  "w") as f:
            json.dump(res, f, indent=2)
        return res


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--archs", default="")
    ap.add_argument("--shapes", default="")
    args = ap.parse_args(argv)

    from repro_torch.common.config import INPUT_SHAPES
    from repro_torch.configs import ARCH_IDS

    archs = args.archs.split(",") if args.archs else list(ARCH_IDS)
    shapes = args.shapes.split(",") if args.shapes else list(INPUT_SHAPES)
    combos = [(a, s, args.mesh, args.out) for a in archs for s in shapes]
    workers = min(MAX_WORKERS, os.cpu_count() or 1, len(combos))
    t0 = time.time()
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"),
                             initializer=_single_thread) as pool:
        results = list(pool.map(_one, combos))
    failures = [(r["arch"], r["shape"], r["error"]) for r in results
                if r["status"] == "error"]
    print(f"[dryrun_all] {args.mesh}: done in {time.time() - t0:.0f}s; "
          f"{len(failures)} failures")
    for f in failures:
        print("  FAIL", f)
    return results


def _single_thread() -> None:
    import torch

    torch.set_num_threads(1)


if __name__ == "__main__":
    main()
