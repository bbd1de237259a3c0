#!/usr/bin/env python3
"""Time kernel 7 (monolithic flash attention) of several checkouts in
turns, on one NVIDIA card, in one call:

    python3 chip_ab.py build/parent . . build/parent

Each argument is the root of a checkout of this repository (for the
parent, a ``git archive`` unpacked into a directory that ``.gitignore``
lists). Each runs in a process of its own, so each builds and loads its
own kernels (into ``<root>/build/repro_torch/``), and times its
``flash_attention`` wrapper at kernel 7's main-path shapes: llama3-8b's
lockstep prefill (B 4, S 2080, 32 q / 8 kv heads of 128, causal) and
hymba-1.5b's (25 q / 5 kv heads of 64, window 1024 and global), on the
same inputs (seed 0), each call on a cold L2 (``chip_smoke.time_ms`` of
this checkout). Give the checkouts in turns (parent, change, change,
parent): two calls may land on two cards. Prints one line per checkout
and shape, then the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = (  # B, S, H, KV, hd, window, label
    (4, 2080, 32, 8, 128, None, "llama3-8b causal"),
    (4, 2080, 25, 5, 64, 1024, "hymba-1.5b window 1024"),
    (4, 2080, 25, 5, 64, None, "hymba-1.5b global"),
)


def time_checkout(root: str) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.kernels import flash_attention as fk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for B, S, H, KV, hd, window, label in SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((B, S, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        ms = chip_smoke.time_ms(
            torch, lambda: fk.flash_attention(q, k, v, window=window))
        print(f"{root}: kernel 7, {label}: {ms:.4f} ms", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: needs an NVIDIA card")
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_checkout(sys.argv[2])
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
