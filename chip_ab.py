#!/usr/bin/env python3
"""Time the attention kernels of several checkouts in turns, on one
NVIDIA card, in one call:

    python3 chip_ab.py build/parent . . build/parent

Each argument is the root of a checkout of this repository (for the
parent, a ``git archive`` unpacked into a directory that ``.gitignore``
lists). Each runs in a process of its own, so each builds and loads its
own kernels (into ``<root>/build/repro_torch/``), and times its wrappers
at their main-path shapes, bf16: kernel 1 (``chunk_attention``) on
llama3-8b's deepest prefill chunk (C 256 at offset 3840 of a 4096-deep
buffer, 32 q / 8 kv heads of 128) and its 32-row observation pass (at
4000); kernel 2 (``chunk_attention_masses``) on that chunk with n_total
4000; kernel 7 (``flash_attention``) on llama3-8b's lockstep prefill (B 4,
S 2080, causal) and hymba-1.5b's (25 q / 5 kv heads of 64, window 1024
and global). The same inputs (seed 0) in every checkout, each call on a
cold L2 (``chip_smoke.time_ms`` of this checkout). Give the checkouts in
turns (parent, change, change, parent): two calls may land on two cards.
Prints one line per checkout and shape, then the card's name and power
limit.

    python3 chip_ab.py --splits .

times one checkout's kernels 1 and 2 at every 256-row chunk offset of
llama3-8b's chunked prefill of a 4000-token prompt (0 to 3840 of a
4096-deep buffer; kernel 2 with n_total 4000) and kernel 1's observation
pass (C 32 at n_total 1024, 2048, 3072 and 4000), with each query tile's
key range split over 1, 2, 3 and 4 CTAs (``key_splits`` replaced for the
sweep) and with the split ``key_splits`` picks; one line per shape.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHUNK_SHAPES = (  # C, K, q_offset, n_total (kernel 2) or None, label
    (256, 4096, 3840, None, "kernel 1, C 256 at 3840 of 4096"),
    (32, 4096, 4000, None, "kernel 1, observation pass C 32 at 4000"),
    (256, 4096, 3840, 4000, "kernel 2, C 256 at 3840, n_total 4000"),
)
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
    from repro_torch.kernels import chunk_attention as ck
    from repro_torch.kernels import flash_attention as fk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for C, K, off, n_total, label in CHUNK_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((1, C, 32, 128), (1, K, 8, 128),
                                 (1, K, 8, 128)))
        if n_total is None:
            fn = (lambda q=q, k=k, v=v, off=off:
                  ck.chunk_attention(q, k, v, q_offset=off))
        else:
            fn = (lambda q=q, k=k, v=v, off=off, n=n_total:
                  ck.chunk_attention_masses(q, k, v, q_offset=off,
                                            n_total=n))
        print(f"{root}: {label}: {chip_smoke.time_ms(torch, fn):.4f} ms",
              flush=True)
    for B, S, H, KV, hd, window, label in SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((B, S, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        ms = chip_smoke.time_ms(
            torch, lambda: fk.flash_attention(q, k, v, window=window))
        print(f"{root}: kernel 7, {label}: {ms:.4f} ms", flush=True)


def time_splits(root: str) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.kernels import chunk_attention as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rule = ck.key_splits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K = 4096
    k, v = (torch.randn((1, K, 8, 128), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    shapes = [(256, off, None) for off in range(0, 4000, 256)]
    shapes += [(256, off, 4000) for off in range(0, 4000, 256)]
    shapes += [(32, n, None) for n in (1024, 2048, 3072, 4000)]
    for C, off, n_total in shapes:
        q = torch.randn((1, C, 32, 128), generator=g, device=dev).to(
            torch.bfloat16)
        if n_total is None:
            fn = lambda: ck.chunk_attention(q, k, v, q_offset=off)
        else:
            fn = lambda: ck.chunk_attention_masses(q, k, v, q_offset=off,
                                                   n_total=n_total)
        picked = rule(1, C, 32, K, 128, torch.bfloat16, q_offset=off,
                      window=None, sms=sms)
        times = []
        for n in (1, 2, 3, 4):
            ck.key_splits = lambda *a, n=n, **kw: n
            try:
                times.append(chip_smoke.time_ms(torch, fn))
            finally:
                ck.key_splits = rule
        name = "kernel 1" if n_total is None else "kernel 2"
        print(f"{root}: {name}, C {C} at {off}: "
              + " / ".join(f"{t:.4f}" for t in times)
              + f" ms with 1 / 2 / 3 / 4 splits; key_splits picks {picked}",
              flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: needs an NVIDIA card")
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_checkout(sys.argv[2])
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--splits":
        time_splits(sys.argv[2])
        print(card())
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(card())


if __name__ == "__main__":
    main()
