#!/usr/bin/env python3
"""Time the kernels of several checkouts in turns, on one NVIDIA card, in
one call:

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
and global), and under its key mask on 3k's padded group (B 4, S 1024,
true lengths 512 / 700 / 900 / 1024; a checkout whose kernel takes no
mask prints so); kernels 4 (``paged_decode_attention``, 19 blocks of 16) and
5 (``paged_decode_masses``, 20 blocks) at phase 1's paged decode shape
(4 slots, 32 q / 8 kv heads of 128), with all slots live and with one
live slot of four; kernel 6 (``decode_attention``) at phase 1's dense
decode shape (4 sequences x 289 rows, per-kv-head mask) and hymba-1.5b's
local layer; kernel 3 (``lookahead_score``) at llama3-8b's finalize (32
rows at 4000 of 4096), the lockstep prefill's call (4 x 32 rows after
2048), monolithic h2o (2048 rows at 0) and hymba-1.5b's local layer;
kernel 8 (``ssd_scan``) at hymba-1.5b's lockstep prefill (B 4 x S 2048,
50 heads of 64, d_state 16, chunk 128), its 32-row lookahead segment on a
carried state, and mamba2-130m's prefill (24 heads, d_state 128), x, B
and C strided views of one conv output as the Mamba-2 block passes them.
The same inputs (seed 0) in every checkout, each call
on a cold L2 (``chip_smoke.time_ms`` of this checkout). Give the checkouts in
turns (parent, change, change, parent): two calls may land on two cards.
Prints one line per checkout and shape, then the card's name and power
limit.

    python3 chip_ab.py --splits .

times one checkout's kernels 1 and 2 at every 256-row chunk offset of
llama3-8b's chunked prefill of a 4000-token prompt (0 to 3840 of a
4096-deep buffer; kernel 2 with n_total 4000) and kernel 1's observation
pass (C 32 at n_total 1024, 2048, 3072 and 4000), with each query tile's
key range split over 1, 2, 3 and 4 CTAs (``key_splits`` replaced for the
sweep) and with the split ``key_splits`` picks; then kernels 4 and 5 at
phase 1's paged decode shape over 4, 8, 19, 20 and 32 blocks of 16, all
slots live and one live slot of four, with each (sequence, kv head)'s
rows split over 1, 2, 4 and 8 CTAs of a cluster (``row_splits``
replaced) and the split ``row_splits`` picks; kernel 6 likewise at C 64,
128, 289, 512 and 1024 rows (``decode_attention.row_splits``); kernel 3
at llama3-8b's finalize and the lockstep prefill's call with 1, 2, 4, 8,
16, 24 and 32 key splits in launch (a) (``lookahead_score.key_splits``)
and 1, 2, 4 and 8 key tiles per CTA of launch (b)
(``lookahead_score.column_tiles``); kernel 8 at its three shapes with 1,
2, 4 and 8 heads per CTA of launches (a) and (c) (``ssd_scan.head_block``);
one line per shape, the rule's pick marked with a *.

    python3 chip_ab.py --ssd .

times kernel 8 alone: its head-block sweep (as in ``--splits``), then its
three launches apart at the rule's pick, from the profiler's trace of 10
calls, each on a cold L2: launch (a)'s span, and how much later than the
launch before it (b) and (c) end (they are programmatic dependent
launches, so each may start before its predecessor ends).

    python3 chip_ab.py --marks .

times a one-element ``add_`` (the floor of every time taken this way),
then builds a copy of kernels 4 and 5 with a clock64 mark at each phase
of ``csrc/decode_split.cuh`` (into ``<root>/build/marks/``; the copy is
never loaded by the port) and prints, for phase 1's paged shapes at
``row_splits``' split with live and with null tables, the event time,
the time before the first CTA starts and the mean per-CTA time of each
phase.

    python3 chip_ab.py --prefill .

times ``transformer.prefill`` of llama3-8b at full width (bf16, random
weights and lookahead modules from seed 0, budget 256) on 4 prompts of
2048 tokens under the passes that 3b, 3i and 3j run before their first
token: lookaheadkv, lookaheadkv with its lookahead rows but without
their LoRA, snapkv (LAQ's first pass), gt_oracle over 2048 + 8 rows (the
rescoring pass of LAQ and SpecKV), full, and no policy (no scoring, no
cache).  Host clock around each call, which ends in a device sync; the
cases run in turns, 7 rounds, the first 2 dropped; prints each case's
median, min and max.

    python3 chip_ab.py --train-lengths build/parent .

runs each checkout's ``launch/train.py`` (a process of its own, that
checkout's ``src`` first on the path, its kernels built into
``<root>/build/repro_torch/``) on llama3-8b at the paper's lengths:
``--n-in 3584 --n-out 512 --batch 1 --steps 2`` (seed 0); prints per
checkout the ms per step, the losses and the peak of
``torch.cuda.max_memory_allocated``, or the out-of-memory error and the
peak reached before it.
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


PAGED = (4, 32, 8, 128, 16)  # slots, q heads, kv heads, hd, block size
DENSE = (  # B, C, H, KV, hd, window, label
    (4, 289, 32, 8, 128, None, "llama3-8b, 4 x 289 rows"),
    (4, 289, 25, 5, 64, 1024, "hymba-1.5b local layer, 4 x 289 rows"),
)
SCORES = (  # B, n_obs, Sk, n_prompt, q_offset, H, KV, hd, window, label
    (1, 32, 4096, 4096, 4000, 32, 8, 128, None,
     "llama3-8b finalize, 32 rows at 4000 of 4096"),
    (4, 32, 2080, 2048, None, 32, 8, 128, None,
     "llama3-8b lockstep, 4 x 32 rows after 2048"),
    (1, 2048, 2048, 2048, 0, 32, 8, 128, None,
     "llama3-8b monolithic h2o, 2048 rows at 0"),
    (4, 32, 2080, 2048, None, 25, 5, 64, 1024,
     "hymba-1.5b local layer, 4 x 32 rows after 2048"),
)

SSD = (  # B, S, nh, hd, ds, chunk, carried state, label
    (4, 2048, 50, 64, 16, 128, False, "hymba-1.5b prompt, 4 x 2048"),
    (4, 32, 50, 64, 16, 128, True, "hymba-1.5b lookahead segment, 4 x 32"),
    (4, 2048, 24, 64, 128, 128, False, "mamba2-130m prefill, 4 x 2048"),
)


def ssd_inputs(torch, g, B, S, nh, hd, ds, carried):
    """Phase 1's kernel-8 inputs (``chip_smoke.phase_kernels``): x, B and C
    views of one bf16 conv output, dt = softplus(N - 2), A in -[1, 16],
    a random incoming state where the segment carries one."""
    dev = torch.device("cuda")
    xbc = torch.randn((B, S, nh * hd + 2 * ds), generator=g,
                      device=dev).to(torch.bfloat16)
    x, Bm, Cm = torch.split(xbc, [nh * hd, ds, ds], dim=-1)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=g, device=dev) - 2.0)
    A = -(1.0 + 15.0 * torch.rand((nh,), generator=g, device=dev))
    h0 = (torch.randn((B, nh, hd, ds), generator=g, device=dev)
          if carried else None)
    return (x.unflatten(-1, (nh, hd)), dt, A, Bm.unflatten(-1, (1, ds)),
            Cm.unflatten(-1, (1, ds)), h0)


def dense_inputs(torch, g, B, C, H, KV, hd, window):
    """Phase 1's dense decode inputs (``chip_smoke.phase_kernels``): kept
    rows with a few dropped per kv head, no appends past row 272, and the
    window folded into the mask."""
    dev = torch.device("cuda")
    q = torch.randn((B, H, hd), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, C, KV, hd), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    mask = torch.rand((B, C, KV), generator=g, device=dev) > 0.05
    mask[:, 272:] = False
    if window is not None:
        pos = torch.randint(0, 2080, (B, C, KV), generator=g, device=dev)
        mask &= (2080 - pos) < window
    return q, k, v, mask


def score_inputs(torch, g, B, n_obs, Sk, H, KV, hd):
    dev = torch.device("cuda")
    return (torch.randn((B, n_obs, H, hd), generator=g, device=dev)
            .to(torch.bfloat16),
            torch.randn((B, Sk, KV, hd), generator=g, device=dev)
            .to(torch.bfloat16))


def paged_inputs(torch, g, nb: int, one_live: bool):
    """Phase 1's paged decode inputs (``chip_smoke.phase_kernels``): a
    pool of 129 blocks, 90% of its rows live, a table of ``nb`` distinct
    blocks per slot; with ``one_live`` slots 1-3 are between requests
    (null tables)."""
    B, H, KV, hd, bs = PAGED
    dev = torch.device("cuda")
    N = 129
    q = torch.randn((B, H, hd), generator=g, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn((N, bs, KV, hd), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    mask = torch.rand((N, bs, KV), generator=g, device=dev) > 0.1
    mask[0] = False  # the null block
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    table = perm[:B * nb].reshape(B, nb).to(torch.int32)
    if one_live:
        table[1:] = 0
    return q, kp, vp, mask, table


def time_checkout(root: str) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.kernels import chunk_attention as ck
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import lookahead_score as lk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ssd_scan as sk

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
    time_masked_flash(root, torch, chip_smoke, fk, g)
    for nb, one_live in ((19, False), (19, True), (20, False), (20, True)):
        args = paged_inputs(torch, g, nb, one_live)
        fn = pk.paged_decode_attention if nb == 19 else pk.paged_decode_masses
        live = "one live slot" if one_live else "all slots live"
        ms = chip_smoke.time_ms(torch, lambda: fn(*args), iters=50)
        print(f"{root}: kernel {4 if nb == 19 else 5}, {nb} blocks of 16, "
              f"{live}: {ms:.4f} ms", flush=True)
    for B, C, H, KV, hd, window, label in DENSE:
        q, k, v, mask = dense_inputs(torch, g, B, C, H, KV, hd, window)
        ms = chip_smoke.time_ms(
            torch, lambda: dk.decode_attention(q, k, v, kv_mask=mask),
            iters=50)
        print(f"{root}: kernel 6, {label}: {ms:.4f} ms", flush=True)
    for B, n_obs, Sk, n_prompt, off, H, KV, hd, window, label in SCORES:
        q, k = score_inputs(torch, g, B, n_obs, Sk, H, KV, hd)
        ms = chip_smoke.time_ms(torch, lambda: lk.lookahead_score(
            q, k, n_prompt, q_offset=off, window=window),
            iters=5 if n_obs > 32 else 20)
        print(f"{root}: kernel 3, {label}: {ms:.4f} ms", flush=True)
    for B, S, nh, hd, ds, chunk, carried, label in SSD:
        x, dt, A, Bm, Cm, h0 = ssd_inputs(torch, g, B, S, nh, hd, ds,
                                          carried)
        ms = chip_smoke.time_ms(torch, lambda: sk.ssd_scan(
            x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0))
        print(f"{root}: kernel 8, {label}: {ms:.4f} ms", flush=True)


def time_masked_flash(root: str, torch, chip_smoke, fk, g) -> None:
    """Kernel 7 under its key mask at 3k's padded group (a checkout whose
    wrapper takes no ``kv_mask`` prints so)."""
    import inspect

    if "kv_mask" not in inspect.signature(fk.flash_attention).parameters:
        print(f"{root}: kernel 7 masked: no key mask in this checkout",
              flush=True)
        return
    dev = torch.device("cuda")
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((4, 1024, 32, 128), (4, 1024, 8, 128),
                             (4, 1024, 8, 128)))
    lens = torch.tensor([512, 700, 900, 1024], device=dev)
    mask = (torch.arange(1024, device=dev) < lens[:, None]).contiguous()
    ms = chip_smoke.time_ms(
        torch, lambda: fk.flash_attention(q, k, v, kv_mask=mask))
    print(f"{root}: kernel 7 masked, 3k's padded group 4 x 1024: "
          f"{ms:.4f} ms", flush=True)


def time_prefill(root: str, torch) -> None:
    """The passes before the first token of 3b, 3i and 3j, each a whole
    ``transformer.prefill`` at full width (module docstring)."""
    import time

    from repro_torch.common.config import EvictionConfig
    from repro_torch.configs import get_config
    from repro_torch.core.lookahead import init_lookahead_params
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = get_config("llama3-8b")
    params = tf.init_params(cfg, seed=0, device=dev)
    lkv = init_lookahead_params(torch.Generator(device=dev).manual_seed(1),
                                cfg, params["layers"])
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                           device=dev, dtype=torch.int32)
    xy = torch.randint(0, cfg.vocab_size, (4, 2056), generator=g,
                       device=dev, dtype=torch.int32)
    evict = EvictionConfig(budget=256, draft_len=8)
    cases = {
        "lookaheadkv": (tokens, dict(policy="lookaheadkv", lkv_params=lkv)),
        "lookaheadkv, rows without LoRA": (tokens, dict(
            policy="lookaheadkv", lkv_params={"emb": lkv["emb"]})),
        "snapkv": (tokens, dict(policy="snapkv")),
        "gt_oracle, 2048 + 8 rows": (xy, dict(policy="gt_oracle",
                                              gt_boundary=2048)),
        "full": (tokens, dict(policy="full")),
        "no policy": (tokens, {}),
    }
    times = {label: [] for label in cases}
    for _ in range(7):
        for label, (toks, kw) in cases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tf.prefill(params, cfg, toks, evict=evict, extra_slots=33, **kw)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    for label, t in times.items():
        kept = sorted(t[2:])
        print(f"{root}: prefill 4 x 2048, {label}: "
              f"{kept[len(kept) // 2] * 1e3:.1f} ms (median of "
              f"{len(kept)}; {kept[0] * 1e3:.1f} - {kept[-1] * 1e3:.1f})",
              flush=True)


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
    time_row_splits(root, torch, chip_smoke)
    time_dense_splits(root, torch, chip_smoke)
    time_key_splits(root, torch, chip_smoke)
    time_head_blocks(root, torch, chip_smoke)


def swept(times, counts, picked) -> str:
    """'t1 / t2* / ...' with the rule's pick marked."""
    return " / ".join(f"{t:.4f}" + ("*" if n == picked else "")
                      for t, n in zip(times, counts))


def time_dense_splits(root: str, torch, chip_smoke) -> None:
    """Kernel 6 with 1, 2, 4 and 8 CTAs per (sequence, kv head)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rule = dk.row_splits
    B, _, H, KV, hd, _, _ = DENSE[0]
    counts = (1, 2, 4, 8)
    for C in (64, 128, 289, 512, 1024):
        picked = rule(B, KV, C, build.sm_count(dev))
        q, k, v, mask = dense_inputs(torch, g, B, C, H, KV, hd, None)
        times = []
        for n in counts:
            dk.row_splits = lambda *a, n=n, **kw: n
            try:
                times.append(chip_smoke.time_ms(
                    torch, lambda: dk.decode_attention(q, k, v,
                                                       kv_mask=mask),
                    iters=50))
            finally:
                dk.row_splits = rule
        print(f"{root}: kernel 6, 4 x {C} rows: {swept(times, counts, picked)}"
              f" ms with 1 / 2 / 4 / 8 splits; row_splits picks {picked}",
              flush=True)


def time_key_splits(root: str, torch, chip_smoke) -> None:
    """Kernel 3 with 1 to 16 key splits in launch (a)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import lookahead_score as lk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = build.sm_count(dev)
    for B, n_obs, Sk, n_prompt, off, H, KV, hd, window, label in SCORES[:2]:
        q, k = score_inputs(torch, g, B, n_obs, Sk, H, KV, hd)
        visible = min(Sk, (n_prompt if off is None else off) + n_obs)
        call = lambda: lk.lookahead_score(q, k, n_prompt, q_offset=off,
                                          window=window)
        for rule_name, counts, picked in (
                ("key_splits", (1, 2, 4, 8, 16, 24, 32),
                 lk.key_splits(B, n_obs, H, KV, visible, sms, hd)),
                ("column_tiles", (1, 2, 4, 8),
                 lk.column_tiles(B, n_obs, H, KV, hd, n_prompt,
                                 lk.key_splits(B, n_obs, H, KV, visible,
                                               sms, hd), sms))):
            rule = getattr(lk, rule_name)
            times = []
            for n in counts:
                setattr(lk, rule_name, lambda *a, n=n, **kw: n)
                try:
                    times.append(chip_smoke.time_ms(torch, call))
                finally:
                    setattr(lk, rule_name, rule)
            print(f"{root}: kernel 3, {label}: {swept(times, counts, picked)}"
                  f" ms with {' / '.join(map(str, counts))} "
                  f"{'key splits' if rule_name == 'key_splits' else 'key tiles per launch (b) CTA'}"
                  f"; {rule_name} picks {picked}", flush=True)


def time_head_blocks(root: str, torch, chip_smoke) -> None:
    """Kernel 8 with 1, 2, 4 and 8 heads per CTA of launches (a) and (c)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as sk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rule = sk.head_block
    counts = (1, 2, 4, 8)
    for B, S, nh, hd, ds, chunk, carried, label in SSD:
        picked = rule(B, S, nh, chunk, build.sm_count(dev))
        x, dt, A, Bm, Cm, h0 = ssd_inputs(torch, g, B, S, nh, hd, ds,
                                          carried)
        times = []
        for n in counts:
            sk.head_block = lambda *a, n=n, **kw: n
            try:
                times.append(chip_smoke.time_ms(torch, lambda: sk.ssd_scan(
                    x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)))
            finally:
                sk.head_block = rule
        print(f"{root}: kernel 8, {label}: {swept(times, counts, picked)} ms "
              f"with 1 / 2 / 4 / 8 heads per CTA; head_block picks {picked}",
              flush=True)


def time_launch_split(root: str, torch, chip_smoke) -> None:
    """Kernel 8's launches (a), (b) and (c) apart, from the trace's kernel
    start and end times (us, the mean of 10 calls on a cold L2)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_scan as sk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    trace = Path(root).resolve() / "build" / "ssd_launches.json"
    for B, S, nh, hd, ds, chunk, carried, label in SSD:
        x, dt, A, Bm, Cm, h0 = ssd_inputs(torch, g, B, S, nh, hd, ds,
                                          carried)
        call = lambda: sk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                   initial_state=h0)
        call()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                scrub.zero_()
                torch.cuda._sleep(10_000_000)
                call()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        evs = sorted((e for e in json.loads(trace.read_text())["traceEvents"]
                      if e.get("cat") == "kernel" and "ssd_" in e["name"]),
                     key=lambda e: e["ts"])
        trace.unlink()
        calls = [evs[i:i + 3] for i in range(0, len(evs), 3)]
        end = [[e["ts"] + e["dur"] for e in c] for c in calls]
        parts = (sum(c[0]["dur"] for c in calls) / len(calls),
                 sum(t[1] - t[0] for t in end) / len(calls),
                 sum(t[2] - t[1] for t in end) / len(calls),
                 sum(t[2] - c[0]["ts"] for t, c in zip(end, calls))
                 / len(calls))
        print(f"{root}: kernel 8, {label}: (a) {parts[0]:.1f} us, (b) ends "
              f"{parts[1]:.1f} us later, (c) {parts[2]:.1f} us after (b); "
              f"{parts[3]:.1f} us from (a)'s start to (c)'s end "
              f"({len(calls)} calls)", flush=True)


def time_row_splits(root: str, torch, chip_smoke) -> None:
    """Kernels 4 and 5 with 1, 2, 4 and 8 CTAs per (sequence, kv head)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rule = pk.row_splits
    B, _, KV, _, bs = PAGED
    for nb in (4, 8, 19, 20, 32):
        picked = rule(B, KV, nb, bs, build.sm_count(dev))
        for one_live in (False, True):
            args = paged_inputs(torch, g, nb, one_live)
            for name, fn in (("kernel 4", pk.paged_decode_attention),
                             ("kernel 5", pk.paged_decode_masses)):
                times = []
                for n in (1, 2, 4, 8):
                    pk.row_splits = lambda *a, n=n, **kw: n
                    try:
                        times.append(chip_smoke.time_ms(
                            torch, lambda: fn(*args), iters=50))
                    finally:
                        pk.row_splits = rule
                live = "one live slot" if one_live else "all slots live"
                print(f"{root}: {name}, {nb} blocks of 16, {live}: "
                      + " / ".join(f"{t:.4f}" for t in times)
                      + " ms with 1 / 2 / 4 / 8 splits; row_splits picks "
                      f"{picked}", flush=True)


#: (anchor in csrc/decode_split.cuh, mark inserted before (False) or
#: after (True) it, mark index); a mark is thread 0's clock64 once the
#: values before it are ready
MARKS = (
    ("  const int n_split = cluster_size(), rank = cluster_rank();\n", True,
     0),
    ("    int rid = resolve(a_cur, p_cur);\n", True, 1),
    ("    cp_async_wait<0>();\n\n", True, 2),
    ("    // push this warp's partial", False, 3),
    ("    const int parts = n_split * WARPS;", False, 4),
    ("    if (MASSES) {\n      // exp2(s - m) / l of the rows", False, 5),
    ("    // another pass pushes", False, 6),
)
PHASES = ("table and mask round trips", "row loop", "slot merge",
          "push and cluster barrier", "final merge and out",
          "masses", "end")


def time_marks(root: str) -> None:
    """Where the time of kernels 4 and 5 goes inside their CTAs."""
    import ctypes

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    src = Path(root).resolve() / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pk

    x = torch.zeros(1, device="cuda")
    floor = chip_smoke.time_ms(torch, lambda: x.add_(1), iters=50)
    print(f"{root}: one-element add_ (the floor): {floor:.4f} ms", flush=True)
    csrc = src / "repro_torch" / "csrc"
    out = Path(root).resolve() / "build" / "marks"
    out.mkdir(parents=True, exist_ok=True)
    h = (csrc / "decode_split.cuh").read_text()
    head = ("__device__ long long g_marks[16384][8], g_gt[16384][2];\n"
            "__device__ __forceinline__ int mark_cta() { return blockIdx.x + "
            "gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); }\n")
    h = h.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + head)
    for anchor, after, i in MARKS:
        check = {1: "rid != 0x7fffffff && ", 2: "m[0] != 1.f && ",
                 3: "m[0] != 1.f && "}.get(i, "")
        mark = (f"    if ({check}threadIdx.x == 0) g_marks[mark_cta()][{i}] = "
                "clock64();\n")
        if i == 0:
            mark += ("    if (threadIdx.x == 0) asm volatile(\"mov.u64 %0, "
                     "%%globaltimer;\" : \"=l\"(g_gt[mark_cta()][0]));\n")
        if h.count(anchor) != 1:
            raise SystemExit(f"chip_ab --marks: anchor {anchor!r} not found "
                             "once in decode_split.cuh")
        h = h.replace(anchor, anchor + mark if after else mark + anchor)
    end = "  }\n}\n\n}  // namespace decode_split"
    h = h.replace(end, "    if (threadIdx.x == 0) { g_marks[mark_cta()][7] = "
                  "clock64(); asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
                  "\"=l\"(g_gt[mark_cta()][1])); }\n" + end)
    (out / "decode_split.cuh").write_text(h)
    (out / "common.cuh").write_text((csrc / "common.cuh").read_text())
    (out / "paged_marks.cu").write_text(
        (csrc / "paged_attention.cu").read_text()
        + '\nextern "C" int read_marks(void* m, void* g) {\n'
        "  cudaMemcpyFromSymbol(m, g_marks, sizeof(g_marks));\n"
        "  return cudaMemcpyFromSymbol(g, g_gt, sizeof(g_gt));\n}\n")
    lib = out / "libpaged_marks.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "paged_marks.cu")], check=True)
    dll = ctypes.CDLL(str(lib))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, KV, hd, bs = PAGED
    marks = torch.zeros((16384, 8), dtype=torch.int64)
    gt = torch.zeros((16384, 2), dtype=torch.int64)
    for entry, nb in (("paged_decode_attention", 19),
                      ("paged_decode_masses", 20)):
        fn = getattr(dll, entry)
        fn.argtypes = build.SIGNATURES[entry]
        n = pk.row_splits(B, KV, nb, bs, build.sm_count(dev))
        for null in (False, True):
            q, kp, vp, mask, table = paged_inputs(torch, g, nb, False)
            if null:
                table.zero_()
            o = torch.empty_like(q)
            ms = torch.empty((B, H, nb * bs), device=dev)
            extra = [ms.data_ptr()] if entry == "paged_decode_masses" else []
            call = lambda: fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                              mask.data_ptr(), None, table.data_ptr(), None,
                              o.data_ptr(), *extra, B, H, KV, hd, bs, nb, 0,
                              n, build.DTYPE_CODES[q.dtype],
                              build.stream_ptr())
            t = chip_smoke.time_ms(torch, call, iters=30)  # the last: cold
            torch.cuda.synchronize()
            dll.read_marks(ctypes.c_void_p(marks.data_ptr()),
                           ctypes.c_void_p(gt.data_ptr()))
            ctas = n * KV * B
            mk, gg = marks[:ctas].double(), gt[:ctas].double()
            clk_ns = float(((mk[:, 7] - mk[:, 0]) / (gg[:, 1] - gg[:, 0]))
                           .median())
            phase = (mk[:, 1:] - mk[:, :-1]) / clk_ns / 1e3  # us
            span = float(gg[:, 1].max() - gg[:, 0].min()) / 1e3
            tables = "null tables" if null else "live tables"
            print(f"{root}: {entry}, {nb} blocks, {n} splits, {tables}: "
                  f"{t * 1e3:.2f} us, of which {t * 1e3 - span:.2f} before "
                  f"the first CTA starts; per CTA "
                  + "; ".join(f"{name} {float(phase[:, i].mean()):.2f}"
                              for i, name in enumerate(PHASES))
                  + " us", flush=True)


def train_lengths(root: str, torch) -> None:
    """One checkout's trainer at the paper's lengths (module docstring)."""
    import tempfile

    from repro_torch.launch import train

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        try:
            res = train.main(["--arch", "llama3-8b", "--seed", "0",
                              "--device", "cuda", "--n-in", "3584",
                              "--n-out", "512", "--batch", "1", "--steps",
                              "2", "--ckpt", f"{d}/lkv.npz"])
        except torch.OutOfMemoryError as e:
            print(f"{root}: train at n_in 3584, n_out 512, B 1: out of "
                  f"memory, peak {torch.cuda.max_memory_allocated()} bytes "
                  f"before it; {str(e).splitlines()[0]}", flush=True)
            return
    print(f"{root}: train at n_in 3584, n_out 512, B 1: ms per step "
          f"{[round(s * 1e3, 1) for s in res['step_s']]}, losses "
          f"{res['losses']}, peak {torch.cuda.max_memory_allocated()} "
          "bytes", flush=True)


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
    if len(sys.argv) > 2 and sys.argv[1] == "--marks":
        time_marks(sys.argv[2])
        print(card())
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--ssd":
        sys.path.insert(0, str(ROOT))
        import chip_smoke

        sys.path.insert(0, str(Path(sys.argv[2]).resolve() / "src"))
        time_head_blocks(sys.argv[2], torch, chip_smoke)
        time_launch_split(sys.argv[2], torch, chip_smoke)
        print(card())
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--prefill":
        sys.path.insert(0, str(Path(sys.argv[2]).resolve() / "src"))
        time_prefill(sys.argv[2], torch)
        print(card())
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--train-one":
        sys.path.insert(0, str(Path(sys.argv[2]).resolve() / "src"))
        train_lengths(sys.argv[2], torch)
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--train-lengths":
        for root in sys.argv[2:]:
            subprocess.run([sys.executable, __file__, "--train-one", root],
                           check=True)
        print(card())
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
