#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (an H100).

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
kernel's plain version):

0. Build the CUDA kernels from ``src/repro_torch/csrc/`` with nvcc for
   sm_90a into ``build/repro_torch/`` (one nvcc per source, all at once;
   rebuilt when a source's hash changes), and check with ``cuobjdump
   -sass`` that each instantiation of the Hopper tile
   (``attention_sm90.cuh``: kernel 7's eight, with and without its key
   mask, kernel 1's and kernel 2's
   first launch at hd 64 and 128, kernel 2's ``column_masses_sm90``)
   holds HGMMA (wgmma) and UTMALDG (TMA loads), and with nvcc's
   ``-Xptxas -v`` that none of them, nor kernels 1's and 2's merges of a
   split key range (``combine_splits``), spills; print their registers
   (a ``chunk_attention`` library left by an earlier run is built again
   for that report); likewise each of the 12 instantiations of kernels 4
   and 5 (``decode_split.cuh``: 2 kernels x float32 / bf16 x hd 32, 64,
   128), the 6 of kernel 6 on the same routine (float32 / bf16 x 3 hd)
   and the 6 of kernel 3's tensor-core kernels (launches (a) and (b),
   bf16, 3 hd) must have a ``-Xptxas -v`` entry and spill nothing.
1. Hold each kernel against its plain PyTorch version on the card, in
   bfloat16, at the shapes of the main paths (llama3-8b: H=32, KV=8,
   hd=128; chunk 256 and the 32-row observation pass over a 4096-deep
   buffer; the h2o chunk with column masses, C = 256 at 3840 of 4096
   with n_total 4000, also in float32; kernel 3 at the window finalize
   (32 rows at 3968, n_prompt 4096) and at monolithic h2o (2048 rows at
   offset 0); paged decode of 4 slots, block size 16, 19 blocks; paged
   decode with row masses over 20 blocks (capacity 256 + interval 64),
   both timed with all slots live and with one live slot of four, each
   one launch on the grid (n_split, KV, B) that ``row_splits`` gives (read
   from the profiler's trace), and both at 1, 2, 4 and 8 forced splits
   and the rule's pick on the edges of ``PAGED_EDGES``;
   monolithic causal prefill of 4 x 2080 rows and its 32 observation
   rows; dense decode of 4 sequences over 289 rows with a per-kv-head
   mask, one launch on the grid (n_split, KV, B) that
   ``decode_attention.row_splits`` gives; kernel 3's bf16 main call two
   launches, of ``obs_row_stats_mma`` and ``obs_column_means_mma``, on the
   grids ``key_splits`` and ``column_tiles`` give) and on edge cases
   (lengths not a multiple of the tile, windows, non-causal attention,
   masked rows and heads, ragged tables with null blocks, GQA groups of 1
   and 8; kernels 1 and 2 at the edges of the Hopper tile,
   ``CHUNK_EDGES`` and ``MASSES_EDGES``, and kernel 1 also timed at the
   observation pass; kernel 3 at the edges of its tile: 17 and 40 rows, G
   5, a window ending inside a key tile, a ragged key tail, a key split
   under a tile, float32; kernel 6 under every mask kind with dead heads
   and sequences, 3 and 1 rows, G 1, 5, 8 and 16, hd 32 and 64 and
   float32, each at 1, 2, 4 and 8 forced splits and the rule's pick;
   every timed kernel printed beside its recorded time,
   ``RECORDED_MS``), within a tolerance that is a fixed
   fraction of the plain result's largest magnitude: per output row for
   attention and for the row masses, over the whole result for the
   scores.  Kernel 5's output must be bitwise kernel 4's, kernel 2's
   kernel 1's, and kernel 2's column masses must sum to the counted
   rows.  Kernels 3, 6 and 7 also at hymba-1.5b's attention shape (25 q /
   5 kv heads of 64, window 1024 on its local layers, none on its global
   ones; kernel 7 timed there too, against SDPA with ``is_causal`` and
   with an explicit window mask); kernel 7 at the edges of its 128-row,
   128-key tile (S of 1, 64, 127, 128, 129; windows of 1, 64, 100, 128,
   1024; GQA ratios 1 and 5; B = 3); the unmasked call at its main shape
   within 2.5% of its recorded time (``FLASH_UNMASKED_MS``).  Kernel 7
   under a key mask (the bucket-padded prefill: B 4 x S 1024, true
   lengths 512/700/900/1024; also with key 0 of a sequence masked and
   every key visible, in float32 and at hd 64, each timed beside the
   unmasked call at its shape and SDPA with the masks as one boolean
   mask, its bound over the valid visible pairs), and with the first
   200 keys of a sequence masked, hd 32, observation rows after the
   padding, lengths around a tile; every output finite.  Kernel 8 (the SSD scan: chunk
   states, state pass, chunk scan; bf16 on tensor cores) at hymba-1.5b's
   prefill (B 4 x S 2048, 50 heads of 64, d_state 16, chunk 128, bf16;
   a ragged last head block) and its 32-row lookahead segment carrying
   the prompt's state, at mamba2-130m's (24 heads, d_state 128), and on
   edge cases (13 heads in blocks of 4, S 4096 through the state pass,
   ragged S, S < chunk, S = 1, chunk 1, d_state 8, odd head counts,
   float32 inputs, initial states, chunks 16, 32 and 256, chunk 256 at
   d_state 128), each row of y and the final state within 2^-12 of the
   plain magnitude, three launches a call on the grids ``grids`` gives
   (the two timed shapes).
   Time kernel, plain version and, where one PyTorch call computes the
   same function, that call (library_ms), each call on a cold L2.
2. Serve through the port's engines on the llama3-8b smoke config in
   float32, once on the card and once on the CPU: the paged and the dense
   continuous engine (3 requests each), the lockstep engine (a batch of
   3), the paged engine with decode-time eviction (interval 8: sweeps
   fire), the paged engine with optimistic admission on a pool too small
   to grow every slot (preemptions happen), the dense engine with
   decode-time eviction, the paged engine under h2o, snapkv, pyramidkv,
   tova, streaming_llm, random (seeded requests) and lookaheadkv with
   adaptive head budgets, the dense engine under h2o, and the lockstep
   engine under h2o, snapkv, full, laq and speckv (draft model
   tiny-llama-smoke), and ``BucketedEngine`` under lookaheadkv, full and
   laq on prompts of 40, 50, 64 and 23 tokens (a padded group at bucket
   64); greedy tokens, admission and retirement kept sets, and the counts
   of sweeps, reclaimed blocks, preemptions and prefill groups must be
   identical, and the padded lookaheadkv tokens must equal each
   request's batch-1 lockstep run on the card.  Then the SSM archs: hymba-smoke's
   lockstep engine under lookaheadkv and h2o, and mamba2-smoke's prefill
   and 8 decode steps; greedy tokens identical, kernel 8 launched.
3. Serve llama3-8b at full width (random weights and lookahead modules
   from the seed; policy lookaheadkv unless named, budget 256) through
   ``repro_torch.launch.serve`` by each of its routes, with the launch
   counts set to 0 just before and read just after each (e runs just
   before a and f just before c, with no profiler phase between them):
   a. paged continuous: prompts of 1024, 2048, 3072 and 4000 tokens, chunk
      256, 4 slots, block size 16, --kv-pool-mb 256, 32 new tokens;
      kernels 1, 3, 4 must launch, kernel 5 not;
   b. lockstep: 4 prompts of 2048 tokens, 32 new; kernels 7 (exactly
      once per layer, 32), 3, 6 must launch;
   c. dense-slot continuous: the prompts of (a), chunk 256, 4 slots, 32
      new; kernels 1, 3, 6 must launch;
   d. paged decode-evict: (a) with --decode-evict --decode-evict-interval
      64 and 192 new tokens; kernels 1, 3, 5 must launch and kernel 4
      not, with >= 8 sweeps, blocks reclaimed mid-generation and
      requests overlapping (max concurrency >= 2);
   e. paged continuous h2o: (a) with --policy h2o; kernels 2 (once per
      layer of every prefill chunk) and 4 must launch, kernels 1, 3, 5
      not; prefill ms per chunk beside (a)'s;
   f. dense-slot continuous pyramidkv: (c) with --policy pyramidkv
      (capacity 342, per-layer budgets printed); kernels 1, 3, 6 must
      launch, kernel 2 not;
   g. hymba-1.5b lockstep (its only route): (b)'s shape; kernels 8, 7, 3
      and 6 must launch exactly 64, 32, 32 and 1,024 times (kernel 8 twice
      per layer: the prompt, then the lookahead rows), kernels 1, 2, 4, 5
      not;
   h. mamba2-130m through the model functions (no engine serves an
      attention-free arch): prefill(want_ssm_cache=True) of 4 x 2048
      tokens and 32 greedy decode steps; kernel 8 once per layer (24), no
      attention kernel;
   i. lockstep laq: (b) with --policy laq (draft_len 8): kernels 7, 3
      and 6 exactly 64, 64 and 1,280 times, run just after (b) and 4b;
   j. lockstep speckv through ``ServingEngine`` on (i)'s weights with
      tiny-llama (12 layers, d 768) as the draft model, prompt ids below
      its 32,000-token vocabulary: kernels 7, 3, 6 exactly 44, 32,
      1,120; then the TTFT of (b), (i) and (j) side by side with their
      ratios, host-clock sightings: of each first serve, and of a second
      serve on the same engine (4b's profiler-off batch for (b));
   k. bucketed continuous full: --continuous --policy full --slots 4
      --prompt-lens 512,700,900,1024 (BucketedEngine: 512 fills its
      bucket, the other three one group padded to 1024): two prefill
      groups, kernel 7 exactly 64 times (32 under the key mask) and
      kernel 6 992, no kernel 1, 2 or 3.
4. Where the time goes, with torch.profiler: (a) one more 2048-token
   request on the engine of 3a, then one decode chunk alone; (b) one
   more lockstep batch on the engine of 3b; (c) on the engine of 3d,
   one decode chunk with three live slots and one sweep, each alone,
   and the score update timed; (d) one more lockstep batch on the engine
   of 3g: device-busy share, launches (per decode step against 4a's, or
   per forward pass), and device time by kernel family (kernel 8's share
   in 4d).  The launch counters are set to 0 just before each profiled
   piece of work and read just after: every family of the port's kernels
   in the trace must hold the counted calls times the wrapper's CUDA
   launches per call (kernels 2 and 3 two, kernel 8 three, the others
   one; a merge of split keys apart); on a mismatch (a trace that lost
   events) the work is profiled again once, then the phase fails.

Output: per-phase lines, then a JSON line of per-kernel numbers, the
card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM rate and dense peak by operand type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SEED = 0

# Phase 1's edge cases of kernels 1 and 2 on the Hopper tile (bf16 at hd
# 64 and 128: 128-row query tiles of two 64-row warpgroups, 128-key tiles
# aligned to position 0): chunks of 1 row up to a tile + 1 and two tiles,
# offsets on and off the 128 grid (the causal diagonal inside a key tile),
# buffers shorter than a tile or with a ragged tail, windows that start
# inside a key tile, GQA ratios 1, 4, 5 and 8, B = 3, and key ranges split
# over CTAs (``key_splits``), one split with no key tile.
# (B, C, K, q_offset, window, label, (H, KV, hd))
CHUNK_EDGES = (
    (1, 1, 100, 0, None, "C=1 K=100 off=0", (8, 2, 128)),
    (1, 1, 4096, 4095, None, "C=1 at the last key of 4096", (8, 2, 64)),
    (1, 32, 1000, 100, None, "C=32 off=100 K=1000", (8, 2, 128)),
    (1, 64, 100, 0, None, "C=64 K=100 (under one key tile)", (8, 2, 64)),
    (1, 127, 1000, 100, None, "C=127 off=100 K=1000", (8, 2, 64)),
    (1, 128, 4096, 3840, None, "C=128 off=3840", (8, 2, 128)),
    (1, 129, 1000, 100, None, "C=129 off=100 K=1000", (8, 2, 128)),
    (1, 256, 1000, 100, None, "C=256 off=100 K=1000", (8, 2, 64)),
    (1, 256, 4096, 3840, 1, "window 1", (8, 2, 128)),
    (1, 256, 4096, 3840, 64, "window 64", (8, 2, 64)),
    (1, 256, 1000, 100, 100, "window 100 off=100", (8, 2, 128)),
    (1, 129, 1000, 100, 128, "window 128 off=100", (8, 2, 64)),
    (1, 256, 4096, 3840, 1024, "window 1024", (8, 2, 128)),
    (1, 100, 1000, 700, None, "GQA 1", (4, 4, 128)),
    (1, 100, 1000, 700, None, "GQA 5", (10, 2, 64)),
    (1, 100, 1000, 700, None, "GQA 8", (16, 2, 128)),
    (3, 129, 1000, 100, None, "B=3", (8, 2, 128)),
    (1, 1024, 1024, 0, None, "2 key splits, one empty", (8, 2, 64)),
)
# (B, C, K, q_offset, n_total, window, label, dtype, (H, KV, hd))
MASSES_EDGES = (
    (1, 256, 4096, 3840, 3900, None, "n_total mid key tile", "bfloat16",
     (8, 2, 128)),
    (1, 64, 300, 200, 150, None, "n_total <= q_offset: no row counts",
     "bfloat16", (8, 2, 64)),
    (1, 100, 1000, 700, 1000, None, "n_total past the chunk", "bfloat16",
     (8, 2, 128)),
    (1, 1, 100, 0, 1, None, "C=1 K=100", "bfloat16", (8, 2, 64)),
    (1, 129, 1000, 100, 229, None, "C=129 off=100", "bfloat16", (8, 2, 128)),
    (1, 256, 1000, 100, 300, 100, "window 100", "bfloat16", (8, 2, 64)),
    (1, 256, 4096, 3840, 4000, 1, "window 1", "bfloat16", (8, 2, 128)),
    (1, 256, 4096, 3840, 4000, 1024, "window 1024", "bfloat16", (8, 2, 128)),
    (1, 100, 1000, 700, 790, None, "GQA 5", "bfloat16", (10, 2, 64)),
    (3, 129, 1000, 100, 200, None, "B=3", "bfloat16", (8, 2, 128)),
    (1, 129, 1000, 100, 200, 100, "float32 window 100", "float32",
     (8, 2, 64)),
    (1, 1024, 1024, 0, 1000, None, "a key split left empty", "bfloat16",
     (8, 2, 128)),
)

# Phase 1's edge cases of kernels 4 and 5 (``csrc/decode_split.cuh``: each
# (sequence, kv head)'s rows split over the CTAs of one cluster), each run
# at 1, 2, 4 and 8 forced splits and at ``row_splits``' pick, 4 slots over
# a pool of 129 blocks: layouts "ragged" (a null tail, a gap, a slot
# between requests, a fully masked kv head), "one live" (three null
# tables), "dead split" (blocks 10-19 null in one slot and 0-9 masked in
# another: whole ranks see no live row); fewer blocks than splits; G of
# 1, 4, 8 and 16; hd 32, 64 and 128; a window; a block size of 7; float32.
# (label, (H, KV, hd), bs, nb, window, layout, dtype)
PAGED_EDGES = (
    ("ragged, gap, null slot, masked head", (32, 8, 128), 16, 20, None,
     "ragged", "bfloat16"),
    ("window 96", (32, 8, 128), 16, 20, 96, "ragged", "bfloat16"),
    ("one live slot of four", (32, 8, 128), 16, 20, None, "one live",
     "bfloat16"),
    ("a split's blocks all null or masked", (32, 8, 128), 16, 20, None,
     "dead split", "bfloat16"),
    ("nb 3: fewer blocks than splits", (32, 8, 128), 16, 3, None, "ragged",
     "bfloat16"),
    ("G=1 (H=8) hd 64", (8, 8, 64), 16, 20, None, "ragged", "bfloat16"),
    ("G=8 (H=64)", (64, 8, 128), 16, 20, None, "ragged", "bfloat16"),
    ("G=16 (32 / 2 heads of 64)", (32, 2, 64), 16, 20, 96, "ragged",
     "bfloat16"),
    ("hd 32", (32, 8, 32), 16, 20, 96, "ragged", "bfloat16"),
    ("block size 7", (32, 8, 128), 7, 20, None, "ragged", "bfloat16"),
    ("float32", (32, 8, 128), 16, 20, 96, "ragged", "float32"),
)
#: split counts forced on kernels 4, 5 and 6 in phase 1 (None: the rule's)
PAGED_SPLITS = (None, 1, 2, 4, 8)
#: kernel 7's time at its main shape (B 4 x S 2080, 32/8 heads of 128,
#: causal, bf16) before the key mask (PERF.md, PR 17; NVIDIA H100 80GB
#: HBM3, 700 W): an unmasked call must stay within 2.5% of it
FLASH_UNMASKED_MS = 0.3455
#: phase-1 times recorded in PERF.md (ms; NVIDIA H100 80GB HBM3, 700 W),
#: printed beside this run's: kernels 6 and 3 on their earlier designs
#: (kernel 6's tile routine, kernel 3's scalar-FMA kernels) and kernel 8
#: on its first (one CTA per (head, sequence), float32 FMA), the others
#: as the last full run before them read them
RECORDED_MS = {
    "chunk_attention": 0.0449, "chunk_attention obs pass": 0.0238,
    "chunk_attention_masses": 0.0818,
    "lookahead_score": 0.1971, "lookahead_score window finalize": 0.1971,
    "lookahead_score monolithic h2o": 4.1156,
    "lookahead_score hymba local": 0.1280,
    "paged_decode_attention": 0.0147,
    "paged_decode_attention one live": 0.0133,
    "paged_decode_masses": 0.0166, "paged_decode_masses one live": 0.0152,
    "flash_attention": 0.3514, "flash_attention hymba local": 0.1883,
    "flash_attention hymba global": 0.2297,
    "decode_attention": 0.0328, "decode_attention hymba local": 0.0208,
    "ssd_scan": 0.6453, "ssd_scan mamba2": 1.2862,
}


def versus(key: str, ms: float) -> str:
    """This run's time beside the recorded one."""
    rec = RECORDED_MS[key]
    return f"{ms:.4f} ms (recorded {rec:.4f}, {ms / rec - 1:+.1%})"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, each call on a cold L2: before
    every timed call a 256 MiB buffer (five times the H100's 50 MB L2) is
    written, as a serving layer finds its K/V evicted by the weights read
    in between.  CUDA events bracket the call alone, and a spin of ~5 ms
    on the card before each call keeps the host's enqueue of the call (its
    argument checks, allocation and launches) out of the bracket."""
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in ev:
        scrub.zero_()
        torch.cuda._sleep(10_000_000)  # clock cycles: ~5 ms at 1.98 GHz
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in ev) / iters


def bound_ms(n_bytes: float, n_ops: float, dtype: str) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tolerance(want, rel: float) -> float:
    """Absolute tolerance ``rel`` times the largest magnitude of the plain
    version's result (the lookahead scores, float32 throughout)."""
    return rel * float(want.float().abs().max())


def check_rows(torch, got, want, rel: float, label: str) -> float:
    """Hold an attention output row by row: each output row (the last axis,
    one query row of one head) must lie within ``rel`` times that row's own
    largest plain magnitude.  Outputs of random inputs shrink as
    1/sqrt(visible keys), so in causal attention a row that sees one key
    is ~30x a row that sees a thousand, and a tolerance taken from the
    whole tensor would let a wrong deep row through.  Prints the largest
    error and the worst row (its index and its error over its tolerance);
    returns the largest error."""
    err = (got.float() - want.float()).abs().amax(-1)
    tol = rel * want.float().abs().amax(-1)
    # an exactly-zero plain row (a dead head) must come out exactly zero
    ratio = torch.where(err == 0, torch.zeros_like(err), err / tol)
    worst = int(ratio.argmax())
    where = tuple(int(i) for i in torch.unravel_index(
        torch.tensor(worst), ratio.shape))
    r = float(ratio.flatten()[worst])
    print(f"  {label}: max_abs_err {float(err.max()):.3e} (max|plain| "
          f"{float(want.float().abs().max()):.3e}); worst row {where} "
          f"at {r:.3f} x its tolerance (2^{round(math.log2(rel))} x the "
          "row's max|plain|)")
    check(r <= 1.0, f"{label}: row {where} is {r:.3f} x its tolerance")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(torch, mods) -> list:
    import torch.nn.functional as F

    ck, lk, pk, fk, dk, sk, ref = (mods[n] for n in ("ck", "lk", "pk", "fk",
                                                     "dk", "sk", "ref"))
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)
    # tolerances relative to the largest magnitude of the plain result,
    # per output row for attention (check_rows): chunk attention feeds its
    # tensor cores P rounded to bf16 (2^-9 relative per term) and rounds
    # the output once: 4 bf16 ulps (2^-5); so does monolithic flash
    # attention, the same tensor-core path; paged and dense decode
    # accumulate in float32 on CUDA cores and round the output once: 1 ulp
    # (2^-7); lookahead scores, over the whole result, are float32
    # throughout (float32 eps 2^-23, logits of a few units through exp):
    # 2^-16
    REL_CHUNK, REL_PAGED, REL_SCORE = 2 ** -5, 2 ** -7, 2 ** -16
    H, KV, hd = 32, 8, 128
    HYMBA_HEADS = (25, 5, 64)  # hymba-1.5b's attention: q heads, kv, hd
    G = H // KV
    itemsize = 2

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    results = []

    # -- kernel 1: chunk attention ------------------------------------------
    # bf16 at hd 64 and 128 runs the wgmma + TMA tile (attention_sm90.cuh)
    # at a general q_offset: 128-row query tiles, 128-key tiles aligned to
    # position 0, the causal diagonal at q_offset + row
    def chunk_case(B, C, K, off, window, label, timed=None,
                   heads=(H, KV, hd)):
        Hs, KVs, hds = heads
        q, k, v = (randn(B, C, Hs, hds), randn(B, K, KVs, hds),
                   randn(B, K, KVs, hds))
        got = ck.chunk_attention(q, k, v, q_offset=off, window=window)
        torch.cuda.synchronize()
        want = ref.chunk_attention(q, k, v, q_offset=off, window=window)
        err = check_rows(torch, got, want, REL_CHUNK,
                         f"chunk_attention {label}")
        if not timed:
            return None
        ms = time_ms(torch, lambda: ck.chunk_attention(
            q, k, v, q_offset=off, window=window))
        plain = time_ms(torch, lambda: ref.chunk_attention(
            q, k, v, q_offset=off, window=window), iters=5)
        # one library call computing the same function: SDPA with an
        # explicit mask (kv heads expanded and the mask built outside)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(Hs // KVs, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(Hs // KVs, dim=2).transpose(1, 2)
        qpos = off + torch.arange(C, device=dev)
        kpos = torch.arange(K, device=dev)
        mask = kpos[None, :] <= qpos[:, None]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        vis = torch.clamp(qpos + 1, max=K).sum().item()
        n_ops = 4 * hds * Hs * B * vis
        n_bytes = itemsize * (2 * B * C * Hs * hds
                              + 2 * B * min(K, off + C) * KVs * hds)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        splits = ck.key_splits(
            B, C, Hs, K, hds, q.dtype, q_offset=off, window=window,
            sms=torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"  chunk_attention {label}: {versus(timed, ms)}, plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); {splits} key split(s)")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)

    main1 = chunk_case(1, 256, 4096, 3840, None, "C=256 K=4096 off=3840",
                       timed="chunk_attention")
    chunk_case(1, 32, 4096, 4000, None, "obs pass C=32 off=4000",
               timed="chunk_attention obs pass")
    chunk_case(1, 256, 1000, 700, None, "K=1000 (ragged tile)")
    chunk_case(2, 64, 700, 500, 128, "window 128")
    for args in CHUNK_EDGES:
        chunk_case(*args[:5], "edge " + args[5], heads=args[6])
    results.append(dict(
        name="chunk_attention", route="cuda",
        source="src/repro_torch/csrc/attention_sm90.cuh",
        replaces="src/repro/kernels/chunk_attention.py:95", **main1))

    # -- kernel 2: chunk attention with column masses (h2o) -------------------
    def masses_chunk_case(B, C, K, off, n_total, window, label, *, Hq=H,
                          dtype=bf16, timed=False, kv_hd=(KV, hd)):
        """Kernel 2 against kernel 1 and its plain version: ``out`` bitwise
        kernel 1's on the same inputs; each (b, h) row of masses within
        2^-16 of that row's largest plain mass (both sides take float32
        logits and exponentials, a few float32 ulps apart, and sum them
        over rows in other orders); exact zeros where the plain masses
        are; every row summing to the number of counted rows within
        1e-4 of it."""
        KVs, hds = kv_hd
        mk = (lambda *shape: torch.randn(shape, generator=g,
                                         device=dev).to(dtype))
        q, k, v = mk(B, C, Hq, hds), mk(B, K, KVs, hds), mk(B, K, KVs, hds)
        kw = dict(q_offset=off, window=window)
        got, m_got = ck.chunk_attention_masses(q, k, v, n_total=n_total,
                                               **kw)
        plain1 = ck.chunk_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, plain1), f"chunk_attention_masses {label}: "
              "out is not bitwise kernel 1's")
        rv = (off + torch.arange(C, device=dev) < n_total).expand(B, C)
        m_want = ref.chunk_column_masses(q, k, row_valid=rv, **kw)
        err = check_rows(torch, m_got, m_want, REL_SCORE,
                         f"chunk_attention_masses {label} masses")
        check(bool(torch.all(m_got[m_want == 0] == 0)),
              f"chunk_attention_masses {label}: an unseen key has mass")
        n_rows = float(rv[0].sum())
        dev_sum = float((m_got.sum(-1) - n_rows).abs().max())
        print(f"  chunk_attention_masses {label}: out bitwise kernel 1's; "
              f"{int(n_rows)} counted rows, largest |row sum - rows| "
              f"{dev_sum:.2e} (tolerance {1e-4 * n_rows:.2e})")
        check(dev_sum <= 1e-4 * n_rows, f"chunk_attention_masses {label}: "
              "a row of masses does not sum to the counted rows")
        if not timed:
            return None
        ms = time_ms(torch, lambda: ck.chunk_attention_masses(
            q, k, v, n_total=n_total, **kw))
        plain = time_ms(torch, lambda: (
            ref.chunk_attention(q, k, v, **kw),
            ref.chunk_column_masses(q, k, row_valid=rv, **kw)), iters=5)
        # the out half only: no library call returns the column masses
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(Hq // KVs, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(Hq // KVs, dim=2).transpose(1, 2)
        qpos = off + torch.arange(C, device=dev)
        mask = torch.arange(K, device=dev)[None, :] <= qpos[:, None]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        vis = torch.clamp(qpos + 1, max=K).sum().item()
        n_ops = 4 * hds * Hq * B * vis  # Q.K^T and P.V once each
        n_bytes = (itemsize * (2 * B * C * Hq * hds
                               + 2 * B * min(K, off + C) * KVs * hds)
                   + 4 * B * Hq * K)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        print(f"  chunk_attention_masses {label}: "
              f"{versus('chunk_attention_masses', ms)}, plain {plain:.4f} "
              f"ms, sdpa (out half) {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)

    main2 = masses_chunk_case(1, 256, 4096, 3840, 4000, None,
                              "C=256 K=4096 off=3840 n_total=4000",
                              timed=True)
    masses_chunk_case(1, 256, 4096, 0, 4000, None, "first chunk off=0")
    masses_chunk_case(2, 100, 1000, 700, 790, None, "K=1000 (ragged tile)")
    masses_chunk_case(1, 256, 1000, 500, 1000, 96, "window 96")
    masses_chunk_case(1, 64, 300, 200, 260, None, "G=1 (H=8)", Hq=8)
    masses_chunk_case(1, 64, 300, 200, 264, None, "G=8 (H=64)", Hq=64)
    masses_chunk_case(1, 256, 1000, 700, 900, None, "float32",
                      dtype=torch.float32)
    for args in MASSES_EDGES:
        (Hs, KVs, hds) = args[8]
        masses_chunk_case(*args[:6], "edge " + args[6],
                          dtype=getattr(torch, args[7]), Hq=Hs,
                          kv_hd=(KVs, hds))
    results.append(dict(
        name="chunk_attention_masses", route="cuda",
        source="src/repro_torch/csrc/attention_sm90.cuh",
        replaces="src/repro/kernels/chunk_attention.py:216", **main2))

    # -- launches read from the profiler's trace -----------------------------
    def traced_launches(fn):
        """[(name, grid or None)] of the work ``fn`` puts on the card, in
        order, from the profiler's trace: kernel launches, and copies and
        memsets (no grid), so a wrapper that adds either fails the check."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        trace = mods["build"].BUILD_DIR / "launch_trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        trace.unlink()
        # device work that began before this profile's first CPU op is an
        # earlier profile's, which the profiler can deliver late
        t0 = min((ev["ts"] for ev in events if ev.get("cat") == "cpu_op"),
                 default=None)
        return [(ev.get("name", ""), ev.get("args", {}).get("grid"))
                for ev in events
                if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                and (t0 is None or ev.get("ts", t0) >= t0)]

    def check_launches(fn, parts, grids):
        """``fn`` makes exactly one CUDA launch of a kernel named
        ``parts[i]`` on the grid ``grids[i]`` for each i, in order (the
        grids where the trace records them).  A trace with other launches
        is taken again, up to three times in all, before the phase fails:
        the profiler has given a kernel-8 call an empty trace, its events
        delivered in the next profile."""
        for attempt in (1, 2, 3):
            got = traced_launches(fn)
            names = [n for n, _ in got]
            if len(got) == len(parts) and all(p in n for p, n in
                                              zip(parts, names)):
                break
            print(f"  one call launched {names}, expected {list(parts)}"
                  + ("; tracing it again" if attempt < 3 else ""))
            torch.cuda.synchronize()
            time.sleep(0.5)
        check(len(got) == len(parts)
              and all(p in n for p, n in zip(parts, names)),
              f"one call launched {names}, expected {list(parts)}")
        for (name, grid), part, want in zip(got, parts, grids):
            if grid is None:
                print(f"  {part}: one launch (the trace records no grid; "
                      f"expected {tuple(want)})")
                continue
            check(list(grid) == list(want), f"{part}: grid {grid}, "
                  f"expected {want}")
            print(f"  {part}: one launch, grid {tuple(grid)}")

    sms = mods["build"].sm_count(dev)

    # -- kernel 3: lookahead scores ------------------------------------------
    # bf16 runs the tensor-core kernels (each kv head's G query heads
    # packed, 16-row fragments, 8 to a row block; 64-key tiles), float32
    # the FMA kernels
    def score_case(B, n_obs, Sk, n_prompt, off, window, masks, label,
                   timed=None, timed_kernel=None, heads=(H, KV, hd),
                   dtype=bf16):
        Hs, KVs, hds = heads
        q = torch.randn((B, n_obs, Hs, hds), generator=g, device=dev).to(dtype)
        k = torch.randn((B, Sk, KVs, hds), generator=g, device=dev).to(dtype)
        kvm = rv = None
        if masks:
            kvm = torch.rand((B, n_prompt), generator=g, device=dev) > 0.2
            rv = torch.rand((B, n_obs), generator=g, device=dev) > 0.3
            rv[-1] = False  # every row invalid: exact-zero scores
        kw = dict(kv_mask=kvm, window=window, q_offset=off, row_valid=rv)
        got = lk.lookahead_score(q, k, n_prompt, **kw)
        torch.cuda.synchronize()
        want = ref.lookahead_score(q, k, n_prompt, **kw)
        err, tol = max_err(got, want), tolerance(want, REL_SCORE)
        n_split = lk.key_splits(B, n_obs, Hs, KVs, min(
            Sk, (n_prompt if off is None else off) + n_obs), sms)
        print(f"  lookahead_score {label}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e} = 2^-16 max|plain|); {n_split} key "
              "split(s)")
        check(err <= tol, f"lookahead_score {label}: err {err} > {tol}")
        if masks:
            check(bool(torch.all(got[-1] == 0)),
                  "lookahead_score: invalid rows must give exact zeros")
        call = lambda: lk.lookahead_score(q, k, n_prompt, **kw)
        if timed_kernel:
            ms = time_ms(torch, call, iters=5)
            print(f"  lookahead_score {label}: {versus(timed_kernel, ms)}")
        if not timed:
            return None
        # one count, two launches: the tensor-core kernels on their grids
        n_rb = lk.row_blocks(n_obs, Hs // KVs)
        t_per = lk.column_tiles(B, n_obs, Hs, KVs, hds, n_prompt, n_split,
                                sms)
        check_launches(call, ("obs_row_stats_mma", "obs_column_means_mma"),
                       ((n_split * n_rb, KVs, B),
                        (-(-n_prompt // (64 * t_per)), KVs, B)))
        ms = time_ms(torch, call)
        plain = time_ms(torch, lambda: ref.lookahead_score(q, k, n_prompt,
                                                           **kw), iters=5)
        vis_keys = min(Sk, off + n_obs)
        n_ops = 2 * hds * Hs * B * sum(min(Sk, off + i + 1)
                                       for i in range(n_obs))
        n_bytes = (itemsize * (B * n_obs * Hs * hds
                               + B * vis_keys * KVs * hds)
                   + 4 * B * Hs * n_prompt)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        print(f"  lookahead_score {label}: {versus(timed, ms)}, plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    main3 = score_case(1, 32, 4096, 4096, 4000, None, False,
                       "n_obs=32 Sk=4096 off=4000", timed="lookahead_score")
    # the lockstep prefill's call: 32 observation rows after 2048 prompt
    # rows of each of 4 sequences, scored on the prompt (q_offset None)
    score_case(4, 32, 2080, 2048, None, None, False,
               "lockstep: B=4 Sk=2080 n_prompt=2048")
    score_case(2, 32, 1000, 968, None, None, True,
               "kv_mask+row_valid Sk=1000")
    # the window policies' finalize: the rolled 32 queries at n_total - 32
    # over the whole 4096-deep buffer (n_prompt = K)
    score_case(1, 32, 4096, 4096, 4000 - 32, None, False,
               "window finalize: 32 rows at 3968, n_prompt=K=4096",
               timed_kernel="lookahead_score window finalize")
    # monolithic h2o: every prompt row at q_offset 0, causal among itself
    score_case(1, 2048, 2048, 2048, 0, None, False,
               "monolithic h2o: 2048 rows at offset 0",
               timed_kernel="lookahead_score monolithic h2o")
    score_case(2, 40, 700, 700, 640, 96, True, "window 96, 2 row tiles")
    # hymba-1.5b's lockstep scoring (25 q / 5 kv heads of 64): 32 lookahead
    # rows after 2048 prompt rows, window 1024 on its local layers
    score_case(4, 32, 2080, 2048, None, 1024, False,
               "hymba local layer: B=4 Sk=2080 window 1024",
               timed_kernel="lookahead_score hymba local", heads=HYMBA_HEADS)
    score_case(4, 32, 2080, 2048, None, None, False,
               "hymba global layer: B=4 Sk=2080", heads=HYMBA_HEADS)
    # the tile's edges: rows padded to 16 (n_obs 17, 40), G 5 at hd 64, a
    # window ending inside a key tile, a ragged key tail, a last key split
    # shorter than a tile, every row of a sequence invalid, float32
    score_case(1, 17, 500, 483, None, None, False, "n_obs 17",
               heads=(8, 2, 128))
    score_case(1, 40, 1000, 1000, 960, None, False, "n_obs 40")
    score_case(2, 17, 300, 300, 283, None, True, "G 5 hd 64, masks",
               heads=(10, 2, 64))
    score_case(1, 32, 1000, 1000, 900, 100, False, "window 100 mid-tile",
               heads=(8, 2, 128))
    score_case(1, 32, 1000, 968, None, None, False, "Sk 1000",
               heads=(8, 2, 64))
    score_case(1, 32, 4096, 4096, 3850, None, False,
               "last key split under a tile")
    score_case(2, 32, 1000, 968, None, 200, True, "float32, masks, window",
               dtype=torch.float32)
    results.append(dict(
        name="lookahead_score", route="cuda",
        source="src/repro_torch/csrc/lookahead_score.cu",
        replaces="src/repro/kernels/lookahead_score.py:87", **main3))

    # -- kernels 4 and 5: paged decode, rows split over a cluster -----------
    @contextlib.contextmanager
    def forced_splits(n, mod=pk):
        """Kernels 4 and 5 (``mod`` pk) or 6 (dk) at ``n`` CTAs per
        (sequence, kv head) (None: ``row_splits``' pick), as the card tests
        force them."""
        rule = mod.row_splits
        if n is not None:
            mod.row_splits = lambda *a, **kw: n
        try:
            yield
        finally:
            mod.row_splits = rule

    def splits_label(n, B, KV, nb, bs):
        if n is not None:
            return f"{n} splits"
        return (f"row_splits' {pk.row_splits(B, KV, nb, bs, sms)} "
                "splits")


    def paged_case(label, window, timed=False, edge=False, one_live=False,
                   splits=None):
        B, bs, nb, N = 4, 16, 19, 129
        q = randn(B, H, hd)
        kp, vp = randn(N, bs, KV, hd), randn(N, bs, KV, hd)
        pos = torch.randint(0, 4100, (N, bs, KV), generator=g, device=dev,
                            dtype=torch.int32)
        mask = torch.rand((N, bs, KV), generator=g, device=dev) > 0.1
        mask[0] = False  # the null block
        # main-path tables: 16 kept-row blocks, then the append blocks the
        # decode has grown so far, null beyond
        perm = torch.randperm(N - 1, generator=g, device=dev) + 1
        table = perm[:B * nb].reshape(B, nb).to(torch.int32)
        table[:, 18] = 0
        if edge:
            table[1, 9:] = 0  # ragged with null blocks
            table[2] = 0  # a slot between requests: exact zeros
            mask[table[3].long(), :, 5] = False  # kv head 5 fully masked
        if one_live:
            table[1:] = 0  # three slots between requests
        new_pos = torch.full((B,), 4032, dtype=torch.int32, device=dev)
        kw = dict(pos_pool=pos, new_pos=new_pos, window=window)
        label = f"{label}, {splits_label(splits, B, KV, nb, bs)}"
        with forced_splits(splits):
            got = pk.paged_decode_attention(q, kp, vp, mask, table, **kw)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention(q, kp, vp, mask, table, **kw)
        err = check_rows(torch, got, want, REL_PAGED,
                         f"paged_decode_attention {label}")
        if edge:
            check(bool(torch.all(got[2] == 0)),
                  "paged decode: an all-null table must give exact zeros")
            check(bool(torch.all(got[3, 5 * G:6 * G] == 0)),
                  "paged decode: a fully masked head must give exact zeros")
        if one_live:
            check(bool(torch.all(got[1:] == 0)),
                  "paged decode: null tables must give exact zeros")
        if not timed:
            return None
        call = lambda: pk.paged_decode_attention(q, kp, vp, mask, table,
                                                 **kw)
        if not one_live:
            check_launches(call, ("paged_decode",), ((pk.row_splits(
                B, KV, nb, bs, sms), KV, B),))
        ms = time_ms(torch, call, iters=50)
        plain = time_ms(torch, lambda: ref.paged_decode_attention(
            q, kp, vp, mask, table, **kw), iters=10)
        # library yardstick: SDPA on the gathered dense view (the gather is
        # outside the timed call)
        S = nb * bs
        kd = ref.gather_paged(kp, table).repeat_interleave(G, 2).transpose(1, 2)
        vd = ref.gather_paged(vp, table).repeat_interleave(G, 2).transpose(1, 2)
        md = ref.gather_paged(mask, table).repeat_interleave(G, 2)
        md = md.permute(0, 2, 1)[:, :, None, :]  # (B, H, 1, S)
        qd = q[:, :, None, :]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=md), iters=50)
        rows_valid = int(ref.gather_paged(mask, table).sum())  # (row, kv head)
        n_ops = 4 * hd * G * rows_valid
        n_bytes = (itemsize * (2 * rows_valid * hd + 2 * B * H * hd)
                   + B * S * KV + 4 * B * nb)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        key = "paged_decode_attention" + (" one live" if one_live else "")
        print(f"  paged_decode_attention {label}: {versus(key, ms)}, "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}, {rows_valid} valid rows of {B * S * KV})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)

    main4 = paged_case("B=4 bs=16 nb=19", None, timed=True)
    paged_case("B=4 bs=16 nb=19, one live slot", None, timed=True,
               one_live=True)
    for n in PAGED_SPLITS:
        paged_case("ragged, null slot, masked head", None, edge=True,
                   splits=n)
        paged_case("window 64", 64, edge=True, splits=n)
    results.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:101", **main4))

    def masses_case(label, *, heads=(H, KV, hd), bs=16, nb=20, window=None,
                    layout=None, dtype="bfloat16", splits=None, timed=False):
        """Kernels 5 and 4 on one input at the decode-eviction route's
        shape (4 slots, a window of capacity 256 + interval 64 = 20 blocks
        of 16) or an edge of ``PAGED_EDGES``: kernel 5's ``out`` must be
        bitwise kernel 4's at the same split; out within 2^-7 per row of
        the plain version, exact zeros on a (sequence, head) with no live
        row; each (b, h) row of masses within 2^-16 of that row's largest
        plain mass (both sides take float32 dot products over hd and
        exponentials of logits of a few units, so they differ by a few
        float32 ulps, ~1e-6 relative, per entry); exact zeros on dead
        rows; live rows sum to 1 within 1e-4."""
        Hq, KVq, hdq = heads
        B, N = 4, 129
        dt = getattr(torch, dtype)
        q, kp, vp = (torch.randn(shape, generator=g, device=dev).to(dt)
                     for shape in ((B, Hq, hdq), (N, bs, KVq, hdq),
                                   (N, bs, KVq, hdq)))
        pos = torch.randint(0, 4300, (N, bs, KVq), generator=g, device=dev,
                            dtype=torch.int32)
        mask = torch.rand((N, bs, KVq), generator=g, device=dev) > 0.05
        mask[0] = False  # the null block
        perm = torch.randperm(N - 1, generator=g, device=dev) + 1
        table = perm[:B * nb].reshape(B, nb).to(torch.int32)
        if layout == "ragged":
            table[1, 7:] = 0  # ragged with null blocks
            table[0, min(3, nb - 1)] = 0  # a gap
            table[2] = 0  # a slot between requests: all zero
            mask[table[3].long(), :, min(5, KVq - 1)] = False  # a dead head
        elif layout == "one live":
            table[1:] = 0
        elif layout == "dead split":
            table[0, 10:] = 0
            mask[table[1, :10].long()] = False
        new_pos = torch.full((B,), 4200, dtype=torch.int32, device=dev)
        kw = dict(pos_pool=pos, new_pos=new_pos, window=window)
        label = f"{label}, {splits_label(splits, B, KVq, nb, bs)}"
        with forced_splits(splits):
            got, m_got = pk.paged_decode_masses(q, kp, vp, mask, table, **kw)
            plain4 = pk.paged_decode_attention(q, kp, vp, mask, table, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, plain4), f"paged_decode_masses {label}: out "
              "is not bitwise kernel 4's")
        want = ref.paged_decode_attention(q, kp, vp, mask, table, **kw)
        check_rows(torch, got, want, REL_PAGED,
                   f"paged_decode_masses {label} out")
        m_want = ref.paged_decode_masses(q, kp, mask, table, **kw)
        err = check_rows(torch, m_got, m_want, REL_SCORE,
                         f"paged_decode_masses {label} masses")
        Gq = Hq // KVq
        dead = torch.repeat_interleave(
            ~ref.gather_paged(mask, table).transpose(1, 2), Gq, dim=1)
        if window is not None:
            far = (new_pos[:, None, None]
                   - ref.gather_paged(pos, table)) >= window
            dead |= torch.repeat_interleave(far.transpose(1, 2), Gq, dim=1)
        check(bool(torch.all(m_got[dead] == 0)),
              f"paged_decode_masses {label}: a dead row has mass")
        sums = m_got.sum(-1)
        alive = ~dead.all(-1)
        check(bool(torch.all((sums[alive] - 1).abs() <= 1e-4))
              and bool(torch.all(sums[~alive] == 0)),
              f"paged_decode_masses {label}: live rows must sum to 1, "
              "dead (sequence, head)s to 0")
        check(bool(torch.all(got[~alive] == 0)), f"paged_decode_masses "
              f"{label}: a (sequence, head) with no live row must give "
              "exact zeros")
        print(f"  paged_decode_masses {label}: out bitwise kernel 4's; "
              f"{int(alive.sum())} live and {int((~alive).sum())} empty "
              f"(sequence, head)s; largest |sum - 1| "
              f"{float((sums[alive] - 1).abs().max()):.2e}")
        if not timed:
            return None
        call = lambda: pk.paged_decode_masses(q, kp, vp, mask, table, **kw)
        if layout is None:
            check_launches(call, ("paged_masses",), ((pk.row_splits(
                B, KVq, nb, bs, sms), KVq, B),))
        ms = time_ms(torch, call, iters=50)
        plain = time_ms(torch, lambda: (
            ref.paged_decode_attention(q, kp, vp, mask, table, **kw),
            ref.paged_decode_masses(q, kp, mask, table, **kw)), iters=10)
        S = nb * bs
        rows_valid = int(ref.gather_paged(mask, table).sum())
        n_ops = 4 * hdq * Gq * rows_valid
        n_bytes = (itemsize * (2 * rows_valid * hdq + 2 * B * Hq * hdq)
                   + B * S * KVq + 4 * B * nb + 4 * B * Hq * S)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        key = "paged_decode_masses" + (" one live" if layout else "")
        print(f"  paged_decode_masses {label}: {versus(key, ms)}, plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {rows_valid} "
              f"valid rows of {B * S * KVq}); no single library call "
              "returns the row masses")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    main5 = masses_case("B=4 bs=16 nb=20", timed=True)
    masses_case("B=4 bs=16 nb=20, one live slot", layout="one live",
                timed=True)
    for label, heads, bs, nb, window, layout, dtype in PAGED_EDGES:
        for n in PAGED_SPLITS:
            masses_case(label, heads=heads, bs=bs, nb=nb, window=window,
                        layout=layout, dtype=dtype, splits=n)
    results.append(dict(
        name="paged_decode_masses", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:266", **main5))

    # -- kernel 7: monolithic flash attention ---------------------------------
    # bf16 at hd 64 and 128 runs the wgmma + TMA tile (attention_sm90.cuh):
    # its edges are 128-row query tiles of two 64-row warpgroups and
    # 128-key K/V tiles
    def flash_case(B, S, causal, window, label, timed=None,
                   heads=(H, KV, hd)):
        Hs, KVs, hds = heads
        q, k, v = (randn(B, S, Hs, hds), randn(B, S, KVs, hds),
                   randn(B, S, KVs, hds))
        kw = dict(causal=causal, window=window)
        got = fk.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, **kw)
        err = check_rows(torch, got, want, REL_CHUNK,
                         f"flash_attention {label}")
        if not timed:
            return None
        ms = time_ms(torch, lambda: fk.flash_attention(q, k, v, **kw))
        # the best of three timings, for the check against the recorded time
        best = min([ms] + [time_ms(torch, lambda: fk.flash_attention(
            q, k, v, **kw)) for _ in range(2)])
        plain = time_ms(torch, lambda: ref.flash_attention(q, k, v, **kw),
                        iters=3)
        # one library call computing the same function: SDPA on kv heads
        # expanded outside the timed call, causal by is_causal, a window by
        # an explicit boolean mask built outside
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(Hs // KVs, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(Hs // KVs, dim=2).transpose(1, 2)
        pos = torch.arange(S, device=dev)
        d = pos[:, None] - pos[None, :]  # query position - key position
        vis = torch.ones_like(d, dtype=torch.bool)
        if causal:
            vis &= d >= 0
        if window:
            vis &= d < window
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=vis))
        else:
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
        n_ops = 4 * hds * Hs * B * int(vis.sum())  # visible (row, key) pairs
        n_bytes = itemsize * (2 * B * S * Hs * hds + 2 * B * S * KVs * hds)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        print(f"  flash_attention {label}: {versus(timed, ms)}, plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib, best_ms=best)

    main7 = flash_case(4, 2080, True, None, "B=4 S=2080 causal",
                       timed="flash_attention")
    flash_case(1, 1000, True, None, "S=1000 (ragged tile)")
    flash_case(2, 300, False, None, "S=300 non-causal")
    flash_case(1, 700, True, 128, "S=700 window 128")
    flash_case(4, 2080, True, 1024, "hymba local layer: B=4 S=2080 window "
               "1024", timed="flash_attention hymba local",
               heads=HYMBA_HEADS)
    flash_case(4, 2080, True, None, "hymba global layer: B=4 S=2080",
               timed="flash_attention hymba global", heads=HYMBA_HEADS)
    # the tile's edges: rows (1, one warpgroup, a tile -1/0/+1), windows
    # inside and across key tiles, GQA ratios 1 and 5, B = 3
    small = (8, 2, hd)
    for S in (1, 64, 127, 128, 129):
        flash_case(1, S, True, None, f"S={S}", heads=small)
    flash_case(1, 129, True, None, "S=129 hd 64", heads=(8, 2, 64))
    for w in (1, 64, 100, 128):
        flash_case(1, 700, True, w, f"S=700 window {w} hd 64",
                   heads=(8, 2, 64))
    flash_case(1, 700, True, 100, "S=700 window 100", heads=small)
    flash_case(2, 1500, True, 1024, "S=1500 window 1024", heads=small)
    flash_case(1, 300, True, None, "GQA 1", heads=(4, 4, hd))
    flash_case(1, 333, True, None, "GQA 5 hd 64", heads=(10, 2, 64))
    flash_case(1, 333, False, 100, "non-causal window 100 hd 64",
               heads=(8, 2, 64))
    flash_case(3, 260, True, None, "B=3", heads=small)
    results.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/attention_sm90.cuh",
        replaces="src/repro/kernels/flash_attention.py:71", **main7))
    # an unmasked call runs the code it ran before the key mask came: the
    # best of three timings (each the mean of 20 calls) within 2.5%
    print(f"  flash_attention unmasked: best of three {main7['best_ms']:.4f} "
          f"ms against {FLASH_UNMASKED_MS} ms recorded "
          f"({main7['best_ms'] / FLASH_UNMASKED_MS - 1:+.1%}; limit +2.5%)")
    check(main7["best_ms"] <= FLASH_UNMASKED_MS * 1.025, f"unmasked kernel "
          f"7 {main7['best_ms']:.4f} ms (best of three), more than 2.5% "
          f"over its recorded {FLASH_UNMASKED_MS} ms")

    # -- kernel 7 under a key mask: the bucket-padded prefill ---------------
    # the tile's MASKED instantiations: two bits per 128-key tile (a valid
    # key, a masked key) in shared memory, a tile without a valid key
    # skipped, in-register masking only on a tile that holds a masked key
    def masked_flash_case(B, S, lens, label, *, heads=(H, KV, hd),
                          dtype=bf16, causal=True, n_obs=0, lead=0,
                          timed=False):
        Hs, KVs, hds = heads
        q, k, v = (randn(B, S, Hs, hds).to(dtype),
                   randn(B, S, KVs, hds).to(dtype),
                   randn(B, S, KVs, hds).to(dtype))
        j = torch.arange(S, device=dev)
        mask = (j < torch.as_tensor(lens, device=dev)[:, None]) \
            | (j >= S - n_obs)
        mask[0, :lead] = False
        mask = mask.contiguous()
        kw = dict(causal=causal, kv_mask=mask)
        got = fk.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              f"masked flash_attention {label}: a non-finite output")
        want = ref.flash_attention(q, k, v, **kw)
        # float32 runs the FMA kernel: float32 throughout, another order
        err = check_rows(torch, got, want,
                         REL_CHUNK if dtype == bf16 else 2 ** -13,
                         f"masked flash_attention {label}")
        if not timed:
            return None
        ms = time_ms(torch, lambda: fk.flash_attention(q, k, v, **kw))
        unmasked = time_ms(torch, lambda: fk.flash_attention(
            q, k, v, causal=causal))
        plain = time_ms(torch, lambda: ref.flash_attention(q, k, v, **kw),
                        iters=3)
        # SDPA with the causal and key masks as one boolean mask, built
        # outside the timed call
        pos = torch.arange(S, device=dev)
        vis = (pos[:, None] >= pos[None, :]) if causal else \
            torch.ones((S, S), dtype=torch.bool, device=dev)
        vis = vis[None] & mask[:, None, :]  # (B, S, S)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(Hs // KVs, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(Hs // KVs, dim=2).transpose(1, 2)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=vis[:, None]))
        # operations over the valid visible (row, key) pairs only; float32
        # runs on CUDA cores
        n_ops = 4 * hds * Hs * int(vis.sum())
        n_bytes = q.element_size() * (2 * B * S * Hs * hds
                                      + 2 * B * S * KVs * hds) + B * S
        b_ms, b_by = bound_ms(n_bytes, n_ops, str(dtype).split(".")[-1])
        print(f"  masked flash_attention {label}: {ms:.4f} ms (unmasked "
              f"{unmasked:.4f} ms, {ms / unmasked - 1:+.1%}), plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {int(vis.sum())} valid visible pairs of "
              f"{B * S * (S + 1) // 2 if causal else B * S * S})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib, unmasked_ms=unmasked)

    lens3k = (512, 700, 900, 1024)  # 3k's prompts
    main7m = masked_flash_case(4, 1024, lens3k, "B=4 S=1024 lengths "
                               "512/700/900/1024", timed=True)
    # at 3k's shape: key 0 of sequence 0 masked with every key visible
    # (each row keeps a valid key), float32, and hd 64 (tiny-llama's 12/4
    # heads); then the first 200 keys of a sequence masked: a key tile
    # with no valid key, then rows whose running max is -inf when the
    # next tile arrives
    masked_flash_case(4, 1024, lens3k, "non-causal, key 0 of seq 0 masked",
                      causal=False, lead=1, timed=True)
    masked_flash_case(4, 1024, lens3k, "float32", dtype=torch.float32,
                      timed=True)
    masked_flash_case(4, 1024, lens3k, "hd 64, 12/4 heads",
                      heads=(12, 4, 64), timed=True)
    masked_flash_case(2, 600, (600, 600), "non-causal, keys 0-199 of seq 0 "
                      "masked", causal=False, lead=200)
    masked_flash_case(2, 1056, (100, 1024), "32 observation rows after the "
                      "padding", n_obs=32)
    masked_flash_case(3, 260, (127, 128, 129), "lengths around a tile",
                      heads=(8, 2, 128))
    masked_flash_case(2, 300, (17, 300), "hd 32", heads=(4, 2, 32))
    results.append(dict(
        name="flash_attention masked", route="cuda",
        source="src/repro_torch/csrc/attention_sm90.cuh",
        replaces="src/repro/kernels/ops.py:77", **main7m))

    # -- kernel 6: dense decode attention, rows split over a cluster ---------
    def decode_case(label, kind, timed=False, timed_kernel=None,
                    heads=(H, KV, hd), window=None, C=289, splits=None,
                    dtype=bf16):
        B = 4  # C: budget 256 + 33 append rows
        Hs, KVs, hds = heads
        Gs = Hs // KVs
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((B, Hs, hds), (B, C, KVs, hds),
                                 (B, C, KVs, hds)))
        mask = None
        dead = min(5, KVs - 1)
        if kind == "head":
            # main-path validity: kept rows (a few dropped per head), then
            # the appends written so far
            mask = torch.rand((B, C, KVs), generator=g, device=dev) > 0.05
            mask[:, 272:] = False
            if window is not None:  # the decode step folds it in
                pos = torch.randint(0, 2080, (B, C, KVs), generator=g,
                                    device=dev)
                mask &= (2080 - pos) < window
        elif kind == "head-edge":
            mask = torch.rand((B, C, KVs), generator=g, device=dev) > 0.3
            mask[1, :, dead] = False  # a fully masked head
            mask[2] = False  # a sequence with no valid row
        elif kind == "row":
            mask = torch.rand((B, C), generator=g, device=dev) > 0.3
            mask[2] = False
        n_rule = dk.row_splits(B, KVs, C, sms)
        label = (f"{label}, {splits} splits" if splits is not None
                 else f"{label}, row_splits' {n_rule} splits")
        call = lambda: dk.decode_attention(q, k, v, kv_mask=mask)
        with forced_splits(splits, dk):
            got = call()
        torch.cuda.synchronize()
        want = ref.decode_attention(q, k, v, kv_mask=mask)
        err = check_rows(torch, got, want, REL_PAGED,
                         f"decode_attention {label}")
        if kind in ("head-edge", "row"):
            check(bool(torch.all(got[2] == 0)),
                  "decode_attention: a sequence with no valid row must give "
                  "exact zeros")
        if kind == "head-edge":
            check(bool(torch.all(got[1, dead * Gs:(dead + 1) * Gs] == 0)),
                  "decode_attention: a fully masked head must give exact "
                  "zeros")
        if timed_kernel:
            ms = time_ms(torch, call, iters=50)
            print(f"  decode_attention {label}: {versus(timed_kernel, ms)}")
        if not timed:
            return None
        check_launches(call, ("decode_kernel",), ((n_rule, KVs, B),))
        ms = time_ms(torch, call, iters=50)
        plain = time_ms(torch, lambda: ref.decode_attention(
            q, k, v, kv_mask=mask), iters=10)
        # library yardstick: SDPA with the per-head mask expanded to
        # (B, H, 1, C) and kv heads expanded, both outside the timed call
        kd = k.repeat_interleave(Gs, 2).transpose(1, 2)
        vd = v.repeat_interleave(Gs, 2).transpose(1, 2)
        md = mask.repeat_interleave(Gs, 2).permute(0, 2, 1)[:, :, None, :]
        qd = q[:, :, None, :]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=md), iters=50)
        rows_valid = int(mask.sum())  # (row, kv head) pairs
        n_ops = 4 * hds * Gs * rows_valid
        n_bytes = (itemsize * (2 * rows_valid * hds + 2 * B * Hs * hds)
                   + B * C * KVs)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        print(f"  decode_attention {label}: {versus('decode_attention', ms)}"
              f", plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {rows_valid} valid rows of "
              f"{B * C * KVs})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)

    main6 = decode_case("B=4 C=289 per-head mask", "head", timed=True)
    decode_case("hymba local layer: 25/5 heads of 64, window 1024", "head",
                timed_kernel="decode_attention hymba local",
                heads=HYMBA_HEADS, window=1024)
    decode_case("hymba global layer: 25/5 heads of 64", "head",
                heads=HYMBA_HEADS)
    # every mask kind and the routine's edges at 1, 2, 4 and 8 forced
    # splits and at the rule's pick: dead heads and sequences, fewer rows
    # than splits, one row, G 1 / 5 / 8 / 16, hd 32 and 64, float32
    for n in PAGED_SPLITS:
        decode_case("per-head mask, dead head and sequence", "head-edge",
                    splits=n)
        decode_case("(B, C) mask, dead sequence", "row", splits=n)
        decode_case("no mask", None, splits=n)
        decode_case("C=3", "head-edge", C=3, splits=n)
        decode_case("C=1 (B, C) mask", "row", C=1, splits=n)
        decode_case("G 1 hd 64", "head-edge", heads=(8, 8, 64), C=200,
                    splits=n)
        decode_case("G 5 hd 64", "head-edge", heads=(10, 2, 64), C=200,
                    splits=n)
        decode_case("G 8", "row", heads=(64, 8, 128), C=200, splits=n)
        decode_case("G 16 hd 32", "head-edge", heads=(32, 2, 32), C=150,
                    splits=n)
        decode_case("float32", "head-edge", C=150, splits=n,
                    dtype=torch.float32)
    results.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:56", **main6))

    # -- kernel 8: the Mamba-2 SSD chunked scan -------------------------------
    # three launches a call: chunk states, the state pass, the chunk scan
    # (bf16 on tensor cores, float32 on CUDA cores)
    def ssd_case(B, S, nh, hd, ds, chunk, label, *, dtype=bf16, state=None,
                 views=True, timed=None):
        """Kernel 8 against ``ref.ssd_scan_chunked`` on model-like inputs:
        x, B and C views of one conv output (rows strided, as the Mamba-2
        block passes them) unless ``views`` is False, dt = softplus(N - 2)
        (the block's dt_bias shifts it down), A in -[1, 16] (a_init_range),
        ``state`` None, "random" or a state tensor to carry in.  Each row of
        y (one row of one head) must lie within 2^-12 of that row's largest
        plain magnitude and the final state within 2^-12 of its largest
        plain magnitude: in bf16 every float32 operand of a tensor-core
        product enters as bf16 hi + lo (~2^-17 of it), and the prefix sums
        of the log-decays take other orders, so exp(L_t - L_s) of two large
        L inherits their ~1e-5 absolute difference.  Timed, one call must be
        three launches on the grids ``sk.grids`` gives.  Returns (the
        kernel's final state, timings or None)."""
        def mk(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        if views:
            xbc = mk(B, S, nh * hd + 2 * ds)
            x, Bm, Cm = torch.split(xbc, [nh * hd, ds, ds], dim=-1)
            x = x.unflatten(-1, (nh, hd))
            Bm, Cm = Bm.unflatten(-1, (1, ds)), Cm.unflatten(-1, (1, ds))
        else:
            x, Bm, Cm = mk(B, S, nh, hd), mk(B, S, 1, ds), mk(B, S, 1, ds)
        dt = F.softplus(torch.randn((B, S, nh), generator=g, device=dev)
                        - 2.0)
        A = -(1.0 + 15.0 * torch.rand((nh,), generator=g, device=dev))
        h0 = (torch.randn((B, nh, hd, ds), generator=g, device=dev)
              if isinstance(state, str) else state)
        kw = dict(chunk=chunk, initial_state=h0)
        got_y, got_h = sk.ssd_scan(x, dt, A, Bm, Cm, **kw)
        torch.cuda.synchronize()
        want_y, want_h = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, **kw)
        err = check_rows(torch, got_y, want_y, REL_SSD, f"ssd_scan {label} y")
        h_err, h_tol = max_err(got_h, want_h), tolerance(want_h, REL_SSD)
        print(f"  ssd_scan {label} state: max_abs_err {h_err:.3e} (tol "
              f"{h_tol:.3e} = 2^-12 max|plain|)")
        check(h_err <= h_tol, f"ssd_scan {label}: state err {h_err} > "
              f"{h_tol}")
        if not timed:
            return got_h, None
        call = lambda: sk.ssd_scan(x, dt, A, Bm, Cm, **kw)
        check_launches(call, ("ssd_chunk_states_mma", "ssd_state_pass",
                              "ssd_chunk_scan_mma"),
                       sk.grids(B, S, nh, hd, ds, chunk, dtype, sms))
        ms = time_ms(torch, call)
        plain = time_ms(torch, lambda: ref.ssd_scan_chunked(
            x, dt, A, Bm, Cm, **kw), iters=3)
        # bytes: each input read once, each output written once; operations:
        # per chunk of nv rows with P = nv (nv + 1) / 2 causal pairs, C.B^T
        # once per (sequence, chunk) (shared by the heads), and per head the
        # pair weights, the quadratic form, the carried-state term and the
        # state update.  bf16 inputs take them on tensor cores, where the
        # bytes bound the time; the float32 CUDA-core time is printed beside
        isz = x.element_size()
        n_bytes = (isz * (B * S * nh * hd + 2 * B * S * ds)
                   + 4 * (B * S * nh + nh + B * S * nh * hd)
                   + 4 * B * nh * hd * ds * (2 if h0 is not None else 1))
        n_ops = 0
        for c0 in range(0, S, chunk):
            nv = min(chunk, S - c0)
            pairs = nv * (nv + 1) // 2
            n_ops += B * (2 * pairs * ds
                          + nh * (pairs * (1 + 2 * hd) + 4 * nv * hd * ds))
        b_ms, b_by = bound_ms(n_bytes, n_ops, str(dtype).split(".")[-1])
        f32_ms = n_ops / PEAK_FLOPS["float32"] * 1e3
        print(f"  ssd_scan {label}: {versus(timed, ms)}, plain {plain:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB; "
              f"{n_ops / 1e9:.2f} GFLOP, {f32_ms:.4f} ms on float32 CUDA "
              "cores); no single library call computes the scan")
        return got_h, dict(max_abs_err=max(err, h_err), ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)

    REL_SSD = 2 ** -12
    # hymba-1.5b's lockstep prefill (bf16): the 2048-row prompt, then the
    # 32 lookahead rows chained on its final state (a ragged chunk); its 50
    # heads leave a ragged last head block
    h_prompt, main8 = ssd_case(4, 2048, 50, 64, 16, 128,
                               "hymba prompt B=4 S=2048 nh=50 ds=16",
                               timed="ssd_scan")
    ssd_case(4, 32, 50, 64, 16, 128, "hymba lookahead segment S=32 carried",
             state=h_prompt)
    ssd_case(4, 2048, 24, 64, 128, 128, "mamba2 B=4 S=2048 nh=24 ds=128",
             timed="ssd_scan mamba2")
    ssd_case(8, 2048, 13, 64, 64, 128, "nh=13 in head blocks of 4",
             state="random")
    ssd_case(2, 4096, 24, 64, 128, 128, "S=4096: 32 chunks through the "
             "state pass", state="random")
    ssd_case(2, 1000, 50, 64, 16, 128, "ragged S=1000", state="random")
    ssd_case(2, 50, 24, 64, 128, 128, "S=50 < chunk", state="random")
    ssd_case(4, 1, 50, 64, 16, 128, "S=1", state="random")
    ssd_case(2, 64, 8, 64, 16, 1, "chunk 1", state="random")
    ssd_case(1, 300, 7, 32, 8, 32, "odd nh=7, chunk 32, ds 8 (smoke)")
    ssd_case(2, 500, 10, 64, 8, 128, "ds 8 at hd 64", state="random")
    ssd_case(2, 500, 24, 64, 128, 128, "float32 inputs", dtype=torch.float32,
             state="random", views=False)
    ssd_case(1, 700, 5, 64, 16, 256, "chunk 256", state="random")
    ssd_case(1, 600, 6, 64, 128, 256, "chunk 256 ds 128 (one buffer)",
             state="random")
    ssd_case(2, 96, 8, 16, 8, 16, "hd=16 chunk 16", views=False)
    results.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:75", **main8))
    return results


# ---------------------------------------------------------------------------
# phase 2: the engine on the card against the engine on the CPU
# ---------------------------------------------------------------------------


def phase_engine_parity(torch, mods, devices=("cuda", "cpu")) -> None:
    """Each engine on ``devices[0]`` (the card) against ``devices[1]``
    (the CPU)."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(mods["configs"].get_smoke_config("llama3-8b"),
                              dtype="float32")
    tf, sv, pol = mods["tf"], mods["serving"], mods["policies"]
    params = tf.init_params(cfg, seed=SEED, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    lkv = mods["lookahead"].init_lookahead_params(gen, cfg, params["layers"])
    evict = mods["EvictionConfig"](budget=16)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 23, 45)]
    burst = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (40, 27, 33, 45, 29, 36)]
    batch = rng.integers(0, cfg.vocab_size, (3, 41)).astype(np.int32)
    mixed = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (40, 50, 64, 23)]
    evict_draft = mods["EvictionConfig"](budget=16, draft_len=8)
    dcfg = dataclasses.replace(
        mods["configs"].get_smoke_config("tiny-llama"), dtype="float32")
    dparams = tf.init_params(dcfg, seed=SEED + 2, device="cpu")

    def kept(mask, pos):  # (L, rows, KV) -> {(layer, head): positions}
        return {(lyr, h): frozenset(pos[lyr, mask[lyr, :, h], h].tolist())
                for lyr in range(mask.shape[0]) for h in range(mask.shape[2])}

    def continuous(device, *, pool_blocks=None, block_size=16, reqs=prompts,
                   max_new=8, ev=evict, chunking=None, slots=2,
                   policy="lookaheadkv", **config):
        pool = (sv.KVBlockPool(cfg, block_size=block_size,
                               num_blocks=pool_blocks, device=device)
                if pool_blocks else None)
        sc = sv.ServingConfig(
            policy=policy, evict=ev, chunking=chunking or sv.ChunkingConfig(
                chunk=32, max_context=70),
            num_slots=slots, max_new_tokens=max_new, eos_id=-1,
            kv_pool=pool, capture_admission=True, **config)
        eng = sv.ContinuousEngine(
            _move(params, device), cfg, sc,
            lkv_params=(_move(lkv, device) if policy == "lookaheadkv"
                        else None),
            device=device)
        # per-request seeds: the random policy draws from them
        done = eng.run([sv.Request(uid=i, prompt=p, max_new_tokens=max_new,
                                   seed=1000 + 17 * i)
                        for i, p in enumerate(reqs)])
        out = {}
        for r in done:
            a = r.admission_cache
            sets = {"admission": kept(a["mask"][:, 0], a["pos"][:, 0])}
            if r.retirement_cache is not None:
                rc = r.retirement_cache
                sets["retirement"] = kept(rc["mask"], rc["pos"])
            out[r.uid] = (r.out_tokens, sets)
        counts = {k: eng.counts[k] for k in ("decode_evict_sweeps",
                                              "preemptions")}
        if pool is not None:
            counts["blocks_reclaimed_decode"] = pool.blocks_reclaimed_decode
        return out, counts

    def lockstep(device, policy="lookaheadkv"):
        p = _move(params, device)
        lk = _move(lkv, device) if policy == "lookaheadkv" else None
        # speckv's draft model: tiny-llama-smoke (the same 512 vocabulary)
        draft = (dict(draft_params=_move(dparams, device), draft_cfg=dcfg)
                 if policy == "speckv" else {})
        ev = evict_draft if policy in ("laq", "speckv") else evict
        reqs = [sv.Request(uid=i, prompt=row, max_new_tokens=8,
                           seed=2000 + i) for i, row in enumerate(batch)]
        # the kept sets of the batch's prefill, then the engine's tokens
        seeds = torch.as_tensor([r.eviction_seed for r in reqs],
                                dtype=torch.int32, device=device)
        res = pol.run_eviction(policy, p, cfg,
                               torch.as_tensor(batch, device=device),
                               evict=ev, lkv_params=lk, extra_slots=9,
                               seeds=seeds, **draft)
        eng = sv.ServingEngine(p, cfg, policy=policy, evict=ev,
                               lkv_params=lk, max_new_tokens=8, eos_id=-1,
                               device=device, **draft)
        done = eng.serve(reqs)
        adm = {k: res.cache["attn"][k].cpu().numpy() for k in ("mask", "pos")}
        return {r.uid: (r.out_tokens, {"admission": kept(
            adm["mask"][:, r.uid], adm["pos"][:, r.uid])})
            for r in done}, {}

    def bucketed(device, policy):
        """``BucketedEngine`` on mixed lengths: 40, 50 and 64 in one
        padded group at bucket 64 (laq: groups of one exact length), 23
        alone at bucket 32."""
        eng = sv.BucketedEngine(
            _move(params, device), cfg, policy=policy,
            evict=evict_draft if policy == "laq" else evict,
            lkv_params=(_move(lkv, device) if policy == "lookaheadkv"
                        else None),
            num_slots=4, max_new_tokens=8, eos_id=-1, device=device)
        done = eng.run([sv.Request(uid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(mixed)])
        return {r.uid: (r.out_tokens, {}) for r in done}, {
            "prefill_groups": eng.counts["prefill_groups"]}

    evict_cfg = sv.DecodeEvictionConfig(enabled=True, interval=8)
    runs = (
        ("paged continuous", lambda d: continuous(d, pool_blocks=32)),
        ("dense-slot continuous", continuous),
        ("lockstep", lockstep),
        # (a) sweeps fire: interval 8 over a 16-row capacity, 4-row blocks
        ("paged decode-evict", lambda d: continuous(
            d, pool_blocks=64, block_size=4, max_new=24,
            decode_evict=evict_cfg)),
        # (b) optimistic admission on a pool too small to grow every slot:
        # depth 8 + 9 = 17 rows, 5 blocks of 4, 7 blocks for 3 slots
        ("paged optimistic admission", lambda d: continuous(
            d, pool_blocks=7, block_size=4, reqs=burst,
            ev=mods["EvictionConfig"](budget=8), reserve_appends=False,
            chunking=sv.ChunkingConfig(chunk=16, max_context=45,
                                       decode_chunk=1), slots=3)),
        # (c) dense slot caches with per-step eviction (8 margin rows)
        ("dense-slot decode-evict", lambda d: continuous(
            d, max_new=24, decode_evict=True)),
        # every other single-pass policy the engines take: h2o runs kernel
        # 2 on the card, the window policies kernel 3 at finalize
        *((f"paged continuous {pol_}", lambda d, pol_=pol_: continuous(
            d, pool_blocks=32, policy=pol_))
          for pol_ in ("h2o", "snapkv", "pyramidkv", "tova",
                       "streaming_llm", "random")),
        ("paged continuous lookaheadkv adaptive", lambda d: continuous(
            d, pool_blocks=48, ev=mods["EvictionConfig"](
                budget=16, head_alloc="adaptive"))),
        ("dense-slot continuous h2o", lambda d: continuous(d, policy="h2o")),
        *((f"lockstep {pol_}", lambda d, pol_=pol_: lockstep(d, pol_))
          for pol_ in ("h2o", "snapkv", "full", "laq", "speckv")),
        *((f"bucketed {pol_}", lambda d, pol_=pol_: bucketed(d, pol_))
          for pol_ in ("lookaheadkv", "full", "laq")),
    )
    for label, run in runs:
        (got, got_counts), (want, want_counts) = (run(d) for d in devices)
        same = {}
        for uid, (toks, sets) in want.items():
            got_toks, got_sets = got[uid]
            print(f"  {label} uid {uid}: cuda {got_toks} cpu {toks}")
            check(got_toks == toks, f"engine parity ({label}): uid {uid} "
                  "tokens differ between card and CPU")
            for name, val in sets.items():
                same[name] = same.get(name, 0) + int(got_sets[name] == val)
        print(f"  {label}: greedy tokens identical for {len(want)} "
              f"requests; kept sets identical: {same}; counts card "
              f"{got_counts} cpu {want_counts}")
        check(all(n == len(want) for n in same.values()),
              f"engine parity ({label}): kept sets differ between card and "
              "CPU")
        check(got_counts == want_counts, f"engine parity ({label}): counts "
              "differ between card and CPU")
        if label == "paged decode-evict":
            check(want_counts["decode_evict_sweeps"] > 0
                  and want_counts["blocks_reclaimed_decode"] > 0,
                  f"{label}: no sweep fired or no block was reclaimed")
        if label == "paged optimistic admission":
            check(want_counts["preemptions"] > 0,
                  f"{label}: the pool never ran dry (no preemption)")
        if label == "bucketed lookaheadkv":
            # bucket padding is exact for lookaheadkv: each request's
            # tokens are a batch-1 lockstep run's, on the card
            eng = sv.ServingEngine(
                _move(params, devices[0]), cfg, evict=evict,
                lkv_params=_move(lkv, devices[0]), max_new_tokens=8,
                eos_id=-1, device=devices[0])
            for uid, p in enumerate(mixed):
                alone = eng.serve([sv.Request(uid=uid, prompt=p,
                                              max_new_tokens=8)])[0]
                check(alone.out_tokens == got[uid][0], f"{label}: uid {uid} "
                      f"padded {got[uid][0]} != batch-1 lockstep "
                      f"{alone.out_tokens}")
            print(f"  {label}: every request's tokens equal its batch-1 "
                  f"lockstep run's on the card ({len(mixed)} requests, "
                  f"{got_counts['prefill_groups']} prefill groups)")


def phase_ssm_parity(torch, mods, devices=("cuda", "cpu")) -> None:
    """The SSM archs on ``devices[0]`` (the card) against ``devices[1]``
    (the CPU), float32 smoke configs: the hybrid hymba-smoke through the
    lockstep engine under lookaheadkv and h2o (3 prompts of 45 tokens, 8
    new), and the attention-free mamba2-smoke through ``prefill(
    want_ssm_cache=True)`` and 8 greedy decode steps; greedy tokens must be
    identical, and kernel 8 must launch on the card."""
    import dataclasses

    import numpy as np

    tf, sv, pol, ops = mods["tf"], mods["serving"], mods["policies"], \
        mods["ops"]
    get = mods["configs"].get_smoke_config
    hcfg = dataclasses.replace(get("hymba-1.5b"), dtype="float32")
    mcfg = dataclasses.replace(get("mamba2-130m"), dtype="float32")
    hp = tf.init_params(hcfg, seed=SEED, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    hl = mods["lookahead"].init_lookahead_params(gen, hcfg, hp["layers"])
    mp = tf.init_params(mcfg, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED + 3)
    hbatch = rng.integers(0, hcfg.vocab_size, (3, 45)).astype(np.int32)
    mbatch = rng.integers(0, mcfg.vocab_size, (3, 45)).astype(np.int32)

    def hymba(device, policy):
        eng = sv.ServingEngine(
            _move(hp, device), hcfg, policy=policy,
            evict=mods["EvictionConfig"](budget=16),
            lkv_params=(_move(hl, device) if policy == "lookaheadkv"
                        else None),
            max_new_tokens=8, eos_id=-1, device=device)
        done = eng.serve([sv.Request(uid=i, prompt=row, max_new_tokens=8)
                          for i, row in enumerate(hbatch)])
        return [r.out_tokens for r in done]

    def mamba(device):
        p = _move(mp, device)
        res = tf.prefill(p, mcfg, torch.as_tensor(mbatch, device=device),
                         want_ssm_cache=True)
        first = torch.argmax(res.logits, dim=-1)[:, None].to(torch.int32)
        toks, _ = pol.greedy_decode(p, mcfg, first, res.cache, 8)
        return toks.cpu().tolist()

    for label, run in (("hymba-smoke lockstep lookaheadkv",
                        lambda d: hymba(d, "lookaheadkv")),
                       ("hymba-smoke lockstep h2o", lambda d: hymba(d, "h2o")),
                       ("mamba2-smoke prefill + decode", mamba)):
        ops.reset_launch_counts()
        got = run(devices[0])
        n8 = ops.launch_counts()["ssd_scan"]
        want = run(devices[1])
        print(f"  {label}: cuda {got} cpu {want}; kernel 8 launched {n8} "
              "times on the card")
        check(got == want, f"ssm parity ({label}): tokens differ between "
              "card and CPU")
        check(n8 > 0, f"ssm parity ({label}): kernel 8 never launched")


def _move(tree, device):
    return {k: _move(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 3: full-width serve
# ---------------------------------------------------------------------------


LENS = (1024, 2048, 3072, 4000)
COMMON = ["--arch", "llama3-8b", "--seed", str(SEED), "--policy",
          "lookaheadkv", "--budget", "256", "--max-new", "32", "--device",
          "cuda"]
PAGED = ["--continuous", "--chunk", "256", "--slots", "4",
         "--kv-block-size", "16", "--kv-pool-mb", "256",
         "--prompt-lens", ",".join(map(str, LENS))]
# route -> (extra launcher arguments, new tokens per request, kernels its
# run must launch, kernels it must not launch)
ROUTES = {
    "paged continuous": (
        PAGED, 32,
        ("chunk_attention", "lookahead_score", "paged_decode_attention"),
        ("paged_decode_masses",)),
    "lockstep": (
        ["--requests", "4", "--n-in", "2048"], 32,
        ("flash_attention", "lookahead_score", "decode_attention"), ()),
    "dense-slot continuous": (
        ["--continuous", "--chunk", "256", "--slots", "4",
         "--prompt-lens", ",".join(map(str, LENS))], 32,
        ("chunk_attention", "lookahead_score", "decode_attention"), ()),
    # 192 new tokens: two sweeps per request (at 64 and 128 appended rows),
    # and requests overlap (a request decodes while the next prefills)
    "paged decode-evict": (
        PAGED + ["--decode-evict", "--decode-evict-interval", "64",
                 "--max-new", "192"], 192,
        ("chunk_attention", "lookahead_score", "paged_decode_masses"),
        ("paged_decode_attention",)),
    # 3a's trace under h2o: every prefill chunk runs kernel 2 (the column
    # masses) instead of kernel 1, and there is no observation pass
    "paged continuous h2o": (
        PAGED + ["--policy", "h2o"], 32,
        ("chunk_attention_masses", "paged_decode_attention"),
        ("chunk_attention", "lookahead_score", "paged_decode_masses")),
    # 3c's trace under pyramidkv: per-layer budgets, capacity 342; the
    # window finalize scores through kernel 3
    "dense-slot continuous pyramidkv": (
        ["--continuous", "--chunk", "256", "--slots", "4",
         "--prompt-lens", ",".join(map(str, LENS)), "--policy", "pyramidkv"],
        32, ("chunk_attention", "lookahead_score", "decode_attention"),
        ("chunk_attention_masses",)),
    # the hybrid hymba-1.5b (its only route): 3b's shape; every layer's SSM
    # runs kernel 8 twice (the prompt, then the lookahead rows chained on
    # its state)
    "hybrid lockstep": (
        ["--arch", "hymba-1.5b", "--requests", "4", "--n-in", "2048"], 32,
        ("flash_attention", "lookahead_score", "decode_attention",
         "ssd_scan"),
        ("chunk_attention", "chunk_attention_masses",
         "paged_decode_attention", "paged_decode_masses")),
    # LAQ (the paper's draft-based baseline) on 3b's shape: a snapkv
    # prefill, an 8-token draft over its compressed cache, a gt_oracle
    # prefill over prompt + draft, then 32 decode steps
    "lockstep laq": (
        ["--requests", "4", "--n-in", "2048", "--policy", "laq"], 32,
        ("flash_attention", "lookahead_score", "decode_attention"),
        ("chunk_attention", "chunk_attention_masses",
         "paged_decode_attention", "paged_decode_masses", "ssd_scan")),
    # --continuous --policy full: BucketedEngine.  512 fills its bucket
    # (an exact group, unmasked kernel 7); 700, 900 and 1024 are one
    # group padded to bucket 1024 (kernel 7 under its key mask)
    "bucketed continuous full": (
        ["--continuous", "--policy", "full", "--slots", "4",
         "--prompt-lens", "512,700,900,1024"], 32,
        ("flash_attention", "decode_attention"),
        ("chunk_attention", "chunk_attention_masses", "lookahead_score",
         "paged_decode_attention", "paged_decode_masses", "ssd_scan")),
}
#: exact launches per kernel in the cells that add them (32 layers of
#: llama3-8b, 12 of the tiny-llama draft; 32 new tokens): 3i runs kernels 7
#: and 3 in both prefills, kernel 6 for 8 draft and 32 serving steps; 3j
#: kernel 7 in the draft's prefill (12) and the target's rescoring prefill
#: (32), kernel 3 in the latter, kernel 6 for 8 draft steps of 12 layers
#: and 32 serving steps; 3k kernel 7 in two prefill groups and kernel 6 for
#: 31 decode steps (the first token comes from the prefill)
EXACT_LAUNCHES = {
    "lockstep laq": {"flash_attention": 2 * 32, "lookahead_score": 2 * 32,
                     "decode_attention": 32 * (8 + 32)},
    "lockstep speckv": {"flash_attention": 12 + 32, "lookahead_score": 32,
                        "decode_attention": 12 * 8 + 32 * 32},
    "bucketed continuous full": {"flash_attention": 2 * 32,
                                 "decode_attention": 32 * 31},
}


def phase_serve(torch, mods, route: str) -> tuple:
    """Serve one route of the launcher at full width; the launch counts are
    set to 0 just before the run and read just after it."""
    ops, fk = mods["ops"], mods["fk"]
    extra, new_tokens, need, forbid = ROUTES[route]
    # kernel 7's calls under a key mask, counted apart here (the wrapper
    # has one counter for both forms)
    masked, unwrapped = [0], fk.flash_attention

    def counting(*args, **kw):
        masked[0] += kw.get("kv_mask") is not None
        return unwrapped(*args, **kw)

    fk.flash_attention = counting
    try:
        ops.reset_launch_counts()
        res = mods["serve"].run(COMMON + extra)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        fk.flash_attention = unwrapped
    res["masked_flash"] = masked[0]
    eng, done = res["engine"], res["done"]
    check(len(done) == 4, f"{route}: not every request finished")
    for r in sorted(done, key=lambda r: r.uid):
        check(len(r.out_tokens) == new_tokens, f"{route}: uid {r.uid} "
              f"emitted {len(r.out_tokens)} tokens")
        check(all(0 <= t < res["cfg"].vocab_size for t in r.out_tokens),
              f"{route}: uid {r.uid} emitted a token outside the vocab")
        print(f"  uid {r.uid}: prompt {len(r.prompt)} ttft "
              f"{r.ttft_s * 1e3:.1f} ms, first tokens {r.out_tokens[:6]}")
    dec_tokens = sum(len(r.out_tokens) - 1 for r in done)
    if "lockstep" in route:
        # one batch: prefill ends at the first-token logits (TTFT), then
        # 32 decode steps for the whole batch (the last one's token unused)
        ttft = done[0].ttft_s
        dec_s = res["wall_s"] - ttft
        print(f"  wall {res['wall_s']:.2f} s; prefill (= TTFT) "
              f"{ttft * 1e3:.1f} ms for 4 x 2048 tokens; decode "
              f"{eng.max_new_tokens} steps of the batch in {dec_s:.2f} s "
              f"({dec_s / eng.max_new_tokens * 1e3:.1f} ms/step) = "
              f"{dec_tokens / dec_s:.1f} tokens/s")
    elif "bucketed" in route:
        c = eng.counts
        print(f"  wall {res['wall_s']:.2f} s; prefill {c['prefill_groups']} "
              f"groups in {c['prefill_s']:.2f} s; decode "
              f"{c['decode_steps']} steps in {c['decode_chunks']} chunks "
              f"({dec_tokens} tokens) in {c['decode_s']:.2f} s "
              f"({c['decode_s'] / c['decode_steps'] * 1e3:.1f} ms/step) = "
              f"{dec_tokens / c['decode_s']:.1f} tokens/s; peak "
              f"concurrency {c['max_concurrency']}; kernel 7 calls under "
              f"the key mask {res['masked_flash']}")
        check(c["prefill_groups"] == 2, f"{route}: {c['prefill_groups']} "
              "prefill groups, expected 2 (512 exact, 700/900/1024 padded)")
        check(res["masked_flash"] == res["cfg"].num_layers, f"{route}: "
              f"{res['masked_flash']} masked kernel 7 calls, expected one "
              "per layer of the padded group")
        check(c["max_concurrency"] == 4, f"{route}: peak concurrency "
              f"{c['max_concurrency']}, expected 4")
    else:
        c = eng.counts
        print(f"  wall {res['wall_s']:.2f} s; prefill {c['prefill_chunks']} "
              f"chunks in {c['prefill_s']:.2f} s "
              f"({c['prefill_s'] / c['prefill_chunks'] * 1e3:.1f} "
              f"ms/chunk); decode {c['decode_steps']} steps in "
              f"{c['decode_chunks']} chunks ({dec_tokens} tokens) in "
              f"{c['decode_s']:.2f} s "
              f"({c['decode_s'] / c['decode_steps'] * 1e3:.1f} ms/step) = "
              f"{dec_tokens / c['decode_s']:.1f} tokens/s; peak concurrency "
              f"{c['max_concurrency']}; {c['preemptions']} preemptions, "
              f"{c['decode_evict_sweeps']} decode-eviction sweeps")
    kv = (f"kv pool high water {eng.pool.stats()['high_water_blocks']} of "
          f"{eng.pool.usable_blocks} blocks, "
          f"{eng.pool.blocks_reclaimed_decode} reclaimed mid-generation"
          if getattr(eng, "pool", None) is not None else
          f"decode KV {eng.kv_device_bytes() / 2**20:.1f} MiB"
          if "lockstep" not in route else
          f"decode KV {eng.kv_device_bytes(4) / 2**20:.1f} MiB")
    print(f"  peak torch.cuda.max_memory_allocated while serving "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; {kv}")
    print(f"  kernel launches in this run: {counts}")
    for name in need:
        check(counts[name] > 0, f"{route}: kernel {name} was never launched")
    for name in forbid:
        check(counts[name] == 0, f"{route}: kernel {name} was launched "
              f"{counts[name]} times")
    if route == "paged continuous h2o":
        # one kernel-2 launch per layer of every prefill chunk
        want = eng.counts["prefill_chunks"] * res["cfg"].num_layers
        print(f"  kernel 2 launches {counts['chunk_attention_masses']} = "
              f"{eng.counts['prefill_chunks']} chunks x "
              f"{res['cfg'].num_layers} layers: "
              f"{counts['chunk_attention_masses'] == want}")
        check(counts["chunk_attention_masses"] == want,
              f"{route}: kernel 2 launched {counts['chunk_attention_masses']}"
              f" times, expected {want}")
    if route == "dense-slot continuous pyramidkv":
        cfg = res["cfg"]
        budgets, cap = mods["tf"]._policy_budget_schedule(
            cfg, "pyramidkv", 256, eng.evict.pyramid_beta)
        print(f"  capacity {eng.capacity} (2*beta/(beta+1)*256 + 1 at beta "
              f"{eng.evict.pyramid_beta}); layer budgets {budgets}")
        check(eng.capacity == cap == 342, f"{route}: capacity "
              f"{eng.capacity}, expected 342")
    if route == "lockstep":
        # kernel 7 once per layer: the prompt's self-attention
        L = res["cfg"].num_layers
        print(f"  kernel 7 launches {counts['flash_attention']}, predicted "
              f"{L}")
        check(counts["flash_attention"] == L, f"{route}: kernel 7 launched "
              f"{counts['flash_attention']} times, expected {L}")
    if route == "hybrid lockstep":
        # per layer: kernel 8 for the prompt and for the lookahead rows,
        # kernels 7 and 3 once; kernel 6 once per layer per decode step
        L, steps = res["cfg"].num_layers, eng.max_new_tokens
        want = {"ssd_scan": 2 * L, "flash_attention": L,
                "lookahead_score": L, "decode_attention": steps * L}
        got = {k: counts[k] for k in want}
        print(f"  launches {got}, predicted {want}: {got == want}")
        check(got == want, f"{route}: launches {got}, expected {want}")
    if route in EXACT_LAUNCHES:
        check_exact_launches(route, counts)
    if route == "paged decode-evict":
        c = eng.counts
        check(c["decode_evict_sweeps"] >= 8, f"{route}: "
              f"{c['decode_evict_sweeps']} sweeps, expected >= 8")
        check(eng.pool.blocks_reclaimed_decode > 0,
              f"{route}: no block was reclaimed mid-generation")
        check(c["max_concurrency"] >= 2, f"{route}: requests never "
              "overlapped (max concurrency 1)")
    return counts, res


def check_exact_launches(label: str, counts: dict) -> None:
    """Every kernel launched exactly ``EXACT_LAUNCHES[label]`` times, and
    every other kernel not at all."""
    want = {k: EXACT_LAUNCHES[label].get(k, 0) for k in counts}
    print(f"  launches {counts}, predicted {want}: {counts == want}")
    check(counts == want, f"{label}: launches {counts}, expected {want}")


def phase_speckv(torch, mods, res) -> tuple:
    """3j: SpecKV through ``ServingEngine`` on 3i's llama3-8b weights (not
    built again), with tiny-llama at its registry width (12 layers, d 768,
    12/4 heads of 64, bf16; random weights from the seed) as the draft
    model, draft_len 8, budget 256, 4 prompts of 2048 tokens, 32 new.
    tiny-llama's vocabulary is 32,000 against llama3-8b's 128,256, so the
    prompts draw token ids below 32,000 (the draft's tokens are below it
    too).  The launch counts are set to 0 just before the serve and read
    just after.  Returns (counts, TTFT seconds, the TTFT of a second
    serve)."""
    import numpy as np

    tf, sv, ops = mods["tf"], mods["serving"], mods["ops"]
    cfg, params, dev = res["cfg"], res["engine"].params, res["engine"].device
    dcfg = mods["configs"].get_config("tiny-llama")
    dparams = tf.init_params(dcfg, seed=SEED, device=dev)
    prompts = np.random.default_rng(SEED + 9).integers(
        0, dcfg.vocab_size, (4, 2048)).astype(np.int32)
    eng = sv.ServingEngine(
        params, cfg, policy="speckv",
        evict=mods["EvictionConfig"](budget=256, draft_len=8),
        draft_params=dparams, draft_cfg=dcfg, max_new_tokens=32, eos_id=-1,
        device=dev)
    reqs = [sv.Request(uid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for r in done:
        check(len(r.out_tokens) == 32, f"3j: uid {r.uid} emitted "
              f"{len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"3j: uid {r.uid} emitted a token outside the vocab")
        print(f"  uid {r.uid}: prompt {len(r.prompt)} ttft "
              f"{r.ttft_s * 1e3:.1f} ms, first tokens {r.out_tokens[:6]}")
    ttft = done[0].ttft_s
    dec_s = wall - ttft
    print(f"  wall {wall:.2f} s; prefill (= TTFT: draft prefill, 8 draft "
          f"steps, rescoring prefill) {ttft * 1e3:.1f} ms for 4 x 2048 "
          f"tokens; decode 32 steps in {dec_s:.2f} s "
          f"({dec_s / 32 * 1e3:.1f} ms/step)")
    print(f"  kernel launches in this run: {counts}")
    check_exact_launches("lockstep speckv", counts)
    return counts, ttft, warm_ttft(torch, mods, eng, dcfg.vocab_size)


def phase_mamba(torch, mods) -> dict:
    """mamba2-130m at full width (24 layers, d 768, 24 SSM heads of 64, d_state
    128, bf16; random weights from the seed) through the model functions
    (no engine serves an attention-free arch): ``prefill(want_ssm_cache=
    True)`` of 4 x 2048 tokens, then 32 steps of ``greedy_decode``.  The
    launch counts are set to 0 just before and read just after: kernel 8
    once per layer, no attention kernel.  Returns the counts."""
    import numpy as np

    tf, pol, ops = mods["tf"], mods["policies"], mods["ops"]
    cfg = mods["configs"].get_config("mamba2-130m")
    params = tf.init_params(cfg, seed=SEED, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (4, 2048)).astype(np.int32), device="cuda")
    steps = 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = tf.prefill(params, cfg, tokens, want_ssm_cache=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first = torch.argmax(res.logits, dim=-1)[:, None].to(torch.int32)
    toks, cache = pol.greedy_decode(params, cfg, first, res.cache, steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(tuple(toks.shape) == (4, steps), f"3h: tokens {tuple(toks.shape)}")
    check(bool(torch.isfinite(res.logits[:, :cfg.vocab_size]).all()),
          "3h: non-finite prefill logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "3h: a token outside the vocab")
    check(bool(torch.isfinite(cache["ssm"]["state"]).all()),
          "3h: non-finite SSM state")
    check(set(cache) == {"ssm", "next_pos"}, f"3h: cache keys {set(cache)}")
    pre, dec = t1 - t0, t2 - t1
    dec_tokens = 4 * (steps - 1)
    print(f"  prefill 4 x 2048 tokens {pre * 1e3:.1f} ms; decode {steps} "
          f"steps in {dec:.2f} s ({dec / steps * 1e3:.1f} ms/step) = "
          f"{dec_tokens / dec:.1f} tokens/s; peak "
          f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; first "
          f"tokens {toks[:, :6].tolist()}")
    print(f"  kernel launches in this run: {counts}")
    want = cfg.num_layers
    check(counts["ssd_scan"] == want, f"3h: kernel 8 launched "
          f"{counts['ssd_scan']} times, expected {want}")
    check(all(n == 0 for k, n in counts.items() if k != "ssd_scan"),
          "3h: an attention kernel was launched")
    print(f"  kernel 8 launches {counts['ssd_scan']} = {want} layers; no "
          "attention kernel")
    return counts


# ---------------------------------------------------------------------------
# phase 4: where the time goes (torch.profiler over one more request)
# ---------------------------------------------------------------------------


# kernel name part -> family; chunk and flash attention share their tile
# code (chunk_attention.cu) but not their kernels' names
# (attention_mma<chunk_attention_tag, ...>), and the merges of a split key
# range carry their entry's tag
FAMILIES = (("chunk_masses", "chunk_attention_masses (kernel 2)"),
            ("column_masses", "chunk_attention_masses (kernel 2)"),
            ("chunk_attention", "chunk_attention (kernel 1)"),
            ("flash_attention", "flash_attention (kernel 7)"),
            ("obs_", "lookahead_score"),
            ("paged_masses", "paged_decode_masses (kernel 5)"),
            ("paged_decode", "paged_decode_attention"),
            ("decode_kernel", "decode_attention"),
            ("ssd_", "ssd_scan (kernel 8)"),
            ("gemm", "GEMM (cuBLAS)"), ("nvjet", "GEMM (cuBLAS)"),
            ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"))
#: each wrapper's family and its CUDA launches per counted call (phase 1's
#: check_launches), the merge of a split key range (kernels 1 and 2's
#: combine_splits, at most one a call) aside
TRACED = {
    "chunk_attention": ("chunk_attention (kernel 1)", 1),
    "chunk_attention_masses": ("chunk_attention_masses (kernel 2)", 2),
    "lookahead_score": ("lookahead_score", 2),
    "paged_decode_attention": ("paged_decode_attention", 1),
    "paged_decode_masses": ("paged_decode_masses (kernel 5)", 1),
    "flash_attention": ("flash_attention (kernel 7)", 1),
    "decode_attention": ("decode_attention", 1),
    "ssd_scan": ("ssd_scan (kernel 8)", 3),
}


def family(name: str) -> str:
    return next((lab for key, lab in FAMILIES if key in name.lower()),
                "other")


def kernel_families(torch, prof) -> tuple:
    """Device kernels of a profile by family: ({family: (launches, us)},
    {kernel name: (launches, us)} of the kernels in no family)."""
    kernels, other = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        name = family(e.name)
        n, tot = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, tot + us)
        if name == "other":
            n, tot = other.get(e.name, (0, 0.0))
            other[e.name] = (n + 1, tot + us)
    return kernels, other


def trace_mismatches(torch, prof, counts: dict) -> list:
    """The port's kernel families whose launches in the trace differ from
    the launch counters (``counts``, read just around the profiled work)
    times each wrapper's CUDA launches per call; a family's merges of a
    split key range count apart, at most one per call.  A trace that lost
    events shows here."""
    kernels, _ = kernel_families(torch, prof)
    merges = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "combine_splits" in e.name):
            merges[family(e.name)] = merges.get(family(e.name), 0) + 1
    want, calls = {}, {}
    for name, (fam, per) in TRACED.items():
        want[fam] = want.get(fam, 0) + counts[name] * per
        calls[fam] = calls.get(fam, 0) + counts[name]
    bad = []
    for fam in sorted(want):
        got = kernels.get(fam, (0, 0.0))[0] - merges.get(fam, 0)
        if got != want[fam] or merges.get(fam, 0) > calls[fam]:
            bad.append(f"{fam}: {got} launches (+{merges.get(fam, 0)} "
                       f"merges) in the trace, counters say {want[fam]}")
    return bad


def checked_trace(torch, label: str, take):
    """``take()`` profiles some work with the launch counters set to 0 just
    before it and read just after, and returns [(profile, counts), ...];
    each profile's families must agree with its counts
    (``trace_mismatches``).  On a mismatch the work is profiled once more,
    then the phase fails.  Returns the agreeing profiles."""
    for attempt in (1, 2):
        taken = take()
        bad = [b for prof, counts in taken
               for b in trace_mismatches(torch, prof, counts)]
        if not bad:
            n = sum(sum(counts[k] * per for k, (_, per) in TRACED.items())
                    for _, counts in taken)
            print(f"  {label}: the trace holds every counted launch of the "
                  f"port's kernels ({n})")
            return [prof for prof, _ in taken]
        print(f"  {label}: the trace disagrees with the launch counters: "
              + "; ".join(bad)
              + ("; profiling it again" if attempt == 1 else ""))
    fail(f"{label}: the trace disagreed with the launch counters twice")


@contextlib.contextmanager
def profiled_call(torch, ops, module, name: str, nth: int = 1):
    """Run the ``nth`` call of ``module.name`` (a function the engine
    looks up there at call time) alone under torch.profiler, between two
    device syncs, with the launch counters set to 0 just before it.
    Yields a dict that then holds ``prof``, the call's host ``wall_s``
    (profiler on), its ``args`` and the launch ``counts`` of the call."""
    from torch.profiler import ProfilerActivity, profile

    orig = getattr(module, name)
    box = {"calls": 0}

    def wrapped(*args, **kw):
        box["calls"] += 1
        if box["calls"] != nth:
            return orig(*args, **kw)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        ops.reset_launch_counts()
        prof.start()
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        box["wall_s"] = time.perf_counter() - t0
        prof.stop()
        box.update(prof=prof, args=(args, kw), counts=ops.launch_counts())
        return out

    setattr(module, name, wrapped)
    try:
        yield box
    finally:
        setattr(module, name, orig)


def decode_window(torch, box, label: str):
    """Print one profiled decode chunk (``profiled_call`` on
    ``policies.decode_chunk``); returns (launches per decode step,
    kernels by family)."""
    args, kw = box["args"]
    steps, slots = args[4], int(kw["active"].sum())
    kernels, _ = kernel_families(torch, box["prof"])
    busy = sum(us for _, us in kernels.values()) / 1e3
    n = sum(k for k, _ in kernels.values())
    wall = box["wall_s"] * 1e3
    print(f"  {label}: one decode chunk of {steps} steps, {slots} live "
          f"slots: wall {wall:.1f} ms (profiler on), device busy "
          f"{busy:.2f} ms = {busy / wall:.1%}; {n} kernel launches = "
          f"{n / steps:.0f} per decode step")
    for name, (k, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        print(f"    {name}: {us / 1e3:.3f} ms in {k} launches "
              f"({us / k:.1f} us each)")
    return n / steps, kernels


def phase_profile(torch, ops, label: str, serve_once, n_passes) -> None:
    """Profile one serve (``serve_once()`` returns its host wall seconds and
    ends in a device sync): device-busy share of the host wall time with
    the profiler off, kernel launches per forward pass (``n_passes()``
    after the run), and the kernels by device time; the trace is checked
    against the launch counters (``checked_trace``)."""
    from torch.profiler import ProfilerActivity, profile

    wall = serve_once()  # host clock, profiler off
    passes = n_passes()
    walls = []

    def take():
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            walls.append(serve_once())
        return [(prof, ops.launch_counts())]

    prof, = checked_trace(torch, label, take)
    wall_prof = walls[-1]
    kernels, other = kernel_families(torch, prof)
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    n_launch = sum(n for n, _ in kernels.values())
    print(f"  {label}: wall {wall * 1e3:.1f} ms with the profiler off "
          f"({wall_prof * 1e3:.1f} ms on), {passes} forward passes")
    if n_launch == 0:
        print("  device time not measured: the profiler saw no CUDA kernels")
        return
    print(f"  device busy {busy_ms:.1f} ms = {busy_ms / (wall * 1e3):.1%} of "
          f"the profiler-off wall; {n_launch} kernel launches "
          f"({n_launch / max(passes, 1):.0f} per forward pass)")
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        print(f"    {name}: {us / 1e3:.2f} ms in {n} launches "
              f"({us / 1e3 / busy_ms:.1%} of device time)")
    for name, (n, us) in sorted(other.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"      other: {name[:90]}: {us / 1e3:.2f} ms in {n}")


def profile_paged(torch, mods, res) -> float:
    """One more 2048-token request with 16 new tokens on the paged
    engine, then one decode chunk of a 300-token request alone; returns
    that chunk's launches per decode step."""
    import numpy as np

    eng, cfg = res["engine"], res["cfg"]
    prompt = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, 2048).astype(np.int32)

    def serve_once():
        req = mods["serving"].Request(uid=100, prompt=prompt,
                                      max_new_tokens=16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run([req])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def n_passes():
        c = eng.counts
        print(f"  prefill {c['prefill_chunks']} chunks "
              f"({c['prefill_s'] * 1e3:.1f} ms), decode {c['decode_steps']} "
              f"steps ({c['decode_s'] * 1e3:.1f} ms)")
        return c["prefill_chunks"] + c["decode_steps"]

    phase_profile(torch, mods["ops"], "paged continuous, one 2048-token "
                  "request", serve_once, n_passes)
    # one decode chunk alone: the step of every paged route decodes all
    # slots, live or not, so its launches do not depend on the live count
    boxes = []

    def take():
        req = mods["serving"].Request(uid=101, prompt=prompt[:300],
                                      max_new_tokens=24)
        with profiled_call(torch, mods["ops"], mods["policies"],
                           "decode_chunk", nth=2) as box:
            eng.run([req])
        check("prof" in box, "4a: the profiled decode chunk never ran")
        boxes.append(box)
        return [(box["prof"], box["counts"])]

    checked_trace(torch, "paged continuous, one decode chunk", take)
    per_step, _ = decode_window(torch, boxes[-1], "paged continuous")
    return per_step


def profile_evict(torch, mods, res, base_per_step) -> None:
    """Phase 4c on the decode-eviction engine of 3d.  Three more requests
    (300, 260 and 280 prompt tokens, 100 new), profiler off, through a
    twin engine without decode eviction (same weights, its own 256 MB
    pool) and through the 3d engine in turns, for the end-to-end cost of
    eviction on one trace, and through the twin one request at a time
    (does a step cost more with more live slots?); then through the 3d
    engine again with its eighth decode chunk (all three live) and its
    first sweep each run alone under the profiler; then one decode step
    of the 4-slot batch with and without the score leaf, and the score
    update of one layer, timed at the route's shape."""
    import numpy as np

    eng, cfg, sv = res["engine"], res["cfg"], mods["serving"]
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (300, 260, 280)]

    def serve(engine, together=True):
        """Serve the three requests at once (or one run each): host wall,
        decode ms/step, steps and chunks."""
        reqs = [sv.Request(uid=200 + i, prompt=p, max_new_tokens=100)
                for i, p in enumerate(prompts)]
        wall = dec_s = 0.0
        steps = chunks = 0
        for batch in ([reqs] if together else [[r] for r in reqs]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run(batch)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            c = engine.counts
            dec_s += c["decode_s"]
            steps += c["decode_steps"]
            chunks += c["decode_chunks"]
        return wall, dec_s / steps, steps, chunks

    twin = sv.ContinuousEngine(
        eng.params, cfg, eng.config.replace(
            decode_evict=sv.DecodeEvictionConfig(),
            kv_pool=sv.KVBlockPool(cfg, block_size=eng.pool.block_size,
                                   pool_mb=256, device="cuda")),
        lkv_params=eng.lkv_params, device="cuda")
    # in turns (without, with, with, without), then the twin serving the
    # requests one at a time (one live slot, as in 3a)
    for label, engine, together in (
            ("without eviction", twin, True), ("with eviction", eng, True),
            ("with eviction", eng, True), ("without eviction", twin, True),
            ("without eviction, one request at a time", twin, False)):
        wall, per, steps, chunks = serve(engine, together)
        print(f"  3 requests x 100 new tokens {label}: wall {wall:.2f} s; "
              f"decode {steps} steps in {chunks} chunks, "
              f"{per * 1e3:.1f} ms/step")
    del twin
    boxes = []

    def take():
        with profiled_call(torch, mods["ops"], mods["policies"],
                           "decode_chunk", nth=8) as dec, \
                profiled_call(torch, mods["ops"], mods["engine"],
                              "paged_sweep") as sw:
            serve(eng)
        check("prof" in dec, "4c: the profiled decode chunk never ran")
        check("prof" in sw, "4c: no sweep ran")
        boxes.append((dec, sw))
        return [(dec["prof"], dec["counts"]), (sw["prof"], sw["counts"])]

    checked_trace(torch, "paged decode-evict, a decode chunk and a sweep",
                  take)
    dec, sw = boxes[-1]
    per_step, kernels = decode_window(torch, dec, "paged decode-evict")
    print(f"  launches per decode step: {per_step:.0f} against "
          f"{base_per_step:.0f} on the paged route without eviction "
          f"(+{per_step - base_per_step:.0f}, "
          f"{(per_step - base_per_step) / cfg.num_layers:.1f} per layer)")
    n5, us5 = kernels.get("paged_decode_masses (kernel 5)", (0, 0.0))
    check(n5 > 0, "4c: kernel 5 did not run in the profiled decode chunk")
    print(f"  kernel 5 in the engine: {us5 / n5:.1f} us per launch")
    sk, _ = kernel_families(torch, sw["prof"])
    sweep_us = sum(us for _, us in sk.values())
    print(f"  one sweep (paged_sweep, 32 layers): device {sweep_us / 1e3:.3f}"
          f" ms in {sum(k for k, _ in sk.values())} launches, wall "
          f"{sw['wall_s'] * 1e3:.1f} ms (profiler on)")
    # the score update of one layer at the route's shape: the GQA mean of
    # kernel 5's masses, gated by the slots that wrote, added in place
    scoring = mods["scoring"]
    a = cfg.attn
    S, depth = eng.num_slots, eng._depth
    g = torch.Generator(device="cuda").manual_seed(SEED)
    masses = torch.rand((S, a.num_heads, depth), generator=g, device="cuda")
    score = torch.zeros((S, depth, a.num_kv_heads), device="cuda")
    ok = torch.ones((S,), dtype=torch.bool, device="cuda")
    upd = time_ms(torch, lambda: score.add_(scoring.decode_mass_update(
        masses, a.num_kv_heads, active=ok)), iters=50)
    print(f"  score update: {upd * 1e3:.1f} us per layer, "
          f"{upd * cfg.num_layers:.3f} ms per decode step")
    # one decode step of the 4-slot batch over 20 full blocks, with and
    # without the score leaf: host ms per step while the steps are only
    # enqueued, and with a device sync after every step
    tf = mods["tf"]
    nb = eng.pool.blocks_for(depth)
    pool = sv.KVBlockPool(cfg, block_size=eng.pool.block_size,
                          num_blocks=S * nb, device="cuda")
    pool.mask[:, 1:] = True  # every row valid; block 0 stays null
    table = torch.arange(1, S * nb + 1, dtype=torch.int32,
                         device="cuda").reshape(S, nb)
    tok = torch.zeros((S, 1), dtype=torch.int32, device="cuda")
    act = torch.ones((S,), dtype=torch.bool, device="cuda")
    score_all = torch.zeros((cfg.num_layers, S, depth, a.num_kv_heads),
                            device="cuda")

    def time_steps(scored: bool, sync_each: bool, n: int = 12) -> float:
        tree = dict(pool.tree(), score=score_all) if scored \
            else pool.tree()
        cache = {"attn": {"table": table}, "pool": tree,
                 "cursor": torch.full((S,), depth - 20, dtype=torch.int32,
                                      device="cuda"),
                 "next_pos": torch.full((S, 1), 4000, dtype=torch.int32,
                                        device="cuda")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tf.decode_step(eng.params, cfg, tok, cache, active=act,
                           paged_depth=depth)
            if sync_each:
                torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t_host / n * 1e3

    time_steps(True, False, 2)  # warm
    for sync_each in (False, True):
        t = {False: [], True: []}
        for scored in (False, True, True, False):
            t[scored].append(time_steps(scored, sync_each))
        how = "synced after each" if sync_each else "enqueue only"
        print(f"  decode step, 4 slots x {depth} rows ({how}): "
              f"{sum(t[False]) / 2:.2f} ms without the score leaf, "
              f"{sum(t[True]) / 2:.2f} ms with it "
              f"(runs {t[False]} / {t[True]})")


def profile_lockstep(torch, mods, res) -> float:
    """One more lockstep batch (4 x 2048 tokens, 32 new) on the engine of
    3b (llama3-8b) or of 3g (hymba-1.5b).  Returns the TTFT of its first
    serve, which runs with the profiler off on a warm engine."""
    import numpy as np

    eng, cfg = res["engine"], res["cfg"]
    prompts = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (4, 2048)).astype(np.int32)
    ttfts = []

    def serve_once():
        reqs = [mods["serving"].Request(uid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        ttfts.append(reqs[0].ttft_s)
        return time.perf_counter() - t0

    phase_profile(torch, mods["ops"], f"{cfg.name} lockstep, one batch of "
                  "4 x 2048 tokens", serve_once,
                  lambda: 1 + eng.max_new_tokens)
    return ttfts[0]


def warm_ttft(torch, mods, eng, vocab: int) -> float:
    """The TTFT of one more lockstep batch (4 x 2048 tokens, ids below
    ``vocab``, 32 new) on an engine that has served once: the first serve
    of a process's prefill shapes pays one-time costs (allocations, GEMM
    kernels loaded at first use) that a second does not."""
    import numpy as np

    prompts = np.random.default_rng(SEED + 8).integers(
        0, vocab, (4, 2048)).astype(np.int32)
    reqs = [mods["serving"].Request(uid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    eng.serve(reqs)
    torch.cuda.synchronize()
    return reqs[0].ttft_s


def load_modules(torch) -> dict:
    """The port's modules this script drives (from ``src/`` beside it)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch import serving
    from repro_torch.common.config import EvictionConfig
    from repro_torch.core import lookahead, policies, scoring
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import chunk_attention as ck
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import lookahead_score as lk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.serving import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dict(configs=configs, serving=serving, lookahead=lookahead,
                policies=policies, scoring=scoring, engine=engine,
                EvictionConfig=EvictionConfig, ops=ops,
                build=build, ref=ref, ck=ck, lk=lk, pk=pk, fk=fk, dk=dk,
                sk=sk, serve=serve, tf=tf)


def phase_build(mods) -> None:
    build = mods["build"]
    print(f"phase 0: build ({build.BUILD_DIR})", flush=True)
    t0 = time.perf_counter()
    report = build.build(verbose=True)
    for name, (secs, log) in report.items():
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln.lower()]
        print(f"  {name}: nvcc {secs:.1f} s; " + " | ".join(regs[:12]))
    print(f"  build {time.perf_counter() - t0:.1f} s "
          f"({len(report)} compiled, {len(build.SOURCES) - len(report)} "
          "cached)", flush=True)
    # the Hopper tile (attention_sm90.cuh) must run on wgmma and TMA: HGMMA
    # and UTMALDG in the SASS of each of its instantiations (kernel 7's
    # eight: causal or not, hd 64 or 128, with or without its key mask,
    # kernel 1's and kernel 2's first launch at hd 64 and 128, and
    # kernel 2's column_masses_sm90), and neither they nor the merges of a
    # split key range (combine_splits, kernel 1's and kernel 2's at hd 64
    # and 128, plain loads and stores) may spill.  The spills come from
    # this build's -Xptxas -v: a library built by an earlier run is built
    # again, so the check always reads the code it holds.
    lib = build._target("chunk_attention")
    if "chunk_attention" not in report:
        lib.unlink()
        report.update(build.build(("chunk_attention",), verbose=True))
        print(f"  chunk_attention: rebuilt for its register report, nvcc "
              f"{report['chunk_attention'][0]:.1f} s", flush=True)
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(lib)], capture_output=True, text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    funcs = {f.split(chr(10))[0].strip(): f
             for f in sass.stdout.split("Function : ")[1:]
             if f.startswith("_ZN4sm90")}
    merges = {name for name in funcs if "combine_splits" in name[:40]}
    tiles = {name: f for name, f in funcs.items() if name not in merges}
    ptxas = ptxas_report(report["chunk_attention"][1])
    for name in sorted(funcs):
        check(name in ptxas, f"{demangle(name)}: no -Xptxas -v entry")
        regs, spills = ptxas[name]
        what = ""
        if name in tiles:
            hg, tma = funcs[name].count("HGMMA"), funcs[name].count("UTMALDG")
            check(hg > 0 and tma > 0, f"{demangle(name)} has no HGMMA or no "
                  "UTMALDG in its SASS")
            what = f"{hg} HGMMA, {tma} UTMALDG; "
        print(f"  {demangle(name)}: {what}{regs} registers, {spills} bytes "
              "spilled")
        check(not spills, f"{demangle(name)} spills registers")
    for group, wanted in ((tiles, {"flash_attention_tag": 8,
                                   "chunk_attention_tag": 2,
                                   "chunk_masses_tag": 2,
                                   "column_masses_sm90": 2}),
                          (merges, {"chunk_attention_tag": 2,
                                    "chunk_masses_tag": 2})):
        for part, n in wanted.items():
            got = sum(part in name for name in group)
            check(got == n, f"{got} instantiations of the Hopper tile name "
                  f"{part} in the SASS, expected {n}")
        check(len(group) == sum(wanted.values()), f"{len(group)} Hopper "
              f"instantiations in the SASS, expected {sum(wanted.values())}")
    # kernels 4 and 5 (decode_split.cuh; 2 kernels x 2 types x hd 32 / 64 /
    # 128), kernel 6 on the same routine (2 types x 3 hd), kernel 3's
    # tensor-core kernels (launches (a) and (b), bf16, 3 hd) and kernel 8's
    # (launches (a) and (c), bf16, 3 hd x 5 d_state): every
    # instantiation of these kernels' names in the source's -Xptxas -v
    # report must be one of these, each of these must be there, and none
    # may spill; a library built by an earlier run is built again for the
    # report
    hds = (32, 64, 128)
    for source, kernels, wanted in (
            ("paged_attention", ("paged_decode_kernel",
                                 "paged_masses_kernel"),
             {f"{kern}<{t}, hd {d}>" for kern in (
                 "paged_decode_kernel", "paged_masses_kernel")
              for t in ("float", "bf16") for d in hds}),
            ("decode_attention", ("decode_kernel",),
             {f"decode_kernel<{t}, hd {d}>"
              for t in ("float", "bf16") for d in hds}),
            ("lookahead_score", ("obs_row_stats_mma", "obs_column_means_mma"),
             {f"{kern}<hd {d}>" for kern in (
                 "obs_row_stats_mma", "obs_column_means_mma")
              for d in hds}),
            ("ssd_scan", ("ssd_chunk_states_mma", "ssd_chunk_scan_mma"),
             {f"{kern}<hd {d}, ds {n}>" for kern in (
                 "ssd_chunk_states_mma", "ssd_chunk_scan_mma")
              for d in (16, 32, 64) for n in (8, 16, 32, 64, 128)})):
        if source not in report:
            build._target(source).unlink()
            report.update(build.build((source,), verbose=True))
            print(f"  {source}: rebuilt for its register report, nvcc "
                  f"{report[source][0]:.1f} s", flush=True)
        ptxas = ptxas_report(report[source][1])
        found = {demangle(name): name for name in ptxas
                 if any(kern in name for kern in kernels)}
        check(set(found) == wanted, f"{source}: kernels without a -Xptxas "
              f"-v entry: {sorted(wanted - set(found))}; unexpected: "
              f"{sorted(set(found) - wanted)}")
        for label in sorted(found):
            regs, spills = ptxas[found[label]]
            print(f"  {label}: {regs} registers, {spills} bytes spilled")
            check(not spills, f"{label} spills registers")


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: (registers, spilled bytes stored + loaded)}
    from the ``-Xptxas -v`` output of one nvcc run."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], 0
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", ln)):
            spill = int(m[1]) + int(m[2])
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out[name] = (int(m[1]), spill)
            name = None
    return out


def demangle(name: str) -> str:
    """A Hopper tile, decode, lookahead-score or SSD-scan instantiation's
    kernel and template arguments."""
    m = re.search(r"(flash_attention_tag|chunk_attention_tag|"
                  r"chunk_masses_tag)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)ELb(\d)",
                  name)
    if m:
        return (f"attention_sm90<{m[1]}, hd {m[2]}, causal {m[3]}, "
                f"stats {m[4]}, split {m[5]}, masked {m[6]}>")
    m = re.search(r"combine_splitsI.*?(chunk_attention_tag|"
                  r"chunk_masses_tag)E?Li(\d+)E", name)
    if m:
        return f"combine_splits<{m[1]}, hd {m[2]}>"
    m = re.search(r"(paged_decode_kernel|paged_masses_kernel|decode_kernel)"
                  r"I(f|13__nv_bfloat16)Li(\d+)EE", name)
    if m:
        t = "float" if m[2] == "f" else "bf16"
        return f"{m[1]}<{t}, hd {m[3]}>"
    m = re.search(r"(obs_row_stats_mma|obs_column_means_mma)ILi(\d+)E", name)
    if m:
        return f"{m[1]}<hd {m[2]}>"
    m = re.search(r"(ssd_chunk_states_mma|ssd_chunk_scan_mma)ILi(\d+)ELi"
                  r"(\d+)E", name)
    if m:
        return f"{m[1]}<hd {m[2]}, ds {m[3]}>"
    m = re.search(r"column_masses_sm90ILi(\d+)E", name)
    return f"column_masses_sm90<hd {m[1]}>" if m else name


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    mods = load_modules(torch)
    kind = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()

    def header(text: str) -> None:  # a phase's title and the time so far
        print(f"{text} [{time.perf_counter() - t_all:.0f} s]", flush=True)

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}")
    phase_build(mods)

    header("phase 1: kernels against their plain versions (bfloat16)")
    kernels = phase_kernels(torch, mods)

    header("phase 2: engines on the card vs on the CPU (llama3-8b smoke, "
           "float32)")
    phase_engine_parity(torch, mods)
    header("phase 2: the SSM archs on the card vs on the CPU (hymba-smoke, "
           "mamba2-smoke, float32)")
    phase_ssm_parity(torch, mods)

    # each other policy's cell runs just before the lookaheadkv cell of
    # its route, so that no profiler phase comes between the two that are
    # compared (host times drift within a call)
    letters = dict(zip(ROUTES, "abcdefgik"))
    pairs = (("paged continuous h2o", "paged continuous"),
             ("dense-slot continuous pyramidkv", "dense-slot continuous"))
    order = ("paged continuous h2o", "paged continuous", "lockstep",
             "lockstep laq", "dense-slot continuous pyramidkv",
             "dense-slot continuous", "paged decode-evict",
             "bucketed continuous full", "hybrid lockstep")
    counts, base_per_step, chunk_ms, ttft, warm = {}, None, {}, {}, {}
    for route in order:
        arch = "hymba-1.5b" if route == "hybrid lockstep" else "llama3-8b"
        header(f"phase 3{letters[route]}: serve {arch} at full width, "
               f"{route}")
        counts[route], res = phase_serve(torch, mods, route)
        if "lockstep" in route:
            ttft[route] = res["done"][0].ttft_s
        if route == "bucketed continuous full":
            counts["masked flash"] = res["masked_flash"]
        c = getattr(res["engine"], "counts", {})
        if c.get("prefill_chunks"):
            chunk_ms[route] = c["prefill_s"] / c["prefill_chunks"] * 1e3
        for new, base in pairs:
            if route == base:
                print(f"  prefill ms per 256-row chunk: {new} "
                      f"{chunk_ms[new]:.1f} (3{letters[new]}) against "
                      f"{chunk_ms[base]:.1f} for lookaheadkv "
                      f"(3{letters[base]}), run one after the other")
        if route == "paged continuous":
            header("phase 4a: where the time goes (torch.profiler)")
            base_per_step = profile_paged(torch, mods, res)
        elif route == "lockstep":
            header("phase 4b: where the time goes (torch.profiler)")
            warm["lockstep"] = profile_lockstep(torch, mods, res)
        elif route == "paged decode-evict":
            header("phase 4c: where the time goes (torch.profiler)")
            profile_evict(torch, mods, res, base_per_step)
        elif route == "hybrid lockstep":
            header("phase 4d: where the time goes (torch.profiler)")
            profile_lockstep(torch, mods, res)
        elif route == "lockstep laq":
            warm[route] = warm_ttft(torch, mods, res["engine"],
                                    res["cfg"].vocab_size)
            header("phase 3j: serve llama3-8b at full width, lockstep "
                   "speckv (tiny-llama draft) on 3i's weights")
            counts["lockstep speckv"], ttft["lockstep speckv"], \
                warm["lockstep speckv"] = phase_speckv(torch, mods, res)
            names = ("lockstep", "lockstep laq", "lockstep speckv")
            for what, got in (("first serve", ttft),
                              ("warm (a second serve)", warm)):
                print(f"  TTFT, host clock, 4 x 2048 tokens, {what} "
                      "(sightings, not claims): " + "; ".join(
                          f"{name} {got[name] * 1e3:.1f} ms "
                          f"({got[name] / got['lockstep']:.2f}x "
                          "lookaheadkv)" for name in names))
        del res  # free this route's weights before the next one's
        torch.cuda.empty_cache()
    header("phase 3h: mamba2-130m at full width, prefill and decode")
    counts["mamba2"] = phase_mamba(torch, mods)
    # launches on the main path: kernels 1, 3, 4 from the paged route,
    # kernels 7 and 6 from the lockstep route, kernel 5 from the
    # decode-eviction route, kernel 2 from the h2o route, kernel 8 from
    # the hybrid lockstep route
    route_of = {"flash_attention": "lockstep",
                "decode_attention": "lockstep",
                "paged_decode_masses": "paged decode-evict",
                "chunk_attention_masses": "paged continuous h2o",
                "ssd_scan": "hybrid lockstep"}
    for k in kernels:
        if k["name"] == "flash_attention masked":  # 3k's padded group
            k["launches"] = counts["masked flash"]
            continue
        k["launches"] = counts[route_of.get(k["name"],
                                            "paged continuous")][k["name"]]
    print(f"total {time.perf_counter() - t_all:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
