#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (an H100).

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
kernel's plain version):

0. Build the CUDA kernels from ``src/repro_torch/csrc/`` with nvcc for
   sm_90a into ``build/repro_torch/`` (one nvcc per source, all at once;
   rebuilt when a source's hash changes).
1. Hold each kernel against its plain PyTorch version on the card, in
   bfloat16, at the shapes of the main path (llama3-8b: H=32, KV=8,
   hd=128; chunk 256 and the 32-row observation pass over a 4096-deep
   buffer; paged decode of 4 slots, block size 16, 19 blocks) and on edge
   cases (K not a multiple of the tile, windows, masked rows and heads,
   ragged tables with null blocks), within a tolerance that is a fixed
   fraction of the plain result's largest magnitude.  Time kernel, plain
   version and, where one PyTorch call computes the same function, that
   call (library_ms), each call on a cold L2.
2. Serve 3 requests through the port's engine on the llama3-8b smoke
   config in float32, once on the card and once on the CPU: the greedy
   tokens must be identical.
3. Serve 4 requests (prompts of 1024, 2048, 3072 and 4000 tokens, 32 new
   tokens each) through ``repro_torch.launch.serve`` at the full width of
   llama3-8b (random weights and lookahead modules from the seed):
   policy lookaheadkv, budget 256, chunk 256, 4 slots, block size 16,
   --kv-pool-mb 256.  Every kernel must have launched in this run.
4. Profile one more 2048-token request on that engine with torch.profiler:
   device-busy share, launches, and device time by kernel family.

Output: per-phase lines, then a JSON line of per-kernel numbers, the
card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM rate and dense peak by operand type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SEED = 0


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
    version's result: the attention outputs of random inputs shrink as
    1/sqrt(visible keys), so a fixed number would be as large as the
    outputs at a 4096-deep buffer and let a wrong kernel through."""
    return rel * float(want.float().abs().max())


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(torch, mods) -> list:
    import torch.nn.functional as F

    ck, lk, pk, ref = (mods[n] for n in ("ck", "lk", "pk", "ref"))
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)
    # tolerances relative to the largest magnitude of the plain result:
    # chunk attention feeds its tensor cores P rounded to bf16 (2^-9
    # relative per term) and rounds the output once: 4 bf16 ulps (2^-5);
    # paged decode accumulates in float32 on CUDA cores and rounds the
    # output once: 1 ulp (2^-7); lookahead scores are float32 throughout
    # (float32 eps 2^-23, logits of a few units through exp): 2^-16
    REL_CHUNK, REL_PAGED, REL_SCORE = 2 ** -5, 2 ** -7, 2 ** -16
    H, KV, hd = 32, 8, 128
    G = H // KV
    itemsize = 2

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    results = []

    # -- kernel 1: chunk attention ------------------------------------------
    def chunk_case(B, C, K, off, window, label, timed=False):
        q, k, v = randn(B, C, H, hd), randn(B, K, KV, hd), randn(B, K, KV, hd)
        got = ck.chunk_attention(q, k, v, q_offset=off, window=window)
        torch.cuda.synchronize()
        want = ref.chunk_attention(q, k, v, q_offset=off, window=window)
        err, tol = max_err(got, want), tolerance(want, REL_CHUNK)
        print(f"  chunk_attention {label}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e} = 2^-5 max|plain|)")
        check(err <= tol, f"chunk_attention {label}: err {err} > {tol}")
        if not timed:
            return None
        ms = time_ms(torch, lambda: ck.chunk_attention(
            q, k, v, q_offset=off, window=window))
        plain = time_ms(torch, lambda: ref.chunk_attention(
            q, k, v, q_offset=off, window=window), iters=5)
        # one library call computing the same function: SDPA with an
        # explicit mask (kv heads expanded and the mask built outside)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        qpos = off + torch.arange(C, device=dev)
        kpos = torch.arange(K, device=dev)
        mask = kpos[None, :] <= qpos[:, None]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        vis = torch.clamp(qpos + 1, max=K).sum().item()
        n_ops = 4 * hd * H * B * vis
        n_bytes = itemsize * (2 * B * C * H * hd
                              + 2 * B * min(K, off + C) * KV * hd)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        print(f"  chunk_attention {label}: {ms:.4f} ms, plain {plain:.4f} "
              f"ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)

    main1 = chunk_case(1, 256, 4096, 3840, None, "C=256 K=4096 off=3840",
                       timed=True)
    chunk_case(1, 32, 4096, 4000, None, "obs pass C=32 off=4000")
    chunk_case(1, 256, 1000, 700, None, "K=1000 (ragged tile)")
    chunk_case(2, 64, 700, 500, 128, "window 128")
    results.append(dict(
        name="chunk_attention", route="cuda",
        source="src/repro_torch/csrc/chunk_attention.cu",
        replaces="src/repro/kernels/chunk_attention.py:95", **main1))

    # -- kernel 3: lookahead scores --------------------------------------------
    def score_case(B, n_obs, Sk, n_prompt, off, window, masks, label,
                   timed=False):
        q, k = randn(B, n_obs, H, hd), randn(B, Sk, KV, hd)
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
        print(f"  lookahead_score {label}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e} = 2^-16 max|plain|)")
        check(err <= tol, f"lookahead_score {label}: err {err} > {tol}")
        if masks:
            check(bool(torch.all(got[-1] == 0)),
                  "lookahead_score: invalid rows must give exact zeros")
        if not timed:
            return None
        ms = time_ms(torch, lambda: lk.lookahead_score(q, k, n_prompt, **kw))
        plain = time_ms(torch, lambda: ref.lookahead_score(q, k, n_prompt,
                                                           **kw), iters=5)
        vis_keys = min(Sk, off + n_obs)
        n_ops = 2 * hd * H * B * sum(min(Sk, off + i + 1)
                                     for i in range(n_obs))
        n_bytes = (itemsize * (B * n_obs * H * hd + B * vis_keys * KV * hd)
                   + 4 * B * H * n_prompt)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        print(f"  lookahead_score {label}: {ms:.4f} ms, plain {plain:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    main3 = score_case(1, 32, 4096, 4096, 4000, None, False,
                       "n_obs=32 Sk=4096 off=4000", timed=True)
    score_case(2, 32, 1000, 968, None, None, True,
               "kv_mask+row_valid Sk=1000")
    score_case(2, 40, 700, 700, 640, 96, True, "window 96, 2 row tiles")
    results.append(dict(
        name="lookahead_score", route="cuda",
        source="src/repro_torch/csrc/lookahead_score.cu",
        replaces="src/repro/kernels/lookahead_score.py:87", **main3))

    # -- kernel 4: paged decode --------------------------------------------------
    def paged_case(label, window, timed=False, edge=False):
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
        new_pos = torch.full((B,), 4032, dtype=torch.int32, device=dev)
        kw = dict(pos_pool=pos, new_pos=new_pos, window=window)
        got = pk.paged_decode_attention(q, kp, vp, mask, table, **kw)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention(q, kp, vp, mask, table, **kw)
        err, tol = max_err(got, want), tolerance(want, REL_PAGED)
        print(f"  paged_decode_attention {label}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e} = 2^-7 max|plain|)")
        check(err <= tol, f"paged_decode_attention {label}: err {err} > "
              f"{tol}")
        if edge:
            check(bool(torch.all(got[2] == 0)),
                  "paged decode: an all-null table must give exact zeros")
            check(bool(torch.all(got[3, 5 * G:6 * G] == 0)),
                  "paged decode: a fully masked head must give exact zeros")
        if not timed:
            return None
        ms = time_ms(torch, lambda: pk.paged_decode_attention(
            q, kp, vp, mask, table, **kw), iters=50)
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
        print(f"  paged_decode_attention {label}: {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {rows_valid} valid rows of {B * S * KV})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)

    main4 = paged_case("B=4 bs=16 nb=19", None, timed=True)
    paged_case("ragged, null slot, masked head", None, edge=True)
    paged_case("window 64", 64, edge=True)
    results.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:101", **main4))
    return results


# ---------------------------------------------------------------------------
# phase 2: the engine on the card against the engine on the CPU
# ---------------------------------------------------------------------------


def phase_engine_parity(torch, mods) -> None:
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(mods["configs"].get_smoke_config("llama3-8b"),
                              dtype="float32")
    tf, sv = mods["tf"], mods["serving"]
    params = tf.init_params(cfg, seed=SEED, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    lkv = mods["lookahead"].init_lookahead_params(gen, cfg, params["layers"])
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 23, 45)]
    out = {}
    for device in ("cuda", "cpu"):
        def move(tree):
            return {k: move(v) if isinstance(v, dict) else v.to(device)
                    for k, v in tree.items()}

        sc = sv.ServingConfig(
            evict=mods["EvictionConfig"](budget=16),
            chunking=sv.ChunkingConfig(chunk=32, max_context=70),
            num_slots=2, max_new_tokens=8, eos_id=-1,
            kv_pool=sv.KVBlockPool(cfg, block_size=16, num_blocks=32,
                                   device=device),
            capture_admission=True)
        eng = sv.ContinuousEngine(move(params), cfg, sc, lkv_params=move(lkv),
                                  device=device)
        done = eng.run([sv.Request(uid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts)])
        out[device] = {r.uid: r for r in done}
    same_kept = 0
    for uid, r in out["cpu"].items():
        got = out["cuda"][uid]
        print(f"  uid {uid}: cuda {got.out_tokens} cpu {r.out_tokens}")
        check(got.out_tokens == r.out_tokens,
              f"engine parity: uid {uid} tokens differ between card and CPU")
        same_kept += int(all(
            np.array_equal(got.admission_cache[k], r.admission_cache[k])
            for k in ("mask", "pos")))
    print(f"  greedy tokens identical for {len(out['cpu'])} requests; "
          f"admission kept sets identical for {same_kept}")
    check(same_kept == len(out["cpu"]),
          "engine parity: admission kept sets differ between card and CPU")


# ---------------------------------------------------------------------------
# phase 3: full-width serve
# ---------------------------------------------------------------------------


def phase_serve(torch, mods) -> dict:
    ops = mods["ops"]
    lens = (1024, 2048, 3072, 4000)
    argv = ["--arch", "llama3-8b", "--seed", str(SEED), "--policy",
            "lookaheadkv", "--budget", "256", "--chunk", "256", "--slots",
            "4", "--kv-block-size", "16", "--kv-pool-mb", "256",
            "--prompt-lens", ",".join(map(str, lens)), "--max-new", "32",
            "--device", "cuda"]
    ops.reset_launch_counts()
    res = mods["serve"].run(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    eng, done = res["engine"], res["done"]
    check(len(done) == len(lens), "serve: not every request finished")
    for r in sorted(done, key=lambda r: r.uid):
        check(len(r.out_tokens) == 32, f"serve: uid {r.uid} emitted "
              f"{len(r.out_tokens)} tokens")
        check(all(0 <= t < res["cfg"].vocab_size for t in r.out_tokens),
              f"serve: uid {r.uid} emitted a token outside the vocab")
        print(f"  uid {r.uid}: prompt {len(r.prompt)} ttft "
              f"{r.ttft_s * 1e3:.1f} ms, first tokens {r.out_tokens[:6]}")
    c = eng.counts
    dec_tokens = sum(len(r.out_tokens) - 1 for r in done)
    print(f"  wall {res['wall_s']:.2f} s; prefill {c['prefill_chunks']} "
          f"chunks in {c['prefill_s']:.2f} s "
          f"({c['prefill_s'] / c['prefill_chunks'] * 1e3:.1f} ms/chunk); "
          f"decode {c['decode_steps']} steps ({dec_tokens} tokens) in "
          f"{c['decode_s']:.2f} s "
          f"({c['decode_s'] / c['decode_steps'] * 1e3:.1f} ms/step) = "
          f"{dec_tokens / c['decode_s']:.1f} tokens/s; peak concurrency "
          f"{c['max_concurrency']}")
    print(f"  peak torch.cuda.max_memory_allocated while serving "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; kv pool "
          f"high water {eng.pool.stats()['high_water_blocks']} of "
          f"{eng.pool.usable_blocks} blocks")
    print(f"  kernel launches in this run: {counts}")
    for name, n in counts.items():
        check(n > 0, f"serve: kernel {name} was never launched")
    return counts, res


# ---------------------------------------------------------------------------
# phase 4: where the time goes (torch.profiler over one more request)
# ---------------------------------------------------------------------------


def phase_profile(torch, mods, res) -> None:
    """Profile one 2048-token request with 16 new tokens on the phase-3
    engine: device-busy share of the host wall time, kernel launches per
    prefill chunk and per decode step, and the kernels by device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    eng, cfg = res["engine"], res["cfg"]
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(0, cfg.vocab_size, 2048).astype(np.int32)

    def serve_one():
        req = mods["serving"].Request(uid=100, prompt=prompt,
                                      max_new_tokens=16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run([req])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = serve_one()  # host clock, profiler off
    c = dict(eng.counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = serve_one()
    families = (("chunk_attention", "chunk_attention"),
                ("obs_", "lookahead_score"),
                ("paged_decode", "paged_decode_attention"),
                ("gemm", "GEMM (cuBLAS)"), ("nvjet", "GEMM (cuBLAS)"),
                ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"))
    kernels, other = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        label = next((lab for key, lab in families if key in e.name.lower()),
                     "other")
        n, tot = kernels.get(label, (0, 0.0))
        kernels[label] = (n + 1, tot + us)
        if label == "other":
            n, tot = other.get(e.name, (0, 0.0))
            other[e.name] = (n + 1, tot + us)
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    n_launch = sum(n for n, _ in kernels.values())
    print(f"  wall {wall * 1e3:.1f} ms with the profiler off "
          f"({wall_prof * 1e3:.1f} ms on) for {c['prefill_chunks']} prefill "
          f"chunks ({c['prefill_s'] * 1e3:.1f} ms) + {c['decode_steps']} "
          f"decode steps ({c['decode_s'] * 1e3:.1f} ms)")
    if n_launch == 0:
        print("  device time not measured: the profiler saw no CUDA kernels")
        return
    print(f"  device busy {busy_ms:.1f} ms = {busy_ms / (wall * 1e3):.1%} of "
          f"the profiler-off wall; {n_launch} kernel launches "
          f"({n_launch / max(c['prefill_chunks'] + c['decode_steps'], 1):.0f}"
          " per forward pass)")
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        print(f"    {name}: {us / 1e3:.2f} ms in {n} launches "
              f"({us / 1e3 / busy_ms:.1%} of device time)")
    for name, (n, us) in sorted(other.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"      other: {name[:90]}: {us / 1e3:.2f} ms in {n}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch import serving
    from repro_torch.common.config import EvictionConfig
    from repro_torch.core import lookahead
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import chunk_attention as ck
    from repro_torch.kernels import lookahead_score as lk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    mods = dict(configs=configs, serving=serving, lookahead=lookahead,
                EvictionConfig=EvictionConfig, ops=ops, ref=ref, ck=ck,
                lk=lk, pk=pk, serve=serve, tf=tf)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}")
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

    print("phase 1: kernels against their plain versions (bfloat16)",
          flush=True)
    kernels = phase_kernels(torch, mods)

    print("phase 2: engine on the card vs on the CPU (llama3-8b smoke, "
          "float32)", flush=True)
    phase_engine_parity(torch, mods)

    print("phase 3: serve llama3-8b at full width", flush=True)
    counts, res = phase_serve(torch, mods)

    print("phase 4: where the time goes (one 2048-token request, "
          "torch.profiler)", flush=True)
    phase_profile(torch, mods, res)
    for k in kernels:
        k["launches"] = counts[k["name"]]
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
