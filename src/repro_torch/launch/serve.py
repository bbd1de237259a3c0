"""Serving launcher of the port: KV-cache eviction under any single-pass
policy (LookaheadKV by default) through the engine the JAX launcher picks
for the same command line.

    # lockstep (ServingEngine): --requests prompts of --n-in tokens each
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --budget 256 --requests 4 --n-in 2048 --max-new 32
    # continuous batching over dense slot caches (no --kv-pool-mb)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --continuous --budget 256 --chunk 256 --slots 4 \
        --prompt-lens 1024,2048,3072,4000 --max-new 32
    # continuous batching over the paged KV pool
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --continuous --kv-pool-mb 256 --budget 256 --chunk 256 --slots 4 \
        --prompt-lens 1024,2048,3072,4000 --max-new 32
    # ... with decode-time eviction: sweeps every 64 rows of growth
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --continuous --kv-pool-mb 256 --decode-evict \
        --decode-evict-interval 64 --budget 256 --chunk 256 --slots 4 \
        --prompt-lens 1024,2048,3072,4000 --max-new 192
    # another policy: h2o, snapkv, pyramidkv, tova, streaming_llm, random
    # on every route
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --continuous --kv-pool-mb 256 --policy h2o --budget 256 \
        --chunk 256 --slots 4 --prompt-lens 1024,2048,3072,4000 --max-new 32
    # the draft-based LAQ on the lockstep route
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --policy laq --budget 256 --requests 4 --n-in 2048 --max-new 32
    # --continuous with full, laq or speckv: the bucket-padded
    # BucketedEngine (one padded group at bucket 1024 here)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --continuous --policy full --budget 256 --slots 4 \
        --prompt-lens 512,700,900,1024 --max-new 32
    # a 1024-token system prompt shared by every request, served from the
    # radix-trie prefix cache (pinned in the pool; hits skip its chunks)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --continuous --kv-pool-mb 2048 --prefix-cache-mb 1024 \
        --shared-prefix 1024 --budget 256 --chunk 256 --slots 4 \
        --prompt-lens 1024,2048,2048,3008 --n-in 4096 --max-new 32
    # the hybrid hymba-1.5b (attention and Mamba-2 heads): lockstep only
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --budget 256 --requests 4 --n-in 2048 --max-new 32
    # the MoE deepseek-moe-16b (every route; phi3.5-moe-42b-a6.6b too)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --continuous --kv-pool-mb 512 \
        --budget 256 --chunk 256 --slots 4 \
        --prompt-lens 1024,2048,3072,4000 --max-new 32

Weights (and, for ``lookaheadkv`` only, lookahead modules) are drawn at
random from ``--seed`` (fine for plumbing and speed); ``--lkv-ckpt``
loads trained modules instead, on every route (a checkpoint of either
package's trainer, ``launch/train.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --lkv-ckpt experiments/ckpt/train_lkv.npz --budget 256 \
        --requests 4 --n-in 1024 --max-new 8

The flags are those of the JAX launcher.  ``--mesh-model N`` serves one
model tensor-parallel over N model shards on the chunked continuous
route: it spawns N ranks (``torch.multiprocessing``, start method
``spawn``), over NCCL with rank r on ``cuda:r`` when there are at least N
cards, else over gloo with every rank on ``cuda:0`` (or on the CPU with
``--device cpu``), and prints which.  Each rank draws the seeded weights
in turn and keeps its shard (``common.sharding.serving_specs``); rank 0
prints the results and writes the three files below.  As in the JAX
launcher, the flag is ignored with a note off the chunked route, heads
that do not divide N serve on a single device, and ``--decode-evict``
with a pool is ignored under a mesh:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --continuous --kv-pool-mb 256 --budget 256 --chunk 256 --slots 4 \
        --prompt-lens 1024,2048,3072,4000 --max-new 32 --mesh-model 2

As in the JAX launcher, the chunked continuous
route always serves traced (a ``TraceRecorder``, so its timers are
device-synced) and prints the per-request phase table;
``--metrics-json``, ``--prom-snapshot`` and ``--trace-out`` (``.jsonl``:
raw events, else Chrome trace-event JSON) write the engine's registry
and trace there, and print the JAX launcher's note on the other routes:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --continuous --kv-pool-mb 256 --budget 256 --chunk 256 --slots 4 \
        --prompt-lens 1024,2048,3072,4000 --max-new 32 \
        --metrics-json m.json --prom-snapshot m.prom --trace-out t.json
  ``--shared-prefix N`` plants one random
system prompt of N tokens, rounded down to whole chunks, before every
``--continuous`` prompt (drawn before the prompt lengths, as the JAX
launcher draws it; with ``--prompt-lens``, the port's own flag, the
listed lengths are the tails after it); ``--prefix-cache-mb`` gives the
chunked ``ContinuousEngine`` a ``PrefixCache`` of that budget, pinned in
the pool under ``--kv-pool-mb``.  Both print the JAX launcher's notes
where the route does not take them.  The JAX launcher has no sampling
flag, and neither has this one (``ServingConfig(sampling=...)``).  Both routes evict with ``EvictionConfig(
budget, draft_len=8)``, as the JAX launcher's do.  ``--continuous`` with
``full``, ``laq`` or ``speckv`` builds a ``BucketedEngine`` (those
policies cannot stream) and ignores ``--kv-pool-mb`` with the JAX
launcher's note.  Neither launcher passes a draft model, so ``--policy
speckv`` fails on every route with "speckv needs a draft model" when the
first prefill runs, where the JAX launcher's assert does.
As in the JAX launcher, ``--decode-evict`` acts on the continuous routes
only (the lockstep route does not take it), and the SSM archs have no
continuous route: ``--continuous`` raises for hymba-1.5b, and the
attention-free mamba2-130m, which has no KV cache to evict, raises on
every route (its path is ``transformer.prefill(want_ssm_cache=True)`` and
``decode_step``).  The chunked continuous routes raise for the M-RoPE
qwen2-vl-72b, which the lockstep and the bucketed routes serve, as in
JAX.  ``--device cpu`` runs the plain PyTorch versions of
the kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.common.pytree import tree_bytes
from repro_torch.common.sharding import (serving_cache_specs,
                                         serving_specs, shard_bounds,
                                         shard_tree)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import policies
from repro_torch.core.lookahead import (init_lookahead_params,
                                        load_lookahead_params)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, spawn_ranks
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import transformer as tf
from repro_torch.obs import TraceRecorder, phase_table
from repro_torch.serving import (BucketedEngine, ChunkingConfig,
                                 ContinuousEngine, DecodeEvictionConfig,
                                 KVBlockPool, PrefixCache, Request,
                                 ServingConfig, ServingEngine)

def _print_phase_table(trace, done) -> None:
    """Per-request phase-latency breakdown from the span trace: where
    each request's TTFT went (the JAX launcher's table)."""
    rows = phase_table(trace, [r.uid for r in done])
    print(f"{'uid':>4s} {'pfx_skip':>8s} {'prefill_ms':>10s} "
          f"{'first_tok_ms':>12s} {'decode_ms':>9s} {'sweeps':>6s} "
          f"{'sweep_ms':>8s} {'replays':>7s} {'outcome':>9s}")
    for row in rows:
        if row["outcome"] == "missing":
            print(f"{row['uid']:4d} {'never admitted':>14s}")
            continue
        ft = (f"{row['first_token_ms']:12.1f}"
              if row["first_token_ms"] is not None else f"{'n/a':>12s}")
        print(f"{row['uid']:4d} {row['prefix_skip_tokens']:8d} "
              f"{row['prefill_ms']:10.1f} {ft} {row['decode_ms']:9.1f} "
              f"{row['sweeps']:6d} {row['sweep_ms']:8.1f} "
              f"{row['replays']:7d} {row['outcome']:>9s}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="lookaheadkv")
    ap.add_argument("--budget", type=int, default=16)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--n-in", type=int, default=96,
                    help="lockstep: every prompt's length; continuous: "
                         "prompt lengths are drawn from [n_in/2, n_in]")
    ap.add_argument("--prompt-lens", default="",
                    help="continuous: comma-separated prompt lengths, "
                         "after the shared prefix (overrides "
                         "--requests/--n-in)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the chunked ContinuousEngine "
                         "(default: the lockstep ServingEngine)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk size")
    ap.add_argument("--kv-pool-mb", type=float, default=0,
                    help="continuous: paged KV pool size in MB (0: dense "
                         "slot caches)")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prefix-cache-mb", type=int, default=0,
                    help="radix-trie prompt-cache budget in MB (chunked "
                         "continuous engine; 0 disables prefix reuse)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of a shared system-prompt prefix planted "
                         "in every continuous request (rounded down to "
                         "whole chunks)")
    ap.add_argument("--decode-evict", action="store_true",
                    help="continuous: decoding-stage eviction; with "
                         "--kv-pool-mb sweeps re-evict each cache to the "
                         "budget every --decode-evict-interval rows, "
                         "freeing blocks mid-generation; dense slot caches "
                         "keep a small fixed margin and evict per step")
    ap.add_argument("--decode-evict-interval", type=int, default=64,
                    help="rows of decode growth between eviction sweeps "
                         "(paged pool)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel shards: serve one sharded model "
                         "over a (data, model) mesh of that many ranks "
                         "(continuous engine; 1 = single device)")
    ap.add_argument("--lkv-ckpt", default="")
    ap.add_argument("--metrics-json", default="",
                    help="write the engine's typed-metrics registry as a "
                         "JSON snapshot to this path after the run "
                         "(chunked continuous engine)")
    ap.add_argument("--prom-snapshot", default="",
                    help="write the registry in Prometheus text exposition "
                         "format to this path after the run")
    ap.add_argument("--trace-out", default="",
                    help="write the per-request span trace here: a .jsonl "
                         "path gets raw events, anything else Chrome "
                         "trace-event JSON (open in https://ui.perfetto.dev)")
    args = ap.parse_args(argv)
    if args.prompt_lens and not args.continuous:
        raise ValueError("--prompt-lens needs --continuous: a lockstep "
                         "batch shares one prompt length (--n-in)")
    return args


def _streamable(args) -> bool:
    """Whether the arguments select the chunked ``ContinuousEngine``."""
    return (args.continuous and args.policy not in policies.MULTI_PASS
            and args.policy != "full")


def mesh_model(args, cfg, say=print) -> int:
    """The model shards ``--mesh-model`` gives on this route, with the JAX
    launcher's notes: 1 off the chunked continuous route or where the
    heads do not divide it."""
    n = args.mesh_model
    if n <= 1:
        return 1
    a = cfg.attn
    if not _streamable(args):
        say("note: --mesh-model requires the chunked continuous engine "
            "(--continuous with a streamable policy); ignoring it")
        return 1
    if a is None or a.num_kv_heads % n or a.num_heads % n:
        heads = None if a is None else (a.num_heads, a.num_kv_heads)
        say(f"note: --mesh-model {n} does not divide {args.arch}'s (q, kv) "
            f"heads {heads}; serving single-device")
        return 1
    return n


def mesh_backend(device: str, n: int) -> str:
    """NCCL with one card per rank, else gloo (ranks sharing a card, or
    the CPU), whose collectives go through the host."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int, n: int) -> str:
    """Rank r's device: ``cuda:r`` with at least n cards, else ``cuda:0``
    for every rank (made current); the CPU as it is."""
    if torch.device(device).type != "cuda":
        return device
    idx = rank if torch.cuda.device_count() >= n else 0
    torch.cuda.set_device(idx)
    return f"cuda:{idx}"


def init_shard(cfg, mesh, *, seed: int, device) -> dict:
    """This rank's shard of the seeded weights: the ranks of the world
    draw the full tree in turn and keep their shard, so that at most one
    full tree is on a shared card at a time."""
    specs = serving_specs(cfg, mesh)
    shard = None
    for r in range(mesh.size):
        if r == mesh.rank:
            full = tf.init_params(cfg, seed=seed, device=device)
            shard = shard_tree(full, specs, mesh, mesh.rank)
            del full
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier(group=mesh.world)
    return shard


def job_params(job: dict, cfg, mesh, device) -> dict:
    """A job's weights on ``device``: the JAX package's numpy tree
    "params" (the rank's shard over ``mesh``), else drawn from "seed"."""
    if job.get("params") is not None:
        return (bridge.to_torch(job["params"], device=device)
                if mesh is None else
                bridge.shard_to_torch(job["params"], cfg, mesh,
                                      device=device))
    if mesh is None:
        return tf.init_params(cfg, seed=job["seed"], device=device)
    return init_shard(cfg, mesh, seed=job["seed"], device=device)


def build_engine(args, cfg, params, lkv, mesh=None):
    """The engine the JAX launcher builds for these arguments: lockstep
    ``ServingEngine`` without ``--continuous`` (which, as in JAX, does not
    take ``--decode-evict``); with it, ``BucketedEngine`` for the policies
    that cannot stream (``full``, ``laq``, ``speckv``; it takes neither
    ``--kv-pool-mb`` nor ``--decode-evict``), else ``ContinuousEngine``
    over the paged pool (``--kv-pool-mb``) or over dense slot caches,
    always traced (its ``trace``, a fresh ``TraceRecorder``)."""
    evict = EvictionConfig(budget=args.budget, draft_len=8)
    if not args.continuous:
        return ServingEngine(params, cfg, policy=args.policy, evict=evict,
                             lkv_params=lkv, max_new_tokens=args.max_new,
                             eos_id=-1, device=args.device)
    if not _streamable(args):
        return BucketedEngine(params, cfg, policy=args.policy, evict=evict,
                              lkv_params=lkv, num_slots=args.slots,
                              max_new_tokens=args.max_new, eos_id=-1,
                              device=args.device)
    pool = None
    if args.kv_pool_mb:
        pool = KVBlockPool(cfg, block_size=args.kv_block_size,
                           pool_mb=args.kv_pool_mb, device=args.device,
                           mesh=mesh)
    prefix_cache = None
    if args.prefix_cache_mb:
        # with a pool, cached prefixes pin pool blocks (one copy, shared
        # with decode) instead of holding a second device copy
        prefix_cache = PrefixCache(chunk=args.chunk,
                                   max_bytes=args.prefix_cache_mb << 20,
                                   pool=pool)
    sc = ServingConfig(
        policy=args.policy, evict=evict,
        chunking=ChunkingConfig(chunk=args.chunk,
                                max_context=max(args.n_in, args.chunk)),
        decode_evict=DecodeEvictionConfig(
            # decode-time eviction on the pool is single-device (JAX)
            enabled=args.decode_evict and (pool is None or mesh is None),
            interval=args.decode_evict_interval),
        num_slots=args.slots, max_new_tokens=args.max_new, eos_id=-1,
        kv_pool=pool, prefix_cache=prefix_cache, mesh=mesh,
        # span tracing is always on for the chunked engine: it is the
        # per-request latency attribution this launcher reports
        trace=TraceRecorder())
    return ContinuousEngine(params, cfg, sc, lkv_params=lkv,
                            device=args.device)


def write_artifacts(args, eng) -> None:
    """``--metrics-json``, ``--prom-snapshot`` and ``--trace-out``: the
    chunked continuous engine's registry and trace (the deprecated
    engines predate both: the JAX launcher's notes)."""
    metrics = getattr(eng, "metrics", None)
    trace = getattr(eng, "trace", None)
    if args.metrics_json:
        if metrics is None:
            print("note: --metrics-json needs the chunked continuous "
                  "engine; skipped")
        else:
            metrics.to_json(args.metrics_json)
            print(f"metrics snapshot -> {args.metrics_json}")
    if args.prom_snapshot:
        if metrics is None:
            print("note: --prom-snapshot needs the chunked continuous "
                  "engine; skipped")
        else:
            with open(args.prom_snapshot, "w") as f:
                f.write(metrics.prometheus_text())
            print(f"prometheus snapshot -> {args.prom_snapshot}")
    if args.trace_out:
        if trace is None:
            print("note: --trace-out needs the chunked continuous "
                  "engine; skipped")
        elif args.trace_out.endswith(".jsonl"):
            trace.to_jsonl(args.trace_out)
            print(f"span trace (jsonl) -> {args.trace_out}")
        else:
            trace.to_chrome(args.trace_out)
            print(f"span trace (perfetto) -> {args.trace_out}")


def run(argv=None, mesh=None) -> dict:
    """Build the model and engine from the command line, serve the
    requests, write the ``--metrics-json`` / ``--prom-snapshot`` /
    ``--trace-out`` files and return {"args", "cfg", "engine", "done",
    "wall_s", "peak_bytes"}.  With ``mesh`` (one rank of ``main``'s
    world), the rank's shard, on the rank's device; rank 0 writes the
    files."""
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.uses_attention:
        raise ValueError(
            f"{cfg.name} has no attention KV cache, so no eviction policy "
            "and no lookahead module applies and no engine serves it; run "
            "it through transformer.prefill(want_ssm_cache=True) and "
            "decode_step")
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder arch: no engine passes its "
            "frame embeddings (the JAX launcher asserts 'whisper needs "
            "frame embeddings' here); run it through "
            "policies.run_eviction(..., encoder_embeds=frames) and "
            "greedy_decode, or transformer.prefill and decode_step")
    if args.prefix_cache_mb and not _streamable(args):
        print("note: --prefix-cache-mb requires the chunked continuous "
              "engine (--continuous with a streamable policy); ignoring it")
        args.prefix_cache_mb = 0
    if args.shared_prefix and not args.continuous:
        print("note: --shared-prefix shapes --continuous traffic only; "
              "ignoring it")
    if args.kv_pool_mb and not _streamable(args):
        print("note: --kv-pool-mb requires the chunked continuous engine "
              "(--continuous with a streamable policy); ignoring it")
        args.kv_pool_mb = 0
    n = mesh_model(args, cfg)
    if mesh is not None and args.kv_pool_mb and args.decode_evict:
        print("note: decode-time eviction on the paged pool is "
              "single-device; ignoring --decode-evict under --mesh-model")
    if mesh is None:
        if n > 1:
            raise ValueError(f"--mesh-model {n} serves from {n} ranks: "
                             "run main(), which spawns them")
        params = tf.init_params(cfg, seed=args.seed, device=args.device)
    else:
        if n != mesh.shape["model"]:
            raise ValueError(f"a mesh of {mesh.shape} for --mesh-model {n}")
        args.device = rank_device(args.device, mesh.rank, n)
        params = init_shard(cfg, mesh, seed=args.seed, device=args.device)
    # the lookahead modules take the layers' shapes only
    layers = tf.init_params(cfg, device="meta")["layers"]
    lkv = None
    if args.lkv_ckpt and cfg.technique_applies and cfg.lookahead:
        lkv = load_lookahead_params(args.lkv_ckpt, cfg, layers,
                                    device=args.device)
        print(f"loaded lookahead modules from {args.lkv_ckpt}")
    elif args.policy == "lookaheadkv":
        gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        lkv = init_lookahead_params(gen, cfg, layers)

    # the JAX launcher's draws: on the continuous route the system prompt
    # first (a zero-length draw leaves the stream as it is), then the
    # lengths, then each prompt's own tokens
    rng = np.random.default_rng(args.seed)
    shared = (args.shared_prefix // args.chunk) * args.chunk \
        if args.continuous else 0
    system = rng.integers(0, cfg.vocab_size, shared).astype(np.int32)
    if not args.continuous:
        lens = [args.n_in] * args.requests
    elif args.prompt_lens:
        lens = [int(n) for n in args.prompt_lens.split(",")]
    else:
        lens = rng.integers(args.n_in // 2, args.n_in + 1,
                            args.requests).tolist()
    reqs = [Request(uid=i,
                    prompt=np.concatenate([system, rng.integers(
                        0, cfg.vocab_size, int(n)).astype(np.int32)]),
                    max_new_tokens=args.max_new)
            for i, n in enumerate(lens)]
    eng = build_engine(args, cfg, params, lkv, mesh)
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = eng.serve(reqs) if isinstance(eng, ServingEngine) \
        else eng.run(reqs)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mesh is None or mesh.rank == 0:
        write_artifacts(args, eng)
    return {"args": args, "cfg": cfg, "engine": eng, "done": done,
            "wall_s": wall,
            # peak device bytes while serving (weights included)
            "peak_bytes": torch.cuda.max_memory_allocated() if on_card
            else None}


def serve_job(job: dict, *, mesh=None, device=None) -> dict:
    """Serve one ``ContinuousEngine`` run in this process: ``job`` holds
    "cfg", "device", "serving" (a ``ServingConfig`` without pool or mesh),
    "requests", "pool" (None or ``KVBlockPool`` keywords), optionally
    "prefix_cache" (``PrefixCache`` keywords but the chunk, bound to the
    pool where there is one) and "mesh_model" (``serve_shard``), and the
    weights as the JAX package's full numpy trees "params" / "lkv"
    (``bridge``), or a "seed" to draw them from (the launcher's draws).
    Over ``mesh`` (one rank of a world, on ``device``) the rank's shard.
    Returns the served requests in finish order, the engine's ``stats``
    and ``counts``, the kernel launches, peak device bytes and wall
    seconds of the run, the bytes of the rank's weights, the slots its
    data row decodes ([start, stop), or None: all of them), and the
    rank's place on the mesh."""
    cfg, sc = job["cfg"], job["serving"]
    device = device or job["device"]
    params = job_params(job, cfg, mesh, device)
    lkv = None
    if sc.policy == "lookaheadkv":
        if job.get("lkv") is not None:
            lkv = bridge.to_torch(job["lkv"], device=device)
        else:
            gen = torch.Generator(device=device).manual_seed(job["seed"] + 1)
            lkv = init_lookahead_params(
                gen, cfg, tf.init_params(cfg, device="meta")["layers"])
    pool = None
    if job.get("pool") is not None:
        pool = KVBlockPool(cfg, device=device, mesh=mesh, **job["pool"])
    pc = None
    if job.get("prefix_cache") is not None:
        pc = PrefixCache(chunk=sc.chunking.chunk, pool=pool,
                         **job["prefix_cache"])
    eng = ContinuousEngine(params, cfg, sc.replace(kv_pool=pool, mesh=mesh,
                                                   prefix_cache=pc),
                           lkv_params=lkv, device=device)
    del params
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run([copy.deepcopy(r) for r in job["requests"]])
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        stats = dict(eng.stats)
    return {"done": done, "stats": stats, "counts": dict(eng.counts),
            "launches": ops.launch_counts(), "wall_s": wall,
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if on_card else None),
            "param_bytes": tree_bytes(eng.params),
            "decode_slots": (None if eng._split is None else
                             [eng._split.start, eng._split.stop]),
            "model_index": 0 if mesh is None else mesh.model_index,
            "data_index": 0 if mesh is None else mesh.data_index}


def serve_shard(rank: int, job: dict) -> dict:
    """One rank of a tensor-parallel ``serve_job``, for ``spawn_ranks``:
    the world's ("data", "model") mesh with ``job["mesh_model"]`` model
    shards (by default the whole world, one data row), on the rank's
    device (``rank_device``)."""
    n = dist.get_world_size()
    return serve_job(job, mesh=make_host_mesh(model=job.get("mesh_model",
                                                             n)),
                     device=rank_device(job["device"], rank, n))


def serve_shards(rank: int, jobs: list) -> list:
    """``serve_shard`` over several jobs in one world, in order."""
    return [serve_shard(rank, job) for job in jobs]


def requested_bytes(device):
    """The bytes of this process's live tensors on the card, as their
    callers asked for them (the caching allocator's ``requested_bytes``,
    no rounding to its blocks); None off the card."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.init()  # the allocator reports nothing before it
    return torch.cuda.memory_stats(device)["requested_bytes.all.current"]


def fill_frozen_rows(cache: dict, cfg, batch: int, capacity: int, *,
                     seed: int, mesh=None) -> dict:
    """Fill a split cache's frozen K/V with draws from a generator seeded
    by ``seed`` and the layer (standard normals in the cache's type), in
    place, as a cache already holding ``capacity`` tokens: each layer's
    full (batch, capacity, KV, hd) draw is made on the cache's device and
    the rank keeps its block (``sharding.serving_cache_specs``), so every
    layout of the same seed holds the same rows.  Returns ``cache``."""
    a = cfg.attn
    k = cache["attn"]["k"]
    full = (batch, capacity, a.num_kv_heads, a.head_dim)
    bounds = None
    if mesh is not None and k.shape[1:] != full:
        spec = serving_cache_specs(cfg, mesh, batch, capacity,
                                   cache["attn"]["hot_k"].shape[2])
        bounds = shard_bounds(full, spec["attn"]["k"][1:], mesh, mesh.rank)
    gen = torch.Generator(device=k.device)
    for layer in range(k.shape[0]):
        for i, name in enumerate(("k", "v")):
            gen.manual_seed(seed * 1_000_003 + 2 * layer + i)
            x = torch.randn(full, generator=gen, device=k.device,
                            dtype=torch.float32).to(k.dtype)
            if bounds is not None:
                for d, (start, size) in enumerate(bounds):
                    x = x.narrow(d, start, size)
            cache["attn"][name][layer].copy_(x)
    return cache


def split_decode_job(job: dict, *, mesh=None, device=None) -> dict:
    """Greedy split-cache decode of ``job``: "cfg", "device", "batch",
    "capacity" (frozen rows, all valid), "hot_slots", "steps", the first
    "token" (batch, 1) int array, the weights as the JAX package's numpy
    tree "params" or a "seed" to draw them from, and the frozen rows as
    the JAX package's numpy split cache "cache" or a "cache_seed"
    (``fill_frozen_rows``).  With "forced" (batch, steps) tokens, step
    t + 1 takes ``forced[:, t]`` as its input in place of step t's argmax
    (teacher forcing, so that two runs compare step by step).  Over
    ``mesh``, the rank's shards (``serving_specs``,
    ``serving_cache_specs``).  Returns the argmax tokens (batch, steps),
    the float32 logits (steps, batch, V), the kernel launches, the seconds
    of the steps, the bytes of the rank's weights and cache, and on the
    card the bytes the caching allocator's live tensors rose by while the
    two were built (``requested_bytes``, None off the card)."""
    from repro_torch.launch.analysis import tensor_bytes

    cfg = job["cfg"]
    device = device or job["device"]
    B, C, hot = job["batch"], job["capacity"], job["hot_slots"]
    before = requested_bytes(device)
    params = job_params(job, cfg, mesh, device)
    if job.get("cache") is not None:
        cache = bridge.decode_cache_to_torch(job["cache"], device=device,
                                             cfg=cfg, mesh=mesh,
                                             hot_slots=hot)
    else:
        cache = tf.init_decode_cache(cfg, B, C, fill_len=C, hot_slots=hot,
                                     device=device, mesh=mesh)
        fill_frozen_rows(cache, cfg, B, C, seed=job["cache_seed"],
                         mesh=mesh)
    alloc = None if before is None else requested_bytes(device) - before
    token = torch.as_tensor(job["token"], dtype=torch.int32, device=device)
    forced = job.get("forced")
    if forced is not None:
        forced = torch.as_tensor(forced, dtype=torch.int32, device=device)
    if mesh is not None and token.shape[0] != cache["next_pos"].shape[0]:
        n = cache["next_pos"].shape[0]  # this data row's batch rows
        rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
        token = token[rows]
        forced = None if forced is None else forced[rows]
    step = make_decode_step(cfg, mesh=mesh)
    toks, logits = [], []
    ops.reset_launch_counts()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(job["steps"]):
            lg, cache = step(params, token, cache)
            token = lg.argmax(-1)[:, None].to(torch.int32)
            toks.append(token[:, 0])
            logits.append(lg.float())
            if forced is not None:
                token = forced[:, t:t + 1].contiguous()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"tokens": torch.stack(toks, 1).cpu().numpy(),
            "logits": torch.stack(logits).cpu().numpy(),
            "launches": ops.launch_counts(), "seconds": secs,
            "param_bytes": tensor_bytes(params),
            "cache_bytes": tensor_bytes(cache), "alloc_bytes": alloc,
            "data_index": 0 if mesh is None else mesh.data_index,
            "model_index": 0 if mesh is None else mesh.model_index}


def split_decode_shard(rank: int, job: dict) -> dict:
    """One rank of ``split_decode_job`` for ``launch.mesh.spawn_ranks``:
    the world's ("data", "model") mesh with ``job["mesh_model"]`` model
    shards (by default the whole world), on the rank's device."""
    n = dist.get_world_size()
    return split_decode_job(
        job, mesh=make_host_mesh(model=job.get("mesh_model", n)),
        device=rank_device(job["device"], rank, n))


def _cli_rank(rank: int, argv) -> None:
    """One rank of ``main``'s world: serve on the rank's shard; only rank
    0 prints."""
    mesh = make_host_mesh(model=dist.get_world_size())
    with contextlib.ExitStack() as stack:
        if rank:
            sink = stack.enter_context(open(os.devnull, "w"))
            stack.enter_context(contextlib.redirect_stdout(sink))
        report(run(argv, mesh=mesh))


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    n = mesh_model(args, cfg, say=lambda *_: None)
    if n == 1:
        report(run(argv))
        return
    backend = mesh_backend(args.device, n)
    place = ("one card per rank" if backend == "nccl" else
             "every rank on cuda:0" if torch.device(args.device).type
             == "cuda" else f"every rank on {args.device}")
    print(f"mesh: {{'data': 1, 'model': {n}}} over {n} spawned ranks "
          f"({backend}, {place})")
    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_cli_rank, n, (argv if argv is not None
                                   else sys.argv[1:],),
                    init_file=os.path.join(tmp, "store"), backend=backend,
                    timeout_s=600.0)


def report(res: dict) -> None:
    """Print a run's results (the JAX launcher's lines)."""
    args, eng, done = res["args"], res["engine"], res["done"]
    cb = eng.cache_bytes(args.n_in)
    print(f"{type(eng).__name__}"
          f"{' (paged)' if getattr(eng, 'pool', None) is not None else ''}: "
          f"policy={args.policy} budget={args.budget} "
          f"requests={len(done)} ttft={done[0].ttft_s * 1e3:.1f}ms "
          f"wall={res['wall_s']:.2f}s cache_ratio={cb['ratio']:.1f}x "
          f"({cb['full'] / 1e3:.0f}KB -> {cb['evicted'] / 1e3:.0f}KB per "
          f"req) on {args.device}")
    for r in sorted(done, key=lambda r: r.uid):
        print(f"  req {r.uid}: prompt {len(r.prompt)} ttft "
              f"{r.ttft_s * 1e3:.1f}ms {len(r.out_tokens)} tokens "
              f"{r.out_tokens[:8]}...")
    if isinstance(eng, ServingEngine):
        return
    if getattr(eng, "trace", None) is not None:
        # where each request's latency went, phase by phase
        _print_phase_table(eng.trace, done)
    c = eng.counts
    print(f"peak concurrency {c['max_concurrency']}; decode "
          f"{c['decode_steps']} steps in {c['decode_s']:.3f}s")
    if getattr(eng, "prefix_cache", None) is not None:
        p = eng.prefix_cache.stats()
        prompt_tokens = sum(len(r.prompt) for r in done)
        print(f"prefix cache: hit-rate "
              f"{p['hits'] / max(p['hits'] + p['misses'], 1):.2f}, "
              f"{p['tokens_hit']}/{prompt_tokens} prompt tokens "
              f"served from shared prefixes, "
              f"{p['bytes'] / 1e6:.2f} MB resident")
    if getattr(eng, "pool", None) is not None:
        s = eng.pool.stats()
        print(f"kv pool: {s['blocks_total']} x {s['block_size']}-row blocks "
              f"({s['bytes_total'] / 1e6:.2f} MB), high water "
              f"{s['high_water_blocks']} blocks, peak concurrency "
              f"{c['max_concurrency']}, {c['preemptions']} preemptions, "
              f"{s['blocks_pinned_prefix']} blocks pinned by the prefix "
              f"cache")
        if eng.decode_evict.enabled:
            print(f"decode eviction: {c['decode_evict_sweeps']} sweeps "
                  f"reclaimed {s['blocks_reclaimed_decode']} blocks "
                  f"mid-generation")


if __name__ == "__main__":
    main()
