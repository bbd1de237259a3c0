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
    # the hybrid hymba-1.5b (attention and Mamba-2 heads): lockstep only
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --budget 256 --requests 4 --n-in 2048 --max-new 32

Weights (and, for ``lookaheadkv`` only, lookahead modules) are drawn at
random from ``--seed`` (fine for plumbing and speed; quality needs trained
modules, ROADMAP A9).  The flags are those of the JAX launcher; the ones
whose feature the port does not serve yet raise ``NotImplementedError``
naming their ROADMAP item.  Both routes evict with ``EvictionConfig(
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
``decode_step``).  ``--device cpu`` runs the plain PyTorch versions of
the kernels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import policies
from repro_torch.core.lookahead import init_lookahead_params
from repro_torch.models import transformer as tf
from repro_torch.serving import (BucketedEngine, ChunkingConfig,
                                 ContinuousEngine, DecodeEvictionConfig,
                                 KVBlockPool, Request, ServingConfig,
                                 ServingEngine)

# flag -> (value meaning "off", ROADMAP item of the feature)
_UNPORTED = {
    "prefix_cache_mb": (0, "prefix cache: ROADMAP A7"),
    "shared_prefix": (0, "shared-prefix traffic: ROADMAP A7"),
    "mesh_model": (1, "a device mesh: ROADMAP A11"),
    "lkv_ckpt": ("", "lookahead checkpoints: ROADMAP A9"),
    "metrics_json": ("", "metrics: ROADMAP A12"),
    "prom_snapshot": ("", "metrics: ROADMAP A12"),
    "trace_out": ("", "tracing: ROADMAP A12"),
}


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
                    help="continuous: comma-separated prompt lengths "
                         "(overrides --requests/--n-in)")
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
    ap.add_argument("--prefix-cache-mb", type=int, default=0)
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--decode-evict", action="store_true",
                    help="continuous: decoding-stage eviction; with "
                         "--kv-pool-mb sweeps re-evict each cache to the "
                         "budget every --decode-evict-interval rows, "
                         "freeing blocks mid-generation; dense slot caches "
                         "keep a small fixed margin and evict per step")
    ap.add_argument("--decode-evict-interval", type=int, default=64,
                    help="rows of decode growth between eviction sweeps "
                         "(paged pool)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--lkv-ckpt", default="")
    ap.add_argument("--metrics-json", default="")
    ap.add_argument("--prom-snapshot", default="")
    ap.add_argument("--trace-out", default="")
    args = ap.parse_args(argv)
    for name, (off, what) in _UNPORTED.items():
        if getattr(args, name) != off:
            raise NotImplementedError(f"--{name.replace('_', '-')}: not "
                                      f"ported yet: {what}")
    if args.prompt_lens and not args.continuous:
        raise ValueError("--prompt-lens needs --continuous: a lockstep "
                         "batch shares one prompt length (--n-in)")
    return args


def _streamable(args) -> bool:
    """Whether the arguments select the chunked ``ContinuousEngine``."""
    return (args.continuous and args.policy not in policies.MULTI_PASS
            and args.policy != "full")


def build_engine(args, cfg, params, lkv):
    """The engine the JAX launcher builds for these arguments: lockstep
    ``ServingEngine`` without ``--continuous`` (which, as in JAX, does not
    take ``--decode-evict``); with it, ``BucketedEngine`` for the policies
    that cannot stream (``full``, ``laq``, ``speckv``; it takes neither
    ``--kv-pool-mb`` nor ``--decode-evict``), else ``ContinuousEngine``
    over the paged pool (``--kv-pool-mb``) or over dense slot caches."""
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
                           pool_mb=args.kv_pool_mb, device=args.device)
    sc = ServingConfig(
        policy=args.policy, evict=evict,
        chunking=ChunkingConfig(chunk=args.chunk,
                                max_context=max(args.n_in, args.chunk)),
        decode_evict=DecodeEvictionConfig(
            enabled=args.decode_evict, interval=args.decode_evict_interval),
        num_slots=args.slots, max_new_tokens=args.max_new, eos_id=-1,
        kv_pool=pool)
    return ContinuousEngine(params, cfg, sc, lkv_params=lkv,
                            device=args.device)


def run(argv=None) -> dict:
    """Build the model and engine from the command line, serve the
    requests and return {"args", "cfg", "engine", "done", "wall_s",
    "peak_bytes"}."""
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.uses_attention:
        raise ValueError(
            f"{cfg.name} has no attention KV cache, so no eviction policy "
            "and no lookahead module applies and no engine serves it; run "
            "it through transformer.prefill(want_ssm_cache=True) and "
            "decode_step")
    if args.kv_pool_mb and not _streamable(args):
        print("note: --kv-pool-mb requires the chunked continuous engine "
              "(--continuous with a streamable policy); ignoring it")
        args.kv_pool_mb = 0
    params = tf.init_params(cfg, seed=args.seed, device=args.device)
    lkv = None
    if args.policy == "lookaheadkv":
        gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        lkv = init_lookahead_params(gen, cfg, params["layers"])

    rng = np.random.default_rng(args.seed)
    if not args.continuous:
        lens = [args.n_in] * args.requests
    elif args.prompt_lens:
        lens = [int(n) for n in args.prompt_lens.split(",")]
    else:
        lens = rng.integers(args.n_in // 2, args.n_in + 1,
                            args.requests).tolist()
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(n)).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i, n in enumerate(lens)]
    eng = build_engine(args, cfg, params, lkv)
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
    return {"args": args, "cfg": cfg, "engine": eng, "done": done,
            "wall_s": wall,
            # peak device bytes while serving (weights included)
            "peak_bytes": torch.cuda.max_memory_allocated() if on_card
            else None}


def main(argv=None) -> None:
    res = run(argv)
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
    c = eng.counts
    print(f"peak concurrency {c['max_concurrency']}; decode "
          f"{c['decode_steps']} steps in {c['decode_s']:.3f}s")
    if getattr(eng, "pool", None) is not None:
        s = eng.pool.stats()
        print(f"kv pool: {s['blocks_total']} x {s['block_size']}-row blocks "
              f"({s['bytes_total'] / 1e6:.2f} MB), high water "
              f"{s['high_water_blocks']} blocks, peak concurrency "
              f"{c['max_concurrency']}, {c['preemptions']} preemptions")
        if eng.decode_evict.enabled:
            print(f"decode eviction: {c['decode_evict_sweeps']} sweeps "
                  f"reclaimed {s['blocks_reclaimed_decode']} blocks "
                  f"mid-generation")


if __name__ == "__main__":
    main()
