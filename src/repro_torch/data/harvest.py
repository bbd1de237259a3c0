"""Trace-harvested gt_oracle distillation dataset (the data half of the
paper's learning loop).

The serving engine cannot run the ``gt_oracle`` policy online — it scores a
prompt's keys with the *future* response's queries.  But every retired
request carries exactly that future: the tokens the engine just generated.
``HarvestWriter`` therefore rides the engine's retirement hook
(``ServingConfig.harvest``): for each retired request it records
``(prompt X, generated continuation Y)`` and replays ``[X; Y]`` through the
frozen model's scoring pass (``objective.gt_scores``), yielding the
per-(layer, q-head) gt importance of X's keys under Y's real queries —
the distillation targets of paper §3.2, harvested from live traffic
instead of a synthetic mixture.

On-disk layout: ``<out_dir>/shard_NNNNN.npz`` with per-record members
``x{i}`` (n_in,) int32, ``y{i}`` (n_obs,) int32, ``s{i}`` (L, H, n_in)
f32 and a record count ``n``.  ``HarvestIterator`` groups records by
prompt length and yields fixed-shape batches for
``launch/train.py --harvest``.

The shard format is the JAX package's, so a dataset harvested by either
package trains the other.  On the card the serve runs the port's kernels
(kernel 2 for h2o's prefill chunks, kernel 6 for the dense slots' decode)
and every record's oracle pass kernels 7 and 3 (``objective.gt_scores``).

CLI — replay a Zipf-prefix / Poisson-arrival trace through the continuous
engine with the hook installed::

    PYTHONPATH=src python -m repro_torch.data.harvest --arch llama3-8b \
        --smoke --device cpu --out experiments/harvest --requests 32
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.core import objective


@dataclass(frozen=True)
class HarvestConfig:
    out_dir: str
    max_obs: int = 32  # observation rows kept per record (generated tokens)
    min_obs: int = 1  # skip requests that generated fewer tokens
    shard_records: int = 64  # records buffered per npz shard


class HarvestWriter:
    """Engine capture hook: buffers retired requests, computes gt_oracle
    targets one record at a time on the device of ``params``, and writes
    npz shards.

    Call ``flush()`` after ``engine.run(...)`` to drain the tail buffer.
    """

    def __init__(self, params: dict, cfg: ModelConfig, hcfg: HarvestConfig):
        self.params, self.cfg, self.hcfg = params, cfg, hcfg
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []
        self._shard = 0
        self.records_written = 0
        os.makedirs(hcfg.out_dir, exist_ok=True)
        # never clobber an existing dataset: append after its last shard
        existing = sorted(glob.glob(os.path.join(hcfg.out_dir,
                                                 "shard_*.npz")))
        if existing:
            self._shard = int(os.path.basename(existing[-1])[6:11]) + 1

    # -- engine hook ---------------------------------------------------------
    def on_retire(self, req) -> None:
        y = np.asarray(req.out_tokens[: self.hcfg.max_obs], np.int32)
        if y.size < self.hcfg.min_obs:
            return
        self._pending.append((np.asarray(req.prompt, np.int32), y))
        if len(self._pending) >= self.hcfg.shard_records:
            self.flush()

    # -- gt scoring ----------------------------------------------------------
    def gt_record(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """(L, H, n_in) f32 gt_oracle scores of ``x``'s keys under ``y``'s
        queries: the frozen-model oracle pass over ``[x; y]``."""
        dev = self.params["embed"].device
        xy = torch.as_tensor(np.concatenate([x, y]), device=dev)[None]
        s = objective.gt_scores(self.params, self.cfg, xy, len(x))
        return s[:, 0].float().cpu().numpy()  # (L, 1, H, n_in) -> (L, H, n)

    def flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        records = [(x, y, self.gt_record(x, y)) for x, y in pending]
        path = os.path.join(self.hcfg.out_dir,
                            f"shard_{self._shard:05d}.npz")
        arrays: dict = {"n": np.asarray(len(records), np.int64)}
        for i, (x, y, s) in enumerate(records):
            arrays[f"x{i}"], arrays[f"y{i}"], arrays[f"s{i}"] = x, y, s
        np.savez(path, **arrays)
        self._shard += 1
        self.records_written += len(records)


# -- dataset reading ---------------------------------------------------------


def load_records(path: str) -> list[dict]:
    """All harvested records under ``path`` as
    ``{"x": (n_in,), "y": (n_obs,), "s": (L, H, n_in)}`` dicts, in shard
    order (deterministic across runs)."""
    records = []
    for f in sorted(glob.glob(os.path.join(path, "shard_*.npz"))):
        z = np.load(f)
        for i in range(int(z["n"])):
            records.append({"x": z[f"x{i}"], "y": z[f"y{i}"],
                            "s": z[f"s{i}"]})
    return records


class HarvestIterator:
    """Deterministic fixed-shape batches from a harvested dataset.

    Records are grouped by prompt length; each ``next()`` round-robins the
    length groups and samples ``batch`` records from the current group
    (with replacement, so small groups still fill a batch).  Yields
    ``{"x": (B, n_in) int32, "s_gt": (L, B, H, n_in) f32}`` — the inputs
    of ``objective.lkv_loss_from_targets``.  Sampling is a pure function
    of (seed, call index), so resuming a killed trainer only needs the
    iterator fast-forwarded by the step count.
    """

    def __init__(self, path: str, batch: int, *, seed: int = 0):
        self.records = load_records(path)
        if not self.records:
            raise FileNotFoundError(
                f"no harvest shards under {path!r} — run "
                "`python -m repro.data.harvest` first")
        groups = defaultdict(list)
        for i, r in enumerate(self.records):
            groups[len(r["x"])].append(i)
        self._groups = {k: np.asarray(v) for k, v in sorted(groups.items())}
        self._keys = sorted(self._groups)
        self.batch = batch
        self._rng = np.random.default_rng(seed)
        self._t = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        k = self._keys[self._t % len(self._keys)]
        self._t += 1
        idx = self._rng.choice(self._groups[k], size=self.batch,
                               replace=True)
        xs = np.stack([self.records[i]["x"] for i in idx])
        ss = np.stack([self.records[i]["s"] for i in idx], axis=1)
        return {"x": xs.astype(np.int32), "s_gt": ss.astype(np.float32)}


# -- CLI: serve a trace with the hook installed -------------------------------


def harvest_trace(params, cfg, *, out_dir: str, requests: int = 32,
                  policy: str = "h2o", budget: int = 96, chunk: int = 64,
                  max_new: int = 16, max_obs: int = 16, num_slots: int = 4,
                  seed: int = 0, lkv_params=None) -> HarvestWriter:
    """Serve a Zipf-prefix / Poisson-arrival trace through
    ``ContinuousEngine`` (dense slot caches, on the device of ``params``)
    with the capture hook installed; returns the (flushed) writer.  The
    serving policy only shapes the generated continuations: the targets
    themselves always come from the frozen full-cache oracle pass."""
    from repro_torch.common.config import EvictionConfig
    from repro_torch.data import synthetic
    from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                     Request, ServingConfig)

    writer = HarvestWriter(params, cfg,
                           HarvestConfig(out_dir=out_dir, max_obs=max_obs))
    trace = synthetic.make_prefix_trace(seed, requests, cfg.vocab_size,
                                        chunk=chunk)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new, arrival_s=t)
            for i, (p, t) in enumerate(trace)]
    max_len = max(len(r.prompt) for r in reqs)
    sc = ServingConfig(
        policy=policy, evict=EvictionConfig(budget=budget, draft_len=8),
        chunking=ChunkingConfig(chunk=chunk, max_context=max(max_len, chunk)),
        num_slots=num_slots, max_new_tokens=max_new, eos_id=-1,
        harvest=writer)
    eng = ContinuousEngine(params, cfg, sc, lkv_params=lkv_params,
                           device=params["embed"].device)
    eng.run(reqs)
    writer.flush()
    return writer


def main(argv=None):
    import argparse

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.lookahead import init_lookahead_params
    from repro_torch.models import transformer as tf

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="experiments/harvest")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--policy", default="h2o",
                    help="serving policy during harvest (shapes the "
                         "generated continuations, not the targets)")
    ap.add_argument("--budget", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-obs", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = tf.init_params(cfg, seed=args.seed, device=args.device)
    lkv = None
    if (args.policy == "lookaheadkv" and cfg.technique_applies
            and cfg.lookahead):
        gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        lkv = init_lookahead_params(gen, cfg, params["layers"])
    w = harvest_trace(params, cfg, out_dir=args.out, requests=args.requests,
                      policy=args.policy, budget=args.budget,
                      chunk=args.chunk, max_new=args.max_new,
                      max_obs=args.max_obs, num_slots=args.slots,
                      seed=args.seed, lkv_params=lkv)
    print(f"harvested {w.records_written} records -> {args.out}")


if __name__ == "__main__":
    main()
