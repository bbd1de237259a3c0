"""Serving engines of the port: the chunked continuous-batching engine
(on the paged KV pool or on dense slot caches), the bucket-padded
continuous engine and the lockstep engine.

``ContinuousEngine`` streams each prompt in fixed-size chunks and
interleaves them with a slot-batched decode loop under a token-budget
step (vLLM-style mixed steps):

    arrivals ──> FCFS queue ──> chunked prefill ──> finalize ──> decode slots
                                (prefill_chunk)     (lookahead     (paged pool
                                                     pass, score,   or dense
                                                     evict)         slot cache)

Every iteration runs one decode chunk for the live slots and as many
prefill chunks of the in-flight prompt as the leftover budget covers, so
no live slot waits longer than one step behind a prompt of any length.
Each chunk streams the policy's scores (h2o: the chunk attention's
column masses; snapkv/pyramidkv/tova: a rolled window of queries), and at
prompt end finalize scores the prompt's keys (lookaheadkv: the lookahead
observation pass) and each layer keeps its top rows per kv head.  Every
request's evicted cache has the same shape, ``capacity + margin`` rows
(``transformer.decode_cache_capacity``: the budget, PyramidKV's first
layer, or the adaptive ceiling), whatever its prompt length, so it lands
in a slot without reshaping anything:

* paged (``config.kv_pool`` set): the kept rows are written into freshly
  allocated pool blocks and decode appends grow the slot block by block.
  Admission is gated by free blocks.  With ``reserve_appends`` (the
  default) every admission reserves its worst-case append blocks, so a
  running request is never starved; without it admission is optimistic
  (one append block), and when the pool runs dry the latest admission is
  preempted to the queue head and re-served from scratch (greedy decode
  gives it the same tokens).
* dense (``config.kv_pool`` None): one live (L, slots, capacity + margin,
  KV, hd) cache; admission writes the request's cache into a free slot
  (``transformer.insert_request_cache``) and decode appends at per-slot
  cursors.

Decode-time eviction (``config.decode_evict``): on the paged pool every
decode step runs kernel 5, which also returns each row's softmax mass;
the engine sums them into a per-slot (L, slots, depth, KV) score, and
once a slot's cursor reaches ``capacity + interval`` a sweep
(``paged_sweep``) keeps its ``capacity`` heaviest rows per (layer, kv
head), compacts them into its head blocks and frees the tail blocks
mid-generation.  On the dense caches the step itself overwrites the
lightest row once the ``margin`` rows are full
(``attention.decode_attention_step_evicting``).

Sampling (``config.sampling``, a ``policies.Sampling``): the first token
and every decode step draw on the device under the key
``fold_in(PRNGKey(seed), position)`` of the request's seed
(``Request.eviction_seed``) and the sampled token's absolute position,
the JAX package's stream, so a preempted request replays its tokens.

Prefix cache (``config.prefix_cache``, a ``serving.prefix_cache.
PrefixCache``): admission looks the prompt up in a radix trie of
chunk-boundary (KV, ``ScoreState``) snapshots taken by earlier requests
under the same KV-buffer rung; a hit resumes streaming at the cached
prefix's end, skipping its attention and its score accumulation, and a
prompt that is exactly a cached prefix admits with no prefill chunk.  The
resumed state is bitwise the one the request would have streamed, so
tokens and kept sets are those of a serve without the cache.  On the
pool the cache pins runs of pool blocks, and live requests reclaim
unpinned ones when the pool runs dry.

This is the JAX package's ``ContinuousEngine`` under every single-pass
policy it takes (not ``gt_oracle``, which needs the response, nor
``full`` and the draft-based ``laq``/``speckv``, which cannot stream and
go to ``BucketedEngine``).  ``config.lkv_checkpoint`` loads trained
lookahead modules (``core.lookahead.load_lookahead_params``) and
``config.harvest`` (a ``data.harvest.HarvestWriter``) is called with
every retired request.  PyTorch runs eagerly, so there is no compile
cache; on the card the attention kernels run through ``kernels/ops.py``.

Tensor-parallel serving (``config.mesh``, a ``launch.mesh.Mesh`` over an
initialised process group of ("data", "model") ranks): every rank runs
this engine on its shard of the params (``common.sharding.serving_specs``;
a full tree is sharded at construction, the lookahead params stay
replicated) and, where the heads divide the model axis, its kv heads of
the pool or the dense slots, the model functions all-gathering
activations where a product's input is sharded (``models/attention.py``)
and each layer's ZeRO-stored ("data") and MoE ("model") leaves at use
(``transformer._layer_params``); where the heads do not divide, every
layer runs whole on every rank.  As the JAX engine's cache specs have
it, a prefill chunk (batch 1) runs on every data row, so every pool
write and prefix snapshot lands on every row; decode splits the slots
over the data rows where the data size divides them (and the MoE
dispatch is not the capacity one, whose rows compete), else runs on
every row, and the new tokens are exchanged over the data axis.  The
paged pool keeps whole blocks on every row.  The host decisions are the
same on every rank: the tokens are the same everywhere, the allocator,
block tables and prefix trie are head-oblivious, and the arrivals are
read on global rank 0's clock, broadcast over the world at every
reading.  Decode-time eviction on the pool under a mesh raises
``ValueError``, as the JAX engine asserts, and so does a pool built for
another mesh.

Observability (``repro_torch.obs``), as in the JAX engine: the engine's
record is one typed ``MetricsRegistry`` (``engine.metrics``: counters and
histograms reset at each ``run()``, the pool's, prefix cache's and
scheduler's callback gauges mirror their state); ``config.trace`` (a
``TraceRecorder``) receives per-request spans and ``config.drift`` (a
``DriftMonitor``) every retired request.  ``sync_timers`` (traced, or
``config.sync_timers``) synchronises the device before each chunk's
timer and span close, so they time the work rather than its launch.
``counts`` is a read-only mapping read from the registry under the
port's earlier keys, ``stats`` the JAX engine's deprecated view.

``BucketedEngine`` (the JAX package's deprecated pad-to-bucket engine)
admits groups of one prompt-length bucket, prefills each group
monolithically with the padding masked (``prompt_lens``) and decodes
dense slots greedily with the same slot loop (``_SlotDecodeMixin``); it
serves every policy but ``gt_oracle``, including ``full`` and the
draft-based ones.

``ServingEngine`` is the JAX package's lockstep engine (deprecated there,
kept as the paper-shaped baseline): one batch of same-length prompts,
monolithic prefill with eviction, then greedy decode of the whole batch
(it takes no sampling, as the JAX one);
it takes every policy but ``gt_oracle`` (``speckv`` with a draft model).
It is the one engine of the hybrid arch (hymba: the SSM's conv tail and
state ride the decode cache beside the evicted attention KV); the
continuous engines refuse the SSM archs, as the JAX ones do, and none
serves the attention-free mamba2 (no KV to evict).  ``random`` draws
per request from ``Request.eviction_seed`` on every engine.
"""

from __future__ import annotations

import time
import warnings
import weakref
from collections.abc import Mapping
from types import MappingProxyType
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.config import EvictionConfig, ModelConfig
from repro_torch.common.sharding import (mesh_signature, serving_specs,
                                         shard_tree)
from repro_torch.core import policies
from repro_torch.core.eviction import select_topk
from repro_torch.core.lookahead import load_lookahead_params
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import request_track
from repro_torch.serving.batching import (DEFAULT_BUCKETS, _batch_bucket,
                                          _bucket_for, _pad_to_bucket)
from repro_torch.serving.config import DecodeEvictionConfig, ServingConfig
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import (Request, RequestState,
                                           SlotScheduler, plan_step)

__all__ = ["BucketedEngine", "ContinuousEngine", "Request", "ServingConfig",
           "ServingEngine", "cache_bytes", "paged_sweep"]


def cache_bytes(cfg: ModelConfig, capacity: int, n_in: int) -> dict:
    """Analytic cache footprint per request: the full prompt's K/V against
    the evicted cache's (bf16 K and V of every layer; the paper's
    headline)."""
    per_tok = cfg.num_layers * cfg.attn.kv_dim * 2 * 2
    return {"full": n_in * per_tok, "evicted": capacity * per_tok,
            "ratio": n_in / max(capacity, 1)}


def _kv_row_bytes(cfg: ModelConfig) -> int:
    """K+V bytes of one cache row over every layer, in the model's type."""
    return 2 * cfg.num_layers * cfg.attn.kv_dim * tf.torch_dtype(cfg).itemsize


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_policy(policy: str, *, streaming: bool) -> None:
    """Raise for a policy the engine does not serve: unknown names;
    ``gt_oracle``, which scores from the true response a server does not
    have; and on the chunked engine the draft-based policies, which cannot
    stream, and ``full``, whose caches are as deep as each prompt (both go
    to ``BucketedEngine``, as the JAX engine's asserts say)."""
    if policy is None:
        raise ValueError("an engine needs an eviction policy")
    if policy not in policies.ALL_POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    if policy == "gt_oracle":
        raise ValueError("policy 'gt_oracle' scores from the true response "
                         "rows, which a server does not have")
    if streaming and policy in policies.MULTI_PASS:
        raise ValueError("multi-pass policies (and gt_oracle) cannot "
                         "stream; use BucketedEngine for those baselines")
    if streaming and policy == "full":
        raise ValueError("policy 'full' caches whole prompts: its decode "
                         "cache is not shape-uniform; use BucketedEngine")


def _seeds(reqs, device) -> torch.Tensor:
    """(B,) int32 per-request eviction seeds (the ``random`` policy)."""
    return torch.as_tensor([r.eviction_seed for r in reqs],
                           dtype=torch.int32, device=device)


def paged_sweep(pool: dict, score: torch.Tensor, table: torch.Tensor,
                slot: int, *, capacity: int, depth: int, block_size: int,
                nb_keep: int) -> None:
    """Evict-and-compact one slot's paged decode cache, in place.

    The device half of a decode-eviction sweep: gather the slot's dense
    ``[0, depth)`` view through its block table (a copy, taken before any
    write, since the compacted rows land in the same blocks), keep the
    ``capacity`` rows of highest cumulative mass per (layer, kv head) with
    the stable ``select_topk`` (ties to the lower row, as
    ``jax.lax.top_k``), write them in temporal order into the first
    ``nb_keep`` blocks of the run and zero the rest of those blocks.  The
    host then frees the tail blocks and resets the slot's cursor to
    ``capacity``.

    ``pool`` holds k/v (L, N, bs, KV, hd) and pos/mask (L, N, bs, KV);
    ``score`` is the engine's (L, slots, depth, KV) cumulative mass
    buffer: kept rows carry their tallies, evicted and padded rows restart
    at zero.  Every block covering ``[0, depth)`` must be real (non-null):
    the host fills table gaps first."""
    bs = block_size
    nb = -(-depth // bs)  # blocks covering logical rows [0, depth)
    row = table[slot, :nb].long()  # physical block ids

    def dense(leaf):  # (L, N, bs, ...) -> (L, depth, ...), a copy
        g = leaf[:, row]
        return g.reshape((g.shape[0], nb * bs) + tuple(g.shape[3:]))[:, :depth]

    k, v = dense(pool["k"]), dense(pool["v"])  # (L, depth, KV, hd)
    pos, mask = dense(pool["pos"]), dense(pool["mask"])  # (L, depth, KV)
    sc = score[:, slot]  # (L, depth, KV)
    # top-capacity rows per (layer, kv head); invalid rows win only where
    # too few rows are valid, and then stay masked
    sel = torch.where(mask, sc, NEG_INF).transpose(1, 2)  # (L, KV, depth)
    idx, selmask = select_topk(sel, capacity)  # (L, KV, cap), row order

    def take(x):  # (L, depth, KV[, hd]) -> (L, cap, KV[, hd])
        xt = x.transpose(1, 2)
        ix = idx if xt.dim() == 3 else \
            idx[..., None].expand(idx.shape + (xt.shape[-1],))
        return torch.gather(xt, 2, ix).transpose(1, 2)

    kept = take(mask) & selmask.transpose(1, 2)  # (L, cap, KV)
    k = torch.where(kept[..., None], take(k), 0)
    v = torch.where(kept[..., None], take(v), 0)
    pos = torch.where(kept, take(pos), 0)
    sc_keep = torch.where(kept, take(sc), 0.0)

    def pad(x, rows):  # (L, cap, ...) -> (L, rows, ...), zeros after
        out = torch.zeros((x.shape[0], rows) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
        out[:, :x.shape[1]] = x
        return out

    def blk(x):  # (L, cap, ...) -> (L, nb_keep, bs, ...)
        x = pad(x, nb_keep * bs)
        return x.reshape((x.shape[0], nb_keep, bs) + tuple(x.shape[2:]))

    keep_ids = row[:nb_keep]
    for name, new in (("k", k), ("v", v), ("pos", pos), ("mask", kept)):
        pool[name][:, keep_ids] = blk(new)  # in place
    score[:, slot] = pad(sc_keep, depth)


class ServingEngine:
    """Lockstep batch engine: every request of a batch shares one prompt
    length, and prefill and decode run back to back for the whole batch.

    ``serve`` runs ``policies.run_eviction`` (the monolithic prefill with
    scoring and eviction under ``policy``, kernels 7 and 3 on the card,
    and kernel 8 for a hybrid arch's SSM; ``laq`` and ``speckv`` draft
    ``evict.draft_len`` tokens, kernel 6, and rescore, ``speckv`` with
    the draft model ``draft_params``/``draft_cfg``)
    and then ``policies.greedy_decode`` over the evicted dense cache
    (kernel 6), ``max_new_tokens`` steps with one shared cursor.  With
    ``decode_evict`` (a bool or a ``DecodeEvictionConfig``) the cache keeps
    only ``margin`` append rows and each step evicts once they are full
    (``attention.decode_attention_step_evicting``)."""

    def __init__(self, params: dict, cfg: ModelConfig, *,
                 policy: str = "lookaheadkv",
                 evict: Optional[EvictionConfig] = None,
                 lkv_params: Optional[dict] = None,
                 draft_params: Optional[dict] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 max_new_tokens: int = 64, eos_id: int = 0,
                 decode_evict=False, device="cuda"):
        _check_policy(policy, streaming=False)
        if not cfg.uses_attention:
            raise ValueError(
                f"{cfg.name} has no attention KV cache, so no eviction "
                "policy applies: run it through transformer.prefill("
                "want_ssm_cache=True) and decode_step")
        if policy == "lookaheadkv" and lkv_params is None:
            raise ValueError("lookaheadkv serving needs lookahead modules "
                             "(lkv_params)")
        self.params, self.cfg, self.lkv_params = params, cfg, lkv_params
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        self.policy = policy
        self.evict = evict if evict is not None else EvictionConfig()
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.device = torch.device(device)
        self.decode_evict = DecodeEvictionConfig.coerce(decode_evict)
        self.decode_margin = self.decode_evict.margin_rows(max_new_tokens)

    def serve(self, requests: list[Request]) -> list[Request]:
        """Serve one batch of same-length requests.  ``ttft_s`` is
        batch-level by construction (all requests prefill together): the
        host clock from the call to the prefill's logits on the device."""
        if not requests:
            raise ValueError("empty batch")
        n_in = len(requests[0].prompt)
        if any(len(r.prompt) != n_in for r in requests):
            raise ValueError("batch requests by prompt length")
        tokens = torch.as_tensor(np.stack([r.prompt for r in requests]),
                                 device=self.device)
        t0 = time.perf_counter()
        res = policies.run_eviction(
            self.policy, self.params, self.cfg, tokens, evict=self.evict,
            lkv_params=self.lkv_params, draft_params=self.draft_params,
            draft_cfg=self.draft_cfg, extra_slots=self.decode_margin,
            seeds=_seeds(requests, self.device))
        _sync(self.device)  # the first-token logits are on the device
        ttft = time.perf_counter() - t0
        cache = res.cache
        if self.decode_evict.enabled:
            cache = tf.add_decode_eviction_scores(cache)
        first = torch.argmax(res.logits, dim=-1)[:, None].to(torch.int32)
        toks, _ = policies.greedy_decode(self.params, self.cfg, first,
                                         cache, self.max_new_tokens)
        toks = toks.cpu().numpy()  # (B, max_new_tokens)
        for i, r in enumerate(requests):
            seq = toks[i].tolist()
            if self.eos_id in seq:
                seq = seq[: seq.index(self.eos_id) + 1]
            r.out_tokens = seq
            r.ttft_s = ttft
            r.first_token_s = ttft
            r.done = True
            r.state = RequestState.DONE
        return requests

    def cache_bytes(self, n_in: int) -> dict:
        return cache_bytes(self.cfg, self.evict.budget + self.decode_margin,
                           n_in)

    def kv_device_bytes(self, batch: int = 1) -> int:
        """K+V bytes of one served batch's decode cache (the lockstep
        engine holds no slot cache between batches)."""
        return batch * (self.evict.budget + self.decode_margin) \
            * _kv_row_bytes(self.cfg)


def _reject_unported(config: ServingConfig) -> None:
    """Raise for every setting the port does not serve, naming its ROADMAP
    item, instead of serving it differently from the JAX engine."""
    _check_policy(config.policy, streaming=True)


def _mesh_now(t0: float, mesh) -> float:
    """Seconds since ``t0`` on the host clock; over a mesh global rank
    0's reading, broadcast over the world, so that every rank of every
    data row takes the same arrivals."""
    now = time.perf_counter() - t0
    if mesh is None:
        return now
    import torch.distributed as dist

    dev = "cuda" if dist.get_backend(mesh.world) == "nccl" else "cpu"
    t = torch.tensor([now], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=0, group=mesh.world)
    return float(t[0])


class _InflightPrefill:
    """Host-side cursor of the one streaming prefill in flight.  ``tip``
    is the deepest pinned prefix-cache entry along its prompt (the resume
    point on a hit, then each boundary it inserts)."""

    __slots__ = ("req", "state", "n", "s", "logits", "tip")

    def __init__(self, req: Request, state: tf.ChunkState, n: int):
        self.req, self.state, self.n = req, state, n
        self.s = 0
        self.logits: Optional[torch.Tensor] = None
        self.tip = None


class _SlotDecodeMixin:
    """The slot-batched decode loop of both continuous engines: chunks of
    1/2/4/... steps over per-slot cursors with an active mask, greedy or
    under ``self.sampling`` with per-slot seeds ``self._seeds_h`` (the
    bucketed engine has neither and decodes greedily).  Expects
    ``self.params``, ``cfg``, ``eos_id``, ``_chunks`` and ``_tok`` (slots,
    1); each engine records a decode chunk in ``_record_decode`` and hooks
    retirement through ``_on_retire`` and ``_release_slot``.  The chunked
    engine's ``trace``, ``_sync_timers``, ``harvest`` and ``drift`` are
    read with ``getattr`` (the bucketed engine has none of them)."""

    #: decode chunk lengths the loop picks from
    _CHUNK_SIZES = (1, 2, 4, 8, 16)

    def _pick_chunk(self, remaining, active) -> int:
        """Largest decode chunk no bigger than the longest remaining
        stream; slots finishing mid-chunk have their surplus tokens
        truncated at collect time (decode is prefix-stable: a sampled
        token's key depends on its position only)."""
        room = max(int(remaining[active].max()), 1)
        return max(c for c in self._chunks if c <= room)

    def _decode_steps(self, cache: dict, steps: int, active,
                      paged_depth: Optional[int] = None
                      ) -> tuple[dict, np.ndarray]:
        """``steps`` decode steps of every slot from ``self._tok``
        (inactive slots keep their token and cache); returns (the cache,
        the new tokens (slots, steps) on the host, read once for the
        chunk) and records the chunk (a ``decode_chunk`` span on the
        engine track when traced)."""
        sampling = getattr(self, "sampling", None)
        seeds = None
        if sampling is not None:
            seeds = torch.as_tensor(self._seeds_h.copy(), device=self.device)
        tok = self._tok
        act = torch.as_tensor(np.array(active), device=self.device)
        split = getattr(self, "_split", None)
        if split is not None:  # this data row's slots only
            tok, act = tok[split], act[split]
            seeds = None if seeds is None else seeds[split]
        tr = getattr(self, "trace", None)
        if tr is not None:
            tr.begin("decode_chunk", tr.ENGINE, steps=steps,
                     slots=int(active.sum()))
        t_dec = time.perf_counter()
        tok, cache, toks = policies.decode_chunk(
            self.params, self.cfg, tok, cache, steps, active=act,
            paged_depth=paged_depth, sampling=sampling, seeds=seeds,
            mesh=getattr(self, "mesh", None))
        if split is None:
            self._tok = tok
        else:  # every row's tokens, in slot order, on every rank
            self._tok[split] = tok
            toks = attn_mod.all_gather(toks, 0, self.mesh, "data")
        if getattr(self, "_sync_timers", False):
            _sync(self.device)  # the whole chunk ran, not just the tokens
        toks_np = toks.cpu().numpy()  # device sync: the tokens landed
        dt = time.perf_counter() - t_dec
        if tr is not None:
            tr.end("decode_chunk", tr.ENGINE)
        self._record_decode(steps, dt)
        return cache, toks_np

    def _collect(self, toks, steps, sched, active, remaining, last_emit, t0):
        now = time.perf_counter() - t0
        for slot in np.nonzero(active)[0]:
            r = sched.running[slot]
            r.max_gap_s = max(r.max_gap_s, now - last_emit[slot])
            last_emit[slot] = now
            take = min(steps, int(remaining[slot]))  # drop overshoot tokens
            finished = False
            for t in toks[slot, :take].tolist():
                r.out_tokens.append(int(t))
                if int(t) == self.eos_id:
                    finished = True
                    break
            remaining[slot] -= steps
            if finished or remaining[slot] <= 0:
                sched.retire(r, now=now)
                active[slot] = False
                self._on_retire(slot, r)
                m = getattr(self, "_m_retired", None)
                if m is not None:
                    m.inc()
                tr = getattr(self, "trace", None)
                tid = request_track(r.uid)
                if tr is not None:
                    tr.end("decode", tid)
                # gt_oracle harvest: the retired request carries the very
                # future the oracle policy needs (its generated tokens);
                # engines without the hook have no ``harvest``
                h = getattr(self, "harvest", None)
                if h is not None:
                    if tr is not None:
                        tr.begin("harvest", tid)
                    h.on_retire(r)
                    if tr is not None:
                        tr.end("harvest", tid)
                # the drift monitor: same moment, same reason
                d = getattr(self, "drift", None)
                if d is not None:
                    d.on_retire(r)
                if tr is not None:
                    tr.instant("retire", tid, tokens=len(r.out_tokens))
                    tr.end("request", tid, outcome="done")
                self._release_slot(slot)

    def _on_retire(self, slot: int, req: Request) -> None:
        """Retirement hook, called while the slot's cache still exists."""

    def _release_slot(self, slot: int) -> None:
        """Retirement hook: return what the slot holds (the paged
        engine's blocks); a dense slot has nothing to free."""


class _LegacyStatsView(Mapping):
    """``ContinuousEngine.stats``: the JAX engine's deprecated per-run
    dict (same keys, same conditional presence), computed from the
    registry at each read, empty before the first ``run()``; the
    component dicts (``prefix_cache``, ``prefix``, ``kv_pool``) are read
    live."""

    __slots__ = ("_eng",)

    def __init__(self, eng: "ContinuousEngine"):
        self._eng = eng

    def _as_dict(self) -> dict:
        e = self._eng
        if not e._run_started:
            return {}
        v = e.metrics.value
        d = {
            "prefill_chunks": int(v("serving_prefill_chunks_total")),
            "decode_chunks": int(v("serving_decode_chunks_total")),
            "decode_steps": int(v("serving_decode_steps_total")),
            "decode_time_s": float(v("serving_decode_seconds_total")),
            "max_prefill_between_decode":
                int(v("serving_max_prefill_between_decode")),
            "max_concurrency": int(v("serving_max_concurrency")),
        }
        d.update(e._run_info)
        sched = e._last_sched
        if e.prefix_cache is not None:
            d["prefix_hits"] = int(v("serving_prefix_hits_total"))
            d["prefix_misses"] = int(v("serving_prefix_misses_total"))
            d["prefix_tokens_skipped"] = \
                int(v("serving_prefix_tokens_skipped_total"))
            d["prefix_cache"] = e.prefix_cache.stats()
            d["prefix"] = sched.prefix_stats()
        if e.pool is not None:
            d["preemptions"] = int(v("serving_preemptions_total"))
            d["admission_blocked"] = \
                int(v("serving_admission_blocked_total"))
            if e._score is not None:
                d["decode_evict_sweeps"] = \
                    int(v("serving_decode_evict_sweeps_total"))
            d["kv_pool"] = dict(e.pool.stats(), queued=len(sched._queue),
                                preemptions=sched.preemptions)
        return d

    def __getitem__(self, key):
        return self._as_dict()[key]

    def __iter__(self):
        return iter(self._as_dict())

    def __len__(self):
        return len(self._as_dict())

    def __repr__(self):
        return f"_LegacyStatsView({self._as_dict()!r})"


class ContinuousEngine(_SlotDecodeMixin):
    """Chunked continuous-batching engine over a ``KVBlockPool``
    (``config.kv_pool``) or over dense slot caches (no pool).

    ``params`` and ``lkv_params`` are dicts of tensors on ``device``
    (``transformer.init_params``, ``core.lookahead.init_lookahead_params``
    or ``bridge.to_torch``); the pool, when there is one, lives there
    too, and a pool-backed prefix cache must be bound to that pool.
    ``run(requests)`` serves them to completion.  The old keyword
    arguments (``policy=``, ``chunk=``, ...: ``ServingConfig.
    from_legacy``) still build the config, with a ``DeprecationWarning``;
    given beside a config they raise ``ValueError``.
    """

    def __init__(self, params: dict, cfg: ModelConfig,
                 config: Optional[ServingConfig] = None, *,
                 lkv_params: Optional[dict] = None, device="cuda",
                 **legacy):
        if legacy:
            if config is not None:
                raise ValueError("pass either a ServingConfig or legacy "
                                 "kwargs, not both")
            warnings.warn(
                "ContinuousEngine(**kwargs) is deprecated; build a "
                "serving.config.ServingConfig and pass it as ``config``",
                DeprecationWarning, stacklevel=2)
            config = ServingConfig.from_legacy(**legacy)
        config = config or ServingConfig()
        _reject_unported(config)
        if not tf.chunkable(cfg):
            raise ValueError(f"{cfg.name}: chunked continuous batching "
                             "serves attention-only decoder archs with "
                             "RoPE and token inputs; serve the SSM, hybrid "
                             "and M-RoPE archs through the lockstep "
                             "ServingEngine (M-RoPE also through "
                             "BucketedEngine)")
        self.device = torch.device(device)
        if config.lkv_checkpoint:
            if lkv_params is not None:
                raise ValueError("pass trained modules either as lkv_params "
                                 "or as config.lkv_checkpoint, not both")
            lkv_params = load_lookahead_params(
                config.lkv_checkpoint, cfg, params["layers"],
                device=self.device)
        if config.policy == "lookaheadkv" and lkv_params is None:
            raise ValueError("lookaheadkv serving needs lookahead modules "
                             "(lkv_params)")
        pool = config.kv_pool
        if pool is not None and pool.device != self.device:
            raise ValueError(f"kv pool on {pool.device}, engine on "
                             f"{self.device}")
        pc = config.prefix_cache
        if pc is not None and pc.pool is not None and pc.pool is not pool:
            raise ValueError("prefix cache bound to a different block pool")
        # tensor-parallel serving: the rank's shard of the params, the
        # lookahead params replicated, the pool sharded on the same mesh
        self.mesh = config.mesh
        if mesh_signature(self.mesh) is None:  # no mesh, or all axes 1
            self.mesh = None
        else:
            params = self._shard_params(params, cfg, config)
        self.config = config
        self.params, self.cfg, self.lkv_params = params, cfg, lkv_params
        # gt_oracle capture hook (the harvest half of the learning loop,
        # ``data/harvest.py``): called per retired request in ``_collect``
        self.harvest = config.harvest
        self.policy = config.policy
        self.evict = config.evict
        self.num_slots = config.num_slots
        self.chunk = config.chunking.chunk
        self.max_new_tokens = config.max_new_tokens
        self.eos_id = config.eos_id
        self.capture_admission = config.capture_admission
        self.decode_evict = config.decode_evict
        self.reserve_appends = config.reserve_appends
        # one margin rule for all engines: a dense cache keeps
        # ``margin_rows`` append rows beyond the eviction capacity; the
        # paged pool under decode eviction keeps ``interval`` rows, the
        # growth window between sweeps
        if pool is not None and self.decode_evict.enabled:
            self.decode_margin = self.decode_evict.interval
        else:
            self.decode_margin = self.decode_evict.margin_rows(
                config.max_new_tokens)
        self._chunks = tuple(c for c in self._CHUNK_SIZES
                             if c <= config.chunking.decode_chunk)
        self.token_budget = config.chunking.token_budget or (
            self.chunk + self.num_slots * config.chunking.decode_chunk)
        # the decode-slot capacity is budget-bound, not context-bound
        self.capacity = tf.decode_cache_capacity(cfg, self.policy, self.evict,
                                                 n_keys_max=1 << 30)
        # KV-buffer rungs are chunk * 2^k: prompts within max_context share
        # the base rung, longer ones take the smallest rung that fits
        self._base_cap = self._rung(max(config.chunking.max_context,
                                        self.capacity))
        self.pool = pool
        # sampling (None or temperature 0: greedy), keyed per slot by the
        # request's seed
        self.sampling = config.sampling
        self._seeds_h = np.zeros(self.num_slots, np.int32)
        # chunk-boundary snapshots shared across requests (prefix_cache.py)
        self.prefix_cache: Optional[PrefixCache] = pc
        if pc is not None:
            # under a mesh the snapshots hold this rank's kv heads: the
            # cache counts their global bytes
            smesh = attn_mod.model_shard_mesh(self.mesh, cfg.attn)
            pc.bind(chunk=self.chunk, policy=self.policy, model=self.params,
                    kv_shards=1 if smesh is None else
                    int(smesh.shape["model"]))
        # rows of every slot's decode cache: kept rows, then appends
        self._depth = self.capacity + self.decode_margin
        S = self.num_slots
        #: over a data axis, the slots this rank's data row decodes (a
        #: slice of [0, S)), or None where every row decodes them all
        self._split: Optional[slice] = self._data_split(cfg)
        self._tok = torch.zeros((S, 1), dtype=torch.int32, device=self.device)
        #: the live dense slot cache of a run without a pool
        self._live: Optional[dict] = None
        #: decode-eviction scores on the pool: (L, slots, depth, KV) f32
        self._score: Optional[torch.Tensor] = None
        # -- observability (repro_torch.obs) ----------------------------
        # one typed registry is the engine's record; the components mirror
        # their state through callback gauges, the tracer (when attached)
        # receives per-request spans
        self.metrics = MetricsRegistry()
        self.drift = config.drift
        self.trace = None
        self._sync_timers = False
        self._run_started = False  # counts / stats: {} before the first run
        self._last_sched: Optional[SlotScheduler] = None
        self._run_info: dict = {}
        self._uid_seq: dict = {}  # uid -> first admission_seq (replay link)
        self._serve_seq = 0
        self._prefix_blocks_reclaimed = 0  # port-only: no JAX metric
        self._register_metrics()
        if pool is not None:
            pool.bind_metrics(self.metrics)
        if pc is not None:
            pc.bind_metrics(self.metrics)
        self.set_trace(config.trace)
        if pool is None:
            return
        if self.decode_evict.enabled:
            self._score = torch.zeros(
                (cfg.num_layers, S, self._depth, cfg.attn.num_kv_heads),
                dtype=torch.float32, device=self.device)
        self._nb_max = pool.blocks_for(self._depth)
        if pool.usable_blocks < self._nb_max + 1:
            raise ValueError("pool cannot hold even one request's worst-case "
                             "cache; raise --kv-pool-mb or shrink "
                             "--kv-block-size")
        # host mirrors of the block tables / cursors / positions: the
        # allocator needs them synchronously, and the device advance rule
        # is deterministic (active slots move `steps` per decode chunk)
        self._table_h = np.zeros((S, self._nb_max), np.int32)
        self._table_dev = self._to_dev(self._table_h)
        self._cursor_h = np.zeros(S, np.int32)
        self._npos_h = np.zeros(S, np.int32)
        self._slot_blocks: dict[int, list[int]] = {s: [] for s in range(S)}
        self._slot_reserved = np.zeros(S, np.int64)
        # admission order of the live slots: preemption takes the latest
        self._admit_seq = np.full(S, -1, np.int64)
        self._admit_counter = 0
        bs = pool.block_size
        # block indices only decode appends can touch: [capacity, depth)
        self._append_jbs = list(range(self.capacity // bs,
                                      (self._depth - 1) // bs + 1))

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.array(arr), device=self.device)

    @staticmethod
    def _shard_params(params: dict, cfg: ModelConfig,
                      config: ServingConfig) -> dict:
        """Check a mesh config and return this rank's shard of ``params``
        (``params`` itself when it is a shard already: its ``wq`` is not
        the whole (d_model, q_dim) weight)."""
        mesh = config.mesh
        n = int(mesh.shape["model"])
        pool = config.kv_pool
        if pool is not None and pool.model_shards != n:
            raise ValueError("kv pool built for a different mesh: pass the "
                             "same mesh to KVBlockPool(..., mesh=...)")
        if pool is not None and config.decode_evict.enabled:
            raise ValueError("decode-time eviction on the paged pool is "
                             "single-device (mesh-sharded serving keeps the "
                             "dense decode_evict path)")
        wq = params["layers"]["attn"]["wq"]
        if tuple(wq.shape[-2:]) != (cfg.d_model, cfg.attn.q_dim):
            return params
        return shard_tree(params, serving_specs(cfg, mesh), mesh, mesh.rank)

    def _data_split(self, cfg: ModelConfig) -> Optional[slice]:
        """This data row's decode slots: the JAX cache specs' batch rule
        (the slots split over "data" where its size divides them), unless
        the MoE's capacity dispatch couples the rows of a call."""
        mesh = self.mesh
        rows = 1 if mesh is None else int(mesh.shape.get("data", 1))
        sparse = cfg.moe is not None and cfg.moe.dispatch == "sparse"
        if rows == 1 or self.num_slots % rows or sparse:
            return None
        w = self.num_slots // rows
        return slice(mesh.data_index * w, (mesh.data_index + 1) * w)

    def _from_row(self, row: int, *ts: torch.Tensor) -> list:
        """``ts`` as the rank of data row ``row`` in this rank's model
        column holds them (broadcast over the data axis)."""
        import torch.distributed as dist

        group = self.mesh.data_group
        dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        src = row * int(self.mesh.shape["model"]) + self.mesh.model_index
        out = []
        for t in ts:
            x = t.to(dev, torch.uint8 if t.dtype == torch.bool
                     else t.dtype).contiguous()
            dist.broadcast(x, src=src, group=group)
            out.append(x.to(t.device, t.dtype))
        return out

    # -- observability ---------------------------------------------------
    def _register_metrics(self) -> None:
        m = self.metrics
        sync_note = (
            "Host perf_counter timer; whether it measures synced execution "
            "(the engine blocks on the chunk's output arrays before "
            "stamping) or async dispatch plus the token sync is recorded "
            "in serving_build's sync_timers key.")
        self._m_prefill_chunks = m.counter(
            "serving_prefill_chunks_total",
            "Prefill chunk programs dispatched.")
        self._m_prefill_seconds = m.counter(
            "serving_prefill_seconds_total",
            "Wall seconds spent in prefill chunk programs. " + sync_note)
        self._m_prefill_chunk_hist = m.histogram(
            "serving_prefill_chunk_seconds",
            "Per-prefill-chunk wall time distribution. " + sync_note)
        self._m_decode_chunks = m.counter(
            "serving_decode_chunks_total",
            "Slot-batched decode chunk programs dispatched.")
        self._m_decode_steps = m.counter(
            "serving_decode_steps_total",
            "Decode steps advanced (chunk dispatches x chunk length).")
        self._m_decode_seconds = m.counter(
            "serving_decode_seconds_total",
            "Wall seconds spent in decode chunks (the legacy "
            "stats['decode_time_s']). " + sync_note)
        self._m_decode_chunk_hist = m.histogram(
            "serving_decode_chunk_seconds",
            "Per-decode-chunk wall time distribution. " + sync_note)
        self._m_ttft = m.histogram(
            "serving_ttft_seconds",
            "Time to first token per request, from schedulability to the "
            "first emitted token (re-admissions keep the original stamp).")
        self._m_max_prefill_between_decode = m.gauge(
            "serving_max_prefill_between_decode",
            "Worst count of prefill chunks run between two decode chunks "
            "while slots were live — the decode-stall bound the "
            "token-budget step enforces.")
        self._m_max_concurrency = m.gauge(
            "serving_max_concurrency",
            "High-water mark of concurrently running requests.")
        self._m_requests = m.counter(
            "serving_requests_total", "Requests submitted to run().")
        self._m_retired = m.counter(
            "serving_requests_retired_total",
            "Requests retired (finished) across admission and decode.")
        self._m_prefix_hits = m.counter(
            "serving_prefix_hits_total",
            "Admissions resumed from a prefix-cache snapshot.")
        self._m_prefix_misses = m.counter(
            "serving_prefix_misses_total",
            "Admissions that probed the prefix cache and missed.")
        self._m_prefix_tokens_skipped = m.counter(
            "serving_prefix_tokens_skipped_total",
            "Prompt tokens whose prefill (attention and score "
            "accumulation) was skipped via prefix-cache hits.")
        self._m_preemptions = m.counter(
            "serving_preemptions_total",
            "Running requests preempted to the queue (paged pool dry).")
        self._m_admission_blocked = m.counter(
            "serving_admission_blocked_total",
            "Prefilled admissions bounced back to the queue head because "
            "the pool could not place their kept rows.")
        self._m_sweeps = m.counter(
            "serving_decode_evict_sweeps_total",
            "Decode-time evict-and-compact sweeps on the paged pool.")
        self._m_build = m.info(
            "serving_build",
            "Engine build facts: score/decode dispatch path, device mesh, "
            "and whether timers are device-synced (sync_timers).")

    def set_trace(self, trace) -> None:
        """Attach (or detach, with ``None``) an ``obs.trace.TraceRecorder``.

        Resolves the timer-sync mode: ``config.sync_timers`` when set,
        else sync exactly when tracing, so untraced serving adds no
        synchronisation; and hands the recorder to the drift monitor."""
        self.trace = trace
        st = self.config.sync_timers
        self._sync_timers = bool(trace is not None if st is None else st)
        if trace is not None:
            trace.sync = self._sync_timers
        if self.drift is not None:
            self.drift.bind(metrics=self.metrics, trace=trace)

    @property
    def counts(self) -> Mapping:
        """The per-run counters under the port's earlier keys, read from
        ``metrics`` into a read-only mapping (empty before the first
        ``run()``; a mapping read after one run keeps that run's values):
        prefill and decode chunks, steps and seconds, peak concurrency,
        preemptions, sweeps, bounced admissions, prefix hits, misses and
        skipped tokens; ``prefix_blocks_reclaimed`` (pool blocks taken
        back from the prefix cache) is the engine's own tally, with no
        JAX metric; ``prefix`` (the scheduler's ``prefix_stats()``) is
        there when the prefix cache is on."""
        if not self._run_started:
            return MappingProxyType({})
        v = self.metrics.value
        d = {"prefill_chunks": int(v("serving_prefill_chunks_total")),
             "prefill_s": float(v("serving_prefill_seconds_total")),
             "decode_chunks": int(v("serving_decode_chunks_total")),
             "decode_steps": int(v("serving_decode_steps_total")),
             "decode_s": float(v("serving_decode_seconds_total")),
             "max_concurrency": int(v("serving_max_concurrency")),
             "preemptions": int(v("serving_preemptions_total")),
             "decode_evict_sweeps":
                 int(v("serving_decode_evict_sweeps_total")),
             "admission_blocked": int(v("serving_admission_blocked_total")),
             "prefix_hits": int(v("serving_prefix_hits_total")),
             "prefix_misses": int(v("serving_prefix_misses_total")),
             "prefix_tokens_skipped":
                 int(v("serving_prefix_tokens_skipped_total")),
             "prefix_blocks_reclaimed": self._prefix_blocks_reclaimed}
        if self.prefix_cache is not None:
            d["prefix"] = self._last_sched.prefix_stats()
        return MappingProxyType(d)

    @property
    def stats(self) -> _LegacyStatsView:
        """Deprecated: the JAX engine's historical per-run ``stats`` dict,
        as a read-only view computed from the metrics registry.  Read
        ``engine.metrics`` (``value()`` / ``snapshot()`` /
        ``prometheus_text()``) instead."""
        warnings.warn(
            "ContinuousEngine.stats is deprecated; read the typed metrics "
            "registry at engine.metrics (see the README's stats() -> "
            "registry migration table)", DeprecationWarning, stacklevel=2)
        return _LegacyStatsView(self)

    def _record_decode(self, steps: int, dt: float) -> None:
        self._m_decode_chunks.inc()
        self._m_decode_steps.inc(steps)
        self._m_decode_seconds.inc(dt)
        self._m_decode_chunk_hist.observe(dt)

    # -- geometry ------------------------------------------------------------
    def _rung(self, need: int) -> int:
        """Smallest chunk * 2^k >= ``need``."""
        r = self.chunk
        while r < need:
            r *= 2
        return r

    def _request_context(self, n_prompt: int) -> int:
        """KV-buffer depth for one request: the base rung for prompts
        within ``max_context``, else the smallest rung that fits the prompt
        plus the observation rows."""
        need = policies.chunk_capacity_for(self.cfg, self.policy, n_prompt,
                                           self.chunk)
        return max(self._rung(need), self._base_cap)

    def cache_bytes(self, n_in: int) -> dict:
        """Analytic full-vs-evicted footprint of one request, plus the pool's
        stats when paged; once traffic has been served, ``evicted`` is the
        measured peak per-request pool footprint."""
        out = cache_bytes(self.cfg, self._depth, n_in)
        if self.pool is not None:
            s = self.pool.stats()
            out["pool"] = s
            peak = int(self.metrics.value("serving_max_concurrency"))
            if peak:
                # prefix-cache pins are shared, not a request's cost
                out["evicted"] = max(
                    s["bytes_high_water"] - s["bytes_pinned_prefix"],
                    s["block_bytes"]) // peak
                out["ratio"] = out["full"] / max(out["evicted"], 1)
        return out

    def kv_device_bytes(self) -> int:
        """Device bytes the decode KV reserves: the whole pool when paged,
        the dense ``num_slots x (capacity + margin)`` slot cache otherwise
        (K+V payload)."""
        if self.pool is not None:
            return self.pool.stats()["bytes_total"]
        return self.num_slots * self._depth * _kv_row_bytes(self.cfg)

    # -- serving loop --------------------------------------------------------
    def run(self, requests: list[Request]) -> list[Request]:
        """Serve ``requests`` to completion; returns them in finish order.
        ``arrival_s`` offsets count on the wall clock from the call."""
        paged = self.pool is not None
        gate = None
        if paged:
            # the scheduler outlives the run (the registry's gauges and the
            # views read it): a weak reference keeps it from holding the
            # engine, and its weights, in a reference cycle
            method = weakref.WeakMethod(self._admission_gate)

            def gate(req: Request) -> bool:
                return method()(req)
        sched = SlotScheduler(self.num_slots, admission_gate=gate)
        for r in requests:
            if r.max_new_tokens > self.max_new_tokens:
                raise ValueError("request exceeds the engine's "
                                 "max_new_tokens cache margin")
            if len(r.prompt) == 0:
                raise ValueError(f"request {r.uid} has an empty prompt")
            sched.submit(r)
        # a fresh collection epoch per run; callback gauges mirror live
        # component state and are untouched
        self.metrics.reset()
        self._run_started = True
        self._last_sched = sched
        self._uid_seq = {}
        self._prefix_blocks_reclaimed = 0
        sched.bind_metrics(self.metrics)
        path = "cuda-kernel" if self.device.type == "cuda" else "torch-plain"
        self._run_info = {
            # where the attention and scoring of prefill run: the kernels
            # on a CUDA device, their plain versions on the CPU
            "score_path": path,
            # the decode cache (paged pool or dense slots) and its path
            "decode_path": f"{'paged' if paged else 'dense'}-{path}",
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
        }
        self._m_build.set(sync_timers=self._sync_timers, **self._run_info)
        self._m_requests.inc(len(requests))
        active = np.zeros(self.num_slots, bool)
        remaining = np.zeros(self.num_slots, np.int64)
        last_emit = np.zeros(self.num_slots, np.float64)
        if self._score is not None:
            self._score.zero_()  # clean tallies across runs
        if not paged:
            slots = (self.num_slots if self._split is None
                     else self._split.stop - self._split.start)
            self._live = tf.init_decode_cache(
                self.cfg, slots, self._depth, per_slot_cursor=True,
                device=self.device, mesh=self.mesh)
            if self.decode_evict.enabled:
                self._live = tf.add_decode_eviction_scores(self._live)
        t0 = time.perf_counter()
        try:
            self._run_loop(sched, active, remaining, last_emit, t0)
        finally:
            # a failed run must not leak blocks into the next one (a clean
            # run has already freed every slot at retirement)
            for s in range(self.num_slots):
                self._release_slot(s)
        return sched.finished

    def _run_loop(self, sched, active, remaining, last_emit, t0) -> None:
        pf: Optional[_InflightPrefill] = None
        since_decode = 0
        try:
            while sched.has_work() or pf is not None:
                now = _mesh_now(t0, self.mesh)
                if pf is None:
                    req = sched.next_request(now)
                    if req is not None:
                        pf = self._begin_prefill(req)
                if pf is not None:
                    steps = (self._pick_chunk(remaining, active)
                             if active.any() else max(self._chunks))
                    _, n_chunks = plan_step(
                        token_budget=self.token_budget, chunk=self.chunk,
                        n_active=int(active.sum()), decode_steps=steps,
                        prefill_pending=True)
                    for _ in range(n_chunks):
                        if pf.s < pf.n:  # a full prefix hit has no chunk
                            self._prefill_step(pf)
                            if active.any():  # only live slots can stall
                                since_decode += 1
                        if pf.s >= pf.n:
                            self._admit(pf, sched, active, remaining,
                                        last_emit, t0)
                            pf = None
                            break
                self._m_max_concurrency.max(len(sched.running))
                if active.any():
                    self._m_max_prefill_between_decode.max(since_decode)
                    since_decode = 0
                    self._decode(sched, active, remaining, last_emit, t0)
                elif pf is None:
                    now2 = _mesh_now(t0, self.mesh)
                    if sched.has_arrived(now2):
                        if self.pool is not None and not sched.running:
                            # nothing can retire to free blocks: reclaim
                            # prefix-cache pins or fail with a sizing error
                            self._reclaim_for_head(sched)
                        continue  # a request is admissible right now
                    nxt = sched.next_arrival()
                    if nxt is None:
                        break
                    wait = nxt - _mesh_now(t0, self.mesh)
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
        finally:
            # a failed run must not leak a trie pin: the cache outlives
            # runs, and a leaked ref would pin its entry forever
            if pf is not None and pf.tip is not None:
                self.prefix_cache.release(pf.tip)
                pf.tip = None

    def _decode(self, sched, active, remaining, last_emit, t0) -> None:
        """One decode chunk of the live slots.  On the pool, in the JAX
        engine's order: the decode-eviction sweep first, then the chunk
        capped so that no cursor passes the depth mid-chunk (the sweep is
        checked only between chunks), then the append blocks grown, with
        preemption when the pool is dry."""
        steps = self._pick_chunk(remaining, active)
        paged = self.pool is not None
        if paged:
            if self._score is not None:
                self._decode_evict_sweep(sched, active, remaining, last_emit)
                if not active.any():
                    return
                room = int(np.min((self._depth - self._cursor_h)[active]))
                steps = max(c for c in self._chunks if c <= max(room, 1))
            self._ensure_append_blocks(sched, active, remaining, last_emit,
                                       steps)
            if not active.any():
                return  # every live slot was preempted
            dispatched = active.copy()
            pool = self.pool.tree()
            if self._score is not None:
                pool["score"] = self._score  # summed into in place
            sl = self._split or slice(None)  # this data row's slots
            cache = {"attn": {"table": self._table_dev[sl]}, "pool": pool,
                     "cursor": self._to_dev(self._cursor_h[sl]),
                     "next_pos": self._to_dev(self._npos_h[sl, None])}
        else:
            cache = self._live  # written in place, gated by `active`
        cache, toks_np = self._decode_steps(
            cache, steps, active, paged_depth=self._depth if paged else None)
        if paged:
            # mirror the device advance rule: slots active at dispatch move
            # `steps`, cursors clamp at the depth
            self._cursor_h[dispatched] = np.minimum(
                self._cursor_h[dispatched] + steps, self._depth)
            self._npos_h[dispatched] += steps
        else:
            self._live = cache
        self._collect(toks_np, steps, sched, active, remaining, last_emit, t0)

    # -- prefill and admission ------------------------------------------------
    def _begin_prefill(self, req: Request) -> _InflightPrefill:
        n = len(req.prompt)
        cap = self._request_context(n)
        tr = self.trace
        tid = request_track(req.uid)
        if tr is not None:
            # one "request" span per serve attempt; a re-serve (preemption
            # replay, or an admission bounced off a dry pool) opens a new
            # span whose replay_of carries the original admission_seq
            seq = self._serve_seq
            self._serve_seq += 1
            args = {"uid": req.uid, "admission_seq": seq, "n_prompt": n}
            if req.uid in self._uid_seq:
                args["replay_of"] = self._uid_seq[req.uid]
            else:
                self._uid_seq[req.uid] = seq
            tr.begin("request", tid, **args)
        pc = self.prefix_cache
        if pc is not None:
            if tr is not None:
                tr.begin("prefix_probe", tid)
            # only snapshots streamed under this request's rung match: the
            # condition for a bitwise resume
            entry = pc.lookup(req.prompt, capacity=cap)
            if entry is not None:
                # materialize before pinning: if it raises, no pin is left
                # that the run loop could not release
                state, logits = pc.materialize(entry, cap)
                pc.acquire(entry)
                pf = _InflightPrefill(req, state, n)
                pf.s = entry.depth
                pf.logits = logits  # the boundary chunk's logits
                pf.tip = entry
                req.cached_prefix_tokens = entry.depth
                self._m_prefix_hits.inc()
                self._m_prefix_tokens_skipped.inc(entry.depth)
                if tr is not None:
                    tr.end("prefix_probe", tid, hit=True, depth=entry.depth)
                return pf
            self._m_prefix_misses.inc()
            if tr is not None:
                tr.end("prefix_probe", tid, hit=False, depth=0)
        state = tf.init_chunk_state(self.cfg, self.policy, 1, cap,
                                    device=self.device, mesh=self.mesh)
        return _InflightPrefill(req, state, n)

    def _prefill_step(self, pf: _InflightPrefill) -> None:
        blk = np.zeros((1, self.chunk), np.int32)
        seg = pf.req.prompt[pf.s:pf.s + self.chunk]
        blk[0, :len(seg)] = seg
        tr = self.trace
        if tr is not None:
            tr.begin("prefill_chunk", request_track(pf.req.uid), s=pf.s)
        t_pf = time.perf_counter()
        pf.state, pf.logits = tf.prefill_chunk(
            self.params, self.cfg, pf.state, self._to_dev(blk), pf.n,
            policy=self.policy, mesh=self.mesh)
        if self._sync_timers:
            # without it the stamp below times the launches only
            _sync(self.device)
        dt = time.perf_counter() - t_pf
        if tr is not None:
            tr.end("prefill_chunk", request_track(pf.req.uid))
        pf.s += self.chunk
        self._m_prefill_chunks.inc()
        self._m_prefill_seconds.inc(dt)
        self._m_prefill_chunk_hist.observe(dt)
        # cache the boundary just crossed (whole chunks only: a partial
        # final chunk holds pad rows)
        pc = self.prefix_cache
        if pc is not None and pf.s <= pf.n:
            entry = pc.insert(pf.req.prompt[:pf.s], state=pf.state,
                              logits=pf.logits, parent=pf.tip)
            if entry is not None:
                pc.acquire(entry)
                if pf.tip is not None:  # the parent link keeps it now
                    pc.release(pf.tip)
                pf.tip = entry

    def _admit(self, pf, sched, active, remaining, last_emit, t0) -> None:
        r = pf.req
        tr = self.trace
        tid = request_track(r.uid)
        if tr is not None:
            tr.begin("finalize", tid)
        cache = tf.prefill_finalize(
            self.params, self.cfg, pf.state, pf.n, policy=self.policy,
            evict=self.evict, lkv_params=self.lkv_params,
            extra_slots=self.decode_margin, seeds=_seeds([r], self.device),
            mesh=self.mesh)
        if pf.tip is not None:
            self.prefix_cache.release(pf.tip)
            pf.tip = None
        if self.decode_evict.enabled:
            cache = tf.add_decode_eviction_scores(cache)
        if self.capture_admission:
            r.admission_cache = {key: val.cpu().numpy()
                                 for key, val in cache["attn"].items()
                                 if key in ("mask", "pos", "score")}
        if self._sync_timers:
            _sync(self.device)
        if tr is not None:
            tr.end("finalize", tid)
        if self.pool is None:
            slot = sched.place(r)
            sl = self._split
            if sl is None:
                tf.insert_request_cache(self._live, cache, slot)
            elif sl.start <= slot < sl.stop:  # a slot of this data row
                tf.insert_request_cache(self._live, cache, slot - sl.start)
        else:
            slot = self._paged_place(sched, r, cache)
            if slot is None:
                # running slots' appends ate the gate's headroom while this
                # request prefilled: back to the queue head, re-prefilled
                # when blocks free (FCFS order and tokens unchanged)
                self._m_admission_blocked.inc()
                sched.push_front(r)
                if tr is not None:
                    tr.end("request", tid, outcome="admission_blocked")
                return
        self._seeds_h[slot] = r.eviction_seed
        first = self._first_token(pf.logits, r.eviction_seed, pf.n)
        self._tok[slot, 0] = first
        r.out_tokens = [first]
        if tr is not None:
            tr.instant("first_token", tid, token=first)
        now = time.perf_counter() - t0
        if r.first_token_s is None:
            # a re-admitted (preempted) request keeps its first stamps: the
            # client had its first token then, and the replay is identical
            r.first_token_s = now
            r.ttft_s = now - r.enqueue_s
            self._m_ttft.observe(r.ttft_s)
        if r.preempt_emit_s is not None:
            # the client-visible stall spans preemption to this re-emit
            r.max_gap_s = max(r.max_gap_s, now - r.preempt_emit_s)
            r.preempt_emit_s = None
        last_emit[slot] = now
        if first == self.eos_id or r.max_new_tokens <= 1:
            sched.retire(r, now=now)
            self._on_retire(slot, r)
            self._release_slot(slot)
            self._m_retired.inc()
            if tr is not None:
                tr.instant("retire", tid, tokens=len(r.out_tokens))
                tr.end("request", tid, outcome="done")
        else:
            active[slot] = True
            remaining[slot] = r.max_new_tokens - 1
            if tr is not None:
                tr.begin("decode", tid)

    def _first_token(self, logits: torch.Tensor, seed: int, pos: int) -> int:
        """The admission token: the argmax, or under ``sampling`` a draw
        with the decode steps' key for (seed, position ``pos``)."""
        s = self.sampling
        if s is None or s.temperature <= 0.0:
            return int(torch.argmax(logits[0]))
        dev = logits.device
        keys = policies.fold_keys(
            torch.tensor([seed], dtype=torch.int32, device=dev),
            torch.tensor([pos], dtype=torch.int32, device=dev))
        return int(policies.sample_logits(
            logits, keys, temperature=s.temperature, top_k=s.top_k,
            top_p=s.top_p)[0])

    # -- paged-KV internals ----------------------------------------------------
    #
    # A live slot's decode cache is a run of pool blocks behind its block
    # table: kept rows at [0, capacity), appends from `capacity`, with gaps
    # and not-yet-grown tails backed by the null block.  Admission writes
    # only the blocks that cover kept rows; append blocks grow one at a
    # time ahead of each decode chunk, redeemed from the slot's reservation
    # or, under optimistic admission, taken from the free list.

    def _request_blocks(self, n_prompt: int) -> tuple[int, int]:
        """(worst-case kept-data blocks, append blocks beyond them) for a
        prompt of ``n_prompt`` tokens — the admission cost model.  Under
        decode-time eviction the slot's window is ``capacity + interval``
        rows, and sweeps materialise every block of it (gap blocks too),
        so the append promise is the whole window minus the data blocks."""
        data = self.pool.blocks_for(min(n_prompt, self.capacity))
        if self._score is not None:
            return data, self._nb_max - data
        appends = sum(1 for jb in self._append_jbs if jb >= data)
        return data, appends

    def _admission_gate(self, req: Request) -> bool:
        """The FCFS head admits only when the pool can cover its
        worst-case kept rows plus, under ``reserve_appends``, its whole
        future decode growth; optimistic admission asks one append
        block.  Blocks the prefix cache could give back count as free:
        the engine reclaims them on demand."""
        data, appends = self._request_blocks(len(req.prompt))
        need = data + (appends if self.reserve_appends else 1)
        free = self.pool.available_blocks()
        if self._pool_cache() is not None:
            free += self.prefix_cache.evictable_pool_blocks()
        return free >= need

    def _pool_cache(self) -> Optional[PrefixCache]:
        """The prefix cache when it pins blocks of this engine's pool."""
        pc = self.prefix_cache
        return pc if pc is not None and pc.pool is not None else None

    def _reclaim(self, need: int) -> bool:
        """Evict unpinned prefix-cache entries until ``need`` pool blocks
        came back (``counts["prefix_blocks_reclaimed"]`` adds what did);
        True iff they did."""
        pc = self._pool_cache()
        if pc is None:
            return False
        before = self.pool.pinned_blocks
        ok = pc.evict_pool_blocks(need)
        self._prefix_blocks_reclaimed += before - self.pool.pinned_blocks
        return ok

    def _alloc_blocks(self, n: int) -> Optional[np.ndarray]:
        """``pool.alloc`` that reclaims prefix-cache blocks when the pool
        is short: live requests outrank cached prefixes.  The shortfall
        counts against the available blocks (ordinary allocs may not dip
        into reservations)."""
        ids = self.pool.alloc(n)
        if ids is None and self._reclaim(n - self.pool.available_blocks()):
            ids = self.pool.alloc(n)
        return ids

    def _reserve_blocks(self, n: int) -> bool:
        """``pool.reserve`` with ``_alloc_blocks``' reclaim: without it the
        gate, which counts evictable prefix blocks as free, would admit
        and the reserve refuse forever."""
        if self.pool.reserve(n):
            return True
        if self._reclaim(n - self.pool.available_blocks()):
            return self.pool.reserve(n)
        return False

    def _reclaim_for_head(self, sched) -> None:
        """Nothing runs, yet the queue head is gated: every missing block
        is pinned by the prefix cache.  Reclaim until the gate passes, or
        fail with a sizing error instead of spinning."""
        while sched._queue and not self._admission_gate(sched._queue[0]):
            if not self._reclaim(1):
                raise RuntimeError(
                    "kv pool too small for the queue head even with the "
                    "prefix cache emptied; raise --kv-pool-mb")

    def _paged_place(self, sched, r: Request, cache: dict) -> Optional[int]:
        """Write the admitted cache's kept rows into freshly allocated
        blocks, reserve its append blocks (under ``reserve_appends``) and
        point a slot's table at them.  Returns the slot, or None when the
        pool cannot cover the kept rows (or the promise) right now."""
        mask = cache["attn"]["mask"]  # (L, 1, C, KV)
        rows = torch.arange(mask.shape[2], device=mask.device)[:, None]
        used = int(torch.where(mask, rows, 0).max()) + 1
        ids = self._alloc_blocks(self.pool.blocks_for(used))
        if ids is None:
            return None
        if self._score is not None:
            # sweeps compact through every block of [0, depth), so gap
            # blocks below the append window count toward the promise too
            outstanding = self._nb_max - len(ids)
        else:
            outstanding = sum(1 for jb in self._append_jbs
                              if jb >= len(ids))
        if self.reserve_appends and not self._reserve_blocks(outstanding):
            self.pool.free(ids)  # the promise cannot be kept: no admission
            return None
        self.pool.write_cache(cache["attn"], ids)
        slot = sched.place(r)
        self._slot_reserved[slot] = outstanding if self.reserve_appends \
            else 0
        self._admit_seq[slot] = self._admit_counter
        self._admit_counter += 1
        self._slot_blocks[slot] = [int(b) for b in ids]
        self._table_h[slot] = 0
        self._table_h[slot, :len(ids)] = ids
        self._table_dev = self._to_dev(self._table_h)
        self._cursor_h[slot] = self.capacity  # appends follow the kept rows
        self._npos_h[slot] = int(cache["next_pos"][0, 0])
        if self._score is not None:
            # the slot's tallies start as add_decode_eviction_scores seeds
            # them: valid kept rows at 1.0
            sc = cache["attn"]["score"]  # (L, 1, depth, KV)
            if sc.shape[2] != self._depth:
                raise RuntimeError("admitted cache depth does not match the "
                                   "paged window")
            self._score[:, slot] = sc[:, 0]
        return slot

    def _grow(self, slot: int, jb: int, sched, active, remaining,
              last_emit) -> bool:
        """Back table entry ``jb`` of ``slot`` with a fresh block: redeemed
        from the slot's reservation (which cannot fail: reserved blocks
        stay on the free list), else taken from the free list, preempting
        the latest admission while it is dry.  Returns False when ``slot``
        itself was preempted."""
        if self._slot_reserved[slot] > 0:
            ids = self.pool.alloc(1, from_reserved=True)
            self._slot_reserved[slot] -= 1
        else:
            ids = self._alloc_blocks(1)
        while ids is None:
            victim = self._latest_admitted_active(active)
            if victim is None:
                raise RuntimeError("kv pool exhausted with no live slot")
            self._preempt(victim, sched, active, remaining, last_emit)
            if not active[slot]:
                return False  # this slot was its own latest admission
            ids = self._alloc_blocks(1)
        # a reallocated block may carry its previous owner's validity rows:
        # invalidate before the table exposes it (the sweep gathers through
        # the table before its scatter overwrites them)
        self.pool.zero_mask(ids)
        self._table_h[slot, jb] = int(ids[0])
        self._slot_blocks[slot].append(int(ids[0]))
        return True

    def _ensure_append_blocks(self, sched, active, remaining, last_emit,
                              steps: int) -> None:
        """Allocate the append blocks every live slot needs for the next
        ``steps`` tokens.  When the pool runs dry the latest admission is
        preempted to the queue (latest first keeps FCFS finish order)
        until the remaining slots fit; the pool sizing check guarantees a
        lone request always fits."""
        bs = self.pool.block_size
        changed = False
        for slot in np.nonzero(active)[0].tolist():
            if not active[slot]:
                continue  # preempted by an earlier slot's growth
            cur = int(self._cursor_h[slot])
            last = min(cur + steps - 1, self._depth - 1)
            for jb in range(cur // bs, last // bs + 1):
                if self._table_h[slot, jb] != 0:
                    continue
                changed = True  # a block was taken, or slots preempted
                if not self._grow(slot, jb, sched, active, remaining,
                                  last_emit):
                    break
        if changed:
            self._table_dev = self._to_dev(self._table_h)

    def _decode_evict_sweep(self, sched, active, remaining,
                            last_emit) -> None:
        """Evict-and-compact every live slot whose cursor reached the
        depth: back the table's gaps below the window with real blocks
        (the compaction writes through them), run ``paged_sweep``, free
        the tail blocks back to the pool mid-generation (and re-promise
        them under ``reserve_appends``) and reset the cursor to
        ``capacity``."""
        nb = self.pool.blocks_for(self._depth)
        nb_keep = self.pool.blocks_for(self.capacity)
        for slot in np.nonzero(active)[0].tolist():
            if not active[slot]:
                continue  # preempted by an earlier slot's gap fill
            if int(self._cursor_h[slot]) < self._depth:
                continue
            gaps = [jb for jb in range(nb) if self._table_h[slot, jb] == 0]
            if not all(self._grow(slot, jb, sched, active, remaining,
                                  last_emit) for jb in gaps):
                continue  # this slot was preempted
            tr = self.trace
            tid = request_track(sched.running[slot].uid)
            if tr is not None:
                tr.begin("paged_sweep", tid)
            self._table_dev = self._to_dev(self._table_h)
            paged_sweep(self.pool.tree(), self._score, self._table_dev, slot,
                        capacity=self.capacity, depth=self._depth,
                        block_size=self.pool.block_size, nb_keep=nb_keep)
            freed = [int(self._table_h[slot, jb]) for jb in
                     range(nb_keep, nb)]
            self.pool.free_run(freed)
            fs = set(freed)
            self._slot_blocks[slot] = [
                b for b in self._slot_blocks[slot] if b not in fs]
            self._table_h[slot, nb_keep:nb] = 0
            if self.reserve_appends:
                if not self.pool.reserve(len(freed)):
                    raise RuntimeError("freed blocks could not be "
                                       "re-promised")
                self._slot_reserved[slot] += len(freed)
            self._cursor_h[slot] = self.capacity
            self._table_dev = self._to_dev(self._table_h)
            if self._sync_timers:
                _sync(self.device)
            if tr is not None:
                tr.end("paged_sweep", tid, blocks_freed=len(freed))
            self._m_sweeps.inc()

    def _on_retire(self, slot: int, req: Request) -> None:
        """Under ``capture_admission`` on the pool, stash the retiring
        request's final kept set (pos and mask of its ``[0, depth)`` view,
        clipped at the emitted-token horizon: a decode chunk may run past
        a finishing request, and those rows are not part of its cache)."""
        if not (self.capture_admission and self.pool is not None):
            return
        L, bs = self.cfg.num_layers, self.pool.block_size
        row = torch.as_tensor(self._table_h[slot], dtype=torch.long,
                              device=self.device)

        def dense(leaf):  # (L, N, bs, KV) -> (L, depth, KV)
            return leaf[:, row].reshape(L, len(row) * bs, -1)[:, :self._depth]

        pos = dense(self.pool.pos)
        horizon = len(req.prompt) + max(len(req.out_tokens) - 1, 0)
        mask = dense(self.pool.mask) & (pos < horizon)
        sl = self._split
        if sl is not None:  # the appends are on the slot's own data row
            pos, mask = self._from_row(slot // (sl.stop - sl.start), pos,
                                       mask)
        req.retirement_cache = {"pos": pos.cpu().numpy(),
                                "mask": mask.cpu().numpy()}

    def _latest_admitted_active(self, active) -> Optional[int]:
        live = np.nonzero(active)[0]
        if len(live) == 0:
            return None
        return int(live[np.argmax(self._admit_seq[live])])

    def _preempt(self, slot: int, sched, active, remaining,
                 last_emit) -> None:
        """Preempt-to-queue: abandon a running slot's decode state, free
        its blocks and push its request back to the queue head for a
        re-serve from scratch (decode keyed on positions gives the same
        tokens, greedy or sampled).  Its
        first-token stamps stay; the stall shows in ``max_gap_s``."""
        r = sched.running[slot]
        tr = self.trace
        if tr is not None:
            tid = request_track(r.uid)
            tr.instant("preempt", tid, emitted=len(r.out_tokens))
            tr.end("decode", tid)
            tr.end("request", tid, outcome="preempted")
        sched.requeue(r)
        r.out_tokens = []  # rebuilt, identical, by the re-serve
        r.preempt_emit_s = last_emit[slot]  # the stall starts here
        r.cached_prefix_tokens = 0
        r.admission_cache = None
        self._release_slot(slot)
        active[slot] = False
        remaining[slot] = 0
        self._m_preemptions.inc()

    def _release_slot(self, slot: int) -> None:
        """Return a retired slot's blocks and unredeemed reservation (a
        dense slot has nothing to free).  The device table row stays stale
        until the next admission overwrites it — harmless: the slot is
        inactive, its reads are discarded and its writes are
        null-routed."""
        if self.pool is None:
            return
        ids = self._slot_blocks[slot]
        if ids:
            self.pool.free(ids)
            self._slot_blocks[slot] = []
        if self._slot_reserved[slot]:
            self.pool.unreserve(int(self._slot_reserved[slot]))
            self._slot_reserved[slot] = 0
        self._table_h[slot] = 0


class BucketedEngine(_SlotDecodeMixin):
    """Continuous-batching engine with bucket-padded monolithic prefill
    (the JAX package's deprecated ``BucketedEngine``, kept there as the
    baseline the chunked engine is measured against, and the engine its
    launcher sends ``full``, ``laq`` and ``speckv`` to).

    Arrived requests are admitted in groups of one prompt-length bucket
    (``SlotScheduler.next_prefill_group``: the FCFS head's bucket, up to
    the free slots and ``max_prefill_batch``); a group is right-padded to
    its bucket and to a power-of-two batch (``batching``) and prefilled in
    one ``policies.run_eviction`` with ``prompt_lens`` when any prompt is
    shorter than the bucket (kernel 7 under its key mask, kernel 3's
    ``kv_mask``).  Each request's evicted cache lands in a dense slot
    (``transformer.insert_request_cache``) and the slots decode together
    (``_SlotDecodeMixin``, kernel 6), every live slot stalling for the
    whole prefill of a group.  Prompts beyond the largest bucket take the
    next power of two, except under ``full``, whose slots are as deep as
    the largest bucket.  The draft-based policies cannot mask padding, so
    their groups share an exact prompt length.

    Exactness: tokens equal isolated lockstep serving for ``lookaheadkv``
    and the position policies under padding; the window policies are
    exact when a prompt fills its bucket and approximate otherwise (their
    observation windows overlap the padding), as in the JAX package.
    ``decode_evict`` caps each slot at ``margin`` append rows, evicting
    per step as the dense slots of ``ContinuousEngine`` do."""

    def __init__(self, params: dict, cfg: ModelConfig, *,
                 policy: str = "lookaheadkv",
                 evict: Optional[EvictionConfig] = None,
                 lkv_params: Optional[dict] = None,
                 draft_params: Optional[dict] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 num_slots: int = 4, buckets: tuple = DEFAULT_BUCKETS,
                 max_prefill_batch: Optional[int] = None,
                 max_new_tokens: int = 64, eos_id: int = 0,
                 decode_evict=False, decode_chunk: int = 8, device="cuda"):
        _check_policy(policy, streaming=False)
        if not cfg.uses_attention or cfg.uses_ssm or cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name}: continuous batching serves "
                             "attention-only decoder archs")
        if policy == "lookaheadkv" and lkv_params is None:
            raise ValueError("lookaheadkv serving needs lookahead modules "
                             "(lkv_params)")
        self.params, self.cfg, self.lkv_params = params, cfg, lkv_params
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        self.policy = policy
        self.evict = evict if evict is not None else EvictionConfig()
        self.num_slots = num_slots
        self.buckets = tuple(sorted(buckets))
        self.max_prefill_batch = max_prefill_batch or num_slots
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.device = torch.device(device)
        self.decode_evict = DecodeEvictionConfig.coerce(decode_evict)
        self.decode_margin = self.decode_evict.margin_rows(max_new_tokens)
        self._chunks = tuple(c for c in self._CHUNK_SIZES
                             if c <= decode_chunk)
        # the draft-based policies draft over a compressed cache and cannot
        # mask padding: their groups share an exact prompt length
        self._exact_only = policy in policies.MULTI_PASS
        self.capacity = tf.decode_cache_capacity(
            cfg, policy, self.evict, n_keys_max=max(self.buckets))
        self._tok = torch.zeros((num_slots, 1), dtype=torch.int32,
                                device=self.device)
        #: per-run counters (prefill groups, decode chunks and steps,
        #: seconds, peak concurrency); the JAX package's deprecated
        #: engines keep a plain dict too, not a registry
        self.counts: dict = {}

    def _record_decode(self, steps: int, dt: float) -> None:
        self.counts["decode_s"] += dt
        self.counts["decode_chunks"] += 1
        self.counts["decode_steps"] += steps

    # -- geometry ------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        if self._exact_only:
            return n
        b = _bucket_for(n, self.buckets)
        if self.policy == "full" and b > max(self.buckets):
            raise ValueError(
                f"policy 'full' caches whole prompts; len {n} exceeds the "
                f"largest bucket {max(self.buckets)}")
        return b

    def cache_bytes(self, n_in: int) -> dict:
        return cache_bytes(self.cfg, self.capacity + self.decode_margin, n_in)

    def kv_device_bytes(self) -> int:
        """K+V bytes of the dense live slot cache."""
        return self.num_slots * (self.capacity + self.decode_margin) \
            * _kv_row_bytes(self.cfg)

    # -- serving loop --------------------------------------------------------
    def run(self, requests: list[Request]) -> list[Request]:
        """Serve ``requests`` to completion; returns them in finish order.
        ``arrival_s`` offsets count on the wall clock from the call; a
        request's TTFT runs from its arrival to its group's first-token
        logits."""
        sched = SlotScheduler(self.num_slots, bucket_for=self._bucket,
                              max_prefill_batch=self.max_prefill_batch)
        for r in requests:
            if r.max_new_tokens > self.max_new_tokens:
                raise ValueError("request exceeds the engine's "
                                 "max_new_tokens cache margin")
            if len(r.prompt) == 0:
                raise ValueError(f"request {r.uid} has an empty prompt")
            self._bucket(len(r.prompt))  # raises for an unservable length
            sched.submit(r)
        self.counts = {"prefill_groups": 0, "prefill_s": 0.0,
                       "decode_chunks": 0, "decode_steps": 0,
                       "decode_s": 0.0, "max_concurrency": 0}
        live = tf.init_decode_cache(
            self.cfg, self.num_slots, self.capacity + self.decode_margin,
            per_slot_cursor=True, device=self.device)
        if self.decode_evict.enabled:
            live = tf.add_decode_eviction_scores(live)
        active = np.zeros(self.num_slots, bool)
        remaining = np.zeros(self.num_slots, np.int64)
        last_emit = np.zeros(self.num_slots, np.float64)
        t0 = time.perf_counter()
        while sched.has_work():
            # fill the free slots, one bucket group per prefill; ``now``
            # refreshes so requests that arrived during a prefill are
            # admissible at once
            while True:
                group = sched.next_prefill_group(time.perf_counter() - t0)
                if not group:
                    break
                self._admit(group, sched, live, active, remaining,
                            last_emit, t0)
            self.counts["max_concurrency"] = max(
                self.counts["max_concurrency"], len(sched.running))
            if active.any():
                steps = self._pick_chunk(remaining, active)
                live, toks = self._decode_steps(live, steps, active)
                self._collect(toks, steps, sched, active, remaining,
                              last_emit, t0)
            else:
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                wait = nxt - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        return sched.finished

    def _admit(self, group, sched, live, active, remaining, last_emit,
               t0) -> None:
        """Prefill one bucket group (padded when a prompt is shorter than
        the bucket) and land each request's cache in a free slot."""
        lens = [len(r.prompt) for r in group]
        bucket = self._bucket(max(lens))
        padded = any(n != bucket for n in lens)
        nb = _batch_bucket(len(group), self.max_prefill_batch)
        tokens, lens_arr = _pad_to_bucket([r.prompt for r in group], bucket,
                                          nb)
        seeds = np.zeros((nb,), np.int32)
        seeds[:len(group)] = [r.eviction_seed for r in group]
        t_pf = time.perf_counter()
        res = policies.run_eviction(
            self.policy, self.params, self.cfg,
            torch.as_tensor(tokens, device=self.device), evict=self.evict,
            lkv_params=self.lkv_params, draft_params=self.draft_params,
            draft_cfg=self.draft_cfg, extra_slots=self.decode_margin,
            prompt_lens=(torch.as_tensor(lens_arr, device=self.device)
                         if padded else None),
            seeds=torch.as_tensor(seeds, device=self.device))
        cache = res.cache
        if self.decode_evict.enabled:
            cache = tf.add_decode_eviction_scores(cache)
        first = torch.argmax(res.logits, dim=-1).cpu().numpy()  # a sync
        self.counts["prefill_groups"] += 1
        self.counts["prefill_s"] += time.perf_counter() - t_pf
        now = time.perf_counter() - t0
        for i, r in enumerate(group):
            slot = sched.place(r)
            tf.insert_request_cache(live, tf.extract_request_cache(cache, i),
                                    slot)
            self._tok[slot, 0] = int(first[i])
            r.out_tokens = [int(first[i])]
            r.first_token_s = now
            r.ttft_s = now - r.enqueue_s
            last_emit[slot] = now
            if r.out_tokens[-1] == self.eos_id or r.max_new_tokens <= 1:
                sched.retire(r, now=now)
                active[slot] = False
            else:
                active[slot] = True
                remaining[slot] = r.max_new_tokens - 1
