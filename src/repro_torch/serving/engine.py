"""Serving engines of the port: the chunked continuous-batching engine
(on the paged KV pool or on dense slot caches), the bucket-padded
continuous engine and the lockstep engine.

``ContinuousEngine`` streams each prompt in fixed-size chunks and
interleaves them with a slot-batched greedy decode loop under a
token-budget step (vLLM-style mixed steps):

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

This is the JAX package's ``ContinuousEngine`` with greedy decode,
under every single-pass policy it takes (not ``gt_oracle``, which needs
the response, nor ``full`` and the draft-based ``laq``/``speckv``, which
cannot stream and go to ``BucketedEngine``).  Every other setting raises
``NotImplementedError`` naming the ROADMAP item that brings it.  PyTorch
runs eagerly, so there is no compile cache; on the card the attention
kernels run through ``kernels/ops.py``.

``BucketedEngine`` (the JAX package's deprecated pad-to-bucket engine)
admits groups of one prompt-length bucket, prefills each group
monolithically with the padding masked (``prompt_lens``) and decodes
dense slots with the same slot loop (``_SlotDecodeMixin``); it serves
every policy but ``gt_oracle``, including ``full`` and the draft-based
ones.

``ServingEngine`` is the JAX package's lockstep engine (deprecated there,
kept as the paper-shaped baseline): one batch of same-length prompts,
monolithic prefill with eviction, then greedy decode of the whole batch;
it takes every policy but ``gt_oracle`` (``speckv`` with a draft model).
It is the one engine of the hybrid arch (hymba: the SSM's conv tail and
state ride the decode cache beside the evicted attention KV); the
continuous engines refuse the SSM archs, as the JAX ones do, and none
serves the attention-free mamba2 (no KV to evict).  ``random`` draws
per request from ``Request.eviction_seed`` on every engine.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.common.config import EvictionConfig, ModelConfig
from repro_torch.core import policies
from repro_torch.core.eviction import select_topk
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import transformer as tf
from repro_torch.serving.batching import (DEFAULT_BUCKETS, _batch_bucket,
                                          _bucket_for, _pad_to_bucket)
from repro_torch.serving.config import DecodeEvictionConfig, ServingConfig
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
    unported = [
        (config.prefix_cache is not None, "prefix cache: ROADMAP A7"),
        (config.sampling is not None, "sampling: ROADMAP A8"),
        (config.harvest is not None or config.lkv_checkpoint is not None,
         "harvest and lookahead checkpoints: ROADMAP A9"),
        (config.mesh is not None, "a device mesh: ROADMAP A11"),
        (config.trace is not None or config.drift is not None
         or config.sync_timers is not None,
         "metrics and tracing: ROADMAP A12"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"not ported yet: {what}")


class _InflightPrefill:
    """Host-side cursor of the one streaming prefill in flight."""

    __slots__ = ("req", "state", "n", "s", "logits")

    def __init__(self, req: Request, state: tf.ChunkState, n: int):
        self.req, self.state, self.n = req, state, n
        self.s = 0
        self.logits: Optional[torch.Tensor] = None


class _SlotDecodeMixin:
    """The slot-batched greedy decode loop of both continuous engines:
    chunks of 1/2/4/... steps over per-slot cursors with an active mask.
    Expects ``self.params``, ``cfg``, ``eos_id``, ``_chunks``, ``_tok``
    (slots, 1) and ``counts``; the engines hook retirement through
    ``_on_retire`` and ``_release_slot``."""

    #: decode chunk lengths the loop picks from
    _CHUNK_SIZES = (1, 2, 4, 8, 16)

    def _pick_chunk(self, remaining, active) -> int:
        """Largest decode chunk no bigger than the longest remaining
        stream; slots finishing mid-chunk have their surplus tokens
        truncated at collect time (greedy decode is prefix-stable)."""
        room = max(int(remaining[active].max()), 1)
        return max(c for c in self._chunks if c <= room)

    def _decode_steps(self, cache: dict, steps: int, active,
                      paged_depth: Optional[int] = None
                      ) -> tuple[dict, np.ndarray]:
        """``steps`` greedy decode steps of every slot from ``self._tok``
        (inactive slots keep their token and cache); returns (the cache,
        the new tokens (slots, steps) on the host) and counts the chunk."""
        t_dec = time.perf_counter()
        self._tok, cache, toks = policies.decode_chunk(
            self.params, self.cfg, self._tok, cache, steps,
            active=torch.as_tensor(np.array(active), device=self.device),
            paged_depth=paged_depth)
        toks_np = toks.cpu().numpy()  # device sync: the tokens landed
        self.counts["decode_s"] += time.perf_counter() - t_dec
        self.counts["decode_chunks"] += 1
        self.counts["decode_steps"] += steps
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
                self._release_slot(slot)

    def _on_retire(self, slot: int, req: Request) -> None:
        """Retirement hook, called while the slot's cache still exists."""

    def _release_slot(self, slot: int) -> None:
        """Retirement hook: return what the slot holds (the paged
        engine's blocks); a dense slot has nothing to free."""


class ContinuousEngine(_SlotDecodeMixin):
    """Chunked continuous-batching engine over a ``KVBlockPool``
    (``config.kv_pool``) or over dense slot caches (no pool).

    ``params`` and ``lkv_params`` are dicts of tensors on ``device``
    (``transformer.init_params``, ``core.lookahead.init_lookahead_params``
    or ``bridge.to_torch``); the pool, when there is one, lives there
    too.  ``run(requests)`` serves them to completion.
    """

    def __init__(self, params: dict, cfg: ModelConfig,
                 config: Optional[ServingConfig] = None, *,
                 lkv_params: Optional[dict] = None, device="cuda"):
        config = config or ServingConfig()
        _reject_unported(config)
        if not tf.chunkable(cfg):
            raise ValueError(f"{cfg.name}: chunked continuous batching "
                             "serves attention-only decoder archs; serve "
                             "the SSM and hybrid archs through the lockstep "
                             "ServingEngine")
        if config.policy == "lookaheadkv" and lkv_params is None:
            raise ValueError("lookaheadkv serving needs lookahead modules "
                             "(lkv_params)")
        self.device = torch.device(device)
        pool = config.kv_pool
        if pool is not None and pool.device != self.device:
            raise ValueError(f"kv pool on {pool.device}, engine on "
                             f"{self.device}")
        self.config = config
        self.params, self.cfg, self.lkv_params = params, cfg, lkv_params
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
        # rows of every slot's decode cache: kept rows, then appends
        self._depth = self.capacity + self.decode_margin
        S = self.num_slots
        self._tok = torch.zeros((S, 1), dtype=torch.int32, device=self.device)
        #: the live dense slot cache of a run without a pool
        self._live: Optional[dict] = None
        #: decode-eviction scores on the pool: (L, slots, depth, KV) f32
        self._score: Optional[torch.Tensor] = None
        #: per-run counters (prefill/decode chunks and steps, seconds,
        #: preemptions, sweeps, bounced admissions)
        self.counts: dict = {}
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
            peak = self.counts.get("max_concurrency", 0)
            if peak:
                out["evicted"] = max(s["bytes_high_water"],
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
        sched = SlotScheduler(
            self.num_slots,
            admission_gate=self._admission_gate if paged else None)
        for r in requests:
            if r.max_new_tokens > self.max_new_tokens:
                raise ValueError("request exceeds the engine's "
                                 "max_new_tokens cache margin")
            if len(r.prompt) == 0:
                raise ValueError(f"request {r.uid} has an empty prompt")
            sched.submit(r)
        self.counts = {"prefill_chunks": 0, "prefill_s": 0.0,
                       "decode_chunks": 0, "decode_steps": 0,
                       "decode_s": 0.0, "max_concurrency": 0,
                       "preemptions": 0, "decode_evict_sweeps": 0,
                       "admission_blocked": 0}
        active = np.zeros(self.num_slots, bool)
        remaining = np.zeros(self.num_slots, np.int64)
        last_emit = np.zeros(self.num_slots, np.float64)
        if self._score is not None:
            self._score.zero_()  # clean tallies across runs
        if not paged:
            self._live = tf.init_decode_cache(
                self.cfg, self.num_slots, self._depth, per_slot_cursor=True,
                device=self.device)
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
        while sched.has_work() or pf is not None:
            now = time.perf_counter() - t0
            if pf is None:
                req = sched.next_request(now)
                if req is not None:
                    pf = self._begin_prefill(req)
            if pf is not None:
                steps = (self._pick_chunk(remaining, active) if active.any()
                         else max(self._chunks))
                _, n_chunks = plan_step(
                    token_budget=self.token_budget, chunk=self.chunk,
                    n_active=int(active.sum()), decode_steps=steps,
                    prefill_pending=True)
                for _ in range(n_chunks):
                    if pf.s < pf.n:
                        self._prefill_step(pf)
                    if pf.s >= pf.n:
                        self._admit(pf, sched, active, remaining, last_emit,
                                    t0)
                        pf = None
                        break
            self.counts["max_concurrency"] = max(
                self.counts["max_concurrency"], len(sched.running))
            if active.any():
                self._decode(sched, active, remaining, last_emit, t0)
            elif pf is None:
                now2 = time.perf_counter() - t0
                if sched.has_arrived(now2):
                    if self.pool is not None and not sched.running and \
                            not self._admission_gate(sched._queue[0]):
                        raise RuntimeError(
                            "kv pool too small for the queue head; raise "
                            "--kv-pool-mb")
                    continue  # a request is admissible right now
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                wait = nxt - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))

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
            cache = {"attn": {"table": self._table_dev}, "pool": pool,
                     "cursor": self._to_dev(self._cursor_h),
                     "next_pos": self._to_dev(self._npos_h[:, None])}
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
        state = tf.init_chunk_state(self.cfg, self.policy, 1,
                                    self._request_context(n),
                                    device=self.device)
        return _InflightPrefill(req, state, n)

    def _prefill_step(self, pf: _InflightPrefill) -> None:
        blk = np.zeros((1, self.chunk), np.int32)
        seg = pf.req.prompt[pf.s:pf.s + self.chunk]
        blk[0, :len(seg)] = seg
        t_pf = time.perf_counter()
        pf.state, pf.logits = tf.prefill_chunk(
            self.params, self.cfg, pf.state, self._to_dev(blk), pf.n,
            policy=self.policy)
        pf.s += self.chunk
        self.counts["prefill_chunks"] += 1
        self.counts["prefill_s"] += time.perf_counter() - t_pf

    def _admit(self, pf, sched, active, remaining, last_emit, t0) -> None:
        r = pf.req
        cache = tf.prefill_finalize(
            self.params, self.cfg, pf.state, pf.n, policy=self.policy,
            evict=self.evict, lkv_params=self.lkv_params,
            extra_slots=self.decode_margin, seeds=_seeds([r], self.device))
        if self.decode_evict.enabled:
            cache = tf.add_decode_eviction_scores(cache)
        if self.capture_admission:
            r.admission_cache = {key: val.cpu().numpy()
                                 for key, val in cache["attn"].items()
                                 if key in ("mask", "pos", "score")}
        if self.pool is None:
            slot = sched.place(r)
            tf.insert_request_cache(self._live, cache, slot)
        else:
            slot = self._paged_place(sched, r, cache)
            if slot is None:
                # running slots' appends ate the gate's headroom while this
                # request prefilled: back to the queue head, re-prefilled
                # when blocks free (FCFS order and tokens unchanged)
                self.counts["admission_blocked"] += 1
                sched.push_front(r)
                return
        first = int(torch.argmax(pf.logits[0]))
        self._tok[slot, 0] = first
        r.out_tokens = [first]
        now = time.perf_counter() - t0
        if r.first_token_s is None:
            # a re-admitted (preempted) request keeps its first stamps: the
            # client had its first token then, and the replay is identical
            r.first_token_s = now
            r.ttft_s = now - r.enqueue_s
        if r.preempt_emit_s is not None:
            # the client-visible stall spans preemption to this re-emit
            r.max_gap_s = max(r.max_gap_s, now - r.preempt_emit_s)
            r.preempt_emit_s = None
        last_emit[slot] = now
        if first == self.eos_id or r.max_new_tokens <= 1:
            sched.retire(r, now=now)
            self._on_retire(slot, r)
            self._release_slot(slot)
        else:
            active[slot] = True
            remaining[slot] = r.max_new_tokens - 1

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
        block."""
        data, appends = self._request_blocks(len(req.prompt))
        need = data + (appends if self.reserve_appends else 1)
        return self.pool.available_blocks() >= need

    def _paged_place(self, sched, r: Request, cache: dict) -> Optional[int]:
        """Write the admitted cache's kept rows into freshly allocated
        blocks, reserve its append blocks (under ``reserve_appends``) and
        point a slot's table at them.  Returns the slot, or None when the
        pool cannot cover the kept rows (or the promise) right now."""
        mask = cache["attn"]["mask"]  # (L, 1, C, KV)
        rows = torch.arange(mask.shape[2], device=mask.device)[:, None]
        used = int(torch.where(mask, rows, 0).max()) + 1
        ids = self.pool.alloc(self.pool.blocks_for(used))
        if ids is None:
            return None
        if self._score is not None:
            # sweeps compact through every block of [0, depth), so gap
            # blocks below the append window count toward the promise too
            outstanding = self._nb_max - len(ids)
        else:
            outstanding = sum(1 for jb in self._append_jbs
                              if jb >= len(ids))
        if self.reserve_appends and not self.pool.reserve(outstanding):
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
            ids = self.pool.alloc(1)
        while ids is None:
            victim = self._latest_admitted_active(active)
            if victim is None:
                raise RuntimeError("kv pool exhausted with no live slot")
            self._preempt(victim, sched, active, remaining, last_emit)
            if not active[slot]:
                return False  # this slot was its own latest admission
            ids = self.pool.alloc(1)
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
            self.counts["decode_evict_sweeps"] += 1

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
        re-serve from scratch (greedy decode gives the same tokens).  Its
        first-token stamps stay; the stall shows in ``max_gap_s``."""
        r = sched.running[slot]
        sched.requeue(r)
        r.out_tokens = []  # rebuilt, identical, by the re-serve
        r.preempt_emit_s = last_emit[slot]  # the stall starts here
        r.admission_cache = None
        self._release_slot(slot)
        active[slot] = False
        remaining[slot] = 0
        self.counts["preemptions"] += 1

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
        if not tf.chunkable(cfg):
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
        #: seconds, peak concurrency)
        self.counts: dict = {}

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
