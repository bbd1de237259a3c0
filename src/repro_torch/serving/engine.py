"""Serving engines of the port: the chunked continuous-batching engine
(on the paged KV pool or on dense slot caches) and the lockstep engine.

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
At prompt end the lookahead observation pass scores the prompt's keys and
each layer keeps its top ``budget`` rows per kv head.  Every request's
evicted cache has the same shape, ``capacity + margin`` rows, whatever its
prompt length, so it lands in a slot without reshaping anything:

* paged (``config.kv_pool`` set): the kept rows are written into freshly
  allocated pool blocks and decode appends grow the slot block by block.
  Admission is gated by free blocks, and every admission reserves its
  worst-case append blocks, so a running request is never starved (no
  preemption is ever needed).
* dense (``config.kv_pool`` None): one live (L, slots, capacity + margin,
  KV, hd) cache; admission writes the request's cache into a free slot
  (``transformer.insert_request_cache``) and decode appends at per-slot
  cursors.

This is the JAX package's ``ContinuousEngine`` with
``reserve_appends=True``, policy ``lookaheadkv`` and greedy decode.  Every
other setting raises ``NotImplementedError`` naming the ROADMAP item that
brings it.  PyTorch runs eagerly, so there is no compile cache; on the
card the attention kernels run through ``kernels/ops.py``.

``ServingEngine`` is the JAX package's lockstep engine (deprecated there,
kept as the paper-shaped baseline): one batch of same-length prompts,
monolithic prefill with eviction, then greedy decode of the whole batch.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.common.config import EvictionConfig, ModelConfig
from repro_torch.core import policies
from repro_torch.models import transformer as tf
from repro_torch.serving.config import DecodeEvictionConfig, ServingConfig
from repro_torch.serving.scheduler import (Request, RequestState,
                                           SlotScheduler, plan_step)

__all__ = ["ContinuousEngine", "Request", "ServingConfig", "ServingEngine",
           "cache_bytes"]


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


class ServingEngine:
    """Lockstep batch engine: every request of a batch shares one prompt
    length, and prefill and decode run back to back for the whole batch.

    ``serve`` runs ``policies.run_eviction`` (the monolithic prefill with
    the lookahead rows, scoring and eviction, kernels 7 and 3 on the card)
    and then ``policies.greedy_decode`` over the evicted dense cache
    (kernel 6), ``max_new_tokens`` steps with one shared cursor."""

    def __init__(self, params: dict, cfg: ModelConfig, *,
                 policy: str = "lookaheadkv",
                 evict: Optional[EvictionConfig] = None,
                 lkv_params: Optional[dict] = None,
                 max_new_tokens: int = 64, eos_id: int = 0, device="cuda"):
        if policy != "lookaheadkv":
            raise NotImplementedError(
                f"not ported yet: policy {policy!r}: ROADMAP A3 (other "
                "policies)")
        if lkv_params is None:
            raise ValueError("lookaheadkv serving needs lookahead modules "
                             "(lkv_params)")
        self.params, self.cfg, self.lkv_params = params, cfg, lkv_params
        self.policy = policy
        self.evict = evict if evict is not None else EvictionConfig()
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.device = torch.device(device)
        self.decode_margin = DecodeEvictionConfig().margin_rows(
            max_new_tokens)

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
            lkv_params=self.lkv_params, extra_slots=self.decode_margin)
        _sync(self.device)  # the first-token logits are on the device
        ttft = time.perf_counter() - t0
        first = torch.argmax(res.logits, dim=-1)[:, None].to(torch.int32)
        toks, _ = policies.greedy_decode(self.params, self.cfg, first,
                                         res.cache, self.max_new_tokens)
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
    unported = [
        (config.policy != "lookaheadkv",
         f"policy {config.policy!r}: ROADMAP A3 (other policies)"),
        (config.decode_evict.enabled, "decode-time eviction: ROADMAP A5"),
        (not config.reserve_appends,
         "optimistic admission with preemption: ROADMAP A5"),
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


class ContinuousEngine:
    """Chunked continuous-batching engine over a ``KVBlockPool``
    (``config.kv_pool``) or over dense slot caches (no pool).

    ``params`` and ``lkv_params`` are dicts of tensors on ``device``
    (``transformer.init_params``, ``core.lookahead.init_lookahead_params``
    or ``bridge.to_torch``); the pool, when there is one, lives there
    too.  ``run(requests)`` serves them to completion.
    """

    #: decode chunk lengths the loop picks from
    _CHUNK_SIZES = (1, 2, 4, 8, 16)

    def __init__(self, params: dict, cfg: ModelConfig,
                 config: Optional[ServingConfig] = None, *,
                 lkv_params: Optional[dict] = None, device="cuda"):
        config = config or ServingConfig()
        _reject_unported(config)
        if lkv_params is None:
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
        self.decode_margin = config.decode_evict.margin_rows(
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
        #: per-run counters (prefill/decode chunks and steps, seconds)
        self.counts: dict = {}
        if pool is None:
            return
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
                       "decode_s": 0.0, "max_concurrency": 0}
        active = np.zeros(self.num_slots, bool)
        remaining = np.zeros(self.num_slots, np.int64)
        last_emit = np.zeros(self.num_slots, np.float64)
        if not paged:
            self._live = tf.init_decode_cache(
                self.cfg, self.num_slots, self._depth, per_slot_cursor=True,
                device=self.device)
        t0 = time.perf_counter()
        try:
            self._run_loop(sched, active, remaining, last_emit, t0)
        finally:
            # a failed run must not leak blocks into the next one (a clean
            # run has already freed every slot at retirement)
            for s in range(self.num_slots):
                self._free_slot_blocks(s)
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

    def _pick_chunk(self, remaining, active) -> int:
        """Largest decode chunk no bigger than the longest remaining
        stream; slots finishing mid-chunk have their surplus tokens
        truncated at collect time (greedy decode is prefix-stable)."""
        room = max(int(remaining[active].max()), 1)
        return max(c for c in self._chunks if c <= room)

    def _decode(self, sched, active, remaining, last_emit, t0) -> None:
        steps = self._pick_chunk(remaining, active)
        paged = self.pool is not None
        if paged:
            # grow every live slot's append blocks before the chunk runs
            self._ensure_append_blocks(active, steps)
            dispatched = active.copy()
            cache = {"attn": {"table": self._table_dev},
                     "pool": self.pool.tree(),
                     "cursor": self._to_dev(self._cursor_h),
                     "next_pos": self._to_dev(self._npos_h[:, None])}
        else:
            cache = self._live  # written in place, gated by `active`
        t_dec = time.perf_counter()
        self._tok, cache, toks = policies.decode_chunk(
            self.params, self.cfg, self._tok, cache, steps,
            active=self._to_dev(active),
            paged_depth=self._depth if paged else None)
        toks_np = toks.cpu().numpy()  # device sync: the tokens landed
        self.counts["decode_s"] += time.perf_counter() - t_dec
        self.counts["decode_chunks"] += 1
        self.counts["decode_steps"] += steps
        if paged:
            # mirror the device advance rule: slots active at dispatch move
            # `steps`, cursors clamp at the depth
            self._cursor_h[dispatched] = np.minimum(
                self._cursor_h[dispatched] + steps, self._depth)
            self._npos_h[dispatched] += steps
        else:
            self._live = cache
        self._collect(toks_np, steps, sched, active, remaining, last_emit, t0)

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
                self._free_slot_blocks(slot)

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
            extra_slots=self.decode_margin)
        if self.capture_admission:
            r.admission_cache = {key: cache["attn"][key].cpu().numpy()
                                 for key in ("mask", "pos")}
        if self.pool is None:
            slot = sched.place(r)
            tf.insert_request_cache(self._live, cache, slot)
        else:
            slot = self._paged_place(sched, r, cache)
        first = int(torch.argmax(pf.logits[0]))
        self._tok[slot, 0] = first
        r.out_tokens = [first]
        now = time.perf_counter() - t0
        r.first_token_s = now
        r.ttft_s = now - r.enqueue_s
        last_emit[slot] = now
        if first == self.eos_id or r.max_new_tokens <= 1:
            sched.retire(r, now=now)
            self._free_slot_blocks(slot)
        else:
            active[slot] = True
            remaining[slot] = r.max_new_tokens - 1

    # -- paged-KV internals ----------------------------------------------------
    #
    # A live slot's decode cache is a run of pool blocks behind its block
    # table: kept rows at [0, capacity), appends from `capacity`, with gaps
    # and not-yet-grown tails backed by the null block.  Admission writes
    # only the blocks that cover kept rows; append blocks grow one at a
    # time ahead of each decode chunk, redeemed from the slot's reservation.

    def _request_blocks(self, n_prompt: int) -> tuple[int, int]:
        """(worst-case kept-data blocks, append blocks beyond them) for a
        prompt of ``n_prompt`` tokens — the admission cost model."""
        data = self.pool.blocks_for(min(n_prompt, self.capacity))
        appends = sum(1 for jb in self._append_jbs if jb >= data)
        return data, appends

    def _admission_gate(self, req: Request) -> bool:
        """The FCFS head admits only when the pool can cover its
        worst-case kept rows plus its whole future decode growth."""
        data, appends = self._request_blocks(len(req.prompt))
        return self.pool.available_blocks() >= data + appends

    def _paged_place(self, sched, r: Request, cache: dict) -> int:
        """Write the admitted cache's kept rows into freshly allocated
        blocks, reserve its append blocks and point a slot's table at them.
        Returns the slot.  Both allocations are covered by the admission
        gate's check: the kept rows never exceed ``min(n_prompt,
        capacity)``, and while this request prefilled, running slots could
        only draw on their own reservations, which available blocks
        already exclude."""
        mask = cache["attn"]["mask"]  # (L, 1, C, KV)
        rows = torch.arange(mask.shape[2], device=mask.device)[:, None]
        used = int(torch.where(mask, rows, 0).max()) + 1
        ids = self.pool.alloc(self.pool.blocks_for(used))
        outstanding = sum(1 for jb in self._append_jbs
                          if ids is not None and jb >= len(ids))
        if ids is None or not self.pool.reserve(outstanding):
            raise RuntimeError("kv pool could not place an admitted request "
                               "the admission gate let through")
        self.pool.write_cache(cache["attn"], ids)
        slot = sched.place(r)
        self._slot_reserved[slot] = outstanding
        self._slot_blocks[slot] = [int(b) for b in ids]
        self._table_h[slot] = 0
        self._table_h[slot, :len(ids)] = ids
        self._table_dev = self._to_dev(self._table_h)
        self._cursor_h[slot] = self.capacity  # appends start after the kept rows
        self._npos_h[slot] = int(cache["next_pos"][0, 0])
        return slot

    def _ensure_append_blocks(self, active, steps: int) -> None:
        """Allocate the append blocks every live slot needs for the next
        ``steps`` tokens, from its admission-time reservation (which cannot
        fail: reserved blocks stay on the free list)."""
        bs = self.pool.block_size
        changed = False
        for slot in np.nonzero(active)[0].tolist():
            cur = int(self._cursor_h[slot])
            last = min(cur + steps - 1, self._depth - 1)
            for jb in range(cur // bs, last // bs + 1):
                if self._table_h[slot, jb] != 0:
                    continue
                assert self._slot_reserved[slot] > 0, \
                    "append block outside the slot's reservation"
                ids = self.pool.alloc(1, from_reserved=True)
                self._slot_reserved[slot] -= 1
                # a reallocated block may carry its previous owner's
                # validity rows: invalidate before the table exposes it
                self.pool.zero_mask(ids)
                self._table_h[slot, jb] = int(ids[0])
                self._slot_blocks[slot].append(int(ids[0]))
                changed = True
        if changed:
            self._table_dev = self._to_dev(self._table_h)

    def _free_slot_blocks(self, slot: int) -> None:
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
