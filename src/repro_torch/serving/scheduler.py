"""Request-level scheduling for continuous-batching serving.

The scheduler owns everything *about requests* and nothing about tensors:
a FCFS arrival queue, a fixed set of decode slots, and the per-request
state machine

    QUEUED ──admit──> PREFILL ──place──> DECODE ──retire──> DONE
       ▲                  │                  │
       └── push_front ────┘                  │  (pool dry at admission)
       └── requeue ──────────────────────────┘  (preempted to the queue)

The port's copy of the JAX package's ``serving/scheduler.py`` (no
tensors, no framework).  ``ContinuousEngine`` (engine.py) drives it with
a *token-budget step*: each engine iteration spends ``token_budget``
tokens of work, split between one decode chunk for every live slot and
as many prefill chunks of the in-flight prompt as the leftover budget
covers (``plan_step``).  Decode therefore advances every iteration — a
16k prompt streams through in chunk-sized slices between decode chunks
instead of stalling every live slot for its whole forward pass.
``next_request`` hands the engine the FCFS head once a slot is free;
``next_prefill_group`` hands ``BucketedEngine`` the head and every other
arrived request of its prompt-length bucket.

Timing is per-request: TTFT is measured from the moment a request
becomes schedulable (its arrival) to its first emitted token, TPOT is
the mean inter-token time after the first, and ``max_gap_s`` records the
worst stall between consecutive token emissions (the decode-stall metric
of the serving benchmarks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import numpy as np


def plan_step(
    *,
    token_budget: int,
    chunk: int,
    n_active: int,
    decode_steps: int,
    prefill_pending: bool,
) -> tuple[int, int]:
    """Split one engine iteration's token budget between decode and prefill.

    Decode is first-class: every live slot advances ``decode_steps`` tokens
    each iteration.  The remaining budget buys prefill chunks for the
    in-flight prompt — at least one whenever a prefill is pending (progress
    guarantee), at most what the budget covers (decode-latency guarantee:
    no live slot waits longer than one token-budget step between its decode
    chunks).  Returns (decode_steps, prefill_chunks).
    """
    assert token_budget > 0 and chunk > 0
    d = decode_steps if n_active > 0 else 0
    room = max(token_budget - n_active * d, 0)
    p = 0
    if prefill_pending:
        p = max(room // chunk, 1)
    return d, p


class RequestState(str, Enum):
    QUEUED = "queued"      # submitted (possibly not yet arrived)
    PREFILL = "prefill"    # pulled into a prefill micro-batch
    DECODE = "decode"      # occupying a decode slot
    DONE = "done"


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (n_in,) int32
    max_new_tokens: int
    out_tokens: list = field(default_factory=list)
    ttft_s: float = 0.0
    done: bool = False
    # per-request randomness (the ``random`` eviction policy, ROADMAP A3)
    # — defaults to ``uid`` so two requests never share an eviction pattern
    seed: Optional[int] = None
    # -- continuous-batching fields ------------------------------------
    arrival_s: float = 0.0  # trace-clock offset at which the request arrives
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    enqueue_s: float = 0.0  # engine clock when the request became schedulable
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    tpot_s: float = 0.0  # mean seconds per output token after the first
    max_gap_s: float = 0.0  # worst stall between consecutive token emissions
    # wall time of the last token emitted before a preemption, so the
    # client-visible stall (preempt -> re-admission re-emit) still lands
    # in ``max_gap_s`` even though the request changes slots
    preempt_emit_s: Optional[float] = None
    cached_prefix_tokens: int = 0  # prompt tokens resumed from a cache hit
    admission_cache: Optional[dict] = None  # mask/pos of the admitted cache
    # (engine's ``capture_admission`` debug flag; the parity tests compare
    # kept sets through this)
    retirement_cache: Optional[dict] = None  # mask/pos at retirement: the
    # paged engine's final kept set (same flag; None on the dense engine)

    @property
    def eviction_seed(self) -> int:
        return self.uid if self.seed is None else self.seed


class SlotScheduler:
    """Fixed decode slots + FCFS arrival queue, with an optional admission
    gate (the paged engine's free-block check) and, for the bucket-padded
    engine, bucket-grouped admission: ``bucket_for`` maps a prompt length
    to its bucket, and a group is the queue head plus every other arrived
    request of the head's bucket, capped by the free slots and
    ``max_prefill_batch``."""

    def __init__(
        self,
        num_slots: int,
        *,
        bucket_for: Optional[Callable[[int], int]] = None,
        max_prefill_batch: Optional[int] = None,
        admission_gate: Optional[Callable[[Request], bool]] = None,
    ):
        assert num_slots > 0
        self.num_slots = num_slots
        self._bucket_for = bucket_for
        self.max_prefill_batch = max_prefill_batch or num_slots
        # paged-KV admission: with a block pool bound, a free slot is no
        # longer sufficient — the gate checks the pool can cover the FCFS
        # head's worst-case block need before the engine starts its prefill
        self._admission_gate = admission_gate
        self._pending: list[Request] = []  # submitted, arrival in the future
        self._queue: list[Request] = []  # arrived, awaiting admission (FCFS)
        self._free: list[int] = list(range(num_slots - 1, -1, -1))
        self.running: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.preemptions = 0

    # -- intake ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.state = RequestState.QUEUED
        req.enqueue_s = req.arrival_s
        self._pending.append(req)
        self._pending.sort(key=lambda r: r.arrival_s)

    def poll_arrivals(self, now: float) -> None:
        while self._pending and self._pending[0].arrival_s <= now:
            self._queue.append(self._pending.pop(0))

    def next_arrival(self) -> Optional[float]:
        return self._pending[0].arrival_s if self._pending else None

    # -- state ----------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self._pending or self._queue or self.running)

    def has_arrived(self, now: float) -> bool:
        """True when a request is admissible right now (arrived, queued)."""
        self.poll_arrivals(now)
        return bool(self._queue)

    # -- admission / retirement ------------------------------------------
    def next_request(self, now: float) -> Optional[Request]:
        """FCFS head for chunked prefill (one in-flight prompt at a time),
        or None when nothing has arrived, no slot is free to land in, or
        the admission gate (paged KV: free-block count) rejects the head.
        The gate blocks FCFS — no skip-ahead — so admission order, and
        therefore served tokens, stay deterministic under memory
        pressure."""
        self.poll_arrivals(now)
        if not self._queue or not self._free:
            return None
        if (self._admission_gate is not None
                and not self._admission_gate(self._queue[0])):
            return None
        req = self._queue.pop(0)
        req.state = RequestState.PREFILL
        return req

    def push_front(self, req: Request) -> None:
        """Return an un-placed request (admission found the pool dry after
        its prefill) to the queue head; it re-prefills when blocks free."""
        req.state = RequestState.QUEUED
        self._queue.insert(0, req)

    def requeue(self, req: Request) -> int:
        """Preempt-to-queue (paged KV, pool dry): move a *running* request
        back to the head of the arrival queue.  Its slot frees, its decode
        state is abandoned (the engine released the blocks), and it
        re-prefills from scratch when blocks are available; greedy decode
        is deterministic, so the re-served tokens are identical.  Returns
        the freed slot."""
        slot = req.slot
        if slot is None or self.running.get(slot) is not req:
            raise ValueError(f"request {req.uid} is not running")
        del self.running[slot]
        self._free.append(slot)
        req.slot = None
        req.state = RequestState.QUEUED
        req.done = False
        self.preemptions += 1
        self._queue.insert(0, req)
        return slot

    def next_prefill_group(self, now: float) -> Optional[list[Request]]:
        """The next same-bucket admission group (``bucket_for``), or None
        when nothing is admissible (no arrived request, or no free
        slot)."""
        if self._bucket_for is None:
            raise ValueError("next_prefill_group needs bucket_for")
        self.poll_arrivals(now)
        if not self._queue or not self._free:
            return None
        cap = min(len(self._free), self.max_prefill_batch)
        head_bucket = self._bucket_for(len(self._queue[0].prompt))
        group = [r for r in self._queue
                 if self._bucket_for(len(r.prompt)) == head_bucket][:cap]
        for r in group:
            self._queue.remove(r)
            r.state = RequestState.PREFILL
        return group

    def place(self, req: Request) -> int:
        slot = self._free.pop()
        req.slot = slot
        req.state = RequestState.DECODE
        self.running[slot] = req
        return slot

    def prefix_stats(self) -> dict:
        """Prefix reuse over the finished requests: how many admissions
        hit the prompt cache and what share of all prompt tokens came
        from cached prefixes."""
        total = sum(len(r.prompt) for r in self.finished)
        cached = sum(r.cached_prefix_tokens for r in self.finished)
        hits = sum(1 for r in self.finished if r.cached_prefix_tokens > 0)
        return {
            "requests": len(self.finished),
            "prefix_hits": hits,
            "hit_rate": hits / len(self.finished) if self.finished else 0.0,
            "cached_tokens": cached,
            "prompt_tokens": total,
            "cached_token_frac": cached / total if total else 0.0,
        }

    def bind_metrics(self, registry) -> None:
        """Mirror scheduler occupancy as ``scheduler_*`` callback gauges.
        The engine builds a fresh scheduler per ``run()`` and re-binds it;
        ``set_fn`` re-binding hands the series to the new instance."""
        registry.gauge(
            "scheduler_queue_depth",
            "Arrived requests awaiting admission (FCFS queue)."
        ).set_fn(lambda: len(self._queue))
        registry.gauge(
            "scheduler_pending",
            "Submitted requests whose arrival offset is in the future."
        ).set_fn(lambda: len(self._pending))
        registry.gauge(
            "scheduler_running",
            "Requests currently occupying a decode slot."
        ).set_fn(lambda: len(self.running))
        registry.gauge(
            "scheduler_free_slots", "Decode slots with no request placed."
        ).set_fn(lambda: len(self._free))
        registry.gauge(
            "scheduler_finished", "Requests retired so far this run."
        ).set_fn(lambda: len(self.finished))

    def retire(self, req: Request, *, now: float) -> int:
        """Free the request's slot; returns it for the engine to reuse."""
        slot = req.slot
        del self.running[slot]
        self._free.append(slot)
        req.state = RequestState.DONE
        req.done = True
        req.finish_s = now
        n = len(req.out_tokens)
        if req.first_token_s is not None and n > 1:
            req.tpot_s = (now - req.first_token_s) / (n - 1)
        self.finished.append(req)
        return slot
