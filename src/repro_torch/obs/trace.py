"""Per-request span tracing for the serving engine, Perfetto-viewable:
the JAX package's ``obs/trace.py`` copied, with its one device call
(``span(sync_on=)``) made a CUDA synchronisation.

``TraceRecorder`` collects begin/end/instant events on named *tracks*:
one track per request (``req:<uid>``) plus one engine track for work
that spans slots (decode chunks, drift evaluations).  The per-request
span tree is::

    request {admission_seq, replay_of?}          ── track req:<uid>
      prefix_probe {hit, depth}                  (prefix cache enabled)
      prefill_chunk {s} × ceil(n/chunk)
      finalize
      i first_token
      decode {…}
        paged_sweep {blocks_freed} × k           (decode-time eviction)
      harvest                                    (capture hook installed)
      i retire | i preempt
    [end] request {outcome: done|preempted|admission_blocked}

A preempted request's spans are *closed* at preemption (outcome
``preempted``); its re-serve opens a fresh ``request`` span whose
``replay_of`` arg carries the original admission's ``admission_seq``.

**Device-time attribution.**  Span end timestamps are host stamps, and
CUDA launches return before the work runs: a bare stamp times the launch
queue, not the work.  The engine therefore synchronises its device
before closing timing-sensitive spans whenever tracing is enabled
(``ContinuousEngine`` ``sync_timers``), so spans measure synced
execution at chunk granularity.  ``TraceRecorder.sync`` records which
semantics a given trace was captured under.  On the CPU there is
nothing to wait for.

Export: ``to_jsonl`` (one raw event per line) and ``to_chrome`` /
``chrome_trace`` (Chrome trace-event JSON: load the file in Perfetto's
https://ui.perfetto.dev or ``chrome://tracing``).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Optional

__all__ = ["TraceRecorder", "validate_trace", "request_span_trees",
           "phase_table"]

ENGINE_TRACK = "engine"


def request_track(uid: int) -> str:
    return f"req:{uid}"


def sync_devices(tree) -> None:
    """Wait for the work queued on every CUDA device holding a tensor of
    ``tree`` (a tensor, or a dict / list / tuple nesting them)."""
    import torch

    devices, stack = set(), [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class TraceRecorder:
    """Append-only event recorder with one ``perf_counter`` epoch.

    Events are plain dicts ``{"name", "ph", "ts", "tid", "args"}`` with
    ``ph`` in B (begin), E (end), i (instant) and ``ts`` in microseconds
    since the recorder's epoch.  Per-track event order is append order,
    so timestamps are monotone per track by construction.
    """

    ENGINE = ENGINE_TRACK

    def __init__(self, *, sync: bool = True):
        #: whether span ends were device-synced (see module docstring)
        self.sync = sync
        self.events: list[dict] = []
        self._t0 = time.perf_counter()

    # -- recording -----------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ph: str, name: str, tid: str, args: Optional[dict]):
        self.events.append({"name": name, "ph": ph, "ts": self.now_us(),
                            "tid": tid, "args": args or {}})

    def begin(self, name: str, tid: str, **args) -> None:
        self._emit("B", name, tid, args)

    def end(self, name: str, tid: str, **args) -> None:
        self._emit("E", name, tid, args)

    def instant(self, name: str, tid: str, **args) -> None:
        self._emit("i", name, tid, args)

    @contextmanager
    def span(self, name: str, tid: str, sync_on=None, **args):
        """Timed span; synchronises the CUDA devices of ``sync_on`` (a
        tensor, or a dict / list / tuple nesting them) before the end
        stamp when the recorder is sync-mode: the device-time attribution
        fix for asynchronous launches.  CPU tensors need no wait."""
        self.begin(name, tid, **args)
        try:
            yield
        finally:
            if sync_on is not None and self.sync:
                sync_devices(sync_on)
            self.end(name, tid)

    # -- export --------------------------------------------------------------
    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON dict (Perfetto-loadable): tracks map to
        tids under one pid, named via ``thread_name`` metadata."""
        tids: dict[str, int] = {ENGINE_TRACK: 0}
        out = []
        for e in self.events:
            tid = tids.setdefault(e["tid"], len(tids))
            out.append({"name": e["name"], "ph": e["ph"], "ts": e["ts"],
                        "pid": 0, "tid": tid, "args": e["args"],
                        **({"s": "t"} if e["ph"] == "i" else {})})
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": i,
                 "args": {"name": track}} for track, i in tids.items()]
        meta += [{"name": "thread_sort_index", "ph": "M", "pid": 0,
                  "tid": i, "args": {"sort_index": i}}
                 for i in tids.values()]
        return {"traceEvents": meta + out,
                "otherData": {"sync_timers": self.sync}}

    def to_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def _events_of(trace) -> list[dict]:
    return trace.events if isinstance(trace, TraceRecorder) else list(trace)


def validate_trace(trace) -> dict:
    """Assert the structural span invariants over a whole trace:

    * per track, B/E events are properly nested and name-matched;
    * every opened span is closed (no dangling B at end-of-trace);
    * timestamps are monotone non-decreasing per track.

    Returns summary counts ``{"tracks", "spans", "events"}``; raises
    ``AssertionError`` with the offending track/event on violation.
    """
    events = _events_of(trace)
    stacks: dict[str, list] = {}
    last_ts: dict[str, float] = {}
    spans = 0
    for e in events:
        tid = e["tid"]
        assert e["ts"] >= last_ts.get(tid, 0.0), \
            f"track {tid}: timestamp moved backwards at {e['name']!r}"
        last_ts[tid] = e["ts"]
        stack = stacks.setdefault(tid, [])
        if e["ph"] == "B":
            stack.append(e["name"])
        elif e["ph"] == "E":
            assert stack, f"track {tid}: end {e['name']!r} with no open span"
            top = stack.pop()
            assert top == e["name"], \
                f"track {tid}: end {e['name']!r} crosses open {top!r}"
            spans += 1
    for tid, stack in stacks.items():
        assert not stack, f"track {tid}: unclosed spans {stack}"
    return {"tracks": len(stacks), "spans": spans, "events": len(events)}


def request_span_trees(trace, uid: int) -> list[dict]:
    """The request's span forest, one tree per serve attempt (original +
    replays), each node ``{"name", "ts", "dur_us", "args", "end_args",
    "children", "instants"}``."""
    tid = request_track(uid)
    roots: list[dict] = []
    stack: list[dict] = []
    for e in _events_of(trace):
        if e["tid"] != tid:
            continue
        if e["ph"] == "B":
            node = {"name": e["name"], "ts": e["ts"], "dur_us": 0.0,
                    "args": e["args"], "end_args": {}, "children": [],
                    "instants": []}
            (stack[-1]["children"] if stack else roots).append(node)
            stack.append(node)
        elif e["ph"] == "E":
            node = stack.pop()
            node["dur_us"] = e["ts"] - node["ts"]
            node["end_args"] = e["args"]
        else:  # instant
            if stack:
                stack[-1]["instants"].append(
                    {"name": e["name"], "ts": e["ts"], "args": e["args"]})
    return roots


def _walk(node):
    yield node
    for c in node["children"]:
        yield from _walk(c)


def phase_table(trace, uids) -> list[dict]:
    """Per-request phase-latency breakdown from the span trees — the
    table ``launch/serve.py`` prints in place of the old flat stats dump.

    One row per uid: prefix-skipped tokens, total prefill time (chunk
    spans + finalize), time from first serve attempt to the first-token
    instant, decode-span time, sweep count/time, replay count, and the
    final outcome.  Times in milliseconds; a request with no closed tree
    (never admitted) yields a row with ``outcome="missing"``.
    """
    rows = []
    for uid in sorted(uids):
        trees = request_span_trees(trace, uid)
        if not trees:
            rows.append({"uid": uid, "outcome": "missing"})
            continue
        row = {"uid": uid, "prefix_skip_tokens": 0, "prefill_ms": 0.0,
               "first_token_ms": None, "decode_ms": 0.0, "sweeps": 0,
               "sweep_ms": 0.0, "replays": len(trees) - 1,
               "outcome": trees[-1]["end_args"].get("outcome", "open")}
        t_start = trees[0]["ts"]
        for tree in trees:
            for node in _walk(tree):
                if node["name"] in ("prefill_chunk", "finalize"):
                    row["prefill_ms"] += node["dur_us"] / 1e3
                elif node["name"] == "decode":
                    row["decode_ms"] += node["dur_us"] / 1e3
                elif node["name"] == "paged_sweep":
                    row["sweeps"] += 1
                    row["sweep_ms"] += node["dur_us"] / 1e3
                elif node["name"] == "prefix_probe":
                    row["prefix_skip_tokens"] = max(
                        row["prefix_skip_tokens"],
                        int(node["end_args"].get("depth", 0)))
                for i in node["instants"]:
                    if (i["name"] == "first_token"
                            and row["first_token_ms"] is None):
                        row["first_token_ms"] = (i["ts"] - t_start) / 1e3
        rows.append(row)
    return rows
