"""The port's observability (``repro_torch.obs`` and its wiring through
``ContinuousEngine`` and the launcher) against the JAX package's
``repro.obs``, on the CPU.

* (a) Registry: the same calls on both packages' ``MetricsRegistry`` give
  an equal ``snapshot()`` and byte-equal ``prometheus_text()`` (labels,
  histogram buckets, ``Info``, ``reset`` keeping callbacks, the numeric
  mirror of ``bind_stat_gauges``); a kind mismatch raises in both.
* (b) Trace utilities: one event list through both packages'
  ``validate_trace`` (the violations JAX rejects included),
  ``request_span_trees``, ``phase_table``, ``chrome_trace`` and the JSONL
  export, with equal results.
* (c) Engine parity: one seeded trace (``trace_utils.make_trace_requests``,
  every request arrived at 0) served by the JAX ``ContinuousEngine`` and
  by the port's, each with a ``TraceRecorder`` and a ``DriftMonitor``, on
  a paged pool small enough to preempt, with the pool-pinned prefix
  cache and decode-time eviction on (llama3-8b smoke, float32).  Equal:
  tokens; each request's span trees (names, nesting, every argument but
  the times); the engine track's decode chunks; every counter and gauge
  that is not a time; the TTFT histogram's count; the ``scheduler_*``
  gauges; the ``kv_pool_*`` and ``prefix_cache_*`` gauges on the keys
  both have (``ONLY_JAX`` lists the rest).  ``stats`` warns and mirrors
  the registry.
* (d) Drift: the oracle and predictor head scores of both monitors on
  the same records within ``SCORE_TOL`` (float32 through the same
  model); ``head_kept_sets`` / ``kept_overlaps`` exact on identical
  arrays; after the served run the port's ``lookahead_drift_overlap``
  within ``DRIFT_FLIPS`` flipped kept keys of JAX's (a near-tie in the
  scores can flip one kept key of one (layer, head) between the
  packages).
* (e) Launcher: ``--smoke --continuous --device cpu`` with
  ``--metrics-json``, ``--prom-snapshot`` and ``--trace-out`` writes
  files that parse; the lockstep route prints JAX's note.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import gc
import json
import re
import warnings
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.common.config import EvictionConfig as JEvict
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro.obs import DriftMonitor as JDrift
from repro.obs import TraceRecorder as JRecorder
from repro.obs import metrics as jmetrics
from repro.obs import quality as jquality
from repro.obs import trace as jtrace
from repro.serving import ChunkingConfig as JChunking
from repro.serving import ContinuousEngine as JEngine
from repro.serving import DecodeEvictionConfig as JDecodeEvict
from repro.serving import KVBlockPool as JPool
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import ServingConfig as JServing
from repro_torch import bridge
from repro_torch.common.config import EvictionConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.obs import DriftMonitor, TraceRecorder
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import quality as tquality
from repro_torch.obs import trace as ttrace
from repro_torch.serving import (ChunkingConfig, ContinuousEngine,
                                 DecodeEvictionConfig, KVBlockPool,
                                 PrefixCache, Request, ServingConfig)
from trace_utils import make_trace_requests

#: oracle / predictor head scores, port against JAX: float32 through the
#: same smoke model in another summation order
SCORE_TOL = dict(atol=1e-5, rtol=1e-4)
#: drift gauge, port against JAX: one flipped kept key in one (layer,
#: head) of one ring record moves the mean by 1 / (budget * L * H * ring)
DRIFT_FLIPS = 1


# ---------------------------------------------------------------------------
# (a) the registry
# ---------------------------------------------------------------------------


def _counters(m, state):
    reg = m.MetricsRegistry()
    c = reg.counter("requests_total", "Requests.", labelnames=("path",))
    c.inc(path="dense")
    c.inc(2, path="dense")
    c.inc(0.5, path="paged")
    reg.counter("plain_total", "No labels.\n  Two   lines.").inc(7)
    with pytest.raises(ValueError):
        c.inc(-1, path="dense")
    with pytest.raises(ValueError):  # wrong label set
        c.inc(mesh="x")
    return reg


def _gauges(m, state):
    reg = m.MetricsRegistry()
    g = reg.gauge("depth", "Queue depth.")
    g.set(3)
    g.inc(2)
    g.max(4)
    g.max(9.25)
    reg.gauge("live", "Live mirror.").set_fn(lambda: state["n"])
    lab = reg.gauge("per_slot", "Per slot.", labelnames=("slot", "pool"))
    lab.set(1, slot=0, pool="a")
    lab.set(2.5, slot=1, pool="a")
    reg.reset()  # set values restart, the callback survives
    g.inc(1)
    state["n"] = 11
    return reg


def _histograms(m, state):
    reg = m.MetricsRegistry()
    h = reg.histogram("lat", "Latency.", buckets=(1.0, 0.01, 0.1))
    for v in (0.005, 0.01, 0.05, 0.05, 0.5, 5.0):
        h.observe(v)
    d = reg.histogram("ttft_s", "Default buckets.", labelnames=("cell",))
    for v in (0.0005, 0.003, 0.7, 12.0):
        d.observe(v, cell="a")
    d.observe(0.2, cell="b")
    return reg


def _info(m, state):
    reg = m.MetricsRegistry()
    reg.info("build", "Build facts.").set(path="kernel", mesh=None,
                                          sync_timers=True)
    reg.counter("c", "A counter.").inc(5)
    reg.reset()  # the payload stays
    reg.info("build").set(path="plain", z=1)
    return reg


def _stat_gauges(m, state):
    reg = m.MetricsRegistry()
    stats = {"hits": 2, "rate": 0.5, "enabled": True, "keys": [1, 2],
             "path": "kernel", "bytes": 1 << 20}
    state["bound"] = m.bind_stat_gauges(reg, "comp", lambda: stats)
    stats["hits"] = 9
    return reg


@pytest.mark.parametrize("script", [_counters, _gauges, _histograms, _info,
                                    _stat_gauges],
                         ids=lambda f: f.__name__.strip("_"))
def test_registry_snapshot_and_prometheus_text_match_jax(script, tmp_path):
    states = [{"n": 7}, {"n": 7}]
    want = script(jmetrics, states[0])
    got = script(tmetrics, states[1])
    assert got.snapshot() == want.snapshot()
    assert got.prometheus_text() == want.prometheus_text()
    assert states[1].get("bound") == states[0].get("bound")
    want.to_json(str(tmp_path / "j.json"))
    got.to_json(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    if script is _stat_gauges:  # numeric keys only, read at collection
        assert sorted(states[1]["bound"]) == ["bytes", "hits", "rate"]
        assert got.value("comp_hits") == 9
    if script is _gauges:
        assert got.value("live") == 11 and got.value("depth") == 1


def test_registry_get_or_create_and_kind_mismatch():
    for m in (jmetrics, tmetrics):
        reg = m.MetricsRegistry()
        a = reg.counter("x", "first")
        assert reg.counter("x") is a
        with pytest.raises(TypeError, match="already registered as "
                                            "counter"):
            reg.gauge("x")
        assert "x" in reg and "y" not in reg
        assert reg.value("never", default=-1) == -1
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


# ---------------------------------------------------------------------------
# (b) the trace utilities
# ---------------------------------------------------------------------------


def _ev(ph, name, ts, tid, **args):
    return {"name": name, "ph": ph, "ts": ts, "tid": tid, "args": args}


#: two requests (uid 3 preempted and replayed) and the engine track
EVENTS = [
    _ev("B", "request", 0.0, "req:3", uid=3, admission_seq=0, n_prompt=40),
    _ev("B", "prefix_probe", 1.0, "req:3"),
    _ev("E", "prefix_probe", 2.0, "req:3", hit=True, depth=16),
    _ev("B", "prefill_chunk", 2.0, "req:3", s=16),
    _ev("E", "prefill_chunk", 9.5, "req:3"),
    _ev("B", "finalize", 9.5, "req:3"),
    _ev("E", "finalize", 12.0, "req:3"),
    _ev("i", "first_token", 12.5, "req:3", token=17),
    _ev("B", "decode", 12.5, "req:3"),
    _ev("B", "decode_chunk", 13.0, "engine", steps=1, slots=1),
    _ev("E", "decode_chunk", 14.0, "engine"),
    _ev("B", "request", 14.0, "req:5", uid=5, admission_seq=1, n_prompt=9),
    _ev("B", "prefill_chunk", 14.5, "req:5", s=0),
    _ev("E", "prefill_chunk", 15.0, "req:5"),
    _ev("B", "paged_sweep", 15.0, "req:3"),
    _ev("E", "paged_sweep", 16.0, "req:3", blocks_freed=2),
    _ev("i", "preempt", 16.5, "req:3", emitted=3),
    _ev("E", "decode", 16.5, "req:3"),
    _ev("E", "request", 16.5, "req:3", outcome="preempted"),
    _ev("B", "finalize", 17.0, "req:5"),
    _ev("E", "finalize", 18.0, "req:5"),
    _ev("i", "first_token", 18.0, "req:5", token=4),
    _ev("i", "retire", 18.0, "req:5", tokens=1),
    _ev("E", "request", 18.0, "req:5", outcome="done"),
    _ev("B", "request", 19.0, "req:3", uid=3, admission_seq=2, n_prompt=40,
        replay_of=0),
    _ev("B", "prefill_chunk", 19.0, "req:3", s=0),
    _ev("E", "prefill_chunk", 21.0, "req:3"),
    _ev("B", "finalize", 21.0, "req:3"),
    _ev("E", "finalize", 22.0, "req:3"),
    _ev("i", "first_token", 22.0, "req:3", token=17),
    _ev("B", "decode", 22.0, "req:3"),
    _ev("E", "decode", 30.0, "req:3"),
    _ev("B", "harvest", 30.0, "req:3"),
    _ev("E", "harvest", 31.0, "req:3"),
    _ev("i", "retire", 31.0, "req:3", tokens=4),
    _ev("E", "request", 31.0, "req:3", outcome="done"),
    _ev("B", "drift_eval", 31.5, "engine", records=2),
    _ev("E", "drift_eval", 40.0, "engine", overlap=0.75),
]


def test_trace_utilities_match_jax(tmp_path):
    assert ttrace.validate_trace(EVENTS) == jtrace.validate_trace(EVENTS) \
        == {"tracks": 3, "spans": 16, "events": len(EVENTS)}
    for uid in (3, 5, 9):  # 9: never admitted
        assert ttrace.request_span_trees(EVENTS, uid) == \
            jtrace.request_span_trees(EVENTS, uid)
    rows = ttrace.phase_table(EVENTS, [5, 3, 9])
    assert rows == jtrace.phase_table(EVENTS, [5, 3, 9])
    assert [r["outcome"] for r in rows] == ["done", "done", "missing"]
    assert rows[0]["replays"] == 1 and rows[0]["sweeps"] == 1
    assert ttrace.request_track(3) == jtrace.request_track(3) == "req:3"
    recs = (JRecorder(), TraceRecorder())
    for rec in recs:
        rec.events = list(EVENTS)
        rec.sync = False
    assert recs[1].chrome_trace() == recs[0].chrome_trace()
    for i, rec in enumerate(recs):
        rec.to_jsonl(str(tmp_path / f"{i}.jsonl"))
        rec.to_chrome(str(tmp_path / f"{i}.json"))
    for ext in ("jsonl", "json"):
        assert (tmp_path / f"1.{ext}").read_bytes() == \
            (tmp_path / f"0.{ext}").read_bytes()


@pytest.mark.parametrize("events", [
    [_ev("B", "a", 0, "t")],  # unclosed
    [_ev("B", "a", 0, "t"), _ev("B", "b", 1, "t"), _ev("E", "a", 2, "t"),
     _ev("E", "b", 3, "t")],  # crossed
    [_ev("B", "a", 5, "t"), _ev("E", "a", 1, "t")],  # time travel
    [_ev("E", "a", 0, "t")],  # end with nothing open
], ids=["unclosed", "crossed", "time-travel", "end-unopened"])
def test_validate_trace_rejects_what_jax_rejects(events):
    with pytest.raises(AssertionError) as want:
        jtrace.validate_trace(events)
    with pytest.raises(AssertionError) as got:
        ttrace.validate_trace(events)
    assert str(got.value) == str(want.value)


def test_recorder_spans_on_cpu_tensors():
    """``span(sync_on=)`` on CPU tensors records the span (nothing to wait
    for); the recorder's own events validate."""
    rec = TraceRecorder()
    with rec.span("work", rec.ENGINE, sync_on={"a": [torch.ones(2)]}, k=1):
        rec.instant("tick", rec.ENGINE)
    assert [(e["name"], e["ph"]) for e in rec.events] == [
        ("work", "B"), ("tick", "i"), ("work", "E")]
    assert rec.events[0]["args"] == {"k": 1}
    assert ttrace.validate_trace(rec) == {"tracks": 1, "spans": 1,
                                          "events": 3}


# ---------------------------------------------------------------------------
# (c) engine parity, (d) drift
# ---------------------------------------------------------------------------

CHUNK, BUDGET, MAX_NEW = 16, 8, 12
#: keys of the kv pool's and prefix cache's stats() only the JAX package
#: has (none since the pool took its mesh keys, ROADMAP A11)
ONLY_JAX: set = set()
#: shared keys whose values differ by design: JAX counts its compiled
#: materialize programs, the port compiles nothing (0)
DIFFERS = {"prefix_cache_materialize_programs"}


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jl = jax_init_lkv(jax.random.PRNGKey(1), jcfg, jp["layers"])
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    tl = bridge.to_torch(jax.tree.map(np.asarray, jl), device="cpu")
    reqs = make_trace_requests(jcfg, chunk=CHUNK, seed=5, n_requests=6,
                               max_new=MAX_NEW, suffix_lens=(0, 1, 21))
    prompts = [r.prompt for r in reqs]
    common = dict(policy="lookaheadkv", num_slots=3, max_new_tokens=MAX_NEW,
                  eos_id=-1, reserve_appends=False)
    drift_kw = dict(budget=BUDGET, ring_size=2, eval_every=2)

    jpool = JPool(jcfg, block_size=4, num_blocks=10)
    jtr, jdrift = JRecorder(), JDrift(jp, jcfg, jl, **drift_kw)
    jeng = JEngine(jp, jcfg, JServing(
        evict=JEvict(budget=BUDGET),
        chunking=JChunking(chunk=CHUNK, max_context=max(map(len, prompts)),
                           decode_chunk=1),
        decode_evict=JDecodeEvict(enabled=True, interval=8), kv_pool=jpool,
        prefix_cache=JPrefixCache(chunk=CHUNK, max_bytes=1 << 20,
                                  pool=jpool),
        trace=jtr, drift=jdrift, **common), lkv_params=jl)
    for r in reqs:
        r.arrival_s = 0.0
    jdone = jeng.run(reqs)

    tpool = KVBlockPool(tcfg, block_size=4, num_blocks=10, device="cpu")
    ttr, tdrift = TraceRecorder(), DriftMonitor(tp, tcfg, tl, **drift_kw)
    teng = ContinuousEngine(tp, tcfg, ServingConfig(
        evict=EvictionConfig(budget=BUDGET),
        chunking=ChunkingConfig(chunk=CHUNK,
                                max_context=max(map(len, prompts)),
                                decode_chunk=1),
        decode_evict=DecodeEvictionConfig(enabled=True, interval=8),
        kv_pool=tpool,
        prefix_cache=PrefixCache(chunk=CHUNK, max_bytes=1 << 20, pool=tpool),
        trace=ttr, drift=tdrift, **common), lkv_params=tl, device="cpu")
    tdone = teng.run([Request(uid=i, prompt=p, max_new_tokens=MAX_NEW)
                      for i, p in enumerate(prompts)])
    return dict(jeng=jeng, teng=teng, jtr=jtr, ttr=ttr, jdrift=jdrift,
                tdrift=tdrift, cfg=tcfg,
                jdone={r.uid: r for r in jdone},
                tdone={r.uid: r for r in tdone})


def test_served_trace_exercises_every_path(served):
    """Not vacuous: the run preempts, hits the prefix cache, sweeps and
    evaluates drift, in both packages alike."""
    t = served["teng"].metrics.value
    assert t("serving_preemptions_total") > 0
    assert t("serving_prefix_hits_total") > 0
    assert t("serving_decode_evict_sweeps_total") > 0
    assert t("lookahead_drift_evals") > 0
    assert served["teng"]._sync_timers and served["ttr"].sync


def test_engine_tokens_match_jax(served):
    assert sorted(served["tdone"]) == sorted(served["jdone"])
    for uid, want in served["jdone"].items():
        assert served["tdone"][uid].out_tokens == want.out_tokens, uid
        assert len(want.out_tokens) == MAX_NEW


def _timeless(node):
    """A span tree without its times: names, nesting and arguments."""
    return {"name": node["name"], "args": node["args"],
            "end_args": node["end_args"],
            "instants": [(i["name"], i["args"]) for i in node["instants"]],
            "children": [_timeless(c) for c in node["children"]]}


def test_span_trees_match_jax(served):
    """Per request, every serve attempt's tree: the same names, nesting
    and non-time arguments (outcome, hit, depth, replay_of, s, tokens,
    blocks_freed, ...), in JAX's order; and the trace validates."""
    ttrace.validate_trace(served["ttr"])
    replays = 0
    for uid in served["jdone"]:
        want = [_timeless(t) for t in
                jtrace.request_span_trees(served["jtr"], uid)]
        got = [_timeless(t) for t in
               ttrace.request_span_trees(served["ttr"], uid)]
        assert got == want, uid
        replays += len(got) - 1
        assert got[-1]["end_args"] == {"outcome": "done"}
    assert replays > 0


def test_engine_track_matches_jax(served):
    """The engine track's spans (decode chunks with their steps and slots,
    drift evaluations), JAX's compile instants aside (the port compiles
    nothing)."""
    def track(tr, drop_values):
        return [(e["name"], e["ph"],
                 {k: v for k, v in e["args"].items() if k not in drop_values})
                for e in tr.events if e["tid"] == "engine"
                and e["name"] != "jit_compile"]

    got = track(served["ttr"], {"overlap"})
    want = track(served["jtr"], {"overlap"})
    assert got == want
    assert ("drift_eval", "B", {"records": 2}) in got


def _values(eng, kinds):
    snap = eng.metrics.snapshot()
    return {series: val for name, m in snap.items() if m["kind"] in kinds
            for series, val in m["values"].items()}


def test_counters_and_gauges_match_jax(served):
    """Every counter and gauge that is not a time, the scheduler's, the
    pool's and the prefix cache's on their shared keys; the metric names,
    kinds and help texts of everything both register."""
    jsnap = served["jeng"].metrics.snapshot()
    tsnap = served["teng"].metrics.snapshot()
    only_jax = {n for n in jsnap if n not in tsnap}
    only_port = {n for n in tsnap if n not in jsnap}
    assert only_port == set()
    assert {n for n in only_jax if not n.startswith("compile_cache_")} \
        == ONLY_JAX
    for name in tsnap:
        assert (tsnap[name]["kind"], tsnap[name]["help"]) == \
            (jsnap[name]["kind"], jsnap[name]["help"]), name
    want = _values(served["jeng"], ("counter", "gauge"))
    got = _values(served["teng"], ("counter", "gauge"))
    keys = {k for k in got if "seconds" not in k
            and k != "lookahead_drift_overlap" and k not in DIFFERS}
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert {k for k in keys if k.startswith("scheduler_")} == {
        "scheduler_queue_depth", "scheduler_pending", "scheduler_running",
        "scheduler_free_slots", "scheduler_finished"}
    assert got["scheduler_finished"] == len(served["jdone"])
    assert {k.split("_")[0] for k in keys} >= {"kv", "prefix", "serving",
                                               "scheduler", "lookahead"}
    ttft = "serving_ttft_seconds"
    assert tsnap[ttft]["values"][ttft]["count"] == \
        jsnap[ttft]["values"][ttft]["count"] == len(served["jdone"])


def test_build_info_and_counts_view(served):
    teng = served["teng"]
    info = teng.metrics.value("serving_build")
    assert info == {"sync_timers": "True", "score_path": "torch-plain",
                    "decode_path": "paged-torch-plain", "mesh": "None"}
    c, v = teng.counts, teng.metrics.value
    assert c["prefill_chunks"] == v("serving_prefill_chunks_total")
    assert c["prefill_s"] == v("serving_prefill_seconds_total") > 0
    assert c["decode_s"] == v("serving_decode_seconds_total") > 0
    assert c["preemptions"] == v("serving_preemptions_total")
    assert c["prefix"]["prefix_hits"] == sum(
        r.cached_prefix_tokens > 0 for r in served["tdone"].values())
    assert isinstance(c["prefix_blocks_reclaimed"], int)
    with pytest.raises(TypeError):  # read-only
        c["decode_steps"] = 0


def test_stats_view_warns_and_mirrors_the_registry(served):
    teng, jeng = served["teng"], served["jeng"]
    with pytest.warns(DeprecationWarning, match="engine.metrics"):
        got = dict(teng.stats)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = dict(jeng.stats)
    assert set(got) == set(want)
    assert got["decode_time_s"] == pytest.approx(
        teng.metrics.value("serving_decode_seconds_total"))
    assert got["decode_path"] == teng.metrics.value(
        "serving_build")["decode_path"]
    for key in ("score_path", "decode_path", "decode_time_s"):
        got.pop(key), want.pop(key)
    for k in ONLY_JAX:
        want["kv_pool"].pop(k.removeprefix("kv_pool_"))
    for k in DIFFERS:
        got["prefix_cache"].pop(k.removeprefix("prefix_cache_"))
        want["prefix_cache"].pop(k.removeprefix("prefix_cache_"))
    assert got == want


def test_drift_scores_match_jax(served):
    """The oracle and predictor head scores of both monitors on the same
    records (the port's ring, which is JAX's)."""
    tdrift, jdrift = served["tdrift"], served["jdrift"]
    assert len(tdrift._ring) == len(jdrift._ring) == 2
    for (x, y), (jx, jy) in zip(tdrift._ring, jdrift._ring):
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        np.testing.assert_allclose(tdrift.gt_head_scores(x, y),
                                   jdrift.gt_head_scores(x, y), **SCORE_TOL)
        np.testing.assert_allclose(tdrift.pred_head_scores(x),
                                   jdrift.pred_head_scores(x), **SCORE_TOL)


def test_kept_sets_exact_on_identical_arrays():
    rng = np.random.default_rng(3)
    a = rng.random((2, 4, 40)).astype(np.float32)
    b = a.copy()
    b[:, :, ::5] = b[:, :, 1::5]  # exact ties
    for budget in (1, 8, 39):
        assert tquality.head_kept_sets(b, budget) == \
            jquality.head_kept_sets(b, budget)
        assert tquality.kept_overlaps(a, b, budget) == \
            jquality.kept_overlaps(a, b, budget)


def test_drift_gauge_matches_jax(served):
    cfg, tdrift = served["cfg"], served["tdrift"]
    t = served["teng"].metrics.value
    j = served["jeng"].metrics.value
    assert t("lookahead_drift_evals") == j("lookahead_drift_evals") > 0
    assert t("lookahead_drift_ring") == j("lookahead_drift_ring") == 2
    tol = DRIFT_FLIPS / (BUDGET * cfg.num_layers * cfg.attn.num_heads
                         * tdrift.ring_size)
    assert 0.0 <= t("lookahead_drift_overlap") <= 1.0
    assert abs(t("lookahead_drift_overlap")
               - j("lookahead_drift_overlap")) <= tol


def test_engine_is_freed_without_the_garbage_collector(served):
    """Observability adds no reference cycle through the engine or the
    drift monitor: once the last reference goes, the engine and the model
    weights are freed at once (the card's memory with them), with the
    cyclic collector off.  Also: ``counts`` read after a run keeps that
    run's values through the next run."""
    cfg = served["cfg"]
    teng = served["teng"]
    params = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in teng.params.items()}
    gc.disable()
    try:
        pool = KVBlockPool(cfg, block_size=4, num_blocks=32, device="cpu")
        eng = ContinuousEngine(params, cfg, teng.config.replace(
            kv_pool=pool, trace=TraceRecorder(),
            prefix_cache=PrefixCache(chunk=CHUNK, max_bytes=1 << 20,
                                     pool=pool),
            drift=DriftMonitor(params, cfg, teng.lkv_params, budget=BUDGET,
                               eval_every=1)), lkv_params=teng.lkv_params,
            device="cpu")
        prompt = served["tdone"][0].prompt
        eng.run([Request(uid=0, prompt=prompt, max_new_tokens=4)])
        assert eng.metrics.value("lookahead_drift_evals") == 1
        first = eng.counts
        eng.run([Request(uid=i, prompt=prompt, max_new_tokens=4)
                 for i in range(2)])
        assert first["decode_steps"] == 3
        assert eng.counts["decode_steps"] > 3
        eng.counts["prefix"], eng.metrics.prometheus_text()
        refs = weakref.ref(eng), weakref.ref(params["embed"])
        del eng, params, pool
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# (e) the launcher
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? '
                        r'-?[0-9.e+-]+$|^[a-zA-Z_:]+_info\{.*\} 1$')


def test_launcher_writes_metrics_and_trace(tmp_path, capsys):
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
            "--continuous", "--kv-pool-mb", "1", "--budget", "16",
            "--chunk", "32", "--n-in", "96", "--max-new", "4",
            "--metrics-json", str(tmp_path / "m.json"),
            "--prom-snapshot", str(tmp_path / "m.prom")]
    serve.main(argv + ["--trace-out", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    assert "pfx_skip" in out and "prefill_ms" in out  # the phase table
    snap = json.loads((tmp_path / "m.json").read_text())
    assert snap["serving_requests_retired_total"]["values"][
        "serving_requests_retired_total"] == 4
    assert snap["serving_build"]["values"]["serving_build"][
        "sync_timers"] == "True"
    lines = (tmp_path / "m.prom").read_text().splitlines()
    assert lines and all(line.startswith("# ") or _PROM_LINE.match(line)
                         for line in lines), lines
    chrome = json.loads((tmp_path / "t.json").read_text())
    assert chrome["otherData"]["sync_timers"] is True
    assert {e["name"] for e in chrome["traceEvents"]} >= {
        "request", "prefill_chunk", "finalize", "first_token", "decode",
        "decode_chunk", "retire", "thread_name"}
    res = serve.run(argv + ["--trace-out", str(tmp_path / "t.jsonl")])
    events = [json.loads(line) for line in
              (tmp_path / "t.jsonl").read_text().splitlines()]
    assert events == res["engine"].trace.events
    assert ttrace.validate_trace(events)["tracks"] == 5


@pytest.mark.parametrize("route", [[], ["--continuous", "--policy", "full"]],
                         ids=["lockstep", "bucketed"])
def test_launcher_notes_other_routes(route, tmp_path, capsys):
    serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                "--budget", "16", "--n-in", "48", "--max-new", "2",
                "--metrics-json", str(tmp_path / "m.json"),
                "--prom-snapshot", str(tmp_path / "m.prom"),
                "--trace-out", str(tmp_path / "t.json")] + route)
    out = capsys.readouterr().out
    for flag in ("--metrics-json", "--prom-snapshot", "--trace-out"):
        assert f"note: {flag} needs the chunked continuous engine; " \
               "skipped" in out
    assert not list(tmp_path.iterdir())
