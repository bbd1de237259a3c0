"""Observability of the port's serving stack, after the JAX package's
``obs``:

* ``obs.metrics``  — a typed metrics registry (Counter / Gauge /
  Histogram / Info, optional labels), the engine's one record, with
  JSON-snapshot and Prometheus text-exposition export.  Component state
  (pool, prefix cache, scheduler) is mirrored through *callback-backed*
  gauges evaluated at collection time: binding a component costs nothing
  on the hot path.
* ``obs.trace``    — per-request span tracing (admission → prefix-cache
  probe → prefill chunks → decode → sweeps → preemption/replay →
  retirement/harvest), exported as JSONL and as Chrome trace-event JSON
  viewable in Perfetto.
* ``obs.quality``  — the streaming lookahead drift monitor: retired
  requests are sampled into a held-out ring and periodically re-scored
  against the frozen-model oracle, exposing per-(layer, head) kept-set
  overlap as a gauge.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Info,
                                     MetricsRegistry)
from repro_torch.obs.quality import (DriftMonitor, head_kept_sets,
                                     kept_overlaps)
from repro_torch.obs.trace import (TraceRecorder, phase_table,
                                   request_span_trees, validate_trace)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Info",
    "TraceRecorder", "validate_trace", "request_span_trees", "phase_table",
    "DriftMonitor", "head_kept_sets", "kept_overlaps",
]
