"""Typed metrics registry of the port: Counter / Gauge / Histogram / Info
with labels, the JAX package's ``obs/metrics.py`` copied (the port imports
nothing of that package): the same calls give the same ``snapshot()`` and
byte-identical ``prometheus_text()``.

The registry is the serving stack's one metrics surface: engines and
components register named, typed, documented metrics.

* **Typed kinds.**  A ``Counter`` only goes up (within a run), a
  ``Gauge`` holds a last-write value, a ``Histogram`` accumulates a
  bucketed distribution, and an ``Info`` carries a small string->string
  payload (dispatch path, mesh) that has no numeric value.
* **Labels.**  A metric may declare label names; each distinct label
  tuple gets its own child series (Prometheus semantics).
* **Callback gauges.**  ``Gauge.set_fn`` binds a zero-argument callable
  evaluated at *collection* time: components (KV pool, prefix cache,
  scheduler) mirror their state without a single hot-path write.
* **Per-run semantics.**  Engine counters reset at ``run()`` start
  (``MetricsRegistry.reset``); callback gauges are left alone, since they
  mirror live component state with its own lifetime.
* **Timing semantics are part of the metric.**  Every timer's help
  string states whether it measures launches or synced execution (CUDA
  launches are asynchronous; see ``ContinuousEngine``'s ``sync_timers``).

Export: ``snapshot()`` (JSON-able dict), ``prometheus_text()`` (text
exposition format, histogram ``_bucket``/``_sum``/``_count`` series
included), ``value(name, **labels)`` for point reads.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Info", "MetricsRegistry",
           "DEFAULT_BUCKETS", "bind_stat_gauges"]

#: default histogram buckets (seconds): serving latencies from 0.5 ms to 10 s
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labelnames, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {tuple(labelnames)}, got {tuple(labels)}")
    return tuple(str(labels[k]) for k in labelnames)


def _series_name(name: str, labelnames, key: tuple) -> str:
    if not labelnames:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in zip(labelnames, key))
    return f"{name}{{{inner}}}"


class Metric:
    """Base: a named, typed, documented metric with optional labels."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: dict = {}  # label-value tuple -> series state

    # -- series plumbing -----------------------------------------------------
    def _get(self, labels: dict):
        key = _label_key(self.labelnames, labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._new_series()
        return s

    def _new_series(self):
        raise NotImplementedError

    def reset(self) -> None:
        self._series.clear()

    # -- export --------------------------------------------------------------
    def _series_value(self, s):
        raise NotImplementedError

    def collect(self) -> dict:
        """{"kind", "help", "labels", "values": {series_name: value}}."""
        return {
            "kind": self.kind,
            "help": self.help,
            "labels": list(self.labelnames),
            "values": {
                _series_name(self.name, self.labelnames, key):
                    self._series_value(s)
                for key, s in sorted(self._series.items())
            },
        }


class Counter(Metric):
    """Monotonically increasing count (within one ``reset`` epoch)."""

    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self._get(labels)[0] += amount

    def value(self, **labels) -> float:
        return self._get(labels)[0]

    def _series_value(self, s):
        v = s[0]
        return int(v) if float(v).is_integer() else v


class Gauge(Metric):
    """Last-written value, or a collection-time callback (``set_fn``)."""

    kind = "gauge"

    def _new_series(self):
        return {"value": 0.0, "fn": None}

    def set(self, value: float, **labels) -> None:
        s = self._get(labels)
        s["fn"], s["value"] = None, value

    def inc(self, amount: float = 1, **labels) -> None:
        self._get(labels)["value"] += amount

    def max(self, value: float, **labels) -> None:
        """Keep the running maximum (high-water observability)."""
        s = self._get(labels)
        s["value"] = max(s["value"], value)

    def set_fn(self, fn: Callable[[], float], **labels) -> None:
        """Bind a collection-time callback; re-binding replaces the old
        callback (a fresh component instance takes over the series)."""
        self._get(labels)["fn"] = fn

    def value(self, **labels) -> float:
        s = self._get(labels)
        return s["fn"]() if s["fn"] is not None else s["value"]

    def reset(self) -> None:
        # callback-backed series mirror live component state and survive;
        # set-value series restart at zero with the run
        for s in self._series.values():
            if s["fn"] is None:
                s["value"] = 0.0

    def _series_value(self, s):
        v = s["fn"]() if s["fn"] is not None else s["value"]
        return int(v) if float(v).is_integer() else v


class Histogram(Metric):
    """Cumulative bucketed distribution plus sum and count."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        assert self.buckets, "a histogram needs at least one bucket bound"

    def _new_series(self):
        return {"counts": [0] * (len(self.buckets) + 1),  # +inf tail
                "sum": 0.0, "count": 0}

    def observe(self, value: float, **labels) -> None:
        s = self._get(labels)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if value <= b:
                i = j
                break
        s["counts"][i] += 1
        s["sum"] += value
        s["count"] += 1

    def count(self, **labels) -> int:
        return self._get(labels)["count"]

    def sum(self, **labels) -> float:
        return self._get(labels)["sum"]

    def _series_value(self, s):
        cum, out = 0, {}
        for b, c in zip(self.buckets, s["counts"]):
            cum += c
            out[str(b)] = cum
        out["+Inf"] = cum + s["counts"][-1]
        return {"buckets": out, "sum": s["sum"], "count": s["count"]}


class Info(Metric):
    """A small string->string payload (dispatch path, mesh shape, …) —
    exported as a constant-1 series with the payload as labels, the
    Prometheus ``_info`` convention."""

    kind = "info"

    def _new_series(self):
        return {}

    def set(self, **payload) -> None:
        s = self._get({})
        s.clear()
        s.update({k: str(v) for k, v in payload.items()})

    def value(self) -> dict:
        return dict(self._get({}))

    def _series_value(self, s):
        return dict(s)


def bind_stat_gauges(registry: "MetricsRegistry", prefix: str, stats_fn,
                     keys: Optional[Sequence[str]] = None) -> list[str]:
    """Mirror a component's ``stats()`` dict as callback gauges.

    Each numeric key ``k`` becomes the gauge ``<prefix>_<k>`` whose value
    is ``stats_fn()[k]`` at collection time — zero hot-path writes, and a
    re-bound component (fresh instance, same registry) simply takes the
    series over.  ``keys=None`` samples ``stats_fn()`` once and binds
    every numeric entry (bools and non-numerics are skipped).  Returns
    the bound key list.
    """
    if keys is None:
        keys = [k for k, v in stats_fn().items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)]
    for k in keys:
        registry.gauge(
            f"{prefix}_{k}",
            f"Live mirror of the component's stats()[{k!r}] "
            "(callback gauge, evaluated at collection time).",
        ).set_fn(lambda k=k: float(stats_fn()[k]))
    return list(keys)


class MetricsRegistry:
    """Named registry of typed metrics; the serving stack's one surface.

    ``counter/gauge/histogram/info`` are get-or-create: re-registering a
    name returns the existing metric (components re-bound across engine
    runs share series), and a kind mismatch fails loudly.
    """

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _register(self, cls, name, help, labelnames=(), **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m
        m = self._metrics[name] = cls(name, help, labelnames, **kw)
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def info(self, name, help="") -> Info:
        return self._register(Info, name, help)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def value(self, name: str, default=0, **labels):
        """Point read of one series (0/default when never touched)."""
        m = self._metrics.get(name)
        if m is None:
            return default
        if isinstance(m, Info):
            return m.value()
        return m.value(**labels)

    def reset(self) -> None:
        """Start a fresh collection epoch: counters, histograms and
        set-value gauges restart at zero; callback gauges (live component
        mirrors) and Info payloads are untouched."""
        for m in self._metrics.values():
            if not isinstance(m, Info):
                m.reset()

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able snapshot of every metric (callbacks evaluated now)."""
        return {name: m.collect()
                for name, m in sorted(self._metrics.items())}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def prometheus_text(self) -> str:  # noqa: C901 - one format, one place
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            col = m.collect()
            if m.help:
                lines.append(f"# HELP {name} {' '.join(m.help.split())}")
            lines.append(f"# TYPE {name} "
                         f"{'gauge' if m.kind == 'info' else m.kind}")
            for series, val in col["values"].items():
                if m.kind == "histogram":
                    base, _, rest = series.partition("{")
                    inner = rest[:-1] if rest else ""
                    for le, c in val["buckets"].items():
                        lbl = f"{inner},le=\"{le}\"" if inner \
                            else f"le=\"{le}\""
                        lines.append(f"{base}_bucket{{{lbl}}} {c}")
                    suffix = f"{{{inner}}}" if inner else ""
                    lines.append(f"{base}_sum{suffix} {val['sum']}")
                    lines.append(f"{base}_count{suffix} {val['count']}")
                elif m.kind == "info":
                    inner = ",".join(f'{k}="{v}"'
                                     for k, v in sorted(val.items()))
                    lines.append(f"{name}_info{{{inner}}} 1")
                else:
                    lines.append(f"{series} {val}")
        return "\n".join(lines) + "\n"
