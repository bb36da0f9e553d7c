"""Process-global metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``repro.obs.metrics``. Plain-Python host-side telemetry: nothing
here touches a tensor, so recording a metric never changes a result. All
mutation happens under one lock, so the `PeriodicDumper` thread and
driver threads can hammer the same registry concurrently.

Series are keyed by ``(name, sorted labels)``:

    counter("service.requeues", route="bucket")      # += 1
    gauge("service.pending", 3.0)
    observe("service.solve_latency.s", 0.042, route="bucket")

A per-name series-cardinality cap guards against label explosions: past
``max_series`` distinct label sets, new series collapse into a single
``{"overflow": "true"}`` series and ``obs.series_overflow`` counts the
collapses — telemetry degrades instead of eating the heap.

Export paths: ``snapshot()`` (plain dict), ``to_jsonl()`` (one JSON object
per series line), ``render()`` (Prometheus text exposition), ``dump_json()``
(snapshot + span aggregates as one JSON document — the format the
``--metrics-json`` CLI flags write and ``tests/data/metrics_schema.json``
pins), and ``PeriodicDumper`` (background thread re-dumping every
``interval_s``).
"""
from __future__ import annotations

import json
import os
import threading
import time

# seconds-scale latency edges; every histogram bucket list ends at +inf
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float("inf"))

_OVERFLOW_LABELS = (("overflow", "true"),)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Registry:
    """Thread-safe container of labeled counter/gauge/histogram series."""

    def __init__(self, max_series: int = 1024):
        self.max_series = max_series
        self._lock = threading.Lock()
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        # name -> (edges, {labels: [counts per edge, sum, count]})
        self._hists: dict[str, tuple[tuple, dict[tuple, list]]] = {}

    # ------------------------------------------------------------ recording
    def _series(self, table: dict, name: str, labels: dict) -> tuple:
        key = _label_key(labels)
        series = table.setdefault(name, {})
        if key not in series and len(series) >= self.max_series:
            self._counters.setdefault("obs.series_overflow", {})
            ov = self._counters["obs.series_overflow"]
            ov[(("name", name),)] = ov.get((("name", name),), 0.0) + 1.0
            return _OVERFLOW_LABELS
        return key

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        """Add ``value`` (default 1) to the counter series. ``value=0``
        pre-registers the series so dumps carry it before the first event."""
        with self._lock:
            key = self._series(self._counters, name, labels)
            tbl = self._counters[name]
            tbl[key] = tbl.get(key, 0.0) + float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            key = self._series(self._gauges, name, labels)
            self._gauges[name][key] = float(value)

    def observe(self, name: str, value: float,
                buckets: tuple | None = None, **labels) -> None:
        """Record ``value`` into the fixed-bucket histogram ``name``. Bucket
        edges are fixed at the first observation (``buckets=`` or the
        default latency ladder); later ``buckets=`` args are ignored so
        every series of one name shares comparable edges. Stored counts are
        per-bucket (``counts[i]`` counts values in ``(edges[i-1],
        edges[i]]``); `render` cumulates them into Prometheus ``le``
        buckets."""
        v = float(value)
        with self._lock:
            if name not in self._hists:
                edges = tuple(buckets) if buckets else DEFAULT_BUCKETS
                if edges[-1] != float("inf"):
                    edges = edges + (float("inf"),)
                self._hists[name] = (edges, {})
            edges, series = self._hists[name]
            key = _label_key(labels)
            if key not in series:
                if len(series) >= self.max_series:
                    # inline (lock already held — counter() would deadlock)
                    ov = self._counters.setdefault("obs.series_overflow", {})
                    k2 = (("name", name),)
                    ov[k2] = ov.get(k2, 0.0) + 1.0
                    key = _OVERFLOW_LABELS
                if key not in series:
                    series[key] = [[0] * len(edges), 0.0, 0]
            h = series[key]
            for i, edge in enumerate(edges):
                if v <= edge:
                    h[0][i] += 1
                    break
            h[1] += v
            h[2] += 1

    def histogram(self, name: str, buckets: tuple | None = None,
                  **labels) -> None:
        """Pre-register an empty histogram series (zero counts, sum 0,
        count 0) so dumps carry it before the first `observe` — the
        histogram analogue of ``counter(name, 0)``. Bucket edges fix here
        exactly as at a first observation; a series that already exists is
        left untouched."""
        with self._lock:
            if name not in self._hists:
                edges = tuple(buckets) if buckets else DEFAULT_BUCKETS
                if edges[-1] != float("inf"):
                    edges = edges + (float("inf"),)
                self._hists[name] = (edges, {})
            edges, series = self._hists[name]
            key = _label_key(labels)
            if key not in series:
                if len(series) >= self.max_series:
                    ov = self._counters.setdefault("obs.series_overflow", {})
                    k2 = (("name", name),)
                    ov[k2] = ov.get(k2, 0.0) + 1.0
                    key = _OVERFLOW_LABELS
                if key not in series:
                    series[key] = [[0] * len(edges), 0.0, 0]

    # ------------------------------------------------------------- reading
    def value(self, name: str, **labels) -> float:
        """Current value of one counter/gauge series (0 when absent)."""
        key = _label_key(labels)
        with self._lock:
            if name in self._counters:
                return self._counters[name].get(key, 0.0)
            if name in self._gauges:
                return self._gauges[name].get(key, 0.0)
        return 0.0

    def total(self, name: str) -> float:
        """Sum of a counter's value across all its label series."""
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def snapshot(self) -> dict:
        """Plain-dict view of every series (stable shapes — this is the
        object ``tests/data/metrics_schema.json`` describes)."""
        with self._lock:
            out = dict(counters={}, gauges={}, histograms={})
            for name, series in self._counters.items():
                out["counters"][name] = [
                    dict(labels=dict(k), value=v)
                    for k, v in sorted(series.items())]
            for name, series in self._gauges.items():
                out["gauges"][name] = [
                    dict(labels=dict(k), value=v)
                    for k, v in sorted(series.items())]
            for name, (edges, series) in self._hists.items():
                out["histograms"][name] = [
                    dict(labels=dict(k),
                         edges=[e if e != float("inf") else "inf"
                                for e in edges],
                         counts=list(h[0]), sum=h[1], count=h[2])
                    for k, h in sorted(series.items())]
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # ------------------------------------------------------------- export
    def to_jsonl(self) -> str:
        """One JSON object per series line (counters/gauges: kind, name,
        labels, value; histograms: + edges/counts/sum/count)."""
        snap = self.snapshot()
        lines = []
        for kind_key, kind in (("counters", "counter"), ("gauges", "gauge"),
                               ("histograms", "histogram")):
            for name in sorted(snap[kind_key]):
                for s in snap[kind_key][name]:
                    rec = dict(kind=kind, name=name, **s)
                    lines.append(json.dumps(rec, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def render(self) -> str:
        """Prometheus text exposition (dots in names become underscores;
        histogram series render as cumulative ``_bucket{le=}`` lines plus
        ``_sum`` / ``_count``)."""
        def prom_name(name: str) -> str:
            return name.replace(".", "_").replace("-", "_")

        def prom_labels(labels: tuple, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in labels]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines = []
        with self._lock:
            for name in sorted(self._counters):
                pn = prom_name(name)
                lines.append(f"# TYPE {pn} counter")
                for k, v in sorted(self._counters[name].items()):
                    lines.append(f"{pn}{prom_labels(k)} {v:g}")
            for name in sorted(self._gauges):
                pn = prom_name(name)
                lines.append(f"# TYPE {pn} gauge")
                for k, v in sorted(self._gauges[name].items()):
                    lines.append(f"{pn}{prom_labels(k)} {v:g}")
            for name in sorted(self._hists):
                edges, series = self._hists[name]
                pn = prom_name(name)
                lines.append(f"# TYPE {pn} histogram")
                for k, (counts, total, count) in sorted(series.items()):
                    cum = 0
                    for edge, c in zip(edges, counts):
                        cum += c
                        le = "+Inf" if edge == float("inf") else f"{edge:g}"
                        lbl = prom_labels(k, f'le="{le}"')
                        lines.append(f"{pn}_bucket{lbl} {cum}")
                    lines.append(f"{pn}_sum{prom_labels(k)} {total:g}")
                    lines.append(f"{pn}_count{prom_labels(k)} {count}")
        return "\n".join(lines) + ("\n" if lines else "")


# process-global default registry: spans and any caller that does not carry
# its own Registry record here (PartitionService instances default to a
# private Registry so per-service stats stay isolated — the CLIs pass this
# one in explicitly so one dump carries service + span + watchdog series)
REGISTRY = Registry()


def counter(name: str, value: float = 1.0, **labels) -> None:
    REGISTRY.counter(name, value, **labels)


def gauge(name: str, value: float, **labels) -> None:
    REGISTRY.gauge(name, value, **labels)


def observe(name: str, value: float, buckets: tuple | None = None,
            **labels) -> None:
    REGISTRY.observe(name, value, buckets, **labels)


def dump_json(path: str, registry: Registry | None = None) -> dict:
    """Write the one-file metrics dump: registry snapshot + span aggregates
    (the `--metrics-json` format; see docs/observability.md). Atomic
    (tmp + rename) so a `PeriodicDumper` overwrite never tears a reader."""
    from repro_torch.obs import trace

    reg = registry if registry is not None else REGISTRY
    doc = dict(ts=time.time(), metrics=reg.snapshot(),
               spans=trace.aggregate())
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return doc


class PeriodicDumper:
    """Background thread re-writing ``dump_json(path)`` every
    ``interval_s`` — the long-lived-service dump mode behind
    ``--metrics-interval``. ``stop()`` writes one final dump."""

    def __init__(self, path: str, interval_s: float,
                 registry: Registry | None = None):
        self.path = path
        self.interval_s = float(interval_s)
        self.registry = registry
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="metrics-dumper")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            dump_json(self.path, self.registry)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        dump_json(self.path, self.registry)
