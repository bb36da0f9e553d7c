"""Host-side telemetry of the port (``repro.obs``): three layers that never
write a tensor, so telemetry on or off gives the same bits.

* `repro_torch.obs.metrics`: labeled counters, gauges and histograms in a
  thread-safe `Registry` (process-global default ``REGISTRY``), with
  snapshot/reset, JSONL and Prometheus export, and the ``--metrics-json``
  dump (`dump_json` / `PeriodicDumper`).
* `repro_torch.obs.trace`: ``span(name, **attrs)`` wall-time span tree
  that drains the device before its timer stops (``sp.sync``), lined up
  with ``torch.profiler`` traces through ``record_function``, with Chrome
  trace export under ``REPRO_TRACE_DIR``.
* `repro_torch.obs.vcycle`: per-level `LevelStats` (structure, capacity
  occupancy, kernel path, connectivity / size / distinct-incidence slack)
  that the partitioner drivers put on `PartitionResult.level_stats`.
"""
from repro_torch.obs import metrics, trace, vcycle  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    REGISTRY,
    PeriodicDumper,
    Registry,
    counter,
    dump_json,
    gauge,
    observe,
)
from repro_torch.obs.trace import span  # noqa: F401
from repro_torch.obs.vcycle import LevelStats  # noqa: F401
