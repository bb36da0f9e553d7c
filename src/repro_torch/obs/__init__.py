"""Host-side telemetry of the port: the metrics registry
(``repro.obs.metrics``). Span tracing and V-cycle stats wait for ROADMAP.md
Queue A item 11."""
from repro_torch.obs import metrics  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    REGISTRY,
    PeriodicDumper,
    Registry,
    counter,
    dump_json,
    gauge,
    observe,
)
