"""repro_torch.obs — the port's observability plane (port of ``repro.obs``).

* :mod:`repro_torch.obs.metrics` — typed instruments (Counter / Gauge /
  bounded Histogram) in a :class:`MetricsRegistry`. Every serving-layer
  statistic lives in the process-wide :data:`REGISTRY`, and the ``stats``
  surfaces of the engines, the KV page pool and the store-paged bank are
  views over it.
* :mod:`repro_torch.obs.trace` — per-request lifecycle spans with TTFT /
  TPOT and stall attribution; JSONL + Chrome ``trace_event`` export.
* :mod:`repro_torch.obs.slo` — sliding-window percentile monitor with
  threshold callbacks for admission backpressure.
"""
from .metrics import (
    DEFAULT_HIST_CAP,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsScope,
)
from .slo import SLO_PERCENTILES, SLOMonitor
from .trace import STALL_REASONS, RequestTrace, TraceRecorder

__all__ = [
    "DEFAULT_HIST_CAP",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsScope",
    "SLO_PERCENTILES",
    "SLOMonitor",
    "STALL_REASONS",
    "RequestTrace",
    "TraceRecorder",
]
