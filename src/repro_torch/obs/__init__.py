"""repro_torch.obs — the port's observability plane: the metrics registry
(``obs/metrics.py``). Every serving-layer statistic lives in the
process-wide :data:`REGISTRY`, and the ``stats`` surfaces of the engines,
the KV page pool and the store-paged bank are views over it. The tracer and
the SLO monitor of ``repro.obs`` are not ported yet."""
from .metrics import (
    DEFAULT_HIST_CAP,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsScope,
)

__all__ = [
    "DEFAULT_HIST_CAP",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsScope",
]
