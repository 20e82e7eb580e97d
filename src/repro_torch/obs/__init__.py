"""repro_torch.obs — metrics, tracing, and exporters for the port's
components and the sharded index.

One handle per component (:class:`Obs` = registry + tracer), a shared
no-op :data:`NULL_OBS` when ``ClusterConfig.obs`` is off, trace contexts
that ride the ``repro_torch.service`` message header across the socket,
and exporters for JSON / Prometheus text / Chrome trace-event dumps.
``python -m repro_torch.obs report <trace.json>`` renders a per-op
latency table from a dump.
"""

from .export import (histogram_summary, load_chrome, merge_snapshots,
                     snapshot_json, span_stats, to_chrome, to_prometheus,
                     write_chrome)
from .metrics import (NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM, NULL_TIMER,
                      Counter, Gauge, Histogram)
from .registry import (NULL_OBS, NULL_REGISTRY, MetricsRegistry, NullObs,
                       NullRegistry, Obs, make_obs)
from .trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram",
    "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM", "NULL_TIMER",
    "MetricsRegistry", "NullRegistry", "NULL_REGISTRY",
    "Obs", "NullObs", "NULL_OBS", "make_obs",
    "Span", "Tracer", "NullTracer", "NULL_TRACER",
    "snapshot_json", "merge_snapshots", "to_prometheus",
    "to_chrome", "write_chrome", "load_chrome",
    "histogram_summary", "span_stats",
]
