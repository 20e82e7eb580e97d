"""repro_torch.obs — metrics and tracing for the port's components.

One handle per component (:class:`Obs` = registry + tracer) and a shared
no-op :data:`NULL_OBS` when ``ClusterConfig.obs`` is off.  The engine reads
``obs.enabled`` / ``obs.histogram``; the API builds handles with
:func:`make_obs`.  The exporters and the report CLI of ``repro.obs`` come
with a later slice of the port.
"""

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
]
