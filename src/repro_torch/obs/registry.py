"""The per-component observability handle: registry + tracer in one.

An :class:`Obs` bundles a :class:`MetricsRegistry` and a
:class:`~repro_torch.obs.trace.Tracer` under one ``enabled`` flag.  Components
(a ClusterIndex, a transport, the serving engine) each hold exactly one
``Obs``; with ``ClusterConfig.obs=False`` (the default) they hold the
shared :data:`NULL_OBS`, whose instruments are all no-ops — the
un-instrumented hot paths stay bit-identical to the pre-observability
tree, and the wire codec emits no trace header at all.

``make_obs(enabled, proc)`` is the one constructor call sites use, so
"is observability on" is decided in exactly one place per component.
"""

from __future__ import annotations

from typing import Any, Dict, Union

from .metrics import (NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM, Counter,
                      Gauge, Histogram)
from .trace import NULL_TRACER, NullTracer, Tracer

Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    enabled = True

    def __init__(self) -> None:
        self._metrics: Dict[str, Instrument] = {}

    def _get(self, name: str, cls: type) -> Instrument:
        inst = self._metrics.get(name)
        if inst is None:
            inst = self._metrics[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)  # type: ignore[return-value]

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)  # type: ignore[return-value]

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)  # type: ignore[return-value]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON-able view of every instrument, in registration order."""
        return {name: inst.snapshot() for name, inst in self._metrics.items()}

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self):
        return iter(self._metrics.items())


class NullRegistry(MetricsRegistry):
    enabled = False

    def counter(self, name: str) -> Counter:
        return NULL_COUNTER

    def gauge(self, name: str) -> Gauge:
        return NULL_GAUGE

    def histogram(self, name: str) -> Histogram:
        return NULL_HISTOGRAM

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {}


NULL_REGISTRY = NullRegistry()


class Obs:
    """One component's observability: metrics + tracer, one flag."""

    enabled = True

    def __init__(self, proc: str = "main"):
        self.proc = proc
        self.metrics: MetricsRegistry = MetricsRegistry()
        self.tracer: Tracer = Tracer(proc)

    # instrument shortcuts (the call sites' one-liner binding surface)
    def counter(self, name: str) -> Counter:
        return self.metrics.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.metrics.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.metrics.histogram(name)

    def set_proc(self, proc: str) -> None:
        """Re-label this component (e.g. a worker learning its shard id)."""
        self.proc = proc
        self.tracer.proc = proc

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Any]:
        """Metrics + finished spans, JSON-able; spans stay buffered."""
        return {"proc": self.proc, "metrics": self.metrics.snapshot(),
                "spans": self.tracer.export(),
                "spans_dropped": self.tracer.dropped}

    def drain(self) -> Dict[str, Any]:
        """Like :meth:`snapshot` but clears the span buffer — the wire
        pull path, so a span ships at most once."""
        return {"proc": self.proc, "metrics": self.metrics.snapshot(),
                "spans": self.tracer.drain_export(),
                "spans_dropped": self.tracer.dropped}


class NullObs(Obs):
    enabled = False

    def __init__(self) -> None:
        self.proc = "null"
        self.metrics = NULL_REGISTRY
        self.tracer = NULL_TRACER

    def set_proc(self, proc: str) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"proc": "null", "metrics": {}, "spans": [],
                "spans_dropped": 0}

    drain = snapshot


NULL_OBS = NullObs()


def make_obs(enabled: bool, proc: str = "main") -> Obs:
    """The one switch: a live Obs when ``enabled``, else the shared
    null handle (zero allocation, zero-op instruments)."""
    return Obs(proc) if enabled else NULL_OBS


# narrow the NullTracer import to what this module re-exports
__all__ = ["MetricsRegistry", "NullRegistry", "NULL_REGISTRY", "Obs",
           "NullObs", "NULL_OBS", "make_obs", "NullTracer"]
