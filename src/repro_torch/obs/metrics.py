"""Metric instruments: counters, gauges, log-bucketed histograms.

Every instrument exists in two forms — a real one and a null one with the
same surface.  Code binds an instrument once (at construction, from its
:class:`~repro_torch.obs.registry.Obs` handle) and calls ``inc`` / ``set`` /
``observe`` / ``timer`` unconditionally; with observability disabled the
bound instrument is the shared null singleton and the call is one no-op
method dispatch.  Hot paths that cannot afford even that guard on
``obs.enabled`` instead (a single attribute read).

Histograms are log₂-bucketed: ``observe(v)`` lands ``v`` in the bucket
``(2^(e-1), 2^e]`` via ``math.frexp`` — no per-observation allocation, a
fixed ~60-bucket worst case regardless of range, and percentile estimates
within a factor of √2 (exact ``min``/``max``/``sum``/``count`` are kept
alongside, and estimates are clamped to the observed range).  Latency
histograms record **microseconds** by convention (names end in ``_us``).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterable, Optional, Tuple


class _NullTimer:
    """Reusable no-op context manager (stateless, shared)."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


NULL_TIMER = _NullTimer()


class _Timer:
    """Times a ``with`` block and records elapsed microseconds."""

    __slots__ = ("_h", "_t0")

    def __init__(self, h: "Histogram"):
        self._h = h

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        self._h.observe((time.perf_counter() - self._t0) * 1e6)
        return False


class Counter:
    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> Dict[str, object]:
        return {"type": "counter", "value": self.value}


class Gauge:
    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict[str, object]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    kind = "histogram"
    __slots__ = ("name", "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.buckets: Dict[int, int] = {}  # exponent e -> count, v <= 2^e
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        e = math.frexp(v)[1] if v > 0 else 0  # 2^(e-1) < v <= 2^e
        self.buckets[e] = self.buckets.get(e, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def timer(self) -> _Timer:
        """``with h.timer():`` records the block's latency in µs."""
        return _Timer(self)

    # ------------------------------------------------------------------ #
    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]) from the log buckets,
        clamped to the exact observed [min, max]."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        seen = 0
        for e in sorted(self.buckets):
            seen += self.buckets[e]
            if seen >= target:
                # arithmetic midpoint of (2^(e-1), 2^e]
                mid = 1.5 * 2.0 ** (e - 1)
                return min(max(mid, self.min), self.max)
        return self.max

    def snapshot(self) -> Dict[str, object]:
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "buckets": {str(2.0 ** e): n
                        for e, n in sorted(self.buckets.items())},
        }

    def bounds(self) -> Iterable[Tuple[float, int]]:
        """(upper bound, count) pairs in ascending bound order."""
        for e in sorted(self.buckets):
            yield 2.0 ** e, self.buckets[e]


class NullCounter(Counter):
    __slots__ = ()

    def __init__(self) -> None:
        super().__init__("null")

    def inc(self, n: int = 1) -> None:
        pass


class NullGauge(Gauge):
    __slots__ = ()

    def __init__(self) -> None:
        super().__init__("null")

    def set(self, v: float) -> None:
        pass


class NullHistogram(Histogram):
    __slots__ = ()

    def __init__(self) -> None:
        super().__init__("null")

    def observe(self, v: float) -> None:
        pass

    def timer(self) -> Optional[_Timer]:  # type: ignore[override]
        return NULL_TIMER  # type: ignore[return-value]


NULL_COUNTER = NullCounter()
NULL_GAUGE = NullGauge()
NULL_HISTOGRAM = NullHistogram()
