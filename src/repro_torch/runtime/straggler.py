"""Straggler detection: per-host EWMA step times with robust outlier test.

A host is flagged when its smoothed step time exceeds
``threshold × median(EWMA over hosts)`` for ``patience`` consecutive
steps.  The trainer can then exclude the host (elastic re-mesh) or, for
data-pipeline stragglers, re-assign its shard (``reassign``).

The port's own copy of ``repro.runtime.straggler`` (pure Python and
numpy): the same EWMA, breaches and stragglers for the same samples.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class StragglerDetector:
    def __init__(self, n_hosts: int, alpha: float = 0.2,
                 threshold: float = 1.8, patience: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self._ewma: Dict[int, float] = {h: float("nan") for h in range(n_hosts)}
        self._breach: Dict[int, int] = {h: 0 for h in range(n_hosts)}

    def record(self, host_id: int, step_time_s: float) -> None:
        prev = self._ewma[host_id]
        self._ewma[host_id] = (
            step_time_s if np.isnan(prev)
            else self.alpha * step_time_s + (1 - self.alpha) * prev
        )

    def update_breaches(self) -> None:
        vals = [v for v in self._ewma.values() if not np.isnan(v)]
        if len(vals) < 2:
            return
        med = float(np.median(vals))
        for h, v in self._ewma.items():
            if not np.isnan(v) and v > self.threshold * med:
                self._breach[h] += 1
            else:
                self._breach[h] = 0

    def stragglers(self) -> List[int]:
        return sorted(h for h, b in self._breach.items() if b >= self.patience)

    def ewma(self, host_id: int) -> float:
        return self._ewma[host_id]

    def record_from_obs(self, metrics: Dict[str, dict],
                        prefix: str = "rpc.shard",
                        scale: float = 1e-6) -> List[int]:
        """Feed one observation round from serving telemetry: the
        per-shard RPC latency histograms of an ``Obs`` metrics snapshot
        (``rpc.shard<N>_us`` entries, as recorded by the sharded
        coordinator's fan-out) instead of synthetic probes.  Each shard's
        p50 (µs, scaled to seconds) becomes that host's step-time sample;
        breach counters update when at least one host was fed.  Returns
        the hosts fed this round."""
        fed: List[int] = []
        for h in self._ewma:
            m = metrics.get(f"{prefix}{h}_us")
            if m and m.get("type") == "histogram" and m.get("count"):
                self.record(h, float(m["p50"]) * scale)
                fed.append(h)
        if fed:
            self.update_breaches()
        return fed
