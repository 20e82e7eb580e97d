"""Host heartbeat registry: deadline-based failure detection.

On a real fleet each host POSTs a heartbeat (host_id, step, t) to the
coordinator (or writes to a shared KV store); the trainer polls
``failed()`` between steps and triggers the elastic re-mesh path when a
host misses its deadline.  The clock is injectable so tests simulate
failures deterministically.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Set


class HeartbeatRegistry:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self._clock = clock or time.monotonic
        now = self._clock()
        self._last: Dict[int, float] = {h: now for h in range(n_hosts)}
        self._step: Dict[int, int] = {h: -1 for h in range(n_hosts)}
        self._evicted: Set[int] = set()

    def beat(self, host_id: int, step: int = -1) -> None:
        if host_id in self._evicted:
            raise KeyError(f"host {host_id} was evicted; must rejoin")
        self._last[host_id] = self._clock()
        self._step[host_id] = max(self._step[host_id], step)

    def failed(self) -> List[int]:
        now = self._clock()
        return sorted(
            h for h, t in self._last.items()
            if h not in self._evicted and now - t > self.timeout_s
        )

    def evict(self, host_id: int) -> None:
        self._evicted.add(host_id)

    def rejoin(self, host_id: int) -> None:
        self._evicted.discard(host_id)
        self._last[host_id] = self._clock()

    def alive(self) -> List[int]:
        failed = set(self.failed())
        return sorted(
            h for h in self._last
            if h not in self._evicted and h not in failed
        )

    def quorum_step(self) -> int:
        """Highest step every alive host has reached (restart point)."""
        alive = self.alive()
        if not alive:
            return -1
        return min(self._step[h] for h in alive)
