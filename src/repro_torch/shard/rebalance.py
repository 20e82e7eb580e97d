"""Rebalance planning: pick a key range to move off a hot shard.

The router's hash spreads table-0 cells uniformly, but real streams are
not uniform over cells (clustered data concentrates mass in few cells),
so shard loads drift.  :func:`propose_rebalance` inspects live per-slot
occupancy and returns a :class:`RebalancePlan` moving a contiguous slot
run from the most- to the least-loaded shard, sized to halve the gap —
feed it to ``ShardedIndex.rebalance``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .router import RebalancePlan


def shard_loads(index) -> np.ndarray:
    """(S,) live point count per shard (coordinator-side home map — no
    shard round trips, so it works on every transport)."""
    return np.asarray(index.shard_sizes(), dtype=np.int64)


def propose_rebalance(index, min_gap: int = 2) -> Optional[RebalancePlan]:
    """The prefix of one of the busiest shard's key ranges whose move to
    the idlest shard minimises the resulting max-min load gap, or None if
    no candidate strictly improves it (clustered streams can concentrate
    a whole cell in one slot, so a blind 'move half the gap' overshoots)."""
    loads = shard_loads(index)
    src = int(loads.argmax())
    dst = int(loads.argmin())
    gap = int(loads[src] - loads[dst])
    if src == dst or gap < min_gap:
        return None
    # per-slot occupancy of the busy shard
    _, X_s = index._shard_rows(src)
    slot_hist = index.router.slot_loads(index.router.slots_batch(X_s))
    others = np.delete(loads, [src, dst])
    o_max = int(others.max()) if others.size else 0
    o_min = int(others.min()) if others.size else np.iinfo(np.int64).max
    best_gap, best = gap, None
    for start, stop, shard in index.router.ranges():
        if shard != src:
            continue
        moved = np.cumsum(slot_hist[start:stop])  # prefix [start, start+j+1)
        hi = np.maximum(np.maximum(loads[src] - moved, loads[dst] + moved),
                        o_max)
        lo = np.minimum(np.minimum(loads[src] - moved, loads[dst] + moved),
                        o_min)
        new_gap = hi - lo
        j = int(new_gap.argmin())
        if int(new_gap[j]) < best_gap:
            best_gap = int(new_gap[j])
            best = RebalancePlan(start, start + j + 1, dst)
    return best
