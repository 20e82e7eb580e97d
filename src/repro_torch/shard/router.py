"""LSH key-range routing: table-0 grid code -> slot -> shard.

The paper's grid LSH (Definition 3) already assigns every point a
deterministic integer code vector per table, so the partitioning key for
sharding exists for free: we hash the *table-0* code into a small slot
space (``SLOTS`` = 4096) and assign contiguous slot ranges to shards.
Ranges (not a bare modulus) are the unit of ownership so that rebalancing
is a key-range move — the same primitive a multi-host deployment would
ship between workers.

Routing is placement only: clustering correctness never depends on which
shard a point lands in (the boundary bridge reconciles cross-shard
structure), so the slot may be derived from either key representation.
With ``mixed=True`` the router slots points by the *table-0 mixed key*
(the float32 device-hash pass), so a sharded index over a mixed-key inner
engine runs exactly one hash pass per batch — the same pass that produces
the inner bucket keys — instead of paying a second exact-code pass just
for routing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core.hashing import GridLSH

SLOTS = 1 << 12  # granularity of the key space (ranges are slot intervals)

_SM_A = np.uint64(0xBF58476D1CE4E5B9)  # splitmix64 finalizer constants
_SM_B = np.uint64(0x94D049BB133111EB)


def _splitmix_slots(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer -> (n,) slot ids; the one mixing pipeline
    both key families share, so their slot hashes can never diverge."""
    with np.errstate(over="ignore"):
        h ^= h >> np.uint64(30)
        h *= _SM_A
        h ^= h >> np.uint64(27)
        h *= _SM_B
        h ^= h >> np.uint64(31)
    return (h & np.uint64(SLOTS - 1)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class RebalancePlan:
    """Move the slot range ``[start, stop)`` to shard ``target``."""

    start: int
    stop: int
    target: int


class ShardRouter:
    """Deterministic point -> shard assignment over ``SLOTS`` key slots."""

    def __init__(self, lsh: GridLSH, n_shards: int, seed: int = 0,
                 assignment: Optional[np.ndarray] = None,
                 mixed: bool = False):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.lsh = lsh
        self.n_shards = int(n_shards)
        self.mixed = bool(mixed)  # slot by table-0 mixed key, not exact code
        # per-dimension odd multipliers for the slot hash, derived from the
        # config seed (stable across processes, unlike hash(bytes))
        rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, 0x51A2D])
        self._mult = (
            rng.integers(1, 2**63 - 1, size=lsh.d, dtype=np.int64)
            .astype(np.uint64) | np.uint64(1)
        )
        if assignment is None:
            # even contiguous ranges: slot s belongs to shard s*S // SLOTS
            assignment = (np.arange(SLOTS, dtype=np.int64)
                          * n_shards) // SLOTS
        assignment = np.asarray(assignment, dtype=np.int64)
        if assignment.shape != (SLOTS,):
            raise ValueError(f"assignment shape {assignment.shape} != ({SLOTS},)")
        if assignment.min() < 0 or assignment.max() >= n_shards:
            raise ValueError("assignment references an unknown shard")
        self.assignment = assignment

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #
    def slots_batch(self, X: np.ndarray) -> np.ndarray:
        """(n, d) points -> (n,) key slots via splitmix64 of the table-0
        key (one vectorised pass, no per-point hashing).  Uses whichever
        key family this router was built for, so every caller — insert
        routing, rebalance planning, load inspection — slots a given
        point identically."""
        X = np.asarray(X, dtype=np.float64)
        if self.mixed:
            return self.slots_from_mixed(self.lsh.device_keys_batch(X)[:, 0, :])
        return self.slots_from_codes(self.lsh.codes_batch(X)[:, 0, :])

    def slots_from_mixed(self, m0: np.ndarray) -> np.ndarray:
        """(n, 2) table-0 int32 mixed keys -> (n,) key slots (callers that
        already ran ``device_keys_batch`` skip the second hashing pass)."""
        m = (np.asarray(m0, dtype=np.int64).reshape(-1, 2)
             & np.int64(0xFFFFFFFF)).astype(np.uint64)
        with np.errstate(over="ignore"):
            h = (m[:, 0] << np.uint64(32)) | m[:, 1]
            h *= self._mult[0]  # seed-dependent pre-mix, then splitmix64
        return _splitmix_slots(h)

    def slots_from_codes(self, c0: np.ndarray) -> np.ndarray:
        """(n, d) table-0 int64 grid codes -> (n,) key slots (callers that
        already ran ``codes_batch`` skip the second hashing pass)."""
        c0 = np.asarray(c0, dtype=np.int64).astype(np.uint64)  # (n, d)
        with np.errstate(over="ignore"):
            h = (c0 * self._mult[None, :]).sum(axis=1, dtype=np.uint64)
        return _splitmix_slots(h)

    def shards_batch(self, X: np.ndarray) -> np.ndarray:
        """(n, d) points -> (n,) shard ids."""
        return self.assignment[self.slots_batch(X)]

    def shard_of(self, x: np.ndarray) -> int:
        return int(self.shards_batch(np.asarray(x)[None])[0])

    # ------------------------------------------------------------------ #
    # key-range bookkeeping
    # ------------------------------------------------------------------ #
    def ranges(self) -> List[Tuple[int, int, int]]:
        """Contiguous runs of the assignment as (start, stop, shard)."""
        out = []
        start = 0
        for s in range(1, SLOTS + 1):
            if s == SLOTS or self.assignment[s] != self.assignment[start]:
                out.append((start, s, int(self.assignment[start])))
                start = s
        return out

    def move_range(self, plan: RebalancePlan) -> None:
        """Reassign slots [start, stop) to ``plan.target``."""
        if not (0 <= plan.start < plan.stop <= SLOTS):
            raise ValueError(f"slot range [{plan.start}, {plan.stop}) "
                             f"outside [0, {SLOTS})")
        if not (0 <= plan.target < self.n_shards):
            raise ValueError(f"target shard {plan.target} outside "
                             f"[0, {self.n_shards})")
        self.assignment[plan.start:plan.stop] = plan.target

    def slot_loads(self, slots: np.ndarray) -> np.ndarray:
        """(m,) observed point slots -> (SLOTS,) occupancy histogram."""
        return np.bincount(np.asarray(slots, dtype=np.int64),
                           minlength=SLOTS)

    @staticmethod
    def load_skew(sizes: "List[int]") -> float:
        """Key-range skew of observed per-shard occupancy: max over mean
        (1.0 = perfectly balanced; 0.0 for an empty index).  The gauge the
        observability layer and rebalance planning read."""
        total = sum(sizes)
        if not sizes or total == 0:
            return 0.0
        return max(sizes) * len(sizes) / total

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #
    def state(self) -> np.ndarray:
        return self.assignment.copy()

    def load_state(self, assignment: np.ndarray) -> None:
        assignment = np.asarray(assignment, dtype=np.int64)
        if assignment.shape != (SLOTS,):
            raise ValueError(f"assignment shape {assignment.shape} != ({SLOTS},)")
        self.assignment = assignment
