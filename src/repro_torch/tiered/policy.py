"""Escalation policy: which queries deserve the exact tier.

The verifier tells the policy which table-0 buckets held diverged
points; the policy remembers them for ``ttl_rounds`` verification
rounds.  A query escalates when its point's bucket is currently hot —
the population most likely to be mislabelled by the sampled tier is
exactly the one that disagreed recently, and bucket granularity makes
the hot set a few keys instead of a per-point ledger.
"""

from __future__ import annotations

from typing import Dict, Iterable


class DivergencePolicy:
    def __init__(self, ttl_rounds: int = 3):
        if ttl_rounds < 1:
            raise ValueError(f"ttl_rounds must be >= 1, got {ttl_rounds}")
        self.ttl_rounds = int(ttl_rounds)
        self._hot: Dict[bytes, int] = {}  # table-0 key -> expiry round
        self.n_marked = 0

    def mark(self, keys: Iterable[bytes], round_no: int) -> None:
        """Remember ``keys`` as diverged as of verification ``round_no``."""
        for key in keys:
            self._hot[key] = round_no + self.ttl_rounds
            self.n_marked += 1

    def hot(self, key: bytes, round_no: int) -> bool:
        """Should a query for a point in this bucket escalate?"""
        exp = self._hot.get(key)
        if exp is None:
            return False
        if round_no > exp:
            del self._hot[key]
            return False
        return True

    def sweep(self, round_no: int) -> None:
        """Drop expired entries (called by the verifier per round)."""
        dead = [k for k, exp in self._hot.items() if round_no > exp]
        for k in dead:
            del self._hot[k]

    def __len__(self) -> int:
        return len(self._hot)
