"""Hash-bucket index: t tables of buckets with ordered core chains,
ported from ``repro.core.buckets`` (pure Python, unchanged).

Each bucket keeps its member set and the *sorted* list of its current core
points (by insertion index) so the paper's predecessor/successor queries
(Alg. 2 lines 31–32 / 38–39) run in O(log |bucket|).  The sorted container
is an array-backed sorted list (C-speed ``bisect``); a balanced-tree drop-in
would give the same asymptotics with a larger constant.
"""

from __future__ import annotations

from bisect import bisect_left, insort
from typing import Dict, List, Optional, Tuple


class Bucket:
    __slots__ = ("members", "cores")

    def __init__(self):
        self.members: set = set()
        self.cores: List[int] = []  # sorted point indices of core members

    def __len__(self) -> int:
        return len(self.members)

    # ---- ordered core-chain queries (paper's c1/c2) -------------------- #
    def core_neighbors(self, idx: int) -> Tuple[Optional[int], Optional[int]]:
        """(pred, succ) core indices around ``idx`` (idx not yet inserted or
        already present; presence is handled by the caller's bisect side)."""
        pos = bisect_left(self.cores, idx)
        pred = self.cores[pos - 1] if pos > 0 else None
        if pos < len(self.cores) and self.cores[pos] == idx:
            succ = self.cores[pos + 1] if pos + 1 < len(self.cores) else None
        else:
            succ = self.cores[pos] if pos < len(self.cores) else None
        return pred, succ

    def add_core(self, idx: int) -> None:
        insort(self.cores, idx)

    def remove_core(self, idx: int) -> None:
        pos = bisect_left(self.cores, idx)
        if pos < len(self.cores) and self.cores[pos] == idx:
            self.cores.pop(pos)

    def first_core(self) -> Optional[int]:
        return self.cores[0] if self.cores else None


class BucketIndex:
    """t hash tables mapping bucket key -> :class:`Bucket`."""

    def __init__(self, t: int):
        self.tables: List[Dict[bytes, Bucket]] = [dict() for _ in range(t)]

    def get(self, table: int, key: bytes) -> Optional[Bucket]:
        return self.tables[table].get(key)

    def get_or_create(self, table: int, key: bytes) -> Bucket:
        b = self.tables[table].get(key)
        if b is None:
            b = Bucket()
            self.tables[table][key] = b
        return b

    def drop_if_empty(self, table: int, key: bytes) -> None:
        b = self.tables[table].get(key)
        if b is not None and not b.members:
            del self.tables[table][key]

    def n_buckets(self) -> int:
        return sum(len(tb) for tb in self.tables)
