"""Sequence skip list supporting split / concat / representative, ported
from ``repro.core.skiplist`` (pure Python, unchanged).

This is the data structure Tseng, Dhulipala and Blelloch (ALENEX'19) use to
store Euler Tour Sequences, and the one the paper adopts.  Elements carry no
keys — the structure maintains an *ordering* only, and supports:

  * ``concat(a, b)``        join two sequences (a's first), O(log n) w.h.p.
  * ``split_after(e)``      split the sequence containing ``e`` right after
                            ``e``.
  * ``representative(e)``   canonical element (the sequence head) of the
                            sequence containing ``e``, O(log n) w.h.p.  Two
                            elements are in the same sequence iff their
                            representatives are identical.
  * ``first/last/iter_seq`` for tests and oracles.

Each element owns a tower of (prev, next) links, one pair per level; tower
heights are geometric(p=1/2) drawn from a per-structure RNG so runs are
reproducible (Python's ``random.Random(seed)``, drawn in ``make_node``
call order exactly as the reference draws them, so a forest built by the
same operations has the same towers and the same sequence heads).  There
are no sentinel heads: a sequence is identified by its
leftmost element, so ``concat``/``split`` never maintain external handles.
Level-``l`` links connect exactly the nodes of height > ``l``.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional


class SLNode:
    """One element of a sequence skip list."""

    __slots__ = ("prev", "next", "height", "payload")

    def __init__(self, height: int, payload=None):
        self.height = height
        self.prev: List[Optional["SLNode"]] = [None] * height
        self.next: List[Optional["SLNode"]] = [None] * height
        self.payload = payload

    def __repr__(self):  # pragma: no cover - debug aid
        return f"SLNode({self.payload!r}, h={self.height})"


class SkipListSeq:
    """Sequence skip-list operations (nodes created via :meth:`make_node`)."""

    def __init__(self, seed: int = 0, p: float = 0.5, max_height: int = 48):
        self._rng = random.Random(seed)
        self._p = p
        self._max_height = max_height

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def make_node(self, payload=None) -> SLNode:
        h = 1
        while h < self._max_height and self._rng.random() < self._p:
            h += 1
        return SLNode(h, payload)

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    @staticmethod
    def representative(e: SLNode) -> SLNode:
        """Sequence head (leftmost element), found in O(log n) expected by
        climbing to taller towers while walking left."""
        x = e
        lvl = x.height - 1
        while True:
            p = x.prev[lvl]
            if p is not None:
                x = p
                lvl = x.height - 1  # climb to the new tower's top
                continue
            if lvl == 0:
                return x
            lvl -= 1

    @staticmethod
    def first(e: SLNode) -> SLNode:
        return SkipListSeq.representative(e)

    @staticmethod
    def last(e: SLNode) -> SLNode:
        """Sequence tail, symmetric to :meth:`representative`."""
        x = e
        lvl = x.height - 1
        while True:
            n = x.next[lvl]
            if n is not None:
                x = n
                lvl = x.height - 1
                continue
            if lvl == 0:
                return x
            lvl -= 1

    @staticmethod
    def iter_seq(e: SLNode) -> Iterator[SLNode]:
        x = SkipListSeq.first(e)
        while x is not None:
            yield x
            x = x.next[0]

    @staticmethod
    def same_seq(a: SLNode, b: SLNode) -> bool:
        return SkipListSeq.representative(a) is SkipListSeq.representative(b)

    # ------------------------------------------------------------------ #
    # structural ops
    # ------------------------------------------------------------------ #
    @staticmethod
    def _nearest_left_taller(x: SLNode, lvl: int) -> Optional[SLNode]:
        """Nearest node strictly left of ``x`` with height > ``lvl``.

        Precondition: every node strictly between the result and ``x`` has
        height <= max(x.height, lvl).  Walks top-level prev links, which
        connect nodes of non-decreasing reachable height.
        """
        y = x.prev[x.height - 1]
        while y is not None and y.height <= lvl:
            y = y.prev[y.height - 1]
        return y

    @staticmethod
    def _nearest_right_taller(x: SLNode, lvl: int) -> Optional[SLNode]:
        y = x.next[x.height - 1]
        while y is not None and y.height <= lvl:
            y = y.next[y.height - 1]
        return y

    @staticmethod
    def split_after(e: SLNode) -> None:
        """Split the sequence containing ``e`` into [..e] and [e.next ..].

        No-op if ``e`` is the last element.  For each level ``l`` the single
        boundary-crossing link leaves the rightmost node at-or-before ``e``
        of height > ``l``; we find those nodes by climbing left from ``e``.
        """
        if e.next[0] is None:
            return
        x = e
        lvl = 0
        while True:
            while lvl < x.height:
                nxt = x.next[lvl]
                if nxt is not None:
                    x.next[lvl] = None
                    nxt.prev[lvl] = None
                lvl += 1
            y = SkipListSeq._nearest_left_taller(x, lvl)
            if y is None:
                return
            x = y

    @staticmethod
    def concat(a_any: SLNode, b_any: SLNode) -> None:
        """Concatenate the sequences containing ``a_any`` (first) and
        ``b_any`` (second).  Caller guarantees they are distinct sequences.
        """
        # rights[l]: last node of A with height > l; lefts[l]: first of B.
        ra = SkipListSeq._boundary(SkipListSeq.last(a_any), left_side=True)
        lb = SkipListSeq._boundary(SkipListSeq.first(b_any), left_side=False)
        for lvl in range(min(len(ra), len(lb))):
            ra[lvl].next[lvl] = lb[lvl]
            lb[lvl].prev[lvl] = ra[lvl]

    @staticmethod
    def _boundary(x: SLNode, left_side: bool) -> List[SLNode]:
        """Per-level boundary nodes starting from a sequence end.

        ``left_side=True``: x is the tail of A; out[l] = last node of A at
        level l.  ``left_side=False``: x is the head of B; out[l] = first
        node of B at level l.
        """
        out: List[SLNode] = []
        lvl = 0
        while True:
            while lvl < x.height:
                out.append(x)
                lvl += 1
            y = (
                SkipListSeq._nearest_left_taller(x, lvl)
                if left_side
                else SkipListSeq._nearest_right_taller(x, lvl)
            )
            if y is None:
                return out
            x = y
