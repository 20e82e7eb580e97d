"""Euler-Tour-Sequence dynamic forest (Henzinger–King via skip lists),
ported from ``repro.core.euler_tour`` (pure Python, unchanged).

Stores, for every tree in the forest, the Euler tour of its doubled edges as
a sequence in a skip list (Tseng et al., ALENEX'19).  Every vertex ``v``
contributes a self-loop element ``(v,v)``; every tree edge ``{u,v}``
contributes two directed elements ``(u,v)`` and ``(v,u)``.

Operations (all O(log n) w.h.p.):
  * ``add_node(v)``      new singleton tree.
  * ``link(u, v)``       connect; no-op returning False if already connected
                         (the paper's LINK semantics).
  * ``cut(u, v)``        remove the edge if present, else False.
  * ``root(v)``          canonical identifier of v's tree (stable between
                         structural updates).
  * ``connected(u, v)``.
  * ``remove_node(v)``   v must be isolated.

The forest also maintains an explicit adjacency map so callers (the DBSCAN
layer) can enumerate tree neighbours — needed when re-linking non-core
points hanging off a demoted core point.

Tour algebra used below (linear sequences are rotations of the circular
tour):
  link:  rot_end(S_u, loop_u) ++ [(u,v)] ++ rot_end(S_v, loop_v) ++ [(v,u)]
  cut:   S = A ++ [(u,v)] ++ B ++ [(v,u)] ++ C   →   trees B and A ++ C
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, Set, Tuple

from .skiplist import SkipListSeq, SLNode

NodeId = Hashable


class EulerTourForest:
    def __init__(self, seed: int = 0, backend: str = "skiplist"):
        if backend == "skiplist":
            self._sl = SkipListSeq(seed=seed)
        elif backend == "treap":
            from .treap_seq import TreapSeq

            self._sl = TreapSeq(seed=seed)
        else:
            raise ValueError(backend)
        self._loop: Dict[NodeId, SLNode] = {}
        self._edge: Dict[Tuple[NodeId, NodeId], SLNode] = {}
        self._adj: Dict[NodeId, Set[NodeId]] = {}
        self.n_links = 0  # instrumentation for benchmarks
        self.n_cuts = 0

    # ------------------------------------------------------------------ #
    # vertices
    # ------------------------------------------------------------------ #
    def add_node(self, v: NodeId) -> None:
        if v in self._loop:
            raise KeyError(f"node {v!r} already present")
        self._loop[v] = self._sl.make_node(("loop", v))
        self._adj[v] = set()

    def remove_node(self, v: NodeId) -> None:
        if self._adj[v]:
            raise ValueError(f"node {v!r} still has incident edges")
        del self._loop[v]
        del self._adj[v]

    def __contains__(self, v: NodeId) -> bool:
        return v in self._loop

    def __len__(self) -> int:
        return len(self._loop)

    def degree(self, v: NodeId) -> int:
        return len(self._adj[v])

    def neighbors(self, v: NodeId) -> Set[NodeId]:
        return self._adj[v]

    def has_edge(self, u: NodeId, v: NodeId) -> bool:
        return (u, v) in self._edge

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def root(self, v: NodeId):
        """Unique identifier of v's tree (the paper's ROOT / GetCluster)."""
        return self._sl.representative(self._loop[v]).payload

    def connected(self, u: NodeId, v: NodeId) -> bool:
        return self._sl.same_seq(self._loop[u], self._loop[v])

    def tree_nodes(self, v: NodeId) -> Iterator[NodeId]:
        """All vertices in v's tree (linear time; oracles/debug only)."""
        for el in self._sl.iter_seq(self._loop[v]):
            kind, a = el.payload[0], el.payload[1]
            if kind == "loop":
                yield a

    # ------------------------------------------------------------------ #
    # structural updates
    # ------------------------------------------------------------------ #
    def _rotate_to_end(self, e) -> None:
        """Rotate e's (circular) sequence so the linear order ends at e."""
        nxt = self._next0(e)
        if nxt is None:
            return
        self._sl.split_after(e)
        # pieces: L = [.. e], R = [nxt ..]; rotated = R ++ L
        self._sl.concat(nxt, e)

    def link(self, u: NodeId, v: NodeId) -> bool:
        """Add edge {u,v} if u and v are in different trees."""
        lu, lv = self._loop[u], self._loop[v]
        if self._sl.same_seq(lu, lv):
            return False
        self._rotate_to_end(lu)
        self._rotate_to_end(lv)
        euv = self._sl.make_node(("edge", u, v))
        evu = self._sl.make_node(("edge", v, u))
        self._edge[(u, v)] = euv
        self._edge[(v, u)] = evu
        # S_u(ends at loop_u) ++ [euv] ++ S_v(ends at loop_v) ++ [evu]
        self._sl.concat(lu, euv)
        self._sl.concat(euv, lv)
        self._sl.concat(lv, evu)
        self._adj[u].add(v)
        self._adj[v].add(u)
        self.n_links += 1
        return True

    def cut(self, u: NodeId, v: NodeId) -> bool:
        """Remove edge {u,v} if present."""
        e1 = self._edge.get((u, v))
        if e1 is None:
            return False
        e2 = self._edge[(v, u)]
        if not self._before(e1, e2):
            e1, e2 = e2, e1
        # S = A ++ [e1] ++ B ++ [e2] ++ C
        p1 = self._prev0(e1)
        n2 = self._next0(e2)
        self._split_before(e1)
        self._sl.split_after(e1)  # isolates ... wait: [e1 .. e2 .. C]
        # after split_before(e1): A | [e1..e2..C];
        # split_after(e1): A | [e1] | B' where B' = B ++ [e2] ++ C
        self._split_before(e2)  # B' → B | [e2 ..C]
        self._sl.split_after(e2)  # → [e2] | C
        # tree 1: B (nonempty: contains at least loop of the far endpoint)
        # tree 2: A ++ C (one may be empty, never both)
        if p1 is not None and n2 is not None:
            self._sl.concat(p1, n2)
        del self._edge[(u, v)]
        del self._edge[(v, u)]
        self._adj[u].discard(v)
        self._adj[v].discard(u)
        self.n_cuts += 1
        return True

    # ------------------------------------------------------------------ #
    # helpers
    # ------------------------------------------------------------------ #
    def _split_before(self, e) -> None:
        p = self._prev0(e)
        if p is not None:
            self._sl.split_after(p)

    def _before(self, e1, e2) -> bool:
        """True iff e1 precedes e2 in their common sequence."""
        nxt = self._next0(e1)
        self._sl.split_after(e1)
        ans = not self._sl.same_seq(e1, e2)
        if nxt is not None:  # undo
            self._sl.concat(e1, nxt)
        return ans

    @staticmethod
    def _prev0(e):
        if hasattr(e, "prev"):
            return e.prev[0]
        # treap: in-order predecessor
        if e.left is not None:
            t = e.left
            while t.right is not None:
                t = t.right
            return t
        cur = e
        while cur.parent is not None and cur.parent.left is cur:
            cur = cur.parent
        return cur.parent

    @staticmethod
    def _next0(e):
        if hasattr(e, "next"):
            return e.next[0]
        if e.right is not None:
            t = e.right
            while t.left is not None:
                t = t.left
            return t
        cur = e
        while cur.parent is not None and cur.parent.right is cur:
            cur = cur.parent
        return cur.parent
