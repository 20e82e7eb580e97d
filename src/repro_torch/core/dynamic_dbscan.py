"""DynamicDBSCAN — Algorithm 2 of the paper, ported from
``repro.core.dynamic_dbscan`` (host Python and numpy; no kernel).

Maintains, under point insertions and deletions:
  * t grid-LSH tables with per-bucket ordered core chains;
  * the exact core set of Definition 4 via per-point *support counts*
    (``support[x] = #{i : |bucket_i(x)| >= k}``; core ⟺ support > 0) —
    this fixes the demotion edge case in the paper's pseudocode;
  * a spanning forest of the collision graph H in an Euler-Tour-Sequence
    dynamic forest, with per-bucket core *paths* (degree O(t)) and non-core
    points attached with degree ≤ 1.

Per-update cost: O(t·k) bucket/support work on threshold crossings plus
O(t) LINK/CUT/ROOT calls at O(log n) each — the paper's
O(t²·k·(d + log n)) ⇒ O(d log³ n + log⁴ n) with t,k = Θ(log n).

``GetCluster`` is ROOT on the forest: O(log n).

The module also holds the point-handle helpers every engine of the port
shares (``NOISE``, ``claim_index``, ``check_unique_ids``).  Given the same
seed and the same operations, the engine equals the reference's in every
label, delta, forest edge and counter: the forest's towers are drawn by
Python's ``random`` in the same order, and every iteration order (sets of
ints, dicts in insertion order, sorted promotions) is the reference's.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from ..obs import NULL_OBS
from .buckets import BucketIndex
from .euler_tour import EulerTourForest
from .hashing import GridLSH

NOISE = -1

try:  # optional fast path, resolved once (labels() is per-batch hot)
    import scipy.sparse as _sp
    from scipy.sparse.csgraph import connected_components as _scipy_cc
except ImportError:  # pragma: no cover - exercised via tests monkeypatching
    _sp = None


def claim_index(live, next_idx: int, idx: Optional[int]):
    """Resolve an explicit-or-auto point handle against a live-id set.

    Shared by every engine/adapter so handle assignment is identical
    across backends (the premise of the equivalence tests).  Returns
    ``(idx, new_next_idx)``; raises KeyError on duplicates.
    """
    if idx is None:
        idx = next_idx
    elif idx in live:
        raise KeyError(f"index {idx} already present")
    return idx, max(next_idx, idx + 1)


def check_unique_ids(ids) -> None:
    """Raise KeyError naming the first id appearing twice in ``ids`` —
    the shared ``delete_batch`` precondition (mirrors ``claim_index``'s
    duplicate-pin behavior on the insert side)."""
    seen = set()
    for i in ids:
        if i in seen:
            raise KeyError(f"duplicate id {i} in delete_batch")
        seen.add(i)


def _connected_components(n: int, rows: List[int], cols: List[int]) -> np.ndarray:
    """Component id per position 0..n-1, numbered by first occurrence.

    scipy (when importable) and the pure-Python union-find fallback produce
    identical labellings: both number components in ascending order of
    their smallest member position.
    """
    if _sp is None:
        parent = list(range(n))

        def find(a: int) -> int:
            root = a
            while parent[root] != root:
                root = parent[root]
            while parent[a] != root:  # path compression
                parent[a], a = root, parent[a]
            return root

        for a, b in zip(rows, cols):
            ra, rb = find(a), find(b)
            if ra != rb:
                # union by smaller root id ⇒ each root is its component's
                # minimum, giving first-occurrence numbering below
                if rb < ra:
                    ra, rb = rb, ra
                parent[rb] = ra
        comp = np.empty(n, dtype=np.int64)
        relabel: Dict[int, int] = {}
        for pos in range(n):
            r = find(pos)
            comp[pos] = relabel.setdefault(r, len(relabel))
        return comp
    g = _sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, comp = _scipy_cc(g, directed=False)
    return comp


class DynamicDBSCAN:
    def __init__(
        self,
        d: int,
        k: int,
        t: int,
        eps: float,
        seed: int = 0,
        attach_orphans: bool = True,
        lsh: Optional[GridLSH] = None,
        repair: str = "exact",
    ):
        if repair not in ("exact", "paper"):
            raise ValueError(repair)
        # 'exact' restores the Thm-2 spanning-forest invariant with a
        # replacement-edge scan (O(smaller side) on genuine splits);
        # 'paper' is Alg. 2's literal pred/succ-only repair — cheaper, but
        # can strand cores after deletions.
        self.repair = repair
        self.d, self.k, self.t, self.eps = d, int(k), int(t), float(eps)
        self.lsh = lsh if lsh is not None else GridLSH(d, eps, t, seed)
        if self.lsh.t != self.t or self.lsh.d != d:
            raise ValueError("lsh family incompatible with (d, t)")
        self.attach_orphans = attach_orphans
        self.forest = EulerTourForest(seed=seed)
        self.buckets = BucketIndex(self.t)
        self.points: Dict[int, np.ndarray] = {}
        self.keys: Dict[int, list] = {}       # idx -> [t bucket keys]
        self.support: Dict[int, int] = {}     # idx -> #buckets of size >= k
        self.attach: Dict[int, Optional[int]] = {}   # non-core -> anchor core
        self.anchored: Dict[int, Set[int]] = {}      # core -> anchored set
        self._next_idx = 0
        # change feed: (idx, old, new) attachment deltas, None until a
        # consumer activates it via drain_deltas() (see below)
        self._journal: Optional[List[Tuple[int, Optional[int], Optional[int]]]] = None
        # instrumentation: how often the replacement-edge repair fires
        self.n_repair_scans = 0
        self.n_repair_links = 0
        # observability handle; rebound by the owning adapter when the
        # config's obs knob is on (class default: shared no-op)
        self.obs = NULL_OBS

    # ------------------------------------------------------------------ #
    # public API (paper's procedures)
    # ------------------------------------------------------------------ #
    def add_point(self, x: np.ndarray, idx: Optional[int] = None) -> int:
        """AddPoint(x).  Returns the point's index (stable handle)."""
        idx, self._next_idx = claim_index(self.points, self._next_idx, idx)
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (self.d,):
            raise ValueError(f"point shape {x.shape} != ({self.d},)")
        keys = self.lsh.keys(x)
        return self._add_with_keys(x, keys, idx)

    def _add_with_keys(self, x: np.ndarray, keys: list, idx: int) -> int:
        self.points[idx] = x
        self.keys[idx] = keys
        self.support[idx] = 0
        self.attach[idx] = None
        self.forest.add_node(idx)

        promoted: Set[int] = set()  # the paper's C'
        for i, key in enumerate(keys):
            b = self.buckets.get_or_create(i, key)
            b.members.add(idx)
            sz = len(b.members)
            if sz == self.k:
                # bucket crosses the threshold: every member gains support
                for y in b.members:
                    self.support[y] += 1
                    if self.support[y] == 1:
                        promoted.add(y)
            elif sz > self.k:
                self.support[idx] += 1
                if self.support[idx] == 1:
                    promoted.add(idx)

        for c in sorted(promoted):  # idx order keeps chains coherent
            self._link_core_point(c)
        if self.support[idx] == 0:
            # journal: _anchor records the attach; noise inserts are a
            # no-op delta (None -> None) by the handle contract
            self._link_non_core_point(idx)
        return idx

    def delete_point(self, idx: int) -> None:
        """DeletePoint(x)."""
        if idx not in self.points:
            raise KeyError(idx)
        if self._journal is not None:
            self._record(idx, self._attach_handle(idx), None)
        if self.support[idx] > 0:
            self._unlink_core_point(idx)  # path repair + anchored re-link
        else:
            anchor = self.attach[idx]
            if anchor is not None:
                self.forest.cut(idx, anchor)
                self.anchored[anchor].discard(idx)

        demoted: List[int] = []
        for i, key in enumerate(self.keys[idx]):
            b = self.buckets.get(i, key)
            b.members.discard(idx)
            sz = len(b.members)
            if sz == self.k - 1:
                # bucket drops below threshold: remaining members lose support
                for y in b.members:
                    self.support[y] -= 1
                    if self.support[y] == 0:
                        demoted.append(y)
            self.buckets.drop_if_empty(i, key)

        for c in sorted(demoted):
            self._unlink_core_point(c)
            self._record(c, c, None)  # demotion; _anchor records re-attach
            self._link_non_core_point(c)

        self.forest.remove_node(idx)
        for m in (self.points, self.keys, self.support, self.attach):
            del m[idx]
        self.anchored.pop(idx, None)

    def get_cluster(self, idx: int):
        """GetCluster(x): unique id of x's cluster — ROOT on the forest."""
        return self.forest.root(idx)

    def is_core(self, idx: int) -> bool:
        return self.support[idx] > 0

    def core_set(self) -> Set[int]:
        return {i for i, s in self.support.items() if s > 0}

    # component_of is the documented name of the native point query on the
    # repro_torch.api protocol; for this engine it is exactly GetCluster (ROOT).
    component_of = get_cluster

    def core_anchor(self, idx: int) -> Optional[int]:
        """The core point ``idx``'s cluster membership rides on: itself if
        core, its anchor if an attached border point, None if noise.
        O(1) — the native query the sharded hot path resolves through."""
        if self.support[idx] > 0:
            return idx
        return self.attach[idx]

    # ------------------------------------------------------------------ #
    # change feed: (idx, old, new) attachment deltas per update batch
    # ------------------------------------------------------------------ #
    def _record(self, idx: int, old: Optional[int], new: Optional[int]) -> None:
        if self._journal is not None:
            self._journal.append((idx, old, new))

    def _attach_handle(self, idx: int) -> Optional[int]:
        return idx if self.support[idx] > 0 else self.attach[idx]

    def _compact_journal(self) -> None:
        """Squash the pending feed to one (first-old, last-new) entry per
        id, dropping no-ops — keeps the feed O(touched ids), not O(ops)."""
        if not self._journal:
            return
        merged: Dict[int, List[Optional[int]]] = {}
        for idx, old, new in self._journal:
            if idx in merged:
                merged[idx][1] = new
            else:
                merged[idx] = [old, new]
        self._journal = [(i, o, n) for i, (o, n) in merged.items() if o != n]

    def drain_deltas(self) -> List[Tuple[int, Optional[int], Optional[int]]]:
        """Return and clear the attachment deltas since the last drain.

        Entries are ``(idx, old, new)`` where a handle is the point itself
        (core), its anchor core (attached border), or None (noise / not
        present); consecutive changes to one id are compacted.  The first
        call activates tracking (and returns []): the journal costs nothing
        until someone consumes it.
        """
        if self._journal is None:
            self._journal = []
            return []
        self._compact_journal()
        out, self._journal = self._journal, []
        return out

    # ------------------------------------------------------------------ #
    # bulk label extraction (for evaluation after each batch)
    # ------------------------------------------------------------------ #
    def labels(self, ids: Optional[Iterable[int]] = None) -> Dict[int, int]:
        """Cluster labels; noise (unattached non-core) -> NOISE.

        Uses one connected-components pass over the forest's edge list
        (O(n α(n))) instead of n ROOT queries; identical partition.
        scipy's C-speed ``connected_components`` is used when importable;
        otherwise a pure-Python union-find with the same labelling
        (components numbered by first occurrence in ``ids`` order).
        """
        ids = list(self.points.keys()) if ids is None else list(ids)
        id_to_pos = {v: i for i, v in enumerate(ids)}
        rows, cols = [], []
        seen = set()
        for (u, v) in self.forest._edge.keys():
            if (v, u) in seen:
                continue
            seen.add((u, v))
            if u in id_to_pos and v in id_to_pos:
                rows.append(id_to_pos[u])
                cols.append(id_to_pos[v])
        comp = _connected_components(len(ids), rows, cols)
        out: Dict[int, int] = {}
        for v, pos in id_to_pos.items():
            if self.support[v] == 0 and self.attach[v] is None:
                out[v] = NOISE
            else:
                out[v] = int(comp[pos])
        return out

    # ------------------------------------------------------------------ #
    # checkpointable state (used by repro_torch.api snapshot/restore)
    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Full structural state as fixed-dtype arrays (npz-serialisable).

        Bucket keys are raw bytes of constant width (exact codes: 8·d;
        mixed device keys: 8), stored as a uint8 tensor.  Forest edges are
        stored explicitly so ``load_state_dict`` restores the *exact*
        spanning forest — border-point anchors are history-dependent, so a
        replay-based restore could legally land them in another cluster.
        """
        ids = sorted(self.points)
        n = len(ids)
        d = self.d
        points = np.zeros((n, d), dtype=np.float64)
        support = np.zeros(n, dtype=np.int64)
        attach = np.full(n, -1, dtype=np.int64)
        keylen = len(self.keys[ids[0]][0]) if n else 0
        keys = np.zeros((n, self.t, keylen), dtype=np.uint8)
        for j, i in enumerate(ids):
            points[j] = self.points[i]
            support[j] = self.support[i]
            if self.attach[i] is not None:
                attach[j] = self.attach[i]
            for ti, key in enumerate(self.keys[i]):
                keys[j, ti] = np.frombuffer(key, dtype=np.uint8)
        edges = sorted(
            (u, v) for (u, v) in self.forest._edge if u < v
        )
        return {
            "ids": np.asarray(ids, dtype=np.int64),
            "points": points,
            "keys": keys,
            "support": support,
            "attach": attach,
            "edges": np.asarray(edges, dtype=np.int64).reshape(-1, 2),
            "next_idx": np.asarray(self._next_idx, dtype=np.int64),
        }

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        """Restore a :meth:`state_dict` into this (empty) instance."""
        if self.points:
            raise ValueError("load_state_dict requires an empty structure")
        ids = [int(i) for i in state["ids"]]
        points = np.asarray(state["points"], dtype=np.float64)
        keys = np.asarray(state["keys"], dtype=np.uint8)
        support = np.asarray(state["support"], dtype=np.int64)
        attach = np.asarray(state["attach"], dtype=np.int64)
        for j, i in enumerate(ids):
            self.points[i] = points[j]
            self.keys[i] = [keys[j, ti].tobytes() for ti in range(self.t)]
            self.support[i] = int(support[j])
            self.attach[i] = int(attach[j]) if attach[j] >= 0 else None
            self.forest.add_node(i)
            for ti, key in enumerate(self.keys[i]):
                b = self.buckets.get_or_create(ti, key)
                b.members.add(i)
                if support[j] > 0:
                    b.add_core(i)
        for i in ids:
            a = self.attach[i]
            if a is not None:
                self.anchored.setdefault(a, set()).add(i)
        for u, v in np.asarray(state["edges"], dtype=np.int64).reshape(-1, 2):
            if not self.forest.link(int(u), int(v)):
                raise ValueError(f"edge ({u}, {v}) does not extend a forest")
        self._next_idx = int(state["next_idx"])

    # ------------------------------------------------------------------ #
    # internal: Alg. 2 subroutines
    # ------------------------------------------------------------------ #
    def _link_core_point(self, c: int) -> None:
        """LinkCorePoint: splice c into every bucket's core chain."""
        if self._journal is not None:
            self._record(c, self.attach[c], c)  # promotion: c is now core
        # cut any edge incident to c (non-core c had at most its anchor)
        anchor = self.attach[c]
        if anchor is not None:
            self.forest.cut(c, anchor)
            self.anchored[anchor].discard(c)
            self.attach[c] = None

        for i, key in enumerate(self.keys[c]):
            b = self.buckets.get(i, key)
            c1, c2 = b.core_neighbors(c)
            b.add_core(c)
            if c1 is not None and c2 is not None:
                self.forest.cut(c1, c2)
            if c1 is not None:
                self.forest.link(c1, c)
            if c2 is not None:
                self.forest.link(c, c2)
            # orphan re-attachment: only sub-threshold
            # buckets can contain non-core members, so this scan is O(k).
            if self.attach_orphans and len(b.members) < self.k:
                for y in b.members:
                    if y != c and self.support[y] == 0 and self.attach[y] is None:
                        self._anchor(y, c)

    def _unlink_core_point(self, c: int) -> None:
        """UnlinkCorePoint: remove c from every chain, repairing paths.

        The paper's repair (LINK the pred/succ pair per bucket) is not
        sufficient on its own: cycle-avoided chain links mean a bucket's
        connectivity may route through ``c`` via *another* bucket's edge,
        stranding cores the local repair never touches.
        We therefore collect every vertex whose tree may have changed and
        run a replacement-edge scan over the split-off components —
        H-edges are recoverable from the bucket chains, so this restores
        the exact spanning-forest invariant (Thm 2) at a cost proportional
        to the smaller side, and is free when nothing actually split.
        """
        touched: List[int] = []
        for i, key in enumerate(self.keys[c]):
            b = self.buckets.get(i, key)
            c1, c2 = b.core_neighbors(c)
            b.remove_core(c)
            if c1 is not None:
                self.forest.cut(c1, c)
                touched.append(c1)
            if c2 is not None:
                self.forest.cut(c, c2)
                touched.append(c2)
            if c1 is not None and c2 is not None:
                self.forest.link(c1, c2)
        # re-link any non-core points attached to c
        for y in list(self.anchored.get(c, ())):
            self.forest.cut(y, c)
            self.anchored[c].discard(y)
            self.attach[y] = None
            self._record(y, c, None)  # detach; _anchor records a re-attach
            self._link_non_core_point(y)
            touched.append(y)
        self._repair_components(touched)

    # ------------------------------------------------------------------ #
    # replacement-edge repair (correctness fix over the paper's pseudocode)
    # ------------------------------------------------------------------ #
    def _repair_components(self, touched: List[int]) -> None:
        """Re-merge split-off components that H still connects.

        Every component created by the cuts contains one of ``touched``.
        For all but the largest such component, scan each core member's
        buckets and LINK it to its chain pred/succ — this covers every
        consecutive-core H-pair with an endpoint in a scanned component,
        which is exactly the set of possibly-stranded pairs.
        """
        if self.repair == "paper":
            return
        comps = {}
        for v in touched:
            if v in self.points:
                comps.setdefault(self.forest.root(v), v)
        if len(comps) <= 1:
            return
        self.n_repair_scans += 1
        # enumerate components round-robin so total work is bounded by the
        # SMALLER sides: the last iterator standing is the largest
        # component and is never fully materialised.
        iters = {r: self.forest.tree_nodes(v) for r, v in comps.items()}
        collected = {r: [] for r in comps}
        active = set(iters)
        while len(active) > 1:
            for r in list(active):
                try:
                    collected[r].append(next(iters[r]))
                except StopIteration:
                    active.discard(r)
        snapshots = [collected[r] for r in comps if r not in active]
        if self.obs.enabled:
            # repair depth: nodes collected off the smaller sides — the
            # per-delete cost the paper bounds by the splits' small halves
            self.obs.histogram("engine.repair_nodes").observe(
                sum(len(snap) for snap in snapshots))
        for snap in snapshots:
            for w in snap:
                if self.support.get(w, 0) == 0:
                    continue
                for j, key in enumerate(self.keys[w]):
                    b = self.buckets.get(j, key)
                    p, s = b.core_neighbors(w)
                    for cand in (p, s):
                        if cand is not None and self.forest.link(w, cand):
                            self.n_repair_links += 1

    def _link_non_core_point(self, x: int) -> None:
        """LinkNonCorePoint: attach x to one colliding core point, if any."""
        for i, key in enumerate(self.keys[x]):
            b = self.buckets.get(i, key)
            if b is None:
                continue
            c = b.first_core()
            if c is not None and c != x:
                self._anchor(x, c)
                return

    def _anchor(self, y: int, c: int) -> None:
        if self.forest.link(y, c):
            self.attach[y] = c
            self.anchored.setdefault(c, set()).add(y)
            self._record(y, None, c)

    # ------------------------------------------------------------------ #
    # invariant checks (used by tests)
    # ------------------------------------------------------------------ #
    def check_invariants(self) -> None:
        # 1. support counts are exact
        for idx, keys in self.keys.items():
            s = sum(
                1 for i, key in enumerate(keys) if len(self.buckets.get(i, key)) >= self.k
            )
            assert s == self.support[idx], (idx, s, self.support[idx])
        # 2. buckets of size >= k contain only core points; core chains match
        for i, table in enumerate(self.buckets.tables):
            for key, b in table.items():
                cores = sorted(y for y in b.members if self.support[y] > 0)
                assert b.cores == cores, (i, key, b.cores, cores)
                if len(b.members) >= self.k:
                    assert len(cores) == len(b.members)
        # 3. non-core degree <= 1; forest degrees of cores O(t)
        for idx in self.points:
            deg = self.forest.degree(idx)
            if self.support[idx] == 0:
                assert deg <= 1, (idx, deg)
                if self.attach[idx] is not None:
                    assert self.forest.has_edge(idx, self.attach[idx])
            else:
                assert deg <= 2 * self.t + len(self.anchored.get(idx, ())), idx
        # 4. forest edges only touch (core,core) or (core,non-core anchor)
        for (u, v) in self.forest._edge:
            su, sv = self.support[u] > 0, self.support[v] > 0
            assert su or sv, (u, v)
        # 5. every core pair sharing a bucket is in the same tree (Thm 2)
        for i, table in enumerate(self.buckets.tables):
            for key, b in table.items():
                if len(b.cores) > 1:
                    r0 = self.forest.root(b.cores[0])
                    for c in b.cores[1:]:
                        assert self.forest.root(c) == r0
