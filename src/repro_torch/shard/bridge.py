"""Boundary bridge: cross-shard cluster merging over the collision graph.

A shard's inner index only sees its own points, so two global facts are
invisible to it:

  * **support** — Definition 4 is global: a bucket with ``k`` members
    split across shards makes all of them core, while every local bucket
    stays sub-threshold;
  * **connectivity** — core points sharing a bucket are one cluster even
    when they live on different shards (and border points may have their
    only colliding core on a remote shard).

The bridge keeps a directory of the *global* buckets — membership,
per-shard occupancy, exact global **and local** support counts (the same
threshold-crossing bookkeeping DynamicDBSCAN does, minus the forest).

The key structural fact (the cell-graph locality argument of de Berg et
al., and the merge step of Wang–Gu–Shun's parallel DBSCAN): the inner
engines already maintain exact intra-shard connectivity under updates —
their Euler-tour forests chain the *locally core* members of every
bucket.  The only buckets whose collision edges the local forests can
miss are the **interesting** ones:

  * buckets whose members span more than one shard, or
  * buckets holding a *boundary core* — a point that is globally core
    (Definition 4 over the global bucket) but locally sub-threshold, so
    its home shard never chained it.

``incremental=True`` (default) maintains, under ``insert`` / ``delete``
/ ``move``, exactly this boundary-bucket set plus per-bucket merge
*representatives*: one locally-core core per (bucket, shard) — all
locally-core cores of a bucket on one shard are already one inner
component, so one stands in for all — and the bucket's boundary cores.
Insertions and promotions extend these eagerly through the touched
buckets and threshold crossings; deletions and demotions shrink or
re-mark them (a dead cached representative is repaired lazily).  Every
mutation stamps an epoch; the first query of an epoch builds a small
quotient union-find by chaining each interesting bucket's
representatives through their *current* inner component handles
(inner-find = Euler-tour ROOT) — O(boundary), not O(n) — and
``resolve()`` is then one inner find plus one quotient find.
``labels()`` reuses the per-shard labellings and chains only the
interesting buckets.

``incremental=False`` restores the PR-2 path: :meth:`merge` rebuilds a
throwaway union-find over *all* live points and scans the whole
directory on every call (kept as the oracle and fallback).

Equivalence caveat (shared with the repo's cross-backend equivalence in
general): which cluster a *border* point joins is a tie-break.  When a
non-core point collides with cores of two different clusters, the
single-shard engine keeps whichever anchor its update history produced,
while the merge keeps the shard-local anchor (or scans tables in order
for a remote one) — the core partition and the noise set always match,
but such a border point can land in the other colliding cluster.  The
paper's well-separated workloads never exercise the tie.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..core.dynamic_dbscan import NOISE
from ..obs import NULL_OBS, Obs

BucketKey = Tuple[int, bytes]  # (table, key bytes)

# merge-representative classes of a live point w.r.t. one of its buckets
_NONCORE, _LOCAL_CORE, _BOUNDARY_CORE = 0, 1, 2


class _Reps:
    """Merge representatives of one bucket: per-shard locally-core count
    and cached representative (None = stale, repaired lazily), plus the
    bucket's boundary cores."""

    __slots__ = ("lc_count", "lc_rep", "bc")

    def __init__(self):
        self.lc_count: Dict[int, int] = {}
        self.lc_rep: Dict[int, Optional[int]] = {}
        self.bc: Set[int] = set()

    def units(self) -> int:
        return len(self.lc_count) + len(self.bc)


class BoundaryBridge:
    def __init__(self, t: int, k: int, attach_orphans: bool = True,
                 incremental: bool = True, obs: Obs = NULL_OBS,
                 core_eligible: Optional[Callable[[int], bool]] = None):
        self.t, self.k = int(t), int(k)
        self.attach_orphans = attach_orphans
        self.incremental = bool(incremental)
        self.obs = obs
        # Sampled-core mode (inner_backend="approx"): only points passing
        # this predicate can gain support, and the threshold tests run on
        # eligible-member counts (n_elig / elig_sc) instead of raw bucket
        # sizes — mirroring SampledCoreDBSCAN's _ssize.  None = exact:
        # the eligible structures stay empty and every test reads the raw
        # counts, so the exact path pays nothing.
        self.core_eligible = core_eligible
        self.elig: Dict[int, bool] = {}  # predicate memoised per live id
        self.n_elig: Dict[BucketKey, int] = {}
        self.elig_sc: Dict[BucketKey, Dict[int, int]] = {}
        # instruments bound once (no-ops when un-instrumented); the
        # rep-cache counters split the lazy-repair bookkeeping into the
        # hit/miss view the observability report wants
        self._h_quotient_us = obs.histogram("bridge.quotient_us")
        self._h_merge_us = obs.histogram("bridge.merge_us")
        self._c_q_hit = obs.counter("bridge.quotient_cache_hit")
        self._c_q_miss = obs.counter("bridge.quotient_cache_miss")
        self._c_rep_hit = obs.counter("bridge.rep_cache_hit")
        self._c_rep_miss = obs.counter("bridge.rep_cache_miss")
        self.members: Dict[BucketKey, Set[int]] = {}
        self.shard_count: Dict[BucketKey, Dict[int, int]] = {}
        self.keys: Dict[int, List[bytes]] = {}
        self.support: Dict[int, int] = {}  # #buckets of size >= k (global)
        self.n_boundary_buckets = 0  # buckets whose members span >1 shard
        self.n_merge_passes = 0
        self.n_bridge_unions = 0
        # --- incremental boundary structure (see module docstring) ---
        self.home: Dict[int, int] = {}           # idx -> shard
        self.local_support: Dict[int, int] = {}  # #buckets locally >= k
        self.n_cores: Dict[BucketKey, int] = {}  # global cores per bucket
        self._rep: Dict[BucketKey, int] = {}     # cached live core per bucket
        self._reps: Dict[BucketKey, _Reps] = {}  # merge representatives
        self.interesting: Set[BucketKey] = set()
        self.epoch = 0  # bumped per mutation; quotient is epoch-stamped
        self._q_parent: Dict[int, int] = {}
        self._q_epoch = -1
        self.n_quotient_builds = 0
        self.n_boundary_merges = 0
        self.n_rep_repairs = 0

    # ------------------------------------------------------------------ #
    # directory maintenance (mirrors DynamicDBSCAN's support bookkeeping)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _cls(sup: int, loc: int) -> int:
        if sup <= 0:
            return _NONCORE
        return _BOUNDARY_CORE if loc == 0 else _LOCAL_CORE

    def _refresh_interesting(self, b: BucketKey) -> None:
        ent = self._reps.get(b)
        if b in self.members and (len(self.shard_count[b]) > 1
                                  or (ent is not None and ent.bc)):
            self.interesting.add(b)
        else:
            self.interesting.discard(b)

    def _rep_add(self, b: BucketKey, m: int, cls: int, shard: int) -> None:
        if cls == _NONCORE:
            return
        ent = self._reps.get(b)
        if ent is None:
            ent = self._reps[b] = _Reps()
        if cls == _BOUNDARY_CORE:
            ent.bc.add(m)
        else:
            ent.lc_count[shard] = ent.lc_count.get(shard, 0) + 1
            if ent.lc_rep.get(shard) is None:
                ent.lc_rep[shard] = m

    def _rep_remove(self, b: BucketKey, m: int, cls: int, shard: int) -> None:
        if cls == _NONCORE:
            return
        ent = self._reps[b]
        if cls == _BOUNDARY_CORE:
            ent.bc.discard(m)
        else:
            n = ent.lc_count[shard] - 1
            if n:
                ent.lc_count[shard] = n
                if ent.lc_rep.get(shard) == m:
                    ent.lc_rep[shard] = None  # stale; repaired lazily
            else:
                del ent.lc_count[shard]
                ent.lc_rep.pop(shard, None)
        if not ent.lc_count and not ent.bc:
            del self._reps[b]

    def _lc_rep_of(self, b: BucketKey, shard: int) -> int:
        """The (bucket, shard) locally-core representative, re-scanned
        only when the cached one was removed."""
        ent = self._reps[b]
        m = ent.lc_rep.get(shard)
        if m is not None:
            self._c_rep_hit.inc()
            return m
        self.n_rep_repairs += 1
        self._c_rep_miss.inc()
        for y in self.members[b]:
            if (self.home[y] == shard and self.support[y] > 0
                    and self.local_support[y] > 0):
                m = y
                break
        assert m is not None, (b, shard)
        ent.lc_rep[shard] = m
        return m

    def _pre(self, pre: Dict[int, Tuple[int, int]], m: int) -> None:
        if m not in pre:
            pre[m] = (self.support[m], self.local_support[m])

    def _apply_transitions(self, pre: Dict[int, Tuple[int, int]],
                           skip: Optional[int] = None) -> None:
        """Re-class every touched point and migrate it between the
        per-bucket representative structures."""
        for m, (sup0, loc0) in pre.items():
            if m == skip:
                continue
            c0 = self._cls(sup0, loc0)
            c1 = self._cls(self.support[m], self.local_support[m])
            if c0 == c1:
                continue
            s = self.home[m]
            for i, key in enumerate(self.keys[m]):
                b = (i, key)
                self._rep_remove(b, m, c0, s)
                self._rep_add(b, m, c1, s)
                self._refresh_interesting(b)

    def insert(self, idx: int, keys: List[bytes], shard: int) -> None:
        if idx in self.keys:
            raise KeyError(f"index {idx} already present in bridge directory")
        inc = self.incremental
        pred = self.core_eligible
        e_idx = True if pred is None else bool(pred(idx))
        if pred is not None:
            self.elig[idx] = e_idx
        self.keys[idx] = keys
        self.support[idx] = 0
        self.home[idx] = shard
        self.local_support[idx] = 0
        promoted: Set[int] = set()
        pre: Dict[int, Tuple[int, int]] = {}
        for i, key in enumerate(keys):
            b = (i, key)
            mem = self.members.setdefault(b, set())
            mem.add(idx)
            sc = self.shard_count.setdefault(b, {})
            sc[shard] = sc.get(shard, 0) + 1
            if sc[shard] == 1 and len(sc) == 2:
                self.n_boundary_buckets += 1
            # threshold tests run on eligible counts; a non-eligible
            # arrival changes no count, so no crossing is possible
            if pred is None:
                sz, loc_sz = len(mem), sc[shard]
            elif e_idx:
                sz = self.n_elig[b] = self.n_elig.get(b, 0) + 1
                es = self.elig_sc.setdefault(b, {})
                loc_sz = es[shard] = es.get(shard, 0) + 1
            else:
                sz = loc_sz = 0
            if sz == self.k:
                for y in mem:
                    if pred is not None and not self.elig[y]:
                        continue
                    if inc:
                        self._pre(pre, y)
                    self.support[y] += 1
                    if self.support[y] == 1:
                        promoted.add(y)
            elif sz > self.k:
                if inc:
                    self._pre(pre, idx)
                self.support[idx] += 1
            if not inc:
                continue
            # local threshold crossing: members homed on this shard gain
            # local support (their home forest now chains this bucket)
            if loc_sz == self.k:
                for y in mem:
                    if self.home[y] == shard and (pred is None
                                                  or self.elig[y]):
                        self._pre(pre, y)
                        self.local_support[y] += 1
            elif loc_sz > self.k:
                self._pre(pre, idx)
                self.local_support[idx] += 1
            self._refresh_interesting(b)
        if not inc:
            return
        if self.support[idx] > 0:  # core on arrival via sz > k buckets
            promoted.add(idx)
        for p in promoted:
            for i, key in enumerate(self.keys[p]):
                b = (i, key)
                self.n_cores[b] = self.n_cores.get(b, 0) + 1
                self._rep.setdefault(b, p)
        # idx's own status was seeded as (0, 0); transition it like the rest
        pre.setdefault(idx, (0, 0))
        self._apply_transitions(pre)
        self.epoch += 1

    def delete(self, idx: int, shard: int) -> None:
        if idx not in self.keys:
            raise KeyError(
                f"cannot delete index {idx}: not in bridge directory")
        inc = self.incremental
        pred = self.core_eligible
        e_idx = True if pred is None else self.elig[idx]
        was_core = self.support[idx] > 0
        cls_idx = (self._cls(self.support[idx], self.local_support[idx])
                   if inc else _NONCORE)
        demoted: List[int] = []
        pre: Dict[int, Tuple[int, int]] = {}
        for i, key in enumerate(self.keys[idx]):
            b = (i, key)
            mem = self.members[b]
            mem.discard(idx)
            sc = self.shard_count[b]
            sc[shard] -= 1
            if sc[shard] == 0:
                del sc[shard]
                if len(sc) == 1:
                    self.n_boundary_buckets -= 1
            # a non-eligible departure changes no eligible count: no
            # crossing possible
            if pred is None:
                crossed = len(mem) == self.k - 1
                loc_sz = sc.get(shard, 0)
            elif e_idx:
                ne = self.n_elig[b] - 1
                if ne:
                    self.n_elig[b] = ne
                else:
                    del self.n_elig[b]
                crossed = ne == self.k - 1
                es = self.elig_sc[b]
                es[shard] -= 1
                if es[shard] == 0:
                    del es[shard]
                    if not es:
                        del self.elig_sc[b]
                loc_sz = es.get(shard, 0)
            else:
                crossed = False
                loc_sz = self.k  # sentinel: no local crossing either
            if crossed:
                for y in mem:
                    if pred is not None and not self.elig[y]:
                        continue
                    if inc:
                        self._pre(pre, y)
                    self.support[y] -= 1
                    if self.support[y] == 0:
                        demoted.append(y)
            if inc:
                self._rep_remove(b, idx, cls_idx, shard)
                if was_core:
                    self._drop_core_from(b)
                # local threshold crossing on the vacated shard
                if loc_sz == self.k - 1:
                    for y in mem:
                        if self.home[y] == shard and (pred is None
                                                      or self.elig[y]):
                            self._pre(pre, y)
                            self.local_support[y] -= 1
            if not mem:
                del self.members[b]
                del self.shard_count[b]
                self.n_cores.pop(b, None)
                self._rep.pop(b, None)
                self._reps.pop(b, None)
                self.n_elig.pop(b, None)
                self.elig_sc.pop(b, None)
            if inc:
                self._refresh_interesting(b)
        if inc:
            for p in demoted:
                for i, key in enumerate(self.keys[p]):
                    self._drop_core_from((i, key))
        del self.keys[idx]
        del self.support[idx]
        if pred is not None:
            del self.elig[idx]
        if inc:
            del self.home[idx]
            del self.local_support[idx]
            self._apply_transitions(pre, skip=idx)
            self.epoch += 1

    def move(self, idx: int, src: int, dst: int) -> None:
        """Re-home ``idx`` (rebalance): membership and global support are
        placement-invariant; per-shard occupancy — and with it local
        support and the boundary-bucket set — shifts between ``src`` and
        ``dst``."""
        if idx not in self.keys:
            raise KeyError(f"cannot move index {idx}: not in bridge directory")
        if src == dst:
            return
        inc = self.incremental
        pre: Dict[int, Tuple[int, int]] = {}
        if inc:
            # take idx out of its buckets' representatives under its old
            # class/home; the transition pass re-adds it under the new
            cls_idx = self._cls(self.support[idx], self.local_support[idx])
            for i, key in enumerate(self.keys[idx]):
                self._rep_remove((i, key), idx, cls_idx, src)
            pre[idx] = (0, 0)  # re-class from scratch after the move
            self.home[idx] = dst
            self.local_support[idx] = 0  # recomputed bucket by bucket
        pred = self.core_eligible
        e_idx = True if pred is None else self.elig[idx]
        for i, key in enumerate(self.keys[idx]):
            b = (i, key)
            sc = self.shard_count[b]
            sc[src] -= 1
            before = len(sc)
            if sc[src] == 0:
                del sc[src]
            sc[dst] = sc.get(dst, 0) + 1
            after = len(sc)
            if before > 1 and after == 1:
                self.n_boundary_buckets -= 1
            elif before == 1 and after > 1:
                self.n_boundary_buckets += 1
            if not inc:
                continue
            # local crossings run on eligible per-shard counts; moving a
            # non-eligible point shifts none of them
            if pred is None:
                es = sc
            elif e_idx:
                es = self.elig_sc[b]
                es[src] -= 1
                if es[src] == 0:
                    del es[src]
                es[dst] = es.get(dst, 0) + 1
            else:
                self._refresh_interesting(b)
                continue
            # src shard lost a member: crossing k-1 demotes its residents
            if es.get(src, 0) == self.k - 1:
                for y in self.members[b]:
                    if (y != idx and self.home[y] == src
                            and (pred is None or self.elig[y])):
                        self._pre(pre, y)
                        self.local_support[y] -= 1
            # dst shard gained one: crossing k promotes its residents
            if es.get(dst, 0) == self.k:
                for y in self.members[b]:
                    if (y != idx and self.home[y] == dst
                            and (pred is None or self.elig[y])):
                        self._pre(pre, y)
                        self.local_support[y] += 1
            if es.get(dst, 0) >= self.k:
                self.local_support[idx] += 1
            self._refresh_interesting(b)
        if inc:
            self._apply_transitions(pre)
            self.epoch += 1

    def _drop_core_from(self, b: BucketKey) -> None:
        if b in self.n_cores:
            n = self.n_cores[b] - 1
            if n:
                self.n_cores[b] = n
            else:
                del self.n_cores[b]
                self._rep.pop(b, None)

    def _bucket_core(self, b: BucketKey) -> Optional[int]:
        """Some live global core of bucket ``b`` (cached; rescanned only
        after core churn invalidates the cache)."""
        mem = self.members.get(b)
        if not mem or not self.n_cores.get(b, 0):
            return None
        rep = self._rep.get(b)
        if rep is not None and rep in mem and self.support.get(rep, 0) > 0:
            self._c_rep_hit.inc()
            return rep
        self._c_rep_miss.inc()
        for m in mem:
            if self.support.get(m, 0) > 0:
                self._rep[b] = m
                return m
        return None

    def is_core(self, idx: int) -> bool:
        return self.support[idx] > 0

    # ------------------------------------------------------------------ #
    # incremental queries: inner-find -> bridge-find over the boundary
    # ------------------------------------------------------------------ #
    # hot-path
    def _quotient(self, comp_of: Callable[[int], int],
                  comp_of_batch: Optional[Callable] = None) -> Dict[int, int]:
        """Epoch-cached entry to :meth:`_quotient_build`: the common case
        (no mutation since the last query) is one dict lookup."""
        if self._q_epoch == self.epoch:
            self._c_q_hit.inc()
            return self._q_parent
        self._c_q_miss.inc()
        with self.obs.tracer.span("bridge.quotient",
                                  interesting=len(self.interesting)), \
                self._h_quotient_us.timer():
            return self._quotient_build(comp_of, comp_of_batch)

    def _quotient_build(self, comp_of: Callable[[int], int],
                        comp_of_batch: Optional[Callable] = None
                        ) -> Dict[int, int]:
        """The epoch's quotient union-find over inner component handles:
        chain every interesting bucket's merge representatives through
        their current inner components.  A handle is whatever the inner
        engine's native find returns (for the Euler-tour engines, the
        forest's canonical node payload, built from globally-unique point
        handles) — orderable and never colliding across shards, so the
        handle alone keys the node.  The representatives are maintained
        under the updates themselves, so the build does no directory
        scans — its cost is one inner ROOT per distinct representative
        (memoised across buckets).

        Three phases — gather, resolve, chain — so a remote-shard caller
        can pass ``comp_of_batch`` and resolve every representative in
        one round trip per shard instead of one per ROOT walk.  The
        result is identical either way: union is by min handle, so the
        final roots do not depend on resolution or chaining order.
        """
        keys = self.keys
        home = self.home
        # 1. gather: each chained bucket's units as resolution tasks.
        # Locally-core cores sharing one (shard, table-0 cell) are
        # provably one inner component — the home forest chains every
        # bucket it sees, and a table-0 bucket never spans shards — so
        # their task key is the cell, collapsing the root walks to one
        # per distinct cell.  Boundary cores are not locally chained and
        # resolve per point (task key ("bc", m)).
        tasks: Dict[Tuple, int] = {}  # task key -> point to resolve
        groups: List[List[Tuple]] = []
        reps_map = self._reps
        for b in self.interesting:
            ent = reps_map.get(b)
            if ent is None or ent.units() < 2:
                continue  # at most one component: nothing to chain
            g: List[Tuple] = []
            for shard, m in ent.lc_rep.items():
                if m is None:
                    m = self._lc_rep_of(b, shard)
                cell = (home[m], keys[m][0])
                tasks.setdefault(cell, m)
                g.append(cell)
            for m in ent.bc:
                bc = ("bc", m)
                tasks.setdefault(bc, m)
                g.append(bc)
            groups.append(g)
        # 2. resolve every distinct representative's inner component
        if comp_of_batch is None:
            node = {tk: comp_of(m) for tk, m in tasks.items()}
        else:
            order = list(tasks)
            vals = comp_of_batch([tasks[tk] for tk in order])
            node = dict(zip(order, vals))
        # 3. chain
        parent: Dict[int, int] = {}

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for g in groups:
            n0: Optional[int] = None
            for tk in g:
                v = node[tk]
                parent.setdefault(v, v)
                if n0 is None:
                    n0 = v
                    continue
                ra, rb = find(n0), find(v)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
        self._q_parent = parent
        self._q_epoch = self.epoch
        self.n_quotient_builds += 1
        return parent

    def _q_find(self, node: int) -> int:  # hot-path
        parent = self._q_parent
        if node not in parent:
            return node  # component untouched by any interesting bucket
        while parent[node] != node:
            parent[node] = parent[parent[node]]
            node = parent[node]
        return node

    # hot-path
    def resolve(self, idx: int, comp_of: Callable[[int], int],
                anchored: bool,
                comp_of_batch: Optional[Callable] = None) -> Optional[int]:
        """Global component handle of live ``idx`` (None = noise) — the
        label() hot path.  ``comp_of`` is the inner engines' native find
        (Euler-tour ROOT, by global handle); ``anchored`` says whether the
        home shard holds a local anchor for a non-core ``idx``;
        ``comp_of_batch`` (optional) lets a quotient rebuild resolve its
        representatives in bulk (one round trip per remote shard)."""
        self._quotient(comp_of, comp_of_batch)
        if self.support[idx] > 0 or anchored:
            return self._q_find(comp_of(idx))
        if self.attach_orphans:
            # border point whose only colliding core is remote (or was
            # locally sub-threshold): first core bucket in table order,
            # matching LinkNonCorePoint's scan order
            for i, key in enumerate(self.keys[idx]):
                c = self._bucket_core((i, key))
                if c is not None:
                    return self._q_find(comp_of(c))
        return None

    # ------------------------------------------------------------------ #
    # the merge pass (full scan when incremental=False; labels() on the
    # incremental path restricts step 2 to the interesting buckets)
    # ------------------------------------------------------------------ #
    def merge(self, shard_labels: Iterable[Dict[int, int]],
              boundary_only: bool = False) -> Dict[int, int]:
        """Global canonical labelling from the per-shard labellings.

        Components are numbered by first occurrence in ascending-id order;
        noise (global non-core with no colliding global core) -> NOISE.
        With ``boundary_only`` step 2 chains just the maintained
        interesting-bucket set instead of scanning the whole directory —
        exact, because the local chains already cover every other bucket.
        """
        with self.obs.tracer.span("bridge.merge",
                                  boundary_only=boundary_only), \
                self._h_merge_us.timer():
            return self._merge_impl(shard_labels, boundary_only)

    def _merge_impl(self, shard_labels: Iterable[Dict[int, int]],
                    boundary_only: bool) -> Dict[int, int]:
        if boundary_only:
            self.n_boundary_merges += 1
        else:
            self.n_merge_passes += 1
        parent: Dict[int, int] = {i: i for i in self.support}

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        def union(a: int, b: int) -> None:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

        # 1. shard-local components (intra-shard forests do the bulk work)
        clustered: Set[int] = set()
        for lab in shard_labels:
            rep: Dict[int, int] = {}
            for i, l in lab.items():
                if l == NOISE:
                    continue
                clustered.add(i)
                if l in rep:
                    union(rep[l], i)
                else:
                    rep[l] = i

        # 2. cross-shard core chains: any bucket the local chains could
        #    not fully cover (spans shards, or holds a core whose support
        #    is remote) gets its global cores chained here.
        buckets = (self.interesting if boundary_only else self.members)
        for b in buckets:
            mem = self.members[b]
            if len(mem) < 2:
                continue
            cores = sorted(m for m in mem if self.support[m] > 0)
            if len(cores) >= 2:
                before = {find(c) for c in cores}
                if len(before) > 1:
                    self.n_bridge_unions += len(before) - 1
                    for u, v in zip(cores, cores[1:]):
                        union(u, v)

        # 3. border points whose only colliding core is remote (or was
        #    locally sub-threshold): attach to the first global core found
        #    in table order, matching LinkNonCorePoint's scan order.
        #    Gated on attach_orphans — with re-attachment disabled the
        #    engines leave such points noise, and so do we.
        if self.attach_orphans:
            for i, sup in self.support.items():
                if sup > 0 or i in clustered:
                    continue
                for ti, key in enumerate(self.keys[i]):
                    cores = [m for m in self.members[(ti, key)]
                             if m != i and self.support[m] > 0]
                    if cores:
                        union(i, min(cores))
                        clustered.add(i)
                        break

        # canonicalise: number components by first occurrence, sorted ids
        out: Dict[int, int] = {}
        number: Dict[int, int] = {}
        for i in sorted(self.support):
            if self.support[i] == 0 and i not in clustered:
                out[i] = NOISE
            else:
                r = find(i)
                out[i] = number.setdefault(r, len(number))
        return out

    # ------------------------------------------------------------------ #
    # diagnostics
    # ------------------------------------------------------------------ #
    def check(self, home: Dict[int, int]) -> None:
        """Directory self-check against the home map (used by tests)."""
        assert set(self.keys) == set(home), "directory/home id mismatch"
        pred = self.core_eligible
        # support counts are exact w.r.t. global (eligible) bucket sizes
        for idx, keys in self.keys.items():
            if pred is None:
                s = sum(1 for i, key in enumerate(keys)
                        if len(self.members[(i, key)]) >= self.k)
            elif self.elig[idx]:
                s = sum(1 for i, key in enumerate(keys)
                        if self.n_elig.get((i, key), 0) >= self.k)
            else:
                s = 0
            assert s == self.support[idx], (idx, s, self.support[idx])
        # eligible-count structures are exact mirrors of membership
        if pred is not None:
            assert set(self.elig) == set(self.keys)
            for idx in self.keys:
                assert self.elig[idx] == bool(pred(idx)), idx
            for b, mem in self.members.items():
                ne = sum(1 for m in mem if self.elig[m])
                assert ne == self.n_elig.get(b, 0), (b, ne)
                esc: Dict[int, int] = {}
                for m in mem:
                    if self.elig[m]:
                        esc[home[m]] = esc.get(home[m], 0) + 1
                assert esc == self.elig_sc.get(b, {}), (b, esc)
        # per-shard occupancy matches the home map; boundary count exact
        n_boundary = 0
        for b, mem in self.members.items():
            assert mem, b
            sc: Dict[int, int] = {}
            for m in mem:
                sc[home[m]] = sc.get(home[m], 0) + 1
            assert sc == self.shard_count[b], (b, sc, self.shard_count[b])
            if len(sc) > 1:
                n_boundary += 1
        assert n_boundary == self.n_boundary_buckets, (
            n_boundary, self.n_boundary_buckets)
        if self.incremental:
            self._check_incremental(home)

    def _check_incremental(self, home: Dict[int, int]) -> None:
        """The maintained boundary structure is exact."""
        assert self.home == home
        pred = self.core_eligible
        for idx, keys in self.keys.items():
            if pred is None:
                loc = sum(
                    1 for i, key in enumerate(keys)
                    if self.shard_count[(i, key)].get(home[idx], 0) >= self.k)
            elif self.elig[idx]:
                loc = sum(
                    1 for i, key in enumerate(keys)
                    if self.elig_sc.get((i, key), {}).get(home[idx], 0)
                    >= self.k)
            else:
                loc = 0
            assert loc == self.local_support[idx], (
                idx, loc, self.local_support[idx])
        interesting: Set[BucketKey] = set()
        seen_reps: Set[BucketKey] = set()
        for b, mem in self.members.items():
            nc = sum(1 for m in mem if self.support[m] > 0)
            assert nc == self.n_cores.get(b, 0), (b, nc, self.n_cores.get(b))
            bc = {m for m in mem
                  if self._cls(self.support[m], self.local_support[m])
                  == _BOUNDARY_CORE}
            lc: Dict[int, int] = {}
            for m in mem:
                if (self._cls(self.support[m], self.local_support[m])
                        == _LOCAL_CORE):
                    lc[home[m]] = lc.get(home[m], 0) + 1
            ent = self._reps.get(b)
            if bc or lc:
                seen_reps.add(b)
                assert ent is not None, b
                assert ent.bc == bc, (b, ent.bc, bc)
                assert ent.lc_count == lc, (b, ent.lc_count, lc)
                for s, m in ent.lc_rep.items():
                    assert s in lc, (b, s)
                    if m is not None:  # cached rep is a valid stand-in
                        assert (home[m] == s and self.support[m] > 0
                                and self.local_support[m] > 0 and m in mem), \
                            (b, s, m)
            else:
                assert ent is None, (b, ent)
            if bc or len(self.shard_count[b]) > 1:
                interesting.add(b)
        assert set(self._reps) == seen_reps
        assert interesting == self.interesting
