"""``ShardedIndex`` — a ClusterIndex of ClusterIndexes.

Points are routed by :class:`ShardRouter` (hash of the table-0 key into
contiguous key ranges) to one of ``cfg.shards`` inner indices, each any
registered grid-bucket backend (``cfg.inner_backend``: ``dynamic``,
``batched``, ``batched-device``, ``emz-static``).  *All* shard access
goes through the wire protocol's :class:`~repro_torch.service.ShardClient` —
``cfg.transport`` selects how a shard is reached:

  * ``"local"`` (default): the inner index lives in-process behind a
    zero-copy client — the pre-protocol behavior and performance;
  * ``"process"``: each shard is a spawned server process
    (``repro_torch.service.worker``) reached over a socket; the coordinator
    routes on a table-0-only hash pass and the shards run the full
    t-table hash *and* the pure-Python forest updates in their own
    interpreters — true ~S× GIL-free update parallelism.  Insert
    responses piggyback the bucket-key digest that feeds the
    coordinator's bridge directory.
  * ``"tcp"``: same protocol over a reconnectable stream socket, with
    timeouts, retries and auth (see
    :class:`~repro_torch.service.transport.TcpTransport`).

With ``cfg.replicas = R > 0`` each shard client is a fault-tolerant
*lane* (:class:`~repro_torch.service.replica.ReplicatedClient`): one primary
plus R replicas kept bit-identical by deterministic update replay.  A
dead primary is promoted away transparently (``failover.*`` counters);
a dead lane member is respawned and resynced in the background.  With
``replicas = 0`` a dead shard surfaces as
:class:`~repro_torch.service.transport.ShardUnavailableError`; the mutation
paths reconcile partial fan-out failure first (insert rolls back the
sub-batches that landed, delete applies bridge updates for exactly the
shards that succeeded), so coordinator state never drifts from shard
state.

Mutations fan out per-shard — ``insert_batch`` splits a run into
per-shard sub-batches, so device backends keep their one-kernel-per-run
hashing, and the sub-batches run concurrently on a thread pool
(``cfg.workers > 1``, or always for ``transport="process"`` where the
threads merely block on sockets; each shard is only ever touched by one
worker at a time; the :class:`BoundaryBridge` is the single shared
structure, lives on the coordinator, and is updated by the coordinating
thread).  The bridge reconciles cross-shard structure so ``labels()`` is
the same global partition the single-shard inner backend computes (same
cores and noise set; border-point ties — see bridge.py — may resolve to
a different colliding cluster) — bit-identical across transports.

Query hot path: with ``cfg.incremental_merge`` (default) the bridge
maintains its cross-shard union-find *under* the updates, so ``label()``
resolves as inner-find -> bridge-find — no global relabel, no O(n) merge
after a mutation.  ``incremental_merge=False`` restores the PR-2
rebuild-per-query path (and is the only option for inner engines without
``native_component_queries``, e.g. ``emz-static``).

``snapshot()`` nests the per-shard snapshots (flattened under
``shard<i>/`` keys, so it round-trips through
``CheckpointManager.save_index`` unchanged), and :meth:`rebalance`
live-migrates a key range between shards by replaying the affected rows
of the source shard's snapshot into the target — snapshot-based live
migration in miniature.

The shards' indices run on the index's ``device`` (``build_index``'s
keyword): an inner ``soa-device`` or ``batched-device`` shard runs its
kernels there ("cuda" by default), in process or in its worker
(``--device``), and a respawned lane member is built there again.  The
coordinator's own hash pass (router slots and the bridge directory's
keys) is the host mirror ``GridLSH.device_keys_batch`` / ``codes_batch``,
as in the reference.

Not supported as inner backends: ``naive`` (its ε-ball components are not
collision-graph components, so shard-local merges would over-connect) and
``emz-fixed`` (insert-only).
"""

from __future__ import annotations

import contextvars
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from ..api.backends import MIXED_KEY_BACKENDS
from ..api.config import ClusterConfig
from ..api.index import ClusterIndex
from ..core.dynamic_dbscan import NOISE, check_unique_ids
from ..core.hashing import GridLSH
from ..obs import merge_snapshots, write_chrome
from ..service.replica import connect_lanes
from ..service.transport import (ShardClient, ShardUnavailableError,
                                 connect_shards)
from .bridge import BoundaryBridge
from .router import RebalancePlan, ShardRouter

UNSUPPORTED_INNER = ("naive", "emz-fixed", "sharded", "tiered")

PlanLike = Union[RebalancePlan, Tuple[int, int, int]]


class ShardedIndex(ClusterIndex):
    def __init__(self, cfg: ClusterConfig, device: Optional[str] = None):
        super().__init__(cfg)
        if cfg.inner_backend in UNSUPPORTED_INNER:
            raise ValueError(
                f"inner_backend {cfg.inner_backend!r} cannot be sharded: "
                "cross-shard merging needs a grid-bucket engine with "
                "deletions (dynamic, batched, batched-device, emz-static)"
            )
        # inner indices are always "local" from their own point of view —
        # a worker process serves a plain in-process engine
        self._inner_cfg = cfg.replace(backend=cfg.inner_backend,
                                      transport="local")
        # "remote" = the shard is behind a wire codec (process or tcp):
        # route on table 0 only and let the shards hash in parallel
        self._remote = cfg.transport != "local"
        self.obs.set_proc("coordinator")
        if cfg.replicas > 0:
            # fault-tolerant lanes: each client is 1 primary + R replicas
            # behind the same ShardClient surface, with promotion and
            # background respawn+resync on member death
            self.clients: List[ShardClient] = connect_lanes(
                self._inner_cfg, cfg.shards, cfg.transport, cfg.replicas,
                obs=self.obs, device=device)
        else:
            self.clients = connect_shards(
                self._inner_cfg, cfg.shards, cfg.transport, obs=self.obs,
                device=device)
        try:
            self._init_rest(cfg)
        except Exception:
            for c in self.clients:
                c.close()
            raise

    def _init_rest(self, cfg: ClusterConfig) -> None:
        # one LSH family shared by router + bridge; identical to the inner
        # engines' (seeded from the same config), so directory keys match
        # inner bucket keys bit-for-bit
        self.lsh = GridLSH(cfg.d, cfg.eps, cfg.t, seed=cfg.seed)
        self._mixed_keys = cfg.inner_backend in MIXED_KEY_BACKENDS
        # mixed-key inners: the router slots by the same device-hash pass
        # that produces the bucket keys, so routing costs no extra pass
        self.router = ShardRouter(self.lsh, cfg.shards, seed=cfg.seed,
                                  mixed=self._mixed_keys)
        # the incremental merge resolves border points through the home
        # shard's native anchor query; recompute inners can't answer it —
        # capability discovered through the protocol handshake, so it
        # works identically for in-process and spawned shards
        self._incremental = bool(cfg.incremental_merge) and all(
            c.hello().native_component_queries for c in self.clients
        )
        self.native_component_queries = self._incremental
        # sampled inners (inner_backend="approx"): the bridge must judge
        # global support over the same deterministic id sample the inner
        # engines use, or a cross-shard bucket of non-sampled points
        # would mint cores no inner engine recognises
        core_eligible = None
        bridge_k = cfg.k
        if cfg.inner_backend == "approx" and cfg.sample_rate < 1.0:
            from ..core.approx import is_sampled
            rate, aseed = cfg.sample_rate, cfg.approx_seed
            core_eligible = lambda i: is_sampled(i, rate, aseed)  # noqa: E731
            # eligible counts are compared against the sampled analogue
            # of k — the same rescaled threshold SampledCoreDBSCAN uses
            bridge_k = max(1, int(round(cfg.k * cfg.sample_rate)))
        self.bridge = BoundaryBridge(cfg.t, bridge_k,
                                     attach_orphans=cfg.attach_orphans,
                                     incremental=self._incremental,
                                     obs=self.obs,
                                     core_eligible=core_eligible)
        # coordinator-side instruments, bound once (no-ops when cfg.obs is
        # off): per-op latency plus one RPC histogram per shard — the
        # telemetry the straggler detector and the serving report read
        self._h_insert_us = self.obs.histogram("coord.insert_batch_us")
        self._h_delete_us = self.obs.histogram("coord.delete_batch_us")
        self._h_label_us = self.obs.histogram("coord.label_us")
        self._h_labels_us = self.obs.histogram("coord.labels_us")
        self._h_rpc = [self.obs.histogram(f"rpc.shard{s}_us")
                       for s in range(cfg.shards)]
        # thread-pool fan-out: opt-in via workers for local shards; always
        # on for process shards (the threads only block on sockets, so the
        # worker processes update truly in parallel).  workers=1 forces a
        # serial fan-out on either transport.
        n_workers = 0
        if cfg.shards > 1:
            if cfg.workers and cfg.workers > 1:
                n_workers = min(int(cfg.workers), cfg.shards)
            elif self._remote and not cfg.workers:
                n_workers = cfg.shards
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=n_workers,
                               thread_name_prefix="shard")
            if n_workers else None
        )
        self._home: Dict[int, int] = {}  # idx -> shard
        self._next_idx = 0
        self._cache: Optional[Dict[int, int]] = None
        self._comp_fns: Optional[List[Callable[[int], int]]] = None

    @property
    def inners(self) -> List[ClusterIndex]:
        """The in-process inner indices (local transport only; process
        shards hold no Python reference — go through ``clients``)."""
        return [c.index for c in self.clients]  # type: ignore[attr-defined]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        for c in self.clients:
            c.close()

    # ------------------------------------------------------------------ #
    # hashing (one vectorised pass per run, mirroring the inner key space)
    # ------------------------------------------------------------------ #
    def _route_and_key(self, X: np.ndarray) -> Tuple[np.ndarray, List[List[bytes]]]:
        """(n, d) -> ((n,) target shards, per-point bucket keys).

        One hash pass either way: the exact-key path shares a
        ``codes_batch`` pass between the router (table-0 slice) and the
        bridge directory; the mixed-key path shares the one
        ``device_keys_batch`` pass the inner engines need anyway (the
        router slots by the table-0 mixed key)."""
        t = self.cfg.t
        if self._mixed_keys:
            mixed = self.lsh.device_keys_batch(X)  # (n, t, 2) int32
            keys = [[mixed[j, i].tobytes() for i in range(t)]
                    for j in range(X.shape[0])]
            slots = self.router.slots_from_mixed(mixed[:, 0, :])
        else:
            codes = self.lsh.codes_batch(X)  # (n, t, d) int64
            keys = [[codes[j, i].tobytes() for i in range(t)]
                    for j in range(X.shape[0])]
            slots = self.router.slots_from_codes(codes[:, 0, :])
        return self.router.assignment[slots], keys

    def _keys_batch(self, X: np.ndarray) -> List[List[bytes]]:
        return self._route_and_key(X)[1]

    def _route_only(self, X: np.ndarray) -> np.ndarray:
        """(n, d) -> (n,) target shards from a *table-0-only* hash pass.

        The process-transport insert path: the coordinator pays one table
        of hashing to route, and the full t-table pass happens shard-side
        (in parallel, GIL-free), coming back as the response digest."""
        if self._mixed_keys:
            slots = self.router.slots_from_mixed(
                self.lsh.device_keys_batch(X, tables=1)[:, 0, :])
        else:
            slots = self.router.slots_from_codes(
                self.lsh.codes_batch(X, tables=1)[:, 0, :])
        return self.router.assignment[slots]

    @staticmethod
    def _digest_keys(digest: np.ndarray, t: int) -> List[List[bytes]]:
        """(m, t, w) response digest -> per-point bucket-key lists,
        byte-identical to the coordinator's own hash pass."""
        return [[digest[j, i].tobytes() for i in range(t)]
                for j in range(digest.shape[0])]

    # ------------------------------------------------------------------ #
    # per-shard fan-out
    # ------------------------------------------------------------------ #
    def _fanout(self, jobs: Dict[int, Callable[[], Any]],
                return_exceptions: bool = False) -> Dict[int, Any]:
        """Run one job per shard, on the worker pool when it pays off.

        Shards never share inner state, so per-shard jobs are safe to run
        concurrently; results (and the first exception) are collected in
        shard order, keeping the fan-out deterministic.  With
        ``return_exceptions`` a failing job's exception is *returned* in
        its shard's slot instead of raised, so mutation paths can see
        which shards applied their sub-batch and reconcile (roll back or
        apply-what-succeeded) before surfacing the first error.
        Instrumented fan-outs time each job into that shard's RPC
        histogram (the straggler signal) and submit under a copied
        contextvars context so wire spans parent under the coordinator's
        op span even from pool threads."""
        if self.obs.enabled:
            jobs = {s: self._timed_job(self._h_rpc[s], fn)
                    for s, fn in jobs.items()}
        if self._pool is None or len(jobs) <= 1:
            if not return_exceptions:
                return {s: fn() for s, fn in jobs.items()}
            out: Dict[int, Any] = {}
            for s, fn in jobs.items():
                try:
                    out[s] = fn()
                except BaseException as e:
                    out[s] = e
            return out
        if self.obs.enabled:
            futures = {s: self._pool.submit(contextvars.copy_context().run, fn)
                       for s, fn in jobs.items()}
        else:
            futures = {s: self._pool.submit(fn) for s, fn in jobs.items()}
        if not return_exceptions:
            return {s: futures[s].result() for s in sorted(futures)}
        out = {}
        for s in sorted(futures):
            try:
                out[s] = futures[s].result()
            except BaseException as e:
                out[s] = e
        return out

    @staticmethod
    def _timed_job(hist, fn: Callable[[], Any]) -> Callable[[], Any]:
        def run() -> Any:
            with hist.timer():
                return fn()
        return run

    # ------------------------------------------------------------------ #
    # mutations
    # ------------------------------------------------------------------ #
    def insert(self, x: np.ndarray, idx: Optional[int] = None) -> int:
        return self.insert_batch(
            np.asarray(x, dtype=np.float64)[None], ids=[idx]
        )[0]

    def insert_batch(self, X: np.ndarray,
                     ids: Optional[Sequence[Optional[int]]] = None) -> List[int]:
        if not self.obs.enabled:
            return self._insert_batch_impl(X, ids)
        with self.obs.tracer.span("coord.insert_batch", n=len(X)), \
                self._h_insert_us.timer():
            return self._insert_batch_impl(X, ids)

    def _insert_batch_impl(self, X: np.ndarray,
                           ids: Optional[Sequence[Optional[int]]]) -> List[int]:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2 or X.shape[1] != self.cfg.d:
            raise ValueError(f"batch shape {X.shape} != (n, {self.cfg.d})")
        if ids is not None and len(ids) != X.shape[0]:
            raise ValueError("ids length must match batch size")
        n = X.shape[0]
        # resolve handles with claim_index semantics (same messages, same
        # auto-id sequence) without copying the live-id set per call
        fresh: set = set()
        out: List[int] = []
        nxt0 = nxt = self._next_idx
        for j in range(n):
            idx = None if ids is None else ids[j]
            if idx is None:
                idx = nxt
            elif idx in self._home or idx in fresh:
                raise KeyError(f"index {idx} already present")
            nxt = max(nxt, idx + 1)
            fresh.add(idx)
            out.append(idx)
        self._next_idx = nxt
        if n == 0:
            return out
        if self._remote:
            # route on table 0 only; the shards hash in parallel and the
            # insert responses piggyback the bucket-key digest the bridge
            # directory is fed from
            with self.obs.tracer.span("coord.route", n=n):
                shards = self._route_only(X)
            keys: List[Optional[List[bytes]]] = [None] * n
        else:
            with self.obs.tracer.span("coord.route_and_key", n=n):
                shards, keys = self._route_and_key(X)
        # fan out per shard, preserving in-shard stream order so batched
        # inners hash each sub-run in one kernel call
        jobs: Dict[int, Callable[[], Any]] = {}
        by_shard: Dict[int, np.ndarray] = {}
        for s in range(self.cfg.shards):
            rows = np.flatnonzero(shards == s)
            if rows.size:
                by_shard[s] = rows
                jobs[s] = (lambda s=s, rows=rows:
                           self.clients[s].insert_batch(
                               X[rows], ids=[out[j] for j in rows],
                               want_digest=self._remote))
        with self.obs.tracer.span("coord.fanout", shards=len(jobs)):
            results = self._fanout(jobs, return_exceptions=True)
        failed = {s: r for s, r in results.items()
                  if isinstance(r, BaseException)}
        if failed:
            self._rollback_insert(results, by_shard, out, X, nxt0)
            raise failed[min(failed)]
        if self._remote:
            for s, rows in by_shard.items():
                sub = self._digest_keys(results[s][1], self.cfg.t)
                for pos, j in enumerate(rows):
                    keys[j] = sub[pos]
        with self.obs.tracer.span("bridge.insert", n=n):
            for j in range(n):
                s = int(shards[j])
                self._home[out[j]] = s
                self.bridge.insert(out[j], keys[j], s)
        self._cache = None
        return out

    def _rollback_insert(self, results: Dict[int, Any],
                         by_shard: Dict[int, np.ndarray],
                         out: List[int], X: np.ndarray, nxt0: int) -> None:
        """Compensate a partially applied insert fan-out: the shards that
        did apply their sub-batch get a compensating delete and the
        handle counter rewinds, so bridge/router/home state is exactly
        what it was before the call (the bridge and home map are only
        written after a fully successful fan-out, so they need no
        undo)."""
        for s, rows in by_shard.items():
            if isinstance(results.get(s), BaseException):
                continue
            try:
                self.clients[s].delete_batch([out[j] for j in rows])
            except ShardUnavailableError:  # analysis: allow[FT001]
                # double failure: this shard died between applying its
                # sub-batch and the compensation.  Its lane already ran
                # the failover path inside delete_batch; all that is left
                # is to record that the rollback could not complete.
                self.obs.counter("failover.rollback_failures").inc()
        self._next_idx = nxt0

    def delete(self, idx: int) -> None:
        with self.obs.tracer.span("coord.delete"), \
                self._h_delete_us.timer():
            if idx not in self._home:
                raise KeyError(idx)
            s = self._home.pop(idx)
            self.clients[s].delete_batch([idx])
            self.bridge.delete(idx, s)
            self._cache = None

    def delete_batch(self, ids: Sequence[int]) -> None:
        with self.obs.tracer.span("coord.delete_batch", n=len(ids)), \
                self._h_delete_us.timer():
            self._delete_batch_impl(ids)

    def _delete_batch_impl(self, ids: Sequence[int]) -> None:
        check_unique_ids(ids)
        for i in ids:
            if i not in self._home:
                raise KeyError(i)
        by_shard: Dict[int, List[int]] = {}
        for i in ids:
            by_shard.setdefault(self._home[i], []).append(i)
        results = self._fanout({s: (lambda s=s, group=group:
                                    self.clients[s].delete_batch(group))
                                for s, group in by_shard.items()},
                               return_exceptions=True)
        failed = sorted(s for s, r in results.items()
                        if isinstance(r, BaseException))
        # reconcile what actually happened: a shard that applied its
        # sub-batch gets its bridge/home updates even when a sibling
        # failed, so coordinator state tracks shard state exactly; the
        # failed shard's points stay (its deletes never applied)
        for s, group in by_shard.items():
            if s in failed:
                continue
            for i in group:
                self.bridge.delete(i, s)
                del self._home[i]
        self._cache = None
        if failed:
            raise results[failed[0]]

    # ------------------------------------------------------------------ #
    # queries (global partition = inner partitions + bridge structure)
    # ------------------------------------------------------------------ #
    def _anchor_of(self, idx: int) -> Optional[int]:
        """Home shard's native core-anchor (inner half of the find)."""
        return self.clients[self._home[idx]].core_anchor_of(idx)

    def _comp_of(self, idx: int) -> int:  # hot-path
        """Home shard's native component handle (Euler-tour ROOT)."""
        fns = self._comp_fns
        if fns is None:  # bind once; the quotient build is call-heavy
            # (LocalTransport binds these straight to the engine)
            fns = self._comp_fns = [client.component_of
                                    for client in self.clients]
        return fns[self._home[idx]](idx)

    def _comp_of_batch(self, ids: Sequence[int]) -> List[Any]:
        """Bulk native find, fanned out per home shard — the quotient
        rebuild resolves all its representatives in one round trip per
        shard (order-preserving; same values as per-point ``_comp_of``)."""
        by_shard: Dict[int, List[int]] = {}
        pos_of: Dict[int, List[int]] = {}
        for pos, i in enumerate(ids):
            s = self._home[i]
            by_shard.setdefault(s, []).append(i)
            pos_of.setdefault(s, []).append(pos)
        res = self._fanout(
            {s: (lambda s=s, grp=grp: self.clients[s].component_of_batch(grp))
             for s, grp in by_shard.items()})
        out: List[Any] = [None] * len(ids)
        for s, positions in pos_of.items():
            for pos, v in zip(positions, res[s]):
                out[pos] = v
        return out

    @property
    def _batch_resolver(self):
        # per-point resolution is already zero-copy on the local
        # transport; only remote shards benefit from batching
        return self._comp_of_batch if self._remote else None

    def _all_labels(self) -> Dict[int, int]:
        if self._cache is None:
            labs = self._fanout(
                {s: (lambda s=s: self.clients[s].labels())
                 for s in range(self.cfg.shards)})
            self._cache = self.bridge.merge(
                (labs[s] for s in sorted(labs)),
                boundary_only=self._incremental)
        return self._cache

    def label(self, idx: int) -> int:  # hot-path
        """Point query.  On the incremental path this is the hot-path
        resolution — inner-find (Euler-tour ROOT on the home shard) ->
        bridge-find (quotient over the maintained boundary-bucket set) —
        and returns an *opaque* component handle (the protocol's
        contract); ``labels()`` stays canonical."""
        if not self.obs.enabled:  # un-instrumented: zero added work
            return self._label_impl(idx)
        with self._h_label_us.timer():
            return self._label_impl(idx)

    def _label_impl(self, idx: int) -> int:  # hot-path
        if idx not in self._home:
            raise KeyError(idx)
        if self._cache is not None:
            return self._cache[idx]
        if self._incremental:
            r = self.bridge.resolve(idx, self._comp_of,
                                    self._anchor_of(idx) is not None,
                                    comp_of_batch=self._batch_resolver)
            return NOISE if r is None else r
        return self._all_labels()[idx]

    def labels(self, ids: Optional[Iterable[int]] = None) -> Dict[int, int]:
        with self.obs.tracer.span("coord.labels"), \
                self._h_labels_us.timer():
            all_lab = self._all_labels()
            if ids is None:
                return dict(all_lab)
            return {i: all_lab[i] for i in ids}

    def component_of(self, idx: int) -> int:
        return self.label(idx)

    def core_anchor_of(self, idx: int) -> Optional[int]:
        if idx not in self._home:
            raise KeyError(idx)
        if not self._incremental:
            return super().core_anchor_of(idx)
        if self.bridge.support[idx] > 0:
            return idx
        return self._anchor_of(idx)

    def drain_deltas(self):
        """Union of the inner change feeds (per-shard local handles).

        Cross-shard component merges are not itemised per point — consult
        ``stats()['bridge_epoch']`` / re-query ``label`` for listed ids.
        Returns None when any inner engine does not track changes."""
        out = []
        for client in self.clients:
            d = client.drain_deltas()
            if d is None:
                return None
            out.extend(d)
        return out

    def is_core(self, idx: int) -> bool:
        return self.bridge.is_core(idx)

    def ids(self) -> List[int]:
        return sorted(self._home)

    def __contains__(self, idx: int) -> bool:
        return idx in self._home

    def __len__(self) -> int:
        return len(self._home)

    # ------------------------------------------------------------------ #
    # rebalancing: key-range live migration via snapshot replay
    # ------------------------------------------------------------------ #
    def shard_sizes(self) -> List[int]:
        """(S,) live point count per shard, from the coordinator's home
        map (no shard round trips)."""
        sizes = [0] * self.cfg.shards
        for s in self._home.values():
            sizes[s] += 1
        return sizes

    def _shard_rows(self, s: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, points) of shard ``s`` from its snapshot — every built-in
        backend's state exposes fixed-dtype ``ids``/``points`` arrays."""
        state = self.clients[s].snapshot_state()
        return (np.asarray(state["ids"], dtype=np.int64),
                np.asarray(state["points"], dtype=np.float64))

    def rebalance(self, plan: Union[PlanLike, Sequence[PlanLike]]) -> Dict[str, int]:
        """Move the key ranges in ``plan`` to their target shards,
        migrating the affected live points (snapshot out of the source,
        replay into the target, same handles).  The global partition is
        unchanged — placement never affects the bridge's directory."""
        if isinstance(plan, (RebalancePlan, tuple)):
            plan = [plan]
        plans = [p if isinstance(p, RebalancePlan) else RebalancePlan(*p)
                 for p in plan]
        moved = 0
        for p in plans:
            self.router.move_range(p)
            for s in range(self.cfg.shards):
                if s == p.target:
                    continue
                ids_s, X_s = self._shard_rows(s)
                if ids_s.size == 0:
                    continue
                slots = self.router.slots_batch(X_s)
                take = (slots >= p.start) & (slots < p.stop)
                if not take.any():
                    continue
                movers = [int(i) for i in ids_s[take]]
                self.clients[s].delete_batch(movers)
                self.clients[p.target].insert_batch(X_s[take], ids=movers)
                for i in movers:
                    self.bridge.move(i, s, p.target)
                    self._home[i] = p.target
                moved += len(movers)
        self._cache = None
        return {"moved": moved, "plans": len(plans)}

    # ------------------------------------------------------------------ #
    # persistence: nested per-shard snapshots, flat npz-safe keys
    # ------------------------------------------------------------------ #
    def _state(self) -> Dict[str, np.ndarray]:
        state: Dict[str, np.ndarray] = {
            "router": self.router.state(),
            "next_idx": np.asarray(self._next_idx, dtype=np.int64),
        }
        for s, client in enumerate(self.clients):
            for key, arr in client.snapshot_state().items():
                state[f"shard{s:03d}/{key}"] = arr
        return state

    def _load_state(self, state: Dict[str, np.ndarray]) -> None:
        self.router.load_state(state["router"])
        self._next_idx = int(state["next_idx"])
        for s, client in enumerate(self.clients):
            prefix = f"shard{s:03d}/"
            sub = {key[len(prefix):]: arr for key, arr in state.items()
                   if key.startswith(prefix)}
            client.restore(self._inner_cfg.to_dict(), sub)
            ids_s, X_s = self._shard_rows(s)
            if ids_s.size:
                keys = self._keys_batch(X_s)
                for j, i in enumerate(ids_s):
                    self._home[int(i)] = s
                    self.bridge.insert(int(i), keys[j], s)
        self._cache = None

    # ------------------------------------------------------------------ #
    # diagnostics
    # ------------------------------------------------------------------ #
    def check_health(self) -> None:
        """Probe every shard lane and run its deadline-based failover
        path (promote a dead primary, evict overdue members, kick the
        background respawn).  A serving loop calls this from its idle
        path; it is a no-op for plain single-member transports."""
        for c in self.clients:
            probe = getattr(c, "check_health", None)
            if probe is not None:
                probe()

    def check_invariants(self) -> None:
        n_live = 0
        for s, client in enumerate(self.clients):
            client.check_invariants()
            shard_ids = client.ids()
            n_live += len(shard_ids)
            for i in shard_ids:
                assert self._home.get(i) == s, (i, s, self._home.get(i))
        assert n_live == len(self._home)
        self.bridge.check(self._home)
        if self._incremental and self._home:
            # the boundary-restricted labelling and the hot-path point
            # queries agree with the full-directory merge oracle
            oracle = self.bridge.merge(c.labels() for c in self.clients)
            self.bridge.n_merge_passes -= 1  # oracle pass, not serving
            assert self.labels() == oracle
            fwd: Dict[int, int] = {}
            rev: Dict[int, int] = {}
            for i in self.ids():
                r = self.bridge.resolve(i, self._comp_of,
                                        self._anchor_of(i) is not None,
                                        comp_of_batch=self._batch_resolver)
                r = NOISE if r is None else r
                assert (r == NOISE) == (oracle[i] == NOISE), (i, r, oracle[i])
                if r != NOISE:  # handles <-> oracle labels bijectively
                    assert fwd.setdefault(r, oracle[i]) == oracle[i], i
                    assert rev.setdefault(oracle[i], r) == r, i

    # ------------------------------------------------------------------ #
    # observability (pull model: structural gauges are refreshed when a
    # snapshot is taken, so the mutation hot paths never touch them)
    # ------------------------------------------------------------------ #
    def obs_refresh(self) -> None:
        """Refresh the structural gauges from current coordinator state."""
        obs = self.obs
        if not obs.enabled:
            return
        b = self.bridge
        obs.gauge("bridge.interesting_buckets").set(len(b.interesting))
        obs.gauge("bridge.boundary_buckets").set(b.n_boundary_buckets)
        obs.gauge("bridge.directory_buckets").set(len(b.members))
        obs.gauge("bridge.epoch").set(b.epoch)
        sizes = self.shard_sizes()
        obs.gauge("router.load_skew").set(self.router.load_skew(sizes))
        for s, sz in enumerate(sizes):
            obs.gauge(f"shard{s}.points").set(sz)

    def obs_snapshot(self, drain: bool = False) -> List[Dict[str, Any]]:
        """Per-process observability snapshots: the coordinator's followed
        by each shard's (pulled through the protocol — one StatsReq round
        trip per shard, which drains the shard's span buffer, so a shard
        span appears in exactly one snapshot).  ``drain`` additionally
        clears the coordinator's own span buffer.  ``[]`` when
        un-instrumented."""
        if not self.obs.enabled:
            return []
        self.obs_refresh()
        snaps = [self.obs.drain() if drain else self.obs.snapshot()]
        for c in self.clients:
            payload = c.pull_obs()
            if payload:
                snaps.append(payload)
        return snaps

    def write_trace(self, path: Union[str, Path]) -> Path:
        """Dump every span recorded so far — coordinator, wire, and shard
        side — as one Chrome/Perfetto trace-event file."""
        merged = merge_snapshots(self.obs_snapshot())
        return write_chrome(path, merged["spans"])

    def stats(self) -> Dict[str, int]:
        sizes = self.shard_sizes()
        out: Dict[str, int] = {
            "shards": self.cfg.shards,
            "workers": self.cfg.workers,
            "replicas": self.cfg.replicas,
            "process_transport": int(self.cfg.transport == "process"),
            "tcp_transport": int(self.cfg.transport == "tcp"),
            "incremental_merge": int(self._incremental),
            "n_boundary_buckets": self.bridge.n_boundary_buckets,
            "n_interesting_buckets": len(self.bridge.interesting),
            "n_merge_passes": self.bridge.n_merge_passes,
            "n_boundary_merges": self.bridge.n_boundary_merges,
            "n_bridge_unions": self.bridge.n_bridge_unions,
            "n_quotient_builds": self.bridge.n_quotient_builds,
            "bridge_epoch": self.bridge.epoch,
            "max_shard_points": max(sizes) if sizes else 0,
            "min_shard_points": min(sizes) if sizes else 0,
            # wire counters: what the protocol cost, summed over shards
            # (zero bytes on the local transport — nothing is encoded)
            "transport_round_trips": sum(c.round_trips
                                         for c in self.clients),
            "transport_bytes_sent": sum(c.bytes_sent for c in self.clients),
            "transport_bytes_received": sum(c.bytes_received
                                            for c in self.clients),
        }
        for client in self.clients:
            for key, v in client.stats()[0].items():
                out[key] = out.get(key, 0) + v
        return out
