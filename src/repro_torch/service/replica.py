"""Replicated shard lanes: promote-on-failure fault tolerance.

A :class:`ReplicatedClient` is a :class:`~repro_torch.service.transport.ShardClient`
made of ``1 + R`` member clients — one primary plus ``R`` replicas
(``ClusterConfig.replicas``), each a full worker holding the same shard
state.  Replicas are fed by deterministic update replay: every mutation
the lane applies to its primary is teed, in order, to every replica (the
engines are deterministic given the op sequence, so members stay
bit-identical — :meth:`ReplicatedClient.verify_replicas` checks the
snapshots byte for byte).  Queries go to the primary only.

Failure handling is the coordinator-side half of the fleet story:

  * a member that raises
    :class:`~repro_torch.service.transport.ShardUnavailableError` (its transport
    already burned its retry budget, so this is a *dead* worker, not a
    blip) is evicted from the lane's
    :class:`~repro_torch.runtime.heartbeat.HeartbeatRegistry` slot;
  * a dead **primary** triggers promotion: the first live replica —
    in lockstep by construction — becomes primary and the in-flight
    request is re-issued against it (``failover.promotions`` counts
    these, under a ``failover.promote`` span);
  * a dead **replica** just leaves the lane (``failover.replica_drops``);
  * either way the lane heals itself in the background: a fresh worker is
    spawned, restored from a snapshot of the surviving primary, fed the
    mutations that arrived while it was rebuilding (the lane journals
    them), and atomically joined back into the lane
    (``failover.resyncs``).  The snapshot is taken synchronously in the
    *calling* thread — member transports are single-socket and not
    thread-safe, so the background thread only ever touches the one
    client it is building.

Every member occupies a fixed heartbeat slot (``0..R``); successful
requests beat the slot, :meth:`ReplicatedClient.check_health` probes idle
members and evicts/promotes anyone who missed the registry deadline —
the same deadline discipline a multi-host deployment would drive from
real heartbeat traffic.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..api.config import ClusterConfig
from ..obs import NULL_OBS, Obs
from ..runtime.heartbeat import HeartbeatRegistry
from . import messages as m
from .transport import (TRANSPORTS, ShardClient, ShardUnavailableError)


@dataclasses.dataclass
class _Member:
    client: ShardClient
    slot: int  # fixed heartbeat-registry slot, 0..R


@dataclasses.dataclass
class _Repair:
    """A respawn+resync in flight: the snapshot it restores from and the
    journal of mutations that arrived after that snapshot was taken."""

    slot: int
    snapshot: Dict[str, np.ndarray]
    journal: List[m.Message] = dataclasses.field(default_factory=list)
    cancelled: bool = False
    thread: Optional[threading.Thread] = None


class ReplicatedClient(ShardClient):
    """A lane of member ShardClients behind the plain ShardClient surface.

    ``factory()`` must return a fresh, empty member client (it is called
    ``1 + replicas`` times up front and once per background respawn).
    The lane serialises itself with one lock: the coordinator's fan-out
    touches each shard with at most one thread at a time, so the only
    contention is with the lane's own repair thread, which takes the lock
    only to drain its journal and to join.
    """

    def __init__(self, factory: Callable[[], ShardClient],
                 inner_cfg: ClusterConfig, shard_id: int = 0,
                 replicas: int = 1, obs: Obs = NULL_OBS,
                 heartbeat_timeout_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None,
                 respawn: bool = True):
        # no super().__init__: the wire counters are properties here
        # (summed over members), not instance attributes
        self.shard_id = shard_id
        self.obs = obs
        self._factory = factory
        self._inner_cfg = inner_cfg
        self._size = 1 + int(replicas)
        self._respawn = respawn
        self._lock = threading.RLock()
        self._closed = False
        self._beats = HeartbeatRegistry(self._size,
                                        timeout_s=heartbeat_timeout_s,
                                        clock=clock)
        self._repairs: List[_Repair] = []
        # bound once so the fleet counters exist (at zero) in every
        # instrumented snapshot, promoted or not
        self._c_promotions = obs.counter("failover.promotions")
        self._c_drops = obs.counter("failover.replica_drops")
        self._c_resyncs = obs.counter("failover.resyncs")
        self._c_respawn_failures = obs.counter("failover.respawn_failures")
        members: List[_Member] = []
        try:
            for slot in range(self._size):
                members.append(_Member(factory(), slot))
        except Exception:
            for mem in members:
                mem.client.close()
            raise
        self._members = members

    # ------------------------------------------------------------------ #
    # wire counters: the lane's cost is the sum of its members'
    # ------------------------------------------------------------------ #
    @property
    def bytes_sent(self) -> int:  # type: ignore[override]
        with self._lock:
            return sum(mem.client.bytes_sent for mem in self._members)

    @property
    def bytes_received(self) -> int:  # type: ignore[override]
        with self._lock:
            return sum(mem.client.bytes_received for mem in self._members)

    @property
    def round_trips(self) -> int:  # type: ignore[override]
        with self._lock:
            return sum(mem.client.round_trips for mem in self._members)

    @property
    def n_members(self) -> int:
        with self._lock:
            return len(self._members)

    @property
    def n_repairs(self) -> int:
        with self._lock:
            return len(self._repairs)

    # ------------------------------------------------------------------ #
    # failure handling (all called with the lane lock held)
    # ------------------------------------------------------------------ #
    def _fail_member(self, mem: _Member) -> None:
        """Evict a dead member; promotion happens implicitly (the lane's
        primary is always ``members[0]``).  Raises when the lane is out
        of members — the caller's op cannot complete, and the coordinator
        decides what that means."""
        promoted = mem is self._members[0]
        self._members.remove(mem)
        self._beats.evict(mem.slot)
        try:
            mem.client.close()
        except Exception:  # a dead worker's close is best-effort
            pass
        if promoted:
            self._c_promotions.inc()
        else:
            self._c_drops.inc()
        if not self._members:
            raise ShardUnavailableError(
                self.shard_id,
                f"no live members left in the lane "
                f"(size {self._size}, all evicted)")
        self._schedule_repair()

    def _schedule_repair(self) -> None:
        """Spawn+resync a replacement member in the background.  The
        snapshot comes off the surviving primary *now*, synchronously —
        the caller thread owns the primary's socket — and the journal
        collects every mutation from here to the join."""
        if not self._respawn or self._closed:
            return
        if len(self._members) + len(self._repairs) >= self._size:
            return
        taken = ({mem.slot for mem in self._members}
                 | {rep.slot for rep in self._repairs})
        slot = next(s for s in range(self._size) if s not in taken)
        snapshot = self._members[0].client.snapshot_state()
        rep = _Repair(slot=slot, snapshot=snapshot)
        self._repairs.append(rep)
        rep.thread = threading.Thread(
            target=self._repair_worker, args=(rep,),
            name=f"lane{self.shard_id}-repair", daemon=True)
        rep.thread.start()

    def _repair_worker(self, rep: _Repair) -> None:
        """Background half of the resync: build a fresh member, restore
        the snapshot, replay the journal until it runs dry, then join
        atomically.  Only this thread touches the new member's client
        until the join publishes it."""
        client: Optional[ShardClient] = None
        try:
            client = self._factory()
            client.restore(self._inner_cfg.to_dict(), rep.snapshot)
            # reset the change-feed baseline: deltas produced *before*
            # the snapshot are already baked into the restored state
            client.drain_deltas()
            while True:
                with self._lock:
                    if rep.cancelled:
                        break
                    if not rep.journal:
                        self._repairs.remove(rep)
                        self._members.append(_Member(client, rep.slot))
                        self._beats.rejoin(rep.slot)
                        self._c_resyncs.inc()
                        return
                    batch, rep.journal = rep.journal, []
                for msg in batch:  # replay outside the lock
                    client.request(msg)
        except Exception:
            self._c_respawn_failures.inc()
            with self._lock:
                if rep in self._repairs:
                    self._repairs.remove(rep)
        if client is not None:
            client.close()

    @staticmethod
    def _tee_copy(req: m.Message) -> m.Message:
        """Fresh message for a tee/journal delivery: each member's
        transport stamps its *own* op-sequence header, and replicas never
        recompute the insert digest the primary already returned."""
        if isinstance(req, m.InsertBatchReq):
            return dataclasses.replace(req, want_digest=False)
        return dataclasses.replace(req)

    # ------------------------------------------------------------------ #
    # the ShardClient surface
    # ------------------------------------------------------------------ #
    def request(self, req: m.Message) -> m.Message:
        with self._lock:
            if self._closed:
                raise ShardUnavailableError(self.shard_id, "lane closed")
            if req.kind in m.MUTATION_KINDS:
                return self._mutate(req)
            return self._apply_primary(req)

    def _apply_primary(self, req: m.Message) -> m.Message:
        """Primary request with promote-on-failure: a dead primary is
        evicted and the op re-issued against the promoted replica."""
        while True:
            mem = self._members[0]
            try:
                resp = mem.client.request(req)
            except ShardUnavailableError:
                with self.obs.tracer.span("failover.promote",
                                          shard=self.shard_id,
                                          slot=mem.slot):
                    self._fail_member(mem)  # raises when lane exhausted
                continue
            self._beats.beat(mem.slot)
            return resp

    def _mutate(self, req: m.Message) -> m.Message:
        resp = self._apply_primary(req)
        # journal to exactly the repairs whose snapshot predates this
        # mutation: everything in flight now — pre-existing repairs and
        # ones scheduled by a promotion *during* the primary apply (their
        # snapshot was taken before the re-issue landed).  A repair
        # scheduled by a tee failure below snapshots a primary that
        # already holds this mutation, so journaling it there would
        # double-apply.
        journal_to = list(self._repairs)
        for mem in list(self._members[1:]):
            try:
                mem.client.request(self._tee_copy(req))
            except ShardUnavailableError:
                self._fail_member(mem)
            else:
                self._beats.beat(mem.slot)
        for rep in journal_to:
            if rep in self._repairs:
                rep.journal.append(self._tee_copy(req))
        return resp

    def check_invariants(self) -> None:
        """Primary invariants + the replication oracle: every replica's
        snapshot must be byte-identical to the primary's."""
        self.request(m.CheckInvariantsReq())
        self.verify_replicas()

    def verify_replicas(self) -> None:
        """Assert primary ≡ replicas, array by array (the transport
        oracle of the replication scheme: replay is deterministic, so
        anything short of bit-identical is a divergence bug)."""
        with self._lock:
            if len(self._members) <= 1:
                return
            ref = self._members[0].client.snapshot_state()
            for mem in self._members[1:]:
                got = mem.client.snapshot_state()
                assert set(got) == set(ref), (
                    f"lane {self.shard_id}: replica slot {mem.slot} state "
                    f"keys {sorted(set(got) ^ set(ref))} differ")
                for key, arr in ref.items():
                    assert np.array_equal(got[key], arr), (
                        f"lane {self.shard_id}: replica slot {mem.slot} "
                        f"diverges from primary at state[{key!r}]")

    def check_health(self, probe: bool = True) -> None:
        """Deadline-based failure detection, callable from a serving
        loop's idle path: probe members (a HelloReq beats the slot), then
        evict anyone whose heartbeat slot missed the registry deadline.
        A dead primary is promoted exactly as on a failed request."""
        with self._lock:
            if self._closed:
                return
            if probe:
                for mem in list(self._members):
                    try:
                        mem.client.request(m.HelloReq())
                    except ShardUnavailableError:
                        with self.obs.tracer.span("failover.promote",
                                                  shard=self.shard_id,
                                                  slot=mem.slot):
                            self._fail_member(mem)
                    else:
                        self._beats.beat(mem.slot)
            overdue = set(self._beats.failed())
            for mem in list(self._members):
                if mem.slot in overdue:
                    with self.obs.tracer.span("failover.promote",
                                              shard=self.shard_id,
                                              slot=mem.slot):
                        self._fail_member(mem)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for rep in self._repairs:
                rep.cancelled = True
            threads = [rep.thread for rep in self._repairs if rep.thread]
            members, self._members = self._members, []
        for t in threads:
            t.join(timeout=10.0)
        for mem in members:
            mem.client.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def connect_lanes(inner_cfg: ClusterConfig, n_shards: int, transport: str,
                  replicas: int, obs: Obs = NULL_OBS,
                  heartbeat_timeout_s: float = 60.0,
                  respawn: bool = True,
                  device: Optional[str] = None) -> List[ShardClient]:
    """One replicated lane per shard — the ``cfg.replicas > 0`` analogue
    of :func:`~repro_torch.service.transport.connect_shards`.  Every
    member, a respawned one too, runs its index on ``device``."""
    try:
        member_cls = TRANSPORTS[transport]
    except KeyError:
        raise ValueError(
            f"unknown transport {transport!r} "
            f"(expected one of {', '.join(sorted(TRANSPORTS))})") from None
    lanes: List[ShardClient] = []
    try:
        for s in range(n_shards):
            factory = (lambda s=s: member_cls(inner_cfg, shard_id=s,
                                              obs=obs, device=device))
            lanes.append(ReplicatedClient(
                factory, inner_cfg, shard_id=s, replicas=replicas, obs=obs,
                heartbeat_timeout_s=heartbeat_timeout_s, respawn=respawn))
    except Exception:
        for lane in lanes:
            lane.close()
        raise
    return lanes
