"""repro_torch.service — the shard wire protocol, transport-agnostic.

The shard-facing API surface of the sharded backend, reified as typed
request/response messages with fixed-dtype numpy payloads over a
length-prefixed npz framing codec:

    from repro_torch.service import (ClusterService, LocalTransport,
                               ProcessTransport, connect_shards)

  * :mod:`~repro_torch.service.messages` — ``InsertBatchReq`` /
    ``DeleteBatchReq`` / ``LabelsReq`` / ``ComponentOfReq`` /
    ``SnapshotReq`` / ``DrainDeltasReq`` / … and their responses;
  * :mod:`~repro_torch.service.codec` — message <-> npz frame;
  * :class:`~repro_torch.service.service.ClusterService` — any registered
    ClusterIndex backend served behind the protocol;
  * :class:`~repro_torch.service.transport.ShardClient` — the client ABC with
    three transports: ``LocalTransport`` (in-process, zero-copy),
    ``ProcessTransport`` (spawned per-shard server processes, GIL-free
    update fan-out) and ``TcpTransport`` (reconnectable stream socket
    with timeouts, bounded-backoff retries, token auth and exactly-once
    mutations via the op-sequence dedup header).
    ``ClusterConfig(transport="local"|"process"|"tcp")`` selects one for
    ``backend="sharded"``;
  * :class:`~repro_torch.service.replica.ReplicatedClient` — a fault-tolerant
    lane of ``1 + R`` members per shard (``ClusterConfig.replicas``):
    deterministic update replay keeps replicas bit-identical, a dead
    primary is promoted away, dead members respawn + resync in the
    background;
  * :class:`~repro_torch.service.chaos.ChaosClient` — fault injection
    (drop/delay/close/corrupt at the Nth request) around any client,
    plus the worker's ``--die-after N`` crash knob, so the recovery
    machinery is tested against real failures.
"""

from .chaos import CHAOS_MODES, ChaosClient  # noqa: F401
from .codec import decode, encode, read_frame, write_frame  # noqa: F401
from .messages import MESSAGE_TYPES, MUTATION_KINDS, Message  # noqa: F401
from .messages import (  # noqa: F401
    CheckInvariantsReq,
    ComponentOfBatchReq,
    ComponentOfReq,
    CoreAnchorOfReq,
    DeleteBatchReq,
    DrainDeltasReq,
    DrainDeltasResp,
    ErrorResp,
    HelloReq,
    HelloResp,
    IdsReq,
    IdsResp,
    InsertBatchReq,
    InsertBatchResp,
    LabelsReq,
    LabelsResp,
    OkResp,
    RestoreReq,
    ShutdownReq,
    SnapshotReq,
    SnapshotResp,
    StatsReq,
    StatsResp,
    ValueResp,
    ValuesResp,
)
from .replica import ReplicatedClient, connect_lanes  # noqa: F401
from .service import ClusterService, serve_connection  # noqa: F401
from .transport import (  # noqa: F401
    TRANSPORTS,
    LocalTransport,
    ProcessTransport,
    ShardClient,
    ShardUnavailableError,
    TcpTransport,
    connect_shards,
)
