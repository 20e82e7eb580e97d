"""Typed wire messages of the shard protocol.

One message class per operation in the paper's AddPoint / DeletePoint /
GetCluster set (plus the structural queries the sharded hot path needs:
``component_of`` / ``core_anchor_of`` / ``drain_deltas``, and the
lifecycle ops: snapshot / restore / stats / shutdown).  A message is a
plain dataclass whose fields are either

  * fixed-dtype numpy arrays (declared in ``_dtypes`` and coerced at
    construction, so both ends of the wire agree bit-for-bit),
  * string-keyed dicts of arrays (declared in ``_array_dicts`` — used for
    snapshot state payloads), or
  * JSON-able scalars/dicts (everything else).

The split is what makes the npz framing codec (:mod:`repro_torch.service.codec`)
generic: arrays travel as raw ``.npy`` members, everything else in one
JSON header.  ``None`` marks an optional field as absent.

Mutation responses piggyback two digests for the coordinator:

  * ``digest`` on :class:`InsertBatchResp` — the inserted points'
    bucket-key digest, one ``(t, w)`` row per point in request order
    (``w = d`` int64 grid codes for exact-key engines, ``w = 2`` int32
    mixed keys for the device-hash engines).  Feeding the coordinator's
    :class:`~repro_torch.shard.bridge.BoundaryBridge` directory from this
    digest moves the full t-table hash off the coordinator: it routes on
    a table-0-only pass and the shards hash in parallel.
  * ``n_live`` on every mutation response — the shard's live-point count
    (the support-side digest the coordinator's stats/rebalance planning
    read without an extra round trip).
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

import numpy as np

MESSAGE_TYPES: Dict[str, Type["Message"]] = {}

#: request kinds that change shard state.  A retrying transport must not
#: re-apply these blindly: it stamps them with a per-client monotonic
#: op-sequence number (``Message.op_seq``) and the service deduplicates —
#: a redelivered mutation returns the cached response instead of applying
#: twice.  ``drain_deltas`` is included because draining consumes the
#: change journal: a lost response must replay from the cache, not drain
#: a second (empty) time.
MUTATION_KINDS = frozenset(
    {"insert_batch", "delete_batch", "restore", "drain_deltas"})


def register_message(cls: Type["Message"]) -> Type["Message"]:
    """Class decorator: key ``cls`` by its ``kind`` for the codec."""
    if not cls.kind:
        raise ValueError(f"{cls.__name__} has no kind")
    if cls.kind in MESSAGE_TYPES:
        raise ValueError(f"duplicate message kind {cls.kind!r}")
    MESSAGE_TYPES[cls.kind] = cls
    return cls


@dataclasses.dataclass
class Message:
    kind: ClassVar[str] = ""
    #: observability sidecar, NOT dataclass fields: ``trace_ctx`` is the
    #: caller's span context (``{"t": trace_id, "s": span_id}``) and
    #: ``span_summary`` the server's finished-span exports riding back on
    #: a response.  They travel in the codec's JSON header under reserved
    #: ``__trace__``/``__spans__`` keys only when set, so an un-traced
    #: message encodes to bit-identical wire bytes.
    trace_ctx: ClassVar[Optional[Dict[str, int]]] = None
    span_summary: ClassVar[Optional[list]] = None
    #: exactly-once sidecar for retried mutations: ``(client_id, n)``
    #: where ``n`` is the sender's monotonic op-sequence number.  Rides
    #: the codec's JSON header under the reserved ``__seq__`` key only
    #: when set (same bit-identical-when-unused contract as the trace
    #: sidecar); the service's dedup table is keyed by it.
    op_seq: ClassVar[Optional[Tuple[str, int]]] = None
    #: field -> required numpy dtype (coerced in __post_init__)
    _dtypes: ClassVar[Dict[str, Any]] = {}
    #: field -> tuple of permitted fixed dtypes, for payloads whose width
    #: legitimately varies by engine family (e.g. the insert digest:
    #: int64 exact grid codes vs int32 device-hash mixed keys) — the
    #: array must already be one of them; never coerced, never object
    _poly_dtypes: ClassVar[Dict[str, Tuple[Any, ...]]] = {}
    #: fields holding {str: ndarray} payloads (snapshot state)
    _array_dicts: ClassVar[Tuple[str, ...]] = ()

    def __post_init__(self) -> None:
        for name, dtype in self._dtypes.items():
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(
                    self, name, np.ascontiguousarray(v, dtype=dtype))
        for name, allowed in self._poly_dtypes.items():
            v = getattr(self, name)
            if v is not None:
                v = np.ascontiguousarray(v)
                if v.dtype not in tuple(np.dtype(a) for a in allowed):
                    raise TypeError(
                        f"{type(self).__name__}.{name} dtype {v.dtype} not "
                        f"in {tuple(np.dtype(a).name for a in allowed)}")
                object.__setattr__(self, name, v)


# ---------------------------------------------------------------------- #
# mutations
# ---------------------------------------------------------------------- #
@register_message
@dataclasses.dataclass
class InsertBatchReq(Message):
    kind = "insert_batch"
    _dtypes = {"X": np.float64, "ids": np.int64}
    X: np.ndarray            # (n, d) points
    ids: np.ndarray          # (n,) pre-claimed handles
    want_digest: bool = False  # piggyback the bucket-key digest


@register_message
@dataclasses.dataclass
class InsertBatchResp(Message):
    kind = "insert_batch_resp"
    _dtypes = {"ids": np.int64}
    # int64 = exact grid codes, int32 = device-hash mixed keys
    _poly_dtypes = {"digest": (np.int64, np.int32)}
    ids: np.ndarray                       # (n,) assigned handles
    digest: Optional[np.ndarray] = None   # (n, t, w) bucket-key digest
    n_live: int = 0


@register_message
@dataclasses.dataclass
class DeleteBatchReq(Message):
    kind = "delete_batch"
    _dtypes = {"ids": np.int64}
    ids: np.ndarray          # (n,) handles to delete


@register_message
@dataclasses.dataclass
class OkResp(Message):
    kind = "ok"
    n_live: int = 0


# ---------------------------------------------------------------------- #
# queries
# ---------------------------------------------------------------------- #
@register_message
@dataclasses.dataclass
class LabelsReq(Message):
    kind = "labels"
    _dtypes = {"ids": np.int64}
    ids: Optional[np.ndarray] = None  # None = all live points


@register_message
@dataclasses.dataclass
class LabelsResp(Message):
    kind = "labels_resp"
    _dtypes = {"ids": np.int64, "labels": np.int64}
    ids: np.ndarray
    labels: np.ndarray


@register_message
@dataclasses.dataclass
class ComponentOfReq(Message):
    kind = "component_of"
    idx: int = 0


@register_message
@dataclasses.dataclass
class ComponentOfBatchReq(Message):
    """Batched native find — one round trip resolves a whole quotient
    build's representatives on this shard."""

    kind = "component_of_batch"
    _dtypes = {"ids": np.int64}
    ids: Optional[np.ndarray] = None


@register_message
@dataclasses.dataclass
class ValuesResp(Message):
    kind = "values"
    values: Optional[list] = None  # encoded handles, request order


@register_message
@dataclasses.dataclass
class CoreAnchorOfReq(Message):
    kind = "core_anchor_of"
    idx: int = 0


@register_message
@dataclasses.dataclass
class ValueResp(Message):
    kind = "value"
    value: Any = None  # int handle, encoded tuple handle, or None


@register_message
@dataclasses.dataclass
class DrainDeltasReq(Message):
    kind = "drain_deltas"


@register_message
@dataclasses.dataclass
class DrainDeltasResp(Message):
    kind = "drain_deltas_resp"
    _dtypes = {"deltas": np.int64}
    # (n, 3) rows of (idx, old, new); -1 encodes None (handles are >= 0)
    deltas: Optional[np.ndarray] = None
    tracked: bool = False


@register_message
@dataclasses.dataclass
class IdsReq(Message):
    kind = "ids"


@register_message
@dataclasses.dataclass
class IdsResp(Message):
    kind = "ids_resp"
    _dtypes = {"ids": np.int64}
    ids: np.ndarray


@register_message
@dataclasses.dataclass
class StatsReq(Message):
    kind = "stats"
    want_obs: bool = False  # also pull the shard's Obs.drain() payload


@register_message
@dataclasses.dataclass
class StatsResp(Message):
    kind = "stats_resp"
    stats: Optional[Dict[str, int]] = None
    n_live: int = 0
    obs: Optional[Dict[str, Any]] = None  # Obs.drain() when requested


# ---------------------------------------------------------------------- #
# lifecycle
# ---------------------------------------------------------------------- #
@register_message
@dataclasses.dataclass
class HelloReq(Message):
    """Handshake: capability discovery + liveness check in one trip.

    On an authenticated listener (worker ``--token``) the hello must be
    the connection's first message and carry the matching ``token``.
    ``client_id`` identifies the caller's mutation-dedup lane: the
    response echoes the highest op-sequence number the server has applied
    for it, so a reconnecting client knows whether an in-flight mutation
    landed before the connection died."""

    kind = "hello"
    token: Optional[str] = None
    client_id: Optional[str] = None


@register_message
@dataclasses.dataclass
class HelloResp(Message):
    kind = "hello_resp"
    backend: str = ""
    native_component_queries: bool = False
    n_live: int = 0
    last_seq: int = -1  # highest applied op_seq for req.client_id


@register_message
@dataclasses.dataclass
class SnapshotReq(Message):
    kind = "snapshot"


@register_message
@dataclasses.dataclass
class SnapshotResp(Message):
    kind = "snapshot_resp"
    _array_dicts = ("state",)
    state: Optional[Dict[str, np.ndarray]] = None


@register_message
@dataclasses.dataclass
class RestoreReq(Message):
    kind = "restore"
    _array_dicts = ("state",)
    config: Optional[Dict[str, Any]] = None
    state: Optional[Dict[str, np.ndarray]] = None


@register_message
@dataclasses.dataclass
class CheckInvariantsReq(Message):
    kind = "check_invariants"


@register_message
@dataclasses.dataclass
class ShutdownReq(Message):
    kind = "shutdown"


@register_message
@dataclasses.dataclass
class ErrorResp(Message):
    """An exception crossing the wire; the client re-raises it by name."""

    kind = "error"
    etype: str = "RuntimeError"
    arg: Any = None  # first exception arg when JSON-able, else str(exc)


# component-handle wire encoding: the engines' native find returns either
# a point handle (int) or an Euler-tour node payload (a flat tuple of
# strs/ints, e.g. ("edge", u, v)).  JSON turns tuples into lists, so the
# client re-tuples on decode — both transports then return the exact same
# handle values (the oracle-equivalence contract).
def encode_handle(v: Any) -> Any:
    if v is None or isinstance(v, (int, np.integer)):
        return None if v is None else int(v)
    if isinstance(v, (tuple, list)):
        return [e if isinstance(e, str) else int(e) for e in v]
    raise TypeError(f"component handle {v!r} is not wire-encodable")


def decode_handle(v: Any) -> Any:
    return tuple(v) if isinstance(v, list) else v


# handle-encoding helpers for DrainDeltasResp (-1 = None; handles >= 0)
def encode_deltas(deltas) -> np.ndarray:
    enc = lambda v: -1 if v is None else int(v)  # noqa: E731
    return np.asarray([(i, enc(old), enc(new)) for i, old, new in deltas],
                      dtype=np.int64).reshape(-1, 3)


def decode_deltas(arr: np.ndarray) -> list:
    dec = lambda v: None if v == -1 else int(v)  # noqa: E731
    return [(int(r[0]), dec(r[1]), dec(r[2])) for r in arr]
