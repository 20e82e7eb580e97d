"""``ClusterService`` — any registered ClusterIndex behind the protocol.

``handle(req) -> resp`` is the whole server: a typed dispatch from the
message classes in :mod:`repro_torch.service.messages` onto the wrapped index's
:class:`~repro_torch.api.index.ClusterIndex` methods.  It raises on error — the
*connection* loop (:func:`serve_connection`) is what converts exceptions
to :class:`~repro_torch.service.messages.ErrorResp` frames, so the in-process
transport sees native exceptions with zero translation.

The service also owns the shard-side half of the insert digest: when an
``InsertBatchReq`` asks for one, it runs the same seeded GridLSH pass the
inner engine keys its buckets with (exact int64 codes, or the float32
mixed keys for the device-hash engines) and piggybacks the result on the
response, so the coordinator can feed its boundary-bucket directory
without hashing the batch itself.
"""

from __future__ import annotations

import socket
from typing import Callable, Dict, Optional, Type

import numpy as np

from ..api.backends import MIXED_KEY_BACKENDS
from ..api.index import ClusterIndex
from ..core.hashing import GridLSH
from . import messages as m
from .codec import decode, encode, read_frame, write_frame

#: exception names the protocol maps back to native types client-side
WIRE_ERRORS: Dict[str, Type[BaseException]] = {
    "KeyError": KeyError,
    "ValueError": ValueError,
    "TypeError": TypeError,
    "NotImplementedError": NotImplementedError,
    "AssertionError": AssertionError,
    "PermissionError": PermissionError,
}


class ClusterService:
    """One index, served request by request (single-threaded: a shard's
    engine is only ever touched by its one connection, mirroring the
    one-worker-per-shard rule of the thread-pool fan-out)."""

    def __init__(self, index: ClusterIndex):
        self.index = index
        self.obs = index.obs  # server-side handle; NULL_OBS when cfg.obs off
        cfg = index.cfg
        self._mixed = cfg.backend in MIXED_KEY_BACKENDS
        self._lsh = GridLSH(cfg.d, cfg.eps, cfg.t, seed=cfg.seed)
        self._dispatch: Dict[type, Callable] = {
            m.HelloReq: self._hello,
            m.InsertBatchReq: self._insert_batch,
            m.DeleteBatchReq: self._delete_batch,
            m.LabelsReq: self._labels,
            m.ComponentOfReq: self._component_of,
            m.ComponentOfBatchReq: self._component_of_batch,
            m.CoreAnchorOfReq: self._core_anchor_of,
            m.DrainDeltasReq: self._drain_deltas,
            m.IdsReq: self._ids,
            m.StatsReq: self._stats,
            m.SnapshotReq: self._snapshot,
            m.RestoreReq: self._restore,
            m.CheckInvariantsReq: self._check_invariants,
            m.ShutdownReq: lambda req: m.OkResp(n_live=len(self.index)),
        }
        # mutation dedup: highest applied op_seq (and its response) per
        # client id.  A retrying transport redelivers a mutation with the
        # same sequence number after a reconnect; replaying the cached
        # response instead of re-dispatching makes delivery exactly-once.
        self._applied_seq: Dict[str, int] = {}
        self._applied_resp: Dict[str, m.Message] = {}

    # ------------------------------------------------------------------ #
    def handle(self, req: m.Message) -> m.Message:
        seq = req.op_seq
        if seq is not None and req.kind in m.MUTATION_KINDS:
            cid, n = str(seq[0]), int(seq[1])
            if n <= self._applied_seq.get(cid, -1):
                self.obs.counter("rpc.dedup_hits").inc()
                return self._applied_resp[cid]
            resp = self._handle(req)
            self._applied_seq[cid] = n
            self._applied_resp[cid] = resp
            return resp
        return self._handle(req)

    def _handle(self, req: m.Message) -> m.Message:
        try:
            fn = self._dispatch[type(req)]
        except KeyError:
            raise TypeError(
                f"unhandled request {type(req).__name__}") from None
        ctx = req.trace_ctx
        if ctx is None or not self.obs.enabled:
            return fn(req)
        # traced request: record a server-side span parented under the
        # caller's wire span, and piggyback every finished span (this one
        # plus any the engine recorded) on the response
        tracer = self.obs.tracer
        with tracer.adopt(ctx):
            with tracer.span("shard." + req.kind):
                resp = fn(req)
        resp.span_summary = tracer.drain_export()
        return resp

    def digest(self, X: np.ndarray) -> np.ndarray:
        """(n, d) -> (n, t, w) bucket-key digest in the wrapped engine's
        key family (bit-identical to the keys the engine buckets by).

        This re-runs the vectorised hash pass the engine already did
        internally; system-wide that is the same one-extra-pass the
        coordinator used to pay (now parallel across shards), and it is
        a tiny fraction of the pure-Python forest update the insert just
        performed.  Reassembling the engine's stored per-point key bytes
        back into a fixed-dtype array would cost a Python loop instead."""
        if self._mixed:
            return self._lsh.device_keys_batch(X)
        return self._lsh.codes_batch(X)

    # ------------------------------------------------------------------ #
    def _hello(self, req: m.HelloReq) -> m.HelloResp:
        last = (self._applied_seq.get(req.client_id, -1)
                if req.client_id else -1)
        return m.HelloResp(
            backend=self.index.cfg.backend,
            native_component_queries=bool(
                self.index.native_component_queries),
            n_live=len(self.index), last_seq=last)

    def _insert_batch(self, req: m.InsertBatchReq) -> m.InsertBatchResp:
        ids = self.index.insert_batch(req.X, ids=[int(i) for i in req.ids])
        digest = self.digest(req.X) if req.want_digest else None
        return m.InsertBatchResp(ids=np.asarray(ids, dtype=np.int64),
                                 digest=digest, n_live=len(self.index))

    def _delete_batch(self, req: m.DeleteBatchReq) -> m.OkResp:
        self.index.delete_batch([int(i) for i in req.ids])
        return m.OkResp(n_live=len(self.index))

    def _labels(self, req: m.LabelsReq) -> m.LabelsResp:
        lab = self.index.labels(
            None if req.ids is None else [int(i) for i in req.ids])
        ids = np.fromiter(lab.keys(), dtype=np.int64, count=len(lab))
        return m.LabelsResp(
            ids=ids,
            labels=np.fromiter(lab.values(), dtype=np.int64, count=len(lab)))

    def _component_of(self, req: m.ComponentOfReq) -> m.ValueResp:
        return m.ValueResp(
            value=m.encode_handle(self.index.component_of(req.idx)))

    # hot-path
    def _component_of_batch(self, req: m.ComponentOfBatchReq) -> m.ValuesResp:
        comp = self.index.component_of  # bound once: the hot dispatch
        return m.ValuesResp(
            values=[m.encode_handle(comp(int(i))) for i in req.ids])

    def _core_anchor_of(self, req: m.CoreAnchorOfReq) -> m.ValueResp:
        v = self.index.core_anchor_of(req.idx)
        return m.ValueResp(value=None if v is None else int(v))

    def _drain_deltas(self, req: m.DrainDeltasReq) -> m.DrainDeltasResp:
        deltas = self.index.drain_deltas()
        if deltas is None:
            return m.DrainDeltasResp(tracked=False)
        return m.DrainDeltasResp(deltas=m.encode_deltas(deltas), tracked=True)

    def _ids(self, req: m.IdsReq) -> m.IdsResp:
        return m.IdsResp(ids=np.asarray(self.index.ids(), dtype=np.int64))

    def _stats(self, req: m.StatsReq) -> m.StatsResp:
        obs = self.obs.drain() if req.want_obs else None
        return m.StatsResp(stats={k: int(v)
                                  for k, v in self.index.stats().items()},
                           n_live=len(self.index), obs=obs)

    def _snapshot(self, req: m.SnapshotReq) -> m.SnapshotResp:
        return m.SnapshotResp(state=self.index.snapshot()["state"])

    def _restore(self, req: m.RestoreReq) -> m.OkResp:
        self.index.restore({"config": dict(req.config),
                            "state": dict(req.state or {})})
        return m.OkResp(n_live=len(self.index))

    def _check_invariants(self, req: m.CheckInvariantsReq) -> m.OkResp:
        self.index.check_invariants()
        return m.OkResp(n_live=len(self.index))


def serve_connection(service: ClusterService, sock: socket.socket,
                     auth_token: Optional[str] = None) -> bool:
    """Frame loop: decode request, handle, encode response; exceptions —
    including an undecodable frame, e.g. an unknown message kind from a
    version-skewed peer — become ErrorResp frames (first arg when
    JSON-able, else ``str``), so a bad request never kills the shard.

    With ``auth_token`` set, the connection's first message must be a
    HelloReq carrying the matching token; anything else gets one
    ``PermissionError`` frame and the connection closes (a TCP listener
    keeps accepting — a failed login never kills the worker).

    Returns True when a ShutdownReq ended the loop (the server should
    exit), False on EOF (a reconnecting client may come back)."""
    authed = auth_token is None
    while True:
        payload = read_frame(sock)
        if payload is None:
            return False
        req = None
        try:
            req = decode(payload)
            if not authed:
                if (isinstance(req, m.HelloReq)
                        and req.token == auth_token):
                    authed = True
                else:
                    write_frame(sock, encode(m.ErrorResp(
                        etype="PermissionError",
                        arg="authentication required: send HelloReq with "
                            "the worker's token first")))
                    return False
            resp = service.handle(req)
        except BaseException as e:  # noqa: BLE001 — everything crosses the wire
            arg = e.args[0] if (e.args and isinstance(
                e.args[0], (str, int, float, bool))) else str(e)
            resp = m.ErrorResp(etype=type(e).__name__, arg=arg)
        write_frame(sock, encode(resp))
        if isinstance(req, m.ShutdownReq):
            return True
