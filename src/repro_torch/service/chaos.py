"""Fault-injection harness for the shard transports.

:class:`ChaosClient` wraps any :class:`~repro_torch.service.transport.ShardClient`
and injects a failure at the Nth request it sees (optionally repeating),
so fault-tolerance tests drive the *real* recovery machinery instead of
mocking it:

  * ``"drop"`` — the request is swallowed and
    :class:`~repro_torch.service.transport.ShardUnavailableError` raised, as if
    the transport had burned its whole retry budget.  Exercises the
    coordinator's failover/rollback paths.
  * ``"delay"`` — ``delay_s`` of added latency before the request is
    forwarded.  Exercises deadlines, stragglers detectors, and the
    heartbeat registry.
  * ``"close"`` — the wrapped transport's live socket is closed just
    before the request goes out.  A reconnecting transport (tcp) must
    retry, re-handshake, and dedup; a single-socket transport (process)
    surfaces ShardUnavailableError.  Exercises the retry + exactly-once
    machinery end to end.
  * ``"corrupt"`` — the request's encoded frame is bit-flipped before it
    is written (framing stays intact, the payload is garbage).  The
    worker must answer with an error frame and keep serving — a corrupt
    frame never kills a shard.

The server-side counterpart is the worker's ``--die-after N`` flag
(:mod:`repro_torch.service.worker`), which hard-exits the shard process upon
receiving its Nth request — a real crash, observed by the client as a
mid-request EOF.

The wrapper is transparent when idle: requests forward unchanged, wire
counters mirror the wrapped client's, and typed methods are inherited
from the ShardClient base (they all funnel through ``request``).
"""

from __future__ import annotations

import time
from typing import FrozenSet, Optional

import numpy as np

from ..obs import NULL_OBS, Obs
from . import messages as m
from .codec import decode, encode, read_frame, write_frame
from . import service as _service
from .transport import ShardClient, ShardUnavailableError

CHAOS_MODES = ("drop", "delay", "close", "corrupt")


class ChaosClient(ShardClient):
    """Inject ``mode`` at the ``at``-th request (1-based), then every
    ``every`` requests after that (0 = fire once).  ``kinds`` restricts
    both counting and injection to the given request kinds, so a test can
    target e.g. exactly the second ``insert_batch`` of a workload."""

    def __init__(self, inner: ShardClient, mode: str, at: int = 1,
                 every: int = 0, delay_s: float = 0.05,
                 kinds: Optional[FrozenSet[str]] = None, seed: int = 0,
                 obs: Obs = NULL_OBS):
        if mode not in CHAOS_MODES:
            raise ValueError(f"unknown chaos mode {mode!r} "
                             f"(expected one of {CHAOS_MODES})")
        if at < 1:
            raise ValueError(f"at must be >= 1, got {at}")
        if mode in ("close", "corrupt") and not hasattr(inner, "_sock"):
            raise ValueError(
                f"chaos mode {mode!r} needs a socket-backed client, "
                f"got {type(inner).__name__}")
        # no super().__init__: the wire counters are read-through
        # properties here, not instance attributes
        self.shard_id = inner.shard_id
        self.obs = obs
        self.inner = inner
        self.mode = mode
        self.at = int(at)
        self.every = int(every)
        self.delay_s = float(delay_s)
        self.kinds = kinds
        self.seen = 0        # matching requests observed
        self.injected = 0    # faults actually fired
        self._rng = np.random.default_rng(seed)
        self._c_injected = obs.counter("chaos.injected")

    # wire counters mirror the wrapped client (the chaos layer itself
    # moves no bytes)
    @property
    def bytes_sent(self) -> int:  # type: ignore[override]
        return self.inner.bytes_sent

    @property
    def bytes_received(self) -> int:  # type: ignore[override]
        return self.inner.bytes_received

    @property
    def round_trips(self) -> int:  # type: ignore[override]
        return self.inner.round_trips

    # ------------------------------------------------------------------ #
    def _fires(self, req: m.Message) -> bool:
        if self.kinds is not None and req.kind not in self.kinds:
            return False
        self.seen += 1
        n = self.seen
        if n < self.at:
            return False
        if n == self.at or (self.every and (n - self.at) % self.every == 0):
            self.injected += 1
            self._c_injected.inc()
            return True
        return False

    def request(self, req: m.Message) -> m.Message:
        if not self._fires(req):
            return self.inner.request(req)
        if self.mode == "drop":
            raise ShardUnavailableError(
                self.shard_id,
                f"chaos drop at request {self.seen} ({req.kind})")
        if self.mode == "delay":
            time.sleep(self.delay_s)
            return self.inner.request(req)
        if self.mode == "close":
            sock = getattr(self.inner, "_sock", None)
            if sock is not None:
                sock.close()  # the transport sees a dead connection next
            return self.inner.request(req)
        return self._corrupt(req)

    def _corrupt(self, req: m.Message) -> m.Message:
        """Send a bit-flipped (but correctly framed) copy of the request
        on the wrapped client's socket and return the server's answer —
        an error frame, raised here exactly as any wire error would be.
        One frame out, one frame in: the connection stays aligned."""
        sock = self.inner._sock  # type: ignore[attr-defined]
        if sock is None:
            raise ShardUnavailableError(self.shard_id,
                                        "chaos corrupt: transport closed")
        payload = bytearray(encode(req))
        flips = self._rng.integers(0, len(payload), size=8)
        for pos in flips:
            payload[pos] ^= 0xFF
        write_frame(sock, bytes(payload))
        frame = read_frame(sock)
        if frame is None:
            raise ShardUnavailableError(
                self.shard_id, "worker closed the connection on a "
                               "corrupt frame (it should answer and live)")
        resp = decode(frame)
        if isinstance(resp, m.ErrorResp):
            raise _service.WIRE_ERRORS.get(resp.etype, RuntimeError)(resp.arg)
        return resp

    def close(self) -> None:
        self.inner.close()
