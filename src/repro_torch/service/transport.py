"""Shard transports: how the coordinator reaches a shard's ClusterService.

``ShardClient`` is the one surface :class:`~repro_torch.shard.index.ShardedIndex`
talks to — typed convenience methods built over a single ``request(req) ->
resp`` primitive, plus wire counters (``bytes_sent`` / ``bytes_received``
/ ``round_trips``) so benchmarks can report protocol overhead.

Three transports ship:

  * :class:`LocalTransport` — the index lives in-process; ``request`` is
    a direct ``ClusterService.handle`` call (no codec, no copy) and the
    per-point hot queries (``component_of`` / ``core_anchor_of``) are
    bound straight to the engine, preserving the pre-protocol behavior
    and performance exactly.
  * :class:`ProcessTransport` — the index lives in a spawned worker
    process (``python -m repro_torch.service.worker``) reached over a unix
    socket pair; every request is one npz frame each way.  S shards means
    S independent interpreters, so the pure-Python forest updates run
    truly in parallel (the coordinator's fan-out threads just block on
    sockets, releasing the GIL) — the ~S× update speedup the in-process
    thread pool can never reach.
  * :class:`TcpTransport` — the same framed protocol over a stream
    socket, built for fleets where connections fail independently of
    workers: connect/request timeouts (``ClusterConfig.rpc_timeout_s``),
    bounded exponential-backoff retries with transparent reconnection,
    token auth on the hello handshake, and exactly-once mutations via the
    per-client op-sequence dedup header (see
    :data:`~repro_torch.service.messages.MUTATION_KINDS`).  By default it
    spawns a local TCP worker; pass ``addr=(host, port)`` to reach a
    worker on another host.

A worker that dies (crash, OOM, kill) surfaces as
:class:`ShardUnavailableError` on the next request — never a hang: a dead
peer closes the socket (EOF at the frame layer), a wedged one trips the
per-op deadline.  ``ShardUnavailableError`` carries the retry/timeout
detail in its message so callers and tests can assert on what the
transport actually did before giving up.

Every transport takes the ``device`` its shard's index runs on (the
``device`` of ``build_index``): the in-process one builds the index
there, the out-of-process ones pass it to the worker as ``--device``.
A worker whose index cannot be built (``--device cuda`` on a machine
without a card) exits non-zero, and the transport raises
:class:`ShardUnavailableError` with the worker's reason.
"""

from __future__ import annotations

import abc
import contextlib
import json
import os
import secrets
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.config import ClusterConfig
from ..api.registry import build_index
from ..obs import NULL_OBS, Obs
from . import messages as m
from .codec import encode, decode, read_frame, write_frame
# module (not name) import: this module is reached from repro_torch.api's
# registration of the sharded backend, which can run while .service is
# still initialising — resolve its names at call time, not import time
from . import service as _service


class ShardUnavailableError(RuntimeError):
    """A shard's server process is gone (exited, crashed, or unreachable).

    ``args[0]`` names the shard and the failure detail — including, for
    deadline failures, how long the transport waited and how many retries
    it burned — so a caller can assert "timed out, N retries" without
    string-parsing logs."""

    def __init__(self, shard: int, detail: str):
        super().__init__(f"shard {shard} unavailable: {detail}")
        self.shard = shard
        self.detail = detail


# ---------------------------------------------------------------------- #
# worker spawn/reap helpers (shared by the out-of-process transports)
# ---------------------------------------------------------------------- #
def _worker_env() -> Dict[str, str]:
    """Environment for a spawned worker: it must resolve ``repro_torch``
    exactly as this process does (__path__, not __file__, as for a
    namespace package)."""
    env = dict(os.environ)
    import repro_torch
    pkg_root = os.path.dirname(
        os.path.abspath(list(repro_torch.__path__)[0]))
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _worker_args(cfg: ClusterConfig, shard_id: int,
                 device: Optional[str]) -> List[str]:
    """The worker command line every spawn shares."""
    args = [sys.executable, "-m", "repro_torch.service.worker",
            "--config", json.dumps(cfg.to_dict()),
            "--proc", f"shard{shard_id}"]
    return args + (["--device", device] if device is not None else [])


def _start_error(line: str) -> Optional[str]:
    """The reason a worker gave on stdout for failing to start (its
    ``WORKER_ERROR=`` line), if ``line`` is that line."""
    if line.startswith("WORKER_ERROR="):
        return line.split("=", 1)[1].strip()
    return None


def _reap(proc: Optional[subprocess.Popen], grace_s: float = 5.0) -> None:
    """Wait for a worker to exit, escalating to kill() on a stuck one;
    never raises, safe to call twice."""
    if proc is None:
        return
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


class ShardClient(abc.ABC):
    """Typed client over one shard's ClusterService."""

    def __init__(self, shard_id: int = 0, obs: Obs = NULL_OBS):
        self.shard_id = shard_id
        #: the *coordinator's* Obs handle — wire spans and per-shard RPC
        #: metrics are client-side observations (the shard records its own
        #: server-side spans with its index's handle)
        self.obs = obs
        self.bytes_sent = 0
        self.bytes_received = 0
        self.round_trips = 0

    # ------------------------------------------------------------------ #
    @abc.abstractmethod
    def request(self, req: m.Message) -> m.Message:
        """One protocol round trip; raises the shard's exception natively."""

    def close(self) -> None:
        """Tear down the connection/worker; idempotent."""

    # ------------------------------------------------------------------ #
    # typed operations (the only shard surface ShardedIndex uses)
    # ------------------------------------------------------------------ #
    def hello(self) -> m.HelloResp:
        return self.request(m.HelloReq())

    def insert_batch(self, X: np.ndarray, ids: Sequence[int],
                     want_digest: bool = False
                     ) -> Tuple[List[int], Optional[np.ndarray]]:
        r = self.request(m.InsertBatchReq(X=X, ids=ids,
                                          want_digest=want_digest))
        return [int(i) for i in r.ids], r.digest

    def delete_batch(self, ids: Sequence[int]) -> None:
        self.request(m.DeleteBatchReq(ids=ids))

    def labels(self, ids=None) -> Dict[int, int]:
        r = self.request(m.LabelsReq(ids=None if ids is None else list(ids)))
        return {int(i): int(l) for i, l in zip(r.ids, r.labels)}

    def component_of(self, idx: int):
        """The shard's native component handle (opaque: an int or an
        Euler-tour node payload tuple, identical across transports)."""
        return m.decode_handle(self.request(m.ComponentOfReq(idx=int(idx))).value)

    def component_of_batch(self, ids: Sequence[int]) -> list:
        """Native component handles of ``ids``, one round trip."""
        r = self.request(m.ComponentOfBatchReq(ids=list(ids)))
        return [m.decode_handle(v) for v in r.values or []]

    def core_anchor_of(self, idx: int) -> Optional[int]:
        v = self.request(m.CoreAnchorOfReq(idx=int(idx))).value
        return None if v is None else int(v)

    def drain_deltas(self):
        r = self.request(m.DrainDeltasReq())
        if not r.tracked:
            return None
        return [] if r.deltas is None else m.decode_deltas(r.deltas)

    def ids(self) -> List[int]:
        return [int(i) for i in self.request(m.IdsReq()).ids]

    def stats(self) -> Tuple[Dict[str, int], int]:
        r = self.request(m.StatsReq())
        return dict(r.stats or {}), int(r.n_live)

    def pull_obs(self) -> Optional[dict]:
        """Drain the shard's server-side Obs payload (metrics snapshot +
        finished spans), or None when the shard is un-instrumented."""
        return self.request(m.StatsReq(want_obs=True)).obs

    def snapshot_state(self) -> Dict[str, np.ndarray]:
        return dict(self.request(m.SnapshotReq()).state or {})

    def restore(self, config: dict, state: Dict[str, np.ndarray]) -> None:
        self.request(m.RestoreReq(config=config, state=state))

    def check_invariants(self) -> None:
        self.request(m.CheckInvariantsReq())


class LocalTransport(ShardClient):
    """In-process shard: zero-copy dispatch straight into the service."""

    def __init__(self, cfg: ClusterConfig, shard_id: int = 0,
                 obs: Obs = NULL_OBS, device: Optional[str] = None):
        super().__init__(shard_id, obs=obs)
        self.index = build_index(cfg, device=device)
        # label the in-process shard's own handle so its spans/metrics
        # land in a per-shard lane, matching the process transport
        self.index.obs.set_proc(f"shard{shard_id}")
        self.service = _service.ClusterService(self.index)
        # hot-path bindings: the sharded quotient build calls these
        # thousands of times per epoch — go straight to the engine, as the
        # pre-protocol code did (message objects would be pure overhead)
        self.component_of = self.index.component_of
        self.core_anchor_of = self.index.core_anchor_of

    def component_of_batch(self, ids):  # hot-path
        comp = self.index.component_of
        return [comp(int(i)) for i in ids]

    def request(self, req: m.Message) -> m.Message:
        self.round_trips += 1
        if self.obs.enabled:
            ctx = self.obs.tracer.context()
            if ctx is not None:
                req.trace_ctx = ctx
                resp = self.service.handle(req)
                if resp.span_summary:
                    self.obs.tracer.ingest(resp.span_summary)
                    resp.span_summary = None
                return resp
        return self.service.handle(req)

    @contextlib.contextmanager
    def _traced(self, op):
        """Shard-lane span for the zero-copy bulk ops: nothing crosses a
        wire here, but a traced run still renders the same
        coordinator -> shard tree as the process transport."""
        ctx = self.obs.tracer.context() if self.obs.enabled else None
        if ctx is None:
            yield
            return
        tr = self.index.obs.tracer
        with tr.adopt(ctx):
            with tr.span("shard." + op):
                yield
        self.obs.tracer.ingest(tr.drain_export())

    # bulk ops skip the message layer too: same arrays in, same dicts out
    def insert_batch(self, X, ids, want_digest=False):
        with self._traced("insert_batch"):
            out = self.index.insert_batch(X, ids=list(ids))
            return out, (self.service.digest(np.asarray(X, dtype=np.float64))
                         if want_digest else None)

    def delete_batch(self, ids):
        with self._traced("delete_batch"):
            self.index.delete_batch(list(ids))

    def labels(self, ids=None):
        with self._traced("labels"):
            return self.index.labels(ids)

    def drain_deltas(self):
        return self.index.drain_deltas()

    def ids(self):
        return self.index.ids()

    def stats(self):
        return self.index.stats(), len(self.index)

    def snapshot_state(self):
        return self.index.snapshot()["state"]

    def restore(self, config, state):
        self.index.restore({"config": dict(config), "state": dict(state)})

    def check_invariants(self):
        self.index.check_invariants()


class ProcessTransport(ShardClient):
    """Out-of-process shard: one spawned worker, one unix socket pair."""

    EXIT_GRACE_S = 2.0  # how long a dropped peer gets to finish exiting

    def __init__(self, cfg: ClusterConfig, shard_id: int = 0,
                 timeout: Optional[float] = None, obs: Obs = NULL_OBS,
                 device: Optional[str] = None):
        super().__init__(shard_id, obs=obs)
        self._cfg = cfg
        # per-op deadline: a wedged (not just dead) worker must surface
        # as ShardUnavailableError, never a hang
        self._timeout = float(cfg.rpc_timeout_s if timeout is None
                              else timeout)
        self._closed = False
        parent, child = socket.socketpair()
        try:
            # stdout carries only a failed start's WORKER_ERROR= line
            self._proc = subprocess.Popen(
                _worker_args(cfg, shard_id, device)
                + ["--fd", str(child.fileno())],
                pass_fds=(child.fileno(),), env=_worker_env(),
                stdout=subprocess.PIPE, text=True)
        finally:
            child.close()
        parent.settimeout(self._timeout)
        self._sock: Optional[socket.socket] = parent

    # ------------------------------------------------------------------ #
    def _gone(self, detail: str,
              exit_grace_s: float = 0.0) -> ShardUnavailableError:
        """The error for a failed round trip, naming the worker's exit
        code and reason when it has exited.  A peer that dropped the
        connection is usually exiting: ``exit_grace_s`` lets it finish,
        so its reason is not lost to the race."""
        try:
            code = self._proc.wait(timeout=exit_grace_s)
        except subprocess.TimeoutExpired:
            code = None
        if code is not None:
            reason = _start_error(self._proc.stdout.readline()
                                  if self._proc.stdout else "")
            detail = (f"worker exited with code {code}"
                      + (f": {reason}" if reason else "") + f" ({detail})")
        return ShardUnavailableError(self.shard_id, detail)

    def request(self, req: m.Message) -> m.Message:  # hot-path
        if not self.obs.enabled:
            return self._roundtrip(req)
        # traced round trip: a client-side wire span whose context rides
        # the request header; the worker's spans come back piggybacked on
        # the response and fold into this process's buffer
        tracer = self.obs.tracer
        with tracer.span(f"wire.shard{self.shard_id}", op=req.kind) as sp:
            req.trace_ctx = sp.wire_ctx()
            resp = self._roundtrip(req)
        if resp.span_summary:
            tracer.ingest(resp.span_summary)
            resp.span_summary = None
        return resp

    def _roundtrip(self, req: m.Message) -> m.Message:  # hot-path
        if self._sock is None:
            raise ShardUnavailableError(self.shard_id, "transport closed")
        try:
            self.bytes_sent += write_frame(self._sock, encode(req))
            payload = read_frame(self._sock)
        except socket.timeout as e:
            raise self._gone(
                f"request timed out after {self._timeout}s "
                f"(rpc_timeout_s), 0 retries") from e
        except (OSError, EOFError) as e:
            raise self._gone(str(e) or type(e).__name__,
                             self.EXIT_GRACE_S) from e
        if payload is None:
            raise self._gone("connection closed by peer", self.EXIT_GRACE_S)
        self.bytes_received += len(payload) + 8
        self.round_trips += 1
        resp = decode(payload)
        if isinstance(resp, m.ErrorResp):
            raise _service.WIRE_ERRORS.get(resp.etype, RuntimeError)(resp.arg)
        return resp

    def close(self) -> None:
        """Shut the worker down; never raises, never hangs, and a second
        invocation is a no-op.  A worker that ignores the shutdown frame
        (or outlives the 5s grace period) is killed and reaped."""
        if self._closed:
            return
        self._closed = True
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.settimeout(5.0)
                write_frame(sock, encode(m.ShutdownReq()))
                read_frame(sock)
            except (OSError, EOFError):
                pass
            finally:
                sock.close()
        _reap(self._proc)
        if self._proc.stdout:
            self._proc.stdout.close()

    def __del__(self):  # backstop: never leak worker processes
        try:
            self.close()
        except Exception:
            pass


class TcpTransport(ShardClient):
    """Shard over TCP: framed protocol + timeouts, retries, auth, dedup.

    The connection is an expendable resource: any send/receive failure —
    EOF, reset, or the per-op deadline (``cfg.rpc_timeout_s``) — drops
    the socket and the transport reconnects with exponential backoff, up
    to ``retries`` times.  Each (re)connect runs the hello handshake:
    token auth plus the dedup exchange, where the server echoes the
    highest op-sequence number it has applied for this client.  Idempotent
    requests are simply re-sent; mutations are re-sent with their original
    ``op_seq`` header, so a mutation that *did* land before the connection
    died is answered from the server's dedup cache instead of applying
    twice — exactly-once, not at-least-once.

    With ``addr=None`` the transport spawns its own worker on
    ``127.0.0.1`` (ephemeral port, fresh auth token) — the local-fleet
    configuration the coordinator uses.  Pass ``addr=(host, port)`` and
    the worker's ``token`` to reach a shard served elsewhere; the
    transport then owns only the connection, not the process.
    """

    RETRIES = 3           # reconnect attempts after the first failure
    BACKOFF_S = 0.05      # first backoff; doubles per retry
    BACKOFF_MAX_S = 1.0
    CONNECT_TIMEOUT_S = 5.0

    def __init__(self, cfg: ClusterConfig, shard_id: int = 0,
                 obs: Obs = NULL_OBS,
                 addr: Optional[Tuple[str, int]] = None,
                 token: Optional[str] = None,
                 retries: Optional[int] = None,
                 die_after: int = 0, device: Optional[str] = None):
        super().__init__(shard_id, obs=obs)
        self._cfg = cfg
        self._timeout = float(cfg.rpc_timeout_s)
        self._retries = self.RETRIES if retries is None else int(retries)
        # dedup identity: unique per client *instance* — a respawned
        # coordinator is a new client with a fresh sequence space
        self._client_id = f"{os.getpid():x}.{secrets.token_hex(4)}.s{shard_id}"
        self._next_seq = 0
        self._server_last_seq = -1
        self._closed = False
        self._sock: Optional[socket.socket] = None
        self._proc: Optional[subprocess.Popen] = None
        # bound once so the counter appears (at zero) in any instrumented
        # snapshot — the fleet dashboards key on it existing
        self._c_retries = obs.counter("rpc.retries")
        self._c_reconnects = obs.counter("rpc.reconnects")
        if addr is None:
            token = token or secrets.token_hex(16)
            self._proc, addr = self._spawn(cfg, shard_id, token, die_after,
                                           device)
        self._addr = addr
        self._token = token
        self._connect()

    # ------------------------------------------------------------------ #
    @staticmethod
    def _spawn(cfg: ClusterConfig, shard_id: int, token: str,
               die_after: int, device: Optional[str]
               ) -> Tuple[subprocess.Popen, Tuple[str, int]]:
        """Spawn a TCP worker on an ephemeral port and learn the port
        from its WORKER_PORT announcement."""
        args = _worker_args(cfg, shard_id, device) + [
            "--listen", "127.0.0.1:0", "--token", token]
        if die_after > 0:
            args += ["--die-after", str(die_after)]
        proc = subprocess.Popen(args, env=_worker_env(),
                                stdout=subprocess.PIPE, text=True)
        line = proc.stdout.readline() if proc.stdout else ""
        if not line.startswith("WORKER_PORT="):
            _reap(proc)
            proc.stdout.close()
            reason = _start_error(line) or "no port announcement"
            raise ShardUnavailableError(
                shard_id, f"worker failed to start ({reason}; "
                          f"exit code {proc.poll()})")
        return proc, ("127.0.0.1", int(line.split("=", 1)[1]))

    def _disconnect(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _connect(self) -> None:
        """Dial + authenticate + dedup handshake; raises OSError/EOFError
        on connection trouble (retryable) and PermissionError on an auth
        reject (not retryable — a bad token will not heal)."""
        sock = socket.create_connection(self._addr,
                                        timeout=self.CONNECT_TIMEOUT_S)
        sock.settimeout(self._timeout)
        self._sock = sock
        try:
            hello = self._exchange(m.HelloReq(token=self._token,
                                              client_id=self._client_id))
        except BaseException:
            self._disconnect()
            raise
        self._server_last_seq = int(hello.last_seq)

    def _exchange(self, req: m.Message) -> m.Message:
        """One frame each way on the live socket; no retry logic here."""
        self.bytes_sent += write_frame(self._sock, encode(req))
        payload = read_frame(self._sock)
        if payload is None:
            raise EOFError("connection closed by peer")
        self.bytes_received += len(payload) + 8
        self.round_trips += 1
        resp = decode(payload)
        if isinstance(resp, m.ErrorResp):
            raise _service.WIRE_ERRORS.get(resp.etype, RuntimeError)(resp.arg)
        return resp

    # ------------------------------------------------------------------ #
    def request(self, req: m.Message) -> m.Message:  # hot-path
        # stamp mutations once — retries re-send the identical header, so
        # the server can collapse duplicate deliveries
        if req.kind in m.MUTATION_KINDS and req.op_seq is None:
            req.op_seq = (self._client_id, self._next_seq)
            self._next_seq += 1
        if not self.obs.enabled:
            return self._request_with_retries(req)
        tracer = self.obs.tracer
        with tracer.span(f"wire.shard{self.shard_id}", op=req.kind) as sp:
            req.trace_ctx = sp.wire_ctx()
            resp = self._request_with_retries(req)
        if resp.span_summary:
            tracer.ingest(resp.span_summary)
            resp.span_summary = None
        return resp

    def _request_with_retries(self, req: m.Message) -> m.Message:
        if self._closed:
            raise ShardUnavailableError(self.shard_id, "transport closed")
        attempts = 0
        while True:
            try:
                if self._sock is None:
                    self._c_reconnects.inc()
                    self._connect()
                return self._exchange(req)
            except socket.timeout as e:
                self._disconnect()
                attempts += 1
                self._fail_or_backoff(
                    attempts, f"request timed out after {self._timeout}s",
                    e)
            except (OSError, EOFError) as e:
                self._disconnect()
                attempts += 1
                self._fail_or_backoff(attempts,
                                      str(e) or type(e).__name__, e)

    def _fail_or_backoff(self, attempts: int, what: str,
                         cause: BaseException) -> None:
        """Give up with a named, detailed ShardUnavailableError — or
        sleep the backoff and let the caller loop retry."""
        proc = self._proc
        if proc is not None and proc.poll() is not None:
            # the worker itself is gone: reconnecting cannot succeed,
            # fail fast instead of burning the retry budget
            raise ShardUnavailableError(
                self.shard_id,
                f"worker exited with code {proc.poll()} ({what}, "
                f"{attempts - 1} retries)") from cause
        if attempts > self._retries:
            raise ShardUnavailableError(
                self.shard_id,
                f"{what}; gave up after {attempts} attempts "
                f"({attempts - 1} retries, "
                f"rpc_timeout_s={self._timeout})") from cause
        self._c_retries.inc()
        time.sleep(min(self.BACKOFF_S * (2 ** (attempts - 1)),
                       self.BACKOFF_MAX_S))

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """Shut down the connection (and the worker, if this transport
        spawned it); idempotent, never raises, never hangs."""
        if self._closed:
            return
        self._closed = True
        sock, self._sock = self._sock, None
        if sock is not None:
            if self._proc is not None:  # we own the worker: ask it to exit
                try:
                    sock.settimeout(5.0)
                    write_frame(sock, encode(m.ShutdownReq()))
                    read_frame(sock)
                except (OSError, EOFError):
                    pass
            try:
                sock.close()
            except OSError:
                pass
        if self._proc is not None:
            if self._proc.stdout:
                self._proc.stdout.close()
            _reap(self._proc)

    def __del__(self):  # backstop: never leak worker processes
        try:
            self.close()
        except Exception:
            pass


TRANSPORTS = {"local": LocalTransport, "process": ProcessTransport,
              "tcp": TcpTransport}


def connect_shards(inner_cfg: ClusterConfig, n_shards: int,
                   transport: str, obs: Obs = NULL_OBS,
                   device: Optional[str] = None) -> List[ShardClient]:
    """Build/spawn one ShardClient per shard for ``transport``; ``obs``
    is the coordinator's handle (client-side wire spans/metrics),
    ``device`` where every shard's index runs."""
    try:
        factory = TRANSPORTS[transport]
    except KeyError:
        raise ValueError(
            f"unknown transport {transport!r} "
            f"(expected one of {', '.join(sorted(TRANSPORTS))})") from None
    clients: List[ShardClient] = []
    try:
        for s in range(n_shards):
            clients.append(factory(inner_cfg, shard_id=s, obs=obs,
                                   device=device))
    except Exception:
        for c in clients:
            c.close()
        raise
    return clients
