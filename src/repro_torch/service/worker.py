"""Shard server process: ``python -m repro_torch.service.worker``.

Spawned by :class:`~repro_torch.service.transport.ProcessTransport` with an
inherited socket fd (``--fd``), or by
:class:`~repro_torch.service.transport.TcpTransport` as a TCP listener
(``--listen HOST:PORT``; port 0 binds an ephemeral port and the worker
prints ``WORKER_PORT=<port>`` on stdout so the spawner can connect).
Either way it builds the index from the shard's inner ClusterConfig
(JSON) and serves the frame loop until ShutdownReq; in listener mode a
client disconnect only ends that *connection* — the worker keeps
accepting, so a retrying client can reconnect after a network blip
without losing shard state.  Connections are served on threads (so a
reconnecting client is never stuck behind a half-dead predecessor in the
accept queue) but requests are serialised through one lock: the engine
itself stays single-threaded, matching the one-worker-per-shard rule.

``--device`` is where the index runs (the ``device`` of ``build_index``:
by default "cuda" for a device backend, the host for a host one).  A
worker whose index cannot be built prints ``WORKER_ERROR=<reason>`` on
stdout and exits with code 1 before it serves anything, so the spawner
can name the cause (``--device cuda`` without a card is one); after the
build the worker's stdout goes to stderr, so nothing else reaches a
spawner's pipe.

``--token`` requires every connection to authenticate with a matching
HelloReq before any other request is served.  ``--die-after N`` is the
fault-injection knob: the worker hard-exits (``os._exit(1)``) upon
receiving its Nth request, before handling it — the client observes a
mid-request EOF, exactly what a crash looks like.  Runnable by hand
against any socket fd or port for debugging.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading


class CrashAfter:
    """Fault injection: pass through ``handle`` for the first ``n - 1``
    requests, then hard-exit on the Nth *before* handling it."""

    def __init__(self, service, n: int):
        self._service = service
        self._left = int(n)

    def handle(self, req):
        self._left -= 1
        if self._left < 0:
            os._exit(1)  # simulated crash: no response, no cleanup
        return self._service.handle(req)


class Serialized:
    """One lock in front of ``handle``: listener mode accepts concurrent
    connections, but the engine only ever sees one request at a time."""

    def __init__(self, service):
        self._service = service
        self._lock = threading.Lock()

    def handle(self, req):
        with self._lock:
            return self._service.handle(req)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fd", type=int, default=None,
                    help="inherited stream-socket file descriptor")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve over TCP instead of an inherited fd; "
                         "port 0 binds an ephemeral port, printed as "
                         "WORKER_PORT=<port> on stdout")
    ap.add_argument("--config", required=True,
                    help="ClusterConfig of the served index, as JSON")
    ap.add_argument("--device", default=None,
                    help="device the index runs on (build_index's "
                         "device; default: cuda for a device backend, "
                         "the host for a host one)")
    ap.add_argument("--proc", default=None,
                    help="observability process label (e.g. 'shard3'); "
                         "names this worker's lane in trace dumps")
    ap.add_argument("--token", default=None,
                    help="require connections to authenticate with this "
                         "token on their first HelloReq")
    ap.add_argument("--die-after", type=int, default=0, dest="die_after",
                    metavar="N",
                    help="fault injection: hard-exit upon receiving the "
                         "Nth request (0 = never)")
    args = ap.parse_args(argv)
    if (args.fd is None) == (args.listen is None):
        ap.error("exactly one of --fd / --listen is required")

    # import late: argparse errors shouldn't cost a numpy import
    from ..api import ClusterConfig, build_index
    from .service import ClusterService, serve_connection

    cfg = ClusterConfig.from_dict(json.loads(args.config))
    try:
        index = build_index(cfg, device=args.device)
    except Exception as e:  # noqa: BLE001 — reported to the spawner
        reason = f"{type(e).__name__}: {e}".replace("\n", " ")
        print(f"WORKER_ERROR={reason}", flush=True)
        return 1
    if args.proc:
        index.obs.set_proc(args.proc)
    service = ClusterService(index)
    if args.die_after > 0:
        service = CrashAfter(service, args.die_after)

    if args.fd is not None:
        os.dup2(2, 1)
        sock = socket.socket(fileno=args.fd)
        try:
            serve_connection(service, sock, auth_token=args.token)
        finally:
            sock.close()
        return 0

    host, _, port = args.listen.rpartition(":")
    srv = socket.create_server((host or "127.0.0.1", int(port)))
    # announce the bound port before the first accept — the spawner
    # blocks on this line, so it must go out even under port 0
    print(f"WORKER_PORT={srv.getsockname()[1]}", flush=True)
    os.dup2(2, 1)
    service = Serialized(service)
    stop = threading.Event()

    def serve(conn: socket.socket) -> None:
        try:
            if serve_connection(service, conn, auth_token=args.token):
                stop.set()
        finally:
            conn.close()

    # timeout-polled accept: closing a listener from another thread does
    # not reliably wake a blocked accept(), so the loop re-checks the
    # stop flag a few times a second instead
    srv.settimeout(0.25)
    try:
        while not stop.is_set():
            try:
                conn, _addr = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(None)
            threading.Thread(target=serve, args=(conn,),
                             daemon=True).start()
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
