"""The port's shard wire protocol (``repro_torch.service``) against
``repro.service``.

* Every message kind, encoded by one package's codec, decodes in the
  other's to equal fields, and the frames are the same bytes.
* The port's process and TCP transports give the local transport's
  results bit for bit over ``soa-device`` shards on ``device="cpu"``
  (the workers get ``--device cpu``), snapshots and rebalance included.
* Frames interchange between the packages over a socket: a port
  ``TcpTransport(addr=, token=)`` drives a reference worker, and a
  reference client drives a port worker.
* TCP dedup, retries through a dropped connection, timeouts, the
  ``--die-after`` crash knob, replica failover with a respawned member,
  rollback of a partly failed fan-out and the chaos knobs behave as in
  the reference.
* ``device="cuda"`` without a card is refused on every transport: in
  process by the index, out of process by a worker that exits non-zero
  and names the cause.

Every test that spawns workers uses at most four, with ``rpc_timeout_s``
at most 30 s, and closes them through the ``closing`` fixture.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.service as jax_service  # noqa: E402
import repro.service.codec as jax_codec  # noqa: E402
import repro.service.messages as jax_m  # noqa: E402
from repro.data import blobs  # noqa: E402

import repro_torch.api as api  # noqa: E402
import repro_torch.service as service  # noqa: E402
import repro_torch.service.messages as m  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.service import codec  # noqa: E402
from repro_torch.shard import SLOTS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cfg(shards, transport="local", inner="soa-device", **kw):
    base = dict(d=4, k=6, t=6, eps=0.45, seed=0, backend="sharded",
                shards=shards, inner_backend=inner, transport=transport,
                rpc_timeout_s=30.0)
    base.update(kw)
    return api.ClusterConfig(**base)


def _inner(backend="soa-device", **kw):
    base = dict(d=4, k=6, t=6, eps=0.45, seed=0, backend=backend,
                rpc_timeout_s=30.0)
    base.update(kw)
    return api.ClusterConfig(**base)


def _stream(n, seed):
    """Seeded chunks of (inserts [(x, id)], deletes [id])."""
    X, _ = blobs(n=n, d=4, n_clusters=4, cluster_std=0.2, seed=seed)
    rng = np.random.default_rng(seed)
    chunks, alive, row = [], [], 0
    while row < n:
        ins, dels = [], []
        for _ in range(int(rng.integers(1, 12))):
            if row >= n:
                break
            ins.append((X[row], row))
            alive.append(row)
            row += 1
        if alive and rng.random() < 0.5:
            for _ in range(int(rng.integers(1, min(6, len(alive)) + 1))):
                dels.append(alive.pop(int(rng.integers(len(alive)))))
        chunks.append((ins, dels))
    return chunks


def _apply(index, chunk):
    ins, dels = chunk
    if ins:
        index.insert_batch(np.stack([x for x, _ in ins]),
                           ids=[i for _, i in ins])
    if dels:
        index.delete_batch(dels)


def _deltas(index):
    d = index.drain_deltas()
    return None if d is None else sorted(d, key=repr)


@pytest.fixture
def closing():
    """``closing(obj)`` returns ``obj`` and closes it when the test ends,
    passed or failed (last registered, first closed)."""
    held = []

    def hold(obj):
        held.append(obj)
        return obj

    yield hold
    for obj in reversed(held):
        obj.close()


# ---------------------------------------------------------------------- #
# messages and codec, both ways
# ---------------------------------------------------------------------- #
SAMPLES = {
    "insert_batch": dict(X=np.arange(8.0).reshape(4, 2), ids=[3, 1, 4, 5],
                         want_digest=True),
    "insert_batch_resp": dict(
        ids=np.arange(4), digest=np.arange(24, dtype=np.int32).reshape(
            4, 3, 2), n_live=7),
    "delete_batch": dict(ids=[5, 9]),
    "ok": dict(n_live=3),
    "labels": dict(ids=[2, 7]),
    "labels_resp": dict(ids=[2, 7], labels=[-1, 0]),
    "component_of": dict(idx=11),
    "component_of_batch": dict(ids=[1, 2]),
    "values": dict(values=[["edge", 3, 0], 5, None]),
    "core_anchor_of": dict(idx=4),
    "value": dict(value=["loop", 5]),
    "drain_deltas": dict(),
    "drain_deltas_resp": dict(
        deltas=m.encode_deltas([(3, None, 5), (4, 2, None)]), tracked=True),
    "ids": dict(),
    "ids_resp": dict(ids=[0, 4]),
    "stats": dict(want_obs=True),
    "stats_resp": dict(stats={"n_links": 3}, n_live=2,
                       obs={"metrics": {}, "spans": []}),
    "hello": dict(token="t0k", client_id="c.1"),
    "hello_resp": dict(backend="soa-device", native_component_queries=True,
                       n_live=9, last_seq=4),
    "snapshot": dict(),
    "snapshot_resp": dict(state={"ids": np.arange(3),
                                 "shard000/points": np.ones((3, 2))}),
    "restore": dict(config={"d": 4, "eps": 0.5},
                    state={"ids": np.asarray([1])}),
    "check_invariants": dict(),
    "shutdown": dict(),
    "error": dict(etype="KeyError", arg=7),
}


def test_message_types_match_reference():
    assert set(m.MESSAGE_TYPES) == set(jax_m.MESSAGE_TYPES) == set(SAMPLES)
    assert m.MUTATION_KINDS == jax_m.MUTATION_KINDS
    for kind, cls in m.MESSAGE_TYPES.items():
        theirs = jax_m.MESSAGE_TYPES[kind]
        assert cls.__name__ == theirs.__name__
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(theirs)]
        assert cls._dtypes == theirs._dtypes
        assert cls._poly_dtypes == theirs._poly_dtypes
        assert cls._array_dicts == theirs._array_dicts


def _assert_same_fields(a, b):
    assert a.kind == b.kind
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif isinstance(x, dict) and f.name in a._array_dicts:
            assert set(x) == set(y), f.name
            for key in x:
                assert np.asarray(x[key]).dtype == y[key].dtype, key
                assert np.array_equal(np.asarray(x[key]), y[key]), key
        else:
            assert x == y, f.name
    assert a.op_seq == b.op_seq and a.trace_ctx == b.trace_ctx


@pytest.mark.parametrize("kind", sorted(SAMPLES))
def test_frames_interchange_both_ways(kind):
    ours = m.MESSAGE_TYPES[kind](**SAMPLES[kind])
    theirs = jax_m.MESSAGE_TYPES[kind](**SAMPLES[kind])
    for msg in (ours, theirs):  # the header sidecars travel too
        if kind in m.MUTATION_KINDS:
            msg.op_seq = ("c.1", 3)
        msg.trace_ctx = {"t": 1, "s": 2}
    frame = codec.encode(ours)
    assert frame == jax_codec.encode(theirs)
    back = jax_codec.decode(frame)
    assert type(back) is jax_m.MESSAGE_TYPES[kind]
    _assert_same_fields(back, theirs)
    mine = codec.decode(jax_codec.encode(theirs))
    assert type(mine) is m.MESSAGE_TYPES[kind]
    _assert_same_fields(mine, ours)


def test_framing_and_error_frames_over_a_socketpair():
    a, b = socket.socketpair()
    for p in (b"", b"x", b"y" * (1 << 17)):
        codec.write_frame(a, p)
        assert jax_codec.read_frame(b) == p
    index = api.build_index(_inner(), device="cpu")
    t = threading.Thread(target=service.serve_connection,
                         args=(service.ClusterService(index), b),
                         daemon=True)
    t.start()
    try:
        codec.write_frame(a, codec.encode(m.DeleteBatchReq(ids=[42])))
        resp = codec.decode(codec.read_frame(a))
        assert isinstance(resp, m.ErrorResp)
        assert (resp.etype, resp.arg) == ("KeyError", 42)
        codec.write_frame(a, b"not an npz archive")
        assert isinstance(codec.decode(codec.read_frame(a)), m.ErrorResp)
        codec.write_frame(a, codec.encode(m.InsertBatchReq(
            X=np.zeros((2, 4)), ids=[0, 1], want_digest=True)))
        resp = codec.decode(codec.read_frame(a))
        assert resp.digest.shape == (2, 6, 2) and resp.digest.dtype == \
            np.int32
    finally:
        a.close()
        t.join(timeout=10)
        b.close()
    assert not t.is_alive()


# ---------------------------------------------------------------------- #
# out-of-process transports against the local one
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("transport", ["process", "tcp"])
def test_out_of_process_transport_equals_local(transport, closing):
    loc = closing(api.build_index(_cfg(2), device="cpu"))
    far = closing(api.build_index(_cfg(2, transport), device="cpu"))
    rng = np.random.default_rng(1)
    for chunk in _stream(120, seed=1):
        _apply(loc, chunk)
        _apply(far, chunk)
        assert _deltas(far) == _deltas(loc)
        lab = loc.labels()
        assert far.labels() == lab
        probe = [int(i) for i in rng.choice(sorted(lab), size=4)]
        assert [far.label(i) for i in probe] == [loc.label(i) for i in probe]
    plan = (0, SLOTS // 3, 1)
    assert far.rebalance(plan) == loc.rebalance(plan)
    assert far.labels() == loc.labels()
    far.check_invariants()
    st = far.stats()
    assert st["transport_bytes_sent"] > 0
    assert st[f"{transport}_transport"] == 1
    # a snapshot of the remote shards restores with the same transport
    back = closing(api.restore_index(far.snapshot(), device="cpu"))
    assert back.cfg.transport == transport
    assert back.labels() == loc.labels()
    back.check_invariants()


# ---------------------------------------------------------------------- #
# frames between the packages, over TCP
# ---------------------------------------------------------------------- #
class _Worker:
    """A TCP worker of either package, spawned by hand; ``close`` waits
    for it to exit after a client's ShutdownReq, else kills it."""

    def __init__(self, module, cfg_dict, token, extra=()):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, "--listen", "127.0.0.1:0",
             "--config", json.dumps(cfg_dict), "--token", token, *extra],
            stdout=subprocess.PIPE, text=True, env=env)
        line = self.proc.stdout.readline()
        assert line.startswith("WORKER_PORT="), line
        self.addr = ("127.0.0.1", int(line.split("=", 1)[1]))

    def close(self):
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()


def _drive_shard(client, index, X):
    """The same inserts and deletes on one shard client and one index."""
    for lo in range(0, len(X), 40):
        ids = list(range(lo, min(lo + 40, len(X))))
        got, digest = client.insert_batch(X[ids], ids=ids, want_digest=True)
        assert list(got) == index.insert_batch(X[ids], ids=ids)
        assert digest.shape == (len(ids), 6, 2)
    client.delete_batch(list(range(0, len(X), 3)))
    index.delete_batch(list(range(0, len(X), 3)))
    assert client.labels() == index.labels()
    ids = index.ids()
    assert sorted(client.ids()) == ids
    assert [client.core_anchor_of(i) for i in ids] == \
        [index.core_anchor_of(i) for i in ids]
    client.check_invariants()


def test_port_client_drives_a_reference_worker(closing):
    import repro.api as jax_api

    X, _ = blobs(n=160, d=4, n_clusters=3, cluster_std=0.2, seed=2)
    worker = closing(_Worker("repro.service.worker",
                             _inner("soa").to_dict(), "tok-r"))
    client = closing(service.TcpTransport(_inner("soa"), addr=worker.addr,
                                          token="tok-r"))
    assert client.hello().backend == "soa"
    index = api.build_index(_inner("soa"))
    _drive_shard(client, index, X)
    # the worker's snapshot restores in the port, and the reverse
    again = api.restore_index({"config": _inner("soa").to_dict(),
                               "state": client.snapshot_state()})
    assert again.labels() == index.labels()
    assert jax_api.restore_index(index.snapshot()).labels() == \
        index.labels()
    client.request(m.ShutdownReq())


def test_reference_client_drives_a_port_worker(closing):
    import repro.api as jax_api

    X, _ = blobs(n=160, d=4, n_clusters=3, cluster_std=0.2, seed=3)
    cfg = _inner("soa-device")
    worker = closing(_Worker("repro_torch.service.worker", cfg.to_dict(),
                             "tok-p", ("--device", "cpu")))
    client = closing(jax_service.TcpTransport(
        jax_api.ClusterConfig(**cfg.to_dict()), addr=worker.addr,
        token="tok-p"))
    assert client.hello().backend == "soa-device"
    _drive_shard(client, api.build_index(cfg, device="cpu"), X)
    client.request(jax_m.ShutdownReq())


# ---------------------------------------------------------------------- #
# TCP semantics, crashes, replicas, chaos
# ---------------------------------------------------------------------- #
def test_tcp_dedup_retries_and_chaos_close(closing):
    X, _ = blobs(n=80, d=4, n_clusters=2, cluster_std=0.2, seed=4)
    loc = api.build_index(_inner(), device="cpu")
    t = closing(service.TcpTransport(_inner(), obs=Obs(), device="cpu"))
    # a re-sent stamped mutation is answered from the dedup cache
    req = m.InsertBatchReq(X=X[:10], ids=list(range(10)))
    first = t.request(req)
    assert req.op_seq is not None
    again = t.request(req)
    assert list(again.ids) == list(first.ids)
    assert again.n_live == first.n_live == 10
    loc.insert_batch(X[:10], ids=list(range(10)))
    # a connection that dies between requests is re-dialled
    t._sock.close()
    t.insert_batch(X[10:20], ids=list(range(10, 20)))
    loc.insert_batch(X[10:20], ids=list(range(10, 20)))
    assert t._c_reconnects.value >= 1
    # and socket kills at every second request are absorbed
    c = service.ChaosClient(t, "close", at=2, every=2)
    for lo in range(20, 80, 10):
        ids = list(range(lo, lo + 10))
        c.insert_batch(X[ids], ids=ids)
        loc.insert_batch(X[ids], ids=ids)
    c.delete_batch(list(range(0, 30)))
    loc.delete_batch(list(range(0, 30)))
    assert c.labels() == loc.labels()
    assert c.injected >= 2
    c.check_invariants()


def test_tcp_timeout_names_the_deadline_and_retries():
    srv = socket.create_server(("127.0.0.1", 0))
    stop = threading.Event()

    def black_hole():  # authenticates, then answers nothing
        srv.settimeout(0.25)
        conns = []
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            conns.append(conn)
            codec.read_frame(conn)
            codec.write_frame(conn, codec.encode(m.HelloResp()))
        for c in conns:
            c.close()

    th = threading.Thread(target=black_hole, daemon=True)
    th.start()
    t = service.TcpTransport(_inner(rpc_timeout_s=0.2),
                             addr=srv.getsockname(), token="x", retries=1,
                             obs=Obs())
    try:
        t0 = time.perf_counter()
        with pytest.raises(service.ShardUnavailableError) as ei:
            t.labels()
        assert "timed out" in ei.value.args[0]
        assert "retries" in ei.value.args[0]
        assert time.perf_counter() - t0 < 5.0
        assert t._c_retries.value >= 1
    finally:
        stop.set()
        th.join(timeout=5)
        t.close()
        srv.close()
    assert not th.is_alive()


def test_worker_die_after_fails_fast_and_close_is_idempotent():
    t = service.TcpTransport(_inner(), die_after=3, device="cpu")
    try:
        t.ids()  # request 2 (the hello was 1)
        t0 = time.perf_counter()
        with pytest.raises(service.ShardUnavailableError, match="exited"):
            for _ in range(3):
                t.ids()
        assert time.perf_counter() - t0 < 10.0
    finally:
        t.close()
        t.close()
    assert t._proc.poll() is not None


def test_replica_lane_fails_over_and_resyncs_on_its_device(closing):
    chunks = _stream(200, seed=5)
    half = len(chunks) // 2
    loc = closing(api.build_index(_cfg(1, inner="soa")))
    rep = closing(api.build_index(_cfg(1, "tcp", replicas=1, obs=True),
                                  device="cpu"))
    for chunk in chunks[:half]:
        _apply(loc, chunk)
        _apply(rep, chunk)
    lane = rep.clients[0]
    assert lane.n_members == 2
    lane._members[0].client._proc.kill()
    for chunk in chunks[half:]:
        _apply(loc, chunk)
        _apply(rep, chunk)
        assert rep.labels() == loc.labels()
    metrics = rep.obs.snapshot()["metrics"]
    assert metrics["failover.promotions"]["value"] >= 1
    # the respawned member is rebuilt (on cpu) and rejoins the lane
    deadline = time.monotonic() + 60
    while lane.n_members < 2 and time.monotonic() < deadline:
        rep.check_health()
        time.sleep(0.2)
    assert lane.n_members == 2 and lane.n_repairs == 0
    assert rep.obs.snapshot()["metrics"]["failover.resyncs"][
        "value"] >= 1
    assert lane._members[1].client.hello().backend == "soa-device"
    rep.check_invariants()  # replicas byte-equal to the primary
    assert rep.labels() == loc.labels()


def test_partly_failed_fanout_rolls_back_device_shards(closing):
    X, _ = blobs(n=120, d=4, n_clusters=2, cluster_std=0.2, seed=7)
    oracle = closing(api.build_index(_cfg(2), device="cpu"))
    ix = closing(api.build_index(_cfg(2), device="cpu"))
    ix.insert_batch(X[:60])
    oracle.insert_batch(X[:60])
    n_before = len(ix)
    ix.clients[1] = service.ChaosClient(
        ix.clients[1], "drop", kinds=frozenset({"insert_batch"}))
    with pytest.raises(service.ShardUnavailableError, match="shard 1"):
        ix.insert_batch(X[60:])
    assert len(ix) == n_before
    ix.check_invariants()  # device mirrors equal the host tables
    assert ix.labels() == oracle.labels()
    assert ix.insert_batch(X[60:]) == oracle.insert_batch(X[60:])
    assert ix.labels() == oracle.labels()
    ix.check_invariants()


def test_heartbeat_registry_matches_reference():
    from repro.runtime.heartbeat import HeartbeatRegistry as JaxRegistry
    from repro_torch.runtime import HeartbeatRegistry

    now = [0.0]
    regs = [cls(3, timeout_s=5.0, clock=lambda: now[0])
            for cls in (HeartbeatRegistry, JaxRegistry)]
    script = [("beat", 0, 4), ("tick", 3.0), ("beat", 1, 2), ("tick", 3.0),
              ("evict", 2), ("beat", 0, 7), ("tick", 4.0), ("rejoin", 2),
              ("beat", 2, 1), ("tick", 6.0), ("beat", 1, 9)]
    for op, *args in script:
        if op == "tick":
            now[0] += args[0]
            continue
        for reg in regs:
            getattr(reg, op)(*args)
        assert [(r.failed(), r.alive(), r.quorum_step()) for r in regs][0] \
            == (regs[1].failed(), regs[1].alive(), regs[1].quorum_step())
    regs[0].evict(1)
    with pytest.raises(KeyError, match="evicted"):
        regs[0].beat(1)


def test_chaos_validates_its_knobs(closing):
    local = closing(service.LocalTransport(_inner(), device="cpu"))
    with pytest.raises(ValueError, match="unknown chaos mode"):
        service.ChaosClient(local, "explode")
    with pytest.raises(ValueError, match="at must be"):
        service.ChaosClient(local, "drop", at=0)
    with pytest.raises(ValueError, match="socket-backed"):
        service.ChaosClient(local, "close")
    assert service.CHAOS_MODES == jax_service.CHAOS_MODES


# ---------------------------------------------------------------------- #
# no card: refused on every transport
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("transport", ["local", "process", "tcp"])
def test_cuda_shards_are_refused_without_a_card(transport):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    err = (RuntimeError if transport == "local"
           else service.ShardUnavailableError)
    with pytest.raises(err, match="CUDA is not available"):
        api.build_index(_cfg(2, transport))  # device=None: "cuda"
