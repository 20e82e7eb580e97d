"""The port's dict engines against the JAX package's.

``repro_torch.core.dynamic_dbscan.DynamicDBSCAN`` (backend ``dynamic``)
and ``repro_torch.core.batched.BatchedDynamicDBSCAN`` (``batched``, and
``batched-device`` on ``device="cpu"``, the plain ``lsh_hash``) are driven
through the same streams as their ``repro`` counterparts — the point
streams of ``tests/test_dynamic_dbscan.py``, ``mixed_stream`` of
``tests/test_api.py`` and the batch stream with pinned ids of
``tests/test_soa.py`` — under both repair modes and with and without
orphan re-attachment.  The reference's ``batched-device`` runs its plain
kernel (the default off the TPU) or, in one small case, the Pallas kernel
in interpret mode.  At every compared step the ``labels()`` dicts, every
``label()`` (the forest root's payload), the deltas in order, every
``state_dict()`` array, ``stats()`` and the repair histogram must be
identical: tolerance zero, since all of them are integers or payload
tuples and the points are stored as given.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro.core.batched as jax_batched  # noqa: E402
import repro.core.dynamic_dbscan as jax_dd  # noqa: E402
import repro_torch.api as api  # noqa: E402
import repro_torch.core.dynamic_dbscan as dd  # noqa: E402
from repro.data import blobs  # noqa: E402
from repro.obs import make_obs as jax_make_obs  # noqa: E402
from repro_torch.core.batched import BatchedDynamicDBSCAN  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.obs import make_obs  # noqa: E402

DICT_BACKENDS = ("dynamic", "batched", "batched-device")
MODES = [(r, o) for r in ("exact", "paper") for o in (True, False)]


def mixed_stream(mod, n=400, d=4, seed=0, p_delete=0.25):
    """``tests/test_api.py``'s mixed Insert/Delete stream, as events of
    ``mod`` (``repro.api`` or ``repro_torch.api``)."""
    X, _ = blobs(n=n, d=d, n_clusters=4, cluster_std=0.15, seed=seed)
    rng = np.random.default_rng(seed)
    events, alive, nxt = [], [], 0
    for j in range(n):
        events.append(mod.Insert(X[j]))
        alive.append(nxt)
        nxt += 1
        if rng.random() < p_delete and len(alive) > 10:
            events.append(mod.Delete(alive.pop(int(rng.integers(len(alive))))))
    return events


def assert_same_engine(ours, theirs):
    """Labels, every point query, the state arrays and the counters."""
    assert ours.labels() == theirs.labels()
    live = sorted(theirs.points)
    assert sorted(ours.points) == live
    assert [ours.get_cluster(i) for i in live] == \
        [theirs.get_cluster(i) for i in live]
    assert [ours.core_anchor(i) for i in live] == \
        [theirs.core_anchor(i) for i in live]
    sa, sb = ours.state_dict(), theirs.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert sa[key].dtype == sb[key].dtype, key
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    assert (ours.n_repair_scans, ours.n_repair_links, ours.forest.n_links,
            ours.forest.n_cuts) == \
        (theirs.n_repair_scans, theirs.n_repair_links,
         theirs.forest.n_links, theirs.forest.n_cuts)
    # the invariants hold on both or fail on both: repair="paper" may
    # strand cores (Thm 2's check), identically on each side
    inv = _invariants(ours)
    assert inv == _invariants(theirs)
    assert inv is None or ours.repair == "paper"


def _invariants(engine):
    try:
        engine.check_invariants()
    except AssertionError as e:
        return e.args
    return None


def _build_pair(backend, **kw):
    base = dict(d=4, k=8, t=8, eps=0.45, seed=0, backend=backend)
    base.update(kw)
    device = "cpu" if backend == "batched-device" else None
    return (api.build_index(api.ClusterConfig(**base), device=device),
            jax_api.build_index(jax_api.ClusterConfig(**base)))


# ---------------------------------------------------------------------- #
# dynamic: the point streams of tests/test_dynamic_dbscan.py
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("repair,orphans", MODES)
def test_dynamic_point_stream_matches_reference(seed, repair, orphans):
    """``test_insert_delete_matches_static_emz``'s stream (a random
    delete after 35% of the inserts), one point at a time, with the
    deltas drained after every update and the repair histogram on."""
    rng = np.random.default_rng(seed)
    X, _ = blobs(n=260, d=3, n_clusters=4, cluster_std=0.3, seed=seed)
    kw = dict(seed=seed, repair=repair, attach_orphans=orphans)
    ours = dd.DynamicDBSCAN(3, 6, 5, 0.5, **kw)
    theirs = jax_dd.DynamicDBSCAN(3, 6, 5, 0.5, **kw)
    ours.obs, theirs.obs = make_obs(True), jax_make_obs(True)
    assert ours.drain_deltas() == theirs.drain_deltas() == []
    alive = []
    for j in range(X.shape[0]):
        idx = ours.add_point(X[j])
        assert idx == theirs.add_point(X[j])
        alive.append(idx)
        assert ours.drain_deltas() == theirs.drain_deltas()
        if rng.random() < 0.35 and len(alive) > 5:
            victim = alive.pop(int(rng.integers(len(alive))))
            ours.delete_point(victim)
            theirs.delete_point(victim)
            assert ours.drain_deltas() == theirs.drain_deltas()
        if (j + 1) % 60 == 0:
            assert_same_engine(ours, theirs)
    assert_same_engine(ours, theirs)
    h = ours.obs.snapshot()["metrics"].get("engine.repair_nodes")
    assert h == theirs.obs.snapshot()["metrics"].get("engine.repair_nodes")
    if repair == "exact":
        assert ours.n_repair_scans > 0 and h["count"] == ours.n_repair_scans
    else:
        assert ours.n_repair_scans == 0 and h is None


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_insert_then_delete_everything_matches_reference(seed):
    """``test_insert_matches_static_emz``'s stream, then every point
    deleted in insertion order (``test_delete_everything``)."""
    X, _ = blobs(n=300, d=3, n_clusters=4, cluster_std=0.3, seed=seed)
    ours = dd.DynamicDBSCAN(3, 8, 6, 0.45, seed=seed)
    theirs = jax_dd.DynamicDBSCAN(3, 8, 6, 0.45, seed=seed)
    ids = [ours.add_point(x) for x in X]
    assert ids == [theirs.add_point(x) for x in X]
    assert_same_engine(ours, theirs)
    for n, i in enumerate(ids):
        ours.delete_point(i)
        theirs.delete_point(i)
        if n % 75 == 0:
            assert_same_engine(ours, theirs)
    assert len(ours.forest) == 0 and ours.buckets.n_buckets() == 0
    assert ours.labels() == {} and ours.state_dict()["ids"].shape == (0,)
    with pytest.raises(KeyError):
        ours.delete_point(ids[0])


# ---------------------------------------------------------------------- #
# the three backends on mixed_stream, through the API
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", DICT_BACKENDS)
@pytest.mark.parametrize("repair,orphans", MODES)
def test_mixed_stream_matches_reference(backend, repair, orphans):
    """``mixed_stream`` in windows of 40 events through ``apply`` (each
    insert run one ``insert_batch``, so one hash call on the batched
    backends): handles, deltas and labels after every window; state,
    point queries and ``stats()`` every fifth and at the end."""
    ours, theirs = _build_pair(backend, repair=repair, attach_orphans=orphans)
    ev_ours = mixed_stream(api, seed=1)
    ev_theirs = mixed_stream(jax_api, seed=1)
    ours.drain_deltas()
    theirs.drain_deltas()
    for w, s in enumerate(range(0, len(ev_ours), 40)):
        assert ours.apply(ev_ours[s:s + 40]) == \
            theirs.apply(ev_theirs[s:s + 40])
        assert ours.drain_deltas() == theirs.drain_deltas()
        assert ours.labels() == theirs.labels()
        if w % 5 == 0:
            assert_same_engine(ours.engine, theirs.engine)
    assert_same_engine(ours.engine, theirs.engine)
    assert ours.stats() == theirs.stats()
    live = ours.ids()
    assert live == theirs.ids() and len(ours) == len(theirs)
    assert [ours.label(i) for i in live] == [theirs.label(i) for i in live]
    assert [ours.component_of(i) for i in live] == \
        [theirs.component_of(i) for i in live]
    assert [ours.is_core(i) for i in live] == \
        [theirs.is_core(i) for i in live]


def test_batched_device_matches_reference_pallas_interpret():
    """The reference's ``batched-device`` with the Pallas ``lsh_hash`` in
    interpret mode against the port's on the CPU (the plain version):
    batches of 20 with pinned ids, then deletes."""
    X, _ = blobs(n=100, d=4, n_clusters=3, cluster_std=0.3, seed=4)
    theirs = jax_batched.BatchedDynamicDBSCAN(4, 5, 6, 0.5, seed=4,
                                              use_device="interpret")
    ours = BatchedDynamicDBSCAN(4, 5, 6, 0.5, seed=4, use_device=True,
                                device="cpu")
    theirs.drain_deltas()
    ours.drain_deltas()
    for s in range(0, 100, 20):
        ids = [None if j % 3 else 500 + s + j for j in range(20)]
        assert ours.add_batch(X[s:s + 20], ids=ids) == \
            theirs.add_batch(X[s:s + 20], ids=ids)
        assert ours.drain_deltas() == theirs.drain_deltas()
    dels = sorted(ours.points)[::4]
    ours.delete_batch(dels)
    theirs.delete_batch(dels)
    assert ours.drain_deltas() == theirs.drain_deltas()
    assert_same_engine(ours, theirs)


# ---------------------------------------------------------------------- #
# snapshots both ways
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", DICT_BACKENDS)
def test_snapshots_interchange_with_reference(backend):
    """A port snapshot restores in ``repro.api`` and a reference snapshot
    in the port, each with the exact forest; both then agree under
    further updates."""
    X, _ = blobs(n=300, d=4, n_clusters=4, cluster_std=0.3, seed=6)
    ours, theirs = _build_pair(backend, seed=6)
    ours.insert_batch(X[:180])
    theirs.insert_batch(X[:180])
    dels = ours.ids()[::5]
    ours.delete_batch(dels)
    theirs.delete_batch(dels)
    device = "cpu" if backend == "batched-device" else None
    there = jax_api.restore_index(ours.snapshot())
    here = api.restore_index(theirs.snapshot(), device=device)
    for a, b in ((there, ours), (here, theirs)):
        assert a.labels() == b.labels() and a.ids() == b.ids()
        assert sorted(a.engine.forest._edge) == sorted(b.engine.forest._edge)
        assert _invariants(a.engine) is None
    assert_same_engine(here.engine, there.engine)
    there.drain_deltas()
    here.drain_deltas()
    assert here.insert_batch(X[180:]) == there.insert_batch(X[180:])
    assert here.drain_deltas() == there.drain_deltas()
    here.delete_batch(here.ids()[1::6])
    there.delete_batch(there.ids()[1::6])
    assert here.drain_deltas() == there.drain_deltas()
    assert_same_engine(here.engine, there.engine)


# ---------------------------------------------------------------------- #
# the port against itself: soa and batched (tests/test_soa.py:83)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("orphans", [True, False])
def test_port_soa_matches_port_batched(seed, orphans):
    """Batches of 1-49 with pinned out-of-order ids and random delete
    batches: the port's ``soa`` and ``batched`` give the same handles,
    the same sorted compacted deltas and identical label dicts."""
    rng = np.random.default_rng(seed + 50)
    X, _ = blobs(n=400, d=4, n_clusters=4, cluster_std=0.3, seed=seed)
    cfg = api.ClusterConfig(d=4, k=8, t=8, eps=0.45, seed=seed,
                            attach_orphans=orphans)
    A = api.build_index(cfg.replace(backend="batched"))
    B = api.build_index(cfg.replace(backend="soa"))
    pos, alive = 0, []
    while pos < len(X):
        b = int(rng.integers(1, 50))
        chunk = X[pos:pos + b]
        pos += b
        ids = None
        if rng.random() < 0.3:
            base = 10_000 + pos * 10
            ids = [None if rng.random() < 0.5 else base + j
                   for j in range(len(chunk))]
        got = A.insert_batch(chunk, ids=ids)
        assert got == B.insert_batch(chunk, ids=ids)
        alive.extend(got)
        assert sorted(A.drain_deltas()) == sorted(B.drain_deltas())
        if rng.random() < 0.5 and len(alive) > 30:
            nd = int(rng.integers(1, min(20, len(alive) - 10)))
            dels = [alive.pop(int(rng.integers(len(alive))))
                    for _ in range(nd)]
            A.delete_batch(dels)
            B.delete_batch(dels)
            assert sorted(A.drain_deltas()) == sorted(B.drain_deltas())
        assert A.labels() == B.labels()
    A.check_invariants()
    B.check_invariants()


# ---------------------------------------------------------------------- #
# labels() without scipy
# ---------------------------------------------------------------------- #
def test_connected_components_fallback_matches_scipy(monkeypatch):
    """The pure-Python union-find numbers components as scipy does, on
    random graphs and on an engine's forest."""
    rng = np.random.default_rng(3)
    graphs = [(0, [], [])]
    for n in (1, 7, 60, 300):
        m = int(rng.integers(0, 2 * n))
        graphs.append((n, rng.integers(0, n, m).tolist(),
                       rng.integers(0, n, m).tolist()))
    with_scipy = [dd._connected_components(*g) for g in graphs]
    ix = api.build_index(api.ClusterConfig(d=3, k=6, t=6, eps=0.5, seed=9))
    ix.apply(mixed_stream(api, n=250, d=3, seed=9))
    labels = ix.labels()
    monkeypatch.setattr(dd, "_sp", None)  # as if scipy were uninstalled
    for g, want in zip(graphs, with_scipy):
        np.testing.assert_array_equal(dd._connected_components(*g), want)
    assert ix.labels() == labels


# ---------------------------------------------------------------------- #
# registry and devices
# ---------------------------------------------------------------------- #
def test_registry_lists_the_dict_backends():
    assert set(DICT_BACKENDS) <= set(api.available_backends())
    assert api.backends.MIXED_KEY_BACKENDS == \
        jax_api.backends.MIXED_KEY_BACKENDS
    assert api.DEVICE_BACKENDS == ("batched-device", "soa-device")
    for name in DICT_BACKENDS:
        ix = api.build_index(name, d=3, k=4, t=4, eps=0.5,
                             device="cpu")
        assert type(ix).__name__ == "EulerTourIndex"
        assert ix.native_component_queries


@pytest.mark.parametrize("backend", ["dynamic", "batched"])
@pytest.mark.parametrize("device", ["cuda", "cuda:0", "meta"])
def test_host_dict_backends_refuse_a_device(backend, device):
    cfg = api.ClusterConfig(d=3, k=4, t=4, eps=0.5, backend=backend)
    with pytest.raises(ValueError, match="host only"):
        api.build_index(cfg, device=device)
    snap = api.build_index(cfg).snapshot()
    with pytest.raises(ValueError, match="host only"):
        api.restore_index(snap, device=device)
    assert len(api.build_index(cfg, device="cpu")) == 0


def test_batched_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = api.ClusterConfig(d=3, k=4, t=4, eps=0.5, backend="batched-device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.build_index(cfg)
    snap = api.build_index(cfg, device="cpu").snapshot()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.restore_index(snap)
    with pytest.raises(ValueError, match="unsupported device"):
        api.build_index(cfg, device="meta")


def test_batched_device_on_cpu_runs_the_plain_kernel(monkeypatch):
    """One ``ops.lsh_hash`` call a batch, on CPU tensors (so the plain
    version: no launch counted), whose keys become the bucket keys."""
    ix = api.build_index(api.ClusterConfig(d=4, k=4, t=5, eps=0.5, seed=1,
                                           backend="batched-device"),
                         device="cpu")
    calls = []

    def spy(x, eta, mixers, *, inv_cell, impl=None):
        out = real(x, eta, mixers, inv_cell=inv_cell, impl=impl)
        calls.append((x.clone(), out))
        return out

    real = ops.lsh_hash
    monkeypatch.setattr(ops, "lsh_hash", spy)
    ops.reset_launch_counts()
    X, _ = blobs(n=90, d=4, n_clusters=3, cluster_std=0.3, seed=1)
    for s in range(0, 90, 30):
        ix.insert_batch(X[s:s + 30])
    assert len(calls) == 3
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    eng = ix.engine
    for n, (x, keys) in enumerate(calls):
        assert x.device.type == "cpu" and x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(),
                                      X[30 * n:30 * n + 30].astype(np.float32))
        want = ref.lsh_hash(x, eng._eta_dev, eng._mix_dev, eng.lsh.inv_cell)
        assert torch.equal(keys, want)
        np.testing.assert_array_equal(
            keys.numpy(), eng.lsh.device_keys_batch(X[30 * n:30 * n + 30]))
        assert [eng.keys[30 * n + j] for j in range(30)] == \
            [[keys[j, i].numpy().tobytes() for i in range(5)]
             for j in range(30)]
