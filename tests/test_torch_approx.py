"""The port's sampled-core tier (``repro_torch.core.approx``, backend
``approx``) against the JAX package's.

``repro_torch.core.approx.SampledCoreDBSCAN`` — on its device path with
``device="cpu"`` (one two-table pass a batch through the plain masked
``bucket_insert_pass``) and on the host path — is driven beside
``repro.core.approx.SampledCoreDBSCAN`` with ``use_device=False`` and
with ``use_device="interpret"`` (the Pallas kernels in interpret mode,
three calls a batch; on the ``tests/test_soa.py`` stream at rate 1.0
only, see ``test_soa_stream_matches_reference``), through the mixed
insert/delete streams of ``tests/test_soa.py`` (pinned out-of-order
ids, batch deletes) and of ``tests/test_tiered.py`` (a sliding window),
at sample rates 0.1, 0.3, 0.5 and 1.0, in both repair modes, with and
without orphan attachment.
After every call the label dicts, the compacted deltas, every
``state_dict()`` array, the full and sampled bucket sizes, the support
and ``n_sampled()`` are identical: tolerance zero, since all of them are
integers (the points are the inserted float64 values, stored unchanged).

Also: the id-hash sample equals the reference's bit for bit; at rate 1.0
the engine equals the port's ``soa`` bit for bit; snapshots interchange
both ways; the device mirrors of both tables follow every host change
(single deletes, batch deletes, restores) into the next insert pass.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro.core.approx as jax_approx  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro.data import blobs  # noqa: E402
from repro_torch.core import approx  # noqa: E402
from repro_torch.core.soa import SoADynamicDBSCAN  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RATES = [0.1, 0.3, 0.5, 1.0]


def _engines(rate, repair, orphans, d=4, k=8, t=8, eps=0.45, seed=0,
             interpret=True):
    """(reference host, port device on the CPU, port host and, with
    ``interpret``, reference interpret) engines of one configuration."""
    kw = dict(seed=seed, attach_orphans=orphans, repair=repair,
              sample_rate=rate, approx_seed=3)
    out = [jax_approx.SampledCoreDBSCAN(d, k, t, eps, use_device=False,
                                        **kw),
           approx.SampledCoreDBSCAN(d, k, t, eps, use_device=True,
                                    device="cpu", **kw),
           approx.SampledCoreDBSCAN(d, k, t, eps, use_device=False, **kw)]
    if interpret:
        out.append(jax_approx.SampledCoreDBSCAN(
            d, k, t, eps, use_device="interpret", **kw))
    return out


def _assert_same(engines):
    """Every engine's labels, state, tables, support and sample count
    equal the first's; the port's device mirrors equal its host tables
    whenever they are fresh."""
    a = engines[0]
    sa, la = a.state_dict(), a.labels()
    rows_a = [a._row[i] for i in sorted(a._row)]
    for b in engines[1:]:
        assert b.labels() == la
        sb = b.state_dict()
        assert sa.keys() == sb.keys()
        for key in sa:
            assert sa[key].dtype == sb[key].dtype, key
            np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
        ns = a._n_slots
        assert b._n_slots == ns
        np.testing.assert_array_equal(b._bsize[:ns], a._bsize[:ns])
        np.testing.assert_array_equal(b._ssize[:ns], a._ssize[:ns])
        rows_b = [b._row[i] for i in sorted(b._row)]
        np.testing.assert_array_equal(b._support[rows_b],
                                      a._support[rows_a])
        assert b.n_sampled() == a.n_sampled()
        if isinstance(b, approx.SampledCoreDBSCAN) and b.use_device:
            b._dpass.check(b._bsize, ns, b._ssize)


def _drain_equal(engines):
    deltas = [sorted(e.drain_deltas()) for e in engines]
    assert all(d == deltas[0] for d in deltas[1:])


def _soa_stream(engines, seed, n=400, d=4):
    """tests/test_soa.py's batch-grained mixed stream: pinned
    out-of-order ids, random batch deletes; every fifth step a single
    delete in their place (the sequential path, ``_bucket_shrink``)."""
    rng = np.random.default_rng(seed + 50)
    X, _ = blobs(n=n, d=d, n_clusters=4, cluster_std=0.3, seed=seed)
    pos, alive, step = 0, [], 0
    while pos < len(X):
        b = int(rng.integers(1, 50))
        chunk = X[pos:pos + b]
        pos += b
        ids = None
        if rng.random() < 0.3:
            base = 10_000 + pos * 10
            ids = [None if rng.random() < 0.5 else base + j
                   for j in range(len(chunk))]
        got = [e.add_batch(chunk, ids=ids) for e in engines]
        assert all(g == got[0] for g in got[1:])
        alive.extend(got[0])
        _drain_equal(engines)
        if step % 5 == 4 and len(alive) > 30:
            # alone between two inserts, so the next pass must see it
            victim = alive.pop(int(rng.integers(len(alive))))
            for e in engines:
                e.delete_point(victim)
            _drain_equal(engines)
        elif rng.random() < 0.5 and len(alive) > 30:
            nd = int(rng.integers(1, min(20, len(alive) - 10)))
            dels = [alive.pop(int(rng.integers(len(alive))))
                    for _ in range(nd)]
            for e in engines:
                e.delete_batch(dels)
            _drain_equal(engines)
        _assert_same(engines)
        step += 1


def _window_stream(engines, seed, n=900, batch=150, window=500):
    """tests/test_tiered.py's stream: inserts in batches with a sliding
    window of deletes every other batch."""
    X, _ = blobs(n=n, d=8, n_clusters=4, cluster_std=0.3, seed=seed)
    ids, ptr = [], 0
    for bno, s in enumerate(range(0, len(X), batch)):
        got = [e.add_batch(X[s:s + batch]) for e in engines]
        assert all(g == got[0] for g in got[1:])
        ids += got[0]
        _drain_equal(engines)
        if len(ids) - ptr > window and bno % 2 == 0:
            drop = len(ids) - ptr - window
            for e in engines:
                e.delete_batch(ids[ptr:ptr + drop])
            ptr += drop
            _drain_equal(engines)
        _assert_same(engines)


# ---------------------------------------------------------------------- #
# the id-hash sample
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 5, 123])
def test_sampled_mask_bit_equal_to_reference(seed):
    ids = np.arange(0, 5000, dtype=np.int64)
    big = np.array([2**62 + 7, 2**63 - 1, 10**15], dtype=np.int64)
    for rate in RATES + [0.0, 0.05, 0.999]:
        m = approx.sampled_mask(ids, rate, seed)
        assert m.dtype == bool and m.shape == ids.shape
        np.testing.assert_array_equal(
            m, jax_approx.sampled_mask(ids, rate, seed))
        np.testing.assert_array_equal(
            approx.sampled_mask(big, rate, seed),
            jax_approx.sampled_mask(big, rate, seed))
        scalar = np.array([approx.is_sampled(int(i), rate, seed)
                           for i in ids[:1000]])
        np.testing.assert_array_equal(scalar, m[:1000])
        for i in big:
            assert approx.is_sampled(int(i), rate, seed) == \
                jax_approx.is_sampled(int(i), rate, seed)


def test_core_threshold_matches_reference():
    for k, rate in [(24, 0.1), (24, 1.0), (256, 0.1), (10, 0.05), (8, 0.25),
                    (10, 0.5)]:
        ours = approx.SampledCoreDBSCAN(4, k, 4, 0.5, sample_rate=rate)
        theirs = jax_approx.SampledCoreDBSCAN(4, k, 4, 0.5, sample_rate=rate)
        assert ours.core_k == theirs.core_k
    with pytest.raises(ValueError, match="sample_rate"):
        approx.SampledCoreDBSCAN(4, 8, 4, 0.5, sample_rate=0.0)


# ---------------------------------------------------------------------- #
# the engine against the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("orphans", [True, False])
@pytest.mark.parametrize("repair", ["exact", "paper"])
@pytest.mark.parametrize("rate", RATES)
def test_soa_stream_matches_reference(rate, repair, orphans):
    """The reference's interpret engine joins at rate 1.0 only: its
    device path raises on an insert batch that holds no sampled point
    (``slot_counts`` of zero rows is a Pallas block of shape (0, t)), and
    this stream's batches of 1-49 points hold such batches at every lower
    rate.  The port's device path takes them (an all-false mask)."""
    engines = _engines(rate, repair, orphans, seed=1,
                       interpret=rate == 1.0)
    ops.reset_launch_counts()
    _soa_stream(engines, seed=1)
    for e in engines:
        e.check_invariants()
    # the CPU device path ran the plain versions: no kernel launched
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("orphans", [True, False])
@pytest.mark.parametrize("rate", RATES)
def test_window_stream_matches_reference(rate, orphans):
    engines = _engines(rate, "exact", orphans, d=8, k=24, t=8, eps=0.5,
                       seed=2)
    _window_stream(engines, seed=2)
    for e in engines:
        e.check_invariants()


@pytest.mark.parametrize("device", [False, True])
def test_rate_one_is_bit_identical_to_soa(device):
    """At rate 1.0 the sample is everyone and the engine is the port's
    exact ``soa`` engine, bit for bit (``tests/test_tiered.py``'s oracle);
    on the device path the masked pass runs with an all-true mask."""
    kw = dict(seed=0, use_device=device, device="cpu")
    a = SoADynamicDBSCAN(8, 24, 8, 0.5, **kw)
    b = approx.SampledCoreDBSCAN(8, 24, 8, 0.5, sample_rate=1.0, **kw)
    X, _ = blobs(n=900, d=8, n_clusters=4, cluster_std=0.3, seed=2)
    rng = np.random.default_rng(0)
    alive = []
    for s in range(0, len(X), 150):
        assert a.add_batch(X[s:s + 150]) == (got := b.add_batch(
            X[s:s + 150]))
        alive += got
        assert sorted(a.drain_deltas()) == sorted(b.drain_deltas())
        if len(alive) > 200:
            dels = [alive.pop(int(rng.integers(len(alive))))
                    for _ in range(40)]
            a.delete_batch(dels)
            b.delete_batch(dels)
            assert sorted(a.drain_deltas()) == sorted(b.drain_deltas())
        assert a.labels() == b.labels()
        for key, val in a.state_dict().items():
            np.testing.assert_array_equal(b.state_dict()[key], val)
        np.testing.assert_array_equal(a._bsize, b._ssize)
    a.check_invariants()
    b.check_invariants()


# ---------------------------------------------------------------------- #
# the device path's mirrors
# ---------------------------------------------------------------------- #
def test_device_pass_takes_the_masked_route(monkeypatch):
    """One ``ops.bucket_insert_pass`` call an insert batch, with the
    sampled sizes and the sample mask: the two-table route."""
    calls = []
    inner = ops.bucket_insert_pass

    def spy(*a, **kw):
        calls.append(kw)
        return inner(*a, **kw)

    monkeypatch.setattr(ops, "bucket_insert_pass", spy)
    eng = approx.SampledCoreDBSCAN(8, 24, 8, 0.5, sample_rate=0.3,
                                   use_device=True, device="cpu")
    X, _ = blobs(n=600, d=8, n_clusters=4, cluster_std=0.3, seed=3)
    for s in range(0, 600, 100):
        eng.add_batch(X[s:s + 100])
    assert len(calls) == 6
    for kw in calls:
        assert kw["core_sizes"] is not None
        assert kw["row_mask"].dtype == torch.uint8
        assert kw["k"] == eng.core_k == 7


def test_mirrors_follow_every_host_change():
    """Delete, then insert: each host change of the tables outside the
    insert pass (a batch delete, a single delete, which runs the
    subclass's own ``_bucket_shrink``, and a restore, which runs its
    ``_rebuild_support``) makes the next pass upload both tables, so the
    device engine stays equal to the host engine and its mirrors to its
    tables."""
    kw = dict(sample_rate=0.3, seed=4)
    dev = approx.SampledCoreDBSCAN(8, 24, 8, 0.5, use_device=True,
                                   device="cpu", **kw)
    host = approx.SampledCoreDBSCAN(8, 24, 8, 0.5, **kw)
    dp = dev._dpass
    X, _ = blobs(n=1400, d=8, n_clusters=4, cluster_std=0.3, seed=4)
    for s in range(0, 600, 150):
        assert dev.add_batch(X[s:s + 150]) == host.add_batch(X[s:s + 150])
    assert dp.fresh and dp.n_size_uploads == 0
    assert dev._n_slots > 256 and dp.core_sizes.numel() >= dev._n_slots
    _assert_same([host, dev])

    ids = sorted(dev._row)
    dev.delete_batch(ids[:40])
    host.delete_batch(ids[:40])
    assert not dp.fresh
    dev.add_batch(X[600:750])
    host.add_batch(X[600:750])
    assert dp.fresh and dp.n_size_uploads == 1
    _assert_same([host, dev])

    for victim in ids[40:200:8]:  # sampled and non-sampled points
        dev.delete_point(victim)
        host.delete_point(victim)
        assert not dp.fresh
        dev.add_batch(X[750 + victim % 50:751 + victim % 50] + 0.01)
        host.add_batch(X[750 + victim % 50:751 + victim % 50] + 0.01)
        _assert_same([host, dev])
    assert dp.n_size_uploads == 21

    # a restore numbers the slots anew: hold it against a host restore
    rest = approx.SampledCoreDBSCAN(8, 24, 8, 0.5, use_device=True,
                                    device="cpu", **kw)
    rest.load_state_dict(dev.state_dict())
    host = approx.SampledCoreDBSCAN(8, 24, 8, 0.5, **kw)
    host.load_state_dict(dev.state_dict())
    assert not rest._dpass.fresh
    rest.add_batch(X[800:1000])
    host.add_batch(X[800:1000])
    assert rest._dpass.n_size_uploads == 1
    _assert_same([host, rest])
    rest.check_invariants()
    with pytest.raises(ValueError, match="every table"):
        rest._dpass.check(rest._bsize, rest._n_slots)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        approx.SampledCoreDBSCAN(4, 8, 8, 0.45, use_device=True,
                                 sample_rate=0.5)


# ---------------------------------------------------------------------- #
# the backend
# ---------------------------------------------------------------------- #
def _cfg(mod, **kw):
    base = dict(d=8, k=24, t=8, eps=0.5, seed=0, backend="approx",
                sample_rate=0.3)
    base.update(kw)
    return mod.ClusterConfig(**base)


def test_backend_is_host_only():
    ix = api.build_index(_cfg(api), device="cpu")
    assert isinstance(ix, api.ApproxIndex) and not ix.engine.use_device
    with pytest.raises(ValueError, match="host only"):
        api.build_index(_cfg(api), device="cuda")
    assert "approx" not in api.DEVICE_BACKENDS


@pytest.mark.parametrize("rate", [0.3, 1.0])
def test_backend_matches_reference_and_snapshots_interchange(rate):
    X, _ = blobs(n=600, d=8, n_clusters=4, cluster_std=0.3, seed=4)
    ours = api.build_index(_cfg(api, sample_rate=rate))
    theirs = jax_api.build_index(_cfg(jax_api, sample_rate=rate))
    for ix in (ours, theirs):
        ix.drain_deltas()
        ix.insert_batch(X[:400])
        ix.delete_batch(list(ix.ids())[::4])
    assert sorted(ours.drain_deltas()) == sorted(theirs.drain_deltas())
    assert ours.labels() == theirs.labels()
    assert ours.stats() == theirs.stats()
    snap_o, snap_t = ours.snapshot(), theirs.snapshot()
    assert snap_o["config"] == snap_t["config"]
    for key, val in snap_t["state"].items():
        np.testing.assert_array_equal(snap_o["state"][key], val)
    there = jax_api.restore_index(snap_o)
    here = api.restore_index(snap_t)
    assert isinstance(here, api.ApproxIndex)
    for a, b in ((ours, there), (theirs, here)):
        assert a.labels() == b.labels()
        a.insert_batch(X[400:])
        b.insert_batch(X[400:])
        assert a.labels() == b.labels()
        b.check_invariants()
    assert here.labels() == there.labels()
