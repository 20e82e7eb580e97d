"""The port's static baselines against the JAX package's: backends
``naive`` (exact Algorithm-1 DBSCAN), ``emz-static`` (EMZ recompute) and
``emz-fixed`` (EMZ with frozen cores), and the engines behind them called
directly.  Labels, ids and snapshot arrays must be identical (tolerance
zero: labels are integers, both sides compute in float64 numpy from the
same points, and the LSH family is drawn from the same numpy seed).

All three are host-only in both packages; the port refuses a device
request for them rather than running on the host.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro.core as jax_core  # noqa: E402
import repro_torch.api as api  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro.core import naive_dbscan as jax_naive  # noqa: E402
from repro_torch.core import naive_dbscan  # noqa: E402
from repro_torch.data import blobs  # noqa: E402

BASELINES = ("naive", "emz-static", "emz-fixed")
RECOMPUTE = ("naive", "emz-static")
N, BATCH = 3000, 500


def _cfg(mod, backend, **kw):
    base = dict(d=10, k=10, t=10, eps=0.75, seed=1, backend=backend)
    base.update(kw)
    return mod.ClusterConfig(**base)


def _stream(seed=1, n=N):
    X, y = blobs(n=n, d=10, n_clusters=10, cluster_std=0.25, seed=seed)
    return X, y


def _assert_same_snapshot(a, b):
    assert a["config"] == b["config"]
    assert a["state"].keys() == b["state"].keys()
    for key in a["state"]:
        x, y = a["state"][key], b["state"][key]
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("backend", BASELINES)
def test_stream_labels_match_reference_after_every_batch(backend):
    """The Table-2 protocol at a small size: batches of 500, labels after
    every batch (the recompute backends also lose every 7th live point
    after each batch)."""
    X, y = _stream()
    ix = api.build_index(_cfg(api, backend))
    ref = jax_api.build_index(_cfg(jax_api, backend))
    for b in range(0, N, BATCH):
        ids = ix.insert_batch(X[b:b + BATCH])
        assert ids == ref.insert_batch(X[b:b + BATCH])
        assert ix.labels() == ref.labels()
        assert ix.labels(ids[::3]) == ref.labels(ids[::3])
        if backend in RECOMPUTE and b + BATCH < N:
            victims = ix.ids()[b // BATCH::7]
            ix.delete_batch(victims)
            ref.delete_batch(victims)
            assert ix.labels() == ref.labels()
    assert ix.ids() == ref.ids() and len(ix) == len(ref)
    for i in ix.ids()[::97]:
        assert ix.label(i) == ref.label(i)
        assert i in ix
    live = np.array(ix.ids())
    lab = ix.labels()
    ari = core.adjusted_rand_index(y[live], np.array([lab[i] for i in live]))
    assert ari == jax_core.adjusted_rand_index(
        y[live], np.array([ref.labels()[i] for i in live]))
    assert ari > 0.5


def test_emz_fixed_refuses_deletes_on_both_sides():
    X, _ = _stream(n=600)
    for mod in (api, jax_api):
        ix = mod.build_index(_cfg(mod, "emz-fixed"))
        ix.insert_batch(X)
        with pytest.raises(NotImplementedError):
            ix.delete(0)
        with pytest.raises(NotImplementedError):
            ix.delete_batch([1, 2])
        assert len(ix) == 600


@pytest.mark.parametrize("backend", BASELINES)
def test_pinned_out_of_order_ids_match_reference(backend):
    X, _ = _stream(seed=2, n=1200)
    rng = np.random.default_rng(5)
    pins = [int(i) for i in rng.permutation(5000)[:600]]
    ix = api.build_index(_cfg(api, backend))
    ref = jax_api.build_index(_cfg(jax_api, backend))
    assert ix.insert_batch(X[:600], ids=pins) == pins
    assert ref.insert_batch(X[:600], ids=pins) == pins
    # auto ids continue past the largest pin, then single pinned inserts
    assert ix.insert_batch(X[600:1100]) == ref.insert_batch(X[600:1100])
    for j in range(1100, 1200):
        assert ix.insert(X[j], idx=9000 - j) == ref.insert(X[j],
                                                           idx=9000 - j)
    assert ix.labels() == ref.labels()
    with pytest.raises(KeyError):
        ix.insert(X[0], idx=pins[0])
    with pytest.raises(KeyError):
        ref.insert(X[0], idx=pins[0])
    assert ix.labels() == ref.labels()


@pytest.mark.parametrize("backend", BASELINES)
def test_port_snapshot_restores_in_reference(backend):
    X, _ = _stream(seed=3, n=1500)
    ix = api.build_index(_cfg(api, backend))
    ix.insert_batch(X[:500])
    ix.insert_batch(X[500:1000])
    if backend in RECOMPUTE:
        ix.delete_batch(ix.ids()[::5])
    snap = ix.snapshot()
    rest = jax_api.restore_index(snap)
    assert rest.labels() == ix.labels()
    assert rest.ids() == ix.ids()
    _assert_same_snapshot(rest.snapshot(), snap)
    assert rest.insert_batch(X[1000:]) == ix.insert_batch(X[1000:])
    assert rest.labels() == ix.labels()


@pytest.mark.parametrize("backend", BASELINES)
def test_reference_snapshot_restores_in_port(backend):
    X, _ = _stream(seed=4, n=1500)
    ref = jax_api.build_index(_cfg(jax_api, backend))
    ref.insert_batch(X[:700])
    ref.insert_batch(X[700:1100])
    if backend in RECOMPUTE:
        ref.delete_batch(ref.ids()[1::4])
    snap = ref.snapshot()
    ix = api.restore_index(snap)
    assert ix.labels() == ref.labels()
    assert ix.ids() == ref.ids()
    _assert_same_snapshot(ix.snapshot(), snap)
    assert ix.insert_batch(X[1100:]) == ref.insert_batch(X[1100:])
    assert ix.labels() == ref.labels()
    # an empty index snapshots and restores too
    empty = api.build_index(_cfg(api, backend)).snapshot()
    _assert_same_snapshot(empty, jax_api.build_index(
        _cfg(jax_api, backend)).snapshot())
    assert len(api.restore_index(empty)) == 0


@pytest.mark.parametrize("backend", BASELINES)
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_host_baselines_refuse_a_device(backend, device):
    with pytest.raises(ValueError, match="host only"):
        api.build_index(_cfg(api, backend), device=device)
    snap = api.build_index(_cfg(api, backend)).snapshot()
    with pytest.raises(ValueError, match="host only"):
        api.restore_index(snap, device=device)
    assert len(api.build_index(_cfg(api, backend), device="cpu")) == 0


# --------------------------------------------------------------------- #
# the engines, called directly
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("k,eps", [(10, 0.75), (5, 0.5), (30, 1.0)])
def test_dbscan_matches_reference(k, eps):
    X, _ = _stream(seed=6, n=1500)
    np.testing.assert_array_equal(core.dbscan(X, k, eps),
                                  jax_core.dbscan(X, k, eps))
    np.testing.assert_array_equal(
        naive_dbscan.eps_neighbor_counts(X, eps, block=256),
        jax_naive.eps_neighbor_counts(X, eps, block=256))
    sk, jsk = core.SklearnStyleDBSCAN(k, eps), jax_core.SklearnStyleDBSCAN(
        k, eps)
    for b in range(0, 1500, 500):
        np.testing.assert_array_equal(sk.add_batch(X[b:b + 500]),
                                      jsk.add_batch(X[b:b + 500]))


@pytest.mark.parametrize("t,seed", [(10, 0), (4, 7)])
def test_emz_cluster_matches_reference(t, seed):
    X, _ = _stream(seed=7, n=2000)
    lab, cmask = core.emz_cluster(X, 10, 0.75, t, seed=seed,
                                  return_core=True)
    jlab, jcmask = jax_core.emz_cluster(X, 10, 0.75, t, seed=seed,
                                        return_core=True)
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_array_equal(cmask, jcmask)
    assert cmask.dtype == bool and cmask.any()
    np.testing.assert_array_equal(
        core.emz_cluster(X, 10, 0.75, t, seed=seed), lab)
    rec = core.EMZRecompute(10, 10, t, 0.75, seed=seed)
    jrec = jax_core.EMZRecompute(10, 10, t, 0.75, seed=seed)
    for b in range(0, 2000, 400):
        np.testing.assert_array_equal(rec.add_batch(X[b:b + 400]),
                                      jrec.add_batch(X[b:b + 400]))


@pytest.mark.parametrize("first", [300, 1000])
def test_emz_fixed_core_matches_reference(first):
    X, _ = _stream(seed=8, n=2000)
    eng = core.EMZFixedCore(10, 10, 10, 0.75, seed=3)
    jeng = jax_core.EMZFixedCore(10, 10, 10, 0.75, seed=3)
    for lo, hi in [(0, first), (first, first + 400), (first + 400, 2000)]:
        np.testing.assert_array_equal(eng.add_batch(X[lo:hi]),
                                      jeng.add_batch(X[lo:hi]))
    assert len(eng._labels) == 2000
