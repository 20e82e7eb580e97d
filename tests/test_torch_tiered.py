"""The port's tiered serving index (``repro_torch.tiered``, backend
``tiered``) against the JAX package's, on the streams of
``tests/test_tiered.py``.

The front tier (``approx``) answers every live point at once; after the
``exact_labels()`` barrier the back tier (``soa``) has applied the whole
stream and equals a port ``soa`` index driven through the same stream
and the reference ``TieredIndex``'s back tier, label for label.  The
front equals the reference's front at every step (both apply each
mutation synchronously).  Divergence numbers are compared only after a
barrier: the verifier's rounds before it depend on thread timing.  The
``tiered.*`` gauges appear in the index's obs snapshot, and snapshots
interchange with the reference's both ways.  Tolerance: none, labels are
integers; the divergence ARI of the two packages is the same float.

Every test closes the indices it builds in a ``finally``, so no
verifier thread outlives it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro.data import blobs  # noqa: E402
from repro_torch.core import adjusted_rand_index  # noqa: E402
from repro_torch.tiered import TieredIndex  # noqa: E402


def _cfg(mod, **kw):
    base = dict(d=8, k=24, t=8, eps=0.5, seed=0)
    base.update(kw)
    return mod.ClusterConfig(**base)


def _stream(indices, X, batch=200, window=None, drop_every=2):
    """``tests/test_tiered.py``'s stream into every index at once: insert
    X in batches with periodic sliding-window deletions; the fronts'
    labels are equal after every call."""
    ids, ptr = [], 0
    for bno, s in enumerate(range(0, len(X), batch)):
        got = [ix.insert_batch(X[s:s + batch]) for ix in indices]
        assert all(g == got[0] for g in got[1:])
        ids += got[0]
        if window and len(ids) - ptr > window and bno % drop_every == 0:
            drop = len(ids) - ptr - window
            for ix in indices:
                ix.delete_batch(ids[ptr:ptr + drop])
            ptr += drop
        labels = [ix.labels() for ix in indices]
        assert all(lab == labels[0] for lab in labels[1:])
    live = ids[ptr:]
    return live, indices[0].labels(live)


def test_backend_is_host_only():
    with pytest.raises(ValueError, match="host only"):
        api.build_index(_cfg(api, backend="tiered"), device="cuda")
    idx = api.build_index(_cfg(api, backend="tiered", sample_rate=0.5),
                          device="cpu")
    try:
        assert isinstance(idx, TieredIndex)
        assert not idx.front.engine.use_device
        assert not idx.back.engine.use_device
        assert idx.front.engine.sample_rate == 0.5
        assert idx.back.cfg.backend == "soa"
    finally:
        idx.close()
    assert not idx.verifier.is_alive()
    assert "tiered" not in api.DEVICE_BACKENDS


def test_serves_from_front_and_verifies_on_back():
    X, _ = blobs(n=1500, d=8, n_clusters=4, cluster_std=0.4, seed=8)
    cfg = dict(k=64, backend="tiered", sample_rate=0.2, obs=True)
    ours = api.build_index(_cfg(api, **cfg))
    theirs = jax_api.build_index(_cfg(jax_api, **cfg))
    exact = api.build_index(_cfg(api, k=64, backend="soa"))
    try:
        live, served = _stream([ours, theirs], X, window=1000)
        _stream([exact], X, window=1000)
        # the front tier answers immediately for every live point
        assert sorted(served) == sorted(live)
        # after the barrier the back tier has applied the whole stream
        got = ours.exact_labels(live)
        assert got == theirs.exact_labels(live) == exact.labels(live)
        assert ours.back.labels() == exact.labels()
        ari = adjusted_rand_index([got[i] for i in live],
                                  [served[i] for i in live])
        assert ari >= 0.9, ari
        # the barrier ran a divergence round on the drained tiers
        assert ours.stats()["divergence_ari"] == \
            theirs.stats()["divergence_ari"]
        snap = ours.obs.snapshot()
        m = snap["metrics"]
        assert m["tiered.divergence_ari"]["type"] == "gauge"
        assert m["tiered.divergence_ari"]["value"] == \
            ours.stats()["divergence_ari"] >= 0.9
        assert m["tiered.lag"]["value"] == 0  # flushed by exact_labels()
        assert "tiered.queue_depth" in m and "tiered.hot_buckets" in m
        assert ours.stats()["lag"] == 0
        assert ours.stats()["queue_depth"] == 0
        ours.check_invariants()
    finally:
        ours.close()
        theirs.close()
    assert not ours.verifier.is_alive()


def test_escalated_queries_read_the_back_tier():
    """A query for a point whose table-0 bucket the policy holds hot
    escalates to the exact tier and counts under ``tiered.escalations``;
    the mark expires after ``ttl_rounds`` verification rounds.  The
    buckets are marked here by hand: which ones the verifier marks
    depends on when its rounds ran."""
    X, _ = blobs(n=1500, d=8, n_clusters=4, cluster_std=0.4, seed=8)
    idx = api.build_index(_cfg(api, k=64, backend="tiered",
                               sample_rate=0.2, obs=True))
    try:
        live, _ = _stream([idx], X, window=1000)
        idx.flush()
        hot = live[::50]
        idx.policy.mark([idx._key0(i) for i in hot], idx.verifier.round_no)
        hot_set = {i for i in live
                   if idx.policy.hot(idx._key0(i), idx.verifier.round_no)}
        assert set(hot) <= hot_set
        for i in live:
            want = (idx.back.label(i) if i in hot_set
                    else idx.front.label(i))
            assert idx.label(i) == want
        assert idx.n_escalations == len(hot_set)
        m = idx.obs.snapshot()["metrics"]
        assert m["tiered.escalations"]["value"] == len(hot_set)
        for _ in range(idx.policy.ttl_rounds + 1):
            idx.flush()  # each barrier runs a round
        assert not any(idx.policy.hot(idx._key0(i), idx.verifier.round_no)
                       for i in hot)
    finally:
        idx.close()


def test_at_rate_one_front_equals_back():
    X, _ = blobs(n=500, d=8, n_clusters=4, cluster_std=0.3, seed=9)
    idx = api.build_index(_cfg(api, backend="tiered", sample_rate=1.0))
    try:
        ids = idx.insert_batch(X)
        idx.delete_batch(ids[::5])
        live = [i for j, i in enumerate(ids) if j % 5]
        assert idx.labels(live) == idx.exact_labels(live)
        assert idx.stats()["divergence_ari"] == 1.0
    finally:
        idx.close()


def test_snapshot_restore_roundtrip():
    X, _ = blobs(n=400, d=8, n_clusters=4, cluster_std=0.3, seed=10)
    idx = api.build_index(_cfg(api, backend="tiered", sample_rate=0.3))
    clone = None
    try:
        idx.insert_batch(X[:300])
        snap = idx.snapshot()
        assert {k.split("/")[0] for k in snap["state"]} == {"front", "back"}
        clone = api.restore_index(snap)
        assert clone.labels() == idx.labels()
        idx.insert_batch(X[300:])
        clone.insert_batch(X[300:])
        assert clone.labels() == idx.labels()
        assert clone.exact_labels() == idx.exact_labels()
        clone.check_invariants()
    finally:
        idx.close()
        if clone is not None:
            clone.close()


def test_snapshots_interchange_with_reference():
    X, _ = blobs(n=600, d=8, n_clusters=4, cluster_std=0.3, seed=11)
    cfg = dict(backend="tiered", sample_rate=0.3)
    ours = api.build_index(_cfg(api, **cfg))
    theirs = jax_api.build_index(_cfg(jax_api, **cfg))
    opened = [ours, theirs]
    try:
        _stream([ours, theirs], X[:400], batch=100, window=250)
        snap_o, snap_t = ours.snapshot(), theirs.snapshot()
        assert snap_o["config"] == snap_t["config"]
        assert snap_o["state"].keys() == snap_t["state"].keys()
        for key, val in snap_t["state"].items():
            np.testing.assert_array_equal(snap_o["state"][key], val,
                                          err_msg=key)
        there = jax_api.restore_index(snap_o)
        opened.append(there)
        here = api.restore_index(snap_t)
        opened.append(here)
        assert isinstance(here, TieredIndex)
        _stream([ours, theirs, there, here], X[400:], batch=100)
        want = theirs.exact_labels()
        for ix in (ours, there, here):
            assert ix.exact_labels() == want
        here.check_invariants()
    finally:
        for ix in opened:
            ix.close()
