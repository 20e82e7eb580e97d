"""The port's API against ``repro.api``: registry parity, config parity,
snapshot interchange in both directions, and no silent CPU run for
``soa-device``.  Labels, ids and snapshot arrays must be identical
(tolerance zero: they are integers, and the points are stored as
given)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro.data import blobs  # noqa: E402

BACKENDS = ("soa", "soa-device")


def _cfg(mod, backend, **kw):
    base = dict(d=4, k=8, t=8, eps=0.45, seed=2, backend=backend)
    base.update(kw)
    return mod.ClusterConfig(**base)


def _build(backend, **kw):
    device = "cpu" if backend == "soa-device" else None
    return api.build_index(_cfg(api, backend, **kw), device=device)


def _assert_same_snapshot(a, b):
    assert a["config"] == b["config"]
    assert a["state"].keys() == b["state"].keys()
    for key in a["state"]:
        x, y = a["state"][key], b["state"][key]
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


def test_registry_holds_the_ported_backends():
    ported = BACKENDS + ("emz-static", "naive", "emz-fixed", "dynamic",
                         "batched", "batched-device", "approx", "tiered",
                         "sharded")
    assert api.available_backends() == tuple(sorted(ported))
    assert api.available_backends() == jax_api.available_backends()


def test_config_fields_match_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(api.ClusterConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(jax_api.ClusterConfig)]
    assert ours == theirs
    cfg = _cfg(api, "soa-device", attach_orphans=False)
    assert cfg.to_dict() == _cfg(jax_api, "soa-device",
                                 attach_orphans=False).to_dict()
    with pytest.raises(ValueError):
        api.ClusterConfig(d=4, k=0, t=8, eps=0.45)


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_snapshot_restores_in_reference(backend):
    X, _ = blobs(n=350, d=4, n_clusters=4, cluster_std=0.3, seed=2)
    ix = _build(backend)
    ix.insert_batch(X[:200])
    ix.delete_batch(list(ix.ids())[::5])
    snap = ix.snapshot()
    rest = jax_api.restore_index(snap)
    assert rest.labels() == ix.labels()
    assert rest.ids() == ix.ids()
    rest.check_invariants()
    _assert_same_snapshot(rest.snapshot(), snap)
    # both keep agreeing under further updates
    assert rest.insert_batch(X[200:]) == ix.insert_batch(X[200:])
    assert rest.labels() == ix.labels()
    assert sorted(rest.drain_deltas() or []) == sorted(ix.drain_deltas()
                                                       or [])


@pytest.mark.parametrize("backend", BACKENDS)
def test_reference_snapshot_restores_in_port(backend):
    X, _ = blobs(n=350, d=4, n_clusters=4, cluster_std=0.3, seed=3)
    ref = jax_api.build_index(_cfg(jax_api, backend))
    ref.insert_batch(X[:220])
    ref.delete_batch(list(ref.ids())[1::4])
    snap = ref.snapshot()
    device = "cpu" if backend == "soa-device" else None
    ix = api.restore_index(snap, device=device)
    assert ix.labels() == ref.labels()
    assert ix.ids() == ref.ids()
    ix.check_invariants()
    _assert_same_snapshot(ix.snapshot(), snap)
    ref.drain_deltas()
    ix.drain_deltas()
    assert ix.insert_batch(X[220:]) == ref.insert_batch(X[220:])
    ix.delete_batch(list(ix.ids())[::7])
    ref.delete_batch(list(ref.ids())[::7])
    assert ix.labels() == ref.labels()
    assert sorted(ix.drain_deltas()) == sorted(ref.drain_deltas())
    other = api.build_index(_cfg(api, backend, k=9), device=device)
    with pytest.raises(ValueError, match="does not match"):
        other.restore(snap)


def test_soa_device_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.build_index(_cfg(api, "soa-device"))
    snap = _build("soa").snapshot()
    snap = dict(snap, config=dict(snap["config"], backend="soa-device"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.restore_index(snap)


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "meta"])
def test_host_soa_refuses_a_device(device):
    # soa has no kernel: a device request must fail, not run on the host
    with pytest.raises(ValueError, match="host only"):
        api.build_index(_cfg(api, "soa"), device=device)
    snap = _build("soa").snapshot()
    with pytest.raises(ValueError, match="host only"):
        api.restore_index(snap, device=device)
    assert len(api.build_index(_cfg(api, "soa"), device="cpu")) == 0


def test_apply_and_point_queries_match_reference():
    from repro.api import Delete as JDelete, Insert as JInsert

    X, _ = blobs(n=200, d=4, n_clusters=3, cluster_std=0.3, seed=5)
    ix = _build("soa-device")
    ref = jax_api.build_index(_cfg(jax_api, "soa-device"))
    evs = [api.Insert(x) for x in X[:150]] + [api.Delete(i)
                                              for i in range(0, 150, 9)]
    jevs = [JInsert(x) for x in X[:150]] + [JDelete(i)
                                            for i in range(0, 150, 9)]
    assert ix.apply(evs) == ref.apply(jevs)
    assert ix.labels() == ref.labels()
    for i in ix.ids()[::11]:
        assert ix.label(i) == ix.component_of(i) == ref.label(i)
        assert ix.core_anchor_of(i) == ref.core_anchor_of(i)
        assert ix.is_core(i) == ref.is_core(i)
    assert ix.stats() == ref.stats()
