"""The port's sharded index (``repro_torch.shard``) against ``repro.shard``.

The same config and the same seeded event stream go through both
packages' ``backend="sharded"`` index, at S in {1, 2, 4} and over every
shardable inner backend the port has (``soa-device`` on ``device="cpu"``,
its plain kernels, against the reference's jnp kernels).  Labels, the
compacted change feed, ``component_of`` / ``core_anchor_of``, ``stats()``
and the snapshots must be identical (tolerance zero: they are integers,
and the points are stored as given).  Plus the router, the rebalance
planner, the refusals and the ``with_shards`` convention, the reference's
interleaved-stream oracle (every query against a fresh rebuild of the
history), the thread-pool fan-out and the incremental merge switched on
and off, and snapshots interchanged in both directions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro.shard as jax_shard  # noqa: E402
from repro.core.hashing import GridLSH as JaxGridLSH  # noqa: E402
from repro.data import blobs  # noqa: E402

import repro_torch.api as api  # noqa: E402
import repro_torch.shard as shard  # noqa: E402
from repro_torch.api.registry import runs_on_device  # noqa: E402
from repro_torch.core.hashing import GridLSH  # noqa: E402

INNERS = ("dynamic", "batched", "soa", "soa-device", "emz-static")


def _cfg(mod, shards, inner="dynamic", **kw):
    base = dict(d=4, k=6, t=6, eps=0.45, seed=0, backend="sharded",
                shards=shards, inner_backend=inner)
    base.update(kw)
    return mod.ClusterConfig(**base)


def _port(cfg):
    """The port's index of ``cfg``, its device shards on the CPU."""
    return api.build_index(cfg, device="cpu" if runs_on_device(cfg)
                           else None)


def _stream(n, seed, max_ins=12):
    """Seeded chunks of (inserts [(x, id)], deletes [id])."""
    X, _ = blobs(n=n, d=4, n_clusters=4, cluster_std=0.2, seed=seed)
    rng = np.random.default_rng(seed)
    chunks, alive, row = [], [], 0
    while row < n:
        ins, dels = [], []
        for _ in range(int(rng.integers(1, max_ins))):
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


def _assert_same_state(a, b):
    assert a["config"] == b["config"]
    assert a["state"].keys() == b["state"].keys()
    for key in a["state"]:
        x, y = np.asarray(a["state"][key]), np.asarray(b["state"][key])
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


def _close(*indices):
    for ix in indices:
        ix.close()


# ---------------------------------------------------------------------- #
# router, planner, refusals, config convention
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mixed", [False, True])
def test_router_matches_reference_and_moves_ranges(mixed):
    X, _ = blobs(n=300, d=4, n_clusters=3, cluster_std=0.3, seed=1)
    ours = shard.ShardRouter(GridLSH(4, 0.45, 6, seed=3), 4, seed=3,
                             mixed=mixed)
    theirs = jax_shard.ShardRouter(JaxGridLSH(4, 0.45, 6, seed=3), 4,
                                   seed=3, mixed=mixed)
    again = shard.ShardRouter(GridLSH(4, 0.45, 6, seed=3), 4, seed=3,
                              mixed=mixed)
    np.testing.assert_array_equal(ours.slots_batch(X), theirs.slots_batch(X))
    np.testing.assert_array_equal(ours.slots_batch(X), again.slots_batch(X))
    np.testing.assert_array_equal(ours.shards_batch(X),
                                  theirs.shards_batch(X))
    assert set(ours.shards_batch(X).tolist()) <= {0, 1, 2, 3}
    assert ours.ranges() == theirs.ranges()
    assert sum(stop - start for start, stop, _ in ours.ranges()) == \
        shard.SLOTS
    ours.move_range(shard.RebalancePlan(100, 1500, 3))
    theirs.move_range(jax_shard.RebalancePlan(100, 1500, 3))
    np.testing.assert_array_equal(ours.state(), theirs.state())
    assert ours.ranges() == theirs.ranges()
    for bad in ((5, 5, 0), (-1, 4, 0), (0, shard.SLOTS + 1, 0), (0, 4, 4)):
        with pytest.raises(ValueError):
            ours.move_range(shard.RebalancePlan(*bad))
    with pytest.raises(ValueError):
        shard.ShardRouter(ours.lsh, 0)


def test_propose_rebalance_matches_reference():
    X, _ = blobs(n=400, d=4, n_clusters=2, cluster_std=0.2, seed=6)
    ix = _port(_cfg(api, 4, "soa"))
    ref = jax_api.build_index(_cfg(jax_api, 4, "soa"))
    try:
        ix.insert_batch(X)
        ref.insert_batch(X)
        for _ in range(3):
            plan = shard.propose_rebalance(ix)
            want = jax_shard.propose_rebalance(ref)
            assert (plan is None) == (want is None)
            if plan is None:
                break
            assert (plan.start, plan.stop, plan.target) == \
                (want.start, want.stop, want.target)
            gap = int(np.ptp(shard.shard_loads(ix)))
            assert ix.rebalance(plan) == ref.rebalance(want)
            assert int(np.ptp(shard.shard_loads(ix))) < gap
            assert ix.shard_sizes() == ref.shard_sizes()
            assert ix.labels() == ref.labels()
        ix.check_invariants()
    finally:
        _close(ix, ref)


@pytest.mark.parametrize("inner", ["naive", "emz-fixed", "tiered"])
def test_unsupported_inner_backends_are_refused(inner):
    assert inner in shard.index.UNSUPPORTED_INNER
    assert shard.index.UNSUPPORTED_INNER == jax_shard.index.UNSUPPORTED_INNER
    with pytest.raises(ValueError, match="cannot be sharded"):
        api.build_index(_cfg(api, 2, inner))
    with pytest.raises(ValueError):
        api.ClusterConfig(d=4, k=6, t=6, eps=0.45, backend="sharded",
                          inner_backend="sharded")


def test_device_is_refused_over_a_host_inner_backend():
    with pytest.raises(ValueError, match="host only"):
        api.build_index(_cfg(api, 2, "soa"), device="cuda")
    ix = api.build_index(_cfg(api, 2, "soa"), device="cpu")
    ix.close()


def test_with_shards_convention_matches_reference():
    for backend in ("soa", "soa-device", "sharded"):
        for shards in (0, 1, 3):
            ours = api.ClusterConfig(d=4, k=6, t=6, eps=0.45,
                                     backend=backend).with_shards(shards)
            theirs = jax_api.ClusterConfig(
                d=4, k=6, t=6, eps=0.45, backend=backend).with_shards(shards)
            assert ours.to_dict() == theirs.to_dict()
    cfg = api.ClusterConfig(d=4, k=6, t=6, eps=0.45,
                            backend="soa-device").with_shards(2)
    assert (cfg.backend, cfg.inner_backend, cfg.shards) == \
        ("sharded", "soa-device", 2)
    assert runs_on_device(cfg)


# ---------------------------------------------------------------------- #
# the same stream through both packages
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_stream_equals_reference(shards, inner):
    # soa-device's reference runs jnp kernels compiled per shape: a
    # shorter stream keeps it quick
    n = 60 if inner == "soa-device" else 200
    ix = _port(_cfg(api, shards, inner))
    ref = jax_api.build_index(_cfg(jax_api, shards, inner))
    try:
        for chunk in _stream(n, seed=shards):
            _apply(ix, chunk)
            _apply(ref, chunk)
            assert _deltas(ix) == _deltas(ref)
            assert ix.labels() == ref.labels()
        ids = ix.ids()
        assert ids == ref.ids()
        assert [ix.label(i) for i in ids] == [ref.label(i) for i in ids]
        assert [ix.component_of(i) for i in ids] == \
            [ref.component_of(i) for i in ids]
        assert [ix.is_core(i) for i in ids] == [ref.is_core(i) for i in ids]
        if inner != "emz-static":  # no native anchors: both raise
            assert [ix.core_anchor_of(i) for i in ids] == \
                [ref.core_anchor_of(i) for i in ids]
        assert ix.stats() == ref.stats()
        assert ix.shard_sizes() == ref.shard_sizes()
        _assert_same_state(ix.snapshot(), ref.snapshot())
        ix.check_invariants()
    finally:
        _close(ix, ref)


def _groups(lab):
    noise = frozenset(i for i, v in lab.items() if v == api.NOISE)
    by = {}
    for i, v in lab.items():
        if v != api.NOISE:
            by.setdefault(v, set()).add(i)
    return noise, frozenset(frozenset(g) for g in by.values())


def _drive_interleaved(cfg, jax_cfg, seed, n=300):
    """The reference's interleaved-stream oracle on the port: random
    insert/delete chunks with point and full queries, every full query
    against a fresh rebuild of the history (incremental merge off, serial
    fan-out) and against the reference's index on the same stream;
    mid-stream a snapshot restored through the OTHER package, then a
    rebalance in both."""
    X, _ = blobs(n=n, d=cfg.d, n_clusters=4, cluster_std=0.2, seed=seed)
    rng = np.random.default_rng(seed)
    ix, ref = _port(cfg), jax_api.build_index(jax_cfg)
    oracle_cfg = cfg.replace(incremental_merge=False, workers=0)
    history, alive, row, half_done = [], [], 0, False
    try:
        while row < n or alive:
            ins = []
            for _ in range(int(rng.integers(0, 7)) if row < n else 0):
                if row >= n:
                    break
                ins.append((X[row], row))
                alive.append(row)
                row += 1
            dels = []
            if alive and rng.random() < 0.6:
                for _ in range(int(rng.integers(1, min(6, len(alive)) + 1))):
                    dels.append(alive.pop(int(rng.integers(len(alive)))))
            if not ins and not dels:
                break
            history.append((ins, dels))
            _apply(ix, (ins, dels))
            _apply(ref, (ins, dels))
            if alive:
                lab = ix.labels()
                assert lab == ref.labels()
                noise, parts = _groups(lab)
                probe = [alive[int(j)] for j in
                         rng.integers(0, len(alive), size=min(8, len(alive)))]
                point = {i: ix.label(i) for i in probe}
                assert point == {i: ref.label(i) for i in probe}
                p_noise, p_parts = _groups(point)
                assert p_noise == noise & set(probe)
                for g in p_parts:
                    assert any(g <= big for big in parts), (g, parts)
            if not half_done and row >= n // 2:
                half_done = True
                before = ix.labels()
                # port snapshot -> reference index, reference -> port
                new_ref = jax_api.restore_index(ix.snapshot())
                new_ix = api.restore_index(
                    ref.snapshot(),
                    device="cpu" if runs_on_device(cfg) else None)
                _close(ix, ref)
                ix, ref = new_ix, new_ref
                assert ix.labels() == before == ref.labels()
                plan = (0, shard.SLOTS // 3, cfg.shards - 1)
                assert ix.rebalance(plan) == ref.rebalance(plan)
                assert ix.labels() == before == ref.labels()
                assert ix.shard_sizes() == ref.shard_sizes()
                ix.check_invariants()
            if rng.random() < 0.15:
                oracle = _port(oracle_cfg)
                for chunk in history:
                    _apply(oracle, chunk)
                assert oracle.labels() == ix.labels()
                oracle.close()
        oracle = _port(oracle_cfg)
        for chunk in history:
            _apply(oracle, chunk)
        assert oracle.labels() == ix.labels() == ref.labels()
        oracle.close()
        ix.check_invariants()
    finally:
        _close(ix, ref)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_interleaved_stream_matches_rebuild_oracle_and_reference(shards):
    _drive_interleaved(_cfg(api, shards, "soa", seed=shards),
                       _cfg(jax_api, shards, "soa", seed=shards), shards)


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("workers", [0, 4])
def test_fanout_and_merge_switches_hold_the_reference(workers, incremental):
    cfg = dict(seed=3, incremental_merge=incremental, workers=workers)
    _drive_interleaved(_cfg(api, 4, "batched", **cfg),
                       _cfg(jax_api, 4, "batched", **cfg), 3, n=200)


def test_threaded_fanout_uses_the_pool_and_equals_serial():
    chunks = _stream(240, seed=5)
    serial = _port(_cfg(api, 4, "soa-device"))
    threaded = _port(_cfg(api, 4, "soa-device", workers=4))
    try:
        assert serial._pool is None and threaded._pool is not None
        for chunk in chunks:
            _apply(serial, chunk)
            _apply(threaded, chunk)
            assert _deltas(serial) == _deltas(threaded)
        assert serial.labels() == threaded.labels()
        threaded.check_invariants()
    finally:
        _close(serial, threaded)


@pytest.mark.parametrize("inner", ["dynamic", "soa-device"])
def test_snapshots_interchange_both_ways(inner):
    chunks = _stream(150, seed=7)
    ix = _port(_cfg(api, 2, inner, seed=7))
    ref = jax_api.build_index(_cfg(jax_api, 2, inner, seed=7))
    try:
        for chunk in chunks:
            _apply(ix, chunk)
            _apply(ref, chunk)
        ix.rebalance((0, shard.SLOTS // 2, 1))
        ref.rebalance((0, shard.SLOTS // 2, 1))
        _assert_same_state(ix.snapshot(), ref.snapshot())
        theirs = jax_api.restore_index(ix.snapshot())
        ours = api.restore_index(
            ref.snapshot(), device="cpu" if inner == "soa-device" else None)
        try:
            assert theirs.labels() == ix.labels() == ours.labels()
            assert ours.shard_sizes() == ix.shard_sizes()
            ours.check_invariants()
            _assert_same_state(ours.snapshot(), theirs.snapshot())
        finally:
            _close(theirs, ours)
    finally:
        _close(ix, ref)


def test_empty_and_single_point_indices():
    ix = _port(_cfg(api, 4, "soa-device"))
    ref = jax_api.build_index(_cfg(jax_api, 4, "soa-device"))
    try:
        assert ix.labels() == ref.labels() == {}
        assert len(ix) == 0 and ix.stats() == ref.stats()
        ix.check_invariants()
        assert ix.insert(np.zeros(4), idx=7) == ref.insert(np.zeros(4),
                                                          idx=7) == 7
        assert ix.labels() == ref.labels() == {7: api.NOISE}
        with pytest.raises(KeyError):
            ix.insert(np.zeros(4), idx=7)
        with pytest.raises(KeyError, match="duplicate"):
            ix.delete_batch([7, 7])
        ix.delete(7)
        assert len(ix) == 0
        ix.check_invariants()
    finally:
        _close(ix, ref)


@pytest.mark.parametrize("workers", [0, 2])
def test_traced_insert_splits_into_route_and_fanout_spans(workers):
    """A traced insert batch records the coordinator's hash pass
    (``coord.route_and_key``) and the fan-out to the shards
    (``coord.fanout``) as children of its ``coord.insert_batch`` span,
    each inside it; the labels equal an untraced index's."""
    X, _ = blobs(n=200, d=4, n_clusters=3, cluster_std=0.2, seed=8)
    ix = _port(_cfg(api, 2, "soa-device", workers=workers, obs=True))
    plain = _port(_cfg(api, 2, "soa-device", workers=workers))
    try:
        for lo in range(0, 200, 50):
            assert ix.insert_batch(X[lo:lo + 50]) == plain.insert_batch(
                X[lo:lo + 50])
        assert ix.labels() == plain.labels()
        spans = ix.obs.snapshot()["spans"]
        parents = {s["span"]: s for s in spans
                   if s["name"] == "coord.insert_batch"}
        assert len(parents) == 4
        for name in ("coord.route_and_key", "coord.fanout"):
            kids = [s for s in spans if s["name"] == name]
            assert len(kids) == 4
            for s in kids:
                assert s["dur"] <= parents[s["parent"]]["dur"]
    finally:
        _close(ix, plain)
