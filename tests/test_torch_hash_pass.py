"""The port's hash-and-resolve pass (``lsh_hash_resolve``) and the
engine's device-resident hash pass against the JAX package.

* The plain pass (``repro_torch.kernels.ref.lsh_hash_resolve``, what
  ``ops`` runs on a CPU tensor): its keys against the Pallas kernel
  ``repro.kernels.lsh_hash.lsh_hash`` in interpret mode, its slots
  against a dict that takes the same updates, over B in {1, 255, 1000},
  d in {1, 10, 54}, t in {1, 10} and the directory cases of
  ``tests/torch_dir_cases.py``: empty, a tombstone in every probe chain,
  an erase then a reinsert with reused slots (and an erase and reinsert
  netted into one update), growth across a flush, one new key repeated
  across a batch.
* ``SoADynamicDBSCAN(use_device=True, device="cpu")``, whose hash pass
  probes a mirror of the bucket directory and resolves only the misses on
  the host, beside the reference's ``use_device="interpret"`` engine and
  the port's host ``soa`` engine, over a stream of insert batches, batch
  deletes that empty buckets (their slots are freed and reused), single
  deletes and a snapshot restored mid-stream.  After every call the ids,
  deltas, labels, ``state_dict`` arrays and each row's slots are equal,
  and a fresh mirror (with its pending updates) holds the host directory.

Tolerance: zero — every value is an integer and must be identical.  On
the CPU no kernel launches.  The CUDA kernel is held against the plain
pass on the card in ``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_dir_cases as cases  # noqa: E402
from repro.api.backends import SoAIndex as JaxSoAIndex  # noqa: E402
from repro.api.config import ClusterConfig as JaxClusterConfig  # noqa: E402
from repro.core.soa import SoADynamicDBSCAN as JaxSoA  # noqa: E402
from repro.data import blobs  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.api import ClusterConfig, restore_index  # noqa: E402
from repro_torch.api.backends import SoAIndex  # noqa: E402
from repro_torch.core.soa import DeviceHashPass, SoADynamicDBSCAN  # noqa: E402
from repro_torch.kernels import lsh_hash, ops, ref  # noqa: E402

SHAPES = [(n, d, t) for n in (1, 255, 1000) for d in (1, 10, 54)
          for t in (1, 10)]


@functools.lru_cache(maxsize=None)
def _batch(n, d, t):
    """The batch and its keys from the Pallas kernel in interpret mode."""
    x, eta, mixers = cases.batch(n, d, t, n * 100 + d * 10 + t)
    keys = np.asarray(jax_ops.lsh_hash(
        jnp.asarray(x), jnp.asarray(eta), jnp.asarray(mixers),
        inv_cell=cases.INV_CELL, impl="pallas_interpret"))
    return x, eta, mixers, keys


@pytest.mark.parametrize("case", cases.CASES)
@pytest.mark.parametrize("n,d,t", SHAPES)
def test_plain_pass_matches_jax_keys_and_dict(n, d, t, case):
    x, eta, mixers, keys = _batch(n, d, t)
    eta_t, mix_t = torch.from_numpy(eta), torch.from_numpy(mixers)
    steps = cases.scenario(case, keys, n + d + t)
    outs, table = cases.run(
        steps, torch.from_numpy(x),
        lambda xs, upd, tab: ops.lsh_hash_resolve(
            xs, eta_t, mix_t, inv_cell=cases.INV_CELL, directory=tab,
            updates=upd))
    want, model = cases.expected(steps, keys)
    calls = [s for s in steps if s[0] == "call"]
    assert len(outs) == len(want) == len(calls)
    for out, (_, rows, _upd), slots in zip(outs, calls, want):
        m = len(rows) * t
        assert out.dtype == np.int32 and out.shape == (3 * m,)
        np.testing.assert_array_equal(out[:2 * m].reshape(-1, t, 2),
                                      keys[rows])
        np.testing.assert_array_equal(out[2 * m:].reshape(-1, t), slots)
    assert cases.live(table) == model
    if case == "tombstone":
        assert cases.past_tombstone(table) == len(model) > 0
    if case == "empty":
        assert (outs[0][2 * n * t:] == -1).all()


def test_plain_probe_counts_cells_read():
    table = torch.full((8, 4), -1, dtype=torch.int32)
    table[3] = torch.tensor([3, 0, 0, 5])
    table[4] = torch.tensor([11, 0, 0, -2])   # a tombstone, home 3
    table[5] = torch.tensor([19, 1, 0, 6])    # home 3, two cells on
    q = torch.tensor([3, 19, 27, 4], dtype=torch.int32)
    found, steps = ref.probe(table, torch.zeros(4, dtype=torch.int32), q,
                             torch.tensor([0, 1, 0, 0], dtype=torch.int32))
    assert found.tolist() == [3, 5, -1, -1]
    assert steps.tolist() == [1, 3, 4, 3]


def test_pass_writes_into_a_larger_out_buffer():
    x, eta, mixers, keys = _batch(255, 10, 10)
    args = (torch.from_numpy(x), torch.from_numpy(eta),
            torch.from_numpy(mixers))
    upd = torch.from_numpy(cases.scenario("growth", keys, 1)[-1][2])
    tabs = [torch.full((4096, 4), -1, dtype=torch.int32) for _ in range(2)]
    buf = torch.full((3 * 2550 + 9,), -7, dtype=torch.int32)
    got = ops.lsh_hash_resolve(*args, inv_cell=cases.INV_CELL,
                               directory=tabs[0], updates=upd, out=buf)
    assert got.data_ptr() == buf.data_ptr() and got.shape == (3 * 2550,)
    assert bool((buf[3 * 2550:] == -7).all())
    # impl="ref" runs the plain version on any device
    want = ops.lsh_hash_resolve(*args, inv_cell=cases.INV_CELL,
                                directory=tabs[1], updates=upd, impl="ref")
    assert torch.equal(got, want)
    assert cases.live(tabs[0]) == cases.live(tabs[1])


def test_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        lsh_hash.lsh_hash_resolve(
            torch.zeros((4, 2)), torch.zeros(3),
            torch.ones((2, 3, 2), dtype=torch.int32), inv_cell=1.0,
            directory=torch.full((8, 4), -1, dtype=torch.int32),
            updates=torch.zeros((0, 4), dtype=torch.int32))


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert sa[key].dtype == sb[key].dtype, key
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    # each live point's slots: the directory allocated in the same order
    for i, r in a._row.items():
        np.testing.assert_array_equal(a._slots[r], b._slots[b._row[i]])


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("orphans", [True, False])
def test_hash_pass_stream_matches_reference(seed, orphans):
    rng = np.random.default_rng(seed + 80)
    X, _ = blobs(n=700, d=4, n_clusters=5, cluster_std=0.35, seed=seed)
    args = dict(d=4, k=6, t=8, eps=0.4, seed=seed, attach_orphans=orphans)
    eng = dict(seed=seed, attach_orphans=orphans)
    ref_idx = JaxSoAIndex(JaxClusterConfig(backend="soa-device", **args),
                          JaxSoA(4, 6, 8, 0.4, use_device="interpret",
                                 **eng))
    cfg = ClusterConfig(backend="soa-device", **args)
    dev = SoAIndex(cfg, SoADynamicDBSCAN(4, 6, 8, 0.4, use_device=True,
                                         device="cpu", **eng))
    host = SoAIndex(cfg.replace(backend="soa"),
                    SoADynamicDBSCAN(4, 6, 8, 0.4, **eng))
    idxs = [ref_idx, dev, host]
    for i in idxs:
        i.drain_deltas()
    ops.reset_launch_counts()
    alive, reused, restored = [], 0, False

    def check():
        deltas = [sorted(i.drain_deltas()) for i in idxs]
        assert deltas[0] == deltas[1] == deltas[2]
        labels = [i.labels() for i in idxs]
        assert labels[0] == labels[1] == labels[2]
        _assert_same_state(ref_idx.engine, dev.engine)
        _assert_same_state(ref_idx.engine, host.engine)
        dev.engine._hpass.check(dev.engine._dir)

    pos, step = 0, 0
    while pos < len(X):
        chunk = X[pos:pos + int(rng.integers(1, 70))]
        pos += len(chunk)
        free0 = len(dev.engine._free_slots)
        got = [i.insert_batch(chunk) for i in idxs]
        assert got[0] == got[1] == got[2]
        reused += free0 - len(dev.engine._free_slots)
        alive.extend(got[0])
        check()
        step += 1
        if step % 3 == 0 and len(alive) > 60:
            # a contiguous run of ids: whole buckets empty, slots freed
            at = int(rng.integers(len(alive) - 40))
            dels = alive[at:at + int(rng.integers(10, 40))]
            del alive[at:at + len(dels)]
            free0 = len(dev.engine._free_slots)
            for i in idxs:
                i.delete_batch(dels)
            assert len(dev.engine._free_slots) > free0
            assert dev.engine._hpass.fresh and dev.engine._hpass.pending
            check()
        if step % 4 == 1 and len(alive) > 40:
            victim = alive.pop(int(rng.integers(len(alive))))
            for i in idxs:
                i.delete(victim)
            check()
        if step == 8:
            snaps = [i.snapshot() for i in idxs]
            fresh = JaxSoAIndex(ref_idx.cfg, JaxSoA(
                4, 6, 8, 0.4, use_device="interpret", **eng))
            fresh.restore(snaps[0])
            dev = restore_index(snaps[0], device="cpu")
            host = restore_index(snaps[2])
            ref_idx = fresh
            idxs = [ref_idx, dev, host]
            assert not dev.engine._hpass.fresh
            restored = True
            check()
    assert restored and reused > 0
    for i in idxs:
        i.check_invariants()
    assert dev.engine._hpass.n_dir_uploads >= 1
    # the CPU device path ran the plain versions: no kernel launched
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert not any(ops.entry_launch_counts().values())


def test_mirror_goes_stale_only_through_the_seam(monkeypatch):
    """An insert-only stream uploads the whole directory only when the
    table grows, and every pass allocates nothing else; deletes reach
    the mirror as pending erases, a restore as one upload.  With the seam
    cut, nothing reaches the mirror."""
    X, _ = blobs(n=3000, d=10, n_clusters=10, seed=5)
    eng = SoADynamicDBSCAN(10, 10, 10, 0.75, seed=5, use_device=True,
                           device="cpu")
    hp = eng._hpass
    caps = set()
    for b in range(0, 2400, 100):
        eng.add_batch(X[b:b + 100])
        assert hp.fresh and all(s >= 0 for s in hp.pending.values())
        assert hp.n_dir_uploads == hp.n_dir_growths
        caps.add(hp.cap)
        hp.check(eng._dir)
    assert hp.n_passes == 24 and hp.n_dir_growths >= 1 and len(caps) > 1
    uploads = hp.n_dir_uploads
    ids = sorted(eng._row)
    eng.delete_batch(ids[:200])
    eng.delete_point(ids[300])
    assert hp.fresh and any(s == -1 for s in hp.pending.values())
    hp.check(eng._dir)
    eng.add_batch(X[2400:2500])
    # the erases went with that pass; what is pending is its misses
    assert hp.n_dir_uploads == uploads
    assert all(s >= 0 for s in hp.pending.values())
    hp.check(eng._dir)
    rest = SoADynamicDBSCAN(10, 10, 10, 0.75, seed=5, use_device=True,
                            device="cpu")
    rest.load_state_dict(eng.state_dict())
    assert not rest._hpass.fresh
    rest.add_batch(X[2500:2600])
    assert rest._hpass.n_dir_uploads == 1 and rest._hpass.fresh
    rest.check_invariants()
    # the seam cut: no change of the host directory reaches the mirror
    cut = SoADynamicDBSCAN(10, 10, 10, 0.75, seed=5, use_device=True,
                           device="cpu")
    monkeypatch.setattr(cut, "_dir_changed", lambda *a, **kw: None)
    cut.add_batch(X[:100])
    assert not cut._hpass.pending
    cut2 = SoADynamicDBSCAN(10, 10, 10, 0.75, seed=5, use_device=True,
                            device="cpu")
    monkeypatch.setattr(cut2, "_dir_changed", lambda *a, **kw: None)
    cut2.load_state_dict(eng.state_dict())
    assert cut2._hpass.fresh and not cut2._hpass.pending


def test_hash_pass_holds_no_stale_rows_between_batches():
    """Two passes of different sizes through one DeviceHashPass: buffers
    grow by doubling, a smaller batch reuses them, and every pass returns
    the keys of its own points."""
    x, eta, mixers, keys = _batch(1000, 10, 10)
    hp = DeviceHashPass(torch.device("cpu"), torch.from_numpy(eta),
                        torch.from_numpy(mixers), cases.INV_CELL)
    empty = [dict() for _ in range(10)]
    k1, s1 = hp.run(x.astype(np.float64), empty)
    bufs = (hp._in_d, hp._out_d)
    k2, s2 = hp.run(x[:255].astype(np.float64), empty)
    assert hp._in_d is bufs[0] and hp._out_d is bufs[1]
    np.testing.assert_array_equal(k1, keys)
    np.testing.assert_array_equal(k2, keys[:255])
    assert (s1 == -1).all() and (s2 == -1).all()
