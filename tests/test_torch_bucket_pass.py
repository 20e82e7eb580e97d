"""The port's fused insert pass (``bucket_insert_pass``) and the engine's
device-resident stats pass against the JAX package.

* The plain pass (``repro_torch.kernels.ref.bucket_insert_pass``, what
  ``ops`` runs on a CPU tensor) against the Pallas kernels in interpret
  mode composed as the reference engine composes them:
  ``slot_counts``, the add on the host, then ``bucket_core_stats`` on the
  new sizes.  Two successive calls on one table, so the carried sizes are
  checked too; ids outside the table (on the range where the TPU kernels
  drop them, see ``tests/test_torch_kernels.py``) included.  The masked
  two-table route (the sampled-core engine's) against the reference
  engine's three calls, with random, all-false and all-true masks.
* ``SoADynamicDBSCAN(use_device=True, device="cpu")``, whose insert
  passes keep a mirror of the size table on the device, beside the
  reference's ``use_device="interpret"`` engine and the port's host
  ``soa`` engine, over a stream of insert batches, ``delete_batch``,
  single deletes, a ``delete_batch`` holding a missing id and a snapshot
  restored mid-stream.  After every call the labels, compacted deltas and
  ``state_dict`` arrays are equal, and a fresh mirror equals the host
  sizes.

Tolerance: zero — every value is an integer and must be identical.  On
the CPU no kernel launches.  The CUDA kernel is held against the plain
pass on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api.backends import SoAIndex as JaxSoAIndex  # noqa: E402
from repro.api.config import ClusterConfig as JaxClusterConfig  # noqa: E402
from repro.core.soa import SoADynamicDBSCAN as JaxSoA  # noqa: E402
from repro.data import blobs  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.api import ClusterConfig, restore_index  # noqa: E402
from repro_torch.api.backends import SoAIndex  # noqa: E402
from repro_torch.core.soa import SoADynamicDBSCAN  # noqa: E402
from repro_torch.kernels import bucket_ops, ops, ref  # noqa: E402

BUCKET_SHAPES = [(1, 1, 1), (7, 3, 5), (203, 7, 37), (256, 8, 128),
                 (301, 10, 513)]


def _slots(n, t, nb, seed):
    """Ids in [-pad, nb + 9): the range on which the Pallas kernels drop
    an out-of-range id (pad = -nb % 128)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-(-nb % 128), nb + 9, (n, t)).astype(np.int32)


def _jax_pass(slots, sizes, k):
    """The reference engine's composition: histogram, host add, gather."""
    delta = np.asarray(jax_ops.slot_counts(
        jnp.asarray(slots), n_slots=len(sizes), impl="pallas_interpret"))
    sizes += delta
    supp, _core = jax_ops.bucket_core_stats(
        jnp.asarray(slots), jnp.asarray(sizes), k=k,
        impl="pallas_interpret")
    return np.concatenate([sizes, np.asarray(supp)])


@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("n,t,nb", BUCKET_SHAPES)
def test_plain_pass_matches_jax(n, t, nb, k):
    rng = np.random.default_rng(n * 7 + nb + k)
    table = rng.integers(0, 6, nb).astype(np.int32)
    want_sizes = table.copy()
    sizes = torch.from_numpy(table.copy())
    for call in range(2):  # the second call carries the first's sizes
        slots = _slots(n, t, nb, n * 13 + nb + call)
        want = _jax_pass(slots, want_sizes, k)
        got = ops.bucket_insert_pass(torch.from_numpy(slots), sizes, k=k)
        assert got.dtype == torch.int32 and got.shape == (nb + n,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(sizes.numpy(), want_sizes)


def _jax_masked_pass(slots, mask, sizes, core_sizes, k, impl):
    """The reference sampled-core engine's three calls
    (``repro/core/approx.py``, ``_batch_stats``): histogram of every row
    into ``sizes``, histogram of the masked rows into ``core_sizes``
    (nothing when no row is masked: the reference's Pallas path cannot
    take a block of zero rows, and the sum of nothing is zero), then the
    support of every row against the new ``core_sizes``."""
    n_slots = len(sizes)
    sizes += np.asarray(jax_ops.slot_counts(
        jnp.asarray(slots), n_slots=n_slots, impl=impl))
    rows = np.nonzero(mask)[0]
    if len(rows):
        core_sizes += np.asarray(jax_ops.slot_counts(
            jnp.asarray(slots[rows]), n_slots=n_slots, impl=impl))
    supp, _core = jax_ops.bucket_core_stats(
        jnp.asarray(slots), jnp.asarray(core_sizes), k=k, impl=impl)
    return np.concatenate([sizes, core_sizes, np.asarray(supp)])


MASKS = ["random", "none", "all"]


def _mask(kind, n, seed):
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "all":
        return np.ones(n, bool)
    return np.random.default_rng(seed).random(n) < 0.3


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,t,nb", BUCKET_SHAPES)
def test_masked_plain_pass_matches_jax(n, t, nb, kind, impl):
    """The masked two-table route of the plain pass against the
    reference's three calls, twice in a row on one pair of tables.  In
    interpret mode the ids run over [-pad, nb + 9), where the Pallas
    kernels drop an out-of-range id; ``repro.kernels.ref`` wraps a
    negative id like numpy indexing (ROADMAP, Queue 3), so against it
    the ids stay in range."""
    rng = np.random.default_rng(n * 5 + nb)
    k = int(rng.integers(1, 5))
    sizes_np = rng.integers(0, 6, nb).astype(np.int32)
    core_np = (sizes_np * rng.random(nb)).astype(np.int32)
    sizes, core = torch.from_numpy(sizes_np.copy()), \
        torch.from_numpy(core_np.copy())
    for call in range(2):  # the second call carries the first's tables
        slots = (_slots(n, t, nb, n * 11 + nb + call) if impl != "ref"
                 else np.random.default_rng(call).integers(
                     0, nb, (n, t)).astype(np.int32))
        mask = _mask(kind, n, n + call)
        want = _jax_masked_pass(slots, mask, sizes_np, core_np, k, impl)
        for mdt in (torch.bool, torch.uint8):
            a, c = sizes.clone(), core.clone()
            got = ops.bucket_insert_pass(
                torch.from_numpy(slots), a, k=k, core_sizes=c,
                row_mask=torch.from_numpy(mask).to(mdt))
            assert got.dtype == torch.int32 and got.shape == (2 * nb + n,)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(a.numpy(), sizes_np)
            np.testing.assert_array_equal(c.numpy(), core_np)
        sizes, core = a, c


def test_masked_pass_with_every_row_equals_one_table_pass():
    """An all-true mask on a core table equal to the sizes: both tables
    come out as the one-table pass's sizes, with its support."""
    slots = torch.from_numpy(_slots(90, 6, 40, 3))
    table = torch.arange(40, dtype=torch.int32) % 7
    a, b, c = table.clone(), table.clone(), table.clone()
    one = ops.bucket_insert_pass(slots, a, k=5)
    two = ops.bucket_insert_pass(slots, b, k=5, core_sizes=c,
                                 row_mask=torch.ones(90, dtype=torch.bool))
    assert torch.equal(two[:40], one[:40]) and torch.equal(two[40:80],
                                                           one[:40])
    assert torch.equal(two[80:], one[40:])
    with pytest.raises(ValueError, match="come together"):
        ops.bucket_insert_pass(slots, a, k=5, core_sizes=c)
    with pytest.raises(ValueError, match="come together"):
        ops.bucket_insert_pass(slots, a, k=5,
                               row_mask=torch.ones(90, dtype=torch.bool))


def test_pass_writes_into_a_larger_out_buffer():
    slots = torch.from_numpy(_slots(40, 4, 9, 1))
    a, b = torch.arange(9, dtype=torch.int32), torch.arange(9,
                                                            dtype=torch.int32)
    buf = torch.full((100,), -7, dtype=torch.int32)
    got = ops.bucket_insert_pass(slots, a, k=4, out=buf)
    assert got.data_ptr() == buf.data_ptr() and got.shape == (49,)
    assert torch.equal(got, ref.bucket_insert_pass(slots, b, 4))
    assert torch.equal(a, b)
    assert bool((buf[49:] == -7).all())
    # the plain version is what impl="ref" runs on any device
    assert torch.equal(ops.bucket_insert_pass(slots, a.clone(), k=4,
                                              impl="ref"),
                       ops.bucket_insert_pass(slots, b.clone(), k=4))


def test_cuda_wrapper_rejects_cpu_tensors():
    s = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bucket_ops.bucket_insert_pass(s, torch.zeros(3, dtype=torch.int32),
                                      k=1)


def test_cuda_wrapper_rejects_a_cpu_masked_pass():
    s = torch.zeros((4, 2), dtype=torch.int32)
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bucket_ops.bucket_insert_pass(s, z, k=1, core_sizes=z.clone(),
                                      row_mask=torch.ones(4,
                                                          dtype=torch.bool))


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert sa[key].dtype == sb[key].dtype, key
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


def _assert_mirror(engine):
    """A fresh mirror equals the host sizes ``[:ns]`` and is zero past."""
    dp, ns = engine._dpass, engine._n_slots
    if dp.fresh:
        mirror = dp.sizes.numpy()
        np.testing.assert_array_equal(mirror[:ns], engine._bsize[:ns])
        assert not mirror[ns:].any()


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("orphans", [True, False])
def test_device_pass_stream_matches_reference(seed, orphans):
    rng = np.random.default_rng(seed + 70)
    X, _ = blobs(n=500, d=4, n_clusters=4, cluster_std=0.3, seed=seed)
    args = dict(d=4, k=8, t=8, eps=0.45, seed=seed, attach_orphans=orphans)
    ref_idx = JaxSoAIndex(
        JaxClusterConfig(backend="soa-device", **args),
        JaxSoA(4, 8, 8, 0.45, seed=seed, attach_orphans=orphans,
               use_device="interpret"))
    cfg = ClusterConfig(backend="soa-device", **args)
    dev = SoAIndex(cfg, SoADynamicDBSCAN(
        4, 8, 8, 0.45, seed=seed, attach_orphans=orphans, use_device=True,
        device="cpu"))
    host = SoAIndex(cfg.replace(backend="soa"), SoADynamicDBSCAN(
        4, 8, 8, 0.45, seed=seed, attach_orphans=orphans))
    idxs = [ref_idx, dev, host]
    for i in idxs:
        i.drain_deltas()
    ops.reset_launch_counts()
    n_inserts = 0
    stale_then_insert = 0
    alive = []

    def check():
        deltas = [sorted(i.drain_deltas()) for i in idxs]
        assert deltas[0] == deltas[1] == deltas[2]
        labels = [i.labels() for i in idxs]
        assert labels[0] == labels[1] == labels[2]
        _assert_same_state(ref_idx.engine, dev.engine)
        _assert_same_state(ref_idx.engine, host.engine)
        _assert_mirror(dev.engine)

    pos, step = 0, 0
    while pos < len(X):
        b = int(rng.integers(1, 60))
        chunk = X[pos:pos + b]
        pos += b
        stale_then_insert += not dev.engine._dpass.fresh
        got = [i.insert_batch(chunk) for i in idxs]
        assert got[0] == got[1] == got[2]
        n_inserts += 1
        alive.extend(got[0])
        check()
        assert dev.engine._dpass.fresh
        step += 1
        if step % 3 == 0 and len(alive) > 40:
            dels = [alive.pop(int(rng.integers(len(alive))))
                    for _ in range(int(rng.integers(2, 15)))]
            for i in idxs:
                i.delete_batch(dels)
            assert not dev.engine._dpass.fresh
            check()
        if step % 4 == 1 and len(alive) > 40:
            victim = alive.pop(int(rng.integers(len(alive))))
            for i in idxs:
                i.delete(victim)
            check()
        if step == 5:
            # a missing id: the prefix before it is deleted, then KeyError
            dels = [alive.pop(), alive.pop(), 10**9, alive[-1]]
            for i in idxs:
                with pytest.raises(KeyError):
                    i.delete_batch(dels)
            check()
        if step == 7:
            # snapshot -> restore mid-stream; the device engine restores
            # the reference's snapshot, which the port reads as its own
            snaps = [i.snapshot() for i in idxs]
            fresh = JaxSoAIndex(ref_idx.cfg, JaxSoA(
                4, 8, 8, 0.45, seed=seed, attach_orphans=orphans,
                use_device="interpret"))
            fresh.restore(snaps[0])
            dev = restore_index(snaps[0], device="cpu")
            host = restore_index(snaps[2])
            ref_idx = fresh
            idxs = [ref_idx, dev, host]
            assert dev.engine.use_device and not dev.engine._dpass.fresh
            assert not host.engine.use_device
            check()
    assert step > 7 and n_inserts == step
    for i in idxs:
        i.check_invariants()
    # every stale mirror was uploaded once, by the insert that followed
    assert stale_then_insert >= 3
    # the CPU device path ran the plain versions: no kernel launched
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert not any(ops.entry_launch_counts().values())


def test_mirror_goes_stale_only_through_the_seam():
    """An insert-only stream uploads no sizes; each host change of the
    sizes outside the insert pass (batch delete, single delete, restore)
    costs one upload at the next insert.  The mirror grows by doubling
    with the slot directory and stays fresh."""
    X, _ = blobs(n=1200, d=4, n_clusters=6, cluster_std=0.3, seed=5)
    eng = SoADynamicDBSCAN(4, 8, 8, 0.45, seed=5, use_device=True,
                           device="cpu")
    dp = eng._dpass
    for b in range(0, 900, 100):
        eng.add_batch(X[b:b + 100])
        _assert_mirror(eng)
    assert dp.n_passes == 9 and dp.n_size_uploads == 0 and dp.fresh
    assert eng._n_slots > 256 and dp.sizes.numel() >= eng._n_slots
    ids = sorted(eng._row)
    eng.delete_batch(ids[:30])
    assert not dp.fresh
    eng.add_batch(X[900:1000])
    assert dp.n_size_uploads == 1 and dp.fresh
    _assert_mirror(eng)
    eng.delete_point(ids[40])
    assert not dp.fresh
    eng.add_batch(X[1000:1100])
    assert dp.n_size_uploads == 2
    _assert_mirror(eng)
    rest = SoADynamicDBSCAN(4, 8, 8, 0.45, seed=5, use_device=True,
                            device="cpu")
    rest.load_state_dict(eng.state_dict())
    assert not rest._dpass.fresh
    rest.add_batch(X[1100:])
    assert rest._dpass.n_size_uploads == 1
    _assert_mirror(rest)
    rest.check_invariants()
