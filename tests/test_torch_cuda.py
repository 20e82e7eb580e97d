"""The port on the card: each CUDA kernel against its plain PyTorch
version, the ``soa-device`` engine on ``cuda`` against the host ``soa``
engine, the sampled-core engine's device path on ``cuda`` against its
host twin, ``batched-device`` on ``cuda`` against ``batched-device`` on
the CPU, ``sharded`` over ``soa-device`` shards on ``cuda`` (in process
and in worker processes) against the same index on the CPU, the dense
LM's prefill (through the flash-attention kernel) against its decode,
and the bf16 prefill of a hybrid and an encoder-decoder model through
the kernel against the same forward with the plain attention, and
``chip_smoke.py``'s phase 14 (the analysis and the five
``examples/torch_*.py``, the clustering ones on the card against the
CPU).
Tolerance zero for the integer kernels (for ``eps_neighbor_counts``
because the kernel and its plain version round every f32 product and
sum in the same order).  ``flash_attention`` sums
in another f32 order than its plain version: atol = rtol = 2e-5 in
float32 (``tests/test_kernels.py``'s tolerance); in bfloat16 it is held
against the plain version run on the f32 upcast of the same inputs and
rounded to bf16, within one bf16 ulp (atol = rtol = 2^-7); bf16 runs on
the tensor cores (``flash_attention_sm90``), f32 on the CUDA cores.
Under autograd the bf16 forward also stores each row's log-sum-exp and
the backward runs ``attention_bwd_sm90``: dq, dk, dv against the f32
gradient of the same bf16 inputs no worse than the plain bf16 gradient
(``attention_vjp``); f32 keeps ``attention_vjp``: dq, dk, dv equal
autograd through ``ref.attention`` within 2e-5.  A training step of the
smoke granite model launches the forward twice per layer (the remat
recompute) and the backward kernel once.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor ``repro``, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dir_cases as dir_cases  # noqa: E402
from repro_torch.api import (ClusterConfig, build_index,  # noqa: E402
                             restore_index)
from repro_torch.data import blobs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

LSH_SHAPES = [(64, 4, 3), (200, 16, 10), (33, 7, 5), (256, 20, 8),
              (1000, 10, 10)]
BUCKET_SHAPES = [(1, 1, 1), (7, 3, 5), (203, 7, 37), (256, 8, 128),
                 (301, 10, 513), (1000, 10, 70000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _slots(n, t, nb, seed):
    """Ids in [-3, nb + 3): in range and out of range on both sides."""
    rng = np.random.default_rng(seed)
    return rng.integers(-3, nb + 3, (n, t)).astype(np.int32)


@pytest.mark.parametrize("n,d,t", LSH_SHAPES)
def test_lsh_hash_matches_plain(cuda, n, d, t):
    rng = np.random.default_rng(n + d + t)
    x = torch.from_numpy((rng.normal(size=(n, d)) * 300).astype(
        np.float32)).to(cuda)
    eta = torch.from_numpy(rng.uniform(0, 1.5, size=(t,)).astype(
        np.float32)).to(cuda)
    mixers = torch.from_numpy(rng.integers(1, 2**31 - 1, size=(2, t, d))
                              .astype(np.int32) | 1).to(cuda)
    ops.reset_launch_counts()
    got = ops.lsh_hash(x, eta, mixers, inv_cell=1 / 1.5)
    want = ops.lsh_hash(x, eta, mixers, inv_cell=1 / 1.5, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts()["lsh_hash"] == 1
    assert torch.equal(got, want)
    # the plain version on the card equals the plain version on the CPU
    assert torch.equal(want.cpu(), ops.lsh_hash(
        x.cpu(), eta.cpu(), mixers.cpu(), inv_cell=1 / 1.5))


@pytest.mark.parametrize("case", dir_cases.CASES)
@pytest.mark.parametrize("n,d,t", [(n, d, t) for n in (1, 255, 1000)
                                   for d in (1, 10, 54) for t in (1, 10)])
def test_lsh_hash_resolve_matches_plain(cuda, n, d, t, case):
    """The hash-and-resolve pass against its plain version through the
    directory cases of ``tests/torch_dir_cases.py`` (empty, a tombstone in
    every probe chain, erase and reinsert with reused slots, growth
    across a flush, one new key repeated across a batch); (1000, 10, 10)
    is the main path's batch.  Every call's keys and slots are equal, and
    so are the two tables' live cells at the end.  One launch a call,
    counted under ``lsh_hash``."""
    x, eta, mixers = (torch.from_numpy(a).to(cuda) for a in
                      dir_cases.batch(n, d, t, n * 100 + d * 10 + t))
    keys = ops.lsh_hash(x, eta, mixers, inv_cell=dir_cases.INV_CELL,
                        impl="ref").cpu().numpy()
    steps = dir_cases.scenario(case, keys, n + d + t)
    ops.reset_launch_counts()
    got, table = dir_cases.run(steps, x, lambda xs, upd, tab:
                               ops.lsh_hash_resolve(
                                   xs, eta, mixers,
                                   inv_cell=dir_cases.INV_CELL,
                                   directory=tab, updates=upd))
    torch.cuda.synchronize()
    calls = sum(s[0] == "call" for s in steps)
    assert ops.launch_counts()["lsh_hash"] == calls
    assert ops.entry_launch_counts()["lsh_hash_resolve"] == calls
    assert ops.entry_launch_counts()["lsh_hash"] == 0
    want, table_ref = dir_cases.run(steps, x, lambda xs, upd, tab:
                                    ops.lsh_hash_resolve(
                                        xs, eta, mixers,
                                        inv_cell=dir_cases.INV_CELL,
                                        directory=tab, updates=upd,
                                        impl="ref"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert dir_cases.live(table) == dir_cases.live(table_ref)
    if case == "tombstone":
        assert dir_cases.past_tombstone(table) == len(
            dir_cases.live(table))


@pytest.mark.parametrize("n,t,nb", BUCKET_SHAPES)
def test_bucket_kernels_match_plain(cuda, n, t, nb):
    rng = np.random.default_rng(n + t + nb)
    slots = torch.from_numpy(_slots(n, t, nb, n + nb)).to(cuda)
    sizes = torch.from_numpy(rng.integers(0, 12, nb).astype(np.int32)
                             ).to(cuda)
    ops.reset_launch_counts()
    assert torch.equal(ops.slot_counts(slots, n_slots=nb),
                       ops.slot_counts(slots, n_slots=nb, impl="ref"))
    for k in (1, 3, 9):
        got = ops.bucket_core_stats(slots, sizes, k=k)
        want = ops.bucket_core_stats(slots, sizes, k=k, impl="ref")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"lsh_hash": 0, "slot_counts": 1,
                                   "bucket_core_stats": 3,
                                   "eps_neighbor_counts": 0,
                                   "flash_attention": 0}


@pytest.mark.parametrize("n,t,nb", BUCKET_SHAPES + [(1000, 10, 3756)])
def test_bucket_insert_pass_matches_plain(cuda, n, t, nb):
    """The fused pass against its plain version, twice in a row on one
    size table (the second call starts from the sizes the first left),
    with ids out of range on both sides; the last shape is the main
    path's batch and slot count.  One launch a call, counted under both
    bucket kernels and under its own entry."""
    rng = np.random.default_rng(n * 3 + nb)
    table = torch.from_numpy(rng.integers(0, 12, nb).astype(np.int32))
    a, b = table.to(cuda), table.to(cuda)
    out = torch.full((nb + n + 5,), -1, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    for call in range(2):
        slots = torch.from_numpy(_slots(n, t, nb, n + nb + call)).to(cuda)
        for k in (1, 9):
            got = ops.bucket_insert_pass(slots, a, k=k, out=out)
            want = ops.bucket_insert_pass(slots, b, k=k, impl="ref")
            assert got.shape == (nb + n,)
            assert torch.equal(got, want) and torch.equal(a, b)
    torch.cuda.synchronize()
    assert int(out[nb + n:].min()) == -1  # nothing written past the pass
    counts, entries = ops.launch_counts(), ops.entry_launch_counts()
    assert counts["slot_counts"] == counts["bucket_core_stats"] == 4
    assert entries["bucket_insert_pass"] == 4
    assert entries["slot_counts"] == entries["bucket_core_stats"] == 0
    # the plain version on the card equals the plain version on the CPU
    c = table.clone()
    for call in range(2):
        slots = _slots(n, t, nb, n + nb + call)
        for k in (1, 9):
            ops.bucket_insert_pass(torch.from_numpy(slots), c, k=k)
    assert torch.equal(c, a.cpu())


@pytest.mark.parametrize("kind", ["random", "none", "all"])
@pytest.mark.parametrize("n,t,nb", BUCKET_SHAPES + [(1000, 10, 3756)])
def test_bucket_insert_pass_masked_matches_plain(cuda, n, t, nb, kind):
    """The masked two-table route against its plain version, twice in a
    row on one pair of tables, ids out of range on both sides, random,
    all-false and all-true masks, as bool and as uint8.  One launch a
    call, counted under both bucket kernels and under its own entry."""
    rng = np.random.default_rng(n * 7 + nb)
    table = torch.from_numpy(rng.integers(0, 12, nb).astype(np.int32))
    core = torch.from_numpy((table.numpy() // 2).astype(np.int32))
    a, b = table.to(cuda), table.to(cuda)
    ca, cb = core.to(cuda), core.to(cuda)
    out = torch.full((2 * nb + n + 5,), -1, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    for call in range(2):
        slots = torch.from_numpy(_slots(n, t, nb, n + nb + call)).to(cuda)
        mask = {"random": rng.random(n) < 0.3, "none": np.zeros(n, bool),
                "all": np.ones(n, bool)}[kind]
        for k, mdt in ((1, torch.bool), (9, torch.uint8)):
            m = torch.from_numpy(mask).to(mdt).to(cuda)
            got = ops.bucket_insert_pass(slots, a, k=k, core_sizes=ca,
                                         row_mask=m, out=out)
            want = ops.bucket_insert_pass(slots, b, k=k, core_sizes=cb,
                                          row_mask=m, impl="ref")
            assert got.shape == (2 * nb + n,)
            assert torch.equal(got, want)
            assert torch.equal(a, b) and torch.equal(ca, cb)
    torch.cuda.synchronize()
    assert int(out[2 * nb + n:].min()) == -1  # nothing written past it
    counts, entries = ops.launch_counts(), ops.entry_launch_counts()
    assert counts["slot_counts"] == counts["bucket_core_stats"] == 4
    assert entries["bucket_insert_pass_masked"] == 4
    assert entries["bucket_insert_pass"] == 0
    assert entries["slot_counts"] == entries["bucket_core_stats"] == 0


def test_bucket_insert_pass_masked_rejects_bad_arguments(cuda):
    s = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    z = torch.zeros(3, dtype=torch.int32, device=cuda)
    m = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="come together"):
        ops.bucket_insert_pass(s, z, k=1, core_sizes=z.clone())
    with pytest.raises(ValueError, match="shape"):
        ops.bucket_insert_pass(s, z, k=1, core_sizes=z.clone(),
                               row_mask=m[:3])
    with pytest.raises(ValueError, match="shape"):
        ops.bucket_insert_pass(s, z, k=1, core_sizes=z[:2].clone(),
                               row_mask=m)
    with pytest.raises(TypeError):
        ops.bucket_insert_pass(s, z, k=1, core_sizes=z.clone(),
                               row_mask=m.to(torch.int32))
    with pytest.raises(ValueError, match="at least 10"):
        ops.bucket_insert_pass(s, z, k=1, core_sizes=z.clone(), row_mask=m,
                               out=torch.zeros(9, dtype=torch.int32,
                                               device=cuda))


@pytest.mark.parametrize("d", [1, 3, 4, 10, 16, 20, 54, 64, 96])
@pytest.mark.parametrize("n", [1, 63, 64, 127, 128, 129, 255, 256, 257,
                               1000, 4097, 8193, 20_001])
def test_eps_neighbor_counts_matches_plain(cuda, n, d):
    """Bit-exact against the plain version on the card and, where the
    CPU's plain version is quick (n^2 d <= 2^30), on the CPU: on the edges
    of the kernel's 128-point tiles, on n = 8193, where blocks start
    inside a row of tile pairs and cross to the next, and on d up to the
    whole-d limit (64) and above it (96: k staged in chunks)."""
    rng = np.random.default_rng(n * 100 + d)
    x = (rng.normal(size=(n, d)) * 0.7).astype(np.float32)
    dup = min(3, n - n // 2)
    x[n // 2:n // 2 + dup] = x[:dup]  # duplicated points
    eps = 0.35 * np.sqrt(d)
    xc = torch.from_numpy(x).to(cuda)
    ops.reset_launch_counts()
    got = ops.eps_neighbor_counts(xc, eps=eps)
    want = ops.eps_neighbor_counts(xc, eps=eps, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts()["eps_neighbor_counts"] == 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, want)
    if n * n * d <= 2**30:
        assert torch.equal(want.cpu(), ops.eps_neighbor_counts(
            torch.from_numpy(x), eps=eps))
    assert int(got.min()) >= 1  # every point counts itself


def test_eps_neighbor_counts_on_blobs(cuda):
    X, _ = blobs(n=20_000, d=10, n_clusters=10, seed=0)
    x = torch.from_numpy(X.astype(np.float32)).to(cuda)
    got = ops.eps_neighbor_counts(x, eps=0.75)
    assert torch.equal(got, ops.eps_neighbor_counts(x, eps=0.75,
                                                    impl="ref"))
    assert ops.eps_neighbor_counts(x[:0], eps=0.75).shape == (0,)


def test_wrappers_reject_bad_arguments(cuda):
    s = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.slot_counts(s.to(torch.int64), n_slots=3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bucket_core_stats(s.t(), torch.zeros(3, dtype=torch.int32,
                                                 device=cuda), k=1)
    with pytest.raises(ValueError, match="at least 7"):
        ops.bucket_insert_pass(s, torch.zeros(3, dtype=torch.int32,
                                              device=cuda), k=1,
                               out=torch.zeros(6, dtype=torch.int32,
                                               device=cuda))
    with pytest.raises(TypeError):
        ops.eps_neighbor_counts(torch.zeros((4, 2), dtype=torch.float64,
                                            device=cuda), eps=1.0)
    with pytest.raises(ValueError, match="d >= 1"):
        ops.eps_neighbor_counts(torch.zeros((4, 0), device=cuda), eps=1.0)
    with pytest.raises(ValueError, match="shape"):
        ops.lsh_hash(torch.zeros((4, 2), device=cuda),
                     torch.zeros(3, device=cuda),
                     torch.ones((2, 3, 3), dtype=torch.int32, device=cuda),
                     inv_cell=1.0)
    x, eta = torch.zeros((4, 2), device=cuda), torch.zeros(3, device=cuda)
    mix = torch.ones((2, 3, 2), dtype=torch.int32, device=cuda)
    upd = torch.zeros((0, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="power of"):
        ops.lsh_hash_resolve(x, eta, mix, inv_cell=1.0, updates=upd,
                             directory=torch.full((12, 4), -1,
                                                  dtype=torch.int32,
                                                  device=cuda))
    with pytest.raises(ValueError, match="aligned"):
        ops.lsh_hash_resolve(x, eta, mix, inv_cell=1.0, updates=upd,
                             directory=torch.full((33,), -1,
                                                  dtype=torch.int32,
                                                  device=cuda)[1:].view(8, 4))


@pytest.mark.parametrize("orphans", [True, False])
def test_soa_device_on_cuda_matches_host_soa(cuda, orphans):
    """Inserts, batch and single deletes and a snapshot restored
    mid-stream: the bucket kernels run once per insert batch, through the
    fused pass only, so does ``lsh_hash``, through the hash-and-resolve
    pass only, and the mirrors of the sizes and of the directory stay
    equal to the host's whenever they are fresh."""
    X, _ = blobs(n=3000, d=10, n_clusters=10, seed=1)
    cfg = ClusterConfig(d=10, k=10, t=10, eps=0.75, seed=1,
                        backend="soa-device", attach_orphans=orphans)
    dev = build_index(cfg)
    host = build_index(cfg.replace(backend="soa"))
    assert dev.engine.device.type == "cuda"
    dev.drain_deltas()
    host.drain_deltas()
    ops.reset_launch_counts()
    for b in range(0, len(X), 250):
        assert dev.insert_batch(X[b:b + 250]) == host.insert_batch(
            X[b:b + 250])
        assert sorted(dev.drain_deltas()) == sorted(host.drain_deltas())
        if b % 1000 == 750:
            victims = dev.ids()[::6]
            dev.delete_batch(victims)
            host.delete_batch(victims)
            assert sorted(dev.drain_deltas()) == sorted(host.drain_deltas())
        if b % 1000 == 250:
            for victim in dev.ids()[1::97]:
                dev.delete(victim)
                host.delete(victim)
            assert sorted(dev.drain_deltas()) == sorted(host.drain_deltas())
        if b == 1500:
            dev = restore_index(dev.snapshot())
            assert dev.engine.device.type == "cuda"
            assert not dev.engine._dpass.fresh
            assert dev.drain_deltas() == []  # starts the change feed
        assert dev.labels() == host.labels()
        dev.check_invariants()  # a fresh mirror equals the host sizes
    counts = ops.launch_counts()
    assert counts == {"lsh_hash": 12, "slot_counts": 12,
                      "bucket_core_stats": 12, "eps_neighbor_counts": 0,
                      "flash_attention": 0}
    entries = ops.entry_launch_counts()
    assert entries["bucket_insert_pass"] == entries["lsh_hash_resolve"] == 12
    assert entries["slot_counts"] == entries["bucket_core_stats"] == 0
    assert entries["lsh_hash"] == 0
    dev.check_invariants()
    for key, val in dev.snapshot()["state"].items():
        np.testing.assert_array_equal(val, host.snapshot()["state"][key])


def _feed(index):
    """The change feed in a total order (a rebalanced id shows twice:
    (idx, old, None) from one shard, (idx, None, new) from another)."""
    return sorted(index.drain_deltas(),
                  key=lambda r: tuple(-1 if v is None else v for v in r))


@pytest.mark.parametrize("transport", ["local", "process"])
def test_sharded_soa_device_on_cuda_matches_cpu(cuda, transport):
    """S = 2 shards of ``soa-device`` on the card (in process on a pool
    of two threads, or in two workers spawned with ``--device cuda``)
    against the same sharded index on the CPU: every batch's sorted
    deltas, the labels at every batch, after a rebalance, after deletes
    and after a snapshot restored on the card, with ``check_invariants``
    (device mirrors equal to the host tables).  In process, each shard
    launches ``lsh_hash_resolve`` and ``bucket_insert_pass`` once per
    non-empty sub-batch and no standalone entry; out of process the
    coordinator launches nothing (the workers' launches are their own)."""
    X, _ = blobs(n=4000, d=10, n_clusters=10, seed=2)
    cfg = ClusterConfig(d=10, k=10, t=10, eps=0.75, seed=2,
                        backend="sharded", shards=2,
                        inner_backend="soa-device", transport=transport,
                        workers=2, rpc_timeout_s=30.0)
    dev = build_index(cfg)
    cpu = build_index(cfg.replace(transport="local"), device="cpu")
    back = None
    try:
        if transport == "local":
            assert all(ix.engine.device.type == "cuda" for ix in dev.inners)
        ops.reset_launch_counts()
        sub_batches = 0
        for b in range(0, len(X), 250):
            Xb = X[b:b + 250]
            sub_batches += len(np.unique(dev.router.shards_batch(Xb)))
            assert dev.insert_batch(Xb) == cpu.insert_batch(Xb)
            assert _feed(dev) == _feed(cpu)
            assert dev.labels() == cpu.labels()
        entries = ops.entry_launch_counts()
        want = sub_batches if transport == "local" else 0
        assert entries["lsh_hash_resolve"] == entries[
            "bucket_insert_pass"] == want
        assert entries["lsh_hash"] == entries["slot_counts"] == \
            entries["bucket_core_stats"] == 0
        plan = (0, 2048, 1)
        assert dev.rebalance(plan) == cpu.rebalance(plan)
        assert dev.shard_sizes() == cpu.shard_sizes()
        assert _feed(dev) == _feed(cpu)
        victims = dev.ids()[::4]
        for lo in range(0, len(victims), 250):
            dev.delete_batch(victims[lo:lo + 250])
            cpu.delete_batch(victims[lo:lo + 250])
            assert _feed(dev) == _feed(cpu)
        assert dev.labels() == cpu.labels()
        dev.check_invariants()
        back = restore_index(dev.snapshot(), device="cuda")
        assert back.labels() == cpu.labels()
        back.check_invariants()
        for key, val in back.snapshot()["state"].items():
            np.testing.assert_array_equal(val, cpu.snapshot()["state"][key])
    finally:
        for ix in (dev, cpu, back):
            if ix is not None:
                ix.close()


@pytest.mark.parametrize("rate", [0.3, 1.0])
def test_approx_device_on_cuda_matches_host(cuda, rate):
    """The sampled-core engine's device path on the card (one masked
    ``bucket_insert_pass`` launch an insert batch, against mirrors of
    both size tables) beside its host twin: inserts, batch and single
    deletes and a restore, labels, deltas, state and both tables equal
    at every step, the mirrors equal to the host tables whenever they
    are fresh."""
    from repro_torch.api import ApproxIndex
    from repro_torch.core.approx import SampledCoreDBSCAN

    X, _ = blobs(n=3000, d=10, n_clusters=10, seed=3)
    cfg = ClusterConfig(d=10, k=10, t=10, eps=0.75, seed=3,
                        backend="approx", sample_rate=rate)

    def engine(use_device):
        return SampledCoreDBSCAN(10, 10, 10, 0.75, seed=3,
                                 sample_rate=rate, use_device=use_device,
                                 device="cuda")
    dev = ApproxIndex(cfg, engine(True))
    host = ApproxIndex(cfg, engine(False))
    assert dev.engine._dpass.core_sizes.device.type == "cuda"
    dev.drain_deltas()
    host.drain_deltas()
    ops.reset_launch_counts()
    n_inserts = 0
    for b in range(0, len(X), 250):
        assert dev.insert_batch(X[b:b + 250]) == host.insert_batch(
            X[b:b + 250])
        n_inserts += 1
        assert sorted(dev.drain_deltas()) == sorted(host.drain_deltas())
        if b % 1000 == 750:
            victims = dev.ids()[::6]
            dev.delete_batch(victims)
            host.delete_batch(victims)
            assert sorted(dev.drain_deltas()) == sorted(host.drain_deltas())
        if b % 1000 == 250:
            for victim in dev.ids()[1::97]:
                dev.delete(victim)
                host.delete(victim)
            assert sorted(dev.drain_deltas()) == sorted(host.drain_deltas())
        if b == 1500:
            # a restore numbers the slots anew: restore both
            snap = host.snapshot()
            dev = ApproxIndex(cfg, engine(True))
            dev.restore(snap)
            host = ApproxIndex(cfg, engine(False))
            host.restore(snap)
            dev.drain_deltas()
            host.drain_deltas()
        assert dev.labels() == host.labels()
        ns = host.engine._n_slots
        np.testing.assert_array_equal(dev.engine._bsize[:ns],
                                      host.engine._bsize[:ns])
        np.testing.assert_array_equal(dev.engine._ssize[:ns],
                                      host.engine._ssize[:ns])
        dev.check_invariants()  # fresh mirrors equal both host tables
    entries = ops.entry_launch_counts()
    assert entries["bucket_insert_pass_masked"] == n_inserts
    assert entries["lsh_hash_resolve"] == n_inserts
    assert entries["bucket_insert_pass"] == entries["slot_counts"] == \
        entries["bucket_core_stats"] == entries["lsh_hash"] == 0
    for key, val in dev.snapshot()["state"].items():
        np.testing.assert_array_equal(val, host.snapshot()["state"][key])


def _mixed_stream(n=400, d=4, seed=0, p_delete=0.25):
    """``tests/test_api.py``'s mixed Insert/Delete stream (auto ids)."""
    from repro_torch.api import Delete, Insert

    X, _ = blobs(n=n, d=d, n_clusters=4, cluster_std=0.15, seed=seed)
    rng = np.random.default_rng(seed)
    events, alive, nxt = [], [], 0
    for j in range(n):
        events.append(Insert(X[j]))
        alive.append(nxt)
        nxt += 1
        if rng.random() < p_delete and len(alive) > 10:
            events.append(Delete(alive.pop(int(rng.integers(len(alive))))))
    return events


def _blobs_stream(n=20_000, seed=0):
    """The smoke stream at 20,000 points: inserts in batches of 1000,
    then 25% deleted in batches of 1000, as ``(op, payload)`` steps."""
    X, _ = blobs(n=n, d=10, n_clusters=10, seed=seed)
    victims = np.random.default_rng(seed + 1).permutation(n)[:n // 4]
    return ([("insert", X[b:b + 1000]) for b in range(0, n, 1000)]
            + [("delete", [int(i) for i in victims[b:b + 1000]])
               for b in range(0, len(victims), 1000)])


@pytest.mark.parametrize("stream", ["mixed", "blobs-20k"])
def test_batched_device_on_cuda_matches_cpu(cuda, stream, monkeypatch):
    """``batched-device`` on the card against ``batched-device`` on the
    CPU (the plain ``lsh_hash``): the same handles, deltas in order,
    labels and ``state_dict``; every batch's keys on the card equal the
    plain version's on the same uploaded points, and the standalone
    ``lsh_hash`` entry launches once per insert batch, nothing else."""
    real = ops.lsh_hash
    on_card = []

    def checked(x, eta, mixers, *, inv_cell, impl=None):
        out = real(x, eta, mixers, inv_cell=inv_cell, impl=impl)
        if x.device.type == "cuda" and impl is None:
            on_card.append(x.shape[0])
            assert torch.equal(out, real(x, eta, mixers, inv_cell=inv_cell,
                                         impl="ref"))
        return out

    monkeypatch.setattr(ops, "lsh_hash", checked)
    if stream == "mixed":
        cfg = ClusterConfig(d=4, k=8, t=8, eps=0.45, seed=1)
        events = _mixed_stream(seed=1)
        steps = [("apply", events[s:s + 40])
                 for s in range(0, len(events), 40)]
    else:
        cfg = ClusterConfig(d=10, k=10, t=10, eps=0.75, seed=0)
        steps = _blobs_stream()
    cfg = cfg.replace(backend="batched-device")
    dev = build_index(cfg)
    host = build_index(cfg, device="cpu")
    assert dev.engine.device.type == "cuda"
    assert host.engine.device.type == "cpu"
    dev.drain_deltas()
    host.drain_deltas()
    ops.reset_launch_counts()
    n_insert_batches = 0
    for n, (op, arg) in enumerate(steps):
        if op == "apply":
            assert dev.apply(arg) == host.apply(arg)
            kinds = [type(e).__name__ for e in arg]
            n_insert_batches += sum(
                1 for j, k in enumerate(kinds)
                if k == "Insert" and (j == 0 or kinds[j - 1] != "Insert"))
        elif op == "insert":
            assert dev.insert_batch(arg) == host.insert_batch(arg)
            n_insert_batches += 1
        else:
            dev.delete_batch(arg)
            host.delete_batch(arg)
        assert dev.drain_deltas() == host.drain_deltas()
        if n % 5 == 4 or n == len(steps) - 1:
            assert dev.labels() == host.labels()
    assert len(on_card) == n_insert_batches
    entries = ops.entry_launch_counts()
    assert {k: v for k, v in entries.items() if v} == \
        {"lsh_hash": n_insert_batches}
    assert ops.launch_counts()["lsh_hash"] == n_insert_batches
    assert dev.stats() == host.stats()
    sa, sb = dev.snapshot()["state"], host.snapshot()["state"]
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    dev.check_invariants()
    rest = restore_index(dev.snapshot())
    assert rest.engine.device.type == "cuda"
    assert rest.labels() == dev.labels()


# (b, hq, hkv, sq, skv, dh, causal, window, q_offset): tests/test_kernels.py's
# cases, decode rows, head_dim 16 / 96 / 128 / 256, ragged lengths, windows
# narrower than a tile and wider than the sequence
FLASH_CASES = [
    (1, 2, 2, 64, 64, 32, True, None, 0),
    (2, 4, 2, 128, 128, 64, True, None, 0),
    (1, 4, 1, 96, 96, 32, True, None, 0),
    (1, 2, 2, 64, 64, 32, True, 16, 0),
    (2, 2, 2, 1, 128, 32, True, None, 127),
    (1, 2, 2, 64, 64, 32, False, None, 0),
    (2, 8, 2, 1, 512, 64, True, None, 511),
    (1, 4, 2, 100, 100, 16, True, 32, 0),
    (1, 4, 2, 70, 70, 96, True, None, 0),
    (1, 4, 2, 300, 300, 128, True, 100, 0),
    (2, 4, 2, 33, 161, 128, True, 64, 128),
    (1, 2, 1, 200, 200, 256, True, None, 0),
    (1, 2, 1, 130, 130, 200, False, 40, 0),
    (1, 32, 16, 1100, 1100, 128, True, 1024, 0),
]


def _flash_inputs(case, dtype, dev):
    b, hq, hkv, sq, skv, dh = case[:6]
    rng = np.random.default_rng(hq * sq + skv + dh)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dev).to(dtype)
            for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                          (b, hkv, skv, dh))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_plain_f32(cuda, case):
    *_, causal, window, q_off = case
    q, k, v = _flash_inputs(case, torch.float32, cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    got = ops.attention(q, k, v, causal=causal, window=window, q_offset=q_off)
    want = ops.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_off, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# bf16 cases of the tensor-core route: the padding path (dh 36), decode
# rows and sq = 33 with q_offset > 0, windows of 127 / 128 / 129 at the
# 128-key tile's edge, skv not a multiple of 128 (causal and not), the
# dh-256 bucket, and gemma3-27b's prefill shape (window and global)
BF16_CASES = [
    (1, 4, 2, 77, 77, 36, True, None, 0),
    (2, 3, 1, 50, 90, 36, True, 16, 40),
    (2, 8, 2, 1, 300, 128, True, None, 299),
    (1, 4, 2, 1, 1000, 64, True, 256, 999),
    (1, 4, 2, 33, 200, 64, True, None, 167),
    (2, 4, 2, 33, 161, 128, True, 64, 128),
    (1, 2, 1, 384, 384, 128, True, 127, 0),
    (1, 2, 1, 384, 384, 128, True, 128, 0),
    (1, 2, 1, 384, 384, 128, True, 129, 0),
    (1, 4, 2, 200, 333, 128, False, None, 0),
    (1, 4, 2, 200, 333, 128, True, None, 133),
    (1, 2, 1, 150, 150, 256, True, 100, 0),
    (1, 32, 16, 4096, 4096, 128, True, 1024, 0),
    (1, 32, 16, 4096, 4096, 128, True, None, 0),
]


def _check_bf16(case, dev):
    """The bf16 kernel against the plain version of the f32 upcast,
    rounded to bf16, within one ulp; it must take the tensor-core
    route."""
    *_, causal, window, q_off = case
    q, k, v = _flash_inputs(case, torch.bfloat16, dev)
    ops.reset_launch_counts()
    got = ops.attention(q, k, v, causal=causal, window=window, q_offset=q_off)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.entry_launch_counts()["flash_attention_sm90"] == 1
    want = ops.attention(q.float(), k.float(), v.float(), causal=causal,
                         window=window, q_offset=q_off, impl="ref")
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               atol=2 ** -7, rtol=2 ** -7)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_plain_bf16(cuda, case):
    _check_bf16(case, cuda)


@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_flash_attention_tensor_core_route(cuda, case):
    _check_bf16(case, cuda)


def test_flash_attention_rejects_bad_arguments(cuda):
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    k = torch.zeros((1, 3, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        ops.attention(q, k, k)
    with pytest.raises(TypeError):
        ops.attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 1, 4, 300), device=cuda)
        ops.attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q.transpose(2, 3), q, q)


def test_lm_prefill_matches_decode_on_card(cuda):
    """gemma3-27b's smoke config cut to 6 layers at float32: prefill logits
    (six flash-attention launches) equal teacher-forced decode logits
    (plain torch) past the 32-token window."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3-27b").smoke(), n_layers=6,
                              dtype="float32")
    m = build_model(cfg)
    p = m.init(3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 80))).to(cuda)
    ops.reset_launch_counts()
    full = m.forward(p, {"tokens": toks})
    assert ops.launch_counts()["flash_attention"] == 6
    assert ops.entry_launch_counts()["flash_attention"] == 6  # f32 route
    caches = m.decode_init(2, 80)
    outs = []
    for t in range(80):
        logits, caches = m.decode_step(p, caches, toks[:, t:t + 1], t)
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=2e-4,
                               rtol=2e-4)


def test_lm_bf16_prefill_takes_tensor_core_route(cuda):
    """gemma3-27b's smoke config cut to 6 layers in bf16: the prefill's
    six flash launches all run on the tensor cores; logits are finite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config("gemma3-27b").smoke(), n_layers=6,
                              dtype="bfloat16")
    m = build_model(cfg)
    p = m.init(4)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 200))).to(cuda)
    ops.reset_launch_counts()
    logits = m.forward(p, {"tokens": toks})
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 6
    assert ops.entry_launch_counts()["flash_attention_sm90"] == 6
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-small"])
def test_family_bf16_prefill_on_card(cuda, arch, monkeypatch):
    """hymba's (GQA group 2 at head_dim 16, beside the SSM) and whisper's
    (non-causal encoder, cross attention with sq != skv) smoke configs in
    bf16: every attention call of the prefill is one flash launch on the
    tensor cores, and the logits equal those of the same forward with
    the plain attention within atol = rtol = 0.1 (the bf16 bound of
    ``tests/test_torch_models.py``: the plain version rounds the logits
    to bf16, the kernel keeps f32 scores)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    m = build_model(cfg)
    p = m.init(5)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 40 if arch == "whisper-small" else 200))
    ).to(cuda)}
    calls = cfg.n_layers
    if arch == "whisper-small":
        batch["frames"] = torch.randn((2, 300, cfg.d_model), device=cuda)
        calls = cfg.n_encoder_layers + 2 * cfg.n_layers
    ops.reset_launch_counts()
    logits = m.forward(p, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == calls
    assert ops.entry_launch_counts()["flash_attention_sm90"] == calls
    assert bool(torch.isfinite(logits).all())
    kernel_attention = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **kw: kernel_attention(
        *a, impl="ref", **kw))
    ops.reset_launch_counts()
    plain = m.forward(p, batch)
    assert ops.launch_counts()["flash_attention"] == 0
    torch.testing.assert_close(logits.float(), plain.float(), atol=0.1,
                               rtol=0.1)


# the trainer's attention: granite-20b's 48 query heads on one kv head
# (full and ragged length), GQA with a window, the padded head_dim
GRAD_CASES = [
    (2, 48, 1, 1024, 1024, 128, True, None, 0),
    (1, 48, 1, 777, 777, 128, True, None, 0),
    (2, 4, 2, 300, 300, 64, True, 100, 0),
    (1, 4, 2, 77, 77, 36, True, None, 0),
]


# the three benchmark cells' head layouts at one batch row: granite-20b's
# 48 query heads on one kv head at 1,024 and 4,096 tokens, granite-moe's
# 16 on 8 at head_dim 64
CELL_GRAD_CASES = [
    (1, 48, 1, 1024, 1024, 128, True, None, 0),
    (1, 48, 1, 4096, 4096, 128, True, None, 0),
    (1, 16, 8, 4096, 4096, 64, True, None, 0),
]


def _rel_errs(got, want):
    """Norm-wise relative errors: the largest entry's error sits at the
    bf16 output rounding (up to 2^-8 of the largest entry) on both routes
    and cannot order them."""
    return [float((g.float() - w).norm() / w.norm())
            for g, w in zip(got, want)]


def _check_bf16_backward(case, dev):
    """The bf16 backward through ``attention_bwd_sm90``: one forward and
    one backward launch, no plain backward; dq, dk, dv against the f32
    gradient of the same bf16 inputs (TF32 off) no worse than
    ``attention_vjp``'s bf16 gradient (the plain path's, which rounds the
    logits and dP to bf16), each error norm-wise relative
    (``_rel_errs``); prints both."""
    from repro_torch.kernels import ref

    *_, causal, window, q_off = case
    kw = {"causal": causal, "window": window, "q_offset": q_off}
    torch.backends.cuda.matmul.allow_tf32 = False
    ins = [t.requires_grad_() for t in _flash_inputs(case, torch.bfloat16,
                                                      dev)]
    g = torch.Generator(device=dev).manual_seed(case[3])
    dout = torch.randn(ins[0].shape, generator=g, device=dev).to(
        torch.bfloat16)
    ops.reset_launch_counts()
    out = ops.attention(*ins, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, ins, dout)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["attention_bwd_sm90"] == 1
    assert ops.plain_on_card_counts() == {"attention_vjp": 0}
    f32 = [t.detach().float().requires_grad_() for t in ins]
    want = torch.autograd.grad(ref.attention(*f32, **kw), f32,
                               dout.float())
    plain = [t.detach().clone().requires_grad_() for t in ins]
    vjp = torch.autograd.grad(ref.attention(*plain, **kw), plain, dout)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
    err, plain_err = _rel_errs(got, want), _rel_errs(vjp, want)
    print(f"{case}: dq, dk, dv error {err}, attention_vjp's {plain_err}")
    assert all(e <= pe for e, pe in zip(err, plain_err))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_flash_function_grads_match_plain(cuda, case, dtype, monkeypatch):
    """The ``autograd.Function``'s wiring on the card: the forward is one
    kernel launch with ``FlashAttention`` as the grad_fn.  bf16 goes
    through the backward kernel (``_check_bf16_backward``).  f32 keeps
    ``attention_vjp``, counted as a plain backward on the card: dq, dk,
    dv equal autograd through ``ref.attention`` within 2e-5, with the
    batch rows in one chunk and in a chunk each.  The values themselves
    are held against ``jax.value_and_grad`` by the CPU tests
    (``tests/test_torch_train.py``)."""
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.kernels import ref

    if dtype == "bfloat16":
        _check_bf16_backward(case, cuda)
        return
    *_, causal, window, q_off = case
    torch.backends.cuda.matmul.allow_tf32 = False
    ins = [t.requires_grad_() for t in _flash_inputs(case, torch.float32,
                                                      cuda)]
    g = torch.Generator(device=cuda).manual_seed(case[3])
    dout = torch.randn(ins[0].shape, generator=g, device=cuda)
    plain = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(ref.attention(*plain, causal=causal,
                                             window=window), plain, dout)
    for chunk_bytes in (1 << 62, 1):  # one chunk; a chunk per batch row
        monkeypatch.setattr(fa, "_BWD_SCORE_BYTES", chunk_bytes)
        ops.reset_launch_counts()
        out = ops.attention(*ins, causal=causal, window=window)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        got = torch.autograd.grad(out, ins, dout)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 1
        assert ops.launch_counts()["attention_bwd_sm90"] == 0
        assert ops.plain_on_card_counts() == {"attention_vjp": 1}
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.shape == b.shape
            torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", CELL_GRAD_CASES, ids=str)
def test_flash_backward_kernel_at_cell_layouts(cuda, case):
    _check_bf16_backward(case, cuda)


def test_flash_backward_256_bucket_stays_plain(cuda):
    """head_dim 200 (the 256 bucket) in bf16: the forward on the tensor
    cores without a log-sum-exp, the backward through ``attention_vjp``,
    counted."""
    case = (1, 2, 1, 130, 130, 200, True, None, 0)
    ins = [t.requires_grad_() for t in _flash_inputs(case, torch.bfloat16,
                                                      cuda)]
    ops.reset_launch_counts()
    out = ops.attention(*ins)
    torch.autograd.grad(out, ins, torch.ones_like(out))
    torch.cuda.synchronize()
    assert ops.entry_launch_counts()["flash_attention_sm90"] == 1
    assert ops.launch_counts()["attention_bwd_sm90"] == 0
    assert ops.plain_on_card_counts() == {"attention_vjp": 1}


def test_flash_lse_and_no_grad_forward(cuda):
    """The forward with the log-sum-exp store gives the same output as
    the inference forward, and the log-sum-exp of the plain scores
    (+inf past sq); the no-grad call stores none and launches the same
    entry."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    for case in [(2, 4, 2, 200, 333, 128, True, None, 133),
                 (1, 4, 2, 77, 77, 36, True, 16, 0)]:
        *_, causal, window, q_off = case
        kw = {"causal": causal, "window": window, "q_offset": q_off}
        q, k, v = _flash_inputs(case, torch.bfloat16, cuda)
        ops.reset_launch_counts()
        plain = ops.attention(q, k, v, **kw)
        out, lse = fa.flash_attention(q, k, v, with_lse=True, **kw)
        torch.cuda.synchronize()
        assert ops.entry_launch_counts()["flash_attention_sm90"] == 2
        assert torch.equal(out, plain)
        sq = q.shape[2]
        assert lse.shape == (q.shape[0], q.shape[1], fa.lse_rows(sq))
        assert bool(torch.isinf(lse[..., sq:]).all())
        torch.testing.assert_close(lse[..., :sq],
                                   ref.attention_lse(q, k, **kw),
                                   atol=1e-4, rtol=1e-5)


#: step 1's relative bounds at the smoke config, against the same step
#: with the plain attention.  A bf16 step of the smoke model reads far
#: more relative error than chip_smoke's full-width one (phase 8 (c) has
#: bounds of its own), so each bound sits between this shape's sound
#: reading and what its planted faults read; the test prints the
#: readings (run it with -s) and requires each fault to break a bound
SMOKE_LOSS_RTOL, SMOKE_GNORM_RTOL = 2e-4, 1e-3


def test_train_step_on_card_runs_flash_under_remat(cuda):
    """granite-20b's smoke config, one train step on the card: the flash
    kernel launches twice per layer (forward and remat recompute), on the
    tensor-core route; every gradient is finite and nonzero; the loss
    and gradient norm are within ``SMOKE_LOSS_RTOL`` /
    ``SMOKE_GNORM_RTOL`` of the same step with the plain attention, and
    a step with a planted fault of one tile (chip_smoke's
    ``planted_fault``) is not."""
    import contextlib
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training import make_train_step

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config("granite-20b").smoke()
    model = build_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 128))).to(cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    grads = {}

    def keep(g):
        grads["g"] = g
        return g

    def one_step(attention):
        params = model.init(5)
        opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
        step = make_train_step(model, opt, grad_accum=1,
                               grad_transform=keep)
        with attention:
            ops.reset_launch_counts()
            _p, _s, m = step(params, opt.init(params), batch)
            torch.cuda.synchronize()
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}

    got = one_step(contextlib.nullcontext())
    assert ops.launch_counts()["flash_attention"] == 2 * cfg.n_layers
    assert ops.entry_launch_counts()["flash_attention_sm90"] == \
        2 * cfg.n_layers
    # one backward kernel a layer, after the recompute; none plain
    assert ops.launch_counts()["attention_bwd_sm90"] == cfg.n_layers
    assert ops.plain_on_card_counts() == {"attention_vjp": 0}
    for g in tree_leaves(grads["g"]):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    ref = one_step(smoke.plain_attention())
    assert ops.launch_counts()["flash_attention"] == 0
    err = smoke.rel_errs(got, ref)
    faults = {kind: smoke.rel_errs(one_step(smoke.planted_fault(kind)), ref)
              for kind in ("rows", "keys")}
    print(f"step 1 at the smoke config against the plain attention: "
          f"{err}; with a planted fault: {faults}")
    assert err["loss_rel_err"] <= SMOKE_LOSS_RTOL
    assert err["grad_norm_rel_err"] <= SMOKE_GNORM_RTOL
    for kind, e in faults.items():
        assert (e["loss_rel_err"] > SMOKE_LOSS_RTOL
                or e["grad_norm_rel_err"] > SMOKE_GNORM_RTOL), (kind, e)

def test_cells_prefill_on_card(cuda, monkeypatch):
    """``launch.cells.build_cell`` on the card (its default device):
    whisper-small's smoke config as a prefill cell of 2 x 256 frames and
    64 tokens.  Every attention call is one flash launch on the tensor
    cores; the logits have the cell's shape and equal those of the same
    cell with the plain attention within atol = rtol = 0.1 (the bf16
    bound of ``test_family_bf16_prefill_on_card``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import build_cell

    cfg = get_config("whisper-small").smoke()
    cell = build_cell("whisper-small", "prefill_32k", cfg=cfg,
                      shape=ShapeConfig("prefill_32k", 256, 2, "prefill"))
    assert cell.device.type == "cuda"
    args = cell.inputs(11)
    calls = cfg.n_encoder_layers + 2 * cfg.n_layers
    ops.reset_launch_counts()
    logits = cell.run(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == calls
    assert ops.entry_launch_counts()["flash_attention_sm90"] == calls
    assert logits.shape == (2, 64, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    kernel_attention = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **kw: kernel_attention(
        *a, impl="ref", **kw))
    ops.reset_launch_counts()
    plain = cell.run(*args)
    assert ops.launch_counts()["flash_attention"] == 0
    torch.testing.assert_close(logits.float(), plain.float(), atol=0.1,
                               rtol=0.1)


def test_cells_train_on_card(cuda):
    """llava's smoke config as a train cell on the card, 8 x 64 (4
    patches + 60 tokens), the reference's accumulation of 4 clamped to
    the batch: the flash kernel launches twice per layer and microbatch
    (forward and remat recompute) on the tensor cores; the loss and the
    gradient norm are finite; every parameter changed and is finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import build_cell
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("llava-next-mistral-7b").smoke()
    cell = build_cell("llava-next-mistral-7b", "train_4k", cfg=cfg,
                      shape=ShapeConfig("train_4k", 64, 8, "train"))
    assert cell.accum == 4
    params, opt_state, batch = cell.inputs(12)
    assert batch["patches"].shape == (8, cfg.n_patches, cfg.d_vision)
    before = [t.clone() for t in tree_leaves(params)]
    ops.reset_launch_counts()
    params, opt_state, met = cell.run(params, opt_state, batch)
    torch.cuda.synchronize()
    want = 2 * cfg.n_layers * cell.accum
    assert ops.launch_counts()["flash_attention"] == want
    assert ops.entry_launch_counts()["flash_attention_sm90"] == want
    assert np.isfinite(float(met["loss"])) and np.isfinite(
        float(met["grad_norm"]))
    for a, b in zip(before, tree_leaves(params)):
        assert bool(torch.isfinite(b).all()) and not torch.equal(a, b)


def test_mesh_train_step_on_card_matches_unsharded(cuda):
    """Phase 12's step at a cut depth: granite-20b's smoke config (bf16
    compute), 2 steps at accumulation 2 of batch 4 x 128, through
    ``build_cell(..., mesh)`` on a (1, 1) DeviceMesh of an NCCL world of
    one and on the card unsharded, from the same draw.  At world 1 the
    mesh bodies keep the unsharded arithmetic: the losses, the gradient
    norms and the parameters are equal; the flash kernel launches 2 x
    layers x microbatches a step, all on the tensor cores, and its
    backward kernel once a layer and microbatch, never ``attention_vjp``."""
    import importlib.util
    from pathlib import Path

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_mesh

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config("granite-20b").smoke()
    started = not dist.is_initialized()
    init_distributed("cuda")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        runs = [smoke.train_cell_run("granite-20b", cfg, (4, 128), where,
                                     2, 2) for where in ("cuda", mesh)]
    finally:
        if started:
            dist.destroy_process_group()
    (_, p1, _, _, one, _), (cell, pm, _, _, got, (fl, fl90, bwd)) = runs
    assert cell.accum == 2
    assert fl == fl90 == 2 * 2 * cfg.n_layers * cell.accum
    assert bwd == {"kernel": 2 * cfg.n_layers * cell.accum, "plain": 0}
    for a, b in zip(one, got):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert smoke._max_diff(pm, smoke._to_host(p1)) == 0


def test_mesh_analysis_phase_on_card(cuda):
    """Phase 13's child process on a machine with cards: the per-card
    step analysis of phases 11 and 12's configurations on meta tensors
    in a fake world, the cards hidden from it; every run analysed, the
    (1, 1) runs equal to the one-card analysis with no collective bytes
    (``mesh_analysis_gates`` raises otherwise), and with n >= 2 cards
    the multi-card meshes send some."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n = torch.cuda.device_count()
    recs = smoke.mesh_analysis_child(n)
    assert len(recs) == 2 + (3 if n >= 2 else 0)
    assert all(r["status"] == "ok" for r in recs)
    assert [tuple(r["mesh"]) for r in recs[:2]] == [(1, 1), (1, 1)]
    for r in recs[2:]:
        assert r["collective_bytes_per_device"] > 0



def test_examples_phase_on_card(cuda):
    """Phase 14 on the card (the trainer cut to 2 steps): the analysis
    clean, quickstart and streaming on ``soa-device`` equal to their CPU
    runs with ``lsh_hash_resolve`` and ``bucket_insert_pass`` launched at
    least once per insert batch, curation equal, serve and train run,
    train's flash launches counted (the phase raises otherwise)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ops.ensure_built()
    ex = smoke.run_examples_phase("cuda", "cuda", train_steps=2)
    assert ex["analysis"]["n_findings"] == 0
    for name, batches in smoke.EXAMPLE_RUNS:
        run = ex["runs"][name]["card"]
        assert run["insert_batches"] == batches
        assert min(run["per_insert_batch"].values()) >= 1
    assert ex["runs"]["torch_train_lm"]["card"]["launches"][
        "flash_attention"] >= 2
