"""The port on the card: each CUDA kernel against its plain PyTorch
version, the ``soa-device`` engine on ``cuda`` against the host ``soa``
engine, the sampled-core engine's device path on ``cuda`` against its
host twin, ``batched-device`` on ``cuda`` against ``batched-device`` on
the CPU, and the dense LM's prefill (through the flash-attention kernel)
against its decode.  Tolerance zero for the integer kernels (for
``eps_neighbor_counts`` because the kernel and its plain version round
every f32 product and sum in the same order).  ``flash_attention`` sums
in another f32 order than its plain version: atol = rtol = 2e-5 in
float32 (``tests/test_kernels.py``'s tolerance); in bfloat16 it is held
against the plain version run on the f32 upcast of the same inputs and
rounded to bf16, within one bf16 ulp (atol = rtol = 2^-7); bf16 runs on
the tensor cores (``flash_attention_sm90``), f32 on the CUDA cores.

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
