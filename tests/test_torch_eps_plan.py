"""The schedule of the ``eps_neighbor_counts`` CUDA kernel on the CPU.

The kernel evaluates each unordered pair of 128-point tiles once (the
f32 count matrix is symmetric bit for bit in the plain version's order)
and splits the T (T + 1) / 2 tile pairs I <= J over a persistent grid in
equal contiguous ranges.  ``pairwise_dist.plan`` lays that out and
``pairwise_dist.pair_of`` numbers the pairs as the kernel does.  Here:
the ranges cover every tile pair exactly once, the shared memory fits a
block, the pair numbers do not overflow at the largest n the wrapper
takes, and a numpy walk of the schedule that credits each hit as the
kernel does (rows always, columns only off the diagonal; padded points
carry an infinite norm) equals the plain version exactly.  The kernel
itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import pairwise_dist as pd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

CU = Path(pd.__file__).resolve().parent / "csrc" / "pairwise_dist.cu"
#: an n whose split on 132 SMs gives blocks that start inside a row of
#: tile pairs and blocks that cross from one row to the next (the card
#: tests and chip_smoke.py's sweep use it)
PARTIAL_RUN_N = 8193
D_ABOVE_WHOLE = 96
SM_SHARED = 233_472         # bytes of shared memory an H100 SM gives blocks
BLOCK_RESERVED = 1_024      # bytes the card keeps back for each block
MAX_BLOCK_SHARED = 232_448  # dynamic shared memory a block may ask for


def _triangle(t):
    """The tile pairs I <= J of t tiles in row-major order."""
    i = np.repeat(np.arange(t, dtype=np.int64), np.arange(t, 0, -1))
    j = np.arange(i.size, dtype=np.int64) - pd.row_start(i, t) + i
    return i, j


@pytest.mark.parametrize("d", [1, 3, 10, 54, D_ABOVE_WHOLE])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 255, 256, 257, 20_001,
                               200_000])
def test_ranges_cover_each_tile_pair_once(n, d):
    p = pd.plan(n, d)
    t = -(-n // pd.TILE)
    assert (p.n_tiles, p.n_pad, p.pairs) == (t, t * pd.TILE,
                                             t * (t + 1) // 2)
    assert 1 <= p.grid <= min(p.pairs, pd.H100_SMS * pd.BLOCKS_PER_SM)
    assert p.smem_bytes <= MAX_BLOCK_SHARED
    assert p.scratch_floats == (d + 1) * p.n_pad
    p0, p1 = pd.block_range(p, np.arange(p.grid))
    # contiguous, no gap, no overlap, none empty, within one pair of even
    assert p0[0] == 0 and p1[-1] == p.pairs
    np.testing.assert_array_equal(p0[1:], p1[:-1])
    size = p1 - p0
    assert size.min() >= 1 and size.max() - size.min() <= 1
    # the pair numbers decode to each I <= J exactly once
    i, j = pd.pair_of(np.arange(p.pairs, dtype=np.int64), t)
    want_i, want_j = _triangle(t)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(j, want_j)


@pytest.mark.parametrize("d,mode,kc,smem", [
    (1, "whole", 1, 4 * 128 * 23), (54, "whole", 54, 4 * 128 * 182),
    (64, "whole", 64, 108_544), (65, "chunked", 32, 75_776),
    (D_ABOVE_WHOLE, "chunked", 32, 75_776),
    (4096, "chunked", 32, 75_776)])
def test_staging_mode_and_shared_memory(d, mode, kc, smem):
    p = pd.plan(20_001, d)
    assert (p.mode, p.kc, p.smem_bytes) == (mode, kc, smem)
    # two blocks an SM: the grid is twice the multiprocessors
    assert 2 * (p.smem_bytes + BLOCK_RESERVED) <= SM_SHARED
    assert p.grid == 2 * pd.H100_SMS
    assert pd.plan(20_001, d, sms=114).grid == 228


def test_kernel_source_shares_the_plan_constants():
    src = CU.read_text()
    for name, value in (("TILE", pd.TILE), ("D_WHOLE", pd.D_WHOLE),
                        ("KC", pd.KC), ("THREADS", 32 * pd.WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "__launch_bounds__(THREADS, 2)" in src
    assert pd.BLOCKS_PER_SM == 2


def test_pair_numbers_fit_at_the_largest_n():
    n = 2**31 - 1
    p = pd.plan(n, 10)
    t = p.n_tiles
    assert t == 2**24 and p.pairs == t * (t + 1) // 2
    # the kernel's products stay inside int64: pairs * (block + 1), the
    # row starts, and the float64 root's argument (2t + 1)^2
    assert p.pairs * p.grid < 2**63 and (2 * t + 1) ** 2 < 2**53
    b = np.arange(p.grid, dtype=np.int64)
    p0, p1 = pd.block_range(p, b)
    assert p0[0] == 0 and p1[-1] == p.pairs
    rng = np.random.default_rng(0)
    probes = np.concatenate([p0, p1 - 1, [0, p.pairs - 1, t - 1, t],
                             rng.integers(0, p.pairs, 2000)])
    i, j = pd.pair_of(probes, t)
    assert (pd.row_start(i, t) <= probes).all()
    assert ((i + 1 == t) | (pd.row_start(i + 1, t) > probes)).all()
    assert ((i <= j) & (j < t)).all()
    assert pd.pair_of(np.array([p.pairs - 1]), t) == (t - 1, t - 1)
    assert pd.pair_of(np.array([t]), t) == (1, 1)


def test_partial_run_n_splits_rows_across_blocks():
    p = pd.plan(PARTIAL_RUN_N, 10)
    p0, p1 = pd.block_range(p, np.arange(p.grid))
    i0, j0 = pd.pair_of(p0, p.n_tiles)
    i1, _ = pd.pair_of(p1 - 1, p.n_tiles)
    assert (j0 != i0).any()    # a block starts inside a row
    assert (i1 != i0).any()    # a block crosses to the next row


def _walk(x, eps, p):
    """The kernel's schedule in numpy f32: every block's tile pairs, each
    hit credited to its row and, off the diagonal, to its column."""
    n, d = x.shape
    thr = np.float32(ref.eps_threshold(eps))
    xp = np.zeros((p.n_pad, d), np.float32)
    xp[:n] = x
    s = xp[:, 0] * xp[:, 0]
    for k in range(1, d):
        s = s + xp[:, k] * xp[:, k]
    s[n:] = np.inf
    out = np.zeros(p.n_pad, np.int64)
    done = np.zeros((p.n_tiles, p.n_tiles), np.int64)
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(p.grid):
            p0, p1 = pd.block_range(p, b)
            for ti, tj in zip(*pd.pair_of(np.arange(p0, p1), p.n_tiles)):
                done[ti, tj] += 1
                r = slice(ti * pd.TILE, (ti + 1) * pd.TILE)
                c = slice(tj * pd.TILE, (tj + 1) * pd.TILE)
                a, bb = xp[r], xp[c]
                acc = a[:, None, 0] * bb[None, :, 0]
                for k in range(1, d):
                    acc = acc + a[:, None, k] * bb[None, :, k]
                d2 = (s[r][:, None] + s[c][None, :]) - np.float32(2) * acc
                hit = d2 <= thr
                out[r] += hit.sum(axis=1)
                if ti != tj:
                    out[c] += hit.sum(axis=0)
    np.testing.assert_array_equal(done, np.triu(np.ones_like(done)))
    return out[:n]


@pytest.mark.parametrize("n,d,sms", [
    (1, 1, 132), (127, 3, 1), (128, 10, 3), (129, 70, 132), (255, 4, 3),
    (257, 10, 1), (300, 70, 3), (1000, 10, 132), (1500, 20, 5),
    (2001, 3, 3), (2001, 70, 132)])
def test_walk_of_the_schedule_equals_the_plain_version(n, d, sms):
    rng = np.random.default_rng(n * 1000 + d)
    x = (rng.normal(size=(n, d)) * 0.7).astype(np.float32)
    dup = min(3, n - n // 2)
    x[n // 2:n // 2 + dup] = x[:dup]  # duplicated points
    eps = 0.35 * np.sqrt(d)
    p = pd.plan(n, d, sms=sms)
    got = _walk(x, eps, p)
    want = ref.eps_neighbor_counts(torch.from_numpy(x), eps).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and (n == 1 or (got > 1).any())


def test_plan_refuses_empty_shapes():
    for n, d in ((0, 3), (5, 0)):
        with pytest.raises(ValueError, match="plan needs"):
            pd.plan(n, d)
