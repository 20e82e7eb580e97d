"""Exact eps-neighbour counts on the card: the CUDA wrapper for
``csrc/pairwise_dist.cu``, which replaces the Pallas TPU kernel
``repro/kernels/pairwise_dist.py::eps_neighbor_counts``.

The kernel counts, for every point, the points within eps (itself
included) from ``(s_i + s_j) - 2*dot_ij`` in the fixed f32 order of
:func:`repro_torch.kernels.ref.eps_neighbor_counts`, bit-identical to it.
The count matrix is symmetric bit for bit in that order, so the kernel
evaluates each unordered pair of 128-point tiles once: :func:`plan` lays
out that schedule (tiles, staging, shared memory, grid and the split of
the tile pairs over the blocks) and :func:`pair_of` numbers the pairs as
the kernel does, so that the CPU tests can check the schedule.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _build
from ._checks import check_cuda
from .ref import eps_threshold

TILE = 128          # points a tile holds: 128 x 128 pairs a tile pair
D_WHOLE = 64        # d up to this stays whole in shared memory
KC = 32             # k rows a ring stage holds when d > D_WHOLE
WARPS = 8           # 256 threads a block
BLOCKS_PER_SM = 2   # __launch_bounds__(256, 2); the shared memory of two
                    # blocks fits an SM at every d (smem_bytes)
H100_SMS = 132


class EpsPlan(NamedTuple):
    """How one call runs: the staging mode (``"whole"``: d k rows in
    shared memory, the row tile kept for a run of column tiles;
    ``"chunked"``: row and column tiles staged ``kc`` k rows at a time),
    the tiles T = ceil(n / 128) and the padded row count 128 T, the
    T (T + 1) / 2 tile pairs I <= J, the persistent grid, its dynamic
    shared-memory bytes, and the scratch floats (xT and the norms)."""
    mode: str
    kc: int
    n_tiles: int
    n_pad: int
    pairs: int
    grid: int
    smem_bytes: int
    scratch_floats: int


def smem_bytes(mode: str, d: int) -> int:
    """Dynamic shared memory of a block (``csrc/pairwise_dist.cu``): the
    k rows of the row tile and of two column stages (whole), or two
    stages of both (chunked), and 20 rows of 128 for the norms, the row
    sums and the column hits of two tile pairs."""
    rows = 3 * d if mode == "whole" else 4 * KC
    return 4 * TILE * (rows + 4 + 2 * WARPS)


def plan(n: int, d: int, sms: int = H100_SMS) -> EpsPlan:
    """The schedule of a call on ``n`` points of ``d`` dimensions on a
    card with ``sms`` multiprocessors."""
    if n < 1 or d < 1:
        raise ValueError(f"eps_neighbor_counts: plan needs n >= 1 and "
                         f"d >= 1, got n = {n}, d = {d}")
    mode = "whole" if d <= D_WHOLE else "chunked"
    t = -(-n // TILE)
    pairs = t * (t + 1) // 2
    return EpsPlan(mode, d if mode == "whole" else KC, t, t * TILE, pairs,
                   min(sms * BLOCKS_PER_SM, pairs), smem_bytes(mode, d),
                   (d + 1) * t * TILE)


def block_range(p: EpsPlan, b) -> Tuple:
    """The tile pairs [p0, p1) block ``b`` (an int or an int64 array)
    walks, as the kernel splits them: equal contiguous ranges."""
    # analysis: allow[HOT003] the host's model of the kernel's schedule
    b = np.asarray(b, dtype=np.int64)
    return p.pairs * b // p.grid, p.pairs * (b + 1) // p.grid


def row_start(i, t: int):
    """Number of the pair (i, i) in the row-major triangle of t tiles."""
    # analysis: allow[HOT003] the host's model of the kernel's schedule
    i = np.asarray(i, dtype=np.int64)
    return i * t - i * (i - 1) // 2


def pair_of(pn, t: int):
    """The tile pair (I, J), I <= J, numbered ``pn`` (an int64 array)
    in the row-major triangle of ``t`` tiles: the kernel's ``pair_of``,
    a float64 root corrected in int64."""
    # analysis: allow[HOT003] the host's model of the kernel's schedule
    pn = np.asarray(pn, dtype=np.int64)
    b = 2.0 * t + 1.0
    i = np.floor((b - np.sqrt(b * b - 8.0 * pn.astype(np.float64))) * 0.5)
    i = np.clip(i.astype(np.int64), 0, t - 1)
    # analysis: allow[HOT001] the host's model of the kernel's schedule
    while True:  # the kernel's correction loops, one step at a time
        dn = (i > 0) & (row_start(i, t) > pn)
        up = (i + 1 < t) & (row_start(i + 1, t) <= pn)
        if not (dn.any() or up.any()):
            break
        i = i - dn + up
    return i, i + (pn - row_start(i, t))


def eps_neighbor_counts(x: torch.Tensor, *, eps: float) -> torch.Tensor:
    """(n, d) f32 on the card -> (n,) i32 counts, self included."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"eps_neighbor_counts: x must be (n, d) with "
                         f"d >= 1, got {tuple(x.shape)}")
    n, d = x.shape
    check_cuda("eps_neighbor_counts", x=(x, torch.float32, (n, d)))
    if n >= 2**31:
        raise ValueError(f"eps_neighbor_counts: n = {n} does not fit int32")
    out = torch.zeros(n, dtype=torch.int32, device=x.device)
    if n:
        p = plan(n, d, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        scratch = torch.empty(p.scratch_floats, dtype=torch.float32,
                              device=x.device)
        _build.launch("eps_neighbor_counts", x.data_ptr(), n, d,
                      eps_threshold(eps), scratch.data_ptr(), out.data_ptr(),
                      int(p.mode == "whole"), p.kc, p.n_tiles, p.pairs,
                      p.grid, p.smem_bytes,
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out
