"""Exact eps-neighbour counts on the card: the CUDA wrapper for
``csrc/pairwise_dist.cu``, which replaces the Pallas TPU kernel
``repro/kernels/pairwise_dist.py::eps_neighbor_counts``.

The kernel counts, for every point, the points within eps (itself
included) from ``(s_i + s_j) - 2*dot_ij`` in the fixed f32 order of
:func:`repro_torch.kernels.ref.eps_neighbor_counts`, bit-identical to it.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import check_cuda
from .ref import eps_threshold


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
        norms = torch.empty(n, dtype=torch.float32, device=x.device)
        _build.launch("eps_neighbor_counts", x.data_ptr(), n, d,
                      eps_threshold(eps), norms.data_ptr(), out.data_ptr(),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out
