"""Bucket occupancy and support on the card: the CUDA wrappers for
``csrc/bucket_ops.cu``, which replace the Pallas TPU kernels
``repro/kernels/bucket_ops.py::slot_counts`` and ``::bucket_core_stats``.

  * ``slot_counts``       — histogram a batch's (n, t) slot matrix into
                            per-slot occupancy deltas (global atomics);
  * ``bucket_core_stats`` — gather each point's t bucket sizes and reduce
                            them to ``support = #{i : |bucket_i| >= k}``
                            and ``core = support > 0`` (Definition 4);
  * ``bucket_insert_pass`` — the engine's insert batch: both of the above
                            in one cooperative launch, the histogram
                            added into a device size table in place and
                            the support gathered against the new sizes,
                            packed into one output for one download.

Ids outside the slot range contribute nothing, bit-identical to
:mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._checks import check_cuda


def slot_counts(slots: torch.Tensor, *, n_slots: int) -> torch.Tensor:
    """(n, t) i32 slots on the card -> (n_slots,) i32 histogram."""
    check_cuda("slot_counts", slots=(slots, torch.int32, None))
    if slots.dim() != 2:
        raise ValueError(f"slot_counts: slots must be (n, t), got "
                         f"{tuple(slots.shape)}")
    out = torch.zeros(n_slots, dtype=torch.int32, device=slots.device)
    if slots.numel() and n_slots:
        _build.launch("slot_counts", slots.data_ptr(), slots.numel(),
                      n_slots, out.data_ptr(),
                      torch.cuda.current_stream(slots.device).cuda_stream)
    return out


def bucket_core_stats(slots: torch.Tensor, sizes: torch.Tensor, *, k: int):
    """(n, t) i32 slots, (nb,) i32 sizes on the card -> ((n,), (n,)) i32
    support and core flags."""
    check_cuda("bucket_core_stats", slots=(slots, torch.int32, None),
               sizes=(sizes, torch.int32, None))
    if slots.dim() != 2 or sizes.dim() != 1:
        raise ValueError(
            f"bucket_core_stats: want slots (n, t) and sizes (nb,), got "
            f"{tuple(slots.shape)} and {tuple(sizes.shape)}")
    n, t = slots.shape
    supp = torch.empty(n, dtype=torch.int32, device=slots.device)
    core = torch.empty(n, dtype=torch.int32, device=slots.device)
    if n:
        _build.launch("bucket_core_stats", slots.data_ptr(),
                      sizes.data_ptr(), n, t, sizes.shape[0], int(k),
                      supp.data_ptr(), core.data_ptr(),
                      torch.cuda.current_stream(slots.device).cuda_stream)
    return supp, core


def bucket_insert_pass(slots: torch.Tensor, sizes: torch.Tensor, *, k: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, t) i32 slots, (nb,) i32 sizes on the card -> ``sizes`` += the
    batch's histogram in place; returns ``out[:nb + n]`` = [new sizes |
    support] (``out``, when given, is written and nothing is allocated)."""
    check_cuda("bucket_insert_pass", slots=(slots, torch.int32, None),
               sizes=(sizes, torch.int32, None))
    if slots.dim() != 2 or sizes.dim() != 1:
        raise ValueError(
            f"bucket_insert_pass: want slots (n, t) and sizes (nb,), got "
            f"{tuple(slots.shape)} and {tuple(sizes.shape)}")
    (n, t), nb = slots.shape, sizes.shape[0]
    if out is None:
        out = torch.empty(nb + n, dtype=torch.int32, device=slots.device)
    elif out.dim() != 1 or out.shape[0] < nb + n:
        raise ValueError(f"bucket_insert_pass: out must be 1-d with at "
                         f"least {nb + n} entries, got {tuple(out.shape)}")
    out = out[:nb + n]
    check_cuda("bucket_insert_pass", out=(out, torch.int32, None))
    if nb + n:
        _build.launch("bucket_insert_pass", slots.data_ptr(), n, t,
                      sizes.data_ptr(), nb, int(k), out.data_ptr(),
                      torch.cuda.current_stream(slots.device).cuda_stream)
    return out
