"""Grid-LSH bucket keys on the card: the CUDA wrappers for
``csrc/lsh_hash.cu``, which replaces the Pallas TPU kernel
``repro/kernels/lsh_hash.py::lsh_hash``.

  * ``lsh_hash``         — ``floor((x + eta) * inv_cell)`` codes, two int32
                           wrap-around dot products with the odd mixers
                           and a murmur3 avalanche, bit-identical to
                           :func:`repro_torch.kernels.ref.lsh_hash`;
  * ``lsh_hash_resolve`` — the engine's hash pass: the same keys, and for
                           each (point, table) key the slot that a device
                           mirror of the bucket directory (an
                           open-addressing table of ``[key a, key b,
                           table, slot]`` cells) holds for it, -1 for a
                           miss, after the directory's pending updates are
                           applied; one cooperative launch, one packed
                           output ``[keys (n, t, 2) | slots (n, t)]``,
                           bit-identical to
                           :func:`repro_torch.kernels.ref.lsh_hash_resolve`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from ._checks import check_cuda


def lsh_hash(x: torch.Tensor, eta: torch.Tensor, mixers: torch.Tensor, *,
             inv_cell: float) -> torch.Tensor:
    """(n, d) f32, (t,) f32, (2, t, d) i32 on the card -> (n, t, 2) i32.

    ``inv_cell`` is rounded to float32 once, as ``jnp.float32(inv_cell)``
    does in the reference."""
    n, d = x.shape
    t = eta.shape[0]
    check_cuda("lsh_hash", x=(x, torch.float32, (n, d)),
               eta=(eta, torch.float32, (t,)),
               mixers=(mixers, torch.int32, (2, t, d)))
    out = torch.empty((n, t, 2), dtype=torch.int32, device=x.device)
    if n and t:
        _build.launch("lsh_hash", x.data_ptr(), eta.data_ptr(),
                      mixers.data_ptr(), float(np.float32(inv_cell)), n, d,
                      t, out.data_ptr(),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out


def lsh_hash_resolve(x: torch.Tensor, eta: torch.Tensor,
                     mixers: torch.Tensor, *, inv_cell: float,
                     directory: torch.Tensor, updates: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, d) f32, (t,) f32, (2, t, d) i32 on the card; ``directory``
    (cap, 4) i32 with cap a power of two, updated IN PLACE by ``updates``
    (u, 4) i32 ``[key a, key b, table, slot]`` (slot -1: erase), which the
    launch consumes (its contents afterwards are unspecified) ->
    ``out[:3 n t]`` = [keys | slots] (``out``, when given, is written and
    nothing is allocated).  Both tables 16-byte aligned."""
    n, d = x.shape
    t = eta.shape[0]
    check_cuda("lsh_hash_resolve", x=(x, torch.float32, (n, d)),
               eta=(eta, torch.float32, (t,)),
               mixers=(mixers, torch.int32, (2, t, d)),
               directory=(directory, torch.int32, None),
               updates=(updates, torch.int32, None))
    cap = directory.shape[0]
    if (directory.dim() != 2 or directory.shape[1] != 4 or cap < 1
            or cap & (cap - 1) or updates.dim() != 2
            or updates.shape[1] != 4):
        raise ValueError(
            f"lsh_hash_resolve: want directory (cap, 4) with cap a power of "
            f"two and updates (u, 4), got {tuple(directory.shape)} and "
            f"{tuple(updates.shape)}")
    if directory.data_ptr() % 16 or updates.data_ptr() % 16:
        raise ValueError("lsh_hash_resolve: directory and updates must be "
                         "16-byte aligned")
    m = n * t
    if out is None:
        out = torch.empty(3 * m, dtype=torch.int32, device=x.device)
    elif out.dim() != 1 or out.shape[0] < 3 * m:
        raise ValueError(f"lsh_hash_resolve: out must be 1-d with at least "
                         f"{3 * m} entries, got {tuple(out.shape)}")
    out = out[:3 * m]
    check_cuda("lsh_hash_resolve", out=(out, torch.int32, None))
    if m or updates.shape[0]:
        _build.launch("lsh_hash_resolve", x.data_ptr(), eta.data_ptr(),
                      mixers.data_ptr(), float(np.float32(inv_cell)), n, d,
                      t, directory.data_ptr(), cap, updates.data_ptr(),
                      updates.shape[0], out.data_ptr(),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out
