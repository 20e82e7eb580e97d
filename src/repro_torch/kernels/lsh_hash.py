"""Grid-LSH bucket keys on the card: the CUDA wrapper for
``csrc/lsh_hash.cu``, which replaces the Pallas TPU kernel
``repro/kernels/lsh_hash.py::lsh_hash``.

The kernel computes ``floor((x + eta) * inv_cell)`` codes, two int32
wrap-around dot products with the odd mixers and a murmur3 avalanche,
bit-identical to :func:`repro_torch.kernels.ref.lsh_hash`.
"""

from __future__ import annotations

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
