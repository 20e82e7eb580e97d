"""GQA flash attention on the card: the CUDA wrapper for
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.

Online-softmax attention with causal and sliding-window masks and
``q_offset``, f32 scores and accumulators, the output in q's dtype (f32
or bf16); query head h reads kv head ``h // (hq // hkv)``.  A row whose
keys are all masked gets 0, as in the TPU kernel.  Held against
:func:`repro_torch.kernels.ref.attention` to the reference tests'
tolerances (another f32 summation order).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._checks import check_cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I32 = 2**31 - 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (b, hq, sq, dh), k and v (b, hkv, skv, dh) on the card ->
    (b, hq, sq, dh) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    check_cuda("flash_attention", q=(q, q.dtype, None),
               k=(k, q.dtype, (b, hkv, skv, dh)),
               v=(v, q.dtype, (b, hkv, skv, dh)))
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: hq = {hq} is not a multiple of "
                         f"hkv = {hkv}")
    if not 1 <= dh <= 256:
        raise ValueError(f"flash_attention: head_dim {dh} not in [1, 256]")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: b * hq = {b * hq} > 65535")
    for name, val in (("window", window or 0), ("q_offset", q_offset),
                      ("sq", sq), ("skv", skv)):
        if abs(val) > _I32:
            raise ValueError(f"flash_attention: {name} = {val} does not "
                             "fit int32")
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, dh,
                  int(causal), int(window is not None), int(window or 0),
                  int(q_offset), float(scale), _DTYPES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
