"""GQA flash attention on the card: the CUDA wrappers for
``csrc/flash_attention_sm90.cu`` (bf16, tensor cores) and
``csrc/flash_attention.cu`` (f32, CUDA cores), which replace the Pallas
TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.

Online-softmax attention with causal and sliding-window masks and
``q_offset``, f32 scores and accumulators, the output in q's dtype;
query head h reads kv head ``h // (hq // hkv)``.  A row whose keys are
all masked gets 0, as in the TPU kernel.  :func:`plan` picks the route
by dtype in one place:

* bfloat16 -> ``wgmma``: both products on the tensor cores (bf16
  operands, f32 sums; p rounded to bf16 for P V, as the plain version
  does), TMA loads.  TMA needs 16-byte row strides, so dh is zero-padded
  to a multiple of 8 (``scale`` stays the true dh's) and the output
  sliced back.
* float32 -> ``simt``: f32 arithmetic on the CUDA cores, which holds the
  reference tests' 2e-5 that no bf16 or TF32 product can.

Both count as launches of ``flash_attention``; ``ops.
entry_launch_counts()`` tells the routes apart.  Held against
:func:`repro_torch.kernels.ref.attention` to the reference tests'
tolerances (another f32 summation order).

:class:`FlashAttention` puts the kernel under autograd, for training:
its forward is the kernel on the card (the plain version where
``ops.attention`` runs that), and its backward is the gradient of the
plain version, in plain PyTorch — the reference has no backward kernel
either; it differentiates its plain ``chunked_attention`` through XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from . import ref as _ref
from ._checks import check_cuda

_I32 = 2**31 - 1
_MAX_GRID_Y = 65535  # heads (simt route) or query tiles (wgmma route)


class FlashPlan(NamedTuple):
    """How one call runs: the route and its C entry point, the head_dim
    handed to the kernel (q, k and v zero-padded to it), the kernel's
    head_dim bucket and its query / key tile sizes."""
    route: str
    entry: str
    dh_pad: int
    bucket: int
    block_q: int
    block_k: int


def plan(dtype: torch.dtype, dh: int) -> FlashPlan:
    """The route, padding and tiling of a call with this dtype and
    head_dim."""
    if not 1 <= dh <= 256:
        raise ValueError(f"flash_attention: head_dim {dh} not in [1, 256]")
    if dtype == torch.bfloat16:
        dh_pad = -(-dh // 8) * 8
        bucket = 64 if dh_pad <= 64 else 128 if dh_pad <= 128 else 256
        return FlashPlan("wgmma", "flash_attention_sm90", dh_pad, bucket,
                         128, 128 if bucket <= 128 else 64)
    if dtype == torch.float32:
        bucket = next(b for b in (64, 128, 192, 256) if dh <= b)
        return FlashPlan("simt", "flash_attention", dh, bucket, 64, 64)
    raise TypeError(f"flash_attention: q must be float32 or bfloat16, got "
                    f"{dtype}")


def pad_head_dim(t: torch.Tensor, dh_pad: int) -> torch.Tensor:
    """Contiguous ``t`` (..., dh) zero-padded to (..., dh_pad) and
    16-byte aligned, as TMA reads it (a copy only where needed)."""
    if t.shape[-1] != dh_pad:
        return F.pad(t, (0, dh_pad - t.shape[-1]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    check_cuda("flash_attention", q=(q, q.dtype, None),
               k=(k, q.dtype, (b, hkv, skv, dh)),
               v=(v, q.dtype, (b, hkv, skv, dh)))
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: hq = {hq} is not a multiple of "
                         f"hkv = {hkv}")
    p = plan(q.dtype, dh)
    grid_y = b * hq if p.route == "simt" else -(-sq // p.block_q)
    if grid_y > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: {p.route} route's grid y "
                         f"{grid_y} > {_MAX_GRID_Y} (b * hq for simt, query "
                         "tiles for wgmma)")
    for name, val in (("window", window or 0), ("q_offset", q_offset),
                      ("sq", sq), ("skv", skv), ("b * hq", b * hq)):
        if abs(val) > _I32:
            raise ValueError(f"flash_attention: {name} = {val} does not "
                             "fit int32")
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    if q.numel() == 0:
        return torch.empty_like(q)
    if k.numel() == 0:  # no key: every row is masked
        return torch.zeros_like(q)
    if p.route == "wgmma":
        q, k, v = (pad_head_dim(t, p.dh_pad) for t in (q, k, v))
    out = torch.empty_like(q)
    _build.launch(p.entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, hq, hkv, sq, skv, p.dh_pad,
                  int(causal), int(window is not None), int(window or 0),
                  int(q_offset), float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out if p.dh_pad == dh else out[..., :dh].contiguous()


#: bytes of f32 scores the backward recomputes at once (batch rows are
#: taken in chunks that fit)
_BWD_SCORE_BYTES = 1 << 28


def attention_vjp(q, k, v, dout, *, causal: bool, window: Optional[int],
                  q_offset: int, scale: Optional[float], needs=(1, 1, 1)):
    """(dq, dk, dv) of :func:`repro_torch.kernels.ref.attention` at (q,
    k, v) against ``dout``, by autograd through it, a chunk of batch rows
    at a time (rows are independent); None where ``needs`` is false."""
    b, hq, sq, _ = q.shape
    per_row = hq * sq * max(k.shape[2], 1) * 4
    step = max(1, _BWD_SCORE_BYTES // max(per_row, 1))
    grads = [[], [], []]
    for lo in range(0, b, step):
        ins = [t[lo:lo + step].detach().requires_grad_(bool(n))
               for t, n in zip((q, k, v), needs)]
        with torch.enable_grad():
            out = _ref.attention(*ins, causal=causal, window=window,
                                 q_offset=q_offset, scale=scale)
            want = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, want, dout[lo:lo + step]))
        for i, t in enumerate(ins):
            grads[i].append(next(got) if t.requires_grad else None)
    return tuple(torch.cat(g) if n else None for g, n in zip(grads, needs))


class FlashAttention(torch.autograd.Function):
    """GQA attention with a gradient: forward through the kernel when
    ``on_card`` (else the plain version), backward through
    :func:`attention_vjp`.  Saves q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, on_card):
        opts = {"causal": causal, "window": window, "q_offset": q_offset,
                "scale": scale}
        ctx.opts = opts
        ctx.save_for_backward(q, k, v)
        if on_card:
            return flash_attention(q, k, v, **opts)
        return _ref.attention(q, k, v, **opts)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_vjp(q, k, v, dout.contiguous(), **ctx.opts,
                                   needs=ctx.needs_input_grad[:3])
        return dq, dk, dv, None, None, None, None, None
