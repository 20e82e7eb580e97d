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
``ops.attention`` runs that).  :func:`bwd_plan` routes its backward by
dtype and head_dim: bf16 at ``dh_pad <= 128`` to ``attention_bwd_sm90``
(beside the forward in ``flash_attention_sm90.cu``), which recomputes P
from the log-sum-exp that the forward then stores, as the flash
backward does; f32, the 256 bucket and the CPU to the gradient of the
plain version, in plain PyTorch (:func:`attention_vjp`).  The reference
has no backward kernel; it differentiates its plain
``chunked_attention`` through XLA.  The kernel's algorithm in plain
PyTorch is :func:`repro_torch.kernels.ref.attention_bwd`.
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


def lse_rows(sq: int) -> int:
    """Rows of each head in the log-sum-exp the bf16 forward stores for
    the backward: sq rounded up to the 128-row query tile."""
    return -(-sq // 128) * 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    with_lse: bool = False):
    """q (b, hq, sq, dh), k and v (b, hkv, skv, dh) on the card ->
    (b, hq, sq, dh) in q's dtype.  ``with_lse`` (the bf16 route at a
    bucket the backward takes): also each row's log-sum-exp, f32 (b, hq,
    :func:`lse_rows`), +inf past sq and where every key is masked —
    ``(out, lse)``."""
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
    # analysis: allow[HOT001] five host ints, checked before the launch
    for name, val in (("window", window or 0), ("q_offset", q_offset),
                      ("sq", sq), ("skv", skv), ("b * hq", b * hq)):
        if abs(val) > _I32:
            raise ValueError(f"flash_attention: {name} = {val} does not "
                             "fit int32")
    if with_lse and bwd_plan(q.dtype, dh) != "wgmma":
        raise ValueError(f"flash_attention: no log-sum-exp on the "
                         f"{p.route} route at head_dim {dh}")
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    lse = torch.empty((b, hq, lse_rows(sq)), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if q.numel() == 0 or k.numel() == 0:  # no key: every row is masked
        out = torch.zeros_like(q)
        if with_lse:
            lse.fill_(float("inf"))
    else:
        if p.route == "wgmma":
            q, k, v = (pad_head_dim(t, p.dh_pad) for t in (q, k, v))
        out = torch.empty_like(q)
        lse_ptr = () if p.route == "simt" else (
            lse.data_ptr() if with_lse else None,)
        _build.launch(p.entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), *lse_ptr, b, hq, hkv, sq, skv,
                      p.dh_pad, int(causal), int(window is not None),
                      int(window or 0), int(q_offset), float(scale),
                      torch.cuda.current_stream(q.device).cuda_stream)
        if p.dh_pad != dh:
            out = out[..., :dh].contiguous()
    return (out, lse) if with_lse else out


#: keys of one block of the dk / dv kernel
BWD_BLOCK_K = 128
#: blocks a card's SM should get from the dk / dv kernel at least
BWD_BLOCKS_PER_SM = 2


def bwd_plan(dtype: torch.dtype, dh: int) -> str:
    """The backward's route by dtype and head_dim: ``"wgmma"`` (the
    ``attention_bwd_sm90`` entry, padded to :func:`plan`'s ``dh_pad``)
    for the bf16 route at ``dh_pad <= 128``; ``"plain"``
    (:func:`attention_vjp`) for f32 (held to 2e-5, which no bf16 product
    meets) and the 256 bucket."""
    p = plan(dtype, dh)
    return "wgmma" if p.route == "wgmma" and p.bucket <= 128 else "plain"


def kv_splits(b: int, hq: int, hkv: int, skv: int, sms: int) -> int:
    """Slices of each kv head's query heads that the dk / dv kernel gives
    blocks of their own (summed afterwards), so that it launches at least
    ``BWD_BLOCKS_PER_SM`` blocks per SM where the heads allow: MQA at
    short rows has few (batch row, kv head, key tile) blocks otherwise.
    No slice is empty."""
    group = hq // hkv
    blocks = b * hkv * max(1, -(-skv // BWD_BLOCK_K))
    want = min(group, max(1, -(-BWD_BLOCKS_PER_SM * sms // blocks)))
    per = group // want
    return -(-group // per)


def attention_bwd(q, k, v, out, lse, dout, *, causal: bool,
                  window: Optional[int], q_offset: int,
                  scale: Optional[float]):
    """(dq, dk, dv) of the bf16 forward at (q, k, v) against ``dout``
    through ``attention_bwd_sm90``, from its output ``out`` and ``lse``
    (:func:`flash_attention` with ``with_lse``).  A row whose keys are all
    masked has output 0 in the forward, so its gradient is that of 0."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if bwd_plan(q.dtype, dh) != "wgmma":
        raise ValueError(f"attention_bwd: no backward kernel for "
                         f"{q.dtype} at head_dim {dh}")
    check_cuda("attention_bwd", q=(q, q.dtype, None),
               k=(k, q.dtype, (b, hkv, skv, dh)),
               v=(v, q.dtype, (b, hkv, skv, dh)),
               out=(out, q.dtype, (b, hq, sq, dh)),
               dout=(dout, q.dtype, (b, hq, sq, dh)),
               lse=(lse, torch.float32, (b, hq, lse_rows(sq))))
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if -(-skv // BWD_BLOCK_K) > _MAX_GRID_Y:
        raise ValueError(f"attention_bwd: {-(-skv // BWD_BLOCK_K)} key tiles"
                         f" > {_MAX_GRID_Y}")
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    p = plan(q.dtype, dh)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = kv_splits(b, hq, hkv, skv, sms)
    qp, kp, vp, dop = (pad_head_dim(t, p.dh_pad) for t in (q, k, v, dout))
    delta = torch.empty((b, hq, lse_rows(sq)), dtype=torch.float32,
                        device=q.device)
    dq = torch.empty_like(qp)
    dk = torch.empty((n_split, b, hkv, skv, p.dh_pad), dtype=torch.float32,
                     device=q.device)
    dv = torch.empty_like(dk)
    _build.launch("attention_bwd_sm90", qp.data_ptr(), kp.data_ptr(),
                  vp.data_ptr(), out.data_ptr(), dop.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, skv, dh, p.dh_pad,
                  int(causal), int(window is not None), int(window or 0),
                  int(q_offset), float(scale), n_split,
                  torch.cuda.current_stream(q.device).cuda_stream)
    # the slices' f32 partials in a fixed order, then bf16
    dk, dv = ((t[0] if n_split == 1 else t.sum(0)).to(q.dtype)
              for t in (dk, dv))
    if p.dh_pad != dh:
        dq, dk, dv = (t[..., :dh].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


#: bytes of f32 scores the backward recomputes at once (batch rows are
#: taken in chunks that fit)
_BWD_SCORE_BYTES = 1 << 28


def attention_vjp(q, k, v, dout, *, causal: bool, window: Optional[int],
                  q_offset: int, scale: Optional[float],
                  needs=(True, True, True)):
    """(dq, dk, dv) of :func:`repro_torch.kernels.ref.attention` at (q,
    k, v) against ``dout``, by autograd through it, a chunk of batch rows
    at a time (rows are independent); None where ``needs`` is false."""
    b, hq, sq, _ = q.shape
    per_row = hq * sq * max(k.shape[2], 1) * 4
    step = max(1, _BWD_SCORE_BYTES // max(per_row, 1))
    grads = [[], [], []]
    # analysis: allow[HOT001] batch rows in chunks bound the scores' memory
    for lo in range(0, b, step):
        ins = [t[lo:lo + step].detach().requires_grad_(n)
               for t, n in zip((q, k, v), needs)]
        with torch.enable_grad():
            out = _ref.attention(*ins, causal=causal, window=window,
                                 q_offset=q_offset, scale=scale)
            want = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, want, dout[lo:lo + step]))
        for i, t in enumerate(ins):  # analysis: allow[HOT001] q, k and v
            grads[i].append(next(got) if t.requires_grad else None)
    return tuple(torch.cat(g) if n else None for g, n in zip(grads, needs))


class FlashAttention(torch.autograd.Function):
    """GQA attention with a gradient: forward through the kernel when
    ``on_card`` (else the plain version).  Where :func:`bwd_plan` sends
    the backward to the kernel, the forward also stores each row's
    log-sum-exp and saves q, k, v, the output and it, and the backward is
    :func:`attention_bwd`; else it saves q, k and v and the backward is
    :func:`attention_vjp` (counted in ``_build.PLAIN_ON_CARD`` after a
    kernel forward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, on_card):
        opts = {"causal": causal, "window": window, "q_offset": q_offset,
                "scale": scale}
        ctx.opts = opts
        ctx.on_card = on_card
        ctx.kernel = on_card and bwd_plan(q.dtype, q.shape[-1]) == "wgmma"
        if ctx.kernel:
            out, lse = flash_attention(q, k, v, with_lse=True, **opts)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        if on_card:
            return flash_attention(q, k, v, **opts)
        return _ref.attention(q, k, v, **opts)

    @staticmethod
    def backward(ctx, dout):
        needs = ctx.needs_input_grad[:3]
        if ctx.kernel:
            q, k, v, out, lse = ctx.saved_tensors
            grads = attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                  **ctx.opts)
            dq, dk, dv = (g if n else None for g, n in zip(grads, needs))
        else:
            q, k, v = ctx.saved_tensors
            if ctx.on_card:
                _build.count_plain("attention_vjp")
            dq, dk, dv = attention_vjp(q, k, v, dout.contiguous(),
                                       **ctx.opts, needs=needs)
        return dq, dk, dv, None, None, None, None, None
