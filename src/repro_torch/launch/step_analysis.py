"""Per-step FLOPs, device-memory traffic and live bytes of one step
function, counted over the PyTorch operations it runs.

The single-card counterpart of ``repro.launch.hlo_analysis``.  The
reference compiles a step with XLA and parses the optimised HLO; a
PyTorch step has no HLO to parse, so this module runs the step itself
under a ``TorchDispatchMode`` and counts each aten operation it
dispatches, on ``meta`` tensors: no allocation, no card, full published
size.  The counts follow the reference's definitions:

* FLOPs: ``2 · |result| · |contracting dims|`` for matrix products only
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``: what
  ``matmul``, ``einsum`` and ``linear`` lower to), as ``_dot_flops``
  counts HLO ``dot`` ops.  Elementwise work is not counted, and neither
  is convolution: the reference's analysis counts ``dot`` alone, and no
  model here convolves (the Mamba-2 conv is a sum of shifted products).
* Device-memory bytes: Σ (operands + results) over the operations that
  launch a kernel; views and aliases (``view``, ``t``, ``expand``,
  ``slice``, ``detach``, ...) and metadata reads are free.  It is the
  counterpart of the reference's "top-level kernels" proxy: an upper
  bound in the same sense (a fused kernel would read and write less).
* Collective bytes: 0 on one card.  The key stays so that records keep
  the reference's schema.

Beyond the reference, :func:`analyze_step` also reports
``peak_bytes_per_device``: the step's arguments plus the largest total of
tensors allocated by the step and alive at once (each freed when its
last reference goes, as the caching allocator sees it, without the
allocator's rounding and workspaces).

On ``meta`` tensors ``ops.attention`` takes the plain attention (only a
CUDA tensor launches the flash kernel), so the count is the work the
reference's HLO counts — every (query, key) pair of the score matrix,
masked or not — not the flash kernel's skipped tiles.  A step that reads
a tensor's value on the host cannot run on ``meta``; the steps of
``repro_torch.launch.cells`` read only host scalars (the optimizer's
step counter lives on the CPU, and operations on CPU tensors are not
counted).
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: operations that launch no kernel: aliases and metadata reads (views
#: are found from their schema)
_FREE = {
    aten._unsafe_view.default, aten.detach.default, aten.alias.default,
    aten.lift_fresh.default, aten.empty.memory_format,
    aten.empty_strided.default, aten._local_scalar_dense.default,
}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args, out) -> float:
    """2 · |result| · |contracting| of a matrix product, else 0."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.bmm, aten.mv, aten.dot, aten.vdot):
        a = args[0]
    elif packet in (aten.addmm, aten.baddbmm, aten.addmv):
        a = args[1]
    else:
        return 0.0
    return 2.0 * out.numel() * a.shape[-1]


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and live bytes of the operations dispatched on
    ``device`` while it is active."""

    def __init__(self, device: torch.device, live_bytes: int = 0):
        super().__init__()
        self.device = device
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ops = 0
        self.live = live_bytes
        self.peak = live_bytes

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _kind(func)
        if kind == "free":
            return out
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if not any(t.device == self.device for t in ins + outs):
            return out
        self.ops += 1
        self.flops += _matmul_flops(func, args, out)
        self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        if kind == "allocates":
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


_KINDS: Dict[Any, str] = {}


def _kind(func) -> str:
    """``free`` (a view, an alias or a metadata read), ``inplace`` (writes
    into an argument) or ``allocates`` (new outputs)."""
    kind = _KINDS.get(func)
    if kind is None:
        if func in _FREE or func.is_view:
            kind = "free"
        elif any(r.alias_info is not None and r.alias_info.is_write
                 for r in func._schema.returns):
            kind = "inplace"
        else:
            kind = "allocates"
        _KINDS[func] = kind
    return kind


def tree_bytes(*trees) -> int:
    """Bytes of the distinct tensors in ``trees``: a tensor met twice,
    or a view of one already counted, counts once (on ``meta``, where
    every storage sits at address 0, views are told apart by their
    base)."""
    seen, total = set(), 0
    for t in _tensors(list(trees)):
        base = t if t._base is None else t._base
        key = (id(base) if t.device.type == "meta"
               else (t.device, t.untyped_storage().data_ptr()))
        if key not in seen:
            seen.add(key)
            total += _nbytes(base)
    return total


def analyze_step(fn: Callable, *args: Any) -> Dict[str, float]:
    """Run ``fn(*args)`` once under :class:`StepCounter` and return the
    reference's per-device keys (``flops_per_device``,
    ``hbm_bytes_per_device``, ``collective_bytes_per_device``) plus
    ``peak_bytes_per_device`` and the number of counted operations.

    ``args`` are normally ``meta`` tensors (a ``Cell`` built with
    ``device="meta"``); the counts are taken on the device of the first
    tensor in them that is not on the CPU (the CPU when all are)."""
    tensors = _tensors(list(args))
    if not tensors:
        raise ValueError("analyze_step: no tensor among the arguments")
    device = next((t.device for t in tensors if t.device.type != "cpu"),
                  tensors[0].device)
    state = tree_bytes(*[t for t in tensors if t.device == device])
    counter = StepCounter(device, live_bytes=state)
    with counter:
        result = fn(*args)
    del result
    return {"flops_per_device": counter.flops,
            "hbm_bytes_per_device": counter.hbm_bytes,
            "collective_bytes_per_device": 0.0,
            "peak_bytes_per_device": counter.peak,
            "counted_ops": counter.ops}

