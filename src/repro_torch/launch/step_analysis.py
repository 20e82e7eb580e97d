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
* Collective bytes: the wire bytes a rank sends for each functional
  collective it dispatches (``torch.distributed``'s ``_c10d_functional``
  ops, which the mesh path's ``Local`` collectives and DTensor's
  redistributions both lower to), by the reference's formulas
  (``hlo_analysis.py``), over a group of ``g`` ranks and a result of
  ``size`` bytes: all-reduce ``2 · size · (g - 1) / g``, reduce-scatter
  ``size · (g - 1)``, all-gather and all-to-all ``size · (g - 1) / g``;
  totalled in ``collective_bytes_per_device`` and by kind in
  ``per_collective`` under the reference's names.  Waits are free; a
  group of one sends nothing; 0 on one card.

On a mesh (a cell built by ``build_cell(arch, shape, mesh)`` in
``launch.mesh.abstract_world``) the arguments are DTensors of ``meta``
blocks.  An operation on DTensors is not counted itself: the counter
defers it to DTensor, and counts the local operations and collectives
DTensor runs for it on this rank's blocks (its sharding propagation,
which runs on fake tensors, is not counted).  So every count is one
rank's.

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
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: the functional collectives by the reference's names, and each one's
#: wire bytes from its result's bytes and its group's size
_WIRE = {
    "all_reduce": ("all-reduce", lambda n, g: 2.0 * n * (g - 1) / g),
    "all_gather_into_tensor": ("all-gather", lambda n, g: n * (g - 1) / g),
    "reduce_scatter_tensor": ("reduce-scatter", lambda n, g: n * (g - 1)),
    "all_to_all_single": ("all-to-all", lambda n, g: n * (g - 1) / g),
}
#: functional-collective operations that send nothing
_NO_WIRE = {"wait_tensor", "_wrap_tensor_autograd"}

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


def local_tensors(*trees) -> List[torch.Tensor]:
    """The tensors of ``trees``, a DTensor as this rank's local block."""
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in _tensors(list(trees))]


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


def _group_size(args) -> int:
    """The size of the group a functional collective runs over (its
    last argument names the group)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collective bytes and live bytes of the
    operations dispatched on ``device`` while it is active."""

    def __init__(self, device: torch.device, live_bytes: int = 0):
        super().__init__()
        self.device = device
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = 0.0
        self.per_collective: Dict[str, float] = {}
        self.ops = 0
        self.live = live_bytes
        self.peak = live_bytes

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs it on the local blocks, through this mode
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out      # DTensor's sharding propagation: no kernel
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
        if func.namespace == "_c10d_functional":
            self._collective(func, args, outs)
        if kind == "allocates":
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out

    def _collective(self, func, args, outs) -> None:
        name = func.overloadpacket.__name__.removesuffix("_coalesced")
        if name not in _WIRE:
            raise NotImplementedError(f"StepCounter: no wire-byte rule "
                                      f"for {func}")
        kind, wire = _WIRE[name]
        g = _group_size(args)
        sent = sum(wire(_nbytes(t), g) for t in outs) if g > 1 else 0.0
        self.collective_bytes += sent
        self.per_collective[kind] = self.per_collective.get(kind, 0.0) + sent


_KINDS: Dict[Any, str] = {}


def _kind(func) -> str:
    """``free`` (a view, an alias or a metadata read), ``inplace`` (writes
    into an argument) or ``allocates`` (new outputs)."""
    kind = _KINDS.get(func)
    if kind is None:
        if func in _FREE or func.is_view or (
                func.namespace == "_c10d_functional"
                and func.overloadpacket.__name__ in _NO_WIRE):
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


def analyze_step(fn: Callable, *args: Any) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under :class:`StepCounter` and return the
    reference's per-device keys (``flops_per_device``,
    ``hbm_bytes_per_device``, ``collective_bytes_per_device``,
    ``per_collective``) plus ``peak_bytes_per_device`` and the number of
    counted operations.

    ``args`` are normally ``meta`` tensors (a ``Cell`` built with
    ``device="meta"``, or on a mesh in an abstract world); the counts are
    taken on the device of the first tensor in them (a DTensor's local
    block) that is not on the CPU (the CPU when all are)."""
    tensors = local_tensors(*args)
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
            "collective_bytes_per_device": counter.collective_bytes,
            "per_collective": counter.per_collective,
            "peak_bytes_per_device": counter.peak,
            "counted_ops": counter.ops}

