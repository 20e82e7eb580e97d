"""What a block's body needs of the mesh, on local shards.

The models' mesh path runs each block (attention, MLP, MoE, the Mamba-2
mixer, the embedding, the head and the loss) under
``torch.distributed.tensor.experimental.local_map``: the body sees each
rank's local tensors, as a ``shard_map`` body sees them in the
reference, and calls the collectives of :class:`Local` over a named mesh
axis — ``torch.distributed``'s functional collectives on the axis's
process group, the counterparts of ``jax.lax.psum`` / ``pmax`` /
``all_gather`` / ``all_to_all``.  A collective over an axis of extent 1
(or one the mesh lacks) is the identity and sends nothing; off a mesh
(``Local(None)``, :meth:`Local.of` a plain tensor) every axis has extent
1, so one body serves both: run directly on plain tensors, or under
``local_map`` on a mesh.

The collectives are differentiable, by the rules of JAX's ``shard_map``
with replication typing (a value is either the same on every rank of
an axis or differs between them), decided at each call site:

* ``all_reduce(..., grad="identity")``: every rank goes on with the
  whole reduced value (an output projection's partial sums, the MoE
  aux, the loss's sums).  Each rank's cotangent is then already the
  whole one, and the backward passes it through (Megatron's "g"; in
  JAX ``psum`` transposes to ``pbroadcast``).
* ``all_reduce(..., grad="sum")``: the reduced value feeds work that
  differs by rank (the RMS variance over a sharded embed, each rank
  normalising its slice).  Each rank holds a share of the cotangent,
  and the backward sums them over the axis (JAX puts a ``pbroadcast``
  before such a use, whose transpose is ``psum``).
* ``all_reduce(..., "max")`` is decode's and has no gradient: it raises
  if one is asked of it.
* ``all_gather`` feeds rank-local work on the whole (the Mamba-2
  mixer's ``w_in`` blocks): its backward sums the cotangents and keeps
  this rank's block (a reduce-scatter).  ``all_to_all``'s backward is
  the same exchange of the cotangent.

A body's inputs that are whole over an axis its work is split over
take their gradient as a partial sum over that axis (``local_map``'s
``in_grad_placements``, set by :func:`repro_torch.models.layers.
on_shards`).  Where no gradient is taken each collective is the plain
functional one, so prefill and decode run the collectives they ran.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from .axes import _mesh_sizes, mesh_axis_names

Axes = Union[str, Sequence[str], None]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _wait(t):
    """The plain tensor of a functional collective's result."""
    from torch.distributed import _functional_collectives as funcol

    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class Local:
    """This rank's place on ``mesh`` and the collectives over its axes
    (``mesh=None``: no axes, size 1 and rank 0 on every one)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.names = () if mesh is None else mesh_axis_names(mesh)
        self.sizes = {} if mesh is None else _mesh_sizes(mesh)
        coord = None if mesh is None else mesh.get_coordinate()
        self.coord = dict(zip(self.names, coord if coord is not None
                              else [0] * len(self.names)))

    @classmethod
    def of(cls, t) -> "Local":
        """The place of a DTensor ``t`` on its mesh; none for a plain
        tensor."""
        return cls(getattr(t, "device_mesh", None))

    def size(self, axes: Axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.sizes.get(a, 1)
        return n

    def rank(self, axes: Axes) -> int:
        """This rank's index along ``axes`` taken together, the first
        axis major (the order a tuple spec entry splits a dimension)."""
        r = 0
        for a in _axes(axes):
            r = r * self.sizes.get(a, 1) + self.coord.get(a, 0)
        return r

    def _live(self, axes: Axes) -> Tuple[str, ...]:
        return tuple(a for a in _axes(axes) if self.sizes.get(a, 1) > 1)

    def _group(self, axis: str):
        return (self.mesh, self.names.index(axis))

    def all_reduce(self, t: torch.Tensor, axes: Axes, op: str = "sum",
                   grad: str = "identity") -> torch.Tensor:
        """``t`` reduced over ``axes`` by ``op`` ("sum" or "max");
        ``grad``, a sum's backward: "identity" where every rank goes on
        with the whole value, "sum" where it feeds rank-local work."""
        from torch.distributed import _functional_collectives as funcol

        if grad not in ("identity", "sum"):
            raise ValueError(f"all_reduce grad {grad!r}")
        for a in self._live(axes):
            if _takes_grad(t):
                if op != "sum":
                    raise RuntimeError(f"all_reduce({op!r}) has no "
                                       f"gradient")
                t = _AllReduce.apply(t, self._group(a), grad)
            else:
                t = _wait(funcol.all_reduce(t, op, self._group(a)))
        return t

    def all_gather(self, t: torch.Tensor, axes: Axes,
                   dim: int) -> torch.Tensor:
        """The blocks of every rank along ``axes``, concatenated on
        ``dim`` in rank order (the inner axis first, then the outer);
        the backward sums the cotangents and keeps this rank's block."""
        dim %= t.ndim
        for a in reversed(self._live(axes)):
            if _takes_grad(t):
                t = _AllGather.apply(t, self._group(a), dim)
            else:
                t = _gather(t, self._group(a), dim)
        return t

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t``'s dim 0 in ``size(axis)`` equal chunks, chunk j sent to
        rank j; the result's chunk i came from rank i.  The backward is
        the same exchange of the cotangent."""
        if axis not in self._live(axis):
            return t
        if _takes_grad(t):
            return _AllToAll.apply(t, self._group(axis))
        return _exchange(t, self._group(axis))


def _takes_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _gather(t, group, dim: int):
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    return _wait(gather(t.contiguous(), dim, group))


def _exchange(t, group):
    from torch.distributed import _functional_collectives as funcol

    return _wait(funcol.all_to_all_single(t.contiguous(), None, None,
                                          group))


class _AllReduce(torch.autograd.Function):
    """A sum over one axis whose backward is the identity or a sum."""

    @staticmethod
    def forward(ctx, t, group, grad):
        from torch.distributed import _functional_collectives as funcol

        ctx.group, ctx.grad = group, grad
        return _wait(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        if ctx.grad == "sum":
            g = _wait(funcol.all_reduce(g.contiguous(), "sum", ctx.group))
        return g, None, None


class _AllGather(torch.autograd.Function):
    """A gather over one axis whose backward is a reduce-scatter."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        scatter = getattr(funcol, "reduce_scatter_single", None) \
            or funcol.reduce_scatter_tensor
        return _wait(scatter(g.contiguous(), "sum", ctx.dim,
                             ctx.group)), None, None


class _AllToAll(torch.autograd.Function):
    """An equal-split exchange over one axis, its own backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None
