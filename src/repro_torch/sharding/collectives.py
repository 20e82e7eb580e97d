"""What a block's body needs of the mesh, on local shards.

The models' mesh path runs each block (attention, MLP, MoE, the Mamba-2
mixer, the embedding and the head) under
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

    def all_reduce(self, t: torch.Tensor, axes: Axes,
                   op: str = "sum") -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol

        for a in self._live(axes):
            t = _wait(funcol.all_reduce(t, op, self._group(a)))
        return t

    def all_gather(self, t: torch.Tensor, axes: Axes,
                   dim: int) -> torch.Tensor:
        """The blocks of every rank along ``axes``, concatenated on
        ``dim`` in rank order (the inner axis first, then the outer)."""
        from torch.distributed import _functional_collectives as funcol

        gather = getattr(funcol, "all_gather_single", None) \
            or funcol.all_gather_tensor
        dim %= t.ndim
        for a in reversed(self._live(axes)):
            t = _wait(gather(t.contiguous(), dim, self._group(a)))
        return t

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t``'s dim 0 in ``size(axis)`` equal chunks, chunk j sent to
        rank j; the result's chunk i came from rank i."""
        from torch.distributed import _functional_collectives as funcol

        if axis not in self._live(axis):
            return t
        return _wait(funcol.all_to_all_single(t.contiguous(), None, None,
                                              self._group(axis)))
