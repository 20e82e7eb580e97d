"""Logical-axis sharding over a ``torch.distributed`` ``DeviceMesh``.

Mirror of ``repro.sharding.axes``.  Every parameter, cache and
activation dimension carries a *logical* name; :data:`LOGICAL_RULES` maps
names to mesh axes.  A mesh axis is applied only when the dimension's
size divides the axis extent (times the extents already kept for it),
and each mesh axis is used once per tensor — otherwise the dimension
stays replicated (e.g. hymba's 25 heads or whisper's 12 heads on a
``model`` axis of 2 or 4).

Parallelism map (mesh axes ``pod``, ``data``, ``model``):
  DP   : ``batch -> (pod, data)``
  FSDP : ``embed -> data``  (parameters sharded over the data ranks)
  TP   : ``heads/kv_heads/mlp/vocab -> model``
  EP   : ``experts -> model``
  SP   : ``cache_seq -> model`` (sequence-sharded decode attention)

The JAX constructs and their counterparts here: a ``PartitionSpec`` is a
tuple of per-dimension entries (``None``, an axis name or a tuple of
names), :func:`logical_to_spec` returns the reference's entries exactly;
a ``NamedSharding`` is the DTensor placement list of :func:`placements`
(``Shard(i)`` on each mesh dimension that dimension ``i`` uses,
``Replicate()`` elsewhere); ``with_sharding_constraint`` is
``DTensor.redistribute`` (:func:`shard_activation`).

A mesh is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``), or with the reference's ``axis_names`` and
``devices.shape`` — so a plain object stands in for a JAX mesh in the
tests and for a mesh of cards in ``launch.dryrun``'s per-card reckoning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# logical axis -> mesh axis (or tuple of mesh axes, or None)
LOGICAL_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",        # FSDP shard of the contracting dim
    "embed_r": None,        # replicated variant (embedding/head tables)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_cap": None,
    "vocab": "model",
    "layers": None,
    "groups": None,
    "conv": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_inner": "model",
    "cache_batch": ("pod", "data"),
    "cache_seq": "model",
    "patch": None,
    "frames": None,
    "act_embed": None,      # activation d_model dim (replicated by default)
    "act_decode_embed": "data",  # decode: embed-sharded activations so the
                                 # FSDP weights are consumed shard-local
                                 # (partial-sum all-reduce << weight gather)
    "act_seq": "model",     # sequence-parallel residual stream (opt-in)
    "act_mlp": "model",     # activation ff dim under TP
    "act_heads": "model",
    "act_vocab": "model",
}

Spec = Tuple[Any, ...]   # per-dimension entries, the reference's P(*spec)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _mesh_sizes(mesh) -> Dict[str, int]:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        shape = tuple(mesh.shape)
    else:
        shape = tuple(mesh.devices.shape)
    return dict(zip(mesh_axis_names(mesh), shape))


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    dims: Sequence[int], mesh,
                    rules: Optional[Dict[str, Any]] = None) -> Spec:
    """Resolve logical axis names to per-dimension mesh-axis entries,
    dropping mesh axes that don't divide the dimension, that the mesh
    lacks, or that an earlier dimension already uses."""
    rules = rules if rules is not None else LOGICAL_RULES
    sizes = _mesh_sizes(mesh)
    used = set()
    out = []
    for name, dim in zip(logical_axes, dims):
        assigned = rules.get(name) if name is not None else None
        if assigned is None:
            out.append(None)
            continue
        axes = assigned if isinstance(assigned, tuple) else (assigned,)
        keep = []
        extent = 1
        for ax in axes:
            if ax not in sizes or ax in used:
                continue
            if dim % (extent * sizes[ax]) == 0:
                keep.append(ax)
                extent *= sizes[ax]
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return tuple(out)


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_zip_map(fn, axes_tree, other):
    """``fn(axes, leaf)`` over an axes tree and a tree of the same
    structure (dicts and lists)."""
    if is_axes(axes_tree):
        return fn(axes_tree, other)
    if isinstance(axes_tree, dict):
        return {k: tree_zip_map(fn, v, other[k])
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_zip_map(fn, a, o)
                               for a, o in zip(axes_tree, other))
    raise TypeError(f"not an axes tree node: {type(axes_tree)}")


def spec_tree(axes_tree: Any, shape_tree: Any, mesh,
              rules: Optional[Dict[str, Any]] = None) -> Any:
    """A tree of logical-axes tuples and a matching tree of shaped leaves
    (tensors, or anything with ``.shape``) -> a tree of specs."""
    return tree_zip_map(
        lambda axes, leaf: logical_to_spec(axes, tuple(leaf.shape), mesh,
                                           rules),
        axes_tree, shape_tree)


def placements(spec: Spec, mesh) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh
    dimension ``Shard(i)`` when tensor dimension ``i``'s entry names it,
    else ``Replicate()``.  A dimension over several mesh axes (``batch``
    over ``(pod, data)``) is split over them in the mesh's order, as
    the reference's tuple entry splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out: List[Any] = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        entries = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(e) for e in entries]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for j in idx:
            out[j] = Shard(i)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's block of a tensor of ``shape`` laid out by ``spec``."""
    sizes = _mesh_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        entries = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        for e in entries:
            dim //= sizes[e]
        out.append(dim)
    return tuple(out)


def shard_activation(x, logical_axes: Sequence[Optional[str]], mesh=None):
    """``redistribute`` ``x`` to the placements of its logical axes (the
    reference's ``with_sharding_constraint``); ``x`` unchanged outside a
    mesh (``mesh=None``: the port passes its mesh explicitly, where the
    reference reads the one of its ``with mesh:`` block).  A plain tensor
    on a mesh is taken as replicated."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = placements(logical_to_spec(logical_axes, tuple(x.shape), mesh),
                      mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def distribute(t: torch.Tensor, axes: Sequence[Optional[str]], mesh):
    """A full tensor (the same on every rank) placed on ``mesh`` by its
    logical axes: each rank keeps its block, nothing is sent."""
    pl = placements(logical_to_spec(axes, tuple(t.shape), mesh), mesh)
    return NamedSharding(mesh, tuple(pl)).place(t)


def local_block(t: torch.Tensor, pl, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under placements
    ``pl`` (contiguous; ``t`` itself when nothing splits it)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    local = t
    for mdim, p in enumerate(pl):
        if isinstance(p, Shard):
            local = local.tensor_split(mesh.size(mdim), dim=p.dim)[
                coord[mdim]]
    return local.contiguous()


def zeros(shape: Sequence[int], axes: Sequence[Optional[str]], mesh, *,
          dtype, device):
    """A zero tensor of ``shape`` placed on ``mesh`` by its logical axes,
    each rank allocating only its block."""
    from torch.distributed.tensor import DTensor

    spec = logical_to_spec(axes, tuple(shape), mesh)
    local = torch.zeros(local_shape(shape, spec, mesh), dtype=dtype,
                        device=device)
    full = torch.empty(tuple(shape), device="meta")
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: ``meta`` in a world of no devices
    (a ``"fake"`` process group, ``launch.mesh.abstract_world``)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        return torch.device("meta")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a placement list: the counterpart of the reference's
    ``jax.sharding.NamedSharding`` (a mesh and a ``PartitionSpec``)."""
    mesh: Any
    placements: Tuple[Any, ...]

    def place(self, t: torch.Tensor):
        """The full tensor ``t`` (the same on every rank) as a DTensor on
        this rank's device of the mesh, each rank keeping its block,
        nothing sent: the counterpart of ``jax.device_put(arr,
        sharding)``.  A ``meta`` ``t`` gives ``meta`` blocks (the
        reference's ``ShapeDtypeStruct`` with a sharding)."""
        from torch.distributed.tensor import DTensor

        meta = t.device.type == "meta"
        if not meta:
            t = t.to(mesh_device(self.mesh))
        pl = list(self.placements)
        local = local_block(t, pl, self.mesh)
        if meta:
            local = torch.empty_like(local)  # its own block, not a view
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())


def spec_of(placements_, mesh, ndim: int) -> Spec:
    """The per-dimension spec entries of ``placements_`` on ``mesh``
    (the inverse of :func:`placements`): ``None``, an axis name, or a
    tuple of names in the mesh's order."""
    names = mesh_axis_names(mesh)
    from torch.distributed.tensor import Shard

    out = []
    for i in range(ndim):
        axes = tuple(n for n, p in zip(names, placements_)
                     if isinstance(p, Shard) and p.dim == i)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


def sharding_tree(axes_tree: Any, shape_tree: Any, mesh,
                  rules: Optional[Dict[str, Any]] = None) -> Any:
    """A tree of :class:`NamedSharding` of ``mesh`` by logical axes (the
    reference's ``NamedSharding(mesh, spec)`` over :func:`spec_tree`).
    A 0-d leaf gets None: it has nothing to place, and stays where it is
    (the optimizer's step, a host scalar)."""
    return tree_zip_map(
        lambda axes, leaf: None if len(leaf.shape) == 0 else NamedSharding(
            mesh, tuple(placements(logical_to_spec(
                axes, tuple(leaf.shape), mesh, rules), mesh))),
        axes_tree, shape_tree)
