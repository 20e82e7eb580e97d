"""Mesh construction over ``torch.distributed``.

Mirror of ``repro.launch.mesh``.  The reference builds JAX meshes over a
TPU pod (16 x 16 chips, axes ``(data, model)``; two pods add ``pod``);
here a mesh is a ``DeviceMesh`` over the processes of one
``torch.distributed`` world, one process per device — NCCL on ``cuda``
(one card per process, ``cuda:<local rank>``), gloo on ``cpu``.
Functions, not module constants, so that importing this module starts
nothing.

:func:`init_distributed` joins (or starts) the world: ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or the rank, world size and address a spawning helper
passes; alone (no environment, world 1) it starts a one-process world
on an in-memory store.  It raises when the backend cannot start.

Usage, on every rank of a world:
  torchrun --nproc-per-node 4 -m repro_torch.launch.cells --mesh 1x4 ...
  mesh = make_host_mesh(model=2, data=2)        # after init_distributed

:func:`abstract_world` stands in for a world of cards in one process, to
analyse a step on a mesh without the cards (``launch.dryrun --mesh``):
  with abstract_world((2, 2)) as mesh:     # rank 0 of a (data, model) mesh
      cell = build_cell(arch, shape, mesh)  # meta DTensor args
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

import torch


def init_distributed(device: str = "cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> Tuple[int, int]:
    """Join the world: NCCL for ``cuda``, gloo for ``cpu``; on ``cuda``
    this process takes ``cuda:<local rank>``.  Returns (rank, world
    size).  An initialised world is kept as it is."""
    import torch.distributed as dist

    dev = torch.device(device).type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {device!r}")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = "nccl" if dev == "cuda" else "gloo"
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: NCCL is not available")
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    local = int(env.get("LOCAL_RANK", rank))
    if dev == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if init_method is not None:
        kw["init_method"] = init_method
    elif "MASTER_ADDR" in env or "TORCHELASTIC_RUN_ID" in env:
        kw["init_method"] = "env://"
    elif world_size == 1:
        kw["store"] = dist.HashStore()
    else:
        raise RuntimeError("init_distributed: a world of several processes "
                           "needs an address (torchrun's environment or "
                           "init_method)")
    if dev == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(**kw)
    return rank, world_size


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over this world."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh():
    """The (data, model) mesh over the world's devices, every device on
    ``model`` (tensor and expert parallel over one host's NVLink)."""
    import torch.distributed as dist

    return make_mesh((1, dist.get_world_size()), ("data", "model"))


def make_host_mesh(model: int = 2, data: int = 2, pod: int = 1):
    """A small mesh over this world — tests and examples.  A world
    smaller than ``model * data * pod`` gets the reference's fallback:
    ``model = min(2, n)``, ``data = n // model``, no pod."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if model * data * pod > n:
        pod = 1
        model = min(2, n)
        data = n // model
    if pod > 1:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))


@contextlib.contextmanager
def abstract_world(shape) -> Iterator:
    """Rank 0 of a world of ``data * model`` ranks in this process, with
    no devices and no peers: a ``"fake"`` process group, whose
    collectives send nothing and return their result's shape (the
    contents are not the collective's).  Yields the ``(data, model)``
    ``DeviceMesh`` of ``shape`` over it; the world is closed after.

    The mesh is ``"cuda"``-typed, so that DTensor picks the collectives
    it runs under NCCL on the cards (on a ``"cpu"`` mesh it takes gloo's
    fallbacks); no card is touched, and a model on it is built on
    ``meta`` (``sharding.axes.mesh_device``).  Refuses to start while a
    process group is initialised: it would replace that world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        raise RuntimeError("abstract_world: a process group is already "
                           "initialised in this process")
    # registers the "fake" backend (torch keeps it with its test helpers)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    class NullStore(dist.Store):
        """A store that holds nothing: the fake group reads none."""

    shape = tuple(int(v) for v in shape)
    dist.init_process_group("fake", rank=0, world_size=shape[0] * shape[1],
                            store=NullStore())
    try:
        yield init_device_mesh("cuda", shape,
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
