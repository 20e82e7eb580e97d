"""The port's logical-axis sharding against the JAX package's, on the
CPU, with no devices.

``repro_torch.sharding.logical_to_spec`` / ``spec_tree`` must give the
reference's ``PartitionSpec`` entries for every parameter, decode-cache
and batch leaf of all ten archs, at their smoke configs and at their
published sizes (shapes only: ``abstract_params`` / ``jax.eval_shape``
on the reference's side, ``meta`` tensors on the port's), on the meshes
(1, 1), (2, 2), (1, 4), (4, 2) over ``(data, model)`` and (2, 2, 2)
over ``(pod, data, model)``.  The reference's ``_mesh_sizes`` reads only
``mesh.axis_names`` and ``mesh.devices.shape``, so a plain object with
those two attributes stands in for a JAX mesh on both sides.

The reference stacks each layer stack on a leading ``layers`` axis
(always replicated); the port keeps a list of per-layer dicts, so a
stacked leaf's spec without its first entry is each port layer's.
"""

import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.sharding import axes as jaxes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.sharding import axes  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
STACKS = ("layers", "enc_layers", "dec_layers")


def _mesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


def _cfgs(arch, size):
    if size == "smoke":
        return jconfigs.get_config(arch).smoke(), \
            configs.get_config(arch).smoke()
    return jconfigs.get_config(arch), configs.get_config(arch)


def _shape(size, kind):
    sid = {"prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    s = configs.get_shape(sid)
    if size == "smoke":
        s = dataclasses.replace(s, seq_len=64, global_batch=4)
    return s


def _ref_param_leaves(jm):
    """(path, shape, axes) of the reference's parameters, a stacked leaf
    once with its ``layers`` axis dropped."""
    shapes, ax = jcells.abstract_params(jm)
    out = []

    def walk(path, s, a, stacked):
        if isinstance(s, dict):
            for k in s:
                walk(path + (k,), s[k], a[k], stacked or k in STACKS)
            return
        shape, a = tuple(s.shape), tuple(a)
        if stacked:
            assert a[0] == "layers"
            shape, a = shape[1:], a[1:]
        out.append((path, shape, a))

    walk((), shapes, ax, False)
    return out


def _port_param_leaves(tm):
    params, ax = cells.abstract_params(tm), tm.axes()
    out = []

    def walk(path, p, a):
        if isinstance(p, dict):
            for k in p:
                if k in STACKS:
                    for layer in p[k]:   # every layer, one at a time
                        assert layer.keys() == p[k][0].keys()
                    walk(path + (k,), p[k][0], a[k][0])
                    assert all(x == a[k][0] for x in a[k])
                else:
                    walk(path + (k,), p[k], a[k])
            return
        out.append((path, tuple(p.shape), tuple(a)))

    walk((), params, ax)
    return out


def _specs_equal(leaves_ref, leaves_port, mesh_name):
    mesh = _mesh(mesh_name)
    leaves_ref = sorted(leaves_ref, key=lambda x: str(x[0]))
    leaves_port = sorted(leaves_port, key=lambda x: str(x[0]))
    assert [p for p, _, _ in leaves_ref] == [p for p, _, _ in leaves_port]
    for (path, shp, ra), (_, pshp, pa) in zip(leaves_ref, leaves_port):
        assert shp == pshp, path
        assert ra == pa, path
        want = tuple(jaxes.logical_to_spec(ra, shp, mesh))
        got = axes.logical_to_spec(pa, pshp, mesh)
        # P trims nothing: both have one entry per dimension
        assert got == want + (None,) * (len(got) - len(want)), (
            mesh_name, path, got, want)


@pytest.mark.parametrize("size", ["smoke", "published"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    ref = _ref_param_leaves(jax_build(jcfg))
    port = _port_param_leaves(build_model(tcfg, device="cpu"))
    for m in MESHES:
        _specs_equal(ref, port, m)


@pytest.mark.parametrize("size", ["smoke", "published"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_and_batch_specs_equal_the_reference(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    shp = _shape(size, "decode")
    holder = {}

    def init():
        c, a = jm.decode_init(shp.global_batch, shp.seq_len)
        holder["axes"] = a
        return c

    jc = jax.eval_shape(init)
    tc = build_model(tcfg, device="meta").decode_init(shp.global_batch,
                                                      shp.seq_len)
    tax = tm.decode_axes()
    assert len(jc) == len(tc) == len(tax)
    ref, port = [], []
    for i, (jl, tl) in enumerate(zip(jc, tc)):
        for k in sorted(jl):
            ref += _flat((i, k), jl[k], holder["axes"][i][k])
            port += _flat((i, k), tl[k], tax[i][k])
    for kind in ("prefill", "decode"):
        sc = _shape(size, kind)
        jb, jba = jcells.batch_specs(jcfg, sc, with_labels=False)
        tb = cells.batch_specs(tcfg, sc, with_labels=False)
        assert sorted(jb) == sorted(tb)
        for k in sorted(jb):
            ref.append(((kind, k), tuple(jb[k].shape), tuple(jba[k])))
            port.append(((kind, k), tuple(tb[k].shape),
                         cells.BATCH_AXES[k]))
    for m in MESHES:
        _specs_equal(ref, port, m)


def _flat(path, node, ax):
    if isinstance(node, dict):
        return [x for k in sorted(node)
                for x in _flat(path + (k,), node[k], ax[k])]
    return [(path, tuple(node.shape), tuple(ax))]


def test_placements_split_a_dimension_over_several_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh("2x2x2")
    spec = axes.logical_to_spec(("batch", None, "heads"), (8, 3, 4), mesh)
    assert spec == (("pod", "data"), None, "model")
    assert axes.placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert axes.local_shape((8, 3, 4), spec, mesh) == (2, 3, 2)
    # a mesh axis is used once: kv_heads takes model, cache_seq cannot
    spec = axes.logical_to_spec(
        ("cache_batch", "kv_heads", "cache_seq", "head_dim"),
        (6, 4, 32, 16), mesh)
    assert spec == ("pod", "model", None, None)
    assert axes.placements((None, None), _mesh("1x1")) == [Replicate(),
                                                          Replicate()]


def test_shard_activation_is_the_identity_outside_a_mesh():
    x = torch.ones(2, 3)
    assert axes.shard_activation(x, ("batch", None)) is x


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k", "train_4k"])
def test_dryrun_per_card_state_splits_the_cell(kind):
    """``launch.dryrun --mesh``: the cell built on a mesh of an abstract
    world holds the one-card cell's state; on (1, 1) a card holds all of
    it, on (1, 4) and (2, 2) at least a quarter of it and less than
    all."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_world
    from repro_torch.launch.step_analysis import local_tensors, tree_bytes

    cfg = configs.get_config("granite-20b").smoke()
    shape = _shape("smoke", "decode") if kind == "decode_32k" else \
        dataclasses.replace(configs.get_shape(kind), seq_len=64,
                            global_batch=4)
    cell = cells.build_cell("granite-20b", kind, device="meta", cfg=cfg,
                            shape=shape)
    whole = tree_bytes(*cell.args)
    for mesh_shape in [(1, 1), *dryrun.MESHES.values()]:
        with abstract_world(mesh_shape) as mesh:
            on_mesh = cells.build_cell("granite-20b", kind, mesh, cfg=cfg,
                                       shape=shape)
            assert tree_bytes(*on_mesh.args) == whole
            per_card = tree_bytes(*local_tensors(*on_mesh.args))
        if mesh_shape == (1, 1):
            assert per_card == whole
        else:
            assert whole / 4 <= per_card < whole


def test_host_mesh_falls_back_in_a_small_world():
    """``make_host_mesh(model=2, data=2)`` in a world of one process: the
    reference's fallback, a (1, 1) mesh over (data, model)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    assert not dist.is_initialized()
    assert M.init_distributed("cpu") == (0, 1)
    try:
        mesh = M.make_host_mesh(model=2, data=2)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert M.init_distributed("cpu") == (0, 1)   # kept as it is
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError):
        M.init_distributed("meta")
