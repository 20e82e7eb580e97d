"""The port's mesh training around its train step, against the JAX
package on meshes of the same shape, on the CPU: gradient compression,
checkpoint interchange with reshard-on-load, the elastic restart, the
train cell, the cells CLI and the trainer under a world of 2.

Worlds of gloo processes (``torchrun``-style environment variables) run
``DeviceMesh``es over ``(data, model)``; the reference runs in
subprocesses on ``jax.sharding.Mesh``es over host CPU devices.  Both get
the reference's init of granite-20b's smoke config in f32.  In two
phases (a checkpoint is read only after its writer has ended):

1. The reference on (2, 2): a step with int8 and with top-k gradient
   compression, and a save of the parameters (a tree of per-layer dicts,
   the port's nesting, so that the two packages name the same leaves);
   the reference's elastic scenario of ``tests/test_elastic_restart.py``
   on 8 devices: save on (4, 2), ``plan_remesh(alive_hosts=[0],
   chips_per_host=4, model_parallel=2, global_batch=8, microbatch=2)``,
   restore on (2, 2), one step at ``plan.grad_accum``.  The port on (2,
   2): the same compressed steps, each DTensor leaf's compression equal
   to the single-device compression of the whole tensor, and a save; on
   (4, 2), 8 ranks, the elastic scenario's save.
2. The reference restores the port's save on (2, 2); the port restores
   the reference's on (1, 2), and on (2, 2) its own (4, 2) save (with
   shardings and without), then takes the step.  On (1, 2) also: a train
   cell at a smoke cut against the same cell on one device, the cells
   CLI with a train shape, and ``launch.train``'s protocol (3 steps with
   a checkpoint at step 2, then ``--resume`` to 4) against the same on
   one process.

Bounds: the compressed steps' loss within 2e-5 relative and ``m`` (0.1
x the clipped, compressed gradient) within 2e-5 x the leaf's largest
(measured: 6e-7; the port's transform takes ``stack_layers=True``: a
layer's leaf is compressed within the stack of every layer's, as the
reference's stacked leaf is, else its int8 blocks and its top-k differ
from the reference's);
saved and restored values exactly equal; the elastic step's loss within
2e-5 relative of the reference's; the train cell's losses within 2e-5
relative (f32); the trainer's losses (bfloat16 compute, the smoke
config's) within 2e-3 relative of one process's, half a bfloat16 ulp
(measured: 1.6e-5).
"""

import contextlib
import dataclasses
import io
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH = "granite-20b"
B, S, ACCUM, LR = 8, 16, 2, 1e-3
SCHEMES = ("int8", "topk")
TOL = 2e-5
TRAIN_RTOL = 2e-3
LIMIT_S = 600           # each phase's time limit
ROOT = Path(__file__).resolve().parents[1]
TRAIN_ARGS = ["--smoke", "--device", "cpu", "--ckpt-every", "2"]


def _cfg(cfg):
    return dataclasses.replace(cfg.smoke(), dtype="float32")


def _batch(cfg):
    rng = np.random.default_rng(5)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _elastic_batch():
    # the reference scenario's batch
    return {k: np.zeros((8, 16), np.int32) for k in ("tokens", "labels")}


def _plan():
    from repro_torch.runtime import plan_remesh

    return plan_remesh(alive_hosts=[0], chips_per_host=4, model_parallel=2,
                       global_batch=8, microbatch=2)


def _specs(d, step):
    man = json.loads((d / f"step_{step:08d}" / "manifest.json")
                     .read_text())
    return {k: v["spec"] for k, v in man["keys"].items()}


# ----------------------------------------------------------------------- #
# the reference (subprocesses)
# ----------------------------------------------------------------------- #
def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))


def _per_layer(tree, n, axes=False):
    """The reference's stacked ``layers`` (or their logical axes, whose
    first is ``layers``) as a list of ``n`` per-layer trees: the port's
    nesting, so that the two packages name the same leaves."""
    import jax

    stack = tree["layers"]
    if axes:
        is_t = lambda x: isinstance(x, tuple)  # noqa: E731
        assert all(a[0] == "layers"
                   for a in jax.tree.leaves(stack, is_leaf=is_t))
        one = jax.tree.map(lambda a: a[1:], stack, is_leaf=is_t)
        return dict(tree, layers=[one] * n)
    return dict(tree, layers=[jax.tree.map(lambda a, i=i: a[i], stack)
                              for i in range(n)])


def _reference_phase1(d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config
    from repro.distributed.compression import make_compressed_grad_transform
    from repro.models.registry import build_model
    from repro.optim import AdamW, warmup_cosine
    from repro.runtime import plan_remesh
    from repro.sharding import spec_tree
    from repro.training import make_train_step

    cfg = _cfg(get_config(ARCH))
    m = build_model(cfg)
    _, axes = m.init(jax.random.PRNGKey(0))
    with open(d / "params.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    out = {}
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    if len(jax.devices()) == 4:
        mesh = _jax_mesh((2, 2))
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        for scheme in SCHEMES:
            init, transform = make_compressed_grad_transform(scheme)
            res = init(params)
            opt = AdamW(lr=warmup_cosine(LR, 2, 10))
            step = jax.jit(make_train_step(
                m, opt, mesh=mesh, grad_accum=ACCUM,
                grad_transform=lambda g: transform(g, res)[0]))
            with mesh:
                _, st, met = step(params, opt.init(params), batch)
            out[scheme] = {"m1": jax.tree.map(np.asarray, st["m"]),
                           "loss": float(met["loss"])}
        # a save of the per-layer tree, placed by its logical axes
        tree = _per_layer(params, cfg.n_layers)
        ax = _per_layer(axes, cfg.n_layers, axes=True)
        specs = spec_tree(ax, tree, mesh)
        placed = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree,
            specs, is_leaf=is_p)
        CheckpointManager(d / "ref_ckpt", async_write=False).save(7, placed)
        with open(d / "ref_phase1_4.pkl", "wb") as f:
            pickle.dump(out, f)
        return
    # the elastic scenario on 8 devices
    mesh8 = _jax_mesh((4, 2))
    sharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh8, s)), params,
        spec_tree(axes, params, mesh8), is_leaf=is_p)
    mgr = CheckpointManager(d / "ref_elastic", async_write=False)
    mgr.save(42, sharded)
    plan = plan_remesh(alive_hosts=[0], chips_per_host=4, model_parallel=2,
                       global_batch=8, microbatch=2)
    mesh4 = _jax_mesh((2, 2))
    shardings4 = jax.tree.map(lambda s: NamedSharding(mesh4, s),
                              spec_tree(axes, params, mesh4), is_leaf=is_p)
    restored = mgr.restore(params, step=42, shardings=shardings4)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
    step = jax.jit(make_train_step(m, opt, mesh=mesh4,
                                   grad_accum=plan.grad_accum))
    batch = {k: jnp.asarray(v) for k, v in _elastic_batch().items()}
    with mesh4:
        _, _, met = step(restored, opt.init(restored), batch)
    out["elastic_loss"] = float(met["loss"])
    out["grad_accum"] = plan.grad_accum
    with open(d / "ref_phase1_8.pkl", "wb") as f:
        pickle.dump(out, f)


def _reference_phase2(d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config
    from repro.models.registry import build_model
    from repro.sharding import spec_tree

    cfg = _cfg(get_config(ARCH))
    _, axes = build_model(cfg).init(jax.random.PRNGKey(0))
    with open(d / "params.pkl", "rb") as f:
        tree = _per_layer(jax.tree.map(jnp.asarray, pickle.load(f)),
                          cfg.n_layers)
    ax = _per_layer(axes, cfg.n_layers, axes=True)
    mesh = _jax_mesh((2, 2))
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s),
                             spec_tree(ax, tree, mesh),
                             is_leaf=lambda x: isinstance(x, P))
    restored = CheckpointManager(d / "port_ckpt", async_write=False) \
        .restore(tree, step=3, shardings=shardings)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    leaf = jax.tree.leaves(restored)[0]
    assert dict(leaf.sharding.mesh.shape) == {"data": 2, "model": 2}
    (d / "ref_phase2.ok").write_text("restored")


# ----------------------------------------------------------------------- #
# the port (each rank a subprocess)
# ----------------------------------------------------------------------- #
def _setup(shape):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models.registry import build_model

    rank, world = init_distributed("cpu")
    mesh = make_mesh(shape, ("data", "model"))
    cfg = _cfg(get_config(ARCH))
    return rank, world, mesh, cfg, build_model(cfg, device="cpu")


def _np_params(d, cfg, mesh=None):
    from repro_torch.models.convert import params_from_jax

    with open(d / "params.pkl", "rb") as f:
        return params_from_jax(pickle.load(f), cfg, "cpu", mesh=mesh)


def _full(tree):
    from repro_torch.optim.adamw import tree_leaves

    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().numpy().copy() for t in tree_leaves(tree)]


def _same_values(restored, want):
    from repro_torch.optim.adamw import tree_leaves

    got = _full(restored)
    return len(got) == len(tree_leaves(want)) and all(
        np.array_equal(a, b.numpy()) for a, b in zip(got,
                                                     tree_leaves(want)))


def _port_phase1(shape, d):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.compression import \
        make_compressed_grad_transform
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training import make_train_step

    rank, world, mesh, cfg, m = _setup(shape)
    out = {}
    if world == 8:
        CheckpointManager(d / "port_elastic", async_write=False,
                          host_id=rank).save(42, _np_params(d, cfg, mesh))
    else:
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        for scheme in SCHEMES:
            init, transform = make_compressed_grad_transform(
                scheme, stack_layers=True)
            params = _np_params(d, cfg, mesh)
            res = init(params)
            # the DTensor path against the whole tensor's, leaf by leaf
            plain = make_compressed_grad_transform(scheme,
                                                   stack_layers=True)[1]
            rng = np.random.default_rng(3)
            grads = [torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)) for p in tree_leaves(params)]
            placed = [DTensor.from_local(
                _block(g, p), mesh, p.placements, run_check=False,
                shape=g.shape, stride=g.stride())
                for g, p in zip(grads, tree_leaves(params))]
            zero = [torch.zeros_like(p) for p in tree_leaves(params)]
            mesh_out = transform(placed, zero)
            whole = plain(grads, [torch.zeros_like(g) for g in grads])
            out[f"{scheme}_exact"] = all(
                torch.equal(a.full_tensor(), b) and
                torch.equal(ra.full_tensor(), rb)
                for a, ra, b, rb in zip(*mesh_out, *whole))
            opt = AdamW(lr=warmup_cosine(LR, 2, 10))
            step = make_train_step(
                m, opt, mesh=mesh, grad_accum=ACCUM,
                grad_transform=lambda g: transform(g, res)[0])
            _, st, met = step(params, opt.init(params), batch)
            out[scheme] = {"m1": _full(st["m"]),
                           "loss": float(met["loss"])}
        mgr = CheckpointManager(d / "port_ckpt", async_write=False,
                                host_id=rank)
        mgr.save(3, _np_params(d, cfg, mesh))
        mgr.wait()
    if rank == 0:
        with open(d / f"port_phase1_{world}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def _block(g, p):
    from repro_torch.sharding.axes import local_block

    return local_block(g, p.placements, p.device_mesh)


def _port_phase2(shape, d):
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.sharding.axes import sharding_tree
    from repro_torch.training import make_train_step

    rank, world, mesh, cfg, m = _setup(shape)
    template = _np_params(d, cfg)
    shardings = sharding_tree(m.axes(), template, mesh)
    out = {}
    if world == 4:
        plan = _plan()
        mgr = CheckpointManager(d / "port_elastic", async_write=False)
        restored = mgr.restore(template, step=42, shardings=shardings)
        out["values"] = _same_values(restored, template)
        out["placements_equal"] = all(
            tuple(r.placements) == tuple(s.placements) and
            tuple(r.device_mesh.shape) == (2, 2)
            for r, s in zip(*(_leaves(t) for t in (restored, shardings))))
        whole = mgr.restore(template, step=42)
        out["whole_values"] = _same_values(whole, template) and not any(
            hasattr(t, "full_tensor") for t in _leaves(whole))
        opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
        step = make_train_step(m, opt, mesh=mesh,
                               grad_accum=plan.grad_accum)
        batch = {k: torch.from_numpy(v) for k, v in _elastic_batch().items()}
        _, _, met = step(restored, opt.init(restored), batch)
        out["elastic_loss"] = float(met["loss"])
        out["grad_accum"] = plan.grad_accum
    else:
        restored = CheckpointManager(d / "ref_ckpt", async_write=False) \
            .restore(template, step=7, shardings=shardings)
        out["ref_values"] = _same_values(restored, template)
        out["ref_placed"] = all(tuple(r.device_mesh.shape) == (1, 2)
                                for r in _leaves(restored))
        out.update(_cell_and_cli(mesh))
        out["trainer"] = _trainer(d / f"train_world{world}")
    if rank == 0:
        with open(d / f"port_phase2_{world}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves

    return tree_leaves(tree)


def _cell_losses(device):
    """Two steps of granite-20b's train cell at a smoke cut (f32)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.cells import build_cell

    cfg = dataclasses.replace(_cfg(get_config(ARCH)), n_layers=1)
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=S,
                                global_batch=4)
    cell = build_cell(ARCH, "train_4k", device, cfg=cfg, shape=shape)
    params, st, batch = cell.inputs(0)
    losses = []
    for _ in range(2):
        params, st, met = cell.run(params, st, batch)
        losses.append(float(met["loss"]))
    return {"accum": cell.accum, "losses": losses,
            "placed": [tuple(p.placements) for p in _leaves(params)]
            if device != "cpu" else None}


def _cell_and_cli(mesh):
    from repro_torch.launch import cells

    out = {"cell": _cell_losses(mesh)}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cells.main(["--arch", ARCH, "--shape", "train_4k", "--device",
                         "cpu", "--smoke", "--layers", "1", "--seq",
                         str(S), "--batch", "4", "--mesh", "1x2"])
    out["cells_cli"] = (rc, printed.getvalue())
    return out


def _trainer(ckpt):
    """``launch.train.main``: 3 steps (a checkpoint at step 2), then
    ``--resume`` to 4."""
    from repro_torch.launch import train

    with contextlib.redirect_stdout(io.StringIO()):
        first = train.main(TRAIN_ARGS + ["--steps", "3", "--ckpt-dir",
                                         str(ckpt)])
        resumed = train.main(TRAIN_ARGS + ["--steps", "4", "--resume",
                                           "--ckpt-dir", str(ckpt)])
    return first, resumed


# ----------------------------------------------------------------------- #
# the runs
# ----------------------------------------------------------------------- #
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _start(args, env):
    return subprocess.Popen([sys.executable, str(Path(__file__)), *args],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _world(phase, shape, d):
    n = shape[0] * shape[1]
    port = _free_port()
    return [_start([f"port{phase}", f"{shape[0]}x{shape[1]}", str(d)], _env(
        RANK=r, WORLD_SIZE=n, LOCAL_RANK=r, MASTER_ADDR="localhost",
        MASTER_PORT=port, OMP_NUM_THREADS=1)) for r in range(n)]


def _reference(phase, n, d):
    return [_start([f"reference{phase}", f"{n}x1", str(d)], _env(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={n}"))]


def _finish(procs):
    deadline = time.time() + LIMIT_S
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((p.args, p.returncode, out))
    bad = [(a, rc, out[-3000:]) for a, rc, out in logs if rc != 0]
    assert not bad, bad


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import get_config as jget
    from repro.models.registry import build_model as jbuild

    d = tmp_path_factory.mktemp("mesh_restart")
    jp, _ = jbuild(_cfg(jget(ARCH))).init(jax.random.PRNGKey(0))
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jp), f)
    _finish(_reference(1, 4, d) + _reference(1, 8, d)
            + _world(1, (2, 2), d) + _world(1, (4, 2), d))
    procs = _reference(2, 4, d) + _world(2, (2, 2), d) \
        + _world(2, (1, 2), d)
    # meanwhile: the same on one process
    res = {"cell_1": _cell_losses("cpu"),
           "trainer_1": _trainer(d / "train_world1")}
    _finish(procs)
    for name in ("ref_phase1_4", "ref_phase1_8", "port_phase1_4",
                 "port_phase2_4", "port_phase2_2"):
        with open(d / f"{name}.pkl", "rb") as f:
            res[name] = pickle.load(f)
    res["specs"] = (_specs(d / "port_ckpt", 3), _specs(d / "ref_ckpt", 7))
    res["ref_restored_port"] = (d / "ref_phase2.ok").exists()
    res["files"] = sorted(p.name for p in (d / "port_ckpt" /
                                           "step_00000003").iterdir())
    return res


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compression_on_dtensors_equals_the_whole_tensors(runs, scheme):
    assert runs["port_phase1_4"][f"{scheme}_exact"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressed_step_matches_the_reference_on_2x2(runs, scheme):
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax

    got = runs["port_phase1_4"][scheme]
    ref = runs["ref_phase1_4"][scheme]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TOL)
    want = [t.numpy() for t in _leaves(params_from_jax(
        ref["m1"], _cfg(get_config(ARCH)), "cpu"))]
    assert len(got["m1"]) == len(want)
    for j, (a, b) in enumerate(zip(got["m1"], want)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=TOL * float(np.abs(b).max()),
                                   err_msg=f"{scheme} m, leaf {j}")


def test_checkpoint_specs_equal_the_reference_save(runs):
    port, ref = runs["specs"]
    assert port == ref
    assert any(s is not None and any(e is not None for e in s)
               for s in port.values())      # something is sharded
    assert runs["files"] == ["manifest.json", "shard_00000.npz"]


def test_reference_restores_the_port_save_on_2x2(runs):
    assert runs["ref_restored_port"]


def test_port_restores_the_reference_save_on_1x2(runs):
    got = runs["port_phase2_2"]
    assert got["ref_values"] and got["ref_placed"]


def test_elastic_restart_4x2_to_2x2(runs):
    got = runs["port_phase2_4"]
    assert got["values"] and got["placements_equal"]
    assert got["whole_values"]
    ref = runs["ref_phase1_8"]
    assert got["grad_accum"] == ref["grad_accum"] == 2
    assert np.isfinite(got["elastic_loss"])
    np.testing.assert_allclose(got["elastic_loss"], ref["elastic_loss"],
                               rtol=TOL)


def test_train_cell_on_1x2_matches_one_device(runs):
    got, one = runs["port_phase2_2"]["cell"], runs["cell_1"]
    assert got["accum"] == one["accum"] == 4
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=TOL)
    assert any(any(type(p).__name__ == "Shard" for p in pl)
               for pl in got["placed"])


def test_cells_cli_runs_a_train_cell_on_1x2(runs):
    rc, printed = runs["port_phase2_2"]["cells_cli"]
    assert rc == 0
    line = printed.strip()
    assert line.startswith(f"{ARCH} x train_4k on (1, 2): train accum 4, "
                           f"loss "), printed
    assert ", finite True, " in line and line.endswith(" ms"), printed


def test_trainer_on_a_world_of_2_matches_one_process(runs):
    (first2, resumed2), (first1, resumed1) = \
        runs["port_phase2_2"]["trainer"], runs["trainer_1"]
    assert len(first2) == 3 and len(resumed2) == 2
    np.testing.assert_allclose(first2, first1, rtol=TRAIN_RTOL)
    np.testing.assert_allclose(resumed2, resumed1, rtol=TRAIN_RTOL)


if __name__ == "__main__":
    mode, tag, where = sys.argv[1:4]
    shp = tuple(int(v) for v in tag.split("x"))
    if mode == "reference1":
        _reference_phase1(Path(where))
    elif mode == "reference2":
        _reference_phase2(Path(where))
    elif mode == "port1":
        _port_phase1(shp, Path(where))
    else:
        _port_phase2(shp, Path(where))
