"""The port's train step on a mesh against the JAX package's on a mesh of
the same shape and against the unsharded port, on the CPU.

Worlds of 1, 2 and 4 processes (gloo, ``repro_torch.launch.mesh.
init_distributed`` from ``torchrun``-style environment variables) run
``DeviceMesh``es of (1, 1), (1, 2) and (2, 2) over ``(data, model)``;
the reference runs in a subprocess on a ``jax.sharding.Mesh`` of the
same shape over host CPU devices (not ``jax.make_mesh``, whose
``Explicit`` axes the reference's ``shard_activation`` refuses).  Both
packages get the reference's init (``models.convert.params_from_jax(...,
mesh=)``) and the same numpy batch.

One arch per family at its smoke config in f32: granite-20b,
granite-moe-1b-a400m (expert parallel, with capacity drops), mamba2-780m,
hymba-1.5b (10 q heads on 5 kv heads, so that on ``model`` = 2 the q
heads are split while the kv heads stay whole), llava-next-mistral-7b
and whisper-small.  Two steps of ``make_train_step(mesh=)`` at
``grad_accum`` 2 with AdamW at ``warmup_cosine(1e-3, 2, 10)``, held
against the reference's ``make_train_step(mesh=)`` on the same mesh and
against the unsharded port:

- loss, ``grad_norm`` and ``lr`` of each step within 2e-5 relative;
- ``m`` after step 1 (the clipped gradient x 0.1) leaf by leaf within
  2e-5 x the leaf's largest magnitude;
- ``v`` after step 2 within 4e-5 x (1 - b2) (b2 max g1^2 + max g2^2) of
  each leaf, g1 and g2 the two steps' clipped gradients (read off the
  reference's ``m``): v sums their squares, and a square doubles the
  gradient's relative bound;
- the parameters after step 2 within 2 (lr1 + lr2) absolute: an AdamW
  step moves an entry by at most its learning rate (``m_hat / (sqrt(
  v_hat) + eps)`` is at most 1 in size in the first steps), so where a
  gradient is within rounding of zero two runs may move it by up to
  twice that.

The moe arch's expert-parallel aux is the mean of the shards' aux (the
reference's ``pmean``), which is not the whole batch's; so it is held
against the unsharded port on (1, 1) only, at a capacity factor at which
nothing is dropped, and against the reference on every mesh.  The tokens
its shards drop in a forward of each microbatch equal the reference's.

On (2, 1) (data = 2): each rank's rows of microbatch i are rows [i B /
accum + r B / (accum D), ...) of the global batch, as the reference
cuts it; and ``CommDebugMode`` counts the collectives of a step at
accumulation 1 and 2: the second microbatch adds only the loss's two
reductions (its CE sum and its token count), no gradient's reduction
and no parameter's gather.
"""

import dataclasses
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

ARCHS = ["granite-20b", "granite-moe-1b-a400m", "mamba2-780m",
         "hymba-1.5b", "llava-next-mistral-7b", "whisper-small"]
MOE = "granite-moe-1b-a400m"
MESHES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
B, S, ACCUM, STEPS = 8, 16, 2, 2
LR, B2 = 1e-3, 0.95
#: n_experts / top_k: every token fits every expert
NO_DROPS = 4 / 2
TOL = 2e-5
LIMIT_S = 600           # each subprocess's time limit
ROOT = Path(__file__).resolve().parents[1]


def _cfg(cfg, cf=None):
    cfg = dataclasses.replace(cfg.smoke(), dtype="float32")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_heads=10, n_kv_heads=5)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    return cfg


def _batch(cfg):
    rng = np.random.default_rng(11)
    s_txt = {"audio": S // 4, "vlm": S - cfg.n_patches}.get(cfg.family, S)
    out = {k: rng.integers(0, cfg.vocab_size, (B, s_txt)).astype(np.int32)
           for k in ("tokens", "labels")}
    out["labels"][0, :3] = -1           # ignored labels
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    return out


# ----------------------------------------------------------------------- #
# the reference on a jax mesh (run as a subprocess)
# ----------------------------------------------------------------------- #
def _reference_main(shape, d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.models import moe as JM
    from repro.models.registry import build_model
    from repro.optim import AdamW, warmup_cosine
    from repro.training import make_train_step

    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    tonp = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {}
    for arch in ARCHS:
        cfg = _cfg(get_config(arch))
        m = build_model(cfg)
        with open(d / f"params_{arch}.pkl", "rb") as f:
            params = jax.tree.map(jnp.asarray, pickle.load(f))
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        opt = AdamW(lr=warmup_cosine(LR, 2, 10))
        st = opt.init(params)
        step = jax.jit(make_train_step(m, opt, mesh=mesh,
                                       grad_accum=ACCUM))
        rec = {"metrics": []}
        with mesh:
            p, st, met = step(params, st, batch)
            rec["metrics"].append({k: float(met[k])
                                   for k in ("loss", "grad_norm", "lr")})
            rec["m1"] = tonp(st["m"])
            p, st, met = step(p, st, batch)
            rec["metrics"].append({k: float(met[k])
                                   for k in ("loss", "grad_norm", "lr")})
            rec["m2"], rec["v2"] = tonp(st["m"]), tonp(st["v"])
            rec["params"] = tonp(p)
        out[arch] = rec
    # the moe shards' drops in a forward of each microbatch
    cfg = _cfg(get_config(MOE))
    m = build_model(cfg)
    with open(d / f"params_{MOE}.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    drops = []
    orig = JM._local_dispatch_combine

    def counted(p, x, cfg, compute_dtype, ep_size, dp_axes, gather_axes,
                weight_stationary=False):
        b, s, E = x.shape
        X, k, T = cfg.n_experts, cfg.top_k, b * s
        logits = x.reshape(T, E).astype(jnp.float32) \
            @ p["router"].astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        counts = jnp.bincount(idx.reshape(-1), length=X)
        C = int(max(1, -(-T * k // X) * cfg.capacity_factor))
        jax.debug.callback(lambda v: drops.append(int(v)),
                           jnp.maximum(counts - C, 0).sum())
        return orig(p, x, cfg, compute_dtype, ep_size, dp_axes,
                    gather_axes, weight_stationary)

    JM._local_dispatch_combine = counted
    batch = _batch(cfg)
    mb = B // ACCUM
    with mesh:
        fwd = jax.jit(lambda p, b: m.loss(p, b, mesh)[0])
        for i in range(ACCUM):
            fwd(params, {k: jnp.asarray(v[i * mb:(i + 1) * mb])
                         for k, v in batch.items()})
        jax.effects_barrier()
    out["drops"] = sum(drops)
    with open(d / f"ref_{n}.pkl", "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------------------- #
# the port (each rank a subprocess; the unsharded port in the fixture)
# ----------------------------------------------------------------------- #
def _full(tree):
    from repro_torch.optim.adamw import tree_leaves

    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().numpy().copy() for t in tree_leaves(tree)]


def _port_train(arch, cfg, mesh, np_params):
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.training import make_train_step

    m = build_model(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, "cpu", mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    opt = AdamW(lr=warmup_cosine(LR, 2, 10))
    st = opt.init(params)
    step = make_train_step(m, opt, mesh=mesh, grad_accum=ACCUM)
    rec = {"metrics": []}
    for i in range(STEPS):
        params, st, met = step(params, st, batch)
        rec["metrics"].append({"loss": float(met["loss"]),
                               "grad_norm": float(met["grad_norm"]),
                               "lr": float(met["lr"])})
        if i == 0:
            rec["m1"] = _full(st["m"])
    rec["m2"], rec["v2"] = _full(st["m"]), _full(st["v"])
    rec["params"] = _full(params)
    return rec


def _port_drops(cfg, mesh, np_params):
    from repro_torch.models import moe as M
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import build_model

    m = build_model(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, "cpu", mesh=mesh)
    batch = _batch(cfg)
    mb = B // ACCUM
    M.reset_ep_drops()
    with torch.no_grad():
        for i in range(ACCUM):
            m.loss(params, {k: torch.from_numpy(v[i * mb:(i + 1) * mb])
                            for k, v in batch.items()}, mesh)
    return M.ep_drops()


def _rows_and_comms(np_params):
    """On a (2, 1) mesh of this world of 2: each rank's token rows per
    microbatch, and the collectives of a step at accumulation 1 and 2."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.sharding import shard_activation
    from repro_torch.training import make_train_step

    mesh = make_mesh((2, 1), ("data", "model"))
    cfg = _cfg(get_config("granite-20b"))
    m = build_model(cfg, device="cpu")
    seen = []

    def loss(params, mb, mesh_):
        seen.append(shard_activation(mb["tokens"], ("batch", None),
                                     mesh_).to_local().numpy().copy())
        return m.loss(params, mb, mesh_)

    spy = dataclasses.replace(m, loss=loss)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = {"comm": {}}
    for accum in (1, ACCUM):
        params = params_from_jax(np_params, cfg, "cpu", mesh=mesh)
        opt = AdamW(lr=warmup_cosine(LR, 2, 10))
        step = make_train_step(spy if accum == ACCUM else m, opt,
                               mesh=mesh, grad_accum=accum)
        st = opt.init(params)
        with CommDebugMode() as cm:
            step(params, st, batch)
        out["comm"][accum] = {str(k).split(".")[-1]: v
                              for k, v in cm.get_comm_counts().items()}
    out["n_leaves"] = len(tree_leaves(params))
    rows = [None, None]
    dist.all_gather_object(rows, seen)
    out["rows"] = rows
    return out


def _port_main(shape, d):
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_mesh

    rank, world = init_distributed("cpu")
    mesh = make_mesh(shape, ("data", "model"))
    out = {}
    for arch in ARCHS:
        with open(d / f"params_{arch}.pkl", "rb") as f:
            np_params = pickle.load(f)
        out[arch] = _port_train(arch, _cfg(get_config(arch)), mesh,
                                np_params)
        if arch == MOE:
            out["drops"] = _port_drops(_cfg(get_config(arch)), mesh,
                                       np_params)
            t = torch.tensor(out["drops"])
            dist.all_reduce(t)
            out["drops"] = int(t)
            if world == 1:
                out["no_drops"] = _port_train(
                    arch, _cfg(get_config(arch), NO_DROPS), mesh,
                    np_params)
    if world == 2:
        with open(d / "params_granite-20b.pkl", "rb") as f:
            out["data2"] = _rows_and_comms(pickle.load(f))
    if rank == 0:
        with open(d / f"port_{world}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import get_config as jget
    from repro.models.registry import build_model as jbuild
    from repro_torch.configs import get_config

    d = tmp_path_factory.mktemp("mesh_train")
    for arch in ARCHS:
        jcfg, tcfg = _cfg(jget(arch)), _cfg(get_config(arch))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
        with open(d / f"params_{arch}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, jp), f)
    procs = []
    for world, shape in MESHES.items():
        tag = f"{shape[0]}x{shape[1]}"
        procs.append(_start(["reference", tag, str(d)], _env(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={world}")))
        port = _free_port()
        for rank in range(world):
            procs.append(_start(["port", tag, str(d)], _env(
                RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                MASTER_ADDR="localhost", MASTER_PORT=port,
                OMP_NUM_THREADS=1)))
    # meanwhile: the unsharded port
    unsharded = {}
    for arch in ARCHS:
        with open(d / f"params_{arch}.pkl", "rb") as f:
            np_params = pickle.load(f)
        cf = NO_DROPS if arch == MOE else None
        unsharded[arch] = _port_train(arch, _cfg(get_config(arch), cf),
                                      None, np_params)
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
    res = {"unsharded": unsharded}
    for world in MESHES:
        with open(d / f"ref_{world}.pkl", "rb") as f:
            res[("ref", world)] = pickle.load(f)
        with open(d / f"port_{world}.pkl", "rb") as f:
            res[("port", world)] = pickle.load(f)
    return res


def _ref_leaves(tree, arch):
    """The reference's numpy tree (stacked layers) as the port's leaves
    in ``tree_leaves`` order."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import tree_leaves

    return [t.numpy() for t in tree_leaves(
        params_from_jax(tree, _cfg(get_config(arch)), "cpu"))]


def _hold(got, want, what):
    """``got`` (the port's record) against ``want`` (a record with the
    same keys, or the reference's, whose trees are converted first)."""
    conv = (lambda t: t) if isinstance(want["m1"], list) else \
        (lambda t: _ref_leaves(t, what[0]))
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=0,
                                       err_msg=f"{what} step {i + 1} {k}")
    m1 = conv(want["m1"])
    for j, (a, b) in enumerate(zip(got["m1"], m1)):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale,
                                   err_msg=f"{what} m after step 1, "
                                           f"leaf {j}")
    g1 = [10.0 * m for m in m1]
    g2 = [(m - 0.9 * a) / 0.1 for m, a in zip(conv(want["m2"]), m1)]
    for j, (a, b) in enumerate(zip(got["v2"], conv(want["v2"]))):
        bound = 4e-5 * (1 - B2) * (B2 * float(np.abs(g1[j]).max()) ** 2
                                   + float(np.abs(g2[j]).max()) ** 2)
        np.testing.assert_allclose(a, b, rtol=0, atol=bound + 1e-30,
                                   err_msg=f"{what} v after step 2, "
                                           f"leaf {j}")
    lrs = sum(w["lr"] for w in want["metrics"])
    for j, (a, b) in enumerate(zip(got["params"], conv(want["params"]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lrs,
                                   err_msg=f"{what} params, leaf {j}")
    assert len(got["params"]) == len(conv(want["params"]))


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference_on_its_mesh(runs, arch, world):
    got = runs[("port", world)][arch]
    assert all(np.isfinite(m["loss"]) for m in got["metrics"])
    _hold(got, runs[("ref", world)][arch], (arch, MESHES[world]))


UNSHARDED = [(a, w) for a in ARCHS for w in MESHES if a != MOE] \
    + [(MOE, 1)]


@pytest.mark.parametrize("arch,world", UNSHARDED)
def test_train_step_matches_the_unsharded_port(runs, arch, world):
    got = runs[("port", world)]
    got = got["no_drops"] if arch == MOE else got[arch]
    _hold(got, runs["unsharded"][arch], (arch, MESHES[world]))


@pytest.mark.parametrize("world", list(MESHES))
def test_expert_parallel_drops_equal_the_reference(runs, world):
    got = runs[("port", world)]["drops"]
    assert got == runs[("ref", world)]["drops"]
    assert got > 0          # the capacity binds on this batch


def test_microbatch_rows_at_data_2(runs):
    from repro_torch.configs import get_config

    rows = runs[("port", 2)]["data2"]["rows"]
    tokens = _batch(_cfg(get_config("granite-20b")))["tokens"]
    mb, per = B // ACCUM, B // ACCUM // 2
    for r, seen in enumerate(rows):
        assert len(seen) == ACCUM
        for i, local in enumerate(seen):
            lo = i * mb + r * per
            np.testing.assert_array_equal(local, tokens[lo:lo + per])


def test_gradients_are_reduced_once_a_step(runs):
    rec = runs[("port", 2)]["data2"]
    one, two = rec["comm"][1], rec["comm"][ACCUM]

    def reductions(c):
        return c.get("all_reduce", 0) + c.get("reduce_scatter_tensor", 0)

    # the second microbatch adds the loss's CE sum and token count only
    assert reductions(two) - reductions(one) == 2, (one, two)
    # each gradient reduced (and each FSDP parameter gathered) once
    assert reductions(one) >= rec["n_leaves"], (one, rec["n_leaves"])
    assert two.get("all_gather_into_tensor", 0) == \
        one.get("all_gather_into_tensor", 0), (one, two)


if __name__ == "__main__":
    mode, tag, where = sys.argv[1:4]
    shp = tuple(int(v) for v in tag.split("x"))
    if mode == "reference":
        _reference_main(shp, Path(where))
    else:
        _port_main(shp, Path(where))
