"""The port's mesh path against the unsharded port and against the JAX
package on a mesh of the same shape, on the CPU.

Worlds of 1, 2 and 4 processes (gloo, ``repro_torch.launch.mesh.
init_distributed`` from ``torchrun``-style environment variables) run
``DeviceMesh``es of (1, 1), (1, 2) and (2, 2) over ``(data, model)``;
the reference runs in a subprocess on a ``jax.sharding.Mesh`` of the
same shape over host CPU devices.  ``jax.make_mesh`` is not used: in
JAX 0.9 it makes ``Explicit`` axes, which the reference's
``shard_activation`` refuses ("can only refer to Auto axes of the
mesh"); a ``Mesh`` built over the devices has ``Auto`` axes.

One arch per family at its smoke config in f32: granite-20b (one kv
head: a sequence-sharded decode cache on ``model``), gemma3-27b
(windowed caches), dbrx-132b and granite-moe-1b-a400m (expert parallel
with capacity drops), mamba2-780m, hymba-1.5b (with 10 q heads on 5 kv
heads, so that on ``model`` = 2 the q heads are split while the kv heads
stay whole and a rank's q heads span kv groups — the case the published
25 / 5 heads give on 5 ranks; 25 divides neither 2 nor 4), llava-next-
mistral-7b and whisper-small.  Both packages get the same parameters
(the reference's init, carried across by ``models.convert.
params_from_jax(..., mesh=)``) and the same numpy inputs.

For each (arch, world):
- prefill logits and 4 decode steps (per-row ``pos``, an ``active``
  mask) equal the reference's on the same mesh and the unsharded
  port's, within atol = 2e-5 x the reference logits' scale, rtol = 2e-5
  (the bound ``tests/test_kernels.py:95`` holds attention to).  A moe
  arch's expert-parallel dispatch drops tokens past an expert's
  capacity, which the unsharded (dense) dispatch never does, so it is
  held against the unsharded port at a capacity factor at which nothing
  is dropped, and at its own against the reference;
- the tokens the expert-parallel shards drop, summed over the shards,
  equal the reference's exactly (counted in its ``shard_map`` body);
- the serving engine's greedy tokens on a stream that reuses slots equal
  the reference engine's on the mesh (and, but for moe, the unsharded
  port engine's), the same on every rank.

On (1, 2) also: the prefill of granite-20b, gemma3-27b, mamba2-780m and
hymba-1.5b with ``seq_shard_activations`` (the residual stream sharded
over ``model`` on the sequence, ``act_seq``), against the reference with
the same flag on the same mesh and against the unsharded port; and
``python -m repro_torch.launch.cells``'s ``main`` on the world's
production mesh, a decode cell of granite-20b's smoke config.

``CommDebugMode`` on (1, 2): a dense prefill runs one all-gather (the
embedding's output, ``act_mlp`` -> ``act_embed``) and two all-reduces a
layer (attention's and the MLP's output projections) — no weight is
gathered; a decode step against granite's sequence-sharded cache
gathers no cache (only the query heads and the embedding's output).
"""

import contextlib
import dataclasses
import io
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

ARCHS = ["granite-20b", "gemma3-27b", "dbrx-132b", "granite-moe-1b-a400m",
         "mamba2-780m", "hymba-1.5b", "llava-next-mistral-7b",
         "whisper-small"]
MOE = ("dbrx-132b", "granite-moe-1b-a400m")
#: the archs whose prefill also runs with a sequence-sharded stream
SEQ_ARCHS = ("granite-20b", "gemma3-27b", "mamba2-780m", "hymba-1.5b")
MESHES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
B, S, KV, STEPS = 4, 16, 24, 4
ENGINE_SLOTS, ENGINE_REQUESTS, PROMPT, NEW = 2, 4, 3, 3
#: a capacity factor at which no token is dropped: n_experts / top_k
#: makes C = ceil(T k / X) X / k >= T, every token fits every expert
NO_DROPS = 4 / 2
TOL = 2e-5
LIMIT_S = 600           # each subprocess's time limit
ROOT = Path(__file__).resolve().parents[1]


def _replace(cfg, cf=None, seq_shard=False):
    cfg = dataclasses.replace(cfg.smoke(), dtype="float32")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_heads=10, n_kv_heads=5)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    if seq_shard:
        cfg = dataclasses.replace(cfg, seq_shard_activations=True)
    return cfg


def _inputs(cfg):
    rng = np.random.default_rng(7)
    s_txt = {"audio": S // 4, "vlm": S - cfg.n_patches}.get(cfg.family, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s_txt))
             .astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    steps = [(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
              (np.arange(B) + t).astype(np.int32),
              (np.arange(B) + t) % 3 != 1) for t in range(STEPS)]
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
               for _ in range(ENGINE_REQUESTS)]
    return batch, steps, prompts


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
    from repro.serving.engine import Request, ServingEngine

    n = shape[0] * shape[1]
    # not jax.make_mesh: its Explicit axes are refused by the reference's
    # shard_activation; a Mesh over the devices has Auto axes
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    drops = []
    orig = JM._local_dispatch_combine

    def counted(p, x, cfg, compute_dtype, ep_size, dp_axes, gather_axes,
                weight_stationary=False):
        # the shard's routing as the body computes it; the tokens past an
        # expert's capacity are its drops
        b, s, E = x.shape
        X, k, T = cfg.n_experts, cfg.top_k, b * s
        xf = x.reshape(T, E).astype(jnp.float32)
        router = p["router"].astype(jnp.float32)
        if weight_stationary and gather_axes:
            i = jax.lax.axis_index("data")
            logits = jax.lax.psum(
                xf @ jax.lax.dynamic_slice_in_dim(router, i * E, E, 0),
                "data")
        else:
            logits = xf @ router
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        counts = jnp.bincount(idx.reshape(-1), length=X)
        C = int(max(1, -(-T * k // X) * cfg.capacity_factor))
        jax.debug.callback(lambda v: drops.append(int(v)),
                           jnp.maximum(counts - C, 0).sum())
        return orig(p, x, cfg, compute_dtype, ep_size, dp_axes, gather_axes,
                    weight_stationary)

    JM._local_dispatch_combine = counted
    out = {}
    for arch in ARCHS:
        cfg = _replace(get_config(arch))
        m = build_model(cfg)
        with open(d / f"params_{arch}.pkl", "rb") as f:
            params = jax.tree.map(jnp.asarray, pickle.load(f))
        batch, steps, prompts = _inputs(cfg)
        rec = {}
        with mesh:
            drops.clear()
            fwd = jax.jit(lambda p, b: m.forward(p, b, mesh))
            rec["prefill"] = np.asarray(fwd(params, {
                k: jnp.asarray(v) for k, v in batch.items()}))
            jax.effects_barrier()
            rec["drops_prefill"] = sum(drops)
            drops.clear()
            caches, _ = m.decode_init(B, KV)
            step = jax.jit(lambda p, c, t, pos, act: m.decode_step(
                p, c, t, pos, mesh, active=act))
            logits = []
            for tok, pos, act in steps:
                lg, caches = step(params, caches, jnp.asarray(tok),
                                  jnp.asarray(pos), jnp.asarray(act))
                logits.append(np.asarray(lg))
            jax.effects_barrier()
            rec["decode"] = np.stack(logits)
            rec["drops_decode"] = sum(drops)
            eng = ServingEngine(m, params, batch=ENGINE_SLOTS, kv_len=KV,
                                mesh=mesh)
            for rid, pr in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=pr, max_new_tokens=NEW))
            done = eng.run_until_drained()
            rec["engine"] = {r: list(q.out_tokens) for r, q in done.items()}
        out[arch] = rec
    if tuple(shape) == MESHES[2]:
        for arch in SEQ_ARCHS:
            cfg = _replace(get_config(arch), seq_shard=True)
            m = build_model(cfg)
            with open(d / f"params_{arch}.pkl", "rb") as f:
                params = jax.tree.map(jnp.asarray, pickle.load(f))
            batch, _, _ = _inputs(cfg)
            with mesh:
                fwd = jax.jit(lambda p, b: m.forward(p, b, mesh))
                out[f"seq:{arch}"] = np.asarray(fwd(params, {
                    k: jnp.asarray(v) for k, v in batch.items()}))
    with open(d / f"ref_{n}.pkl", "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------------------- #
# the port on a DeviceMesh (each rank a subprocess)
# ----------------------------------------------------------------------- #
def _port_run(arch, cfg, mesh, np_params, with_engine):
    from repro_torch.models import moe as M
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import build_model
    from repro_torch.serving import Request, ServingEngine

    m = build_model(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, "cpu", mesh=mesh)
    batch, steps, prompts = _inputs(cfg)
    rec = {}
    with torch.no_grad():
        M.reset_ep_drops()
        rec["prefill"] = m.forward(params, {
            k: torch.from_numpy(v) for k, v in batch.items()},
            mesh).full_tensor().numpy()
        rec["drops_prefill"] = M.ep_drops()
        M.reset_ep_drops()
        caches = m.decode_init(B, KV, mesh=mesh)
        logits = []
        for tok, pos, act in steps:
            lg, caches = m.decode_step(
                params, caches, torch.from_numpy(tok), torch.from_numpy(pos),
                torch.from_numpy(act), mesh=mesh)
            logits.append(lg.full_tensor().numpy())
        rec["decode"] = np.stack(logits)
        rec["drops_decode"] = M.ep_drops()
    if with_engine:
        eng = ServingEngine(m, params, batch=ENGINE_SLOTS, kv_len=KV,
                            mesh=mesh)
        for rid, pr in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=pr, max_new_tokens=NEW))
        done = eng.run_until_drained()
        rec["engine"] = {r: list(q.out_tokens) for r, q in done.items()}
    return rec


def _comm_counts(mesh, np_params):
    """Collectives of one dense layer's prefill and decode step on the
    mesh, by kind."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(_replace(get_config("granite-20b")),
                              n_layers=1)
    m = build_model(cfg, device="cpu")
    def first(node):      # the stacked layers' first one
        if isinstance(node, dict):
            return {k: first(v) for k, v in node.items()}
        return node[:1]

    one = dict(np_params, layers=first(np_params["layers"]))
    params = params_from_jax(one, cfg, "cpu", mesh=mesh)
    batch, steps, _ = _inputs(cfg)
    out = {}
    with torch.no_grad(), CommDebugMode() as cm:
        m.forward(params, {"tokens": torch.from_numpy(batch["tokens"])},
                  mesh)
    out["prefill"] = {str(k).split(".")[-1]: v
                      for k, v in cm.get_comm_counts().items()}
    caches = m.decode_init(B, KV, mesh=mesh)
    tok, pos, act = steps[0]
    with torch.no_grad(), CommDebugMode() as cm:
        m.decode_step(params, caches, torch.from_numpy(tok),
                      torch.from_numpy(pos), torch.from_numpy(act),
                      mesh=mesh)
    out["decode"] = {str(k).split(".")[-1]: v
                     for k, v in cm.get_comm_counts().items()}
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
        rec = _port_run(arch, _replace(get_config(arch)), mesh, np_params,
                        with_engine=True)
        if arch in MOE:
            nd = _port_run(arch, _replace(get_config(arch), NO_DROPS), mesh,
                           np_params, with_engine=False)
            rec["no_drops"] = nd
        for k in ("drops_prefill", "drops_decode"):
            t = torch.tensor(rec[k])
            dist.all_reduce(t)
            rec[k] = int(t)
        engines = [None] * world
        dist.all_gather_object(engines, rec["engine"])
        rec["engine_every_rank"] = engines
        out[arch] = rec
        if arch == "granite-20b" and shape == MESHES[2]:
            out["comm"] = _comm_counts(mesh, np_params)
    if shape == MESHES[2]:
        from repro_torch.launch import cells
        from repro_torch.models.convert import params_from_jax
        from repro_torch.models.registry import build_model

        for arch in SEQ_ARCHS:
            cfg = _replace(get_config(arch), seq_shard=True)
            with open(d / f"params_{arch}.pkl", "rb") as f:
                params = params_from_jax(pickle.load(f), cfg, "cpu",
                                         mesh=mesh)
            batch, _, _ = _inputs(cfg)
            with torch.no_grad():
                out[f"seq:{arch}"] = build_model(cfg, device="cpu").forward(
                    params, {k: torch.from_numpy(v)
                             for k, v in batch.items()},
                    mesh).full_tensor().numpy()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cells.main(["--arch", "granite-20b", "--shape",
                             "decode_32k", "--device", "cpu", "--smoke",
                             "--layers", "1", "--seq", "16", "--batch",
                             "2"])
        out["cells_cli"] = (rc, printed.getvalue())
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
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import build_model
    from repro_torch.serving import Request, ServingEngine

    d = tmp_path_factory.mktemp("mesh")
    for arch in ARCHS:
        jcfg, tcfg = _replace(jget(arch)), _replace(get_config(arch))
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
        for cf in (None, NO_DROPS) if arch in MOE else (None,):
            cfg = _replace(get_config(arch), cf)
            m = build_model(cfg, device="cpu")
            tp = params_from_jax(np_params, cfg, "cpu")
            batch, steps, prompts = _inputs(cfg)
            with torch.no_grad():
                rec = {"prefill": m.forward(tp, {
                    k: torch.from_numpy(v) for k, v in batch.items()})
                    .numpy()}
                caches, logits = m.decode_init(B, KV), []
                for tok, pos, act in steps:
                    lg, caches = m.decode_step(
                        tp, caches, torch.from_numpy(tok),
                        torch.from_numpy(pos), torch.from_numpy(act))
                    logits.append(lg.numpy())
                rec["decode"] = np.stack(logits)
            eng = ServingEngine(m, tp, batch=ENGINE_SLOTS, kv_len=KV)
            for rid, pr in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=pr, max_new_tokens=NEW))
            rec["engine"] = {r: list(q.out_tokens)
                             for r, q in eng.run_until_drained().items()}
            unsharded[(arch, cf)] = rec
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


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_the_reference_and_the_unsharded_port(runs, arch,
                                                           world):
    got = runs[("port", world)][arch]
    ref = runs[("ref", world)][arch]
    for k in ("prefill", "decode"):
        assert got[k].shape == ref[k].shape
        assert np.isfinite(got[k]).all()
        _close(got[k], ref[k], f"{arch} {k} vs the reference on "
                               f"{MESHES[world]}")
        sharded, cf = (got["no_drops"], NO_DROPS) if arch in MOE else \
            (got, None)
        _close(sharded[k], runs["unsharded"][(arch, cf)][k],
               f"{arch} {k} vs the unsharded port")


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("arch", MOE)
def test_expert_parallel_drops_equal_the_reference(runs, arch, world):
    got = runs[("port", world)][arch]
    ref = runs[("ref", world)][arch]
    assert got["drops_prefill"] == ref["drops_prefill"]
    assert got["drops_decode"] == ref["drops_decode"]
    assert got["drops_prefill"] > 0      # the capacity binds on this batch
    assert got["no_drops"]["drops_prefill"] == 0
    assert got["no_drops"]["drops_decode"] == 0


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match(runs, arch, world):
    got = runs[("port", world)][arch]
    assert len(got["engine"]) == ENGINE_REQUESTS
    assert all(e == got["engine"] for e in got["engine_every_rank"])
    assert got["engine"] == runs[("ref", world)][arch]["engine"]
    if arch not in MOE:
        assert got["engine"] == runs["unsharded"][(arch, None)]["engine"]


@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_sequence_sharded_stream_matches_the_reference(runs, arch):
    got = runs[("port", 2)][f"seq:{arch}"]
    ref = runs[("ref", 2)][f"seq:{arch}"]
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    _close(got, ref, f"{arch} prefill, act_seq on {MESHES[2]}, vs the "
                     f"reference")
    # off a mesh the flag changes nothing: the unsharded port's prefill
    _close(got, runs["unsharded"][(arch, None)]["prefill"],
           f"{arch} prefill, act_seq, vs the unsharded port")


def test_cells_cli_runs_a_decode_cell_on_the_production_mesh(runs):
    rc, printed = runs[("port", 2)]["cells_cli"]
    assert rc == 0
    from repro_torch.configs import get_config

    vp = get_config("granite-20b").smoke().padded_vocab
    line = printed.strip()
    assert line.startswith(f"granite-20b x decode_32k on (1, 2): logits "
                           f"(2, {vp}) "), printed
    assert ", finite True, " in line and line.endswith(" ms"), printed


def test_dense_layer_gathers_no_weight_or_cache(runs):
    comm = runs[("port", 2)]["comm"]
    assert comm["prefill"] == {"all_gather_into_tensor": 1,
                               "all_reduce": 2}, comm
    # decode: the embedding's output and the q heads gathered; the split
    # softmax's max, sum and values, the output projection and the MLP
    # reduced — the sequence-sharded cache stays where it is
    assert comm["decode"] == {"all_gather_into_tensor": 2,
                              "all_reduce": 5}, comm


if __name__ == "__main__":
    mode, tag, where = sys.argv[1:4]
    shp = tuple(int(v) for v in tag.split("x"))
    if mode == "reference":
        _reference_main(shp, Path(where))
    else:
        _port_main(shp, Path(where))
