"""The per-card step analysis of a mesh cell on the CPU:
``launch.mesh.abstract_world``, ``build_cell(arch, shape, mesh)``'s
``meta`` DTensor arguments, the collective bytes of
``launch.step_analysis`` and ``launch.dryrun --mesh`` / ``--sp`` with
``launch.roofline``'s link term.

- Each functional collective's wire bytes on hand-built tensors, over
  groups of 1, 2 and 4 ranks (the reference's formulas,
  ``hlo_analysis.py``): all-reduce 2·n·(g−1)/g, reduce-scatter n·(g−1)
  of its result, all-gather and all-to-all n·(g−1)/g; a wait is free.
- On (1, 1) the mesh analysis equals the one-card analysis (FLOPs,
  bytes, operations, live bytes) for the dense families; the collective
  bytes are 0.
- The expert-parallel dispatch's count equals ``torch.bincount``.
- Per-device FLOPs against ``repro.launch.hlo_analysis.analyze_compiled``
  of the reference's cell compiled on a ``jax.sharding.Mesh`` of the
  same shape over 4 host devices (smoke configs; seq x batch below).
  Measured (counts, the same on any machine), port / reference:
  granite-20b prefill 1,024 x 1 on 1x4 184,549,376 = 184,549,376;
  gemma3-27b decode 1,024 x 4 on 2x2 196,608 = 196,608; granite-moe
  decode 1,024 x 4 on 1x4 (expert parallel) 1,445,888 = 1,445,888;
  granite-20b prefill 1,024 x 2 on 2x2 360,710,144 = 360,710,144 (held
  exactly); granite-moe prefill 1,024 x 1 on 1x4 230,948,864 /
  218,365,952 = 1.0576 (XLA splits the projection of the two kv heads,
  which 4 ranks cannot split, over the sequence); granite-20b train 128
  x 8 on 2x2 251,658,240 / 232,783,872 = 1.0811 (1.0741 on one device:
  the backward's products); dbrx train 412,090,368 / 395,313,152 =
  1.0424 (as on one device); mamba2 prefill 1,024 x 2 on 2x2 164,626,432
  / 156,237,824 = 1.0537 (the SSD's grouping, 1.0367 on one device).
  Held within MESH_FLOPS_RTOL (9%), never below.
- The batch-1 case on 2x2 on its own: the batch cannot split over
  ``data``, so each data rank repeats the other's work: the port counts
  what batch 2 counts a rank (360,710,144); the reference 314,572,800
  (1.1467), its compiler contracting the FSDP-sharded weights over
  ``data`` (partial sums) where the port gathers them.
- One dense layer's collective bytes on 2x2 against a hand count from
  its parameters' specs: each weight split over ``data`` gathered in
  bf16 over 2 ranks, the attention's and the MLP's output projections
  (contracting dims split over ``model``) all-reduced once each.
- ``--sp`` records are ``arch+sp``, with the same FLOPs and other
  collectives; the roofline's mesh rows carry ``t_coll_s`` over
  ``LINK_BW``.
- ``dryrun --all --smoke --mesh 1x4`` and ``--mesh 2x2`` cover every
  cell with ``ok`` (collective bytes > 0) or the documented skip.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import abstract_world  # noqa: E402
from repro_torch.launch.step_analysis import analyze_step  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.sharding.axes import (local_shape,  # noqa: E402
                                       logical_to_spec)

ROOT = Path(__file__).resolve().parents[1]
#: (arch, shape id, (seq, batch), mesh): port / reference FLOPs exactly 1
EXACT = [("granite-20b", "prefill_32k", (1024, 1), (1, 4)),
         ("gemma3-27b", "decode_32k", (1024, 4), (2, 2)),
         ("granite-moe-1b-a400m", "decode_32k", (1024, 4), (1, 4)),
         ("granite-20b", "prefill_32k", (1024, 2), (2, 2))]
#: ... within MESH_FLOPS_RTOL
BOUNDED = [("granite-moe-1b-a400m", "prefill_32k", (1024, 1), (1, 4)),
           ("granite-20b", "train_4k", (128, 8), (2, 2)),
           ("dbrx-132b", "train_4k", (128, 8), (2, 2)),
           ("mamba2-780m", "prefill_32k", (1024, 2), (2, 2))]
BATCH_ONE = ("granite-20b", "prefill_32k", (1024, 1), (2, 2))
MESH_FLOPS_RTOL = 0.09
LIMIT_S = 300


def _key(cell):
    arch, sid, (s, b), (d, m) = cell
    return f"{arch} {sid} {s}x{b} {d}x{m}"


def _shape(sid, s, b):
    return dataclasses.replace(configs.get_shape(sid), seq_len=s,
                               global_batch=b)


def _reference_main(out: Path) -> None:
    import jax
    from jax.sharding import Mesh

    from repro.configs import get_config as jget
    from repro.configs import get_shape as jshape
    from repro.launch.cells import build_cell as jbuild
    from repro.launch.hlo_analysis import analyze_compiled

    res = {}
    for cell in EXACT + BOUNDED + [BATCH_ONE]:
        arch, sid, (s, b), shp = cell
        # not jax.make_mesh: its Explicit axes are refused by the
        # reference's shard_activation
        mesh = Mesh(np.array(jax.devices()[:shp[0] * shp[1]]).reshape(shp),
                    ("data", "model"))
        shape = dataclasses.replace(jshape(sid), seq_len=s, global_batch=b)
        with mesh:
            compiled = jbuild(arch, sid, mesh, cfg=jget(arch).smoke(),
                              shape=shape).lower().compile()
        res[_key(cell)] = analyze_compiled(compiled)["flops_per_device"]
    out.write_text(json.dumps(res))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's per-device FLOPs of every parity cell, compiled
    in a subprocess started with the module's first test."""
    out = tmp_path_factory.mktemp("mesh_analysis") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__)), "reference", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    got = {}

    def result():
        if not got:
            try:
                log, _ = proc.communicate(timeout=LIMIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                raise
            assert proc.returncode == 0, log[-3000:]
            got.update(json.loads(out.read_text()))
        return got

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


pytestmark = pytest.mark.usefixtures("reference")


def _mesh_flops(cell) -> float:
    arch, sid, (s, b), shp = cell
    with abstract_world(shp) as mesh:
        c = build_cell(arch, sid, mesh, cfg=configs.get_config(arch).smoke(),
                       shape=_shape(sid, s, b))
        return analyze_step(c.step_fn, *c.args)["flops_per_device"]


# ---------------------------------------------------------------------- #
# the collectives' wire bytes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,dim", [((1, 4), 0), ((2, 2), 1),
                                       ((1, 4), 1)])
def test_wire_bytes_of_each_collective(shape, dim):
    """g = 1 (the data axis of 1x4), 2 (an axis of 2x2), 4 (model of
    1x4): a (16, 8) f32 block through each collective."""
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    scatter = getattr(funcol, "reduce_scatter_single", None) \
        or funcol.reduce_scatter_tensor
    g = shape[dim]
    x = torch.empty((16, 8), device="meta")
    n = 16 * 8 * 4
    with abstract_world(shape) as mesh:
        grp = (mesh, dim)

        def step(x):
            for y in (funcol.all_reduce(x, "sum", grp),
                      gather(x, 0, grp), scatter(x, "sum", 0, grp),
                      funcol.all_to_all_single(x, None, None, grp)):
                funcol.wait_tensor(y)

        got = analyze_step(step, x)
    want = {"all-reduce": 2.0 * n * (g - 1) / g,
            "all-gather": (g * n) * (g - 1) / g,
            "reduce-scatter": (n / g) * (g - 1),
            "all-to-all": n * (g - 1) / g}
    assert got["per_collective"] == want
    assert got["collective_bytes_per_device"] == sum(want.values())
    assert got["counted_ops"] == 4            # the waits are free
    assert got["flops_per_device"] == 0


def test_a_dtensor_op_counts_its_local_operations_once():
    """A DTensor product of blocks split on the contracting dim: the
    local (8, 16) @ (16, 32) product and, for its partial sums, one
    all-reduce of the (8, 32) result over the 4 ranks; the DTensor-level
    product itself and its sharding propagation are not counted."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with abstract_world((1, 4)) as mesh:
        x = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(8, 64), stride=(64, 1))
        w = DTensor.from_local(torch.empty(16, 32, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False,
                               shape=(64, 32), stride=(32, 1))
        got = analyze_step(
            lambda x, w: (x @ w).redistribute(mesh, [Replicate()] * 2), x, w)
    assert got["flops_per_device"] == 2 * 8 * 32 * 16
    assert got["per_collective"] == {"all-reduce": 2.0 * 8 * 32 * 4 * 3 / 4}


def test_abstract_world_refuses_an_initialised_world_and_closes():
    import torch.distributed as dist

    with abstract_world((2, 2)) as mesh:
        assert tuple(mesh.shape) == (2, 2) and mesh.device_type == "cuda"
        with pytest.raises(RuntimeError, match="already initialised"):
            with abstract_world((1, 1)):
                pass
    assert not dist.is_initialized()


# ---------------------------------------------------------------------- #
# (1, 1), the expert count
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,sid", [
    ("granite-20b", "train_4k"), ("gemma3-27b", "decode_32k"),
    ("mamba2-780m", "prefill_32k"), ("hymba-1.5b", "decode_32k"),
    ("whisper-small", "prefill_32k"), ("llava-next-mistral-7b",
                                       "prefill_32k")])
def test_one_by_one_mesh_equals_the_one_card_analysis(arch, sid):
    cfg = configs.get_config(arch).smoke()
    shape = dryrun.smoke_shape(configs.get_shape(sid))
    one = dryrun.analyze_cell(arch, sid, cfg=cfg, shape=shape)
    with abstract_world((1, 1)) as mesh:
        got = dryrun.analyze_cell(arch, sid, cfg=cfg, shape=shape,
                                  mesh=mesh)
    for k in ("flops_per_device", "hbm_bytes_per_device", "counted_ops",
              "peak_bytes_per_device", "state_bytes"):
        assert got[k] == one[k], k
    assert got["state_bytes_per_card"] == one["state_bytes"]
    assert got["collective_bytes_per_device"] == 0
    assert got["per_collective"] == {}


def test_expert_count_equals_bincount():
    rng = np.random.default_rng(3)
    for n, size in ((4, 1), (8, 300), (16, 5000), (64, 17)):
        ids = torch.from_numpy(rng.integers(0, n, size))
        got = moe.expert_counts(ids, n)
        want = torch.bincount(ids, minlength=n)
        assert got.dtype == want.dtype and torch.equal(got, want)
    meta = moe.expert_counts(torch.empty(40, dtype=torch.int64,
                                         device="meta"), 8)
    assert meta.shape == (8,) and meta.device.type == "meta"


def test_analysed_moe_leaves_no_drops_behind():
    moe.reset_ep_drops()
    cfg = configs.get_config("granite-moe-1b-a400m").smoke()
    with abstract_world((1, 4)) as mesh:
        c = build_cell("granite-moe-1b-a400m", "prefill_32k", mesh, cfg=cfg,
                       shape=_shape("prefill_32k", 64, 2))
        analyze_step(c.step_fn, *c.args)
    assert moe.ep_drops() == 0


# ---------------------------------------------------------------------- #
# against the reference's HLO on a mesh
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cell", EXACT, ids=_key)
def test_mesh_flops_equal_the_reference(reference, cell):
    assert _mesh_flops(cell) == reference()[_key(cell)]


@pytest.mark.parametrize("cell", BOUNDED, ids=_key)
def test_mesh_flops_within_the_bound_of_the_reference(reference, cell):
    ratio = _mesh_flops(cell) / reference()[_key(cell)]
    print(f"{_key(cell)}: port / reference {ratio:.4f}")
    assert 1.0 <= ratio <= 1.0 + MESH_FLOPS_RTOL, ratio


def test_batch_one_repeats_the_work_over_data(reference):
    """Batch 1 on 2x2 counts what batch 2 counts a rank; the reference
    splits more (its compiler's choice, not the logical specs')."""
    arch, sid, (s, _), shp = BATCH_ONE
    got = _mesh_flops(BATCH_ONE)
    assert got == _mesh_flops((arch, sid, (s, 2), shp))
    ratio = got / reference()[_key(BATCH_ONE)]
    assert ratio == pytest.approx(360710144 / 314572800)


# ---------------------------------------------------------------------- #
# one dense layer by hand
# ---------------------------------------------------------------------- #
def test_one_dense_layer_collective_bytes_by_hand():
    """granite-20b (smoke) prefill 1,024 x 2 on 2x2: one layer's bytes
    are the analysis at 2 layers less the analysis at 1."""
    arch, shp, (s, b) = "granite-20b", (2, 2), (1024, 2)
    cfg = configs.get_config(arch).smoke()
    recs = []
    with abstract_world(shp) as mesh:
        for depth in (1, 2):
            c = build_cell(arch, "prefill_32k", mesh,
                           cfg=dataclasses.replace(cfg, n_layers=depth),
                           shape=_shape("prefill_32k", s, b))
            recs.append(analyze_step(c.step_fn, *c.args))
        layer_axes = c.model.axes()["layers"][0]
        layer = c.args[0]["layers"][0]
    d, m = shp
    gathered = 0.0
    for blk in ("attn", "mlp"):
        for name, axes in layer_axes[blk].items():
            shape = tuple(layer[blk][name].shape)
            spec = logical_to_spec(axes, shape, mesh)
            if "data" in spec:      # gathered over data, bf16
                n = int(np.prod(local_shape(shape, spec, mesh))) * 2
                gathered += d * n * (d - 1) / d
    rows = (b // d) * s * cfg.d_model * 2          # (B / d, S, E) bf16
    reduced = 2 * (2.0 * rows * (m - 1) / m)       # wo and w_down
    per_layer = {k: recs[1]["per_collective"][k] - recs[0]["per_collective"]
                 [k] for k in recs[1]["per_collective"]}
    assert per_layer == {"all-gather": gathered, "all-reduce": reduced}


# ---------------------------------------------------------------------- #
# the dry run and the roofline
# ---------------------------------------------------------------------- #
def test_sp_records_and_mesh_roofline_rows(tmp_path):
    out = tmp_path / "d.json"
    for extra in ([], ["--sp"]):
        assert dryrun.main(["--arch", "granite-20b", "--shape",
                            "prefill_32k", "--smoke", "--mesh", "1x4",
                            "--out", str(out), *extra]) == 0
    recs = {r["arch"]: r for r in json.loads(out.read_text())}
    plain, sp = recs["granite-20b"], recs["granite-20b+sp"]
    assert (sp["mesh"], sp["chips"]) == ("1x4", 4)
    assert sp["flops_per_device"] == plain["flops_per_device"]
    assert sp["per_collective"] != plain["per_collective"]
    rows = {r["arch"]: r for r in roofline.build_table(out)}
    assert roofline.LINK_BW == 450e9
    for arch, r in rows.items():
        rec = recs[arch]
        assert r["t_coll_s"] == rec["collective_bytes_per_device"] / 450e9
        assert r["t_comp_s"] == rec["flops_per_device"] / 989e12
        assert r["t_mem_s"] == rec["hbm_bytes_per_device"] / 3.35e12
        assert r["bound_time_s"] == max(r["t_comp_s"], r["t_mem_s"],
                                        r["t_coll_s"])
        assert r["mfu_upper_bound"] == r["model_flops"] / (
            4 * 989e12 * r["bound_time_s"])
        assert r["useful_ratio"] == r["model_flops"] / (
            4 * rec["flops_per_device"])
    assert "T_coll" in roofline.format_table(list(rows.values()))


@pytest.mark.parametrize("mesh", list(dryrun.MESHES))
def test_dryrun_mesh_covers_every_smoke_cell(tmp_path, mesh):
    out = tmp_path / "m.json"
    assert dryrun.main(["--all", "--smoke", "--mesh", mesh,
                        "--out", str(out)]) == 0
    recs = {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())}
    assert len(recs) == 40
    for arch in configs.ARCH_IDS:
        for sid in configs.SHAPES:
            r = recs[(arch, sid)]
            assert (r["mesh"], r["chips"]) == (mesh, 4)
            ok, why = configs.cell_supported(arch, sid)
            if not ok:
                assert (r["status"], r["reason"]) == ("skipped", why)
                continue
            assert r["status"] == "ok", r.get("error")
            assert r["flops_per_device"] > 0
            assert r["hbm_bytes_per_device"] > 0
            assert r["collective_bytes_per_device"] > 0
            assert sum(r["per_collective"].values()) == pytest.approx(
                r["collective_bytes_per_device"])
            assert r["state_bytes"] / 4 <= r["state_bytes_per_card"] \
                < r["state_bytes"]
            assert r["fits_mesh"]
            assert r["peak_bytes_per_device"] >= r["state_bytes_per_card"]
    rows = [r for r in roofline.build_table(out) if r["status"] == "ok"]
    assert len(rows) == 33
    assert all(r["t_coll_s"] > 0 and r["dominant"] in
               ("compute", "memory", "collective") for r in rows)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference_main(Path(sys.argv[2]))
