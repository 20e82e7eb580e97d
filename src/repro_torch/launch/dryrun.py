"""Dry run: every (architecture × input shape) cell at its full
published size, analysed without allocation, on one card or per card on
a mesh of four.

The counterpart of ``repro.launch.dryrun`` for NVIDIA H100s.  The
reference lowers and compiles each cell with XLA on 256- and 512-chip
meshes of placeholder devices and records XLA's memory and cost
analyses; here each cell is built on ``meta`` tensors
(``launch.cells.build_cell(..., device="meta")``) and its step runs once
under ``launch.step_analysis.analyze_step``: no card, no allocation, no
placeholder devices.  Each record keeps the reference's keys (``arch``,
``shape``, ``mesh`` = ``"1xH100"``, ``chips`` = 1, ``status`` ``ok`` /
``skipped`` with ``cell_supported``'s reason / ``error``, and the
analysis), and in place of ``memory_analysis``:

* ``state_bytes``: the exact bytes of the parameters, optimizer state,
  caches and inputs the cell holds across a step;
* ``fits_one_card``: ``state_bytes`` within the card's 80 GB (the single
  card's reading of the reference's ``peak_bytes``);
* ``peak_bytes_per_device``: that state plus the most the step's own
  tensors hold at once (``analyze_step``).

``--mesh 1x4`` / ``--mesh 2x2`` (data x model) records carry the same
analysis per card, as the reference's per-mesh records do: the cell is
built on a ``(data, model)`` ``DeviceMesh`` of that shape in
``launch.mesh.abstract_world`` (rank 0 of a world of four with no
cards), its parameters, optimizer state, caches and inputs laid out by
their logical axes (``sharding.logical_to_spec``) as ``meta`` DTensors,
and its step runs once under ``analyze_step``, which counts rank 0's
operations and the wire bytes of the collectives it runs
(``collective_bytes_per_device``, ``per_collective``).  With them:
``state_bytes`` (the whole state), ``state_bytes_per_card`` (rank 0's
blocks; every rank's are the same size) and ``fits_mesh`` (within one
card's 80 GB) — which published cells fit four H100s whole.  ``mesh`` =
``"1x4"`` or ``"2x2"``, ``chips`` = 4.  A moe cell on a mesh takes the
expert-parallel dispatch, which bounds each expert's tokens by its
capacity; on one card it takes the dense dispatch, so their counts
differ.

``--sp`` analyses each cell with ``seq_shard_activations=True`` (the
residual stream sharded over ``model`` on the sequence), its records'
``arch`` written ``arch+sp``, as the reference's ``--sp`` does.

Records go to ``results/torch_dryrun.json`` (merged over the records
already there, cell by cell); ``python -m repro_torch.launch.roofline``
reads them.  Exit status 1 when any cell failed, as the reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b \\
      --shape long_500k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke \\
      --out /tmp/smoke.json     # every cell, smoke configs, shapes / 32
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1x4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 2x2 --sp
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

from ..configs import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig,
                       cell_supported, get_config, get_shape)
from .cells import build_cell
from .mesh import abstract_world
from .step_analysis import analyze_step, local_tensors, tree_bytes

RESULTS = Path(__file__).resolve().parents[3] / "results"
MESH = "1xH100"
CARD_BYTES = 80e9   # one H100 SXM's HBM3 (data sheet)
#: ``--smoke`` cuts each shape's sequence and batch by this factor
SMOKE_DIVISOR = 32
#: the (data, model) meshes of four cards ``--mesh`` reckons
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def smoke_shape(shape: ShapeConfig) -> ShapeConfig:
    """A shape cut for ``--smoke``: sequence and batch / SMOKE_DIVISOR."""
    return dataclasses.replace(
        shape, seq_len=max(shape.seq_len // SMOKE_DIVISOR, 8),
        global_batch=max(shape.global_batch // SMOKE_DIVISOR, 1))


#: the keys that add up layer by layer
_ADDITIVE = ("flops_per_device", "hbm_bytes_per_device",
             "collective_bytes_per_device", "peak_bytes_per_device",
             "counted_ops")


def layer_period(cfg: ArchConfig) -> int:
    """Layers after which the stack repeats itself: gemma3's local:global
    pattern, else 1."""
    return sum(cfg.local_global_pattern) if cfg.local_global_pattern else 1


def at_depth(cfg: ArchConfig, n: int) -> ArchConfig:
    """``cfg`` with ``n`` layers (an encoder-decoder: ``n`` each)."""
    changes = {"n_layers": n}
    if cfg.family == "audio":
        changes["n_encoder_layers"] = n
    return dataclasses.replace(cfg, **changes)


def analyze_cell(arch: str, shape_id: str, cfg: Optional[ArchConfig] = None,
                 shape: Optional[ShapeConfig] = None,
                 grad_accum: Optional[int] = None, mesh=None) -> dict:
    """``analyze_step`` of the cell built on ``meta`` (or on ``mesh``, a
    ``DeviceMesh`` of :func:`~.mesh.abstract_world`, where it counts one
    rank's step), plus its ``state_bytes`` and ``grad_accum``; on a mesh
    also ``state_bytes_per_card``.

    The reference's HLO analysis multiplies a loop body by its trip count
    (its layers are a ``lax.scan``).  The port's layers are a Python loop,
    which the analysis would walk layer by layer; so a deep stack is
    analysed at ``r + p`` and ``r + 2p`` layers (``p`` the
    ``layer_period``, ``r`` the depth modulo ``p``) and the difference,
    one period's counts, is added for each further period (key by key
    for ``per_collective``).  That is exact for FLOPs, bytes, collective
    bytes and operations, since every period runs the same operations on
    the same shapes; the live-bytes peak grows by one period's state and
    saved activations a period, as it does in the step.  An
    encoder-decoder is extended only when both stacks have the same depth
    (else analysed whole)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else get_shape(shape_id)
    where = "meta" if mesh is None else mesh

    def cell(c):
        return build_cell(arch, shape_id, where, grad_accum=grad_accum,
                          cfg=c, shape=shape)

    full = cell(cfg)
    rec = {"state_bytes": tree_bytes(*full.args)}
    if mesh is not None:
        rec["state_bytes_per_card"] = tree_bytes(*local_tensors(*full.args))
    if full.accum is not None:
        rec["grad_accum"] = full.accum
    p, d = layer_period(cfg), cfg.n_layers
    lo = d % p + p
    if d <= lo + p or (cfg.family == "audio" and cfg.n_encoder_layers != d):
        rec.update(analyze_step(full.step_fn, *full.args))
        return rec
    del full
    a, b = (analyze_step(c.step_fn, *c.args) for c in (
        cell(at_depth(cfg, n)) for n in (lo, lo + p)))
    periods = (d - lo) // p
    rec.update({k: a[k] + periods * (b[k] - a[k]) for k in _ADDITIVE})
    rec["per_collective"] = {
        k: a["per_collective"].get(k, 0.0) + periods * (
            b["per_collective"].get(k, 0.0) - a["per_collective"].get(k, 0.0))
        for k in {**a["per_collective"], **b["per_collective"]}}
    rec["analyzed_depths"] = [lo, lo + p]
    return rec


def run_cell(arch: str, shape: str, grad_accum=None, smoke: bool = False,
             mesh_name: str = MESH, sp: bool = False) -> dict:
    """The record of one cell: analysed on one card (``mesh_name``
    ``1xH100``) or per card on a four-card mesh (``1x4`` / ``2x2``);
    ``sp``: with ``seq_shard_activations``."""
    chips = 1 if mesh_name == MESH else 4
    rec = {"arch": arch + ("+sp" if sp else ""), "shape": shape,
           "mesh": mesh_name, "chips": chips}
    tag = f"[{rec['arch']} × {shape} × {mesh_name}]"
    ok, why = cell_supported(arch, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    try:
        t0 = time.time()
        cfg = get_config(arch).smoke() if smoke else get_config(arch)
        if sp:
            cfg = dataclasses.replace(cfg, seq_shard_activations=True)
        sc = smoke_shape(get_shape(shape)) if smoke else None
        if mesh_name == MESH:
            rec.update(analyze_cell(arch, shape, cfg=cfg, shape=sc,
                                    grad_accum=grad_accum))
            rec["fits_one_card"] = rec["state_bytes"] <= CARD_BYTES
        else:
            with abstract_world(MESHES[mesh_name]) as mesh:
                rec.update(analyze_cell(arch, shape, cfg=cfg, shape=sc,
                                        grad_accum=grad_accum, mesh=mesh))
            rec["fits_mesh"] = rec["state_bytes_per_card"] <= CARD_BYTES
        rec["status"] = "ok"
        rec["analyze_s"] = round(time.time() - t0, 1)
        if smoke:
            rec["smoke"] = True
        fits = (f"(fits one card: {rec['fits_one_card']})"
                if chips == 1 else
                f"per card {rec['state_bytes_per_card'] / 1e9:.2f} GB "
                f"(fits: {rec['fits_mesh']})")
        print(f"{tag} analysed in {rec['analyze_s']}s: "
              f"flops/device={rec['flops_per_device']:.3e} "
              f"hbm_bytes/device={rec['hbm_bytes_per_device']:.3e} "
              f"collective_bytes/device="
              f"{rec['collective_bytes_per_device']:.3e} "
              f"state={rec['state_bytes'] / 1e9:.2f} GB {fits} "
              f"peak={rec['peak_bytes_per_device'] / 1e9:.2f} GB",
              flush=True)
    except Exception as e:  # noqa: BLE001 — a failed cell is a record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"{tag} FAILED: {rec['error']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default when neither "
                         "--arch nor --shape is given)")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family configs at shapes cut "
                         "by SMOKE_DIVISOR: a quick check of every cell")
    ap.add_argument("--mesh", default=MESH, choices=[MESH, *MESHES],
                    help="1xH100 (default): the step analysis on one card; "
                         "1x4 / 2x2: per card on a (data, model) mesh of "
                         "four")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel residual stream variant "
                         "(records tagged arch+sp)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch and not args.all else list(ARCH_IDS)
    shapes = [args.shape] if args.shape and not args.all else list(SHAPES)
    records = [run_cell(arch, shape, grad_accum=args.grad_accum,
                        smoke=args.smoke, mesh_name=args.mesh, sp=args.sp)
               for arch in archs for shape in shapes]
    out = Path(args.out) if args.out else RESULTS / "torch_dryrun.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    existing = []
    if out.exists():
        keys = {(r["arch"], r["shape"], r["mesh"]) for r in records}
        existing = [r for r in json.loads(out.read_text())
                    if (r["arch"], r["shape"], r["mesh"]) not in keys]
    out.write_text(json.dumps(existing + records, indent=1))
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors -> {out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
