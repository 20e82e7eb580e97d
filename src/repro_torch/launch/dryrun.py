"""Single-card dry run: every (architecture × input shape) cell at its
full published size, analysed without allocation.

The counterpart of ``repro.launch.dryrun`` for one NVIDIA H100.  The
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

``--mesh 1x4`` / ``--mesh 2x2`` (data x model) records, per cell, what
one card of four holds when the cell's parameters, optimizer state,
caches and inputs are laid out by their logical axes
(``sharding.logical_to_spec`` over a ``(data, model)`` mesh of that
shape, as the reference's per-mesh records are): ``state_bytes_per_card``
(the largest block, every rank's being the same) and ``fits_mesh``
(within one card's 80 GB) — which published cells fit four H100s whole.
These records carry no step analysis (``mesh`` = ``"1x4"`` or ``"2x2"``,
``chips`` = 4); the reckoning is host-only work on ``meta``.

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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

from ..configs import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig,
                       cell_supported, get_config, get_shape)
from ..optim.adamw import tree_leaves
from ..sharding.axes import local_shape, logical_to_spec, tree_zip_map
from .cells import BATCH_AXES, build_cell
from .step_analysis import analyze_step, tree_bytes

RESULTS = Path(__file__).resolve().parents[3] / "results"
MESH = "1xH100"
CARD_BYTES = 80e9   # one H100 SXM's HBM3 (data sheet)
#: ``--smoke`` cuts each shape's sequence and batch by this factor
SMOKE_DIVISOR = 32
#: the (data, model) meshes of four cards ``--mesh`` reckons
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def host_mesh(shape) -> SimpleNamespace:
    """A stand-in for a (data, model) mesh of ``shape``: its axis names
    and extents, which is all the spec rules read."""
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=SimpleNamespace(shape=tuple(shape)))


def _block_bytes(axes, t, mesh) -> int:
    spec = logical_to_spec(axes, tuple(t.shape), mesh)
    n = 1
    for d in local_shape(tuple(t.shape), spec, mesh):
        n *= d
    return n * t.element_size()


def mesh_state_bytes(cell, mesh) -> int:
    """Bytes one rank holds of ``cell``'s state laid out on ``mesh``:
    parameters (and AdamW's moments) by the parameters' axes, caches by
    the caches', the batch by ``batch``; scalars whole."""
    paxes = cell.model.axes()
    total = 0

    def add(axes, tree):
        nonlocal total
        total += sum(tree_leaves(tree_zip_map(
            lambda ax, t: _block_bytes(ax, t, mesh), axes, tree)))

    if cell.kind == "train":
        params, opt, batch = cell.args
        add(paxes, params)
        add(paxes, opt["m"])
        add(paxes, opt["v"])
        total += sum(t.numel() * t.element_size() for k, t in opt.items()
                     if k not in ("m", "v"))
    elif cell.kind == "prefill":
        params, batch = cell.args
        add(paxes, params)
    else:
        params, caches, token, pos = cell.args
        add(paxes, params)
        add(cell.model.decode_axes(), caches)
        batch = {"tokens": token}
        total += pos.numel() * pos.element_size()
    for k, t in batch.items():
        total += _block_bytes(BATCH_AXES[k], t, mesh)
    return total


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
                 grad_accum: Optional[int] = None) -> dict:
    """``analyze_step`` of the cell built on ``meta``, plus its
    ``state_bytes`` and ``grad_accum``.

    The reference's HLO analysis multiplies a loop body by its trip count
    (its layers are a ``lax.scan``).  The port's layers are a Python loop,
    which the analysis would walk layer by layer; so a deep stack is
    analysed at ``r + p`` and ``r + 2p`` layers (``p`` the
    ``layer_period``, ``r`` the depth modulo ``p``) and the difference,
    one period's counts, is added for each further period.  That is exact
    for FLOPs, bytes and operations, since every period runs the same
    operations on the same shapes; the live-bytes peak grows by one
    period's state and saved activations a period, as it does in the
    step.  An encoder-decoder is extended only when both stacks have the
    same depth (else analysed whole)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else get_shape(shape_id)
    full = build_cell(arch, shape_id, device="meta", grad_accum=grad_accum,
                      cfg=cfg, shape=shape)
    rec = {"state_bytes": tree_bytes(*full.args)}
    if full.accum is not None:
        rec["grad_accum"] = full.accum
    p, d = layer_period(cfg), cfg.n_layers
    lo = d % p + p
    if d <= lo + p or (cfg.family == "audio" and cfg.n_encoder_layers != d):
        rec.update(analyze_step(full.step_fn, *full.args))
        return rec
    del full
    a, b = (analyze_step(c.step_fn, *c.args) for c in (
        build_cell(arch, shape_id, device="meta", grad_accum=grad_accum,
                   cfg=at_depth(cfg, n), shape=shape) for n in (lo, lo + p)))
    periods = (d - lo) // p
    rec.update({k: a[k] + periods * (b[k] - a[k]) for k in _ADDITIVE})
    rec["analyzed_depths"] = [lo, lo + p]
    return rec


def run_mesh_cell(arch: str, shape: str, mesh_name: str,
                  smoke: bool = False) -> dict:
    """The per-card state of a cell on a four-card mesh (no analysis)."""
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": 4}
    ok, why = cell_supported(arch, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        cfg = get_config(arch).smoke() if smoke else None
        sc = smoke_shape(get_shape(shape)) if smoke else None
        cell = build_cell(arch, shape, device="meta", cfg=cfg, shape=sc)
        per_card = mesh_state_bytes(cell, host_mesh(MESHES[mesh_name]))
        rec.update(status="ok", state_bytes=tree_bytes(*cell.args),
                   state_bytes_per_card=per_card,
                   fits_mesh=per_card <= CARD_BYTES)
        if smoke:
            rec["smoke"] = True
        print(f"[{arch} × {shape} × {mesh_name}] state "
              f"{rec['state_bytes'] / 1e9:.2f} GB, per card "
              f"{per_card / 1e9:.2f} GB (fits: {rec['fits_mesh']})",
              flush=True)
    except Exception as e:  # noqa: BLE001 — a failed cell is a record
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[{arch} × {shape} × {mesh_name}] FAILED: {rec['error']}",
              flush=True)
    return rec


def run_cell(arch: str, shape: str, grad_accum=None,
             smoke: bool = False) -> dict:
    rec = {"arch": arch, "shape": shape, "mesh": MESH, "chips": 1}
    ok, why = cell_supported(arch, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    try:
        t0 = time.time()
        cfg = get_config(arch).smoke() if smoke else None
        sc = smoke_shape(get_shape(shape)) if smoke else None
        rec.update(analyze_cell(arch, shape, cfg=cfg, shape=sc,
                                grad_accum=grad_accum))
        rec["status"] = "ok"
        rec["analyze_s"] = round(time.time() - t0, 1)
        rec["fits_one_card"] = rec["state_bytes"] <= CARD_BYTES
        if smoke:
            rec["smoke"] = True
        print(f"[{arch} × {shape} × {MESH}] analysed in {rec['analyze_s']}s: "
              f"flops/device={rec['flops_per_device']:.3e} "
              f"hbm_bytes/device={rec['hbm_bytes_per_device']:.3e} "
              f"state={rec['state_bytes'] / 1e9:.2f} GB "
              f"(fits one card: {rec['fits_one_card']}) "
              f"peak={rec['peak_bytes_per_device'] / 1e9:.2f} GB",
              flush=True)
    except Exception as e:  # noqa: BLE001 — a failed cell is a record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[{arch} × {shape} × {MESH}] FAILED: {rec['error']}",
              flush=True)
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
                         "1x4 / 2x2: the per-card state on four")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch and not args.all else list(ARCH_IDS)
    shapes = [args.shape] if args.shape and not args.all else list(SHAPES)
    if args.mesh == MESH:
        records = [run_cell(arch, shape, grad_accum=args.grad_accum,
                            smoke=args.smoke)
                   for arch in archs for shape in shapes]
    else:
        records = [run_mesh_cell(arch, shape, args.mesh, smoke=args.smoke)
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
