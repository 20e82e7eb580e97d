"""Roofline terms from the dry run, for NVIDIA H100 SXMs.

Hardware model: NVIDIA's data sheet for the H100 SXM, dense rates at the
full 700 W power limit — 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s
of HBM3 (the constants of ``PERF.md``'s kernel table) and NVLink 4 at
900 GB/s a card, both directions together: 450 GB/s for what a card
sends.

For each (arch × shape × mesh) record of ``results/torch_dryrun.json``
(``python -m repro_torch.launch.dryrun``):
  T_comp = FLOPs / peak            [matrix-product FLOPs of the step]
  T_mem  = HBM bytes / HBM bw       [Σ operands + results of its kernels]
  T_coll = collective bytes / link  [a rank's wire bytes; --mesh rows]
plus MODEL_FLOPS = 6·N·D (active N for MoE; prefill 2·N·D; decode D =
one token a sequence), the usefulness ratio MODEL_FLOPS / (chips ·
counted FLOPs) and the MFU upper bound MODEL_FLOPS / (chips · peak ·
the bound), the bound being the largest of the terms.  One card has no
interconnect term: its rows carry no ``t_coll_s``.

Caveats, as the reference's:
  * the HBM term is an upper-bound proxy: it counts what every operation
    of the eager step reads and writes; a fused kernel moves less;
  * the peak assumes bf16 tensor-core work; the steps' f32 element-wise
    work and reductions run slower, so T_comp is optimistic;
  * the counts are the plain attention's (every score pair), as the
    reference's HLO counts them, not the flash kernel's skipped tiles;
  * the link term takes every collective at the one-direction NVLink
    rate, all four cards sending at once; it adds no latency a
    collective, and the terms are not summed (no overlap is assumed or
    ruled out).
These are data-sheet constants over counted work, not measurements.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12     # bf16 dense, tensor cores
HBM_BW = 3.35e12        # B/s
LINK_BW = 450e9         # B/s: NVLink 4, one direction per card

RESULTS = Path(__file__).resolve().parents[3] / "results"


def model_flops(cfg, shape) -> float:
    """6·N·D with active params for MoE; decode steps count 1 token."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def roofline_row(rec: Dict, cfg=None, shape=None) -> Dict:
    chips = rec["chips"]
    terms = {"compute": rec["flops_per_device"] / PEAK_FLOPS,
             "memory": rec["hbm_bytes_per_device"] / HBM_BW}
    if chips > 1:
        terms["collective"] = rec["collective_bytes_per_device"] / LINK_BW
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    out = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_comp_s": terms["compute"], "t_mem_s": terms["memory"],
        "dominant": dominant,
        "bound_time_s": bound,
        "roofline_fraction": terms["compute"] / max(bound, 1e-30),
        "state_gb": rec.get("state_bytes", 0) / 1e9,
        "peak_gb": rec.get("peak_bytes_per_device", 0) / 1e9,
    }
    if chips > 1:
        out.update(t_coll_s=terms["collective"],
                   state_gb_per_card=rec["state_bytes_per_card"] / 1e9,
                   fits_mesh=rec["fits_mesh"])
    else:
        out["fits_one_card"] = rec.get("fits_one_card")
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        out["model_flops"] = mf
        out["useful_ratio"] = mf / max(chips * rec["flops_per_device"], 1e-30)
        out["mfu_upper_bound"] = mf / (chips * PEAK_FLOPS * max(bound, 1e-30))
    return out


def build_table(dryrun_json: Optional[Path] = None) -> List[Dict]:
    from ..configs import get_config, get_shape
    from .dryrun import smoke_shape

    path = dryrun_json or (RESULTS / "torch_dryrun.json")
    rows = []
    for rec in json.loads(Path(path).read_text()):
        if rec.get("status") != "ok":
            rows.append({
                "arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "status": rec["status"],
                "reason": rec.get("reason", rec.get("error", ""))[:90],
            })
            continue
        # variants: "arch+sp"
        cfg = get_config(rec["arch"].split("+")[0])
        shape = get_shape(rec["shape"])
        if rec.get("smoke"):
            cfg, shape = cfg.smoke(), smoke_shape(shape)
        row = roofline_row(rec, cfg, shape)
        row["status"] = "ok"
        rows.append(row)
    return rows


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':24}{'shape':13}{'mesh':8}{'T_comp':>10}{'T_mem':>10}"
           f"{'T_coll':>10}{'bound':>11}{'MFU_ub':>8}{'useful':>8}"
           f"{'state_GB':>10}{'peak_GB':>9}{'fits':>6}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"{r['arch']:24}{r['shape']:13}{r['mesh']:8}"
                         f"  [{r['status']}] {r.get('reason', '')}")
            continue
        mesh = "t_coll_s" in r
        fits = r["fits_mesh"] if mesh else r["fits_one_card"]
        lines.append(
            f"{r['arch']:24}{r['shape']:13}{r['mesh']:8}"
            f"{r['t_comp_s']:10.4f}{r['t_mem_s']:10.4f}"
            + (f"{r['t_coll_s']:10.4f}" if mesh else f"{'-':>10}")
            + f"{r['dominant']:>11}{r.get('mfu_upper_bound', 0):8.3f}"
            f"{r.get('useful_ratio', 0):8.3f}"
            f"{r['state_gb_per_card' if mesh else 'state_gb']:10.1f}"
            f"{r['peak_gb']:9.1f}{'yes' if fits else 'no':>6}")
    return "\n".join(lines)


def main() -> int:
    rows = build_table()
    print(format_table(rows))
    RESULTS.mkdir(exist_ok=True)
    (RESULTS / "torch_roofline.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
