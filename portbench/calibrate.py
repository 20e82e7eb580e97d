"""The readings that the limits of a cell's check are set from, at the
cell's own size, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--faults half_batch,altered_grad \\
        --fault-seeds 4,5,6] [--out chiprun_out/cal.json]

For each seed the program is set up as a run sets it up (the checked
steps, no window), freed, and compared with the float32 reference: the
sound runs' numbers, whose largest is a limit's lower reading.  On each
control seed the reference computed in float8 (the control) is compared
with the float32 one as the program would be; on each fault seed the
program with that fault planted.  Prints one JSON object (and writes it
to ``--out``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench.run import _paths  # noqa: E402


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def one(cell, seed: int, device: str, fault=None, control=False, **kw):
    import torch

    from portbench import check
    from portbench.faults import FAULTS
    from portbench.harness import Session

    s = Session(cell, seed, device,
                fault=FAULTS[fault] if fault else None, **kw)
    t0 = time.perf_counter()
    s.setup()
    setup = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    s.close_program()
    t0 = time.perf_counter()
    ref = s.reference("f32")
    out = {"seed": seed, "fault": fault, "setup_s": setup,
           "reference_s": time.perf_counter() - t0, "peak_bytes": peak,
           "losses": s.readings["losses"], "ref_losses": ref["losses"],
           "numbers": check.numbers(s.readings, ref),
           "worst": check.worst_leaves(s.readings, ref)}
    if control:
        t0 = time.perf_counter()
        ctrl = s.reference("fp8")
        out["control_s"] = time.perf_counter() - t0
        out["control"] = check.numbers(ctrl, ref)
        out["control_worst"] = check.worst_leaves(ctrl, ref)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    _paths()
    import torch

    from portbench import manifest

    cell = manifest.cell(args.workload)
    runs = []
    for seed in args.seeds:
        runs.append(one(cell, seed, args.device,
                        control=seed in args.control_seeds))
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in args.fault_seeds:
            runs.append(one(cell, seed, args.device, fault=fault))
            print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    sound = [r["numbers"] for r in runs if r["fault"] is None]
    summary = {
        "workload": args.workload, "runs": runs,
        "card": torch.cuda.get_device_name(0) if args.device == "cuda"
        else "cpu",
        "lower": {k: max(n[k] for n in sound) for k in sound[0]}
        if sound else {},
        "control_least": {k: min(r["control"][k] for r in runs
                                 if "control" in r)
                          for k in (sound[0] if sound else {})}
        if any("control" in r for r in runs) else {},
        "wall_s": time.perf_counter() - T0}
    text = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
