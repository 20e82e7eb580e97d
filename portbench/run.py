"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Set-up (import, the kernel library loaded from the checkout's build
directory, the weights and the optimizer state made on the card, the
curation index, the checked steps, the prefetch queue filled) is timed
from the start of this script to the window's first step.  The window
then runs whole steps for ``--seconds``.  Once it has closed, the
program's state is freed and the plain reference runs; the numbers it is
compared on are printed beside their limits, last on standard error and
last in the result's line.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read under the profiler.

Exit codes: 0 with a result line; 2 without a card, 3 when a module of
JAX or of the JAX package is loaded, 1 on any other failure, each with
no result.  ``--device cpu`` runs the same path on the CPU for the tests.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The checkout's root and ``src`` on the path (not this script's own
    folder), every build and kernel cache inside the checkout."""
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def end_to_end(name: str, rec, setup_s: float, peak: int) -> float:
    if name == "train_tokens_per_s":
        return (len(rec.steps) * rec.tokens_per_step
                / (rec.window_end - rec.window_start))
    if name == "peak_mem_gib":
        return peak / 2**30
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r} in this harness")


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, limits=None, **session_kw):
    """-> (result dict, check lines); ``limits`` (the tests' own, at
    their size) replaces the cell's."""
    import torch

    from portbench import check
    from portbench.harness import Session

    on_card = device == "cuda"
    s = Session(cell, seed, device, **session_kw)
    t_import = time.perf_counter() - t_process
    s.setup()
    setup_s = time.perf_counter() - t_process
    rec = s.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    s.close_program()
    t0 = time.perf_counter()
    ref = s.reference("f32")
    ref_s = time.perf_counter() - t0
    checks, ok = check.held(check.numbers(s.readings, ref),
                            limits or cell.limits)
    losses = [st["loss"] for st in rec.steps]
    failed = sum(not (x == x and abs(x) != float("inf")) for x in losses)
    metrics = {}
    if trace:
        from portbench.manifest import metric_module

        for m in cell.per_layer:
            v = metric_module(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], rec,
                                                      setup_s, peak),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1 if on_card else 0, "memory_peak_bytes": peak}
    result = {"correct": bool(ok and failed == 0),
              "attempted": len(rec.steps), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["checks"] = checks
    parts = {"import_s": t_import, **s.setup_parts, "reference_s": ref_s}
    if rec.trace is not None:
        parts["trace_read_s"] = rec.trace.read_s
    lines = [f"set-up and check: {json.dumps(parts)}"]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in checks.items()]
    return result, lines


def main(argv=None) -> int:
    args = parse(argv)
    _paths()
    try:
        import torch

        from portbench import manifest

        cell = manifest.cell(args.workload)
        if args.device == "cuda" and (
                not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        result, lines = run(cell, args.seed, args.seconds, bool(args.trace),
                            args.device, T_PROCESS)
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
