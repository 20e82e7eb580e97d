#!/usr/bin/env python3
"""Time the ``eps_neighbor_counts`` CUDA kernel of two source trees on one
card, in turns.

    python3 tools/eps_compare.py --tree OLD --tree NEW [--out FILE]

Each ``--tree`` is a checkout of this repository (for example an earlier
commit unpacked with ``git archive`` into a git-ignored directory).  The
trees run in the order OLD, NEW, NEW, OLD, each in a process of its own
(both packages are named ``repro_torch``), which builds that tree's
kernels and, at every shape, checks the kernel against its plain version
on the card (max abs error 0) and times it: CUDA events over back-to-back
calls and the device time per call from torch.profiler (the mean of each
device function's launches, summed over its functions); then it runs the
kernel back to back for ``--clock-window`` seconds while ``nvidia-smi``
samples the SM clock and the power draw every 100 ms (medians reported
beside the card's maximum SM clock).  The shapes are
``chip_smoke.py``'s: blobs at 200,000 x 10 and 20,000 x 10 (eps 0.75) and
at 100,000 x 54 with 7 clusters (eps 1.0).  The counts of all trees must
be equal.  Prints one JSON line per run and a summary; ``--out`` writes
them to a file as well.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# (name, n, d, n_clusters, cluster_std, eps)
SHAPES = (("200k_10", 200_000, 10, 10, 0.25, 0.75),
          ("20k_10", 20_000, 10, 10, 0.25, 0.75),
          ("100k_54", 100_000, 54, 7, 0.25, 1.0))
SEED = 0
SMI_FIELDS = "clocks.sm,clocks.max.sm,power.draw"


def clocks_under(fn, seconds: float) -> dict:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi``
    samples every 100 ms while ``fn`` runs back to back for ``seconds``,
    with the card's maximum SM clock."""
    import statistics

    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        calls = 0
        while time.perf_counter() - t0 < seconds:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
            calls += 4
    finally:
        smi.terminate()
        text = smi.communicate(timeout=30)[0]
    rows = []
    for line in text.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    # the first and last samples may fall outside the window
    rows = rows[1:-1] or rows
    if not rows:
        return {"samples": 0, "calls": calls}
    return {"samples": len(rows), "calls": calls,
            "sm_mhz": statistics.median(r[0] for r in rows),
            "max_sm_mhz": rows[0][1],
            "power_w": statistics.median(r[2] for r in rows)}


def worker(tree: Path, reps: int, clock_window: float) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import blobs
    from repro_torch.kernels import ops

    assert torch.cuda.is_available(), "needs a CUDA device"
    t0 = time.perf_counter()
    ops.ensure_built()
    out = {"tree": str(tree), "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "shapes": {}}
    for name, n, d, nc, std, eps in SHAPES:
        X, _ = blobs(n=n, d=d, n_clusters=nc, cluster_std=std, seed=SEED)
        x = torch.from_numpy(X.astype(np.float32)).cuda()
        ops.reset_launch_counts()
        got = ops.eps_neighbor_counts(x, eps=eps)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["eps_neighbor_counts"]
        want = ops.eps_neighbor_counts(x, eps=eps, impl="ref")
        err = int((got.long() - want.long()).abs().max())
        del want
        for _ in range(2):
            ops.eps_neighbor_counts(x, eps=eps)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            ops.eps_neighbor_counts(x, eps=eps)
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                ops.eps_neighbor_counts(x, eps=eps)
            torch.cuda.synchronize()
        # mean duration of each device function, summed over the
        # functions (pre-pass and count kernel): a trace that drops an
        # event does not bias it
        by_fn = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and \
                    "eps_neighbor_counts" in e.name:
                by_fn.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        dev_us = sum(sum(v) / len(v) for v in by_fn.values())
        clocks = clocks_under(lambda: ops.eps_neighbor_counts(x, eps=eps),
                              clock_window)
        c = got.cpu().numpy()
        out["shapes"][name] = {
            "n": n, "d": d, "eps": eps, "launches": launches,
            "max_abs_err": err, "ms": start.elapsed_time(end) / reps,
            "device_ms": dev_us / 1e3, "mean_count": float(c.mean()),
            "counts_sha256": hashlib.sha256(c.tobytes()).hexdigest(),
            "clocks": clocks}
        del x, got
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--clock-window", type=float, default=2.0)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker(a.tree[0].resolve(), a.reps,
                                a.clock_window)), flush=True)
        return 0
    if len(a.tree) != 2:
        ap.error("give --tree twice: OLD, then NEW")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs, failed = [], []
    for tree in (a.tree[0], a.tree[1], a.tree[1], a.tree[0]):
        p = subprocess.run(
            [sys.executable, __file__, "--worker", "--tree", str(tree),
             "--reps", str(a.reps), "--clock-window", str(a.clock_window)],
            capture_output=True, text=True,
            env=env, timeout=1200)
        if p.returncode:
            failed.append(str(tree))
            print(f"run of {tree} failed ({p.returncode}):\n"
                  f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}", flush=True)
            continue
        run = json.loads(p.stdout.strip().splitlines()[-1])
        run["card"] = card
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {}
    for name, *_ in SHAPES:
        rows = [(r["tree"], r["shapes"][name]) for r in runs]
        summary[name] = {
            "ms": [s["ms"] for _, s in rows],
            "device_ms": [s["device_ms"] for _, s in rows],
            "sm_mhz": [s["clocks"].get("sm_mhz") for _, s in rows],
            "power_w": [s["clocks"].get("power_w") for _, s in rows],
            "max_abs_err": max((s["max_abs_err"] for _, s in rows),
                               default=None),
            "counts_equal": len({s["counts_sha256"] for _, s in rows}) == 1}
    line = {"card": card, "order": [r["tree"] for r in runs],
            "summary": summary, "failed": failed}
    print(json.dumps(line), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("\n".join(json.dumps(r) for r in runs + [line]))
    bad = failed or any(s["max_abs_err"] or not s["counts_equal"]
                        for s in summary.values())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
