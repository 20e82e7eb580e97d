#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--points N]

Phases, each of which raises on failure (exit code != 0):

1. device  — print the card (``nvidia-smi`` name and power limit, torch's
             device name); no CUDA device is a failure.
2. build   — compile the kernel library from ``src/repro_torch/kernels/
             csrc/*.cu`` with nvcc for sm_90a and print the seconds.
3. main    — the ``soa-device`` streaming engine through the public API:
             the paper's blobs set (n=200,000, d=10, 10 clusters) with
             k=10, t=10, eps=0.75, inserted in batches of 1000 with deltas
             drained every batch, sampled ``label()`` calls every batch and
             ``labels()`` every 10th, then 25% of the points deleted in
             batches of 1000, then snapshot + restore.  The same stream
             runs through the host ``soa`` engine (no kernels); labels,
             deltas and the restored labels must be equal, and every
             kernel must have launched.  Prints throughput and ARI.
4. kernels — each kernel at the main path's shapes (its last insert
             batch and slot count), held bit-exact against its plain
             PyTorch version on the card (out-of-range ids included for
             the bucket kernels), then timed with CUDA events against
             the plain version and, where one exists, a library call;
             the profiler gives each kernel's device time per launch.
5. profile — device busy share of five more insert batches at the
             main path's final state (torch.profiler).

The line before the last is one JSON object with a ``kernels`` list; the
last line is ``{"ok": true, "device": {...}}``.  ``--points`` cuts the
stream (the cut is printed); d, k, t, eps and the batch never change.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "src" / "repro_torch"

D, K, T, EPS, BATCH, SEED = 10, 10, 10, 0.75, 1000, 0
FULL_POINTS = 200_000          # DATASET_SPECS["blobs"][0]
DELETE_FRACTION = 0.25
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# H100 SXM scalar rate outside the tensor cores: the data sheet's 67
# TFLOP/s float32 counts a fused multiply-add as two operations, so a lone
# add, multiply, compare or int32 operation issues at half of it
SCALAR_OPS_PER_S = 67e12 / 2
KERNEL_SOURCES = {
    "lsh_hash": ("src/repro_torch/kernels/csrc/lsh_hash.cu",
                 "src/repro/kernels/lsh_hash.py:65"),
    "slot_counts": ("src/repro_torch/kernels/csrc/bucket_ops.cu",
                    "src/repro/kernels/bucket_ops.py:117"),
    "bucket_core_stats": ("src/repro_torch/kernels/csrc/bucket_ops.cu",
                          "src/repro/kernels/bucket_ops.py:63"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------- #
# main path
# ---------------------------------------------------------------------- #
def run_main_path(n_points: int, device: str):
    """Drive soa-device (on ``device``) and the host soa engine through
    the same stream; returns (metrics, last-batch inputs for phase 4)."""
    import numpy as np

    from repro_torch.api import ClusterConfig, build_index, restore_index
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.data import DATASET_SPECS, blobs
    from repro_torch.kernels import ops

    _n, d, n_clusters = DATASET_SPECS["blobs"]
    if d != D:
        raise AssertionError(f"blobs spec has d={d}, expected {D}")
    X, y = blobs(n=n_points, d=d, n_clusters=n_clusters, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    cfg = ClusterConfig(d=D, k=K, t=T, eps=EPS, seed=SEED,
                        backend="soa-device")
    dev = build_index(cfg, device=device)
    host = build_index(cfg.replace(backend="soa"))
    dev.drain_deltas()
    host.drain_deltas()

    # host clock around the engine's two device passes (uploads, kernel
    # launches, downloads) — the device-path share of the wall time
    eng = dev.engine
    pass_s = [0.0]

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                pass_s[0] += time.perf_counter() - t0
        return run

    eng._hash_batch = timed(eng._hash_batch)
    eng._batch_stats = timed(eng._batch_stats)

    ops.reset_launch_counts()
    ins_s = del_s = query_s = 0.0
    n_deltas = 0
    t_path = time.perf_counter()
    last = None
    n_batches = (n_points + BATCH - 1) // BATCH
    for b in range(n_batches):
        Xb = X[b * BATCH:(b + 1) * BATCH]
        t0 = time.perf_counter()
        ids = dev.insert_batch(Xb)
        deltas = dev.drain_deltas()
        ins_s += time.perf_counter() - t0
        if host.insert_batch(Xb) != ids:
            raise AssertionError(f"batch {b}: assigned ids differ")
        if sorted(deltas) != sorted(host.drain_deltas()):
            raise AssertionError(f"batch {b}: insert deltas differ")
        n_deltas += len(deltas)
        sample = rng.choice(ids, size=min(32, len(ids)), replace=False)
        t0 = time.perf_counter()
        got = [dev.label(int(i)) for i in sample]
        full = dev.labels() if b % 10 == 9 else None
        query_s += time.perf_counter() - t0
        if got != [host.label(int(i)) for i in sample]:
            raise AssertionError(f"batch {b}: sampled labels differ")
        if full is not None and full != host.labels():
            raise AssertionError(f"batch {b}: labels() differ")
        if b == n_batches - 1:
            rows = [eng._row[i] for i in ids]
            ns = eng._n_slots
            last = {"x": np.asarray(Xb, np.float32),
                    "slots": eng._slots[rows].copy(),
                    "n_slots": ns, "sizes": eng._bsize[:ns].copy(),
                    "eta": eng.lsh.eta.astype(np.float32),
                    "mixers": eng.lsh.mixers.copy(),
                    "inv_cell": eng.lsh.inv_cell}
    labels_ins = dev.labels()
    if labels_ins != host.labels():
        raise AssertionError("labels() differ after the inserts")
    ari_ins = adjusted_rand_index(
        y, np.array([labels_ins[i] for i in range(n_points)]))

    victims = rng.permutation(n_points)[:int(n_points * DELETE_FRACTION)]
    for b in range(0, len(victims), BATCH):
        vb = [int(i) for i in victims[b:b + BATCH]]
        t0 = time.perf_counter()
        dev.delete_batch(vb)
        deltas = dev.drain_deltas()
        del_s += time.perf_counter() - t0
        host.delete_batch(vb)
        if sorted(deltas) != sorted(host.drain_deltas()):
            raise AssertionError(f"delete batch {b // BATCH}: deltas differ")
        n_deltas += len(deltas)
    labels_del = dev.labels()
    if labels_del != host.labels():
        raise AssertionError("labels() differ after the deletes")
    live = np.array(sorted(labels_del))
    ari_del = adjusted_rand_index(
        y[live], np.array([labels_del[int(i)] for i in live]))

    snap = dev.snapshot()
    rest = restore_index(snap, device=device)
    if rest.labels() != labels_del:
        raise AssertionError("labels differ after snapshot + restore")
    wall = time.perf_counter() - t_path
    launches = ops.launch_counts()
    last["restored"] = rest
    if device != "cpu":
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main "
                                 f"path: {missing}")
    metrics = {
        "points": n_points, "cut": n_points != FULL_POINTS,
        "d": D, "k": K, "t": T, "eps": EPS, "batch": BATCH,
        "deleted": len(victims), "deltas": n_deltas,
        "insert_pts_per_s": n_points / ins_s,
        "delete_pts_per_s": len(victims) / del_s if del_s else None,
        "insert_s": ins_s, "delete_s": del_s, "query_s": query_s,
        "main_path_wall_s": wall, "device_pass_s": pass_s[0],
        "device_pass_share_of_insert": pass_s[0] / ins_s,
        "n_slots": last["n_slots"], "ari_after_inserts": ari_ins,
        "ari_after_deletes": ari_del, "launches": launches,
        "labels_equal_host_soa": True, "deltas_equal_host_soa": True,
        "restore_labels_equal": True,
    }
    return metrics, last


# ---------------------------------------------------------------------- #
# device time from the profiler (CUPTI)
# ---------------------------------------------------------------------- #
def device_events(fn):
    """Run ``fn`` under torch.profiler; returns its wall seconds and the
    (name, device microseconds) of every device activity it traced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]


def kernel_device_ms(fns, reps: int = 50):
    """Mean device milliseconds per launch of each kernel in ``fns``
    (name -> call), from the profiler; None where it traced none."""
    def run():
        for fn in fns.values():
            for _ in range(reps):
                fn()
    _wall, evs = device_events(run)
    out = {}
    for name in fns:
        durs = [us for ev, us in evs if f"{name}_kernel" in ev]
        out[name] = sum(durs) / len(durs) / 1e3 if durs else None
    return out


def profile_insert_window(index, batches: int = 5):
    """Device busy share of ``batches`` insert batches (with deltas
    drained) into ``index`` at its current state: device activity time
    by kind over the window's wall time."""
    import numpy as np

    from repro_torch.data import blobs

    Xn, _ = blobs(n=batches * BATCH, d=D, n_clusters=10, seed=SEED + 99)
    Xn = np.asarray(Xn)

    def run():
        for b in range(batches):
            index.insert_batch(Xn[b * BATCH:(b + 1) * BATCH])
            index.drain_deltas()
    wall, evs = device_events(run)
    kinds = {"kernels": 0.0, "memcpy": 0.0, "other": 0.0}
    for name, us in evs:
        key = ("kernels" if any(k in name for k in KERNEL_SOURCES)
               else "memcpy" if "emcpy" in name else "other")
        kinds[key] += us / 1e6
    busy = sum(kinds.values())
    return {"batches": batches, "wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "by_kind_s": kinds, "device_events": len(evs)}


# ---------------------------------------------------------------------- #
# kernels
# ---------------------------------------------------------------------- #
def time_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean device milliseconds per call over ``reps`` back-to-back calls
    (CUDA events on the current stream, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(last, launches, card: str):
    """Bit-exact and timed comparison of each kernel with its plain
    version at the main path's shapes; returns the ``kernels`` list."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    x = torch.from_numpy(last["x"]).to(dev)
    eta = torch.from_numpy(last["eta"]).to(dev)
    mixers = torch.from_numpy(np.ascontiguousarray(last["mixers"])).to(dev)
    slots = torch.from_numpy(last["slots"]).to(dev)
    sizes = torch.from_numpy(last["sizes"]).to(dev)
    ns, inv = last["n_slots"], last["inv_cell"]
    n, t = slots.shape
    # the same slots with ~10% of the ids moved out of range on both sides
    rng = np.random.default_rng(7)
    bad = last["slots"].copy()
    hit = rng.random(bad.shape) < 0.1
    bad[hit] = rng.choice([-3, -1, ns, ns + 5], size=int(hit.sum()))
    bad = torch.from_numpy(bad).to(dev)

    out = []

    def record(name, err, ms, plain_ms, nbytes, nops, library_ms):
        src, replaces = KERNEL_SOURCES[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / SCALAR_OPS_PER_S * 1e3
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": nbytes, "ops": nops,
            "card": card,
        })

    # -- lsh_hash: reads x, eta, mixers once, writes (n, t, 2) keys; per
    #    (point, table, dim) add, mul, floor, convert, 2 mul, 2 add, plus
    #    ~10 ops per avalanche, two per (point, table)
    got = ops.lsh_hash(x, eta, mixers, inv_cell=inv)
    want = ops.lsh_hash(x, eta, mixers, inv_cell=inv, impl="ref")
    err = max_abs_err(got, want)
    nb = (x.numel() + eta.numel() + mixers.numel() + got.numel()) * 4
    record("lsh_hash", err,
           time_ms(lambda: ops.lsh_hash(x, eta, mixers, inv_cell=inv)),
           time_ms(lambda: ops.lsh_hash(x, eta, mixers, inv_cell=inv,
                                        impl="ref")),
           nb, n * t * D * 8 + n * t * 20, None)

    # -- slot_counts: reads n*t ids, writes n_slots counts; one compare
    #    and one atomic add per id
    err = 0
    for s in (slots, bad):
        err = max(err, max_abs_err(ops.slot_counts(s, n_slots=ns),
                                   ops.slot_counts(s, n_slots=ns,
                                                   impl="ref")))
    flat = slots.flatten()
    lib = time_ms(lambda: torch.bincount(flat, minlength=ns))
    if max_abs_err(torch.bincount(flat, minlength=ns).to(torch.int32),
                   ops.slot_counts(slots, n_slots=ns)):
        raise AssertionError("torch.bincount disagrees with slot_counts")
    record("slot_counts", err,
           time_ms(lambda: ops.slot_counts(slots, n_slots=ns)),
           time_ms(lambda: ops.slot_counts(slots, n_slots=ns, impl="ref")),
           (slots.numel() + ns) * 4, 3 * slots.numel(), lib)

    # -- bucket_core_stats: reads n*t ids and the distinct sizes they
    #    gather, writes support and core; per id a compare, a gather, a
    #    compare and an add
    err = 0
    for s in (slots, bad):
        g = ops.bucket_core_stats(s, sizes, k=K)
        w = ops.bucket_core_stats(s, sizes, k=K, impl="ref")
        err = max(err, max_abs_err(g[0], w[0]), max_abs_err(g[1], w[1]))
    distinct = int(torch.unique(slots).numel())
    record("bucket_core_stats", err,
           time_ms(lambda: ops.bucket_core_stats(slots, sizes, k=K)),
           time_ms(lambda: ops.bucket_core_stats(slots, sizes, k=K,
                                                 impl="ref")),
           (slots.numel() + distinct + 2 * n) * 4, 4 * slots.numel(),
           None)
    dev_ms = kernel_device_ms({
        "lsh_hash": lambda: ops.lsh_hash(x, eta, mixers, inv_cell=inv),
        "slot_counts": lambda: ops.slot_counts(slots, n_slots=ns),
        "bucket_core_stats": lambda: ops.bucket_core_stats(slots, sizes,
                                                           k=K)})
    for k in out:
        k["device_ms"] = dev_ms[k["name"]]
    torch.cuda.synchronize()
    bad_k = [k["name"] for k in out if k["max_abs_err"] != 0]
    if bad_k:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {bad_k}")
    return out


# ---------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=FULL_POINTS,
                    help="points in the stream (default: the paper's "
                         "200,000); fewer is a cut and is printed")
    args = ap.parse_args(argv)

    if not (PKG / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {PKG} not found; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(PKG.parent))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU "
              "only", file=sys.stderr)
        return 3

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {kind} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    build_s = ops.ensure_built()
    print(f"build: {build_s:.2f} s nvcc (load {time.perf_counter() - t0:.2f}"
          f" s) from src/repro_torch/kernels/csrc", flush=True)

    # 3. main path
    if args.points != FULL_POINTS:
        print(f"main: CUT — {args.points} points instead of {FULL_POINTS}",
              flush=True)
    metrics, last = run_main_path(args.points, "cuda")
    metrics["card"] = card
    metrics["build_s"] = build_s
    print("main_path " + json.dumps(metrics), flush=True)

    # 4. kernels
    kernels = check_kernels(last, metrics["launches"], card)
    share = sum(k["launches"] * k["ms"] for k in kernels) / 1e3 \
        / metrics["insert_s"]
    print(f"kernel time (launches x ms per call) / insert wall time: "
          f"{share:.4f}  [{card}]", flush=True)

    # 5. where the device time goes in a few insert batches at the main
    #    path's final state (the restored index; launches already read)
    window = profile_insert_window(last["restored"])
    window["card"] = card
    print("profile " + json.dumps(window), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
