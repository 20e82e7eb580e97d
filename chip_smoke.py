#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--points N]

Phases (1-3, 3b-3d, 4-7), each of which raises on failure (exit code
!= 0):

1. device  — print the card (``nvidia-smi`` name and power limit, torch's
             device name); no CUDA device is a failure.
2. build   — compile the kernel library from ``src/repro_torch/kernels/
             csrc/*.cu`` with nvcc for sm_90a and print the seconds, each
             kernel's registers and spills (``-Xptxas -v``) and the
             ``HGMMA`` (wgmma) instructions in the SASS of the bf16
             flash kernel (``cuobjdump -sass``); a count of 0 fails, and
             so does a spill in an ``eps_neighbor_counts`` kernel or in
             the ``lsh_hash_resolve`` kernel.
3. main    — the ``soa-device`` streaming engine through the public API:
             the paper's blobs set (n=200,000, d=10, 10 clusters) with
             k=10, t=10, eps=0.75, inserted in batches of 1000 with deltas
             drained every batch, sampled ``label()`` calls every batch and
             ``labels()`` every 10th, then 25% of the points deleted in
             batches of 1000, then snapshot + restore.  The same stream
             runs through the host ``soa`` engine (no kernels); labels,
             deltas and the restored labels must be equal, and every
             kernel must have launched: ``lsh_hash`` once per insert
             batch through the ``lsh_hash_resolve`` route (keys probed
             against the device mirror of the bucket directory), the
             bucket kernels once per insert batch through the fused
             ``bucket_insert_pass`` route, none through a standalone
             entry, with no size-table upload in the insert-only stream
             and a directory upload only when the mirror grows.  Prints
             throughput, ARI, the host seconds of the two device passes
             (``hash_pass_s``: points to slots, the device pass and the
             host lookup of its misses, ``resolver_s`` the latter;
             ``stats_pass_s``) and the misses a batch.  The host
             engine's labels and sorted deltas are kept for phase 3b.
3b. dict   — the paper's Euler-tour engine with one ``lsh_hash`` call a
             batch, ``batched-device`` on the card, through the same
             stream as phase 3 (inserts, deltas drained every batch, 32
             sampled ``label()`` calls a batch and ``labels()`` every
             10th, the same 25% deleted, snapshot + restore): labels at
             every 10th batch and at the ends and each batch's sorted
             deltas must equal the host ``soa`` engine's of phase 3, each
             batch's keys its plain ``lsh_hash`` on the card, the sampled
             roots must partition the sample as ``labels()`` does, the
             standalone ``lsh_hash`` entry must launch once per insert
             batch and no other kernel at all, and the restore must
             rebuild the exact forest (``check_invariants``).  Prints
             throughput, ``labels()`` seconds, ARI, ``stats()``, the host
             seconds of the hash call (upload, launch, download) against
             the rest of an insert batch, and the kernel at the last
             batch per call beside its plain version and its bound.
3c. approx — the sampled-core engine (``core.approx``) on its device
             path, ``ApproxIndex(cfg, SampledCoreDBSCAN(...,
             use_device=True, device="cuda"))``, whose insert batch is one
             launch of ``bucket_insert_pass``'s masked two-table route:
             (a) phase 3's stream at rate 0.5 (k_s = 5), no ``label()``
             calls, beside the same engine on the host: every batch's
             sorted deltas, ``labels()`` at every 10th batch and at both
             ends, snapshot + restore (equal labels, ``check_invariants``)
             and one more batch into the restore beside a host restore
             must be equal; the masked pass and ``lsh_hash_resolve`` once
             per insert batch and no other bucket or hash entry; both
             mirrors equal to the host tables after the inserts; the ARI
             against phase 3's exact labels is reported.  (b) Phase 3's
             stream at rate 1.0 on the card: every batch's deltas and the
             labels must equal phase 3's host ``soa`` results.  (c) The
             tier's operating point (``benchmarks/quality_speed.py``
             FULL: 36,000 points through a 24,000-point window, batches
             of 1000, d=8, 8 clusters, std 0.5, k=256, t=10, eps=0.5,
             data seed 3) at rate 0.1 (k_s = 26), device against host as
             in (a), then the host twin and the host ``soa`` engine timed
             alone: insert and delete throughput of all three, the ARI of
             the final window against ``soa``.
3d. tiered — ``build_index(ClusterConfig(backend="tiered",
             sample_rate=0.1, obs=True))`` (both tiers on the host, no
             kernel) over (c)'s stream: update and label-serving
             throughput; after the ``exact_labels()`` barrier the
             ``tiered.divergence_ari`` and ``tiered.lag`` gauges and the
             escalations; the back tier's labels must equal (c)'s host
             ``soa`` run; ``close()`` must stop the verifier thread.
4. baselines — the paper's Table-2 streaming protocol at its default
             scale (``benchmarks/table2.py``, scale 0.1): blobs n=20,000,
             d=10, 10 clusters, k=10, t=10, eps=0.75, batches of 1000
             with ``labels()`` after every batch, through the host
             backends ``dynamic`` (the table's headline row), ``naive``,
             ``emz-static`` and ``emz-fixed``; prints each one's seconds,
             ARI and NMI; snapshot + restore of all but ``emz-fixed``
             must give equal labels.  Then
             the exact eps-ball counts of the final 20,000 points on the
             card (the ``eps_neighbor_counts`` kernel, which must
             launch), held bit-exact against its plain version; the rows
             where they differ from the host float64 counts of
             ``core.naive_dbscan`` and the core flags that flip at k=10
             are reported (two definitions, not a check).
5. lm      — the dense-LM serving path on gemma3-27b at its published
             widths (d_model 5376, 32 query / 16 kv heads of 128, d_ff
             21504, vocab 262,144, window 1024 on 5 of every 6 layers),
             depth cut to 6 layers, f32 weights from a seeded
             ``torch.Generator`` on the card: a bf16 ``forward`` of 4,096
             tokens must launch ``flash_attention`` 6 times, all on its
             tensor-core route (``flash_attention_sm90``), and give
             finite logits (wall ms, peak memory); the kernel against its
             plain version at the model's shapes, window and global, in
             f32 (CUDA-core route, atol = rtol = 2e-5) and bf16
             (tensor-core route, against the plain version of the f32
             upcast rounded to bf16, one ulp), and over a sweep of the
             reference tests' cases, decode rows, head_dim 16-256 (36:
             padded to 40) and ragged lengths; f32 prefill logits
             (kernel) against teacher-forced ``decode_step`` logits
             (plain torch) over 1,100 tokens, TF32 off, atol = rtol =
             2e-4; the
             ``ServingEngine`` at batch 4, kv_len 2048, 8 requests of
             8-64 prompt tokens and 16 new tokens with request
             clustering on ``soa-device`` (tokens/s, step p50/p99).
             Then the kernel timed at the model's shapes in bf16 (and
             its f32 route, ``ms_f32``) beside its plain version,
             ``scaled_dot_product_attention`` and the bound, and the top
             device operations of a prefill and of a decode step.
6. kernels — each clustering kernel at its path's shapes, held
             bit-exact against its plain PyTorch version on the card,
             then timed with CUDA events against the plain version and,
             where one exists, a library call; the profiler gives each
             kernel's device time per launch.  ``lsh_hash_resolve`` runs
             the main path's last batch against the directory it probed
             (equal to the main path's keys and hits), the final
             directory (equal to its slots) and a flush that erases ~10%
             of it and one that reinserts half (tombstones in the probe
             chains), then is timed on the final directory with and
             without the last pass's update count, with its bytes bound
             from the cells its probes read.  The bucket kernels run at
             the main path's last insert batch and slot count
             (out-of-range ids included); so does their fused insert
             pass, on fresh copies of the size table before that batch
             (twice in a row, so the carried sizes are checked too; its
             first result must equal what the main path computed), and
             the host round trip of one batch's stats is timed in turns
             against the sequence of standalone calls the engine made
             before the fused pass (old, new, new, old); the pass's
             masked route at phase 3c (a)'s last batch (its result equal
             to the path's, then with ids out of range and all-false and
             all-true masks, twice in a row, timed and profiled);
             ``eps_neighbor_counts`` at the
             main path's points (200,000 x 10) and at 20,000 x 10, beside
             a blocked ``torch.matmul`` composite (TF32 off; several
             calls, so no library column), at covertype's width (blobs
             of 100,000 x 54 in 7 clusters, eps 1.0; its mean count is
             printed), and over a sweep of n on the 128-point tile
             edges and d in {1, 3, 4, 16, 20, 54, 64, 96}.
7. profile — device busy share and CUDA runtime calls a batch of five
             more insert batches at the main path's final state
             (torch.profiler); the device allocations and whole-table
             uploads of three more batches' stats passes and hash passes;
             the stats pass and the hash pass (points to slots) inside
             the stream, each against its route before the device mirror,
             in turns (old, new, new, old, 25 batches each); and the host
             microseconds of a hash pass in the stream, under the
             profiler, back to back, back to back after 64 MB of numpy
             work, and through the old pageable route.

The line before the last is one JSON object with a ``kernels`` list (all
five kernels and the ``lsh_hash_resolve`` and fused
``bucket_insert_pass`` routes, the latter's masked route with its
launches on the approx path; ``lsh_hash``'s entry also gives its
launches on the dict path); the last line is ``{"ok": true,
"device": {...}}``.
``--points`` cuts the main, dict and approx streams only (the cut is
printed);
d, k, t, eps and the batch never change.
"""

from __future__ import annotations

import argparse
import gc
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
    # the route of lsh_hash that the main path takes: the keys with their
    # slots in a device mirror of the bucket directory
    "lsh_hash_resolve": ("src/repro_torch/kernels/csrc/lsh_hash.cu",
                         "src/repro/kernels/lsh_hash.py:65"),
    "slot_counts": ("src/repro_torch/kernels/csrc/bucket_ops.cu",
                    "src/repro/kernels/bucket_ops.py:117"),
    "bucket_core_stats": ("src/repro_torch/kernels/csrc/bucket_ops.cu",
                          "src/repro/kernels/bucket_ops.py:63"),
    # the fused route of the two above, which the main path takes
    "bucket_insert_pass": ("src/repro_torch/kernels/csrc/bucket_ops.cu",
                           "src/repro/kernels/bucket_ops.py:117"),
    # its masked two-table route, which the sampled-core path takes
    "bucket_insert_pass_masked": ("src/repro_torch/kernels/csrc/"
                                  "bucket_ops.cu",
                                  "src/repro/kernels/bucket_ops.py:117"),
    "eps_neighbor_counts": ("src/repro_torch/kernels/csrc/pairwise_dist.cu",
                            "src/repro/kernels/pairwise_dist.py:60"),
    # the bf16 route (tensor cores), which the main path takes
    "flash_attention": ("src/repro_torch/kernels/csrc/"
                        "flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:129"),
}
#: the f32 route of flash_attention (CUDA cores), timed as ``ms_f32``
FLASH_F32_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: the kernels the main path (phase 3) runs
MAIN_KERNELS = ("lsh_hash", "slot_counts", "bucket_core_stats")
#: the C entry points the main path launches them through: the
#: standalone entries of the three kernels must not run there
MAIN_ENTRIES = ("lsh_hash_resolve", "bucket_insert_pass")
# the sampled-core tier (phase 3c): phase 3's stream at rate 0.5 (k_s =
# 5), and the tier's own operating point, benchmarks/quality_speed.py's
# FULL workload, at rate 0.1 (k_s = 26), the rate its acceptance block
# reads; phase 3d runs the tiered index over the latter
APPROX_RATE = 0.5
TIER_RATE = 0.1
TIER_POINT = dict(n_stream=36000, window=24000, batch=1000, d=8,
                  n_clusters=8, cluster_std=0.5, k=256, t=10, eps=0.5,
                  data_seed=3)
# Table 2 at its default scale: benchmarks/table2.py run(scale=0.1) on
# blobs, with benchmarks/common.py stream_eval's protocol
BASELINES = ("dynamic", "naive", "emz-static", "emz-fixed")
BASELINE_POINTS = 20_000
# shapes of the eps_neighbor_counts correctness sweep: n on the edges of
# the kernel's 128-point tiles, 8193 (blocks start inside a row of tile
# pairs and cross to the next on 132 SMs), d up to the whole-d limit (64)
# and above it (96: k staged in chunks)
SWEEP_N = (0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 1000, 4097,
           8193, 20_001)
SWEEP_D = (1, 3, 4, 16, 20, 54, 64, 96)
# eps_neighbor_counts at covertype's width (DATASET_SPECS["covertype"] =
# (581012, 54, 7)), cut to 100,000 points so that the plain version's one
# comparison takes seconds; eps puts the mean count at ~10^2
WIDE_POINTS, WIDE_D, WIDE_CLUSTERS, WIDE_EPS = 100_000, 54, 7, 1.0
WIDE_MEAN_COUNT = (10, 10_000)
# LM phase: gemma3-27b at its published widths, depth cut from 62 layers
# to one 5:1 local:global period (62 layers of f32 weights, ~102 GB, do
# not fit one 80 GB card; 6 layers are 5.30 B parameters, 21.2 GB)
LM_ARCH, LM_LAYERS = "gemma3-27b", 6
PREFILL_TOKENS = 4096          # past the local layers' 1024-token window
CHECK_TOKENS = 1100            # f32 prefill vs decode, past the window
SERVE_BATCH, SERVE_KV, SERVE_REQUESTS = 4, 2048, 8
SERVE_PROMPT_MIN, SERVE_PROMPT_MAX, SERVE_NEW_TOKENS = 8, 64, 16
LM_TOL = 2e-4                  # tests/test_arch_smoke.py decode vs prefill
FLASH_F32_TOL = 2e-5           # tests/test_kernels.py flash vs ref, f32
FLASH_BF16_TOL = 2.0 ** -7     # one bf16 ulp, relative
BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
F32_CORE_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
# (b, hq, hkv, sq, skv, dh, causal, window) of the flash_attention sweep:
# tests/test_kernels.py's cases, decode rows (sq = 1, q_offset = skv - 1),
# head_dim 16 / 36 (padded to 40 on the bf16 route) / 96 / 128 / 256,
# ragged lengths, the model's widths
FLASH_SWEEP = (
    (1, 2, 2, 64, 64, 32, True, None), (2, 4, 2, 128, 128, 64, True, None),
    (1, 4, 1, 96, 96, 32, True, None), (1, 2, 2, 64, 64, 32, True, 16),
    (2, 2, 2, 1, 128, 32, True, None), (1, 2, 2, 64, 64, 32, False, None),
    (2, 8, 2, 1, 512, 64, True, None), (1, 4, 2, 100, 100, 16, True, 32),
    (1, 4, 2, 70, 70, 96, True, None), (1, 4, 2, 300, 300, 128, True, 100),
    (2, 4, 2, 33, 161, 128, True, 64), (1, 2, 1, 200, 200, 256, True, None),
    (1, 32, 16, 1, 4096, 128, True, 1024),
    (1, 32, 16, 1100, 1100, 128, True, 1024),
    (1, 4, 2, 77, 77, 36, True, None),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """``flash_attention_sm90_kernel<128>`` from an Itanium-mangled
    kernel name, where each identifier follows its length in digits."""
    import re

    end = mangled.find("_kernel") + len("_kernel")
    if end < len("_kernel"):
        return mangled
    for start in range(end - len("_kernel"), 0, -1):
        n = str(end - start)
        if mangled[start - len(n):start] == n and not \
                mangled[start].isdigit():
            t = re.match(r"IL([ib])(\d+)E", mangled[end:])
            if not t:
                return mangled[start:end]
            arg = (t.group(2) if t.group(1) == "i"
                   else ("false", "true")[int(t.group(2))])
            return f"{mangled[start:end]}<{arg}>"
    return mangled


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of every kernel from ``-Xptxas -v``."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def hgmma_counts(sass: str) -> dict:
    """``HGMMA`` (wgmma) instructions per kernel in ``cuobjdump -sass``
    output."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = _kernel_name(line.split("Function :")[1].strip())
            out[cur] = 0
        elif cur and "HGMMA" in line:
            out[cur] += 1
    return out


def build_report() -> dict:
    """The built library's ptxas registers / spills per kernel and the
    HGMMA count of each bf16 flash kernel; raises when the bf16 route
    holds no HGMMA or an ``eps_neighbor_counts`` kernel spills."""
    from repro_torch.kernels import _build

    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass", str(_build.library_path())],
        capture_output=True, text=True, timeout=300, check=True).stdout
    hgmma = {k: n for k, n in hgmma_counts(sass).items()
             if "flash_attention_sm90" in k}
    if not hgmma or min(hgmma.values()) == 0:
        raise AssertionError(f"no HGMMA in the bf16 flash kernel's SASS: "
                             f"{hgmma}")
    ptxas = ptxas_report(_build.build_log())
    for name, count in (("eps_neighbor_counts", 3), ("lsh_hash_resolve", 1)):
        found = {k: v for k, v in ptxas.items() if name in k}
        if len(found) != count or any(
                v.get("spill_stores", 1) or v.get("spill_loads", 1)
                for v in found.values()):
            raise AssertionError(f"{name} kernels missing or spilling: "
                                 f"{found}")
    eps = {k: v for k, v in ptxas.items() if "eps_neighbor_counts" in k}
    return {"ptxas": ptxas, "hgmma": hgmma, "eps_ptxas": eps}


# ---------------------------------------------------------------------- #
# main path
# ---------------------------------------------------------------------- #
def dir_cells(host_dir):
    """A host bucket directory as (m, 4) int32 cells ``[key a, key b,
    table, slot]``, the updates that load it into an empty table."""
    from repro_torch.core.soa import directory_cells

    return directory_cells((i, k, s) for i, t in enumerate(host_dir)
                           for k, s in t.items())


def label_array(labels):
    """A ``labels()`` dict as a (2, n) int64 array [ids; labels], sorted
    by id: two dicts are equal iff their arrays are."""
    import numpy as np

    ids = np.fromiter(labels.keys(), np.int64, len(labels))
    lab = np.fromiter(labels.values(), np.int64, len(labels))
    order = np.argsort(ids, kind="stable")
    return np.stack([ids[order], lab[order]])


def delta_array(deltas):
    """Sorted ``(idx, old, new)`` deltas as an (m, 3) int64 array, None
    as -1 (handles are ids, never negative)."""
    import numpy as np

    return np.array([[-1 if v is None else v for v in row]
                     for row in deltas], np.int64).reshape(-1, 3)


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
    # launches, downloads) and the host lookup of the hash pass's misses
    # — the device-path share of the wall time
    eng = dev.engine
    pass_s = {"hash": 0.0, "resolve": 0.0, "stats": 0.0}
    misses = []  # slots allocated a batch: the misses the host resolved
    seen = {}

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                pass_s[key] += time.perf_counter() - t0
        return run

    def resolve(keys32, hits=None):
        # the hits as the pass returned them (the lookup fills the misses)
        seen["keys"], seen["hits"] = keys32, hits.copy()
        before = eng._n_slots - len(eng._free_slots)
        slots = resolve_inner(keys32, hits)
        misses.append(eng._n_slots - len(eng._free_slots) - before)
        return slots

    resolve_inner = eng._resolve_slots
    eng._hash_batch = timed(eng._hash_batch, "hash")
    eng._resolve_slots = timed(resolve, "resolve")
    eng._batch_stats = timed(eng._batch_stats, "stats")

    # the host engine's results, which the dict phase is held against:
    # labels() at every 10th insert batch and after the inserts and the
    # deletes, each batch's sorted deltas, the victims
    kept = {"labels": {}, "insert_deltas": [], "delete_deltas": []}
    ops.reset_launch_counts()
    ins_s = del_s = query_s = 0.0
    n_deltas = 0
    t_path = time.perf_counter()
    last = None
    n_batches = (n_points + BATCH - 1) // BATCH
    for b in range(n_batches):
        Xb = X[b * BATCH:(b + 1) * BATCH]
        if b == n_batches - 1:  # the directory the last batch probes
            dir_before = dir_cells(eng._dir)
        t0 = time.perf_counter()
        ids = dev.insert_batch(Xb)
        deltas = dev.drain_deltas()
        ins_s += time.perf_counter() - t0
        if host.insert_batch(Xb) != ids:
            raise AssertionError(f"batch {b}: assigned ids differ")
        host_deltas = sorted(host.drain_deltas())
        if sorted(deltas) != host_deltas:
            raise AssertionError(f"batch {b}: insert deltas differ")
        kept["insert_deltas"].append(delta_array(host_deltas))
        n_deltas += len(deltas)
        sample = rng.choice(ids, size=min(32, len(ids)), replace=False)
        t0 = time.perf_counter()
        got = [dev.label(int(i)) for i in sample]
        full = dev.labels() if b % 10 == 9 else None
        query_s += time.perf_counter() - t0
        if got != [host.label(int(i)) for i in sample]:
            raise AssertionError(f"batch {b}: sampled labels differ")
        if full is not None:
            host_full = host.labels()
            if full != host_full:
                raise AssertionError(f"batch {b}: labels() differ")
            kept["labels"][b] = label_array(host_full)
        if b == n_batches - 1:
            rows = [eng._row[i] for i in ids]
            ns = eng._n_slots
            slots = eng._slots[rows].copy()
            sizes = eng._bsize[:ns].copy()
            last = {"x": np.asarray(Xb, np.float32), "slots": slots,
                    "n_slots": ns, "sizes": sizes,
                    # the table the batch's stats pass started from, and
                    # the support it gave the batch
                    "sizes_before": sizes - np.bincount(
                        slots.ravel(), minlength=ns).astype(np.int32),
                    "support": eng._support[rows].copy(),
                    # the hash pass's keys and hits of the batch, the
                    # directory before and after it, the mirror's size
                    "keys": seen["keys"], "hits": seen["hits"],
                    "dir_before": dir_before,
                    "dir_after": dir_cells(eng._dir),
                    "dir_cap": eng._hpass.cap,
                    "n_updates": eng._hpass.n_updates,
                    "eta": eng.lsh.eta.astype(np.float32),
                    "mixers": eng.lsh.mixers.copy(),
                    "inv_cell": eng.lsh.inv_cell}
    size_uploads_ins = eng._dpass.n_size_uploads
    hp = eng._hpass
    dir_ins = {"passes": hp.n_passes, "uploads": hp.n_dir_uploads,
               "growths": hp.n_dir_growths, "cap": hp.cap}
    hp.check(eng._dir)  # the mirror holds the directory
    labels_ins = dev.labels()
    if labels_ins != host.labels():
        raise AssertionError("labels() differ after the inserts")
    kept["labels_after_inserts"] = label_array(labels_ins)
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
        host_deltas = sorted(host.drain_deltas())
        if sorted(deltas) != host_deltas:
            raise AssertionError(f"delete batch {b // BATCH}: deltas differ")
        kept["delete_deltas"].append(delta_array(host_deltas))
        n_deltas += len(deltas)
    labels_del = dev.labels()
    if labels_del != host.labels():
        raise AssertionError("labels() differ after the deletes")
    kept["labels_after_deletes"] = label_array(labels_del)
    kept["victims"] = victims
    live = np.array(sorted(labels_del))
    ari_del = adjusted_rand_index(
        y[live], np.array([labels_del[int(i)] for i in live]))

    snap = dev.snapshot()
    rest = restore_index(snap, device=device)
    if rest.labels() != labels_del:
        raise AssertionError("labels differ after snapshot + restore")
    wall = time.perf_counter() - t_path
    hash_s = pass_s["hash"] + pass_s["resolve"]
    launches = ops.launch_counts()
    entries = ops.entry_launch_counts()
    last["restored"] = rest
    last["host_stream"] = kept
    if eng._dpass.n_passes != n_batches or size_uploads_ins:
        raise AssertionError(f"{eng._dpass.n_passes} stats passes and "
                             f"{size_uploads_ins} size-table uploads in "
                             f"{n_batches} insert batches")
    if dir_ins["passes"] != n_batches or \
            dir_ins["uploads"] != dir_ins["growths"]:
        raise AssertionError(f"{dir_ins['passes']} hash passes and "
                             f"{dir_ins['uploads']} directory uploads for "
                             f"{dir_ins['growths']} growths in {n_batches} "
                             f"insert batches")
    if device != "cpu":
        missing = [k for k in MAIN_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main "
                                 f"path: {missing}")
        want = {"lsh_hash_resolve": n_batches, "lsh_hash": 0,
                "bucket_insert_pass": n_batches, "slot_counts": 0,
                "bucket_core_stats": 0}
        got = {k: entries[k] for k in want}
        if got != want:
            raise AssertionError(f"kernel entries on the main path: "
                                 f"{got}, expected {want}")
    metrics = {
        "points": n_points, "cut": n_points != FULL_POINTS,
        "d": D, "k": K, "t": T, "eps": EPS, "batch": BATCH,
        "deleted": len(victims), "deltas": n_deltas,
        "insert_pts_per_s": n_points / ins_s,
        "delete_pts_per_s": len(victims) / del_s if del_s else None,
        "insert_s": ins_s, "delete_s": del_s, "query_s": query_s,
        "main_path_wall_s": wall,
        # the hash pass from points to slots: the device pass, then the
        # host's allocation of the misses (resolver_s)
        "device_pass_s": hash_s + pass_s["stats"],
        "device_pass_share_of_insert": (hash_s + pass_s["stats"]) / ins_s,
        "hash_pass_s": hash_s, "resolver_s": pass_s["resolve"],
        "hash_pass_ms_per_batch": hash_s / n_batches * 1e3,
        "resolver_ms_per_batch": pass_s["resolve"] / n_batches * 1e3,
        "misses_per_batch": {
            "mean": float(np.mean(misses)),
            "median": float(np.median(misses)),
            "from_batch_5_mean": float(np.mean(misses[5:] or [0])),
            "at": {str(i): misses[i] for i in (0, 1, 5, 20, 100, 199)
                   if i < len(misses)}},
        "misses": int(np.sum(misses)),
        "dir_uploads_during_inserts": dir_ins["uploads"],
        "dir_growths": dir_ins["growths"], "dir_cap": dir_ins["cap"],
        "hash_passes": dir_ins["passes"],
        "stats_pass_s": pass_s["stats"],
        "stats_pass_ms_per_batch": pass_s["stats"] / n_batches * 1e3,
        "stats_pass_share_of_insert": pass_s["stats"] / ins_s,
        "stats_passes": eng._dpass.n_passes,
        "size_uploads_during_inserts": size_uploads_ins,
        "n_slots": last["n_slots"], "ari_after_inserts": ari_ins,
        "ari_after_deletes": ari_del, "launches": launches,
        "entry_launches": entries,
        "labels_equal_host_soa": True, "deltas_equal_host_soa": True,
        "restore_labels_equal": True,
    }
    return metrics, last


# ---------------------------------------------------------------------- #
# dict path: the paper's Euler-tour engine with one hash call a batch
# ---------------------------------------------------------------------- #
def run_dict_path(n_points: int, device: str, kept: dict):
    """Drive ``batched-device`` (on ``device``) through phase 3's stream
    and hold it against what the host ``soa`` engine gave there
    (``kept``); returns (metrics, the last batch's points and keys)."""
    import numpy as np
    import torch

    from repro_torch.api import ClusterConfig, build_index, restore_index
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.data import DATASET_SPECS, blobs
    from repro_torch.kernels import ops

    _n, d, n_clusters = DATASET_SPECS["blobs"]
    X, y = blobs(n=n_points, d=d, n_clusters=n_clusters, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    cfg = ClusterConfig(d=D, k=K, t=T, eps=EPS, seed=SEED,
                        backend="batched-device")
    index = build_index(cfg, device=device)
    index.drain_deltas()
    eng = index.engine
    if not eng.use_device or eng.device.type != torch.device(device).type:
        raise AssertionError(f"batched-device built on {eng.device}, "
                             f"use_device={eng.use_device}")

    # host clock around the hash call (upload, launch, download); the
    # batch's points and keys are kept for the check against the plain
    # version, made outside the timed insert; and around the whole
    # keying of a batch (the hash call and the keys' bytes)
    hash_s = [0.0, 0.0]
    seen = {}
    device_hash, keys_of_batch = eng._device_hash, eng._keys_of_batch

    def timed_hash(Xb):
        t0 = time.perf_counter()
        keys = device_hash(Xb)
        hash_s[0] += time.perf_counter() - t0
        seen["x"], seen["keys"] = Xb, keys
        return keys

    def timed_keys(Xb):
        t0 = time.perf_counter()
        try:
            return keys_of_batch(Xb)
        finally:
            hash_s[1] += time.perf_counter() - t0

    eng._device_hash = timed_hash
    eng._keys_of_batch = timed_keys

    def plain_keys(x32):
        x = torch.from_numpy(x32).to(device)
        return ops.lsh_hash(x, eng._eta_dev, eng._mix_dev,
                            inv_cell=eng.lsh.inv_cell,
                            impl="ref").cpu().numpy()

    ops.reset_launch_counts()
    ins_s = del_s = query_s = labels_s = 0.0
    n_deltas = n_compared = 0
    t_path = time.perf_counter()
    n_batches = (n_points + BATCH - 1) // BATCH
    for b in range(n_batches):
        Xb = X[b * BATCH:(b + 1) * BATCH]
        t0 = time.perf_counter()
        ids = index.insert_batch(Xb)
        deltas = index.drain_deltas()
        ins_s += time.perf_counter() - t0
        if ids != list(range(b * BATCH, b * BATCH + len(Xb))):
            raise AssertionError(f"dict batch {b}: assigned ids differ")
        if not np.array_equal(delta_array(sorted(deltas)),
                              kept["insert_deltas"][b]):
            raise AssertionError(f"dict batch {b}: insert deltas differ "
                                 "from the host soa engine's")
        if not np.array_equal(seen["x"], np.asarray(Xb, np.float32)) or \
                not np.array_equal(seen["keys"], plain_keys(seen["x"])):
            raise AssertionError(f"dict batch {b}: lsh_hash keys differ "
                                 "from its plain version")
        n_deltas += len(deltas)
        sample = [int(i) for i in rng.choice(ids, size=min(32, len(ids)),
                                             replace=False)]
        t0 = time.perf_counter()
        got = [index.label(i) for i in sample]
        query_s += time.perf_counter() - t0
        if b % 10 == 9:
            t0 = time.perf_counter()
            full = index.labels()
            dt = time.perf_counter() - t0
            query_s += dt
            labels_s += dt
            if not np.array_equal(label_array(full), kept["labels"][b]):
                raise AssertionError(f"dict batch {b}: labels() differ "
                                     "from the host soa engine's")
            n_compared += 1
            # the sampled roots partition the sample as labels() does
            lab = [full[i] for i in sample]
            for i in range(len(sample)):
                for j in range(i):
                    if lab[i] != -1 and lab[j] != -1 and \
                            (got[i] == got[j]) != (lab[i] == lab[j]):
                        raise AssertionError(
                            f"dict batch {b}: label() of {sample[i]}, "
                            f"{sample[j]} disagrees with labels()")
    launches = ops.launch_counts()
    entries = ops.entry_launch_counts()
    t0 = time.perf_counter()
    labels_ins = index.labels()
    labels_s += time.perf_counter() - t0
    if not np.array_equal(label_array(labels_ins),
                          kept["labels_after_inserts"]):
        raise AssertionError("dict: labels() differ from the host soa "
                             "engine's after the inserts")
    ari_ins = adjusted_rand_index(
        y, np.array([labels_ins[i] for i in range(n_points)]))
    stats_ins = index.stats()

    victims = kept["victims"]
    for n, b in enumerate(range(0, len(victims), BATCH)):
        vb = [int(i) for i in victims[b:b + BATCH]]
        t0 = time.perf_counter()
        index.delete_batch(vb)
        deltas = index.drain_deltas()
        del_s += time.perf_counter() - t0
        if not np.array_equal(delta_array(sorted(deltas)),
                              kept["delete_deltas"][n]):
            raise AssertionError(f"dict delete batch {n}: deltas differ "
                                 "from the host soa engine's")
        n_deltas += len(deltas)
    t0 = time.perf_counter()
    labels_del = index.labels()
    labels_s += time.perf_counter() - t0
    if not np.array_equal(label_array(labels_del),
                          kept["labels_after_deletes"]):
        raise AssertionError("dict: labels() differ from the host soa "
                             "engine's after the deletes")
    live = np.array(sorted(labels_del))
    ari_del = adjusted_rand_index(
        y[live], np.array([labels_del[int(i)] for i in live]))
    if ops.launch_counts() != launches:
        raise AssertionError("dict: a kernel launched during the deletes")

    t0 = time.perf_counter()
    rest = restore_index(index.snapshot(), device=device)
    restore_s = time.perf_counter() - t0
    if rest.labels() != labels_del:
        raise AssertionError("dict: labels differ after snapshot + "
                             "restore")
    if sorted(rest.engine.forest._edge) != sorted(eng.forest._edge):
        raise AssertionError("dict: the restored forest differs")
    t0 = time.perf_counter()
    rest.check_invariants()
    invariants_s = time.perf_counter() - t0
    wall = time.perf_counter() - t_path

    if device != "cpu":
        # the standalone lsh_hash entry once per insert batch, nothing else
        want = {"lsh_hash": n_batches}
        got = {k: v for k, v in entries.items() if v}
        if got != want or {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"kernel entries on the dict path: {got}, "
                                 f"expected {want}")
    metrics = {
        "backend": "batched-device", "points": n_points,
        "cut": n_points != FULL_POINTS, "d": D, "k": K, "t": T, "eps": EPS,
        "batch": BATCH, "deleted": len(victims), "deltas": n_deltas,
        "insert_pts_per_s": n_points / ins_s,
        "delete_pts_per_s": len(victims) / del_s if del_s else None,
        "insert_s": ins_s, "delete_s": del_s, "query_s": query_s,
        "labels_s": labels_s, "restore_s": restore_s,
        "check_invariants_s": invariants_s, "dict_path_wall_s": wall,
        # the hash call (upload + launch + download) against the rest of
        # an insert batch, host clock
        "hash_call_s": hash_s[0],
        "hash_call_ms_per_batch": hash_s[0] / n_batches * 1e3,
        "rest_of_insert_ms_per_batch": (ins_s - hash_s[0]) / n_batches * 1e3,
        "hash_call_share_of_insert": hash_s[0] / ins_s,
        # the hash call with the keys' conversion to bytes
        "keying_ms_per_batch": hash_s[1] / n_batches * 1e3,
        "ari_after_inserts": ari_ins, "ari_after_deletes": ari_del,
        "stats_after_inserts": stats_ins, "stats": index.stats(),
        "labels_compared": n_compared + 2, "launches": launches,
        "entry_launches": entries, "keys_equal_plain": True,
        "labels_equal_host_soa": True, "deltas_equal_host_soa": True,
        "restore_labels_equal": True, "restored_forest_equal": True,
    }
    last = {"x": np.asarray(seen["x"], np.float32), "keys": seen["keys"],
            "eta": eng.lsh.eta.astype(np.float32),
            "mixers": eng.lsh.mixers.copy(), "inv_cell": eng.lsh.inv_cell}
    return metrics, last


def time_dict_hash(last, card: str) -> dict:
    """The ``lsh_hash`` kernel at the dict path's last batch (B = 1000):
    bit-exact against its plain version, per call with CUDA events beside
    the plain version, and its bytes bound as phase 6 computes it for
    row 1.  No profiler here: phase 6 gives the kernel's device time at
    this shape, and the LM phase's profiler sessions come first, as
    before this phase existed."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    x = torch.from_numpy(last["x"]).to(dev)
    eta = torch.from_numpy(last["eta"]).to(dev)
    mixers = torch.from_numpy(np.ascontiguousarray(last["mixers"])).to(dev)
    inv = last["inv_cell"]
    got = ops.lsh_hash(x, eta, mixers, inv_cell=inv)
    err = max_abs_err(got, ops.lsh_hash(x, eta, mixers, inv_cell=inv,
                                        impl="ref"))
    if err or not np.array_equal(got.cpu().numpy(), last["keys"]):
        raise AssertionError("lsh_hash at the dict path's last batch "
                             "differs from its plain version or from the "
                             "path's keys")
    n, t = x.shape[0], eta.shape[0]
    nb = (x.numel() + eta.numel() + mixers.numel() + got.numel()) * 4
    bound_ms, bound_by = bound(nb, n * t * D * 8 + n * t * 20)
    return {
        "n": n, "t": t, "max_abs_err": err,
        "ms": time_ms(lambda: ops.lsh_hash(x, eta, mixers, inv_cell=inv)),
        "plain_ms": time_ms(lambda: ops.lsh_hash(x, eta, mixers,
                                                 inv_cell=inv, impl="ref")),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nb,
        "card": card,
    }


# ---------------------------------------------------------------------- #
# approx path: the sampled-core tier, its stats pass on the masked route
# ---------------------------------------------------------------------- #
def approx_index(cfg, device: str, use_device: bool):
    """The ``approx`` backend's index at ``cfg.sample_rate`` with its
    engine on the device path (``use_device``, on ``device``) or on the
    host: the reference's way to the sampled tier's kernels, which the
    backend's factory keeps on the host."""
    from repro_torch.api import ApproxIndex
    from repro_torch.core.approx import SampledCoreDBSCAN

    return ApproxIndex(cfg, SampledCoreDBSCAN(
        cfg.d, cfg.k, cfg.t, cfg.eps, seed=cfg.seed,
        attach_orphans=cfg.attach_orphans, repair=cfg.repair,
        sample_rate=cfg.sample_rate, approx_seed=cfg.approx_seed,
        use_device=use_device, device=device))


def keep_last_pass(eng) -> dict:
    """Wrap the engine's two-table stats pass so that the last pass's
    inputs (slots, row mask, both host tables before it) and its raw
    support (before the host zeroes the non-sampled rows) are kept in
    the dict returned; a few small host copies a batch."""
    seen = {}
    inner = eng._dpass.run

    def run(slots, host_sizes, k, host_core_sizes=None, row_mask=None):
        before = (host_sizes.copy(), host_core_sizes.copy())
        out = inner(slots, host_sizes, k, host_core_sizes, row_mask)
        seen.update(slots=slots.copy(), mask=row_mask.copy(), k=k,
                    sizes_before=before[0], core_before=before[1],
                    sizes=host_sizes.copy(), core=host_core_sizes.copy(),
                    support=out[-1].copy())
        return out
    eng._dpass.run = run
    return seen


def drive(index, X, batches, *, victims=(), window=None, check=None):
    """Drive ``index`` through inserts of ``batches`` (row ranges of X),
    deltas drained every batch, ``labels()`` every 10th batch; with
    ``window`` the oldest points past it are deleted after each insert,
    else ``victims`` afterwards in batches of BATCH.  ``check(kind, b,
    arg, got)`` sees every result ("insert": arg the row range, got (ids,
    sorted deltas); "delete": arg the ids, got the sorted deltas;
    "labels", "labels_after_inserts", "labels_end": got the dict).  Only
    the index's own calls are timed."""
    check = check or (lambda *a: None)
    ins_s = del_s = labels_s = 0.0
    ids, ptr, n_del = [], 0, 0

    def delete(b, drop):
        nonlocal del_s, n_del
        t0 = time.perf_counter()
        index.delete_batch(drop)
        deltas = index.drain_deltas()
        del_s += time.perf_counter() - t0
        check("delete", b, drop, sorted(deltas))
        n_del += len(drop)

    for b, (lo, hi) in enumerate(batches):
        t0 = time.perf_counter()
        got = index.insert_batch(X[lo:hi])
        deltas = index.drain_deltas()
        ins_s += time.perf_counter() - t0
        check("insert", b, (lo, hi), (got, sorted(deltas)))
        ids += got
        if window is not None and len(ids) - ptr > window:
            drop = ids[ptr:len(ids) - window]
            ptr += len(drop)
            delete(b, drop)
        if b % 10 == 9:
            t0 = time.perf_counter()
            lab = index.labels()
            labels_s += time.perf_counter() - t0
            check("labels", b, None, lab)
    lab_ins = index.labels()
    check("labels_after_inserts", None, None, lab_ins)
    for n, b in enumerate(range(0, len(victims), BATCH)):
        delete(n, [int(i) for i in victims[b:b + BATCH]])
    lab_end = index.labels()
    check("labels_end", None, None, lab_end)
    return {"insert_s": ins_s, "delete_s": del_s, "labels_s": labels_s,
            "inserted": sum(hi - lo for lo, hi in batches),
            "deleted": n_del, "labels_after_inserts": lab_ins,
            "labels": lab_end, "live": ids[ptr:]}


def against_twin(twin, X, tag: str):
    """A ``drive`` check that applies every call to ``twin`` as well and
    holds each result equal to the twin's."""
    def check(kind, b, arg, got):
        if kind == "insert":
            lo, hi = arg
            ok = twin.insert_batch(X[lo:hi]) == got[0] and \
                sorted(twin.drain_deltas()) == got[1]
        elif kind == "delete":
            twin.delete_batch(arg)
            ok = sorted(twin.drain_deltas()) == got
        else:
            ok = twin.labels() == got
        if not ok:
            raise AssertionError(f"{tag}: {kind} {b} differs from the "
                                 "host twin's")
    return check


def against_kept(kept, tag: str):
    """A ``drive`` check against phase 3's host soa results: every
    batch's sorted deltas, ``labels()`` at every 10th batch and at both
    ends."""
    import numpy as np

    def check(kind, b, arg, got):
        if kind == "insert":
            ok = got[0] == list(range(*arg)) and np.array_equal(
                delta_array(got[1]), kept["insert_deltas"][b])
        elif kind == "delete":
            ok = np.array_equal(delta_array(got), kept["delete_deltas"][b])
        else:
            want = {"labels": lambda: kept["labels"][b],
                    "labels_after_inserts":
                        lambda: kept["labels_after_inserts"],
                    "labels_end": lambda: kept["labels_after_deletes"]}
            ok = np.array_equal(label_array(got), want[kind]())
        if not ok:
            raise AssertionError(f"{tag}: {kind} {b} differs from phase "
                                 "3's host soa engine")
    return check


def ari_of(labels: dict, ref) -> float:
    """ARI of a ``labels()`` dict against a reference labelling (a dict,
    or a ``label_array`` [ids; labels]) over the reference's ids."""
    from repro_torch.core.metrics import adjusted_rand_index

    if isinstance(ref, dict):
        ids = sorted(ref)
        want = [ref[i] for i in ids]
    else:
        ids, want = [int(i) for i in ref[0]], [int(v) for v in ref[1]]
    return adjusted_rand_index(want, [labels[i] for i in ids])


def approx_entries_check(entries, n_batches: int, tag: str) -> None:
    """The masked insert pass and the hash-and-resolve pass once per
    insert batch, no other bucket or hash entry."""
    want = {"bucket_insert_pass_masked": n_batches,
            "lsh_hash_resolve": n_batches, "bucket_insert_pass": 0,
            "slot_counts": 0, "bucket_core_stats": 0, "lsh_hash": 0}
    got = {k: entries[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag}: kernel entries {got}, expected "
                             f"{want}")


def tier_stream():
    """The tier's operating point (``benchmarks/quality_speed.py``
    FULL): its points, its insert batches as row ranges."""
    from repro_torch.data import blobs

    p = TIER_POINT
    X, _ = blobs(n=p["n_stream"], d=p["d"], n_clusters=p["n_clusters"],
                 cluster_std=p["cluster_std"], seed=p["data_seed"])
    return X, [(s, min(p["n_stream"], s + p["batch"]))
               for s in range(0, p["n_stream"], p["batch"])]


def run_approx_path(n_points: int, device: str, kept: dict):
    """Phase 3c: the sampled-core engine's device path (a) at rate 0.5
    over phase 3's stream beside its host twin, (b) at rate 1.0 over the
    same stream against phase 3's host soa results, (c) at the tier's
    operating point at rate 0.1 beside its host twin, then the twin and
    the host soa engine timed alone.  Returns (metrics, (a)'s last masked
    pass, (c)'s host soa labels)."""
    from repro_torch.api import ClusterConfig, build_index, restore_index
    from repro_torch.data import DATASET_SPECS, blobs
    from repro_torch.kernels import ops

    _n, d, n_clusters = DATASET_SPECS["blobs"]
    X, _y = blobs(n=n_points, d=d, n_clusters=n_clusters, seed=SEED)
    n_batches = -(-n_points // BATCH)
    batches = [(b * BATCH, min(n_points, (b + 1) * BATCH))
               for b in range(n_batches)]
    victims = kept["victims"]
    if len(kept["insert_deltas"]) != n_batches:
        raise AssertionError(f"approx: phase 3 kept "
                             f"{len(kept['insert_deltas'])} insert batches, "
                             f"this stream has {n_batches}")
    cfg = ClusterConfig(d=D, k=K, t=T, eps=EPS, seed=SEED,
                        backend="approx", sample_rate=APPROX_RATE)
    out = {"points": n_points, "cut": n_points != FULL_POINTS,
           "d": D, "k": K, "t": T, "eps": EPS, "batch": BATCH}

    # (a) rate 0.5: the device engine and its host twin at every batch
    dev = approx_index(cfg, device, True)
    host = approx_index(cfg, "cpu", False)
    eng = dev.engine
    if eng._dpass.core_sizes is None or eng.device.type != device:
        raise AssertionError("3c(a): the device engine holds no mirror of "
                             "the sampled sizes, or runs elsewhere")
    last = keep_last_pass(eng)
    dev.drain_deltas()
    host.drain_deltas()
    ops.reset_launch_counts()
    t_path = time.perf_counter()
    seen_fresh = []

    def twin_check(kind, b, arg, got, inner=against_twin(host, X, "3c(a)")):
        inner(kind, b, arg, got)
        if kind == "labels_after_inserts":
            # both mirrors fresh and equal to the host tables
            seen_fresh.append(eng._dpass.fresh)
            eng._check_device_mirrors()
    run_a = drive(dev, X, batches, victims=victims, check=twin_check)
    launches_a = ops.launch_counts()
    entries_a = ops.entry_launch_counts()
    if seen_fresh != [True]:
        raise AssertionError("3c(a): a mirror went stale in the inserts")
    t0 = time.perf_counter()
    snap = dev.snapshot()
    rest = approx_index(cfg, device, True)
    rest.restore(snap)
    if rest.labels() != run_a["labels"]:
        raise AssertionError("3c(a): labels differ after snapshot + "
                             "restore")
    rest.check_invariants()
    restore_s = time.perf_counter() - t0
    # one more batch into the restored index beside a host restore: the
    # pass uploads both tables once, and their mirrors then hold them
    host_rest = approx_index(cfg, "cpu", False)
    host_rest.restore(snap)
    again = X[victims[:BATCH]]
    if rest.insert_batch(again) != host_rest.insert_batch(again) or \
            rest.labels() != host_rest.labels():
        raise AssertionError("3c(a): the restored index differs from its "
                             "host twin after a batch")
    rest.check_invariants()
    dp = rest.engine._dpass
    if dp.n_size_uploads != 1 or not dp.fresh:
        raise AssertionError("3c(a): the restored tables were not "
                             "uploaded once")
    wall_a = time.perf_counter() - t_path
    if device != "cpu":
        approx_entries_check(entries_a, n_batches, "3c(a)")
    out["a"] = {
        "sample_rate": APPROX_RATE, "core_k": eng.core_k,
        "n_sampled": eng.n_sampled(), "batches": n_batches,
        "insert_pts_per_s": run_a["inserted"] / run_a["insert_s"],
        "delete_pts_per_s": run_a["deleted"] / run_a["delete_s"],
        "insert_s": run_a["insert_s"], "delete_s": run_a["delete_s"],
        "labels_s": run_a["labels_s"], "restore_s": restore_s,
        "wall_s": wall_a,
        "ari_vs_exact_after_inserts": ari_of(
            run_a["labels_after_inserts"], kept["labels_after_inserts"]),
        "ari_vs_exact_after_deletes": ari_of(
            run_a["labels"], kept["labels_after_deletes"]),
        "stats_passes": eng._dpass.n_passes,
        "size_uploads": eng._dpass.n_size_uploads,
        "launches": launches_a, "entry_launches": entries_a,
        "deltas_equal_host": True, "labels_equal_host": True,
        "restore_labels_equal": True, "mirrors_equal_host": True,
    }
    del dev, host, rest, host_rest, snap
    gc.collect()

    # (b) rate 1.0 on the card against phase 3's host soa results
    dev = approx_index(cfg.replace(sample_rate=1.0), device, True)
    dev.drain_deltas()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run_b = drive(dev, X, batches, victims=victims,
                  check=against_kept(kept, "3c(b)"))
    wall_b = time.perf_counter() - t0
    entries_b = ops.entry_launch_counts()
    if device != "cpu":
        approx_entries_check(entries_b, n_batches, "3c(b)")
    out["b"] = {
        "sample_rate": 1.0, "core_k": dev.engine.core_k,
        "insert_pts_per_s": run_b["inserted"] / run_b["insert_s"],
        "delete_pts_per_s": run_b["deleted"] / run_b["delete_s"],
        "wall_s": wall_b, "launches": ops.launch_counts(),
        "entry_launches": entries_b, "labels_equal_phase3_soa": True,
        "deltas_equal_phase3_soa": True,
    }
    del dev, X
    gc.collect()

    # (c) the tier's operating point at rate 0.1: the device engine
    #     beside its host twin, then the twin and the exact engine alone
    p = TIER_POINT
    Xc, cb = tier_stream()
    ccfg = ClusterConfig(d=p["d"], k=p["k"], t=p["t"], eps=p["eps"],
                         seed=0, backend="approx", sample_rate=TIER_RATE)
    dev = approx_index(ccfg, device, True)
    host = approx_index(ccfg, "cpu", False)
    dev.drain_deltas()
    host.drain_deltas()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run_c = drive(dev, Xc, cb, window=p["window"],
                  check=against_twin(host, Xc, "3c(c)"))
    wall_c = time.perf_counter() - t0
    launches_c = ops.launch_counts()
    entries_c = ops.entry_launch_counts()
    rest = restore_index(dev.snapshot())  # the host backend restores it
    if rest.labels() != run_c["labels"]:
        raise AssertionError("3c(c): labels differ after snapshot + "
                             "restore")
    rest.check_invariants()
    if device != "cpu":
        approx_entries_check(entries_c, len(cb), "3c(c)")
    host_t = drive(approx_index(ccfg, "cpu", False), Xc, cb,
                   window=p["window"])
    soa = build_index(ccfg.replace(backend="soa", sample_rate=1.0))
    soa_t = drive(soa, Xc, cb, window=p["window"])

    def rates(r):
        return {"insert_pts_per_s": r["inserted"] / r["insert_s"],
                "delete_pts_per_s": r["deleted"] / r["delete_s"],
                "insert_s": r["insert_s"], "delete_s": r["delete_s"]}
    out["c"] = {
        "workload": dict(p), "sample_rate": TIER_RATE,
        "core_k": dev.engine.core_k, "batches": len(cb),
        "deleted": run_c["deleted"], "device": rates(run_c),
        "host": rates(host_t), "host_soa": rates(soa_t),
        "insert_speedup_device_vs_host_soa":
            soa_t["insert_s"] / run_c["insert_s"],
        "insert_speedup_host_vs_host_soa":
            soa_t["insert_s"] / host_t["insert_s"],
        "ari_final_window_vs_soa": ari_of(run_c["labels"],
                                          soa_t["labels"]),
        "wall_s": wall_c, "launches": launches_c,
        "entry_launches": entries_c, "deltas_equal_host": True,
        "labels_equal_host": True, "restore_labels_equal": True,
    }
    return out, last, soa_t["labels"]


def run_tiered_path(exact_labels: dict):
    """Phase 3d: the tier's operating point through ``backend="tiered"``
    (approx front at rate 0.1, soa back, both on the host, no kernel):
    update and label-serving throughput, then, after the
    ``exact_labels()`` barrier, the divergence ARI, the lag and the
    escalations; the back tier must equal ``exact_labels`` (phase 3c's
    host soa run of the same stream)."""
    from repro_torch.api import ClusterConfig, build_index
    from repro_torch.kernels import ops

    p = TIER_POINT
    Xc, cb = tier_stream()
    cfg = ClusterConfig(d=p["d"], k=p["k"], t=p["t"], eps=p["eps"], seed=0,
                        backend="tiered", sample_rate=TIER_RATE, obs=True)
    idx = build_index(cfg)
    ops.reset_launch_counts()
    try:
        run = drive(idx, Xc, cb, window=p["window"])
        live = run["live"]
        t0 = time.perf_counter()
        served = idx.labels(live)
        label_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exact = idx.exact_labels()
        barrier_s = time.perf_counter() - t0
        m = idx.obs.snapshot()["metrics"]
        stats = idx.stats()
        if exact != exact_labels:
            raise AssertionError("3d: the back tier's labels differ from "
                                 "the host soa engine's")
        if m["tiered.lag"]["value"] != 0:
            raise AssertionError("3d: lag after the barrier")
        idx.check_invariants()
    finally:
        idx.close()
    if idx.verifier.is_alive():
        raise AssertionError("3d: the verifier outlived close()")
    if any(ops.launch_counts().values()):
        raise AssertionError("3d: the tiered index launched a kernel")
    n_ops = run["inserted"] + run["deleted"]
    return {
        "workload": dict(p), "sample_rate": TIER_RATE,
        "update_pts_per_s": n_ops / (run["insert_s"] + run["delete_s"]),
        "insert_pts_per_s": run["inserted"] / run["insert_s"],
        "delete_pts_per_s": run["deleted"] / run["delete_s"],
        "label_pts_per_s": len(live) / label_s, "labels_served": len(live),
        "barrier_s": barrier_s,
        "divergence_ari": m["tiered.divergence_ari"]["value"],
        "lag": m["tiered.lag"]["value"],
        "queue_depth": m["tiered.queue_depth"]["value"],
        "hot_buckets": m["tiered.hot_buckets"]["value"],
        "escalations": stats["escalations"],
        "diff_rounds": stats["diff_rounds"],
        "applied_batches": stats["applied_batches"],
        "served_ari_vs_exact": ari_of(served, exact),
        "back_equal_host_soa": True, "launches": ops.launch_counts(),
    }


# ---------------------------------------------------------------------- #
# baselines path
# ---------------------------------------------------------------------- #
def run_baselines(n_points: int, device: str):
    """Table 2's streaming protocol through the host baselines, then the
    exact eps-ball counts of the final points through ``ops`` on
    ``device``; returns (metrics, the final points as float32)."""
    import numpy as np
    import torch

    from repro_torch.api import ClusterConfig, build_index, restore_index
    from repro_torch.core import naive_dbscan
    from repro_torch.core.metrics import (adjusted_rand_index,
                                          normalized_mutual_info)
    from repro_torch.data import blobs
    from repro_torch.kernels import ops

    X, y = blobs(n=n_points, d=D, n_clusters=10, cluster_std=0.25,
                 seed=SEED)
    cfg = ClusterConfig(d=D, k=K, t=T, eps=EPS, seed=SEED)
    ops.reset_launch_counts()
    out = {"points": n_points, "cut": n_points != BASELINE_POINTS,
           "d": D, "k": K, "t": T, "eps": EPS, "batch": BATCH}
    for backend in BASELINES:
        index = build_index(cfg.replace(backend=backend))
        total = 0.0
        ids = []
        lab = {}
        for b in range(0, n_points, BATCH):
            t0 = time.perf_counter()
            ids.extend(index.insert_batch(X[b:b + BATCH]))
            lab = index.labels(ids)
            total += time.perf_counter() - t0
        got = np.array([lab[i] for i in ids])
        row = {"time_s": total, "ari": adjusted_rand_index(y, got),
               "nmi": normalized_mutual_info(y, got)}
        if backend != "emz-fixed":
            rest = restore_index(index.snapshot())
            if rest.labels() != index.labels():
                raise AssertionError(f"{backend}: labels differ after "
                                     "snapshot + restore")
            row["restore_labels_equal"] = True
        out[backend] = row
        print(f"baselines: {backend:10} n={n_points} time={total:.3f} s "
              f"ARI={row['ari']:.4f} NMI={row['nmi']:.4f}", flush=True)

    # exact eps-ball counts of the final points on the card
    x32 = X.astype(np.float32)
    x = torch.from_numpy(x32).to(device)
    counts = ops.eps_neighbor_counts(x, eps=EPS)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    if device != "cpu" and launches["eps_neighbor_counts"] <= 0:
        raise AssertionError("eps_neighbor_counts never launched on the "
                             "baselines path")
    err = max_abs_err(counts, ops.eps_neighbor_counts(x, eps=EPS,
                                                      impl="ref"))
    if err:
        raise AssertionError(f"eps_neighbor_counts differs from its plain "
                             f"version on the final points by {err}")
    got = counts.cpu().numpy().astype(np.int64)
    host = naive_dbscan.eps_neighbor_counts(X, EPS)
    out.update({
        "launches": launches, "eps_counts_max_abs_err": err,
        "eps_counts_mean": float(got.mean()),
        # f32 with float32(eps^2 + 1e-6) against float64 with eps^2 + 1e-9
        "rows_differing_from_host_f64": int((got != host).sum()),
        "core_flips_at_k": int(((got >= K) != (host >= K)).sum()),
    })
    return out, x32


# ---------------------------------------------------------------------- #
# device time from the profiler (CUPTI)
# ---------------------------------------------------------------------- #
def device_events(fn, runtime: bool = False):
    """Run ``fn`` under torch.profiler; returns its wall seconds and the
    (name, device microseconds) of every device activity it traced and,
    with ``runtime``, the host microseconds spent in each CUDA runtime
    call by name (``cudaStreamSynchronize``, ``cudaMemcpyAsync``, ...)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    if not runtime:
        return wall, evs
    calls = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda"):
            us, n = calls.get(e.name, (0.0, 0))
            calls[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return wall, evs, {k: {"us": us, "calls": n}
                       for k, (us, n) in sorted(calls.items())}


def kernel_device_ms(fns, reps: int = 50):
    """Mean device milliseconds per launch of each kernel in ``fns``
    (name -> call), from the profiler: the mean duration of each device
    function whose name holds the kernel's, summed over those functions
    (``eps_neighbor_counts`` launches a norm pre-pass and the count
    kernel); None where it traced none."""
    def run():
        for fn in fns.values():
            for _ in range(reps):
                fn()
    _wall, evs = device_events(run)
    out = {}
    for name in fns:
        by_fn = {}
        for ev, us in evs:
            if name in ev:
                by_fn.setdefault(ev, []).append(us)
        out[name] = (sum(sum(v) / len(v) for v in by_fn.values()) / 1e3
                     if by_fn else None)
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
    wall, evs, calls = device_events(run, runtime=True)
    kinds = {"kernels": 0.0, "memcpy": 0.0, "other": 0.0}
    for name, us in evs:
        key = ("kernels" if any(k in name for k in KERNEL_SOURCES)
               else "memcpy" if "emcpy" in name else "other")
        kinds[key] += us / 1e6
    busy = sum(kinds.values())
    return {"batches": batches, "wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "by_kind_s": kinds, "device_events": len(evs),
            "host_runtime_calls": calls}


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


def masked_check(ml, dev, record, card: str) -> None:
    """``bucket_insert_pass``'s masked two-table route at the last insert
    batch of phase 3c (a) (1000 x 10 slots, rate 0.5): its first result
    from the tables before that batch must equal what the path computed;
    then bit-exact against its plain version twice in a row on one pair
    of tables, with the batch's ids and with ~10% of them out of range,
    under the batch's mask, an all-false and an all-true one; timed per
    call (CUDA events) beside the plain version, and on the device
    (profiler).  Bound: the ids, the mask, both tables read once, the
    entries each table's histogram touches written, the packed [sizes |
    sampled sizes | support]; per id a compare and an atomic add, a mask
    test and an atomic add, then a compare, a gather, a compare and an
    add, and two copies per slot."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    slots = torch.from_numpy(ml["slots"]).to(dev)
    mask = torch.from_numpy(ml["mask"]).to(dev)
    sizes = torch.from_numpy(ml["sizes_before"]).to(dev)
    core = torch.from_numpy(ml["core_before"]).to(dev)
    k, ns = ml["k"], len(ml["sizes_before"])
    n, t = slots.shape
    first = ops.bucket_insert_pass(slots, sizes.clone(), k=k,
                                   core_sizes=core.clone(), row_mask=mask)
    want = torch.from_numpy(np.concatenate(
        [ml["sizes"], ml["core"], ml["support"]])).to(dev)
    if max_abs_err(first, want):
        raise AssertionError("bucket_insert_pass (masked) differs from the "
                             "approx path's stats of its last batch")
    rng = np.random.default_rng(8)
    bad = ml["slots"].copy()
    hit = rng.random(bad.shape) < 0.1
    bad[hit] = rng.choice([-3, -1, ns, ns + 5], size=int(hit.sum()))
    bad = torch.from_numpy(bad).to(dev)
    err = 0
    for s in (slots, bad):
        for m in (mask, torch.zeros_like(mask), torch.ones_like(mask)):
            a, b, ca, cb = sizes.clone(), sizes.clone(), core.clone(), \
                core.clone()
            for _call in range(2):  # the second carries the first's tables
                err = max(err, max_abs_err(
                    ops.bucket_insert_pass(s, a, k=k, core_sizes=ca,
                                           row_mask=m),
                    ops.bucket_insert_pass(s, b, k=k, core_sizes=cb,
                                           row_mask=m, impl="ref")),
                    max_abs_err(a, b), max_abs_err(ca, cb))
    # timed on scratch copies, which grow by a batch each call
    sa, sc = sizes.clone(), core.clone()
    buf = torch.empty(2 * ns + n, dtype=torch.int32, device=dev)

    def fused():
        return ops.bucket_insert_pass(slots, sa, k=k, core_sizes=sc,
                                      row_mask=mask, out=buf)
    ms = time_ms(fused)
    plain_ms = time_ms(lambda: ops.bucket_insert_pass(
        slots, sa, k=k, core_sizes=sc, row_mask=mask, out=buf, impl="ref"))
    # one profiler session of this route alone: the unmasked route's
    # kernel name holds the same words
    device_ms = kernel_device_ms({"bucket_insert_pass": fused})[
        "bucket_insert_pass"]
    distinct = int(torch.unique(slots).numel())
    distinct_m = int(torch.unique(slots[mask]).numel())
    nbytes = (slots.numel() + 2 * ns + distinct + distinct_m + 2 * ns
              + n) * 4 + n
    row = record("bucket_insert_pass_masked", err, ms, plain_ms, nbytes,
                 8 * slots.numel() + 2 * ns, None, device_ms=device_ms,
                 replaces_also=KERNEL_SOURCES["bucket_core_stats"][1],
                 route_of=["slot_counts", "bucket_core_stats"],
                 path="approx (phase 3c (a), rate 0.5)", n=n, t=t,
                 n_slots=ns, sampled_rows=int(mask.sum()), k=k)
    print(f"bucket_insert_pass (masked) at {n} x {t}, {ns} slots, "
          f"{int(mask.sum())} sampled rows, k_s {k}: {ms:.5f} ms per call, "
          f"device {device_ms} ms, plain {plain_ms:.4f} ms, bound "
          f"{row['bound_ms']:.7f} ms ({row['bound_by']}, {nbytes} B), "
          f"launches on the approx path {row['launches']}  [{card}]",
          flush=True)


def check_kernels(last, launches, card: str, x_base, build, masked):
    """Bit-exact and timed comparison of each kernel with its plain
    version at its path's shapes (``x_base``: the baselines path's final
    points; ``build``: the build phase's report; ``masked``: the last
    masked insert pass of phase 3c (a)); returns the ``kernels`` list."""
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

    def record(name, err, ms, plain_ms, nbytes, nops, library_ms, **extra):
        src, replaces = KERNEL_SOURCES[name]
        bound_ms, bound_by = bound(nbytes, nops)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": nbytes, "ops": nops,
            "card": card, **extra,
        })
        return out[-1]

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

    # -- lsh_hash_resolve: the main path's hash pass on its last batch
    args, extra = resolve_check(last, x, eta, mixers, build)
    record("lsh_hash_resolve", *args, **extra)

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
    # -- bucket_insert_pass: both of the above in one cooperative launch,
    #    from the table the main path's last batch started from.  Reads
    #    the n*t ids and the size table once, writes the entries the
    #    batch touches and the packed [sizes | support]; per id a compare
    #    and an atomic add, then a compare, a gather, a compare and an
    #    add, and one copy per slot
    pre = torch.from_numpy(last["sizes_before"]).to(dev)
    first = ops.bucket_insert_pass(slots, pre.clone(), k=K)
    want = torch.from_numpy(np.concatenate(
        [last["sizes"], last["support"]])).to(dev)
    if max_abs_err(first, want):
        raise AssertionError("bucket_insert_pass differs from the main "
                             "path's stats of its last batch")
    err = 0
    for s in (slots, bad):
        a, b = pre.clone(), pre.clone()
        for _call in range(2):  # the second call carries the first's sizes
            err = max(err,
                      max_abs_err(ops.bucket_insert_pass(s, a, k=K),
                                  ops.bucket_insert_pass(s, b, k=K,
                                                         impl="ref")),
                      max_abs_err(a, b))
    # timed on scratch copies, which grow by a batch each call
    scratch, buf = pre.clone(), torch.empty(ns + n, dtype=torch.int32,
                                            device=dev)
    record("bucket_insert_pass", err,
           time_ms(lambda: ops.bucket_insert_pass(slots, scratch, k=K,
                                                  out=buf)),
           time_ms(lambda: ops.bucket_insert_pass(slots, scratch, k=K,
                                                  out=buf, impl="ref")),
           (slots.numel() + 2 * ns + distinct + n) * 4,
           6 * slots.numel() + ns, None,
           replaces_also=KERNEL_SOURCES["bucket_core_stats"][1],
           route_of=["slot_counts", "bucket_core_stats"],
           round_trip=stats_round_trips(last, dev))
    dev_ms = kernel_device_ms({
        "lsh_hash": lambda: ops.lsh_hash(x, eta, mixers, inv_cell=inv),
        "slot_counts": lambda: ops.slot_counts(slots, n_slots=ns),
        "bucket_core_stats": lambda: ops.bucket_core_stats(slots, sizes,
                                                           k=K),
        "bucket_insert_pass": lambda: ops.bucket_insert_pass(
            slots, scratch, k=K, out=buf)})
    for k in out:  # lsh_hash_resolve's was timed on its own
        k.setdefault("device_ms", dev_ms.get(k["name"]))
    rt = out[-1]["round_trip"]
    row23 = out[-1]
    masked_check(masked, dev, record, card)
    print(f"bucket_insert_pass at {n} x {t}, {ns} slots: {row23['ms']:.5f}"
          f" ms per call, device {dev_ms['bucket_insert_pass']} ms; one "
          f"batch's stats host to host, standalone sequence vs fused pass "
          f"(old, new, new, old): {rt['old_ms'][0]:.4f}, "
          f"{rt['new_ms'][0]:.4f}, {rt['new_ms'][1]:.4f}, "
          f"{rt['old_ms'][1]:.4f} ms  [{card}]", flush=True)

    # -- eps_neighbor_counts: reads n*d floats, writes n counts; the
    #    operations are counted by eps_ops (each unordered pair once)
    from repro_torch.data import blobs

    X, _ = blobs(n=FULL_POINTS, d=D, n_clusters=10, seed=SEED)
    big = eps_at(torch.from_numpy(X.astype(np.float32)).to(dev), EPS)
    small = eps_at(torch.from_numpy(x_base).to(dev), EPS)
    X, _ = blobs(n=WIDE_POINTS, d=WIDE_D, n_clusters=WIDE_CLUSTERS,
                 seed=SEED)
    wide = eps_at(torch.from_numpy(X.astype(np.float32)).to(dev), WIDE_EPS,
                  composite=False, plain_reps=0)
    del X
    lo, hi = WIDE_MEAN_COUNT
    if not lo <= wide["mean_count"] <= hi:
        raise AssertionError(f"eps_neighbor_counts at {WIDE_POINTS} x "
                             f"{WIDE_D}: mean count {wide['mean_count']} "
                             f"outside [{lo}, {hi}]")
    sweep_err, sweep_cases = eps_sweep(dev)
    extra = {}
    for tag, row in (("_20k", small), ("_100k_54", wide)):
        extra.update({f"{k}{tag}": v for k, v in row.items()
                      if k not in ("bytes", "ops", "ops_all_pairs")})
        extra[f"bound_ms{tag}"] = bound(row["bytes"], row["ops"])[0]
        extra[f"bound_share{tag}"] = extra[f"bound_ms{tag}"] / row["ms"]
    record("eps_neighbor_counts",
           max(big["err"], small["err"], wide["err"], sweep_err),
           big["ms"], big["plain_ms"], big["bytes"], big["ops"], None,
           n=big["n"], d=D, eps=EPS, mean_count=big["mean_count"],
           device_ms=big["device_ms"], composite_ms=big["composite_ms"],
           composite_rows_differing=big["composite_rows_differing"],
           bound_share=bound(big["bytes"], big["ops"])[0] / big["ms"],
           bound_ms_all_pairs=bound(big["bytes"], big["ops_all_pairs"])[0],
           bound_ms_all_pairs_20k=bound(small["bytes"],
                                        small["ops_all_pairs"])[0],
           ptxas=build["eps_ptxas"], sweep_cases=sweep_cases,
           sweep_max_abs_err=sweep_err, **extra)
    print(f"eps_neighbor_counts: composite, not one call (blocked "
          f"torch.matmul f32, TF32 off, compare, sum): "
          f"{big['composite_ms']:.3f} ms at {big['n']} x {D}, "
          f"{small['composite_ms']:.3f} ms at {small['n']} x {D}; kernel "
          f"{big['ms']:.3f} / {small['ms']:.3f} ms  [{card}]", flush=True)
    print(f"eps_neighbor_counts at {WIDE_POINTS} x {WIDE_D} "
          f"({WIDE_CLUSTERS} clusters, eps {WIDE_EPS}): mean count "
          f"{wide['mean_count']:.2f}; kernel {wide['ms']:.3f} ms per call, "
          f"{wide['device_ms']:.3f} ms device, bound "
          f"{extra['bound_ms_100k_54']:.3f} ms (share "
          f"{extra['bound_share_100k_54']:.3f}); plain {wide['plain_ms']:.1f}"
          f" ms  [{card}]", flush=True)
    torch.cuda.synchronize()
    bad_k = [k["name"] for k in out if k["max_abs_err"] != 0]
    if bad_k:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {bad_k}")
    return out


def resolve_check(last, x, eta, mixers, build):
    """``lsh_hash_resolve`` at the main path's last batch, bit-exact
    against its plain version: on the directory that batch probed (its
    keys and hits must equal what the main path got), on the final
    directory (every key a hit, the main path's slots), and through a
    flush that erases ~10% of the final entries, then one that reinserts
    half of them with their freed slots swapped (tombstones in the probe
    chains); then timed on the final directory with no update (CUDA
    events, profiler) and, on the device, with the last pass's update
    count re-applied.  Returns ``record``'s arguments."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref

    dev = x.device
    inv, cap = last["inv_cell"], last["dir_cap"]
    n, t = last["slots"].shape
    m = n * t
    kw = {"inv_cell": inv}

    def table(cells):
        """A table of the main path's capacity loaded with ``cells``
        through the plain version (the kernel's own loads are compared
        below)."""
        tab = torch.full((cap, 4), -1, dtype=torch.int32, device=dev)
        ops.lsh_hash_resolve(x[:0], eta, mixers, directory=tab,
                             updates=torch.from_numpy(cells).to(dev),
                             impl="ref", **kw)
        return tab

    def both(steps):
        """Each step's updates through the kernel and the plain version,
        each on its own empty table; (max abs error, kernel's outputs,
        kernel's table)."""
        tabs = [torch.full((cap, 4), -1, dtype=torch.int32, device=dev)
                for _ in range(2)]
        err, outs = 0, []
        for cells in steps:
            upd = torch.from_numpy(cells).to(dev)
            got = ops.lsh_hash_resolve(x, eta, mixers, directory=tabs[0],
                                       updates=upd.clone(), **kw)
            want = ops.lsh_hash_resolve(x, eta, mixers, directory=tabs[1],
                                        updates=upd.clone(), impl="ref",
                                        **kw)
            err = max(err, max_abs_err(got, want))
            outs.append(got.cpu().numpy())
        if live_cells(tabs[0]) != live_cells(tabs[1]):
            raise AssertionError("lsh_hash_resolve's table differs from its "
                                 "plain version's")
        return err, outs, tabs[0]

    err0, (probed,), _ = both([last["dir_before"]])
    if not (np.array_equal(probed[:2 * m], last["keys"].ravel())
            and np.array_equal(probed[2 * m:], last["hits"].ravel())):
        raise AssertionError("lsh_hash_resolve differs from the main path's "
                             "hash pass of its last batch")
    final = last["dir_after"]
    err1, (full,), _ = both([final])
    if not np.array_equal(full[2 * m:], last["slots"].ravel()):
        raise AssertionError("lsh_hash_resolve on the final directory "
                             "differs from the main path's slots")
    rng = np.random.default_rng(11)
    gone = final[rng.random(len(final)) < 0.1]
    erase, back = gone.copy(), gone[::2].copy()
    erase[:, 3] = -1
    back[:, 3] = np.roll(back[:, 3], 1)
    err2, outs, tab = both([final, erase, back])
    misses = int((outs[1][2 * m:] < 0).sum())

    # timed on the final directory, probes only; the plain version with no
    # update leaves the table as it is
    fin = table(final)
    none = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    buf = torch.empty(3 * m, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: ops.lsh_hash_resolve(x, eta, mixers, directory=fin,
                                              updates=none, out=buf, **kw))
    plain_ms = time_ms(lambda: ops.lsh_hash_resolve(
        x, eta, mixers, directory=fin, updates=none, out=buf, impl="ref",
        **kw), reps=20, warmup=2)
    # the last pass's update count, as upserts of entries the table holds
    # (found live, so the table does not change); the copy that restores
    # the consumed list each call is another device function
    upd = torch.from_numpy(final[:max(1, last["n_updates"])]).to(dev)
    scratch = upd.clone()

    def with_updates():
        scratch.copy_(upd)
        ops.lsh_hash_resolve(x, eta, mixers, directory=fin, updates=scratch,
                             out=buf, **kw)
    dev_ms = kernel_device_ms({"lsh_hash_resolve": lambda: ops.
                               lsh_hash_resolve(x, eta, mixers,
                                                directory=fin, updates=none,
                                                out=buf, **kw)})
    dev_upd = kernel_device_ms({"lsh_hash_resolve": with_updates})
    # bytes: x, eta and mixers read, keys and slots written, each directory
    # cell the probes read once; operations: the keys' (per (point, table,
    # dim) add, mul, floor, convert, 2 mul, 2 add; ~10 per avalanche, two
    # per (point, table)) and ~8 a cell read (4 compares, the slot tests,
    # the next position)
    k32 = torch.from_numpy(last["keys"]).to(dev)
    tabs = torch.arange(t, dtype=torch.int32, device=dev).expand(n, t)
    _found, steps = ref.probe(fin, tabs, k32[..., 0], k32[..., 1])
    reads = steps.reshape(-1)
    home = (k32[..., 0].reshape(-1).to(torch.int64)
            & (cap - 1)).repeat_interleave(reads)
    # the j-th cell of a probe is home + j
    j = torch.arange(int(reads.sum()), device=dev) - (
        torch.cumsum(reads, 0) - reads).repeat_interleave(reads)
    cells = torch.unique((home + j) & (cap - 1)).numel()
    nbytes = (x.numel() + eta.numel() + mixers.numel() + 3 * m
              + 4 * cells) * 4
    nops = m * D * 8 + m * 20 + 8 * int(reads.sum())
    ptx = {k: v for k, v in build["ptxas"].items() if "lsh_hash" in k}
    return (max(err0, err1, err2), ms, plain_ms, nbytes, nops, None), dict(
        route_of=["lsh_hash"], device_ms=dev_ms["lsh_hash_resolve"],
        device_ms_with_updates=dev_upd["lsh_hash_resolve"],
        updates_timed=len(upd), dir_cap=cap, dir_entries=len(final),
        cells_read=cells, probe_reads_mean=float(reads.double().mean()),
        probe_reads_max=int(reads.max()), hits_last_batch=int(
            (last["hits"] >= 0).sum()), misses_after_erase=misses,
        erased=len(gone), reinserted=len(back), ptxas=ptx)


def live_cells(tab) -> dict:
    """A directory table's live cells {(table, key a, key b): slot}."""
    c = tab.cpu().numpy()
    c = c[c[:, 3] >= 0]
    out = {(int(r[2]), int(r[0]), int(r[1])): int(r[3]) for r in c}
    if len(out) != len(c):
        raise AssertionError("a directory table holds a key twice")
    return out


def stats_round_trip_standalone(slots_np, host_sizes, k: int, dev):
    """One insert batch's stats as the engine took them before the fused
    pass, through the standalone ops: upload the slots, histogram,
    download, add on the host, upload the whole size table, gather,
    download.  Updates
    ``host_sizes`` in place; returns (delta, support)."""
    import torch

    from repro_torch.kernels import ops

    dslots = torch.from_numpy(slots_np).to(dev)
    delta = ops.slot_counts(dslots, n_slots=len(host_sizes)).cpu().numpy()
    host_sizes += delta
    sizes = torch.from_numpy(host_sizes).to(dev)
    supp, _core = ops.bucket_core_stats(dslots, sizes, k=k)
    return delta, supp.cpu().numpy()


def stats_round_trips(last, dev, reps: int = 200, warmup: int = 10):
    """Host milliseconds per call of one insert batch's stats at the main
    path's last batch, host array in to host arrays out, in turns on one
    card: the standalone sequence, the engine's ``DeviceInsertPass``, the
    pass again, the standalone sequence again.  The first call of each must give the same
    delta and support; later calls run on a table that grows by a batch
    each call (the work does not depend on the sizes)."""
    import numpy as np

    from repro_torch.core.soa import DeviceInsertPass

    slots = last["slots"]
    dpass = DeviceInsertPass(dev)

    def old(host):
        return stats_round_trip_standalone(slots, host, K, dev)

    def new(host):
        return dpass.run(slots, host, K)

    ref = old(last["sizes_before"].copy())
    dpass.mark_stale()  # its mirror holds zeros, not this table
    got = new(last["sizes_before"].copy())
    for a, b in zip(ref, got):
        if not np.array_equal(a, b):
            raise AssertionError("DeviceInsertPass differs from the "
                                 "standalone sequence at the main path's "
                                 "last batch")
    times = {"old": [], "new": []}
    for name, fn in (("old", old), ("new", new), ("new", new),
                     ("old", old)):
        host = last["sizes_before"].copy()
        if name == "new":
            dpass.mark_stale()
            fn(host)  # the upload of a stale table, outside the timing
        for _ in range(warmup):
            fn(host)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(host)
        times[name].append((time.perf_counter() - t0) / reps * 1e3)
    return {"old_ms": times["old"], "new_ms": times["new"], "reps": reps,
            "order": "old, new, new, old",
            "new_size_uploads": dpass.n_size_uploads}


def stats_ab_in_stream(index, batches: int = 25):
    """The stats pass inside the insert stream, the standalone sequence
    (``stats_round_trip_standalone``) against the engine's
    ``DeviceInsertPass``, in turns on one card (old, new, new, old): each
    turn inserts ``batches`` new batches of 1000 into
    ``index`` (deltas drained) and records per batch the host ms of the
    stats pass and of ``insert_batch`` + ``drain_deltas``.  The old turns
    change the host sizes outside the pass, so the first new batch after
    one uploads them (as the engine would after a delete)."""
    import numpy as np

    from repro_torch.data import blobs

    eng = index.engine
    Xn, _ = blobs(n=4 * batches * BATCH, d=D, n_clusters=10, seed=SEED + 97)
    Xn = np.asarray(Xn)
    stats_ms = []

    def old_stats(slots, flat, ns, smask):
        delta, supp = stats_round_trip_standalone(slots, eng._bsize[:ns],
                                            eng.core_k, eng.device)
        eng._sizes_changed()
        new_sizes = eng._bsize[:ns]
        return new_sizes - delta, new_sizes, eng._bsize[slots], supp

    def timed(fn):
        def run(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                stats_ms.append((time.perf_counter() - t0) * 1e3)
        return run

    out = {"batches_per_turn": batches, "order": "old, new, new, old",
           "old": [], "new": []}
    new_stats = eng._batch_stats
    try:
        for turn, name in enumerate(("old", "new", "new", "old")):
            eng._batch_stats = timed(old_stats if name == "old"
                                     else new_stats)
            stats_ms.clear()
            ins_ms = []
            for b in range(batches):
                j = (turn * batches + b) * BATCH
                t0 = time.perf_counter()
                index.insert_batch(Xn[j:j + BATCH])
                index.drain_deltas()
                ins_ms.append((time.perf_counter() - t0) * 1e3)
            out[name].append({
                "stats_ms_median": float(np.median(stats_ms)),
                "stats_ms_mean": float(np.mean(stats_ms)),
                "insert_ms_median": float(np.median(ins_ms)),
                "insert_ms_mean": float(np.mean(ins_ms))})
    finally:
        del eng._batch_stats
    return out


def pass_allocations(index, which: str = "stats", batches: int = 3):
    """Device allocations and whole-table uploads of each stats pass (or
    hash pass, ``which="hash"``) in ``batches`` more insert batches into
    ``index`` (deltas drained)."""
    import numpy as np
    import torch

    from repro_torch.data import blobs

    eng = index.engine
    Xn, _ = blobs(n=batches * BATCH, d=D, n_clusters=10,
                  seed=SEED + (98 if which == "stats" else 96))
    Xn = np.asarray(Xn)
    allocs, uploads = [], []
    method = "_batch_stats" if which == "stats" else "_hash_batch"
    inner = getattr(eng, method)

    def count():
        return (eng._dpass.n_size_uploads if which == "stats"
                else eng._hpass.n_dir_uploads)

    def counted(*a, **kw):
        a0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        u0 = count()
        try:
            return inner(*a, **kw)
        finally:
            allocs.append(torch.cuda.memory_stats().get(
                "allocation.all.allocated", 0) - a0)
            uploads.append(count() - u0)

    setattr(eng, method, counted)
    try:
        for b in range(batches):
            index.insert_batch(Xn[b * BATCH:(b + 1) * BATCH])
            index.drain_deltas()
    finally:
        delattr(eng, method)
    return {"batches": batches, "device_allocations": allocs,
            "size_uploads" if which == "stats" else "dir_uploads": uploads}


def old_hash_pass(eng):
    """The engine's hash pass before the directory mirror: a pageable
    upload of the points, ``ops.lsh_hash``, a synchronising download of
    the keys, and every lookup left to the host (no hits)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    def run(X):
        X32 = np.ascontiguousarray(X, dtype=np.float32)
        return ops.lsh_hash(torch.from_numpy(X32).to(eng.device),
                            eng._eta_dev, eng._mix_dev,
                            inv_cell=eng.lsh.inv_cell).cpu().numpy(), None
    return run


def hash_ab_in_stream(index, batches: int = 25):
    """The hash pass inside the insert stream, points to slots, the old
    route (``old_hash_pass`` and the host lookup of every key) against the
    engine's (``DeviceHashPass`` and the host lookup of the misses), in
    turns on one card (old, new, new, old): each turn inserts ``batches``
    new batches of 1000 into ``index`` (deltas drained) and records per
    batch the host ms of the hash pass with the lookup and of
    ``insert_batch`` + ``drain_deltas``.  The old turns allocate slots
    through the same seam, so the mirror stays coherent across turns."""
    import numpy as np

    from repro_torch.data import blobs

    eng = index.engine
    Xn, _ = blobs(n=4 * batches * BATCH, d=D, n_clusters=10, seed=SEED + 95)
    Xn = np.asarray(Xn)
    hash_ms = []
    new_hash, resolve = eng._hash_batch, eng._resolve_slots

    def timed_resolve(keys32, hits=None):
        try:
            return resolve(keys32, hits)
        finally:
            hash_ms.append((time.perf_counter() - t_hash[0]) * 1e3)

    t_hash = [0.0]

    def timed(fn):
        def run(X):
            t_hash[0] = time.perf_counter()
            return fn(X)
        return run

    out = {"batches_per_turn": batches, "order": "old, new, new, old",
           "old": [], "new": []}
    eng._resolve_slots = timed_resolve
    try:
        for turn, name in enumerate(("old", "new", "new", "old")):
            eng._hash_batch = timed(old_hash_pass(eng) if name == "old"
                                    else new_hash)
            hash_ms.clear()
            ins_ms = []
            for b in range(batches):
                j = (turn * batches + b) * BATCH
                t0 = time.perf_counter()
                index.insert_batch(Xn[j:j + BATCH])
                index.drain_deltas()
                ins_ms.append((time.perf_counter() - t0) * 1e3)
            out[name].append({
                "hash_ms_median": float(np.median(hash_ms)),
                "hash_ms_mean": float(np.mean(hash_ms)),
                "insert_ms_median": float(np.median(ins_ms)),
                "insert_ms_mean": float(np.mean(ins_ms))})
    finally:
        del eng._hash_batch, eng._resolve_slots
    return out


def runtime_call_study(index, batches: int = 10, reps: int = 50):
    """Why a CUDA runtime call costs more host time inside the insert
    stream than back to back.  Host microseconds of the engine's hash
    pass (``_hash_batch``: upload, launch, download, synchronise) per
    pass: (1) inside the stream, ``batches`` insert batches; (2) the same
    under torch.profiler, with the runtime calls it traced per pass;
    (3) back to back on one batch; (4) back to back with ~64 MB of numpy
    work between passes (cold CPU caches, as after an insert batch's host
    work); (5) the old route's pass (pageable copies) back to back; and
    the profiler's runtime calls per pass back to back; then the host
    microseconds of one runtime call alone (a synchronise of the idle
    stream, a 4-byte copy from pinned memory), warm, after the numpy
    work, and under the profiler."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import blobs

    eng = index.engine
    Xn, _ = blobs(n=2 * batches * BATCH, d=D, n_clusters=10,
                  seed=SEED + 94)
    Xn = np.asarray(Xn)
    inner = eng._hash_batch
    pass_us = []

    def timed(X):
        t0 = time.perf_counter()
        try:
            return inner(X)
        finally:
            pass_us.append((time.perf_counter() - t0) * 1e6)

    def stream(lo):
        pass_us.clear()
        for b in range(lo, lo + batches):
            index.insert_batch(Xn[b * BATCH:(b + 1) * BATCH])
            index.drain_deltas()
        return float(np.median(pass_us))

    def runtime_calls(prof):
        calls = [e for e in prof.events()
                 if e.device_type == DeviceType.CPU
                 and e.name.startswith("cuda")]
        return len(calls), sum(e.time_range.elapsed_us() for e in calls)

    out = {"batches": batches, "reps": reps}
    eng._hash_batch = timed
    try:
        out["stream_us"] = stream(0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out["stream_profiled_us"] = stream(batches)
        n_calls, call_us = runtime_calls(prof)
    finally:
        del eng._hash_batch
    out["stream_profiled_calls_per_batch"] = n_calls / batches
    out["stream_profiled_us_per_call"] = call_us / max(n_calls, 1)
    X = Xn[:BATCH]
    hp = eng._hpass
    junk = np.zeros(8 << 20)  # 64 MB

    def per_pass(fn, flush=False):
        fn()
        times = []
        for _ in range(reps):
            if flush:
                np.add(junk, 1.0, out=junk)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return float(np.median(times))

    new = lambda: hp.run(X, eng._dir)  # noqa: E731
    old = lambda: old_hash_pass(eng)(X)  # noqa: E731
    out["back_to_back_us"] = per_pass(new)
    out["back_to_back_cold_us"] = per_pass(new, flush=True)
    out["old_back_to_back_us"] = per_pass(old)
    out["old_back_to_back_cold_us"] = per_pass(old, flush=True)
    for name, fn in (("new", new), ("old", old)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        n_calls, call_us = runtime_calls(prof)
        out[f"{name}_calls_per_pass"] = n_calls / reps
        out[f"{name}_back_to_back_profiled_us_per_call"] = \
            call_us / max(n_calls, 1)
    src = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    dst = torch.zeros(1, dtype=torch.int32, device=eng.device)
    stream = torch.cuda.current_stream(eng.device)
    for name, fn in (("sync", stream.synchronize),
                     ("copy", lambda: dst.copy_(src, non_blocking=True))):
        out[f"{name}_call_us"] = per_pass(fn)
        out[f"{name}_call_cold_us"] = per_pass(fn, flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            out[f"{name}_call_profiled_us"] = per_pass(fn)
        stream.synchronize()
    return out


def bound(nbytes: int, nops: int):
    """(least milliseconds the card could take, what bounds it): bytes
    over the memory rate against operations over the scalar rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def eps_at(xs, eps: float, *, composite: bool = True, plain_reps: int = 2):
    """``eps_neighbor_counts`` on the points ``xs`` (on the card) against
    its plain version (max abs error), timed: per call (CUDA events),
    device per call (profiler), the plain version (``plain_reps`` timed
    calls after one; with 0, the one comparison call is timed) and,
    with ``composite``, the blocked matmul composite."""
    import torch

    from repro_torch.kernels import ops

    got = ops.eps_neighbor_counts(xs, eps=eps)
    plain = lambda: ops.eps_neighbor_counts(xs, eps=eps,  # noqa: E731
                                            impl="ref")
    if plain_reps:
        err = max_abs_err(got, plain())
        plain_ms = time_ms(plain, reps=plain_reps, warmup=0)
    else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        end.synchronize()
        err, plain_ms = max_abs_err(got, want), start.elapsed_time(end)
        del want
    n, d = xs.shape
    row = {
        "n": n, "d": d, "eps": eps, "err": err,
        "mean_count": float(got.double().mean()),
        "ms": time_ms(lambda: ops.eps_neighbor_counts(xs, eps=eps),
                      reps=5, warmup=1),
        "plain_ms": plain_ms,
        "device_ms": kernel_device_ms({
            "eps_neighbor_counts":
                lambda: ops.eps_neighbor_counts(xs, eps=eps)},
            reps=3)["eps_neighbor_counts"],
        "bytes": (xs.numel() + n) * 4,
        "ops": eps_ops(n, d),
        "ops_all_pairs": n * n * (2 * d + 4),
    }
    if composite:
        comp = composite_eps_counts(xs, eps)
        row["composite_ms"] = time_ms(lambda: composite_eps_counts(xs, eps),
                                      reps=3, warmup=1)
        row["composite_rows_differing"] = int((comp != got).sum())
    return row


def eps_ops(n: int, d: int) -> int:
    """Least scalar operations of the eps-ball counts of n points in d
    dimensions. In the fixed f32 order the count matrix is symmetric bit
    for bit (the products of dot_ij and dot_ji are the same, taken in the
    same k order, and s_i + s_j rounds as s_j + s_i), so each unordered
    pair, the diagonal included, is evaluated once: d multiplies and d - 1
    adds for the dot, then add, multiply, subtract, compare, and a count
    added to both rows."""
    return n * (n + 1) // 2 * (2 * d + 5)


def composite_eps_counts(x, eps: float):
    """The eps-ball counts from several PyTorch calls (norms, a blocked
    f32 ``torch.matmul`` with TF32 off, compare, sum) — a yardstick only:
    no single library call computes this function, and its f32 order is
    not the kernel's, so boundary rows may differ."""
    import torch

    from repro_torch.kernels.ref import _EPS_BLOCK_BYTES, eps_threshold

    n = x.shape[0]
    thr = eps_threshold(eps)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = (x * x).sum(dim=1)
        out = torch.empty(n, dtype=torch.int32, device=x.device)
        rows = max(1, _EPS_BLOCK_BYTES // (4 * max(n, 1)))
        for r0 in range(0, n, rows):
            r1 = min(r0 + rows, n)
            d2 = s[r0:r1, None] + s[None, :] - 2.0 * (x[r0:r1] @ x.T)
            out[r0:r1] = (d2 <= thr).sum(dim=1, dtype=torch.int32)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def eps_sweep(dev):
    """``eps_neighbor_counts`` against its plain version on tile-ragged
    n and on d in SWEEP_D (d = 96 is staged in chunks of k), with
    duplicated points; returns (max abs error, cases)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    err = cases = 0
    for d in SWEEP_D:
        for n in SWEEP_N:
            rng = np.random.default_rng(n * 100 + d)
            x = (rng.normal(size=(n, d)) * 0.7).astype(np.float32)
            dup = min(3, n - n // 2)
            x[n // 2:n // 2 + dup] = x[:dup]
            eps = 0.35 * float(np.sqrt(d))
            xs = torch.from_numpy(x).to(dev)
            got = ops.eps_neighbor_counts(xs, eps=eps)
            e = max_abs_err(got, ops.eps_neighbor_counts(xs, eps=eps,
                                                         impl="ref"))
            if n and int(got.min()) < 1:
                raise AssertionError(f"eps_neighbor_counts n={n} d={d}: a "
                                     "point does not count itself")
            err, cases = max(err, e), cases + 1
    torch.cuda.synchronize()
    return err, cases


# ---------------------------------------------------------------------- #
# LM path: gemma3-27b at full width through the flash-attention kernel
# ---------------------------------------------------------------------- #
def lm_sizes(device: str) -> dict:
    """The LM phase's sizes: on the card gemma3-27b's published widths
    with depth cut to one 5:1 local:global period; on the CPU (tests) its
    smoke config at the same depth and proportionally short sequences."""
    if device == "cpu":
        return {"smoke": True, "prefill": 80, "check": 48, "serve_kv": 96,
                "prompt": (8, 40), "new": 4, "shape_seq": 80,
                "time_reps": 1}
    return {"smoke": False, "prefill": PREFILL_TOKENS,
            "check": CHECK_TOKENS, "serve_kv": SERVE_KV,
            "prompt": (SERVE_PROMPT_MIN, SERVE_PROMPT_MAX),
            "new": SERVE_NEW_TOKENS, "shape_seq": PREFILL_TOKENS,
            "time_reps": 3}


def lm_config(smoke: bool, dtype: str = "bfloat16"):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    if smoke:
        cfg = cfg.smoke()
    return dataclasses.replace(cfg, n_layers=LM_LAYERS, dtype=dtype)


def _sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def unmasked_pairs(sq: int, skv: int, window, q_offset: int = 0) -> int:
    """(query, key) pairs a causal attention with ``window`` (None = full)
    computes: query i at position i + q_offset sees keys
    [max(0, p - window + 1), min(p, skv - 1)]."""
    total = 0
    for i in range(sq):
        p = i + q_offset
        lo = 0 if window is None else max(0, p - window + 1)
        hi = min(p, skv - 1)
        total += max(0, hi - lo + 1)
    return total


def attention_bound(b, hq, hkv, sq, skv, dh, window, elem_bytes):
    """(bound ms, bound_by, f32-core bound ms, flops, bytes) of one causal
    attention: 4 dh flops per unmasked pair and head (q.k and p.v) over
    the bf16 tensor-core peak, against one read of q, k, v and one write
    of the output over the memory rate."""
    flops = 4 * dh * unmasked_pairs(sq, skv, window) * b * hq
    nbytes = (2 * b * hq * sq * dh + 2 * b * hkv * skv * dh) * elem_bytes
    t_ops = flops / BF16_TC_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops / F32_CORE_FLOPS * 1e3, flops, nbytes)


def _flash_err(got, want, tol: float) -> float:
    """max |got - want| in f32; raises past atol = rtol = ``tol``."""
    import torch

    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        raise AssertionError(f"flash_attention differs from its plain "
                             f"version: max abs err {err} (tol {tol})")
    return err


def flash_check(q, k, v, window, q_offset=0, causal=True):
    """The kernel against its plain version on the same inputs: in f32 at
    2e-5; in bf16 against the plain version of the f32 upcast rounded to
    bf16, within one bf16 ulp (2^-7).  Returns (f32 err, bf16 err)."""
    import torch

    from repro_torch.kernels import ops

    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    q, k, v = q.float(), k.float(), v.float()
    e32 = _flash_err(ops.attention(q, k, v, **kw),
                     ops.attention(q, k, v, impl="ref", **kw), FLASH_F32_TOL)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    want = ops.attention(qb.float(), kb.float(), vb.float(), impl="ref",
                         **kw).to(torch.bfloat16)
    e16 = _flash_err(ops.attention(qb, kb, vb, **kw), want, FLASH_BF16_TOL)
    return e32, e16


def flash_sweep(device: str):
    """The kernel against its plain version over the reference tests'
    cases plus decode rows, head_dim 16 / 96 / 128 / 256 and ragged
    lengths; returns (max f32 err, max bf16 err, cases)."""
    import torch

    e32 = e16 = 0.0
    for b, hq, hkv, sq, skv, dh, causal, window in FLASH_SWEEP:
        g = torch.Generator(device=device).manual_seed(sq * 1000 + dh)
        q = torch.randn((b, hq, sq, dh), generator=g, device=device)
        k = torch.randn((b, hkv, skv, dh), generator=g, device=device)
        v = torch.randn((b, hkv, skv, dh), generator=g, device=device)
        a, c = flash_check(q, k, v, window, causal=causal,
                           q_offset=skv - sq if causal else 0)
        e32, e16 = max(e32, a), max(e16, c)
    return e32, e16, len(FLASH_SWEEP)


def _leaves(tree):
    if isinstance(tree, dict):
        for val in tree.values():
            yield from _leaves(val)
    elif isinstance(tree, list):
        for val in tree:
            yield from _leaves(val)
    else:
        yield tree


def _percentile(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q)) if xs else None


def run_lm_path(device: str):
    """Drive the dense-LM serving path of ``LM_ARCH`` on ``device``:
    prefill through ``forward`` (launch count), the kernel against its
    plain version at the model's shapes and over a sweep, f32 prefill
    against teacher-forced decode, and the serving engine with request
    clustering; returns (metrics, what the timing phase needs)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.obs import make_obs
    from repro_torch.serving import Request, ServingEngine

    sz = lm_sizes(device)
    cfg = lm_config(sz["smoke"])
    on_card = device != "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(SEED)
    _sync(device)
    n_params = sum(t.numel() for t in _leaves(params))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.resolved_head_dim, "window": cfg.window,
           "vocab": cfg.padded_vocab, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "params": n_params,
           "init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(SEED)

    # 1. prefill: the path whose launches count
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, sz["prefill"]))).to(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with torch.inference_mode():
        logits = model.forward(params, {"tokens": toks})
        _sync(device)
        launches = ops.launch_counts()
        tc_launches = ops.entry_launch_counts()["flash_attention_sm90"]
        if on_card and launches["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"flash_attention launched "
                                 f"{launches['flash_attention']} times in "
                                 f"one forward, expected {cfg.n_layers}")
        if on_card and tc_launches != cfg.n_layers:
            raise AssertionError(f"the bf16 prefill took the tensor-core "
                                 f"route {tc_launches} times, expected "
                                 f"{cfg.n_layers}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite")
        if tuple(logits.shape) != (1, sz["prefill"], cfg.padded_vocab):
            raise AssertionError(f"prefill logits {tuple(logits.shape)}")
        del logits
        walls = []
        for _ in range(sz["time_reps"]):
            t0 = time.perf_counter()
            model.forward(params, {"tokens": toks})
            _sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
    out.update({"prefill_tokens": sz["prefill"], "launches": launches,
                "flash_launches_per_forward": launches["flash_attention"],
                "flash_tensor_core_launches_per_forward": tc_launches,
                "prefill_ms": walls, "prefill_logits_finite": True,
                "prefill_tokens_per_s": sz["prefill"] / (min(walls) / 1e3)})
    if on_card:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    print(f"lm: {cfg.name} {cfg.n_layers} layers (depth cut from 62), "
          f"{n_params / 1e9:.3f} B params {cfg.param_dtype}; prefill "
          f"{sz['prefill']} tokens {cfg.dtype}: {min(walls):.2f} ms, "
          f"flash launches {launches['flash_attention']} (tensor-core "
          f"route {tc_launches})", flush=True)

    # 2. the kernel against its plain version at the model's shapes
    s = sz["shape_seq"]
    dh, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn((1, hq, s, dh), generator=g, device=device)
    k = torch.randn((1, hkv, s, dh), generator=g, device=device)
    v = torch.randn((1, hkv, s, dh), generator=g, device=device)
    shapes = {}
    for tag, window in (("window", cfg.window), ("global", None)):
        e32, e16 = flash_check(q, k, v, window)
        shapes[tag] = {"window": window, "err_f32": e32, "err_bf16": e16}
    sw32, sw16, cases = flash_sweep(device)
    out["flash_check"] = {"shape": [1, hq, s, dh], "kv_heads": hkv,
                          **shapes, "sweep_cases": cases,
                          "sweep_err_f32": sw32, "sweep_err_bf16": sw16,
                          "tol_f32": FLASH_F32_TOL,
                          "tol_bf16": FLASH_BF16_TOL}
    print("lm: flash_attention vs plain " + json.dumps(out["flash_check"]),
          flush=True)

    # 3. f32 prefill (kernel) against teacher-forced decode (plain torch)
    cfg32 = lm_config(sz["smoke"], dtype="float32")
    m32 = build_model(cfg32, device=device)
    n = sz["check"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(
        device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        full = m32.forward(params, {"tokens": toks})[0]
        _sync(device)
        f32_launches = ops.entry_launch_counts()["flash_attention"]
        caches = m32.decode_init(1, n)
        dec = torch.empty_like(full)
        t0 = time.perf_counter()
        for t in range(n):
            step, caches = m32.decode_step(params, caches, toks[:, t:t + 1],
                                           t)
            dec[t] = step[0]
        _sync(device)
        dec_s = time.perf_counter() - t0
        err = float((dec - full).abs().max())
        ok = bool(torch.allclose(dec, full, atol=LM_TOL, rtol=LM_TOL))
    del full, dec, caches
    out["prefill_vs_decode"] = {"tokens": n, "window": cfg.window,
                                "max_abs_err": err, "tol": LM_TOL,
                                "flash_launches": f32_launches,
                                "decode_steps_s": dec_s,
                                "decode_ms_per_step_b1_f32": dec_s / n * 1e3}
    print(f"lm: f32 prefill vs teacher-forced decode over {n} tokens: max "
          f"abs err {err:.3e} (tol {LM_TOL})", flush=True)
    if not ok:
        raise AssertionError(f"prefill and decode logits differ by {err}")
    if on_card and f32_launches != cfg.n_layers:
        raise AssertionError(f"f32 forward took flash_attention's f32 "
                             f"route {f32_launches} times")

    # 4. serving with request clustering on the card
    obs = make_obs(True)
    backend = "soa-device"
    eng = ServingEngine(model, params, batch=SERVE_BATCH,
                        kv_len=sz["serve_kv"], cluster_requests=True,
                        cluster_backend=backend, obs=obs)
    centres = rng.normal(size=(2, 8)) * 3
    lo, hi = sz["prompt"]
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(lo, hi + 1)))
               for _ in range(SERVE_REQUESTS)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(
            rid=rid, prompt=prompt, max_new_tokens=sz["new"],
            embedding=centres[rid % 2] + 0.05 * rng.normal(size=8)))
    steps = []
    while eng.queue or any(sl is not None for sl in eng.slots):
        ts = time.perf_counter()
        eng.step()
        steps.append((time.perf_counter() - ts) * 1e6)
    _sync(device)
    wall = time.perf_counter() - t0
    serve_launches = ops.launch_counts()
    done = eng.done
    eng.close()
    gen = sum(len(r.out_tokens) for r in done.values())
    hist = obs.histogram("serving.step_us")
    if sorted(done) != list(range(SERVE_REQUESTS)) or \
            gen != SERVE_REQUESTS * sz["new"]:
        raise AssertionError(f"served {sorted(done)} with {gen} tokens")
    if on_card:
        missing = [kn for kn in MAIN_KERNELS if serve_launches[kn] <= 0]
        if missing:
            raise AssertionError(f"request clustering launched no {missing}")
    out["serving"] = {
        "batch": SERVE_BATCH, "kv_len": sz["serve_kv"],
        "requests": len(done), "generated_tokens": gen,
        "prompt_tokens": sum(len(p) for p in prompts), "wall_s": wall,
        "tokens_per_s": gen / wall, "steps": len(steps),
        "step_us_p50": _percentile(steps, 50),
        "step_us_p99": _percentile(steps, 99),
        "hist_step_us_p50": hist.percentile(50),
        "hist_step_us_p99": hist.percentile(99),
        "clusters": sorted({r.cluster for r in done.values()}),
        "cluster_backend": backend, "launches": serve_launches,
    }
    print("lm: serving " + json.dumps(out["serving"]), flush=True)
    return out, {"model": model, "params": params, "q": q, "k": k, "v": v,
                 "window": cfg.window, "prefill": sz["prefill"],
                 "serve_kv": sz["serve_kv"]}


def sdpa_backend(fn) -> str:
    """The device kernel that took longest in ``fn`` (a PyTorch attention
    call), which names the backend it ran: ``flash`` (pytorch_flash),
    ``efficient`` (fmha_cutlass), ``cudnn`` or the math path's GEMMs."""
    _wall, evs = device_events(fn)
    return max(evs, key=lambda e: e[1])[0][:120] if evs else ""


def time_flash(ctx, launches: int, check: dict, card: str,
               build: dict) -> dict:
    """``flash_attention`` timed at the model's shapes in bf16 (the main
    path's dtype and the tensor-core route), window and global, beside
    its f32 route (``ms_f32``), its plain version, SDPA and the bound;
    returns its row of the ``kernels`` list, per launch averaged over
    one forward (five window layers, one global)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    q32, k32, v32 = ctx["q"], ctx["k"], ctx["v"]
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    window = ctx["window"]
    cases = {}
    for tag, win in (("window", window), ("global", None)):
        kw = {"causal": True, "window": win}
        pos = torch.arange(s, device=q.device)
        mask = (pos[:, None] >= pos[None, :])
        if win is not None:
            mask &= (pos[:, None] - pos[None, :]) < win

        def sdpa(win=win, mask=mask):
            if win is None:
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        got = ops.attention(q, k, v, **kw)
        bound_ms, bound_by, f32_bound_ms, flops, nbytes = attention_bound(
            b, hq, hkv, s, s, dh, win, 2)
        cases[tag] = {
            "window": win,
            "ms": time_ms(lambda: ops.attention(q, k, v, **kw), reps=10,
                          warmup=2),
            "ms_f32": time_ms(lambda: ops.attention(q32, k32, v32, **kw),
                              reps=5, warmup=1),
            "plain_ms": time_ms(lambda: ops.attention(q, k, v, impl="ref",
                                                      **kw),
                                reps=3, warmup=1),
            "library_ms": time_ms(sdpa, reps=10, warmup=2),
            "library_kernel": sdpa_backend(sdpa),
            "library_max_abs_diff": float((sdpa().float()
                                           - got.float()).abs().max()),
            "device_ms": kernel_device_ms(
                {"flash_attention": lambda: ops.attention(q, k, v, **kw)},
                reps=3)["flash_attention"],
            "device_ms_f32": kernel_device_ms(
                {"flash_attention": lambda: ops.attention(q32, k32, v32,
                                                          **kw)},
                reps=2)["flash_attention"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_f32_cores": f32_bound_ms, "flops": flops,
            "bytes": nbytes,
        }
        del got
    # one forward runs the window case on 5 layers and the global on 1
    w = {"window": LM_LAYERS - 1, "global": 1}

    def per_launch(key):
        return sum(w[t] * cases[t][key] for t in w) / LM_LAYERS

    bound_ms = per_launch("bound_ms")
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": KERNEL_SOURCES["flash_attention"][0],
        "source_f32": FLASH_F32_SOURCE,
        "replaces": KERNEL_SOURCES["flash_attention"][1],
        "launches": launches,
        # the bf16 route's error (one ulp: atol = rtol = 2^-7), then the
        # f32 route's (2e-5)
        "max_abs_err": max(check["window"]["err_bf16"],
                           check["global"]["err_bf16"],
                           check["sweep_err_bf16"]),
        "tol": FLASH_BF16_TOL,
        "max_abs_err_f32": max(check["window"]["err_f32"],
                               check["global"]["err_f32"],
                               check["sweep_err_f32"]),
        "tol_f32": FLASH_F32_TOL,
        "ms": per_launch("ms"), "plain_ms": per_launch("plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": cases["global"]["bound_by"],
        "library_ms": per_launch("library_ms"),
        "device_ms": per_launch("device_ms"),
        "ms_f32": per_launch("ms_f32"),
        "device_ms_f32": per_launch("device_ms_f32"),
        "bound_ms_f32_cores": per_launch("bound_ms_f32_cores"),
        "hgmma": build["hgmma"],
        "ptxas": {k: v for k, v in build["ptxas"].items()
                  if "flash_attention" in k},
        "dtype": "bfloat16", "shape": [b, hq, s, dh], "kv_heads": hkv,
        "per_launch": "mean over one forward: 5 window layers, 1 global",
        "cases": cases, "card": card,
    }
    print(f"flash_attention at {[b, hq, s, dh]} bf16 (window {window} / "
          f"global): kernel {cases['window']['ms']:.4f} / "
          f"{cases['global']['ms']:.4f} ms (f32 route "
          f"{cases['window']['ms_f32']:.3f} / "
          f"{cases['global']['ms_f32']:.3f} ms), SDPA "
          f"{cases['window']['library_ms']:.3f} / "
          f"{cases['global']['library_ms']:.3f} ms "
          f"({cases['window']['library_kernel'][:60]} / "
          f"{cases['global']['library_kernel'][:60]}), bound "
          f"{cases['window']['bound_ms']:.4f} / "
          f"{cases['global']['bound_ms']:.4f} ms  [{card}]", flush=True)
    return row


def _top_ops(evs, wall: float, n: int = 12) -> dict:
    by = {}
    for name, us in evs:
        tot, cnt = by.get(name, (0.0, 0))
        by[name] = (tot + us, cnt + 1)
    busy = sum(t for t, _c in by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    flash = sum(t for name, (t, _c) in by.items()
                if "flash_attention" in name)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / wall,
            "flash_share_of_device": flash / busy if busy else 0.0,
            "top": [{"name": name[:90], "ms": t / 1e3, "calls": c,
                     "share": t / busy} for name, (t, c) in top]}


def profile_lm(ctx, device: str) -> dict:
    """Top device operations of one bf16 prefill forward at the phase's
    length and of one fused decode step of the serving batch."""
    import numpy as np
    import torch

    model, params = ctx["model"], ctx["params"]
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, ctx["prefill"]))).to(device)
    caches = model.decode_init(SERVE_BATCH, ctx["serve_kv"])
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (SERVE_BATCH, 1))).to(device)
    pos = torch.arange(SERVE_BATCH, device=device, dtype=torch.int32) * 16
    act = torch.ones(SERVE_BATCH, dtype=torch.bool, device=device)
    with torch.inference_mode():
        model.forward(params, {"tokens": toks})       # warm
        model.decode_step(params, caches, tok, pos, act)
        wall, evs = device_events(
            lambda: model.forward(params, {"tokens": toks}))
        pre = _top_ops(evs, wall)
        wall, evs = device_events(
            lambda: model.decode_step(params, caches, tok, pos, act))
        dec = _top_ops(evs, wall)
    return {"prefill": {"tokens": ctx["prefill"], **pre},
            "decode_step": {"batch": SERVE_BATCH, "kv_len": ctx["serve_kv"],
                            **dec}}


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
    build = build_report()
    print("build: ptxas -v " + json.dumps(build["ptxas"]), flush=True)
    print("build: HGMMA in SASS " + json.dumps(build["hgmma"]), flush=True)
    print("build: eps_neighbor_counts ptxas -v (registers, spill bytes) "
          + json.dumps(build["eps_ptxas"]), flush=True)

    # 3. main path
    if args.points != FULL_POINTS:
        print(f"main: CUT — {args.points} points instead of "
              f"{FULL_POINTS}", flush=True)
    metrics, last = run_main_path(args.points, "cuda")
    metrics["card"] = card
    metrics["build_s"] = build_s
    metrics["build"] = build
    print("main_path " + json.dumps(metrics), flush=True)

    # 3b. dict path: batched-device over the same stream, held against
    #     the host soa engine's results of phase 3
    kept = last.pop("host_stream")
    dict_m, dict_last = run_dict_path(args.points, "cuda", kept)
    dict_m["card"] = card
    dict_m["lsh_hash_at_batch"] = time_dict_hash(dict_last, card)
    kh = dict_m["lsh_hash_at_batch"]
    print(f"dict: batched-device, {args.points} points: insert "
          f"{dict_m['insert_pts_per_s']:.1f} points/s, delete "
          f"{dict_m['delete_pts_per_s']:.1f} points/s, labels() "
          f"{dict_m['labels_s']:.3f} s, ARI {dict_m['ari_after_inserts']:.4f}"
          f" / {dict_m['ari_after_deletes']:.4f}; hash call "
          f"{dict_m['hash_call_ms_per_batch']:.4f} ms of an insert batch's "
          f"{dict_m['hash_call_ms_per_batch'] + dict_m['rest_of_insert_ms_per_batch']:.4f}"
          f" ms; lsh_hash at {kh['n']} x {kh['t']}: {kh['ms']:.5f} ms per "
          f"call, plain {kh['plain_ms']:.4f} ms, bound "
          f"{kh['bound_ms']:.7f} ms  [{card}]", flush=True)
    print("dict_path " + json.dumps(dict_m), flush=True)
    del dict_last
    gc.collect()

    # 3c. approx path: the sampled-core engine's device path (one masked
    #     bucket_insert_pass a batch) against its host twin and phase 3's
    #     host soa results; 3d. the tiered index (host) at the tier's
    #     operating point, its back tier held against 3c's host soa run
    t0 = time.perf_counter()
    approx_m, masked_last, soa_c = run_approx_path(args.points, "cuda", kept)
    approx_m["wall_s"] = time.perf_counter() - t0
    approx_m["card"] = card
    a, b, c = approx_m["a"], approx_m["b"], approx_m["c"]
    print(f"approx: {args.points} points at rate {a['sample_rate']} (k_s "
          f"{a['core_k']}), device path: insert {a['insert_pts_per_s']:.1f}"
          f" points/s, delete {a['delete_pts_per_s']:.1f} points/s, ARI vs "
          f"exact {a['ari_vs_exact_after_inserts']:.4f} / "
          f"{a['ari_vs_exact_after_deletes']:.4f}, masked passes "
          f"{a['entry_launches']['bucket_insert_pass_masked']} in "
          f"{a['batches']} batches; rate 1.0 equal to phase 3's soa "
          f"(insert {b['insert_pts_per_s']:.1f} points/s); operating point "
          f"(k {c['workload']['k']}, rate {c['sample_rate']}, k_s "
          f"{c['core_k']}): insert device / host / host soa "
          f"{c['device']['insert_pts_per_s']:.1f} / "
          f"{c['host']['insert_pts_per_s']:.1f} / "
          f"{c['host_soa']['insert_pts_per_s']:.1f} points/s, delete "
          f"{c['device']['delete_pts_per_s']:.1f} / "
          f"{c['host']['delete_pts_per_s']:.1f} / "
          f"{c['host_soa']['delete_pts_per_s']:.1f} points/s, ARI vs soa "
          f"{c['ari_final_window_vs_soa']:.4f}; phase "
          f"{approx_m['wall_s']:.1f} s  [{card}]", flush=True)
    print("approx_path " + json.dumps(approx_m), flush=True)
    t0 = time.perf_counter()
    tier = run_tiered_path(soa_c)
    tier["wall_s"] = time.perf_counter() - t0
    tier["card"] = card
    print(f"tiered: rate {tier['sample_rate']}: update "
          f"{tier['update_pts_per_s']:.1f} points/s, labels served "
          f"{tier['label_pts_per_s']:.1f} points/s, after the barrier "
          f"divergence ARI {tier['divergence_ari']:.4f}, lag {tier['lag']},"
          f" escalations {tier['escalations']}; back tier equal to host "
          f"soa; phase {tier['wall_s']:.1f} s  [{card}]", flush=True)
    print("tiered_path " + json.dumps(tier), flush=True)
    del kept, soa_c
    gc.collect()

    # 4. baselines path
    base, x_base = run_baselines(BASELINE_POINTS, "cuda")
    base["card"] = card
    print("baselines " + json.dumps(base), flush=True)

    # 5. LM path: gemma3-27b prefill through the flash kernel, the kernel
    #    against its plain version, prefill vs decode, serving; then the
    #    kernel's timing and where a prefill / decode step spends its time
    lm, ctx = run_lm_path("cuda")
    lm["card"] = card
    print("lm_path " + json.dumps(lm), flush=True)
    flash = time_flash(ctx, lm["flash_launches_per_forward"],
                       lm["flash_check"], card, build)
    lm_prof = profile_lm(ctx, "cuda")
    lm_prof["card"] = card
    lm_prof["flash_share_of_prefill_wall"] = (
        flash["launches"] * flash["ms"] / min(lm["prefill_ms"]))
    print("profile_lm " + json.dumps(lm_prof), flush=True)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()

    # 6. kernels, each with the launches of its own path
    launches = dict(metrics["launches"])
    launches["eps_neighbor_counts"] = \
        base["launches"]["eps_neighbor_counts"]
    for entry in MAIN_ENTRIES:
        launches[entry] = metrics["entry_launches"][entry]
    # the masked route's launches on its own path, phase 3c (a)
    launches["bucket_insert_pass_masked"] = \
        approx_m["a"]["entry_launches"]["bucket_insert_pass_masked"]
    kernels = check_kernels(last, launches, card, x_base, build,
                            masked_last) + [flash]
    # lsh_hash's second path: batched-device's standalone entry
    row1 = next(k for k in kernels if k["name"] == "lsh_hash")
    row1.update({
        "batched_device_launches": dict_m["entry_launches"]["lsh_hash"],
        "batched_device_insert_batches": -(-args.points // BATCH),
        "batched_device_ms": kh["ms"],
        "batched_device_plain_ms": kh["plain_ms"]})
    share = sum(k["launches"] * k["ms"] for k in kernels
                if k["name"] in MAIN_ENTRIES) / 1e3 / metrics["insert_s"]
    print(f"main-path kernel time (launches x ms per call) / insert wall "
          f"time: {share:.4f}  [{card}]", flush=True)

    # 7. where the device time goes in a few insert batches at the main
    #    path's final state (the restored index; launches already read)
    window = profile_insert_window(last["restored"])
    window["runtime_calls_per_batch"] = sum(
        c["calls"] for c in window["host_runtime_calls"].values()) / \
        window["batches"]
    window["stats_pass"] = pass_allocations(last["restored"])
    window["hash_pass"] = pass_allocations(last["restored"], "hash")
    window["stats_in_stream"] = stats_ab_in_stream(last["restored"])
    window["hash_in_stream"] = hash_ab_in_stream(last["restored"])
    window["runtime_calls"] = runtime_call_study(last["restored"])
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
