#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--points N]

Phases (1-3, 3b-3e, 4-14), each of which raises on failure (exit code
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
             the paper's blobs set (d=10, 10 clusters; 150,000 of its
             n=200,000 points by default, a cut printed for the script's
             time; ``--points 200000`` runs it whole) with
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
3e. sharded — ``backend="sharded"`` over ``soa-device`` shards on the
             card.  (a) Four shards on a pool of four threads (local
             transport, ``obs=True``) over phase 3's stream (deltas
             drained every batch, 16 sampled ``label()`` calls a batch,
             ``labels()`` every 10th), then ``rebalance(
             propose_rebalance(ix))``, phase 3's victims deleted in
             batches of 1000, snapshot + ``restore_index`` on the card:
             every batch's sorted deltas, the labels at every 10th batch,
             after the rebalance, at both ends and after the restore must
             equal the same config over host ``soa`` shards, with
             ``check_invariants()`` on both; the live ids, noise set and
             cores must equal phase 3's host ``soa`` results, the
             partition's ARI against them and the points outside the best
             bijection are reported; each shard launches
             ``lsh_hash_resolve`` and ``bucket_insert_pass`` once per
             non-empty sub-batch, no standalone entry.  At the last
             insert batch the fullest shard's two passes keep the inputs
             their kernels launched on (points, pending directory
             updates, directory mirror; slots, size table): each kernel
             on copies of them must equal its plain version bit for bit
             and what the shard computed, and is timed beside it.  Prints
             shard sizes around the rebalance, throughput, the
             coordinator's hash pass (span ``coord.route_and_key``)
             against the fan-out (span ``coord.fanout``), a batch,
             ``stats()`` and the top rows of ``python -m repro_torch.obs
             report`` over the written trace; then the first 10 insert
             batches of the stream timed with the fan-out serial
             (``workers=0``) and on the pool, in turns (serial, pool,
             pool, serial).  (b) The same config with
             ``transport="process"``: four workers spawned with
             ``--device cuda`` over the first 15 insert batches, each
             batch's deltas and the labels after them equal to (a)'s host
             run, every worker holding a GPU device file open, a snapshot
             restored on the local transport equal; round trips and
             bytes.  (c) ``transport="tcp"``, two shards of a primary and
             a replica each, at Table 2's scale (blobs 20,000 x 10,
             batches of 1000, 25% deleted): shard 0's primary is killed
             after batch 10 (``benchmarks/serving_mix.py``'s chaos); no
             request may fail, the labels at every 5th batch and at the
             end must equal an in-process host oracle, and after
             ``check_health()`` the lane is back at two members on the
             card with replicas byte-equal to their primaries; the
             ``failover.*`` counters are printed.  Every index is closed
             in a ``finally``; a worker alive after ``close()`` fails.
4. baselines — the paper's Table-2 streaming protocol at half its
             default scale (``benchmarks/table2.py`` at scale 0.1 has
             20,000 points; the cut is printed): blobs n=10,000, d=10,
             10 clusters, k=10, t=10, eps=0.75, batches of 1000
             with ``labels()`` after every batch, through the host
             backends ``dynamic`` (the table's headline row), ``naive``,
             ``emz-static`` and ``emz-fixed``; prints each one's seconds,
             ARI and NMI; snapshot + restore of all but ``emz-fixed``
             must give equal labels.  Then
             the exact eps-ball counts of the final 10,000 points on the
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
             device operations of a prefill and of a decode step.  Then
             the backward kernel (``attention_bwd_sm90``) at the three
             benchmark cells' attention shapes, timed beside its bound
             (five products), ``attention_vjp`` and SDPA's backward, the
             timed call's dq, dk and dv each no worse norm-wise than
             ``attention_vjp``'s against the f32 gradient.
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
             paper's blobs (200,000 x 10) and at phase 4's (10,000 x
             10), beside
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
8. train   — the training path.  (a) Phase 3's stream on ``soa-device``
             to insert batch 100, saved by ``CheckpointManager.
             save_index``, restored onto the card by ``restore_index(
             device="cuda")``; the remaining inserts and phase 3's
             deletes go through the restored index, every batch's deltas
             and ``labels()`` equal to phase 3's host ``soa`` results,
             one ``lsh_hash_resolve`` and one ``bucket_insert_pass`` per
             insert batch.  (b) The trainer's ``CurationFilter`` on
             ``soa-device`` beside a host ``soa`` twin over the trainer's
             stream, keep masks equal every batch.  (c) ``launch.train.
             train`` on granite-20b at its published widths, 4 layers,
             batch 8 x 1,024 tokens, 10 steps: every parameter gets a
             finite nonzero gradient, flash launches 4 x 2 (the remat
             recompute) a step on the tensor-core route and one
             ``attention_bwd_sm90`` launch a layer a step with no
             ``attention_vjp`` backward (as in (d), 10 and 12), step 1's
             loss and gradient norm within their bf16 bound of the same
             step with the plain attention; step ms, tokens/s, peak memory and the
             device's busy share of one more step (profiler); the kernel
             against its plain version at the trainer's attention shape.
             (d) ``launch.train.main`` at the ``100m`` preset: 30 steps at
             lr 1e-2 with a checkpoint every 10, then ``--resume`` to 32;
             the loss falls and the resumed run takes 2 steps; one
             backward launch a layer a step.
9. families — the moe, vlm, ssm, hybrid and audio families at their
             published widths (FAMILY_RUNS: mamba2-780m, hymba-1.5b,
             granite-moe-1b-a400m, llava-next-mistral-7b at full depth,
             dbrx-132b at 2 of 40 layers, whisper-small), f32 weights
             from a seeded generator on the card, each freed before the
             next: a bf16 ``forward`` of one sequence (finite logits of
             the expected shape; flash launches equal to its attention
             calls, all on the tensor-core route; wall time, peak
             memory), the ``ServingEngine`` as in phase 5 (a freed slot
             is reused: 8 requests on 4 slots); for mamba2 and hymba,
             f32 prefill against teacher-forced decode over 600 tokens
             (FAMILY_CHECK_TOL) and the first mixer's scan against its
             recurrence within 2e-4; the device profile of one decode
             step of mamba2 and granite-moe.  Then ``launch.serve.
             main([])`` with its defaults (mamba2-780m at full width on
             the card, every request served), and the flash kernel
             against its plain version at the shapes these models give
             it first (FLASH_FAMILY_SHAPES: head_dim 64 with GQA groups 2
             and 5, head_dim 128 with groups 4 and 6, whisper's
             non-causal encoder and its 448 x 1,500 cross attention),
             timed beside its plain version, SDPA and the bound.  The
             phase prints its wall time.
10. cells  — the reference's (arch x shape) grid (``launch.cells.
             build_cell(..., device="cuda")``) at the published widths:
             prefill_32k and decode_32k for all ten archs, long_500k for
             the three ``cell_supported`` allows, train_4k for one arch of
             each family (CELL_TRAIN_ARCHS), each cut in depth and batch
             (CELL_CUTS, printed beside the cell).  Each cut cell is first
             analysed on ``meta`` (``launch.dryrun.analyze_cell``): its
             FLOPs, bytes, state and predicted peak, which must fit the
             80 GB card, and its H100 roofline bound (a prefill's also
             along the flash kernel's path).  Then it runs on weights drawn
             from a seeded generator once per arch (each cell takes its
             depth of them; the train cell last, as it updates them in
             place): flash launches counted over its runs only, equal to
             its attention calls (twice under remat, per microbatch), all
             on the tensor-core route, and a train cell's backward launches
             one a call per microbatch; step time (CUDA events after a
             warm-up), peak memory, bound / step time; finite logits of
             the expected shape; a train cell's step 1 (loss, gradient
             norm) within CELL_STEP1_RTOL of the same cell with the plain
             attention and its update skipped, every parameter the loss
             reaches changed and all finite.  At each prefill the flash
             kernel is held against its plain version on the q / k / v of
             one layer of each distinct shape and mask (32,768 rows; one
             query head), and timed beside SDPA and its bound.
11. mesh   — the models' mesh path (``repro_torch.sharding``,
             ``launch.mesh``, the expert-parallel moe) in a
             ``torch.distributed`` world of one process per card (NCCL),
             spawned through ``torch.multiprocessing``.  With one card a
             (1, 1) ``DeviceMesh`` (DTensor, ``local_map``, the flash
             kernel on the rank's local heads): gemma3-27b at 6 layers and
             granite-moe-1b-a400m at 24 (the expert-parallel branch at
             ep = 1, its dropped tokens counted); with n >= 2 cards
             also a world of min(4, n) processes for qwen1.5-110b x 4 and
             dbrx-132b x 2 on (1, min(4, n)).  Each:
             a bf16 prefill (MESH_PREFILL) through ``launch.cells.
             build_cell`` on the mesh, MESH_DECODE_STEPS decode steps
             (MESH_DECODE) and the ``ServingEngine`` with ``mesh=`` on
             MESH_SERVE's requests (request clustering on ``soa-device``,
             greedy tokens equal on every rank), each held against the
             same model unsharded in the same run: exactly at world 1 for
             dense archs; granite-moe in f32 at capacity n_experts /
             top_k against the dense dispatch (MESH_F32_TOL); else
             MESH_BF16_TOL.  The engine's greedy tokens equal the
             unsharded engine's (at world > 1 both serve in f32).  Flash launches per rank equal the attention
             calls, all sm90; prefill and decode-step ms, peak GB per
             rank.  A failure in any rank fails the script.
12. mesh train — the train step on a (1, 1) ``DeviceMesh`` of a world
             of one (NCCL) against the unsharded step in the same run:
             (a) granite-20b at published widths and TRAIN_LAYERS layers,
             phase 8's batch, MESH_TRAIN_STEPS steps at accumulation
             MESH_TRAIN_ACCUM, unsharded (kept on the host, freed), then
             through ``build_cell(..., mesh)`` from the same draw: loss,
             gradient norm and parameters within phase 8's bounds (equal
             when the bodies keep the unsharded arithmetic), flash
             launches 2 x layers x microbatches a step, all sm90, one
             backward launch per layer and microbatch, the
             kernel against its plain version at the step's local shape;
             (b) granite-moe at published widths, MESH_MOE_LAYERS layers,
             f32 at capacity n_experts / top_k: the expert-parallel step
             within MESH_MOE_F32_TOL of the dense dispatch's, drops
             counted at its own capacity; (c) mamba2-780m x
             MESH_RESTART_LAYERS: a save of parameters and AdamW state on
             the mesh, restored onto it and unsharded, the next step from
             each equal to the uninterrupted run's.  With n >= 2 cards
             (a)'s mesh step in a world of min(4, n) on (2, 2) or (2, 1),
             within MESH_TRAIN_BF16_RTOL of the world-1 step.  Step ms
             (CUDA events), peak GB, the phase's seconds.
13. mesh analysis — in a child process that sees no card, the per-card
             step analysis (``launch.dryrun.analyze_cell`` on a mesh of
             ``launch.mesh.abstract_world``, meta tensors) of the exact
             configurations 12 (a) and 11 ran on (1, 1) (granite-20b x
             TRAIN_LAYERS train, gemma3-27b x 6 prefill), and with n >= 2
             cards of their multi-card meshes: per-card FLOPs, HBM bytes
             and collective bytes, the three roofline terms over
             ``launch.roofline``'s data-sheet rates, and the bound beside
             the step ms those phases measured (bound / the slowest
             rank's).  On (1, 1) the FLOPs and HBM bytes must equal the
             one-card analysis and the collective bytes 0; every run must
             be analysed.
14. examples and analysis — ``python -m repro_torch.analysis --json``
             in a child process: exit 0, 0 findings, all six passes
             reported (their counts printed).  Then the five
             ``examples/torch_*.py`` through their ``main`` at their
             defaults, each one's wall seconds and launches printed:
             quickstart and streaming with ``--backend soa-device`` on
             the card and again with ``--device cpu``, every number they
             print but seconds equal (ARIs, clusters, noise, repair
             scans), ``lsh_hash_resolve`` and ``bucket_insert_pass``
             launched at least once per insert batch on the card;
             curation on ``soa-device`` on the card and the CPU, equal;
             serve (``mamba2-780m --smoke``, 12 requests) and train
             (granite-20b smoke at d_model 512, its 300 steps) on the
             card, train's ``flash_attention`` launches at least 1.

The line before the last is one JSON object with a ``kernels`` list (all
five kernels and the ``lsh_hash_resolve`` and fused
``bucket_insert_pass`` routes, the latter's masked route with its
launches on the approx path; ``lsh_hash``'s entry also gives its
launches on the dict path, and the two routes theirs on the sharded
path, 3e (a), with their check at a shard's sub-batch, and on phase 8
(a)'s restored index and (b)'s curation; ``flash_attention``'s its
launches in 8 (c) and (d) and its check at the trainer's shape, and its
launches per forward of each arch of phase 9 with its checks at phase
9's shapes, its launches in each cell of phase 10 with its checks at
32,768 rows, its launches per rank in phase 11, and its launches per
rank in phase 12 with its check at the mesh step's local shape; every
kernel and route its launches in each example of phase 14); the last
line is
``{"ok": true, "device": {...}}``.
``--points`` cuts the main, dict and approx streams only (the cut is
printed);
d, k, t, eps and the batch never change.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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
# the stream of phases 3-3e and 8 (a) by default: cut from FULL_POINTS
# for the script's time (the whole script took 1,300.0 s of its 1,200 on
# a slow host, 910.6 s on another, with phases 3-3e 55% of it and linear
# in the points)
STREAM_POINTS = 150_000
DELETE_FRACTION = 0.25
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# H100 SXM scalar rate outside the tensor cores: the data sheet's 67
# TFLOP/s float32 counts a fused multiply-add as two operations, so a lone
# add, multiply, compare or int32 operation issues at half of it
SCALAR_OPS_PER_S = 67e12 / 2
PROFILE_TRIES = 3              # profiler sessions before CUDA events
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
# blobs, with benchmarks/common.py stream_eval's protocol; phase 4 runs
# it cut to half that scale, BASELINE_POINTS, to keep the script within
# its time with the families phase (9) added (``naive`` recomputes on
# every batch: ~100 s at 20,000 points on a slow host, ~1/8 of it at
# 10,000); the cut is printed
BASELINES = ("dynamic", "naive", "emz-static", "emz-fixed")
TABLE2_POINTS = 20_000
BASELINE_POINTS = 10_000
# the sharded path (phase 3e): four soa-device shards on a pool of four
# threads over phase 3's stream (a), its first 10 insert batches timed
# with a serial and a pooled fan-out in turns; the same config as four
# worker processes over its first 15 insert batches (b); two shards of a
# primary and a replica each over TCP at Table 2's scale, shard 0's
# primary killed after batch 10 as benchmarks/serving_mix.py's chaos
# does (c).  The 10 and 15 are cut from 100 and 50 (then 40 and 25) to
# keep the script within its time with phases 8 and 9 added
SHARDS = 4
PROCESS_BATCHES = 15
FANOUT_BATCHES = 10
# label() calls on every SHARDED_LABEL_EVERY-th insert batch of (a), each
# held against the host shards', and labels() on every
# SHARDED_LABELS_EVERY-th (cut from 32 calls on every batch and labels()
# on every 10th, for the same reason; deltas stay compared every batch)
SHARDED_LABEL_SAMPLE = 16
SHARDED_LABEL_EVERY, SHARDED_LABELS_EVERY = 5, 40
FAILOVER_KILL_AFTER = 10
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
# the trainer's attention (phase 8 (c)): granite-20b's 48 query heads on
# one kv head at head_dim 128, and a ragged length; swept on the card
# only: on the CPU the "kernel" is the plain version itself, whose bf16
# logits (rounded as the reference rounds them) fall two bf16 ulps from
# the f32 upcast's at 1,024 unmasked keys
FLASH_SWEEP_TRAIN = (
    (2, 48, 1, 1024, 1024, 128, True, None),
    (1, 48, 1, 777, 777, 128, True, None),
)
# training path (phase 8): (a) phase 3's soa-device index saved after
# this many insert batches and restored onto the card; (b) the trainer's
# curation (launch/train.py's CurationFilter settings over its stream:
# SyntheticTokenStream(vocab, 64, 8, seed=1)) on soa-device beside a host
# soa twin, this many batches (no point leaves the 20,000-point window);
# (c) granite-20b at its published widths (d_model 6144, 48 heads, one kv
# head, head_dim 128, d_ff 24,576, vocab 49,152), depth cut from 52
# layers to 4: 2.72 B parameters, whose f32 weights, gradients and two
# moments take 43.6 GB (52 layers do not fit one 80 GB card), at the
# trainer's --batch 8 --seq 1024 --curation balance, 10 steps; step 1's
# loss and gradient norm within relative bounds of the same step with
# the plain attention (the kernel's output is within one bf16 ulp of its
# plain version's); each bound sits between the sound step's reading on
# the card and the smallest that a step with a planted fault of one tile
# (FAULT_TILE rows or keys, planted_fault) reads, a factor of 2 to 6 from
# each (PERF.md section 5 keeps the readings), and each planted fault
# must break a bound; (d) the reference trainer's test protocol at the
# trainer's "100m" preset
# families phase (9): each arch of the moe, vlm, ssm, hybrid and audio
# families at its published widths: (arch, layers or None for all, text
# tokens of the bf16 prefill); llava adds its 576 patches to the text,
# whisper's encoder takes 1,500 frames.  dbrx is cut from 40 layers to
# 2: one layer's f32 weights are ~13 GB, so 40 would need ~520 GB.
# llava is cut from 32 layers to 16 for the script's time: its serving
# took 28 s of a 281 s phase on a slow host, at ~3 ms of host dispatch a
# layer and decode step
FAMILY_RUNS = (
    ("mamba2-780m", None, 4096), ("hymba-1.5b", None, 4096),
    ("granite-moe-1b-a400m", None, 4096),
    ("llava-next-mistral-7b", 16, 2048), ("dbrx-132b", 2, 2048),
    ("whisper-small", None, 448),
)
AUDIO_FRAMES = 1500            # whisper's 30 s encoder length (CROSS_LEN)
# f32 prefill against teacher-forced decode, past two SSD chunks of 256,
# within these tolerances: the reference's LM_TOL, except for the 48
# layers of mamba2-780m.  There the chunked scan (prefill) and the
# recurrence (decode) sum in different f32 orders: one mixer at full
# width differs by 4.4e-5 on outputs up to 4.6 (within LM_TOL, and held
# so below for each arch's first mixer), and the differences compound
# over the 48 layers to 7.2e-4-1.1e-3 on logits up to 5.6 on an NVIDIA
# H100 80GB HBM3 at 700 W, already from token 8 on and still 4.0e-4
# with chunks of 16: not the cumsum's cancellation at a full chunk
# (tools/ssm_decode_study.py measures it).  The 32 layers of hymba-1.5b
# read 5.4e-5-5.7e-5
FAMILY_CHECK_TOKENS = 600
# the serving engine takes a prompt one token a step, so phase 9's
# serving time is ~(prompt + new tokens) decode steps of each arch: its
# prompts are cut from SERVE_PROMPT_MIN..SERVE_PROMPT_MAX (8-64) tokens
# to 8-16 for the script's time (hymba's serving took 69.9 s of a 205 s
# phase on a slow host, 329 prompt tokens at ~0.2 s a step)
FAMILY_SERVE_PROMPT = (8, 16)
FAMILY_CHECK_TOL = {"mamba2-780m": 2e-3, "hymba-1.5b": LM_TOL}
# the archs whose decode step is profiled
FAMILY_PROFILE_ARCHS = ("mamba2-780m", "granite-moe-1b-a400m")
# flash_attention at the shapes this phase gives it first: (tag, b, hq,
# hkv, sq, skv, dh, causal); head_dim 64 with GQA groups 2 and 5, 128
# with groups 4 (llava's 576 patches + 2,048 tokens) and 6 (dbrx's
# 2,048), whisper's non-causal encoder and its cross attention (sq !=
# skv)
FLASH_FAMILY_SHAPES = (
    ("granite-moe-1b-a400m", 1, 16, 8, 4096, 4096, 64, True),
    ("hymba-1.5b", 1, 25, 5, 4096, 4096, 64, True),
    ("llava-next-mistral-7b", 1, 32, 8, 2624, 2624, 128, True),
    ("dbrx-132b", 1, 48, 8, 2048, 2048, 128, True),
    ("whisper-small encoder", 1, 12, 12, 1500, 1500, 64, False),
    ("whisper-small cross", 1, 12, 12, 448, 1500, 64, False),
)
# cells phase (10): the reference's (arch x shape) grid through
# launch.cells.build_cell on the card at the published widths.  Every arch
# runs prefill_32k (batch cut from 32 to 1) and decode_32k, the three that
# cell_supported allows run long_500k, and one arch of each family runs
# train_4k (batch cut from 256 to 8, the accumulation clamped to it as
# the reference clamps it).  CELL_CUTS: (layers or None for all, batch);
# each cut is reckoned from the cell's state_bytes (launch.dryrun) and
# checked before the run against the card's 80 GB by the peak the cut
# cell predicts on meta (run_cell); the depth cuts also keep the phase
# within its ~180 s.  Params + grads + AdamW's m and v take 16 B a
# parameter: phi3's 32 layers (3.82 B) 61 GB, llava's 32 (7.24 B) 116 GB.
CELL_TRAIN_ARCHS = ("phi3-mini-3.8b", "granite-moe-1b-a400m",
                    "llava-next-mistral-7b", "mamba2-780m", "hymba-1.5b",
                    "whisper-small")
CELL_CUTS = {
    # f32 weights: qwen 5.4 GB a layer + 10 GB embed/head; its bf16 cache
    # at batch 8 is 1.07 GB a layer
    ("qwen1.5-110b", "prefill_32k"): (4, 1),
    ("qwen1.5-110b", "decode_32k"): (4, 8),
    ("granite-20b", "prefill_32k"): (8, 1),
    ("granite-20b", "decode_32k"): (8, 64),
    # two 5:1 periods: two global layers (4.3 GB of cache each at 500k)
    ("gemma3-27b", "prefill_32k"): (12, 1),
    ("gemma3-27b", "decode_32k"): (12, 16),
    ("gemma3-27b", "long_500k"): (12, None),
    # phi3's 32 kv heads: 403 MB of cache a sequence and layer at 32k
    ("phi3-mini-3.8b", "prefill_32k"): (16, 1),
    ("phi3-mini-3.8b", "decode_32k"): (8, 4),
    ("phi3-mini-3.8b", "train_4k"): (16, 8),
    # one dbrx layer's f32 weights are 12.7 GB
    ("dbrx-132b", "prefill_32k"): (2, 1),
    ("dbrx-132b", "decode_32k"): (2, 32),
    ("granite-moe-1b-a400m", "prefill_32k"): (None, 1),
    ("granite-moe-1b-a400m", "decode_32k"): (None, 8),
    ("granite-moe-1b-a400m", "train_4k"): (None, 8),
    ("llava-next-mistral-7b", "prefill_32k"): (10, 1),
    ("llava-next-mistral-7b", "decode_32k"): (10, 8),
    ("llava-next-mistral-7b", "train_4k"): (10, 8),
    # mamba2 carries state only: 9.7 GB at the full batch of 128.  Its
    # and hymba's train steps are cut to a quarter of their depth for the
    # phase's time: at full depth they took 7.80 / 11.11 s a step (three
    # steps a cell) on an NVIDIA H100 80GB HBM3 at 700 W, the SSD's chunk
    # loop host-bound, and at half depth 5.34 / 5.85 s on a slow host
    ("mamba2-780m", "prefill_32k"): (None, 1),
    ("mamba2-780m", "train_4k"): (12, 8),
    # hymba's cache at 500k: 21.5 GB at full depth
    ("hymba-1.5b", "prefill_32k"): (None, 1),
    ("hymba-1.5b", "decode_32k"): (None, 8),
    ("hymba-1.5b", "train_4k"): (8, 8),
    ("whisper-small", "prefill_32k"): (None, 1),
    ("whisper-small", "decode_32k"): (None, 16),
    ("whisper-small", "train_4k"): (None, 8),
}
CELL_CARD_BYTES = 80e9          # one H100 SXM (data sheet)
# on the CPU (tests): the smoke configs at (sequence, batch)
CELL_SMOKE_SHAPES = {"prefill_32k": (64, 1), "decode_32k": (64, 2),
                     "long_500k": (128, 1), "train_4k": (32, 8)}
# query heads (with their kv heads) on which the flash kernel is held
# against its plain version at a prefill cell's shapes
CELL_CHECK_HEADS = 1
# train_4k's step 1 against the same cell with the plain attention
# (relative error of the loss, of the global gradient norm), per family,
# set before the first card run from phase 8's reading (3.3e-6 / 3.5e-5
# at 4 layers x 1,024 tokens): ~10x deeper stacks and 4x longer rows give
# a margin of ~6; a moe router may flip a near-tied expert; the ssm
# family runs no attention, so both steps compute the same thing
CELL_STEP1_RTOL = {"dense": (2e-4, 2e-3), "vlm": (2e-4, 2e-3),
                   "moe": (2e-4, 5e-3), "ssm": (2e-4, 2e-3),
                   "hybrid": (2e-4, 2e-3), "audio": (2e-4, 2e-3)}
INDEX_SAVE_AT = 100
CURATION = dict(k=8, t=8, eps=0.6, policy="balance", window=20_000)
CURATION_SEQ, CURATION_BATCH, CURATION_BATCHES = 64, 8, 400
TRAIN_ARCH, TRAIN_LAYERS = "granite-20b", 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 10
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 2e-5, 1e-4
FAULT_TILE = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """``flash_attention_sm90_kernel<128, true>`` from an Itanium-mangled
    kernel name, where each identifier follows its length in digits and
    each int / bool template argument is ``L[ib]<value>E``."""
    import re

    end = mangled.find("_kernel") + len("_kernel")
    if end < len("_kernel"):
        return mangled
    for start in range(end - len("_kernel"), 0, -1):
        n = str(end - start)
        if mangled[start - len(n):start] == n and not \
                mangled[start].isdigit():
            t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
            if not t:
                return mangled[start:end]
            args = [v if kind == "i" else ("false", "true")[int(v)]
                    for kind, v in re.findall(r"L([ib])(\d+)E",
                                              t.group(1))]
            return f"{mangled[start:end]}<{', '.join(args)}>"
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


def flash_hgmma(sass: str) -> dict:
    """The HGMMA count of each bf16 flash kernel, forward and backward
    (the backward's rowsum pass has no product); raises unless both the
    forward and a backward kernel are there, each with HGMMA."""
    hgmma = {k: n for k, n in hgmma_counts(sass).items()
             if "flash_attention_sm90" in k or ("attention_bwd_sm90" in k
                                                and "delta" not in k)}
    fwd = [k for k in hgmma if "flash_attention_sm90" in k]
    bwd = [k for k in hgmma if "attention_bwd_sm90" in k]
    if not fwd or not bwd or min(hgmma.values()) == 0:
        raise AssertionError(f"no HGMMA in a bf16 flash kernel's SASS, "
                             f"forward and backward: {hgmma}")
    return hgmma


def build_report() -> dict:
    """The built library's ptxas registers / spills per kernel and the
    HGMMA count of each bf16 flash kernel; raises when the bf16 route
    holds no HGMMA or an ``eps_neighbor_counts`` kernel spills."""
    from repro_torch.kernels import _build

    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass", str(_build.library_path())],
        capture_output=True, text=True, timeout=300, check=True).stdout
    hgmma = flash_hgmma(sass)
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
    kept["cores_after_inserts"] = np.array(sorted(host.engine.core_set()),
                                           np.int64)
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
    kept["cores_after_deletes"] = np.array(sorted(host.engine.core_set()),
                                           np.int64)
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
# sharded path: the coordinator over soa-device shards on the card
# ---------------------------------------------------------------------- #
def sharded_cfg(inner: str, **kw):
    """Phase 3e's config: SHARDS shards of ``inner`` on a pool of as many
    threads, traced, at phase 3's d, k, t, eps and seed."""
    from repro_torch.api import ClusterConfig

    base = dict(d=D, k=K, t=T, eps=EPS, seed=SEED, backend="sharded",
                shards=SHARDS, inner_backend=inner, workers=SHARDS,
                obs=True)
    base.update(kw)
    return ClusterConfig(**base)


def partition_agreement(labels: dict, ref) -> dict:
    """ARI of ``labels`` against ``ref`` (a ``label_array``) and the
    points outside the best one-to-one matching of their clusters (noise
    matched to noise): border points whose tie picked another colliding
    cluster land there."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    ids, want = ref[0], ref[1]
    got = np.array([labels[int(i)] for i in ids], np.int64)
    _, wi = np.unique(want, return_inverse=True)
    _, gi = np.unique(got, return_inverse=True)
    table = np.zeros((wi.max() + 1, gi.max() + 1), np.int64)
    np.add.at(table, (wi, gi), 1)
    rows, cols = linear_sum_assignment(-table)
    return {"ari": ari_of(labels, ref),
            "outside_best_bijection": int(len(ids) - table[rows, cols].sum())}


def same_cores_and_noise(index, labels: dict, want_labels, want_cores,
                         tag: str) -> None:
    """The reference's contract for a sharded index against the unsharded
    engine (``shard/index.py``): the same live ids, noise set and cores."""
    import numpy as np

    ids = np.array(sorted(labels), np.int64)
    if not np.array_equal(ids, want_labels[0]):
        raise AssertionError(f"3e {tag}: live ids differ from phase 3's")
    noise = np.array([labels[int(i)] == -1 for i in ids])
    if not np.array_equal(noise, want_labels[1] == -1):
        raise AssertionError(f"3e {tag}: noise set differs from phase 3's")
    cores = np.array([i for i in ids if index.is_core(int(i))], np.int64)
    if not np.array_equal(cores, want_cores):
        raise AssertionError(f"3e {tag}: core set differs from phase 3's")


def sorted_deltas(deltas) -> list:
    """A change feed in a total order: a sharded feed may hold one id
    twice, (idx, old, None) from one shard and (idx, None, new) from
    another, when a rebalance moved it."""
    return sorted(deltas, key=lambda r: tuple(-1 if v is None else v
                                              for v in r))


def card_apps() -> list:
    """``nvidia-smi``'s compute apps as (pid, used memory) lines (in a
    container the pid is the host's, not ours)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def holds_card(pid: int) -> bool:
    """Whether process ``pid`` has a GPU device file (/dev/nvidia<N>)
    open: every process with a CUDA context does."""
    import os
    import re

    fd_dir = Path(f"/proc/{pid}/fd")
    for fd in fd_dir.iterdir():
        try:
            if re.fullmatch(r"/dev/nvidia\d+", os.readlink(fd)):
                return True
        except OSError:  # closed since the listing
            continue
    return False


def keep_passes(eng) -> dict:
    """Wrap a ``soa-device`` engine's two device passes for their next
    call (a shard's in 3e (a), the curation window's in 8 (b)): the
    dict returned gets the inputs each kernel launched on (the points, the
    pending directory updates and the directory mirror as the hash pass
    hands them over, after any rebuild; the slots and the host size table
    before the stats pass) and what each pass returned.  The wrappers take
    themselves off after that call."""
    import numpy as np

    seen = {}
    hp, dp = eng._hpass, eng._dpass

    def updates(host_dir):
        cells = type(hp)._updates(hp, host_dir)
        seen.update(upd=cells.copy(), table=hp.table.clone())
        return cells

    def hash_run(X, host_dir):
        try:
            keys, slots = type(hp).run(hp, X, host_dir)
        finally:
            del hp._updates, hp.run
        seen.update(x=np.asarray(X, np.float32), keys=keys.copy(),
                    hits=slots.copy())
        return keys, slots

    def stats_run(slots, host_sizes, k, *rest):
        before = host_sizes.copy()
        try:
            out = type(dp).run(dp, slots, host_sizes, k, *rest)
        finally:
            del dp.run
        seen.update(slots=slots.copy(), k=k, sizes_before=before,
                    sizes=host_sizes.copy(), support=out[-1].copy())
        return out

    hp._updates, hp.run, dp.run = updates, hash_run, stats_run
    return seen


def pass_check(seen, eng, card: str, tag: str) -> dict:
    """``lsh_hash_resolve`` and ``bucket_insert_pass`` at the batch that
    ``keep_passes`` captured (phase ``tag``): each on copies of the inputs
    it launched on, bit-exact against its plain version on other copies
    (the directory each leaves too), and equal to what the engine
    computed; then, on the card, timed beside the plain version (CUDA
    events; the hash pass with no update, the stats pass on a scratch
    table that grows a batch a call)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    hp = eng._hpass
    dev = hp.table.device
    x = torch.from_numpy(seen["x"]).to(dev)
    upd = torch.from_numpy(seen["upd"]).to(dev)
    kw = {"inv_cell": hp.inv_cell}
    n, t = seen["hits"].shape
    m = n * t
    tabs = [seen["table"].clone(), seen["table"].clone()]
    got = ops.lsh_hash_resolve(x, hp.eta, hp.mixers, directory=tabs[0],
                               updates=upd.clone(), **kw)
    want = ops.lsh_hash_resolve(x, hp.eta, hp.mixers, directory=tabs[1],
                                updates=upd.clone(), impl="ref", **kw)
    err_h = max_abs_err(got, want)
    if live_cells(tabs[0]) != live_cells(tabs[1]):
        raise AssertionError(f"{tag}: lsh_hash_resolve's directory differs "
                             "from its plain version's at the captured "
                             "batch")
    out = got.cpu().numpy()
    if not (np.array_equal(out[:2 * m], seen["keys"].ravel())
            and np.array_equal(out[2 * m:], seen["hits"].ravel())):
        raise AssertionError(f"{tag}: lsh_hash_resolve differs from the "
                             "engine's hash pass of the captured batch")
    slots = torch.from_numpy(seen["slots"]).to(dev)
    pre = torch.from_numpy(seen["sizes_before"]).to(dev)
    k, ns = seen["k"], len(seen["sizes_before"])
    a, b = pre.clone(), pre.clone()
    got = ops.bucket_insert_pass(slots, a, k=k)
    err_s = max(max_abs_err(got, ops.bucket_insert_pass(slots, b, k=k,
                                                        impl="ref")),
                max_abs_err(a, b))
    if not np.array_equal(got.cpu().numpy(), np.concatenate(
            [seen["sizes"], seen["support"]])):
        raise AssertionError(f"{tag}: bucket_insert_pass differs from the "
                             "engine's stats pass of the captured batch")
    if err_h or err_s:
        raise AssertionError(f"{tag}: at the captured batch the kernels "
                             f"differ from their plain versions (max abs "
                             f"err {err_h}, {err_s})")
    row = {"rows": n, "t": t, "updates": len(seen["upd"]),
           "dir_cap": int(tabs[0].shape[0]), "n_slots": ns,
           "lsh_hash_resolve_max_abs_err": err_h,
           "bucket_insert_pass_max_abs_err": err_s, "card": card}
    if dev.type == "cpu":  # the plain versions against themselves
        return row
    none = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    hbuf = torch.empty(3 * m, dtype=torch.int32, device=dev)
    sbuf = torch.empty(ns + n, dtype=torch.int32, device=dev)
    scratch = pre.clone()

    def resolve(impl):
        return ops.lsh_hash_resolve(x, hp.eta, hp.mixers,
                                    directory=tabs[0], updates=none,
                                    out=hbuf, impl=impl, **kw)

    def stats(impl):
        return ops.bucket_insert_pass(slots, scratch, k=k, out=sbuf,
                                      impl=impl)
    row.update({
        "lsh_hash_resolve_ms": time_ms(lambda: resolve(None)),
        "lsh_hash_resolve_plain_ms": time_ms(lambda: resolve("ref"),
                                             reps=20, warmup=2),
        "bucket_insert_pass_ms": time_ms(lambda: stats(None)),
        "bucket_insert_pass_plain_ms": time_ms(lambda: stats("ref"),
                                               reps=20, warmup=2)})
    print(f"{tag} pass check: {n} x {t} rows, {row['updates']} directory "
          f"updates, {ns} slots: both kernels bit-exact against their "
          f"plain versions and equal to the engine's passes; "
          f"lsh_hash_resolve {row['lsh_hash_resolve_ms']:.5f} ms (plain "
          f"{row['lsh_hash_resolve_plain_ms']:.4f}), bucket_insert_pass "
          f"{row['bucket_insert_pass_ms']:.5f} ms (plain "
          f"{row['bucket_insert_pass_plain_ms']:.4f})  [{card}]", flush=True)
    return row


def fanout_in_turns(X, device: str, card: str) -> dict:
    """3e (a)'s insert batches, the first FANOUT_BATCHES of the stream on
    an uninstrumented index with no host twin, with the fan-out serial
    (``workers=0``) and on a pool of SHARDS threads, in turns (serial,
    pool, pool, serial), each run on a fresh index: the host clock around
    ``insert_batch`` and the feed's drain, ms a batch."""
    import numpy as np

    from repro_torch.api import build_index

    n = min(len(X), FANOUT_BATCHES * BATCH)
    runs = []
    for workers in (0, SHARDS, SHARDS, 0):
        ix = build_index(sharded_cfg("soa-device", workers=workers,
                                     obs=False), device=device)
        try:
            ix.drain_deltas()
            ms = []
            for b in range(-(-n // BATCH)):
                t0 = time.perf_counter()
                ix.insert_batch(X[b * BATCH:min(n, (b + 1) * BATCH)])
                ix.drain_deltas()
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            ix.close()
        runs.append({"workers": workers, "total_s": sum(ms) / 1e3,
                     "median_ms": float(np.median(ms)),
                     "mean_ms": float(np.mean(ms))})
    print(f"3e (a) fan-out in turns, {n} points, insert batch ms (median) "
          f"serial / pool / pool / serial: "
          + ", ".join(f"{r['median_ms']:.3f}" for r in runs)
          + f"  [{card}]", flush=True)
    return {"points": n, "runs": runs, "card": card}


def run_sharded_local(X, kept: dict, device: str, card: str):
    """Phase 3e (a): the sharded index, four ``soa-device`` shards on the
    card behind the local transport with a pool of four threads, over
    phase 3's stream beside the same config with host ``soa`` shards;
    returns (metrics, what (b) is held against)."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.api import build_index, restore_index
    from repro_torch.kernels import ops
    from repro_torch.obs import span_stats
    from repro_torch.shard import propose_rebalance

    n_points = len(X)
    n_batches = -(-n_points // BATCH)
    rng = np.random.default_rng(SEED + 2)
    dev = build_index(sharded_cfg("soa-device"), device=device)
    host = build_index(sharded_cfg("soa"))
    for ix in (dev, host):
        if ix.inners[0].engine.use_device != (ix is dev):
            raise AssertionError("3e (a): shards on the wrong engine")
    if any(ix.engine.device.type != device for ix in dev.inners):
        raise AssertionError(f"3e (a): a shard is not on {device}")
    rest = None
    try:
        dev.drain_deltas()
        host.drain_deltas()
        ops.reset_launch_counts()
        keep = {"deltas": []}
        ins_s = labels_s = label_s = 0.0
        sub_batches = 0
        for b in range(n_batches):
            Xb = X[b * BATCH:(b + 1) * BATCH]
            to = dev.router.shards_batch(Xb)
            sub_batches += len(np.unique(to))
            if b == n_batches - 1:  # the fullest shard's sub-batch
                probe = int(np.bincount(to, minlength=SHARDS).argmax())
                passes = keep_passes(dev.inners[probe].engine)
            t0 = time.perf_counter()
            ids = dev.insert_batch(Xb)
            deltas = sorted_deltas(dev.drain_deltas())
            ins_s += time.perf_counter() - t0
            if host.insert_batch(Xb) != ids:
                raise AssertionError(f"3e (a) batch {b}: ids differ")
            if sorted_deltas(host.drain_deltas()) != deltas:
                raise AssertionError(f"3e (a) batch {b}: deltas differ "
                                     "from the host sharded run's")
            if b < PROCESS_BATCHES:
                keep["deltas"].append(deltas)
            if b % SHARDED_LABEL_EVERY == 0:
                sample = [int(i) for i in rng.choice(
                    ids, size=SHARDED_LABEL_SAMPLE, replace=False)]
                t0 = time.perf_counter()
                got = [dev.label(i) for i in sample]
                label_s += time.perf_counter() - t0
                if got != [host.label(i) for i in sample]:
                    raise AssertionError(f"3e (a) batch {b}: label() "
                                         "differs")
            if b % SHARDED_LABELS_EVERY == SHARDED_LABELS_EVERY - 1:
                t0 = time.perf_counter()
                lab = dev.labels()
                labels_s += time.perf_counter() - t0
                if lab != host.labels():
                    raise AssertionError(f"3e (a) batch {b}: labels() "
                                         "differ")
            if b == min(PROCESS_BATCHES, n_batches) - 1:
                # after the label() calls: labels() warms the index's
                # cache, which label() then answers from
                keep["labels"] = host.labels()
        entries = ops.entry_launch_counts()
        launches = ops.launch_counts()
        want = {"lsh_hash_resolve": sub_batches,
                "bucket_insert_pass": sub_batches, "lsh_hash": 0,
                "slot_counts": 0, "bucket_core_stats": 0}
        if device != "cpu" and {k: entries[k] for k in want} != want:
            raise AssertionError(f"3e (a): kernel entries "
                                 f"{ {k: entries[k] for k in want} }, "
                                 f"expected {want}")
        # the coordinator's split of an insert batch, from its spans
        spans = {r["op"]: r
                 for r in span_stats(dev.obs.snapshot()["spans"])}
        route_s = spans["coord.route_and_key"]["total_us"] / 1e6
        fan_s = spans["coord.fanout"]["total_us"] / 1e6
        sub_check = pass_check(passes, dev.inners[probe].engine, card,
                               "3e (a)")
        sub_check["shard"] = probe
        lab_ins = dev.labels()
        if lab_ins != host.labels():
            raise AssertionError("3e (a): labels() differ after the "
                                 "inserts")
        same_cores_and_noise(dev, lab_ins, kept["labels_after_inserts"],
                             kept["cores_after_inserts"], "inserts")
        agree_ins = partition_agreement(lab_ins,
                                        kept["labels_after_inserts"])

        sizes_before = dev.shard_sizes()
        plan = propose_rebalance(dev)
        if plan != propose_rebalance(host):
            raise AssertionError("3e (a): rebalance plans differ")
        t0 = time.perf_counter()
        moved = dev.rebalance(plan) if plan is not None else {"moved": 0}
        rebalance_s = time.perf_counter() - t0
        if plan is not None and host.rebalance(plan) != moved:
            raise AssertionError("3e (a): rebalance moved other points")
        sizes_after = dev.shard_sizes()
        lab = dev.labels()
        if lab != host.labels() or lab != lab_ins:
            raise AssertionError("3e (a): labels() changed in the "
                                 "rebalance")
        if sizes_after != host.shard_sizes():
            raise AssertionError("3e (a): shard sizes differ after the "
                                 "rebalance")
        if sorted_deltas(dev.drain_deltas()) != \
                sorted_deltas(host.drain_deltas()):
            raise AssertionError("3e (a): the rebalance's deltas differ")

        del_s = 0.0
        victims = kept["victims"]
        for b in range(0, len(victims), BATCH):
            vb = [int(i) for i in victims[b:b + BATCH]]
            t0 = time.perf_counter()
            dev.delete_batch(vb)
            deltas = sorted_deltas(dev.drain_deltas())
            del_s += time.perf_counter() - t0
            host.delete_batch(vb)
            if sorted_deltas(host.drain_deltas()) != deltas:
                raise AssertionError(f"3e (a) delete batch {b // BATCH}: "
                                     "deltas differ")
        lab_end = dev.labels()
        if lab_end != host.labels():
            raise AssertionError("3e (a): labels() differ after the "
                                 "deletes")
        same_cores_and_noise(dev, lab_end, kept["labels_after_deletes"],
                             kept["cores_after_deletes"], "deletes")
        agree_end = partition_agreement(lab_end,
                                        kept["labels_after_deletes"])
        t0 = time.perf_counter()
        dev.check_invariants()
        host.check_invariants()
        check_s = time.perf_counter() - t0

        rest = restore_index(dev.snapshot(), device=device)
        if rest.labels() != lab_end:
            raise AssertionError("3e (a): labels differ after snapshot + "
                                 "restore")
        rest.check_invariants()

        with tempfile.TemporaryDirectory() as tmp:
            trace = dev.write_trace(Path(tmp) / "sharded_trace.json")
            trace_bytes = trace.stat().st_size
            report = subprocess.run(
                [sys.executable, "-m", "repro_torch.obs", "report",
                 str(trace)], capture_output=True, text=True, timeout=300,
                env=dict(os.environ, PYTHONPATH=str(PKG.parent)))
        if report.returncode != 0:
            raise AssertionError("3e (a): obs report failed: "
                                 + report.stderr[-2000:])
        stats = dev.stats()
    finally:
        for ix in (dev, host, rest):
            if ix is not None:
                ix.close()
    n_del = len(kept["victims"])
    return {
        "points": n_points, "shards": SHARDS, "workers": SHARDS,
        "inner": "soa-device", "insert_batches": n_batches,
        "sub_batches": sub_batches, "entry_launches": entries,
        "launches": launches,
        "insert_pts_per_s": n_points / ins_s,
        "delete_pts_per_s": n_del / del_s, "insert_s": ins_s,
        "delete_s": del_s, "labels_s": labels_s,
        "labels_s_per_call": labels_s
        / (n_batches // SHARDED_LABELS_EVERY or 1),
        "label_us_per_call": label_s / (
            SHARDED_LABEL_SAMPLE * -(-n_batches // SHARDED_LABEL_EVERY))
        * 1e6,
        "route_and_key_ms_per_batch": route_s / n_batches * 1e3,
        "fanout_ms_per_batch": fan_s / n_batches * 1e3,
        "rest_of_insert_ms_per_batch":
            (ins_s - route_s - fan_s) / n_batches * 1e3,
        "sub_batch_check": sub_check,
        "shard_sizes_before_rebalance": sizes_before,
        "shard_sizes_after_rebalance": sizes_after,
        "rebalance_plan": None if plan is None else
            [plan.start, plan.stop, plan.target],
        "rebalance_moved": moved["moved"], "rebalance_s": rebalance_s,
        "check_invariants_s": check_s,
        "agreement_after_inserts": agree_ins,
        "agreement_after_deletes": agree_end,
        "stats": stats, "report_top": report.stdout.splitlines()[:12],
        "trace_bytes": trace_bytes,
        "equal_host_sharded": True, "cores_noise_equal_phase3": True,
        "restore_labels_equal": True, "card": card,
    }, keep


def run_sharded_process(X, keep: dict, device: str, card: str) -> dict:
    """Phase 3e (b): (a)'s config with ``transport="process"``, four
    workers spawned with ``--device``, over the first PROCESS_BATCHES
    insert batches, held against (a)'s host run; then a snapshot
    restored on the local transport."""
    import numpy as np

    from repro_torch.api import build_index, restore_index
    from repro_torch.kernels import ops

    n = min(len(X), PROCESS_BATCHES * BATCH)
    t0 = time.perf_counter()
    ix = build_index(sharded_cfg("soa-device", transport="process"),
                     device=device)
    spawn_s = time.perf_counter() - t0
    rest = None
    try:
        pids = [c._proc.pid for c in ix.clients]
        ix.drain_deltas()
        ops.reset_launch_counts()
        ins_s = 0.0
        for b in range(-(-n // BATCH)):
            t0 = time.perf_counter()
            ix.insert_batch(X[b * BATCH:min(n, (b + 1) * BATCH)])
            deltas = sorted_deltas(ix.drain_deltas())
            ins_s += time.perf_counter() - t0
            if deltas != keep["deltas"][b]:
                raise AssertionError(f"3e (b) batch {b}: deltas differ "
                                     "from (a)'s host run")
        # nvidia-smi lists one compute app a process with a context (the
        # coordinator's too), but in a container under a pid that is not
        # ours: the count is checked, and each worker's own device file
        apps = card_apps() if device != "cpu" else []
        missing = [p for p in pids if device != "cpu" and
                   not holds_card(p)]
        if missing or (device != "cpu" and len(apps) < len(pids)):
            raise AssertionError(f"3e (b): workers {missing} hold no "
                                 f"context on the card (nvidia-smi lists "
                                 f"{apps})")
        t0 = time.perf_counter()
        lab = ix.labels()
        labels_s = time.perf_counter() - t0
        if lab != keep["labels"]:
            raise AssertionError(f"3e (b): labels after {n} points "
                                 "differ from (a)'s")
        if any(ops.launch_counts().values()):
            raise AssertionError("3e (b): the coordinator launched a "
                                 "kernel")
        for c in ix.clients:  # each shard's invariants, its mirrors too
            c.check_invariants()
        snap = ix.snapshot()
        snap = dict(snap, config=dict(snap["config"], transport="local"))
        rest = restore_index(snap, device=device)
        if rest.labels() != lab:
            raise AssertionError("3e (b): labels differ after a restore "
                                 "on the local transport")
        st = ix.stats()
    finally:
        for c in (ix, rest):
            if c is not None:
                c.close()
    alive = [p for p in pids if _alive(p)]
    if alive:
        raise AssertionError(f"3e (b): workers {alive} outlived close()")
    return {"points": n, "workers_pids": pids, "nvidia_smi_apps": apps,
            "spawn_s": spawn_s,
            "insert_pts_per_s": n / ins_s, "labels_s": labels_s,
            "round_trips": st["transport_round_trips"],
            "bytes_sent": st["transport_bytes_sent"],
            "bytes_received": st["transport_bytes_received"],
            "workers_on_card": True, "equal_a_host": True,
            "restore_local_equal": True, "card": card}


def _alive(pid: int) -> bool:
    import os

    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def run_sharded_failover(device: str, card: str) -> dict:
    """Phase 3e (c): ``transport="tcp"``, two shards of one primary and
    one replica each on the card, over Table 2's scale (blobs of
    20,000 x 10, batches of 1000, 25% deleted); shard 0's primary is
    killed after batch FAILOVER_KILL_AFTER as the reference's serving mix
    does; every request must succeed and the labels equal an in-process
    host oracle's; the lane must come back to two members."""
    import numpy as np

    from repro_torch.api import build_index
    from repro_torch.data import blobs

    X, _ = blobs(n=TABLE2_POINTS, d=D, n_clusters=10, seed=SEED)
    victims = np.random.default_rng(SEED + 3).permutation(
        TABLE2_POINTS)[:int(TABLE2_POINTS * DELETE_FRACTION)]
    cfg = sharded_cfg("soa-device", shards=2, workers=2, transport="tcp",
                      replicas=1)
    oracle = build_index(sharded_cfg("soa", shards=2, workers=0,
                                     transport="local"))
    t0 = time.perf_counter()
    ix = build_index(cfg, device=device)
    spawn_s = time.perf_counter() - t0
    pids = []
    try:
        pids = [mem.client._proc.pid for lane in ix.clients
                for mem in lane._members]
        lane = ix.clients[0]
        killed = None
        n_batches = TABLE2_POINTS // BATCH
        checks = 0
        for b in range(n_batches):
            Xb = X[b * BATCH:(b + 1) * BATCH]
            if ix.insert_batch(Xb) != oracle.insert_batch(Xb):
                raise AssertionError(f"3e (c) batch {b}: ids differ")
            if b + 1 == FAILOVER_KILL_AFTER:  # serving_mix._kill_one
                killed = lane._members[0].client._proc
                killed.kill()
                killed.wait(timeout=30)
            if b % 5 == 4:
                checks += 1
                if ix.labels() != oracle.labels():
                    raise AssertionError(f"3e (c) batch {b}: labels differ "
                                         "from the host oracle")
        for b in range(0, len(victims), BATCH):
            vb = [int(i) for i in victims[b:b + BATCH]]
            ix.delete_batch(vb)
            oracle.delete_batch(vb)
        if ix.labels() != oracle.labels():
            raise AssertionError("3e (c): labels at the end differ from "
                                 "the host oracle")
        deadline = time.monotonic() + 300
        while lane.n_members < 2 and time.monotonic() < deadline:
            ix.check_health()
            time.sleep(0.5)
        if lane.n_members != 2 or lane.n_repairs:
            raise AssertionError(f"3e (c): lane 0 has {lane.n_members} "
                                 "members after check_health()")
        pids = [mem.client._proc.pid for lane_ in ix.clients
                for mem in lane_._members]
        if device != "cpu" and not all(holds_card(p) for p in pids):
            raise AssertionError(f"3e (c): members {pids} not all on the "
                                 "card")
        for lane_ in ix.clients:  # shard invariants, replicas byte-equal
            lane_.check_invariants()
        metrics = ix.obs.snapshot()["metrics"]
        failover = {k: v["value"] for k, v in metrics.items()
                    if k.startswith(("failover.", "rpc."))
                    and "value" in v}
        if failover["failover.promotions"] < 1 or \
                failover["failover.resyncs"] < 1:
            raise AssertionError(f"3e (c): no promotion or resync: "
                                 f"{failover}")
        st = ix.stats()
    finally:
        ix.close()
        oracle.close()
    alive = [p for p in pids if _alive(p)]
    if alive:
        raise AssertionError(f"3e (c): workers {alive} outlived close()")
    return {"points": TABLE2_POINTS, "deleted": len(victims),
            "killed_after_batch": FAILOVER_KILL_AFTER,
            "killed_pid": killed.pid, "spawn_s": spawn_s,
            "label_checks": checks + 1, "counters": failover,
            "round_trips": st["transport_round_trips"],
            "members_pids": pids, "no_request_failed": True,
            "equal_host_oracle": True, "card": card}


def run_sharded_path(n_points: int, device: str, kept: dict, card: str):
    """Phase 3e: (a) local, (b) process, (c) tcp with a killed primary."""
    from repro_torch.data import DATASET_SPECS, blobs

    _n, d, n_clusters = DATASET_SPECS["blobs"]
    X, _y = blobs(n=n_points, d=d, n_clusters=n_clusters, seed=SEED)
    t0 = time.perf_counter()
    a, keep = run_sharded_local(X, kept, device, card)
    a["wall_s"] = time.perf_counter() - t0
    a["fanout_in_turns"] = fanout_in_turns(X, device, card)
    t0 = time.perf_counter()
    b = run_sharded_process(X, keep, device, card)
    b["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = run_sharded_failover(device, card)
    c["wall_s"] = time.perf_counter() - t0
    return {"a": a, "b": b, "c": c}


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
    out = {"points": n_points, "cut": n_points != TABLE2_POINTS,
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
    if not evs:
        print("device time: a profiler session traced no device activity",
              flush=True)
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
    kernel). A session may trace no device activity at all (CUPTI does
    not always deliver it); a kernel that ``PROFILE_TRIES`` sessions
    traced none of is timed with CUDA events instead, and the line
    printed says so."""
    out = {}
    for _try in range(PROFILE_TRIES):
        missing = {name: fn for name, fn in fns.items() if name not in out}
        if not missing:
            break

        def run():
            for fn in missing.values():
                for _ in range(reps):
                    fn()
        _wall, evs = device_events(run)
        for name in missing:
            by_fn = {}
            for ev, us in evs:
                if name in ev:
                    by_fn.setdefault(ev, []).append(us)
            if by_fn:
                out[name] = sum(sum(v) / len(v) for v in by_fn.values()) / 1e3
    for name, fn in fns.items():
        if name not in out:
            out[name] = time_ms(fn, reps=reps, warmup=1)
            print(f"device time: the profiler traced no {name} launch in "
                  f"{PROFILE_TRIES} sessions; its device_ms is CUDA events' "
                  f"{out[name]:.5f} ms over {reps} calls", flush=True)
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
    small_tag = f"_{len(x_base) // 1000}k"
    for tag, row in ((small_tag, small), ("_100k_54", wide)):
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
           **{f"bound_ms_all_pairs{small_tag}": bound(
               small["bytes"], small["ops_all_pairs"])[0]},
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


def attention_bound(b, hq, hkv, sq, skv, dh, window, elem_bytes,
                    causal=True):
    """(bound ms, bound_by, f32-core bound ms, flops, bytes) of one
    attention (causal: its unmasked pairs; else all sq * skv): 4 dh flops
    per computed pair and head (q.k and p.v) over the bf16 tensor-core
    peak, against one read of q, k, v and one write of the output over
    the memory rate."""
    pairs = unmasked_pairs(sq, skv, window) if causal else sq * skv
    flops = 4 * dh * pairs * b * hq
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
    cases plus decode rows, head_dim 16 / 96 / 128 / 256, ragged lengths
    and (on the card) the trainer's shapes; returns (max f32 err, max
    bf16 err, cases)."""
    import torch

    e32 = e16 = 0.0
    rows = FLASH_SWEEP + (FLASH_SWEEP_TRAIN if device != "cpu" else ())
    for b, hq, hkv, sq, skv, dh, causal, window in rows:
        g = torch.Generator(device=device).manual_seed(sq * 1000 + dh)
        q = torch.randn((b, hq, sq, dh), generator=g, device=device)
        k = torch.randn((b, hkv, skv, dh), generator=g, device=device)
        v = torch.randn((b, hkv, skv, dh), generator=g, device=device)
        a, c = flash_check(q, k, v, window, causal=causal,
                           q_offset=skv - sq if causal else 0)
        e32, e16 = max(e32, a), max(e16, c)
    return e32, e16, len(rows)


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


def teacher_forced_decode(m, params, toks, device):
    """Logits (n, vocab) of ``toks`` (1, n) fed one token a step through
    ``m.decode_step`` from empty caches at positions 0..n-1.  On the card
    the step is captured once in a CUDA graph and replayed, its new
    caches copied back into the captured ones after each replay: the
    same kernels in the same order, without the host dispatch of ~50
    small kernels a layer that makes an eager step 50-120 ms at full
    width."""
    import torch

    from repro_torch.optim.adamw import tree_leaves

    n = toks.shape[1]
    caches = m.decode_init(1, n)
    if device == "cpu":
        steps = []
        for t in range(n):
            step, caches = m.decode_step(params, caches, toks[:, t:t + 1],
                                         t)
            steps.append(step[0])
        return torch.stack(steps)
    tok = toks[:, :1].clone()
    pos = torch.zeros(1, dtype=torch.int32, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):       # warm up outside the capture
        m.decode_step(params, caches, tok, pos)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, new = m.decode_step(params, caches, tok, pos)
    pairs = list(zip(tree_leaves(caches), tree_leaves(new)))
    out = torch.empty((n, logits.shape[-1]), dtype=logits.dtype,
                      device=device)
    for t in range(n):
        tok.copy_(toks[:, t:t + 1])
        pos.fill_(t)
        graph.replay()
        out[t] = logits[0]
        for dst, src in pairs:
            dst.copy_(src)
    return out


def prefill_vs_decode(m32, params, toks, device, tol: float = LM_TOL):
    """f32 prefill logits of ``toks`` (1, n) against teacher-forced decode
    (plain torch, ``teacher_forced_decode``); returns (max abs err, within
    ``tol``, flash launches on the f32 route, decode seconds)."""
    import torch

    from repro_torch.kernels import ops

    n = toks.shape[1]
    with torch.inference_mode():
        ops.reset_launch_counts()
        full = m32.forward(params, {"tokens": toks})[0]
        _sync(device)
        f32_launches = ops.entry_launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        dec = teacher_forced_decode(m32, params, toks, device)
        _sync(device)
        dec_s = time.perf_counter() - t0
        err = float((dec - full).abs().max())
        ok = bool(torch.allclose(dec, full, atol=tol, rtol=tol))
    return err, ok, f32_launches, dec_s


def serve_clustered(model, params, sz, rng, device) -> dict:
    """``SERVE_REQUESTS`` requests (prompts of ``sz["prompt"]`` tokens,
    ``sz["new"]`` new tokens each, embeddings around two centres) through
    a ``ServingEngine`` of ``SERVE_BATCH`` slots with request clustering
    on ``soa-device``; every request must be served in full and, on the
    card, the clustering kernels launched.  Returns its numbers."""
    from repro_torch.kernels import ops
    from repro_torch.obs import make_obs
    from repro_torch.serving import Request, ServingEngine

    obs = make_obs(True)
    backend = "soa-device"
    eng = ServingEngine(model, params, batch=SERVE_BATCH,
                        kv_len=sz["serve_kv"], cluster_requests=True,
                        cluster_backend=backend, obs=obs)
    centres = rng.normal(size=(2, 8)) * 3
    lo, hi = sz["prompt"]
    prompts = [rng.integers(1, model.cfg.vocab_size,
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
    if device != "cpu":
        missing = [kn for kn in MAIN_KERNELS if serve_launches[kn] <= 0]
        if missing:
            raise AssertionError(f"request clustering launched no {missing}")
    return {
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
    err, ok, f32_launches, dec_s = prefill_vs_decode(m32, params, toks,
                                                     device)
    out["prefill_vs_decode"] = {"tokens": n, "window": cfg.window,
                                "max_abs_err": err, "tol": LM_TOL,
                                "flash_launches": f32_launches,
                                "decode_steps_s": dec_s,
                                "decode_ms_per_step_b1_f32": dec_s / n * 1e3,
            "decode_cuda_graph": on_card,
                                "decode_cuda_graph": on_card}
    print(f"lm: f32 prefill vs teacher-forced decode over {n} tokens: max "
          f"abs err {err:.3e} (tol {LM_TOL})", flush=True)
    if not ok:
        raise AssertionError(f"prefill and decode logits differ by {err}")
    if on_card and f32_launches != cfg.n_layers:
        raise AssertionError(f"f32 forward took flash_attention's f32 "
                             f"route {f32_launches} times")

    # 4. serving with request clustering on the card
    out["serving"] = serve_clustered(model, params, sz, rng, device)
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


#: the benchmark cells' attention, (b, hq, hkv, s, dh), causal
BWD_CELL_SHAPES = {
    "granite-20b.train_curated_1k": (8, 48, 1, 1024, 128),
    "granite-moe-1b-a400m.train_curated_4k": (8, 16, 8, 4096, 64),
    "granite-20b.train_curated_4k_b2": (2, 48, 1, 4096, 128),
}


def flash_backward_bound(b, hq, hkv, s, dh):
    """(bound ms, bound_by, flops, bytes) of one causal attention
    backward: five products, 10 dh flops per unmasked pair and query head,
    over the bf16 tensor-core peak, against one read of q, k, v, the
    output, dO and the log-sum-exp and one write of dq, dk, dv, over the
    memory rate."""
    flops = 10 * dh * unmasked_pairs(s, s, None) * b * hq
    nbytes = 2 * (4 * b * hq * s * dh + 4 * b * hkv * s * dh) + 4 * b * hq * s
    t_ops = flops / BF16_TC_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def _grad_rel_errs(got, want) -> list:
    """dq, dk, dv's norm-wise relative errors |got - want| / |want| (the
    largest entry's error sits at the bf16 output rounding on every
    route)."""
    return [float((g.float() - w).norm() / w.norm())
            for g, w in zip(got, want)]


def _f32_attention_grads(q, k, v, do) -> tuple:
    """(dq, dk, dv) in f32 of causal ``ref.attention`` at the f32 values
    of bf16 q, k, v against dO, a batch row at a time (rows are
    independent; one row's f32 scores and their graph fit the card)."""
    import torch

    from repro_torch.kernels import ref

    rows = []
    for i in range(q.shape[0]):
        f32 = [t[i:i + 1].float().requires_grad_() for t in (q, k, v)]
        rows.append(torch.autograd.grad(ref.attention(*f32, causal=True),
                                        f32, do[i:i + 1].float()))
        del f32
    return tuple(torch.cat(g) for g in zip(*rows))


def time_flash_backward(card: str, build: dict) -> dict:
    """The bf16 backward kernel (``attention_bwd_sm90``) at the benchmark
    cells' attention shapes: its time as the trainer calls it (``ms``,
    the partials' sum included) and its three kernels' device time,
    beside its bound, ``attention_vjp`` (the plain route it replaced,
    ``plain_ms``) and SDPA's backward (``library_ms``; the port never
    calls it).  The timed call's dq, dk, dv at the full shape, and
    ``attention_vjp``'s, against the f32 gradient of the same bf16 inputs
    (TF32 off); raises where the kernel's error is the larger in any of
    the three."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    for cell, (b, hq, hkv, s, dh) in BWD_CELL_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, do = (torch.randn((b, hq, s, dh), generator=g, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, dh), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        kw = {"causal": True, "window": None, "q_offset": 0, "scale": None}
        out, lse = fa.flash_attention(q, k, v, with_lse=True, causal=True)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                               enable_gqa=True)

        def lib_bwd(o_lib=o_lib, leaves=leaves, do=do):
            return torch.autograd.grad(o_lib, leaves, do, retain_graph=True)

        bound_ms, bound_by, flops, nbytes = flash_backward_bound(
            b, hq, hkv, s, dh)
        ops.reset_launch_counts()
        row = {
            "shape": [b, hq, s, dh], "kv_heads": hkv,
            "kv_splits": fa.kv_splits(
                b, hq, hkv, s,
                torch.cuda.get_device_properties(0).multi_processor_count),
            "ms": time_ms(lambda: fa.attention_bwd(q, k, v, out, lse, do,
                                                   **kw), reps=10, warmup=2),
            "device_ms": kernel_device_ms(
                {"attention_bwd_sm90": lambda: fa.attention_bwd(
                    q, k, v, out, lse, do, **kw)}, reps=3)[
                        "attention_bwd_sm90"],
            "plain_ms": time_ms(lambda: fa.attention_vjp(q, k, v, do, **kw),
                                reps=2, warmup=1),
            "library_ms": time_ms(lib_bwd, reps=10, warmup=2),
            "library_kernel": sdpa_backend(lib_bwd),
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes,
            "launches_timed": ops.launch_counts()["attention_bwd_sm90"],
        }
        del o_lib, leaves
        got = fa.attention_bwd(q, k, v, out, lse, do, **kw)
        plain = fa.attention_vjp(q, k, v, do, **kw)
        want = _f32_attention_grads(q, k, v, do)
        row["rel_errs"] = _grad_rel_errs(got, want)
        row["plain_rel_errs"] = _grad_rel_errs(plain, want)
        row["rel_err"] = max(row["rel_errs"])
        row["plain_rel_err"] = max(row["plain_rel_errs"])
        del got, plain, want
        if any(e > pe for e, pe in zip(row["rel_errs"],
                                       row["plain_rel_errs"])):
            raise AssertionError(f"attention_bwd_sm90 at {cell}'s shape: "
                                 f"dq, dk, dv error {row['rel_errs']} "
                                 f"above attention_vjp's "
                                 f"{row['plain_rel_errs']}")
        row["achieved_share_of_bound"] = bound_ms / row["device_ms"]
        cases[cell] = row
        print(f"attention_bwd_sm90 at {cell}'s {[b, hq, hkv, s, dh]}: "
              f"{row['ms']:.3f} ms ({row['device_ms']:.3f} device, "
              f"{row['kv_splits']} kv splits), attention_vjp "
              f"{row['plain_ms']:.2f}, SDPA backward {row['library_ms']:.3f}"
              f" ({row['library_kernel'][:50]}), bound {bound_ms:.3f} ms "
              f"({bound_by}); grad error {row['rel_err']:.2e} against "
              f"attention_vjp's {row['plain_rel_err']:.2e}  [{card}]",
              flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    first = cases["granite-20b.train_curated_1k"]
    return {
        "name": "attention_bwd_sm90", "route": "cuda",
        "source": KERNEL_SOURCES["flash_attention"][0],
        "replaces": "none: the reference differentiates chunked_attention "
                    "through XLA; on the card it replaces attention_vjp",
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"], "device_ms": first["device_ms"],
        "max_rel_err": max(c["rel_err"] for c in cases.values()),
        "max_plain_rel_err": max(c["plain_rel_err"]
                                 for c in cases.values()),
        "hgmma": {k: n for k, n in build["hgmma"].items() if "bwd" in k},
        "ptxas": {k: v for k, v in build["ptxas"].items()
                  if "attention_bwd" in k},
        "dtype": "bfloat16", "shape": first["shape"],
        "per_launch": "granite-20b.train_curated_1k's shape; the other "
                      "cells' in cases",
        "cases": cases, "card": card,
    }


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
    with torch.inference_mode():
        model.forward(params, {"tokens": toks})       # warm
        wall, evs = device_events(
            lambda: model.forward(params, {"tokens": toks}))
        pre = _top_ops(evs, wall)
    return {"prefill": {"tokens": ctx["prefill"], **pre},
            "decode_step": decode_step_profile(model, params,
                                               ctx["serve_kv"], rng, device)}


# ---------------------------------------------------------------------- #
# training path (phase 8): index checkpoints and curation on the card,
# the trainer at full width, the trainer's own protocol
# ---------------------------------------------------------------------- #
def index_checkpoint_path(n_points: int, device: str, kept: dict,
                          directory) -> dict:
    """8 (a): phase 3's stream on ``soa-device`` up to insert batch
    ``INDEX_SAVE_AT`` (held against phase 3's kept host results), saved
    through ``CheckpointManager.save_index``, restored onto ``device``;
    the restored index takes the remaining inserts and phase 3's deletes,
    every batch's deltas and ``labels()`` held against phase 3's."""
    from repro_torch.api import ClusterConfig, build_index
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DATASET_SPECS, blobs
    from repro_torch.kernels import ops

    _n, d, n_clusters = DATASET_SPECS["blobs"]
    X, _y = blobs(n=n_points, d=d, n_clusters=n_clusters, seed=SEED)
    n_batches = -(-n_points // BATCH)
    save_at = min(INDEX_SAVE_AT, n_batches // 2)
    batches = [(b * BATCH, min((b + 1) * BATCH, n_points))
               for b in range(n_batches)]
    check = against_kept(kept, "8 (a)")
    cfg = ClusterConfig(d=D, k=K, t=T, eps=EPS, seed=SEED,
                        backend="soa-device")
    index = build_index(cfg, device=device)
    index.drain_deltas()
    for b, (lo, hi) in enumerate(batches[:save_at]):
        ids = index.insert_batch(X[lo:hi])
        check("insert", b, (lo, hi), (ids, sorted(index.drain_deltas())))
    mgr = CheckpointManager(directory, async_write=False)
    t0 = time.perf_counter()
    mgr.save_index(save_at, index)
    save_s = time.perf_counter() - t0
    files = sorted((Path(directory) / f"index_{save_at:08d}").iterdir())
    nbytes = sum(f.stat().st_size for f in files)
    labels_saved = index.labels()
    del index
    t0 = time.perf_counter()
    rest = mgr.restore_index(device=device)
    _sync(device)
    restore_s = time.perf_counter() - t0
    if rest.labels() != labels_saved:
        raise AssertionError("8 (a): labels differ after save_index + "
                             "restore_index")
    rest.drain_deltas()  # the change feed starts, as phase 3's did

    def shifted(kind, b, arg, got):
        if kind == "insert":
            check(kind, b + save_at, arg, got)
        elif kind == "labels":
            if b + save_at in kept["labels"]:
                check(kind, b + save_at, arg, got)
        else:
            check(kind, b, arg, got)

    ops.reset_launch_counts()
    run = drive(rest, X, batches[save_at:], victims=kept["victims"],
                check=shifted)
    _sync(device)
    entries = ops.entry_launch_counts()
    left = n_batches - save_at
    if device != "cpu":
        want = {"lsh_hash_resolve": left, "bucket_insert_pass": left}
        got = {k: entries[k] for k in want}
        if got != want:
            raise AssertionError(f"8 (a): kernel entries on the restored "
                                 f"index {got}, expected {want}")
    return {"points": n_points, "saved_after_batch": save_at,
            "save_s": save_s, "restore_s": restore_s, "bytes": nbytes,
            "files": [f.name for f in files],
            "restored_insert_batches": left,
            "restored_delete_batches": -(-len(kept["victims"]) // BATCH),
            "insert_pts_per_s": run["inserted"] / run["insert_s"],
            "delete_pts_per_s": (run["deleted"] / run["delete_s"]
                                 if run["delete_s"] else None),
            "entry_launches": {k: entries[k] for k in MAIN_ENTRIES},
            "equal_to_phase_3": True}


def curation_path(device: str, batches: int, card: str) -> dict:
    """8 (b): the trainer's curation (``launch/train.py``'s settings) over
    its stream on ``soa-device`` (``device``) beside a host ``soa`` twin.
    Every batch the keep masks, the ids and ``labels()`` of the two
    windows must be equal (under ``balance`` on this stream the mask keeps
    every row, so the labels are what hold the device index); at the last
    batch ``pass_check`` holds both kernels bit-exact against their plain
    versions on the inputs they launched on."""
    import numpy as np

    from repro_torch.api import NOISE
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import CurationFilter, SyntheticTokenStream
    from repro_torch.kernels import ops

    stream = SyntheticTokenStream(get_config(TRAIN_ARCH).vocab_size,
                                  CURATION_SEQ, CURATION_BATCH, seed=1)
    src = iter(stream)
    kw = dict(d=stream.embed_dim, **CURATION)
    dev = CurationFilter(backend="soa-device", device=device, **kw)
    host = CurationFilter(backend="soa", **kw)
    ops.reset_launch_counts()
    dev_s = host_s = 0.0
    for b in range(batches):
        e = next(src)["embeddings"]
        if b == batches - 1:
            passes = keep_passes(dev.index.engine)
        t0 = time.perf_counter()
        keep = dev.filter(e)
        dev_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        want = host.filter(e)
        host_s += time.perf_counter() - t0
        if not np.array_equal(keep, want):
            raise AssertionError(f"8 (b): keep mask {b} differs from the "
                                 "host soa twin's")
        if dev._fifo[-len(e):] != host._fifo[-len(e):]:
            raise AssertionError(f"8 (b): batch {b}: ids differ from the "
                                 "host soa twin's")
        labels = dev.index.labels()
        if labels != host.index.labels():
            raise AssertionError(f"8 (b): batch {b}: labels() differ from "
                                 "the host soa twin's")
    _sync(device)
    entries = ops.entry_launch_counts()
    if device != "cpu":
        want = {"lsh_hash_resolve": batches, "bucket_insert_pass": batches}
        got = {k: entries[k] for k in want}
        if got != want:
            raise AssertionError(f"8 (b): kernel entries {got}, expected "
                                 f"{want}")
    check = pass_check(passes, dev.index.engine, card, "8 (b)")
    return {"batches": batches, "batch": CURATION_BATCH, **CURATION,
            "seen": dev.n_seen, "kept": dev.n_kept,
            "window_points": len(dev.index),
            "clusters": len(set(labels.values()) - {NOISE}),
            "noise_points": sum(v == NOISE for v in labels.values()),
            "device_ms_per_batch": dev_s / batches * 1e3,
            "host_soa_ms_per_batch": host_s / batches * 1e3,
            "entry_launches": {k: entries[k] for k in MAIN_ENTRIES},
            "masks_ids_labels_equal": True, "pass_check": check}


@contextlib.contextmanager
def attention_swapped(wrap):
    """Within the block the model's attention is ``wrap(ops.attention)``;
    ``ops.attention`` again after it."""
    from repro_torch.kernels import ops

    fn = ops.attention
    ops.attention = wrap(fn)
    try:
        yield
    finally:
        ops.attention = fn


def plain_attention():
    """Within the block the model's attention runs the plain version
    (``impl="ref"``) on any device; the kernel again after it."""
    return attention_swapped(lambda fn: functools.partial(fn, impl="ref"))


def planted_fault(kind: str):
    """Within the block the model's attention is the kernel's with a
    planted fault the size of one tile (``FAULT_TILE`` rows or keys):
    ``"rows"`` zeroes every head's last query tile; ``"keys"`` drops the
    first key tile from the last query tile's view (a sliding window of
    seq - FAULT_TILE; at most half the sequence on short ones)."""
    import torch

    def rows(fn):
        def attend(q, k, v, **kw):
            out = fn(q, k, v, **kw)
            keep = torch.ones((out.shape[-2], 1), dtype=out.dtype,
                              device=out.device)
            keep[-FAULT_TILE:] = 0
            return out * keep
        return attend

    def keys(fn):
        def attend(q, k, v, **kw):
            s = q.shape[-2]
            return fn(q, k, v, **{**kw, "window": max(s - FAULT_TILE,
                                                      s // 2)})
        return attend
    return attention_swapped({"rows": rows, "keys": keys}[kind])


def step_one(model, params, batch) -> dict:
    """One forward and backward at ``params`` on ``batch`` with the
    model's attention as it stands: the loss, the global gradient norm,
    and which leaves (in ``tree_leaves`` order) got a gradient that is
    not finite or is zero everywhere."""
    import torch

    from repro_torch.optim.adamw import global_norm, tree_leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss(live, batch)
    loss.backward()
    grads = [p.grad for p in tree_leaves(live)]
    sound = torch.stack([torch.isfinite(g).all() & (g != 0).any()
                         for g in grads]).cpu()
    return {"loss": float(loss.detach()),
            "grad_norm": float(global_norm(grads)),
            "leaves": len(grads),
            "bad_leaves": [i for i, ok in enumerate(sound) if not ok]}


def rel_errs(got: dict, want: dict) -> dict:
    return {f"{k}_rel_err": abs(got[k] - want[k]) / abs(want[k])
            for k in ("loss", "grad_norm")}


def train_sizes(device: str) -> dict:
    """Phase 8 (c)'s and (d)'s sizes: on the card granite-20b at its
    published widths with depth cut to ``TRAIN_LAYERS``; on the CPU
    (tests) its smoke config and short sequences."""
    if device == "cpu":
        return {"smoke": True, "batch": 2, "seq": 32, "steps": 4,
                "protocol": ["--smoke", "--batch", "4", "--seq", "32"],
                "curation_batches": 40}
    return {"smoke": False, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "protocol": ["--preset", "100m"],
            "curation_batches": CURATION_BATCHES}


def train_config(smoke: bool):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    if smoke:
        return cfg.smoke()
    return dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)


def first_batch(cfg, args) -> dict:
    """The first batch ``train`` takes: the same stream, curation and
    pipeline, built again."""
    from repro_torch.data.pipeline import (CurationFilter, Pipeline,
                                           SyntheticTokenStream)

    src = SyntheticTokenStream(cfg.vocab_size, args.seq, args.batch, seed=1)
    pipe = Pipeline(iter(src), curation=CurationFilter(
        d=src.embed_dim, k=8, t=8, eps=0.6, policy=args.curation,
        window=20_000))
    batch = next(pipe)
    pipe.close()
    return batch


def train_path(device: str, directory) -> dict:
    """8 (c): ``launch.train.train`` at ``TRAIN_ARCH``'s widths, depth cut,
    ``--batch 8 --seq 1024 --curation balance`` for ``TRAIN_STEPS``
    steps, from weights drawn from ``SEED``.  Step 1's loss and gradient
    norm are held against the same step with the plain attention; in a
    step-1 pass of its own with the kernel every parameter must get a
    finite, nonzero gradient; two more passes read what a planted fault
    does to step 1 (``planted_fault``); flash launches must be layers x 2
    (the remat recompute) a step, on the tensor-core route; then one more
    step under the profiler."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as trainer
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training import make_train_step

    sz = train_sizes(device)
    on_card = device != "cpu"
    cfg = train_config(sz["smoke"])
    args = trainer.parse_args([
        "--arch", TRAIN_ARCH, "--batch", str(sz["batch"]), "--seq",
        str(sz["seq"]), "--curation", "balance", "--steps",
        str(sz["steps"]), "--device", device, "--ckpt-dir", str(directory),
        "--ckpt-every", str(10**9)])
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(SEED)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    b0 = first_batch(cfg, args)
    tb = {k: torch.from_numpy(b0[k]).to(device, torch.long)
          for k in ("tokens", "labels")}

    # step 1 with the plain attention, with the kernel (every leaf's
    # gradient finite and nonzero), and with each planted fault
    with plain_attention():
        ref = step_one(model, params, tb)
    kern = step_one(model, params, tb)
    if kern["bad_leaves"]:
        raise AssertionError(f"8 (c): parameter leaves {kern['bad_leaves']}"
                             " (in tree_leaves order) got no finite "
                             "nonzero gradient")
    faults = {}
    for kind in ("rows", "keys"):
        with planted_fault(kind):
            faults[kind] = rel_errs(step_one(model, params, tb), ref)
        if (faults[kind]["loss_rel_err"] <= TRAIN_LOSS_RTOL
                and faults[kind]["grad_norm_rel_err"] <= TRAIN_GNORM_RTOL):
            raise AssertionError(f"8 (c): step 1 with a planted fault "
                                 f"({kind}) is within the bounds: "
                                 f"{faults[kind]}")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    steps = trainer.train(cfg, args, params=params)
    _sync(device)
    launches = ops.launch_counts()["flash_attention"]
    tc = ops.entry_launch_counts()["flash_attention_sm90"]
    bwd = backward_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    want = sz["steps"] * cfg.n_layers * (2 if cfg.remat else 1)
    if on_card and (launches != want or tc != want):
        raise AssertionError(f"8 (c): flash_attention launched {launches} "
                             f"times ({tc} on the tensor cores) in "
                             f"{sz['steps']} steps, expected {want}")
    if on_card:
        check_backward("8 (c)", bwd, sz["steps"] * cfg.n_layers)
    losses = [m["loss"] for m in steps]
    err = rel_errs(steps[0], ref)
    if (err["loss_rel_err"] > TRAIN_LOSS_RTOL
            or err["grad_norm_rel_err"] > TRAIN_GNORM_RTOL):
        raise AssertionError(
            f"8 (c): step 1 differs from the plain attention's: loss "
            f"{losses[0]} vs {ref['loss']} (rel {err['loss_rel_err']}, tol "
            f"{TRAIN_LOSS_RTOL}), grad norm {steps[0]['grad_norm']} vs "
            f"{ref['grad_norm']} (rel {err['grad_norm_rel_err']}, tol "
            f"{TRAIN_GNORM_RTOL})")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"8 (c): losses {losses}")
    step_s = [m["seconds"] for m in steps]
    timed = step_s[2:] or step_s
    tokens = sz["batch"] * sz["seq"]
    med = float(np.median(timed))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.padded_vocab, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "remat": cfg.remat,
           "params": n_params, "init_s": init_s, "batch": sz["batch"],
           "seq": sz["seq"], "steps": sz["steps"], "losses": losses,
           "grad_norms": [m["grad_norm"] for m in steps], "step_s": step_s,
           "step_ms_median_3_on": med * 1e3, "tokens_per_s": tokens / med,
           "model_tflops_6nd": 6 * n_params * tokens / med / 1e12,
           "peak_bytes": peak, "flash_launches": launches,
           "flash_sm90_launches": tc, "bwd_launches": bwd,
           "flash_launches_per_step": launches / sz["steps"],
           "step1": {"loss": losses[0], "ref_loss": ref["loss"],
                     "loss_tol": TRAIN_LOSS_RTOL,
                     "grad_norm": steps[0]["grad_norm"],
                     "ref_grad_norm": ref["grad_norm"],
                     "grad_norm_tol": TRAIN_GNORM_RTOL, **err,
                     "kernel_pass": rel_errs(kern, ref),
                     "planted_faults": faults},
           "grads_finite_nonzero": kern["leaves"]}

    # one more step under the profiler, with a fresh optimizer
    if on_card:
        opt = AdamW(lr=warmup_cosine(args.lr, 20, 100))
        state = opt.init(params)
        step_fn = make_train_step(model, opt, grad_accum=1)
        step_fn(params, state, tb)
        _sync(device)
        wall, evs = device_events(lambda: step_fn(params, state, tb))
        out["profile_step"] = _top_ops(evs, wall)
        del state, step_fn
    del params
    return out


def train_protocol(device: str, directory) -> dict:
    """8 (d): the reference trainer's own test protocol through
    ``launch.train.main``: 30 steps at ``--lr 1e-2`` with a checkpoint
    every 10, then ``--resume`` to 32; the loss must fall (mean of the
    last 5 below the mean of the first 3) and the resume take 2 steps."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import train as trainer

    sz = train_sizes(device)
    base = ["--arch", TRAIN_ARCH, *sz["protocol"], "--lr", "1e-2",
            "--ckpt-every", "10", "--ckpt-dir", str(directory), "--device",
            device]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = trainer.main([*base, "--steps", "30"])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses2 = trainer.main([*base, "--steps", "32", "--resume"])
    resume_s = time.perf_counter() - t0
    _sync(device)
    launches = ops.launch_counts()["flash_attention"]
    bwd = backward_counts()
    if not np.mean(losses[-5:]) < np.mean(losses[:3]):
        raise AssertionError(f"8 (d): loss did not fall: {losses}")
    if len(losses2) != 2:
        raise AssertionError(f"8 (d): the resumed run took {len(losses2)} "
                             "steps, expected 2")
    cfg = trainer.config_of(trainer.parse_args(base))
    want = 32 * cfg.n_layers * (2 if cfg.remat else 1)
    if device != "cpu" and launches != want:
        raise AssertionError(f"8 (d): flash_attention launched {launches} "
                             f"times, expected {want}")
    if device != "cpu":
        check_backward("8 (d)", bwd, 32 * cfg.n_layers)
    ckpt = Path(directory) / cfg.name
    return {"config": sz["protocol"], "params": cfg.n_params(),
            "losses": losses, "resumed_losses": losses2,
            "first_3_mean": float(np.mean(losses[:3])),
            "last_5_mean": float(np.mean(losses[-5:])),
            "run_s": first_s, "resume_run_s": resume_s,
            "flash_launches": launches, "bwd_launches": bwd,
            "checkpoints": sorted(p.name for p in ckpt.glob("step_*")),
            "checkpoint_bytes": sum(f.stat().st_size
                                    for f in ckpt.rglob("*") if f.is_file())}


def flash_at_train_shape(device: str, card: str) -> dict:
    """The flash kernel at the trainer's attention shape (8, 48, 1,024,
    128 with one kv head) against its plain version (bf16 within one ulp,
    f32 within 2e-5), timed beside its plain version, SDPA and the
    bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    cfg = train_config(False)
    b, hq, hkv, s, dh = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads,
                         TRAIN_SEQ, cfg.resolved_head_dim)
    g = torch.Generator(device=device).manual_seed(SEED)
    q32 = torch.randn((b, hq, s, dh), generator=g, device=device)
    k32 = torch.randn((b, hkv, s, dh), generator=g, device=device)
    v32 = torch.randn((b, hkv, s, dh), generator=g, device=device)
    e32, e16 = flash_check(q32, k32, v32, None)
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    bound_ms, bound_by, *_ = attention_bound(b, hq, hkv, s, s, dh, None, 2)
    return {"shape": [b, hq, s, dh], "kv_heads": hkv, "window": None,
            "max_abs_err": e16, "max_abs_err_f32": e32,
            "ms": time_ms(lambda: ops.attention(q, k, v), reps=10,
                          warmup=2),
            "plain_ms": time_ms(lambda: ops.attention(q, k, v, impl="ref"),
                                reps=3, warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps=10,
                warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by, "card": card}


def run_train_phase(n_points: int, device: str, kept: dict,
                    card: str) -> dict:
    """Phase 8, (a) to (d), each in a temporary directory of its own."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        out["a"] = index_checkpoint_path(n_points, device, kept, d)
        out["a"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = curation_path(device, train_sizes(device)["curation_batches"],
                             card)
    out["b"]["wall_s"] = time.perf_counter() - t0
    gc.collect()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        out["c"] = train_path(device, d)
        out["c"]["wall_s"] = time.perf_counter() - t0
    gc.collect()
    if device != "cpu":
        import torch

        torch.cuda.empty_cache()
        out["c"]["flash_at_train_shape"] = flash_at_train_shape(device, card)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        out["d"] = train_protocol(device, d)
        out["d"]["wall_s"] = time.perf_counter() - t0
    out["card"] = card
    return out


# ---------------------------------------------------------------------- #
# families path: the moe, vlm, ssm, hybrid and audio archs on the card
# ---------------------------------------------------------------------- #
def family_sizes(device: str) -> dict:
    """Phase 9's sizes: on the card the published widths (FAMILY_RUNS);
    on the CPU (tests) each arch's smoke config with sequences cut by
    ``scale``."""
    if device == "cpu":
        return {"smoke": True, "scale": 32, "frames": 48, "check": 40,
                "serve_kv": 96, "prompt": (8, 40), "new": 4,
                "time_reps": 1}
    return {"smoke": False, "scale": 1, "frames": AUDIO_FRAMES,
            "check": FAMILY_CHECK_TOKENS, "serve_kv": SERVE_KV,
            "prompt": FAMILY_SERVE_PROMPT,
            "new": SERVE_NEW_TOKENS, "time_reps": 3}


def family_config(arch: str, layers, smoke: bool, dtype: str = "bfloat16"):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    changes = {"dtype": dtype}
    if layers:      # a depth cut; a smoke config is shallower already
        changes["n_layers"] = min(layers, cfg.n_layers)
    return dataclasses.replace(cfg, **changes)


def attention_calls(cfg) -> int:
    """Full-sequence attention calls of one forward, each one flash
    launch: one a layer for dense, vlm, moe and hybrid, none for ssm,
    the encoder's layers plus two a decoder layer (self and cross) for
    audio."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def backward_counts() -> dict:
    """The attention backward since the last reset of the launch counts:
    ``attention_bwd_sm90`` launches and backwards on the card that took
    ``attention_vjp``."""
    from repro_torch.kernels import ops

    return {"kernel": ops.launch_counts()["attention_bwd_sm90"],
            "plain": ops.plain_on_card_counts()["attention_vjp"]}


def check_backward(where: str, got: dict, want: int) -> None:
    """Every one of ``want`` bf16 attention backwards ran the kernel."""
    if got != {"kernel": want, "plain": 0}:
        raise AssertionError(f"{where}: attention backward {got}, expected "
                             f"{want} attention_bwd_sm90 launches and no "
                             "attention_vjp")


def family_batch(cfg, text: int, frames: int, rng, device) -> dict:
    """One sequence: ``text`` tokens, a vlm's patches, audio's frames
    (unit normal, as stub embeddings)."""
    import numpy as np
    import torch

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)

    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, text))).to(device)}
    if cfg.family == "vlm":
        batch["patches"] = normal(1, cfg.n_patches, cfg.d_vision)
    if cfg.family == "audio":
        batch["frames"] = normal(1, frames, cfg.d_model)
    return batch


def decode_step_profile(model, params, serve_kv: int, rng,
                        device: str) -> dict:
    """Top device operations and the busy share of one fused decode step
    of the serving batch (every row active, rows at different
    positions)."""
    import torch

    cfg = model.cfg
    caches = model.decode_init(SERVE_BATCH, serve_kv)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (SERVE_BATCH, 1))).to(device)
    pos = torch.arange(SERVE_BATCH, device=device, dtype=torch.int32) * 16
    act = torch.ones(SERVE_BATCH, dtype=torch.bool, device=device)
    with torch.inference_mode():
        model.decode_step(params, caches, tok, pos, act)       # warm
        wall, evs = device_events(
            lambda: model.decode_step(params, caches, tok, pos, act))
    return {"batch": SERVE_BATCH, "kv_len": serve_kv, **_top_ops(evs, wall)}


def run_family(arch: str, layers, text: int, sz: dict, rng, device: str,
               card: str) -> dict:
    """One arch of phase 9: a bf16 forward (flash launches equal to its
    attention calls, all on the tensor-core route; finite logits of the
    expected shape), clustered serving, and, per arch, f32 prefill
    against decode and a profiled decode step."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model

    on_card = device != "cpu"
    cfg = family_config(arch, layers, sz["smoke"])
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(SEED)
    _sync(device)
    n_params = sum(t.numel() for t in _leaves(params))
    out = {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
           "layers_published": family_config(arch, None, False).n_layers,
           "n_encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "n_experts": cfg.n_experts, "top_k": cfg.top_k,
           "ssm_state": cfg.ssm_state, "ssm_heads": cfg.ssm_heads,
           "vocab": cfg.padded_vocab, "params": n_params,
           "init_s": time.perf_counter() - t0}
    batch = family_batch(cfg, text, sz["frames"], rng, device)
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    want = attention_calls(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with torch.inference_mode():
        logits = model.forward(params, batch)
        _sync(device)
        launches = ops.launch_counts()["flash_attention"]
        tc = ops.entry_launch_counts()["flash_attention_sm90"]
        if on_card and (launches != want or tc != want):
            raise AssertionError(f"{arch}: flash_attention launched "
                                 f"{launches} times ({tc} on the tensor-core"
                                 f" route) in one forward, expected {want}")
        if tuple(logits.shape) != (1, n_prefix + text, cfg.padded_vocab):
            raise AssertionError(f"{arch}: logits {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: prefill logits are not finite")
        del logits
        walls = []
        for _ in range(sz["time_reps"]):
            t0 = time.perf_counter()
            model.forward(params, batch)
            _sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
    tokens = n_prefix + text
    out.update({"prefill_text_tokens": text, "prefill_prefix": n_prefix,
                "encoder_frames": (sz["frames"] if cfg.family == "audio"
                                   else 0),
                "attention_calls": want, "flash_launches_per_forward":
                launches, "flash_tensor_core_launches_per_forward": tc,
                "prefill_ms": walls, "prefill_logits_finite": True,
                "prefill_tokens_per_s": tokens / (min(walls) / 1e3)})
    if on_card:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del batch
    out["serving"] = serve_clustered(model, params, sz, rng, device)
    if on_card and arch in FAMILY_PROFILE_ARCHS:
        out["decode_profile"] = decode_step_profile(
            model, params, sz["serve_kv"], rng, device)
    if arch in FAMILY_CHECK_TOL:
        tol = FAMILY_CHECK_TOL[arch]
        cfg32 = family_config(arch, layers, sz["smoke"], "float32")
        m32 = build_model(cfg32, device=device)
        n = sz["check"]
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, n))).to(device)
        err, ok, f32_launches, dec_s = prefill_vs_decode(m32, params, toks,
                                                         device, tol)
        out["prefill_vs_decode"] = {
            "tokens": n, "max_abs_err": err, "tol": tol,
            "flash_launches": f32_launches, "decode_steps_s": dec_s,
            "decode_ms_per_step_b1_f32": dec_s / n * 1e3,
            "decode_cuda_graph": on_card,
            "first_mixer": mixer_vs_recurrence(
                params["layers"][0]["ssm"], cfg32, n, device)}
        if not ok:
            raise AssertionError(f"{arch}: f32 prefill and decode logits "
                                 f"differ by {err} (tol {tol})")
        if on_card and f32_launches != want:
            raise AssertionError(f"{arch}: the f32 forward took "
                                 f"flash_attention's f32 route "
                                 f"{f32_launches} times, expected {want}")
    sv = out["serving"]
    cut = ("" if cfg.n_layers == out["layers_published"] else
           f" (CUT from {out['layers_published']})")
    print(f"families: {arch} ({cfg.family}) {cfg.n_layers} layers{cut}, "
          f"{n_params / 1e9:.3f} B params {cfg.param_dtype}; bf16 prefill "
          f"{tokens} tokens: {min(walls):.2f} ms, flash launches "
          f"{launches} of {want} attention calls (sm90 {tc}); serving "
          f"{sv['tokens_per_s']:.1f} tokens/s, step p50 / p99 "
          f"{sv['step_us_p50'] / 1e3:.2f} / {sv['step_us_p99'] / 1e3:.2f} "
          f"ms" + (f"; f32 prefill vs decode over "
                   f"{out['prefill_vs_decode']['tokens']} tokens: max abs "
                   f"err {out['prefill_vs_decode']['max_abs_err']:.3e}"
                   if "prefill_vs_decode" in out else "")
          + f"  [{card}]", flush=True)
    return out


def mixer_vs_recurrence(p, cfg, n: int, device: str) -> dict:
    """One Mamba-2 mixer in f32 (TF32 off): ``mamba2_block`` (the chunked
    scan) against ``mamba2_decode`` (the recurrence) over ``n`` tokens of
    unit-normal input, within the reference's ``LM_TOL``."""
    import torch

    from repro_torch.models import ssm as S

    g = torch.Generator(device=device).manual_seed(SEED)
    u = torch.randn((1, n, cfg.d_model), generator=g, device=device)
    with torch.inference_mode():
        full = S.mamba2_block(p, u, cfg, torch.float32)
        cache = S.init_ssm_cache(cfg, 1, torch.float32, device)
        steps = []
        for t in range(n):
            y, cache = S.mamba2_decode(p, u[:, t:t + 1], cache, cfg,
                                       torch.float32)
            steps.append(y)
        dec = torch.cat(steps, dim=1)
        err = float((dec - full).abs().max())
        if not bool(torch.allclose(dec, full, atol=LM_TOL, rtol=LM_TOL)):
            raise AssertionError(f"{cfg.name}: the mixer's scan and its "
                                 f"recurrence differ by {err}")
    return {"tokens": n, "max_abs_err": err, "tol": LM_TOL,
            "max_abs": float(dec.abs().max())}


def serve_defaults(device: str) -> dict:
    """``python -m repro_torch.launch.serve`` through ``main()`` with its
    defaults (``mamba2-780m`` at full width on the card; its smoke config
    on the CPU): every request served, each with its ``--max-new``
    tokens."""
    from repro_torch.launch import serve

    argv = [] if device != "cpu" else ["--smoke", "--device", "cpu"]
    requests, max_new = 12, 8   # its --requests and --max-new defaults
    t0 = time.perf_counter()
    done = serve.main(argv)
    wall = time.perf_counter() - t0
    gen = sum(len(r.out_tokens) for r in done.values())
    if sorted(done) != list(range(requests)) or gen != requests * max_new:
        raise AssertionError(f"launch.serve served {sorted(done)} with "
                             f"{gen} tokens")
    return {"argv": argv, "requests": len(done), "generated_tokens": gen,
            "wall_s": wall}


def flash_at_family_shapes(device: str, card: str) -> list:
    """The flash kernel against its plain version at the shapes phase 9
    gives it first (FLASH_FAMILY_SHAPES): bf16 within one ulp, f32
    within 2e-5, each timed beside its plain version, SDPA and the
    bound.  On the card only, as FLASH_SWEEP_TRAIN: on the CPU the
    "kernel" is the plain version itself (an empty list)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    rows = []
    if device == "cpu":
        return rows
    for tag, b, hq, hkv, sq, skv, dh, causal in FLASH_FAMILY_SHAPES:
        g = torch.Generator(device=device).manual_seed(sq * 1000 + dh)
        q32 = torch.randn((b, hq, sq, dh), generator=g, device=device)
        k32 = torch.randn((b, hkv, skv, dh), generator=g, device=device)
        v32 = torch.randn((b, hkv, skv, dh), generator=g, device=device)
        e32, e16 = flash_check(q32, k32, v32, None, causal=causal)
        row = {"tag": tag, "shape": [b, hq, sq, dh], "kv_heads": hkv,
               "skv": skv, "causal": causal, "max_abs_err": e16,
               "tol": FLASH_BF16_TOL, "max_abs_err_f32": e32,
               "tol_f32": FLASH_F32_TOL}
        q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        bound_ms, bound_by, *_ = attention_bound(
            b, hq, hkv, sq, skv, dh, None, 2, causal=causal)
        row.update({
            "ms": time_ms(lambda: ops.attention(q, k, v, causal=causal),
                          reps=10, warmup=2),
            "plain_ms": time_ms(lambda: ops.attention(
                q, k, v, causal=causal, impl="ref"), reps=3, warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps=10,
                warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by, "card": card})
        rows.append(row)
        del q, k, v, q32, k32, v32
    return rows


def run_families_phase(device: str, card: str) -> dict:
    """Phase 9: every arch of FAMILY_RUNS (``run_family``), then
    ``launch.serve``'s defaults, then the flash kernel at the phase's new
    shapes; each arch's model is freed before the next is built."""
    import numpy as np
    import torch

    sz = family_sizes(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 prefill vs decode
    rng = np.random.default_rng(SEED + 9)
    t0 = time.perf_counter()
    out = {"archs": {}}
    for arch, layers, text in FAMILY_RUNS:
        ta = time.perf_counter()
        out["archs"][arch] = run_family(arch, layers, text // sz["scale"],
                                        sz, rng, device, card)
        out["archs"][arch]["wall_s"] = time.perf_counter() - ta
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    out["serve_defaults"] = serve_defaults(device)
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    out["flash_shapes"] = flash_at_family_shapes(device, card)
    out["wall_s"] = time.perf_counter() - t0
    out["card"] = card
    return out


# ---------------------------------------------------------------------- #
# cells path: the reference's (arch x shape) grid on the card
# ---------------------------------------------------------------------- #
def cell_grid() -> list:
    """(arch, [shape ids in run order]) for every arch: prefill_32k,
    decode_32k, long_500k where ``cell_supported`` allows it, and
    train_4k for one arch of each family (CELL_TRAIN_ARCHS), last,
    because the train step updates the arch's weights in place."""
    from repro_torch.configs import ARCH_IDS, cell_supported

    grid = []
    for arch in ARCH_IDS:
        shapes = [s for s in ("prefill_32k", "decode_32k", "long_500k")
                  if cell_supported(arch, s)[0]]
        if arch in CELL_TRAIN_ARCHS:
            shapes.append("train_4k")
        grid.append((arch, shapes))
    return grid


def cell_sizes(arch: str, shape_id: str, device: str):
    """The cut (config, shape) of one cell: on the card the published
    widths with CELL_CUTS' depth and batch; on the CPU (tests) the smoke
    config and short sequences (CELL_SMOKE_SHAPES)."""
    import dataclasses

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import at_depth

    cfg, shape = get_config(arch), get_shape(shape_id)
    layers, batch = CELL_CUTS.get((arch, shape_id), (None, None))
    if device == "cpu":
        cfg = cfg.smoke()
        seq, batch = CELL_SMOKE_SHAPES[shape_id]
        shape = dataclasses.replace(shape, seq_len=seq)
        layers = min(layers, cfg.n_layers) if layers else None
    if layers:
        cfg = at_depth(cfg, layers)
    if batch:
        shape = dataclasses.replace(shape, global_batch=batch)
    return cfg, shape


def layers_view(params, cfg):
    """``params`` (drawn at the arch's deepest cut) with each layer stack
    cut to ``cfg``'s depth: the same tensors, no copy."""
    out = dict(params)
    for key, n in (("layers", cfg.n_layers), ("dec_layers", cfg.n_layers),
                   ("enc_layers", cfg.n_encoder_layers)):
        if key in out:
            out[key] = out[key][:n]
    return out


def shape_only_attention(fn):
    """An attention that allocates only its output, as the flash kernel
    does: a prefill analysed on ``meta`` with it counts everything but
    the attention itself, where ``ops.attention`` would take the plain
    version and count its score matrices."""
    import torch

    def attend(q, k, v, **kw):
        return torch.empty_like(q)
    return attend


def prefill_attention_calls(cfg, shape) -> list:
    """(b, hq, hkv, sq, skv, dh, window, causal) of each attention call of
    a prefill forward, in order: one a layer (its window) for the
    attention families; the encoder's, then each decoder layer's self and
    cross attention for audio."""
    b, S = shape.global_batch, shape.seq_len
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.family == "ssm":
        return []
    if cfg.family == "audio":
        t = max(S // 4, 8)
        return ([(b, hq, hkv, S, S, dh, None, False)] * cfg.n_encoder_layers
                + [(b, hq, hkv, t, t, dh, None, True),
                   (b, hq, hkv, t, S, dh, None, False)] * cfg.n_layers)
    from repro_torch.models.transformer import layer_metadata

    return [(b, hq, hkv, S, S, dh, w, True)
            for w in layer_metadata(cfg)["window"]]


def cell_reckoning(arch: str, shape_id: str, cfg, shape) -> dict:
    """The cut cell analysed on ``meta`` before it runs: FLOPs and bytes as
    the reference's analysis counts them (the plain attention's every
    score), their H100 roofline bound, ``state_bytes`` and the predicted
    peak.  For a prefill the peak and a second bound, ``kernel_bound_ms``,
    take the flash kernel's path: the cell analysed with
    ``shape_only_attention``, plus each attention call's least work as
    ``attention_bound`` counts it (its unmasked pairs; q, k, v read and
    the output written once).  An ssm prefill runs no attention: its one
    path is both."""
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.roofline import roofline_row

    def bound(flops, nbytes):
        row = roofline_row({"arch": arch, "shape": shape_id, "mesh": "",
                            "chips": 1, "flops_per_device": flops,
                            "hbm_bytes_per_device": nbytes})
        return row["bound_time_s"] * 1e3, ("operations"
                                           if row["dominant"] == "compute"
                                           else "bytes")

    rec = analyze_cell(arch, shape_id, cfg=cfg, shape=shape)
    out = {"flops": rec["flops_per_device"],
           "hbm_bytes": rec["hbm_bytes_per_device"],
           "state_bytes": rec["state_bytes"],
           "predicted_peak_bytes": rec["peak_bytes_per_device"],
           "grad_accum": rec.get("grad_accum")}
    out["bound_ms"], out["bound_by"] = bound(out["flops"], out["hbm_bytes"])
    if shape.kind == "prefill" and cfg.family != "ssm":
        with attention_swapped(shape_only_attention):
            rest = analyze_cell(arch, shape_id, cfg=cfg, shape=shape)
        flops, nbytes = rest["flops_per_device"], rest["hbm_bytes_per_device"]
        for b, hq, hkv, sq, skv, dh, window, causal in \
                prefill_attention_calls(cfg, shape):
            flops += attention_bound(b, hq, hkv, sq, skv, dh, window, 2,
                                     causal=causal)[3]
            nbytes += 2 * 2 * b * hkv * skv * dh   # k and v; q, out counted
        out["predicted_peak_bytes"] = rest["peak_bytes_per_device"]
        out["kernel_flops"], out["kernel_hbm_bytes"] = flops, nbytes
        out["kernel_bound_ms"], out["kernel_bound_by"] = bound(flops, nbytes)
    return out


class NormOnly:
    """An optimizer that leaves the parameters as they are and reports the
    global gradient norm: the train cell's forward, backward and
    accumulation without its update, for the plain-attention step 1.
    ``reached`` says which leaves (in ``tree_leaves`` order) got a
    gradient that is not zero everywhere."""

    reached = None

    def update(self, grads, state, params):
        from repro_torch.optim.adamw import global_norm, tree_leaves

        self.reached = [bool((g != 0).any()) for g in tree_leaves(grads)]
        return params, state, {"grad_norm": global_norm(grads), "lr": 0.0}


def _fingerprints(params):
    """(sum, sum of |x|) of each leaf (``tree_leaves`` order) in float64,
    on its device."""
    import torch

    from repro_torch.optim.adamw import tree_leaves

    return torch.stack([torch.stack([t.double().sum(), t.double().abs().sum()])
                        for t in tree_leaves(params)])


def _all_finite(tree) -> bool:
    import torch

    return all(bool(torch.isfinite(t).all()) for t in _leaves(tree)
               if t.is_floating_point())


def _logits_finite(logits, rows: int = 4096) -> bool:
    """Every logit finite, a slice of the sequence at a time (a 32k
    prefill's logits are up to 17 GB)."""
    import torch

    flat = logits.reshape(-1, logits.shape[-1])
    return all(bool(torch.isfinite(flat[i:i + rows]).all())
               for i in range(0, flat.shape[0], rows))


def _timed(fn, device: str, reps: int):
    """Mean ms of ``reps`` back-to-back calls of ``fn`` (CUDA events on the
    card, the host clock on the CPU)."""
    import torch

    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flash_at_cell(captured: dict, card: str, device: str) -> list:
    """The flash kernel against its plain version on the q / k / v a
    prefill cell gave it (one call of each distinct shape and mask), on
    CELL_CHECK_HEADS query heads with their kv heads (the plain version's
    scores take 4.3 GB a head at 32,768^2): f32 within 2e-5, bf16 within
    one ulp; then the kernel at every head timed beside SDPA and the
    bound, the plain version on the slice.  On the card only: on the CPU
    the kernel is the plain version itself."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    rows = []
    if device == "cpu":
        return rows
    for (sq, skv, causal, window), (q, k, v, kw) in captured.items():
        b, hq, _, dh = q.shape
        hkv = k.shape[1]
        g = hq // hkv
        heads = torch.arange(CELL_CHECK_HEADS, device=q.device) * g
        qs = q[:, heads].contiguous()
        ks, vs = (t[:, :CELL_CHECK_HEADS].contiguous() for t in (k, v))
        e32, e16 = flash_check(qs, ks, vs, window, causal=causal,
                               q_offset=kw.get("q_offset", 0))
        bound_ms, bound_by, *_ = attention_bound(b, hq, hkv, sq, skv, dh,
                                                 window, 2, causal=causal)
        akw = {"causal": causal, "window": window}

        if window is None:
            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        else:
            # a mask rules out SDPA's flash backend, and GQA its
            # memory-efficient one (its math path would hold hq x sq x
            # skv f32 scores): the kv heads are repeated to hq
            pos = torch.arange(sq, device=q.device)
            mask = (pos[:, None] >= pos[None, :]) & \
                ((pos[:, None] - pos[None, :]) < window)
            kr, vr = (t.repeat_interleave(g, dim=1) for t in (k, v))

            def sdpa():
                return F.scaled_dot_product_attention(q, kr, vr,
                                                      attn_mask=mask)

        rows.append({
            "shape": [b, hq, sq, dh], "kv_heads": hkv, "skv": skv,
            "causal": causal, "window": window,
            "check_heads": CELL_CHECK_HEADS, "max_abs_err": e16,
            "tol": FLASH_BF16_TOL, "max_abs_err_f32": e32,
            "tol_f32": FLASH_F32_TOL,
            "ms": time_ms(lambda: ops.attention(q, k, v, **akw), reps=5,
                          warmup=1),
            "library_ms": time_ms(sdpa, reps=5, warmup=1),
            "slice_ms": time_ms(lambda: ops.attention(qs, ks, vs, **akw),
                                reps=5, warmup=1),
            "slice_plain_ms": time_ms(lambda: ops.attention(
                qs, ks, vs, impl="ref", **akw), reps=2, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "card": card})
        del qs, ks, vs
    return rows


def capture_attention(captured: dict):
    """Within the block the model's attention keeps the inputs of the
    first call of each (sq, skv, causal, window) in ``captured``."""
    def wrap(fn):
        def attend(q, k, v, **kw):
            sig = (q.shape[2], k.shape[2], kw.get("causal", True),
                   kw.get("window"))
            if sig not in captured:
                captured[sig] = (q, k, v, kw)
            return fn(q, k, v, **kw)
        return attend
    return attention_swapped(wrap)


def run_cell(arch: str, shape_id: str, params, device: str,
             card: str) -> dict:
    """One cell of phase 10 on ``device``: the cut reckoned on ``meta``
    first (its predicted peak must fit the card), then the cell built by
    ``launch.cells.build_cell`` and run on inputs made from ``SEED``:
    launches counted over its runs only, step time (CUDA events after a
    warm-up), peak memory, and its checks (finite outputs of the expected
    shape; a train step's step 1 against the plain attention's, every
    parameter changed and finite)."""
    import torch

    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import build_cell
    from repro_torch.training import make_train_step

    on_card = device != "cpu"
    cfg, shape = cell_sizes(arch, shape_id, device)
    pub_cfg, pub_shape = get_config(arch), get_shape(shape_id)
    out = {"arch": arch, "shape": shape_id, "kind": shape.kind,
           "layers": cfg.n_layers, "layers_published": pub_cfg.n_layers,
           "batch": shape.global_batch,
           "batch_published": pub_shape.global_batch,
           "seq": shape.seq_len, **cell_reckoning(arch, shape_id, cfg,
                                                   shape)}
    cut = []
    if cfg.n_layers != pub_cfg.n_layers:
        cut.append(f"layers {cfg.n_layers} of {pub_cfg.n_layers}")
    if shape.global_batch != pub_shape.global_batch:
        cut.append(f"batch {shape.global_batch} of "
                   f"{pub_shape.global_batch}")
    out["cut"] = ", ".join(cut) or "none"
    if on_card and out["predicted_peak_bytes"] > CELL_CARD_BYTES:
        raise AssertionError(f"cells: {arch} x {shape_id} ({out['cut']}) "
                             f"predicts {out['predicted_peak_bytes']:.3e} B,"
                             f" over the card's {CELL_CARD_BYTES:.0e}")
    cell = build_cell(arch, shape_id, device=device, cfg=cfg, shape=shape)
    p = layers_view(params, cfg)
    args = cell.inputs(SEED, params=p)
    want_launches = attention_calls(cfg) * (
        2 * cell.accum if shape.kind == "train" else
        1 if shape.kind == "prefill" else 0)
    captured = {}
    if shape.kind == "train":
        # step 1 of the same cell with the plain attention, update skipped
        norm_only = NormOnly()
        with plain_attention():
            _, _, ref = make_train_step(cell.model, norm_only,
                                        grad_accum=cell.accum)(*args)
        ref = {k: float(ref[k]) for k in ("loss", "grad_norm")}
        before = _fingerprints(p)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if shape.kind == "prefill":
        with capture_attention(captured):
            res = cell.run(*args)
    else:
        res = cell.run(*args)
    _sync(device)
    warm_ms = (time.perf_counter() - t0) * 1e3
    if shape.kind == "train":
        step1 = {k: float(res[2][k]) for k in ("loss", "grad_norm")}
        out["step1"] = {**step1, "plain": ref, **rel_errs(step1, ref),
                        "bounds": CELL_STEP1_RTOL[cfg.family]}
        lb, gb = CELL_STEP1_RTOL[cfg.family]
        if (out["step1"]["loss_rel_err"] > lb
                or out["step1"]["grad_norm_rel_err"] > gb):
            raise AssertionError(f"cells: {arch} x {shape_id}: step 1 "
                                 f"against the plain attention "
                                 f"{out['step1']} is outside its bounds")
        logits = None
    else:
        logits = res[0] if shape.kind == "decode" else res
        want = ((shape.global_batch, cfg.padded_vocab)
                if shape.kind == "decode" else
                (shape.global_batch, cell.args[1]["tokens"].shape[1]
                 + (cfg.n_patches if cfg.family == "vlm" else 0),
                 cfg.padded_vocab))
        if tuple(logits.shape) != want or not _logits_finite(logits):
            raise AssertionError(f"cells: {arch} x {shape_id}: logits "
                                 f"{tuple(logits.shape)} (want {want}), "
                                 "finite?")
    del res, logits
    reps = 1 if warm_ms > 300 or shape.kind == "train" else 3
    out["step_ms"] = _timed(lambda: cell.run(*args), device, reps)
    out["runs"] = 1 + reps
    out["warm_ms"] = warm_ms
    launches = ops.launch_counts()["flash_attention"]
    sm90 = ops.entry_launch_counts()["flash_attention_sm90"]
    out["bwd_launches"] = backward_counts()
    out["flash_launches"] = launches
    out["flash_launches_per_run"] = launches / out["runs"]
    out["flash_sm90_launches"] = sm90
    if on_card and (launches != want_launches * out["runs"]
                    or sm90 != launches):
        raise AssertionError(f"cells: {arch} x {shape_id}: flash launched "
                             f"{launches} times ({sm90} sm90) in "
                             f"{out['runs']} runs, expected "
                             f"{want_launches} a run, all sm90")
    if on_card:
        check_backward(f"cells: {arch} x {shape_id}", out["bwd_launches"],
                       attention_calls(cfg) * cell.accum * out["runs"]
                       if shape.kind == "train" else 0)
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["share"] = out["bound_ms"] / out["step_ms"]
    if "kernel_bound_ms" in out:
        out["kernel_share"] = out["kernel_bound_ms"] / out["step_ms"]
    if shape.kind == "train":
        # every leaf the loss reaches changed; a leaf it does not reach
        # (hymba's ln_ssm: the reference's init declares it, only the
        # ssm family reads it) keeps its zeros
        same = (_fingerprints(p) == before).all(dim=1).cpu().tolist()
        unreached = [not r for r in norm_only.reached]
        if same != unreached or not _all_finite(p):
            raise AssertionError(
                f"cells: {arch} x {shape_id}: leaves unchanged "
                f"{[i for i, s in enumerate(same) if s]}, leaves the loss "
                f"does not reach {[i for i, u in enumerate(unreached) if u]}"
                " (tree_leaves order), or a parameter is not finite")
        out["params_changed_and_finite"] = True
        out["leaves_unreached"] = sum(unreached)
    out["flash_checks"] = flash_at_cell(captured, card, device)
    del captured, args
    peak = (f"peak {out['peak_bytes'] / 1e9:.2f} GB (predicted "
            f"{out['predicted_peak_bytes'] / 1e9:.2f}, state "
            f"{out['state_bytes'] / 1e9:.2f})" if on_card else
            f"state {out['state_bytes'] / 1e9:.4f} GB")
    print(f"cells: {arch} x {shape_id} (CUT {out['cut']}; seq "
          f"{shape.seq_len}): step {out['step_ms']:.2f} ms ({out['runs']} "
          f"runs), {peak}; flash {out['flash_launches_per_run']:g} a run "
          f"(sm90 {sm90} of {launches}); {out['flops']:.4e} FLOP, "
          f"{out['hbm_bytes']:.4e} B -> bound {out['bound_ms']:.3f} ms "
          f"({out['bound_by']}), share {out['share']:.4f}"
          + (f"; flash path: bound {out['kernel_bound_ms']:.3f} ms "
             f"({out['kernel_bound_by']}), share {out['kernel_share']:.4f}"
             if "kernel_bound_ms" in out else "")
          + (f"; step 1 vs plain: loss rel {out['step1']['loss_rel_err']:.2e}"
             f", grad norm rel {out['step1']['grad_norm_rel_err']:.2e} "
             f"(bounds {out['step1']['bounds']})"
             if "step1" in out else "")
          + "".join(f"; flash at {r['shape']} skv {r['skv']} window "
                    f"{r['window']}: err {r['max_abs_err']:.2e} bf16 / "
                    f"{r['max_abs_err_f32']:.2e} f32, {r['ms']:.3f} ms, "
                    f"SDPA {r['library_ms']:.3f}, bound {r['bound_ms']:.3f}"
                    for r in out["flash_checks"])
          + f"  [{card}]", flush=True)
    return out


def run_cells_phase(device: str, card: str) -> dict:
    """Phase 10: the reference's (arch x shape) grid (``cell_grid``)
    through ``launch.cells.build_cell`` on ``device``, one model's weights
    per arch (drawn from ``SEED`` at its deepest cut, each cell taking its
    own depth of them), each arch freed before the next."""
    import torch

    from repro_torch.launch.dryrun import at_depth
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"cells": [], "card": card}
    for arch, shapes in cell_grid():
        depth = max(cell_sizes(arch, s, device)[0].n_layers for s in shapes)
        cfg = at_depth(cell_sizes(arch, shapes[0], device)[0], depth)
        params = build_model(cfg, device=device).init(SEED)
        for shape_id in shapes:
            out["cells"].append(run_cell(arch, shape_id, params, device,
                                         card))
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
        del params
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out



# mesh phase (11): the models' mesh path (sharding.axes, launch.mesh,
# the expert-parallel moe) in a torch.distributed world of one process
# per card, NCCL.  World 1: a (1, 1) DeviceMesh — DTensor, local_map and
# the flash kernel on each rank's local heads all run — for gemma3-27b
# at phase 5's 6 layers (windowed and global caches) and
# granite-moe-1b-a400m at its 24 layers (the expert-parallel branch at
# ep = 1, capacity drops counted; held against the dense dispatch at a
# capacity with no drops).  With n >= 2 cards also a (1, min(4, n)) mesh
# for qwen1.5-110b and dbrx-132b at phase 10's prefill depths, held
# against the same depth on one card.  Each arch: a prefill through
# launch.cells.build_cell on the mesh (prefill_32k cut to MESH_PREFILL),
# MESH_DECODE_STEPS decode steps (decode_32k cut to MESH_DECODE) and the
# serving engine with mesh= on MESH_SERVE_REQUESTS requests, each held
# against the model unsharded in the same run
MESH_WORLD1_RUNS = (("gemma3-27b", 6), ("granite-moe-1b-a400m", 24))
MESH_MULTI_RUNS = (("qwen1.5-110b", 4), ("dbrx-132b", 2))
MESH_PREFILL = (1, 4096)            # batch, tokens
MESH_DECODE = (8, 4096)             # batch, cache positions
MESH_DECODE_STEPS = 8
MESH_SERVE = dict(batch=4, kv_len=512, requests=8, prompt=(4, 8), new=4)
# bf16 logits: the sharded path against the unsharded one where their
# arithmetic differs (partial sums over model, the expert-parallel
# dispatch's order of the expert mix): atol = rtol = 0.1 on logits of
# unit scale, tests/test_torch_families.py's bf16 bound; at world 1 the
# dense archs' mesh bodies run the unsharded arithmetic, so 0
MESH_BF16_TOL = 0.1
# granite-moe is held against the dense dispatch in f32 (bf16 rounds the
# expert mix in another order, which 24 layers compound: 0.88 on logits
# of scale 4.7 in the first card run): atol = rtol = 1e-3 over 24 layers
MESH_F32_TOL = 1e-3


def _mesh_run_arch(arch: str, layers: int, mesh, device,
                   world: int) -> dict:
    """One arch on ``mesh`` and unsharded (on this rank): prefill,
    decode steps and the serving engine, each held against the other."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import build_cell
    from repro_torch.models import moe as M
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serving import Request, ServingEngine

    out = {"arch": arch, "layers": layers}
    moe = get_config(arch).family == "moe"
    exact = world == 1 and not moe
    pb, ps = MESH_PREFILL
    db, ds = MESH_DECODE
    pre = ShapeConfig("prefill_32k", ps, pb, "prefill")
    dec = ShapeConfig("decode_32k", ds, db, "decode")
    dev = torch.device(device)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED)

    def cfg_at(no_drops=False):
        # no_drops: capacity n_experts / top_k, so C >= the tokens routed
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        return cfg if not no_drops else dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k, dtype="float32")

    def held(a, b):
        f32 = b.dtype == torch.float32
        a, b = a.float(), b.float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"mesh {arch}: logits not finite")
        err = float((a - b).abs().max())
        rel = MESH_F32_TOL if f32 else MESH_BF16_TOL
        tol = 0.0 if exact else rel * (1.0 + float(b.abs().max()))
        if err > tol:
            raise AssertionError(f"mesh {arch}: sharded vs unsharded "
                                 f"{err:.3e} > {tol:.3e}")
        return err

    # prefill: the mesh cell, then the same cell on this rank's card
    cfgs = [(cfg_at(), "own")] + ([(cfg_at(True), "no_drops")]
                                  if moe else [])
    for cfg, tag in cfgs:
        cell = build_cell(arch, "prefill_32k", mesh, cfg=cfg, shape=pre)
        params, batch = cell.inputs(SEED)
        cell.run(params, batch)                               # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        M.reset_ep_drops()
        logits = cell.run(params, batch)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["flash_attention"]
        sm90 = ops.entry_launch_counts().get("flash_attention_sm90", 0)
        drops = M.ep_drops()
        ms = _timed(lambda: cell.run(params, batch), device, 2)
        rec = {"prefill_ms": ms, "flash_launches": launches,
               "flash_sm90_launches": sm90, "ep_drops_prefill": drops}
        if launches != attention_calls(cfg) or (
                cfg.dtype == "bfloat16" and sm90 != launches):
            raise AssertionError(f"mesh {arch}: flash launches {launches} "
                                 f"({sm90} sm90) for "
                                 f"{attention_calls(cfg)} attention calls")
        if tag == "no_drops" or not moe:
            # the unsharded cell on this card, from the same seed
            one = build_cell(arch, "prefill_32k", device,
                             cfg=dataclasses.replace(cfg_at(),
                                                     dtype=cfg.dtype),
                             shape=pre)
            p1 = tree_map(lambda t: t.to_local(), params) if world == 1 \
                else one.model.init(SEED)
            b1 = {k: v.full_tensor() for k, v in batch.items()}
            want = one.run(p1, b1)
            rec["prefill_ms_unsharded"] = _timed(lambda: one.run(p1, b1),
                                                 device, 2)
            rec["prefill_max_abs_diff"] = held(logits.full_tensor(), want)
            del p1, want
        out[tag] = rec
        del logits, params, batch
        gc.collect()
        torch.cuda.empty_cache()

    # decode: MESH_DECODE_STEPS steps at scalar positions against caches
    # filled from the seed, on the mesh and unsharded
    for cfg, tag in cfgs:
        cell = build_cell(arch, "decode_32k", mesh, cfg=cfg, shape=dec)
        params, caches, token, pos = cell.inputs(SEED)
        one = build_cell(arch, "decode_32k", device, cfg=cfg, shape=dec)
        p1 = tree_map(lambda t: t.to_local(), params) if world == 1 else \
            one.model.init(SEED)
        _, c1, t1, _ = one.inputs(SEED, params=p1)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (MESH_DECODE_STEPS, db, 1)).astype(np.int32))
        errs, times = [], []
        M.reset_ep_drops()
        for i in range(MESH_DECODE_STEPS):
            p = torch.tensor(ds - MESH_DECODE_STEPS + i, dtype=torch.int32,
                             device=dev)
            tk = toks[i].to(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lg, caches = cell.run(params, caches, tk, p)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            if tag == ("no_drops" if moe else "own"):
                want, c1 = one.run(p1, c1, tk, p)
                errs.append(held(lg.full_tensor(), want))
        out[tag].update({"decode_step_ms": sorted(times)[len(times) // 2],
                         "decode_step_ms_all": times,
                         "ep_drops_decode": M.ep_drops()})
        if errs:
            out[tag]["decode_max_abs_diff"] = max(errs)
        del params, caches, p1, c1
        gc.collect()
        torch.cuda.empty_cache()

    # the serving engine with mesh= (request clustering on soa-device on
    # every rank), against the unsharded engine; greedy tokens every rank
    import torch.distributed as dist

    sv = MESH_SERVE
    # world > 1: f32, where the partial sums' order cannot move a greedy
    # token (bf16's can), so the engine is held exactly; at world 1 the
    # dense archs are exact in bf16 and granite-moe serves in f32
    cfg = cfgs[-1][0] if world == 1 else dataclasses.replace(
        cfgs[-1][0], dtype="float32")
    from repro_torch.models.registry import build_model

    model = build_model(cfg, device=dev)
    params = model.init(SEED, mesh=mesh)
    # the unsharded engine's weights: the mesh's own at world 1, else the
    # same draw whole on this rank's card
    p1 = tree_map(lambda t: t.to_local(), params) if world == 1 else \
        model.init(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(
        sv["prompt"][0], sv["prompt"][1] + 1))) for _ in range(
            sv["requests"])]
    centres = rng.normal(size=(2, 8)) * 3
    embeds = [centres[i % 2] + 0.05 * rng.normal(size=8)
              for i in range(sv["requests"])]

    def serve(model, prm, m):
        eng = ServingEngine(model, prm, batch=sv["batch"],
                            kv_len=sv["kv_len"], cluster_requests=True,
                            cluster_backend="soa-device", mesh=m)
        t0 = time.perf_counter()
        for rid, pr in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=pr,
                               max_new_tokens=sv["new"],
                               embedding=embeds[rid]))
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.close()
        return {r: list(q.out_tokens) for r, q in sorted(done.items())}, wall

    toks_mesh, wall = serve(model, params, mesh)
    every = [None] * world
    dist.all_gather_object(every, toks_mesh)
    if any(e != toks_mesh for e in every):
        raise AssertionError(f"mesh {arch}: ranks chose different tokens")
    if len(toks_mesh) != sv["requests"] or any(
            len(v) != sv["new"] for v in toks_mesh.values()):
        raise AssertionError(f"mesh {arch}: served {toks_mesh}")
    serve_rec = {"wall_s": wall, "requests": len(toks_mesh),
                 "tokens": sum(len(v) for v in toks_mesh.values())}
    toks_one, wall1 = serve(model, p1, None)
    agree = sum(a == b for r in toks_one for a, b in
                zip(toks_one[r], toks_mesh[r]))
    serve_rec.update(wall_s_unsharded=wall1, tokens_equal=agree,
                     of=serve_rec["tokens"], dtype=cfg.dtype)
    if (exact or cfg.dtype == "float32") and toks_one != toks_mesh:
        raise AssertionError(f"mesh {arch}: greedy tokens differ from "
                             f"the unsharded engine's")
    out["serve"] = serve_rec
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, p1
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank: int, world: int, port: int, where: str,
               arch_runs) -> None:
    """One rank of a phase 11 world (a spawned process): the archs of
    ``arch_runs`` on the world's production mesh, (1, world)."""
    import torch

    sys.path.insert(0, str(PKG.parent))
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed, \
        make_production_mesh

    init_distributed("cuda", rank=rank, world_size=world,
                     init_method=f"tcp://localhost:{port}")
    ops.ensure_built()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = f"cuda:{torch.cuda.current_device()}"
    mesh = make_production_mesh()
    res = {"rank": rank, "archs": []}
    for arch, layers in arch_runs:
        t0 = time.perf_counter()
        r = _mesh_run_arch(arch, layers, mesh, device, world)
        r.update(mesh=list(mesh.shape), wall_s=time.perf_counter() - t0)
        res["archs"].append(r)
    Path(where, f"mesh_rank{rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def run_mesh_phase(card: str) -> dict:
    """Phase 11: MESH_WORLD1_RUNS in a world of one process on a (1, 1)
    mesh, then, with n >= 2 cards, MESH_MULTI_RUNS in a world of
    min(4, n) processes, one per card (NCCL), on (1, min(4, n))."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    cards = torch.cuda.device_count()
    parts = [("world1", 1, MESH_WORLD1_RUNS)]
    if cards >= 2:
        parts.append(("multi", min(4, cards), MESH_MULTI_RUNS))
    t0 = time.perf_counter()
    out = []
    for tag, world, arch_runs in parts:
        t1 = time.perf_counter()
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        with tempfile.TemporaryDirectory(dir=ROOT) as where:
            mp.start_processes(_mesh_rank,
                               args=(world, port, where, arch_runs),
                               nprocs=world, join=True,
                               start_method="spawn")
            ranks = [json.loads(Path(where, f"mesh_rank{r}.json")
                                .read_text()) for r in range(world)]
        out.append({"part": tag, "world": world, "ranks": ranks,
                    "wall_s": time.perf_counter() - t1})
    return {"cards": cards, "parts": out,
            "wall_s": time.perf_counter() - t0, "card": card}


def print_mesh_phase(mesh: dict) -> None:
    card = mesh["card"]
    print(f"mesh: {mesh['cards']} card(s), NCCL; worlds "
          f"{[p['world'] for p in mesh['parts']]}"
          + ("; the multi-rank part (qwen1.5-110b, dbrx-132b on (1, n)) did "
             "not run: one card — tests/test_torch_mesh.py carries its "
             "semantics on gloo worlds of 2 and 4"
             if mesh["cards"] == 1 else "") + f"  [{card}]", flush=True)
    for part in mesh["parts"]:
        ranks = part["ranks"]
        for i, a in enumerate(ranks[0]["archs"]):
            per = [r["archs"][i] for r in ranks]
            own, nd = a["own"], a.get("no_drops", {})
            held = nd or own
            sv = a["serve"]
            print(f"mesh: world {part['world']}: {a['arch']} x "
                  f"{a['layers']}L on {tuple(a['mesh'])}: prefill "
                  f"{own['prefill_ms']:.2f} ms (unsharded "
                  f"{own.get('prefill_ms_unsharded', float('nan')):.2f}), "
                  f"decode step {own['decode_step_ms']:.2f} ms; max |diff| "
                  f"vs unsharded: prefill {held.get('prefill_max_abs_diff')}"
                  f", decode {held.get('decode_max_abs_diff')}"
                  + (f" (dense dispatch against the expert-parallel one at "
                     f"capacity n_experts / top_k; at its own capacity "
                     f"{own['ep_drops_prefill']} prefill / "
                     f"{own['ep_drops_decode']} decode tokens dropped)"
                     if nd else "")
                  + f"; flash launches per rank "
                  f"{[p['own']['flash_launches'] for p in per]} (sm90 "
                  f"{[p['own']['flash_sm90_launches'] for p in per]}); peak "
                  f"{[round(p['peak_gb'], 2) for p in per]} GB per rank; "
                  f"serving ({sv['dtype']}) {sv['requests']} requests, "
                  f"{sv['tokens']} tokens in {sv['wall_s']:.2f} s "
                  f"(unsharded {sv['wall_s_unsharded']:.2f} s, "
                  f"{sv['tokens_equal']}/{sv['of']} greedy tokens equal)"
                  f"; part {a['wall_s']:.1f} s  [{card}]", flush=True)
        print(f"mesh: world {part['world']}: {part['wall_s']:.1f} s  "
              f"[{card}]", flush=True)
    print(f"mesh: phase {mesh['wall_s']:.1f} s  [{card}]", flush=True)
    print("mesh_path " + json.dumps(mesh), flush=True)


# ---------------------------------------------------------------------- #
# training on a (data, model) mesh (phase 12): the train step on a
# DeviceMesh against the unsharded step in the same run
# ---------------------------------------------------------------------- #
MESH_TRAIN_STEPS, MESH_TRAIN_ACCUM = 2, 2
# (b) the expert-parallel backward: granite-moe at its published widths,
# depth cut, f32 compute, capacity n_experts / top_k, one step
MESH_MOE_ARCH, MESH_MOE_LAYERS, MESH_MOE_SHAPE = \
    "granite-moe-1b-a400m", 8, (4, 512)
# its loss, gradient norm and m (the clipped gradient x 0.1, leaf by leaf
# against the leaf's largest) against the dense dispatch's: the expert
# mix sums the same products in another order, in f32 over 8 layers
MESH_MOE_F32_TOL = 1e-4
# (c) save on the mesh, restore onto it and unsharded: mamba2-780m (a
# dense arch, so the unsharded step computes what the mesh step does)
# at its published widths, depth cut to keep the state small on disk
MESH_RESTART_ARCH, MESH_RESTART_LAYERS, MESH_RESTART_SHAPE = \
    "mamba2-780m", 2, (8, 1024)
# with >= 2 cards, granite-20b x 4 on (2, 2) (4 cards) or (2, 1) against
# the world-1 mesh step: bf16 partial sums in another order, the bounds
# of tests/test_torch_train.py's bf16 comparison (loss 1e-2 relative,
# gradient 5e-2 of its leaf's largest, here of the norm)
MESH_TRAIN_BF16_RTOL = (1e-2, 5e-2)


def mesh_train_sizes(device: str) -> dict:
    """Phase 12's configs and batches: on the card the published widths
    with the depths above; on the CPU (tests) the smoke configs."""
    import dataclasses

    from repro_torch.configs import get_config

    def cut(arch, layers):
        cfg = get_config(arch)
        if device == "cpu":
            return dataclasses.replace(cfg.smoke(), n_layers=2)
        return dataclasses.replace(cfg, n_layers=layers)

    cpu = device == "cpu"
    return {"dense": cut(TRAIN_ARCH, TRAIN_LAYERS),
            "dense_batch": (4, 32) if cpu else (TRAIN_BATCH, TRAIN_SEQ),
            "moe": cut(MESH_MOE_ARCH, MESH_MOE_LAYERS),
            "moe_batch": (2, 16) if cpu else MESH_MOE_SHAPE,
            "restart": cut(MESH_RESTART_ARCH, MESH_RESTART_LAYERS),
            "restart_batch": (4, 32) if cpu else MESH_RESTART_SHAPE}


def _peak_gb(device: str):
    import torch

    return None if device == "cpu" else \
        torch.cuda.max_memory_allocated() / 1e9


def _reset_peak(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def train_cell_run(arch: str, cfg, batch_seq, where, steps: int,
                   accum: int, capture=None):
    """``steps`` steps of ``build_cell(arch, "train_4k", where)`` (a
    device or a DeviceMesh) from ``inputs(SEED)``: -> (the cell, params,
    optimizer state, the batch, per-step metrics with CUDA-event ms,
    flash launches, those on the tensor cores and the attention
    backward's :func:`backward_counts`).  ``capture``: a dict in which the
    first attention call's inputs are kept."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import build_cell

    b, s = batch_seq
    cell = build_cell(arch, "train_4k", where, grad_accum=accum, cfg=cfg,
                      shape=ShapeConfig("train_4k", s, b, "train"))
    device = cell.device.type
    params, state, batch = cell.inputs(SEED)
    _sync(device)
    ops.reset_launch_counts()
    out = []
    for i in range(steps):
        ctx = capture_attention(capture) if capture is not None and i == 0 \
            else contextlib.nullcontext()
        with ctx:
            if device == "cpu":
                t0 = time.perf_counter()
                params, state, m = cell.run(params, state, batch)
                ms = (time.perf_counter() - t0) * 1e3
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                params, state, m = cell.run(params, state, batch)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "lr": float(m["lr"]), "ms": ms})
    _sync(device)
    launches = (ops.launch_counts()["flash_attention"],
                ops.entry_launch_counts().get("flash_attention_sm90", 0),
                backward_counts())
    return cell, params, state, batch, out, launches


def _local_leaves(tree):
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in _leaves(tree)]


def _to_host(tree):
    return [t.detach().to("cpu") for t in _local_leaves(tree)]


def _max_diff(got, host) -> float:
    """Max |a - b| over matching leaves, ``host`` moved leaf by leaf."""
    return max(float((a.float() - b.to(a.device).float()).abs().max())
               for a, b in zip(_local_leaves(got), host))


def _held_steps(got, want, rtol) -> dict:
    errs = {k: max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want))
            for k in ("loss", "grad_norm")}
    if errs["loss"] > rtol[0] or errs["grad_norm"] > rtol[1]:
        raise AssertionError(f"12: steps {got} vs {want}: {errs} > {rtol}")
    return errs


def mesh_train_dense(mesh, device: str, card: str) -> dict:
    """12 (a): granite-20b at its published widths, TRAIN_LAYERS layers,
    phase 8's batch, MESH_TRAIN_STEPS steps at accumulation
    MESH_TRAIN_ACCUM unsharded (kept on the host, freed), then through
    ``build_cell(..., mesh)`` from the same draw; the flash kernel on the
    mesh step's inputs against its plain version."""
    import torch

    sz = mesh_train_sizes(device)
    cfg, shape = sz["dense"], sz["dense_batch"]
    on_card = device != "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_peak(device)
    _, p1, s1, _, one, _ = train_cell_run(TRAIN_ARCH, cfg, shape, device,
                                          MESH_TRAIN_STEPS,
                                          MESH_TRAIN_ACCUM)
    peak_one = _peak_gb(device)
    n_params = sum(t.numel() for t in _leaves(p1))
    want = _to_host(p1)
    del p1, s1
    gc.collect()
    _reset_peak(device)
    captured: dict = {}
    cell, pm, sm, _, got, (fl, fl90, bwd) = train_cell_run(
        TRAIN_ARCH, cfg, shape, mesh, MESH_TRAIN_STEPS, MESH_TRAIN_ACCUM,
        capture=captured)
    peak = _peak_gb(device)
    # the training forward's q / k / v, without their graph
    captured = {sig: tuple(t.detach() for t in qkv[:3]) + qkv[3:]
                for sig, qkv in captured.items()}
    per_step = 2 * cfg.n_layers * cell.accum
    if on_card and (fl != per_step * MESH_TRAIN_STEPS or fl90 != fl):
        raise AssertionError(f"12 (a): flash launches {fl} ({fl90} sm90) "
                             f"in {MESH_TRAIN_STEPS} steps, expected "
                             f"{per_step} a step")
    if on_card:
        check_backward("12 (a)", bwd, per_step // 2 * MESH_TRAIN_STEPS)
    errs = _held_steps(got, one, (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL))
    pdiff = _max_diff(pm, want)
    lrs = sum(m["lr"] for m in one)
    if pdiff > 2 * lrs:
        raise AssertionError(f"12 (a): parameters {pdiff} apart > "
                             f"2 x sum(lr) {2 * lrs}")
    flash = flash_at_cell(captured, card, device)
    del pm, sm, want, captured
    gc.collect()
    _reset_peak(device)
    return {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "params": n_params,
            "batch": list(shape), "steps": MESH_TRAIN_STEPS,
            "accum": cell.accum, "mesh": list(mesh.shape),
            "mesh_steps": got, "unsharded_steps": one,
            "loss_rel_err": errs["loss"],
            "grad_norm_rel_err": errs["grad_norm"],
            "exact": errs["loss"] == 0 and errs["grad_norm"] == 0
            and pdiff == 0, "params_max_abs_diff": pdiff,
            "params_bound": 2 * lrs, "peak_gb": peak,
            "peak_gb_unsharded": peak_one, "flash_launches": fl,
            "flash_sm90_launches": fl90, "flash_launches_per_step": per_step,
            "bwd_launches": bwd,
            "flash_check": flash, "card": card}


def mesh_train_moe(mesh, device: str, card: str) -> dict:
    """12 (b): granite-moe at its published widths, MESH_MOE_LAYERS
    layers, f32, capacity n_experts / top_k: one step on the mesh
    (expert parallel) against one unsharded (the dense dispatch); then
    the drops of a forward at the config's own capacity."""
    import dataclasses

    from repro_torch.models import moe as M

    sz = mesh_train_sizes(device)
    base = dataclasses.replace(sz["moe"], dtype="float32")
    cfg = dataclasses.replace(
        base, capacity_factor=base.n_experts / base.top_k)
    shape = sz["moe_batch"]
    _reset_peak(device)
    _, p1, s1, _, one, _ = train_cell_run(MESH_MOE_ARCH, cfg, shape,
                                          device, 1, 1)
    want = _to_host(s1["m"])
    del p1, s1
    gc.collect()
    M.reset_ep_drops()
    cell, pm, sm, _, got, _ = train_cell_run(MESH_MOE_ARCH, cfg, shape,
                                             mesh, 1, 1)
    no_drops = M.ep_drops()
    errs = _held_steps(got, one, (MESH_MOE_F32_TOL, MESH_MOE_F32_TOL))
    worst = 0.0
    for a, b in zip(_local_leaves(sm["m"]), want):
        b = b.to(a.device)
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, e)
    if worst > MESH_MOE_F32_TOL:
        raise AssertionError(f"12 (b): m {worst} of its leaf's largest > "
                             f"{MESH_MOE_F32_TOL}")
    del pm, sm, want
    # the drops at the config's own capacity, a forward of the batch
    own = build_cell_inputs_loss(MESH_MOE_ARCH, base, shape, mesh)
    peak = _peak_gb(device)
    gc.collect()
    _reset_peak(device)
    return {"arch": MESH_MOE_ARCH, "layers": cfg.n_layers,
            "batch": list(shape), "dtype": "float32",
            "capacity_factor": cfg.capacity_factor,
            "mesh_step": got, "dense_step": one,
            "loss_rel_err": errs["loss"],
            "grad_norm_rel_err": errs["grad_norm"], "m_rel_err": worst,
            "tol": MESH_MOE_F32_TOL, "drops_no_drops_capacity": no_drops,
            "drops_own_capacity": own["drops"],
            "own_capacity_factor": base.capacity_factor, "peak_gb": peak,
            "card": card}


def build_cell_inputs_loss(arch: str, cfg, batch_seq, mesh) -> dict:
    """The expert-parallel drops of one forward of the train cell's loss
    on ``mesh`` at ``cfg``'s capacity."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import build_cell
    from repro_torch.models import moe as M

    b, s = batch_seq
    cell = build_cell(arch, "train_4k", mesh, cfg=cfg,
                      shape=ShapeConfig("train_4k", s, b, "train"))
    params, _, batch = cell.inputs(SEED)
    M.reset_ep_drops()
    with torch.no_grad():
        loss, _ = cell.model.loss(params, {k: v.full_tensor() for k, v in
                                           batch.items()}, mesh)
    return {"loss": float(loss), "drops": M.ep_drops()}


def mesh_train_restart(mesh, device: str, card: str) -> dict:
    """12 (c): a step on the mesh, a save of the parameters and AdamW
    state, the second step; then the save restored onto the mesh and
    unsharded (``shardings=None``), and the second step from each: equal
    to the uninterrupted run's."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.sharding.axes import sharding_tree
    from repro_torch.training import make_train_step

    sz = mesh_train_sizes(device)
    cfg, shape = sz["restart"], sz["restart_batch"]
    cell, params, state, batch, first, _ = train_cell_run(
        MESH_RESTART_ARCH, cfg, shape, mesh, 1, 1)
    model, opt = cell.model, cell.optimizer
    tree = {"params": params, "opt": state}
    with tempfile.TemporaryDirectory(dir=ROOT) as where:
        mgr = CheckpointManager(where, async_write=False)
        t0 = time.perf_counter()
        mgr.save(1, tree)
        mgr.wait()
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(where).rglob("*")
                     if f.is_file())
        _, _, m2 = cell.run(params, state, batch)
        want = _to_host(params)
        shardings = sharding_tree({"params": model.axes(),
                                   "opt": opt.state_axes(model.axes())},
                                  tree, mesh)
        t0 = time.perf_counter()
        back = mgr.restore(tree, step=1, shardings=shardings)
        restore_s = time.perf_counter() - t0
        # the template's leaves are DTensors: restored whole on their
        # local device
        whole = mgr.restore(tree, step=1)
    del tree, params, state
    gc.collect()
    _, _, r2 = cell.run(back["params"], back["opt"], batch)
    mesh_diff = _max_diff(back["params"], want)
    del back
    gc.collect()
    plain = make_train_step(model, opt, grad_accum=cell.accum)
    _, _, u2 = plain(whole["params"], whole["opt"],
                     {k: v.full_tensor() for k, v in batch.items()})
    whole_diff = _max_diff(whole["params"], want)
    del whole
    gc.collect()
    _reset_peak(device)
    losses = {"uninterrupted": float(m2["loss"]),
              "restored_on_mesh": float(r2["loss"]),
              "restored_unsharded": float(u2["loss"])}
    if losses["restored_on_mesh"] != losses["uninterrupted"] or mesh_diff:
        raise AssertionError(f"12 (c): the mesh restore's step differs: "
                             f"{losses}, params {mesh_diff}")
    # the unsharded step runs the mesh bodies' arithmetic off the mesh:
    # exact if they keep it, else within phase 8's bounds
    rel = abs(losses["restored_unsharded"] - losses["uninterrupted"]) / \
        abs(losses["uninterrupted"])
    lr = float(m2["lr"])
    if rel > TRAIN_LOSS_RTOL or whole_diff > 2 * lr:
        raise AssertionError(f"12 (c): the unsharded restore's step "
                             f"differs: {losses}, params {whole_diff}")
    return {"arch": MESH_RESTART_ARCH, "layers": cfg.n_layers,
            "batch": list(shape), "step1": first,
            "losses": losses, "unsharded_params_max_abs_diff": whole_diff,
            "unsharded_exact": rel == 0 and whole_diff == 0,
            "bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "card": card}


def _mesh_train_rank(rank: int, world: int, port: int, where: str,
                     shape) -> None:
    """One rank of phase 12's world of min(4, n) cards: 12 (a)'s mesh
    step on ``shape``."""
    import dataclasses

    import torch

    sys.path.insert(0, str(PKG.parent))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed, make_mesh

    init_distributed("cuda", rank=rank, world_size=world,
                     init_method=f"tcp://localhost:{port}")
    ops.ensure_built()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(shape, ("data", "model"))
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    cell, _, _, _, got, (fl, fl90, bwd) = train_cell_run(
        TRAIN_ARCH, cfg, (TRAIN_BATCH, TRAIN_SEQ), mesh, MESH_TRAIN_STEPS,
        MESH_TRAIN_ACCUM)
    Path(where, f"mesh_train_rank{rank}.json").write_text(json.dumps({
        "rank": rank, "steps": got, "accum": cell.accum,
        "flash_launches": fl, "flash_sm90_launches": fl90,
        "bwd_launches": bwd,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def mesh_train_multi(world1: dict) -> dict:
    """With n >= 2 cards: 12 (a)'s mesh step in a world of min(4, n)
    processes on (2, 2) (4 cards) or (2, 1), against the world-1 mesh
    step within MESH_TRAIN_BF16_RTOL."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    world = min(4, torch.cuda.device_count())
    shape = (2, 2) if world == 4 else (2, 1)
    world = shape[0] * shape[1]
    t0 = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=ROOT) as where:
        mp.start_processes(_mesh_train_rank,
                           args=(world, port, where, shape), nprocs=world,
                           join=True, start_method="spawn")
        ranks = [json.loads(Path(where, f"mesh_train_rank{r}.json")
                            .read_text()) for r in range(world)]
    errs = _held_steps(ranks[0]["steps"], world1["mesh_steps"],
                       MESH_TRAIN_BF16_RTOL)
    per_step = 2 * TRAIN_LAYERS * ranks[0]["accum"]
    for r in ranks:
        if r["flash_launches"] != per_step * MESH_TRAIN_STEPS or \
                r["flash_sm90_launches"] != r["flash_launches"]:
            raise AssertionError(f"12 multi: rank {r['rank']} flash "
                                 f"launches {r['flash_launches']}")
        check_backward(f"12 multi: rank {r['rank']}", r["bwd_launches"],
                       per_step // 2 * MESH_TRAIN_STEPS)
    return {"world": world, "mesh": list(shape), "ranks": ranks,
            "loss_rel_err": errs["loss"],
            "grad_norm_rel_err": errs["grad_norm"],
            "rtol": list(MESH_TRAIN_BF16_RTOL),
            "wall_s": time.perf_counter() - t0}


def run_mesh_train_phase(card: str, device: str = "cuda") -> dict:
    """Phase 12: (a), (b) and (c) on a (1, 1) DeviceMesh in this process
    (a world of one: NCCL on the card, gloo on the CPU, where the tests
    rehearse it at the smoke configs), then with n >= 2 cards a world of
    min(4, n)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh

    t0 = time.perf_counter()
    started = not dist.is_initialized()
    init_distributed(device)
    if device != "cpu":
        device = f"cuda:{torch.cuda.current_device()}"
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {"card": card, "cards": torch.cuda.device_count()
           if device != "cpu" else 0}
    try:
        for part, fn in (("a", mesh_train_dense), ("b", mesh_train_moe),
                         ("c", mesh_train_restart)):
            t1 = time.perf_counter()
            out[part] = fn(mesh, device, card)
            out[part]["wall_s"] = time.perf_counter() - t1
    finally:
        if started:
            dist.destroy_process_group()
    if out["cards"] >= 2:
        out["multi"] = mesh_train_multi(out["a"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_mesh_train_phase(mt: dict) -> None:
    from repro_torch.configs import get_config

    card = mt["card"]
    a, b, c = mt["a"], mt["b"], mt["c"]
    ms = [m["ms"] for m in a["mesh_steps"]]
    ms1 = [m["ms"] for m in a["unsharded_steps"]]
    full = {n: get_config(n).n_layers for n in (a["arch"], b["arch"],
                                                 c["arch"])}

    def cut(r):
        return f"{r['layers']}L (CUT from {full[r['arch']]})"

    print(f"mesh train (a): {a['arch']} x {cut(a)} at published "
          f"widths, {a['params']} parameters, batch {a['batch'][0]} x "
          f"{a['batch'][1]}, accumulation {a['accum']}, on "
          f"{tuple(a['mesh'])}: step ms {[round(v, 2) for v in ms]} "
          f"(unsharded {[round(v, 2) for v in ms1]}); loss rel err "
          f"{a['loss_rel_err']:.3e}, grad norm rel err "
          f"{a['grad_norm_rel_err']:.3e}, params max |diff| "
          f"{a['params_max_abs_diff']:.3e} (bound {a['params_bound']:.3e})"
          f", exact {a['exact']}; flash launches {a['flash_launches']} in "
          f"{a['steps']} steps ({a['flash_launches_per_step']} a step, "
          f"{a['flash_sm90_launches']} sm90); peak {a['peak_gb']:.2f} GB "
          f"(unsharded {a['peak_gb_unsharded']:.2f}); part "
          f"{a['wall_s']:.1f} s  [{card}]", flush=True)
    for r in a["flash_check"]:
        print(f"mesh train (a): flash_attention at the mesh step's local "
              f"{r['shape']} kv heads {r['kv_heads']}: err "
              f"{r['max_abs_err']:.3e} bf16 (tol {r['tol']:.3e}) / "
              f"{r['max_abs_err_f32']:.3e} f32; {r['ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms  "
              f"[{card}]", flush=True)
    print(f"mesh train (b): {b['arch']} x {cut(b)}, f32, batch "
          f"{b['batch'][0]} x {b['batch'][1]}, capacity "
          f"{b['capacity_factor']}: expert-parallel step "
          f"{b['mesh_step'][0]['ms']:.2f} ms vs dense dispatch "
          f"{b['dense_step'][0]['ms']:.2f} ms; loss rel err "
          f"{b['loss_rel_err']:.3e}, grad norm {b['grad_norm_rel_err']:.3e}"
          f", m {b['m_rel_err']:.3e} of its leaf's largest (tol "
          f"{b['tol']:.0e}); drops {b['drops_no_drops_capacity']} (at "
          f"{b['own_capacity_factor']}: {b['drops_own_capacity']}); peak "
          f"{b['peak_gb']:.2f} GB; part {b['wall_s']:.1f} s  [{card}]",
          flush=True)
    print(f"mesh train (c): {c['arch']} x {cut(c)}, batch "
          f"{c['batch'][0]} x {c['batch'][1]}: saved {c['bytes']} bytes in "
          f"{c['save_s']:.2f} s, restored in {c['restore_s']:.2f} s; step 2"
          f" loss {json.dumps(c['losses'])}; unsharded restore exact "
          f"{c['unsharded_exact']}; part {c['wall_s']:.1f} s  [{card}]",
          flush=True)
    if "multi" in mt:
        m = mt["multi"]
        print(f"mesh train: world {m['world']} on {tuple(m['mesh'])}: "
              f"steps {[[round(s['loss'], 5), round(s['ms'], 1)] for s in m['ranks'][0]['steps']]} "
              f"(loss, ms); loss rel err {m['loss_rel_err']:.3e}, grad norm"
              f" {m['grad_norm_rel_err']:.3e} vs world 1 (bounds "
              f"{m['rtol']}); flash launches per rank "
              f"{[r['flash_launches'] for r in m['ranks']]}; peak "
              f"{[round(r['peak_gb'], 2) for r in m['ranks']]} GB; part "
              f"{m['wall_s']:.1f} s  [{card}]", flush=True)
    else:
        print(f"mesh train: the multi-card part (granite-20b x "
              f"{TRAIN_LAYERS} on (2, 2) or (2, 1)) skipped: one card — "
              f"tests/test_torch_mesh_train.py carries its semantics on "
              f"gloo worlds of 2 and 4  [{card}]", flush=True)
    print(f"mesh train: phase {mt['wall_s']:.1f} s  [{card}]", flush=True)
    print("mesh_train_path " + json.dumps(mt), flush=True)


# ---------------------------------------------------------------------- #
# the mesh analysis (phase 13): the per-card step analysis of what phases
# 11 and 12 ran, on meta tensors in a fake world of the mesh's size, in a
# process of its own that sees no card; the bounds beside the step ms
# those phases measured
# ---------------------------------------------------------------------- #
MESH_ANALYSIS_TIMEOUT_S = 300


def mesh_analysis_runs(cards: int) -> list:
    """Phase 13's configurations, each the exact one a phase ran: 12 (a)
    (granite-20b x TRAIN_LAYERS at phase 8's batch, accumulation
    MESH_TRAIN_ACCUM) and 11's first world-1 arch (gemma3-27b x 6,
    prefill at MESH_PREFILL) on (1, 1); with n >= 2 cards also 12's
    multi-card mesh ((2, 2) at 4 cards, else (2, 1)) and 11's
    (MESH_MULTI_RUNS' prefills on (1, min(4, n)))."""
    dense = dict(arch=TRAIN_ARCH, shape="train_4k", layers=TRAIN_LAYERS,
                 batch=(TRAIN_BATCH, TRAIN_SEQ), accum=MESH_TRAIN_ACCUM)
    arch, layers = MESH_WORLD1_RUNS[0]
    runs = [dict(dense, phase="12 (a)", mesh=(1, 1)),
            dict(arch=arch, shape="prefill_32k", layers=layers,
                 batch=MESH_PREFILL, accum=None, phase="11", mesh=(1, 1))]
    if cards >= 2:
        n = min(4, cards)
        runs.append(dict(dense, phase="12 multi",
                          mesh=(2, 2) if n == 4 else (2, 1)))
        runs += [dict(arch=a, shape="prefill_32k", layers=k,
                      batch=MESH_PREFILL, accum=None, phase="11 multi",
                      mesh=(1, n)) for a, k in MESH_MULTI_RUNS]
    return runs


def mesh_analysis(runs: list) -> list:
    """Each run's ``launch.dryrun.analyze_cell`` on its mesh (an
    ``abstract_world``), with the three roofline terms over the
    data-sheet rates of ``launch.roofline``; on (1, 1) also the one-card
    analysis of the same cell.  A run that fails is a record with
    ``status`` ``error``."""
    import dataclasses
    import traceback

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.mesh import abstract_world
    from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS

    out = []
    for run in runs:
        rec = dict(run, status="ok")
        t0 = time.perf_counter()
        try:
            cfg = dataclasses.replace(get_config(run["arch"]),
                                      n_layers=run["layers"])
            b, s = run["batch"]
            shape = dataclasses.replace(get_shape(run["shape"]), seq_len=s,
                                        global_batch=b)
            kw = dict(cfg=cfg, shape=shape, grad_accum=run["accum"])
            with abstract_world(run["mesh"]) as mesh:
                a = analyze_cell(run["arch"], run["shape"], mesh=mesh, **kw)
            keys = ("flops_per_device", "hbm_bytes_per_device",
                    "collective_bytes_per_device", "per_collective",
                    "peak_bytes_per_device", "state_bytes_per_card")
            rec.update({k: a[k] for k in keys})
            rec["grad_accum"] = a.get("grad_accum")
            terms = {"compute": a["flops_per_device"] / PEAK_FLOPS,
                     "memory": a["hbm_bytes_per_device"] / HBM_BW,
                     "collective": a["collective_bytes_per_device"]
                     / LINK_BW}
            rec["terms_ms"] = {k: v * 1e3 for k, v in terms.items()}
            rec["dominant"] = max(terms, key=terms.get)
            rec["bound_ms"] = rec["terms_ms"][rec["dominant"]]
            if tuple(run["mesh"]) == (1, 1):
                one = analyze_cell(run["arch"], run["shape"], **kw)
                rec["one_card"] = {k: one[k] for k in (
                    "flops_per_device", "hbm_bytes_per_device")}
        except Exception as e:  # noqa: BLE001 — a failed run is a record
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        rec["analyze_s"] = time.perf_counter() - t0
        out.append(rec)
    return out


def mesh_analysis_main(cards: int) -> None:
    """Phase 13's child process: prints ``mesh_analysis <json>``."""
    sys.path.insert(0, str(PKG.parent))
    print("mesh_analysis " + json.dumps(
        mesh_analysis(mesh_analysis_runs(cards))), flush=True)


def mesh_analysis_gates(recs: list) -> None:
    """Every run ``ok``; on (1, 1) the FLOPs and HBM bytes those of the
    one-card analysis and no collective bytes; on a mesh of several
    cards some."""
    for r in recs:
        tag = f"13: {r['arch']} x {r['layers']}L on {tuple(r['mesh'])}"
        if r["status"] != "ok":
            raise AssertionError(f"{tag}: {r.get('error')}\n"
                                 f"{r.get('traceback', '')}")
        if tuple(r["mesh"]) == (1, 1):
            got = {k: r[k] for k in r["one_card"]}
            if got != r["one_card"] or r["collective_bytes_per_device"]:
                raise AssertionError(
                    f"{tag}: {got}, collective bytes "
                    f"{r['collective_bytes_per_device']} against the "
                    f"one-card analysis {r['one_card']}")
        elif not r["collective_bytes_per_device"] > 0:
            raise AssertionError(f"{tag}: no collective bytes")


def measured_step_ms(run: dict, mesh: dict, mt: dict) -> list:
    """The step ms per rank that phase 11 or 12 measured for ``run``:
    12's last step (CUDA events), 11's prefill (a mean of 2)."""
    if run["phase"].startswith("12"):
        if run["phase"] == "12 (a)":
            return [mt["a"]["mesh_steps"][-1]["ms"]]
        return [r["steps"][-1]["ms"] for r in mt["multi"]["ranks"]]
    part = mesh["parts"][0 if run["phase"] == "11" else 1]
    i = [a["arch"] for a in part["ranks"][0]["archs"]].index(run["arch"])
    return [r["archs"][i]["own"]["prefill_ms"] for r in part["ranks"]]


def mesh_analysis_child(cards: int) -> list:
    """:func:`mesh_analysis` of :func:`mesh_analysis_runs` in a child
    process that sees no card (so the fake world never shares a process
    with phases 11 and 12), held to :func:`mesh_analysis_gates`."""
    import os

    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.mesh_analysis_main({cards})")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT,
                         timeout=MESH_ANALYSIS_TIMEOUT_S)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("mesh_analysis ")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"13: the analysis process exited "
                           f"{res.returncode}:\n{res.stderr[-3000:]}")
    recs = json.loads(lines[-1][len("mesh_analysis "):])
    mesh_analysis_gates(recs)
    return recs


def run_mesh_analysis_phase(card: str, cards: int, mesh: dict,
                            mt: dict) -> dict:
    """Phase 13: :func:`mesh_analysis_child`, then each run's bound beside
    the step ms its phase measured (the share of the slowest rank's)."""
    t0 = time.perf_counter()
    recs = mesh_analysis_child(cards)
    for r in recs:
        r["measured_ms"] = measured_step_ms(r, mesh, mt)
        r["bound_share"] = r["bound_ms"] / max(r["measured_ms"])
    return {"card": card, "runs": recs, "wall_s": time.perf_counter() - t0}


def print_mesh_analysis_phase(ma: dict) -> None:
    card = ma["card"]
    for r in ma["runs"]:
        b, s = r["batch"]
        t = r["terms_ms"]
        print(f"mesh analysis: {r['arch']} x {r['layers']}L {r['shape']} "
              f"{b} x {s}" + (f", accumulation {r['grad_accum']}"
                              if r["grad_accum"] else "")
              + f" on {tuple(r['mesh'])} (phase {r['phase']}): per card "
              f"{r['flops_per_device']:.6e} FLOPs, "
              f"{r['hbm_bytes_per_device']:.6e} HBM bytes, "
              f"{r['collective_bytes_per_device']:.6e} collective bytes "
              f"{json.dumps(r['per_collective'])}; T_comp "
              f"{t['compute']:.3f} ms, T_mem {t['memory']:.3f} ms, T_coll "
              f"{t['collective']:.3f} ms (989 TFLOP/s, 3.35 TB/s, 450 GB/s "
              f"data sheet) -> bound {r['bound_ms']:.3f} ms "
              f"({r['dominant']}); measured step "
              f"{[round(v, 2) for v in r['measured_ms']]} ms a rank, bound"
              f" / slowest {r['bound_share']:.4f}; analysed in "
              f"{r['analyze_s']:.1f} s  [{card}]", flush=True)
    print(f"mesh analysis: phase {ma['wall_s']:.1f} s  [{card}]",
          flush=True)
    print("mesh_analysis_path " + json.dumps(ma), flush=True)


# ---------------------------------------------------------------------- #
# examples and analysis (phase 14): the port's static analysis in a child
# process, then the five examples/torch_*.py through their main(), the
# clustering ones on the card and again on the CPU
# ---------------------------------------------------------------------- #
EXAMPLES = ROOT / "examples"
ANALYSIS_TIMEOUT_S = 120
#: the passes ``python -m repro_torch.analysis --json`` must report
ANALYSIS_PASSES = ("concurrency-guards", "fault-tolerance-guards",
                   "hot-path-purity", "obs-discipline",
                   "protocol-exhaustiveness", "registry-conformance")
#: the clustering examples run on soa-device, and their insert batches
#: at their defaults (quickstart inserts its 2,000 points at once,
#: streaming 12,000 in batches of 1,000)
EXAMPLE_RUNS = (("torch_quickstart", 1), ("torch_streaming_clustering", 12))
EXAMPLE_BACKEND = "soa-device"
#: the train example's steps (its default)
EXAMPLE_TRAIN_STEPS = 300
EXAMPLES_BUDGET_S = 120


def analysis_child(root=None) -> dict:
    """``python -m repro_torch.analysis --json`` (over ``root``'s package
    tree when given) in a child process: it must exit 0 with 0 findings
    and report every pass of :data:`ANALYSIS_PASSES`."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(PKG.parent), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "repro_torch.analysis", "--json"]
    if root is not None:
        cmd += ["--root", str(root)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=ANALYSIS_TIMEOUT_S)
    try:
        report = json.loads(res.stdout)
    except json.JSONDecodeError:
        report = None
    if res.returncode != 0 or report is None or report["n_findings"]:
        found = "\n".join(f"{f['path']}:{f['line']}: {f['rule']} "
                          f"{f['message']}" for f in
                          (report or {}).get("findings", []))
        raise AssertionError(f"14: python -m repro_torch.analysis exited "
                             f"{res.returncode}:\n{found}\n"
                             f"{res.stderr[-3000:]}")
    if tuple(sorted(report["counts"])) != ANALYSIS_PASSES:
        raise AssertionError(f"14: the analysis ran {sorted(report['counts'])}"
                             f", not {list(ANALYSIS_PASSES)}")
    return {"counts": report["counts"], "n_findings": report["n_findings"],
            "wall_s": time.perf_counter() - t0}


def example_module(name: str):
    """``examples/<name>.py`` as a module (its ``main`` is not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list, **sizes) -> dict:
    """``examples/<name>.py``'s ``main(argv, **sizes)`` with its printed
    lines captured, the kernel launches it made and its wall seconds
    (ended by a synchronise where the card was used)."""
    import io

    import torch

    from repro_torch.kernels import ops

    buf = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        example_module(name).main(list(argv), **sizes)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"argv": list(argv), "sizes": sizes,
            "wall_s": time.perf_counter() - t0,
            "lines": buf.getvalue().splitlines(),
            "launches": ops.launch_counts(),
            "entry_launches": ops.entry_launch_counts()}


def printed_numbers(lines: list) -> list:
    """The numbers an example printed, but its seconds (``1.25s``)."""
    import re

    num = re.compile(r"(?<![\w.])-?\d+(?:\.\d+)?(?!\.?\d*s\b)")
    return [[float(v) for v in num.findall(ln)] for ln in lines]


def same_numbers(a: dict, b: dict, tag: str) -> None:
    """The two runs printed the same lines, numbers and all, but for
    their seconds."""
    got, want = printed_numbers(a["lines"]), printed_numbers(b["lines"])
    if len(a["lines"]) != len(b["lines"]) or got != want:
        raise AssertionError(f"14: {tag}: the card printed\n"
                             + "\n".join(a["lines"]) + "\nthe CPU\n"
                             + "\n".join(b["lines"]))


@contextlib.contextmanager
def prompt_switches():
    """A short switch interval while the curation example runs: its
    pipeline's producer thread runs one batch ahead of the counts it
    prints, and must not finish a batch in the few statements between
    the last batch taken and the print."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def run_examples_phase(device: str, card: str, *,
                       train_steps: int = EXAMPLE_TRAIN_STEPS,
                       analysis_root=None) -> dict:
    """Phase 14: the analysis (:func:`analysis_child`), then quickstart
    and streaming on ``soa-device`` on ``device`` and on the CPU, equal
    in every number they print but seconds, with ``lsh_hash_resolve``
    and ``bucket_insert_pass`` launched at least once per insert batch
    on the card; curation on ``soa-device`` on both, equal; serve and
    train (``train_steps``) on ``device``, train's flash launches
    counted.  Everything at the examples' defaults."""
    import tempfile

    t0 = time.perf_counter()
    out = {"card": card, "analysis": analysis_child(analysis_root),
           "runs": {}}
    on_card = device == "cuda"
    for name, batches in EXAMPLE_RUNS:
        argv = ["--backend", EXAMPLE_BACKEND]
        run = run_example(name, argv + ["--device", device])
        cpu = run_example(name, argv + ["--device", "cpu"])
        same_numbers(run, cpu, name)
        run["insert_batches"] = batches
        run["per_insert_batch"] = {e: run["entry_launches"][e] / batches
                                   for e in MAIN_ENTRIES}
        if on_card and min(run["per_insert_batch"].values()) < 1:
            raise AssertionError(f"14: {name}: launches a batch "
                                 f"{run['per_insert_batch']}")
        out["runs"][name] = {"card": run, "cpu": cpu}
    argv = ["--backend", EXAMPLE_BACKEND]
    with prompt_switches():
        run = run_example("torch_curation_pipeline",
                          argv + ["--device", device])
        cpu = run_example("torch_curation_pipeline",
                          argv + ["--device", "cpu"])
    same_numbers(run, cpu, "torch_curation_pipeline")
    if on_card and not min(run["entry_launches"][e] for e in MAIN_ENTRIES):
        raise AssertionError(f"14: torch_curation_pipeline: launches "
                             f"{run['entry_launches']}")
    out["runs"]["torch_curation_pipeline"] = {"card": run, "cpu": cpu}
    out["runs"]["torch_serve_lm"] = {"card": run_example(
        "torch_serve_lm", ["--device", device])}
    # the trainer's checkpoints go to the temporary directory
    with tempfile.TemporaryDirectory() as tmp:
        old, tempfile.tempdir = tempfile.tempdir, tmp
        try:
            run = run_example("torch_train_lm", [
                "--device", device, "--steps", str(train_steps)])
        finally:
            tempfile.tempdir = old
    if on_card and not run["launches"]["flash_attention"]:
        raise AssertionError(f"14: torch_train_lm: launches "
                             f"{run['launches']}")
    out["runs"]["torch_train_lm"] = {"card": run}
    out["wall_s"] = time.perf_counter() - t0
    return out


def print_examples_phase(ex: dict) -> None:
    card = ex["card"]
    a = ex["analysis"]
    print(f"examples: python -m repro_torch.analysis: {a['n_findings']} "
          f"finding(s), per pass {json.dumps(a['counts'])}, "
          f"{a['wall_s']:.1f} s", flush=True)
    for name, r in ex["runs"].items():
        run = r["card"]
        last = run["lines"][-1] if run["lines"] else ""
        print(f"examples: {name} {' '.join(run['argv'])}: "
              f"{run['wall_s']:.2f} s"
              + (f" (CPU {r['cpu']['wall_s']:.2f} s, equal)" if "cpu" in r
                 else "")
              + f"; launches {json.dumps(run['launches'])}"
              + (f", a batch {json.dumps(run['per_insert_batch'])}"
                 if "per_insert_batch" in run else "")
              + f"; last line: {last}  [{card}]", flush=True)
    print(f"examples: phase {ex['wall_s']:.1f} s (budget "
          f"{EXAMPLES_BUDGET_S} s)  [{card}]", flush=True)
    print("examples_path " + json.dumps(ex), flush=True)


# ---------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=STREAM_POINTS,
                    help="points in the stream (default 150,000 of the "
                         "paper's 200,000); fewer than 200,000 is a cut "
                         "and is printed")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        print(f"timeline: {phase} at {time.perf_counter() - t_start:.1f} s "
              f"from the start", flush=True)

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

    mark("phase 2 (build)")
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

    mark("phase 3 (main path)")
    # 3. main path
    if args.points != FULL_POINTS:
        print(f"main: CUT — {args.points} points instead of "
              f"{FULL_POINTS}", flush=True)
    metrics, last = run_main_path(args.points, "cuda")
    metrics["card"] = card
    metrics["build_s"] = build_s
    metrics["build"] = build
    print("main_path " + json.dumps(metrics), flush=True)

    mark("phase 3b (dict)")
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

    mark("phase 3c (approx)")
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
    del soa_c

    mark("phase 3e (sharded)")
    # 3e. sharded path: the coordinator over four soa-device shards on the
    #     card, in process (a), as worker processes (b) and as TCP workers
    #     with replicas through a killed primary (c)
    sharded = run_sharded_path(args.points, "cuda", kept, card)
    sa, sb, sc = sharded["a"], sharded["b"], sharded["c"]
    print(f"sharded (a): {SHARDS} soa-device shards, {sa['workers']} "
          f"threads, {sa['points']} points: insert "
          f"{sa['insert_pts_per_s']:.1f} points/s, delete "
          f"{sa['delete_pts_per_s']:.1f} points/s, labels() "
          f"{sa['labels_s_per_call']:.3f} s, label() "
          f"{sa['label_us_per_call']:.1f} us; a batch: coordinator hash "
          f"pass (_route_and_key) {sa['route_and_key_ms_per_batch']:.3f} "
          f"ms, fan-out {sa['fanout_ms_per_batch']:.3f} ms, the rest "
          f"{sa['rest_of_insert_ms_per_batch']:.3f} ms; launches "
          f"{sa['entry_launches']['lsh_hash_resolve']} + "
          f"{sa['entry_launches']['bucket_insert_pass']} for "
          f"{sa['sub_batches']} sub-batches; shard sizes "
          f"{sa['shard_sizes_before_rebalance']} -> "
          f"{sa['shard_sizes_after_rebalance']} (moved "
          f"{sa['rebalance_moved']}); vs phase 3: ARI "
          f"{sa['agreement_after_inserts']['ari']:.6f} / "
          f"{sa['agreement_after_deletes']['ari']:.6f}, outside the best "
          f"bijection {sa['agreement_after_inserts']['outside_best_bijection']}"
          f" / {sa['agreement_after_deletes']['outside_best_bijection']}; "
          f"phase {sa['wall_s']:.1f} s  [{card}]", flush=True)
    print("sharded (a) stats " + json.dumps(sa["stats"]), flush=True)
    print("sharded (a) obs report:\n  " + "\n  ".join(sa["report_top"]),
          flush=True)
    print(f"sharded (b): process transport, {len(sb['workers_pids'])} "
          f"workers on the card (pids {sb['workers_pids']}), "
          f"{sb['points']} points: insert {sb['insert_pts_per_s']:.1f} "
          f"points/s, spawn {sb['spawn_s']:.1f} s, round trips "
          f"{sb['round_trips']}, bytes sent {sb['bytes_sent']} / received "
          f"{sb['bytes_received']}; phase {sb['wall_s']:.1f} s  [{card}]",
          flush=True)
    print(f"sharded (c): tcp, 2 shards x (primary + 1 replica), "
          f"{sc['points']} points, primary of shard 0 killed after batch "
          f"{sc['killed_after_batch']}: no request failed, labels equal "
          f"the host oracle at {sc['label_checks']} checks; counters "
          f"{json.dumps(sc['counters'])}; phase {sc['wall_s']:.1f} s  "
          f"[{card}]", flush=True)
    print("sharded_path " + json.dumps(sharded), flush=True)
    gc.collect()

    mark("phase 4 (baselines)")
    # 4. baselines path
    print(f"baselines: CUT — Table 2 at {BASELINE_POINTS} points instead "
          f"of {TABLE2_POINTS}", flush=True)
    base, x_base = run_baselines(BASELINE_POINTS, "cuda")
    base["card"] = card
    print("baselines " + json.dumps(base), flush=True)

    mark("phase 5 (LM)")
    # 5. LM path: gemma3-27b prefill through the flash kernel, the kernel
    #    against its plain version, prefill vs decode, serving; then the
    #    kernel's timing and where a prefill / decode step spends its time
    lm, ctx = run_lm_path("cuda")
    lm["card"] = card
    print("lm_path " + json.dumps(lm), flush=True)
    flash = time_flash(ctx, lm["flash_launches_per_forward"],
                       lm["flash_check"], card, build)
    flash_bwd = time_flash_backward(card, build)
    lm_prof = profile_lm(ctx, "cuda")
    lm_prof["card"] = card
    lm_prof["flash_share_of_prefill_wall"] = (
        flash["launches"] * flash["ms"] / min(lm["prefill_ms"]))
    print("profile_lm " + json.dumps(lm_prof), flush=True)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()

    mark("phase 6 (kernels)")
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
                            masked_last) + [flash, flash_bwd]
    # lsh_hash's second path: batched-device's standalone entry
    row1 = next(k for k in kernels if k["name"] == "lsh_hash")
    row1.update({
        "batched_device_launches": dict_m["entry_launches"]["lsh_hash"],
        "batched_device_insert_batches": -(-args.points // BATCH),
        "batched_device_ms": kh["ms"],
        "batched_device_plain_ms": kh["plain_ms"]})
    # the main path's two entries on the sharded path, phase 3e (a): one
    # launch per non-empty sub-batch of each shard
    for k in kernels:
        if k["name"] in MAIN_ENTRIES:
            k["sharded_launches"] = sa["entry_launches"][k["name"]]
            k["sharded_sub_batches"] = sa["sub_batches"]
            sub = sa["sub_batch_check"]
            k["sharded_check"] = {
                "rows": sub["rows"], "shard": sub["shard"],
                "max_abs_err": sub[f"{k['name']}_max_abs_err"],
                "ms": sub[f"{k['name']}_ms"],
                "plain_ms": sub[f"{k['name']}_plain_ms"]}
    share = sum(k["launches"] * k["ms"] for k in kernels
                if k["name"] in MAIN_ENTRIES) / 1e3 / metrics["insert_s"]
    print(f"main-path kernel time (launches x ms per call) / insert wall "
          f"time: {share:.4f}  [{card}]", flush=True)

    mark("phase 7 (profile)")
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
    del last, window
    gc.collect()
    torch.cuda.empty_cache()

    mark("phase 8 (train)")
    # 8. training path: (a) phase 3's index through save_index /
    #    restore_index on the card, (b) the trainer's curation on the
    #    card, (c) the trainer at full width, (d) its own protocol
    tr = run_train_phase(args.points, "cuda", kept, card)
    del kept
    ta, tb, tc, td = tr["a"], tr["b"], tr["c"], tr["d"]
    print(f"train (a): soa-device index saved after batch "
          f"{ta['saved_after_batch']} ({ta['bytes']} bytes, save "
          f"{ta['save_s']:.3f} s, restore onto the card "
          f"{ta['restore_s']:.3f} s), then {ta['restored_insert_batches']}"
          f" insert and {ta['restored_delete_batches']} delete batches "
          f"equal to phase 3; launches {json.dumps(ta['entry_launches'])};"
          f" part {ta['wall_s']:.1f} s  [{card}]", flush=True)
    print(f"train (b): curation on soa-device beside host soa, "
          f"{tb['batches']} batches of {tb['batch']}: masks, ids and "
          f"labels() equal every batch ({tb['clusters']} clusters, "
          f"{tb['noise_points']} noise points at the end), kept "
          f"{tb['kept']}/{tb['seen']}, {tb['device_ms_per_batch']:.3f} / "
          f"{tb['host_soa_ms_per_batch']:.3f} ms a batch; launches "
          f"{json.dumps(tb['entry_launches'])}; part {tb['wall_s']:.1f} s"
          f"  [{card}]", flush=True)
    ts = tc["flash_at_train_shape"]
    print(f"train (c): {tc['arch']} x {tc['n_layers']} layers, "
          f"{tc['params']} parameters, batch {tc['batch']} x "
          f"{tc['seq']}: step {tc['step_ms_median_3_on']:.1f} ms (median "
          f"of steps 3-{tc['steps']}), {tc['tokens_per_s']:.1f} tokens/s, "
          f"peak {tc['peak_bytes'] / 1e9:.2f} GB, device busy "
          f"{tc['profile_step']['device_busy_share']:.4f} of a step; loss "
          f"{tc['losses'][0]:.4f} -> {tc['losses'][-1]:.4f}; step 1 vs "
          f"plain attention: loss rel {tc['step1']['loss_rel_err']:.2e}, "
          f"grad norm rel {tc['step1']['grad_norm_rel_err']:.2e} (bounds "
          f"{TRAIN_LOSS_RTOL:.0e} / {TRAIN_GNORM_RTOL:.0e}; planted faults "
          + ", ".join(f"{kind} {e['loss_rel_err']:.2e} / "
                      f"{e['grad_norm_rel_err']:.2e}" for kind, e in
                      tc["step1"]["planted_faults"].items())
          + f"); flash "
          f"launches {tc['flash_launches']} ({tc['flash_sm90_launches']} "
          f"sm90); at {ts['shape']}: {ts['ms']:.4f} ms, plain "
          f"{ts['plain_ms']:.3f}, SDPA {ts['library_ms']:.4f}, bound "
          f"{ts['bound_ms']:.4f} ms; part {tc['wall_s']:.1f} s  [{card}]",
          flush=True)
    print(f"train (d): {' '.join(td['config'])}, 30 steps at lr 1e-2: "
          f"loss {td['first_3_mean']:.4f} (first 3) -> "
          f"{td['last_5_mean']:.4f} (last 5); resumed for "
          f"{len(td['resumed_losses'])} steps; checkpoints "
          f"{td['checkpoints']} ({td['checkpoint_bytes']} bytes); part "
          f"{td['wall_s']:.1f} s  [{card}]", flush=True)
    print("train_path " + json.dumps(tr), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    mark("phase 9 (families)")
    print(f"families: CUT — serving prompts of {FAMILY_SERVE_PROMPT[0]}-"
          f"{FAMILY_SERVE_PROMPT[1]} tokens instead of {SERVE_PROMPT_MIN}-"
          f"{SERVE_PROMPT_MAX}", flush=True)
    # 9. families: the moe, vlm, ssm, hybrid and audio archs at their
    #    published widths, each through a bf16 forward and clustered
    #    serving; launch.serve's defaults; the flash kernel at the shapes
    #    these models give it
    fam = run_families_phase("cuda", card)
    sd = fam["serve_defaults"]
    print(f"families: launch.serve defaults ({sd['argv']}): "
          f"{sd['requests']} requests, {sd['generated_tokens']} tokens in "
          f"{sd['wall_s']:.2f} s  [{card}]", flush=True)
    for r in fam["flash_shapes"]:
        print(f"families: flash_attention {r['tag']} {r['shape']} kv heads "
              f"{r['kv_heads']} skv {r['skv']} causal {r['causal']}: err "
              f"{r['max_abs_err']:.3e} bf16 / {r['max_abs_err_f32']:.3e} "
              f"f32; {r['ms']:.4f} ms, plain {r['plain_ms']:.3f}, SDPA "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms  "
              f"[{card}]", flush=True)
    print(f"families: phase {fam['wall_s']:.1f} s  [{card}]", flush=True)
    print("families_path " + json.dumps(fam), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    mark("phase 10 (cells)")
    # 10. cells: the reference's (arch x shape) grid through
    #     launch.cells.build_cell, each cut printed, the flash kernel held
    #     against its plain version at 32,768 rows
    cells = run_cells_phase("cuda", card)
    print(f"cells: {len(cells['cells'])} cells; phase {cells['wall_s']:.1f}"
          f" s  [{card}]", flush=True)
    print("cells_path " + json.dumps(cells), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    mark("phase 11 (mesh)")
    # 11. mesh: the models' mesh path in a world of one process per card
    mesh = run_mesh_phase(card)
    print_mesh_phase(mesh)
    gc.collect()
    torch.cuda.empty_cache()

    mark("phase 12 (mesh train)")
    # 12. training on the mesh: the train step on a (1, 1) DeviceMesh
    #     against the unsharded step, the expert-parallel backward, a
    #     checkpoint restart; with n >= 2 cards a world of min(4, n)
    mt = run_mesh_train_phase(card)
    print_mesh_train_phase(mt)

    mark("phase 13 (mesh analysis)")
    # 13. the per-card step analysis of phases 11 and 12's configurations
    #     (a process of its own, no card), their bounds beside the
    #     measured steps
    print_mesh_analysis_phase(run_mesh_analysis_phase(card, count, mesh,
                                                      mt))

    mark("phase 14 (examples and analysis)")
    # 14. python -m repro_torch.analysis, then the five examples/torch_*.py
    #     (quickstart, streaming and curation on the card and the CPU)
    ex = run_examples_phase("cuda", card)
    print_examples_phase(ex)
    for k in kernels:  # a kernel's launches, or a route's (its entry's)
        k["examples_launches"] = {
            name: r["card"]["launches"].get(
                k["name"], r["card"]["entry_launches"].get(k["name"], 0))
            for name, r in ex["runs"].items()}
    for k in kernels:
        if k["name"] == "flash_attention":
            k["families_launches"] = {
                arch: m["flash_launches_per_forward"]
                for arch, m in fam["archs"].items()}
            k["families_checks"] = fam["flash_shapes"]
        if k["name"] in MAIN_ENTRIES:
            k["restored_index_launches"] = ta["entry_launches"][k["name"]]
            k["curation_launches"] = tb["entry_launches"][k["name"]]
            cur = tb["pass_check"]
            k["curation_check"] = {
                "rows": cur["rows"],
                "max_abs_err": cur[f"{k['name']}_max_abs_err"],
                "ms": cur[f"{k['name']}_ms"],
                "plain_ms": cur[f"{k['name']}_plain_ms"]}
        if k["name"] == "flash_attention":
            k["cells_launches"] = {f"{m['arch']} x {m['shape']}":
                                   m["flash_launches"]
                                   for m in cells["cells"]}
            k["cells_checks"] = [dict(r, cell=f"{m['arch']} x {m['shape']}")
                                 for m in cells["cells"]
                                 for r in m["flash_checks"]]
            k["mesh_launches_per_rank"] = {
                f"{a['arch']} x {a['layers']}L on {a['mesh']}, rank "
                f"{r['rank']}": a["own"]["flash_launches"]
                for part in mesh["parts"] for r in part["ranks"]
                for a in r["archs"]}
            k["train_launches"] = tc["flash_launches"]
            k["train_steps"] = tc["steps"]
            k["train_protocol_launches"] = td["flash_launches"]
            k["train_shape"] = ts
            k["mesh_train_launches_per_rank"] = {
                f"{mt['a']['arch']} x {mt['a']['layers']}L on "
                f"{mt['a']['mesh']}, rank 0": mt["a"]["flash_launches"]}
            if "multi" in mt:
                k["mesh_train_launches_per_rank"].update({
                    f"{mt['a']['arch']} x {mt['a']['layers']}L on "
                    f"{mt['multi']['mesh']}, rank {r['rank']}":
                    r["flash_launches"] for r in mt["multi"]["ranks"]})
            k["mesh_train_steps"] = mt["a"]["steps"]
            k["mesh_train_checks"] = mt["a"]["flash_check"]
        if k["name"] == "attention_bwd_sm90":
            # the trainer's backwards, each phase asserted all on the kernel
            k["launches"] = tc["bwd_launches"]["kernel"]
            k["train_steps"] = tc["steps"]
            k["train_protocol_launches"] = td["bwd_launches"]
            k["cells_launches"] = {f"{m['arch']} x {m['shape']}":
                                   m["bwd_launches"]
                                   for m in cells["cells"]
                                   if m["kind"] == "train"}
            k["mesh_train_launches_per_rank"] = {
                f"{mt['a']['arch']} x {mt['a']['layers']}L on "
                f"{mt['a']['mesh']}, rank 0": mt["a"]["bwd_launches"]}
            if "multi" in mt:
                k["mesh_train_launches_per_rank"].update({
                    f"{mt['a']['arch']} x {mt['a']['layers']}L on "
                    f"{mt['multi']['mesh']}, rank {r['rank']}":
                    r["bwd_launches"] for r in mt["multi"]["ranks"]})
    mark("the end")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
