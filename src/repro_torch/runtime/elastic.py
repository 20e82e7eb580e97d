"""Elastic re-mesh planning: membership change -> new mesh + restore plan.

Policy (1000+-node fleets): the ``model`` (and EP) extent is fixed by the
architecture's sharding; elasticity happens on the data-parallel axes.  On
failure we keep the largest slice of surviving hosts whose chip count is a
multiple of the model extent with a power-of-two DP degree, rebuild the
mesh, reshard the latest durable checkpoint (CheckpointManager restores by
PartitionSpec, so any DP degree works), and rescale grad-accumulation to
preserve the global batch.

The port's own copy of ``repro.runtime.elastic`` (pure Python): the same
plans for the same membership.  The port's ``CheckpointManager`` writes
each leaf's spec and restores onto any mesh (``restore(...,
shardings=)``), so a plan's new mesh takes the saved state
(``tests/test_torch_mesh_restart.py``: (4, 2) to (2, 2)).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    hosts: Tuple[int, ...]        # surviving hosts to keep
    data_parallel: int            # new DP degree
    model_parallel: int
    grad_accum: int               # rescaled to preserve global batch
    dropped_hosts: Tuple[int, ...]


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_remesh(
    alive_hosts: List[int],
    chips_per_host: int,
    model_parallel: int,
    global_batch: int,
    microbatch: int,
) -> Optional[ElasticPlan]:
    """Choose the new (DP, accum) after a membership change.

    Returns None when no viable mesh exists (fewer chips than one model
    replica)."""
    total_chips = len(alive_hosts) * chips_per_host
    if total_chips < model_parallel:
        return None
    max_dp = total_chips // model_parallel
    dp = _pow2_floor(max_dp)
    need_hosts = dp * model_parallel // chips_per_host
    need_hosts = max(need_hosts, 1)
    keep = tuple(sorted(alive_hosts)[:need_hosts])
    dropped = tuple(sorted(set(alive_hosts) - set(keep)))
    # preserve the global batch: accum × dp × microbatch == global_batch
    denom = dp * microbatch
    accum = max(1, -(-global_batch // denom))
    return ElasticPlan(
        hosts=keep, data_parallel=dp, model_parallel=model_parallel,
        grad_accum=accum, dropped_hosts=dropped,
    )
