"""The port's runtime services against the JAX package's, on the CPU.

``repro_torch.runtime.straggler`` and ``.elastic`` are copies of the
reference's pure-Python modules: the same samples give the same EWMAs,
breaches and stragglers (fed directly and from an ``Obs`` metrics
snapshot), and the same membership gives the same re-mesh plan.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.runtime import StragglerDetector as JaxStraggler  # noqa: E402
from repro.runtime import plan_remesh as jax_plan_remesh  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.runtime import StragglerDetector, plan_remesh  # noqa: E402


def test_runtime_exports():
    assert {"HeartbeatRegistry", "StragglerDetector", "ElasticPlan",
            "plan_remesh"} <= set(dir(runtime))


@pytest.mark.parametrize("n_hosts,slow", [(1, None), (4, 2), (8, 5)])
def test_straggler_detector_matches_reference(n_hosts, slow):
    rng = np.random.default_rng(n_hosts)
    mine = StragglerDetector(n_hosts, alpha=0.3, threshold=1.5, patience=2)
    ref = JaxStraggler(n_hosts, alpha=0.3, threshold=1.5, patience=2)
    for step in range(12):
        for h in range(n_hosts):
            if rng.random() < 0.1:
                continue  # a missed sample
            t = float(rng.uniform(0.9, 1.1))
            if h == slow and step >= 4:
                t *= 3.0
            mine.record(h, t)
            ref.record(h, t)
        mine.update_breaches()
        ref.update_breaches()
        assert mine.stragglers() == ref.stragglers()
        for h in range(n_hosts):
            a, b = mine.ewma(h), ref.ewma(h)
            assert (np.isnan(a) and np.isnan(b)) or a == b
    if slow is not None:
        assert mine.stragglers() == [slow]


def test_straggler_from_obs_matches_reference():
    snap = {f"rpc.shard{h}_us": {"type": "histogram", "count": 3,
                                 "p50": 100.0 * (4 if h == 1 else 1)}
            for h in range(3)}
    snap["rpc.shard2_us"]["count"] = 0  # not fed
    mine, ref = StragglerDetector(3, patience=1), JaxStraggler(3, patience=1)
    for _ in range(3):
        assert mine.record_from_obs(snap) == ref.record_from_obs(snap)
    assert mine.stragglers() == ref.stragglers()
    assert [mine.ewma(h) for h in (0, 1)] == [ref.ewma(h) for h in (0, 1)]


@pytest.mark.parametrize("alive,chips,mp,gb,mb", [
    (list(range(16)), 4, 8, 256, 4), ([0, 2, 3, 5, 7], 4, 4, 64, 2),
    ([1], 8, 8, 32, 8), ([1], 4, 8, 32, 8), ([3, 1, 2], 1, 1, 10, 3),
    (list(range(100)), 8, 16, 4096, 1), ([], 4, 1, 8, 1)])
def test_plan_remesh_matches_reference(alive, chips, mp, gb, mb):
    mine = plan_remesh(alive, chips, mp, gb, mb)
    ref = jax_plan_remesh(alive, chips, mp, gb, mb)
    if ref is None:
        assert mine is None
    else:
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
