"""What decides ``correct``: the program's readings against the
reference's, each number beside its limit.

* ``loss_gap``: the largest relative gap of a checked step's loss;
* ``grad_gap``: by the worst leaf, the gap between the program's norm
  of its first clipped gradient (from AdamW's first moment after step 1,
  ``m / (1 - b1)``) and the reference's, over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
* ``update_gap``: the same of each leaf's change over the checked steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (a leaf below that moves by round-off alone);
* ``keep_mismatch``: keep-mask rows that differ, over every batch the
  program's curation filtered;
* ``partition_mismatch``: points of the window whose cluster (as the
  smallest id of its group) or noise differs at the end.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Any, Dict

from .reference.clustering import canonical

#: leaves whose reference gradient is below this share of the median
#: leaf's are left out of ``update_gap``
TINY_GRAD = 1e-3


def _worst(prog: Dict[str, float], ref: Dict[str, float], leaves):
    """(gap, leaf) of the leaf whose norms differ most, over the
    reference's norm of that leaf or of the median leaf."""
    floor = median(ref[k] for k in leaves)
    return max((abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30), k)
               for k in leaves)


def _moved(ref: Dict[str, Any]):
    g = ref["first_grad"]
    g_med = median(g.values())
    return [k for k, v in g.items() if v >= TINY_GRAD * g_med]


def worst_leaves(prog: Dict[str, Any], ref: Dict[str, Any]):
    """The leaf that sets ``grad_gap`` and the one that sets
    ``update_gap`` (for the calibration's record)."""
    return {"grad_gap": _worst(prog["first_grad"], ref["first_grad"],
                               list(ref["first_grad"]))[1],
            "update_gap": _worst(prog["update"], ref["update"],
                                 _moved(ref))[1]}


def numbers(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    out["loss_gap"] = max(abs(p - r) / abs(r) for p, r in
                          zip(prog["losses"], ref["losses"], strict=True))
    out["grad_gap"] = _worst(prog["first_grad"], ref["first_grad"],
                             list(ref["first_grad"]))[0]
    out["update_gap"] = _worst(prog["update"], ref["update"],
                               _moved(ref))[0]
    pk, rk = prog["keeps"], ref["keeps"]
    bad = abs(len(pk) - len(rk))
    for a, b in zip(pk, rk):
        bad += int((a != b).sum()) if a.shape == b.shape else max(
            a.size, b.size)
    out["keep_mismatch"] = float(bad)
    pp, rp = canonical(prog["partition"]), canonical(ref["partition"])
    ids = set(pp) | set(rp)
    out["partition_mismatch"] = float(sum(pp.get(i, "missing")
                                          != rp.get(i, "missing")
                                          for i in ids))
    return out


def held(values: Dict[str, float], limits: Dict[str, float]):
    """``({name: {"value", "limit"}}, correct)``."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in checks.values())
    return checks, ok
