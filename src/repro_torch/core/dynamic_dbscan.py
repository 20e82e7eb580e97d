"""Helpers shared by the port's engines: the noise label and point-handle
bookkeeping of ``repro.core.dynamic_dbscan``.

Only ``NOISE``, ``claim_index`` and ``check_unique_ids`` are ported so far
— what the structure-of-arrays engine (:mod:`repro_torch.core.soa`), the
static baselines and the API need.  The dict engine ``DynamicDBSCAN`` (Euler-tour forest,
Algorithm 2) comes with a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

NOISE = -1


def claim_index(live, next_idx: int, idx: Optional[int]):
    """Resolve an explicit-or-auto point handle against a live-id set.

    Shared by every engine/adapter so handle assignment is identical
    across backends (the premise of the equivalence tests).  Returns
    ``(idx, new_next_idx)``; raises KeyError on duplicates.
    """
    if idx is None:
        idx = next_idx
    elif idx in live:
        raise KeyError(f"index {idx} already present")
    return idx, max(next_idx, idx + 1)


def check_unique_ids(ids) -> None:
    """Raise KeyError naming the first id appearing twice in ``ids`` —
    the shared ``delete_batch`` precondition (mirrors ``claim_index``'s
    duplicate-pin behavior on the insert side)."""
    seen = set()
    for i in ids:
        if i in seen:
            raise KeyError(f"duplicate id {i} in delete_batch")
        seen.add(i)
