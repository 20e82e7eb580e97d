"""Update events for the unified streaming API.

A workload is a plain iterable of :class:`Insert` / :class:`Delete`
events — the paper's AddPoint / DeletePoint operation set (Alg. 2) as
data, so one harness can drive any backend and mixed streams can be
logged, replayed, and sharded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Insert:
    """AddPoint(x).  ``idx`` pins an explicit stable handle (must be
    unused); ``None`` lets the index auto-assign the next free one."""

    x: np.ndarray
    idx: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Delete:
    """DeletePoint(idx)."""

    idx: int


Update = object  # Insert | Delete (3.10-friendly alias for annotations)
