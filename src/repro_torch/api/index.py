"""``ClusterIndex`` — the one streaming interface over every engine.

The paper defines a single logical operation set (AddPoint / DeletePoint /
GetCluster); this class is that operation set as an API, so consumers
(serving, curation, benchmarks, examples) are written once and the engine
becomes a config key.  Concrete backends adapt the four engines in
``repro_torch.core`` — see :mod:`repro_torch.api.backends`.

Contract notes:
  * point indices are stable integer handles, unique among live points;
  * ``label(idx)`` is the backend's native point query (for the dynamic
    engines: ROOT on the Euler-tour forest, O(log n)); its value is an
    opaque cluster id, only comparable between two live points;
  * ``labels(ids)`` returns a canonical dense labelling with noise = -1,
    deterministic for a given structure state;
  * ``snapshot()`` / ``restore()`` round-trip the full structure through
    fixed-dtype numpy arrays (npz-serialisable), the same schema as
    ``repro.api``'s, so snapshots interchange between the two packages.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dynamic_dbscan import NOISE, check_unique_ids
from ..obs import make_obs
from .config import ClusterConfig
from .events import Delete, Insert


class ClusterIndex(abc.ABC):
    NOISE: int = NOISE

    #: True when the backend answers :meth:`component_of` /
    #: :meth:`core_anchor_of` from maintained structure (no recompute) —
    #: the capability the sharded incremental merge path requires of its
    #: inner engines.
    native_component_queries: bool = False

    def __init__(self, cfg: ClusterConfig):
        self.cfg = cfg
        #: per-index observability handle; the shared no-op NULL_OBS
        #: unless ``cfg.obs`` is set (see repro_torch.obs).
        self.obs = make_obs(cfg.obs)

    # ---------------------------------------------------------------- #
    # mutations
    # ---------------------------------------------------------------- #
    @abc.abstractmethod
    def insert(self, x: np.ndarray, idx: Optional[int] = None) -> int:
        """AddPoint(x) -> stable handle of the new point."""

    @abc.abstractmethod
    def delete(self, idx: int) -> None:
        """DeletePoint(idx); raises KeyError if idx is not live."""

    def insert_batch(self, X: np.ndarray,
                     ids: Optional[Sequence[Optional[int]]] = None) -> List[int]:
        """Insert the rows of X; backends with device hashing override
        this to amortise the hash over the whole batch."""
        X = np.asarray(X, dtype=np.float64)
        if ids is not None and len(ids) != X.shape[0]:
            raise ValueError("ids length must match batch size")
        return [
            self.insert(X[j], None if ids is None else ids[j])
            for j in range(X.shape[0])
        ]

    def delete_batch(self, ids: Sequence[int]) -> None:
        """Delete ``ids``; a duplicate id within one call raises KeyError
        naming the offending id (matching ``insert_batch``'s duplicate-pin
        behavior) before any point is removed."""
        check_unique_ids(ids)
        for i in ids:
            self.delete(i)

    def apply(self, updates: Iterable[Any]) -> List[Optional[int]]:
        """Apply a mixed stream of Insert/Delete events in order.

        Returns one entry per event: the assigned handle for an Insert,
        None for a Delete.  Maximal runs of consecutive Inserts are routed
        through :meth:`insert_batch` and maximal runs of consecutive
        Deletes through :meth:`delete_batch`, so batched backends hash
        each insert run in one kernel call and sharded backends fan both
        kinds of run out per shard — without reordering the stream.  (A
        duplicate id within one delete run therefore raises *before* any
        of the run is applied, per the ``delete_batch`` contract.)
        """
        out: List[Optional[int]] = []
        run_x: List[np.ndarray] = []
        run_ids: List[Optional[int]] = []
        run_del: List[int] = []

        def flush() -> None:
            if run_x:
                out.extend(self.insert_batch(np.stack(run_x), ids=run_ids))
                run_x.clear()
                run_ids.clear()
            if run_del:
                self.delete_batch(run_del)
                out.extend([None] * len(run_del))
                run_del.clear()

        for ev in updates:
            if isinstance(ev, Insert):
                if run_del:
                    flush()
                run_x.append(np.asarray(ev.x, dtype=np.float64))
                run_ids.append(ev.idx)
            elif isinstance(ev, Delete):
                if run_x:
                    flush()
                run_del.append(ev.idx)
            else:
                raise TypeError(f"not an Insert/Delete event: {ev!r}")
        flush()
        return out

    # ---------------------------------------------------------------- #
    # queries
    # ---------------------------------------------------------------- #
    @abc.abstractmethod
    def label(self, idx: int) -> int:
        """GetCluster(idx): the point's current cluster id."""

    @abc.abstractmethod
    def labels(self, ids: Optional[Iterable[int]] = None) -> Dict[int, int]:
        """Canonical labelling of ``ids`` (default: all live points);
        noise maps to :data:`NOISE` (-1)."""

    def component_of(self, idx: int) -> int:
        """The point's native component handle — same opacity contract as
        :meth:`label` (only comparable between two live points at one
        instant), but guaranteed to be the backend's *cheapest* point
        query (Euler-tour ROOT / union-find find for the maintained
        engines).  Default: ``label(idx)``."""
        return self.label(idx)

    def core_anchor_of(self, idx: int) -> Optional[int]:
        """The core point ``idx``'s membership rides on: itself if core,
        its anchor core if an attached border point, None if noise.  Only
        backends with ``native_component_queries`` answer this from
        structure; others raise."""
        raise NotImplementedError(
            f"{type(self).__name__} has no native core-anchor query"
        )

    def drain_deltas(
        self,
    ) -> Optional[List[Tuple[int, Optional[int], Optional[int]]]]:
        """Return and clear ``(idx, old, new)`` attachment deltas since the
        previous drain, or None when the backend does not track changes.

        A handle is the point itself (core), its anchor core (attached
        border), or None (noise / not live); the first call activates
        tracking and returns [].  Consumers re-query :meth:`label` for the
        listed ids instead of interpreting the handles globally.
        """
        return None

    @abc.abstractmethod
    def ids(self) -> List[int]:
        """Sorted handles of all live points."""

    @abc.abstractmethod
    def __contains__(self, idx: int) -> bool: ...

    @abc.abstractmethod
    def __len__(self) -> int: ...

    # ---------------------------------------------------------------- #
    # persistence
    # ---------------------------------------------------------------- #
    @abc.abstractmethod
    def _state(self) -> Dict[str, np.ndarray]: ...

    @abc.abstractmethod
    def _load_state(self, state: Dict[str, np.ndarray]) -> None: ...

    def snapshot(self) -> Dict[str, Any]:
        """Serialisable structure state: ``{"config": ..., "state": ...}``
        where every ``state`` value is a fixed-dtype numpy array."""
        return {"config": self.cfg.to_dict(), "state": self._state()}

    def restore(self, snapshot: Dict[str, Any]) -> None:
        """Load a snapshot into this (freshly built, empty) index."""
        cfg = ClusterConfig.from_dict(dict(snapshot["config"]))
        if cfg != self.cfg:
            raise ValueError(
                f"snapshot config {cfg} does not match index config {self.cfg}"
            )
        if len(self):
            raise ValueError("restore() requires an empty index")
        self._load_state(snapshot["state"])

    # ---------------------------------------------------------------- #
    # lifecycle
    # ---------------------------------------------------------------- #
    def close(self) -> None:
        """Release external resources (worker processes, sockets, thread
        pools).  No-op for in-process backends; idempotent.  The index is
        unusable afterwards."""

    def __enter__(self) -> "ClusterIndex":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ---------------------------------------------------------------- #
    # diagnostics
    # ---------------------------------------------------------------- #
    def check_invariants(self) -> None:
        """Structural self-check; no-op for recompute baselines."""

    def stats(self) -> Dict[str, int]:
        """Backend instrumentation counters (may be empty)."""
        return {}
