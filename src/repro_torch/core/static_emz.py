"""EMZ — the static near-linear DBSCAN of Esfandiari et al. (AAAI'21).

Vectorised batch implementation, ported from ``repro.core.static_emz``
as host numpy/scipy over the port's :class:`GridLSH`.  It is the paper's
main baseline ("hash values for incoming points are computed once, and
the graph is recomputed after processing each batch", backend
``emz-static``).  With the same LSH family and the paper's Definition-4
core rule its connected components match the dynamic structure's
exactly, because H is invariant to update order (§4.2).

Core rule: Definition 4 (any of the t buckets has >= k members).  The
original EMZ paper used a dedicated hash function for core determination;
the dynamic paper redefines cores over all t tables, and for a meaningful
equivalence test we follow the dynamic paper's definition here too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from .dynamic_dbscan import NOISE
from .hashing import GridLSH


def _bucket_ids(codes_i: np.ndarray) -> np.ndarray:
    """(n, d) int64 codes -> (n,) dense bucket ids for one table."""
    _, inv = np.unique(codes_i, axis=0, return_inverse=True)
    return inv


def emz_cluster(
    X: np.ndarray,
    k: int,
    eps: float,
    t: int,
    seed: int = 0,
    lsh: Optional[GridLSH] = None,
    return_core: bool = False,
) -> np.ndarray:
    """Cluster X; returns labels (noise = -1), optionally the core mask.

    O(t·n·(d + log n)) — one sort per table dominates.
    """
    X = np.asarray(X, dtype=np.float64)
    n, d = X.shape
    if lsh is None:
        lsh = GridLSH(d, eps, t, seed)
    codes = lsh.codes_batch(X)  # (n, t, d)

    core = np.zeros(n, dtype=bool)
    bucket_of = np.empty((t, n), dtype=np.int64)
    for i in range(t):
        b = _bucket_ids(codes[:, i, :])
        bucket_of[i] = b
        sizes = np.bincount(b)
        core |= sizes[b] >= k

    rows, cols = [], []
    core_idx = np.flatnonzero(core)
    for i in range(t):
        b = bucket_of[i]
        # chain CORE points within each bucket in index order (paper's path)
        bc = b[core_idx]
        order = np.argsort(bc, kind="stable")  # core_idx already ascending
        s = core_idx[order]
        same = bc[order][1:] == bc[order][:-1]
        rows.append(s[:-1][same])
        cols.append(s[1:][same])

    # attach non-core points to one colliding core point (if any)
    attached_to = np.full(n, -1, dtype=np.int64)
    for i in range(t):
        b = bucket_of[i]
        nb = int(b.max()) + 1 if n else 0
        # first (lowest-index) core point per bucket
        first_core = np.full(nb, -1, dtype=np.int64)
        bc = b[core_idx]
        # reversed so the lowest index wins the final write
        first_core[bc[::-1]] = core_idx[::-1]
        cand = first_core[b]
        take = (~core) & (attached_to < 0) & (cand >= 0)
        attached_to[take] = cand[take]

    att = np.flatnonzero(attached_to >= 0)
    rows.append(att)
    cols.append(attached_to[att])

    rows = np.concatenate(rows) if rows else np.empty(0, dtype=np.int64)
    cols = np.concatenate(cols) if cols else np.empty(0, dtype=np.int64)
    g = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, comp = connected_components(g, directed=False)

    labels = comp.astype(np.int64)
    labels[(~core) & (attached_to < 0)] = NOISE
    if return_core:
        return labels, core
    return labels


class EMZRecompute:
    """Streaming wrapper: recompute the EMZ clustering after every batch
    (the paper's 'EMZ' baseline).  Hash codes are computed once per point
    and cached; the graph/labels are rebuilt from scratch per batch."""

    def __init__(self, d: int, k: int, t: int, eps: float, seed: int = 0,
                 lsh: Optional[GridLSH] = None):
        self.k, self.t, self.eps = k, t, eps
        self.lsh = lsh if lsh is not None else GridLSH(d, eps, t, seed)
        self._X: list = []

    def add_batch(self, Xb: np.ndarray) -> np.ndarray:
        self._X.append(np.asarray(Xb, dtype=np.float64))
        X = np.concatenate(self._X, axis=0)
        return emz_cluster(X, self.k, self.eps, self.t, lsh=self.lsh)
