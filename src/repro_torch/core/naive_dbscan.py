"""Exact DBSCAN — Algorithm 1 of the paper (Ester et al. 1996 variant).

A point is core iff at least k points (itself included) lie within its
eps-ball; the cluster graph connects every core point to everything in its
eps-ball; clusters are connected components; non-core points with no core
neighbour are noise.

This is the host baseline (backend ``naive``), ported from
``repro.core.naive_dbscan``: numpy float64 distances in row blocks, so
memory stays O(n·B), and scipy's connected components.  It does not call
the CUDA ``eps_neighbor_counts`` kernel, and the two compute different
functions: here the distances are float64 and the threshold is
``eps² + 1e-9``; the kernel (``repro_torch.kernels.ops``) works in float32
with the threshold ``float32(eps² + 1e-6)`` of the TPU kernel it
replaces, so counts at the eps boundary may differ between them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from .dynamic_dbscan import NOISE


def eps_neighbor_counts(X: np.ndarray, eps: float, block: int = 2048) -> np.ndarray:
    """|B(x, eps)| per point, computed in row blocks."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    sq = np.einsum("ij,ij->i", X, X)
    counts = np.zeros(n, dtype=np.int64)
    e2 = eps * eps
    for s in range(0, n, block):
        e = min(s + block, n)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (X[s:e] @ X.T)
        counts[s:e] = (d2 <= e2 + 1e-9).sum(axis=1)
    return counts


def dbscan(X: np.ndarray, k: int, eps: float, block: int = 2048) -> np.ndarray:
    """Exact Algorithm-1 DBSCAN; returns labels with noise = -1."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    counts = eps_neighbor_counts(X, eps, block)
    core = counts >= k
    sq = np.einsum("ij,ij->i", X, X)
    e2 = eps * eps
    rows, cols = [], []
    core_idx = np.flatnonzero(core)
    for s in range(0, len(core_idx), block):
        ci = core_idx[s : s + block]
        d2 = sq[ci, None] + sq[None, :] - 2.0 * (X[ci] @ X.T)
        r, c = np.nonzero(d2 <= e2 + 1e-9)
        rows.append(ci[r])
        cols.append(c)
    rows = np.concatenate(rows) if rows else np.empty(0, dtype=np.int64)
    cols = np.concatenate(cols) if cols else np.empty(0, dtype=np.int64)
    g = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    labels = comp.astype(np.int64)
    # points not adjacent to any core point are noise
    touched = np.zeros(n, dtype=bool)
    touched[np.unique(cols)] = True
    touched[core] = True
    labels[~touched] = NOISE
    return labels


class SklearnStyleDBSCAN:
    """Streaming wrapper matching the paper's SKLEARN baseline: full exact
    recluster after every batch."""

    def __init__(self, k: int, eps: float):
        self.k, self.eps = k, eps
        self._X: list = []

    def add_batch(self, Xb: np.ndarray) -> np.ndarray:
        self._X.append(np.asarray(Xb, dtype=np.float64))
        X = np.concatenate(self._X, axis=0)
        return dbscan(X, self.k, self.eps)
