"""Clustering quality metrics: ARI and NMI (sklearn-compatible semantics),
implemented from scratch (no sklearn dependency)."""

from __future__ import annotations

import numpy as np


def _contingency(a: np.ndarray, b: np.ndarray):
    a = np.asarray(a)
    b = np.asarray(b)
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    na, nb = ai.max() + 1, bi.max() + 1
    m = np.zeros((na, nb), dtype=np.int64)
    np.add.at(m, (ai, bi), 1)
    return m


def _comb2(x):
    return x * (x - 1) / 2.0


def adjusted_rand_index(labels_true, labels_pred) -> float:
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    if labels_true.shape != labels_pred.shape:
        raise ValueError(
            f"label shape mismatch: {labels_true.shape} vs "
            f"{labels_pred.shape}")
    # degenerate streams: no points, or a single point — the labellings
    # carry no pair information, and identical-partition conventions
    # (incl. two all-noise labellings) say perfect agreement
    if labels_true.size <= 1:
        return 1.0
    m = _contingency(labels_true, labels_pred)
    n = m.sum()
    sum_comb = _comb2(m).sum()
    sum_a = _comb2(m.sum(axis=1)).sum()
    sum_b = _comb2(m.sum(axis=0)).sum()
    exp = sum_a * sum_b / _comb2(n) if n > 1 else 0.0
    max_idx = 0.5 * (sum_a + sum_b)
    if max_idx == exp:
        return 1.0
    return float((sum_comb - exp) / (max_idx - exp))


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0].astype(np.float64)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def normalized_mutual_info(labels_true, labels_pred, average: str = "arithmetic") -> float:
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    if labels_true.shape != labels_pred.shape:
        raise ValueError(
            f"label shape mismatch: {labels_true.shape} vs "
            f"{labels_pred.shape}")
    if labels_true.size == 0:
        return 1.0
    m = _contingency(labels_true, labels_pred).astype(np.float64)
    n = m.sum()
    if n == 0:
        return 0.0
    pij = m / n
    pi = pij.sum(axis=1, keepdims=True)
    pj = pij.sum(axis=0, keepdims=True)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / (pi @ pj)[nz])).sum())
    hu = _entropy(m.sum(axis=1))
    hv = _entropy(m.sum(axis=0))
    if hu == 0.0 and hv == 0.0:
        return 1.0
    if average == "arithmetic":
        denom = 0.5 * (hu + hv)
    elif average == "geometric":
        denom = np.sqrt(hu * hv)
    else:
        raise ValueError(average)
    return float(mi / denom) if denom > 0 else 0.0
