"""Synthetic datasets for the paper's experiments.

``blobs`` is exactly the paper's synthetic dataset (mixture of Gaussians,
n=200k, d=10, 10 clusters by default), drawn with numpy from a seed, so
the port makes the same data as ``repro.data.synthetic`` without JAX.
The table-1 stand-ins (``dataset_standin``) come with a later slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# (n, d, n_clusters) from the paper's Table 1 (post-PCA dims where applied)
DATASET_SPECS: Dict[str, Tuple[int, int, int]] = {
    "letter": (20000, 16, 26),
    "mnist": (70000, 20, 10),
    "fashion-mnist": (70000, 20, 10),
    "blobs": (200000, 10, 10),
    "kddcup99": (494000, 20, 23),
    "covertype": (581012, 54, 7),
}


def blobs(
    n: int = 200000,
    d: int = 10,
    n_clusters: int = 10,
    cluster_std: float = 0.25,
    spread: float = 4.0,
    seed: int = 0,
    standardize: bool = True,
):
    """Mixture-of-Gaussians blobs; returns (X, labels)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n_clusters, d))
    labels = rng.integers(0, n_clusters, size=n)
    X = centers[labels] + rng.normal(0.0, cluster_std, size=(n, d))
    if standardize:
        X = (X - X.mean(axis=0)) / (X.std(axis=0) + 1e-12)
    return X.astype(np.float64), labels.astype(np.int64)
