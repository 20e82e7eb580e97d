"""Synthetic datasets for the paper's experiments.

``blobs`` is exactly the paper's synthetic dataset (mixture of Gaussians,
n=200k, d=10, 10 clusters by default), drawn with numpy from a seed, so
the port makes the same data as ``repro.data.synthetic`` without JAX.
The real datasets in Table 1 (Letter/MNIST/Fashion-MNIST/KDDCup99/
Covertype) are unavailable offline, so ``dataset_standin`` generates
distribution-matched stand-ins with the same (n, d, #clusters) and
standardisation, with the reference's numpy draws.
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


def dataset_standin(name: str, seed: int = 0, scale: float = 1.0):
    """Distribution-matched stand-in for one of the paper's datasets.

    Gaussian mixture with unequal cluster weights plus 5% uniform
    background noise (real datasets are not clean blobs); standardised to
    zero mean / unit variance per dimension like the paper's preprocessing.
    ``scale`` < 1 shrinks n for CI-speed runs.

    Seeded with ``seed + hash(name) % 2**31`` as the reference is.
    Python salts ``str`` hashes per process, so a stand-in is the same
    as the reference's in one process and differs between processes
    unless ``PYTHONHASHSEED`` is fixed.
    """
    n, d, c = DATASET_SPECS[name]
    n = max(1000, int(n * scale))
    rng = np.random.default_rng(seed + hash(name) % (2**31))
    centers = rng.uniform(-3.5, 3.5, size=(c, d))
    # unequal cluster weights (Zipf-ish), as in real data
    w = 1.0 / np.arange(1, c + 1)
    w /= w.sum()
    labels = rng.choice(c, size=n, p=w)
    stds = rng.uniform(0.15, 0.5, size=c)
    X = centers[labels] + rng.normal(0.0, 1.0, size=(n, d)) * stds[labels][:, None]
    # background noise points
    n_noise = n // 20
    noise_rows = rng.choice(n, size=n_noise, replace=False)
    X[noise_rows] = rng.uniform(-4.5, 4.5, size=(n_noise, d))
    labels[noise_rows] = -1
    X = (X - X.mean(axis=0)) / (X.std(axis=0) + 1e-12)
    return X.astype(np.float64), labels.astype(np.int64)
