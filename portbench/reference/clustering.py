"""Plain reference of the curation the trainer's pipeline runs: the
paper's grid-LSH DBSCAN (Esfandiari, Mirrokni and Zhong, Definition 4;
the port's ``DynamicDBSCAN``) over a sliding window of example
embeddings, and the ``balance`` policy's keep masks.

Semantics, point by point in id order (ids 0, 1, ... as inserted):

* table ``i`` puts ``x`` in the bucket of its grid code
  ``floor((x + eta_i) / (2 eps))``, computed in float32 as the card's
  hash kernel computes it (a frozen copy of that arithmetic: ``eta``
  drawn by ``numpy.random.default_rng(seed).uniform(0, 2 eps, t)``);
  buckets are keyed by the code itself, not by the kernel's 64-bit mix
  of it (the two differ only on a mix collision, ~2^-64);
* a point's support is the number of its buckets holding ``k`` or more
  points; a point is core while its support is above 0;
* cores that share a bucket are in one cluster (connected components);
* a non-core point takes, when it arrives, the cluster of the cores in
  the first of its buckets (in table order) that holds one; a point
  that becomes core drops its cluster of arrival; a new core takes
  every unattached non-core point of its buckets that hold fewer than
  ``k`` points, new cores in id order; the rest is noise (``-1``).

Departure: the window's deletes (and the demotions and re-attachments
they cause) are not implemented; :meth:`PlainCuration.filter` raises if
the window would expire a point.  No cell here fills its window.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

NOISE = -1


class PlainCuration:
    def __init__(self, d: int, k: int, t: int, eps: float, seed: int,
                 window: int, max_per_cluster_frac: float,
                 policy: str = "balance"):
        if policy != "balance":
            raise ValueError(f"policy {policy!r} is not in this reference")
        self.k, self.t, self.window = int(k), int(t), int(window)
        self.max_frac = float(max_per_cluster_frac)
        eta = np.random.default_rng(seed).uniform(0.0, 2.0 * eps, size=t)
        self.eta = eta.astype(np.float32)
        self.inv_cell = np.float32(1.0 / (2.0 * eps))
        self.buckets: List[Dict[bytes, List[int]]] = [{} for _ in range(t)]
        self.keys: List[List[bytes]] = []
        self.support: List[int] = []
        self.attach: List[int] = []       # anchor core, -1 for none

    def _codes(self, X: np.ndarray) -> np.ndarray:
        X32 = np.asarray(X, dtype=np.float32)
        return np.floor((X32[:, None, :] + self.eta[None, :, None])
                        * self.inv_cell).astype(np.int64)

    def _insert(self, keys: List[bytes]) -> None:
        p = len(self.keys)
        self.keys.append(keys)
        self.support.append(0)
        self.attach.append(-1)
        promoted = set()
        for i, key in enumerate(keys):
            b = self.buckets[i].setdefault(key, [])
            b.append(p)
            if len(b) == self.k:
                for y in b:
                    self.support[y] += 1
                    if self.support[y] == 1:
                        promoted.add(y)
            elif len(b) > self.k:
                self.support[p] += 1
                if self.support[p] == 1:
                    promoted.add(p)
        for c in sorted(promoted):
            self.attach[c] = -1
            for i, key in enumerate(self.keys[c]):
                b = self.buckets[i][key]
                if len(b) < self.k:
                    for y in b:
                        if (y != c and self.support[y] == 0
                                and self.attach[y] < 0):
                            self.attach[y] = c
        if self.support[p] == 0:
            for i, key in enumerate(keys):
                cores = [y for y in self.buckets[i][key]
                         if self.support[y] > 0]
                if cores:
                    self.attach[p] = min(cores)
                    break

    def labels(self) -> np.ndarray:
        """Per id: the smallest core id of its cluster, or ``NOISE``."""
        n = len(self.keys)
        parent = np.arange(n)

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for table in self.buckets:
            for members in table.values():
                cores = [y for y in members if self.support[y] > 0]
                for y in cores[1:]:
                    ra, rb = find(cores[0]), find(y)
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
        out = np.full(n, NOISE, dtype=np.int64)
        for p in range(n):
            if self.support[p] > 0:
                out[p] = find(p)
            elif self.attach[p] >= 0:
                out[p] = find(self.attach[p])
        return out

    def filter(self, X: np.ndarray) -> np.ndarray:
        """Insert the rows of ``X``; the ``balance`` keep mask of them:
        noise, or a cluster of at most ``max_per_cluster_frac`` of the
        window."""
        first = len(self.keys)
        if first + len(X) > self.window:
            raise NotImplementedError("the window's deletes are not in this "
                                      "reference")
        codes = self._codes(X)
        for row in codes:
            self._insert([row[i].tobytes() for i in range(self.t)])
        lab = self.labels()
        total = max(1, len(lab))
        groups, counts = np.unique(lab, return_counts=True)
        size = dict(zip(groups.tolist(), counts.tolist()))
        mine = lab[first:]
        return np.array([m == NOISE or size[m] / total <= self.max_frac
                         for m in mine.tolist()], dtype=bool)


def canonical(labels: Dict[int, int]) -> Dict[int, int]:
    """A partition ``{id: label}`` with each label replaced by the
    smallest id of its group (noise stays ``NOISE``)."""
    first: Dict[int, int] = {}
    for i in sorted(labels):
        lab = labels[i]
        if lab != NOISE:
            first.setdefault(lab, i)
    return {i: (NOISE if lab == NOISE else first[lab])
            for i, lab in labels.items()}
