"""EMZFixedCore — the ablation variant proposed in the paper's §5, ported
from ``repro.core.fixed_core`` (host numpy, backend ``emz-fixed``).

Processes the initial batch with the EMZ method, then freezes the core set:
every subsequent point is treated as non-core and assigned to the cluster
of the first core point it collides with under any hash function (noise if
none).  Works well under random arrival order; degrades when clusters
arrive one at a time (Figure 2c).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .dynamic_dbscan import NOISE
from .hashing import GridLSH
from .static_emz import emz_cluster


class EMZFixedCore:
    def __init__(self, d: int, k: int, t: int, eps: float, seed: int = 0,
                 lsh: Optional[GridLSH] = None):
        self.k, self.t, self.eps = k, t, eps
        self.lsh = lsh if lsh is not None else GridLSH(d, eps, t, seed)
        self._initialised = False
        self._labels: list = []
        # bucket key -> cluster label of a core point in that bucket
        self._core_bucket_label: list = None

    def add_batch(self, Xb: np.ndarray) -> np.ndarray:
        Xb = np.asarray(Xb, dtype=np.float64)
        if not self._initialised:
            labels, core = emz_cluster(
                Xb, self.k, self.eps, self.t, lsh=self.lsh, return_core=True
            )
            self._labels = list(labels)
            self._core_bucket_label = [dict() for _ in range(self.t)]
            codes = self.lsh.codes_batch(Xb)
            for j in np.flatnonzero(core):
                for i in range(self.t):
                    key = codes[j, i].tobytes()
                    self._core_bucket_label[i].setdefault(key, int(labels[j]))
            self._initialised = True
            return np.asarray(self._labels)

        codes = self.lsh.codes_batch(Xb)
        for j in range(Xb.shape[0]):
            lab = NOISE
            for i in range(self.t):
                key = codes[j, i].tobytes()
                hit = self._core_bucket_label[i].get(key)
                if hit is not None:
                    lab = hit
                    break
            self._labels.append(lab)
        return np.asarray(self._labels)
