"""Quickstart: dynamic DBSCAN through the port's repro_torch.api in a
dozen lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--backend dynamic] \
        [--device cuda]

``examples/quickstart.py`` over the port: the same flags, data and
printed lines.  ``--device`` is where a device backend (``soa-device``,
``batched-device``) runs: "cuda" by default, "cpu" for its kernels'
plain versions; a host backend runs on the host whatever it says.
"""
import argparse

import numpy as np

from repro_torch.api import ClusterConfig, available_backends, build_index
from repro_torch.api.registry import runs_on_device
from repro_torch.core import adjusted_rand_index
from repro_torch.data import blobs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="dynamic",
                    choices=available_backends())
    ap.add_argument("--device", default="cuda",
                    help="where a device backend runs (default: cuda)")
    args = ap.parse_args(argv)

    # 2000 points from 5 Gaussian blobs, streamed one at a time
    X, y = blobs(n=2000, d=5, n_clusters=5, cluster_std=0.15, seed=0)

    cfg = ClusterConfig(d=5, k=10, t=10, eps=0.4, seed=0,
                        backend=args.backend)
    db = build_index(cfg, device=args.device if runs_on_device(cfg) else None)
    ids = db.insert_batch(X)

    # clusters update dynamically: delete the first 500 points again
    db.delete_batch(ids[:500])

    labels = db.labels()                     # bulk labels (noise = -1)
    cluster_of_point_700 = db.label(ids[700])   # O(log n) point query

    pred = np.array([labels[i] for i in ids[500:]])
    print("backend:", args.backend)
    print("ARI vs ground truth:", round(adjusted_rand_index(y[500:], pred), 4))
    print("clusters:", len({v for v in pred if v != -1}),
          " noise points:", int((pred == -1).sum()))
    db.close()


if __name__ == "__main__":
    main()
