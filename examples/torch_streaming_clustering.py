"""The paper's core experiment, end to end, on the port: stream a dynamic
dataset into a ClusterIndex (insertions + sliding-window deletions) and
track clustering quality against the EMZ-recompute baseline — Figure 2's
workload at laptop scale.  Both clusterers are built through
repro_torch.api, so swapping engines is a CLI flag:

    PYTHONPATH=src python examples/torch_streaming_clustering.py
    PYTHONPATH=src python examples/torch_streaming_clustering.py \
        --backend soa-device                  # the CUDA kernels
    PYTHONPATH=src python examples/torch_streaming_clustering.py \
        --backend soa-device --device cpu     # their plain versions
    PYTHONPATH=src python examples/torch_streaming_clustering.py \
        --backend batched --shards 4 --transport process

``examples/streaming_clustering.py`` over the port: the same flags, data
and printed lines, plus ``--device``, where a device backend (and
``--shards`` over one) runs: "cuda" by default, "cpu" for its kernels'
plain versions; a host backend runs on the host whatever it says.
:func:`main`'s ``n`` cuts the stream (12,000 points) for the tests.
"""
import argparse
import time

import numpy as np

from repro_torch.api import ClusterConfig, available_backends, build_index
from repro_torch.api.registry import runs_on_device
from repro_torch.core import adjusted_rand_index
from repro_torch.data import blobs


def main(argv=None, *, n=12000):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="dynamic",
                    choices=available_backends())
    ap.add_argument("--baseline", default="emz-static",
                    choices=available_backends())
    ap.add_argument("--shards", type=int, default=0,
                    help="shard the engine under test across S LSH key "
                         "ranges")
    ap.add_argument("--transport", default="local",
                    choices=("local", "process"),
                    help="reach the shards in-process or as spawned servers")
    ap.add_argument("--sample-rate", type=float, default=0.2,
                    help="sampled-core fraction for --backend approx/tiered "
                         "(ignored by the exact engines)")
    ap.add_argument("--device", default="cuda",
                    help="where a device backend runs (default: cuda)")
    args = ap.parse_args(argv)

    def build(cfg):
        return build_index(
            cfg, device=args.device if runs_on_device(cfg) else None)

    d, batch = 8, 1000
    X, y = blobs(n=n, d=d, n_clusters=8, cluster_std=0.2, seed=3)
    cfg = ClusterConfig(d=d, k=10, t=10, eps=0.5, seed=0,
                        transport=args.transport,
                        sample_rate=args.sample_rate)

    dyn = build(cfg.replace(backend=args.backend).with_shards(args.shards))
    emz = build(cfg.replace(backend=args.baseline))

    t_dyn = t_emz = 0.0
    ids = []
    for s in range(0, n, batch):
        xb = X[s: s + batch]
        t0 = time.time()
        ids += dyn.insert_batch(xb)
        t_dyn += time.time() - t0
        t0 = time.time()
        emz.insert_batch(xb)
        emz_lab = emz.labels()
        t_emz += time.time() - t0
        lab = dyn.labels(ids)
        pred = np.array([lab[i] for i in ids])
        pred_e = np.array([emz_lab[i] for i in sorted(emz_lab)])
        ari_d = adjusted_rand_index(y[: s + batch], pred)
        ari_e = adjusted_rand_index(y[: s + batch], pred_e)
        print(f"n={s+batch:6d}  {args.backend} ARI={ari_d:.3f} "
              f"({t_dyn:5.2f}s cum)   {args.baseline} ARI={ari_e:.3f} "
              f"({t_emz:5.2f}s cum)")

    # sliding-window deletions: expire the first half
    t0 = time.time()
    dyn.delete_batch(ids[: n // 2])
    print(f"deleted {n//2} points in {time.time()-t0:.2f}s "
          f"(repair scans fired: {dyn.stats().get('n_repair_scans', 0)})")
    lab = dyn.labels(ids[n // 2:])
    pred = np.array([lab[i] for i in ids[n // 2:]])
    print("post-expiry ARI:", round(adjusted_rand_index(y[n // 2:], pred), 3))
    dyn.close()  # shuts shard worker processes down under --transport process
    emz.close()


if __name__ == "__main__":
    main()
