"""Serving entry point: continuous-batching engine with request clustering.

Mirror of ``repro.launch.serve``, plus ``--device`` (default ``cuda``)
and ``--cluster-backend`` (the engine's keyword; default, as there,
``batched``, which runs on the host whatever ``--device`` is; a device
backend, ``batched-device`` or ``soa-device``, runs on ``--device``;
``--tier RATE`` serves from the tiered index, on the host;
``--cluster-shards S`` shards the clustering index, its shards on
``--device`` over a device backend, reached by ``--cluster-transport``).
``--arch`` takes every id of :mod:`repro_torch.configs` and defaults, as
the reference does, to ``mamba2-780m``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve [--arch mamba2-780m] \\
      --smoke --requests 16 --batch 4 [--cluster [--cluster-backend soa-device]]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models.registry import build_model
from ..serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: cuda)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--kv-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--cluster", action="store_true",
                    help="dynamic-DBSCAN request clustering")
    ap.add_argument("--cluster-backend", default="batched",
                    help="request-clustering backend (repro_torch.api "
                         "registry key)")
    ap.add_argument("--cluster-shards", type=int, default=1,
                    help="shard the request-clustering window across S "
                         "LSH key ranges")
    ap.add_argument("--cluster-transport", default="local",
                    choices=("local", "process", "tcp"),
                    help="how the clustering shards are reached")
    ap.add_argument("--cluster-replicas", type=int, default=0,
                    help="replicas per clustering shard")
    ap.add_argument("--tier", type=float, default=None, metavar="RATE",
                    help="tiered request clustering (repro_torch.tiered): "
                         "serve labels from a sampled-core front tier at "
                         "this sample_rate while the exact tier verifies "
                         "on a thread (host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    eng = ServingEngine(model, params, batch=args.batch, kv_len=args.kv_len,
                        cluster_requests=args.cluster, embed_dim=8,
                        cluster_backend=args.cluster_backend,
                        cluster_shards=args.cluster_shards,
                        cluster_transport=args.cluster_transport,
                        cluster_replicas=args.cluster_replicas,
                        cluster_tier=args.tier)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(1, cfg.vocab_size, size=int(rng.integers(2, 8))),
            max_new_tokens=args.max_new,
            embedding=rng.normal(size=8) if args.cluster else None,
        ))
    done = eng.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in done.values())
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s) on {model.device}")
    for rid in sorted(done)[:4]:
        print(f"  req {rid}: {done[rid].out_tokens}")
    eng.close()
    return done


if __name__ == "__main__":
    main()
