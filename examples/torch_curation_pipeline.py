"""Data-curation demo on the port: the dynamic-DBSCAN filter inside the
streaming pipeline — dominant topics get throttled, the topic mix evens
out.

    PYTHONPATH=src python examples/torch_curation_pipeline.py
    PYTHONPATH=src python examples/torch_curation_pipeline.py \
        --backend soa-device [--device cpu]

``examples/curation_pipeline.py`` over the port: the same stream, filter
and printed lines (the counts are read before the pipeline closes, since
its ``close`` waits for the producer, which runs one batch ahead).  ``--backend`` picks the filter's window index (the
reference's, ``batched``, by default); ``--device`` is where a device
backend (``soa-device``, ``batched-device``) runs: "cuda" by default,
"cpu" for its kernels' plain versions.
"""
import argparse

import numpy as np

from repro_torch.api import DEVICE_BACKENDS, available_backends
from repro_torch.data.pipeline import (CurationFilter, Pipeline,
                                       SyntheticTokenStream)


class SkewedStream(SyntheticTokenStream):
    """80% of examples come from topic 0."""
    def __iter__(self):
        for batch in super().__iter__():
            skew = self.rng.random(self.batch) < 0.8
            batch["topics"] = np.where(skew, 0, batch["topics"])
            batch["embeddings"][skew] = (
                self.topic_centers[0] + 0.05 * self.rng.normal(
                    size=(int(skew.sum()), self.embed_dim))
            )
            yield batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="batched",
                    choices=available_backends(),
                    help="the filter's window index (default: batched)")
    ap.add_argument("--device", default="cuda",
                    help="where a device backend runs (default: cuda)")
    args = ap.parse_args(argv)

    src = SkewedStream(vocab_size=1000, seq_len=32, batch=64, n_topics=8,
                       seed=0)
    cf = CurationFilter(
        d=src.embed_dim, k=8, t=8, eps=0.6, policy="balance",
        max_per_cluster_frac=0.3, backend=args.backend,
        device=args.device if args.backend in DEVICE_BACKENDS else None)
    pipe = Pipeline(iter(src), curation=cf)

    after = []
    for i in range(20):
        b = next(pipe)
        after.append(b["topics"])
    after = np.concatenate(after)
    frac0 = float((after == 0).mean())
    print(f"raw stream: 80% topic-0   curated stream: {frac0:.0%} topic-0")
    print(f"curation kept {cf.n_kept}/{cf.n_seen} examples "
          f"({cf.n_kept/cf.n_seen:.0%})")
    # after the counts: close() waits for the producer's batch in hand
    pipe.close()
    cf.close()


if __name__ == "__main__":
    main()
