"""Streaming training-data pipeline with background prefetch and
dynamic-DBSCAN curation (the paper's technique as a first-class feature).

The pipeline yields fixed-shape token batches; an optional
:class:`CurationFilter` clusters example embeddings *online* (insertions
for arriving examples, deletions for expired ones — exactly the paper's
Add/Delete workload) and applies a policy:

  * ``dedup``      drop examples landing in an over-dense cluster;
  * ``balance``    downsample dominant clusters to even coverage;
  * ``novelty``    keep only examples that are noise/low-density (e.g. for
                   replay-buffer style continual pretraining).

The host-side structure updates run on the prefetch thread — off the
accelerator critical path (async curation).

Mirror of ``repro.data.pipeline``: the same numpy draws and the same
call sequence on the window index (``insert_batch``, one ``delete`` per
expired id, ``labels(ids)``, ``labels()``), so the same stream gives the
same keep masks.  The index is built by ``repro_torch.api.build_index``
on ``device`` (``None``: the backend's default; a device backend such as
``soa-device`` runs on "cuda" then, ``device="cpu"`` runs its plain
kernels), because the device is not a config field in the port.

Both take ``obs`` (default the no-op :data:`~repro_torch.obs.NULL_OBS`).
``Pipeline`` records ``pipeline.next`` around each wait for a batch
(attribute ``batch``: the producer's sequence number of the source
batch).  ``CurationFilter`` records ``curation.filter`` (``batch``, its
call's number, and ``rows``) with the children ``curation.insert``,
``curation.delete`` (the window's expiries, ``n``) and
``curation.labels`` (both ``labels`` calls); the policy is the filter's
self time.  The filter hands its handle to the window index and its
engine, so their instruments (``engine.comp_rebuild_rows``) land in the
same registry.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..api import ClusterConfig, NOISE, build_index
from ..obs import NULL_OBS, Obs


class SyntheticTokenStream:
    """Deterministic synthetic LM token stream (documents with topical
    structure so curation has something to find)."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 n_topics: int = 16, embed_dim: int = 16, seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.n_topics = n_topics
        self.topic_centers = self.rng.normal(size=(n_topics, embed_dim))
        self.topic_token_bias = self.rng.integers(
            0, max(vocab_size - 100, 1), size=n_topics
        )
        self.embed_dim = embed_dim

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            topics = self.rng.integers(0, self.n_topics, size=self.batch)
            base = self.topic_token_bias[topics][:, None]
            toks = (base + self.rng.integers(0, 100, size=(self.batch, self.seq))) % self.vocab
            emb = self.topic_centers[topics] + 0.1 * self.rng.normal(
                size=(self.batch, self.embed_dim)
            )
            yield {
                "tokens": toks.astype(np.int32),
                "labels": np.roll(toks, -1, axis=1).astype(np.int32),
                "embeddings": emb.astype(np.float32),
                "topics": topics,
            }


class CurationFilter:
    """Online clustering of example embeddings with a sliding window."""

    def __init__(self, d: int, k: int = 10, t: int = 10, eps: float = 0.75,
                 policy: str = "balance", window: int = 50_000,
                 max_per_cluster_frac: float = 0.25, seed: int = 0,
                 backend: str = "batched", shards: int = 1,
                 transport: str = "local", device: Optional[str] = None,
                 obs: Obs = NULL_OBS):
        # shards > 1 shards the window by LSH key range (backend = inner);
        # transport="process" runs those shards out-of-process
        self.index = build_index(
            ClusterConfig(d=d, k=k, t=t, eps=eps, seed=seed,
                          backend=backend,
                          transport=transport).with_shards(shards),
            device=device,
        )
        self.obs = obs
        if obs.enabled:
            self.index.obs = obs
            engine = getattr(self.index, "engine", None)
            if engine is not None:
                engine.obs = obs
        self.policy = policy
        self.window = window
        self.max_frac = max_per_cluster_frac
        self._fifo: list = []
        self.n_seen = 0
        self.n_kept = 0
        self.n_calls = 0

    def filter(self, embeddings: np.ndarray) -> np.ndarray:
        """Returns a boolean keep-mask for the rows of ``embeddings``."""
        n = embeddings.shape[0]
        with self.obs.tracer.span("curation.filter", batch=self.n_calls,
                                  rows=n):
            self.n_calls += 1
            return self._filter(embeddings, n)

    def _filter(self, embeddings: np.ndarray, n: int) -> np.ndarray:
        tracer = self.obs.tracer
        with tracer.span("curation.insert"):
            ids = self.index.insert_batch(embeddings)
        self._fifo.extend(ids)
        # expire old points (sliding window -> DeletePoint workload)
        n_expired = max(0, len(self._fifo) - self.window)
        with tracer.span("curation.delete", n=n_expired):
            for _ in range(n_expired):
                self.index.delete(self._fifo.pop(0))
        with tracer.span("curation.labels"):
            labels = self.index.labels(ids)
            all_labels = self.index.labels()
        sizes: Dict[int, int] = {}
        for v in all_labels.values():
            sizes[v] = sizes.get(v, 0) + 1
        total = max(1, len(all_labels))
        keep = np.ones(n, dtype=bool)
        for j, idx in enumerate(ids):
            lab = labels[idx]
            if self.policy == "novelty":
                keep[j] = lab == NOISE
            elif self.policy == "balance":
                keep[j] = (lab == NOISE) or (
                    sizes.get(lab, 0) / total <= self.max_frac
                )
            elif self.policy == "dedup":
                keep[j] = (lab == NOISE) or sizes.get(lab, 0) < self.index.cfg.k * 4
        self.n_seen += n
        self.n_kept += int(keep.sum())
        return keep

    def close(self) -> None:
        """Shut down the window index (worker processes, if any)."""
        self.index.close()


class Pipeline:
    """Prefetching iterator: source -> (curation) -> bounded queue."""

    def __init__(self, source, curation: Optional[CurationFilter] = None,
                 prefetch: int = 4, obs: Obs = NULL_OBS):
        self.source = source
        self.curation = curation
        self.obs = obs
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        for seq, batch in enumerate(self.source):
            if self._stop.is_set():
                return
            if self.curation is not None:
                keep = self.curation.filter(batch["embeddings"])
                if keep.sum() == 0:
                    continue
                idx = np.flatnonzero(keep)
                # refill to the fixed batch size by repeating kept rows
                fill = np.resize(idx, batch["tokens"].shape[0])
                batch = {k: v[fill] for k, v in batch.items()}
            self.q.put((seq, batch))

    def __iter__(self):
        return self

    def __next__(self):
        with self.obs.tracer.span("pipeline.next") as sp:
            seq, batch = self.q.get()
            if sp is not None:
                sp.attrs["batch"] = seq
        return batch

    def close(self):
        """Stop the producer and wait for it: it finishes the batch in
        hand and exits at its next one; the queue is drained so that a
        producer blocked on a full queue wakes.  (``repro.data.pipeline``
        only sets the flag, and its producer keeps running the filter,
        on the card for a device backend, until the queue is full.)"""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(0.01)
