"""The port's data layer against the JAX package's, on the CPU.

- ``SyntheticTokenStream`` batches equal the reference's for the same
  seed, array for array.
- ``CurationFilter`` keep masks equal the reference's batch by batch,
  for the policies ``balance``, ``dedup`` and ``novelty``, on the
  backends ``batched``, ``soa``, ``soa-device`` (``device="cpu"``) and
  ``sharded`` (2 shards), over the trainer's stream cut to three topics
  with uniform rows added, through a window small enough that points
  expire.
- ``Pipeline`` keeps its fixed shape and yields the reference's batches.
- ``dataset_standin`` is equal for every name, in one process: it seeds
  with the per-process salted ``hash(name)``, as the reference does.
- ``DBSCANConfig`` is equal field for field.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import paper_dbscan as jax_paper  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.data.pipeline import CurationFilter as JaxCuration  # noqa: E402
from repro.data.pipeline import Pipeline as JaxPipeline  # noqa: E402
from repro.data.pipeline import SyntheticTokenStream as JaxStream  # noqa: E402
from repro_torch.configs import paper_dbscan  # noqa: E402
from repro_torch.data import DATASET_SPECS, dataset_standin  # noqa: E402
from repro_torch.data.pipeline import (CurationFilter, Pipeline,  # noqa: E402
                                       SyntheticTokenStream)


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (100, 16, 8, 0), (256, 32, 4, 1), (49152, 64, 8, 1), (50, 7, 3, 9)])
def test_synthetic_stream_matches_reference(vocab, seq, batch, seed):
    mine = _take(iter(SyntheticTokenStream(vocab, seq, batch, seed=seed)), 5)
    ref = _take(iter(JaxStream(vocab, seq, batch, seed=seed)), 5)
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert mine[0]["tokens"].shape == (batch, seq)
    assert (mine[0]["tokens"] < vocab).all()


BACKENDS = [("batched", 1, None), ("soa", 1, None),
            ("soa-device", 1, "cpu"), ("batched", 2, None)]


@pytest.mark.parametrize("policy", ["balance", "dedup", "novelty"])
@pytest.mark.parametrize("backend,shards,device", BACKENDS,
                         ids=["batched", "soa", "soa-device", "sharded"])
def test_curation_masks_match_reference(policy, backend, shards, device):
    # three topics (each cluster over max_per_cluster_frac and over
    # dedup's 4 k) and four uniform rows a batch (noise, for novelty)
    src = JaxStream(256, 8, 12, n_topics=3, seed=1)
    rng = np.random.default_rng(5)
    batches = [np.concatenate([b["embeddings"], rng.uniform(
        -3, 3, (4, src.embed_dim)).astype(np.float32)])
        for b in _take(iter(src), 14)]
    kw = dict(d=src.embed_dim, k=4, t=8, eps=0.6, policy=policy, window=96,
              max_per_cluster_frac=0.3)
    mine = CurationFilter(backend=backend, shards=shards, device=device,
                          **kw)
    ref = JaxCuration(backend=backend, shards=shards, **kw)
    if shards > 1:
        assert mine.index.cfg.backend == "sharded"
    kept = 0
    for e in batches:
        a, b = mine.filter(e), ref.filter(e)
        np.testing.assert_array_equal(a, b)
        kept += int(a.sum())
    assert (mine.n_seen, mine.n_kept) == (ref.n_seen, ref.n_kept)
    assert mine.index.labels() == ref.index.labels()
    assert len(mine.index) == 96
    # the masks are not trivial: some rows kept, some dropped
    assert 0 < kept < 14 * 16
    mine.close()
    ref.close()


def test_curation_balance_downsamples_dominant_cluster():
    """``tests/test_pipeline_serving.py``'s case, held equal."""
    rng = np.random.default_rng(0)
    dom = rng.normal(size=(300, 4)) * 0.05
    scat = rng.uniform(-6, 6, size=(60, 4))
    kw = dict(d=4, k=6, t=6, eps=0.5, policy="balance",
              max_per_cluster_frac=0.3, window=10_000)
    mine, ref = CurationFilter(**kw), JaxCuration(**kw)
    for x in (dom, scat):
        np.testing.assert_array_equal(mine.filter(x), ref.filter(x))
    assert mine.n_kept < mine.n_seen


def test_curation_sliding_window_deletes():
    cf = CurationFilter(d=3, k=4, t=4, eps=0.5, window=50)
    rng = np.random.default_rng(1)
    for _ in range(6):
        cf.filter(rng.normal(size=(20, 3)))
    assert len(cf.index) <= 50
    cf.index.check_invariants()


@pytest.mark.parametrize("curated", [False, True])
def test_pipeline_matches_reference_and_keeps_its_shape(curated):
    def build(stream, curation):
        src = stream(vocab_size=64, seq_len=8, batch=6, seed=2)
        cf = curation(d=16, k=4, t=4, eps=0.6, policy="balance") \
            if curated else None
        return Pipeline(iter(src), curation=cf, prefetch=2) \
            if stream is SyntheticTokenStream else \
            JaxPipeline(iter(src), curation=cf, prefetch=2), cf

    mine, mcf = build(SyntheticTokenStream, CurationFilter)
    ref, rcf = build(JaxStream, JaxCuration)
    for _ in range(6):
        a, b = next(mine), next(ref)
        assert a["tokens"].shape == (6, 8)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    mine.close()
    ref.close()
    if curated:
        assert mcf.n_seen >= 36


@pytest.mark.parametrize("name", sorted(DATASET_SPECS))
def test_dataset_standin_matches_reference(name):
    for seed in (0, 3):
        X, y = dataset_standin(name, seed=seed, scale=0.01)
        Xr, yr = jax_synthetic.dataset_standin(name, seed=seed, scale=0.01)
        np.testing.assert_array_equal(X, Xr)
        np.testing.assert_array_equal(y, yr)
    n, d, c = DATASET_SPECS[name]
    assert X.shape == (max(1000, int(n * 0.01)), d)
    assert set(np.unique(y)) <= set(range(-1, c))


def test_dbscan_config_matches_reference():
    mine = dataclasses.asdict(paper_dbscan.CONFIG)
    assert mine == dataclasses.asdict(jax_paper.CONFIG)
    assert [f.name for f in dataclasses.fields(paper_dbscan.DBSCANConfig)] \
        == [f.name for f in dataclasses.fields(jax_paper.DBSCANConfig)]
    cfg = paper_dbscan.DBSCANConfig(d=8, window=100)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_paper.DBSCANConfig(d=8, window=100))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.d = 3
