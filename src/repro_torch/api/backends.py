"""Built-in backends of the port.

=================  ==================================================
key                engine
=================  ==================================================
``dynamic``        DynamicDBSCAN — the paper's Alg. 2 (exact host keys),
                   host only
``batched``        BatchedDynamicDBSCAN — batch hashing on the host
                   (mixed keys, the kernel's numpy mirror), host only
``batched-device`` BatchedDynamicDBSCAN(use_device=True) — one
                   ``lsh_hash`` call a batch on ``device`` ("cuda" by
                   default), host pointer updates
``soa``            SoADynamicDBSCAN — vectorised structure-of-arrays
                   core on the host (numpy mirror, no kernel)
``soa-device``     SoADynamicDBSCAN(use_device=True) — the lsh_hash and
                   bucket kernels on ``device`` ("cuda" by default)
``approx``         SampledCoreDBSCAN — the sampled-core tier (DBSCAN++
                   style, ``sample_rate`` / ``approx_seed``) on the host,
                   as in the reference
``tiered``         TieredIndex — ``approx`` serves, the host ``soa``
                   engine verifies on a thread (``repro_torch.tiered``);
                   host only, no kernel
``emz-static``     EMZ recompute-per-query baseline (Esfandiari et al.),
                   host only
``naive``          exact Algorithm-1 DBSCAN recompute-per-query
                   baseline, host only (float64 numpy; no kernel)
``emz-fixed``      EMZFixedCore §5 ablation (insert-only), host only
``sharded``        ShardedIndex — ``shards`` shards of ``inner_backend``
                   behind the wire protocol (``repro_torch.shard``,
                   ``transport`` local / process / tcp); on ``device``
                   ("cuda" by default) when the inner backend is a
                   device backend, else host only
=================  ==================================================

The recompute baselines are *lazy*: mutations only touch the point store;
the clustering runs from scratch on the first ``label``/``labels`` query
after a mutation (matching the paper's "recompute after each batch"
protocol when queried once per batch).  A host-only backend refuses any
device but ``None`` and "cpu"; the device backends are listed in
:data:`~repro_torch.api.registry.DEVICE_BACKENDS`.  The sampled tier's
device path is reached as in the reference, through the engine:
``ApproxIndex(cfg, SampledCoreDBSCAN(..., use_device=True,
device="cuda"))``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.approx import SampledCoreDBSCAN
from ..core.batched import BatchedDynamicDBSCAN
from ..core.dynamic_dbscan import DynamicDBSCAN, claim_index
from ..core.fixed_core import EMZFixedCore
from ..core.hashing import GridLSH
from ..core.naive_dbscan import dbscan
from ..core.soa import SoADynamicDBSCAN
from ..core.static_emz import emz_cluster
from .config import ClusterConfig
from .index import ClusterIndex
from .registry import register_backend

#: backends keyed by the float32 device-hash mixed keys rather than exact
#: int64 grid codes — consumers that must mirror an engine's bucket-key
#: space branch on this (the reference's list, ``approx`` included)
MIXED_KEY_BACKENDS = ("batched", "batched-device", "soa", "soa-device",
                      "approx")


class EulerTourIndex(ClusterIndex):
    """Adapter over the dynamic engines (shared DynamicDBSCAN machinery)."""

    native_component_queries = True

    def __init__(self, cfg: ClusterConfig, engine: DynamicDBSCAN):
        super().__init__(cfg)
        self.engine = engine
        # hand the engine this index's obs handle so structural telemetry
        # (repair depth) lands in the same registry as the adapter's ops
        engine.obs = self.obs
        # bind the native point query directly: adapter hops count on a
        # query made per point
        self.component_of = engine.get_cluster

    def insert(self, x: np.ndarray, idx: Optional[int] = None) -> int:
        return self.engine.add_point(x, idx=idx)

    def delete(self, idx: int) -> None:
        self.engine.delete_point(idx)

    def insert_batch(self, X, ids=None) -> List[int]:
        X = np.asarray(X, dtype=np.float64)
        if isinstance(self.engine, BatchedDynamicDBSCAN):
            return self.engine.add_batch(X, ids=ids)
        return super().insert_batch(X, ids=ids)

    def label(self, idx: int) -> int:  # hot-path
        return self.engine.get_cluster(idx)

    def labels(self, ids=None) -> Dict[int, int]:
        return self.engine.labels(ids)

    def core_anchor_of(self, idx):
        return self.engine.core_anchor(idx)  # O(1) support/attach lookup

    def drain_deltas(self):
        return self.engine.drain_deltas()

    def is_core(self, idx: int) -> bool:
        return self.engine.is_core(idx)

    def ids(self):
        return sorted(self.engine.points)

    def __contains__(self, idx):
        return idx in self.engine.points

    def __len__(self):
        return len(self.engine.points)

    def _state(self):
        return self.engine.state_dict()

    def _load_state(self, state):
        self.engine.load_state_dict(state)

    def check_invariants(self):
        self.engine.check_invariants()

    def stats(self):
        return {
            "n_repair_scans": self.engine.n_repair_scans,
            "n_repair_links": self.engine.n_repair_links,
            "n_links": self.engine.forest.n_links,
            "n_cuts": self.engine.forest.n_cuts,
        }


class SoAIndex(ClusterIndex):
    """Adapter over :class:`~repro_torch.core.soa.SoADynamicDBSCAN` — the
    vectorised structure-of-arrays engine: native point queries, O(1)
    core anchors, a drain_deltas change feed, and batch mutations as
    single array passes."""

    native_component_queries = True

    def __init__(self, cfg: ClusterConfig, engine: SoADynamicDBSCAN):
        super().__init__(cfg)
        self.engine = engine
        engine.obs = self.obs
        self.component_of = engine.get_cluster  # bind the native query

    def insert(self, x: np.ndarray, idx: Optional[int] = None) -> int:
        return self.engine.add_point(x, idx=idx)

    def delete(self, idx: int) -> None:
        self.engine.delete_point(idx)

    def insert_batch(self, X, ids=None) -> List[int]:
        return self.engine.add_batch(np.asarray(X, dtype=np.float64),
                                     ids=ids)

    def delete_batch(self, ids) -> None:
        self.engine.delete_batch([int(i) for i in ids])

    def label(self, idx: int) -> int:  # hot-path
        return self.engine.get_cluster(idx)

    def labels(self, ids=None) -> Dict[int, int]:
        return self.engine.labels(ids)

    def core_anchor_of(self, idx):
        return self.engine.core_anchor(idx)

    def drain_deltas(self):
        return self.engine.drain_deltas()

    def is_core(self, idx: int) -> bool:
        return self.engine.is_core(idx)

    def ids(self):
        return sorted(self.engine._row)

    def __contains__(self, idx):
        return idx in self.engine

    def __len__(self):
        return len(self.engine)

    def _state(self):
        return self.engine.state_dict()

    def _load_state(self, state):
        self.engine.load_state_dict(state)

    def check_invariants(self):
        self.engine.check_invariants()

    def stats(self):
        return {
            "n_epoch_rebuilds": self.engine.n_epoch_rebuilds,
            "n_promotions": self.engine.n_promotions,
            "n_demotions": self.engine.n_demotions,
            "n_grab_events": self.engine.n_grab_events,
            "n_scan_events": self.engine.n_scan_events,
        }


class ApproxIndex(SoAIndex):
    """Adapter over :class:`~repro_torch.core.approx.SampledCoreDBSCAN` —
    same protocol surface as :class:`SoAIndex` (it *is* the SoA engine
    with the density test restricted to a deterministic id-hash sample),
    plus sampling diagnostics in ``stats()``."""

    native_component_queries = True

    def stats(self):
        s = super().stats()
        s["sample_rate"] = self.engine.sample_rate
        s["n_sampled"] = self.engine.n_sampled()
        return s


class RecomputeIndex(ClusterIndex):
    """Static-recompute baselines: mutations are O(1) bookkeeping; the
    clustering reruns from scratch on the first query after a mutation."""

    def __init__(self, cfg: ClusterConfig,
                 cluster_fn: Callable[[np.ndarray], np.ndarray]):
        super().__init__(cfg)
        self._cluster_fn = cluster_fn  # (n, d) -> (n,) labels, noise = -1
        self._pts: Dict[int, np.ndarray] = {}
        self._next_idx = 0
        self._cache: Optional[Dict[int, int]] = None

    def insert(self, x, idx=None):
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (self.cfg.d,):
            raise ValueError(f"point shape {x.shape} != ({self.cfg.d},)")
        idx, self._next_idx = claim_index(self._pts, self._next_idx, idx)
        self._pts[idx] = x
        self._cache = None
        return idx

    def delete(self, idx):
        del self._pts[idx]
        self._cache = None

    def _all_labels(self) -> Dict[int, int]:
        if self._cache is None:
            ids = sorted(self._pts)
            if not ids:
                self._cache = {}
            else:
                lab = self._cluster_fn(np.stack([self._pts[i] for i in ids]))
                self._cache = {i: int(v) for i, v in zip(ids, lab)}
        return self._cache

    def label(self, idx):
        if idx not in self._pts:
            raise KeyError(idx)
        return self._all_labels()[idx]

    def labels(self, ids=None):
        all_lab = self._all_labels()
        if ids is None:
            return dict(all_lab)
        return {i: all_lab[i] for i in ids}

    def ids(self):
        return sorted(self._pts)

    def __contains__(self, idx):
        return idx in self._pts

    def __len__(self):
        return len(self._pts)

    def _state(self):
        ids = sorted(self._pts)
        points = (np.stack([self._pts[i] for i in ids])
                  if ids else np.zeros((0, self.cfg.d)))
        return {
            "ids": np.asarray(ids, dtype=np.int64),
            "points": points.astype(np.float64),
            "next_idx": np.asarray(self._next_idx, dtype=np.int64),
        }

    def _load_state(self, state):
        for i, x in zip(state["ids"], np.asarray(state["points"], np.float64)):
            self._pts[int(i)] = x
        self._next_idx = int(state["next_idx"])
        self._cache = None


class FixedCoreIndex(ClusterIndex):
    """EMZFixedCore §5 ablation: the first ``insert_batch`` freezes the
    core set; later points only attach to frozen core buckets.  The freeze
    boundary is stream state, so deletions are unsupported.

    The underlying engine is fed *incrementally* (its labels list is
    append-only in insertion order), keeping per-batch cost O(batch) —
    the cost profile Figure 2 measures — and making pinned out-of-order
    handles safe: a handle is just a name for a stream position.
    """

    def __init__(self, cfg: ClusterConfig):
        super().__init__(cfg)
        self.engine = EMZFixedCore(cfg.d, cfg.k, cfg.t, cfg.eps,
                                   seed=cfg.seed)
        self._order: List[int] = []  # handles in insertion (stream) order
        self._pts: Dict[int, np.ndarray] = {}
        self._next_idx = 0
        self._n_init = 0  # points in the frozen first batch (0 = not frozen)

    def insert(self, x, idx=None):
        return self.insert_batch(np.asarray(x, dtype=np.float64)[None],
                                 ids=[idx])[0]

    def insert_batch(self, X, ids=None):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2 or X.shape[1] != self.cfg.d:
            raise ValueError(f"batch shape {X.shape} != (n, {self.cfg.d})")
        if ids is not None and len(ids) != X.shape[0]:
            raise ValueError("ids length must match batch size")
        out = []
        for j in range(X.shape[0]):
            idx, self._next_idx = claim_index(
                self._pts, self._next_idx,
                ids[j] if ids is not None else None,
            )
            self._pts[idx] = X[j]
            self._order.append(idx)
            out.append(idx)
        self.engine.add_batch(X)
        if self._n_init == 0:
            self._n_init = len(self._order)
        return out

    def delete(self, idx):
        raise NotImplementedError("emz-fixed is insert-only (frozen cores)")

    def _all_labels(self) -> Dict[int, int]:
        return {i: int(v) for i, v in zip(self._order, self.engine._labels)}

    def label(self, idx):
        if idx not in self._pts:
            raise KeyError(idx)
        return self._all_labels()[idx]

    def labels(self, ids=None):
        all_lab = self._all_labels()
        if ids is None:
            return all_lab
        return {i: all_lab[i] for i in ids}

    def ids(self):
        return sorted(self._pts)

    def __contains__(self, idx):
        return idx in self._pts

    def __len__(self):
        return len(self._pts)

    def _state(self):
        # ids in INSERTION order: the engine's labels/freeze boundary are
        # stream state, so restore must replay the original order
        points = (np.stack([self._pts[i] for i in self._order])
                  if self._order else np.zeros((0, self.cfg.d)))
        return {
            "ids": np.asarray(self._order, dtype=np.int64),
            "points": points.astype(np.float64),
            "next_idx": np.asarray(self._next_idx, dtype=np.int64),
            "n_init": np.asarray(self._n_init, dtype=np.int64),
        }

    def _load_state(self, state):
        X = np.asarray(state["points"], dtype=np.float64)
        n_init = int(state["n_init"])
        order = [int(i) for i in state["ids"]]
        if order:
            self.insert_batch(X[:n_init], ids=order[:n_init])
            if len(order) > n_init:
                self.insert_batch(X[n_init:], ids=order[n_init:])
        self._next_idx = int(state["next_idx"])


# -------------------------------------------------------------------- #
# registrations
# -------------------------------------------------------------------- #
def _host_only(backend: str, device: Optional[str], hint: str = "") -> None:
    # a host-only backend has no kernel: a request for any other device
    # is refused, never run on the host
    if device not in (None, "cpu"):
        raise ValueError(f"backend {backend!r} runs on the host only; got "
                         f"device={device!r}{hint}")


def _dynamic_engine(cfg: ClusterConfig, cls, **extra) -> EulerTourIndex:
    return EulerTourIndex(cfg, cls(
        cfg.d, cfg.k, cfg.t, cfg.eps, seed=cfg.seed,
        attach_orphans=cfg.attach_orphans, repair=cfg.repair, **extra,
    ))


@register_backend("dynamic")
def _build_dynamic(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
    _host_only("dynamic", device)
    return _dynamic_engine(cfg, DynamicDBSCAN)


@register_backend("batched")
def _build_batched(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
    _host_only("batched", device, hint=" (use backend='batched-device')")
    return _dynamic_engine(cfg, BatchedDynamicDBSCAN, use_device=False)


@register_backend("batched-device")
def _build_batched_device(cfg: ClusterConfig,
                          device: Optional[str]) -> ClusterIndex:
    # one ops.lsh_hash call a batch: the CUDA kernel on "cuda" (the
    # default; raises without a card), its plain version on "cpu"
    return _dynamic_engine(cfg, BatchedDynamicDBSCAN, use_device=True,
                           device=device or "cuda")


@register_backend("soa")
def _build_soa(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
    # host-only, as in the reference: the numpy mirror, no kernel
    _host_only("soa", device, hint=" (use backend='soa-device')")
    return SoAIndex(cfg, SoADynamicDBSCAN(
        cfg.d, cfg.k, cfg.t, cfg.eps, seed=cfg.seed,
        attach_orphans=cfg.attach_orphans, repair=cfg.repair,
        use_device=False))


@register_backend("soa-device")
def _build_soa_device(cfg: ClusterConfig,
                      device: Optional[str]) -> ClusterIndex:
    # hash/bucket/support passes through repro_torch.kernels.ops: the
    # CUDA kernels on "cuda" (the default; raises without a card), the
    # plain PyTorch versions on "cpu"
    return SoAIndex(cfg, SoADynamicDBSCAN(
        cfg.d, cfg.k, cfg.t, cfg.eps, seed=cfg.seed,
        attach_orphans=cfg.attach_orphans, repair=cfg.repair,
        use_device=True, device=device or "cuda"))


@register_backend("approx")
def _build_approx(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
    # host-only, as in the reference; the device path is the engine's
    # use_device=True (see the module docstring)
    _host_only("approx", device)
    return ApproxIndex(cfg, SampledCoreDBSCAN(
        cfg.d, cfg.k, cfg.t, cfg.eps, seed=cfg.seed,
        attach_orphans=cfg.attach_orphans, repair=cfg.repair,
        use_device=False, sample_rate=cfg.sample_rate,
        approx_seed=cfg.approx_seed))


@register_backend("tiered")
def _build_tiered(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
    # both tiers on the host (approx front, soa back): no kernel
    _host_only("tiered", device)
    from ..tiered import TieredIndex  # lazy: repro_torch.tiered imports api

    return TieredIndex(cfg)


@register_backend("emz-static")
def _build_emz(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
    _host_only("emz-static", device)
    lsh = GridLSH(cfg.d, cfg.eps, cfg.t, seed=cfg.seed)
    return RecomputeIndex(
        cfg, lambda X: emz_cluster(X, cfg.k, cfg.eps, cfg.t, lsh=lsh))


@register_backend("naive")
def _build_naive(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
    # float64 host counting, as in the reference; the f32 CUDA
    # eps_neighbor_counts kernel is a different function (core.naive_dbscan)
    _host_only("naive", device)
    return RecomputeIndex(cfg, lambda X: dbscan(X, cfg.k, cfg.eps))


@register_backend("emz-fixed")
def _build_emz_fixed(cfg: ClusterConfig,
                     device: Optional[str]) -> ClusterIndex:
    _host_only("emz-fixed", device)
    return FixedCoreIndex(cfg)
