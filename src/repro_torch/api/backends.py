"""Built-in backends of the port.

=================  ==================================================
key                engine
=================  ==================================================
``soa``            SoADynamicDBSCAN — vectorised structure-of-arrays
                   core on the host (numpy mirror, no kernel)
``soa-device``     SoADynamicDBSCAN(use_device=True) — the lsh_hash and
                   bucket kernels on ``device`` ("cuda" by default)
=================  ==================================================

The other backends of ``repro.api`` come with later slices of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.soa import SoADynamicDBSCAN
from .config import ClusterConfig
from .index import ClusterIndex
from .registry import register_backend


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


# -------------------------------------------------------------------- #
# registrations
# -------------------------------------------------------------------- #
@register_backend("soa")
def _build_soa(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
    # host-only, as in the reference: the numpy mirror, no kernel — so a
    # request for any other device is refused, never run on the host
    if device not in (None, "cpu"):
        raise ValueError(f"backend 'soa' runs on the host only; got "
                         f"device={device!r} (use backend='soa-device')")
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
