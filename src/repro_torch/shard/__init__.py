"""repro_torch.shard — sharded ClusterIndex with LSH key-range routing.

    from repro_torch.api import ClusterConfig, build_index

    index = build_index(ClusterConfig(d=8, k=10, t=10, eps=0.5,
                                      backend="sharded", shards=4,
                                      inner_backend="batched",
                                      workers=4))          # threaded fan-out

Everything downstream of ``build_index`` (serving, curation, examples,
benchmarks) gets sharding for free; see :mod:`repro_torch.shard.index` for the
architecture (router / shard clients / boundary bridge).  ``label()`` is
an incremental point query (inner-find -> bridge-find over the maintained
boundary-bucket set) unless ``incremental_merge=False`` restores the
rebuild-per-query merge.  ``transport="process"`` runs each shard as a
spawned server process behind the :mod:`repro_torch.service` wire protocol —
bit-identical results, GIL-free update fan-out.  With a device inner
backend (``soa-device``, ``batched-device``) every shard runs on
``build_index``'s ``device`` ("cuda" by default); with a host one the
index refuses any device but ``None`` and "cpu".
"""

from typing import Optional

from ..api.backends import _host_only
from ..api.config import ClusterConfig
from ..api.registry import register_backend, runs_on_device
from .bridge import BoundaryBridge  # noqa: F401
from .index import ShardedIndex  # noqa: F401
from .rebalance import propose_rebalance, shard_loads  # noqa: F401
from .router import SLOTS, RebalancePlan, ShardRouter  # noqa: F401


@register_backend("sharded")
def _build_sharded(cfg: ClusterConfig,
                   device: Optional[str]) -> ShardedIndex:
    if runs_on_device(cfg):
        return ShardedIndex(cfg, device=device or "cuda")
    _host_only("sharded", device,
               hint=f" (inner_backend {cfg.inner_backend!r} is host-only)")
    return ShardedIndex(cfg)
