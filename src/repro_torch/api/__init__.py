"""repro_torch.api — the streaming interface of ``repro.api``, ported.

    from repro_torch.api import ClusterConfig, build_index

    index = build_index(ClusterConfig(d=10, k=10, t=10, eps=0.75,
                                      backend="soa-device"))  # on "cuda"
    ids = index.insert_batch(X)
    index.labels()                      # {idx: label}, noise = -1
    snap = index.snapshot()             # -> restore_index(snap)

All eleven backends of ``repro.api``: the paper's engines ``dynamic``
and ``batched`` (host) and ``batched-device`` (one CUDA ``lsh_hash``
call a batch), ``soa`` (host), ``soa-device`` (the CUDA kernels), the
sampled tier ``approx`` and the tiered index ``tiered`` (host), the
host-only baselines ``emz-static``, ``naive`` and ``emz-fixed``, and
``sharded`` (``repro_torch.shard``: shards of any grid-bucket backend,
in process or in worker processes).  The device backends
(``DEVICE_BACKENDS``, and ``sharded`` over one of them) run on "cuda" by
default; ``build_index(cfg, device="cpu")`` runs their plain kernels.
Snapshots interchange with ``repro.api``.
"""

from ..core.dynamic_dbscan import NOISE  # noqa: F401
from .config import ClusterConfig  # noqa: F401
from .events import Delete, Insert  # noqa: F401
from .index import ClusterIndex  # noqa: F401
from .registry import (  # noqa: F401
    DEVICE_BACKENDS,
    available_backends,
    build_index,
    register_backend,
    restore_index,
    unregister_backend,
)
from . import backends as _backends  # noqa: F401  (populates the registry)
from .backends import (  # noqa: F401
    ApproxIndex,
    EulerTourIndex,
    RecomputeIndex,
    SoAIndex,
)
# module (not name) import: repro_torch.shard may be mid-initialisation
# when it is what pulled repro_torch.api in; it registers "sharded" when
# it completes
from .. import shard as _shard  # noqa: F401


def __getattr__(name):  # PEP 562: late-bound re-export
    if name == "ShardedIndex":
        return _shard.ShardedIndex
    raise AttributeError(name)
