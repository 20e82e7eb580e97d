"""repro_torch.api — the streaming interface of ``repro.api``, ported.

    from repro_torch.api import ClusterConfig, build_index

    index = build_index(ClusterConfig(d=10, k=10, t=10, eps=0.75,
                                      backend="soa-device"))  # on "cuda"
    ids = index.insert_batch(X)
    index.labels()                      # {idx: label}, noise = -1
    snap = index.snapshot()             # -> restore_index(snap)

Backends registered so far: the paper's engines ``dynamic`` and
``batched`` (host) and ``batched-device`` (one CUDA ``lsh_hash`` call a
batch), ``soa`` (host), ``soa-device`` (the CUDA kernels), and the
host-only baselines ``emz-static``, ``naive`` and ``emz-fixed``.  The
device backends (``DEVICE_BACKENDS``) run on "cuda" by default;
``build_index(cfg, device="cpu")`` runs their plain kernels.  Snapshots
interchange with ``repro.api``.
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
from .backends import EulerTourIndex, RecomputeIndex, SoAIndex  # noqa: F401
