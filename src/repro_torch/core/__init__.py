# The port's engines: the structure-of-arrays engine on the streaming
# main path (backends soa / soa-device), the static baselines it is
# evaluated against (exact DBSCAN, EMZ recompute, EMZ fixed-core), the
# grid-LSH family and the quality metrics.  The dict engines of
# repro.core come with a later slice.
from .dynamic_dbscan import NOISE  # noqa: F401
from .fixed_core import EMZFixedCore  # noqa: F401
from .hashing import GridLSH  # noqa: F401
from .metrics import adjusted_rand_index, normalized_mutual_info  # noqa: F401
from .naive_dbscan import SklearnStyleDBSCAN, dbscan  # noqa: F401
from .soa import SoADynamicDBSCAN  # noqa: F401
from .static_emz import EMZRecompute, emz_cluster  # noqa: F401
