# The port's engines: the paper's dynamic DBSCAN over an Euler-Tour
# dynamic forest (DynamicDBSCAN, and BatchedDynamicDBSCAN with one hash
# call a batch), the structure-of-arrays engine on the streaming main
# path (backends soa / soa-device), the static baselines they are
# evaluated against (exact DBSCAN, EMZ recompute, EMZ fixed-core), the
# grid-LSH family and the quality metrics.
from .dynamic_dbscan import DynamicDBSCAN, NOISE  # noqa: F401
from .euler_tour import EulerTourForest  # noqa: F401
from .fixed_core import EMZFixedCore  # noqa: F401
from .hashing import GridLSH  # noqa: F401
from .metrics import adjusted_rand_index, normalized_mutual_info  # noqa: F401
from .naive_dbscan import SklearnStyleDBSCAN, dbscan  # noqa: F401
from .skiplist import SkipListSeq  # noqa: F401
from .static_emz import EMZRecompute, emz_cluster  # noqa: F401
from .batched import BatchedDynamicDBSCAN  # noqa: F401
from .soa import SoADynamicDBSCAN  # noqa: F401
