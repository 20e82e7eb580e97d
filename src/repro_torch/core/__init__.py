# The port's engines.  So far: the structure-of-arrays engine on the
# streaming main path (backends soa / soa-device), the grid-LSH family,
# and the quality metrics; the dict engines and baselines of repro.core
# come with later slices.
from .dynamic_dbscan import NOISE  # noqa: F401
from .hashing import GridLSH  # noqa: F401
from .metrics import adjusted_rand_index, normalized_mutual_info  # noqa: F401
from .soa import SoADynamicDBSCAN  # noqa: F401
