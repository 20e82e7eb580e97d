"""The paper's own workload: streaming dynamic-DBSCAN curation.

Not an LM architecture — hyperparameters of the clustering substrate used
by the data pipeline and by benchmarks (k=10, t=10, eps=0.75 per §5).
The port's own copy of ``repro.configs.paper_dbscan``: the same fields
and defaults."""
from dataclasses import dataclass


@dataclass(frozen=True)
class DBSCANConfig:
    d: int = 20
    k: int = 10
    t: int = 10
    eps: float = 0.75
    batch_size: int = 1000
    window: int = 0  # sliding-window size for delete-after (0 = keep all)


CONFIG = DBSCANConfig()
