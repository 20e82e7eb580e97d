"""``repro_torch.tiered`` — tiered serving: approximate answers, exact
verification.  The port of ``repro.tiered``, host code as there.

The tier structure:

  * a **front** tier (``backend="approx"``, sampled cores) absorbs every
    mutation synchronously and serves ``label()``/``labels()``
    immediately — the caller pays approximate-engine update cost only;
  * a **back** tier (exact SoA engine) receives the same mutation stream
    through a bounded queue drained by a verifier thread — exact labels
    trail the stream by the queue lag instead of gating it;
  * the verifier periodically **diffs** the tiers (ARI over the common
    live set, ``core/metrics.py``) and exports ``tiered.lag``,
    ``tiered.queue_depth`` and ``tiered.divergence_ari`` gauges through
    ``repro_torch.obs``;
  * a :class:`DivergencePolicy` remembers which buckets recently
    disagreed, and ``label()`` **escalates** queries for points in those
    buckets to the exact tier.

Register-once: ``backend="tiered"`` builds a :class:`TieredIndex` from
one ``ClusterConfig`` (``sample_rate`` configures the front tier), so
serving, checkpoints, and benchmarks construct it like any other
backend.  Both tiers are the host backends (``approx`` in front, ``soa``
behind), as in the reference, so tiered serving launches no kernel; the
index runs on the host and refuses any device but ``None`` and "cpu".
"""

from .index import TieredIndex
from .policy import DivergencePolicy
from .verifier import Verifier

__all__ = ["TieredIndex", "DivergencePolicy", "Verifier"]
