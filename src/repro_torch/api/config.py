"""Frozen configuration shared by every clustering backend.

One ``ClusterConfig`` fully determines an index: the LSH family is seeded
from ``(d, eps, t, seed)``, so two indices built from equal configs are
semantically interchangeable — the basis of the backend-equivalence tests
and of snapshot portability.

The fields are exactly those of ``repro.api.config.ClusterConfig``, so a
snapshot taken by either package restores in the other (``restore()``
compares configs).  The device an index runs on is therefore not a field:
it is a keyword of ``build_index`` / ``restore_index``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    d: int                       # point dimensionality
    k: int                       # Definition-4 core threshold
    t: int                       # number of LSH tables
    eps: float                   # grid cell scale (2·eps cells)
    seed: int = 0                # LSH family + sequence-backend seed
    backend: str = "dynamic"     # registry key, see repro_torch.api.backends
    repair: str = "exact"        # 'exact' (Thm-2 fix) | 'paper' (Alg. 2)
    attach_orphans: bool = True  # DESIGN.md §3.2 border re-attachment
    shards: int = 1              # backend="sharded": number of key ranges
    inner_backend: str = "dynamic"  # backend="sharded": per-shard engine
    workers: int = 0             # backend="sharded": thread pool size for
    #                              per-shard fan-out (0/1 = serial)
    incremental_merge: bool = True  # backend="sharded": maintain the
    #                              cross-shard union-find under updates
    #                              (False = rebuild per query, PR-2 path)
    transport: str = "local"     # backend="sharded": how the coordinator
    #                              reaches its shards — "local" (in-process,
    #                              zero-copy), "process" (one spawned
    #                              server process per shard, wire protocol
    #                              over a socketpair; GIL-free update
    #                              fan-out) or "tcp" (same protocol over a
    #                              stream socket with timeouts, retries and
    #                              auth — reconnectable, cross-host capable)
    replicas: int = 0            # backend="sharded": replicas per shard
    #                              lane, fed by deterministic update
    #                              replay; on a dead primary the
    #                              coordinator promotes a replica instead
    #                              of erroring (0 = no fault tolerance)
    rpc_timeout_s: float = 30.0  # wire transports: per-request deadline —
    #                              a request that gets no response within
    #                              this window fails (and, on "tcp",
    #                              retries) instead of hanging forever
    obs: bool = False            # observability: metrics registry + trace
    #                              spans (repro_torch.obs).  Off by default; the
    #                              null instruments keep un-instrumented
    #                              runs and wire bytes bit-identical.
    sample_rate: float = 1.0     # backend="approx": fraction of points in
    #                              the deterministic core sample (1.0 =
    #                              exact; the engine comes later)
    approx_seed: int = 0         # backend="approx": seed folded into the
    #                              id-hash sampling predicate

    def __post_init__(self) -> None:
        # Validate at construction with named messages instead of failing
        # deep inside GridLSH.__init__ / the engine constructors.
        if self.d < 1:
            raise ValueError(f"d must be >= 1, got {self.d}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.t < 1:
            raise ValueError(f"t must be >= 1, got {self.t}")
        if self.eps <= 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")
        if self.repair not in ("exact", "paper"):
            raise ValueError(f"unknown repair mode {self.repair!r}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.workers < 0:
            raise ValueError(f"workers must be >= 0, got {self.workers}")
        if self.replicas < 0:
            raise ValueError(f"replicas must be >= 0, got {self.replicas}")
        if self.rpc_timeout_s <= 0:
            raise ValueError(
                f"rpc_timeout_s must be > 0, got {self.rpc_timeout_s}")
        if self.inner_backend == "sharded":
            raise ValueError("inner_backend cannot itself be 'sharded'")
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in (0, 1], got {self.sample_rate}")
        if self.transport not in ("local", "process", "tcp"):
            raise ValueError(
                f"unknown transport {self.transport!r} "
                "(expected 'local', 'process' or 'tcp')"
            )

    def replace(self, **changes: Any) -> "ClusterConfig":
        return dataclasses.replace(self, **changes)

    def with_shards(self, shards: int,
                    inner: Optional[str] = None) -> "ClusterConfig":
        """Resolve a shard-count request against this config — the one
        definition of the '--shards S' CLI convention.

        ``shards > 1`` wraps this config's backend into ``sharded`` with
        the current backend (or ``inner``) as the per-shard engine; an
        already-``sharded`` config just updates its shard count;
        ``shards <= 1`` on an unsharded config is a no-op.
        """
        if self.backend == "sharded":
            return self.replace(shards=max(1, shards),
                                **({"inner_backend": inner} if inner else {}))
        if shards and shards > 1:
            return self.replace(backend="sharded", shards=shards,
                                inner_backend=inner or self.backend)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClusterConfig":
        return cls(**d)
