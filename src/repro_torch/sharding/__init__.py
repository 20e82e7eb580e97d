"""repro_torch.sharding — the reference's logical-axis sharding over a
``torch.distributed`` ``DeviceMesh`` (:mod:`.axes`) and the collectives
the models' mesh path runs on local shards (:mod:`.collectives`)."""

from .axes import (  # noqa: F401
    LOGICAL_RULES,
    distribute,
    logical_to_spec,
    placements,
    shard_activation,
    spec_tree,
)
