"""repro_torch.analysis — the port's static analysis over its own tree.

    PYTHONPATH=src python -m repro_torch.analysis [--json] [--select PASSES]

Six passes guard the invariants the repo otherwise enforces only by
convention (see each module's docstring for the rule tables):

  * ``protocol-exhaustiveness`` — every ``repro_torch.service`` message is
    codec-registered, every ``*Req`` has a dispatch handler and a
    resolvable ``*Resp``, every numpy payload declares a fixed dtype;
  * ``hot-path-purity`` — ``repro_torch/kernels``' launch wrappers and
    plain versions stay vectorised (no Python loops / host syncs on the
    card's path; the nvcc build and the launch ABI's host scalars are
    host code by the pass's written scope) and ``# hot-path``-marked
    functions stay free of per-element numpy work;
  * ``concurrency-guards`` — fan-out callables never mutate
    coordinator-owned state (bridge/router/home map), and transport
    error paths chain their raises;
  * ``fault-tolerance-guards`` — every ``except ShardUnavailableError``
    in ``service/``/``shard/`` re-raises or routes to the failover path
    (a dead shard must surface or be failed over, never swallowed);
  * ``registry-conformance`` — every registered backend implements the
    full ClusterIndex protocol with paired snapshot/restore and a
    truthful ``native_component_queries`` capability flag, and every
    factory takes ``(cfg, device)``;
  * ``obs-discipline`` — span/timer instruments in ``service/`` and
    ``shard/`` are opened as context managers, so a span can't leak
    open on an exception path.

Suppress one finding with ``# analysis: allow[RULE]`` on (or directly
above) the offending line; mark a serving hot path for checking with a
``# hot-path`` comment on its ``def``.  New passes subclass
:class:`~repro_torch.analysis.base.AnalysisPass` and register with
``@register_pass`` — the CLI and tests pick them up by name.

The port's copy of ``repro.analysis``: it imports nothing of ``repro``
and nothing of JAX, and it analyses ``repro_torch``.  Rule ids, pragma
syntax, output and exit codes are the reference's; the differences
(the hot-path pass's device scope, REG005's ``(cfg, device)``
contract, the JSON counts of clean passes) are written in
:mod:`.hotpath_pass`, :mod:`.registry_pass` and :mod:`.cli`.
"""

from .base import PASSES, AnalysisPass, all_passes, register_pass  # noqa: F401
from .cli import main, run_passes  # noqa: F401
from .findings import Finding  # noqa: F401
from .walker import Project, SourceFile  # noqa: F401
