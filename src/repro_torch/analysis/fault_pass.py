"""fault-tolerance-guards — failures are handled, never swallowed.

The fault-tolerance layer's contract is that
``ShardUnavailableError`` is a *decision point*, not noise: wherever the
coordinator or a transport catches one, it must either re-raise (let the
caller decide) or take the failover path (evict the member / promote a
replica / record the compensation).  A handler that silently eats the
exception turns a dead shard into quietly wrong answers — the one
failure mode a clustering service must never have.

  FT001  ``except ShardUnavailableError`` (alone or in a tuple) in
         ``service/`` or ``shard/`` whose handler neither raises nor
         calls a failover-path function

"Failover-path function" is any call whose name is one of
``_fail_member`` / ``_schedule_repair`` / ``check_health`` or contains
``promote`` / ``failover`` — the lane's eviction/promotion entry points
plus anything named for the job.  Suppress a deliberate best-effort
handler (e.g. compensation after a double failure, where the counter is
the record) with ``# analysis: allow[FT001]``.

A copy of ``repro.analysis.fault_pass``: the rules, their scope and their
messages are the reference's.
"""

from __future__ import annotations

import ast
from typing import List

from .base import AnalysisPass, register_pass
from .findings import Finding
from .walker import Project, SourceFile, enclosing

_SCOPED_PREFIXES = ("service/", "shard/")

#: call names that constitute "taking the failover path"
_FAILOVER_CALLS = frozenset({"_fail_member", "_schedule_repair",
                             "check_health"})
_FAILOVER_SUBSTRINGS = ("promote", "failover")


def _names_shard_unavailable(node: ast.expr) -> bool:
    """True when an except clause's type expression names
    ShardUnavailableError (bare, dotted, or inside a tuple)."""
    if isinstance(node, ast.Tuple):
        return any(_names_shard_unavailable(e) for e in node.elts)
    if isinstance(node, ast.Name):
        return node.id == "ShardUnavailableError"
    if isinstance(node, ast.Attribute):
        return node.attr == "ShardUnavailableError"
    return False


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_failover_call(name: str) -> bool:
    return (name in _FAILOVER_CALLS
            or any(s in name for s in _FAILOVER_SUBSTRINGS))


@register_pass
class FaultToleranceGuards(AnalysisPass):
    name = "fault-tolerance-guards"
    description = ("every ShardUnavailableError handler re-raises or "
                   "takes the failover path")

    def run(self, project: Project) -> List[Finding]:
        for sf in project.sources():
            if not sf.rel.startswith(_SCOPED_PREFIXES):
                continue
            if "ShardUnavailableError" not in sf.text:
                continue
            self._check_file(sf)
        return self.findings

    def _check_file(self, sf: SourceFile) -> None:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None or not _names_shard_unavailable(node.type):
                continue
            if self._handler_ok(node):
                continue
            self.emit(sf, node.lineno, "FT001",
                      "ShardUnavailableError caught but neither re-raised "
                      "nor routed to the failover path — a dead shard "
                      "must surface or be failed over, never swallowed")

    @staticmethod
    def _handler_ok(handler: ast.ExceptHandler) -> bool:
        """A handler passes when *its own* body (not a nested handler's)
        raises or calls into the failover machinery."""
        for sub in ast.walk(handler):
            if sub is handler:
                continue
            inner = enclosing(sub, ast.ExceptHandler)
            if inner is not handler and inner is not None:
                continue
            if isinstance(sub, ast.Raise):
                return True
            if isinstance(sub, ast.Call) and _is_failover_call(
                    _call_name(sub)):
                return True
        return False
