"""concurrency-guards — the coordinator-serial discipline, checked.

The sharded backend's whole thread-safety argument is one sentence:
*worker threads only ever touch their own shard's client; every shared
structure (BoundaryBridge, ShardRouter, the home map, caches) is mutated
serially by the coordinating thread* — that is what keeps the threaded
fan-out bit-identical to the serial path with zero locks.  Nothing
enforces it: a well-meaning PR that updates the bridge from inside a
fan-out lambda races silently and corrupts the directory only under
load.  This pass makes the discipline machine-checked:

  CONC001  mutation of coordinator-owned state (``self.bridge.insert/
           delete/move``, ``self.router.*`` mutators, any write to a
           ``self.*`` attribute) inside a callable passed to
           ``_fanout(...)`` or ``*.submit(...)``
  CONC002  bare ``except:`` in protocol/shard modules (swallows
           ``ShardUnavailableError`` and ``KeyboardInterrupt`` alike)
  CONC003  ``raise X(...)`` without ``from`` inside an ``except`` block
           in protocol/shard modules — unchained raises strip the wire
           error's cause exactly where debugging needs it

CONC001 scans any module that uses a thread pool; CONC002/CONC003 are
scoped to ``service/`` and ``shard/`` (the transport error paths).

A copy of ``repro.analysis.concurrency_pass``: the rules, their scope and their
messages are the reference's.
"""

from __future__ import annotations

import ast
from typing import List

from .base import AnalysisPass, register_pass
from .findings import Finding
from .walker import Project, SourceFile, enclosing

#: methods of coordinator-owned structures that mutate them
_MUTATORS = ("insert", "delete", "move", "delete_batch", "insert_batch",
             "move_range", "load_state", "rebalance")
#: self-attributes that name coordinator-owned shared structures
_OWNED = ("bridge", "router")

_ERROR_PATH_PREFIXES = ("service/", "shard/")


def _self_attr(node: ast.expr) -> str:
    """'bridge' for ``self.bridge``; '' otherwise."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return ""


def _submitted_callables(call: ast.Call) -> List[ast.AST]:
    """Lambdas/defs handed to a fan-out call, including dict-literal
    values and comprehension bodies (the repo's fan-out idioms)."""
    out: List[ast.AST] = []
    todo = list(call.args) + [kw.value for kw in call.keywords]
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Lambda):
            out.append(node)
        elif isinstance(node, ast.Dict):
            todo.extend(v for v in node.values if v is not None)
        elif isinstance(node, (ast.DictComp,)):
            todo.append(node.value)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            todo.append(node.elt)
        elif isinstance(node, ast.Tuple):
            todo.extend(node.elts)
    return out


@register_pass
class ConcurrencyGuards(AnalysisPass):
    name = "concurrency-guards"
    description = ("fan-out callables never mutate coordinator state; "
                   "transport error paths chain their raises")

    def run(self, project: Project) -> List[Finding]:
        for sf in project.sources():
            if "ThreadPoolExecutor" in sf.text or "_fanout" in sf.text:
                self._check_fanout(sf)
            if sf.rel.startswith(_ERROR_PATH_PREFIXES):
                self._check_error_paths(sf)
        return self.findings

    # ------------------------------------------------------------------ #
    def _check_fanout(self, sf: SourceFile) -> None:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            target = f.attr if isinstance(f, ast.Attribute) else ""
            if target not in ("_fanout", "submit"):
                continue
            for cb in _submitted_callables(node):
                self._check_callable(sf, cb)

    def _check_callable(self, sf: SourceFile, cb: ast.AST) -> None:
        for node in ast.walk(cb):
            # writes to any self attribute (incl. self._home[i] = ...)
            targets: List[ast.expr] = []
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
            elif isinstance(node, ast.Delete):
                targets = list(node.targets)
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                attr = _self_attr(base)
                if attr:
                    self.emit(sf, t.lineno, "CONC001",
                              f"write to coordinator state self.{attr} "
                              "inside a fan-out callable — shared "
                              "structures are coordinator-serial")
            # mutating calls on owned structures: self.bridge.insert(...)
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr in _MUTATORS
                        and _self_attr(f.value) in _OWNED):
                    self.emit(sf, node.lineno, "CONC001",
                              f"self.{f.value.attr}.{f.attr}() inside a "
                              "fan-out callable — bridge/router mutations "
                              "must run on the coordinating thread")

    # ------------------------------------------------------------------ #
    def _check_error_paths(self, sf: SourceFile) -> None:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                self.emit(sf, node.lineno, "CONC002",
                          "bare except in a protocol module — name the "
                          "exceptions the transport actually raises")
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Raise) and sub.exc is not None
                        and sub.cause is None
                        and enclosing(sub, ast.ExceptHandler) is node):
                    if (isinstance(sub.exc, ast.Name) and node.name
                            and sub.exc.id == node.name):
                        continue  # plain re-raise of the caught exception
                    self.emit(sf, sub.lineno, "CONC003",
                              "unchained raise inside except — add "
                              "'from e' (or 'from None') so the wire "
                              "error keeps its cause")
        return None
