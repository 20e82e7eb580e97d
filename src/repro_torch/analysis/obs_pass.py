"""obs-discipline — span/timer lifecycle, checked.

A trace span or latency timer is a scope: it must close on every exit
path, including exceptions, or the dump shows a span that never ended
(and the histogram silently loses the observation).  The context-manager
protocol is exactly that guarantee, so the rule is simply that the
protocol is used:

  OBS001  a ``.span(...)`` / ``.timer(...)`` call in ``service/`` or
          ``shard/`` that is not a ``with``-statement item — open-coded
          ``__enter__``/manual timing can leak the span open on an
          exception path

Scoped to the protocol and coordinator modules (the ones whose spans
cross the wire, where a leaked span corrupts a whole trace tree) — and to
the two instrument factories by name, so unrelated ``.timer()`` APIs
elsewhere never trip it.  Storing the context manager first
(``cm = h.timer()`` ... ``with cm:``) also trips the rule by design:
the repo's idiom is to open the scope where it is created.

A copy of ``repro.analysis.obs_pass``: the rules, their scope and their
messages are the reference's.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .base import AnalysisPass, register_pass
from .findings import Finding
from .walker import Project, SourceFile

_SCOPED_PREFIXES = ("service/", "shard/")
_INSTRUMENT_FACTORIES = ("span", "timer")


@register_pass
class ObsDiscipline(AnalysisPass):
    name = "obs-discipline"
    description = ("span/timer instruments in protocol modules are opened "
                   "as context managers, never left to leak on exceptions")

    def run(self, project: Project) -> List[Finding]:
        for sf in project.sources():
            if sf.rel.startswith(_SCOPED_PREFIXES):
                self._check(sf)
        return self.findings

    def _check(self, sf: SourceFile) -> None:
        # every call node that already is a with-item is compliant
        with_items: Set[int] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    with_items.add(id(item.context_expr))
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in _INSTRUMENT_FACTORIES):
                continue
            if id(node) in with_items:
                continue
            self.emit(sf, node.lineno, "OBS001",
                      f".{f.attr}(...) outside a with statement — open "
                      "span/timer scopes as context managers so they "
                      "close on every exit path")
