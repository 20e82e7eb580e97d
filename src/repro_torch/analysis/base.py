"""Analysis pass base class and registry.

A pass is a named check over a
:class:`~repro_torch.analysis.walker.Project`: ``run(project)`` returns
the (unsuppressed) findings.  Passes register at import time via
:func:`register_pass`, mirroring the backend registry in
:mod:`repro_torch.api.registry` — adding a pass is "write a class,
decorate it", and the CLI picks it up by name.  A copy of
``repro.analysis.base``.

Emission goes through :meth:`AnalysisPass.emit`, which drops findings
whose line carries a matching ``# analysis: allow[RULE]`` pragma, so
every rule is suppressible the same way without per-pass bookkeeping.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Tuple, Type

from .findings import Finding
from .walker import Project, SourceFile

PASSES: Dict[str, Type["AnalysisPass"]] = {}


def register_pass(cls: Type["AnalysisPass"]) -> Type["AnalysisPass"]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} has no name")
    if cls.name in PASSES:
        raise ValueError(f"duplicate pass name {cls.name!r}")
    PASSES[cls.name] = cls
    return cls


def all_passes() -> Tuple[str, ...]:
    return tuple(sorted(PASSES))


class AnalysisPass(abc.ABC):
    name: str = ""
    description: str = ""

    def __init__(self) -> None:
        self.findings: List[Finding] = []

    @abc.abstractmethod
    def run(self, project: Project) -> List[Finding]:
        """Analyse ``project`` and return the surviving findings."""

    def emit(self, sf: Optional[SourceFile], line: int, rule: str,
             message: str, path: Optional[str] = None) -> None:
        """Record a finding unless a suppression pragma covers it.
        ``sf=None`` (runtime-reflection findings with no source handle)
        skips suppression; ``path`` overrides the rendered location."""
        if sf is not None and sf.suppressed(line, rule):
            return
        self.findings.append(Finding(
            pass_name=self.name, rule=rule,
            path=path or (sf.rel if sf is not None else "<runtime>"),
            line=line, message=message))
