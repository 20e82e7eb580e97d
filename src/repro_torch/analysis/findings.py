"""Finding — one rule violation at one source location.

Findings are plain data: the CLI renders them as ``path:line: RULE
message [pass]`` lines or as JSON objects, and the exit code is driven by
their count.  Rule ids are stable strings (``PROTO001`` …) so
suppression pragmas (see :mod:`repro_torch.analysis.walker`) and CI
greps can target them.  A copy of ``repro.analysis.findings``: the rule
ids, the rendering and the JSON keys are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str   # which analysis pass produced it
    rule: str        # stable rule id, e.g. "HOT001"
    path: str        # path relative to the analysed root (or module name)
    line: int        # 1-based line number (0 = whole file / no source)
    message: str     # human-readable description of the violation

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"{self.message} [{self.pass_name}]")

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
