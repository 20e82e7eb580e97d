"""``python -m repro_torch.analysis`` — run the port's static-analysis
suite.

Exit codes: 0 = clean, 1 = findings, 2 = bad invocation.  ``--json``
emits a machine-readable report (one object: findings + per-pass counts)
for CI artifacts; the default output is one ``path:line: RULE message
[pass]`` line per finding, sorted by location.

The AST passes analyse the tree under ``--root`` (default: the source
tree of the importable ``repro_torch`` package, i.e. the repo's
``src/``); the reflection passes (protocol, registry) always introspect
the *imported* ``repro_torch`` — point PYTHONPATH and --root at the same
checkout.

A copy of ``repro.analysis.cli``, with one difference: the JSON report's
``counts`` names every pass that ran, a clean one with 0, where the
reference's names only the passes with findings.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from .base import PASSES, all_passes
from .findings import Finding
from .walker import Project

# importing the pass modules populates the registry
from . import concurrency_pass  # noqa: F401
from . import fault_pass  # noqa: F401
from . import hotpath_pass  # noqa: F401
from . import obs_pass  # noqa: F401
from . import protocol_pass  # noqa: F401
from . import registry_pass  # noqa: F401


def run_passes(project: Project,
               names: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the named passes (default: all) and collect their findings."""
    findings: List[Finding] = []
    for name in names or all_passes():
        findings.extend(PASSES[name]().run(project))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="project-specific static analysis "
                    f"(passes: {', '.join(all_passes())})")
    ap.add_argument("--root", type=Path, default=None,
                    help="directory containing the package tree to analyse "
                         "(default: the imported repro_torch package's "
                         "parent)")
    ap.add_argument("--select", default=None, metavar="PASS[,PASS...]",
                    help="comma-separated subset of passes to run")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit a JSON report instead of text lines")
    ap.add_argument("--list", action="store_true", dest="list_passes",
                    help="list the registered passes and exit")
    args = ap.parse_args(argv)

    if args.list_passes:
        for name in all_passes():
            print(f"{name}: {PASSES[name].description}")
        return 0

    names = None
    if args.select:
        names = [n.strip() for n in args.select.split(",") if n.strip()]
        unknown = [n for n in names if n not in PASSES]
        if unknown:
            print(f"unknown pass(es): {', '.join(unknown)} "
                  f"(available: {', '.join(all_passes())})", file=sys.stderr)
            return 2

    project = Project(args.root) if args.root else Project.locate()
    findings = run_passes(project, names)

    if args.as_json:
        counts = dict.fromkeys(names or all_passes(), 0)
        for f in findings:
            counts[f.pass_name] += 1
        print(json.dumps({"ok": not findings,
                          "n_findings": len(findings),
                          "counts": counts,
                          "findings": [f.as_dict() for f in findings]},
                         indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s) from "
              f"{len(names or all_passes())} pass(es)")
    return 1 if findings else 0
