"""Source loading for the analysis passes: files, comments, pragmas.

Two pragma families ride in comments (both attach to the line they are
written on, or — for ``# hot-path`` — to the ``def`` they precede):

  * ``# hot-path`` marks a function outside ``repro_torch/kernels`` as a
    serving hot path, opting it into the hot-path purity checks for
    interpreted code (no per-point numpy conversions inside loops, no
    host syncs);
  * ``# analysis: allow[RULE1,RULE2]`` (or ``allow[*]``) suppresses the
    named rules on that line — the per-finding escape hatch.  Suppression
    is per line, not per file: a pragma never baselines a whole module.

``SourceFile`` parses a module once (AST + comment map + parent links —
``node.parent`` is set on every AST node so passes can walk upward, e.g.
"is this call inside a loop inside a hot function").  ``Project`` walks a
root directory for the package's modules and caches the parses; tests
point it at fixture trees.  A copy of ``repro.analysis.walker`` whose
``Project`` defaults to the package ``repro_torch``.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterator, List, Optional

_ALLOW = re.compile(r"analysis:\s*allow\[([^\]]*)\]")
_HOT = re.compile(r"#\s*hot-path\b")


class SourceFile:
    """One parsed module: AST (with parent links), comments, pragmas."""

    def __init__(self, text: str, rel: str):
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child.parent = node  # type: ignore[attr-defined]
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:  # pragma: no cover — ast would have raised
            pass

    # ------------------------------------------------------------------ #
    def suppressed(self, line: int, rule: str) -> bool:
        """True when ``# analysis: allow[...]`` on ``line`` (or the line
        above it) names ``rule`` or ``*``."""
        for ln in (line, line - 1):
            c = self.comments.get(ln)
            if not c:
                continue
            m = _ALLOW.search(c)
            if m:
                allowed = {r.strip() for r in m.group(1).split(",")}
                if "*" in allowed or rule in allowed:
                    return True
        return False

    def is_hot_path(self, fn: ast.AST) -> bool:
        """True when ``fn``'s def line, a decorator line, or the line
        directly above carries a ``# hot-path`` comment."""
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
        for ln in range(first - 1, fn.body[0].lineno):
            c = self.comments.get(ln)
            if c and _HOT.search(c):
                return True
        return False

    def functions(self) -> Iterator[ast.FunctionDef]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.FunctionDef):
                yield node


def enclosing(node: ast.AST, *types: type) -> Optional[ast.AST]:
    """Nearest ancestor of ``node`` that is an instance of ``types``,
    or None (walks the parent links SourceFile installed)."""
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, types):
            return cur
        cur = getattr(cur, "parent", None)
    return None


class Project:
    """The analysed source tree: ``root`` contains the package directory
    (for the real repo, ``src`` containing ``repro_torch``; for fixtures,
    any directory containing a ``repro_torch``-shaped subtree)."""

    def __init__(self, root: Path, package: str = "repro_torch"):
        self.root = Path(root)
        self.package = package
        self._cache: Dict[str, SourceFile] = {}

    @classmethod
    def locate(cls) -> "Project":
        """Project over the importable ``repro_torch`` package's own
        tree."""
        import repro_torch

        pkg_dir = Path(list(repro_torch.__path__)[0])
        return cls(pkg_dir.parent)

    # ------------------------------------------------------------------ #
    def _load(self, path: Path) -> Optional[SourceFile]:
        rel = str(path.relative_to(self.root / self.package))
        if rel not in self._cache:
            try:
                self._cache[rel] = SourceFile(path.read_text(), rel)
            except (OSError, SyntaxError):
                return None
        return self._cache[rel]

    def sources(self) -> List[SourceFile]:
        """Every parseable module under the package, sorted by path."""
        out = []
        pkg = self.root / self.package
        for path in sorted(pkg.rglob("*.py")):
            sf = self._load(path)
            if sf is not None:
                out.append(sf)
        return out

    def source(self, rel: str) -> Optional[SourceFile]:
        """The module at ``rel`` (path relative to the package dir)."""
        path = self.root / self.package / rel
        return self._load(path) if path.is_file() else None
