"""Nothing under ``portbench/`` imports JAX or the JAX package ``repro``,
and nothing under ``portbench/reference/`` imports the port: checked on
the source with ``ast`` (an import inside a function counts), comparing
each module's top-level name (before the first dot) whole, since the
port's name ``repro_torch`` begins with ``repro``."""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _files(where: Path):
    files = sorted(where.rglob("*.py"))
    assert files, where
    return files


@pytest.mark.parametrize("path", _files(PB), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    bad = set(_top_names(path)) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("path", _files(PB / "reference"), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_the_reference_imports_nothing_of_the_port(path):
    names = set(_top_names(path))
    assert "repro_torch" not in names and not names & FORBIDDEN, path
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, f"{path} climbs out of reference/"


def test_the_names_are_compared_whole():
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN, loaded_forbidden

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    held = {m: sys.modules[m] for m in list(sys.modules)
            if m.split(".")[0] in FORBIDDEN}
    try:
        for m in held:
            del sys.modules[m]
        sys.modules["repro_torch_probe"] = sys
        assert loaded_forbidden() == []
        sys.modules["repro.probe"] = sys
        assert loaded_forbidden() == ["repro"]
    finally:
        sys.modules.pop("repro_torch_probe", None)
        sys.modules.pop("repro.probe", None)
        sys.modules.update(held)
