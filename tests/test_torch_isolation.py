"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package ``repro`` (checked on
the source with ``ast``, so a lazy import inside a function counts too),
no relative import climbs out of ``repro_torch``, and every kernel that
``ops`` dispatches to the card has its CUDA source."""

import ast
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _files():
    files = sorted(PKG.rglob("*.py"))
    assert files, PKG
    return files + [ROOT / "chip_smoke.py"]


def _max_level(path: Path) -> int:
    """Deepest relative import (number of dots) that stays inside
    ``repro_torch`` from ``path``."""
    return len(path.relative_to(PKG).parent.parts) + 1


def _bad_imports(path: Path, text=None):
    tree = ast.parse(path.read_text() if text is None else text,
                     filename=str(path))
    in_pkg = PKG in path.parents
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                if not in_pkg or node.level > _max_level(path):
                    yield (f"{path}:{node.lineno} relative import leaves "
                           "the package")
                continue
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                yield f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.is_file(), path
    assert list(_bad_imports(path)) == []


def test_checker_catches_forbidden_imports():
    src = ("import numpy\nfrom repro.core import soa\n"
           "from .. import obs\n"
           "def f():\n    import jax.numpy as jnp\n"
           "    importlib.import_module('repro.kernels')\n"
           "from ... import x\n")
    found = list(_bad_imports(PKG / "core" / "probe.py", src))
    assert len(found) == 4, found
    assert sum("relative import" in f for f in found) == 1, found


def test_every_dispatched_kernel_has_a_cuda_source():
    from repro_torch.kernels import ops

    sources = "\n".join(p.read_text()
                        for p in (PKG / "kernels" / "csrc").glob("*.cu"))
    assert ops.KERNELS
    for name in ops.KERNELS:
        assert re.search(rf'extern "C" int {name}_launch\(', sources), \
            f"no CUDA source defines {name}_launch"
