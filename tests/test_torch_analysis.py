"""The reference's tree passes over the port's source.

``repro.analysis.walker.Project(Path("src"), package="repro_torch")``
lets the hot-path (HOT), fault-tolerance (FT001), observability
(OBS001) and concurrency (CONC) passes walk ``src/repro_torch`` as they
walk ``src/repro``.  Each must run there and return its findings (a
list of ``Finding``).  The hot-path pass's device scope is the
reference's ``kernels/``, Pallas code there; over the port it finds
only what the port's own pass (``repro_torch.analysis``, held in
``tests/test_torch_analysis_suite.py``) exempts by its written scope:
the host modules ``kernels/_build.py`` and ``kernels/_checks.py``, and
the host scalars of the launch ABI.  Nothing under ``src/repro/analysis``
changes for this.
"""

from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis.concurrency_pass import ConcurrencyGuards  # noqa: E402
from repro.analysis.fault_pass import FaultToleranceGuards  # noqa: E402
from repro.analysis.findings import Finding  # noqa: E402
from repro.analysis.hotpath_pass import HotPathPurity  # noqa: E402
from repro.analysis.obs_pass import ObsDiscipline  # noqa: E402
from repro.analysis.walker import Project  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def project():
    p = Project(SRC, package="repro_torch")
    assert len(p.sources()) > 50
    return p


@pytest.mark.parametrize("pass_cls,prefix", [
    (HotPathPurity, "HOT"), (FaultToleranceGuards, "FT"),
    (ObsDiscipline, "OBS"), (ConcurrencyGuards, "CONC")],
    ids=["HOT", "FT001", "OBS001", "CONC"])
def test_tree_pass_runs_over_the_port(project, pass_cls, prefix):
    findings = pass_cls().run(project)
    assert isinstance(findings, list)
    for f in findings:
        assert isinstance(f, Finding)
        assert f.rule.startswith(prefix), f
        assert (SRC / "repro_torch" / f.path).is_file(), f


def _launch_spans(path: Path):
    """(first, last) line of each ``_build.launch(...)`` call in ``path``."""
    import ast

    for node in ast.walk(ast.parse(path.read_text())):
        f = getattr(node, "func", None)
        if (isinstance(node, ast.Call) and isinstance(f, ast.Attribute)
                and f.attr == "launch" and isinstance(f.value, ast.Name)
                and f.value.id == "_build"):
            yield node.lineno, node.end_lineno


def test_hot_pass_sees_the_port_kernels(project):
    """The hot-path pass treats ``kernels/`` as device scope in the port
    too.  Its findings there are the host modules' loops (the build and
    the argument checks) and the ``int()`` / ``float()`` conversions in
    the argument lists of ``_build.launch``, the launch ABI: what the
    port's own pass exempts by its written scope, and nothing else."""
    from repro_torch.analysis.hotpath_pass import HOST_MODULES

    findings = HotPathPurity().run(project)
    assert findings
    assert all(f.path.startswith("kernels/") for f in findings)
    assert {f.rule for f in findings} <= {"HOT001", "HOT002", "HOT003"}
    assert {f.path for f in findings} >= set(HOST_MODULES)
    abi = 0
    for f in findings:
        if f.path in HOST_MODULES:
            continue
        assert f.rule == "HOT002" and f.message.startswith(
            ("int()", "float()")), f
        spans = list(_launch_spans(SRC / "repro_torch" / f.path))
        assert any(a <= f.line <= b for a, b in spans), f
        abi += 1
    assert abi > 0
