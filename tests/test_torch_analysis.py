"""The reference's tree passes over the port's source.

``repro.analysis.walker.Project(Path("src"), package="repro_torch")``
lets the hot-path (HOT), fault-tolerance (FT001), observability
(OBS001) and concurrency (CONC) passes walk ``src/repro_torch`` as they
walk ``src/repro``.  Each must run there and return its findings (a
list of ``Finding``; what they are is recorded in ROADMAP.md).  The
registry pass (REG) reflects over the live ``repro.api`` backends, not a
source tree, so it does not apply.  Nothing under ``src/repro/analysis``
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


def test_hot_pass_sees_the_port_kernels(project):
    """The hot-path pass treats ``kernels/`` as device scope in the port
    too: its findings there are the host-side loops and scalar
    conversions of the wrappers (shapes, launch arguments, the build)."""
    findings = HotPathPurity().run(project)
    assert findings
    assert all(f.path.startswith("kernels/") for f in findings)
    assert {f.rule for f in findings} <= {"HOT001", "HOT002", "HOT003"}
