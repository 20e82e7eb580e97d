"""The output check fails what it should, at a CPU test's size: the
control (the reference computed in float8, the precision below the
configuration's bfloat16, put in the program's place) and, run by run
with the harness's look for a chip skipped, each fault a training cell
can have, planted underneath the timed path."""

import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import check  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402
from portbench.harness import Session  # noqa: E402
from portbench.run import run  # noqa: E402
from portbench_tiny import CELLS, one_thread, tiny  # noqa: E402

_one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_the_limits(cell_name):
    cell, kw, limits = tiny(cell_name)
    s = Session(cell, 2**31 + 99, "cpu", **kw)
    s.setup()
    s.close_program()
    ref = s.reference("f32")
    sound = check.numbers(s.readings, ref)
    control = check.numbers(s.reference("fp8"), ref)
    assert check.held(sound, limits)[1], sound
    assert not check.held(control, limits)[1], control


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_planted_fault_reads_not_correct(cell_name, fault):
    cell, kw, limits = tiny(cell_name)
    result, _ = run(cell, 4242, 0.3, False, "cpu", time.perf_counter(),
                    limits=limits, fault=FAULTS[fault], **kw)
    assert result["correct"] is False, result["checks"]
