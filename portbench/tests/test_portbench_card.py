"""Each cell's code path on the card at the CPU tests' size, traced: the
flash kernel's launches are read from the profiler, and the run agrees
with the reference.  Needs an NVIDIA GPU; skips here otherwise."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench_tiny import CELLS, tiny  # noqa: E402


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_small_traced_run_on_the_card(card, cell_name):
    from portbench.run import run

    cell, kw, limits = tiny(cell_name)
    kw["traffic"]["trace_steps"] = 2
    result, _ = run(cell, 31337, 2.0, True, "cuda", time.perf_counter(),
                    limits=limits, **kw)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert "flash_attention_roofline" in result["metrics"]
    assert "device_idle_pct" in result["metrics"]
    assert result["breakdown"]["device_ops"]
