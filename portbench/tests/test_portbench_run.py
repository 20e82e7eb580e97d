"""Each cell's code path run end to end on the CPU at a tiny size: the
program's trainer and curation against the plain reference, the result
line's keys, the per-layer readers, and the exits without a result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(1, str(ROOT / "src"))

from portbench import manifest  # noqa: E402
from portbench.harness import RunRecord  # noqa: E402
from portbench.devtrace import TraceSummary  # noqa: E402
from portbench.reference.clustering import NOISE  # noqa: E402
from portbench.run import run  # noqa: E402
from portbench_tiny import CELLS, one_thread, tiny  # noqa: E402

_one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_tiny_run_agrees_with_the_reference(cell_name):
    import time

    cell, kw, limits = tiny(cell_name)
    seed = 2**31 + 12_345
    result, lines = run(cell, seed, 1.0, False, "cpu", time.perf_counter(),
                        limits=limits, **kw)
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert result["device"]["platform"] == "cpu"
    assert len(lines) == len(cell.limits) + 1
    json.dumps(result)


def test_the_partition_compared_holds_clusters():
    """The window that the check compares is not all noise: the stream's
    topics form clusters within a short run."""
    from portbench.harness import Session

    cell, kw, _ = tiny(CELLS[0])
    s = Session(cell, 7, "cpu", **kw)
    s.setup()
    for _ in range(20):
        s.one_step()
    s.close_program()
    keeps, part = s.reference_curation()
    assert any(v != NOISE for v in part.values())
    assert len(keeps) == len(s.curation.calls)


def _record(**kw):
    base = dict(steps=[{"t_wait": 0.0, "t_batch": 0.01, "t_end": 0.5,
                        "loss": 1.0},
                       {"t_wait": 0.5, "t_batch": 0.53, "t_end": 1.0,
                        "loss": 1.0}],
                window_start=0.0, window_end=1.0,
                curation_calls=[{"t0": 0.1, "t1": 0.3}],
                tokens_per_step=100, flops_per_step=989e12 * 0.25,
                flash_bound_s=1e-4, peak_flops=989e12)
    base.update(kw)
    return RunRecord(**base)


def test_the_readers_read_their_numbers():
    trace = TraceSummary(window_s=2.0, busy_s=1.5, device_ops=[],
                         idle_gaps=[], read_s=0.0,
                         kernels={"flash_attention_sm90_kernel": (4, 8e-4),
                                  "gemm": (10, 1.0)})
    rec = _record(trace=trace)
    read = {m: manifest.metric_module(m).read(rec) for m in
            ("curation_batch_ms", "curation_wait_ms", "train_mfu",
             "flash_attention_roofline", "device_idle_pct")}
    assert read["curation_batch_ms"] == pytest.approx(200.0)
    assert read["curation_wait_ms"] == pytest.approx(20.0)
    assert read["train_mfu"] == pytest.approx(50.0)
    assert read["flash_attention_roofline"] == pytest.approx(50.0)
    assert read["device_idle_pct"] == pytest.approx(25.0)


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = _record(curation_calls=[], trace=None)
    for m in ("curation_batch_ms", "flash_attention_roofline",
              "device_idle_pct"):
        assert manifest.metric_module(m).read(rec) is None
    empty = TraceSummary(window_s=1.0, busy_s=0.0, device_ops=[],
                         idle_gaps=[], kernels={}, read_s=0.0)
    rec = _record(trace=empty)
    assert manifest.metric_module("device_idle_pct").read(rec) is None
    assert manifest.metric_module("flash_attention_roofline").read(rec) \
        is None


def _cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _cli(ROOT)
    assert p.returncode == 2 and p.stdout == ""


def test_the_benchmark_alone_exits_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _cli(tmp_path, "--device", "cpu")
    assert p.returncode != 0 and p.stdout == ""
