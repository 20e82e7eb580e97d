"""``chip_smoke.py`` on the CPU: its main path runs end to end at a tiny
size with the kernels' plain versions (the port's ``soa-device`` on
``device="cpu"`` against its host ``soa`` engine, labels and deltas
equal), and the script itself refuses to run without a CUDA device."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def test_main_path_runs_on_cpu():
    metrics, last = chip_smoke.run_main_path(3000, "cpu")
    assert metrics["points"] == 3000 and metrics["cut"]
    assert metrics["deleted"] == 750
    assert metrics["labels_equal_host_soa"]
    assert 0.5 < metrics["ari_after_inserts"] <= 1.0
    assert last["slots"].shape == (1000, chip_smoke.T)
    assert last["sizes"].shape == (last["n_slots"],)
    assert len(last["restored"]) == 3000 - 750


def test_script_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
