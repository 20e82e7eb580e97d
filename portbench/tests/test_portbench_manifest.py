"""The benchmark's manifest keeps to its contract's shapes, and every
configuration, traffic mix, limit file and per-layer metric it names is
found by name."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = [m["name"] for m in MAN["per_layer"]]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_plain_and_distinct(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_units_and_directions(section):
    for m in MAN[section]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_per_layer_entries_move_a_reported_metric():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["layer"] and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_configs_are_files_under_paths_with_their_cuts():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert c["file"].startswith("portbench/") and path.is_file()
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert data["arch"][key] != data["published"][key]
            assert not key.endswith(("_dim", "_rank")) and "d_" not in key


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_is_found_by_its_name(cell):
    c = manifest.cell(cell)
    conf, traffic = cell.split(".", 1)
    assert c.config["name"] == conf and c.traffic["name"] == traffic
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s",
                                                   "train_tokens_per_s"}
    assert c.per_layer
    assert set(c.limits) == {"loss_gap", "grad_gap", "update_gap",
                             "keep_mismatch", "partition_mismatch"}
    assert c.limits["keep_mismatch"] == 0
    assert c.limits["partition_mismatch"] == 0


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.cell("no-such-config.no_such_mix")


@pytest.mark.parametrize("name", METRICS)
def test_a_metric_is_a_reader_found_by_its_name(name):
    mod = manifest.metric_module(name)
    assert callable(mod.read)
