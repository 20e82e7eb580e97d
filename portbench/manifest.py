"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` is an entry of ``workloads``; its
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, the limits of its output check
``limits/<cell>.json`` and each per-layer metric ``metrics/<name>.py``
(a module with ``read(run) -> float | None``).  A later cell, mix or
metric is a new file and a new entry: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One workload of the manifest, with the files it names."""
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load() -> Dict[str, Any]:
    return _json(MANIFEST)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: Optional[Dict[str, Any]] = None) -> Cell:
    """The workload ``name``; raises KeyError for a name the manifest
    does not hold."""
    man = manifest or load()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}")
    return Cell(
        name=name,
        config=_json(HERE / "configs" / f"{entry['config']}.json"),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json")["limits"],
        chips=int(entry["chips"]),
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def metric_module(name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by its path (a name may hold ``.``
    and ``-``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
