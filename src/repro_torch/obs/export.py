"""Exporters: JSON snapshot, Prometheus text exposition, Chrome trace.

Three consumers, three formats, one source of truth (the registry /
tracer snapshots):

  * :func:`snapshot_json` — the raw JSON-able snapshot, for committing
    next to benchmark results;
  * :func:`to_prometheus` — the text exposition format a scrape endpoint
    would serve (counters as ``_total``, histograms as cumulative
    ``_bucket{le=...}`` series);
  * :func:`to_chrome` / :func:`write_chrome` — a Chrome/Perfetto
    trace-event dump (``chrome://tracing``, https://ui.perfetto.dev):
    one ``X`` (complete) event per span, one process lane per ``proc``
    label, and the span/parent ids carried in ``args`` so parentage is
    explicit, not just visual nesting.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Union

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "repro_" + _NAME_RE.sub("_", name)


# ---------------------------------------------------------------------- #
# metrics
# ---------------------------------------------------------------------- #
def snapshot_json(snapshots: Union[Dict[str, Any], List[Dict[str, Any]]],
                  indent: int = 1) -> str:
    """Serialise one or many ``Obs.snapshot()`` dicts."""
    return json.dumps(snapshots, indent=indent, sort_keys=False)


def merge_snapshots(snaps: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Fold per-process snapshots into one flat metrics dict with
    ``<proc>/``-prefixed names plus a single combined span list."""
    metrics: Dict[str, Any] = {}
    spans: List[Dict[str, Any]] = []
    dropped = 0
    for snap in snaps:
        proc = snap.get("proc", "?")
        for name, m in (snap.get("metrics") or {}).items():
            metrics[f"{proc}/{name}"] = m
        spans.extend(snap.get("spans") or [])
        dropped += int(snap.get("spans_dropped") or 0)
    return {"metrics": metrics, "spans": spans, "spans_dropped": dropped}


def to_prometheus(metrics: Mapping[str, Mapping[str, Any]]) -> str:
    """Text exposition of a metrics snapshot (``{name: instrument}``,
    the ``metrics`` half of ``Obs.snapshot()``)."""
    lines: List[str] = []
    for name, m in metrics.items():
        kind = m.get("type")
        pname = _prom_name(name)
        if kind == "counter":
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {m['value']}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {m['value']}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for bound, n in (m.get("buckets") or {}).items():
                cum += int(n)
                lines.append(f'{pname}_bucket{{le="{bound}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {m["count"]}')
            lines.append(f"{pname}_sum {m['sum']}")
            lines.append(f"{pname}_count {m['count']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------- #
# traces
# ---------------------------------------------------------------------- #
def to_chrome(spans: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON from exported span dicts (the
    ``Span.export()`` shape).  Every distinct ``proc`` label becomes a
    named process lane; ids ride in ``args`` for machine checking."""
    pids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for sp in spans:
        proc = sp.get("proc", "?")
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": proc}})
        events.append({
            "ph": "X", "cat": "repro", "name": sp["name"],
            "ts": sp["ts"], "dur": sp["dur"], "pid": pid, "tid": 0,
            "args": {"trace": sp["trace"], "span": sp["span"],
                     "parent": sp.get("parent"),
                     **(sp.get("args") or {})},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(path: Union[str, Path],
                 spans: Iterable[Mapping[str, Any]]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome(spans), indent=1))
    return path


def load_chrome(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """The ``X`` (complete) events of a Chrome trace dump."""
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def histogram_summary(metrics: Mapping[str, Mapping[str, Any]],
                      prefix: str = "") -> Dict[str, Dict[str, float]]:
    """Compact ``{name: {count, p50, p99, mean}}`` view of every
    histogram in a metrics snapshot — the shape benchmarks embed in
    ``results/*.json`` rows."""
    out: Dict[str, Dict[str, float]] = {}
    for name, m in metrics.items():
        if m.get("type") != "histogram" or not m.get("count"):
            continue
        if prefix and not name.startswith(prefix):
            continue
        out[name] = {"count": m["count"], "p50": m["p50"], "p99": m["p99"],
                     "mean": m["sum"] / m["count"]}
    return out


def span_stats(events: Iterable[Mapping[str, Any]],
               percentile=None) -> List[Dict[str, Any]]:
    """Per-op latency table from trace events: exact p50/p99 over the
    recorded durations, grouped by span name, sorted by total time."""
    if percentile is None:
        def percentile(xs: List[float], q: float) -> float:
            xs = sorted(xs)
            if not xs:
                return 0.0
            k = (len(xs) - 1) * q / 100.0
            lo, hi = int(k), min(int(k) + 1, len(xs) - 1)
            return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
    groups: Dict[str, List[float]] = {}
    for e in events:
        groups.setdefault(e["name"], []).append(float(e["dur"]))
    rows = []
    for name, durs in groups.items():
        rows.append({
            "op": name, "count": len(durs),
            "p50_us": percentile(durs, 50), "p99_us": percentile(durs, 99),
            "mean_us": sum(durs) / len(durs), "total_us": sum(durs),
        })
    rows.sort(key=lambda r: -r["total_us"])
    return rows
