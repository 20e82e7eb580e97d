"""``python -m repro_torch.obs`` — render human-readable reports from dumps.

Subcommands:

  * ``report <trace.json>`` — per-op latency table (count, p50, p99,
    mean, total) computed from a Chrome trace-event dump's ``X`` events.
  * ``prom <snapshot.json>`` — Prometheus text exposition of a metrics
    snapshot file (one ``Obs.snapshot()`` dict or a list of them).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .export import load_chrome, merge_snapshots, span_stats, to_prometheus


def _fmt_us(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.2f}ms"
    return f"{v:.0f}us"


def _report(path: str, as_json: bool) -> int:
    events = load_chrome(path)
    rows = span_stats(events)
    if as_json:
        print(json.dumps(rows, indent=1))
        return 0
    if not rows:
        print(f"{path}: no spans")
        return 1
    procs = len({e.get("pid") for e in events})
    print(f"{path}: {len(events)} spans, {len(rows)} ops, {procs} process lanes")
    hdr = f"{'op':<28} {'count':>6} {'p50':>10} {'p99':>10} {'mean':>10} {'total':>10}"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['op']:<28} {r['count']:>6} {_fmt_us(r['p50_us']):>10} "
              f"{_fmt_us(r['p99_us']):>10} {_fmt_us(r['mean_us']):>10} "
              f"{_fmt_us(r['total_us']):>10}")
    return 0


def _prom(path: str) -> int:
    data = json.loads(Path(path).read_text())
    if isinstance(data, list):
        data = merge_snapshots(data)
    elif "proc" in data:  # a single un-merged Obs.snapshot()
        data = merge_snapshots([data])
    sys.stdout.write(to_prometheus(data.get("metrics") or {}))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("report", help="per-op latency table from a "
                                        "Chrome trace-event dump")
    rep.add_argument("trace", help="path to trace-event JSON")
    rep.add_argument("--json", action="store_true", help="machine output")

    prom = sub.add_parser("prom", help="Prometheus text exposition of a "
                                       "metrics snapshot file")
    prom.add_argument("snapshot", help="path to Obs.snapshot() JSON")

    args = ap.parse_args(argv)
    if args.cmd == "report":
        return _report(args.trace, args.json)
    return _prom(args.snapshot)


if __name__ == "__main__":
    sys.exit(main())
