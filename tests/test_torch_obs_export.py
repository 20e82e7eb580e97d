"""The port's exporters and report CLI (``repro_torch.obs.export`` /
``.cli``) against ``repro.obs``'s, on the same snapshots: the ones a
traced sharded index of either package records (coordinator and shard
lanes, wire and engine spans, counters, gauges, histograms).  Every
output must be equal: merged snapshots, Prometheus text, Chrome trace
events, span statistics, histogram summaries and the CLI's report."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro.obs as jax_obs  # noqa: E402
import repro.obs.cli as jax_cli  # noqa: E402
from repro.data import blobs  # noqa: E402

import repro_torch.api as api  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro_torch.obs import cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _traced_snapshots(mod):
    """The obs snapshots of a traced 2-shard soa index of package ``mod``
    after a few inserts, deletes and queries."""
    X, _ = blobs(n=200, d=4, n_clusters=3, cluster_std=0.2, seed=1)
    cfg = mod.ClusterConfig(d=4, k=6, t=6, eps=0.45, seed=1,
                            backend="sharded", shards=2,
                            inner_backend="soa", obs=True)
    ix = mod.build_index(cfg)
    try:
        ids = ix.insert_batch(X[:120])
        ix.insert_batch(X[120:])
        ix.delete_batch(ids[:30])
        ix.labels()
        for i in ids[30:40]:
            ix.label(i)
        return ix.obs_snapshot()
    finally:
        ix.close()


@pytest.fixture(scope="module")
def snapshots():
    return {"port": _traced_snapshots(api), "reference":
            _traced_snapshots(jax_api)}


@pytest.mark.parametrize("source", ["port", "reference"])
def test_exporters_equal_the_reference(snapshots, source):
    snaps = snapshots[source]
    assert len(snaps) == 3  # the coordinator and two shard lanes
    merged = obs.merge_snapshots(snaps)
    assert merged == jax_obs.merge_snapshots(snaps)
    assert merged["spans"] and merged["metrics"]
    assert obs.snapshot_json(snaps) == jax_obs.snapshot_json(snaps)
    prom = obs.to_prometheus(merged["metrics"])
    assert prom == jax_obs.to_prometheus(merged["metrics"])
    assert "# TYPE" in prom
    chrome = obs.to_chrome(merged["spans"])
    assert chrome == jax_obs.to_chrome(merged["spans"])
    events = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert events
    assert obs.span_stats(events) == jax_obs.span_stats(events)
    assert obs.histogram_summary(merged["metrics"]) == \
        jax_obs.histogram_summary(merged["metrics"])


def test_trace_files_interchange(snapshots, tmp_path):
    spans = obs.merge_snapshots(snapshots["port"])["spans"]
    ours = obs.write_chrome(tmp_path / "ours.json", spans)
    theirs = jax_obs.write_chrome(tmp_path / "theirs.json", spans)
    assert ours.read_bytes() == theirs.read_bytes()
    assert obs.load_chrome(theirs) == jax_obs.load_chrome(ours)


def test_report_cli_equals_the_reference(snapshots, tmp_path, capsys):
    merged = obs.merge_snapshots(snapshots["port"])
    trace = obs.write_chrome(tmp_path / "trace.json", merged["spans"])
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps(snapshots["port"]))
    for argv in (["report", str(trace)], ["report", str(trace), "--json"],
                 ["prom", str(snap)]):
        assert cli.main(argv) == 0
        ours = capsys.readouterr().out
        assert jax_cli.main(argv) == 0
        assert ours == capsys.readouterr().out
        assert ours
    empty = obs.write_chrome(tmp_path / "empty.json", [])
    assert cli.main(["report", str(empty)]) == 1
    assert "no spans" in capsys.readouterr().out


def test_report_module_entry_point(snapshots, tmp_path):
    spans = obs.merge_snapshots(snapshots["port"])["spans"]
    trace = obs.write_chrome(tmp_path / "trace.json", spans)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", str(trace)],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    rows = out.stdout.splitlines()
    assert "spans" in rows[0] and rows[1].split()[:2] == ["op", "count"]
    ops = {r.split()[0] for r in rows[3:]}
    assert {"coord.insert_batch", "coord.labels"} <= ops
    assert np.all([int(r.split()[1]) > 0 for r in rows[3:]])
