"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``) on the CPU, their printed lines captured:

  * quickstart over ``dynamic``, ``soa``, ``soa-device`` (``--device
    cpu``) and ``approx``: the port's lines equal the reference
    script's, run with ``runpy``;
  * streaming at 3,000 points (``main``'s ``n``) against the same
    stream through ``repro.api`` at that size: every per-batch ARI, the
    repair scans and the post-expiry ARI equal;
  * curation: both printed lines equal the reference's;
  * serve and train: the port passes exactly the reference example's
    argv to ``repro_torch.launch.serve`` / ``.train`` (plus
    ``--device``), then runs 4 requests and 2 steps.  The reference's
    trainer is not run (``repro.launch.train`` fails here at its mesh);
    its example's argv is read with the trainer replaced by a recorder.

Without ``--device cpu`` a device backend asks for the card, and with
no card it raises: nothing falls back to the CPU.
"""

import importlib.util
import re
import runpy
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def port_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_script(name: str, argv, capsys):
    """The reference example run as a script; its printed lines."""
    capsys.readouterr()
    old = sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
    try:
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


def port_lines(fn, capsys, *args, **kw):
    capsys.readouterr()
    fn(*args, **kw)
    return capsys.readouterr().out.splitlines()


@pytest.fixture
def prompt_switches():
    """The curation examples print counts that their pipeline's producer
    thread, one batch ahead, updates: a short switch interval keeps the
    thread from finishing a batch between the last batch taken and the
    print, in both scripts."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("backend", ["dynamic", "soa", "soa-device",
                                     "approx"])
def test_quickstart_prints_the_reference_lines(capsys, backend):
    want = reference_script("quickstart", ["--backend", backend], capsys)
    got = port_lines(port_example("torch_quickstart").main, capsys,
                     ["--backend", backend, "--device", "cpu"])
    assert len(want) == 3 and got == want


def test_quickstart_device_backend_needs_the_card(capsys):
    """The default ``--device cuda`` on a machine without a card: the
    device backend raises, it does not run on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_example("torch_quickstart").main(["--backend", "soa-device"])


def _streaming_reference(n: int):
    """``examples/streaming_clustering.py``'s stream at ``n`` points
    through ``repro.api``: per-batch (engine, baseline) ARIs, the repair
    scans of the expiry, the post-expiry ARI, as the script prints
    them."""
    from repro.api import ClusterConfig, build_index
    from repro.core import adjusted_rand_index
    from repro.data import blobs

    d, batch = 8, 1000
    X, y = blobs(n=n, d=d, n_clusters=8, cluster_std=0.2, seed=3)
    cfg = ClusterConfig(d=d, k=10, t=10, eps=0.5, seed=0)
    dyn = build_index(cfg.replace(backend="dynamic"))
    emz = build_index(cfg.replace(backend="emz-static"))
    ids, aris = [], []
    for s in range(0, n, batch):
        xb = X[s: s + batch]
        ids += dyn.insert_batch(xb)
        emz.insert_batch(xb)
        emz_lab = emz.labels()
        lab = dyn.labels(ids)
        pred = np.array([lab[i] for i in ids])
        pred_e = np.array([emz_lab[i] for i in sorted(emz_lab)])
        aris.append((f"{adjusted_rand_index(y[: s + batch], pred):.3f}",
                     f"{adjusted_rand_index(y[: s + batch], pred_e):.3f}"))
    dyn.delete_batch(ids[: n // 2])
    scans = dyn.stats().get("n_repair_scans", 0)
    lab = dyn.labels(ids[n // 2:])
    pred = np.array([lab[i] for i in ids[n // 2:]])
    post = round(adjusted_rand_index(y[n // 2:], pred), 3)
    return aris, scans, post


def test_streaming_holds_the_reference_stream(capsys):
    n = 3000
    lines = port_lines(port_example("torch_streaming_clustering").main,
                       capsys, ["--device", "cpu"], n=n)
    aris, scans, post = _streaming_reference(n)
    got = [tuple(re.findall(r"ARI=([0-9.]+)", ln)) for ln in lines[:-2]]
    assert got == aris
    assert [ln.split()[0] for ln in lines[:-2]] == ["n="] * len(aris)
    assert lines[-2].endswith(f"(repair scans fired: {scans})")
    assert lines[-1] == f"post-expiry ARI: {post}"


def test_curation_prints_the_reference_lines(capsys, prompt_switches):
    want = reference_script("curation_pipeline", [], capsys)
    got = port_lines(port_example("torch_curation_pipeline").main, capsys,
                     [])
    assert len(want) == 2 and got == want


def _reference_argv(name: str, module: str, monkeypatch, *argv):
    """The argv ``examples/<name>.py`` gives ``<module>.main``."""
    mod = importlib.import_module(module)
    seen = []
    monkeypatch.setattr(mod, "main", lambda a: seen.append(list(a)))
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return seen[0]


def test_serve_passes_the_reference_argv(monkeypatch, capsys):
    want = _reference_argv("serve_lm", "repro.launch.serve", monkeypatch)
    ex = port_example("torch_serve_lm")
    seen = []
    monkeypatch.setattr(ex, "serve_main", lambda a: seen.append(list(a)))
    ex.main(["--device", "cpu"])
    assert seen == [want + ["--device", "cpu"]]
    monkeypatch.undo()
    lines = port_lines(ex.main, capsys, ["--device", "cpu"], requests=4)
    assert re.match(r"served 4 requests, 32 tokens in .* on cpu", lines[0])
    assert len(lines) == 5


@pytest.mark.parametrize("argv", [[], ["--steps", "7"], ["--full-100m"]])
def test_train_passes_the_reference_argv(monkeypatch, argv):
    from repro_torch.launch.train import parse_args

    want = _reference_argv("train_lm", "repro.launch.train", monkeypatch,
                           *argv)
    ex = port_example("torch_train_lm")
    seen = []
    monkeypatch.setattr(ex, "train_main", lambda a: seen.append(list(a)))
    ex.main(argv + ["--device", "cpu"])
    assert seen == [want + ["--device", "cpu"]]
    got = vars(parse_args(seen[0]))
    assert got.pop("device") == "cpu"
    ref = vars(parse_args(want))
    ref.pop("device")
    assert got == ref


def test_train_runs_two_steps_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    losses = port_example("torch_train_lm").main(["--device", "cpu",
                                                  "--steps", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "arch=granite-20b" in out and "device=cpu" in out
