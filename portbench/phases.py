"""A cell run with the program's spans on: the trainer's and curation's
phases on the device trace's clock, and what the spans cost.

    python3 portbench/phases.py --workload <cell> --seed <n> \\
        [--steps 6] [--cost-seconds 20] [--device cuda|cpu]

The cell is set up as ``portbench/run.py`` sets it up
(:class:`.harness.Session`), with one ``repro_torch.obs`` handle handed
to ``make_train_step``, ``Pipeline`` and ``CurationFilter``.  Then:

1. the harness's untraced window four times, in turns with the step
   built without and with the handle (off, on, on, off), each for
   ``--cost-seconds``: tokens/s and ``train_mfu`` of each, and in the
   windows with spans on, the spans against the harness's own clocks
   (``train.step`` count against the steps, ``curation.filter`` against
   ``curation_batch_ms``, ``pipeline.next`` against ``curation_wait_ms``);
2. ``--steps`` steps under the profiler, inside the harness's ``pb.*``
   ranges: ``devtrace.summarize``'s busy and window seconds, the device
   time of each phase (:mod:`.spans`) and the six per-layer readings.

Prints one JSON line.  ``BENCHMARK.json`` does not run this: its harness
hands the program no handle.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import devtrace, spans  # noqa: E402
from portbench.harness import Session  # noqa: E402
from portbench.manifest import metric_module  # noqa: E402

COUNTER = "engine.comp_rebuild_rows"


@contextlib.contextmanager
def _handing(obs):
    """``Session.build`` with ``obs`` handed to the three program objects
    it makes (it imports them when it runs)."""
    import repro_torch.data.pipeline as pipeline
    import repro_torch.training as training

    saved = [(training, "make_train_step"), (pipeline, "CurationFilter"),
             (pipeline, "Pipeline")]
    originals = [getattr(m, n) for m, n in saved]
    for (m, n), f in zip(saved, originals):
        setattr(m, n, functools.partial(f, obs=obs))
    try:
        yield
    finally:
        for (m, n), f in zip(saved, originals):
            setattr(m, n, f)


class ObservedSession(Session):
    """The harness's session with one live ``Obs`` in the program."""

    def build(self) -> None:
        from repro_torch.obs import make_obs
        from repro_torch.training import make_train_step

        self.obs = make_obs(True, "trainer")
        with _handing(self.obs):
            super().build()
        self.step_on = self.step_fn
        self.step_off = make_train_step(
            self.model, self.opt, grad_accum=self.traffic["grad_accum"])


def _ms(xs) -> float:
    return 1e3 * statistics.fmean(xs) if xs else float("nan")


def _dur_s(sps, name):
    return [(sp.end_ns - sp.start_ns) / 1e9 for sp in sps if sp.name == name]


def cost(s: ObservedSession, seconds: float) -> Dict[str, Any]:
    """The untraced window in turns, off / on / on / off."""
    from portbench.run import end_to_end

    out: Dict[str, Any] = {"off": [], "on": []}
    for side in ("off", "on", "on", "off"):
        s.step_fn = s.step_on if side == "on" else s.step_off
        t0 = time.time_ns()
        rec = s.window(seconds, False)
        t1 = time.time_ns()
        row = {"train_tokens_per_s": end_to_end("train_tokens_per_s", rec,
                                                0.0, 0),
               "train_mfu": metric_module("train_mfu").read(rec),
               "steps": len(rec.steps),
               "curation_batch_ms": metric_module(
                   "curation_batch_ms").read(rec),
               "curation_wait_ms": metric_module(
                   "curation_wait_ms").read(rec)}
        if side == "on":
            sps = [sp for sp in s.obs.tracer.spans if t0 <= sp.start_ns < t1]
            row["spans"] = {
                "train_step_n": len(_dur_s(sps, "train.step")),
                "train_step_ms": _ms(_dur_s(sps, "train.step")),
                "host_step_ms": _ms([st["t_end"] - st["t_batch"]
                                     for st in rec.steps]),
                "curation_filter_ms": _ms(_dur_s(sps, "curation.filter")),
                "pipeline_next_ms": _ms(_dur_s(sps, "pipeline.next"))}
        out[side].append(row)
    s.step_fn = s.step_on
    return out


def traced(s: ObservedSession, n: int) -> Dict[str, Any]:
    """``n`` steps under the profiler, read with the program's spans."""
    import torch

    counter = s.obs.metrics.counter(COUNTER)
    c0, t0 = counter.value, time.time_ns()
    prof = devtrace.start()
    for _ in range(n):
        with devtrace.label("next_batch"):
            batch = next(s.pipe)
        with devtrace.label("to_device"):
            tb = {k: torch.from_numpy(batch[k]).to(s.device, torch.long)
                  for k in ("tokens", "labels")}
        with devtrace.label("step"):
            s.params, s.opt_state, m = s.step_fn(s.params, s.opt_state, tb)
        with devtrace.label("loss_readback"):
            float(m["loss"])
    devtrace.stop(prof)
    c1, t1 = counter.value, time.time_ns()
    summary = devtrace.summarize(prof)
    ops, launches, window = spans.from_profiler(prof)
    sps = list(s.obs.tracer.spans)
    aliases = spans.thread_aliases(threading.enumerate())
    ph = spans.phase_device_s(ops, launches, sps, window, aliases)
    idle = spans.idle_under(ops, sps, window)
    roles = {sp.tid: sp.name.split(".")[0] for sp in sps
             if sp.name in ("train.step", "curation.filter")}
    by_thread = collections.Counter(
        roles.get(aliases.get(tid, tid), "unnamed")
        for _, tid in (launches[c] for a, b, c in ops
                       if c in launches and window[0] <= a < window[1]))
    return {"busy_s": summary.busy_s, "window_s": summary.window_s,
            "steps": ph.steps, "phase_device_s": ph.device_s,
            "phase_sum_s": sum(ph.device_s.values()),
            "unmatched_ops": ph.unmatched, "device_ops": len(ops),
            "launches_by_thread": dict(by_thread),
            "filter_calls": sum(sp.name == "curation.filter"
                                and window[0] <= sp.start_ns < window[1]
                                for sp in sps),
            "readings": spans.readings(ph, idle, window, sps,
                                       (c1 - c0, (t0, t1))),
            "spans_dropped": s.obs.tracer.dropped}


def run(cell, seed: int, steps: int, cost_seconds: float, device: str,
        **session_kw) -> Dict[str, Any]:
    s = ObservedSession(cell, seed, device, **session_kw)
    s.setup()
    try:
        out = {"workload": cell.name, "seed": seed, "device": device}
        if cost_seconds > 0:
            out["cost"] = cost(s, cost_seconds)
        out["traced"] = traced(s, steps)
        return out
    finally:
        s.close_program()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--cost-seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from portbench import manifest
    from portbench.run import _paths

    _paths()
    out = run(manifest.cell(args.workload), args.seed, args.steps,
              args.cost_seconds, args.device)
    if args.device == "cuda":
        import torch

        out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
