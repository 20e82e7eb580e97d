"""Model FLOPs per second over the window's steps that ran outside the
profiler (the benchmark's count, remat's recompute not counted; a step
from the start of its wait for the batch to its loss read back) as a
percentage of the card's bf16 peak."""


def read(run):
    steps = [s for s in run.steps if not s.get("traced")] or run.steps
    busy = sum(s["t_end"] - s["t_wait"] for s in steps)
    if busy <= 0:
        return None
    return 100.0 * len(steps) * run.flops_per_step / busy / run.peak_flops
