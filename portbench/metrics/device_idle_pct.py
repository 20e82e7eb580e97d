"""The share of the traced window (a steady run of the window's steps)
in which no operation ran on the device, from the profiler's trace;
nothing where the trace holds no device operation."""


def read(run):
    if run.trace is None or not run.trace.kernels or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
