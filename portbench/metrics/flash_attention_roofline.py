"""The traced ``flash_attention_sm90`` launches' least possible time (the
benchmark's count of one launch's operations and bytes at the cell's
shape, the larger of operations over the bf16 peak and bytes over the
HBM rate) as a percentage of their device time in the profiler's
trace."""

KERNEL = "flash_attention_sm90"


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.kernel(KERNEL)
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * run.flash_bound_s / seconds
