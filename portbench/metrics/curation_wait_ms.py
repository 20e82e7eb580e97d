"""Mean host milliseconds a step of the window waited for its batch
(``next(pipeline)``): what the curated pipeline adds to the step."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * sum(s["t_batch"] - s["t_wait"] for s in run.steps) \
        / len(run.steps)
