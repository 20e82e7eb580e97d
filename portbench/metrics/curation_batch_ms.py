"""Mean host milliseconds of one ``CurationFilter.filter`` call (insert,
the window's deletes, ``labels()``) begun in the window, on the
pipeline's prefetch thread; the harness's clock around each call."""


def read(run):
    calls = run.curation_calls
    if not calls:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] for c in calls) / len(calls)
