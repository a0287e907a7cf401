"""Share of the window that the caller spends outside
``PipelinedSweep.run``: 1 minus the sum of ``RunStats.sweep_seconds`` over
the window (waiting on the producer's parse and encode, staging, thread
start, ``hits()``)."""


def read(window):
    if not window.searches:
        return None
    return 1.0 - sum(s.sweep_seconds for s in window.searches) / window.seconds
