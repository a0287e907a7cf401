"""Share of the window that the pipeline's main thread spends on the host
hit path: the sum over the window's searches of ``RunStats.pipeline_prof``
``fetch + regrow + drain + tail`` (wall seconds), over the window."""

PHASES = ("fetch", "regrow", "drain", "tail")


def read(window):
    profs = [s.prof for s in window.searches]
    if not profs or any(p is None for p in profs):
        return None
    return sum(p[k] for p in profs for k in PHASES) / window.seconds
