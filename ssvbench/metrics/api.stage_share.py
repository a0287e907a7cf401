"""Share of the window that the engine spends staging each search's
database and score rows on the device: the sum over the window's searches
of ``RunStats.pipeline_prof`` ``stage`` (the program's ``havac.stage``
span, on the sweep's worker, while the caller waits), over the window.
None where the program records no such counter."""

KEY = "stage"


def read(window):
    profs = [s.prof for s in window.searches]
    if not profs or any(p is None or KEY not in p for p in profs):
        return None
    return sum(p[KEY] for p in profs) / window.seconds
