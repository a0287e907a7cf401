"""Milliseconds the pipeline's worker spends dispatching a kernel launch:
the sum over the window's searches of ``RunStats.pipeline_prof``
``dispatch`` (the program's ``havac.launch`` spans) over the sum of its
``launches`` (the count of those spans, a regrow's relaunch apart), x 1000.
None where the program records no ``launches``."""

KEY = "launches"


def read(window):
    profs = [s.prof for s in window.searches]
    if not profs or any(p is None or KEY not in p for p in profs):
        return None
    launches = sum(p[KEY] for p in profs)
    if not launches:
        return None
    return 1e3 * sum(p["dispatch"] for p in profs) / launches
