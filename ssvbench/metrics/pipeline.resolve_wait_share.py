"""Share of the window in which the pipeline's main thread waits on the
collector pool's sorts and resolves: the sum over the window's searches of
``RunStats.pipeline_prof`` ``resolve_wait`` (the program's
``havac.resolve_wait`` span: the futures' results, in the drain and at
checkpoints), over the window. None where the program records no such
counter."""

KEY = "resolve_wait"


def read(window):
    profs = [s.prof for s in window.searches]
    if not profs or any(p is None or KEY not in p for p in profs):
        return None
    return sum(p[KEY] for p in profs) / window.seconds
