"""``search_gcups`` read as a per-layer metric, by the host's clock:
residues searched x model positions over the window's seconds, in a cell
whose host path sets the pace and whose runs spread too widely on a shared
host to bound it end to end. Read from the traced run, so the profiler's
cost on the host is in it."""


def read(window):
    if not window.searches:
        return None
    return (sum(s.positions for s in window.searches) * window.rows
            / window.seconds / 1e9)
