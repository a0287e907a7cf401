"""Share of the window that the caller spends waiting on ``scan_files``'
producer for the next file's parse and encode: the sum over the window's
searches of ``RunStats.pipeline_prof`` ``encode_wait`` (the program's
``havac.encode_wait`` span, on the consumer), over the window. None where
the program records no such counter."""

KEY = "encode_wait"


def read(window):
    profs = [s.prof for s in window.searches]
    if not profs or any(p is None or KEY not in p for p in profs):
        return None
    return sum(p[KEY] for p in profs) / window.seconds
