"""Share (%) of the sweep kernel's device time in the window that the
least time of the window's sweep work needs over the window's alphabet
(``kernel_cost/ssv_sweep``): operations at the card's issue peak or bytes
at its bandwidth, whichever binds. The kernel's time is the summed duration of every
``ssv_word_kernel`` launch in the traced window. A trace without one fails
the run: the kernel is launched through ``ctypes``, and a profiler that
does not see it would read 0."""

from ssvbench.kernel_cost import peaks, ssv_sweep

KERNEL = "ssv_word_kernel"


def read(window):
    if window.trace is None:
        return None
    peak = peaks(window.device_kind)
    if peak is None:
        return None
    kernel_s = window.trace.seconds_of(KERNEL)
    if kernel_s <= 0:
        raise RuntimeError(f"the trace holds no {KERNEL} launch in the "
                           "window: the profiler did not see the kernel")
    least = ssv_sweep.least_seconds(
        [(s.positions, window.rows, s.hits) for s in window.searches],
        peak, window.card)
    window.notes["ssv_word_kernel_roofline"] = dict(
        least, kernel_s=kernel_s, ops_per_cell=ssv_sweep.OPS_PER_CELL)
    return 100.0 * least["seconds"] / kernel_s
