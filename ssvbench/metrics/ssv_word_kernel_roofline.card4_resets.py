"""Share (%) of the card-4 sweep kernel with reset rows that the least
time of the window's sweep work needs over the 4 nucleotide codes
(``kernel_cost/ssv_sweep``: 2-bit codes, 4 score bytes a row; operations
at the card's issue peak or bytes at its bandwidth, whichever binds). The
kernel's time is the summed duration of only the card-4 reset-row
instances of ``ssv_word_kernel`` (``ssv_word_kernel<true, true, ...>``, or
their mangled names) in the traced window: the DNA collection searched
with isolated models. A trace without one fails the run: the kernel is
launched through ``ctypes``, so a profiler that does not see it would read
0, and a cell that fell back to the chained kernel must not pass."""

from ssvbench.kernel_cost import peaks, ssv_sweep

CARD = 4
# the template's leading <kCard4 = true, kReset = true>, demangled and
# mangled
KERNELS = ("ssv_word_kernel<true, true,", "ssv_word_kernelILb1ELb1E")


def read(window):
    if window.trace is None:
        return None
    peak = peaks(window.device_kind)
    if peak is None:
        return None
    kernel_s = sum(s for name, s in window.trace.kernel_s.items()
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        raise RuntimeError("the trace holds no card-4 reset-row "
                           "ssv_word_kernel launch in the window")
    least = ssv_sweep.least_seconds(
        [(s.positions, window.rows, s.hits) for s in window.searches],
        peak, CARD)
    window.notes["ssv_word_kernel_roofline.card4_resets"] = dict(
        least, kernel_s=kernel_s, ops_per_cell=ssv_sweep.OPS_PER_CELL)
    return 100.0 * least["seconds"] / kernel_s
