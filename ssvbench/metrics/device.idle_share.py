"""Share of the traced window in which no kernel, copy or fill ran on the
device: 1 minus the union of device activity over the window."""


def read(window):
    if window.trace is None:
        return None
    return 1.0 - window.trace.busy_s / window.trace.window_s
