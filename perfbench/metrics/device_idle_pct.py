"""The device's idle share of the traced sub-window: 1 - (union of the
intervals of its kernels, copies and memsets) / window, in percent."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
