"""1 minus the union of the device's operations over the traced window's
wall time (profiler), in %."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
