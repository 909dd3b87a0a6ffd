"""Every device operation of the traced window (kernels and copies, by the
profiler), summed, over the steps the window ran, in ms."""


def read(run):
    if run.trace is None or run.trace.device_s <= 0:
        return None
    return run.trace.device_s / run.record.steps * 1e3
