"""The 95th percentile over all runs of the window of a run's time from
its launch to the end of its work, on the device's clock (CUDA events
around the call), in ms."""

from sphbench.stats import percentile


def read(run):
    return percentile(run.record.run_s, 95) * 1e3 if run.record.run_s else None
