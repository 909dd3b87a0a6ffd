"""The 95th percentile over all steps of the window of one
`simulate_and_time` call, on the device's clock (CUDA events on the idle
compute stream before and after the call), in ms."""

from sphbench.stats import percentile


def read(run):
    return percentile(run.record.step_s, 95) * 1e3 if run.record.step_s else None
