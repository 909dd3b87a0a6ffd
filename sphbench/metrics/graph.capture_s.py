"""The harness's wall clock around the cell's first run, in s: the capture
of the cell's graphed loop or loops plus the first replay."""


def read(run):
    return run.capture_s
