"""All steps completed in the window over the window's seconds (host clock)."""


def read(run):
    return run.record.steps / run.record.window_s
