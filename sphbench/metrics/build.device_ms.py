"""The device time of the kernels that `stages/` assigns to the build (the
sort's passes, the gathers into cell order, the rank kernel) over the
traced window's steps, in ms."""


def read(run):
    if run.trace is None or not run.trace.by_stage.get("build"):
        return None
    return run.trace.by_stage["build"] / run.record.steps * 1e3
