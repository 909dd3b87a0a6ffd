"""`Times.memcpy` over `Times.iters` in the traced window, in ms: the
Simulator's wait for the previous step's copy to the host and the start
of this step's."""


def read(run):
    t = run.record.times
    return t.memcpy / t.iters * 1e3 if t.iters else None
