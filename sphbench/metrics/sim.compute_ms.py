"""(`Times.build_grid` + `Times.sph_update`) over `Times.iters` in the
traced window, in ms: the Simulator's two fenced replays a step."""


def read(run):
    t = run.record.times
    return (t.build_grid + t.sph_update) / t.iters * 1e3 if t.iters else None
