"""Set-up: the process's start to the window's (host clock), in s: imports,
the card, the kernels' library (built on a checkout's first run), the
initial state, capture and first replay, one warm run."""


def read(run):
    return run.setup_s
