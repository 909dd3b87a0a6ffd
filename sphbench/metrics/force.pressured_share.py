"""The share of the force pass's targets under pressure: the port's counter
`force.pressured` (the live targets with p > 0, each step of the traced
window; `tpusph_torch/kernels/fused.py`, `force`) over the cell's
particles times the window's steps. 0 while the fluid has no pressure
anywhere; a property of the state, which no change to the program should
move."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    counts = spans.counts()
    pressured = counts.get("force.pressured")
    if pressured is None or not counts.get("force.blocks") or not run.record.steps:
        return None
    return pressured / (run.n * run.record.steps)
