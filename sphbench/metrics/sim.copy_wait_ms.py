"""`sim.copy_wait` seconds over the traced window's steps, in ms: the timed
step's wait for the previous step's copy of the positions to the host, by
the port's spans (`tpusph_torch/bench/spans.py`); with `sim.copy_start_ms`
it makes `sim.copy_ms` (the two share its clock reads)."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    t = spans.totals().get("sim.copy_wait")
    if t is None or not run.record.steps:
        return None
    return t.seconds / run.record.steps * 1e3
