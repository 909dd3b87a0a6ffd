"""`sim.copy_start` seconds over the traced window's steps, in ms: the timed
step's start of its copy of the positions to the host (the pinned buffer,
the stream waits, the enqueue, `record_stream`), by the port's spans
(`tpusph_torch/bench/spans.py`); with `sim.copy_wait_ms` it makes
`sim.copy_ms`."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    t = spans.totals().get("sim.copy_start")
    if t is None or not run.record.steps:
        return None
    return t.seconds / run.record.steps * 1e3
