"""The timed steps whose copy of the positions to the host started before
the update's fence, while the card ran the update, over the traced
window's steps: the port's counter `sim.copy_overlapped` (each such step
adds 1; `tpusph_torch/engine/simulator.py`, `Simulator._timed_step`)."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    overlapped = spans.counts().get("sim.copy_overlapped")
    if not overlapped or not run.record.steps:
        return None
    return overlapped / run.record.steps
