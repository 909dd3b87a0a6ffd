"""The force kernel's rate, whatever the regime: the device time of the
force stage over the traced window (`stages/force.json`, from the
profiler) over the candidates its targets walked there (the port's counter
`force.candidates`; `tpusph_torch/kernels/fused.py`, `force`), in ns."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    candidates = spans.counts().get("force.candidates")
    seconds = run.trace.by_stage.get("force") if run.trace is not None else None
    if not candidates or not seconds:
        return None
    return seconds / candidates * 1e9
