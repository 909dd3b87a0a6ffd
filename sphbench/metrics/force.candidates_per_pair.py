"""The force pass's walk over its physics, in candidates a pair: the port's
counter `force.candidates` (the candidates the force kernel's targets
walked, each step of the traced window; `tpusph_torch/kernels/fused.py`,
`force`) over the reference's force pairs within h (r^2 <= h^2 and
r >= EPS, `run.pairs`) of every step of a run, times the window's runs.
1 would be a walk of the pairs alone."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    candidates = spans.counts().get("force.candidates")
    if not candidates or not run.pairs or not run.record.runs:
        return None
    pairs = sum(p[1] for p in run.pairs) * run.record.runs
    return candidates / pairs if pairs else None
