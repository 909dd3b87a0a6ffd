"""The timed steps that ran on the state the step before left in the
graphs' own tensors, over the traced window's steps: the port's counter
`graph.carried` (each such step adds 1; a step that copies its state in,
the first of each run, adds nothing; `tpusph_torch/engine/graphs.py`,
`CarriedLoop`)."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    carried = spans.counts().get("graph.carried")
    if not carried or not run.record.steps:
        return None
    return carried / run.record.steps
