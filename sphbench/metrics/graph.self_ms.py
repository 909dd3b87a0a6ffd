"""`graph.call` self seconds over the traced window's steps, in ms: a graphed
loop's call less its copies, clones and replays, i.e. its own Python (the
sync-debug toggles, launch bookkeeping, list handling), by the port's spans
(`tpusph_torch/bench/spans.py`)."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    t = spans.totals().get("graph.call")
    if t is None or not run.record.steps:
        return None
    return t.self_seconds / run.record.steps * 1e3
