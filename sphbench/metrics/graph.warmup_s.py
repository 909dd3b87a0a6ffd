"""`graph.warmup` seconds of the whole process, in s: the eager warm-up call
of each graph the cell captured, all in the set-up, by the port's spans
(`tpusph_torch/bench/spans.py`, recorded at every capture)."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    t = spans.totals().get("graph.warmup")
    return None if t is None else t.seconds
