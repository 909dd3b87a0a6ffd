"""`graph.copy_in` plus `graph.clone_out` seconds over the traced window's
steps, in ms: a graphed loop's copies of its inputs into the graph's tensors
and its clones of the outputs, on the host (the enqueue), by the port's
spans (`tpusph_torch/bench/spans.py`)."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    tot = spans.totals()
    parts = [tot[k].seconds for k in ("graph.copy_in", "graph.clone_out") if k in tot]
    if not parts or not run.record.steps:
        return None
    return sum(parts) / run.record.steps * 1e3
