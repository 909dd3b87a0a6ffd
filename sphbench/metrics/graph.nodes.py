"""The top-level CUDA-graph nodes replayed over the traced window's steps:
the port's counter `graph.nodes` (each replay adds its graph's nodes,
counted at capture; `tpusph_torch/bench/spans.py`)."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    nodes = spans.counts().get("graph.nodes")
    if not nodes or not run.record.steps:
        return None
    return nodes / run.record.steps
