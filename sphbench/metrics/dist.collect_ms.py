"""`dist.collect` seconds over the traced window's runs, in ms: the
collect of the whole state to the host, ordered by pid
(`collect_state`, `tpusph_torch/dist/sharded.py`), by the port's spans
(`tpusph_torch/bench/spans.py`)."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    t = spans.totals().get("dist.collect")
    if t is None or not run.record.runs:
        return None
    return t.seconds / run.record.runs * 1e3
