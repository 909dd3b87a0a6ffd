"""The rows a rank held at its peak over the rows it carries, in the
traced window: the port's counters `dist.rows_peak` (each chunk of
`DistSimulator.run` adds its `max_dev_particles`) over
`dist.rows_capacity` (its `dev_capacity`; `tpusph_torch/dist/simulator.py`).
The kernels run on `dev_capacity` rows plus the halo's, so 1 - this is the
padding they carry."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    counts = spans.counts()
    peak, capacity = counts.get("dist.rows_peak"), counts.get("dist.rows_capacity")
    if not peak or not capacity:
        return None
    return peak / capacity
