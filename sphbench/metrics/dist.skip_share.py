"""The migration steps that took the sort skip, over those that took a
branch, in the traced window: the port's counters `dist.migration_skips`
over `dist.migration_skips` + `dist.migration_sorts` (each chunk of
`DistSimulator.run` adds the branches it took, read after its counters;
`tpusph_torch/dist/simulator.py`). On a line of one rank no particle
crosses a face, so every step skips: 1.0."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    counts = spans.counts()
    skips, sorts = counts.get("dist.migration_skips"), counts.get("dist.migration_sorts")
    if skips is None or sorts is None or skips + sorts == 0:
        return None
    return skips / (skips + sorts)
