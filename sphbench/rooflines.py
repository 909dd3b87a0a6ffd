"""A stage's share of its roofline, the arithmetic of the `*_roofline`
readers."""

from __future__ import annotations

from sphbench import counts


def share(run, stage: str):
    """100 × the least time of the traced window's `stage` calls over the
    device time of the kernels assigned to `stage`; None where the trace,
    the card's peaks, the pairs or those kernels are missing."""
    secs = run.trace.by_stage.get(stage) if run.trace is not None else None
    if not secs or run.peaks is None or run.pairs is None:
        return None
    least, binds = counts.least_seconds(stage, run.n, run.pairs, run.record.runs, run.peaks)
    run.notes.append(f"{stage} roofline: least {least:.6e} s over {secs:.6e} s device; "
                     f"calls bound by {binds}")
    return 100.0 * least / secs
