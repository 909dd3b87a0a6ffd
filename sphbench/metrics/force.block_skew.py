"""How uneven the force kernel's blocks are: the heaviest block's
candidates over the mean block's, from the port's counters over the traced
window (`tpusph_torch/kernels/fused.py`, `force`): `force.block_max` (each
step's heaviest block) over its steps, against `force.candidates` over
`force.blocks`. A launch's blocks are the same every step, so this is
sum(block_max x blocks) / sum(candidates). 1: every block walks as much."""


def read(run):
    try:
        from tpusph_torch.bench import spans
    except ImportError:  # a port without spans
        return None
    counts = spans.counts()
    candidates, top, blocks = (counts.get(f"force.{k}") for k in ("candidates", "block_max",
                                                                  "blocks"))
    if not candidates or not top or not blocks or not run.record.steps:
        return None
    return (top / run.record.steps) / (candidates / blocks)
