"""The build phase's alternatives on one card, the counterpart of
`scripts/build_bench.py`:

    python -m tpusph_torch.scripts.build_bench [N]

At N particles of grid init (262,144 by default), each timed by
`scripts.graph_ms` (10 calls in one CUDA graph, the median of 11 replays):

  sort     the fields build's stable payload sort: `torch.sort` of the keys
           and the six `index_select`s into sorted order
  hist     the cell histogram by `scatter_add_` over the unsorted keys
  hist_s   the same over the sorted keys
  cumsum   the exclusive prefix sum over the num_cells + 1 counts alone
  rank     the starts table by the rank kernel (`starts_from_sorted`, the
           step's)
  ssorted  the starts table by `torch.searchsorted` over the same queries

The starts tables by histogram and prefix sum, by the rank kernel and by
`searchsorted` must be equal. Prints one line with the card's name and
power limit. The question it serves: sort and relayout cost more of the
chained step than density and rank together.
"""

from __future__ import annotations

import sys

import torch

from tpusph_torch.core.config import tuned_config
from tpusph_torch.core.init import init_state
from tpusph_torch.engine.step import fields_from_state
from tpusph_torch.neighbors.cell_list import cell_queries, starts_from_sorted
from tpusph_torch.neighbors.grid import compute_keys_fields
from tpusph_torch.scripts import card_line, cuda_device, graph_ms


def build_inputs(n: int, device):
    """(cfg, fields state, keys, sorted keys) of grid init at `n`."""
    cfg = tuned_config(n)
    fs = fields_from_state(init_state(cfg, device=device))
    key, _ = compute_keys_fields(fs.x, fs.y, fs.z, fs.valid, cfg)
    return cfg, fs, key, torch.sort(key, stable=True).values


def histogram(key, cfg):
    """Particles a cell, int32[num_cells + 1], by `scatter_add_`."""
    return key.new_zeros(cfg.num_cells + 1).scatter_add_(0, key.long(), torch.ones_like(key))


def exclusive_cumsum(counts):
    out = counts.new_zeros(counts.numel() + 1)
    out[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    return out


def starts_tables(cfg, key, key_sorted) -> dict:
    """The starts table, int32[num_cells + 2], three ways."""
    queries = cell_queries(cfg.num_cells, key.device)
    return {
        "hist+cumsum": exclusive_cumsum(histogram(key, cfg)),
        "rank": starts_from_sorted(key_sorted, cfg)[0],
        "searchsorted": torch.searchsorted(key_sorted, queries).to(torch.int32),
    }


def alternatives(cfg, fs, key, key_sorted) -> dict:
    """name → a call of one alternative, as the module docstring lists them."""
    counts = histogram(key, cfg)
    queries = cell_queries(cfg.num_cells, key.device)

    def sort():
        ks, perm = torch.sort(key, stable=True)
        return ks, [a.index_select(0, perm) for a in fs[:6]]

    return {
        "sort": sort,
        "hist": lambda: histogram(key, cfg),
        "hist_s": lambda: histogram(key_sorted, cfg),
        "cumsum": lambda: exclusive_cumsum(counts),
        "rank": lambda: starts_from_sorted(key_sorted, cfg),
        "ssorted": lambda: torch.searchsorted(key_sorted, queries).to(torch.int32),
    }


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 262_144
    dev = cuda_device()
    card = card_line()
    cfg, fs, key, key_sorted = build_inputs(n, dev)
    tables = starts_tables(cfg, key, key_sorted)
    ref = tables["hist+cumsum"]
    for name, table in tables.items():
        if not torch.equal(table, ref):
            raise RuntimeError(f"the starts table by {name} differs from hist+cumsum")
    ms = {name: graph_ms(fn) for name, fn in alternatives(cfg, fs, key, key_sorted).items()}
    print(f"build N={n} (device ms, 10 calls in one CUDA graph): "
          + "  ".join(f"{k}={v:.4f}" for k, v in ms.items())
          + f"; hist+cumsum == rank == searchsorted; {card}", flush=True)
    return ms


if __name__ == "__main__":
    main()
