"""The sharded engine at scale, the counterpart of
`scripts/dist_scale_check.py`: N particles (1,048,576 by default) over
`ranks` gloo ranks (8) on the CPU, `steps` (5) `DistSimulator` steps of
the dam-break, with particle conservation and the halo, migration and
window overflow, misrouting and out-of-grid counters held at zero after
every step (the default capacity heuristics must hold):

    python -m tpusph_torch.scripts.dist_scale_check [N] [steps] [ranks]

Started plainly it spawns one process a rank; under `torchrun
--nproc_per_node <ranks>` each process joins torchrun's group instead.
Either way the ranks run on the CPU, as the JAX check's virtual devices
do. Rank 0 prints.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

DEADLINE_S = 3600.0


def check_rank(comm, n: int, steps: int) -> None:
    """One rank's share: set up, then `steps` checked steps."""
    from tpusph_torch.core.config import default_config
    from tpusph_torch.dist.simulator import DistSimulator
    from tpusph_torch.graft_entry import assert_aux_clean

    say = print if torch.distributed.get_rank() == 0 else (lambda *a, **k: None)
    sim = DistSimulator(default_config(n), comm=comm)
    t0 = time.perf_counter()
    sim.setup()
    say(f"setup: N={n} over {sim.comm.size} ranks (dev_capacity={sim.dcfg.dev_capacity}, "
        f"halo={sim.dcfg.halo_capacity}, migration={sim.dcfg.migration_capacity}) in "
        f"{time.perf_counter() - t0:.1f} s on {sim.device}", flush=True)
    for i in range(steps):
        t0 = time.perf_counter()
        sim.simulate()
        assert_aux_clean(sim.last_aux, n, "dist_scale_check", i)
        say(f"step {i}: {time.perf_counter() - t0:6.2f} s  alive={sim.last_aux.num_particles}",
            flush=True)
    say(f"OK: {steps} steps at N={n} on {sim.comm.size} ranks, zero overflow, exact "
        "conservation", flush=True)


def main(argv=None) -> None:
    from tpusph_torch.dist.comm import join_torchrun, spawn_ranks

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 1_048_576
    steps = int(argv[1]) if len(argv) > 1 else 5
    ranks = int(argv[2]) if len(argv) > 2 else 8
    if "RANK" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != ranks:
            raise SystemExit(f"dist_scale_check: {ranks} ranks asked, torchrun started "
                             f"{os.environ['WORLD_SIZE']}")
        comm = join_torchrun("cpu")
        try:
            check_rank(comm, n, steps)
        finally:
            torch.distributed.destroy_process_group()
        return
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(check_rank, ranks, "file://" + os.path.join(tmp, "store"), "cpu",
                    args=(n, steps), deadline_s=DEADLINE_S)


if __name__ == "__main__":
    main()
