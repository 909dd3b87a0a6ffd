"""Driver entry points of the port, the counterparts of `__graft_entry__.py`:
a one-step check on the card (`entry`) and a dry run of the sharded
engines over n ranks (`dryrun_multichip`).

The JAX dry run forces n virtual CPU devices and re-executes itself in a
subprocess when it cannot see them. Here a rank is a process, so the dry
run spawns n gloo ranks on the CPU (`dist.comm.spawn_ranks`) and needs no
re-execution.
"""

from __future__ import annotations

import os
import tempfile

N_DRYRUN = 8192
DRYRUN_DEADLINE_S = 900.0
COUNTERS = ("halo_overflow", "migration_overflow", "window_overflow", "misrouted", "oob_count")


def entry(device="cuda"):
    """(fn, example_args): the cell-list SPH timestep at N = 4096
    (`default_config(4096, chunk_size=4096)`, grid init) on `device`;
    `fn(state)` returns the next state."""
    from tpusph_torch.core.config import default_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.engine.step import step_cell_list

    cfg = default_config(4096, chunk_size=4096)
    state = init_state(cfg, device=device)

    def fn(state):
        new_state, aux = step_cell_list(state, cfg)
        return new_state

    return fn, (state,)


def dryrun_multichip(n_devices: int) -> None:
    """The sharded engines over `n_devices` gloo ranks on the CPU, one
    process a rank, at N = 8192 with particle conservation and every
    overflow, misrouting and out-of-grid counter held at zero after each
    step (`assert_aux_clean`). Three legs, as the JAX dry run's:
      1. z-slabs, backend `cell_list` (tpusph's XLA path): 10 steps of
         `make_sharded_step`, then one `make_sharded_run(steps=5)`;
      2. a brick grid, (2, 2, 2) on the first 8 ranks when there are 8 or
         more, else (n, 1, 1): 5 steps of `make_mesh3d_step` and one
         `make_mesh3d_run(steps=3)`;
      3. z-slabs with backend `kernels`, 2 steps: the per-device kernels,
         whose plain versions run on the CPU.
    Raises if a rank fails."""
    from tpusph_torch.dist.comm import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_dryrun_rank, n_devices, "file://" + os.path.join(tmp, "store"), "cpu",
                    deadline_s=DRYRUN_DEADLINE_S)


def assert_aux_clean(aux, n_expected: int, leg: str, i: int) -> None:
    """Conservation and the five counters at zero; raises otherwise."""
    got = int(aux.num_particles)
    if got != n_expected:
        raise RuntimeError(f"{leg} step {i}: particle conservation broken ({got} != {n_expected})")
    for name in COUNTERS:
        v = int(getattr(aux, name))
        if v != 0:
            raise RuntimeError(f"{leg} step {i}: {name} = {v}")


def dryrun_config():
    """tpusph's dry-run config, with the tile passes sized for its sparse
    state: tiles of 64 targets, whose columns held at most 98 candidates
    at step 0 (measured), at a capacity of 192. A sixth of the pair work of
    the default tiles (256 targets, capacity 768), which keeps the CPU
    dry run to about a minute; the window overflow is held at 0 all the
    same."""
    from tpusph_torch.core.config import default_config

    return default_config(N_DRYRUN, chunk_size=2048, tile_size=64, tile_cand_capacity=192)


def dryrun_state(cfg):
    """Random init (seed 0) with alternating ±3 z velocities: the sparse
    random state has ρ ≪ ρ₀ and gravity acts on y, so without the drift
    hardly a particle would cross a slab face; ±3 · dt = 0.03 a step keeps
    within the one-hop invariant while halo and migration carry real rows
    every step."""
    import torch

    from tpusph_torch.core.init import init_state

    state = init_state(cfg, random_init=True, seed=0, device="cpu")
    state.velocity[:, 2] = torch.where(torch.arange(state.num_slots) % 2 == 0, 3.0, -3.0)
    return state


def slab_leg(comm, cfg, dcfg, state, backend: str, steps: int, run_steps: int, leg: str) -> None:
    """`steps` sharded steps of this rank's slab, then one
    `make_sharded_run(run_steps)` when run_steps > 0, each checked."""
    from tpusph_torch.dist.sharded import distribute_state, make_sharded_run, make_sharded_step

    block = distribute_state(state, cfg, dcfg, comm)
    step = make_sharded_step(cfg, dcfg, comm, backend)
    for i in range(steps):
        block, aux = step(block)
        assert_aux_clean(aux, cfg.num_particles, leg, i)
    if run_steps:
        block, aux = make_sharded_run(cfg, dcfg, comm, run_steps, backend)(block)
        assert_aux_clean(aux, cfg.num_particles, leg + "-run", 0)


def _dryrun_rank(comm) -> None:
    import torch.distributed as dist

    from tpusph_torch.dist.comm import BrickComm
    from tpusph_torch.dist.mesh3d import distribute_state_3d, make_mesh3d_run, make_mesh3d_step
    from tpusph_torch.dist.sharded import DistConfig
    from tpusph_torch.dist.simulator import default_mesh3d_config

    n_ranks = comm.size
    cfg = dryrun_config()
    # tpusph's capacities, the slab's at least twice its share (fewer than
    # 4 ranks hold more than 4096 a slab)
    share = -(-cfg.num_particles // n_ranks)
    dcfg = DistConfig(n_devices=n_ranks, dev_capacity=max(4096, 2 * share),
                      halo_capacity=1024, migration_capacity=256)
    state = dryrun_state(cfg)
    say = print if comm.rank == 0 else (lambda *a, **k: None)

    # --- leg 1: z-slabs, the tile passes
    slab_leg(comm, cfg, dcfg, state, "cell_list", 10, 5, "slab")
    say(f"dryrun leg 1 (z-slabs + a 5-step run, N={N_DRYRUN}): OK", flush=True)

    # --- leg 2: a brick grid
    shape = (2, 2, 2) if n_ranks >= 8 else (n_ranks, 1, 1)
    n3 = shape[0] * shape[1] * shape[2]
    group = dist.group.WORLD if n3 == n_ranks else dist.new_group(list(range(n3)))
    if dist.get_rank() < n3:
        bricks = BrickComm(comm.device, group, shape)
        mcfg = default_mesh3d_config(cfg, shape)
        block = distribute_state_3d(state, cfg, mcfg, bricks)
        step3 = make_mesh3d_step(cfg, mcfg, bricks, "cell_list")
        for i in range(5):
            block, aux = step3(block)
            assert_aux_clean(aux, cfg.num_particles, "mesh3d", i)
        block, aux = make_mesh3d_run(cfg, mcfg, bricks, 3, "cell_list")(block)
        assert_aux_clean(aux, cfg.num_particles, "mesh3d-run", 0)
        del bricks  # no communicator may outlive its group
    say(f"dryrun leg 2 (brick grid {shape} + a 3-step run): OK", flush=True)

    # --- leg 3: z-slabs, the kernels
    slab_leg(comm, cfg, dcfg, state, "kernels", 2, 0, "kernels")
    say("dryrun leg 3 (z-slabs, backend kernels): OK", flush=True)
