"""Headline benchmark of tpusph_torch: SPH timesteps/s at N = 262,144 on
one card. The counterpart of `bench.py`, function for function.

    python3 bench_torch.py                          # on the card
    TPUSPH_BENCH_DEVICE=cpu python3 bench_torch.py  # the plain versions on the CPU

The timed loop is bench.py's: 100 chained fields steps from grid init
(`make_fields_chain`, one CUDA-graph replay on a card), one warm replay,
then one timed replay up to a synchronize. Before timing, the gates hold
the physics on the same device: `verify_parity` (the timed loop against
the `cell_list` tile passes at N = 4096, and one `cell_list` step and one
step of the timed backend against the NumPy oracle of
`tests/oracle_numpy.py`) and `verify_headline` (the timed loop against the
tile passes at the timed N and config). The line reports "parity":
"pass" / "fail" ("skipped" with TPUSPH_BENCH_VERIFY=0).

Environment: TPUSPH_BENCH_N (262,144), TPUSPH_BENCH_STEPS (100),
TPUSPH_BENCH_BACKEND (`kernels`; bench.py's `pallas_sorted` and tpusph's
`auto` / `pallas` name it too; or `cell_list`, `allpairs`),
TPUSPH_BENCH_INIT=random (automatic above the grid lattice's capacity),
TPUSPH_BENCH_VERIFY=0, TPUSPH_BENCH_DEVICE (`cuda`; with no card and no
`cpu` asked for, exit 2). The JAX bench's TPUSPH_BENCH_COL_CAP ...
TPUSPH_SCOPED_VMEM_KIB set `pallas_*` knobs of the TPU kernels, which the
port does without: the config is `tuned_config(N)`.

TPUSPH_BENCH_DIST=<ranks> is the sharded mode (`main_dist`): one rank with
no group, or one rank a process under `torchrun --nproc_per_node <ranks>`.

Prints ONE JSON line, the last on stdout: metric
`torch_sph_timesteps_per_sec_n{N}` (sharded:
`torch_sph_dist_timesteps_per_sec_n{N}_r{ranks}`), value, unit, parity and
the device's name. Details of a failed gate go to stderr.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# bench.py's name for the backend it times
BACKEND_NAMES = {"pallas_sorted": "kernels"}
GROWTH_TRIES = 4  # bench.py's tile-capacity doublings before a gate gives up
PROFILED_DIST_STEPS = 10  # the sharded mode's profiled run, for the busy share


def bench_device() -> torch.device:
    """TPUSPH_BENCH_DEVICE (default `cuda`); exit 2 when it names a card
    and there is none: the bench never falls back to the CPU."""
    dev = torch.device(os.environ.get("TPUSPH_BENCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: torch.cuda is not available; set TPUSPH_BENCH_DEVICE=cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        raise SystemExit(2)
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_backend(name: str) -> str:
    """The port's backend for a TPUSPH_BENCH_BACKEND value."""
    from tpusph_torch.engine.step import resolve_backend

    return resolve_backend(BACKEND_NAMES.get(name, name))


def _canon(pos, *fields):
    """Order particle records by lexicographic position (multiset compare)."""
    order = np.lexsort(pos.T)
    return (pos[order],) + tuple(f[order] for f in fields)


def run_steps(state, cfg, steps: int, backend: str, device):
    """`steps` timesteps from `state`: (final FluidState, summed window
    overflow). `kernels` runs the loop the bench times, the fields chain
    (its state comes back in sorted order); another backend its step
    `steps` times."""
    from tpusph_torch.engine.step import (
        BACKENDS,
        fields_from_state,
        make_fields_chain,
        state_from_fields,
    )

    if backend == "kernels":
        fs, ovf = make_fields_chain(cfg, steps, device)(fields_from_state(state))
        return state_from_fields(fs), int(ovf)
    ovf = 0
    for _ in range(steps):
        state, aux = BACKENDS[backend](state, cfg)
        ovf += int(aux.window_overflow)
    return state, ovf


def _cell_list_steps(state, cfg, steps: int, device):
    """`steps` `step_cell_list` steps with bench.py's grow loop: the tile
    candidate capacity doubled while a window overflows, up to
    GROWTH_TRIES runs. (final state, its config), or (None, None)."""
    for _ in range(GROWTH_TRIES):
        out, ovf = run_steps(state, cfg, steps, "cell_list", device)
        if ovf == 0:
            return out, cfg
        cfg = dataclasses.replace(cfg, tile_cand_capacity=cfg.tile_cand_capacity * 2)
    return None, None


def records(state, cfg, backend: str):
    """((positions, density) of the live particles of `state`, window
    overflow): the density as `backend`'s step computes it at those
    positions (the density of one more step)."""
    from tpusph_torch.engine.step import BACKENDS

    nxt, aux = BACKENDS[backend](state, cfg)
    v = state.valid
    return (state.position[v].cpu().numpy(), nxt.density[v].cpu().numpy()), int(
        aux.window_overflow)


def hold_multisets(label: str, a, b):
    """Hold two runs' (positions, density) records as multisets by nearest
    neighbour. At 262,144 many particles share a lattice coordinate, so a
    lexicographic order can pair other particles once rounding splits a
    tie, and after 20 steps ~5,000 sit on another particle exactly, so no
    one-to-one pairing exists. Each run's particles lie within 1e-4 of the
    other run's, each coordinate's sorted values agree within 1e-4
    (multiplicities), and the density at paired positions within rtol
    1e-4. Returns the largest coordinate difference of paired particles,
    or None with what failed on stderr."""
    from scipy.spatial import cKDTree

    (pa, ra), (pb, rb) = a, b
    if len(pa) != len(pb):
        print(f"{label} FAIL: {len(pa)} against {len(pb)} live particles", file=sys.stderr)
        return None
    _, match = cKDTree(pb).query(pa)
    _, back = cKDTree(pa).query(pb)
    try:
        np.testing.assert_allclose(pa, pb[match], rtol=0, atol=1e-4)
        np.testing.assert_allclose(pb, pa[back], rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.sort(pa, axis=0), np.sort(pb, axis=0), rtol=0, atol=1e-4)
        np.testing.assert_allclose(ra, rb[match], rtol=1e-4, atol=0)
    except AssertionError as e:
        print(f"{label} FAIL: {e}", file=sys.stderr)
        return None
    return float(np.abs(pa - pb[match]).max()) if len(pa) else 0.0


def verify_parity(backend: str = "kernels", verify_steps: int = 10, n: int = 4096,
                  device="cuda") -> str:
    """Physics parity on `device`: `verify_steps` steps of the timed loop
    against as many `step_cell_list` steps, multiset-compared (positions
    atol 1e-4, density rtol 1e-4), no window overflow and every particle
    valid; then one `step_cell_list` step and one step of the timed
    backend against the NumPy oracle (density rtol 1e-4, positions atol
    1e-5). Returns 'pass' or 'fail', with details on stderr."""
    from tpusph_torch.core.config import default_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.engine.step import BACKENDS

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle_numpy import oracle_step

    cfg = default_config(n, chunk_size=min(4096, n))
    state0 = init_state(cfg, device=device)
    ok = True

    def check(name, a, b, rtol, atol):
        nonlocal ok
        try:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        except AssertionError as e:
            ok = False
            print(f"parity FAIL [{name}]: {e}", file=sys.stderr)

    # --- the timed loop against cell_list, multiset-compared
    sa, ovf_a = run_steps(state0, cfg, verify_steps, backend, device)
    sb, ovf_b = run_steps(state0, cfg, verify_steps, "cell_list", device)
    rec_a, ovf_a2 = records(sa, cfg, backend)
    rec_b, ovf_b2 = records(sb, cfg, "cell_list")
    if ovf_a + ovf_a2 or ovf_b + ovf_b2:
        print(f"parity FAIL: overflow a={ovf_a + ovf_a2} b={ovf_b + ovf_b2}", file=sys.stderr)
        ok = False
    if not len(rec_a[0]) == len(rec_b[0]) == cfg.num_particles:
        print("parity FAIL: particle count mismatch", file=sys.stderr)
        ok = False
    else:
        pa, ra = _canon(*rec_a)
        pb, rb = _canon(*rec_b)
        check(f"{backend} vs cell_list positions ({verify_steps} steps)", pa, pb,
              rtol=0, atol=1e-4)
        check(f"{backend} vs cell_list density ({verify_steps} steps)", ra, rb,
              rtol=1e-4, atol=0)

    # --- one step against the independent NumPy oracle
    v = state0.valid
    ref = oracle_step(state0.position[v].cpu().numpy(), state0.velocity[v].cpu().numpy(), cfg)
    for name in dict.fromkeys(("cell_list", backend)):
        s1, aux = BACKENDS[name](state0, cfg)
        if int(aux.oob_count):
            print(f"parity FAIL: {int(aux.oob_count)} particles outside the grid ({name})",
                  file=sys.stderr)
            ok = False
        check(f"{name} vs oracle density", s1.density[v].cpu().numpy(), ref["density"],
              rtol=1e-4, atol=0)
        check(f"{name} vs oracle positions", s1.position[v].cpu().numpy(), ref["position"],
              rtol=0, atol=1e-5)
    return "pass" if ok else "fail"


def verify_headline(cfg, state0, backend: str, device, steps: int = 1) -> str:
    """`steps` steps of the timed loop at the HEADLINE N and the exact timed
    config against the `step_cell_list` tile passes from the same state,
    growing their candidate capacity as bench.py does, held as multisets
    by nearest neighbour (`hold_multisets`). Catches what only the
    production N shows. Returns 'pass'/'fail'."""
    if backend != "kernels":
        return "pass"  # the timed backend IS the reference path
    sa, ovf = run_steps(state0, cfg, steps, backend, device)
    if ovf:
        print(f"headline parity FAIL: overflow {ovf} in the fields chain", file=sys.stderr)
        return "fail"
    sb, ccfg = _cell_list_steps(state0, cfg, steps, device)
    if sb is None:
        print("headline parity FAIL: cell_list overflow", file=sys.stderr)
        return "fail"
    rec_a, ovf_a = records(sa, cfg, backend)
    rec_b, ovf_b = records(sb, ccfg, "cell_list")
    if ovf_a or ovf_b:
        print(f"headline parity FAIL: overflow a={ovf_a} b={ovf_b}", file=sys.stderr)
        return "fail"
    dpos = hold_multisets(f"headline parity ({steps} steps, N={cfg.num_particles})", rec_a, rec_b)
    return "fail" if dpos is None else "pass"


def _is_rank0(comm) -> bool:
    import torch.distributed as dist

    return comm.group is None or dist.get_rank() == 0


def verify_dist_parity(sim, cfg, state0_host, device, gate_steps: int = 3) -> str:
    """Physics parity of the sharded engine AT THE TIMED N: `gate_steps`
    `DistSimulator` steps from the timed initial state, collected by pid
    (the engine keeps each particle's id), against a `step_cell_list`
    chain from the same state on `device` (rank 0's), with bench.py's grow
    loop: positions atol 1e-4. Every rank steps and collects; rank 0 holds
    the comparison and returns its verdict, the others 'skipped'. Sets the
    simulator up from `state0_host` again afterwards."""
    from tpusph_torch.core.state import state_from_numpy, state_to_numpy

    sim.run(gate_steps)
    got = sim.get_position()  # ordered by pid == original slot index
    sim.setup(state0_host)
    if not _is_rank0(sim.comm):
        return "skipped"
    ref, _ = _cell_list_steps(state_from_numpy(state_to_numpy(state0_host), device), cfg,
                              gate_steps, device)
    if ref is None:
        print("dist parity FAIL: cell_list overflow", file=sys.stderr)
        return "fail"
    try:
        np.testing.assert_allclose(got, ref.position[: cfg.num_particles].cpu().numpy(),
                                   rtol=0, atol=1e-4)
    except AssertionError as e:
        print(f"dist parity FAIL [positions, {gate_steps} steps]: {e}", file=sys.stderr)
        return "fail"
    return "pass"


def _size_and_init(n: int):
    """(tuned_config(n), random_init): random init when asked, and past the
    grid lattice's capacity whether asked or not."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import lattice_capacity

    cfg = tuned_config(n)
    random_init = os.environ.get("TPUSPH_BENCH_INIT") == "random"
    if n > lattice_capacity(cfg) and not random_init:
        print(f"bench: N={n} exceeds the {lattice_capacity(cfg)} grid-lattice ceiling — using "
              "random init", file=sys.stderr)
        random_init = True
    return cfg, random_init


def _busy_share(run, device):
    """Device time over wall time of one `run()` up to a synchronize, from
    torch.profiler's device events; None on the CPU or where the profiler
    shows no device time."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    return round(device_us / 1e6 / wall, 4) if device_us > 0 else None


def main_dist() -> None:
    """The sharded mode (TPUSPH_BENCH_DIST=<ranks>): `DistSimulator`'s
    production loop, held to the single-card bench's rigor by
    `verify_dist_parity` at the timed N (TPUSPH_BENCH_VERIFY=0 skips), plus
    the conservation and overflow checks inside `run()`. One rank needs no
    group; more are processes under `torchrun --nproc_per_node <ranks>`,
    each joining through `comm.join_torchrun`. A run whose WORLD_SIZE is
    not the asked rank count exits 2.

    Capacities are measured: `right_size(warmup_steps=10)` unless
    TPUSPH_BENCH_DIST_SLACK pins a slack. One warm `run(steps)` (it
    captures the run's CUDA graphs), the state set up again, one timed
    `run(steps)` up to a synchronize: on one rank one replay, as tpusph's
    chain is one dispatch; with peers one step's graph segments replayed
    `steps` times, the transports between them (`sharded.RankGraphs.run`).
    On a card a profiled run of PROFILED_DIST_STEPS more (made and warmed
    first) gives the device's busy share. The artifact records that the
    run is the graphed one (on the CPU its bodies under the capture guard)
    and the migration branches (category sorts, skips) that the timed run
    took. Rank 0 prints the
    line and writes it with its capacities to
    TORCH_DIST_BENCH[_FULL[_MIGSORT]][_n{N}].json in
    TPUSPH_BENCH_ARTIFACT_DIR (the repo root by default): `_FULL` with
    TPUSPH_DIST_FULL_MACHINERY=1, the engine as it runs by default (the
    migration-free sort skip live), `_MIGSORT` added where
    TPUSPH_DIST_FORCE_MIGSORT=1 turns the skip off (the whole machinery or
    more than one rank)."""
    import torch.distributed as dist

    from tpusph_torch.core.init import init_state
    from tpusph_torch.dist import sharded
    from tpusph_torch.dist.comm import join_torchrun
    from tpusph_torch.dist.simulator import DistSimulator, default_dist_config
    from tpusph_torch.scripts import device_card

    ranks = int(os.environ["TPUSPH_BENCH_DIST"])
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != ranks:
        print(f"bench_torch: TPUSPH_BENCH_DIST={ranks} asks for {ranks} ranks, this run has "
              f"{world}: start it under torchrun --nproc_per_node {ranks}", file=sys.stderr)
        raise SystemExit(2)
    n = int(os.environ.get("TPUSPH_BENCH_N", 262_144))
    steps = int(os.environ.get("TPUSPH_BENCH_STEPS", 100))
    device = bench_device()
    cfg, random_init = _size_and_init(n)
    comm = join_torchrun(device)
    try:
        slack_env = os.environ.get("TPUSPH_BENCH_DIST_SLACK")
        dcfg = default_dist_config(cfg, ranks, slack=float(slack_env)) if slack_env else None
        sim = DistSimulator(cfg, comm=comm, dcfg=dcfg, random_init=random_init, device=device)
        device = sim.device
        state0_host = init_state(cfg, random_init=random_init, device="cpu")
        sim.setup(state0_host)

        parity = "skipped"
        if os.environ.get("TPUSPH_BENCH_VERIFY", "1") != "0":
            parity = verify_dist_parity(sim, cfg, state0_host, device)

        right_sized = not slack_env
        if right_sized:
            sim.right_size(warmup_steps=10)  # sets the initial state up again
        # warm-up: every runner made and the capacities settled on the
        # trajectory, so that the timed run makes nothing
        sim.run(steps)
        sim.setup(state0_host)
        branches0 = sharded.migration_counts()
        _sync(device)
        t0 = time.perf_counter()
        sim.run(steps)
        _sync(device)
        dt = time.perf_counter() - t0
        sorts, skips = (b - a for a, b in zip(branches0, sharded.migration_counts()))
        sim.run(PROFILED_DIST_STEPS)  # made (captured on one rank) before it is profiled
        busy = _busy_share(lambda: sim.run(PROFILED_DIST_STEPS), device)
        if not _is_rank0(sim.comm):
            return
        line = {
            "metric": f"torch_sph_dist_timesteps_per_sec_n{n}_r{ranks}",
            "value": round(steps / dt, 3),
            "unit": "timesteps/s",
            "parity": parity,
            "device": device_name(device),
        }
        full = os.environ.get("TPUSPH_DIST_FULL_MACHINERY") == "1"
        migsort = os.environ.get("TPUSPH_DIST_FORCE_MIGSORT") == "1"
        artifact = dict(
            line, steps=steps, backend=sim.backend, ranks=ranks,
            dev_capacity=sim.dcfg.dev_capacity, halo_capacity=sim.dcfg.halo_capacity,
            migration_capacity=sim.dcfg.migration_capacity, right_sized=right_sized,
            slack=float(slack_env) if slack_env else None, full_machinery=full,
            force_migsort=migsort, device_busy=busy, card=device_card(device),
            graphed=True, migration_sorts=sorts, migration_skips=skips,
        )
        name = "TORCH_DIST_BENCH" + ("_FULL" if full else "")
        if migsort and (full or ranks > 1):  # the skip is there to turn off
            name += "_MIGSORT"
        if n != 262_144:  # other tiers get their own artifact
            name += f"_n{n}"
        art_dir = os.environ.get("TPUSPH_BENCH_ARTIFACT_DIR") or REPO
        with open(os.path.join(art_dir, name + ".json"), "w") as f:
            json.dump(artifact, f, indent=1)
        print(json.dumps(line), flush=True)
    finally:
        if comm is not None:
            dist.destroy_process_group()


def main() -> None:
    if os.environ.get("TPUSPH_BENCH_DIST"):
        main_dist()
        return
    from tpusph_torch.core.init import init_state
    from tpusph_torch.engine.step import BACKENDS, fields_from_state, make_fields_chain

    n = int(os.environ.get("TPUSPH_BENCH_N", 262_144))
    steps = int(os.environ.get("TPUSPH_BENCH_STEPS", 100))
    backend = bench_backend(os.environ.get("TPUSPH_BENCH_BACKEND", "kernels"))
    device = bench_device()
    cfg, random_init = _size_and_init(n)
    state0 = init_state(cfg, random_init=random_init, device=device)

    parity = "skipped"
    if os.environ.get("TPUSPH_BENCH_VERIFY", "1") != "0":
        parity = verify_parity(backend, device=device)
        if parity == "pass":
            # the gate must cover the configuration it reports: the timed
            # loop at the headline N with the exact timed config
            parity = verify_headline(cfg, state0, backend, device)

    if backend == "kernels":
        # The fields chain walks every window to its end: its only overflow
        # count is the rank kernel's, which has no capacity (always 0), so
        # there is nothing to grow.
        chain = make_fields_chain(cfg, steps, device)
        fs0 = fields_from_state(state0)
        _, ovf = chain(fs0)  # capture and first replay
        chain(fs0)  # warm replay
        if int(ovf):
            raise RuntimeError(f"fields chain overflow {int(ovf)}")
        _sync(device)
        t0 = time.perf_counter()
        chain(fs0)
        _sync(device)
        dt = time.perf_counter() - t0
    else:
        step = BACKENDS[backend]

        def run(cfg):
            state, ovf = state0, 0
            for _ in range(steps):
                state, aux = step(state, cfg)
                ovf = ovf + aux.window_overflow
            return int(ovf)

        # warm-up: grow the tile candidate capacity (the only capacity the
        # cell_list passes have) until the whole horizon runs clean
        for _ in range(6):
            if run(cfg) == 0:
                break
            cfg = dataclasses.replace(cfg, tile_cand_capacity=cfg.tile_cand_capacity * 2)
            print(f"capacity overflow; growing to tile_cand_capacity={cfg.tile_cand_capacity}",
                  file=sys.stderr)
        else:
            print("warning: capacity growth did not converge", file=sys.stderr)
        _sync(device)
        t0 = time.perf_counter()
        run(cfg)
        _sync(device)
        dt = time.perf_counter() - t0

    print(json.dumps({
        "metric": f"torch_sph_timesteps_per_sec_n{n}",
        "value": round(steps / dt, 3),
        "unit": "timesteps/s",
        "parity": parity,
        "device": device_name(device),
    }), flush=True)


if __name__ == "__main__":
    main()
