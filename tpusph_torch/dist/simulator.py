"""DistSimulator, the front end of the sharded engines with the single-card
Simulator's surface (setup / simulate / simulate_and_time / get_position).
Counterpart of `tpusph/dist/simulator.py`.

The JAX package drives every device of a mesh from one process. Here every
rank is a process and runs its own DistSimulator over one process group
(SPMD): every rank calls the same methods in the same order, each steps
its own block, and the counters, the collect and every decision taken
from them are the same on every rank. `mesh_shape=None` shards 1-D
z-slabs (`dist/sharded.py`) over a slice-major line of the group's ranks
(`dist/multislice.py`); `mesh_shape=(mz, my, mx)` shards a brick grid
(`dist/mesh3d.py`) whose product must be the group's size.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import SimConfig
from tpusph_torch.core.init import init_state
from tpusph_torch.core.state import FluidState
from tpusph_torch.dist import mesh3d, sharded
from tpusph_torch.dist.comm import BrickComm, SlabComm
from tpusph_torch.dist.multislice import make_multislice_mesh
from tpusph_torch.dist.sharded import DistAux, DistConfig, DistState, collect_state
from tpusph_torch.engine.step import resolve_backend
from tpusph_torch.interact.impulse import click_in_box

GROWTH_RETRIES = 8  # capacity doublings before a step is given up


def round_capacity(x) -> int:
    """A buffer capacity of at least x rows: a multiple of 256, at least 256."""
    return max(256, -(-int(x) // 256) * 256)


def default_dist_config(cfg: SimConfig, n_devices: int, slack: float = 2.0) -> DistConfig:
    """Capacity heuristics: each slab gets `slack`× the uniform share (the
    fluid clusters under gravity along y, and slabs are along z, so the
    z-density stays near uniform; overflow is detected regardless). Halo ≈
    the 2h ghost layer's share of a slab; migration ≈ a few percent a
    step."""
    share = -(-cfg.num_particles // n_devices)
    dev_cap = round_capacity(share * slack)
    band = share * 2 * cfg.h / (cfg.box_dim / n_devices)  # the 2h layer's share of a slab
    halo = min(round_capacity(max(band, 256) * slack), dev_cap)
    mig = min(round_capacity(max(share * 0.05, 128)), dev_cap // 2)
    return DistConfig(
        n_devices=n_devices, dev_capacity=dev_cap, halo_capacity=halo, migration_capacity=mig
    )


def default_mesh3d_config(cfg: SimConfig, mesh_shape, slack: float = 2.0) -> mesh3d.Mesh3DConfig:
    """Capacity heuristics of the brick grid: the halo of an axis scales
    with the brick's face shell (the 2h ghost layer's share along that axis,
    doubled again for the rows earlier phases forward); migration a few
    percent an axis a step."""
    n_dev = math.prod(mesh_shape)
    share = -(-cfg.num_particles // n_dev)
    dev_cap = round_capacity(share * slack)
    halos, migs = [], []
    for m in mesh_shape:
        width = cfg.box_dim / m
        halos.append(min(round_capacity(max(share * 4 * cfg.h / width, 256) * slack), dev_cap))
        migs.append(min(round_capacity(max(share * 0.05, 128)), dev_cap // 2))
    return mesh3d.Mesh3DConfig(
        mesh_shape=tuple(mesh_shape), dev_capacity=dev_cap,
        halo_capacity=tuple(halos), migration_capacity=tuple(migs),
    )


def _host(aux: DistAux) -> DistAux:
    """The nine counters as ints, in one read (`jax.device_get(aux)`)."""
    return DistAux(*torch.stack(tuple(aux)).tolist())


class DistSimulator:
    """Multi-rank variant of engine.Simulator, free-mode click impulses
    included (simulate(click=(px, py)) kicks velocities as the single-card
    engine does, reference simulator.cu:329-367,482-489).

    comm: this rank's communicator, or any object with `device` and
    `group`; its group is the one used. Default: the initialised default
    process group, else a group of one rank on `device`.
    mesh_shape=None shards 1-D z-slabs over a line ordered slice-major
    (`dist/multislice.py`; n_slices forces synthetic slicing);
    mesh_shape=(mz, my, mx) a brick grid, whose product must equal the
    group's size (tpusph takes the first mz·my·mx of more devices).
    backend: `kernels` (also under tpusph's names `auto` and `pallas`) or
    `cell_list`."""

    def __init__(
        self,
        cfg: SimConfig,
        comm=None,
        dcfg: DistConfig | None = None,
        random_init: bool = False,
        seed: int = 0,
        mesh_shape=None,
        n_slices: int | None = None,
        balance: bool = True,
        backend: str = "kernels",
        device="cuda",
    ):
        cfg.validate()
        self.cfg = cfg
        # balance-aware partition: setup() re-partitions along the measured
        # initial occupancy unless the caller pinned planes or opted out
        self.balance = balance
        self.random_init = random_init
        self.seed = seed
        self.backend = resolve_backend(backend)
        self.state: DistState | None = None
        self.last_aux: DistAux | None = None
        self._timed = None  # (build, update) for simulate_and_time
        self._runners: dict[int, object] = {}  # run(k) per chunk length
        if comm is None:
            import torch.distributed as dist

            group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
        else:
            group, device = comm.group, comm.device
        self.mesh_shape = None if mesh_shape is None else tuple(int(m) for m in mesh_shape)
        size = SlabComm(device, group).size
        if self.mesh_shape is None:
            self.topology = make_multislice_mesh(size, n_slices=n_slices)
            self.comm = SlabComm(device, group, order=self.topology.order)
            self.dcfg = dcfg or default_dist_config(cfg, size)
        else:
            self.topology = None  # bricks: one slice
            if dcfg is not None:
                raise ValueError("pass the brick capacities through default_mesh3d_config")
            if math.prod(self.mesh_shape) != size:
                raise ValueError(
                    f"mesh {self.mesh_shape} needs {math.prod(self.mesh_shape)} ranks, the group "
                    f"has {size}"
                )
            self.comm = BrickComm(device, group, self.mesh_shape)
            self.dcfg = default_mesh3d_config(cfg, self.mesh_shape)
        self.device = self.comm.device
        self._rebuild_step()

    @property
    def _n_dev(self) -> int:
        return self.dcfg.n_devices if self.mesh_shape is None else math.prod(self.mesh_shape)

    def _owner(self, pos: np.ndarray, dcfg) -> np.ndarray:
        if self.mesh_shape is None:
            return sharded.slab_owner(pos[:, 2], self.cfg, dcfg)
        return mesh3d.brick_owner(pos, self.cfg, dcfg)

    def setup(self, state: FluidState | None = None) -> None:
        """Distribute the initial (or a restored) state over the ranks.
        Every rank builds the same initial state on the CPU from the seeded
        generator and keeps its own block. Where the state is more
        clustered than the uniform-share capacities assumed (the grid
        lattice fills one corner of the box, reference simulator.cu:438-453),
        dev_capacity grows up front to the measured peak occupancy."""
        host_state = (
            state if state is not None
            else init_state(self.cfg, self.random_init, self.seed, device="cpu")
        )
        if self.balance and self._n_dev > 1:
            pos = host_state.position[host_state.valid].cpu().numpy()
            if self.mesh_shape is None and self.dcfg.slab_planes is None:
                planes = sharded.balanced_slab_planes(pos[:, 2], self.cfg, self.dcfg.n_devices)
                self.dcfg = dataclasses.replace(self.dcfg, slab_planes=planes)
                self._rebuild_step()
            elif self.mesh_shape is not None and self.dcfg.axis_planes is None:
                planes = mesh3d.balanced_brick_planes(pos, self.cfg, self.mesh_shape)
                self.dcfg = dataclasses.replace(self.dcfg, axis_planes=planes)
                self._rebuild_step()
        self._fit_initial_capacity(host_state)
        if self.mesh_shape is None:
            self.state = sharded.distribute_state(host_state, self.cfg, self.dcfg, self.comm)
        else:
            self.state = mesh3d.distribute_state_3d(host_state, self.cfg, self.dcfg, self.comm)

    def _rebuild_step(self) -> None:
        """Make the step again after a change of dcfg (capacity growth, new
        planes); drops the timed stages and the runners."""
        self._timed = None
        self._runners.clear()
        make = sharded.make_sharded_step if self.mesh_shape is None else mesh3d.make_mesh3d_step
        self._step = make(self.cfg, self.dcfg, self.comm, self.backend)

    def _fit_initial_capacity(self, host_state: FluidState) -> None:
        """Double dev_capacity until the host state's most loaded rank fits,
        making the step again on a change (host arithmetic, the owners of
        `distribute_state`)."""
        pos = host_state.position.cpu().numpy()
        valid = host_state.valid.cpu().numpy()
        owner = self._owner(pos, self.dcfg)[valid]
        peak = int(np.bincount(owner, minlength=self._n_dev).max())
        cap = self.dcfg.dev_capacity
        if peak <= cap:
            return
        while cap < peak:
            cap *= 2
        self.dcfg = dataclasses.replace(self.dcfg, dev_capacity=cap)
        self._rebuild_step()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _overflowed(aux: DistAux) -> bool:
        return bool(aux.halo_overflow or aux.migration_overflow or aux.window_overflow)

    def _check_misrouted(self, aux: DistAux) -> None:
        if aux.misrouted > 0:
            # One-hop migration invariant: a particle may cross at most one
            # face an axis a step. Crossing two in one dt needs speeds far
            # beyond the physics (the kicks are ≤ ~10), so a trip here means
            # a corrupt state, not a tunable.
            raise RuntimeError(
                f"{aux.misrouted} particle(s) crossed more than one slab in a single step — "
                "one-hop migration invariant violated"
            )

    def simulate(self, click: tuple[int, int] | None = None) -> None:
        """One timestep, then the click impulse if `click` (pixel
        coordinates) lies in the box. The counters are read once; a step
        that overflowed a buffer is replayed with doubled capacities."""
        assert self.state is not None, "call setup() first"
        click_px = click if click is not None and click_in_box(*click) else None
        for _ in range(GROWTH_RETRIES):
            new_state, aux = self._step(self.state, click_px)
            aux = _host(aux)
            if not self._overflowed(aux):
                break
            self._grow(aux)
        else:
            raise RuntimeError("dist capacity growth failed to converge")
        self._check_misrouted(aux)
        self.state = new_state
        self.last_aux = aux

    def _grow(self, aux: DistAux) -> None:
        """Double what overflowed: the halo buffers; the migration buffers
        and dev_capacity; on window overflow the port's `SimConfig` field
        that sizes a window, `tile_cand_capacity` (the tile passes of
        `cell_list`). tpusph also doubles its `pallas_*` capacities, which
        size its Pallas window prep; the port has none."""
        d = self.dcfg
        dbl = lambda v: tuple(x * 2 for x in v) if isinstance(v, tuple) else v * 2
        if aux.halo_overflow > 0:
            d = dataclasses.replace(d, halo_capacity=dbl(d.halo_capacity))
        if aux.migration_overflow > 0:
            d = dataclasses.replace(
                d, migration_capacity=dbl(d.migration_capacity), dev_capacity=d.dev_capacity * 2
            )
        if aux.window_overflow > 0:
            self.cfg = dataclasses.replace(
                self.cfg, tile_cand_capacity=self.cfg.tile_cand_capacity * 2
            )
        self.dcfg = d
        self._rebuild_step()

    def run(self, steps: int, chunk: int | None = None,
            rebalance_above: float | None = None) -> None:
        """The production loop: `chunk` steps (default all) per call of a
        `make_*_run` runner, the counters read once a chunk. A chunk that
        overflowed runs again from its start with doubled capacities, so
        the physics that lands in self.state is never degraded.

        rebalance_above: if set (e.g. 1.15), after each chunk re-partition
        (`rebalance`) when the measured imbalance λ = max_dev_particles /
        (N / ranks) reaches it."""
        assert self.state is not None, "call setup() first"
        make_run = sharded.make_sharded_run if self.mesh_shape is None else mesh3d.make_mesh3d_run
        chunk = steps if chunk is None else max(1, chunk)
        done = 0
        while done < steps:
            k = min(chunk, steps - done)
            for _ in range(GROWTH_RETRIES):
                if k not in self._runners:
                    self._runners[k] = make_run(self.cfg, self.dcfg, self.comm, k, self.backend)
                new_state, aux = self._runners[k](self.state)
                aux = _host(aux)
                if not self._overflowed(aux):
                    break
                self._grow(aux)
            else:
                raise RuntimeError("dist capacity growth failed to converge")
            self._check_misrouted(aux)
            if aux.num_particles != self.cfg.num_particles:
                raise RuntimeError(
                    f"particle conservation broken: {aux.num_particles} != "
                    f"{self.cfg.num_particles}"
                )
            self.state = new_state
            self.last_aux = aux
            done += k
            if rebalance_above is not None and done < steps:
                lam = aux.max_dev_particles * self._n_dev / self.cfg.num_particles
                if lam >= rebalance_above:
                    self.rebalance()

    def simulate_and_time(self, times: Times) -> None:
        """One timed step in the reference's three phases (times.h:12-36):
        grid construction = halo exchange and sort, SPH update = kernels,
        integration and migration, data transfer = the collect of the
        positions. Each phase ends in a synchronize on a card. A step that
        overflowed is replayed with doubled capacities and its seconds
        rolled back, as in the single-card Simulator."""
        assert self.state is not None, "call setup() first"
        build0, update0, memcpy0 = times.build_grid, times.sph_update, times.memcpy
        if self._timed is None:
            make = (sharded.make_sharded_timed if self.mesh_shape is None
                    else mesh3d.make_mesh3d_timed)
            self._timed = make(self.cfg, self.dcfg, self.comm, self.backend)
        build, update = self._timed

        t0 = time.perf_counter()
        inter = build(self.state)
        self._sync()
        t1 = time.perf_counter()
        times.build_grid += t1 - t0

        new_state, aux = update(*inter)
        self._sync()
        aux = _host(aux)
        t2 = time.perf_counter()
        times.sph_update += t2 - t1

        if self._overflowed(aux):
            times.build_grid, times.sph_update, times.memcpy = build0, update0, memcpy0
            self._grow(aux)
            self.simulate_and_time(times)
            return
        self._check_misrouted(aux)
        self.state = new_state
        self.last_aux = aux

        self.get_position()
        times.memcpy += time.perf_counter() - t2
        times.iters += 1

    def right_size(self, warmup_steps: int = 10, margin: float = 1.3,
                   restore: bool = True) -> None:
        """Measure, then right-size the per-rank capacities: run
        `warmup_steps` on the current capacities, read the peak occupancy,
        halo rows and migration rows from the counters, and make the step
        again at those peaks × `margin` (rounded up to 256, never above the
        current values). A grid of one rank cannot migrate, so its
        occupancy is sized exactly. restore=True distributes the state from
        before the warm-up again, so a timed run still measures the
        original trajectory."""
        assert self.state is not None, "call setup() first"
        host0 = self.to_host_state() if restore else None
        self.run(warmup_steps)
        aux = self.last_aux
        dev_margin = 1.0 if self._n_dev == 1 else margin
        dev = min(round_capacity(aux.max_dev_particles * dev_margin), self.dcfg.dev_capacity)
        halo = round_capacity(max(aux.max_halo_send, 1) * margin)
        mig = round_capacity(max(aux.max_migration_send, 1) * margin)
        if self.mesh_shape is None:
            # replace() keeps the balance-aware slab_planes
            self.dcfg = dataclasses.replace(
                self.dcfg, dev_capacity=dev,
                halo_capacity=min(halo, self.dcfg.halo_capacity),
                migration_capacity=min(mig, self.dcfg.migration_capacity),
            )
        else:
            self.dcfg = dataclasses.replace(
                self.dcfg, dev_capacity=dev,
                halo_capacity=tuple(min(halo, c) for c in self.dcfg.halo_capacity),
                migration_capacity=tuple(min(mig, c) for c in self.dcfg.migration_capacity),
            )
        self._rebuild_step()
        self.setup(host0 if restore else self.to_host_state())

    def rebalance(self, min_gain: float = 0.05) -> bool:
        """Re-partition along the current occupancy: planes from the live
        state, applied only where they cut the most loaded rank's occupancy
        by more than `min_gain` (relative). A pure re-assignment: the
        trajectory is unchanged. Costs a collect and a new step, so it is
        for occasional use at drift scale; run(rebalance_above=...) triggers
        it from the counters. Returns True if it re-partitioned."""
        assert self.state is not None, "call setup() first"
        if self._n_dev == 1:
            return False
        host = self.to_host_state()
        pos = host.position[host.valid].numpy()
        if self.mesh_shape is None:
            planes = sharded.balanced_slab_planes(pos[:, 2], self.cfg, self._n_dev)
            if planes == self.dcfg.slab_planes:
                return False
            new_dcfg = dataclasses.replace(self.dcfg, slab_planes=planes)
        else:
            planes = mesh3d.balanced_brick_planes(pos, self.cfg, self.mesh_shape)
            if planes == self.dcfg.axis_planes:
                return False
            new_dcfg = dataclasses.replace(self.dcfg, axis_planes=planes)
        cur = int(np.bincount(self._owner(pos, self.dcfg), minlength=self._n_dev).max())
        new = int(np.bincount(self._owner(pos, new_dcfg), minlength=self._n_dev).max())
        if cur < (1.0 + min_gain) * new:
            return False
        self.dcfg = new_dcfg
        self._rebuild_step()
        self.setup(host)
        return True

    def to_host_state(self) -> FluidState:
        """The whole state, collected from every rank (a collective), as
        the port's padded FluidState on the CPU: the checkpoint surface
        (`--save` writes one format for both engines)."""
        assert self.state is not None, "call setup() first"
        got = collect_state(self.state, self.cfg.num_particles, self.comm)
        if np.isnan(got["position"]).any():
            raise RuntimeError(
                "checkpoint collect incomplete: particle ids missing (conservation broken)"
            )
        n, npad = self.cfg.num_particles, self.cfg.padded_num_particles

        def pad(a):
            out = np.zeros((npad,) + a.shape[1:], a.dtype)
            out[:n] = a
            return torch.from_numpy(out)

        return FluidState(
            position=pad(got["position"]), velocity=pad(got["velocity"]),
            force=torch.zeros((npad, 3)), density=torch.ones(npad), pressure=torch.zeros(npad),
            valid=torch.arange(npad) < n,
        )

    def get_position(self) -> np.ndarray:
        """f32[N, 3] positions by pid on the host, collected from every
        rank (a collective: every rank calls it)."""
        assert self.state is not None, "call setup() first"
        return collect_state(self.state, self.cfg.num_particles, self.comm)["position"]

    def num_particles_alive(self) -> int:
        assert self.last_aux is not None, "step first"
        return self.last_aux.num_particles
