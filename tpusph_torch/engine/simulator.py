"""Simulator, the host-side driver (`class Simulator`,
simulator.h:53-74 and simulator.cu:370-546). Counterpart of
`tpusph/engine/simulator.py` for its timed path:

  * Simulator(cfg, ...)       ← Simulator(Settings*)   (cu:370-375)
  * setup()                   ← setup()                (cu:411-460)
  * simulate()                ← simulate()             (cu:462-497)
  * simulate_and_time(times)  ← simulateAndTime(Times*) (cu:499-546)
  * get_position()            ← getPosition()          (cu:407-409)

State stays on the device across steps. Each timed phase ends in a device
synchronize, so it measures device time as the reference's do. The JAX
package's chunked scan, asynchronous position fetch, click impulse and
free mode are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import SimConfig
from tpusph_torch.core.init import init_state
from tpusph_torch.core.state import FluidState
from tpusph_torch.engine.step import build_phase, make_step, update_phase_kernels


class Simulator:
    def __init__(
        self,
        cfg: SimConfig,
        backend: str = "kernels",
        random_init: bool = False,
        seed: int = 0,
        device="cuda",
    ):
        self.cfg = cfg
        self.backend = backend
        self.random_init = random_init
        self.seed = seed
        self.device = torch.device(device)
        self._step = make_step(cfg, backend, self.device)
        self.state: FluidState | None = None
        self.last_aux = None
        self._position_host: np.ndarray | None = None

    def setup(self, state: FluidState | None = None) -> None:
        """Initial particle state (Simulator::setup, cu:411-460), or `state`
        to resume from."""
        self.state = (
            state
            if state is not None
            else init_state(self.cfg, self.random_init, self.seed, self.device)
        )
        self._position_host = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def simulate(self) -> None:
        """One untimed timestep."""
        assert self.state is not None, "call setup() first"
        self.state, self.last_aux = self._step(self.state)
        self._position_host = None

    def simulate_and_time(self, times: Times) -> None:
        """One timed timestep with the reference's three phases (cu:499-546):
        grid build, SPH update, copy of the positions to the host. The copy
        is synchronous."""
        assert self.state is not None, "call setup() first"
        if self.backend != "kernels":
            raise ValueError("timed mode needs the 'kernels' backend")
        cfg = self.cfg

        t0 = time.perf_counter()
        cl = build_phase(self.state, cfg)
        self._sync()
        t1 = time.perf_counter()
        times.build_grid += t1 - t0

        new_state, aux = update_phase_kernels(self.state, cl, cfg)
        self._sync()
        t2 = time.perf_counter()
        times.sph_update += t2 - t1

        self._position_host = new_state.position[: cfg.num_particles].cpu().numpy()
        t3 = time.perf_counter()
        times.memcpy += t3 - t2

        self.state = new_state
        self.last_aux = aux
        times.iters += 1

    def get_position(self) -> np.ndarray:
        """Host f32[N, 3] positions (getPosition, cu:407-409)."""
        assert self.state is not None, "call setup() first"
        if self._position_host is None:
            self._position_host = (
                self.state.position[: self.cfg.num_particles].cpu().numpy()
            )
        return self._position_host
