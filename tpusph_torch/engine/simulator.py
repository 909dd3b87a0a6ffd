"""Simulator, the host-side driver (`class Simulator`,
simulator.h:53-74 and simulator.cu:370-546). Counterpart of
`tpusph/engine/simulator.py`:

  * Simulator(cfg, ...)       ← Simulator(Settings*)   (cu:370-375)
  * setup()                   ← setup()                (cu:411-460)
  * simulate(click=None)      ← simulate() + mouse globals (cu:462-497)
  * simulate_and_time(times)  ← simulateAndTime(Times*) (cu:499-546)
  * get_position()            ← getPosition()          (cu:407-409)
  * get_position_async()      the in-flight copy of the current positions
  * move_particles(click)     declared but never defined in the reference
                              (simulator.h:73); implemented as in tpusph

State stays on the device across steps. Each timed phase ends in a
synchronize of the compute stream, so it measures device time as the
reference's do; the copy of the positions to the host runs on a side
stream into pinned memory and overlaps the next step (`AsyncPositionFetch`).
The JAX package's chunked scan (`dispatch_chunk`, `AsyncChunkFetch`,
`rewind_chunk`, `simulate_chunk`) is not ported yet.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import SimConfig
from tpusph_torch.core.init import init_state
from tpusph_torch.core.state import FluidState
from tpusph_torch.engine.step import build_phase, make_step, update_phase_kernels
from tpusph_torch.interact.impulse import click_in_box, make_impulse


class AsyncPositionFetch:
    """An in-flight copy of `position[:num_particles]` to the host.

    On a CUDA tensor, constructing it starts the copy: a side stream waits
    for the work queued so far on the compute stream, then copies into a
    fresh pinned host tensor with `non_blocking=True`. `wait()` blocks on
    the copy's completion event and returns a numpy view of that tensor.
    Every fetch has its own host tensor, so an array handed to a caller is
    never overwritten. The source stays alive until the copy has read it:
    the fetch keeps a reference, and `record_stream` stops the caching
    allocator from handing its memory to later work on the compute stream
    while the side stream still reads it.

    On a CPU tensor, `wait()` returns a plain copy."""

    def __init__(self, position: torch.Tensor, num_particles: int):
        self._src = position
        self._n = num_particles
        self._host: np.ndarray | None = None
        self._done: torch.cuda.Event | None = None
        self.buffer: torch.Tensor | None = None  # pinned host tensor (CUDA)
        if position.device.type == "cuda":
            dev = position.device
            side = _side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            self.buffer = torch.empty(
                (num_particles,) + tuple(position.shape[1:]),
                dtype=position.dtype, pin_memory=True,
            )
            with torch.cuda.stream(side):
                self.buffer.copy_(position[:num_particles], non_blocking=True)
                self._done = torch.cuda.Event()
                self._done.record(side)
            position.record_stream(side)

    def matches(self, position: torch.Tensor) -> bool:
        """True when this fetch copies exactly `position` (by identity)."""
        return self._src is position

    def wait(self) -> np.ndarray:
        if self._host is None:
            if self._done is None:
                self._host = self._src[: self._n].numpy().copy()
            else:
                self._done.synchronize()
                self._host = self.buffer.numpy()
        return self._host


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The copy stream of `device`, one per process and device."""
    return torch.cuda.Stream(device)


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
        self._impulse = make_impulse(cfg)
        self.state: FluidState | None = None
        self.last_aux = None
        self._position_host: np.ndarray | None = None
        self._pending_fetch: AsyncPositionFetch | None = None

    def setup(self, state: FluidState | None = None) -> None:
        """Initial particle state (Simulator::setup, cu:411-460), or `state`
        to resume from."""
        self.state = (
            state
            if state is not None
            else init_state(self.cfg, self.random_init, self.seed, self.device)
        )
        self._position_host = None
        self._pending_fetch = None

    def _sync(self) -> None:
        """Fence the compute stream only: a copy in flight on the side stream
        overlaps the phases instead of being charged to them."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def simulate(self, click: tuple[int, int] | None = None) -> None:
        """One untimed timestep, then the click impulse if `click` (pixel
        coordinates) lies in the box, with cells taken from the pre-step
        positions (cu:462-497)."""
        assert self.state is not None, "call setup() first"
        pre_pos = self.state.position
        new_state, aux = self._step(self.state)
        if click is not None and click_in_box(*click):
            new_state = self._impulse(new_state, pre_pos, click)
        self.state = new_state
        self.last_aux = aux
        self._position_host = None

    def simulate_and_time(self, times: Times) -> None:
        """One timed timestep with the reference's three phases (cu:499-546):
        grid build, SPH update, copy of the positions to the host. The copy
        is double-buffered as in tpusph: the phase waits for the previous
        step's copy, which overlapped this step's build and update, and
        starts this step's copy."""
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

        if self._pending_fetch is not None:
            self._position_host = self._pending_fetch.wait()
        self._pending_fetch = AsyncPositionFetch(new_state.position, cfg.num_particles)
        t3 = time.perf_counter()
        times.memcpy += t3 - t2

        self.state = new_state
        self.last_aux = aux
        times.iters += 1

    def get_position(self) -> np.ndarray:
        """Host f32[N, 3] positions (getPosition, cu:407-409). Joins the
        copy in flight when it covers the current state; copies otherwise."""
        assert self.state is not None, "call setup() first"
        if self._pending_fetch is not None and self._pending_fetch.matches(
            self.state.position
        ):
            return self._pending_fetch.wait()
        if self._position_host is None:
            self._position_host = AsyncPositionFetch(
                self.state.position, self.cfg.num_particles
            ).wait()
        return self._position_host

    def get_position_async(self) -> AsyncPositionFetch:
        """Start a copy of the current positions to the host and return the
        handle; free mode runs the next step before it waits on it."""
        assert self.state is not None, "call setup() first"
        self._pending_fetch = AsyncPositionFetch(
            self.state.position, self.cfg.num_particles
        )
        return self._pending_fetch

    def move_particles(self, click: tuple[int, int]) -> None:
        """A click impulse outside the step loop, with cells from the current
        positions (the reference's declared Simulator::moveParticles)."""
        assert self.state is not None, "call setup() first"
        if not click_in_box(*click):
            return
        self.state = self._impulse(self.state, self.state.position, click)
        self._position_host = None
