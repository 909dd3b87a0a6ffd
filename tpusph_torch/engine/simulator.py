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
  * dispatch_chunk(S, ...)    S steps in one dispatch (the JAX package's
    rewind_chunk(handle)      `lax.scan` chunk); snapshots come back in one
    simulate_chunk(S, ...)    copy

What the JAX package jits is one CUDA-graph replay on a card
(`engine/graphs.py`): the step and the impulse (`make_step`,
`make_impulse`), each timed phase, each chunk per (S, pack). On the CPU
the same bodies run eagerly under the capture guard.

State stays on the device across steps. Each timed phase ends in a
synchronize of the compute stream, so it measures device time as the
reference's do; the copy of the positions to the host runs on a side
stream into pinned memory and overlaps the next step (`AsyncPositionFetch`,
`AsyncChunkFetch`). On a card the timed steps carry the state in the
graphs' own two buffers (`graphs.CarriedLoop`): after a timed step
`self.state` is one of them, valid until the next `simulate_and_time`.

Capacity: the `cell_list` backend's tile passes have a fixed candidate
capacity and count what overflows it. `simulate`, `simulate_and_time` and
`simulate_chunk` replay a step or chunk that overflowed with a doubled
capacity (`_grow_capacity`), as tpusph does, so no pair is dropped. The
kernels have no capacity: their overflow is the int 0, so on the default
backend no retry fires and no overflow is read back from the card.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from tpusph_torch.bench.spans import count, recording, span
from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import SimConfig
from tpusph_torch.core.init import init_state
from tpusph_torch.core.state import FIELDS, FluidState
from tpusph_torch.engine.graphs import CarriedLoop, GraphedLoop
from tpusph_torch.neighbors.cell_list import CellList
from tpusph_torch.engine.step import (
    BACKENDS,
    StepAux,
    build_phase,
    make_step,
    resolve_backend,
    update_phase,
    update_phase_kernels,
)
from tpusph_torch.interact.impulse import apply_kick, click_cell_from_px, click_in_box, make_impulse
from tpusph_torch.kernels.fused import WALK, force_blocks
from tpusph_torch.viz.project import project_bitmap, project_pixels_packed

GROWTH_RETRIES = 8  # capacity doublings before a step is given up


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
    while the side stream still reads it. A source that later work writes
    in place (the timed phases' state buffers) is guarded by its writer
    (`Simulator._fence_fetches`).

    On a CPU tensor the copy is made at once, and `wait()` returns it.

    `walk`: the force pass's walk counter of the step (int64[3],
    `kernels.fused.WALK`), copied in the same call; the first `wait()` adds
    it to the counters `force.candidates`, `force.pressured` and
    `force.block_max`, and `blocks`, the force launch's blocks, to
    `force.blocks` (`bench/spans.py`, kept while a profile records)."""

    def __init__(self, position: torch.Tensor, num_particles: int,
                 walk: torch.Tensor | None = None, blocks: int = 0):
        self._src = position
        self._host: np.ndarray | None = None
        self._done: torch.cuda.Event | None = None
        self._walk: torch.Tensor | None = None  # its host copy, until counted
        self._blocks = blocks
        self.buffer: torch.Tensor | None = None  # pinned host tensor (CUDA)
        srcs = [position[:num_particles]] + ([] if walk is None else [walk])
        if position.device.type == "cuda":
            (self.buffer, *walk_host), self._done = _copy_to_host(srcs)
            self._walk = walk_host[0] if walk_host else None
        else:
            self._host = srcs[0].numpy().copy()
            self._walk = None if walk is None else walk.clone()

    def matches(self, position: torch.Tensor) -> bool:
        """True when this fetch copies exactly `position` (by identity)."""
        return self._src is position

    def wait(self) -> np.ndarray:
        if self._host is None:
            self._done.synchronize()
            self._host = self.buffer.numpy()
        if self._walk is not None:
            for name, n in zip(WALK, self._walk.tolist()):
                count(f"force.{name}", n)
            count("force.blocks", self._blocks)
            self._walk = None
        return self._host


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The copy stream of `device`, one per process and device."""
    return torch.cuda.Stream(device)


def _copy_to_host(srcs: list[torch.Tensor]):
    """Start copies of the CUDA tensors `srcs` to the host: the side stream
    waits for the work queued so far on the compute stream and copies each
    into a fresh pinned tensor. Returns (host tensors, completion event).
    `record_stream` keeps the caching allocator from handing a source's
    memory to later work while the side stream still reads it."""
    dev = srcs[0].device
    side = _side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in srcs]
    with torch.cuda.stream(side):
        for host, src in zip(hosts, srcs):
            host.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    for src in srcs:
        src.record_stream(side)
    return hosts, done


class AsyncChunkFetch:
    """An in-flight copy of one chunk's snapshot stack and its summed
    overflow to the host, made as `AsyncPositionFetch`'s is. `wait()` →
    (snapshots as numpy, cut to `num_particles` rows per step unless that
    is None, overflow as an int)."""

    def __init__(self, snaps: torch.Tensor, overflow: torch.Tensor, num_particles: int | None):
        self._src = (snaps, overflow)
        self._n = num_particles
        self._host: tuple[np.ndarray, int] | None = None
        self._done: torch.cuda.Event | None = None
        if snaps.device.type == "cuda":
            self._src, self._done = _copy_to_host([snaps, overflow])

    def wait(self) -> tuple[np.ndarray, int]:
        if self._host is None:
            if self._done is not None:
                self._done.synchronize()
            snaps, ovf = self._src
            snaps = snaps.numpy() if self._done is not None else snaps.numpy().copy()
            self._host = (snaps if self._n is None else snaps[:, : self._n], int(ovf))
        return self._host


@dataclasses.dataclass
class ChunkHandle:
    """One dispatched chunk: the pre-chunk state (kept for the rewind on
    overflow), the fetch in flight, and the chunk's step count."""

    pre_state: FluidState
    fetch: AsyncChunkFetch
    n_steps: int


def _snapshot(position: torch.Tensor, pack, num_particles: int) -> torch.Tensor:
    """One step's frame: positions, packed pixels (pack True) or the
    occupancy bitmap of the live rows (pack "bitmap": padding slots park at
    the origin, which projects inside the frame)."""
    if pack == "bitmap":
        return project_bitmap(position[:num_particles])
    if pack:
        return project_pixels_packed(position)
    return position


def _make_chunk(cfg: SimConfig, backend: str, n_steps: int, pack, device) -> GraphedLoop:
    """`[*state fields, cells int32[S, 2], gains int32[S]] -> [*state
    fields, snapshots, overflow int32[]]`: S steps of `backend`, each
    followed by the click kick of its gain (from that step's pre-step
    positions), the composition `simulate(click=...)` runs step by step, so
    the snapshots equal the sequential loop's bit for bit. One CUDA graph on
    a card, the same loop eagerly on the CPU (`GraphedLoop`)."""
    step = BACKENDS[resolve_backend(backend)]

    def chunk(inputs: list) -> list:
        *fields, cells, gains = inputs
        state = FluidState(*fields)
        ovf = torch.zeros((), dtype=torch.int32, device=state.device)
        snaps = []
        for j in range(n_steps):
            new, aux = step(state, cfg)
            new.velocity = apply_kick(
                new.velocity, state.position, new.valid, cells[j], gains[j], cfg
            )
            snaps.append(_snapshot(new.position, pack, cfg.num_particles))
            ovf = ovf + aux.window_overflow
            state = new
        return [*(getattr(state, f) for f in FIELDS), torch.stack(snaps), ovf]

    return GraphedLoop(chunk, device)


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
        self.backend = resolve_backend(backend)
        self.random_init = random_init
        self.seed = seed
        self.device = torch.device(device)
        self.state: FluidState | None = None
        self.last_aux = None
        self._position_host: np.ndarray | None = None
        self._pending_fetch: AsyncPositionFetch | None = None
        self._step_fetch: AsyncPositionFetch | None = None  # the last timed step's
        self._build_fns()

    def _build_fns(self) -> None:
        """Make the step, the impulse, the timed phases and the chunks
        again for the current cfg: their graphs are dropped and captured
        anew at their next call."""
        self._step = make_step(self.cfg, self.backend, self.device)
        self._impulse = make_impulse(self.cfg)
        self._timed: CarriedLoop | None = None
        self._chunk_cache: dict = {}

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

    def _grow_capacity(self) -> None:
        """Double the tile passes' candidate capacity and make the step,
        the timed phases and the chunks again (`_build_fns`). The JAX package also doubles its window
        and `pallas_*` capacities, which size its Pallas window prep; the
        port's kernels have none."""
        self.cfg = dataclasses.replace(
            self.cfg, tile_cand_capacity=self.cfg.tile_cand_capacity * 2
        )
        self._build_fns()

    def simulate(self, click: tuple[int, int] | None = None) -> None:
        """One untimed timestep, then the click impulse if `click` (pixel
        coordinates) lies in the box, with cells taken from the pre-step
        positions (cu:462-497). A step whose windows overflowed is replayed
        with doubled capacity."""
        assert self.state is not None, "call setup() first"
        pre_pos = self.state.position
        for _ in range(GROWTH_RETRIES):
            new_state, aux = self._step(self.state)
            if int(aux.window_overflow) == 0:
                break
            self._grow_capacity()
        else:
            raise RuntimeError("window capacity growth failed to converge")
        if click is not None and click_in_box(*click):
            new_state = self._impulse(new_state, pre_pos, click)
        self.state = new_state
        self.last_aux = aux
        self._position_host = None

    def _timed_phases(self) -> CarriedLoop:
        """The timed step's two phases as tpusph jits them
        (`tpusph/engine/simulator.py:140-141`): `build(state fields) ->
        CellList fields` and `update() -> [*state fields, oob, overflow]`,
        the second reading the first's inputs and outputs in place. One
        CUDA-graph replay each on a card, the state carried from step to
        step in the graphs' own tensors (`graphs.CarriedLoop`). On the
        kernels the update also returns the force pass's walk counter
        (`kernels.fused.force`), zeroed inside the update; the tile passes
        return None in its place."""
        cfg, tiles = self.cfg, self.backend == "cell_list"

        def build_body(fields: list) -> list:
            return list(build_phase(FluidState(*fields), cfg, histogram=tiles))

        def update_body(inputs: list, out: list | None = None) -> list:
            fields, cl = inputs[: len(FIELDS)], CellList(*inputs[len(FIELDS):])
            state, out = FluidState(*fields), None if out is None else FluidState(*out)
            if tiles:
                (new, aux), walk = update_phase(state, cl, cfg, out), None
            else:
                walk = torch.zeros(len(WALK), dtype=torch.int64, device=state.device)
                new, aux = update_phase_kernels(state, cl, cfg, out, walk=walk)
            return [*(getattr(new, f) for f in FIELDS), *aux, walk]

        return CarriedLoop(build_body, update_body, self.device, len(FIELDS))

    def simulate_and_time(self, times: Times) -> None:
        """One timed timestep with the reference's three phases (cu:499-546):
        grid build, SPH update (one replay each on a card, `_timed_phases`),
        copy of the positions to the host. The copy is double-buffered as in
        tpusph: the phase waits for the previous step's copy, which
        overlapped this step's build and update, and starts this step's
        copy. A step that overflowed is replayed, its seconds not counted,
        with doubled capacity and its phases captured again (the new graphs
        copy the state in); `iters` counts only steps that stood.

        On a card the state lives in the phases' two buffers
        (`graphs.CarriedLoop`): a step from the state the previous timed
        step left reads one buffer and writes the other, with no copy in or
        clone out; any other state (from `setup()`, `simulate()`, a chunk,
        or one a caller put back) is copied into the first buffer once,
        under the span `graph.copy_in`. A tensor handed to `setup()` is
        never written. `self.state` and `last_aux` afterwards are the
        graphs' own tensors: they hold this step's state until the next
        call of `simulate_and_time`, so clone what must outlive it.
        `get_position()`'s arrays are the fetch's own host tensors, never
        overwritten.

        Spans (`bench/spans.py`), while a profile records: `sim.step` around
        the step, inside it `sim.build` and `sim.update` (each phase's call
        and its fence), `sim.copy_wait` (the wait for the previous copy) and
        `sim.copy_start` (this step's); the four share their clock reads
        with `times`, so they sum to its fields over steps that stood. A
        step that overflowed leaves its `sim.build` and `sim.update` spans,
        and its recapture `graph.warmup` and `graph.record`, though `times`
        drops its seconds. On the kernels, while a profile records, the
        step's copy also takes the force pass's walk counter, which the
        counters `force.*` take when the copy is waited for
        (`AsyncPositionFetch`)."""
        assert self.state is not None, "call setup() first"
        if self.backend not in ("kernels", "cell_list"):
            raise ValueError("timed mode needs the 'kernels' or 'cell_list' backend")
        if self._timed is None:
            self._timed = self._timed_phases()
        with span("sim.step"):
            stood = self._timed_step(times)
        if not stood:
            self._grow_capacity()
            self.simulate_and_time(times)

    def _timed_step(self, times: Times) -> bool:
        """The phases of `simulate_and_time`; False, with nothing added to
        `times`, where the step overflowed."""
        self._fence_fetches()
        t0 = time.perf_counter()
        with span("sim.build", t0) as s:
            self._timed.build([getattr(self.state, f) for f in FIELDS])
            self._sync()
            t1 = s.end = time.perf_counter()
        with span("sim.update", t1) as s:
            *fields, oob, ovf, walk = self._timed.update()
            self._sync()
            t2 = s.end = time.perf_counter()
        if int(ovf) > 0:
            return False

        new_state = FluidState(*fields)
        with span("sim.copy_wait", t2) as s:
            if self._pending_fetch is not None:
                self._position_host = self._pending_fetch.wait()
        with span("sim.copy_start", s.end) as s:
            self._pending_fetch = AsyncPositionFetch(
                new_state.position, self.cfg.num_particles,
                walk if walk is not None and recording() else None,
                force_blocks(new_state.num_slots))
            t3 = s.end = time.perf_counter()
        self._step_fetch = self._pending_fetch
        times.build_grid += t1 - t0
        times.sph_update += t2 - t1
        times.memcpy += t3 - t2

        self.state = new_state
        self.last_aux = StepAux(oob_count=oob, window_overflow=ovf)
        times.iters += 1
        return True

    def _fence_fetches(self) -> None:
        """Before a timed step writes the phases' state buffers: unless the
        one copy to the host that may be in flight is the last timed step's,
        of the state this step reads (every earlier one was waited for),
        the compute stream waits on the card for every copy started so far,
        so that no copy reads a buffer the step writes. On the CPU a fetch
        copies at once."""
        fetch = self._pending_fetch
        if self.device.type != "cuda" or (fetch is not None and fetch is self._step_fetch
                                          and fetch.matches(self.state.position)):
            return
        torch.cuda.current_stream(self.device).wait_stream(_side_stream(self.device))

    # ------------------------------------------------------ chunked stepping
    def _chunk_fn(self, n_steps: int, pack_pixels=False) -> GraphedLoop:
        """The chunk of `n_steps` steps with frames `pack_pixels` (False:
        positions f32[S, Np, 3]; True: packed pixels int32[S, Np]; "bitmap":
        occupancy bitmaps uint8[S, H, W/8]), one per (n_steps, pack) of the
        current cfg; on a card each holds its CUDA graph."""
        key = (n_steps, pack_pixels)
        if key not in self._chunk_cache:
            self._chunk_cache[key] = _make_chunk(
                self.cfg, self.backend, n_steps, pack_pixels, self.device
            )
        return self._chunk_cache[key]

    def dispatch_chunk(self, n_steps: int, clicks=None, pack_pixels=False) -> ChunkHandle:
        """Advance `n_steps` steps in one dispatch, speculatively: the
        handle's overflow arrives with the snapshots; on overflow call
        rewind_chunk and dispatch again. clicks: {local step: (px, py)},
        applied after their step like simulate(click=...)."""
        assert self.state is not None, "call setup() first"
        cells = torch.zeros((n_steps, 2), dtype=torch.int32)
        gains = torch.zeros((n_steps,), dtype=torch.int32)
        for j, (px, py) in (clicks or {}).items():
            if click_in_box(px, py):
                cells[j] = torch.tensor(click_cell_from_px(px, py, self.cfg), dtype=torch.int32)
                gains[j] = 1
        pre = self.state
        *fields, snaps, ovf = self._chunk_fn(n_steps, pack_pixels)(
            [*(getattr(pre, f) for f in FIELDS), cells, gains]
        )
        self.state = FluidState(*fields)
        self._position_host = None
        self._pending_fetch = None
        rows = None if pack_pixels == "bitmap" else self.cfg.num_particles
        return ChunkHandle(pre_state=pre, fetch=AsyncChunkFetch(snaps, ovf, rows), n_steps=n_steps)

    def rewind_chunk(self, handle: ChunkHandle, grow: bool = True) -> None:
        """Overflow recovery: restore the pre-chunk state (dropping this
        chunk and any dispatched after it) and double the capacities."""
        self.state = handle.pre_state
        self._position_host = None
        self._pending_fetch = None
        if grow:
            self._grow_capacity()

    def simulate_chunk(self, n_steps: int, clicks=None) -> np.ndarray:
        """Chunked advance with the capacity-growth retry folded in: the
        f32[S, N, 3] stack of per-step positions."""
        for _ in range(GROWTH_RETRIES):
            handle = self.dispatch_chunk(n_steps, clicks)
            pos, ovf = handle.fetch.wait()
            if ovf == 0:
                return pos
            self.rewind_chunk(handle)
        raise RuntimeError("window capacity growth failed to converge")

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
