"""The timed step's state carried in the graphs' own tensors
(`graphs.CarriedLoop`, `Simulator.simulate_and_time`).

A card carries by default; here the same two pairs of loops run on the
CPU with `carry` turned on (`_Carried`), their bodies eager under the
capture guard, and are held bit for bit to the phases without the carry
(one pair, fresh tensors each step, the path before the carry): over ten
steps, from a state put back, between untimed steps, through an overflow
that grows the capacity; the tensors handed to `setup()` and the arrays
`get_position()` handed out stay as they were. The update writes into
`out` bit for bit as it makes fresh tensors, and a loop made with its own
input tensors copies in only what is not its own. Small N, one thread.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)

from tpusph_torch.bench import spans  # noqa: E402
from tpusph_torch.bench.times import Times  # noqa: E402
from tpusph_torch.core.config import default_config  # noqa: E402
from tpusph_torch.core.init import init_state  # noqa: E402
from tpusph_torch.core.state import FIELDS, FluidState  # noqa: E402
from tpusph_torch.engine import step  # noqa: E402
from tpusph_torch.engine.graphs import GraphedLoop  # noqa: E402
from tpusph_torch.engine.simulator import Simulator  # noqa: E402

STEPS = 10


@pytest.fixture
def tracing(monkeypatch):
    """The recorder as while a profile records (its flag alone)."""
    spans.reset()
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    yield
    spans.reset()


def _fields(state) -> list:
    return [getattr(state, f) for f in FIELDS]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_fields(a), _fields(b)))


class _Carried(Simulator):
    """A Simulator whose timed phases carry their state in the graphs' own
    tensors (`carry`) or, as before the carry, clone it out and copy it in,
    through every capture again after a growth. A subclass and not a
    patched instance, so that no reference cycle holds a Simulator: a
    graph that dead cycles hold may be collected in the middle of another
    capture, which that ends."""

    carry = True

    def _timed_phases(self):
        loop = super()._timed_phases()
        loop.carry = self.carry
        return loop


class _Cloned(_Carried):
    carry = False


def _pair(cfg, backend="kernels", seed=7):
    """(carried, cloned) Simulators of `cfg` set up from one state, and
    that state's tensors with a copy of each."""
    start = init_state(cfg, random_init=True, seed=seed, device="cpu")
    sims = [kind(cfg, backend=backend, device="cpu") for kind in (_Carried, _Cloned)]
    for sim in sims:
        sim.setup(start)
    return (*sims, start, [t.clone() for t in _fields(start)])


@pytest.mark.parametrize("backend", ["kernels", "cell_list"])
def test_the_update_writes_its_state_into_out(backend):
    """With `out` the update writes the new state into its tensors, bit for
    bit what it makes without, and passes `valid` through."""
    cfg = ranks.dense_cfg()
    state = init_state(cfg, random_init=True, seed=5, device="cpu")
    tiles = backend == "cell_list"
    cl = step.build_phase(state, cfg, histogram=tiles)
    update = step.update_phase if tiles else step.update_phase_kernels
    fresh, aux = update(state, cl, cfg)
    out = FluidState(*(torch.full_like(t, 7) for t in _fields(state)))
    into, aux_out = update(state, cl, cfg, out)
    assert _equal(into, fresh)
    assert all(getattr(into, f) is getattr(out, f) for f in FIELDS if f != "valid")
    assert into.valid is state.valid
    assert [int(a) for a in aux_out] == [int(a) for a in aux]


def test_a_loop_with_its_own_inputs_copies_in_what_is_not_its_own(tracing):
    """`GraphedLoop(..., inputs=...)`: the body reads the loop's tensors; a
    call copies in each tensor it is handed that is not the loop's own,
    under `graph.copy_in`, and nothing where it is handed None."""
    own = [torch.zeros(4), torch.ones(4)]
    seen = []
    loop = GraphedLoop(lambda xs: seen.append(xs) or [xs[0] + xs[1]], "cpu", clone=False,
                       inputs=own)
    assert torch.equal(loop()[0], torch.ones(4))
    x = torch.arange(4.0)
    assert torch.equal(loop([x, own[1]])[0], x + 1)
    assert loop.inputs is own and all(a is b for a, b in zip(seen[-1], own))
    assert torch.equal(own[0], x) and x is not own[0]
    assert spans.totals()["graph.copy_in"].count == 1


@pytest.mark.parametrize("backend", ["kernels", "cell_list"])
def test_carried_steps_equal_the_cloned_steps(backend, tracing):
    """Ten timed steps: the carried state equals the cloned one bit for bit
    after each; the steps alternate between the two buffers, the first
    copies `setup()`'s state in (`graph.copy_in`) and the other nine carry
    (`graph.carried`); `setup()`'s tensors are never written."""
    carried, cloned, start, kept = _pair(ranks.dense_cfg(), backend)
    sources = []
    for _ in range(STEPS):
        sources.append(carried._timed.source(_fields(carried.state))
                       if carried._timed else None)
        carried.simulate_and_time(Times())
        cloned.simulate_and_time(Times())
        assert _equal(carried.state, cloned.state)
        assert int(carried.last_aux.oob_count) == int(cloned.last_aux.oob_count)
    assert sources == [None] + [1, 0] * 4 + [1]
    assert spans.counts()["graph.carried"] == STEPS - 1
    assert spans.totals()["graph.copy_in"].count == 1
    assert all(torch.equal(a, b) for a, b in zip(_fields(start), kept))
    assert carried._timed.source(_fields(carried.state)) == STEPS % 2


def test_a_state_put_back_runs_its_buffer_again():
    """The harness's `unchanged` fault: each step's state is put back to
    the one before it (a buffer), so the next step runs that buffer's pair
    again; equal to the cloned path doing the same."""
    carried, cloned, _, _ = _pair(ranks.dense_cfg())
    for sim in (carried, cloned):
        for _ in range(2):
            sim.simulate_and_time(Times())
    for _ in range(3):
        for sim in (carried, cloned):
            before = sim.state
            sim.simulate_and_time(Times())
            sim.state = before
        assert carried._timed.source(_fields(carried.state)) == 0
        assert _equal(carried.state, cloned.state)
    for sim in (carried, cloned):
        sim.simulate_and_time(Times())
    assert _equal(carried.state, cloned.state)
    np.testing.assert_array_equal(carried.get_position(), cloned.get_position())


def test_untimed_steps_between_timed_ones_copy_the_state_in(tracing):
    """`simulate()` between timed steps hands the next timed step a state of
    its own, which is copied in; the states stay those of the cloned path."""
    carried, cloned, _, _ = _pair(ranks.dense_cfg())
    for k in range(6):
        for sim in (carried, cloned):
            sim.simulate_and_time(Times()) if k % 3 else sim.simulate()
        assert _equal(carried.state, cloned.state)
    assert spans.counts()["graph.carried"] == 2  # steps 2 and 5
    assert spans.totals()["graph.copy_in"].count == 2  # steps 1 and 4


def test_arrays_handed_out_keep_their_values():
    """`get_position()` after each timed step: every array equals the
    cloned path's and stays as it was through the later steps."""
    carried, cloned, _, _ = _pair(ranks.dense_cfg())
    got, kept = [], []
    for _ in range(6):
        carried.simulate_and_time(Times())
        cloned.simulate_and_time(Times())
        got.append(carried.get_position())
        kept.append(got[-1].copy())
        np.testing.assert_array_equal(got[-1], cloned.get_position())
    for g, k in zip(got, kept):
        np.testing.assert_array_equal(g, k)


def test_an_overflow_grows_and_copies_the_state_into_new_pairs():
    """`cell_list` from tile_cand_capacity 8: a step that overflowed is
    replayed on new pairs captured at the grown capacity, which copy the
    old buffer's state in; 4 steps equal the cloned path's bit for bit."""
    cfg = ranks.dense_cfg()
    small = default_config(cfg.num_particles, chunk_size=cfg.chunk_size, tile_cand_capacity=8)
    carried, cloned, _, _ = _pair(small, backend="cell_list")
    for _ in range(4):
        carried.simulate_and_time(Times())
        cloned.simulate_and_time(Times())
        assert _equal(carried.state, cloned.state)
    assert carried.cfg.tile_cand_capacity == cloned.cfg.tile_cand_capacity > 8
    assert carried._timed.carry and len(carried._timed.pairs) == 2


@pytest.mark.parametrize("backend", ["kernels", "cell_list"])
def test_each_timed_step_fetches_its_positions_wherever_the_copy_starts(backend, tracing):
    """After every timed step `get_position()` equals the positions of
    `simulate()` run from the same state, bit for bit, through a second
    `setup()`. On the kernels the copy starts before the update's fence
    and `sim.copy_overlapped` counts each step; on `cell_list` from
    tile_cand_capacity 8 a step overflows and is replayed at a grown
    capacity, the copy started after the fence, and the counter stays 0."""
    cfg = ranks.dense_cfg()
    if backend == "cell_list":
        cfg = default_config(cfg.num_particles, chunk_size=cfg.chunk_size, tile_cand_capacity=8)
    start = init_state(cfg, random_init=True, seed=11, device="cpu")
    timed, plain = _Carried(cfg, backend=backend, device="cpu"), Simulator(cfg, backend, device="cpu")
    steps = 0
    for _ in range(2):
        for sim in (timed, plain):
            sim.setup(start)
        for _ in range(4):
            timed.simulate_and_time(Times())
            plain.simulate()
            np.testing.assert_array_equal(timed.get_position(), plain.get_position())
            steps += 1
    assert spans.counts().get("sim.copy_overlapped", 0) == (steps if backend == "kernels" else 0)
    if backend == "cell_list":
        assert timed.cfg.tile_cand_capacity > 8
