"""The CUDA kernels of tpusph_torch against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and `nvcc`, and skips
without them. On a GPU machine, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest`: the suite's conftest imports jax, which this file does
not need.) Bars: ranks exact; density rtol 1e-5; force rtol 1e-4 with
atol 1e-4, and on the dense blob an atol at the float32 floor of its sums
(see the test). The kernels sum in another order than the plain versions,
and nvcc contracts a*b+c into FMA. The tiled density kernel equals the
baseline kernel (the first design) bit for bit; the tiled force (one
1/(2ρ) a pair, rsqrt) is held at the force bar. The block-narrowed rank
kernel (csrc/qrank.cu) is exact on every path: spans staged in shared
memory by 16-byte and by 4-byte copies, wide spans searched in device
memory, scalar loads for ragged tails and pointers off 16 bytes; it equals
the first design and, inside a replayed CUDA graph, its eager launch. The
density mix is held at 1, 7, 64 and 65 rounds (its loop takes several
rounds at once) and in bf16 equals its first design bit for bit. The rate probes at 64 rounds: f32 FMA,
f32 density mix and the loop probe rtol 1e-5 (FMA against separately
rounded ops; rsqrtf); bf16 FMA and bf16 density mix bit-equal. At the
entry points' round counts: the f32 FMA bit-equal on inputs where a fused
and a split multiply-add round alike; the loop probe within rounds·eps
and a mean difference under 1 % of one round's term. The loop probe
(csrc/probes.cu) is also held on each path its inputs select: 67 rounds and
1 round (its loop takes several rounds at once), a desc 2 bytes off a
16-byte boundary, a cand of 512 lanes and one too wide to stage, pt 8 and
128, columns off a 32-lane slice, and a cand off 16 bytes (device memory
at the entry point's shape); its first design at the same bars, the two beside each other, and
inside a replayed CUDA graph. The copy of the
positions to the host equals a synchronous copy exactly. The timed step
that carries its state in the graphs' own tensors equals the path that
clones it out and copies it in, bit for bit: over 12 steps (one copy in,
then no copy or clone a step), from a state put back, between untimed
steps, from a state on the host and through an overflow that grows the
capacity; `setup()`'s tensors and the fetched arrays keep their values. One rank of the
sharded engine on the card, elided and with the whole multi-rank machinery,
and `DistSimulator` on one rank as z-slabs and as a (1, 1, 1) brick grid,
against the same steps on the CPU. `bench_torch`'s gates pass on the card
and its timed run launches each kernel; `fields_profile`'s stages compose
to the fields step bit for bit; `build_bench`'s three starts tables agree;
`graft_entry.entry()`'s step on the card matches the CPU's at 1e-4. At a
clustered state with the pressure live (`torch_pressured.py`) the density
and force kernels match their plain versions; the force kernel's walk
counter equals `force_walk` exactly on every kind of state, its forces are
the same bits with and without it, and carried timed steps sum it. Each
graphed entry point (`make_step`, `make_impulse`, the one-rank slab and
brick steps, timed stages and runs) replays a CUDA graph bit for bit
equal to its eager path, with sync debug mode "error" around the
replays, and a body that reads the card on the host fails its capture; a
capture records its spans and a traced replay adds its graph's nodes.
With peers: a segmented loop replays its chain of graphs and transports,
and two ranks on the card over gloo (a slab line, a (2, 1, 1) brick grid)
replay each graphed entry point's segments bit for bit equal to its eager
path, each kernel once a step."""

import os
import sys

import numpy as np
import pytest
import torch

from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import default_config
from tpusph_torch.core.init import init_state
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.engine.step import build_phase, make_step
from tpusph_torch.kernels import fused, probes, qrank
from tpusph_torch.physics.kernels import pressure_from_density

sys.path.insert(0, os.path.dirname(__file__))
from torch_pressured import clustered_state  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _sorted_inputs(kind, dev):
    """Sorted rows, keys and starts of a grid or random state after 5
    steps; of grid init ("plane": tiles straddle z-planes); of a grid at
    1000 rows ("ragged": no multiple of a tile); or of a dense blob with
    random velocities (pressure live, windows wider than a chunk), also at
    1001 rows ("blob_odd": y and z of the [3, n] fields off 16 bytes)."""
    n = {"ragged": 1000, "blob_odd": 1001}.get(kind, 4096)
    cfg = default_config(n, chunk_size=n if n < 4096 else 1024)
    st = init_state(cfg, random_init=(kind == "random"), seed=3, device=dev)
    if kind.startswith("blob"):
        rng = np.random.default_rng(0)
        st.position[:n] = torch.from_numpy(rng.uniform(4.0, 4.35, (n, 3)).astype(np.float32)).to(dev)
        st.velocity[:n] = torch.from_numpy(rng.normal(0, 0.5, (n, 3)).astype(np.float32)).to(dev)
    elif kind != "plane":
        step = make_step(cfg, "kernels", dev)
        for _ in range(5):
            st, _ = step(st)
    cl = build_phase(st, cfg)
    xyz = st.position[cl.perm].T.contiguous()
    vxyz = st.velocity[cl.perm].T.contiguous()
    return cfg, cl, xyz, vxyz


@pytest.mark.parametrize("kind", ["grid", "blob"])
def test_rank_kernel_equals_plain(dev, kind):
    cfg, cl, _, _ = _sorted_inputs(kind, dev)
    nc = cfg.num_cells
    q = torch.cat([torch.arange(nc + 2, dtype=torch.int32, device=dev),
                   torch.tensor([nc + 5, 2**30, 0, nc], dtype=torch.int32, device=dev)])
    before = qrank.rank_queries.launches
    got, ovf = qrank.rank_queries(cl.key_sorted, q, nc)
    torch.cuda.synchronize()
    assert qrank.rank_queries.launches == before + 1 and ovf == 0
    torch.testing.assert_close(got, qrank.rank_queries_plain(cl.key_sorted, q, nc), rtol=0, atol=0)


def _rank_both(key, q, nc):
    """The kernel's ranks, checked against the plain version and the first
    design's, with one launch counted on each wrapper."""
    before = (qrank.rank_queries.launches, qrank.rank_queries_baseline.launches)
    got, ovf = qrank.rank_queries(key, q, nc)
    base, _ = qrank.rank_queries_baseline(key, q, nc)
    torch.cuda.synchronize()
    assert ovf == 0 and got.dtype == torch.int32 and got.shape == q.shape
    assert (qrank.rank_queries.launches, qrank.rank_queries_baseline.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, qrank.rank_queries_plain(key, q, nc), rtol=0, atol=0)
    assert torch.equal(got, base)
    return got


def _rank_queries_of(kind, nc, dev):
    g = torch.Generator(device=dev).manual_seed(17)
    cells = torch.arange(nc + 2, dtype=torch.int32, device=dev)
    if kind == "cells":
        return cells
    if kind == "unsorted":  # every block's span is the whole array
        return cells[torch.randperm(nc + 2, device=dev, generator=g)]
    if kind == "repeats":  # in order, repeated, with a tail above num_cells
        q = torch.randint(0, nc + 2, (100_000,), device=dev, generator=g).sort().values
        tail = torch.tensor([nc + 1, nc + 2, nc + 7, 2**30, -1, -(2**30)], device=dev)
        return torch.cat([q, tail]).to(torch.int32)
    assert kind == "offset"  # a contiguous view 4 bytes past a 16-byte boundary
    q = cells[1:]
    assert q.data_ptr() % 16 == 4 and q.is_contiguous()
    return q


@pytest.mark.parametrize("queries", ["cells", "unsorted", "repeats", "offset"])
@pytest.mark.parametrize("kind", ["grid", "blob", "blob_odd", "ragged"])
def test_rank_kernel_on_every_path(dev, kind, queries):
    """At most 4096 keys, so every span fits the stage: most blocks of the
    grid states find an empty span, the blob's blocks stage up to all its
    rows, at 1001 rows (n % 4 != 0) by 4-byte copies."""
    cfg, cl, _, _ = _sorted_inputs(kind, dev)
    q = _rank_queries_of(queries, cfg.num_cells, dev)
    lo, hi, staged = qrank.block_spans(cl.key_sorted, q)
    assert bool(staged.all()) and bool((hi > lo).any())
    assert bool((hi == lo).any()) == (queries != "unsorted")
    _rank_both(cl.key_sorted, q, cfg.num_cells)


@pytest.mark.parametrize("n", [0, 1, 3, 4096, 20_000])
@pytest.mark.parametrize("keys", ["sentinel", "equal", "wide", "offset"])
def test_rank_kernel_on_edge_keys(dev, keys, n):
    """All-sentinel keys, all-equal keys, one cell holding three quarters of
    the keys, and keys that start 4 bytes past a 16-byte boundary. At
    n = 20,000 a span can exceed the stage: the dense cell's block and every
    block of unsorted queries search device memory."""
    nc = 32**3
    g = torch.Generator(device=dev).manual_seed(n)
    if keys == "sentinel":
        key = torch.full((n,), nc, dtype=torch.int32, device=dev)
    elif keys == "equal":
        key = torch.full((n,), 777, dtype=torch.int32, device=dev)
    elif keys == "wide":
        key = torch.randint(0, nc, (n,), device=dev, generator=g).to(torch.int32)
        key[: n * 3 // 4] = 5000
        key = key.sort().values
    else:
        key = torch.randint(0, nc + 1, (n + 1,), device=dev, generator=g).to(torch.int32)
        key = key.sort().values[1:]
        assert n == 0 or key.data_ptr() % 16 == 4
    cells = torch.arange(nc + 2, dtype=torch.int32, device=dev)
    unsorted = cells[torch.randperm(nc + 2, device=dev, generator=g)]
    if n == 20_000:
        if keys == "wide":
            assert not bool(qrank.block_spans(key, cells)[2].all())
        if keys in ("wide", "offset"):
            assert float(qrank.block_spans(key, unsorted)[2].float().mean()) < 0.1
    few = torch.tensor([5000, 777, 0, nc, nc + 1, nc + 2, -3], dtype=torch.int32, device=dev)
    for q in (cells, unsorted, few):
        _rank_both(key, q, nc)


@pytest.mark.parametrize("nq,offset", [(0, 0), (1, 0), (5, 3), (1023, 0), (1025, 1), (4100, 2)])
def test_rank_kernel_on_short_and_offset_queries(dev, nq, offset):
    cfg, cl, _, _ = _sorted_inputs("grid", dev)
    nc = cfg.num_cells
    g = torch.Generator(device=dev).manual_seed(nq)
    q = torch.randint(0, nc + 2, (nq + offset,), device=dev, generator=g).to(torch.int32)[offset:]
    assert q.is_contiguous() and (nq == 0 or q.data_ptr() % 16 == 4 * offset)
    got = _rank_both(cl.key_sorted, q, nc)
    assert got.numel() == nq


def test_rank_kernel_in_a_replayed_graph_equals_eager(dev):
    """The launch is capturable: nothing in it reads the host or allocates
    outside PyTorch's allocator. A replay ranks the keys then in the input
    tensor, twice."""
    cfg, cl, _, _ = _sorted_inputs("grid", dev)
    nc = cfg.num_cells
    cells = torch.arange(nc + 2, dtype=torch.int32, device=dev)
    key = cl.key_sorted.clone()
    qrank.rank_queries(key, cells, nc)  # build and load outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qrank.rank_queries(key, cells, nc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = qrank.rank_queries(key, cells, nc)
    other = _sorted_inputs("blob", dev)[1].key_sorted
    for keys in (cl.key_sorted, other, cl.key_sorted):
        key.copy_(keys)
        graph.replay()
        torch.cuda.synchronize()
        eager, _ = qrank.rank_queries(keys, cells, nc)
        assert torch.equal(out, eager)
        assert torch.equal(out, qrank.rank_queries_plain(keys, cells, nc))


@pytest.mark.parametrize("kind", ["grid", "blob"])
def test_density_and_force_kernels_equal_plain(dev, kind):
    cfg, cl, xyz, vxyz = _sorted_inputs(kind, dev)
    key, starts = cl.key_sorted, cl.starts
    raw = fused.density(*xyz, key, starts, cfg)
    torch.testing.assert_close(raw, fused.density_plain(*xyz, key, starts, cfg), rtol=1e-5, atol=0)
    assert torch.all(raw[~cl.valid_sorted] == 0)
    rho, p = pressure_from_density(raw, cfg)
    rho = torch.where(cl.valid_sorted, rho, 1.0)
    p = torch.where(cl.valid_sorted, p, 0.0)
    if kind == "blob":
        assert float(p.max()) > 0  # the pressure term is exercised
    f = fused.force(*xyz, *vxyz, rho, p, key, starts, cfg)
    ref = fused.force_plain(*xyz, *vxyz, rho, p, key, starts, cfg)
    atol = 1e-4
    if kind == "blob":
        # Forces reach ~1.5e4 as sums of ~2,600 cancelling candidate terms,
        # and the two versions add them in other orders: float32 rounding
        # alone then differs by about sqrt(K)·eps·max|f|, far above 1e-4.
        _, count = fused.windows(key, starts, cfg)
        k = float(count.sum(dim=1).max())
        atol = k**0.5 * torch.finfo(torch.float32).eps * float(ref.abs().max())
    torch.testing.assert_close(f, ref, rtol=1e-4, atol=atol)
    assert torch.all(f[:, ~cl.valid_sorted] == 0)


def _force_atol(kind, cfg, cl, ref):
    """1e-4, or on the dense blob and the pressured clusters the float32
    floor of their sums (see test_density_and_force_kernels_equal_plain)."""
    if not kind.startswith("blob") and kind != "pressured":
        return 1e-4
    _, count = fused.windows(cl.key_sorted, cl.starts, cfg)
    k = float(count.sum(dim=1).max())
    return k**0.5 * torch.finfo(torch.float32).eps * float(ref.abs().max())


@pytest.mark.parametrize("kind", ["grid", "random", "blob", "blob_odd", "ragged", "plane"])
def test_tiled_kernels_equal_plain_and_baseline(dev, kind):
    """The tiled kernels (csrc/sph.cu) against the plain versions at their
    bars, and the density against the baseline (csrc/sph_baseline.cu) bit
    for bit: per target both add the same pairs in the same order with the
    same expressions. The blobs' density blocks stage their windows (a
    column takes several chunks; at 1001 rows by 4-byte copies), the grids'
    read device memory; the force always reads device memory."""
    cfg, cl, xyz, vxyz = _sorted_inputs(kind, dev)
    key, starts = cl.key_sorted, cl.starts
    walk = fused.chunk_walk(key, starts, cfg, stage_min=fused.DENSITY_STAGE_MIN)
    if kind.startswith("blob"):
        assert int(torch.unique(walk[:, 0] * 9 + walk[:, 2], return_counts=True)[1].max()) > 1
    if kind in ("grid", "ragged", "plane"):
        assert walk.numel() == 0
    if kind in ("ragged", "blob_odd"):
        assert key.numel() % fused.DENSITY_TILE != 0
    if kind == "blob_odd":
        assert xyz[1].data_ptr() % 16 != 0
    if kind == "plane":
        c2 = cfg.num_cells_per_dim**2
        k = key[: key.numel() // 128 * 128].view(-1, 128)
        assert bool((k[:, 0] // c2 != k[:, -1] // c2).any())  # a tile straddles a z-plane
    before = (fused.density.launches, fused.density_baseline.launches)
    base = fused.density_baseline(*xyz, key, starts, cfg)
    raw = fused.density(*xyz, key, starts, cfg)
    assert (fused.density.launches, fused.density_baseline.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(raw, fused.density_plain(*xyz, key, starts, cfg), rtol=1e-5, atol=0)
    assert torch.equal(raw, base)
    assert torch.all(raw[~cl.valid_sorted] == 0)
    rho, p = pressure_from_density(raw, cfg)
    rho = torch.where(cl.valid_sorted, rho, 1.0)
    p = torch.where(cl.valid_sorted, p, 0.0)
    args = (*xyz, *vxyz, rho, p, key, starts, cfg)
    ref = fused.force_plain(*args)
    atol = _force_atol(kind, cfg, cl, ref)
    f = fused.force(*args)
    torch.testing.assert_close(f, ref, rtol=1e-4, atol=atol)
    torch.testing.assert_close(fused.force_baseline(*args), ref, rtol=1e-4, atol=atol)
    assert torch.all(f[:, ~cl.valid_sorted] == 0)


def test_tiled_density_takes_fields_off_16_bytes(dev):
    """The dense blob at 4096 rows, whose blocks stage, with x one float
    past a 16-byte boundary: the stages fill by 4-byte copies, and the sums
    equal the baseline's and the aligned launch's bit for bit."""
    cfg, cl, xyz, _ = _sorted_inputs("blob", dev)
    shifted = torch.empty(xyz.shape[1] + 1, device=dev)[1:]
    shifted.copy_(xyz[0])
    assert shifted.data_ptr() % 16 != 0
    got = fused.density(shifted, xyz[1], xyz[2], cl.key_sorted, cl.starts, cfg)
    assert torch.equal(got, fused.density(*xyz, cl.key_sorted, cl.starts, cfg))
    assert torch.equal(
        got, fused.density_baseline(shifted, xyz[1], xyz[2], cl.key_sorted, cl.starts, cfg))


def _pressured_inputs(dev, steps):
    """Sorted rows, keys and starts of the clustered state of
    `torch_pressured.py` at 8,192 after `steps` steps on the card: clusters
    of 64 within 0.2 h of lattice points h apart, every particle pressured
    at step 0 and the clusters merging under pressure after."""
    cfg, st = clustered_state(8192, device=dev)
    step = make_step(cfg, "kernels", dev)
    for _ in range(steps):
        st, _ = step(st)
    g = torch.Generator(device=dev).manual_seed(2)
    st.velocity.add_(torch.randn(st.velocity.shape, generator=g, device=dev) * 0.1)
    cl = build_phase(st, cfg)
    xyz = st.position[cl.perm].T.contiguous()
    vxyz = st.velocity[cl.perm].T.contiguous()
    return cfg, cl, xyz, vxyz


def _pressure(raw, cl, cfg):
    rho, p = pressure_from_density(raw, cfg)
    return torch.where(cl.valid_sorted, rho, 1.0), torch.where(cl.valid_sorted, p, 0.0)


@pytest.mark.parametrize("steps", [0, 5])
def test_kernels_equal_plain_under_pressure(dev, steps):
    """The density and force kernels against their plain versions at the
    force kernel's pressure path: most targets have p > 0 and the pair
    terms of each cluster cancel, so the force is held at the float32 floor
    of its sums, as on the dense blob."""
    cfg, cl, xyz, vxyz = _pressured_inputs(dev, steps)
    key, starts = cl.key_sorted, cl.starts
    raw = fused.density(*xyz, key, starts, cfg)
    torch.testing.assert_close(raw, fused.density_plain(*xyz, key, starts, cfg), rtol=1e-5, atol=0)
    rho, p = _pressure(raw, cl, cfg)
    assert int((p > 0).sum()) > key.numel() // 4
    args = (*xyz, *vxyz, rho, p, key, starts, cfg)
    ref = fused.force_plain(*args)
    torch.testing.assert_close(fused.force(*args), ref, rtol=1e-4,
                               atol=_force_atol("pressured", cfg, cl, ref))


@pytest.mark.parametrize("kind", ["grid", "random", "blob", "ragged", "pressured"])
def test_force_walk_counter_equals_the_plain_count(dev, kind):
    """The kernel's walk counter equals `force_walk` exactly (candidates,
    pressured targets, the heaviest block), and the forces with the counter
    equal those without it bit for bit."""
    if kind == "pressured":
        cfg, cl, xyz, vxyz = _pressured_inputs(dev, 0)
    else:
        cfg, cl, xyz, vxyz = _sorted_inputs(kind, dev)
    key, starts = cl.key_sorted, cl.starts
    rho, p = _pressure(fused.density(*xyz, key, starts, cfg), cl, cfg)
    args = (*xyz, *vxyz, rho, p, key, starts, cfg)
    walk = torch.zeros(len(fused.WALK), dtype=torch.int64, device=dev)
    f = fused.force(*args, walk=walk)
    want = fused.force_walk(key, starts, p, cfg)
    assert torch.equal(walk, want), (walk.tolist(), want.tolist())
    assert torch.equal(f, fused.force(*args))
    if kind in ("blob", "pressured"):
        assert int(want[1]) > 0


def test_timed_steps_count_the_walk_on_the_card(dev):
    """Six carried timed steps from the clustered state under a profile:
    the counters `force.*` are the sums of each pre-step state's
    `force_walk`, the copy of each step's counter riding its fetch."""
    from torch.profiler import ProfilerActivity, profile

    from tpusph_torch.bench import spans
    from tpusph_torch.engine.step import masked_pressure

    cfg, start = clustered_state(8192, device=dev)
    sim = Simulator(cfg, device=dev)
    sim.setup(start)
    spans.reset()
    before = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(6):
            before.append(type(sim.state)(*(getattr(sim.state, f).clone() for f in _FIELDS)))
            sim.simulate_and_time(Times())
        sim.get_position()
    counts = spans.counts()
    spans.reset()
    want = torch.zeros(len(fused.WALK), dtype=torch.int64, device=dev)
    for st in before:
        cl = build_phase(st, cfg)
        xyz = st.position[cl.perm].T.contiguous()
        _, p = masked_pressure(fused.density(*xyz, cl.key_sorted, cl.starts, cfg),
                               cl.valid_sorted, cfg)
        want += fused.force_walk(cl.key_sorted, cl.starts, p, cfg)
    assert [counts[f"force.{k}"] for k in fused.WALK] == want.tolist()
    assert counts["force.blocks"] == 6 * fused.force_blocks(8192)
    assert counts["force.pressured"] > 0


def test_kernels_repeat_bit_for_bit(dev):
    """No atomics: two launches on the same inputs give the same bits."""
    cfg, cl, xyz, vxyz = _sorted_inputs("blob", dev)
    a = fused.density(*xyz, cl.key_sorted, cl.starts, cfg)
    b = fused.density(*xyz, cl.key_sorted, cl.starts, cfg)
    assert torch.equal(a, b)
    rho, p = pressure_from_density(a, cfg)
    fa = fused.force(*xyz, *vxyz, rho, p, cl.key_sorted, cl.starts, cfg)
    fb = fused.force(*xyz, *vxyz, rho, p, cl.key_sorted, cl.starts, cfg)
    assert torch.equal(fa, fb)


def test_wrappers_reject_mixed_devices(dev):
    cfg, cl, xyz, _ = _sorted_inputs("grid", dev)
    with pytest.raises(ValueError):
        fused.density(xyz[0].cpu(), xyz[1], xyz[2], cl.key_sorted, cl.starts, cfg)
    with pytest.raises(ValueError):
        qrank.rank_queries(cl.key_sorted, cl.starts.cpu(), cfg.num_cells)


def test_timed_fetch_equals_a_synchronous_copy(dev):
    """20 double-buffered timed steps at N = 4096: each step's fetched
    positions equal a synchronous copy of that state, and no array handed
    out is overwritten by a later step."""
    n = 4096
    sim = Simulator(default_config(n, chunk_size=1024), device=dev)
    sim.setup()
    times = Times()
    got, want = [], []
    for _ in range(20):
        sim.simulate_and_time(times)
        want.append(sim.state.position[:n].cpu().numpy())
        got.append(sim.get_position())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fetches_in_flight_across_steps(dev):
    """Fetches started right after their step is queued, and waited on only
    after 20 more steps: the side stream waited for the step, and the
    source positions were not reused while it read them."""
    n = 4096
    sim = Simulator(default_config(n, chunk_size=1024), device=dev)
    sim.setup()
    pending = []
    for _ in range(20):
        sim.simulate()
        pending.append((sim.get_position_async(), sim.state.position[:n].clone()))
    for fetch, ref in pending:
        np.testing.assert_array_equal(fetch.wait(), ref.cpu().numpy())


def test_fetch_buffer_is_pinned(dev):
    sim = Simulator(default_config(1024, chunk_size=1024), device=dev)
    sim.setup()
    fetch = sim.get_position_async()
    assert fetch.buffer.is_pinned()
    np.testing.assert_array_equal(fetch.wait(), sim.state.position[:1024].cpu().numpy())


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


def _timed_pair(dev, backend="kernels", **cfg_kw):
    """(carried, cloned) Simulators at 4,096 grid init on the card, set up
    from one state, and that state with a copy of its tensors."""
    cfg = default_config(4096, chunk_size=1024, **cfg_kw)
    start = init_state(cfg, device=dev)
    sims = [kind(cfg, backend=backend, device=dev) for kind in (_Carried, _Cloned)]
    for sim in sims:
        sim.setup(start)
    return (*sims, start, [getattr(start, f).clone() for f in _FIELDS])


_FIELDS = ("position", "velocity", "force", "density", "pressure", "valid")


def _states_equal(a, b) -> bool:
    return all(torch.equal(getattr(a.state, f), getattr(b.state, f)) for f in _FIELDS)


def test_carried_timed_steps_equal_the_cloned_path(dev):
    """12 timed steps: after each, the carried state (position, density,
    every field) equals the cloned path's bit for bit; the steps alternate
    between the two buffers, the first copies `setup()`'s state in and the
    other eleven carry (`graph.carried`); once both pairs are captured a
    carried step's host enqueues only the fetch's copies, of the positions
    and, as a profile records, of the force's walk counter beside them, and
    no clone (one profile a step); `setup()`'s tensors are unchanged; each
    `get_position()` array keeps its values through later steps."""
    from torch.profiler import ProfilerActivity, profile

    from tpusph_torch.bench import spans

    carried, cloned, start, kept = _timed_pair(dev)
    steps, got, held, sources, ops = 12, [], [], [], []
    spans.reset()
    for _ in range(steps):
        sources.append(carried._timed and carried._timed.source(
            [getattr(carried.state, f) for f in _FIELDS]))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            carried.simulate_and_time(Times())
        names = [e.name for e in prof.events()]
        ops.append((names.count("aten::copy_"), names.count("aten::clone")))
        got.append(carried.get_position())
        held.append(got[-1].copy())
        cloned.simulate_and_time(Times())
        assert _states_equal(carried, cloned)
        np.testing.assert_array_equal(got[-1], cloned.get_position())
    assert sources == [None] + [1, 0] * 5 + [1]
    assert spans.counts()["graph.carried"] == steps - 1
    assert spans.totals()["graph.copy_in"].count == 1 and "graph.clone_out" not in spans.totals()
    assert ops[2:] == [(2, 0)] * (steps - 2), ops
    spans.reset()
    for g, h in zip(got, held):
        np.testing.assert_array_equal(g, h)
    assert all(torch.equal(getattr(start, f), k) for f, k in zip(_FIELDS, kept))
    assert len(carried._timed.pairs) == 2 and len(cloned._timed.pairs) == 1


def test_carried_steps_put_back_and_between_untimed_steps(dev):
    """The state put back to the step before's (the harness's `unchanged`
    fault: that buffer's pair runs again, the copy of the other buffer in
    flight waited for first), and `simulate()` between timed steps (its
    state copied in): the states and fetched positions equal the cloned
    path's bit for bit."""
    carried, cloned, _, _ = _timed_pair(dev)
    for k in range(12):
        for sim in (carried, cloned):
            if k % 4 == 3:
                sim.simulate()
            elif k in (5, 6):
                before = sim.state
                sim.simulate_and_time(Times())
                sim.state = before
            else:
                sim.simulate_and_time(Times())
        assert _states_equal(carried, cloned), k
        np.testing.assert_array_equal(carried.get_position(), cloned.get_position())


def test_a_state_on_the_host_is_copied_into_the_carried_buffers(dev):
    """`setup()` with the start state's tensors on the host: the first
    timed step copies them onto the card, and 3 steps equal the cloned
    path's from the card's copy bit for bit."""
    carried, cloned, start, _ = _timed_pair(dev)
    carried.setup(type(start)(*(getattr(start, f).cpu() for f in _FIELDS)))
    for _ in range(3):
        carried.simulate_and_time(Times())
        cloned.simulate_and_time(Times())
        assert carried.state.position.device == dev and _states_equal(carried, cloned)


def test_an_overflow_regrows_on_new_carried_pairs(dev):
    """`cell_list` from tile_cand_capacity 64: a timed step that overflowed
    is replayed at the grown capacity on new pairs, which copy the old
    buffer's state in; 6 steps equal the cloned path's bit for bit."""
    carried, cloned, _, _ = _timed_pair(dev, "cell_list", tile_cand_capacity=64)
    for _ in range(6):
        carried.simulate_and_time(Times())
        cloned.simulate_and_time(Times())
        assert _states_equal(carried, cloned)
    assert carried.cfg.tile_cand_capacity == cloned.cfg.tile_cand_capacity > 64
    assert len(carried._timed.pairs) == 2


def _same(kernel, plain, rtol):
    torch.cuda.synchronize()
    if rtol:
        torch.testing.assert_close(kernel, plain, rtol=rtol, atol=0)
    else:
        assert torch.equal(kernel, plain)


@pytest.mark.parametrize("streams", probes.FMA_STREAMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fma_probe_equals_plain(dev, dtype, streams):
    g = torch.Generator(device=dev).manual_seed(streams)
    x = torch.empty((256, 128), device=dev).uniform_(0.5, 2.0, generator=g).to(dtype)
    before = probes.fma_probe.launches
    got = probes.fma_probe(x, streams, 64)
    assert probes.fma_probe.launches == before + 1
    _same(got, probes.fma_probe_plain(x, streams, 64), 1e-5 if dtype == torch.float32 else 0)


@pytest.mark.parametrize("rounds", [1, 7, 64, 65])
@pytest.mark.parametrize("pt", [8, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_density_mix_equals_plain(dev, dtype, pt, rounds):
    """1 and 7 rounds run only the loop of single rounds, 64 only the loop
    that takes several rounds at once, 65 both. bf16 equals the first
    design bit for bit; f32 is held to it at the plain version's bar."""
    g = torch.Generator(device=dev).manual_seed(pt)
    t = torch.empty((max(pt, 8), 4), device=dev).uniform_(1.0, 1.05, generator=g)
    c = torch.empty((8, 128), device=dev).uniform_(1.0, 1.05, generator=g)
    t[:, 3] = torch.randint(0, 3, (t.shape[0],), device=dev, generator=g).float()
    c[3] = torch.randint(0, 3, (128,), device=dev, generator=g).float()
    t, c = t.to(dtype), c.to(dtype)
    rtol = 1e-5 if dtype == torch.float32 else 0
    before = (probes.density_mix.launches, probes.density_mix_baseline.launches)
    got = probes.density_mix(t, c, pt, rounds)
    base = probes.density_mix_baseline(t, c, pt, rounds)
    assert (probes.density_mix.launches, probes.density_mix_baseline.launches) == (
        before[0] + 1, before[1] + 1)
    _same(got, probes.density_mix_plain(t, c, pt, rounds), rtol)
    _same(got, base, rtol)
    assert (got != 0).any() and (got == 0).any()  # the masks cut some lanes


@pytest.mark.parametrize("streams", probes.FMA_STREAMS)
def test_fma_probe_runs_every_round(dev, streams):
    """At the entry point's 20,000 rounds on tie-free inputs the f32 kernel
    equals the plain version bit for bit; one round fewer changes the bits."""
    rounds = 20_000
    x = probes.fma_tie_free_input((256, 128), streams, rounds).to(dev)
    got = probes.fma_probe(x, streams, rounds)
    _same(got, probes.fma_probe_plain(x, streams, rounds), 0)
    assert not torch.equal(got, probes.fma_probe(x, streams, rounds - 1))


def _loop_inputs(dev, rounds, trip, seed):
    pt, bl, cap = 64, 256, 16384
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.empty((pt, 4), device=dev).uniform_(1.0, 1.05, generator=g)
    cand = torch.empty((8, cap), device=dev).uniform_(1.0, 1.05, generator=g)
    desc = torch.randint(0, (cap - bl) // 128, (rounds + 8,), device=dev, generator=g)
    desc[rounds] = trip
    return desc.to(torch.int16), t, cand, pt, bl


@pytest.mark.parametrize("rounds", [64, 4096, 16384])
@pytest.mark.parametrize("variant", list(probes.VARIANTS))
def test_loop_probe_equals_plain(dev, variant, rounds):
    args = _loop_inputs(dev, rounds, rounds, rounds)
    got = probes.loop_probe(variant, *args)
    want = probes.loop_probe_plain(variant, *args)
    torch.cuda.synchronize()
    if rounds <= 64:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        return
    # Two sums of `rounds` f32 terms rounded in two orders (FMA against
    # separate ops) differ by at most rounds·eps·|sum|, and a static-load
    # variant, adding the same term every round, may come near that: one
    # rounding that tips the other way recurs in every round. The mean
    # difference stays far below one round's term, which a kernel one
    # round short misses by 100×.
    torch.testing.assert_close(got, want, rtol=rounds * torch.finfo(torch.float32).eps, atol=0)
    shift = float((got - want).mean()) / (float(want.mean()) / rounds)
    assert abs(shift) < 0.01


@pytest.mark.parametrize("variant", ["V2", "V3", "V4", "V5"])
def test_dynamic_trip_reads_desc(dev, variant):
    """The dynamic-trip variants run desc[rounds] blocks, here 41 of 64."""
    args = _loop_inputs(dev, 64, 41, 7)
    _same(probes.loop_probe(variant, *args), probes.loop_probe_plain(variant, *args), 1e-5)
    full = probes.loop_probe_plain(variant, *_loop_inputs(dev, 64, 64, 7))
    assert not torch.allclose(full, probes.loop_probe(variant, *args), rtol=1e-2)


def _loop_case(dev, case):
    """(desc, t, cand, pt, bl) of one path of the loop probe's kernel, at
    64 rounds unless the case is a round count."""
    pt, bl, cap, rounds = 64, 256, 16384, 64
    if case == "rounds67":  # no multiple of the rounds a loop iteration takes
        rounds = 67
    elif case == "rounds1":  # the loop of single rounds alone
        rounds = 1
    elif case == "cand512":  # a small table
        cap = 512
    elif case == "wide":  # 393 KB of table: read from device memory
        cap = 131072
    elif case == "pt8":
        pt = 8
    elif case == "pt128":
        pt = 128
    elif case == "pt5_bl40":  # columns off a 32-lane slice: nothing staged
        pt, bl = 5, 40
    g = torch.Generator(device=dev).manual_seed(len(case))
    t = torch.empty((max(pt, 8), 4), device=dev).uniform_(1.0, 1.05, generator=g)
    cand = torch.empty(8 * cap + 1, device=dev).uniform_(1.0, 1.05, generator=g)
    if case == "cand_off16":  # 4 bytes past a 16-byte boundary: device memory at this shape
        cand = cand[1:].view(8, cap)
        assert cand.data_ptr() % 16 == 4
    else:
        cand = cand[:-1].view(8, cap)
    desc = torch.randint(0, (cap - bl) // 128 + 1, (rounds + 9,), device=dev, generator=g)
    desc = desc.to(torch.int16)
    if case == "desc_off16":  # 2 bytes past a 16-byte boundary: the loop of single rounds
        desc = desc[1:]
        assert desc.data_ptr() % 16 == 2
    else:
        desc = desc[:-1].clone()
    desc[rounds] = rounds
    return desc, t, cand, pt, bl


@pytest.mark.parametrize("case", ["rounds67", "rounds1", "desc_off16", "cand512", "wide", "pt8",
                                  "pt128", "pt5_bl40", "cand_off16"])
@pytest.mark.parametrize("variant", list(probes.VARIANTS))
def test_loop_probe_on_every_path(dev, variant, case):
    """The new kernel against plain (rtol 1e-5, as at 64 rounds) on each
    path its inputs select: the staged table and device memory, both loops,
    a desc read by 16-byte loads and entry by entry."""
    desc, t, cand, pt, bl = _loop_case(dev, case)
    staged = probes.loop_stage_blocks(variant, cand, bl) > 0
    dyn_load = probes.VARIANTS[variant][1]
    assert staged == (case not in ("pt5_bl40", "cand_off16")
                      and not (case == "wide" and dyn_load))
    before = (probes.loop_probe.launches, probes.loop_probe.staged)
    got = probes.loop_probe(variant, desc, t, cand, pt, bl)
    assert (probes.loop_probe.launches, probes.loop_probe.staged) == (
        before[0] + 1, before[1] + staged)
    want = probes.loop_probe_plain(variant, desc, t, cand, pt, bl)
    _same(got, want, 1e-5)
    assert (want != 0).all() or (variant == "V4" and case == "rounds1")


@pytest.mark.parametrize("rounds", [64, 4096])
@pytest.mark.parametrize("variant", list(probes.VARIANTS))
def test_loop_probe_baseline_equals_plain_and_new(dev, variant, rounds):
    """The first design at the bars it was ported at, and the new kernel
    beside it: both within rounds·eps of plain, so within twice that of each
    other (they add the same terms in the same order and mostly agree bit
    for bit)."""
    args = _loop_inputs(dev, rounds, rounds, rounds + 1)
    before = (probes.loop_probe.launches, probes.loop_probe_baseline.launches)
    first = probes.loop_probe_baseline(variant, *args)
    got = probes.loop_probe(variant, *args)
    assert (probes.loop_probe.launches, probes.loop_probe_baseline.launches) == (
        before[0] + 1, before[1] + 1)
    want = probes.loop_probe_plain(variant, *args)
    torch.cuda.synchronize()
    rtol = 1e-5 if rounds <= 64 else rounds * torch.finfo(torch.float32).eps
    torch.testing.assert_close(first, want, rtol=rtol, atol=0)
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)
    torch.testing.assert_close(got, first, rtol=2 * rtol, atol=0)
    shift = float((first - want).mean()) / (float(want.mean()) / rounds)
    assert abs(shift) < 0.01


def test_loop_probe_in_a_replayed_graph_equals_eager(dev):
    """The launch is capturable: no host read, no allocation besides out."""
    args = _loop_inputs(dev, 64, 64, 9)
    eager = probes.loop_probe("V3", *args)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        probes.loop_probe("V3", *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = probes.loop_probe("V3", *args)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_static_trip_refuses_other_round_counts(dev):
    desc = torch.zeros(100 + 8, dtype=torch.int16, device=dev)
    t = torch.ones((8, 4), device=dev)
    cand = torch.ones((8, 512), device=dev)
    with pytest.raises(ValueError):
        probes.loop_probe("V0", desc, t, cand, 8, 256)
    with pytest.raises(ValueError):
        probes.loop_probe_baseline("V1", desc, t, cand, 8, 256)
    probes.loop_probe("V2", desc, t, cand, 8, 256)  # the trip count comes from desc
    probes.loop_probe_baseline("V2", desc, t, cand, 8, 256)


# ------------------------------------------- CUDA graphs of chained steps


def _counts():
    return {fn: fn.launches for fn in (qrank.rank_queries, fused.density, fused.force)}


@pytest.mark.parametrize("random_init", [False, True], ids=["grid", "random"])
def test_chunk_graph_equals_sequential_steps(dev, random_init):
    """simulate_chunk(5) with a click at step 2, one graph replay, equals 5
    sequential simulate() calls bit for bit (snapshots and the final
    velocity); each kernel ran 5 times per replay; the frame streams equal
    the projections of the sequential positions."""
    from tpusph_torch.viz.project import project_bitmap, project_pixels_packed

    n, clicks = 4096, {2: (400, 300)}
    cfg = default_config(n, chunk_size=1024)
    sim = Simulator(cfg, random_init=random_init, seed=5, device=dev)
    ref = Simulator(cfg, random_init=random_init, seed=5, device=dev)
    sim.setup()
    ref.setup()
    sim.simulate_chunk(5, clicks=clicks)  # capture (and its warm-up)
    sim.setup()
    before = _counts()
    pos = sim.simulate_chunk(5, clicks=clicks)
    for fn, c in _counts().items():
        assert c - before[fn] == 5, fn.__name__
    for k in range(5):
        ref.simulate(click=clicks.get(k))
        np.testing.assert_array_equal(pos[k], ref.get_position(), err_msg=str(k))
    assert torch.equal(sim.state.velocity, ref.state.velocity)
    for pack, proj in ((True, project_pixels_packed), ("bitmap", project_bitmap)):
        a, b = (Simulator(cfg, random_init=random_init, seed=5, device=dev) for _ in range(2))
        a.setup()
        b.setup()
        frames, ovf = a.dispatch_chunk(3, pack_pixels=pack).fetch.wait()
        assert ovf == 0
        for k in range(3):
            b.simulate()
            rows = b.state.position[:n] if pack == "bitmap" else b.state.position
            want = proj(rows).cpu().numpy()
            np.testing.assert_array_equal(frames[k], want[:n] if pack is True else want)


def test_chunks_in_flight_keep_their_outputs(dev):
    """Two chunks dispatched before either is read: the second replay of the
    same graph does not overwrite the first chunk's snapshots or state."""
    n = 4096
    cfg = default_config(n, chunk_size=1024)
    sim, ref = Simulator(cfg, device=dev), Simulator(cfg, device=dev)
    sim.setup()
    ref.setup()
    h1 = sim.dispatch_chunk(3)
    mid = sim.state
    h2 = sim.dispatch_chunk(3)
    want = []
    for _ in range(6):
        ref.simulate()
        want.append(ref.get_position())
    for k, snap in enumerate(np.concatenate([h1.fetch.wait()[0], h2.fetch.wait()[0]])):
        np.testing.assert_array_equal(snap, want[k], err_msg=str(k))
    sim.rewind_chunk(h2, grow=False)
    assert sim.state is mid
    np.testing.assert_array_equal(sim.get_position(), want[2])


def test_fields_chain_graph_equals_eager_steps(dev):
    from tpusph_torch.engine.step import fields_from_state, make_fields_chain, step_kernels_fields

    n = 4096
    cfg = default_config(n, chunk_size=1024)
    fs0 = fields_from_state(init_state(cfg, device=dev))
    chain = make_fields_chain(cfg, 20, dev)
    chain(fs0)  # capture
    before = _counts()
    out, ovf = chain(fs0)
    for fn, c in _counts().items():
        assert c - before[fn] == 20, fn.__name__
    assert int(ovf) == 0
    fs = fs0
    for _ in range(20):
        (fs, _, _, _), _ = step_kernels_fields(fs, cfg)
    for a, b in zip(out, fs):
        assert torch.equal(a, b)


def test_cell_list_backend_grows_and_matches_kernels(dev):
    n = 4096
    small = Simulator(default_config(n, chunk_size=1024, tile_cand_capacity=64),
                      backend="cell_list", device=dev)
    ample = Simulator(default_config(n, chunk_size=1024), backend="cell_list", device=dev)
    kern = Simulator(default_config(n, chunk_size=1024), device=dev)
    for s in (small, ample, kern):
        s.setup()
        for _ in range(10):
            s.simulate()
    assert small.cfg.tile_cand_capacity > 64
    np.testing.assert_allclose(small.get_position(), ample.get_position(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ample.get_position(), kern.get_position(), rtol=0, atol=1e-4)


def test_cell_list_chunk_graph_grows_and_replays(dev):
    """The chunk graph runs the Simulator's own backend: a cell_list chunk
    from tile_cand_capacity 64 overflows, rewinds, is captured again at the
    grown capacity, and its snapshots equal ample-capacity sequential steps
    within 1e-6."""
    n = 4096
    small = Simulator(default_config(n, chunk_size=1024, tile_cand_capacity=64),
                      backend="cell_list", device=dev)
    ample = Simulator(default_config(n, chunk_size=1024), backend="cell_list", device=dev)
    small.setup()
    ample.setup()
    pos = small.simulate_chunk(5)
    assert small.cfg.tile_cand_capacity > 64
    for k in range(5):
        ample.simulate()
        np.testing.assert_allclose(pos[k], ample.get_position(), rtol=0, atol=1e-6,
                                   err_msg=str(k))


@pytest.mark.parametrize("full", ["0", "1"], ids=["elided", "full_machinery"])
def test_sharded_step_on_the_card_matches_the_cpu(dev, full, monkeypatch):
    """One rank of the sharded engine on the card (the three kernels on
    its combined rows, with dead halo rows when the whole machinery runs)
    against the same steps on the CPU (the plain versions): 5 steps at
    4,096 grid init, positions by pid within 1e-4, counters clean, one
    launch of each kernel a step once the step's graph is captured (its
    warm-up runs the kernels too)."""
    from tpusph_torch.dist.comm import SlabComm
    from tpusph_torch.dist.sharded import (
        DistConfig,
        collect_state,
        distribute_state,
        make_sharded_step,
    )

    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", full)
    n = 4096
    cfg = default_config(n, chunk_size=1024)
    dcfg = DistConfig(1, n, 1000 // 8 * 8, 256)
    whole = init_state(cfg, device="cpu")
    got = {}
    for device in (dev, "cpu"):
        comm = SlabComm(device)
        state = distribute_state(whole, cfg, dcfg, comm)
        step = make_sharded_step(cfg, dcfg, comm)
        step(state)  # the capture on the card
        kernels = (qrank.rank_queries, fused.density, fused.force)
        for fn in kernels:
            fn.launches = 0
        for _ in range(5):
            state, aux = step(state)
        assert [fn.launches for fn in kernels] == [5 * (comm.device.type == "cuda")] * 3
        assert [int(a) for a in aux[:6]] == [0, 0, 0, 0, 0, n]
        got[comm.device.type] = collect_state(state, n, comm)
    np.testing.assert_allclose(got["cuda"]["position"], got["cpu"]["position"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["cuda"]["velocity"], got["cpu"]["velocity"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mesh", [None, (1, 1, 1)], ids=["z", "brick"])
def test_dist_simulator_on_the_card_matches_the_cpu(dev, mesh):
    """`DistSimulator` on one rank on the card (z-slabs, elided; a (1, 1, 1)
    brick grid, the whole machinery, its halo grown by a first step) against
    the same steps on the CPU: 5 `simulate()` steps at 4,096 grid init,
    positions by pid within 1e-4, counters clean, one launch of each kernel
    a step."""
    from tpusph_torch.dist.simulator import DistSimulator

    n = 4096
    cfg = default_config(n, chunk_size=1024)
    kernels = (qrank.rank_queries, fused.density, fused.force)
    got = {}
    for device in (dev, torch.device("cpu")):
        sim = DistSimulator(cfg, mesh_shape=mesh, device=device)
        sim.setup()
        sim.simulate()  # grows what the grid sheet overflows
        sim.setup()
        for fn in kernels:
            fn.launches = 0
        for _ in range(5):
            sim.simulate()
        assert [fn.launches for fn in kernels] == [5 * (device.type == "cuda")] * 3
        assert list(sim.last_aux[:6]) == [0, 0, 0, 0, 0, n]
        got[device.type] = sim.get_position()
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=0, atol=1e-4)


def _bench_torch():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench_torch

    return bench_torch


def test_bench_gates_pass_on_the_card(dev):
    """`bench_torch`'s gates on the card: verify_parity at 4,096 (the
    fields chain, a CUDA graph, against the cell_list tile passes; the
    oracle) and verify_headline at 32,768 over 3 steps; the kernels run."""
    bench_torch = _bench_torch()
    kernels = (qrank.rank_queries, fused.density, fused.force)
    for fn in kernels:
        fn.launches = 0
    assert bench_torch.verify_parity("kernels", 10, 4096, dev) == "pass"
    assert all(fn.launches > 0 for fn in kernels)
    cfg = default_config(32768)
    assert bench_torch.verify_headline(cfg, init_state(cfg, device=dev), "kernels", dev, 3) == "pass"


def test_bench_main_launches_the_kernels(dev, monkeypatch, capsys):
    import json

    bench_torch = _bench_torch()
    for k, v in (("TPUSPH_BENCH_N", "16384"), ("TPUSPH_BENCH_STEPS", "5"),
                 ("TPUSPH_BENCH_VERIFY", "0")):
        monkeypatch.setenv(k, v)
    for k in ("TPUSPH_BENCH_DIST", "TPUSPH_BENCH_DEVICE", "TPUSPH_BENCH_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    kernels = (qrank.rank_queries, fused.density, fused.force)
    for fn in kernels:
        fn.launches = 0
    bench_torch.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "torch_sph_timesteps_per_sec_n16384" and line["value"] > 0
    assert line["device"] == torch.cuda.get_device_name(dev)
    # the capture's warm-up run, its first replay, the warm and the timed replay
    assert [fn.launches for fn in kernels] == [4 * 5] * 3


def test_fields_profile_stages_compose_on_the_card(dev):
    """The profile's stages in order are the fields step bit for bit."""
    from tpusph_torch.engine.step import fields_from_state, step_kernels_fields
    from tpusph_torch.scripts import fields_profile

    cfg = default_config(32768)
    fs = fields_from_state(init_state(cfg, random_init=True, seed=3, device=dev))
    fns = fields_profile.stages(cfg)
    sf = fns["build"](fs)
    rho, p = fns["press"](fns["density"](sf), sf.valid_sorted)
    fxyz = fns["force"](sf, rho, p)
    out = fns["integ"](sf, fxyz, rho)
    (want, w_rho, w_p, w_f), _ = step_kernels_fields(fs, cfg)
    for a, b in zip((*out, rho, p, *fxyz), (*want, w_rho, w_p, *w_f)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("random_init", [False, True], ids=["grid", "random"])
def test_build_bench_starts_tables_on_the_card(dev, random_init):
    from tpusph_torch.scripts import build_bench

    cfg = default_config(65536)
    st = init_state(cfg, random_init=random_init, seed=4, device=dev)
    from tpusph_torch.engine.step import fields_from_state

    fs = fields_from_state(st)
    key, _ = build_bench.compute_keys_fields(fs.x, fs.y, fs.z, fs.valid, cfg)
    tables = build_bench.starts_tables(cfg, key, torch.sort(key, stable=True).values)
    ref = tables["hist+cumsum"]
    assert all(torch.equal(t, ref) for t in tables.values())


def test_graft_entry_step_on_the_card_matches_the_cpu(dev):
    from tpusph_torch import graft_entry

    fn, (state,) = graft_entry.entry()
    assert state.position.is_cuda
    got = fn(state)
    fn_cpu, (state_cpu,) = graft_entry.entry(device="cpu")
    want = fn_cpu(state_cpu)
    for f in ("position", "velocity", "density"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(), getattr(want, f).numpy(),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------ the jitted dispatches as graphs


def _replays_equal(graphed, eager, start, calls=3):
    """`graphed` and `eager` (state -> (state, aux)) `calls` times from
    `start`, after a first graphed call (the capture, whose warm-up may
    make constants by a copy from the host): the graphed calls (sync debug
    mode "error" around them) equal the eager ones bit for bit after each
    call."""
    graphed(start)
    a = b = start
    for _ in range(calls):
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a, aux_a = graphed(a)
        finally:
            torch.cuda.set_sync_debug_mode(previous)
        b, aux_b = eager(b)
        for x, y in zip(a if isinstance(a, tuple) else vars(a).values(),
                        b if isinstance(b, tuple) else vars(b).values()):
            assert torch.equal(x, y)
        assert [int(v) for v in aux_a] == [int(v) for v in aux_b]


@pytest.mark.parametrize("entry", ["step", "impulse", "slab_step", "slab_timed", "slab_run",
                                   "brick_step", "brick_timed", "brick_run"])
def test_graphed_entry_points_replay_their_eager_path(dev, entry, monkeypatch):
    """On the card at 4,096 grid init, each graphed entry point (`make_step`,
    `make_impulse`, and on one rank the slab engine's through the whole
    machinery and the (1, 1, 1) brick's step with a click, timed stages and
    2-step run) replays a CUDA graph bit for bit equal to its eager path."""
    from tpusph_torch.dist import mesh3d, sharded
    from tpusph_torch.dist.comm import BrickComm, SlabComm
    from tpusph_torch.interact.impulse import make_impulse

    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")
    n, click = 4096, (400, 300)
    cfg = default_config(n, chunk_size=1024)
    if entry == "step":
        fn = make_step(cfg, "kernels", dev)
        _replays_equal(fn, fn.eager, init_state(cfg, device=dev))
        return
    if entry == "impulse":
        fn = make_impulse(cfg)
        _replays_equal(lambda s: (fn(s, s.position, click), ()),
                       lambda s: (fn.eager(s, s.position, click), ()),
                       init_state(cfg, device=dev))
        return
    engine, kind = entry.split("_")
    whole = init_state(cfg, device="cpu")
    if engine == "slab":
        comm = SlabComm(dev)
        dcfg = sharded.DistConfig(1, n, 1024, 256)
        start = sharded.distribute_state(whole, cfg, dcfg, comm)
        makers = (sharded.make_sharded_step, sharded.make_sharded_timed, sharded.make_sharded_run)
    else:
        comm = BrickComm(dev)
        dcfg = mesh3d.Mesh3DConfig((1, 1, 1), n, (n,) * 3, (256,) * 3)
        start = mesh3d.distribute_state_3d(whole, cfg, dcfg, comm)
        makers = (mesh3d.make_mesh3d_step, mesh3d.make_mesh3d_timed, mesh3d.make_mesh3d_run)
    if kind == "step":
        fn = makers[0](cfg, dcfg, comm)
        _replays_equal(lambda s: fn(s, click), lambda s: fn.eager(s, click), start)
    elif kind == "timed":
        build, update = makers[1](cfg, dcfg, comm)
        _replays_equal(lambda s: update(*build(s)), lambda s: update.eager(*build.eager(s)),
                       start)
    else:
        fn = makers[2](cfg, dcfg, comm, 2)
        _replays_equal(fn, fn.eager, start)


def test_a_host_read_fails_the_capture(dev):
    """A body that reads the card on the host cannot be captured: the call
    raises, with no eager fallback."""
    from tpusph_torch.engine.graphs import GraphedLoop, HostReadError

    def body(inputs):
        inputs[0].sum().item()
        return [inputs[0] * 2]

    with pytest.raises(HostReadError):
        GraphedLoop(body, dev)([torch.ones(4, device=dev)])


@pytest.mark.parametrize("profiled", [False, True])
def test_a_capture_records_its_spans_and_a_replay_its_nodes(dev, profiled):
    """One capture records `graph.warmup` and `graph.record` once, with a
    profile recording or not; each replay under a profile adds its graph's
    top-level nodes (`graph_cond.node_counts`) to `graph.nodes` and records
    `graph.copy_in`, `graph.replay` and `graph.clone_out` in `graph.call`."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from tpusph_torch.bench import spans
    from tpusph_torch.engine.graphs import GraphedLoop
    from tpusph_torch.kernels.graph_cond import node_counts

    spans.reset()
    loop = GraphedLoop(lambda inputs: [inputs[0] * 2 + 1, inputs[0].sum()], dev)
    x = torch.arange(8.0, device=dev)
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        loop([x])
    tot = spans.totals()
    assert tot["graph.warmup"].count == 1 and tot["graph.record"].count == 1
    nodes = node_counts(loop.graph.graph.raw_cuda_graph())["nodes"]
    assert nodes >= 2 and loop.graph.nodes == nodes
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for k in range(3):
            y = x + k
            assert torch.equal(loop([y])[0], y * 2 + 1)
    assert spans.counts() == {"graph.nodes": 3 * nodes}
    tot = spans.totals()
    names = ("graph.call", "graph.copy_in", "graph.replay", "graph.clone_out")
    assert {k: tot[k].count for k in tot} == dict.fromkeys(names, 3)
    torch.cuda.synchronize()
    spans.reset()


# ------------------------------------ ranks with peers: segments of graphs


def test_a_segmented_loop_replays_its_chain(dev):
    """A body split by a transport that goes through the host: on the card
    two segments and the transport between them, replayed bit for bit
    equal to the body run eagerly (sync debug mode "error" around each
    segment, not around the transport), each replay from new inputs."""
    from tpusph_torch.engine import graphs

    def transport(t):
        return [t.cpu().to(t.device) + 1]  # a copy to the host and back, as gloo's

    def body(inputs):
        (y,) = graphs.cross("exchange", transport, [inputs[0] * 2], [inputs[0]])
        return [y * 3]

    loop = graphs.SegmentedLoop(body, dev)
    for k in range(3):
        x = torch.arange(8.0, device=dev) + k
        got = loop([x])
        assert torch.equal(got[0], body([x])[0])
    assert loop.structure == ["segment", "exchange", "segment"]
    assert [type(item).__name__ for item in loop.chain] == [
        "CapturedGraph", "_Transport", "CapturedGraph"]


@pytest.mark.parametrize("engine", ["slab", "brick"])
def test_two_ranks_on_the_card_replay_segments(dev, engine, tmp_path):
    """Two ranks on the card over gloo, a z-slab line or a (2, 1, 1) brick
    grid (`torch_dist_ranks.card_graph_checks`): each graphed entry point
    against its `.eager` bit for bit after each of 3 calls, every segment
    replayed under sync debug mode "error", and each kernel launched once
    a replayed step, in the segment after the halo exchange."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_dist_ranks as ranks
    import torch_mesh3d_ranks as bricks

    from tpusph_torch.dist.comm import spawn_ranks

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cases = {"grid": ranks._as_numpy(init_state(ranks.dense_cfg(), device="cpu")),
             "blob": bricks.blob()}
    spawn_ranks(ranks.card_graph_checks, 2, f"file://{tmp_path}/store", dev, (cases, engine),
                300.0, shape=None if engine == "slab" else (2, 1, 1))


# ------------------------------------------- the device branch (graph_cond)


def _if_node_ran(pred, dev):
    """(ran, condition, node counts): one graph holding `set_if` on `pred`
    and an if node whose body writes 1 into a zeroed flag, replayed once;
    `ran` is the flag (the branch the card took), `condition` what
    `set_if` returned, the counts those of the graph's top level."""
    from tpusph_torch.kernels import graph_cond

    flag = torch.zeros((), dtype=torch.int32, device=dev)
    body = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body.capture_begin(pool=torch.cuda.graph_pool_handle())
        flag.fill_(1)
        body.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    parent = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(parent):
        flag.zero_()
        cond = graph_cond.set_if(pred, body.raw_cuda_graph())
    parent.instantiate()
    counts = graph_cond.node_counts(parent.raw_cuda_graph())
    parent.replay()
    torch.cuda.synchronize()
    return bool(flag), bool(cond), counts


@pytest.mark.parametrize("value", [-2, 0, 1, 5])
def test_set_if_node_runs_its_body_where_pred_holds(dev, value):
    """`set_if` (csrc/graph_cond.cu, a runtime of its own beside torch's)
    on a graph torch captures: the if node runs its body exactly where
    its plain version, pred > 0, holds; the graph holds one conditional
    node; one launch is counted at capture."""
    from tpusph_torch.kernels import graph_cond

    pred = torch.tensor(value, dtype=torch.int32, device=dev)
    before = graph_cond.set_if.launches
    ran, cond, counts = _if_node_ran(pred, dev)
    want = bool(graph_cond.set_if_plain(pred.cpu()))
    assert ran == cond == want
    assert counts["conditional"] == 1 and counts["kernel"] >= 1
    assert graph_cond.set_if.launches == before + 1


def test_device_if_in_a_graphed_loop(dev):
    """`graphs.device_if` in a graphed body on the card: the branch (a
    stable sort) runs in a conditional node only where the predicate
    holds at the replay, and each replay equals the plain version's
    select; one conditional node and one `set_if` launch a replay; outside
    a body's warm-up and capture it raises."""
    from tpusph_torch.engine import graphs
    from tpusph_torch.kernels import graph_cond

    def branch(cat):
        return torch.sort(cat, stable=True).indices

    def body(inputs):
        cat, pred = inputs
        alt = torch.arange(cat.numel(), device=cat.device)
        return [graphs.device_if(pred > 0, branch, (cat,), alt)]

    loop = graphs.GraphedLoop(body, dev)
    rng = np.random.default_rng(0)
    for k, value in enumerate((1, 0, 3, 0)):
        cat = torch.from_numpy(rng.integers(0, 4, 70_000).astype(np.uint8)).to(dev)
        pred = torch.tensor(value, device=dev)
        before = graph_cond.set_if.launches
        (got,) = loop([cat, pred])
        want = branch(cat) if value > 0 else torch.arange(cat.numel(), device=dev)
        assert torch.equal(got, want), k
        if k:
            assert graph_cond.set_if.launches == before + 1
    assert graph_cond.node_counts(loop.graph.graph.raw_cuda_graph())["conditional"] == 1
    with pytest.raises(RuntimeError, match="graphed body"):
        graphs.device_if(torch.tensor(True, device=dev), branch, (cat,), got)


def test_graphed_slab_run_branches_on_the_card(dev, monkeypatch):
    """One z-slab rank through the whole machinery at 4,096 grid init, a
    5-step `make_sharded_run`: the graphed run takes the skip on the card
    (one conditional node a step in its graph, branch counts (0, 5)) and
    equals its eager run and the graphed run with
    TPUSPH_DIST_FORCE_MIGSORT=1 (no conditional node, (5, 0)) bit for bit."""
    from tpusph_torch.dist import sharded
    from tpusph_torch.dist.comm import SlabComm
    from tpusph_torch.kernels import graph_cond

    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")
    n, steps = 4096, 5
    cfg = default_config(n, chunk_size=1024)
    comm = SlabComm(dev)
    dcfg = sharded.DistConfig(1, n, 1024, 256)
    start = sharded.distribute_state(init_state(cfg, device="cpu"), cfg, dcfg, comm)
    run = sharded.make_sharded_run(cfg, dcfg, comm, steps)
    ends = {}
    for forced, mode in (("0", "graphed"), ("0", "eager"), ("1", "graphed")):
        monkeypatch.setenv("TPUSPH_DIST_FORCE_MIGSORT", forced)
        before = sharded.migration_counts()
        ends[forced, mode] = run(start) if mode == "graphed" else run.eager(start)
        counts = tuple(b - a for a, b in zip(before, sharded.migration_counts()))
        assert counts == ((steps, 0) if forced == "1" else (0, steps)), (forced, mode, counts)
    for key in ends:
        (a, aux_a), (b, aux_b) = ends[key], ends["0", "eager"]
        assert [int(x) for x in aux_a] == [int(x) for x in aux_b], key
        assert all(torch.equal(x, y) for x, y in zip(a, b)), key
    for forced, want in (("0", steps), ("1", 0)):
        key = ("run", False, forced == "1")
        graph = run.graphs.loops[key].chain[0].graph
        assert graph_cond.node_counts(graph.raw_cuda_graph())["conditional"] == want, forced
