"""The force pass's walk counter (`kernels/fused.py::force(..., walk=)`,
`force_walk`) and the timed path with the pressure live, on the CPU.

`force_walk` against a count by brute force over every (target, row)
pair of the sorted keys; `force` fills a counter as the kernel does (sums
added, the heaviest block as a max) and gives the same forces with one or
without; the timed step copies the counter beside its positions only while
a profile records, and the counters `force.*` then sum each step's walk.

The timed path under pressure: `Simulator.simulate_and_time` for 10 steps
from a clustered state whose pressure is live from step 0
(`torch_pressured.py`), against the benchmark's plain reference
(`sphbench/reference/sph.py`), which shares no code with the port. Small N,
one thread.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)
from torch_pressured import SCENE, clustered_state  # noqa: E402

from sphbench.reference import sph  # noqa: E402
from tpusph_torch.bench import spans  # noqa: E402
from tpusph_torch.bench.times import Times  # noqa: E402
from tpusph_torch.core.config import default_config  # noqa: E402
from tpusph_torch.core.init import init_state  # noqa: E402
from tpusph_torch.engine.simulator import Simulator  # noqa: E402
from tpusph_torch.engine.step import build_phase, make_step, masked_pressure  # noqa: E402
from tpusph_torch.kernels import fused  # noqa: E402

STEPS = 10


def _sorted(kind):
    """(cfg, cell list, xyz, vxyz, rho, p) of sorted rows: grid init at
    4,096; a random state; the clustered state (pressure live) at 4,096;
    and the clustered state at 1,000 rows padded to 1,100 (sentinel rows,
    a last block of 76 targets)."""
    if kind in ("grid", "random"):
        cfg = default_config(2048 if kind == "random" else 4096, chunk_size=1024)
        st = init_state(cfg, random_init=kind == "random", seed=5, device="cpu")
    else:
        n, padded = (4096, None) if kind == "pressured" else (1000, 1100)
        cfg, st = clustered_state(n, padded)
    g = torch.Generator().manual_seed(1)
    st.velocity[st.valid] = torch.randn((int(st.valid.sum()), 3), generator=g) * 0.3
    cl = build_phase(st, cfg)
    xyz = st.position[cl.perm].T.contiguous()
    vxyz = st.velocity[cl.perm].T.contiguous()
    raw = fused.density(*xyz, cl.key_sorted, cl.starts, cfg)
    rho, p = masked_pressure(raw, cl.valid_sorted, cfg)
    return cfg, cl, xyz, vxyz, rho, p


def _brute(key, p, cfg):
    """(candidates, pressured, heaviest block) by testing every row's key
    against each live target's 9 key ranges [k+off-1, k+off+2), clipped to
    [0, num_cells), one target at a time."""
    key, p = key.long().numpy(), p.numpy()
    nc = cfg.num_cells
    per = np.zeros(len(key), np.int64)
    for i, k in enumerate(key):
        if k >= nc:
            continue
        for off in fused.column_offsets(cfg):
            lo = min(max(k + off - 1, 0), nc)
            hi = min(max(k + off + 2, lo), nc)
            per[i] += int(((key >= lo) & (key < hi)).sum())
    pressured = sum(1 for k, q in zip(key, p) if k < nc and q > 0)
    blocks = [int(per[b:b + fused.FORCE_TILE].sum()) for b in range(0, len(key), fused.FORCE_TILE)]
    return int(per.sum()), pressured, max(blocks)


@pytest.mark.parametrize("kind", ["grid", "random", "pressured", "padded"])
def test_force_walk_equals_a_brute_force_count(kind):
    cfg, cl, _, _, _, p = _sorted(kind)
    got = fused.force_walk(cl.key_sorted, cl.starts, p, cfg)
    assert got.dtype == torch.int64 and got.shape == (len(fused.WALK),)
    assert tuple(got.tolist()) == _brute(cl.key_sorted, p, cfg)
    n = cl.key_sorted.numel()
    assert fused.force_blocks(n) == -(-n // 128)
    if kind == "padded":
        assert n % fused.FORCE_TILE and bool((cl.key_sorted >= cfg.num_cells).any())
    if kind in ("pressured", "padded"):
        assert got[1] > 0  # the pressure is live
    else:
        assert got[1] == 0  # rho << rho0 away from the pile


def test_force_adds_its_walk_to_a_counter_and_keeps_its_forces():
    cfg, cl, xyz, vxyz, rho, p = _sorted("pressured")
    args = (*xyz, *vxyz, rho, p, cl.key_sorted, cl.starts, cfg)
    want = fused.force_walk(cl.key_sorted, cl.starts, p, cfg)
    walk = torch.zeros(len(fused.WALK), dtype=torch.int64)
    f = fused.force(*args, walk=walk)
    assert torch.equal(walk, want)
    assert torch.equal(f, fused.force(*args))
    fused.force(*args, walk=walk)  # sums add, the heaviest block stays the max
    assert walk.tolist() == [2 * want[0], 2 * want[1], want[2]]
    with pytest.raises(TypeError):
        fused.force(*args, walk=walk.int())


@pytest.fixture(scope="module")
def timed():
    """10 timed steps from the clustered state at 4,096 while a profile's
    flag is up: each step's pre-step state, the counters, the positions
    and density after; and the reference's 10 steps from the same state,
    in float32 and in bfloat16."""
    cfg, start = clustered_state(4096)
    n = cfg.num_particles
    spans.reset()
    sim = Simulator(cfg, device="cpu")
    sim.setup(start)
    before = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
        times = Times()
        for _ in range(STEPS):
            before.append(sim.state)
            sim.simulate_and_time(times)
        pos = sim.get_position().copy()
    counts = spans.counts()
    spans.reset()
    config = {**SCENE, "pi": 3.14159265}
    ref = {dtype: sph.run(start.position[:n], config, STEPS, dtype=dtype)
           for dtype in (torch.float32, torch.bfloat16)}
    return dict(cfg=cfg, before=before, counts=counts, pos=pos, sim=sim,
                density=sim.state.density[:n].clone(), pressure=sim.state.pressure[:n].clone(),
                ref=ref)


def _gaps(pos, density, ref):
    d = np.linalg.norm(pos.astype(np.float64) - ref["position"].double().numpy(), axis=1)
    want = ref["density"].double().numpy()
    rel = np.abs(density.double().numpy() - want) / want
    return d.max(), np.percentile(d, 99), rel.max(), np.percentile(rel, 99)


def test_the_timed_path_under_pressure_agrees_with_the_reference(timed):
    """Bars: positions within 2e-5 at the widest and 2e-6 at the 99th
    percentile, density within 1e-4 relative at the widest and 2e-5 at the
    99th percentile. The two sum each target's terms in other orders, a few
    float32 roundings a step; over 10 steps under pressure (forces ~1e3)
    that reads 1.7e-6 / 3.4e-7 in position and 1.2e-5 / 2.6e-6 in density
    here, so the bars leave ~10x room. The reference in bfloat16 fails
    every bar by orders of magnitude."""
    assert timed["before"][0].pressure.numel() and float(timed["pressure"].max()) > 0
    assert int((timed["pressure"] > 0).sum()) > 1000  # pressured at step 10 as well
    bars = (2e-5, 2e-6, 1e-4, 2e-5)
    got = _gaps(timed["pos"], timed["density"], timed["ref"][torch.float32])
    assert all(g <= b for g, b in zip(got, bars)), got
    low = _gaps(timed["pos"], timed["density"], timed["ref"][torch.bfloat16])
    assert all(g > 10 * b for g, b in zip(low, bars)), low


def test_the_timed_steps_count_each_steps_walk(timed):
    """Each step's counter is the walk of its own pre-step state, and the
    counters sum them: the copy of the last step's counter is waited for
    by `get_position`."""
    cfg = timed["cfg"]
    want = torch.zeros(len(fused.WALK), dtype=torch.int64)
    blocks = 0
    for st in timed["before"]:
        cl = build_phase(st, cfg)
        xyz = st.position[cl.perm].T.contiguous()
        _, p = masked_pressure(fused.density(*xyz, cl.key_sorted, cl.starts, cfg),
                               cl.valid_sorted, cfg)
        got = fused.force_walk(cl.key_sorted, cl.starts, p, cfg)
        want[:2] += got[:2]
        want[2] += got[2]
        blocks += fused.force_blocks(cl.key_sorted.numel())
    counts = timed["counts"]
    assert [counts[f"force.{k}"] for k in fused.WALK] == want.tolist()
    assert counts["force.blocks"] == blocks == STEPS * fused.force_blocks(4096)
    assert counts["force.pressured"] > 0


def test_the_walk_is_counted_only_while_a_profile_records(monkeypatch):
    """No profile: a timed step copies no counter and counts nothing. With
    one, the timed steps count, and the untimed step and the fields chain,
    which pass no counter, count nothing."""
    cfg = default_config(512, chunk_size=512)
    spans.reset()
    sim = Simulator(cfg, device="cpu")
    sim.setup()
    sim.simulate_and_time(Times())
    assert sim._pending_fetch._walk is None
    sim.get_position()
    assert spans.counts() == {}
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    sim.simulate()
    make_step(cfg, "kernels", "cpu")(sim.state)
    assert not [k for k in spans.counts() if k.startswith("force.")]
    sim.simulate_and_time(Times())
    sim.get_position()
    assert spans.counts()["force.blocks"] == fused.force_blocks(512)
    spans.reset()
