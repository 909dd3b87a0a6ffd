"""The benchmark's one-rank z-slab cell (`grid262k-sharded1`: loop
`sphbench/loops/distrun.py`, `DistSimulator.run` with the whole
machinery, then `collect_state`) on the CPU at 4,096 particles and 20
steps: correct against the plain reference by pid, not correct with a
fault planted under the loop, the dist engine's counters under a
profile, and no span or counter kept without one.

`plant(monkeypatch, loop_module, fault)` breaks the port under the loop:
`unchanged` (a run leaves the state as it came), `half` (the particles of
the upper half of the pids left where they were), `moved` (one particle
of the collect moved 1.0 along z, inside the falling column). The card's
study of the cell's limits plants the same faults through `run.execute`.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from sphbench import run
from sphbench.registry import Benchmark
from sphbench.window import Record
from tpusph_torch.bench import spans
from tpusph_torch.dist.sharded import DistConfig, DistState
from tpusph_torch.dist.simulator import DistSimulator

REPO = Path(__file__).resolve().parents[1]
CELL, REAL = "tiny-sharded1", "grid262k-sharded1"
N, STEPS, SEED = 4096, 20, 2**31 + 7
FAULTS = ("unchanged", "half", "moved")


def tiny_root(tmp: Path) -> Path:
    """A benchmark root beside the real one: its BENCHMARK.json and data
    folders, plus the cell's configuration at N particles and a cell of
    STEPS-step runs, with the real cell's limits and per-layer metrics."""
    src, dst = REPO / "sphbench", tmp / "sphbench"
    for sub in ("configs", "inits", "traffic", "loops", "metrics", "stages", "limits"):
        shutil.copytree(src / sub, dst / sub)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    real = next(w for w in spec["workloads"] if w["name"] == REAL)
    entry = next(c for c in spec["configs"] if c["name"] == real["config"])
    config = json.loads((REPO / entry["file"]).read_text())
    config.update(name="tiny-slab1", num_particles=N)
    (dst / "configs" / "tiny-slab1.json").write_text(json.dumps(config))
    spec["configs"].append({**entry, "name": "tiny-slab1",
                            "file": "sphbench/configs/tiny-slab1.json"})
    traffic = json.loads((src / "traffic" / f"{real['traffic']}.json").read_text())
    traffic.update(steps=STEPS, trace_runs=2)
    (dst / "traffic" / f"distrun{STEPS}.json").write_text(json.dumps(traffic))
    spec["workloads"].append({**real, "name": CELL, "config": "tiny-slab1",
                              "traffic": f"distrun{STEPS}"})
    shutil.copy(src / "limits" / f"{REAL}.json", dst / "limits" / f"{CELL}.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def plant(monkeypatch, loop_module, fault: str) -> None:
    """Break the port underneath the loop `loop_module` (see the module's
    docstring)."""
    if fault == "moved":
        real_collect = loop_module.collect_state

        def collect(state, num_particles, comm):
            got = real_collect(state, num_particles, comm)
            pos = got["position"]
            y = torch.from_numpy(pos[:, 1])
            i = int(torch.argsort(y)[int(0.9 * len(y))])
            pos[i, 2] += 1.0 if pos[i, 2] < 5.0 else -1.0
            return got

        monkeypatch.setattr(loop_module, "collect_state", collect)
        return
    simulator = loop_module.DistSimulator
    real_run = simulator.run

    def broken(self, steps, *args, **kwargs):
        before = self.state
        real_run(self, steps, *args, **kwargs)
        if fault == "unchanged":
            self.state = before
            return
        after = DistState(*(t.clone() for t in self.state))
        slot = torch.full((self.cfg.num_particles,), -1, dtype=torch.long,
                          device=before.pid.device)
        slot[before.pid[before.valid].long()] = torch.nonzero(before.valid).flatten()
        rows = after.valid & (after.pid >= self.cfg.num_particles // 2)
        src = slot[after.pid[rows].long()]
        after.position[rows] = before.position[src]
        after.velocity[rows] = before.velocity[src]
        self.state = after

    monkeypatch.setattr(simulator, "run", broken)


@pytest.fixture
def bench(tmp_path, monkeypatch):
    """The throwaway root's Benchmark; the loop's machinery switch and the
    spans are this test's alone."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")
    spans.reset()
    yield Benchmark(tiny_root(tmp_path))
    spans.reset()


def test_the_cell_is_correct_by_pid_and_never_writes_its_start(bench):
    """The whole run but the look for a card, on the CPU (the kernels'
    plain versions): correct by every number; the start block is the same
    after the runs, so every run starts from it."""
    out = run.execute(bench, CELL, SEED, 0.0, False, device="cpu")
    assert out.line["correct"] is True, out.err
    assert out.line["failed"] == 0 and out.line["attempted"] >= 1
    assert set(out.line["compared"]) == {"position_gap_max", "position_gap_p99",
                                         "velocity_gap_max", "velocity_gap_p99"}
    assert all(v < 1e-6 for v in out.numbers.values()), out.numbers
    cell = bench.cell(CELL)
    loop_module = bench.loop(cell.traffic["loop"])
    start = bench.init(cell.config["init"]).start(cell.config, SEED, "cpu")
    loop = loop_module.Loop(cell.config, cell.traffic, start, "cpu")
    block = [t.clone() for t in loop.state0]
    first = loop.run(Record())
    second = loop.run(Record())
    assert all(torch.equal(a, b) for a, b in zip(block, loop.state0))
    assert (first["position"] == second["position"]).all()
    assert first["position"] is not second["position"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(bench, monkeypatch, fault):
    plant(monkeypatch, bench.loop("distrun"), fault)
    out = run.execute(bench, CELL, SEED, 0.0, False, device="cpu")
    assert out.line["correct"] is False, out.err
    assert out.numbers["position_gap_max"] >= 0.1, out.numbers


def test_the_traced_run_reads_the_dist_counters(bench):
    """Under a CPU profile: every step skips the sort, the rows fill
    N / dev_capacity of the rank, nothing grew, and the collect has its
    span once a run."""
    out = run.execute(bench, CELL, SEED, 0.0, True, device="cpu")
    line, counts = out.line, spans.counts()
    assert line["correct"] is True, out.err
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    capacity = counts["dist.rows_capacity"] // line["attempted"]
    assert capacity == 2 * N  # default_dist_config's slack on one rank
    assert metrics["dist.skip_share"] == 1.0
    assert metrics["dist.row_fill"] == N / capacity
    assert metrics["dist.collect_ms"] > 0
    assert counts.get("dist.regrows", 0) == 0
    assert counts["dist.steps"] == line["attempted"] * STEPS
    assert counts["dist.migration_skips"] == line["attempted"] * STEPS
    totals = spans.totals()
    assert totals["dist.run"].count == totals["dist.aux"].count == line["attempted"]
    assert totals["dist.collect"].count == line["attempted"]


def test_no_profile_keeps_no_dist_span_or_counter(bench):
    cell = bench.cell(CELL)
    start = bench.init(cell.config["init"]).start(cell.config, SEED, "cpu")
    loop = bench.loop("distrun").Loop(cell.config, cell.traffic, start, "cpu")
    loop.run(Record())
    kept = [*spans.totals(), *spans.counts()]
    assert not [k for k in kept if k.startswith("dist.")], kept


def test_growth_and_the_timed_phases_have_their_spans(monkeypatch):
    """A halo buffer of 8 rows overflows at the first chunk: it grows
    (`dist.grow`, counter `dist.regrows`) and the chunk runs again; then
    a timed step's two phases (`dist.build`, `dist.update`)."""
    from torch.profiler import ProfilerActivity, profile

    from tpusph_torch.bench.times import Times
    from tpusph_torch.core.config import tuned_config

    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")
    cfg = tuned_config(N)
    sim = DistSimulator(cfg, dcfg=DistConfig(1, 2 * N, 8, 128), device="cpu")
    sim.setup()
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            sim.run(2)
            sim.simulate_and_time(Times())
        totals, counts = spans.totals(), spans.counts()
    finally:
        spans.reset()
    assert sim.dcfg.halo_capacity > 8
    assert counts["dist.regrows"] == totals["dist.grow"].count >= 1
    assert totals["dist.run"].count == 1 and totals["dist.aux"].count == counts["dist.regrows"] + 1
    assert counts["dist.steps"] == 2
    assert totals["dist.build"].count == totals["dist.update"].count == 1
    assert totals["dist.collect"].count == 1  # the timed step's get_position
