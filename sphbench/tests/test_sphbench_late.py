"""The late start state (`inits/late.py`), the readers of the force pass's
walk (`metrics/force.*.py`), and the cell `late262k-timed20` rehearsed on
the CPU at 4,096 particles: a copy of its configuration with 3 reference
steps of set-up and rho0 = 20, so that the grid init (rho ~ 32) is under
pressure at that size, through the path that decides `correct`."""

from __future__ import annotations

import json
import shutil
import sys

import pytest
import torch

from sphbench import run
from sphbench.registry import Benchmark
from sphbench.run import RunData
from sphbench.window import Record
from tpusph_torch.bench import spans
from tpusph_torch.bench.times import Times

from conftest import REPO, TINY, tiny_root

READERS = ("force.candidates_per_pair", "force.block_skew", "force.ns_per_candidate",
           "force.pressured_share")
CELL = "late262k-timed20"


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def tracing(monkeypatch):
    """The recorder as while a profile records (its flag alone)."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)


def small(**kw) -> dict:
    c = json.loads((REPO / "sphbench" / "configs" / "dambreak-late-262k.json").read_text())
    c.update(num_particles=TINY, start_steps=3, **kw)
    return c


def test_the_configuration_is_the_grid_scene_from_a_later_state():
    late = json.loads((REPO / "sphbench" / "configs" / "dambreak-late-262k.json").read_text())
    grid = json.loads((REPO / "sphbench" / "configs" / "dambreak-grid-262k.json").read_text())
    changed = {k for k in grid if late[k] != grid[k]}
    assert changed == {"name", "source", "init", "assumed", "deployment"}
    assert late["init"] == "late" and late["start_steps"] == 120
    assert set(late["reduced"]) <= set(late["assumed"]) and "start_steps" in late["assumed"]
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("dambreak-late-262k", "timed20", 1)
    mix = json.loads((REPO / "sphbench" / "traffic" / "timed20.json").read_text())
    assert mix == {"loop": "timed", "steps": 20, "trace_runs": 15}
    limits = Benchmark().cell(CELL).limits
    assert {"position_gap_p99", "density_gap_p99"} <= set(limits)


def test_the_late_start_is_the_seeds_reference_state():
    late = Benchmark().init("late")
    a, again, other = (late.state(small(), s, "cpu") for s in (7, 7, 8))
    assert all(torch.equal(a[k], again[k]) for k in a)
    assert not torch.equal(a["position"], other["position"])
    assert a["velocity"].abs().max() > 0  # the reference has run: the column falls
    live = small(rest_density=20.0)  # rho ~ 32: under pressure from the first step
    got, want = late.start(live, 7, "cpu"), late.state(live, 7, "cpu")
    assert set(got) == {"position", "velocity"}
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert not torch.equal(got["position"], a["position"])  # the pressure has acted


def test_the_late_start_raises_without_pressure():
    """Three steps from grid init leave rho ~ 32, far below rho0 = 1000."""
    with pytest.raises(ValueError, match="no pressure at the start state"):
        Benchmark().init("late").start(small(), 7, "cpu")


def data(steps: int, runs: int = 1, n: int = 8, pairs=None, force_s=None) -> RunData:
    d = RunData(record=Record(steps=steps, runs=runs, times=Times()), setup_s=9.0,
                capture_s=1.0, n=n, pairs=pairs)
    if force_s is not None:
        from sphbench.trace import TraceSummary

        d.trace = TraceSummary(1.0, 0.5, 0.5, {}, {"force": force_s}, {})
    return d


def read(name, run_data):
    return Benchmark().reader(name)(run_data)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_without_its_counters_reads_none(tracing, name):
    run_data = data(steps=20, pairs=[(30, 20)] * 20, force_s=1e-3)
    spans.count("graph.nodes", 70)
    assert read(name, run_data) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_recorder_reads_none(tracing, monkeypatch, name):
    for k in ("candidates", "pressured", "block_max", "blocks"):
        spans.count(f"force.{k}", 5)
    import tpusph_torch.bench

    monkeypatch.setitem(sys.modules, "tpusph_torch.bench.spans", None)
    monkeypatch.delattr(tpusph_torch.bench, "spans")
    assert read(name, data(steps=20, pairs=[(30, 20)] * 20, force_s=1e-3)) is None


def test_the_readers_sum_the_window(tracing):
    """Two runs of two steps over 8 particles in two blocks: the reference
    counts 10 then 14 force pairs a step; the kernel walked 60 candidates
    a step, 40 of them in its heaviest block, with 3 then 1 targets
    pressured; its stage took 12 us."""
    for pressured in (3, 1, 3, 1):
        for k, v in (("candidates", 60), ("pressured", pressured), ("block_max", 40),
                     ("blocks", 2)):
            spans.count(f"force.{k}", v)
    run_data = data(steps=4, runs=2, pairs=[(15, 10), (20, 14)], force_s=12e-6)
    assert read("force.candidates_per_pair", run_data) == pytest.approx(240 / 48)
    assert read("force.block_skew", run_data) == pytest.approx(40 / 30)
    assert read("force.ns_per_candidate", run_data) == pytest.approx(12e3 / 240)
    assert read("force.pressured_share", run_data) == pytest.approx(8 / 32)


def test_no_pressure_reads_a_share_of_zero(tracing):
    for k, v in (("candidates", 60), ("pressured", 0), ("block_max", 40), ("blocks", 2)):
        spans.count(f"force.{k}", v)
    assert read("force.pressured_share", data(steps=1)) == 0.0


@pytest.fixture
def late_root(tmp_path):
    """A benchmark root with the cell `tiny-late`: the late configuration at
    4,096 particles, 3 steps of set-up, rho0 = 20; runs of 10 timed steps,
    2 traced; the late cell's limits."""
    root = tiny_root(tmp_path)
    src = root / "sphbench"
    (src / "configs" / "tiny-late.json").write_text(
        json.dumps(small(name="tiny-late", rest_density=20.0)))
    (src / "traffic" / "late10.json").write_text(
        json.dumps({"loop": "timed", "steps": 10, "trace_runs": 2}))
    shutil.copy(src / "limits" / f"{CELL}.json", src / "limits" / "tiny-late.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][-1], "name": "tiny-late",
                            "file": "sphbench/configs/tiny-late.json"})
    spec["workloads"].append({"name": "tiny-late", "config": "tiny-late", "traffic": "late10",
                              "chips": 1, "why": "a test's throwaway"})
    for m in spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-late")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_the_late_cell_rehearsed_on_the_cpu(late_root, traced):
    """The whole run but the look for a card: correct by the late cell's
    limits; traced, the three readers of the port's counters report, with
    the pressure live, and `force.ns_per_candidate`, which needs the
    card's kernels in the trace, reads nothing on the CPU."""
    out = run.execute(Benchmark(late_root), "tiny-late", 2**31 + 9, 0.2, traced, device="cpu")
    line = out.line
    assert line["correct"] and line["failed"] == 0, out.err
    assert set(line["compared"]) == set(Benchmark().cell(CELL).limits)
    got = line["metrics"]
    if not traced:
        assert {"timesteps_per_s", "setup_s"} <= set(got)
        return
    assert line["attempted"] == 2, got
    assert set(READERS) & set(got) == set(READERS) - {"force.ns_per_candidate"}, got
    assert 0 < got["force.pressured_share"]["value"] <= 1
    assert got["force.candidates_per_pair"]["value"] > 1
    assert got["force.block_skew"]["value"] >= 1
