"""The end-to-end metrics are taken over all runs and steps of the window,
the trace's reduction, and the rooflines' work counts."""

from __future__ import annotations

import re

import pytest
import torch

from sphbench import counts, stats, trace
from sphbench.window import Record
from sphbench.reference import sph
from sphbench.registry import Benchmark
from sphbench.run import RunData


def data(**kw) -> RunData:
    rec = Record(**kw)
    return RunData(record=rec, setup_s=7.5, capture_s=1.25, n=8)


def read(name, run):
    return Benchmark().reader(name)(run)


def test_percentile_is_over_every_sample():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2


def test_rate_and_tails_take_all_runs_and_steps():
    run_s = [0.040] * 90 + [0.050] * 9 + [0.200]  # one slow run in a hundred
    step_s = [0.001] * 1900 + [0.010] * 100
    run = data(runs=100, steps=10_000, run_s=run_s, step_s=step_s, window_s=5.0)
    assert read("timesteps_per_s", run) == pytest.approx(2000.0)
    assert read("run_ms_p95", run) == pytest.approx(50.0)
    assert read("step_ms_p95", run) == pytest.approx(stats.percentile(step_s, 95) * 1e3)
    assert read("step_ms_p95", data(run_s=run_s)) is None  # the chain has no steps timed
    assert read("setup_s", run) == 7.5 and read("graph.capture_s", run) == 1.25


def test_simulator_phase_metrics_read_times():
    run = data()
    run.record.times.build_grid, run.record.times.sph_update = 0.2, 0.3
    run.record.times.memcpy, run.record.times.iters = 0.1, 1000
    assert read("sim.compute_ms", run) == pytest.approx(0.5)
    assert read("sim.copy_ms", run) == pytest.approx(0.1)
    assert read("sim.copy_ms", data()) is None


STAGES = {"build": [re.compile("sort"), re.compile("qrank")],
          "density": [re.compile("density_tile")], "force": [re.compile("force_tile")]}


def test_trace_reduction_busy_stages_and_gaps():
    ev = [
        (trace.WINDOW, 0.0, 100.0, False),
        ("sphbench.launch", 0.0, 10.0, False),
        ("cudaStreamSynchronize", 10.0, 90.0, False),
        ("sphbench.get_position", 90.0, 100.0, False),
        ("radix sort", 5.0, 20.0, True),
        ("qrank_block_kernel", 15.0, 25.0, True),  # overlaps the sort
        ("density_tile_kernel", 40.0, 50.0, True),
        ("force_tile_kernel", 50.0, 70.0, True),
        ("memcpy", 95.0, 120.0, True),  # clipped to the window
        ("outside", 200.0, 210.0, True),
    ]
    s = trace.summarize(ev, STAGES)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((20 + 30 + 5) * 1e-6)
    assert s.device_s == pytest.approx((15 + 10 + 10 + 20 + 5) * 1e-6)
    assert s.by_stage == pytest.approx({"build": 25e-6, "density": 10e-6, "force": 20e-6})
    assert s.idle_by_host == pytest.approx({"sphbench.launch": 5e-6,
                                            "cudaStreamSynchronize": 40e-6})
    b = s.breakdown()
    assert b["device_ops"][0] == ["force_tile_kernel", pytest.approx(20e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    run = data(steps=10, runs=1)
    run.trace = s
    assert read("step.device_ms", run) == pytest.approx(60e-6 / 10 * 1e3)
    assert read("build.device_ms", run) == pytest.approx(25e-6 / 10 * 1e3)
    assert read("device.idle", run) == pytest.approx(45.0)


def test_a_kernel_in_two_stages_is_an_error():
    ev = [(trace.WINDOW, 0.0, 10.0, False), ("qrank density_tile", 1.0, 2.0, True)]
    with pytest.raises(RuntimeError, match="matches the stages"):
        trace.summarize(ev, STAGES)


def hand_pairs(points):
    """Ordered pairs within h by hand: (density, force)."""
    pos = torch.tensor(points, dtype=torch.float32)
    config = {"h": 0.1, "num_cells_per_dim": 100, "dt": 0.01, "mass": 0.02,
              "gas_constant": 1.0, "rest_density": 1000.0, "viscosity": 1.0, "gravity": -9.8,
              "elasticity": 0.5, "eps": 1e-4, "pi": 3.14159265, "box_dim": 10.0}
    return sph.run(pos, config, 1)["pairs"][0]


def test_pairs_within_h_three_particles():
    # 0-1 at 0.05 (within h), 1-2 at 0.15 and 0-2 at 0.2 (not): self 3 + 2 ordered
    assert hand_pairs([[1.0, 1.0, 1.0], [1.05, 1.0, 1.0], [1.2, 1.0, 1.0]]) == (5, 2)


def test_pairs_within_h_27_particle_lattice():
    # 3x3x3 at 0.09: face neighbours within h, diagonals (0.127) not.
    # 3 axes x 9 lines x 2 edges = 54 edges = 108 ordered pairs, + 27 self
    pts = [[2.0 + 0.09 * i, 2.0 + 0.09 * j, 2.0 + 0.09 * k]
           for i in range(3) for j in range(3) for k in range(3)]
    assert hand_pairs(pts) == (135, 108)


def test_least_time_takes_what_binds():
    peaks = {"bytes_per_s": 1e12, "flops_per_s": 1e12}
    # density: 1000 particles read 16 KB (16 ns); 100 pairs x 12 + 1000 = 2200 ops
    t, what = counts.least_time("density", 1000, 100, peaks)
    assert (t, what) == (pytest.approx(16e-9), "bytes")
    t, what = counts.least_time("force", 10, 10_000, peaks)
    assert what == "operations"
    assert t == pytest.approx((10_000 * counts.FORCE_FLOPS_PER_PAIR + 90) / 1e12)
    total, binds = counts.least_seconds("density", 1000, [(100, 50), (10**6, 10**6)], 3, peaks)
    assert binds == {"bytes": 3, "operations": 3}
    assert total == pytest.approx(3 * (16e-9 + (10**6 * 12 + 1000) / 1e12))


def test_roofline_reader_needs_its_kernels_and_the_peaks():
    run = data(runs=2, steps=2)
    run.pairs = [(100, 60)]
    run.peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert read("density_roofline", run) is None  # no trace
    run.trace = trace.summarize([(trace.WINDOW, 0.0, 10.0, False),
                                 ("density_tile_kernel", 1.0, 2.0, True)], STAGES)
    least, _ = counts.least_seconds("density", 8, run.pairs, 2, run.peaks)
    assert read("density_roofline", run) == pytest.approx(100 * least / 1e-6)
    assert read("force_roofline", run) is None  # no force kernel in the trace
