"""The reader of the port's counter `sim.copy_overlapped`
(`metrics/sim.copy_overlap_share`) against recorder contents made by hand,
on a port without the recorder, and through a traced run of each tiny cell
on the CPU, where the kernels' timed step starts every copy under the
update."""

from __future__ import annotations

import sys

import pytest
import torch

from sphbench import run
from sphbench.registry import Benchmark
from sphbench.run import RunData
from sphbench.window import Record
from tpusph_torch.bench import spans
from tpusph_torch.bench.times import Times

NAME = "sim.copy_overlap_share"


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def tracing(monkeypatch):
    """The recorder as while a profile records (its flag alone)."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)


def data(steps: int) -> RunData:
    return RunData(record=Record(steps=steps, times=Times()), setup_s=9.0, capture_s=1.0, n=8)


def read(run_data):
    return Benchmark().reader(NAME)(run_data)


@pytest.mark.parametrize("steps,overlapped,want", [(300, 300, 1.0), (400, 300, 0.75),
                                                   (200, 1, 0.005)])
def test_the_share_is_the_overlapped_steps_over_the_steps(tracing, steps, overlapped, want):
    for _ in range(overlapped):
        spans.count("sim.copy_overlapped", 1)
    assert read(data(steps)) == pytest.approx(want)
    assert read(data(steps=0)) is None


def test_no_counter_reads_none(tracing):
    assert read(data(steps=100)) is None
    spans.count("graph.carried", 99)
    assert read(data(steps=100)) is None


def test_a_port_without_the_recorder_reads_none(tracing, monkeypatch):
    spans.count("sim.copy_overlapped", 100)
    import tpusph_torch.bench

    monkeypatch.setitem(sys.modules, "tpusph_torch.bench.spans", None)
    monkeypatch.delattr(tpusph_torch.bench, "spans")
    assert read(data(steps=100)) is None


@pytest.mark.parametrize("cell", ["tiny-chain", "tiny-timed"])
def test_a_traced_run_reports_the_share_where_the_simulator_runs(tiny, cell):
    """Every traced timed step counts (share 1.0); the chain runs no timed
    step and reports nothing."""
    line = run.execute(Benchmark(tiny), cell, 12, 0.2, True, device="cpu").line
    got = line["metrics"]
    assert line["correct"]
    if cell == "tiny-timed":
        assert got[NAME]["value"] == 1.0
    else:
        assert NAME not in got
