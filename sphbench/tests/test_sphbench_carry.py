"""The reader of the port's counter `graph.carried` (`metrics/graph.carry_share`)
against recorder contents made by hand, on a port without the recorder, and
through a traced run of the tiny timed cell on the CPU, where the timed
phases carry their state only when a test turns the carry on."""

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
from tpusph_torch.engine.simulator import Simulator


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
    return Benchmark().reader("graph.carry_share")(run_data)


def test_the_share_is_the_carried_steps_over_the_steps(tracing):
    for _ in range(3):  # three runs of 100 steps, each copying its start state in
        spans.count("graph.carried", 99)
    assert read(data(steps=300)) == pytest.approx(0.99)
    assert read(data(steps=0)) is None


def test_nothing_counted_reads_none(tracing):
    spans.count("graph.nodes", 70)
    assert read(data(steps=100)) is None


def test_a_port_without_the_recorder_reads_none(tracing, monkeypatch):
    spans.count("graph.carried", 99)
    import tpusph_torch.bench

    monkeypatch.setitem(sys.modules, "tpusph_torch.bench.spans", None)
    monkeypatch.delattr(tpusph_torch.bench, "spans")
    assert read(data(steps=100)) is None


@pytest.mark.parametrize("carry", [False, True])
def test_a_traced_timed_run_reports_the_share_where_it_carries(tiny, monkeypatch, carry):
    """On the CPU the timed phases carry nothing (no graph) and the share is
    not reported; with the carry turned on, each 20-step run copies its
    start state in once (`graph.io_ms` reads) and carries 19 steps."""
    make = Simulator._timed_phases

    def phases(self):
        loop = make(self)
        loop.carry = carry
        return loop

    monkeypatch.setattr(Simulator, "_timed_phases", phases)
    line = run.execute(Benchmark(tiny), "tiny-timed", 12, 0.2, True, device="cpu").line
    got = line["metrics"]
    assert line["correct"]
    if carry:
        assert got["graph.carry_share"]["value"] == pytest.approx(19 / 20)
        assert got["graph.io_ms"]["value"] > 0
    else:
        assert not {"graph.carry_share", "graph.io_ms"} & set(got)
