"""The readers of the port's spans and counter (`metrics/graph.*`,
`metrics/sim.copy_wait_ms`, `metrics/sim.copy_start_ms`) against recorder
contents made by hand, on a port without the recorder, and through a traced
run of each tiny cell on the CPU."""

from __future__ import annotations

import math
import sys

import pytest
import torch

from sphbench import run
from sphbench.registry import Benchmark
from sphbench.run import RunData
from sphbench.window import Record
from tpusph_torch.bench import spans
from tpusph_torch.bench.times import Times

PER_STEP = ("graph.io_ms", "graph.self_ms", "graph.nodes", "sim.copy_wait_ms",
            "sim.copy_start_ms")
SETUP = ("graph.warmup_s", "graph.record_s")
READERS = PER_STEP + SETUP


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def tracing(monkeypatch):
    """The recorder as while a profile records (its flag alone)."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)


def data(steps: int, times: Times | None = None) -> RunData:
    return RunData(record=Record(steps=steps, times=times or Times()), setup_s=9.0,
                   capture_s=1.0, n=8)


def read(name, run):
    return Benchmark().reader(name)(run)


def _span(name, start, end):
    with spans.span(name, start, always=True) as s:
        s.end = end


def test_readers_divide_the_window_by_its_steps(tracing):
    ms = 1e-3  # s
    for k in range(4):  # four replays of a graphed loop, 2 ms apart
        t = 10 * ms * k
        with spans.span("graph.call", t) as call:
            _span("graph.copy_in", t, t + ms / 4)
            _span("graph.replay", t + ms / 4, t + ms)
            spans.count("graph.nodes", 70)
            _span("graph.clone_out", t + ms, t + ms + ms / 2)
            call.end = t + 2 * ms
    _span("graph.warmup", 100 * ms, 400 * ms)
    _span("graph.record", 400 * ms, 450 * ms)
    run = data(steps=400)
    assert read("graph.io_ms", run) == pytest.approx(4 * 0.75 / 400)
    assert read("graph.self_ms", run) == pytest.approx(4 * 0.5 / 400)
    assert read("graph.nodes", run) == pytest.approx(4 * 70 / 400)
    assert read("graph.warmup_s", run) == pytest.approx(0.3)
    assert read("graph.record_s", run) == pytest.approx(0.05)
    assert read("graph.warmup_s", data(steps=1)) == read("graph.warmup_s", run)  # not per step
    assert read("sim.copy_wait_ms", run) is None and read("sim.copy_start_ms", run) is None
    for name in PER_STEP[:3]:
        assert read(name, data(steps=0)) is None


def test_copy_parts_make_the_copy_from_the_same_reads(tracing):
    """`sim.copy_wait_ms + sim.copy_start_ms == sim.copy_ms` where the spans
    and `Times` take the same clock reads, as the simulator's step does."""
    times = Times()
    t = 1234.5678  # s, as a host clock reads
    for k in range(100):
        t2, tw, t3 = t, t + 1.234e-6 + 1.7e-8 * k, t + 9.1011e-5 + 3e-9 * k * k
        with spans.span("sim.copy_wait", t2) as s:
            s.end = tw
        with spans.span("sim.copy_start", s.end) as s:
            s.end = t3
        times.memcpy += t3 - t2
        times.iters += 1
        t = t3 + 5e-4
    run = data(steps=100, times=times)
    got = read("sim.copy_wait_ms", run) + read("sim.copy_start_ms", run)
    assert math.isclose(got, read("sim.copy_ms", run), rel_tol=1e-12)


def test_nothing_recorded_reads_none(tracing):
    run = data(steps=100, times=Times(memcpy=0.1, iters=100))
    for name in READERS:
        assert read(name, run) is None, name


def test_a_port_without_the_recorder_reads_none(tracing, monkeypatch):
    _span("graph.replay", 0.0, 1e-3)
    _span("graph.warmup", 0.0, 1e-3)
    import tpusph_torch.bench

    monkeypatch.setitem(sys.modules, "tpusph_torch.bench.spans", None)
    monkeypatch.delattr(tpusph_torch.bench, "spans")
    run = data(steps=10)
    for name in READERS:
        assert read(name, run) is None, name


@pytest.mark.parametrize("cell", ["tiny-chain", "tiny-timed"])
def test_a_traced_run_reports_the_spans_of_its_layers(tiny, cell):
    """On the CPU: no graph is captured or copied, so the capture-time,
    copy and node readers find nothing; the call's self time (less the
    body's guarded call, which stands for the replay) reads; the copy's
    parts only where the Simulator runs, and there they make `sim.copy_ms`."""
    line = run.execute(Benchmark(tiny), cell, 12, 0.2, True, device="cpu").line
    got = line["metrics"]
    assert "graph.self_ms" in got
    assert not {"graph.nodes", "graph.io_ms", *SETUP} & set(got)
    if cell == "tiny-timed":
        parts = got["sim.copy_wait_ms"]["value"] + got["sim.copy_start_ms"]["value"]
        assert math.isclose(parts, got["sim.copy_ms"]["value"], rel_tol=1e-9)
    else:
        assert not {"sim.copy_wait_ms", "sim.copy_start_ms"} & set(got)
