"""The spans of the port's host code (`tpusph_torch/bench/spans.py`), on
the CPU at small N: nothing recorded and no record function made without a
profile; under one, the timed step's and the chain's spans in the
profiler's events and the recorder, nested (the copy's spans inside
`sim.update` on the kernels, after it on the tile passes), indexed by
step, summing to `Times`' fields; self time; the cap on records; the node
counter."""

import math
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpusph_torch.bench import spans
from tpusph_torch.bench.times import Times
from tpusph_torch.core.config import default_config
from tpusph_torch.engine import graphs, simulator
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.engine.step import fields_from_state, make_fields_chain

N = 512
STEPS = 3
SIM_SPANS = ("sim.step", "sim.build", "sim.update", "sim.copy_wait", "sim.copy_start")


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _sim(backend="kernels"):
    sim = Simulator(default_config(N, chunk_size=N), backend=backend, device="cpu")
    sim.setup()
    return sim


def _chain(sim):
    return make_fields_chain(sim.cfg, 2, "cpu"), fields_from_state(sim.state)


def test_no_profile_no_span_no_record_function_no_clock(monkeypatch):
    """Without a profile the timed steps and a chain call record nothing,
    never make a record function, and read the clock only for `Times`:
    five reads a step on the kernels (the build's two ends, the copy's two,
    the update's end), none in the recorder."""
    sim = _sim()
    chain, fs = _chain(sim)

    def refuse(*a, **k):
        raise AssertionError("a record function made with no profile")

    monkeypatch.setattr(spans, "_RecordFunction", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    class NoClock:
        def perf_counter(self):
            raise AssertionError("the recorder read the clock with no profile")

    monkeypatch.setattr(spans, "time", NoClock())
    reads = []

    class Clock:
        def perf_counter(self):
            reads.append(1)
            return time.perf_counter()

    monkeypatch.setattr(simulator, "time", Clock())
    times = Times()
    for _ in range(STEPS):
        sim.simulate_and_time(times)
    chain(fs)
    assert times.iters == STEPS and len(reads) == 5 * STEPS
    assert spans.records() == [] and spans.totals() == {} and spans.counts() == {}


def _children(records):
    out = {}
    for r in records:
        out.setdefault(r.parent, []).append(r)
    return out


@pytest.mark.parametrize("backend", ["kernels", "cell_list"])
def test_spans_under_a_profile_nest_index_and_sum_to_times(backend):
    sim = _sim(backend)
    chain, fs = _chain(sim)
    sim.simulate_and_time(Times())  # the first call of each loop, outside the profile
    chain(fs)
    times = Times()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(STEPS):
            sim.simulate_and_time(times)
        chain(fs)

    # the profiler's events: each span, nested as in the port; the copy
    # runs under the update on the kernels, after it on the tile passes
    copy_parent = "sim.update" if backend == "kernels" else "sim.step"
    parent = {}
    for e in prof.events():
        if e.name.startswith(("sim.", "graph.")):
            parent.setdefault(e.name, set()).add(e.cpu_parent.name if e.cpu_parent else None)
    assert parent == {
        "sim.step": {None},
        "sim.build": {"sim.step"}, "sim.update": {"sim.step"},
        "sim.copy_wait": {copy_parent}, "sim.copy_start": {copy_parent},
        "graph.call": {"sim.build", "sim.update", None},
        "graph.replay": {"graph.call"},
    }
    overlapped = spans.counts().get("sim.copy_overlapped", 0)
    assert overlapped == (STEPS if backend == "kernels" else 0)

    # the recorder: one index a step, one for the chain's call
    recs = spans.records()
    by_index = {}
    for r in recs:
        by_index.setdefault(r.index, []).append(r.name)
    assert len(by_index) == STEPS + 1
    *steps, last = sorted(by_index)
    for k in steps:
        assert sorted(by_index[k]) == sorted([*SIM_SPANS, "graph.call", "graph.call",
                                               "graph.replay", "graph.replay"])
    assert sorted(by_index[last]) == ["graph.call", "graph.replay"]
    ids = {r.id: r for r in recs}
    for r in recs:
        if r.parent >= 0:
            p = ids[r.parent]
            assert p.index == r.index and p.start <= r.start <= r.end <= p.end

    # the shared reads: the phases are Times' intervals, the copy's two
    # parts tile Times.memcpy
    def secs(name):
        return sum(r.end - r.start for r in recs if r.name == name)

    tot = spans.totals()
    assert secs("sim.build") == tot["sim.build"].seconds == times.build_grid
    assert secs("sim.update") == tot["sim.update"].seconds == times.sph_update
    assert math.isclose(secs("sim.copy_wait") + secs("sim.copy_start"), times.memcpy,
                        rel_tol=1e-12)
    kids = _children(recs)
    for r in recs:
        if r.name == "sim.step":
            build, update = (next(c for c in kids[r.id] if c.name == n)
                             for n in ("sim.build", "sim.update"))
            assert build.end == update.start
            if backend == "kernels":
                wait, start = (next(c for c in kids[update.id] if c.name == n)
                               for n in SIM_SPANS[3:])
                assert update.start <= wait.start and start.end <= update.end
            else:
                wait, start = (next(c for c in kids[r.id] if c.name == n)
                               for n in SIM_SPANS[3:])
                assert update.end == wait.start
            assert wait.end == start.start

    # self time: the duration less what the children cover
    for name, t in tot.items():
        own = [r for r in recs if r.name == name]
        assert t.count == len(own)
        want = sum(r.end - r.start - sum(c.end - c.start for c in kids.get(r.id, []))
                   for r in own)
        assert math.isclose(t.self_seconds, want, rel_tol=1e-9, abs_tol=1e-12)
        assert 0 <= t.self_seconds <= t.seconds


def test_records_are_capped_and_totals_count_every_span(monkeypatch):
    monkeypatch.setattr(spans, "_records", type(spans._records)(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(10):
            with spans.span("a"):
                with spans.span("b"):
                    pass
    recs = spans.records()
    assert [r.name for r in recs] == ["b", "a", "b", "a"]
    assert [r.index for r in recs] == [8, 8, 9, 9]
    assert spans.totals()["a"].count == 10 and spans.totals()["b"].count == 10


def test_capture_time_spans_record_without_a_profile(monkeypatch):
    """`always` spans keep their record with no profile, and make no record
    function then; other spans and counters stay silent."""
    def refuse(*a, **k):
        raise AssertionError("a record function made with no profile")

    monkeypatch.setattr(spans, "_RecordFunction", refuse)
    with spans.span("graph.warmup", always=True):
        with spans.span("graph.call"):
            spans.count("graph.nodes", 5)
    (r,) = spans.records()
    assert r.name == "graph.warmup" and r.parent == -1 and r.end >= r.start
    assert spans.totals()["graph.warmup"].count == 1 and spans.counts() == {}


def test_a_replay_adds_its_nodes_while_a_profile_records():
    class Stub:
        def replay(self):
            pass

    g = graphs.CapturedGraph(Stub(), {}, nodes=7)
    g.replay()
    assert spans.counts() == {} and spans.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        g.replay()
        g.replay()
    assert spans.counts() == {"graph.nodes": 14}
    assert spans.totals()["graph.replay"].count == 2
