"""Spans of the port's host code: named intervals of its host work, on
`torch.profiler`'s timeline and in memory, and counters beside them.

Tracing is on exactly while a `torch.profiler` profile records
(`torch.autograd.profiler._is_profiler_enabled`); there is no other switch.

`span(name)` is a context manager around a piece of host work. With no
profile recording it checks that flag and returns one shared null context:
it allocates nothing, enters no record function and reads no clock. While
a profile records it enters a record function of `name` (torch's
`_RecordFunctionFast`, a host event as `record_function` makes, at a fifth
of its cost and with no copy on the device's timeline), so the span sits on
the profiler's clock (a trace's idle gaps and `--profile`'s Chrome trace
name it), and keeps a `Record`: its name, start and end (host seconds,
`time.perf_counter`), the enclosing span and the index of the root span
it belongs to. A span opened with no span open is a root and takes the next
index, so every span of one timed step (under `sim.step`) or of one chain
replay (under `graph.call`) shares that step's or replay's index.

A span may take its ends from the caller's own clock reads: `span(name,
start=t)`, and `s.end = t` inside the block; otherwise it reads the clock at
entry and exit. The timed step's phases share their reads with `Times` so.
On the null context `end` reads None and takes no value.

`span(name, always=True)`: recorded with or without a profile (entering
the record function only while one records). For work that runs once per
graph, outside any hot path: the capture-time spans, which set-up
measurements read.

`count(name, n)` adds `n` to a counter while a profile records;
`recording()` says whether one does, for a counter whose value costs
something to read.

`totals()` gives each name's count, seconds and self seconds (the duration
less what its child spans cover), over every span closed since `reset()`;
`records()` the last `CAP` records, the oldest dropped, so a long profile
cannot grow without end while the totals still count every span.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 16  # records kept
_RecordFunction = torch._C._profiler._RecordFunctionFast


class Record(NamedTuple):
    id: int
    name: str
    start: float  # host seconds (time.perf_counter)
    end: float
    parent: int  # the enclosing span's id, -1 at a root
    index: int  # the root span's number: the step or run


@dataclasses.dataclass
class Total:
    count: int = 0
    seconds: float = 0.0
    self_seconds: float = 0.0


_open: list = []  # the spans open now, innermost last
_records: collections.deque = collections.deque(maxlen=CAP)
_totals: dict[str, Total] = {}
_counts: dict[str, int] = {}
_ids = 0  # spans opened since reset()
_roots = 0  # root spans opened since reset()


class _Null:
    """The span while no profile records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    end = property(lambda self: None, lambda self, value: None)


_NULL = _Null()


class _Span:
    __slots__ = ("name", "start", "end", "id", "parent", "index", "child_s", "_fn")

    def __init__(self, name: str, start: float | None, profiled: bool):
        self.name, self.start, self.end = name, start, None
        self._fn = _RecordFunction(name) if profiled else None

    def __enter__(self):
        global _ids, _roots
        if self._fn is not None:
            self._fn.__enter__()
        if self.start is None:
            self.start = time.perf_counter()
        parent = _open[-1] if _open else None
        self.id, _ids = _ids, _ids + 1
        if parent is None:
            self.parent, self.index, _roots = -1, _roots, _roots + 1
        else:
            self.parent, self.index = parent.id, parent.index
        self.child_s = 0.0
        _open.append(self)
        return self

    def __exit__(self, *exc):
        if self.end is None:
            self.end = time.perf_counter()
        _open.pop()
        seconds = self.end - self.start
        if _open:
            _open[-1].child_s += seconds
        total = _totals.get(self.name)
        if total is None:
            total = _totals[self.name] = Total()
        total.count += 1
        total.seconds += seconds
        total.self_seconds += seconds - self.child_s
        _records.append(Record(self.id, self.name, self.start, self.end, self.parent,
                               self.index))
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return None


def recording() -> bool:
    """True while a profile records: spans and counters are kept."""
    return _profiler._is_profiler_enabled


def span(name: str, start: float | None = None, always: bool = False):
    """A span of `name` around the block while a profile records (and with
    `always`, also while none does); else the shared null context."""
    profiled = _profiler._is_profiler_enabled
    if not (profiled or always):
        return _NULL
    return _Span(name, start, profiled)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` while a profile records."""
    if recording():
        _counts[name] = _counts.get(name, 0) + n


def totals() -> dict[str, Total]:
    """name → Total of every span closed since `reset()`."""
    return {k: dataclasses.replace(v) for k, v in _totals.items()}


def counts() -> dict[str, int]:
    """name → the counter's sum since `reset()`."""
    return dict(_counts)


def records() -> list[Record]:
    """The last `CAP` spans closed, in the order they closed."""
    return list(_records)


def reset() -> None:
    """Forget every span and counter (spans open now still close)."""
    global _ids, _roots
    _records.clear()
    _totals.clear()
    _counts.clear()
    _ids = _roots = 0
