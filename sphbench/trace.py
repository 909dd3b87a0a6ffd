"""The reduction of a `torch.profiler` trace of the traced window.

The harness wraps the traced runs in `record_function(WINDOW)` and each
of its own phases in `record_function("sphbench.<phase>")`. From the
profiler's events (`prof.events()`, times in microseconds on one clock)
it takes:

- the device's operations (kernels, copies, sets) inside the window, with
  their names and intervals; a label's copy on the device's timeline (a
  user annotation) is not an operation;
- busy: the union of those intervals; the window: the span of WINDOW;
- by stage: the seconds of the kernels whose names a `stages/` pattern
  matches (a kernel matched by two stages is an error);
- the idle gaps between busy intervals, each named by the innermost host
  event that covers its middle (a runtime call, an operator or a harness
  phase; not the profiler's own), "python" where none does.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

LABEL = "sphbench."
WINDOW = LABEL + "window"
# host events of the profiler itself, which say nothing of the program
PROFILER_OWN = {"Activity Buffer Request"}
NAME_CHARS = 160  # of a device operation's name in the breakdown


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: float  # summed durations, overlaps counted twice
    by_name: dict[str, float]  # device seconds by operation name
    by_stage: dict[str, float]  # device seconds by stage, matched stages only
    idle_by_host: dict[str, float]  # idle seconds by what the host was doing

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(self.by_name), "idle_gaps": head(self.idle_by_host)}


def summarize(events, stages: dict) -> TraceSummary:
    """`events`: (name, start_us, end_us, on_device) tuples; `stages`: stage
    → compiled name patterns."""
    window = [(s, e) for name, s, e, dev in events if name == WINDOW and not dev]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} windows, not one")
    w0, w1 = window[0]
    ops = sorted((max(s, w0), min(e, w1), name) for name, s, e, dev in events
                 if dev and e > w0 and s < w1)
    by_name: dict[str, float] = defaultdict(float)
    for s, e, name in ops:
        by_name[name] += (e - s) / 1e6
    by_stage: dict[str, float] = {}
    for name, secs in by_name.items():
        hits = [st for st, pats in stages.items() if any(p.search(name) for p in pats)]
        if len(hits) > 1:
            raise RuntimeError(f"kernel {name!r} matches the stages {hits}")
        if hits:
            by_stage[hits[0]] = by_stage.get(hits[0], 0.0) + secs
    busy, gaps, cur_s, cur_e = 0.0, [], None, w0
    for s, e, _ in ops:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    idle: dict[str, float] = defaultdict(float)
    host = sorted((s, e, name) for name, s, e, dev in events if not dev and name != WINDOW)
    active: list = []  # heap of (duration, end, name) of host events begun
    k = 0
    for g0, g1 in gaps:  # in order of time
        mid = (g0 + g1) / 2
        while k < len(host) and host[k][0] <= mid:
            s, e, name = host[k]
            heapq.heappush(active, (e - s, e, name))
            k += 1
        while active and active[0][1] < mid:  # the shortest has ended
            heapq.heappop(active)
        idle[active[0][2] if active else "python"] += (g1 - g0) / 1e6
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy / 1e6,
        device_s=sum(by_name.values()),
        by_name=dict(by_name),
        by_stage=by_stage,
        idle_by_host=dict(idle),
    )


def profiler_events(prof) -> list[tuple[str, float, float, bool]]:
    """(name, start_us, end_us, on_device) of every event of a finished
    `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        if on_device and (getattr(e, "is_user_annotation", False)
                          or e.name.startswith(LABEL)):
            continue  # a label's copy on the device's timeline, not work
        if not on_device and e.name in PROFILER_OWN:
            continue
        out.append((e.name, float(e.time_range.start), float(e.time_range.end), on_device))
    return out
