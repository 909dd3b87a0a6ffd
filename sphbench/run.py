"""Run one cell of `BENCHMARK.json` once and print its result line last.

    python3 -m sphbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from the start of this module): the
start state from the seed (`inits/<init>.py`), the cell's loop
(`loops/<loop>.py`, which imports the port), its first run (capture and
first replay: `graph.capture_s`) and one warm run. Then the window:

- `--trace 0`: runs back to back until `--seconds` have passed; the
  window ends with the last run. The end-to-end metrics.
- `--trace 1`: the traffic's `trace_runs` runs under `torch.profiler`.
  The per-layer metrics, `busy_s`, `window_s` and `breakdown`.

After the window the memory peak is read, the port's state is freed and
the plain reference runs the same steps from the same initial state on
the same card; the loop's `numbers` hold the last run's output, and that
of one run drawn from the seed, against it. With `control` (never in the
benchmark's own runs) the reference computed in bfloat16 is judged in the
port's place, as the limits were set. Each compared number is printed
beside its limit, last on standard error and under `compared` last in the
line. Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; with JAX or the JAX package loaded after the
window, 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from sphbench import compare, counts, stats, trace  # noqa: E402
from sphbench.reference import sph  # noqa: E402
from sphbench.registry import Benchmark  # noqa: E402
from sphbench.window import Record, sync  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpusph")


class NoCard(RuntimeError):
    pass


@dataclasses.dataclass
class RunData:
    """What a metric's reader reads (`metrics/<name>.py`)."""

    record: Record
    setup_s: float
    capture_s: float
    n: int
    trace: trace.TraceSummary | None = None
    pairs: list | None = None  # (density, force) pairs within h, each step of a run
    peaks: dict | None = None
    notes: list = dataclasses.field(default_factory=list)


def card(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda is not available")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, {torch.cuda.device_count()} are here")
    return torch.device("cuda", 0)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Outcome:
    """One run: its result line, its lines for standard error, every number
    of the comparison (compared or not), and the window's record."""

    line: dict
    err: list[str]
    numbers: dict[str, float]
    record: Record


def execute(bench: Benchmark, workload: str, seed: int, seconds: float, traced: bool,
            device=None, control: bool = False) -> Outcome:
    """One run of `workload`. `device` None takes the card, and raises
    NoCard without one. `control` judges the reference in bfloat16 in the
    port's place."""
    phases = {"imports": time.perf_counter() - _T0}
    cell = bench.cell(workload)
    dev = card(cell.chips) if device is None else torch.device(device)
    start = bench.init(cell.config["init"]).start(cell.config, seed, dev)
    sync(dev)
    phases["card and inputs"] = time.perf_counter() - _T0
    loop_module = bench.loop(cell.traffic["loop"])
    loop = loop_module.Loop(cell.config, cell.traffic, start, dev)
    phases["loop"] = time.perf_counter() - _T0

    setup = Record()
    t = time.perf_counter()
    loop.run(setup)  # capture and first replay
    sync(dev)
    capture_s = time.perf_counter() - t
    phases["first run"] = time.perf_counter() - _T0
    t = time.perf_counter()
    loop.run(setup)  # warm
    run_s = time.perf_counter() - t
    if traced:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if dev.type == "cuda" else [])
        with profile(activities=activities):  # the profiler's own start-up
            torch.ones(1, device=dev).add_(1)
            sync(dev)
    setup_s = time.perf_counter() - _T0
    phases["set-up"] = setup_s

    rec = Record()
    runs = int(cell.traffic["trace_runs"]) if traced else max(1, int(seconds / run_s))
    sample_at = random.Random(seed).randrange(runs)
    sampled = out = None
    if traced:
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                w0 = time.perf_counter()
                for k in range(runs):
                    out = loop.run(rec)
                    if k == sample_at:
                        sampled = out
                rec.window_s = time.perf_counter() - w0
        summary = trace.summarize(trace.profiler_events(prof), bench.stages())
        del prof
    else:
        summary = None
        w0 = time.perf_counter()
        while True:
            out = loop.run(rec)
            if rec.runs - 1 == sample_at:
                sampled = out
            if time.perf_counter() - w0 >= seconds:
                break
        rec.window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    outputs = [loop.result(out)] + ([loop.result(sampled)] if sampled is not None
                                    and sampled is not out else [])
    steps, n = loop.steps, loop.n
    del loop, out, sampled
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = sph.run(start["position"], cell.config, steps, velocity=start["velocity"])
    ref_np = _numpy(ref)
    if control:
        outputs = [_numpy(sph.run(start["position"], cell.config, steps,
                                  velocity=start["velocity"], dtype=torch.bfloat16))]
    numbers = compare.worst(*(loop_module.numbers(o, ref_np, cell.config) for o in outputs))
    correct, compared = compare.judge(numbers, cell.limits)

    kind_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    data = RunData(record=rec, setup_s=setup_s, capture_s=capture_s, n=n, trace=summary,
                   pairs=ref["pairs"], peaks=counts.PEAKS.get(kind_name))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = bench.reader(m.name)(data)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    device_line = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind_name,
                   "count": cell.chips if dev.type == "cuda" else 0,
                   "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": rec.runs, "failed": rec.failed,
            "metrics": metrics, "device": device_line}
    if summary is not None:
        device_line.update(busy_s=summary.busy_s, window_s=summary.window_s)
        line["breakdown"] = summary.breakdown()
    info = {k: v for k, v in numbers.items() if k not in compared}
    line["compared"] = compared
    err = [*data.notes,
           "set-up, s from the start: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
           f"{workload} seed {seed}: {rec.runs} runs, {rec.steps} steps, {rec.failed} failed, "
           f"window {rec.window_s:.3f} s; run ms p05/p50/p95 {_ms(rec.run_s)}, step ms "
           f"{_ms(rec.step_s)}; not compared: {info}",
           *(f"compared {k} {v['value']!r} limit {v['limit']!r}" for k, v in compared.items())]
    if not compared:
        err.append(f"compared nothing: no limits for {workload}")
    return Outcome(line, err, numbers, rec)


def _numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items() if k != "pairs"}


def _ms(samples) -> str:
    if not samples:
        return "none"
    return "/".join(f"{stats.percentile(samples, q) * 1e3:.4f}" for q in (5, 50, 95))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        out = execute(Benchmark(), args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"sphbench: no result: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"sphbench: no result: the process holds {found}", file=sys.stderr)
        return 3
    print("\n".join(out.err), file=sys.stderr, flush=True)
    print(json.dumps(finite(out.line)), flush=True)
    return 0


def finite(x):
    """`x` with every non-finite float as None, so the line is plain JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
