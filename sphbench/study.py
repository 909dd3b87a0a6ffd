"""The readings that a cell's correctness limits are set from, on the card.

    python3 -m sphbench.study --workload <cell> --seeds 1 2 ... [--control 3] [--seconds S] [--out FILE]

For each seed, one run of the cell through `run.execute`, the path that
decides `correct` in every run of the benchmark, with a short window
(`--seconds`): the numbers of the cell's loop for the port. For the first
`--control` seeds also a second run with the control, the reference
computed in bfloat16 (the precision below the configuration's float32),
judged in the port's place. One JSON line a seed on standard output, and
appended to `--out` when given.
"""

from __future__ import annotations

import argparse
import json

from sphbench.registry import Benchmark
from sphbench.run import execute, finite


def readings(bench: Benchmark, workload: str, seed: int, control: bool, seconds: float,
             device=None) -> dict:
    got = execute(bench, workload, seed, seconds, False, device=device)
    out = {"workload": workload, "seed": seed, "correct": got.line["correct"],
           "runs": got.record.runs, "failed": got.record.failed, "numbers": got.numbers}
    if control:
        low = execute(bench, workload, seed, seconds, False, device=device, control=True)
        out["control_correct"] = low.line["correct"]
        out["control"] = low.numbers
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0, help="seeds that also run the control")
    p.add_argument("--seconds", type=float, default=0.0, help="the window; 0: one run")
    p.add_argument("--out")
    p.add_argument("--device", default=None, help="cpu for a rehearsal; the card otherwise")
    args = p.parse_args(argv)
    bench = Benchmark()
    for k, seed in enumerate(args.seeds):
        line = json.dumps(finite(readings(bench, args.workload, seed, k < args.control,
                                          args.seconds, args.device)))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
