"""Command line, with the reference driver's surface (main.cpp:20-82):

    python -m tpusph_torch -n <NUM_PARTICLES> -i <random/grid> -m <free/time>

Counterpart of `tpusph/cli.py`: the same defaults (N=1000, grid init,
time mode), the same usage text and the same 100-step timed run printing
the Times table. Extra flags: --steps, --warmup, --seed and --device
(default cuda). Free mode, --mesh, --save and --load are not ported yet
and exit with an error.
"""

from __future__ import annotations

import argparse
import sys

NOT_PORTED = "not yet ported to tpusph_torch"


def usage() -> str:
    return (
        "Program Options:\n"
        "  -n  <NUM_PARTICLES>    Number of particles to simulate\n"
        "  -i  <random/grid>      Initialization mode: random or grid\n"
        "  -m  <free/time>        Execution mode: free or timed\n"
        "  -?                     This message\n"
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sph", add_help=False, usage="sph -n <N> -i <random/grid> -m <free/time>"
    )
    p.add_argument("-n", type=int, default=1000, dest="num_particles")
    p.add_argument("-i", choices=["random", "grid"], default="grid", dest="init_mode")
    p.add_argument("-m", choices=["free", "time"], default="time", dest="exec_mode")
    p.add_argument("-?", "--help", action="store_true", dest="show_help")
    p.add_argument("--steps", type=int, default=100, help="timed-mode iterations")
    p.add_argument(
        "--warmup", type=int, default=1,
        help="timed-mode untimed warm-up steps (0 reproduces the reference "
        "protocol exactly)",
    )
    p.add_argument("--seed", type=int, default=0, help="generator seed for -i random")
    p.add_argument("--device", type=str, default="cuda", help="torch device")
    for flag in ("--mesh", "--save", "--load"):
        p.add_argument(flag, type=str, default=None, help=NOT_PORTED)
    return p


def main(argv: list[str] | None = None) -> int:
    args_in = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    try:
        args = parser.parse_args(args_in)
    except SystemExit:
        print(usage(), end="")
        return 1
    if args.show_help:
        print(usage(), end="")
        return 1
    for what, given in (
        ("-m free", args.exec_mode == "free"),
        ("--mesh", args.mesh is not None),
        ("--save", args.save is not None),
        ("--load", args.load is not None),
    ):
        if given:
            print(f"sph: {what} is {NOT_PORTED}", file=sys.stderr)
            return 2

    from tpusph_torch.bench.times import Times, display_times
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import lattice_capacity
    from tpusph_torch.engine.simulator import Simulator

    cfg = tuned_config(args.num_particles)
    random_init = args.init_mode == "random"
    cap = lattice_capacity(cfg)
    if not random_init and args.num_particles > cap:
        print(
            f"sph: N={args.num_particles} exceeds the {cap} grid-lattice "
            "ceiling — using random init",
            file=sys.stderr,
        )
        random_init = True

    sim = Simulator(cfg, random_init=random_init, seed=args.seed, device=args.device)
    sim.setup()
    warm = Times()
    for _ in range(args.warmup):
        sim.simulate_and_time(warm)
    times = Times()
    for _ in range(args.steps):
        sim.simulate_and_time(times)
    display_times(times)
    return 0
