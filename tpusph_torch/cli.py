"""Command line, with the reference driver's surface (main.cpp:20-82):

    python -m tpusph_torch -n <NUM_PARTICLES> -i <random/grid> -m <free/time>

Counterpart of `tpusph/cli.py`: the same defaults (N=1000, grid init,
time mode), the same usage text and the same 100-step timed run printing
the Times table. Free mode is the interactive window (a hint and exit code
0 where there is no display) or, with `--frames N`, the headless frame
dump (`--out DIR`, scripted clicks `--click frame:px,py`, repeatable,
`--gif PATH` to assemble the frames into an animated GIF).
`--save PATH` checkpoints the final state and `--load PATH` resumes one,
in the `.npz` format both packages read. Extra flags: --steps, --warmup,
--seed, --device (default cuda), --backend (kernels, the default, also
under tpusph's names auto and pallas; cell_list; allpairs), --viz-chunk
(free mode: steps per dispatch) and --profile DIR (timed mode: a
`torch.profiler` Chrome trace of the timed steps in DIR).

Not every tpusph command line runs here. Flags of `tpusph/cli.py` that are
not taken (argparse rejects them: the usage text, exit code 1):
--stencil, --pallas-col-capacity, --pallas-sub-blocks and --window-capacity
size the Pallas kernels' stencil decomposition, candidate buffers and window
prep, which the CUDA kernels do without (they walk each window to its end).
--mesh is parsed and exits with code 2 until the sharded engine's
simulator is ported.
"""

from __future__ import annotations

import argparse
import contextlib
import os
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
    p.add_argument(
        "--backend", choices=["auto", "kernels", "pallas", "cell_list", "allpairs"],
        default="auto",
        help="step backend: kernels (the CUDA kernels; auto and pallas name it "
        "too), cell_list (plain-torch tile passes) or allpairs (O(N^2) oracle)",
    )
    p.add_argument(
        "--viz-chunk", type=int, default=None, metavar="S",
        help="free mode with --frames: steps per dispatch, one CUDA-graph "
        "replay each, frames projected on the device. Default: "
        "TPUSPH_VIZ_CHUNK, else one step at a time",
    )
    p.add_argument("--frames", type=int, default=0, help="free mode: frame-dump count")
    p.add_argument("--out", type=str, default="frames", help="free mode: output dir")
    p.add_argument(
        "--click", type=str, default=None, action="append",
        help="free mode: 'frame:px,py' scripted click, repeatable",
    )
    p.add_argument(
        "--save", type=str, default=None, metavar="PATH",
        help="checkpoint the final state to PATH (.npz, self-describing)",
    )
    p.add_argument(
        "--load", type=str, default=None, metavar="PATH",
        help="resume from a checkpoint written by --save of either package "
        "(restores N and the physics config; -n/-i are ignored with a note)",
    )
    p.add_argument(
        "--profile", type=str, default=None, metavar="DIR",
        help="timed mode: write a torch.profiler Chrome trace of the timed steps to DIR",
    )
    p.add_argument(
        "--gif", type=str, default=None,
        help="free mode with --frames: also assemble frames into this GIF",
    )
    p.add_argument("--mesh", type=str, default=None, help=NOT_PORTED)
    return p


def parse_clicks(specs: list[str] | None) -> dict[int, tuple[int, int]]:
    """['frame:px,py', ...] → {frame: (px, py)}."""
    clicks = {}
    for spec in specs or []:
        frame, xy = spec.split(":")
        x, y = xy.split(",")
        clicks[int(frame)] = (int(x), int(y))
    return clicks


@contextlib.contextmanager
def profile_to(trace_dir: str | None, device):
    """Trace the body with `torch.profiler` (CPU activity, and CUDA activity
    when `device` is a card) and write `trace_dir/trace.json`, a Chrome
    trace; no trace_dir, no profiler."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"wrote profiler trace: {path}", file=sys.stderr)


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
    if args.mesh is not None:
        print(f"sph: --mesh is {NOT_PORTED}", file=sys.stderr)
        return 2
    try:
        clicks = parse_clicks(args.click)
    except ValueError:
        print(usage(), end="")
        return 1

    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import lattice_capacity
    from tpusph_torch.core.io import load_state, save_state
    from tpusph_torch.engine.simulator import Simulator

    loaded_state = None
    if args.load is not None:
        # the checkpoint's config (N and the physics) is the one to resume
        loaded_state, cfg = load_state(args.load, args.device)
        if args.num_particles != 1000 and args.num_particles != cfg.num_particles:
            print(
                f"sph: --load restores N={cfg.num_particles}; -n "
                f"{args.num_particles} ignored",
                file=sys.stderr,
            )
        random_init = False
    else:
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

    sim = Simulator(
        cfg, backend=args.backend, random_init=random_init, seed=args.seed, device=args.device
    )
    sim.setup(loaded_state)

    if args.exec_mode == "time":
        from tpusph_torch.bench.times import Times, display_times

        warm = Times()
        for _ in range(args.warmup):
            sim.simulate_and_time(warm)
        times = Times()
        with profile_to(args.profile, sim.device):
            for _ in range(args.steps):
                sim.simulate_and_time(times)
        display_times(times)
    else:
        from tpusph_torch.viz.render import frames_to_gif, run_free_mode

        run_free_mode(
            sim, frames=args.frames, out_dir=args.out, clicks=clicks, chunk=args.viz_chunk
        )
        if args.gif and args.frames > 0:
            frames_to_gif(args.out, args.gif)
            print(f"wrote {args.gif}")

    if args.save is not None:
        save_state(args.save, sim.state, sim.cfg)
        print(f"saved checkpoint: {args.save}", file=sys.stderr)
    return 0
