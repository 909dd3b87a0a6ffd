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

`--mesh z|ZxYxX` shards the box over ranks through `DistSimulator`: `z`
for z-slabs on a line of every rank, `ZxYxX` (e.g. 2x2x2) for a grid of
bricks whose product is the number of ranks; a shape that is not three
integers, or not the number of ranks, prints the usage text and exits 1.
The ranks are processes: under `torchrun` (RANK, WORLD_SIZE and
LOCAL_RANK set) each joins torchrun's group on `cuda:LOCAL_RANK` (or the
CPU with `--device cpu`); started otherwise it is one rank with no group.
Every rank steps and collects; rank 0 alone prints the Times table and
writes the frames, the GIF and the checkpoint (`--save` goes through
`DistSimulator.to_host_state`). Under `--mesh`, `--backend` auto, pallas
and kernels run the kernels and cell_list the tile passes; allpairs exits
1 (tpusph ignores `--backend` under `--mesh`). `-m free` without
`--frames` (the interactive window) takes one rank; `--viz-chunk` does
not apply (`DistSimulator` steps one frame at a time).

Not every tpusph command line runs here. Flags of `tpusph/cli.py` that are
not taken (argparse rejects them: the usage text, exit code 1):
--stencil, --pallas-col-capacity, --pallas-sub-blocks and --window-capacity
size the Pallas kernels' stencil decomposition, candidate buffers and window
prep, which the CUDA kernels do without (they walk each window to its end).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

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
    p.add_argument(
        "--mesh", type=str, default=None, metavar="z|ZxYxX",
        help="shard the box over the ranks: 'z' = 1-D z-slabs over every rank, "
        "'ZxYxX' (e.g. 2x2x2) = a grid of bricks; ranks from torchrun",
    )
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


def parse_mesh(spec: str):
    """`--mesh`: 'z' → None (z-slabs), 'ZxYxX' → (Z, Y, X); anything else
    raises ValueError."""
    if spec == "z":
        return None
    shape = tuple(int(v) for v in spec.split("x"))
    if len(shape) != 3:
        raise ValueError(f"--mesh {spec}: three extents ZxYxX, or z")
    return shape


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
    try:
        clicks = parse_clicks(args.click)
        mesh_shape = parse_mesh(args.mesh) if args.mesh is not None else None
    except ValueError:
        print(usage(), end="")
        return 1
    if args.mesh is not None and args.backend == "allpairs":
        print("sph: --mesh runs the kernels or cell_list backend, not allpairs", file=sys.stderr)
        print(usage(), end="")
        return 1
    comm = None
    if args.mesh is not None:
        from tpusph_torch.dist.comm import join_torchrun

        comm = join_torchrun(args.device)
    try:
        return _run(args, clicks, mesh_shape, comm)
    finally:
        if comm is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, clicks, mesh_shape, comm) -> int:
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import lattice_capacity
    from tpusph_torch.core.io import load_state, save_state

    meshed = args.mesh is not None
    rank0 = comm is None or comm.rank == 0
    if args.exec_mode == "free" and args.frames <= 0 and comm is not None and comm.size > 1:
        print("sph: the interactive window runs on one rank; use --frames N with --mesh "
              "under torchrun", file=sys.stderr)
        return 1
    loaded_state = None
    if args.load is not None:
        # the checkpoint's config (N and the physics) is the one to resume
        loaded_state, cfg = load_state(args.load, "cpu" if meshed else args.device)
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

    if meshed:
        from tpusph_torch.dist.simulator import DistSimulator

        try:
            sim = DistSimulator(
                cfg, comm=comm, random_init=random_init, seed=args.seed, mesh_shape=mesh_shape,
                backend=args.backend, device=args.device,
            )
        except ValueError as e:
            print(f"sph: {e}", file=sys.stderr)
            print(usage(), end="")
            return 1
    else:
        from tpusph_torch.engine.simulator import Simulator

        sim = Simulator(
            cfg, backend=args.backend, random_init=random_init, seed=args.seed,
            device=args.device,
        )
    sim.setup(loaded_state)

    if args.exec_mode == "time":
        from tpusph_torch.bench.times import Times, display_times

        warm = Times()
        for _ in range(args.warmup):
            sim.simulate_and_time(warm)
        times = Times()
        with profile_to(args.profile if rank0 else None, sim.device):
            for _ in range(args.steps):
                sim.simulate_and_time(times)
        if rank0:
            display_times(times)
    elif not rank0:
        # the other ranks step and collect (a collective), and draw nothing
        for k in range(args.frames):
            sim.simulate(click=clicks.get(k))
            sim.get_position()
    else:
        from tpusph_torch.viz.render import frames_to_gif, run_free_mode

        run_free_mode(
            sim, frames=args.frames, out_dir=args.out, clicks=clicks, chunk=args.viz_chunk
        )
        if args.gif and args.frames > 0:
            frames_to_gif(args.out, args.gif)
            print(f"wrote {args.gif}")

    if args.save is not None:
        # one checkpoint format for both engines: the sharded one collects
        # to a host FluidState first (a collective, so every rank takes part)
        state = sim.to_host_state() if meshed else sim.state
        if rank0:
            save_state(args.save, state, sim.cfg)
            print(f"saved checkpoint: {args.save}", file=sys.stderr)
    return 0
