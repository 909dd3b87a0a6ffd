#!/usr/bin/env python3
"""Smoke run of tpusph_torch on one NVIDIA GPU (built for sm_90a: H100).

    python3 chip_smoke.py        # from the repository root

Phases, each of which raises on failure (exit code 1):
  1. device: needs torch.cuda; prints the card, CUDA version and the
     card's power limit as nvidia-smi reports it;
  2. build: compiles the CUDA kernels from tpusph_torch/csrc with nvcc
     and the host library native/sphnative.cpp with g++ (required here);
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes (262,144 particles, grid init, at steps 0, 20 and
     100): ranks exact, on the step's queries (every cell in order) and
     also on 1,000,002 unsorted queries (a seeded permutation of the
     cells), on sorted queries with repeats and values above num_cells and
     on a query tensor 4 bytes past a 16-byte boundary; the share of the
     rank kernel's blocks that find an empty span, stage their span in
     shared memory or search device memory (`qrank.block_spans`); the tiled
     density (csrc/sph.cu) and its first design `density_baseline`
     (csrc/sph_baseline.cu) rtol 1e-5, force rtol 1e-4 atol 1e-4, and the
     tiled density bit for bit equal to `density_baseline` (the largest
     difference printed, 0). At each state: the time of rank, density and
     force, each alone (device time: 10 calls in one CUDA graph, the
     median of 11 replays), the plain version's (CUDA events around 10
     eager calls), for rank also one `torch.searchsorted` call's
     (library_ms) and, at step 20, the rank kernel on the unsorted queries
     and on one block of queries for each SM; each kernel's bound, the
     larger of its bytes (each input read once, each output written once;
     the starts entries it reads) at 3.35 TB/s and its fp32 operations at
     67 TFLOP/s (density 9 a candidate, 4 a pair within h and 1 a target;
     force 9 a candidate and 32 a pair within h and apart; rank 2 a
     binary-search step); Gpair/s; the tiled density's staging overhead
     (rows staged, from
     `fused.chunk_walk`, / rows of the union of each staging block's
     windows; the tiled force stages nothing); the force's packing pass
     (`fused.force_pack`) equal to `fused.force_pack_plain` bit for bit at
     each state, and timed alone (the tiled force's time includes it);
  4. parity at N = 4096: `bench_torch.verify_parity` on the card (10
     chained fields steps against 10 `cell_list` steps, multiset-compared,
     density rtol 1e-4, positions atol 1e-4; one `cell_list` step and one
     kernel step against the NumPy oracle of tests/oracle_numpy.py, density
     rtol 1e-4, positions atol 1e-5), and 10 kernel steps against 10 plain
     steps on the CPU, multiset-compared at the same bars;
  5. the timed path through the user's entry points: Simulator at 262,144
     particles, 3 warm-up steps and 100 timed `simulate_and_time` steps
     (each phase one CUDA-graph replay, the first step's capture and its
     warm-up among the warm-up steps; the copy to the host double-buffered
     on a side stream); prints the
     Times table and timesteps/s, checks that each kernel was launched,
     that no particle left the grid and that the state is finite;
  6. the rate probes: each probe kernel against its plain version for
     every dtype, stream count, pt and variant at 64 rounds (f32 FMA, f32
     density mix and loop probe rtol 1e-5; bf16 bit-equal), the density
     mix also at 67 rounds (no multiple of the rounds its loop takes at
     once) and at 1; the loop probe at 64, 67 and 1 rounds with its
     candidates staged in shared memory and read from device memory; the
     dynamic-trip variants also with desc[rounds] != rounds; at the entry
     points' round counts the f32 FMA bit-equal on tie-free inputs, and the
     loop probe (every variant at R, V0 and V1 at 4R) within rounds·eps
     and a mean difference under 1 % of one round's term; then
     the two probe entry points (`tpusph_torch.scripts.vpu_microbench` and
     `loop_probe`) at their own round counts, every rate finite and
     positive, and the share of the loop probe's calls that staged; the
     density mix's issue ceiling (the instructions of a round, counted from
     the SASS of its loop, on every scheduler of the card at the SM clock
     `nvidia-smi` reports) and the four loads a round found inside that
     loop; the probe's best f32 rate as bytes its loads move a clock and
     SM; the density kernel's time at each state beside
     `mix_ceiling_ms`, its candidate pairs over the probe's best f32 rate;
     the loop probe alone (ms a call by CUDA events and device ms of 10
     calls in one CUDA graph) for V0-V5 at pt 64 and V3 and V5 at pt 8
     and 128; the issue
     ceilings of V0, V3 and V5 from the SASS of their staged main loops,
     each round's three candidate loads (LDS) inside them, and the share of
     each ceiling reached by the call, its device time and the slope; V3's
     rate as bytes of candidate loads a clock and SM; and the force
     kernel's time at each state beside `force_mix_ms`, its candidate pairs
     over V5's rate (the force's op mix), and the finer reading that prices
     only the pairs that take the force arithmetic at V5's rate and the
     others at V3's;
  7. headless free mode through the command line, `python -m tpusph_torch
     -n 262144 -m free --frames 10 --click 2:400,300 --save ...`, run in
     this process: 10 PNGs, a saved state that is finite and inside the
     box; prints the wall time per frame, set-up and save included;
  8. the chained loop, CUDA graphs of chained steps:
     a. at N = 4096, grid and random init: `simulate_chunk(5)` with a click
        at step 2 (one graph replay) equals 5 sequential `simulate()` calls
        bit for bit (snapshots, final velocity), each kernel launched 5×
        its count in one replayed step; `dispatch_chunk(3)` with packed pixels and with
        bitmaps equals the projections of the sequential positions;
     b. at 262,144, grid init: 20 chained fields steps (`make_fields_chain`)
        against 20 `step_kernels` steps, multiset-compared by nearest
        neighbour (`bench_torch.hold_multisets`: density rtol 1e-4,
        positions atol 1e-4), and through `bench_torch.verify_headline`
        against 20 `cell_list` steps (the tile passes, their capacity grown
        on overflow), with the time the gate takes; one warm and one
        timed replay of the 100-step chain from grid init: timesteps/s
        beside phase 5's, the card's busy share (device time of the CUDA
        events only, at most 1) and device time by kernel over a profiled
        replay, each kernel launched 100 times a replay;
     c. the `cell_list` backend at 4096: 10 steps against the kernels at
        1e-4; grow-and-replay from tile_cand_capacity 64, step by step and
        through a 10-step chunk graph (overflow, rewind, capture again),
        ends with overflow 0 and positions within 1e-6 of an ample-capacity
        run;
     d. chunked free mode through the command line, `-n 262144 -m free
        --frames 32 --viz-chunk 8 --click 2:400,300` (bitmap frames, the
        default at this N): 32 PNGs; ms per frame beside phase 7's.
  9. the single-card remainder: the native host library builds and loads
     (required here); its raster of phase 5's final positions is byte-equal
     to the numpy raster, both timed on the host; `compute_diagnostics` of
     that state, 262,144 valid and finite; phase 7's frames as a GIF by
     the stdlib writer (`render.write_gif`) starts with GIF89a and holds 10
     frames; `--gif` (PIL where it imports, which folds repeated frames,
     else the stdlib writer) and `-m free` without a display through the
     command line at N = 4096 exit 0;
 10. the z-slab sharded engine (`tpusph_torch/dist/`) at 262,144, grid
     init, backend `kernels`:
     a. one rank, elided: 20 `make_sharded_step` steps against 20
        `step_kernels` steps, multiset-compared as in 8b; counters clean;
        one rank, one density and one force launch a step (the step's
        capture made first); timesteps/s of a 100-step `make_sharded_run`
        (one replay) beside phase 5's and phase 8's;
     b. the same with TPUSPH_DIST_FULL_MACHINERY=1: dead halo buffers,
        the splice and the migration sort;
     c. four ranks on the one card, a process each over a gloo group
        (exchanges staged through host memory), balanced slab planes and
        capacities from the initial occupancy: 20 steps, the collected
        positions within 1e-4 of the 20 `step_kernels` steps, counters
        clean, every rank sent a non-empty halo, 20 launches of each kernel
        a rank; on every rank's combined rows at step 20 (ghost rows on its
        faces) rank exact, density rtol 1e-5, force rtol 1e-4 atol 1e-4
        against their plain versions; ms a step and the share spent inside
        the exchanges. Four ranks time-share one card: a check of
        correctness, not a scaling figure. Also the operations a step on
        the card (profiler) of 10a and 10b;
 11. the brick engine (`tpusph_torch/dist/mesh3d.py`) at 262,144, grid
     init, backend `kernels`:
     a. one rank as a (1, 1, 1) grid, the whole machinery with every
        exchange returning zeros (halo rows a direction 262,144 on every
        axis, migration 4,096): 20 `make_mesh3d_step` steps
        against 20 `step_kernels` steps, multiset-compared as in 8b;
        counters clean; one rank, one density and one force launch a step;
        timesteps/s of a 100-step `make_mesh3d_run` (one replay) and its
        operations a step on the card, beside 10a and 10b;
     b. four ranks as a (1, 2, 2) grid on the one card over gloo (the y and
        x phases staged, corner rows forwarded), `DistSimulator` with its
        balanced brick planes and capacities (a warm-up `run(20)` grows
        what overflows, one `simulate()` captures the step, then grid init
        again): 20 `simulate()` steps (graph segments), positions
        by pid within 1e-4 of the 20 `step_kernels` steps, counters clean,
        every rank sent halo rows along y and along x, 20 launches of each
        kernel a rank; at step 20, on every rank's combined rows, rank
        exact, density rtol 1e-5, force rtol 1e-4 atol 1e-4 against their
        plain versions; ms a step and the share inside the exchanges;
     c. the command line: `-n 262144 -m time --mesh z --save ...` and
        `--mesh 1x1x1 --save ...` in this process, each printing the Times
        table (timesteps/s beside phase 5's) and saving 262,144 valid,
        finite rows inside the box; `torchrun --standalone --nproc_per_node
        2 -m tpusph_torch -n 262144 -m time --steps 20 --mesh 1x1x2` exits 0
        with exactly one Times table;
 12. the bench and the driver entry points: `python3 bench_torch.py` at
     262,144 with its gates, as a subprocess: its line's metric, parity
     "pass" and the card's name; its timed run again in this process with
     the gates off, each of the rank, density and force kernels launched;
     `TPUSPH_BENCH_DIST=1 python3 bench_torch.py` (one rank, its gate on)
     with its artifact in a temporary directory; `graft_entry.entry()`'s
     step once on the card; `scripts.fields_profile` at steps 0 and 60 and
     `scripts.build_bench` once, every time positive;
 13. the last modules: the migration-free sort skip of the z-slab engine,
     sharded checkpoints, the slab census and the scaling model:
     a. one slab rank through the whole machinery at 262,144 grid init, the
        eager step (`make_sharded_step(...).eager`, whose skip is the host
        read a line of several ranks takes): 20 steps with
        TPUSPH_DIST_FORCE_MIGSORT=1 and 20 with the skip, every
        row of positions, velocities, valid and pids and the nine counters
        bit for bit after every step, (sorts, skips) (20, 0) and (0, 20),
        20 launches of each kernel a run; `_device_update`'s device ms
        (profiler) and wall ms in each mode;
     b. four slab ranks on the card over gloo, 262,144 random init with the
        rows within 0.05 below each interior face given vz = 2, so that
        they cross: 20 steps in each mode bit for bit on every rank, both
        branches taken over the ranks, 20 launches of each kernel a rank;
        then 20 graphed steps (`make_sharded_step`, segments between the
        exchanges, the migration's branch a conditional node, phase 16)
        bit for bit with the eager steps on every rank, both branches
        taken on the card over the ranks, one conditional node a step (in
        the segment after the halo exchange), 20 launches of each kernel
        and of `set_if` a rank;
     c. `DistSimulator` on one rank, 10 steps, `save_dist_state`,
        `load_dist_state`, 10 more steps: within 1e-5 of 20 uninterrupted
        steps;
     d. `scripts.slab_census` at 262,144 grid init, 100 steps in chunks of
        10 on the card (the fields chain), written to a temporary
        directory: within `slab_census.compare`'s bars of
        scaling/census_n262144.json at every checkpoint, the counts that
        differ at all listed;
     e. `scripts.scaling_model` on the repo's artifacts (TORCH_DIST_BENCH*.json,
        scaling_torch/), its tables printed;
 14. graphs: at 262,144 grid init, each graphed entry point against the
     same function run eagerly on the same input (`.eager`, or the timed
     phases' bodies run eagerly), bit for bit after each of 3 calls, with
     sync debug mode "error" around the graphed calls: `make_step`,
     `make_impulse`, and on one rank the slab step (elided and through the
     whole machinery, a click at the second), timed stages and 3-step run
     and the (1, 1, 1) brick's; the capture's seconds and the launches of
     one replay (one of each kernel a step, none for the impulse);
     `Simulator.simulate_and_time` graphed and eager in turns (graphs,
     eager, eager, graphs) of 100 steps, its Times tables, timesteps/s,
     busy share (profiler, 10 steps) and equal end states; the sharded
     bench on one rank (`DistSimulator` right-sized, a warm and a timed
     100-step `run`) elided and through the whole machinery at 262,144
     and 1,048,576, graphed and eager in turns, timesteps/s, busy share
     (profiler, a 10-step run), equal end states; the (1, 1, 1) `DistSimulator`'s timed step (the
     CLI's `--mesh 1x1x1`) likewise over 20 steps a run, its halo a whole
     block;
 15. multi-rank graphs: four ranks on the card over gloo, one process
     each, as a z-slab line (262,144 grid init, phase 10c's planes and
     capacities, 105,824 rows a rank) and as a (1, 2, 2) brick grid
     (`DistSimulator`'s planes and capacities after a warm-up run): each
     graphed entry point of both engines (step, a click at the second;
     timed stages; run(20)) against its `.eager` bit for bit after each of
     3 calls on every rank, every segment replayed under sync debug mode
     "error"; the chain of each body (segments and transports), the
     launches of each segment a replay, the capture's seconds; ms a step
     of 20 `step()` calls and of a `run(20)` graphed and eager in turns
     (graphs, eager, eager, graphs), and the share of each inside the
     transports (exchanges and reduces, the card drained before each);
     then `TPUSPH_BENCH_DIST=2 torchrun --standalone --nproc_per_node 2
     bench_torch.py` (its gate on), its artifact `graphed`. Phase 11c's
     `torchrun ... --mesh 1x1x2` is the command line's multi-rank run,
     which these graphs carry. Four ranks time-share one card: a check of
     correctness, not a scaling figure;
 16. the device branch, tpusph's `lax.cond` (`graphs.device_if`,
     `kernels/graph_cond.py`, `csrc/graph_cond.cu` in the port's library):
     a. `set_if` and its if node on the predicates -2, 0, 1, 5 and, in the
        same graph replayed, 3, 1, 0, -4: the body ran exactly where the
        plain version, pred > 0, holds; one conditional node a graph
        (`graph_cond.node_counts`, libcuda's node types); the device
        ms of one `set_if` and its node, 100 in one graph, with the body
        skipped (the row's ms) and run, against the plain version's;
     b. one slab rank through the whole machinery at 262,144 grid init,
        `make_sharded_run(20)` graphed with the skip and with
        TPUSPH_DIST_FORCE_MIGSORT=1, and its eager run (the host-read
        skip): bit for bit, (sorts, skips) (0, 20), (20, 0), (0, 20); the
        run graph's node types, one conditional node a step with the skip
        and none with the sort; the first call's seconds (capture and
        replay); the skip run replayed, each kernel and `set_if` launched
        20 times (this slice's path);
     c. the sharded bench on one rank through the whole machinery at
        262,144 and 1,048,576 (phase 14c's protocol), graphed, the sort
        and the skip in turns (sort, skip, skip, sort): timesteps/s, busy
        share, (sorts, skips) (100, 0) and (0, 100), 0 and 100 conditional
        nodes in the 100-step run graph, the runs equal bit for bit.
The probes' bounds are their FMA (2 flops) or operation counts at 67
TFLOP/s. Each path's kernel launch counts are set to 0 just before it and
read just after; the main path's kernels are the rank, density, force
packing (`fused.force_pack`) and force kernels, and every path launches
one packing pass for each force launch. A wrapper counts where it
launches its kernel; inside a CUDA graph
(phase 8) the launches recorded at capture are what each replay adds
(`tpusph_torch/engine/graphs.py`). It then prints one JSON line of
per-kernel results (the main path's launches, the launches in one replay
of the 100-step chain, and for rank, density and force the numbers at step
20 with each state's under "by_step", the sharded and brick paths'
launches and phase 13's under "dist_launches", bench_torch's timed run's under
"bench_launches", one replay of each graphed entry point of phase 14 and
of the four-rank steps of phase 15 under "graph_launches", phase 16b's
replayed run under "branch_launches"; the packing pass's launches and its
largest difference from its plain version under the force's
"pack_launches" and "pack_max_abs_err"; set_if's row with its launches in
16b's run and its time with the body run under "body_ms") and, last, one
JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

import bench_torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 262_144
N_PARITY = 4096
TIMED_STEPS = 100
WARMUP_STEPS = 3
CHECK_ROUNDS = 64  # rounds at which the probes are held against their plain versions
MIX_ROUNDS = (CHECK_ROUNDS, 67, 1)  # the density mix's: 67 is no multiple of its unroll
LOOP_ROUNDS = (CHECK_ROUNDS, 67, 1)  # the loop probe's, likewise
FREE_FRAMES = 10
FREE_CLICK = "2:400,300"  # frame:pixel, the box centre
CHAIN_STEPS = 100  # steps per replay of the timed fields chain (bench.py's)
CHAIN_PARITY_STEPS = 20
CHUNK_FRAMES, VIZ_CHUNK = 32, 8
DIST_STEPS = 20  # sharded steps held against step_kernels in phase 10
DIST_RANKS = 4  # processes sharing the one card in phase 10c
DIST_HALO_ONE_CARD = 16_384  # dead halo rows a side in phase 10b
DIST_MIGRATION = 4096
DIST_DEADLINE_S = 300.0
PROFILED_STEPS = 10  # steps of the profiled run that counts a step's operations on the card
BRICK_GRID = (1, 2, 2)  # phase 11b: four ranks, the y and x phases staged
TORCHRUN_MESH, TORCHRUN_RANKS = "1x1x2", 2  # phase 11c
BENCH_TIMEOUT_S = 600  # a bench_torch.py subprocess of phase 12
SKIP_STEPS = 20  # phase 13a and 13b: steps with the skip and with the sort
CHECKPOINT_STEPS = 10  # phase 13c: steps before and after the checkpoint
CENSUS_STEPS, CENSUS_CHUNK = 100, 10  # phase 13d
SKIP_KICK = (0.05, 2.0)  # phase 13b: rows this far below a slab face get this vz
GRAPH_STEPS = 3  # phase 14: replays held bit for bit against the eager calls
GRAPH_TIERS = (262_144, 1_048_576)  # phase 14: the sharded bench's tiers
MESH_TIMED_STEPS = 20  # phase 14: timed steps a run of the (1, 1, 1) DistSimulator
RANK_GRAPH_STEPS = 20  # phase 15: steps a timed turn, and the run's
GRAPH_CLICK = (400, 300)  # phase 14: the click of the graphed impulse and steps
BRANCH_PREDS = (-2, 0, 1, 5)  # phase 16a: set_if's predicates, held against its plain version
BRANCH_NODES = 100  # phase 16a: if nodes in the graph that times set_if
KERNEL_STATES = (0, 20, 100)  # steps of 262,144 grid init at which phase 3 checks and times
TIMED_STATE = 20  # the state of each kernel row's own numbers in the JSON line
# the main path's kernels, in the order of `main_kernels()`: the force's
# packing pass (`fused.force_pack`) runs once before each force launch
KERNEL_NAMES = ("rank", "density", "pack", "force")
# H100 SXM peaks (NVIDIA's data sheet) for the bounds
MEM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
H100_SMS = 132


def require(ok, msg: str) -> None:
    """Fail the run (an `assert` would vanish under `python -O`)."""
    if not ok:
        raise RuntimeError(msg)


def main_kernels() -> tuple:
    """The main path's kernel wrappers, named by KERNEL_NAMES."""
    from tpusph_torch.kernels import fused, qrank

    return (qrank.rank_queries, fused.density, fused.force_pack, fused.force)


def hold_packed(launches: dict, what: str) -> None:
    """One packing pass for each force launch ({name: launches})."""
    require(launches["pack"] == launches["force"],
            f"{what}: {launches['pack']} force packings for {launches['force']} force launches")


def kernel_name(line: str) -> str:
    """A kernel's name and integer template arguments from ptxas's line
    with its mangled name (`<length><name>` then `I...E` for the
    arguments), e.g. fma_f32_kernel<8>; the line if none."""
    for m in re.finditer(r"(?=(\d{1,2})([a-z]\w*?_kernel)[IE])", line):
        if int(m.group(1)) == len(m.group(2)):
            args = re.match(r"I((?:L[ib]\d+E)+)E", line[m.end(2):])
            if not args:
                return m.group(2)
            return m.group(2) + "<" + ", ".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
    return line.strip()


def time_ms(fn, reps: int) -> float:
    """Median over `reps` batches of 10 back-to-back calls, in ms per call,
    from CUDA events on the current stream (wrapper overhead included)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 10)
    return statistics.median(samples)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what binds it: bytes
    at the memory rate or operations at the fp32 rate."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_stats(key, starts, cfg):
    """(candidates, distinct starts entries a pass reads, (rows the tiled
    density stages, rows of its staging blocks' window unions, share of
    blocks that stage))."""
    from tpusph_torch.kernels import fused

    nc = cfg.num_cells
    live = key < nc
    offs = torch.tensor(fused.column_offsets(cfg), device=key.device)
    base = key[live].long()[:, None] + offs
    lo = (base - 1).clamp(0, nc)
    hi = torch.maximum((base + 2).clamp(max=nc), lo)
    entries = int(torch.unique(torch.cat([lo.flatten(), hi.flatten()])).numel())
    begin, count = fused.windows(key, starts, cfg)
    n = key.numel()
    # tiled density: the rows staged against the rows of each (block,
    # column)'s union
    t = fused.DENSITY_TILE
    c = torch.nn.functional.pad(count, (0, 0, 0, -n % t)).view(-1, t, 9)
    b = torch.nn.functional.pad(begin, (0, 0, 0, -n % t)).view(-1, t, 9)
    e = torch.where(c > 0, b + c, -1)
    seen = torch.cummax(e, dim=1).values
    seen = torch.cat([torch.full_like(seen[:, :1], -1), seen[:, :-1]], dim=1)
    lives = torch.nn.functional.pad(live, (0, -n % t)).view(-1, t).sum(dim=1)
    staged = (lives > 0) & (c.sum(dim=(1, 2)) >= lives * fused.DENSITY_STAGE_MIN)
    needed = int((e - torch.maximum(b, seen)).clamp(min=0).sum(dim=(1, 2))[staged].sum())
    walk = fused.chunk_walk(key, starts, cfg, stage_min=fused.DENSITY_STAGE_MIN)
    staging = (int(fused.staged_slots(walk[:, 3], walk[:, 4]).sum()), needed,
               float(staged.float().mean()))
    return int(count.sum()), entries, staging


def kernel_phase(card: str, dev) -> dict:
    """Phase 3 (see the module docstring). Returns the kernel rows of the
    JSON line for rank, density and force."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.engine.step import build_phase, make_step
    from tpusph_torch.kernels import fused, qrank
    from tpusph_torch.physics.kernels import pressure_from_density
    from tpusph_torch.scripts import graph_ms

    cfg = tuned_config(N_MAIN)
    nc = cfg.num_cells
    step = make_step(cfg, "kernels", dev)
    states = {}
    st = init_state(cfg, device=dev)
    for k in range(max(KERNEL_STATES) + 1):
        if k in KERNEL_STATES:
            states[k] = st
        st, _ = step(st)
    results = {
        "rank": dict(route="cuda", source="tpusph_torch/csrc/qrank.cu",
                     replaces="tpusph/pallas/qrank.py:234", max_abs_err=0.0),
        "density": dict(route="cuda", source="tpusph_torch/csrc/sph.cu",
                        replaces="tpusph/pallas/fused.py:1200", max_abs_err=0.0,
                        max_abs_diff_baseline=0.0),
        "force": dict(route="cuda", source="tpusph_torch/csrc/sph.cu",
                      replaces="tpusph/pallas/fused.py:1540", max_abs_err=0.0,
                      pack_max_abs_err=0.0),
    }
    for r in results.values():
        r["by_step"] = {}
    cells = torch.arange(nc + 2, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    repeats = torch.randint(0, nc + 2, (500_000,), device=dev, generator=gen).sort().values
    query_sets = {
        "cells": cells,
        "unsorted": cells[torch.randperm(nc + 2, device=dev, generator=gen)],
        "repeats": torch.cat([repeats, torch.tensor([nc + 1, nc + 7, 2**30], device=dev)]
                             ).to(torch.int32),
        "offset": cells[1:],  # contiguous, 4 bytes past a 16-byte boundary
    }
    require(query_sets["offset"].data_ptr() % 16 == 4, "the offset queries are aligned")
    for label, st in states.items():
        cl = build_phase(st, cfg)
        key, starts = cl.key_sorted, cl.starts
        n = key.numel()
        shares = {}
        for qname, q in query_sets.items():
            rk, ovf = qrank.rank_queries(key, q, nc)
            rp = qrank.rank_queries_plain(key, q, nc)
            torch.testing.assert_close(rk, rp, rtol=0, atol=0)
            require(ovf == 0, f"rank overflow {ovf}")
            results["rank"]["max_abs_err"] = max(results["rank"]["max_abs_err"],
                                                 float((rk - rp).abs().max()))
            lo, hi, staged = qrank.block_spans(key, q)
            empty = hi == lo
            shares[qname] = dict(
                blocks=lo.numel(), empty=float(empty.float().mean()),
                staged=float((staged & ~empty).float().mean()),
                wide=float((~staged).float().mean()),
                mean_span=float((hi - lo).float().mean()), max_span=int((hi - lo).max()))
        print(f"step {label}: rank blocks of {qrank.BLOCK_QUERIES} queries, stage "
              f"{qrank.STAGE} keys, share (empty span, staged, searched in device memory): "
              + "; ".join(f"{k} {v['empty']:.4f}, {v['staged']:.4f}, {v['wide']:.4f} (mean span "
                          f"{v['mean_span']:.1f}, widest {v['max_span']})"
                          for k, v in shares.items()) + f"; {card}")

        xyz = st.position[cl.perm].T.contiguous()
        vxyz = st.velocity[cl.perm].T.contiguous()
        dk = fused.density(*xyz, key, starts, cfg)
        db = fused.density_baseline(*xyz, key, starts, cfg)
        dp = fused.density_plain(*xyz, key, starts, cfg)
        torch.testing.assert_close(dk, dp, rtol=1e-5, atol=0)
        torch.testing.assert_close(db, dp, rtol=1e-5, atol=0)
        rho, p = pressure_from_density(dk, cfg)
        rho = torch.where(cl.valid_sorted, rho, 1.0)
        p = torch.where(cl.valid_sorted, p, 0.0)
        # the force's packing pass against its plain version, bit for bit
        for got, want in zip(fused.force_pack(*xyz, *vxyz, rho, p),
                             fused.force_pack_plain(*xyz, *vxyz, rho, p)):
            require(torch.equal(got, want),
                    f"step {label}: the force's packed rows differ from force_pack_plain")
            results["force"]["pack_max_abs_err"] = max(
                results["force"]["pack_max_abs_err"], float((got - want).abs().max()))
        fk = fused.force(*xyz, *vxyz, rho, p, key, starts, cfg)
        fp = fused.force_plain(*xyz, *vxyz, rho, p, key, starts, cfg)
        torch.testing.assert_close(fk, fp, rtol=1e-4, atol=1e-4)
        for name, got, plain in (("density", dk, dp), ("force", fk, fp)):
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], float((got - plain).abs().max()))
        # the tiled density against its first design, bit for bit: the
        # reference of its staged and direct paths
        diff = float((dk - db).abs().max())
        results["density"]["max_abs_diff_baseline"] = max(
            results["density"]["max_abs_diff_baseline"], diff)
        if diff:
            worst = int((dk - db).abs().argmax())
            print(f"step {label}: the tiled density differs from density_baseline by up to "
                  f"{diff:.3e} (row {worst}, key {int(key[worst])}; {card})")
        require(diff == 0, f"step {label}: the tiled density differs from density_baseline")
        cand, entries, staging = window_stats(key, starts, cfg)
        _, within, apart = fused.pair_counts(*xyz, key, starts, cfg)
        _, count = fused.windows(key, starts, cfg)
        print(f"step {label}: ranks equal (cells, unsorted, repeats and above num_cells, "
              f"off 16 bytes); the force's packed rows equal their plain "
              f"version bit for bit; density max|err| "
              f"{float((dk - dp).abs().max()):.3e} (max rho {float(dk.max()):.3f}); "
              f"force max|err| {float((fk - fp).abs().max()):.3e} "
              f"(max |f| {float(fk.abs().max()):.3f}); max |tiled - density_baseline| "
              f"{diff:.3e}; widest window "
              f"{int(count.max())}; max p {float(p.max()):.3f}; {card}")
        rows, need, frac = staging
        print(f"step {label}: candidate pairs {cand}, within h {within}, force pairs "
              f"{apart}; tiled density "
              f"(T {fused.DENSITY_TILE}, S {fused.DENSITY_CHUNK}, staging from "
              f"{fused.DENSITY_STAGE_MIN}): blocks staged {frac:.4f}, {rows} rows staged / "
              f"{need} needed = {rows / max(need, 1):.4f}; tiled force stages nothing; {card}")

        # bounds: each input read once, each output written once
        nbytes = {
            "rank": 4 * (n + 2 * (nc + 2)),
            "density": 4 * (n + entries + 3 * n + n),
            "force": 4 * (n + entries + 8 * n + 3 * n),
        }
        flops = {
            "rank": 2 * (nc + 2) * math.ceil(math.log2(n + 1)),
            "density": 9 * cand + 4 * within + int(cl.valid_sorted.sum()),
            "force": 9 * cand + 32 * apart,
        }
        calls = {
            "density": (lambda: fused.density(*xyz, key, starts, cfg),
                        lambda: fused.density_plain(*xyz, key, starts, cfg)),
            "force": (lambda: fused.force(*xyz, *vxyz, rho, p, key, starts, cfg),
                      lambda: fused.force_plain(*xyz, *vxyz, rho, p, key, starts, cfg)),
        }
        for name, (kern, plain) in calls.items():
            row = dict(ms=graph_ms(kern), plain_ms=time_ms(plain, 3), library_ms=None)
            row["bound_ms"], row["bound_by"] = bound(nbytes[name], flops[name])
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            results[name]["by_step"][label] = row
            print(f"time {name} at step {label}: tiled {row['ms']:.4f} ms; plain "
                  f"{row['plain_ms']:.4f} ms; "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes[name]} B, "
                  f"{flops[name]} flop), share {row['share_of_bound']:.4f}; tiled "
                  f"{cand / row['ms'] / 1e6:.2f} Gpair/s (N={N_MAIN}; {card})")
        results["density"]["by_step"][label]["candidate_pairs"] = cand
        results["force"]["by_step"][label].update(candidate_pairs=cand, force_pairs=apart)
        # the force's packing pass alone (part of the tiled force's time above)
        pack_ms = graph_ms(lambda: fused.force_pack(*xyz, *vxyz, rho, p))
        results["force"]["by_step"][label]["pack_ms"] = pack_ms
        print(f"time force packing at step {label}: {pack_ms:.4f} ms of the tiled force's "
              f"{results['force']['by_step'][label]['ms']:.4f} (N={N_MAIN}; {card})")

        row = dict(ms=graph_ms(lambda: qrank.rank_queries(key, cells, nc)),
                   plain_ms=time_ms(lambda: qrank.rank_queries_plain(key, cells, nc), 21),
                   library_ms=graph_ms(lambda: torch.searchsorted(key, cells, out_int32=True)),
                   blocks=shares["cells"])
        row["bound_ms"], row["bound_by"] = bound(nbytes["rank"], flops["rank"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        results["rank"]["by_step"][label] = row
        print(f"time rank at step {label}: {row['ms']:.4f} ms; plain "
              f"{row['plain_ms']:.4f} ms, torch.searchsorted {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes['rank']} B), share "
              f"{row['share_of_bound']:.4f} (N={N_MAIN}; {card})")
        if label == TIMED_STATE:
            unsorted = query_sets["unsorted"]
            row["unsorted_ms"] = graph_ms(lambda: qrank.rank_queries(key, unsorted, nc))
            print(f"time rank at step {label} on unsorted queries: {row['unsorted_ms']:.4f} ms "
                  f"(N={N_MAIN}; {card})")
            # One block for each SM: a block's own chain of loads and barriers
            # plus the launch, with nothing queued behind it.
            few = cells[: H100_SMS * qrank.BLOCK_QUERIES]
            row["one_block_per_sm_ms"] = graph_ms(lambda: qrank.rank_queries(key, few, nc))
            print(f"time rank at step {label} on the first {few.numel()} cells (one block of "
                  f"{qrank.BLOCK_QUERIES} for each of {H100_SMS} SMs): "
                  f"{row['one_block_per_sm_ms']:.4f} ms (N={N_MAIN}; {card})")
    for r in results.values():  # the row's own numbers: step 20, as before
        r.update(r["by_step"][TIMED_STATE])
        r["at"] = f"{N_MAIN} grid init, step {TIMED_STATE}"
    return results


def live_particles(fs, cfg):
    """(positions, density) of the live particles of a fields state, the
    density from one pass of the density kernel over it."""
    from tpusph_torch.kernels import fused
    from tpusph_torch.neighbors.cell_list import build_sorted_fields_1d
    from tpusph_torch.physics.kernels import pressure_from_density

    sf = build_sorted_fields_1d(*fs, cfg)
    rho, _ = pressure_from_density(
        fused.density(sf.x, sf.y, sf.z, sf.key_sorted, sf.starts, cfg), cfg)
    v = sf.valid_sorted
    pos = torch.stack([sf.x, sf.y, sf.z], dim=1)[v]
    return pos.cpu().numpy(), rho[v].cpu().numpy()


def hold_multisets(cfg, fs_a, fs_b) -> float:
    """Hold two fields states of N_MAIN particles against each other as
    multisets by nearest neighbour (`bench_torch.hold_multisets`: positions
    within 1e-4 both ways and by coordinate, density rtol 1e-4 at paired
    positions), the density from one pass of the density kernel over each.
    Returns max|dpos| of the paired particles."""
    pa, ra = live_particles(fs_a, cfg)
    pb, rb = live_particles(fs_b, cfg)
    require(len(pa) == len(pb) == N_MAIN, "a run lost particles")
    dpos = bench_torch.hold_multisets("multisets", (pa, ra), (pb, rb))
    require(dpos is not None, "the runs differ as multisets (details on stderr)")
    return dpos


def gif_frame_count(path: str) -> int:
    """Image descriptors of a GIF89a file, found by walking its blocks."""
    with open(path, "rb") as f:
        data = f.read()
    require(data[:6] == b"GIF89a", f"{path} does not start with GIF89a")
    pos = 13 + (3 * 2 ** ((data[10] & 7) + 1) if data[10] & 0x80 else 0)

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += 1 + data[pos]
        return pos + 1

    frames = 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # extension: label, then sub-blocks
            pos = skip_sub_blocks(pos + 2)
        else:
            require(data[pos] == 0x2C, f"{path}: unknown block {data[pos]:#x} at {pos}")
            frames += 1
            local = data[pos + 9]
            pos += 10 + (3 * 2 ** ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)  # past the LZW minimum code size
    return frames


def remainder_phase(card: str, state, gif_frames: int, dev) -> None:
    """Phase 9 (see the module docstring). `state` is phase 5's final
    state; `gif_frames` what phase 7's frames made as a GIF."""
    from tpusph_torch import cli
    from tpusph_torch.bench.diagnostics import compute_diagnostics, format_diagnostics
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.utils import native
    from tpusph_torch.viz import render

    lib = native.get_lib()
    require(lib is not None, "the native library did not build or load")
    print(f"native library: {os.path.relpath(native.library_path(), REPO)}, ABI "
          f"{lib.sph_native_abi_version()}")
    pos = state.position[:N_MAIN].cpu().numpy()
    rasters = {}
    for name, fn in (("native", native.render_frame_native), ("numpy", render._render_frame_numpy)):
        fn(pos)
        t0 = time.perf_counter()
        for _ in range(5):
            img = fn(pos)
        rasters[name] = (img, (time.perf_counter() - t0) / 5 * 1e3)
    require(np.array_equal(rasters["native"][0], rasters["numpy"][0]),
            "the native raster differs from the numpy raster")
    require(np.array_equal(render.render_frame(pos), rasters["native"][0]),
            "render_frame did not take the native raster")
    print(f"host raster of {N_MAIN} positions (host time, mean of 5): native "
          f"{rasters['native'][1]:.3f} ms, numpy {rasters['numpy'][1]:.3f} ms, byte-equal; "
          f"{int((rasters['native'][0][..., 2] == 255).sum())} blue or white pixels")

    d = compute_diagnostics(state, tuned_config(N_MAIN))
    print(f"diagnostics after phase 5: {format_diagnostics(d)}")
    require(d.num_valid == N_MAIN, f"diagnostics count {d.num_valid} valid particles")
    require(all(math.isfinite(x) for x in (d.kinetic_energy, *d.momentum, d.max_speed,
                                           d.mean_density, d.max_density)),
            f"non-finite diagnostics {d}")
    require(d.occupied_cells > 0 and d.max_cell_occupancy >= 1, f"empty grid in {d}")

    require(gif_frames == FREE_FRAMES, f"phase 7's GIF holds {gif_frames} frames")
    display = os.environ.pop("DISPLAY", None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            gif = os.path.join(tmp, "small.gif")
            rc = cli.main(["-n", str(N_PARITY), "-m", "free", "--frames", "4", "--out",
                           os.path.join(tmp, "frames"), "--gif", gif])
            require(rc == 0, f"--gif exited {rc}")
            # PIL folds a frame equal to the one before it into that frame's
            # duration; the stdlib writer keeps all 4
            cli_frames = gif_frame_count(gif)
            require(cli_frames == 4 or (_has_pil() and 1 <= cli_frames < 4),
                    f"--gif wrote {cli_frames} frames of 4")
        rc = cli.main(["-n", str(N_PARITY), "-m", "free"])
        require(rc == 0, f"-m free without a display exited {rc}")
    finally:
        if display is not None:
            os.environ["DISPLAY"] = display
    print(f"--gif: {FREE_FRAMES} frames of phase 7 by the stdlib writer; through the command "
          f"line {cli_frames} of 4 frames at N={N_PARITY} "
          f"({'PIL, which folds repeated frames' if _has_pil() else 'the stdlib writer: no PIL'}"
          f"); -m free without a display exits 0")


def _has_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def fields_of_block(state):
    """A DistState block as a FieldsState."""
    from tpusph_torch.engine.step import FieldsState

    cols = (a[:, i].contiguous() for a in (state.position, state.velocity) for i in range(3))
    return FieldsState(*cols, state.valid)


def hold_clean(aux, n: int, what: str) -> None:
    for name in ("halo_overflow", "migration_overflow", "window_overflow", "oob_count",
                 "misrouted"):
        require(int(getattr(aux, name)) == 0, f"{what}: {name} = {int(getattr(aux, name))}")
    require(int(aux.num_particles) == n, f"{what}: {int(aux.num_particles)} particles")


def hold_kernels_on_rows(key, x, y, z, vx, vy, vz, cfg) -> tuple[float, float]:
    """The rank, density and force kernels against their plain versions on
    one rank's combined rows (ghost rows included) at phase 3's bars: rank
    exact, density rtol 1e-5, force rtol 1e-4 atol 1e-4. Returns the
    density's and the force's largest differences."""
    from tpusph_torch.kernels import fused, qrank
    from tpusph_torch.neighbors.cell_list import starts_from_sorted
    from tpusph_torch.physics.kernels import pressure_from_density

    starts, _ = starts_from_sorted(key, cfg)
    cells = torch.arange(cfg.num_cells + 2, dtype=torch.int32, device=key.device)
    torch.testing.assert_close(starts, qrank.rank_queries_plain(key, cells, cfg.num_cells),
                               rtol=0, atol=0)
    dk = fused.density(x, y, z, key, starts, cfg)
    dp = fused.density_plain(x, y, z, key, starts, cfg)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=0)
    rho, p = pressure_from_density(dk, cfg)
    valid = key < cfg.num_cells
    rho, p = torch.where(valid, rho, 1.0), torch.where(valid, p, 0.0)
    fk = fused.force(x, y, z, vx, vy, vz, rho, p, key, starts, cfg)
    fp = fused.force_plain(x, y, z, vx, vy, vz, rho, p, key, starts, cfg)
    torch.testing.assert_close(fk, fp, rtol=1e-4, atol=1e-4)
    return float((dk - dp).abs().max()), float((fk - fp).abs().max())


def device_ops_per_step(run, start, steps: int) -> float:
    """Operations the card ran a step (kernels, copies and fills), counted
    by torch.profiler over one call `run(start)` of `steps` steps, after a
    first call (the capture of a graphed run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(start)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(start)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / steps


def dist_rank(comm, payload: dict) -> None:
    """One of phase 10c's ranks (a process of its own on the one card):
    20 sharded steps from grid init, then the checks of the module
    docstring; writes its numbers to `payload["out"]/rank<r>.json`."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.dist import sharded

    n = payload["n"]
    cfg = tuned_config(n)
    dcfg = sharded.DistConfig(**payload["dcfg"])
    dev = comm.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    kernels = main_kernels()
    state = sharded.distribute_state(init_state(cfg, device="cpu"), cfg, dcfg, comm)
    occupancy = int(state.valid.sum())
    step = sharded.make_sharded_step(cfg, dcfg, comm)
    state, _ = step(state)  # warm-up: loads the library, fills the caches
    state = sharded.distribute_state(init_state(cfg, device="cpu"), cfg, dcfg, comm)

    # time spent inside the exchanges, the card drained before each so that
    # the wait for the kernels queued ahead is not charged to them (the
    # transport a graphed step replays between its segments)
    exchange, spent = comm._exchange, [0.0]

    def timed_exchange(up, dn, below, above):
        sync()
        t0 = time.perf_counter()
        out = exchange(up, dn, below, above)
        sync()
        spent[0] += time.perf_counter() - t0
        return out

    comm._exchange = timed_exchange
    for fn in kernels:
        fn.launches = 0
    auxs = []
    sync()
    t0 = time.perf_counter()
    for _ in range(DIST_STEPS):
        state, aux = step(state)
        auxs.append(aux)
    sync()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    del comm._exchange  # the wrapper refers to comm: no cycle left behind
    for k, aux in enumerate(auxs):
        hold_clean(aux, n, f"rank {comm.rank} step {k}")
        require(int(aux.max_halo_send) > 0, f"step {k}: empty halos on every rank")
    for name, count in zip(KERNEL_NAMES, launches):
        require(count == DIST_STEPS,
                f"rank {comm.rank}: {name} launched {count} times in {DIST_STEPS} steps")

    got = sharded.collect_state(state, n, comm)
    want = np.load(payload["reference"])
    require(not np.isnan(got["position"]).any(), "a particle is on no rank")
    np.testing.assert_allclose(got["position"], want, rtol=0, atol=1e-4)

    # this rank's combined rows at step 20, ghosts on its faces: the three
    # kernels against their plain versions at phase 3's bars
    key, x, y, z, vx, vy, vz, tag, _ovf, _oob, halo_send = sharded._device_build(
        *state, cfg, dcfg, comm)
    require(int(halo_send) > 0, f"rank {comm.rank} sent an empty halo")
    live_ghost = (tag == -2) & (key < cfg.num_cells)
    first_local = int((tag >= 0).nonzero()[0])
    ghosts = (int(live_ghost[:first_local].sum()), int(live_ghost[first_local:].sum()))
    require(ghosts[0] > 0 or comm.rank == 0, f"rank {comm.rank}: no ghost rows below")
    require(ghosts[1] > 0 or comm.rank == comm.size - 1, f"rank {comm.rank}: no ghost rows above")
    density_err, force_err = hold_kernels_on_rows(key, x, y, z, vx, vy, vz, cfg)
    with open(os.path.join(payload["out"], f"rank{comm.rank}.json"), "w") as f:
        json.dump({
            "rank": comm.rank, "occupancy": occupancy, "rows": key.numel(),
            "ghosts_below": ghosts[0], "ghosts_above": ghosts[1],
            "halo_send": int(halo_send), "launches": launches,
            "ms_per_step": wall / DIST_STEPS * 1e3,
            "exchange_ms_per_step": spent[0] / DIST_STEPS * 1e3,
            "max_halo_send": max(int(a.max_halo_send) for a in auxs),
            "max_migration_send": max(int(a.max_migration_send) for a in auxs),
            "max_dev_particles": max(int(a.max_dev_particles) for a in auxs),
            "density_max_abs_err": density_err, "force_max_abs_err": force_err,
        }, f)


def four_slab_caps(cfg):
    """(planes, occupancy, DistConfig fields) of DIST_RANKS slab ranks at
    grid init: balanced slab planes, dev capacity 1.25x the most loaded
    slab, halo 1.5x the fullest 2-cell band."""
    from tpusph_torch.core.init import grid_positions
    from tpusph_torch.dist import sharded

    z = grid_positions(cfg)[:, 2]
    planes = sharded.balanced_slab_planes(z, cfg, DIST_RANKS)
    zc = np.clip((z / np.float32(cfg.h)).astype(np.int32), 0, cfg.num_cells_per_dim - 1)
    per_plane = np.bincount(zc, minlength=cfg.num_cells_per_dim)
    occupancy = [int(per_plane[a:b].sum()) for a, b in zip(planes, planes[1:])]
    bands = [int(per_plane[a:a + 2].sum()) for a in planes[:-1]]
    bands += [int(per_plane[b - 2:b].sum()) for b in planes[1:]]
    up8 = lambda v: -(-int(v) // 8) * 8
    caps = dict(n_devices=DIST_RANKS, dev_capacity=up8(1.25 * max(occupancy)),
                halo_capacity=up8(1.5 * max(bands)), migration_capacity=DIST_MIGRATION,
                slab_planes=planes)
    return planes, occupancy, caps


def dist_phase(card: str, kernels, reference, timed_rate: float, chain_rate: float, dev) -> dict:
    """Phase 10 (see the module docstring). `reference` is the state after
    20 `step_kernels` steps from grid init. Returns the dist path's
    launches a step and rank by kernel, and one rank's timesteps/s and
    operations a step on the card, elided and through the whole
    machinery."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.dist import sharded
    from tpusph_torch.dist.comm import SlabComm, spawn_ranks
    from tpusph_torch.engine.step import fields_from_state

    cfg = tuned_config(N_MAIN)
    names = KERNEL_NAMES
    ref_fields = fields_from_state(reference)
    whole = init_state(cfg, device="cpu")
    comm = SlabComm(dev)
    rates, per_step, ops = {}, {}, {}
    # a. one rank, elided; b. one rank through the whole machinery
    for label, full, caps in (("elided", "0", (8, 8)),
                              ("full machinery", "1", (DIST_HALO_ONE_CARD, DIST_MIGRATION))):
        os.environ["TPUSPH_DIST_FULL_MACHINERY"] = full
        try:
            dcfg = sharded.DistConfig(1, cfg.padded_num_particles, *caps)
            require(sharded._elide_single(dcfg) == (full == "0"), "the machinery switch")
            step = sharded.make_sharded_step(cfg, dcfg, comm)
            run = sharded.make_sharded_run(cfg, dcfg, comm, CHAIN_STEPS)
            start = sharded.distribute_state(whole, cfg, dcfg, comm)
            state = start
            step(start)  # the capture
            for fn in kernels:
                fn.launches = 0
            for k in range(DIST_STEPS):
                state, aux = step(state)
                hold_clean(aux, N_MAIN, f"one rank, {label}, step {k}")
            per_step[label] = {n: fn.launches / DIST_STEPS for n, fn in zip(names, kernels)}
            for name, n in per_step[label].items():
                require(n == 1, f"one rank, {label}: {name} launched {n} times a step")
            dpos = hold_multisets(cfg, fields_of_block(state), ref_fields)
            run(start)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, aux = run(start)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            hold_clean(aux, N_MAIN, f"one rank, {label}, {CHAIN_STEPS}-step run")
            require(torch.isfinite(out.position).all(), "non-finite positions")
            rates[label] = CHAIN_STEPS / wall
            ops[label] = device_ops_per_step(
                sharded.make_sharded_run(cfg, dcfg, comm, PROFILED_STEPS), start, PROFILED_STEPS)
            rows = cfg.padded_num_particles + (0 if full == "0" else 2 * caps[0])
            print(f"sharded one rank, {label}: {DIST_STEPS} steps match {DIST_STEPS} "
                  f"step_kernels steps (density rtol 1e-4, positions atol 1e-4, multisets; "
                  f"max|dpos| {dpos:.3e}), counters clean, {rows} rows, launches "
                  f"a step {per_step[label]}, {ops[label]:.1f} operations a step on the card "
                  f"(profiler); {rates[label]:.3f} timesteps/s "
                  f"({CHAIN_STEPS} steps in one replay, {wall * 1e3:.3f} ms) beside simulate_and_time "
                  f"{timed_rate:.3f} (phase 5) and the chained graph {chain_rate:.3f} (phase 8); "
                  f"{card}")
        finally:
            os.environ.pop("TPUSPH_DIST_FULL_MACHINERY", None)

    # c. four ranks on the one card
    planes, occupancy, caps = four_slab_caps(cfg)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host, no network
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "reference.npy")
        np.save(ref_path, reference.position[:N_MAIN].cpu().numpy())
        payload = {"n": N_MAIN, "dcfg": caps, "reference": ref_path, "out": tmp}
        t0 = time.perf_counter()
        spawn_ranks(dist_rank, DIST_RANKS, f"file://{tmp}/store", dev, (payload,),
                    deadline_s=DIST_DEADLINE_S)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    require([r["rank"] for r in ranks] == list(range(DIST_RANKS)), "a rank did not report")
    print(f"sharded {DIST_RANKS} ranks on one card: planes {planes}, occupancy {occupancy}, "
          f"capacities dev {caps['dev_capacity']} halo {caps['halo_capacity']} migration "
          f"{caps['migration_capacity']}; {DIST_STEPS} steps, collected positions within 1e-4 of "
          f"{DIST_STEPS} step_kernels steps, counters clean; spawn to join {spawn_s:.1f} s")
    for r in ranks:
        print(f"  rank {r['rank']}: {r['occupancy']} particles, {r['rows']} combined rows, "
              f"ghosts below/above {r['ghosts_below']}/{r['ghosts_above']}, halo rows sent "
              f"{r['halo_send']}, launches (rank, density, pack, force) {r['launches']}, "
              f"rank exact, "
              f"density max err {r['density_max_abs_err']:.3e} (rtol 1e-5), force "
              f"{r['force_max_abs_err']:.3e} (rtol 1e-4 atol 1e-4), {r['ms_per_step']:.3f} ms a "
              f"step of which {r['exchange_ms_per_step']:.3f} ms inside the two exchanges "
              f"({r['exchange_ms_per_step'] / r['ms_per_step']:.3f})")
    slowest = max(r["ms_per_step"] for r in ranks)
    print(f"sharded {DIST_RANKS} ranks: {slowest:.3f} ms a step ({1e3 / slowest:.3f} timesteps/s) "
          f"on the slowest rank. The four ranks time-share one card and exchange through host "
          f"memory (gloo): this is a check of correctness, not a scaling figure; {card}")
    launches = {
        n: {"one_rank_per_step": per_step["elided"][n],
            "full_machinery_per_step": per_step["full machinery"][n],
            "four_ranks": [r["launches"][i] for r in ranks], "steps": DIST_STEPS}
        for i, n in enumerate(names)
    }
    return launches, {"rates": rates, "ops": ops}


def brick_rank(comm, payload: dict) -> None:
    """One of phase 11b's ranks (a process of its own on the one card, a
    (1, 2, 2) brick grid): `DistSimulator` with its balanced planes and
    capacities, a warm-up `run(20)` (which grows what overflows in those
    steps), then grid init again and the same 20 steps by `simulate()`,
    the checks of the module docstring; writes its numbers to
    `payload["out"]/brick<r>.json`."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.dist import mesh3d
    from tpusph_torch.dist.simulator import DistSimulator

    n = payload["n"]
    cfg = tuned_config(n)
    dev = comm.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    kernels = main_kernels()
    sim = DistSimulator(cfg, comm, mesh_shape=BRICK_GRID, device=dev)
    sim.setup()
    setup_caps = sim.dcfg
    sim.run(DIST_STEPS)  # warm-up: loads the library, fills the caches, grows what overflows
    caps = sim.dcfg
    sim.setup()
    sim.simulate()  # the step's capture, whose warm-up launches, outside the counted steps
    sim.setup()  # grid init again, on the capacities the warm-up settled
    occupancy = int(sim.state.valid.sum())
    grid = sim.comm

    # time inside the exchanges, the card drained before each so that the
    # wait for the kernels queued ahead is not charged to them; halo rows
    # sent to each peer, by the axis along which it lies, counted on the
    # device
    exchange, spent, sent = grid._exchange, [0.0], {0: 0, 1: 0, 2: 0}
    my, mx = grid.shape[1:]

    def timed_exchange(up, dn, below, above):
        if len(up) == 2:  # the halo message: rows and valid lanes
            for peer, message in ((above, up), (below, dn)):
                if peer is not None:
                    at = (peer // (my * mx), peer // mx % my, peer % mx)
                    sent[next(a for a in range(3) if at[a] != grid.coords[a])] += message[1].sum()
        sync()
        t0 = time.perf_counter()
        out = exchange(up, dn, below, above)
        sync()
        spent[0] += time.perf_counter() - t0
        return out

    grid._exchange = timed_exchange
    for fn in kernels:
        fn.launches = 0
    auxs = []
    sync()
    t0 = time.perf_counter()
    for _ in range(DIST_STEPS):
        sim.simulate()
        auxs.append(sim.last_aux)
    sync()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    del grid._exchange  # the wrapper refers to grid: no cycle left behind
    require(sim.dcfg == caps, f"rank {comm.rank}: capacities grew inside the counted steps")
    for k, aux in enumerate(auxs):
        hold_clean(aux, n, f"brick rank {comm.rank} step {k}")
    for name, count in zip(KERNEL_NAMES, launches):
        require(count == DIST_STEPS,
                f"brick rank {comm.rank}: {name} launched {count} times in {DIST_STEPS} steps")
    halo_rows = {ax: int(rows) for ax, rows in sent.items()}
    for ax, axis in ((1, "y"), (2, "x")):
        require(halo_rows[ax] > 0, f"brick rank {comm.rank} sent no halo rows along {axis}")

    got = sim.get_position()
    want = np.load(payload["reference"])
    require(not np.isnan(got).any(), "a particle is on no rank")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    # this rank's combined rows at step 20, ghosts from both of its faces
    key, x, y, z, vx, vy, vz, tag, _ovf, _oob, halo_send = mesh3d._device_build3d(
        *sim.state, cfg, caps, grid)
    ghosts = int(((tag == -2) & (key < cfg.num_cells)).sum())
    require(ghosts > 0, f"brick rank {comm.rank}: no ghost rows")
    density_err, force_err = hold_kernels_on_rows(key, x, y, z, vx, vy, vz, cfg)
    with open(os.path.join(payload["out"], f"brick{comm.rank}.json"), "w") as f:
        json.dump({
            "rank": comm.rank, "coords": list(grid.coords), "occupancy": occupancy,
            "rows": key.numel(), "ghosts": ghosts, "halo_rows_y": halo_rows[1],
            "halo_rows_x": halo_rows[2], "launches": launches,
            "ms_per_step": wall / DIST_STEPS * 1e3,
            "exchange_ms_per_step": spent[0] / DIST_STEPS * 1e3,
            "planes": [list(p) for p in caps.axis_planes],
            "setup_caps": [setup_caps.dev_capacity, list(setup_caps.halo_capacity),
                           list(setup_caps.migration_capacity)],
            "caps": [caps.dev_capacity, list(caps.halo_capacity),
                     list(caps.migration_capacity)],
            "max_halo_send": max(a.max_halo_send for a in auxs),
            "max_migration_send": max(a.max_migration_send for a in auxs),
            "density_max_abs_err": density_err, "force_max_abs_err": force_err,
        }, f)


def times_rate(out: str, steps: int) -> float:
    """Timesteps/s from a printed Times table of `steps` timed steps: the
    steps over the sum of the three phases' totals (the last column)."""
    rows = ("Grid construction", "SPH update", "Data transfer")
    totals = [float(line.split()[-1]) for line in out.splitlines() if line.startswith(rows)]
    require(len(totals) == 3, "no Times table")
    return steps / sum(totals)


def brick_phase(card: str, kernels, reference, timed_rate: float, slab: dict, dev) -> dict:
    """Phase 11 (see the module docstring). `reference` is the state after
    20 `step_kernels` steps from grid init, `slab` phase 10's one-rank
    rates and operations. Returns the brick path's launches by kernel."""
    import io

    from tpusph_torch import cli
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.core.io import load_state
    from tpusph_torch.dist import mesh3d
    from tpusph_torch.dist.comm import BrickComm, spawn_ranks
    from tpusph_torch.engine.step import fields_from_state

    cfg = tuned_config(N_MAIN)
    names = KERNEL_NAMES

    # a. one brick rank, the whole machinery, every exchange returning zeros
    comm = BrickComm(dev)
    # a face with no rank behind it still counts its 2h band (tpusph's
    # rule): at grid init the x band holds two lattice planes (23,762 rows)
    # and the floor band fills as the column falls, so every halo buffer
    # holds a whole block
    halo = (cfg.padded_num_particles,) * 3
    mcfg = mesh3d.Mesh3DConfig((1, 1, 1), cfg.padded_num_particles, halo, (DIST_MIGRATION,) * 3)
    step = mesh3d.make_mesh3d_step(cfg, mcfg, comm)
    run = mesh3d.make_mesh3d_run(cfg, mcfg, comm, CHAIN_STEPS)
    start = mesh3d.distribute_state_3d(init_state(cfg, device="cpu"), cfg, mcfg, comm)
    state = start
    step(start)  # the capture
    for fn in kernels:
        fn.launches = 0
    for k in range(DIST_STEPS):
        state, aux = step(state)
        hold_clean(aux, N_MAIN, f"one brick, step {k}")
    per_step = {n: fn.launches / DIST_STEPS for n, fn in zip(names, kernels)}
    for name, count in per_step.items():
        require(count == 1, f"one brick: {name} launched {count} times a step")
    dpos = hold_multisets(cfg, fields_of_block(state), fields_from_state(reference))
    run(start)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, aux = run(start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hold_clean(aux, N_MAIN, f"one brick, {CHAIN_STEPS}-step run")
    require(torch.isfinite(out.position).all(), "non-finite positions")
    rate = CHAIN_STEPS / wall
    ops = device_ops_per_step(mesh3d.make_mesh3d_run(cfg, mcfg, comm, PROFILED_STEPS), start,
                              PROFILED_STEPS)
    rows = cfg.padded_num_particles + 2 * sum(halo)
    print(f"brick one rank (1, 1, 1): {DIST_STEPS} steps match {DIST_STEPS} step_kernels steps "
          f"(density rtol 1e-4, positions atol 1e-4, multisets; max|dpos| "
          f"{dpos:.3e}), counters clean, {rows} rows (halo a direction "
          f"{halo} by axis), launches a step {per_step}, {ops:.1f} operations a "
          f"step on the card (profiler); {rate:.3f} timesteps/s ({CHAIN_STEPS} steps in one replay, "
          f"{wall * 1e3:.3f} ms) beside the z-slab one rank elided {slab['rates']['elided']:.3f} "
          f"({slab['ops']['elided']:.1f} operations a step) and through the whole machinery "
          f"{slab['rates']['full machinery']:.3f} ({slab['ops']['full machinery']:.1f}); {card}")

    # b. four ranks as a (1, 2, 2) grid on the one card
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host, no network
    size = math.prod(BRICK_GRID)
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "reference.npy")
        np.save(ref_path, reference.position[:N_MAIN].cpu().numpy())
        payload = {"n": N_MAIN, "reference": ref_path, "out": tmp}
        t0 = time.perf_counter()
        spawn_ranks(brick_rank, size, f"file://{tmp}/store", dev, (payload,),
                    deadline_s=DIST_DEADLINE_S, shape=BRICK_GRID)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(size):
            with open(os.path.join(tmp, f"brick{r}.json")) as f:
                ranks.append(json.load(f))
    require([r["rank"] for r in ranks] == list(range(size)), "a brick rank did not report")
    first = ranks[0]
    print(f"brick {BRICK_GRID} on one card over gloo: planes {first['planes']}, capacities "
          f"(dev, halo, migration) {first['setup_caps']} from DistSimulator.setup, "
          f"{first['caps']} after the warm-up run; {DIST_STEPS} simulate() steps, positions "
          f"within 1e-4 of {DIST_STEPS} step_kernels steps, counters clean; spawn to join "
          f"{spawn_s:.1f} s")
    for r in ranks:
        print(f"  rank {r['rank']} {tuple(r['coords'])}: {r['occupancy']} particles, {r['rows']} "
              f"combined rows, {r['ghosts']} ghost rows, halo rows sent along y {r['halo_rows_y']} "
              f"and x {r['halo_rows_x']} over {DIST_STEPS} steps, launches (rank, density, pack, "
              f"force) "
              f"{r['launches']}, rank exact, density max err {r['density_max_abs_err']:.3e} "
              f"(rtol 1e-5), force {r['force_max_abs_err']:.3e} (rtol 1e-4 atol 1e-4), "
              f"{r['ms_per_step']:.3f} ms a step of which {r['exchange_ms_per_step']:.3f} ms "
              f"inside the exchanges ({r['exchange_ms_per_step'] / r['ms_per_step']:.3f})")
    slowest = max(r["ms_per_step"] for r in ranks)
    print(f"brick {BRICK_GRID}: {slowest:.3f} ms a step ({1e3 / slowest:.3f} timesteps/s) on the "
          f"slowest rank. Four ranks time-share one card and exchange through host memory "
          f"(gloo): a check of correctness, not a scaling figure; {card}")

    # c. the command line: --mesh in this process, and under torchrun
    lo, hi = cfg.h, cfg.box_dim - cfg.h
    for mesh in ("z", "1x1x1"):
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "mesh.npz")
            argv = ["-n", str(N_MAIN), "-m", "time", "--mesh", mesh, "--save", ckpt]
            for fn in kernels:
                fn.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            out = buf.getvalue()
            print(out, end="")
            require(rc == 0, f"--mesh {mesh} exited {rc}")
            require(out.count("Grid construction") == 1, f"--mesh {mesh}: no Times table")
            mesh_launches = {name: fn.launches for name, fn in zip(names, kernels)}
            for name, n in mesh_launches.items():
                require(n > 0, f"--mesh {mesh}: the {name} kernel was not launched")
            hold_packed(mesh_launches, f"--mesh {mesh}")
            state, _ = load_state(ckpt, "cpu")
        v = state.valid.numpy()
        pos = state.position.numpy()[v]
        require(v.sum() == N_MAIN, f"--mesh {mesh}: the saved state holds {v.sum()} particles")
        require(np.isfinite(pos).all() and np.isfinite(state.velocity.numpy()[v]).all(),
                f"--mesh {mesh}: non-finite saved state")
        require(pos.min() >= lo - 1e-6 and pos.max() <= hi + 1e-6,
                f"--mesh {mesh}: a saved particle outside the box")
        print(f"python -m tpusph_torch {' '.join(argv[:6])}: "
              f"{times_rate(out, TIMED_STEPS):.3f} timesteps/s (100 / the Times phases) "
              f"beside simulate_and_time {timed_rate:.3f} (phase 5); "
              f"{N_MAIN} valid, finite rows inside the box saved; command {wall:.1f} s; {card}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(TORCHRUN_RANKS), "-m", "tpusph_torch", "-n", str(N_MAIN), "-m", "time",
           "--steps", str(DIST_STEPS), "--mesh", TORCHRUN_MESH]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    print(r.stdout, end="")
    require(r.returncode == 0, f"torchrun exited {r.returncode}: {r.stderr[-3000:]}")
    require(r.stdout.count("Grid construction") == 1,
            f"torchrun printed {r.stdout.count('Grid construction')} Times tables")
    print(f"torchrun --standalone --nproc_per_node {TORCHRUN_RANKS} -m tpusph_torch -n {N_MAIN} "
          f"-m time --steps {DIST_STEPS} --mesh {TORCHRUN_MESH}: exit 0, one Times table, "
          f"{times_rate(r.stdout, DIST_STEPS):.3f} timesteps/s, command {wall:.1f} s (two "
          f"processes on the one card over gloo); {card}")
    return {n: {"brick_one_rank_per_step": per_step[n],
                "brick_four_ranks": [r["launches"][i] for r in ranks]}
            for i, n in enumerate(names)}


def chained_loop(card: str, kernels, timed_rate: float, free_ms: float, dev) -> dict:
    """Phase 8 (see the module docstring). Returns each kernel's launches
    in one replay of the 100-step chain."""
    from tpusph_torch import cli
    from tpusph_torch.core.config import default_config, tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.engine.simulator import Simulator
    from tpusph_torch.engine.step import fields_from_state, make_fields_chain, make_step
    from tpusph_torch.viz.project import project_bitmap, project_pixels_packed

    from torch.autograd import DeviceType

    names = KERNEL_NAMES

    def zero():
        for fn in kernels:
            fn.launches = 0

    def counts():
        return dict(zip(names, (fn.launches for fn in kernels)))

    # a. chunk against sequential steps at 4096
    cfg4 = default_config(N_PARITY)
    clicks = {2: (400, 300)}
    for random_init in (False, True):
        label = "random" if random_init else "grid"

        def sim():
            s = Simulator(cfg4, random_init=random_init, seed=5, device=dev)
            s.setup()
            return s

        ref = sim()
        ref.simulate()  # the step's capture (its warm-up launches too)
        ref.setup()
        zero()
        ref.simulate()
        per_step = counts()
        ref = sim()
        chunked = sim()
        chunked.simulate_chunk(5, clicks=clicks)  # capture and its warm-up
        chunked.setup()
        zero()
        snaps = chunked.simulate_chunk(5, clicks=clicks)
        replay = counts()
        for name in names:
            require(replay[name] == 5 * per_step[name],
                    f"chunk replay launched {name} {replay[name]} times, not 5 x {per_step[name]}")
        for k in range(5):
            ref.simulate(click=clicks.get(k))
            require(np.array_equal(snaps[k], ref.get_position()),
                    f"chunk snapshot {k} differs from the sequential step ({label})")
        require(torch.equal(chunked.state.velocity, ref.state.velocity),
                f"chunk velocity differs from the sequential steps ({label})")
        for pack in (True, "bitmap"):
            a, b = sim(), sim()
            frames, ovf = a.dispatch_chunk(3, pack_pixels=pack).fetch.wait()
            require(ovf == 0, f"chunk overflow {ovf}")
            for k in range(3):
                b.simulate()
                if pack == "bitmap":
                    want = project_bitmap(b.state.position[:N_PARITY])
                else:
                    want = project_pixels_packed(b.state.position)[:N_PARITY]
                require(np.array_equal(frames[k], want.cpu().numpy()),
                        f"chunk frame {k} ({pack}) differs from the sequential one ({label})")
        print(f"chunk N={N_PARITY} {label}: 5 steps with a click in one graph replay equal 5 "
              f"sequential steps bit for bit; packed and bitmap frames equal; launches per "
              f"replay {replay} (per step {per_step})")

    # b. the fields chain at 262,144
    cfg = tuned_config(N_MAIN)
    st0 = init_state(cfg, device=dev)
    fs0 = fields_from_state(st0)
    fs20, ovf = make_fields_chain(cfg, CHAIN_PARITY_STEPS, dev)(fs0)
    require(int(ovf) == 0, f"fields chain overflow {int(ovf)}")
    step = make_step(cfg, "kernels", dev)
    st = st0
    for _ in range(CHAIN_PARITY_STEPS):
        st, _ = step(st)
    dpos = hold_multisets(cfg, fs20, fields_from_state(st))
    t0 = time.perf_counter()
    require(bench_torch.verify_headline(cfg, st0, "kernels", dev, CHAIN_PARITY_STEPS) == "pass",
            "bench_torch.verify_headline failed (details on stderr)")
    headline_s = time.perf_counter() - t0
    chain = make_fields_chain(cfg, CHAIN_STEPS, dev)
    t0 = time.perf_counter()
    chain(fs0)  # capture (warm-up run included) and the first replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    # every replay starts from grid init, the states phase 5 times
    chain(fs0)  # warm replay
    torch.cuda.synchronize()
    zero()
    t0 = time.perf_counter()
    out, ovf = chain(fs0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chain_launches = counts()
    require(int(ovf) == 0, f"fields chain overflow {int(ovf)}")
    for name in names:
        require(chain_launches[name] == CHAIN_STEPS,
                f"{name} launched {chain_launches[name]} times in a {CHAIN_STEPS}-step replay")
    for f in out:
        require(torch.isfinite(f.float()).all(), "non-finite fields after the chain")
    rate = CHAIN_STEPS / wall
    print(f"fields chain N={N_MAIN}: {CHAIN_PARITY_STEPS} chained steps match "
          f"{CHAIN_PARITY_STEPS} step_kernels steps (density rtol 1e-4, positions atol "
          f"1e-4, multisets; max|dpos| {dpos:.3e}) and, through bench_torch.verify_headline, "
          f"{CHAIN_PARITY_STEPS} cell_list steps ({headline_s:.1f} s); capture {capture_s:.3f} s")
    print(f"chained timesteps/s: {rate:.3f} ({CHAIN_STEPS} steps in one replay, "
          f"{wall * 1e3:.3f} ms) beside simulate_and_time {timed_rate:.3f} (phase 5); "
          f"launches per replay {chain_launches}; {card}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain(fs0)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # Only the device's own events: a host op's self device time repeats
    # the time of the kernels it launched.
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in events)
    if device_us > 0:
        share = device_us / 1e6 / prof_wall
        require(share <= 1, f"busy share {share:.3f} above 1: device time counted twice")
        print(f"chained busy share: {share:.3f} (device "
              f"{device_us / 1e3:.3f} ms over {prof_wall * 1e3:.3f} ms wall, profiled "
              f"replay; {card})")
        top = "; ".join(f"{e.key[:160]} {e.self_device_time_total / 1e3 / CHAIN_STEPS:.4f}"
                        for e in events[:12] if e.self_device_time_total > 0)
        print(f"chained device ms per step by kernel: {top}")
    else:
        print("chained busy share: not measured (the profiler shows no device time "
              "inside the graph replay)")

    # c. the cell_list backend at 4096
    def cell_list_run(backend, **kw):
        s = Simulator(default_config(N_PARITY, **kw), backend=backend, device=dev)
        s.setup()
        for _ in range(10):
            s.simulate()
        return s

    kern = cell_list_run("kernels")
    ample = cell_list_run("cell_list")
    small = cell_list_run("cell_list", tile_cand_capacity=64)
    np.testing.assert_allclose(ample.get_position(), kern.get_position(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ample.state.density.cpu(), kern.state.density.cpu(), rtol=1e-4)
    require(small.cfg.tile_cand_capacity > 64, "the cell_list capacity did not grow")
    require(int(small.last_aux.window_overflow) == 0, "overflow after growing")
    np.testing.assert_allclose(small.get_position(), ample.get_position(), rtol=0, atol=1e-6)
    # the same growth through a chunk graph: overflow, rewind, capture again
    chunked = Simulator(default_config(N_PARITY, tile_cand_capacity=64), backend="cell_list",
                        device=dev)
    chunked.setup()
    snaps = chunked.simulate_chunk(10)
    require(chunked.cfg.tile_cand_capacity > 64, "the cell_list chunk capacity did not grow")
    np.testing.assert_allclose(snaps[-1], ample.get_position(), rtol=0, atol=1e-6)
    print(f"cell_list N={N_PARITY}: 10 steps match the kernels (1e-4); from capacity 64 "
          f"grown to {small.cfg.tile_cand_capacity} (simulate) and "
          f"{chunked.cfg.tile_cand_capacity} (a 10-step chunk graph), overflow 0, positions "
          f"within 1e-6")

    # d. chunked free mode through the command line
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-n", str(N_MAIN), "-m", "free", "--frames", str(CHUNK_FRAMES),
                "--viz-chunk", str(VIZ_CHUNK), "--click", FREE_CLICK, "--out", tmp,
                "--device", str(dev)]
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        chunk_launches = counts()
        require(rc == 0, f"chunked free mode exited {rc}")
        pngs = sorted(f for f in os.listdir(tmp) if f.endswith(".png"))
        require(len(pngs) == CHUNK_FRAMES, f"chunked free mode wrote {len(pngs)} frames")
        for name in pngs:
            with open(os.path.join(tmp, name), "rb") as f:
                require(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name} is not a PNG")
    for name in names:
        require(chunk_launches[name] >= CHUNK_FRAMES,
                f"{name} launched {chunk_launches[name]} times in chunked free mode")
    hold_packed(chunk_launches, "chunked free mode")
    print(f"chunked free mode: python -m tpusph_torch {' '.join(argv[:10])}: "
          f"{CHUNK_FRAMES} frames, {chunk_s:.3f} s, {chunk_s / CHUNK_FRAMES * 1e3:.2f} ms "
          f"per frame with set-up and capture, beside {free_ms:.2f} unchunked (phase 7); "
          f"launches {chunk_launches}; {card}")
    return chain_launches, st, rate


def bench_phase(card: str, kernels, chain_rate: float, dev) -> dict:
    """Phase 12 (see the module docstring). Returns each kernel's launches
    in bench_torch's timed run."""
    import io

    from tpusph_torch import graft_entry
    from tpusph_torch.scripts import build_bench, fields_profile

    names = KERNEL_NAMES
    kind = torch.cuda.get_device_name(0)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TPUSPH_", "WORLD_SIZE"))}
    env.update(TPUSPH_BENCH_N=str(N_MAIN), TPUSPH_BENCH_STEPS=str(CHAIN_STEPS))

    def bench_line(**extra):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
                           env=dict(env, **extra), capture_output=True, text=True,
                           timeout=BENCH_TIMEOUT_S)
        require(r.returncode == 0, f"bench_torch.py {extra} exited {r.returncode}:\n"
                f"{r.stderr[-3000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        require(line["parity"] == "pass" and line["device"] == kind and line["value"] > 0,
                f"bench_torch.py {extra}: {line}")
        return line, time.perf_counter() - t0

    # a. the bench as its user runs it, gates on
    line, secs = bench_line()
    require(line["metric"] == f"torch_sph_timesteps_per_sec_n{N_MAIN}", f"metric {line}")
    print(f"bench_torch.py: {json.dumps(line)} ({secs:.1f} s with its gates) beside the "
          f"chained {chain_rate:.3f} (phase 8); {card}")

    # b. its timed run in this process, for the launch counts
    saved = {k: os.environ.get(k) for k in ("TPUSPH_BENCH_N", "TPUSPH_BENCH_STEPS",
                                            "TPUSPH_BENCH_VERIFY")}
    os.environ.update(TPUSPH_BENCH_N=str(N_MAIN), TPUSPH_BENCH_STEPS=str(CHAIN_STEPS),
                      TPUSPH_BENCH_VERIFY="0")
    out = io.StringIO()
    try:
        for fn in kernels:
            fn.launches = 0
        with contextlib.redirect_stdout(out):
            bench_torch.main()
        launches = {name: fn.launches for name, fn in zip(names, kernels)}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name, n in launches.items():
        require(n > 0, f"{name} kernel was not launched by bench_torch's timed run")
    hold_packed(launches, "bench_torch's timed run")
    print(f"bench_torch in process (gates off): {out.getvalue().strip()}; launches {launches}")

    # c. the sharded mode, one rank
    with tempfile.TemporaryDirectory() as tmp:
        dline, secs = bench_line(TPUSPH_BENCH_DIST="1", TPUSPH_BENCH_ARTIFACT_DIR=tmp)
        written = os.listdir(tmp)
        require(written == ["TORCH_DIST_BENCH.json"], f"the sharded bench wrote {written}")
        with open(os.path.join(tmp, written[0])) as f:
            art = json.load(f)
    require(dline["metric"] == f"torch_sph_dist_timesteps_per_sec_n{N_MAIN}_r1", f"{dline}")
    require(all(art[k] > 0 for k in ("dev_capacity", "halo_capacity", "migration_capacity")),
            f"artifact {art}")
    print(f"bench_torch.py, TPUSPH_BENCH_DIST=1: {json.dumps(dline)} ({secs:.1f} s); capacities "
          f"dev {art['dev_capacity']}, halo {art['halo_capacity']}, migration "
          f"{art['migration_capacity']}, right-sized {art['right_sized']}; {card}")

    # d. the driver's entry point: one cell_list step on the card
    fn, (state,) = graft_entry.entry()
    t0 = time.perf_counter()
    new = fn(state)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    require(new.position.is_cuda and int(new.valid.sum()) == 4096, "graft_entry.entry()")
    require(torch.isfinite(new.position).all(), "non-finite positions from entry()'s fn")
    print(f"graft_entry.entry(): one step_cell_list step at 4096 on the card, {entry_s:.3f} s")

    # e. the fields step by stage, f. the build's alternatives
    profile = fields_profile.main([str(N_MAIN), "0", "60"])
    for step, ms in profile.items():
        require(all(v > 0 for v in ms.values()), f"fields_profile at step {step}: {ms}")
    table = build_bench.main([str(N_MAIN)])
    require(all(v > 0 for v in table.values()), f"build_bench: {table}")
    return launches


def _update_device_ms(cfg, dcfg, comm, inter, calls: int = 10) -> tuple[float, float]:
    """(device ms, wall ms) of one `_device_update` call on `inter`, the
    rows of one `_device_build`: device time from torch.profiler's device
    events over `calls` calls, wall time up to a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpusph_torch.dist import sharded

    def calls_once():
        for _ in range(calls):
            sharded._device_update(*inter, None, False, cfg, dcfg, comm, "kernels",
                                   with_click=False)

    calls_once()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    return device_us / 1e3 / calls, wall * 1e3 / calls


def _skip_runs(step, start, kernels, steps: int) -> dict:
    """The same `steps` steps from `start` with TPUSPH_DIST_FORCE_MIGSORT=1
    ("sort") and with the skip, in turns: sort, skip, skip, sort. Per mode
    the states and counters after every step of its first run, the branch
    counters and the kernels' launches of that run, and the wall ms a step
    of both runs; every run's rows are held bit for bit against the first
    sort run's."""
    from tpusph_torch.dist import sharded

    runs = {}
    sync = torch.cuda.synchronize if start.position.is_cuda else (lambda: None)
    for mode in ("sort", "skip", "skip", "sort"):
        os.environ["TPUSPH_DIST_FORCE_MIGSORT"] = "1" if mode == "sort" else "0"
        try:
            sharded.migration_sorts = sharded.migration_skips = 0
            for fn in kernels:
                fn.launches = 0
            state, out = start, []
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, aux = step(state)
                out.append((state, aux))
            sync()
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("TPUSPH_DIST_FORCE_MIGSORT", None)
        if "sort" in runs:
            _hold_bit_equal(runs["sort"]["states"], out, f"{mode} run")
        if mode in runs:
            runs[mode]["ms_per_step"].append(wall / steps * 1e3)
            continue
        runs[mode] = {
            "states": out, "sorts": sharded.migration_sorts, "skips": sharded.migration_skips,
            "launches": [fn.launches for fn in kernels], "ms_per_step": [wall / steps * 1e3],
        }
    return runs


def _hold_bit_equal(want: list, got: list, what: str, of: str = "the sort's") -> None:
    require(len(want) == len(got), f"{what}: {len(got)} steps against {len(want)}")
    for k, ((a, aux_a), (b, aux_b)) in enumerate(zip(want, got)):
        require([int(x) for x in aux_a] == [int(x) for x in aux_b],
                f"{what}, step {k}: the counters differ from {of}")
        for x, y, field in zip(a, b, a._fields):
            require(torch.equal(x, y), f"{what}, step {k}: {field} differs from {of}")


def skip_rank(comm, payload: dict) -> None:
    """One of phase 13b's ranks (a process of its own on the one card):
    random init with the rows just below each interior slab face kicked
    up across it, `SKIP_STEPS` steps with the sort and with the skip, then
    the graphed step's, the checks of the module docstring; writes its
    numbers to `payload["out"]/skip<r>.json`."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.dist import sharded
    from tpusph_torch.kernels import graph_cond

    n = payload["n"]
    cfg = tuned_config(n)
    dcfg = sharded.DistConfig(**payload["dcfg"])
    whole = np.load(payload["state"])
    whole = {k: whole[k] for k in ("position", "velocity", "valid")}
    start = sharded.distribute_state(types.SimpleNamespace(**whole), cfg, dcfg, comm)
    # the eager step, whose skip is the host read; the graphed step below
    # branches on the card
    step = sharded.make_sharded_step(cfg, dcfg, comm).eager
    step(start)  # warm-up: loads the library, fills the caches
    kernels = main_kernels()
    runs = _skip_runs(step, start, kernels, SKIP_STEPS)
    for mode in ("sort", "skip"):
        for k, (_, aux) in enumerate(runs[mode]["states"]):
            hold_clean(aux, n, f"rank {comm.rank}, {mode}, step {k}")
        require(runs[mode]["launches"] == [SKIP_STEPS] * len(kernels),
                f"rank {comm.rank}, {mode}: launches {runs[mode]['launches']}")
    require((runs["sort"]["sorts"], runs["sort"]["skips"]) == (SKIP_STEPS, 0),
            f"rank {comm.rank}: TPUSPH_DIST_FORCE_MIGSORT=1 skipped")
    crossed = [int(aux.max_migration_send) for _, aux in runs["skip"]["states"]]

    # the graphed step (segments between the exchanges; the migration's
    # branch a conditional node), from the same start after its capture
    graphed = sharded.make_sharded_step(cfg, dcfg, comm)
    graphed(start)
    counted = (*kernels, graph_cond.set_if)
    for fn in counted:
        fn.launches = 0
    before = sharded.migration_counts()
    state, steps = start, []
    for _ in range(SKIP_STEPS):
        state, aux = graphed(state)
        steps.append((state, aux))
    _hold_bit_equal(runs["skip"]["states"], steps, f"rank {comm.rank}, graphed step",
                    "the eager step's")
    g_sorts, g_skips = (b - a for a, b in zip(before, sharded.migration_counts()))
    g_launches = [fn.launches for fn in counted]
    require(g_launches == [SKIP_STEPS] * len(counted),
            f"rank {comm.rank}, graphed: launches (rank, density, pack, force, set_if) "
            f"{g_launches}")
    loop = graphed.graphs.loops[("step", False, False, False)]
    cond_nodes = [graph_cond.node_counts(item.graph.raw_cuda_graph())["conditional"]
                  for item in loop.chain if hasattr(item, "graph")]
    require(sum(cond_nodes) == 1, f"rank {comm.rank}: conditional nodes a segment {cond_nodes}")
    with open(os.path.join(payload["out"], f"skip{comm.rank}.json"), "w") as f:
        json.dump({
            "rank": comm.rank, "occupancy": int(start.valid.sum()),
            "sorts": runs["skip"]["sorts"], "skips": runs["skip"]["skips"],
            "launches": runs["skip"]["launches"], "max_migration_send": crossed,
            "ms_per_step": {m: runs[m]["ms_per_step"] for m in runs},
            "graphed": {"sorts": g_sorts, "skips": g_skips, "launches": g_launches,
                        "structure": loop.structure, "conditional_nodes": cond_nodes},
        }, f)


def _turns(ms: dict, first: str = "sort", second: str = "skip") -> str:
    """Four times taken in turns first, second, second, first ({mode:
    [first run, second run]}), in that order."""
    order = (ms[first][0], ms[second][0], ms[second][1], ms[first][1])
    return " / ".join(f"{t:.3f}" for t in order)


def slice_phase(card: str, kernels, dev) -> dict:
    """Phase 13 (see the module docstring). Returns each kernel's launches
    in 13a's skip run and on each of 13b's ranks."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.core.io import load_dist_state, save_dist_state
    from tpusph_torch.dist import sharded
    from tpusph_torch.dist.comm import SlabComm, spawn_ranks
    from tpusph_torch.dist.simulator import DistSimulator
    from tpusph_torch.scripts import scaling_model, slab_census

    names = KERNEL_NAMES
    cfg = tuned_config(N_MAIN)
    comm = SlabComm(dev)

    # a. the skip on one rank through the whole machinery
    os.environ["TPUSPH_DIST_FULL_MACHINERY"] = "1"
    try:
        dcfg = sharded.DistConfig(1, cfg.padded_num_particles, DIST_HALO_ONE_CARD,
                                  DIST_MIGRATION)
        require(sharded._aligned(cfg, dcfg) and not sharded._elide_single(dcfg),
                "13a: the one-rank line must splice")
        start = sharded.distribute_state(init_state(cfg, device="cpu"), cfg, dcfg, comm)
        # the eager step, whose skip is the host read that a line of several
        # ranks takes (phase 14 holds the graphed step)
        step = sharded.make_sharded_step(cfg, dcfg, comm).eager
        step(start)
        runs = _skip_runs(step, start, kernels, SKIP_STEPS)
        for mode in runs:
            require(runs[mode]["launches"] == [SKIP_STEPS] * len(kernels),
                    f"13a, {mode}: launches {runs[mode]['launches']}")
        counts = {m: (runs[m]["sorts"], runs[m]["skips"]) for m in runs}
        require(counts == {"sort": (SKIP_STEPS, 0), "skip": (0, SKIP_STEPS)},
                f"13a: (sorts, skips) {counts}")
        hold_clean(runs["skip"]["states"][-1][1], N_MAIN, "13a")
        inter = sharded._device_build(*start, cfg, dcfg, comm)[:8]
        update_ms = {"sort": [], "skip": []}  # (device ms, wall ms), in turns
        for mode in ("sort", "skip", "skip", "sort"):
            os.environ["TPUSPH_DIST_FORCE_MIGSORT"] = "1" if mode == "sort" else "0"
            try:
                update_ms[mode].append(_update_device_ms(cfg, dcfg, comm, inter))
            finally:
                os.environ.pop("TPUSPH_DIST_FORCE_MIGSORT", None)
    finally:
        os.environ.pop("TPUSPH_DIST_FULL_MACHINERY", None)
    launches = {name: {"skip_one_rank": runs["skip"]["launches"][i]} for i, name in
                enumerate(names)}
    turn_ms = {m: r["ms_per_step"] for m, r in runs.items()}
    print(f"13a. sort skip, one rank, whole machinery, {N_MAIN} grid init: {SKIP_STEPS} steps "
          f"bit for bit with TPUSPH_DIST_FORCE_MIGSORT=1 (positions, velocities, valid, pids, "
          f"counters); (sorts, skips) {counts}; _device_update in turns sort, skip, skip, "
          f"sort: device ms {_turns({m: [d for d, _ in t] for m, t in update_ms.items()})} "
          f"(profiler), wall ms {_turns({m: [w for _, w in t] for m, t in update_ms.items()})}; "
          f"eager ms a step {_turns(turn_ms)}; "
          f"launches a run {runs['skip']['launches']}; {card}")

    # b. the skip on four ranks sharing the card, a state with crossers
    whole = init_state(cfg, random_init=True, device="cpu")
    z = whole.position[:N_MAIN, 2].numpy()
    planes = sharded.balanced_slab_planes(z, cfg, DIST_RANKS)
    depth, speed = SKIP_KICK
    vel = whole.velocity.clone()
    for p in planes[1:-1]:
        face = np.float32(p) * np.float32(cfg.h)
        layer = torch.from_numpy((z >= face - depth) & (z < face))
        vel[:N_MAIN, 2][layer] = speed
    zc = np.clip((z / np.float32(cfg.h)).astype(np.int32), 0, cfg.num_cells_per_dim - 1)
    per_plane = np.bincount(zc, minlength=cfg.num_cells_per_dim)
    occupancy = [int(per_plane[a:b].sum()) for a, b in zip(planes, planes[1:])]
    bands = [int(per_plane[a:a + 2].sum()) for a in planes[:-1]]
    bands += [int(per_plane[b - 2:b].sum()) for b in planes[1:]]
    up8 = lambda v: -(-int(v) // 8) * 8
    caps = dict(n_devices=DIST_RANKS, dev_capacity=up8(1.25 * max(occupancy)),
                halo_capacity=up8(1.5 * max(bands)), migration_capacity=DIST_MIGRATION,
                slab_planes=planes)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        state_path = os.path.join(tmp, "state.npz")
        np.savez(state_path, position=whole.position.numpy(), velocity=vel.numpy(),
                 valid=whole.valid.numpy())
        payload = {"n": N_MAIN, "dcfg": caps, "state": state_path, "out": tmp}
        t0 = time.perf_counter()
        spawn_ranks(skip_rank, DIST_RANKS, f"file://{tmp}/store", dev, (payload,),
                    deadline_s=DIST_DEADLINE_S)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"skip{r}.json")) as f:
                ranks.append(json.load(f))
    sorts, skips = sum(r["sorts"] for r in ranks), sum(r["skips"] for r in ranks)
    require(sorts > 0 and skips > 0, f"13b: sorts {sorts}, skips {skips}: one branch never ran")
    for i, name in enumerate(names):
        launches[name]["skip_four_ranks"] = [r["launches"][i] for r in ranks]
    print(f"13b. sort skip, {DIST_RANKS} ranks on one card over gloo, {N_MAIN} random init, the "
          f"rows within {depth} below each interior face (planes {planes}) given vz {speed}: "
          f"{SKIP_STEPS} steps bit for bit with TPUSPH_DIST_FORCE_MIGSORT=1 on every rank; "
          f"sorts {sorts}, skips {skips}; spawn to join {spawn_s:.1f} s")
    for r in ranks:
        print(f"  rank {r['rank']}: {r['occupancy']} particles, sorts {r['sorts']}, skips "
              f"{r['skips']}, migration rows a step (most on a rank) "
              f"{r['max_migration_send']}, ms a step in turns sort, skip, skip, sort "
              f"{_turns(r['ms_per_step'])}")
    g_sorts = sum(r["graphed"]["sorts"] for r in ranks)
    g_skips = sum(r["graphed"]["skips"] for r in ranks)
    require(g_sorts > 0 and g_skips > 0,
            f"13b graphed: sorts {g_sorts}, skips {g_skips}: one branch never ran on the card")
    launches["set_if"] = {
        "skip_four_ranks_graphed": [r["graphed"]["launches"][-1] for r in ranks]}
    print(f"13b graphed (the device branch, phase 16): {SKIP_STEPS} graphed steps on every rank "
          f"equal its eager steps bit for bit; sorts {g_sorts}, skips {g_skips} on the card; "
          f"chain {' '.join(ranks[0]['graphed']['structure'])}, conditional nodes a segment "
          f"{ranks[0]['graphed']['conditional_nodes']}; (sorts, skips) by rank "
          f"{[(r['graphed']['sorts'], r['graphed']['skips']) for r in ranks]}; launches "
          f"(rank, density, pack, force, set_if) by rank "
          f"{[r['graphed']['launches'] for r in ranks]}")

    # c. checkpoints: DistSimulator, save after 10 steps, load, 10 more
    sim = DistSimulator(cfg, device=dev)
    sim.setup()
    sim.run(CHECKPOINT_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dist.npz")
        t0 = time.perf_counter()
        save_dist_state(path, sim.state, sim.cfg, sim.dcfg, sim.comm)
        save_s = time.perf_counter() - t0
        state, cfg2, dcfg2 = load_dist_state(path, comm)
    require(cfg2 == cfg and dcfg2 == sim.dcfg, f"13c: loaded {cfg2} {dcfg2}")
    sim.run(CHECKPOINT_STEPS)
    want = sim.get_position()
    resumed, aux = sharded.make_sharded_run(cfg2, dcfg2, comm, CHECKPOINT_STEPS)(state)
    hold_clean(aux, N_MAIN, "13c")
    got = sharded.collect_state(resumed, N_MAIN, comm)["position"]
    err = float(np.abs(got - want).max())
    require(err <= 1e-5, f"13c: the resumed run is {err:.3e} from the uninterrupted one")
    print(f"13c. checkpoint: DistSimulator {CHECKPOINT_STEPS} steps, save_dist_state "
          f"({save_s:.2f} s), load_dist_state, {CHECKPOINT_STEPS} more steps: max|dpos| "
          f"{err:.3e} from {2 * CHECKPOINT_STEPS} uninterrupted steps (atol 1e-5)")

    # d. the census on the card against tpusph's
    want = scaling_model.load_json(os.path.join(REPO, "scaling", f"census_n{N_MAIN}.json"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        got = slab_census.main([str(N_MAIN), str(CENSUS_STEPS), str(CENSUS_CHUNK),
                                "--device", str(dev)], out_dir=tmp)
        census_s = time.perf_counter() - t0
    require(got["backend"] == "kernels" and got["init"] == "grid", f"13d: {got['backend']}")
    bad = slab_census.compare(got, want)
    require(not bad, f"13d: the census departs from scaling/census_n{N_MAIN}.json: {bad}")
    diff = slab_census.differences(got, want)
    print(f"13d. slab census, {N_MAIN} grid init, {CENSUS_STEPS} steps in chunks of "
          f"{CENSUS_CHUNK} on the card ({census_s:.1f} s): within the bars of "
          f"scaling/census_n{N_MAIN}.json at every checkpoint; {len(diff)} counts differ"
          + (": " + "; ".join(diff[:12]) if diff else ""))

    # e. the projection from the repo's artifacts
    with tempfile.TemporaryDirectory() as tmp:
        proj = scaling_model.main([], out_dir=tmp)
    require(proj["tables"], "13e: no projection table")
    print(f"13e. scaling_model on the repo's artifacts (link assumed, not measured); {card}")
    return launches


class EagerPhases:
    """The bodies of a `graphs.CarriedLoop` run eagerly on the card, with its
    interface (`build(state)`, then `update()`): the eager path of the timed
    phases, fresh tensors each step."""

    def __init__(self, phases):
        self.phases = phases
        self.inputs = self.outputs = None

    def build(self, state):
        self.inputs, self.outputs = list(state), self.phases.build_fn(list(state))
        return self.outputs

    def update(self):
        return self.phases.update_fn([*self.inputs, *self.outputs])


@contextlib.contextmanager
def sync_errors():
    """Sync debug mode "error" inside the block: a synchronising call raises."""
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def _as_list(state, aux) -> list:
    """A FluidState or DistState and its counters as one list to compare."""
    fields = list(state) if hasattr(state, "pid") else [
        getattr(state, f) for f in ("position", "velocity", "force", "density", "pressure",
                                    "valid")]
    return fields + [int(a) for a in aux]


def _bit_equal(a: list, b: list) -> bool:
    return all(torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b))


def graph_phase(card: str, kernels, timed_rate: float, dev) -> dict:
    """Phase 14 (see the module docstring). Returns each kernel's launches
    in one replay of each graphed entry point."""
    from tpusph_torch.bench.times import Times, format_times
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.dist import mesh3d, sharded
    from tpusph_torch.dist.comm import BrickComm, SlabComm
    from tpusph_torch.dist.simulator import DistSimulator
    from tpusph_torch.engine.simulator import Simulator
    from tpusph_torch.engine.step import make_step
    from tpusph_torch.interact.impulse import make_impulse

    names = KERNEL_NAMES
    cfg = tuned_config(N_MAIN)
    print(f"14. graphs, torch {torch.__version__}: a graphed migration branches on the card "
          f"(graphs.device_if, a conditional node of the port's library; phase 16)")
    per_replay = {n: {} for n in names}

    def counts():
        return {n: fn.launches for n, fn in zip(names, kernels)}

    def hold_chain(label, graphed, eager, start, expect=1):
        """`graphed` and `eager` (state -> (state, aux)) GRAPH_STEPS times
        from `start`, bit for bit after every call; the first graphed call
        (the capture) timed, launches of the second counted and held to
        `expect` a kernel."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphed(start)  # the warm-up may make constants (a copy from the host)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        a = b = start
        for k in range(GRAPH_STEPS):
            before = counts()
            with sync_errors():
                a, aux_a = graphed(a)
            if k == 0:
                for n, c in counts().items():
                    per_replay[n][label] = c - before[n]
            b, aux_b = eager(b)
            require(_bit_equal(_as_list(a, aux_a), _as_list(b, aux_b)),
                    f"14 {label}: replay {k} differs from the eager call")
        launches = {n: per_replay[n][label] for n in names}
        require(all(c == expect for c in launches.values()),
                f"14 {label}: launches a replay {launches}, not {expect} a kernel")
        print(f"14 {label}: {GRAPH_STEPS} replays equal the eager calls bit for bit (sync debug "
              f"mode error around them); capture and first replay {capture_s:.3f} s; launches "
              f"a replay {launches}")

    # a. the single-card engine: make_step, make_impulse, the timed phases
    start = init_state(cfg, device=dev)
    step = make_step(cfg, "kernels", dev)
    hold_chain("make_step", step, step.eager, start)
    kick = make_impulse(cfg)
    hold_chain("make_impulse", lambda s: (kick(s, s.position, GRAPH_CLICK), ()),
               lambda s: (kick.eager(s, s.position, GRAPH_CLICK), ()), start, expect=0)
    sims, rates, busy = {}, {"graphs": [], "eager": []}, {}
    for mode in ("graphs", "eager"):
        sim = Simulator(cfg, device=dev)
        sim.setup(start)
        if mode == "eager":
            sim._timed = EagerPhases(sim._timed_phases())
        sim.simulate_and_time(Times())  # the capture, outside the turns
        sims[mode] = sim
    for mode in ("graphs", "eager", "eager", "graphs"):
        sim = sims[mode]
        sim.setup(start)
        times = Times()
        for _ in range(TIMED_STEPS):
            sim.simulate_and_time(times)
        rates[mode].append(times.iters / (times.build_grid + times.sph_update + times.memcpy))
        if mode not in busy:
            print(f"14 timed, {mode}:\n{format_times(times)}")
            busy[mode] = bench_torch._busy_share(
                lambda: [sim.simulate_and_time(Times()) for _ in range(PROFILED_STEPS)], dev)
    require(_bit_equal(_as_list(sims["graphs"].state, ()), _as_list(sims["eager"].state, ())),
            "14 timed: the graphed phases end apart from the eager ones")
    print(f"14 timed (Simulator.simulate_and_time, two replays a step), {N_MAIN} grid init, "
          f"{TIMED_STEPS} steps a run in turns graphs, eager, eager, graphs: timesteps/s "
          f"{rates['graphs'][0]:.3f} / {rates['eager'][0]:.3f} / {rates['eager'][1]:.3f} / "
          f"{rates['graphs'][1]:.3f} (phase 5: {timed_rate:.3f}); busy share graphs "
          f"{busy['graphs']} eager {busy['eager']}; the states equal bit for bit; {card}")

    # b. the sharded engines on one rank: step (a click at the second),
    # timed stages and run, against their eager paths
    whole = init_state(cfg, device="cpu")
    for label, full in (("slab elided", "0"), ("slab whole machinery", "1"), ("brick", "1")):
        os.environ["TPUSPH_DIST_FULL_MACHINERY"] = full
        try:
            if label == "brick":
                comm = BrickComm(dev)
                halo = (cfg.padded_num_particles,) * 3  # phase 11a's capacities
                dcfg = mesh3d.Mesh3DConfig((1, 1, 1), cfg.padded_num_particles, halo,
                                           (DIST_MIGRATION,) * 3)
                make_step_, make_timed, make_run = (mesh3d.make_mesh3d_step,
                                                    mesh3d.make_mesh3d_timed,
                                                    mesh3d.make_mesh3d_run)
                begin = mesh3d.distribute_state_3d(whole, cfg, dcfg, comm)
            else:
                comm = SlabComm(dev)
                caps = (8, 8) if full == "0" else (DIST_HALO_ONE_CARD, DIST_MIGRATION)
                dcfg = sharded.DistConfig(1, cfg.padded_num_particles, *caps)
                make_step_, make_timed, make_run = (sharded.make_sharded_step,
                                                    sharded.make_sharded_timed,
                                                    sharded.make_sharded_run)
                begin = sharded.distribute_state(whole, cfg, dcfg, comm)
            branches0 = sharded.migration_counts()
            fn = make_step_(cfg, dcfg, comm)
            a = b = begin
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(begin)
            fn(begin, GRAPH_CLICK)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            for k in range(GRAPH_STEPS):
                click = GRAPH_CLICK if k == 1 else None
                before = counts()
                with sync_errors():
                    a, aux_a = fn(a, click)
                if k == 0:
                    for n, c in counts().items():
                        per_replay[n][f"{label} step"] = c - before[n]
                        require(c - before[n] == 1, f"14 {label} step: {n} launched "
                                f"{c - before[n]} times a replay")
                b, aux_b = fn.eager(b, click)
                require(_bit_equal(_as_list(a, aux_a), _as_list(b, aux_b)),
                        f"14 {label} step {k}: the replay differs from the eager step")
            print(f"14 {label} step: {GRAPH_STEPS} replays (a click at the second) equal the "
                  f"eager steps bit for bit; both graphs captured in {capture_s:.3f} s; launches "
                  f"a replay {dict((n, per_replay[n][f'{label} step']) for n in names)}")
            build, update = make_timed(cfg, dcfg, comm)
            hold_chain(f"{label} timed", lambda s: update(*build(s)),
                       lambda s: update.eager(*build.eager(s)), begin)
            run = make_run(cfg, dcfg, comm, GRAPH_STEPS)
            hold_chain(f"{label} run({GRAPH_STEPS})", run, run.eager, begin, expect=GRAPH_STEPS)
            sorts, skips = (b - a for a, b in zip(branches0, sharded.migration_counts()))
            print(f"14 {label}: migration branches of the graphed and eager calls (sorts, "
                  f"skips) ({sorts}, {skips})")
            del comm
        finally:
            os.environ.pop("TPUSPH_DIST_FULL_MACHINERY", None)

    # c. the sharded bench on one rank (bench_torch's protocol: right_size,
    # a warm run, the state set up again, a timed run), graphed and eager
    # in turns, and the brick grid's timed step (`--mesh 1x1x1`)
    for n in GRAPH_TIERS:
        cfg_n = tuned_config(n)
        host0 = init_state(cfg_n, device="cpu")
        for label, full in (("elided", "0"), ("whole machinery", "1")):
            os.environ["TPUSPH_DIST_FULL_MACHINERY"] = full
            try:
                sim = DistSimulator(cfg_n, device=dev)
                sim.setup(host0)
                sim.right_size(warmup_steps=10)
                runners = {k: sharded.make_sharded_run(sim.cfg, sim.dcfg, sim.comm, k)
                           for k in (CHAIN_STEPS, PROFILED_STEPS)}
                rates, busy, ends = {"graphs": [], "eager": []}, {}, {}
                for mode in ("graphs", "eager", "eager", "graphs"):
                    for k, run in runners.items():
                        sim._runners[k] = run if mode == "graphs" else run.eager
                    sim.setup(host0)
                    sim.run(CHAIN_STEPS)  # warm (the capture)
                    sim.setup(host0)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sim.run(CHAIN_STEPS)
                    torch.cuda.synchronize()
                    rates[mode].append(CHAIN_STEPS / (time.perf_counter() - t0))
                    ends[mode] = list(sim.state)
                    if mode not in busy:
                        sim.run(PROFILED_STEPS)  # the capture of the profiled run
                        busy[mode] = bench_torch._busy_share(lambda: sim.run(PROFILED_STEPS),
                                                             dev)
                require(_bit_equal(ends["graphs"], ends["eager"]),
                        f"14 bench {n} {label}: the graphed run ends apart from the eager one")
                print(f"14 sharded bench, one rank, {label}, {n} grid init, capacities dev "
                      f"{sim.dcfg.dev_capacity} halo {sim.dcfg.halo_capacity} migration "
                      f"{sim.dcfg.migration_capacity}: timesteps/s of {CHAIN_STEPS}-step runs in "
                      f"turns graphs, eager, eager, graphs {rates['graphs'][0]:.3f} / "
                      f"{rates['eager'][0]:.3f} / {rates['eager'][1]:.3f} / "
                      f"{rates['graphs'][1]:.3f}; busy share graphs {busy['graphs']} eager "
                      f"{busy['eager']}; the runs end equal bit for bit; {card}")
                del sim
            finally:
                os.environ.pop("TPUSPH_DIST_FULL_MACHINERY", None)
    sims, rates, busy = {}, {"graphs": [], "eager": []}, {}
    for mode in ("graphs", "eager"):
        sim = DistSimulator(cfg, mesh_shape=(1, 1, 1), device=dev)
        # phase 11a's halo, a whole block, so that no step grows and makes
        # the timed stages again (which would be graphed)
        sim.dcfg = dataclasses.replace(sim.dcfg, halo_capacity=(cfg.padded_num_particles,) * 3)
        sim._rebuild_step()
        sim.setup(whole)
        if mode == "eager":
            build, update = mesh3d.make_mesh3d_timed(sim.cfg, sim.dcfg, sim.comm)
            sim._timed = (build.eager, update.eager)
        sim.simulate_and_time(Times())  # the capture, outside the turns
        sims[mode] = sim
    for mode in ("graphs", "eager", "eager", "graphs"):
        sim = sims[mode]
        sim.setup(whole)
        times = Times()
        for _ in range(MESH_TIMED_STEPS):
            sim.simulate_and_time(times)
        rates[mode].append(times.iters / (times.build_grid + times.sph_update + times.memcpy))
        if mode not in busy:
            print(f"14 --mesh 1x1x1 timed, {mode}:\n{format_times(times)}")
            busy[mode] = bench_torch._busy_share(
                lambda: [sim.simulate_and_time(Times()) for _ in range(2)], dev)
    require(_bit_equal(list(sims["graphs"].state), list(sims["eager"].state)),
            "14 --mesh 1x1x1: the graphed timed steps end apart from the eager ones")
    print(f"14 DistSimulator (1, 1, 1) timed (the CLI's --mesh 1x1x1), {N_MAIN} grid init, "
          f"{MESH_TIMED_STEPS} steps a run in turns graphs, eager, eager, graphs: timesteps/s "
          f"{rates['graphs'][0]:.3f} / {rates['eager'][0]:.3f} / {rates['eager'][1]:.3f} / "
          f"{rates['graphs'][1]:.3f}; busy share graphs {busy['graphs']} eager {busy['eager']} "
          f"(the collect by pid included); the states equal bit for bit; {card}")
    return per_replay


def _timed_transports(line, sync):
    """Wrap `line`'s transports (`_exchange`, `_all_reduce`: what a graphed
    body replays between its segments, and what an eager step calls) in
    timers that drain the card before and after each, so that the wait for
    the kernels queued ahead is not charged to them. Returns ({transport:
    seconds spent}, a function that takes the wrappers off)."""
    names = ("_exchange", "_all_reduce")
    spent = dict.fromkeys(names, 0.0)

    def timer(name, fn):
        def timed(*args):
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            spent[name] += time.perf_counter() - t0
            return out
        return timed

    for name in names:
        setattr(line, name, timer(name, getattr(line, name)))

    def undo():
        for name in names:
            delattr(line, name)  # the wrappers refer to line: no cycle left behind

    return spent, undo


def rank_graph_engine(comm, cfg, dcfg, start, makers, kernels) -> dict:
    """Phase 15 on one rank for one engine: the captures, each graphed
    entry point against its `.eager` bit for bit after each of 3 calls,
    the chains and the launches of each segment, the turns and the
    transport shares (module docstring). Returns its numbers."""
    make_step, make_timed, make_run = makers
    sync = torch.cuda.synchronize
    names = KERNEL_NAMES
    step = make_step(cfg, dcfg, comm)
    build, update = make_timed(cfg, dcfg, comm)
    run = make_run(cfg, dcfg, comm, RANK_GRAPH_STEPS)
    capture_s = {}
    for label, first in (("step", lambda: step(start)),
                         ("step with a click", lambda: step(start, GRAPH_CLICK)),
                         ("timed", lambda: update(*build(start))), ("run", lambda: run(start))):
        sync()
        t0 = time.perf_counter()
        first()
        sync()
        capture_s[label] = time.perf_counter() - t0

    a = b = c = d = start
    for k in range(GRAPH_STEPS):
        click = GRAPH_CLICK if k == 1 else None
        before = [fn.launches for fn in kernels]
        a, aux_a = step(a, click)
        if k == 0:
            step_launches = [fn.launches - n for fn, n in zip(kernels, before)]
        b, aux_b = step.eager(b, click)
        require(_bit_equal(_as_list(a, aux_a), _as_list(b, aux_b)),
                f"15 rank {comm.rank}: graphed step {k} differs from the eager one")
        c, aux_c = update(*build(c))
        d, aux_d = update.eager(*build.eager(d))
        require(_bit_equal(_as_list(c, aux_c), _as_list(d, aux_d)),
                f"15 rank {comm.rank}: graphed timed step {k} differs from the eager one")
        (e, aux_e), (f, aux_f) = run(start), run.eager(start)
        require(_bit_equal(_as_list(e, aux_e), _as_list(f, aux_f)),
                f"15 rank {comm.rank}: graphed run({RANK_GRAPH_STEPS}) call {k} differs")
        for aux in (aux_a, aux_c, aux_e):
            hold_clean(aux, cfg.num_particles, f"15 rank {comm.rank} call {k}")
    require(step_launches == [1] * len(kernels), f"15 rank {comm.rank}: a step replay "
            f"launched {step_launches} {names}")

    chains = {}
    for entry, fn in (("step", step), ("timed", build), ("run", run)):
        for key, loop in fn.graphs.loops.items():
            chains[" ".join(str(x) for x in key)] = {
                "structure": loop.structure,
                "launches": [{n: seg.get(kf, 0) for n, kf in zip(names, kernels)}
                             for seg in loop.launches]}

    def step_ms(fn):
        state = start
        sync()
        t0 = time.perf_counter()
        for _ in range(RANK_GRAPH_STEPS):
            state, _ = fn(state)
        sync()
        return (time.perf_counter() - t0) / RANK_GRAPH_STEPS * 1e3

    def run_ms(fn):
        sync()
        t0 = time.perf_counter()
        fn(start)
        sync()
        return (time.perf_counter() - t0) / RANK_GRAPH_STEPS * 1e3

    turns = {"step": {"graphs": [], "eager": []}, "run": {"graphs": [], "eager": []}}
    for mode in ("graphs", "eager", "eager", "graphs"):
        turns["step"][mode].append(step_ms(step if mode == "graphs" else step.eager))
        turns["run"][mode].append(run_ms(run if mode == "graphs" else run.eager))
    line = comm if hasattr(comm, "_exchange") else comm._brick
    transport = {}
    for mode, fn in (("graphs", step), ("eager", step.eager)):
        spent, undo = _timed_transports(line, sync)
        try:
            ms = step_ms(fn)
        finally:
            undo()
        per_step = {name: t / RANK_GRAPH_STEPS * 1e3 for name, t in spent.items()}
        transport[mode] = {"ms_per_step": ms, "transport_ms_per_step": sum(per_step.values()),
                           "exchange_ms_per_step": per_step["_exchange"],
                           "reduce_ms_per_step": per_step["_all_reduce"]}
    return {"capture_s": capture_s, "step_launches": step_launches, "chains": chains,
            "turns": turns, "transport": transport}


def rank_graph_rank(comm, payload: dict) -> None:
    """One of phase 15's ranks (a process of its own on the one card): the
    z-slab line, then the (1, 2, 2) brick grid over the same group; writes
    its numbers to `payload["out"]/graphs<r>.json`."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.dist import mesh3d, sharded
    from tpusph_torch.dist.simulator import DistSimulator

    kernels = main_kernels()
    cfg = tuned_config(payload["n"])
    whole = init_state(cfg, device="cpu")
    dcfg = sharded.DistConfig(**payload["dcfg"])
    start = sharded.distribute_state(whole, cfg, dcfg, comm)
    out = {"rank": comm.rank, "slab": rank_graph_engine(
        comm, cfg, dcfg, start,
        (sharded.make_sharded_step, sharded.make_sharded_timed, sharded.make_sharded_run),
        kernels)}
    sim = DistSimulator(cfg, comm, mesh_shape=BRICK_GRID, device=comm.device)
    sim.setup()
    sim.run(DIST_STEPS)  # settles the capacities (grows what overflows), as phase 11b
    grid, mcfg = sim.comm, sim.dcfg
    start = mesh3d.distribute_state_3d(whole, cfg, mcfg, grid)
    out["brick"] = rank_graph_engine(
        grid, cfg, mcfg, start,
        (mesh3d.make_mesh3d_step, mesh3d.make_mesh3d_timed, mesh3d.make_mesh3d_run), kernels)
    out["brick"]["caps"] = [mcfg.dev_capacity, list(mcfg.halo_capacity),
                            list(mcfg.migration_capacity)]
    with open(os.path.join(payload["out"], f"graphs{comm.rank}.json"), "w") as f:
        json.dump(out, f)


def multirank_phase(card: str, dev) -> dict:
    """Phase 15 (see the module docstring). Returns each kernel's launches
    in one replayed step of each rank, by engine."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.dist.comm import spawn_ranks

    names = KERNEL_NAMES
    cfg = tuned_config(N_MAIN)
    planes, occupancy, caps = four_slab_caps(cfg)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host, no network
    with tempfile.TemporaryDirectory() as tmp:
        payload = {"n": N_MAIN, "dcfg": caps, "out": tmp}
        t0 = time.perf_counter()
        spawn_ranks(rank_graph_rank, DIST_RANKS, f"file://{tmp}/store", dev, (payload,),
                    deadline_s=DIST_DEADLINE_S)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"graphs{r}.json")) as f:
                ranks.append(json.load(f))
    require([r["rank"] for r in ranks] == list(range(DIST_RANKS)), "a rank did not report")
    print(f"15. multi-rank graphs, {DIST_RANKS} ranks on one card over gloo, {N_MAIN} grid init "
          f"(spawn to join {spawn_s:.1f} s): every graphed step (a click at the second), timed "
          f"step and run({RANK_GRAPH_STEPS}) equals its .eager bit for bit after each of "
          f"{GRAPH_STEPS} calls on every rank, counters clean, each segment replayed under sync "
          f"debug mode error; slab planes {planes}, occupancy {occupancy}; {card}")
    launches = {n: {} for n in names}
    for engine, label in (("slab", "z-slab line"), ("brick", f"brick grid {BRICK_GRID}")):
        for r in ranks:
            e = r[engine]
            step = next(c for key, c in e["chains"].items() if key.startswith("step False"))
            kinds = {k: step["structure"].count(k) for k in ("segment", "exchange", "reduce")}
            t, x = e["turns"], e["transport"]
            share = {m: x[m]["transport_ms_per_step"] / x[m]["ms_per_step"] for m in x}
            print(f"  {label}, rank {r['rank']}: a step {kinds['segment']} segments, "
                  f"{kinds['exchange']} exchanges, {kinds['reduce']} reduce "
                  f"({' '.join(step['structure'])}); launches of each segment a replay "
                  f"{step['launches']}; capture s {e['capture_s']}"
                  + (f"; capacities {e['caps']}" if "caps" in e else ""))
            print(f"    ms a step in turns graphs, eager, eager, graphs: {RANK_GRAPH_STEPS} step() "
                  f"calls {_turns(t['step'], 'graphs', 'eager')}; run({RANK_GRAPH_STEPS}) "
                  f"{_turns(t['run'], 'graphs', 'eager')}; inside the transports, graphs "
                  + "; eager ".join(
                      f"{x[m]['transport_ms_per_step']:.3f} of {x[m]['ms_per_step']:.3f} ms "
                      f"({share[m]:.3f}: exchanges {x[m]['exchange_ms_per_step']:.3f}, reduce "
                      f"{x[m]['reduce_ms_per_step']:.3f})" for m in ("graphs", "eager")))
            for n, count in zip(names, e["step_launches"]):
                launches[n].setdefault(f"four {engine} ranks, one graphed step", []).append(count)
        slowest = {m: max(sum(r[engine]["turns"]["step"][m]) / 2 for r in ranks)
                   for m in ("graphs", "eager")}
        print(f"  {label}: slowest rank {slowest['graphs']:.3f} ms a graphed step against "
              f"{slowest['eager']:.3f} eager (the mean of its two turns); four ranks time-share "
              f"one card: a check of correctness, not a scaling figure; {card}")

    # the sharded bench on two ranks under torchrun
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TPUSPH_", "WORLD_SIZE"))}
    with tempfile.TemporaryDirectory() as tmp:
        env.update(TPUSPH_BENCH_N=str(N_MAIN), TPUSPH_BENCH_STEPS=str(CHAIN_STEPS),
                   TPUSPH_BENCH_DIST="2", TPUSPH_BENCH_ARTIFACT_DIR=tmp, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               "2", os.path.join(REPO, "bench_torch.py")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=BENCH_TIMEOUT_S)
        secs = time.perf_counter() - t0
        require(r.returncode == 0, f"torchrun bench_torch.py exited {r.returncode}:\n"
                f"{r.stderr[-3000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        with open(os.path.join(tmp, "TORCH_DIST_BENCH.json")) as f:
            art = json.load(f)
    require(line["metric"] == f"torch_sph_dist_timesteps_per_sec_n{N_MAIN}_r2"
            and line["parity"] == "pass" and line["value"] > 0, f"15 bench: {line}")
    require(art["graphed"] is True and art["ranks"] == 2, f"15 bench artifact: {art}")
    print(f"TPUSPH_BENCH_DIST=2 torchrun --standalone --nproc_per_node 2 bench_torch.py: "
          f"{json.dumps(line)} ({secs:.1f} s with its gate); graphed {art['graphed']}, busy "
          f"{art['device_busy']}, capacities dev {art['dev_capacity']} halo "
          f"{art['halo_capacity']} migration {art['migration_capacity']}, migration (sorts, "
          f"skips) ({art['migration_sorts']}, {art['migration_skips']}); two ranks time-share "
          f"one card; {card}")
    return launches


def if_node_graph(pred, flag, nodes: int, dev):
    """(graph, body): a kept, instantiated graph that zeroes `flag`, then
    `nodes` times launches `set_if` on `pred` with an if node behind it
    whose body (`body`, captured first in a pool of its own) writes 1 into
    `flag`. A replay leaves 1 in `flag` exactly where the card took the
    branch."""
    from tpusph_torch.kernels import graph_cond

    body = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body.capture_begin(pool=torch.cuda.graph_pool_handle())
        flag.fill_(1)
        body.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        flag.zero_()
        for _ in range(nodes):
            graph_cond.set_if(pred, body.raw_cuda_graph())
    graph.instantiate()
    return graph, body


def replay_ms(graph, reps: int = 11) -> float:
    """Device ms of one replay of `graph`: the median over `reps` replays
    timed by CUDA events, after one warm replay."""
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def branch_phase(card: str, kernels, dev) -> dict:
    """Phase 16 (see the module docstring). Returns set_if's row of the
    kernels line and each kernel's launches in 16b's graphed 20-step run
    with the skip."""
    from tpusph_torch.core.config import tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.dist import sharded
    from tpusph_torch.dist.comm import SlabComm
    from tpusph_torch.dist.simulator import DistSimulator
    from tpusph_torch.kernels import graph_cond
    from tpusph_torch.scripts import graph_ms
    from tpusph_torch.utils import cuda_build

    names = (*KERNEL_NAMES, "set_if")
    counted = (*kernels, graph_cond.set_if)

    # a. set_if and its if node against the plain version, and its time
    lib = cuda_build.library_path()
    print(f"16. the device branch, torch {torch.__version__}: tpusph_graph_if and the kernel "
          f"set_if of tpusph_torch/csrc/graph_cond.cu, from the port's library "
          f"{os.path.relpath(lib, REPO)} (torch.cuda.CUDAGraph(keep_graph=True), "
          f"raw_cuda_graph(), instantiate()); {card}")
    err = 0.0
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    for value in BRANCH_PREDS:
        pred = torch.tensor(value, dtype=torch.int32, device=dev)
        graph, _ = if_node_graph(pred, flag, 1, dev)
        seen = []
        for v in (value, 1 - value):  # the same graph decides again at each replay
            pred.fill_(v)
            graph.replay()
            torch.cuda.synchronize()
            want = graph_cond.set_if_plain(pred)
            err = max(err, float((flag - want.to(torch.int32)).abs()))
            require(bool(flag) == bool(want), f"16a: set_if on {v}: the card took "
                    f"{bool(flag)}, its plain version says {bool(want)}")
            seen.append((v, bool(flag)))
        require(graph_cond.node_counts(graph.raw_cuda_graph())["conditional"] == 1,
                "16a: the graph does not hold one conditional node")
        print(f"16a. set_if on {seen[0][0]} then {seen[1][0]} in one graph: the if node ran "
              f"{seen[0][1]}, {seen[1][1]} = pred > 0 (its plain version)")
    pred = torch.zeros((), dtype=torch.int32, device=dev)
    timing = {}
    for v in (0, 1):
        pred.fill_(v)
        graph, _ = if_node_graph(pred, flag, BRANCH_NODES, dev)
        counts = graph_cond.node_counts(graph.raw_cuda_graph())
        require(counts["conditional"] == BRANCH_NODES, f"16a: node counts {counts}")
        timing[v] = replay_ms(graph) / BRANCH_NODES
        require(bool(flag) == bool(v), "16a: the timed graph took the wrong branch")
    plain = graph_ms(lambda: graph_cond.set_if_plain(pred))
    row = dict(route="cuda", source="tpusph_torch/csrc/graph_cond.cu",
               replaces="tpusph/dist/sharded.py:610", max_abs_err=err, ms=timing[0],
               plain_ms=plain, library_ms=None,
               at=f"one int32 predicate, {BRANCH_NODES} if nodes in one graph, body skipped")
    row["bound_ms"], row["bound_by"] = bound(4 + 4, 1)  # read pred, set the condition
    row["body_ms"] = timing[1]
    print(f"16a. set_if and its if node, {BRANCH_NODES} in one graph (node types {counts}): "
          f"{timing[0]:.5f} ms each with the body skipped, {timing[1]:.5f} with its body (one "
          f"fill) run; plain version (pred > 0, 10 in one graph) {plain:.5f} ms; bound "
          f"{row['bound_ms']:.2e} ms ({row['bound_by']}); {card}")

    # b. one rank through the whole machinery: the graphed run's skip
    cfg = tuned_config(N_MAIN)
    comm = SlabComm(dev)
    os.environ["TPUSPH_DIST_FULL_MACHINERY"] = "1"
    try:
        dcfg = sharded.DistConfig(1, cfg.padded_num_particles, DIST_HALO_ONE_CARD,
                                  DIST_MIGRATION)
        start = sharded.distribute_state(init_state(cfg, device="cpu"), cfg, dcfg, comm)
        run = sharded.make_sharded_run(cfg, dcfg, comm, SKIP_STEPS)
        ends, tallies, capture_s, nodes = {}, {}, {}, {}
        for mode in ("skip", "sort", "eager"):
            os.environ["TPUSPH_DIST_FORCE_MIGSORT"] = "1" if mode == "sort" else "0"
            try:
                before = sharded.migration_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ends[mode] = (run.eager if mode == "eager" else run)(start)
                torch.cuda.synchronize()
                capture_s[mode] = time.perf_counter() - t0
                tallies[mode] = tuple(b - a for a, b in zip(before, sharded.migration_counts()))
                if mode != "eager":
                    loop = run.graphs.loops[("run", False, mode == "sort")]
                    nodes[mode] = graph_cond.node_counts(loop.chain[0].graph.raw_cuda_graph())
            finally:
                os.environ.pop("TPUSPH_DIST_FORCE_MIGSORT", None)
        for mode in ("sort", "eager"):
            require(_bit_equal(_as_list(*ends[mode]), _as_list(*ends["skip"])),
                    f"16b: the {mode} run ends apart from the graphed skip")
        hold_clean(ends["skip"][1], N_MAIN, "16b")
        require(tallies == {"skip": (0, SKIP_STEPS), "sort": (SKIP_STEPS, 0),
                            "eager": (0, SKIP_STEPS)}, f"16b: (sorts, skips) {tallies}")
        require(nodes["skip"]["conditional"] == SKIP_STEPS and nodes["sort"]["conditional"] == 0,
                f"16b: conditional nodes {nodes}")
        # the slice's path: the captured skip run replayed, its launches counted
        for fn in counted:
            fn.launches = 0
        before = sharded.migration_counts()
        state, aux = run(start)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in zip(names, counted)}
        replay_tally = tuple(b - a for a, b in zip(before, sharded.migration_counts()))
        require(_bit_equal(_as_list(state, aux), _as_list(*ends["skip"])),
                "16b: the replayed run differs from its first call")
        require(all(c == SKIP_STEPS for c in launches.values()),
                f"16b: launches of a replayed {SKIP_STEPS}-step run {launches}")
    finally:
        os.environ.pop("TPUSPH_DIST_FULL_MACHINERY", None)
    print(f"16b. one rank, whole machinery, {N_MAIN} grid init, make_sharded_run({SKIP_STEPS}) "
          f"graphed: the skip, TPUSPH_DIST_FORCE_MIGSORT=1 and the eager run (host-read skip) "
          f"end equal bit for bit (rows and counters); (sorts, skips) {tallies}; the replay "
          f"{replay_tally}; nodes of the run graph, skip {nodes['skip']}, sort {nodes['sort']}; "
          f"first call (capture, replay) s {capture_s}; launches of a replay {launches}")
    del comm

    # c. the sharded bench on one rank through the whole machinery, the
    # sort and the skip in turns (phase 14c's protocol)
    for n in GRAPH_TIERS:
        cfg_n = tuned_config(n)
        host0 = init_state(cfg_n, device="cpu")
        os.environ["TPUSPH_DIST_FULL_MACHINERY"] = "1"
        try:
            sim = DistSimulator(cfg_n, device=dev)
            sim.setup(host0)
            sim.right_size(warmup_steps=10)
            runners = {k: sharded.make_sharded_run(sim.cfg, sim.dcfg, sim.comm, k)
                       for k in (CHAIN_STEPS, PROFILED_STEPS)}
            rates, busy, ends, tallies = {"sort": [], "skip": []}, {}, {}, {}
            capture_s, nodes = {}, {}
            for mode in ("sort", "skip", "skip", "sort"):
                os.environ["TPUSPH_DIST_FORCE_MIGSORT"] = "1" if mode == "sort" else "0"
                try:
                    sim.setup(host0)
                    sim._runners.update(runners)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sim.run(CHAIN_STEPS)  # warm (the capture, at its first turn)
                    torch.cuda.synchronize()
                    capture_s.setdefault(mode, time.perf_counter() - t0)
                    sim.setup(host0)
                    sim._runners.update(runners)
                    before = sharded.migration_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sim.run(CHAIN_STEPS)
                    torch.cuda.synchronize()
                    rates[mode].append(CHAIN_STEPS / (time.perf_counter() - t0))
                    tallies.setdefault(mode, tuple(
                        b - a for a, b in zip(before, sharded.migration_counts())))
                    if mode in ends:
                        require(_bit_equal(list(sim.state), ends[mode]),
                                f"16c {n}: the {mode} turns end apart")
                    ends[mode] = list(sim.state)
                    if mode not in busy:
                        loop = runners[CHAIN_STEPS].graphs.loops[("run", False, mode == "sort")]
                        nodes[mode] = graph_cond.node_counts(
                            loop.chain[0].graph.raw_cuda_graph())["conditional"]
                        sim.run(PROFILED_STEPS)  # the capture of the profiled run
                        busy[mode] = bench_torch._busy_share(lambda: sim.run(PROFILED_STEPS),
                                                             dev)
                finally:
                    os.environ.pop("TPUSPH_DIST_FORCE_MIGSORT", None)
            require(_bit_equal(ends["sort"], ends["skip"]),
                    f"16c {n}: the skip ends apart from the sort")
            require(tallies == {"sort": (CHAIN_STEPS, 0), "skip": (0, CHAIN_STEPS)},
                    f"16c {n}: (sorts, skips) {tallies}")
            require(nodes == {"sort": 0, "skip": CHAIN_STEPS},
                    f"16c {n}: conditional nodes of the run graphs {nodes}")
            print(f"16c. sharded bench, one rank, whole machinery, {n} grid init, capacities dev "
                  f"{sim.dcfg.dev_capacity} halo {sim.dcfg.halo_capacity} migration "
                  f"{sim.dcfg.migration_capacity}: timesteps/s of graphed {CHAIN_STEPS}-step "
                  f"runs in turns sort, skip, skip, sort {_turns(rates)}; busy share sort "
                  f"{busy['sort']} skip {busy['skip']}; (sorts, skips) {tallies}; conditional "
                  f"nodes of the {CHAIN_STEPS}-step run graph {nodes}; first call (capture, "
                  f"replay) s {capture_s}; the runs end equal bit for bit; {card}")
            del sim
        finally:
            os.environ.pop("TPUSPH_DIST_FULL_MACHINERY", None)
    return row, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this runs only on a GPU",
              file=sys.stderr)
        return 1

    from tpusph_torch import cli
    from tpusph_torch.bench.times import Times, format_times
    from tpusph_torch.core.config import default_config, tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.core.io import load_state
    from tpusph_torch.engine.simulator import Simulator
    from tpusph_torch.engine.step import make_step
    from tpusph_torch.kernels import probes
    from tpusph_torch.scripts import loop_probe as loop_script
    from tpusph_torch.scripts import (card_line, graph_ms, sass_loops, slope, timed,
                                      vpu_microbench)
    from tpusph_torch.utils import cuda_build

    # ---------------------------------------------------------- 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    print(card)

    # ----------------------------------------------------------- 2. build
    path, build_s = cuda_build.build()
    cuda_build.library()
    print(f"build: {build_s:.2f} s -> {os.path.relpath(path, REPO)}")
    # the host library too (g++), so that free mode's first frame does not
    # pay for it; phase 9 holds its raster against numpy's
    from tpusph_torch.utils import native

    t0 = time.perf_counter()
    require(native.get_lib() is not None, "the native host library did not build or load")
    print(f"build: native host library {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(native.library_path(), REPO)}")
    log = path.with_suffix(".log")
    kernel = None
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            kernel = kernel_name(line)
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {kernel}: {line.split(':', 1)[-1].strip()}")

    # ---------------------------------- 3. kernels against plain versions
    cfg = tuned_config(N_MAIN)
    results = kernel_phase(card, dev)

    # ------------------------------------------------- 4. parity at 4096
    # bench_torch's gate: the timed loop (the fields chain) against the
    # cell_list tile passes, multisets; cell_list and a kernel step against
    # the NumPy oracle
    require(bench_torch.verify_parity("kernels", 10, N_PARITY, dev) == "pass",
            f"bench_torch.verify_parity at N={N_PARITY} failed (details on stderr)")
    print(f"parity N={N_PARITY}: bench_torch.verify_parity passes on the card (10 chained "
          "fields steps against 10 cell_list steps; a cell_list step and a kernel step "
          "against the NumPy oracle)")

    cfg4 = default_config(N_PARITY)
    s0 = init_state(cfg4, device=dev)
    sg, sc = s0, init_state(cfg4, device="cpu")
    step_gpu, step_cpu = make_step(cfg4, "kernels", dev), make_step(cfg4, "kernels", "cpu")
    for _ in range(10):
        sg, _ = step_gpu(sg)
        sc, _ = step_cpu(sc)
    vg, vc = sg.valid.cpu().numpy(), sc.valid.numpy()
    require(vg.sum() == vc.sum() == N_PARITY, "valid slots differ")
    pa, ra = bench_torch._canon(sg.position.cpu().numpy()[vg], sg.density.cpu().numpy()[vg])
    pb, rb = bench_torch._canon(sc.position.numpy()[vc], sc.density.numpy()[vc])
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ra, rb, rtol=1e-4, atol=0)
    print(f"parity N={N_PARITY}: 10 kernel steps match 10 plain steps on the CPU")

    # ----------------------------------------------------- 5. timed path
    kernels = main_kernels()
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    sim = Simulator(tuned_config(N_MAIN), device="cuda")
    sim.setup()
    warm = Times()
    for _ in range(WARMUP_STEPS):
        sim.simulate_and_time(warm)
    times = Times()
    worst_oob = worst_ovf = 0
    for _ in range(TIMED_STEPS):
        sim.simulate_and_time(times)
        worst_oob = max(worst_oob, int(sim.last_aux.oob_count))
        worst_ovf = max(worst_ovf, sim.last_aux.window_overflow)
    launches = {name: fn.launches for name, fn in zip(KERNEL_NAMES, kernels)}
    print(format_times(times))
    phase_s = times.build_grid + times.sph_update + times.memcpy
    timed_rate = times.iters / phase_s
    print(f"timesteps/s: {timed_rate:.3f} (N={N_MAIN} grid init, "
          f"{TIMED_STEPS} steps; {card})")
    print(f"peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    print(f"launches in the main path: {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} kernel was not launched by the main path")
    hold_packed(launches, "the main path")
    require(worst_oob == 0, f"{worst_oob} particles left the grid")
    require(worst_ovf == 0, f"window overflow {worst_ovf}")
    for f in ("position", "velocity", "force", "density", "pressure"):
        require(torch.isfinite(getattr(sim.state, f)).all(), f"non-finite {f}")
    pos = sim.get_position()
    main_state = sim.state
    require(pos.shape == (N_MAIN, 3) and np.isfinite(pos).all(), "bad host positions")
    lo, hi = cfg.h, cfg.box_dim - cfg.h
    require(pos.min() >= lo - 1e-6 and pos.max() <= hi + 1e-6, "particle outside the box")

    # --------------------------------------------------------- 6. probes
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    def keys(count):
        return torch.randint(0, 3, (count,), device=dev, generator=gen).float()

    probe_err = {"fma_probe": 0.0, "density_mix": 0.0, "loop_probe": 0.0}

    def hold(name, got, want, rtol):
        torch.cuda.synchronize()
        if rtol:
            torch.testing.assert_close(got, want, rtol=rtol, atol=0)
        else:
            require(torch.equal(got, want), f"{name} differs from its plain version")
        err = float((got.float() - want.float()).abs().max())
        probe_err[name] = max(probe_err[name], err)

    def hold_sum(got, want, rounds):
        """A loop probe's sum over `rounds` f32 terms, rounded in two orders
        (nvcc's FMA against separate ops): each element within the bound
        rounds·eps·|sum| of two such sums (a static-load variant adds the
        same term every round and may reach it: one rounding that tips the
        other way recurs each round), and the mean difference under 1 % of
        one round's mean term, which a kernel one round short misses by 100×."""
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, want, rtol=rounds * torch.finfo(torch.float32).eps, atol=0)
        shift = float((got - want).mean()) / (float(want.mean()) / rounds)
        require(abs(shift) < 0.01, f"loop_probe at {rounds} rounds: mean difference "
                f"{shift:.3g} of a round's term")
        err = float((got - want).abs().max())
        probe_err["loop_probe"] = max(probe_err["loop_probe"], err)
        return err, shift

    def loop_inputs(rounds, trip):
        desc = torch.randint(0, (cap - bl) // 128, (rounds + 8,), device=dev, generator=gen)
        desc[rounds] = trip
        return desc.to(torch.int16)

    r = CHECK_ROUNDS
    for dtype in probes.DTYPES:
        rtol = 1e-5 if dtype == torch.float32 else 0
        for streams in probes.FMA_STREAMS:
            x = uniform((vpu_microbench.SUB, 128), 0.5, 2.0).to(dtype)
            hold("fma_probe", probes.fma_probe(x, streams, r),
                 probes.fma_probe_plain(x, streams, r), rtol)
        for pt in (8, 64, 128, 256):
            t, c = uniform((max(pt, 8), 4), 1.0, 1.05), uniform((8, 128), 1.0, 1.05)
            t[:, 3], c[3] = keys(t.shape[0]), keys(128)
            t, c = t.to(dtype), c.to(dtype)
            for rounds in MIX_ROUNDS:
                got = probes.density_mix(t, c, pt, rounds)
                hold("density_mix", got, probes.density_mix_plain(t, c, pt, rounds), rtol)
    pt, bl, cap = 64, 256, loop_script.CAP
    t, cand = uniform((pt, 4), 1.0, 1.05), uniform((8, cap), 1.0, 1.05)
    # The loop probe with its candidates staged in shared memory and, for a
    # copy of cand 4 bytes off a 16-byte boundary, which it cannot stage,
    # read from device memory. 67 rounds are no multiple of the rounds a loop
    # iteration takes, 1 round runs the loop of single rounds alone; the
    # dynamic-trip variants run desc[rounds] blocks, not rounds.
    cand_off = torch.empty(8 * cap + 1, device=dev)[1:].view(8, cap).copy_(cand)
    require(probes.loop_stage_blocks("V3", cand, bl) > 0
            and probes.loop_stage_blocks("V0", cand_off, bl) == 0,
            "the loop probe's inputs do not reach both of its paths")
    for rounds, trip in [(n, n) for n in LOOP_ROUNDS] + [(r, r - 23)]:
        desc = loop_inputs(rounds, trip)
        for variant in probes.VARIANTS if trip == rounds else ("V2", "V3", "V4", "V5"):
            want = probes.loop_probe_plain(variant, desc, t, cand, pt, bl)
            for c in (cand, cand_off):
                hold("loop_probe", probes.loop_probe(variant, desc, t, c, pt, bl), want, 1e-5)
    print(f"probes at {r} rounds (dynamic trips also at desc[{r}] = {r - 23}; the density "
          f"mix at {MIX_ROUNDS} rounds; the loop probe at {LOOP_ROUNDS} rounds, staged and "
          f"from device memory) equal their plain versions; max|err| {probe_err}")

    # At the entry points' round counts. f32 FMA on inputs where a fused and
    # a split multiply-add round alike: bit-equal, so every round must run
    # (the bf16 chain cannot show it: bf16(c1) = 1 and c2 is under half an
    # ulp). The loop probe at R for every variant and at 4R for V0 and V1,
    # whose trip counts are compiled in.
    fr = vpu_microbench.R
    x = probes.fma_tie_free_input((vpu_microbench.SUB, 128), 0, 4 * fr).to(dev)
    for streams in probes.FMA_STREAMS:
        got = probes.fma_probe(x, streams, fr)
        hold("fma_probe", got, probes.fma_probe_plain(x, streams, fr), 0)
        require(not torch.equal(got, probes.fma_probe(x, streams, fr - 1)),
                "the FMA probe's output does not show its round count")
    print(f"f32 FMA probe at {fr} rounds equals its plain version bit for bit")
    for rounds in (loop_script.R, 4 * loop_script.R):
        desc = loop_inputs(rounds, rounds)
        for variant in probes.VARIANTS if rounds == loop_script.R else ("V0", "V1"):
            got = probes.loop_probe(variant, desc, t, cand, pt, bl)
            want = probes.loop_probe_plain(variant, desc, t, cand, pt, bl)
            err, shift = hold_sum(got, want, rounds)
            print(f"loop_probe {variant} at {rounds} rounds: max|err| {err:.3e}, mean "
                  f"difference {shift:.3e} of a round's term")

    probe_fns = {"fma_probe": probes.fma_probe, "density_mix": probes.density_mix,
                 "loop_probe": probes.loop_probe}
    for fn in probe_fns.values():
        fn.launches = 0
    probes.loop_probe.staged = 0
    rates = vpu_microbench.main()
    rates.update({("loop_probe", v): g for v, g in loop_script.main([]).items()})
    for name, fn in probe_fns.items():
        launches[name] = fn.launches
    print(f"launches in the probe path: { {n: launches[n] for n in probe_fns} }; the loop "
          f"probe staged its candidates in shared memory in "
          f"{probes.loop_probe.staged / max(launches['loop_probe'], 1):.4f} of its calls")
    for key, rate in rates.items():
        require(math.isfinite(rate) and rate > 0, f"probe rate {key} = {rate}")
    for name in probe_fns:
        require(launches[name] > 0, f"{name} kernel was not launched by the probe path")

    def plain_ms(call, rounds):
        """The plain version's slope at rounds/100 and 4·rounds/100, scaled
        to `rounds`, in ms."""
        lo = max(1, rounds // 100)
        dt = slope(timed(lambda: call(lo), 2), timed(lambda: call(4 * lo), 2), lo, 4 * lo)
        return dt * rounds * 1e3

    ones = torch.ones((vpu_microbench.SUB, 128), device=dev)
    fma_r = vpu_microbench.R
    mix_t, mix_c = torch.ones((128, 4), device=dev), torch.ones((8, 128), device=dev)
    mix_r = vpu_microbench.R
    rng = np.random.default_rng(0)
    lp_t = torch.from_numpy(rng.uniform(1, 9, (64, 4)).astype(np.float32)).to(dev)
    lp_c = torch.from_numpy(rng.uniform(1, 9, (8, cap)).astype(np.float32)).to(dev)
    lp_r = loop_script.R
    lp_desc = np.zeros((lp_r + 8,), np.int16)
    lp_desc[:lp_r] = rng.integers(0, (cap - 256) // 128, lp_r)
    lp_desc[lp_r] = lp_r
    lp_desc = torch.from_numpy(lp_desc).to(dev)

    @functools.cache
    def lp_desc_of(rounds):
        d = torch.zeros(rounds + 8, dtype=torch.int16, device=dev)
        d[:rounds] = lp_desc[:rounds]
        d[rounds] = rounds
        return d

    probe_calls = {
        "fma_probe": (
            f"float32, streams 8, ({vpu_microbench.SUB}, 128), {fma_r} rounds",
            lambda n: probes.fma_probe(ones, 8, n), lambda n: probes.fma_probe_plain(ones, 8, n),
            fma_r),
        "density_mix": (
            f"float32, pt 128, {mix_r} rounds",
            lambda n: probes.density_mix(mix_t, mix_c, 128, n),
            lambda n: probes.density_mix_plain(mix_t, mix_c, 128, n), mix_r),
        "loop_probe": (
            f"V3, pt 64, bl 256, {lp_r} rounds",
            lambda n: probes.loop_probe("V3", lp_desc_of(n), lp_t, lp_c, 64, 256),
            lambda n: probes.loop_probe_plain("V3", lp_desc_of(n), lp_t, lp_c, 64, 256),
            lp_r),
    }
    sources = {
        "fma_probe": "scripts/vpu_microbench.py:45",
        "density_mix": "scripts/vpu_microbench.py:81",
        "loop_probe": "scripts/loop_probe.py:54",
    }
    # (bytes, flops) of each timed probe call: an FMA is 2 flops; the density
    # mix does 16 operations a pair-lane and round, the loop probe's V3 13
    sub = vpu_microbench.SUB
    probe_work = {
        "fma_probe": (2 * 4 * sub * 128, 2 * sub * 128 * 8 * fma_r),
        "density_mix": (4 * (128 * 4 + 8 * 128 + 128 * 128), 16 * 128 * 128 * mix_r),
        "loop_probe": (2 * (lp_r + 8) + 4 * (64 * 4 + 8 * cap + 64 * 256),
                       13 * 64 * 256 * lp_r),
    }
    for name, (at, kern, plain, rounds) in probe_calls.items():
        r = results[name] = dict(
            route="cuda", source="tpusph_torch/csrc/probes.cu", replaces=sources[name],
            max_abs_err=probe_err[name], at=at,
            ms=timed(lambda: kern(rounds), 6) * 1e3, plain_ms=plain_ms(plain, rounds))
        r["bound_ms"], r["bound_by"] = bound(*probe_work[name])
        print(f"time {name} ({at}): kernel {r['ms']:.4f} ms per call, plain "
              f"{r['plain_ms']:.4f} ms (its slope from {max(1, rounds // 100)} "
              f"to {4 * max(1, rounds // 100)} rounds, scaled to {rounds}); bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"{r['bound_ms'] / r['ms']:.4f}; {card}")

    mix = results["density_mix"]

    # The issue ceiling: a round's instructions on every scheduler of the
    # card, one warp instruction a cycle each. From the SASS of the f32
    # kernel's loop, which also shows each round's four loads inside it.
    unroll = int(re.search(r"kMixUnroll = (\d+);",
                           (cuda_build.CSRC / "probes.cu").read_text()).group(1))
    loops = sass_loops(path, "density_mix_kernel", "F32Ops")
    require(loops, "no loop found in the SASS of the f32 density-mix kernel")
    body, loads = max(loops, key=lambda loop: loop[1])
    require(loads > 0 and loads % (4 * unroll) == 0,
            f"the density mix's loop holds {loads} loads, no multiple of 4 x {unroll}")
    per_round = body / (loads // 4)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ceiling_ms = per_round * mix_r * 128 * 128 / (sms * 4 * 32 * sm_mhz * 1e6) * 1e3
    mix.update(issue_ceiling_ms=ceiling_ms, sass_instructions_per_round=per_round,
               sass_loads_per_round=loads / (loads // 4))
    print(f"density_mix SASS (float32): loops (instructions, loads) {loops}; the main loop "
          f"takes {loads // 4} rounds in {body} instructions with {loads} LDG inside it = "
          f"{per_round:.3f} instructions and 4 loads a round")
    print(f"density_mix issue ceiling (float32, pt 128, {mix_r} rounds): {per_round:.3f} "
          f"instructions x {128 * 128} pair-lanes x {mix_r} rounds / ({sms} SMs x 4 schedulers "
          f"x 32 lanes x {sm_mhz:.0f} MHz) = {ceiling_ms:.4f} ms; the kernel ({mix['ms']:.4f} "
          f"ms) reaches {ceiling_ms / mix['ms']:.4f} of it; bound {mix['bound_ms']:.4f} ms; "
          f"{card}")

    # The density kernel beside the probe: its candidate pairs at the
    # probe's best f32 rate of this run.
    best = max(rate for key, rate in rates.items()
               if key[0] == "density_mix" and key[1] == "float32")
    mix["best_load_bytes_per_clock_per_sm"] = best * 1e9 * 16 / (sms * sm_mhz * 1e6)
    print(f"density_mix best float32 rate {best:.2f} Gpair-lanes/s: its four 4-byte loads a "
          f"pair-lane and round are {mix['best_load_bytes_per_clock_per_sm']:.2f} bytes a clock "
          f"and SM at {sm_mhz:.0f} MHz on {sms} SMs; {card}")
    for label, row in results["density"]["by_step"].items():
        row["mix_ceiling_ms"] = row["candidate_pairs"] / (best * 1e9) * 1e3
        print(f"density at step {label}: kernel {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), mix_ceiling_ms "
              f"{row['mix_ceiling_ms']:.4f} ({row['candidate_pairs']} candidate pairs at the "
              f"probe's best {best:.2f} Gpair-lanes/s): the kernel runs at "
              f"{row['mix_ceiling_ms'] / row['ms']:.4f} of the probe's rate; {card}")

    # The loop probe alone: ms a call at R by CUDA events around the call
    # (the wrapper's host time included) and the device's ms (10 calls in
    # one CUDA graph, the median of 5 replays).
    loop = results["loop_probe"]
    loop["rates"] = {v: rates[("loop_probe", v)] for v in probes.VARIANTS}
    loop["by_variant"] = {}
    lp_big = torch.from_numpy(rng.uniform(1, 9, (128, 4)).astype(np.float32)).to(dev)
    for tpt, variants in ((64, tuple(probes.VARIANTS)), (8, ("V3", "V5")), (128, ("V3", "V5"))):
        for variant in variants:
            def call():
                return probes.loop_probe(variant, lp_desc, lp_big, lp_c, tpt, 256)

            turn = loop["by_variant"][f"{variant} pt {tpt}"] = dict(
                ms=timed(call, 6) * 1e3, device_ms=graph_ms(call, reps=5))
            print(f"time loop_probe ({variant}, pt {tpt}, bl 256, {lp_r} rounds): "
                  f"{turn['ms']:.4f} ms per call, {turn['device_ms']:.4f} ms on the device; "
                  f"{card}")
    # the row's own numbers: V3 at pt 64
    loop.update(loop["by_variant"]["V3 pt 64"])

    # Its issue ceilings, from the SASS of the staged main loops of V0, V3 and
    # V5 (the static trip at R, the two dynamic ones): a round's instructions
    # on every scheduler, and each round's three candidate loads (LDS: the
    # table is staged) inside the loop.
    mangled = {"V0": f"ILb0ELb0ELi1ELb0ELi{lp_r}EE", "V3": "ILb1ELb1ELi1ELb0ELi0EE",
               "V5": "ILb1ELb1ELi1ELb1ELi0EE"}
    loop["issue_ceiling_ms"], loop["sass_instructions_per_round"] = {}, {}
    for variant, args in mangled.items():
        flight = probes.LOOP_UNROLL
        loops = sass_loops(path, "loop_probe_kernel", args, load="LDS")
        main_loops = [loop_ for loop_ in loops if loop_[1] == 3 * flight]
        require(len(main_loops) == 1, f"loop_probe {variant}: no loop in the SASS holds the "
                f"{3 * flight} LDS of {flight} rounds: (instructions, LDS) {loops}")
        per_round = main_loops[0][0] / flight
        ceiling_ms = per_round * 64 * 256 * lp_r / (sms * 4 * 32 * sm_mhz * 1e6) * 1e3
        ceiling_rate = sms * 4 * 32 * sm_mhz * 1e6 / per_round / 1e9
        turn = loop["by_variant"][f"{variant} pt 64"]
        loop["issue_ceiling_ms"][variant] = ceiling_ms
        loop["sass_instructions_per_round"][variant] = per_round
        print(f"loop_probe {variant} SASS: loops (instructions, LDS) {loops}; the staged main "
              f"loop takes {flight} rounds in {main_loops[0][0]} instructions = {per_round:.3f} "
              f"a round with 3 loads a round inside it; issue ceiling at pt 64, bl 256, {lp_r} "
              f"rounds {ceiling_ms:.4f} ms ({ceiling_rate:.2f} Gpair-lanes/s at {sm_mhz:.0f} MHz "
              f"on {sms} SMs): the call ({turn['ms']:.4f} ms) reaches "
              f"{ceiling_ms / turn['ms']:.4f} of it, its device time ({turn['device_ms']:.4f} "
              f"ms) {ceiling_ms / turn['device_ms']:.4f}, the slope ({loop['rates'][variant]:.2f} "
              f"Gpair-lanes/s) {loop['rates'][variant] / ceiling_rate:.4f}; {card}")
    loop["best_load_bytes_per_clock_per_sm"] = (
        loop["rates"]["V3"] * 1e9 * 12 / (sms * sm_mhz * 1e6))
    print(f"loop_probe V3 {loop['rates']['V3']:.2f} Gpair-lanes/s: its three 4-byte loads a "
          f"pair-lane and round are {loop['best_load_bytes_per_clock_per_sm']:.2f} bytes a "
          f"clock and SM from shared memory; {card}")

    # The force kernel beside V5, the force's op mix. V5 does the whole force
    # arithmetic for every pair-lane, while the kernel leaves a candidate
    # beyond h after 9 operations, so the kernel may run above V5's rate (a
    # share over 1 is no error); and V5 loads 3 values a pair where the kernel
    # loads 5 more (rho, p, v) for a pair within h. The finer reading prices
    # the pairs that take the force arithmetic at V5's rate and the others at
    # V3's (the density term, about the 9 operations of a rejected pair).
    v3, v5 = loop["rates"]["V3"], loop["rates"]["V5"]
    for label, row in results["force"]["by_step"].items():
        pairs, live = row["candidate_pairs"], row["force_pairs"]
        row["force_mix_ms"] = pairs / (v5 * 1e9) * 1e3
        row["force_mix_fine_ms"] = ((pairs - live) / (v3 * 1e9) + live / (v5 * 1e9)) * 1e3
        print(f"force at step {label}: kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}), force_mix_ms {row['force_mix_ms']:.4f} ({pairs} "
              f"candidate pairs at V5's {v5:.2f} Gpair-lanes/s, which does the whole force "
              f"arithmetic and 3 loads for every pair; the kernel drops a pair beyond h after 9 "
              f"operations and loads 5 more values for one within h): the kernel runs at "
              f"{row['force_mix_ms'] / row['ms']:.4f} of V5's rate, which may exceed 1; finer, "
              f"{live} force pairs at V5's rate and the other {pairs - live} at V3's "
              f"{v3:.2f}: {row['force_mix_fine_ms']:.4f} ms, the kernel at "
              f"{row['force_mix_fine_ms'] / row['ms']:.4f} of it; {card}")

    # ------------------------------------------------------ 7. free mode
    with tempfile.TemporaryDirectory() as tmp:
        frames_dir, ckpt = os.path.join(tmp, "frames"), os.path.join(tmp, "free.npz")
        argv = ["-n", str(N_MAIN), "-m", "free", "--frames", str(FREE_FRAMES),
                "--click", FREE_CLICK, "--out", frames_dir, "--save", ckpt]
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        free_s = time.perf_counter() - t0
        free_launches = {name: fn.launches for name, fn in zip(KERNEL_NAMES, kernels)}
        require(rc == 0, f"the free-mode command line exited {rc}")
        pngs = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
        require(len(pngs) == FREE_FRAMES, f"free mode wrote {len(pngs)} frames")
        for name in pngs:
            with open(os.path.join(frames_dir, name), "rb") as f:
                require(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name} is not a PNG")
        state, _ = load_state(ckpt, "cpu")
        # the same frames as a GIF by the stdlib writer (what --gif runs
        # after the frame dump where PIL is absent), outside the timed command
        from tpusph_torch.viz.render import read_png, write_gif

        t0 = time.perf_counter()
        write_gif((read_png(os.path.join(frames_dir, name)) for name in pngs),
                  os.path.join(tmp, "free.gif"))
        gif_s = time.perf_counter() - t0
        gif_frames = gif_frame_count(os.path.join(tmp, "free.gif"))
        gif_bytes = os.path.getsize(os.path.join(tmp, "free.gif"))
    print(f"free mode frames as a GIF: {gif_frames} frames, {gif_bytes} bytes, {gif_s:.3f} s "
          f"on the host")
    print(f"launches in free mode: {free_launches}")
    for name, n in free_launches.items():
        require(n > 0, f"{name} kernel was not launched by free mode")
    hold_packed(free_launches, "free mode")
    v = state.valid.numpy()
    require(v.sum() == N_MAIN, "the saved state lost particles")
    for f in ("position", "velocity", "density"):
        require(torch.isfinite(getattr(state, f)[v]).all(), f"non-finite {f} in free mode")
    pos = state.position.numpy()[v]
    require(pos.min() >= lo - 1e-6 and pos.max() <= hi + 1e-6,
            "particle outside the box in free mode")
    free_ms = free_s / FREE_FRAMES * 1e3
    print(f"free mode: python -m tpusph_torch {' '.join(argv[:8])}: {FREE_FRAMES} frames, "
          f"{free_s:.3f} s, {free_ms:.2f} ms per frame with set-up "
          f"and save ({card})")

    replay_launches, reference, chain_rate = chained_loop(card, kernels, timed_rate, free_ms, dev)

    remainder_phase(card, main_state, gif_frames, dev)
    dist_launches, slab = dist_phase(card, kernels, reference, timed_rate, chain_rate, dev)
    for name, brick in brick_phase(card, kernels, reference, timed_rate, slab, dev).items():
        dist_launches[name].update(brick)
    bench_launches = bench_phase(card, kernels, chain_rate, dev)
    for name, counts in slice_phase(card, kernels, dev).items():
        dist_launches.setdefault(name, {}).update(counts)
    graph_launches = graph_phase(card, kernels, timed_rate, dev)
    for name, counts in multirank_phase(card, dev).items():
        graph_launches[name].update(counts)
    results["set_if"], branch_launches = branch_phase(card, kernels, dev)
    launches["set_if"] = branch_launches["set_if"]
    # the packing pass's launches, in the force's row (each path's checks
    # above hold them to one a force launch)
    results["force"]["pack_launches"] = {
        "main": launches["pack"], "per_replay": replay_launches.get("pack", 0),
        **{what: counts["pack"] for what, counts in (
            ("bench", bench_launches), ("dist", dist_launches), ("graph", graph_launches),
            ("branch", branch_launches)) if "pack" in counts}}

    for name, r in results.items():
        r["launches_per_replay"] = replay_launches.get(name, 0)
        if name in bench_launches:
            r["bench_launches"] = bench_launches[name]
        if name in dist_launches:
            r["dist_launches"] = dist_launches[name]
        if name in graph_launches:
            r["graph_launches"] = graph_launches[name]
        if name in branch_launches:
            r["branch_launches"] = branch_launches[name]
        r.setdefault("library_ms", None)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    table = [
        {"name": name, "launches": launches[name],
         **{k: r[k] for k in ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms", "share_of_bound", "launches_per_replay", "at")},
         **{k: r[k] for k in ("max_abs_diff_baseline", "by_step", "issue_ceiling_ms",
                              "sass_instructions_per_round", "sass_loads_per_round",
                              "best_load_bytes_per_clock_per_sm", "rates", "by_variant",
                              "device_ms", "dist_launches",
                              "bench_launches", "graph_launches", "branch_launches", "body_ms",
                              "pack_max_abs_err", "pack_launches")
            if k in r}}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
