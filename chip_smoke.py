#!/usr/bin/env python3
"""Smoke run of tpusph_torch on one NVIDIA GPU (built for sm_90a: H100).

    python3 chip_smoke.py        # from the repository root

Phases, each of which raises on failure (exit code 1):
  1. device: needs torch.cuda; prints the card, CUDA version and the
     card's power limit as nvidia-smi reports it;
  2. build: compiles the CUDA kernels from tpusph_torch/csrc with nvcc;
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes (262,144 particles, grid init, at step 0 and after
     20 steps): ranks exact, density rtol 1e-5, force rtol 1e-4 atol 1e-4;
     prints each kernel's time beside the plain version's;
  4. parity at N = 4096: one kernel step against the NumPy oracle
     (tests/oracle_numpy.py: density rtol 1e-4, positions atol 1e-5), and
     10 chained kernel steps against 10 plain steps on the CPU,
     multiset-compared (density rtol 1e-4, positions atol 1e-4);
  5. the timed path through the user's entry points: Simulator at 262,144
     particles, 3 warm-up steps and 100 timed `simulate_and_time` steps
     (the copy to the host double-buffered on a side stream); prints the
     Times table and timesteps/s, checks that each kernel was launched,
     that no particle left the grid and that the state is finite;
  6. the rate probes: each probe kernel against its plain version for
     every dtype, stream count, pt and variant at 64 rounds (f32 FMA, f32
     density mix and loop probe rtol 1e-5; bf16 bit-equal), the
     dynamic-trip variants also with desc[rounds] != rounds; at the entry
     points' round counts the f32 FMA bit-equal on tie-free inputs, and the
     loop probe (every variant at R, V0 and V1 at 4R) within rounds·eps
     and a mean difference under 1 % of one round's term; then the two
     probe entry points (`tpusph_torch.scripts.vpu_microbench` and
     `loop_probe`) at their own round counts, every rate finite and
     positive;
  7. headless free mode through the command line, `python -m tpusph_torch
     -n 262144 -m free --frames 10 --click 2:400,300 --save ...`, run in
     this process: 10 PNGs, a saved state that is finite and inside the
     box; prints the wall time per frame, set-up and save included;
  8. the chained loop, CUDA graphs of chained steps:
     a. at N = 4096, grid and random init: `simulate_chunk(5)` with a click
        at step 2 (one graph replay) equals 5 sequential `simulate()` calls
        bit for bit (snapshots, final velocity), each kernel launched 5×
        its per-step count; `dispatch_chunk(3)` with packed pixels and with
        bitmaps equals the projections of the sequential positions;
     b. at 262,144, grid init: 20 chained fields steps (`make_fields_chain`)
        against 20 `step_kernels` steps, multiset-compared by nearest
        neighbour (density rtol 1e-4, positions atol 1e-4); one warm and one
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
Each path's kernel launch counts are set to 0 just before it and read just
after. A wrapper counts where it launches its kernel; inside a CUDA graph
(phase 8) the launches recorded at capture are what each replay adds
(`tpusph_torch/engine/graphs.py`). It then prints one JSON line of
per-kernel results and, last, one JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 262_144
N_PARITY = 4096
TIMED_STEPS = 100
WARMUP_STEPS = 3
CHECK_ROUNDS = 64  # rounds at which the probes are held against their plain versions
FREE_FRAMES = 10
FREE_CLICK = "2:400,300"  # frame:pixel, the box centre
CHAIN_STEPS = 100  # steps per replay of the timed fields chain (bench.py's)
CHAIN_PARITY_STEPS = 20
CHUNK_FRAMES, VIZ_CHUNK = 32, 8


def require(ok, msg: str) -> None:
    """Fail the run (an `assert` would vanish under `python -O`)."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


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


def canon(pos, *fields):
    """Order particle records by position (a multiset compare)."""
    order = np.lexsort(pos.T)
    return (pos[order],) + tuple(f[order] for f in fields)


def chained_loop(card: str, kernels, timed_rate: float, free_ms: float, dev) -> None:
    """Phase 8 (see the module docstring)."""
    from tpusph_torch import cli
    from tpusph_torch.core.config import default_config, tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.engine.simulator import Simulator
    from tpusph_torch.engine.step import fields_from_state, make_fields_chain, make_step
    from tpusph_torch.kernels import fused
    from tpusph_torch.neighbors.cell_list import build_sorted_fields_1d
    from tpusph_torch.physics.kernels import pressure_from_density
    from tpusph_torch.viz.project import project_bitmap, project_pixels_packed

    from torch.autograd import DeviceType

    names = ("rank", "density", "force")

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
    def particles(fs):
        """(positions, density) of the live particles of a fields state,
        the density from one pass of the density kernel over it."""
        sf = build_sorted_fields_1d(*fs, cfg)
        rho, _ = pressure_from_density(
            fused.density(sf.x, sf.y, sf.z, sf.key_sorted, sf.starts, cfg), cfg)
        v = sf.valid_sorted
        pos = torch.stack([sf.x, sf.y, sf.z], dim=1)[v]
        return pos.cpu().numpy(), rho[v].cpu().numpy()

    # A multiset compare by nearest neighbour: at 262,144 many particles
    # share a lattice coordinate, so a lexicographic order can pair other
    # particles once rounding splits a tie, and ~5,000 sit on another
    # particle exactly after 20 steps, so a one-to-one pairing does not
    # exist. Each run's particles lie within 1e-4 of the other run's, each
    # coordinate's sorted values agree within 1e-4 (multiplicities), and
    # the density at paired positions within rtol 1e-4.
    from scipy.spatial import cKDTree

    pa, ra = particles(fs20)
    pb, rb = particles(fields_from_state(st))
    require(len(pa) == len(pb) == N_MAIN, "the fields chain lost particles")
    _, match = cKDTree(pb).query(pa)
    _, back = cKDTree(pa).query(pb)
    np.testing.assert_allclose(pa, pb[match], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pb, pa[back], rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.sort(pa, axis=0), np.sort(pb, axis=0), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ra, rb[match], rtol=1e-4, atol=0)
    pb = pb[match]
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
          f"1e-4, multisets; max|dpos| {np.abs(pa - pb).max():.3e}); capture "
          f"{capture_s:.3f} s")
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
        top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / CHAIN_STEPS:.4f}"
                        for e in events[:8] if e.self_device_time_total > 0)
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
    print(f"chunked free mode: python -m tpusph_torch {' '.join(argv[:10])}: "
          f"{CHUNK_FRAMES} frames, {chunk_s:.3f} s, {chunk_s / CHUNK_FRAMES * 1e3:.2f} ms "
          f"per frame with set-up and capture, beside {free_ms:.2f} unchunked (phase 7); "
          f"launches {chunk_launches}; {card}")


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
    from tpusph_torch.engine.step import build_phase, make_step
    from tpusph_torch.kernels import fused, probes, qrank
    from tpusph_torch.physics.kernels import pressure_from_density
    from tpusph_torch.scripts import loop_probe as loop_script
    from tpusph_torch.scripts import slope, timed, vpu_microbench
    from tpusph_torch.utils import cuda_build

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle_numpy import oracle_step

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
    log = path.with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---------------------------------- 3. kernels against plain versions
    cfg = tuned_config(N_MAIN)
    nc = cfg.num_cells
    step = make_step(cfg, "kernels", dev)
    states = {0: init_state(cfg, device=dev)}
    st = states[0]
    for _ in range(20):
        st, _ = step(st)
    states[20] = st

    results = {
        "rank": dict(route="cuda", source="tpusph_torch/csrc/qrank.cu",
                     replaces="tpusph/pallas/qrank.py:234", fn=qrank.rank_queries),
        "density": dict(route="cuda", source="tpusph_torch/csrc/sph.cu",
                        replaces="tpusph/pallas/fused.py:1200", fn=fused.density),
        "force": dict(route="cuda", source="tpusph_torch/csrc/sph.cu",
                      replaces="tpusph/pallas/fused.py:1540", fn=fused.force),
    }
    for r in results.values():
        r["max_abs_err"] = 0.0
    for label, st in states.items():
        cl = build_phase(st, cfg)
        key, starts = cl.key_sorted, cl.starts
        cells = torch.arange(nc + 2, dtype=torch.int32, device=dev)
        rk, ovf = qrank.rank_queries(key, cells, nc)
        rp = qrank.rank_queries_plain(key, cells, nc)
        torch.testing.assert_close(rk, rp, rtol=0, atol=0)
        require(ovf == 0, f"rank overflow {ovf}")
        results["rank"]["max_abs_err"] = max(
            results["rank"]["max_abs_err"], float((rk - rp).abs().max()))

        xyz = st.position[cl.perm].T.contiguous()
        vxyz = st.velocity[cl.perm].T.contiguous()
        dk = fused.density(*xyz, key, starts, cfg)
        dp = fused.density_plain(*xyz, key, starts, cfg)
        torch.testing.assert_close(dk, dp, rtol=1e-5, atol=0)
        results["density"]["max_abs_err"] = max(
            results["density"]["max_abs_err"], float((dk - dp).abs().max()))

        rho, p = pressure_from_density(dk, cfg)
        rho = torch.where(cl.valid_sorted, rho, 1.0)
        p = torch.where(cl.valid_sorted, p, 0.0)
        fk = fused.force(*xyz, *vxyz, rho, p, key, starts, cfg)
        fp = fused.force_plain(*xyz, *vxyz, rho, p, key, starts, cfg)
        torch.testing.assert_close(fk, fp, rtol=1e-4, atol=1e-4)
        results["force"]["max_abs_err"] = max(
            results["force"]["max_abs_err"], float((fk - fp).abs().max()))
        _, count = fused.windows(key, starts, cfg)
        print(f"step {label}: ranks equal; density max|err| "
              f"{float((dk - dp).abs().max()):.3e} (max rho {float(dk.max()):.3f}); "
              f"force max|err| {float((fk - fp).abs().max()):.3e} "
              f"(max |f| {float(fk.abs().max()):.3f}); widest window {int(count.max())}; "
              f"max p {float(p.max()):.3f}")

        if label == 20:  # time at the pile-up state
            calls = {
                "rank": (lambda: qrank.rank_queries(key, cells, nc),
                         lambda: qrank.rank_queries_plain(key, cells, nc)),
                "density": (lambda: fused.density(*xyz, key, starts, cfg),
                            lambda: fused.density_plain(*xyz, key, starts, cfg)),
                "force": (lambda: fused.force(*xyz, *vxyz, rho, p, key, starts, cfg),
                          lambda: fused.force_plain(*xyz, *vxyz, rho, p, key, starts, cfg)),
            }
            for name, (kern, plain) in calls.items():
                results[name]["ms"] = time_ms(kern, 21)
                results[name]["plain_ms"] = time_ms(plain, 5)
                print(f"time {name}: kernel {results[name]['ms']:.4f} ms, plain "
                      f"{results[name]['plain_ms']:.4f} ms per call (N={N_MAIN}, "
                      f"step 20; {card})")
            pairs = int(count.sum())
            print(f"candidate pairs at step 20: {pairs}; density kernel "
                  f"{pairs / results['density']['ms'] / 1e6:.2f} Gpair/s, force kernel "
                  f"{pairs / results['force']['ms'] / 1e6:.2f} Gpair/s ({card})")

    # ------------------------------------------------- 4. parity at 4096
    cfg4 = default_config(N_PARITY)
    s0 = init_state(cfg4, device=dev)
    s1, aux = make_step(cfg4, "kernels", dev)(s0)
    v = s0.valid.cpu().numpy()
    ref = oracle_step(s0.position.cpu().numpy()[v], s0.velocity.cpu().numpy()[v], cfg4)
    np.testing.assert_allclose(s1.density.cpu().numpy()[v], ref["density"], rtol=1e-4, atol=0)
    np.testing.assert_allclose(s1.position.cpu().numpy()[v], ref["position"], rtol=0, atol=1e-5)
    require(int(aux.oob_count) == 0, "particles outside the grid at N=4096")
    print(f"parity N={N_PARITY}: 1 kernel step matches the NumPy oracle")

    sg, sc = s0, init_state(cfg4, device="cpu")
    step_gpu, step_cpu = make_step(cfg4, "kernels", dev), make_step(cfg4, "kernels", "cpu")
    for _ in range(10):
        sg, _ = step_gpu(sg)
        sc, _ = step_cpu(sc)
    vg, vc = sg.valid.cpu().numpy(), sc.valid.numpy()
    require(vg.sum() == vc.sum() == N_PARITY, "valid slots differ")
    pa, ra = canon(sg.position.cpu().numpy()[vg], sg.density.cpu().numpy()[vg])
    pb, rb = canon(sc.position.numpy()[vc], sc.density.numpy()[vc])
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ra, rb, rtol=1e-4, atol=0)
    print(f"parity N={N_PARITY}: 10 kernel steps match 10 plain steps on the CPU")

    # ----------------------------------------------------- 5. timed path
    kernels = [qrank.rank_queries, fused.density, fused.force]
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
    launches = {name: fn.launches for name, fn in zip(results, kernels)}
    print(format_times(times))
    phase_s = times.build_grid + times.sph_update + times.memcpy
    timed_rate = times.iters / phase_s
    print(f"timesteps/s: {timed_rate:.3f} (N={N_MAIN} grid init, "
          f"{TIMED_STEPS} steps; {card})")
    print(f"peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    print(f"launches in the main path: {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} kernel was not launched by the main path")
    require(worst_oob == 0, f"{worst_oob} particles left the grid")
    require(worst_ovf == 0, f"window overflow {worst_ovf}")
    for f in ("position", "velocity", "force", "density", "pressure"):
        require(torch.isfinite(getattr(sim.state, f)).all(), f"non-finite {f}")
    pos = sim.get_position()
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
            hold("density_mix", probes.density_mix(t, c, pt, r),
                 probes.density_mix_plain(t, c, pt, r), rtol)
    pt, bl, cap = 64, 256, loop_script.CAP
    t, cand = uniform((pt, 4), 1.0, 1.05), uniform((8, cap), 1.0, 1.05)
    desc = loop_inputs(r, r)
    for variant in probes.VARIANTS:
        hold("loop_probe", probes.loop_probe(variant, desc, t, cand, pt, bl),
             probes.loop_probe_plain(variant, desc, t, cand, pt, bl), 1e-5)
    # The dynamic-trip variants run desc[rounds] blocks, not rounds.
    desc = loop_inputs(r, r - 23)
    for variant in ("V2", "V3", "V4", "V5"):
        hold("loop_probe", probes.loop_probe(variant, desc, t, cand, pt, bl),
             probes.loop_probe_plain(variant, desc, t, cand, pt, bl), 1e-5)
    print(f"probes at {r} rounds (dynamic trips also at desc[{r}] = {r - 23}) equal "
          f"their plain versions; max|err| {probe_err}")

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
            err, shift = hold_sum(probes.loop_probe(variant, desc, t, cand, pt, bl),
                                  probes.loop_probe_plain(variant, desc, t, cand, pt, bl),
                                  rounds)
            print(f"loop_probe {variant} at {rounds} rounds: max|err| {err:.3e}, mean "
                  f"difference {shift:.3e} of a round's term")

    probe_fns = {"fma_probe": probes.fma_probe, "density_mix": probes.density_mix,
                 "loop_probe": probes.loop_probe}
    for fn in probe_fns.values():
        fn.launches = 0
    rates = vpu_microbench.main()
    rates.update({("loop_probe", v): g for v, g in loop_script.main([]).items()})
    for name, fn in probe_fns.items():
        launches[name] = fn.launches
    print(f"launches in the probe path: { {n: launches[n] for n in probe_fns} }")
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
    for name, (at, kern, plain, rounds) in probe_calls.items():
        results[name] = dict(
            route="cuda", source="tpusph_torch/csrc/probes.cu", replaces=sources[name],
            max_abs_err=probe_err[name], at=at,
            ms=timed(lambda: kern(rounds), 6) * 1e3, plain_ms=plain_ms(plain, rounds))
        print(f"time {name} ({at}): kernel {results[name]['ms']:.4f} ms per call, plain "
              f"{results[name]['plain_ms']:.4f} ms (its slope from {max(1, rounds // 100)} "
              f"to {4 * max(1, rounds // 100)} rounds, scaled to {rounds}; {card})")

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
        free_launches = {name: fn.launches
                         for name, fn in zip(("rank", "density", "force"), kernels)}
        require(rc == 0, f"the free-mode command line exited {rc}")
        pngs = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
        require(len(pngs) == FREE_FRAMES, f"free mode wrote {len(pngs)} frames")
        for name in pngs:
            with open(os.path.join(frames_dir, name), "rb") as f:
                require(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name} is not a PNG")
        state, _ = load_state(ckpt, "cpu")
    print(f"launches in free mode: {free_launches}")
    for name, n in free_launches.items():
        require(n > 0, f"{name} kernel was not launched by free mode")
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

    chained_loop(card, kernels, timed_rate, free_ms, dev)

    table = [
        {"name": name, "route": r["route"], "source": r["source"],
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         **({"at": r["at"]} if "at" in r else {})}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
